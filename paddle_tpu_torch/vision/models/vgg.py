"""VGG (the JAX package's `vision/models/vgg.py`; Simonyan and Zisserman
2014, configurations A, B, D and E): 3x3 convolutions (with BatchNorm2D
when `batch_norm`), 2x2 max pools, a 7x7 adaptive average pool and the
4096-wide classifier with dropout 0.5. The same module tree and
parameter names as the JAX model.

`device` (None: the CUDA card) and `generator` (a CPU torch.Generator
the initial weights are drawn from) as for every port model.
"""
from __future__ import annotations

from torch.nn import Module

from ... import nn

__all__ = ["VGG", "make_layers", "cfgs", "vgg11", "vgg13", "vgg16", "vgg19"]

cfgs = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512,
          512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
          512, 512, "M", 512, 512, 512, 512, "M"],
}


def make_layers(cfg, batch_norm=False, *, device=None, generator=None):
    layers = []
    in_channels = 3
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2D(2, 2))
        else:
            conv = nn.Conv2D(in_channels, v, 3, padding=1, device=device,
                             generator=generator)
            if batch_norm:
                layers += [conv, nn.BatchNorm2D(v, device=device), nn.ReLU()]
            else:
                layers += [conv, nn.ReLU()]
            in_channels = v
    return nn.Sequential(*layers)


class VGG(Module):
    def __init__(self, features, num_classes=1000, with_pool=True, *,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.features = features
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(512 * 7 * 7, 4096, **kw), nn.ReLU(), nn.Dropout(),
                nn.Linear(4096, 4096, **kw), nn.ReLU(), nn.Dropout(),
                nn.Linear(4096, num_classes, **kw),
            )

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def _vgg(cfg, batch_norm, pretrained, device=None, generator=None,
         **kwargs):
    if pretrained:
        raise ValueError("no pretrained weights: load a state_dict instead")
    return VGG(make_layers(cfgs[cfg], batch_norm, device=device,
                           generator=generator),
               device=device, generator=generator, **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("A", batch_norm, pretrained, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("B", batch_norm, pretrained, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("D", batch_norm, pretrained, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("E", batch_norm, pretrained, **kwargs)
