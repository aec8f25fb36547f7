"""MobileNet V1 and V2 (the JAX package's `vision/models/mobilenet.py`;
Howard et al. 2017, Sandler et al. 2018): convolution + BatchNorm2D +
ReLU / ReLU6 blocks, the depthwise convolutions as grouped cuDNN
convolutions (groups = channels), a width multiplier `scale`. The same
module tree and parameter names as the JAX models.

`device` (None: the CUDA card) and `generator` (a CPU torch.Generator
the initial weights are drawn from) as for every port model.
"""
from __future__ import annotations

from torch.nn import Module

from ... import nn

__all__ = ["ConvBNLayer", "DepthwiseSeparable", "InvertedResidual",
           "MobileNetV1", "MobileNetV2", "mobilenet_v1", "mobilenet_v2"]


class ConvBNLayer(Module):
    def __init__(self, in_c, out_c, k, stride=1, padding=0, groups=1,
                 act="relu", *, device=None, generator=None):
        super().__init__()
        self.conv = nn.Conv2D(in_c, out_c, k, stride=stride, padding=padding,
                              groups=groups, bias_attr=False, device=device,
                              generator=generator)
        self.bn = nn.BatchNorm2D(out_c, device=device)
        self.act = nn.ReLU6() if act == "relu6" else (
            nn.ReLU() if act == "relu" else None)

    def forward(self, x):
        x = self.bn(self.conv(x))
        return self.act(x) if self.act else x


class DepthwiseSeparable(Module):
    def __init__(self, in_c, out_c1, out_c2, stride, scale=1.0, *,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        c1 = int(out_c1 * scale)
        c2 = int(out_c2 * scale)
        self.dw = ConvBNLayer(in_c, c1, 3, stride, 1, groups=in_c, **kw)
        self.pw = ConvBNLayer(c1, c2, 1, **kw)

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetV1(Module):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool

        def s(c):
            return int(c * scale)

        self.conv1 = ConvBNLayer(3, s(32), 3, 2, 1, **kw)
        cfg = [(s(32), 32, 64, 1), (s(64), 64, 128, 2),
               (s(128), 128, 128, 1), (s(128), 128, 256, 2),
               (s(256), 256, 256, 1), (s(256), 256, 512, 2)] + \
              [(s(512), 512, 512, 1)] * 5 + \
              [(s(512), 512, 1024, 2), (s(1024), 1024, 1024, 1)]
        self.blocks = nn.Sequential(*[
            DepthwiseSeparable(ic, c1, c2, st, scale, **kw)
            for ic, c1, c2, st in cfg])
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(s(1024), num_classes, **kw)

    def forward(self, x):
        x = self.blocks(self.conv1(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


class InvertedResidual(Module):
    def __init__(self, inp, oup, stride, expand_ratio, *, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.stride = stride
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNLayer(inp, hidden, 1, act="relu6", **kw))
        layers += [
            ConvBNLayer(hidden, hidden, 3, stride, 1, groups=hidden,
                        act="relu6", **kw),
            ConvBNLayer(hidden, oup, 1, act=None, **kw),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(Module):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        inp = int(32 * scale)
        last = int(1280 * max(1.0, scale))
        features = [ConvBNLayer(3, inp, 3, 2, 1, act="relu6", **kw)]
        for t, c, n, s in cfg:
            oup = int(c * scale)
            for i in range(n):
                features.append(InvertedResidual(
                    inp, oup, s if i == 0 else 1, t, **kw))
                inp = oup
        features.append(ConvBNLayer(inp, last, 1, act="relu6", **kw))
        self.features = nn.Sequential(*features)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.2), nn.Linear(last, num_classes, **kw))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        raise ValueError("no pretrained weights: load a state_dict instead")
    return MobileNetV1(scale=scale, **kwargs)


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        raise ValueError("no pretrained weights: load a state_dict instead")
    return MobileNetV2(scale=scale, **kwargs)
