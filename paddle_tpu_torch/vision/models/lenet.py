"""LeNet (the JAX package's `vision/models/lenet.py`): two 3x3 / 5x5
convolutions with ReLU and 2x2 max pools, then three Linear layers. The
module tree and parameter names are the JAX model's, so its
`state_dict()` loads name for name (`convert.from_jax_state`).

`device` (None: the CUDA card) and `generator` (a CPU torch.Generator
the initial weights are drawn from) as for every port model.
"""
from __future__ import annotations

from torch.nn import Module

from ... import nn

__all__ = ["LeNet"]


class LeNet(Module):
    def __init__(self, num_classes=10, *, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.num_classes = num_classes
        self.features = nn.Sequential(
            nn.Conv2D(1, 6, 3, stride=1, padding=1, **kw),
            nn.ReLU(),
            nn.MaxPool2D(2, 2),
            nn.Conv2D(6, 16, 5, stride=1, padding=0, **kw),
            nn.ReLU(),
            nn.MaxPool2D(2, 2),
        )
        if num_classes > 0:
            self.fc = nn.Sequential(
                nn.Linear(400, 120, **kw),
                nn.Linear(120, 84, **kw),
                nn.Linear(84, num_classes, **kw),
            )

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x
