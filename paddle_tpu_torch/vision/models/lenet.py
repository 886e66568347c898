"""LeNet.  Counterpart of `paddle_tpu/vision/models/lenet.py`: two
conv + ReLU + 2x2 max-pool stages over a 1 x 28 x 28 image, then three
Linear layers."""
from __future__ import annotations

import torch

from ... import nn
from ._init import device_and_generator

__all__ = ["LeNet"]


class LeNet(nn.Layer):
    def __init__(self, num_classes=10, *, device=None, seed=0,
                 generator=None):
        super().__init__()
        dev, gen = device_and_generator(device, seed, generator)
        kw = dict(device=dev, generator=gen)
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
            x = self.fc(torch.flatten(x, 1))
        return x
