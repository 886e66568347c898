"""AlexNet.  Counterpart of `paddle_tpu/vision/models/alexnet.py`: five
convolutions with ReLU and three 3x3 stride-2 max pools, an adaptive
average pool to 6x6, and a classifier of Dropout, Linear and ReLU."""
from __future__ import annotations

import torch

from ... import nn
from ._init import device_and_generator, no_pretrained

__all__ = ["AlexNet", "alexnet"]


class AlexNet(nn.Layer):
    def __init__(self, num_classes=1000, *, device=None, seed=0,
                 generator=None):
        super().__init__()
        dev, gen = device_and_generator(device, seed, generator)
        kw = dict(device=dev, generator=gen)
        self.num_classes = num_classes
        self.features = nn.Sequential(
            nn.Conv2D(3, 64, 11, stride=4, padding=2, **kw),
            nn.ReLU(),
            nn.MaxPool2D(3, 2),
            nn.Conv2D(64, 192, 5, padding=2, **kw),
            nn.ReLU(),
            nn.MaxPool2D(3, 2),
            nn.Conv2D(192, 384, 3, padding=1, **kw),
            nn.ReLU(),
            nn.Conv2D(384, 256, 3, padding=1, **kw),
            nn.ReLU(),
            nn.Conv2D(256, 256, 3, padding=1, **kw),
            nn.ReLU(),
            nn.MaxPool2D(3, 2),
        )
        self.avgpool = nn.AdaptiveAvgPool2D((6, 6))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(generator=gen),
                nn.Linear(256 * 6 * 6, 4096, **kw),
                nn.ReLU(),
                nn.Dropout(generator=gen),
                nn.Linear(4096, 4096, **kw),
                nn.ReLU(),
                nn.Linear(4096, num_classes, **kw),
            )

    def forward(self, x):
        x = self.avgpool(self.features(x))
        if self.num_classes > 0:
            x = self.classifier(torch.flatten(x, 1))
        return x


def alexnet(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return AlexNet(**kwargs)
