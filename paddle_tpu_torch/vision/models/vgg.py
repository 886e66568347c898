"""VGG.  Counterpart of `paddle_tpu/vision/models/vgg.py`: the
configurations A, B, D and E (vgg11/13/16/19) of 3x3 convolutions
(with BatchNorm when `batch_norm`) and ReLU between 2x2 max pools, an
adaptive average pool to 7x7 and a 4096-wide classifier with Dropout."""
from __future__ import annotations

import torch

from ... import nn
from ._init import device_and_generator, no_pretrained

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19"]

_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
          512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
          512, 512, "M", 512, 512, 512, 512, "M"],
}


def _make_layers(cfg, batch_norm, device, generator):
    kw = dict(device=device, generator=generator)
    layers = []
    in_c = 3
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2D(kernel_size=2, stride=2))
        else:
            layers.append(nn.Conv2D(in_c, v, 3, padding=1, **kw))
            if batch_norm:
                layers.append(nn.BatchNorm2D(v, **kw))
            layers.append(nn.ReLU())
            in_c = v
    return nn.Sequential(*layers)


class VGG(nn.Layer):
    """`features`: the convolutional stack (`_make_layers`), built on
    the same device."""

    def __init__(self, features, num_classes=1000, with_pool=True, *,
                 device=None, seed=0, generator=None):
        super().__init__()
        dev, gen = device_and_generator(device, seed, generator)
        kw = dict(device=dev, generator=gen)
        self.features = features
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(512 * 7 * 7, 4096, **kw),
                nn.ReLU(),
                nn.Dropout(generator=gen),
                nn.Linear(4096, 4096, **kw),
                nn.ReLU(),
                nn.Dropout(generator=gen),
                nn.Linear(4096, num_classes, **kw),
            )

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(torch.flatten(x, 1))
        return x


def _vgg(cfg, batch_norm=False, pretrained=False, *, device=None, seed=0,
         generator=None, **kwargs):
    no_pretrained(pretrained)
    dev, gen = device_and_generator(device, seed, generator)
    return VGG(_make_layers(_CFGS[cfg], batch_norm, dev, gen), device=dev,
               generator=gen, **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("A", batch_norm, pretrained, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("B", batch_norm, pretrained, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("D", batch_norm, pretrained, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("E", batch_norm, pretrained, **kwargs)
