"""MobileNetV1.  Counterpart of `paddle_tpu/vision/models/mobilenetv1.py`:
a stride-2 conv stem and 13 depthwise-separable blocks (a depthwise 3x3
conv, `groups` = channels, then a 1x1 conv, each with BatchNorm and
ReLU), an adaptive average pool to 1x1 and a Linear head; `scale`
multiplies the widths."""
from __future__ import annotations

import torch

from ... import nn
from ._init import device_and_generator, no_pretrained

__all__ = ["MobileNetV1", "mobilenet_v1"]


class ConvBNLayer(nn.Sequential):
    def __init__(self, in_c, out_c, kernel, stride, padding, groups=1, *,
                 device, generator):
        kw = dict(device=device, generator=generator)
        super().__init__(
            nn.Conv2D(in_c, out_c, kernel, stride=stride, padding=padding,
                      groups=groups, bias_attr=False, **kw),
            nn.BatchNorm2D(out_c, **kw),
            nn.ReLU(),
        )


class DepthwiseSeparable(nn.Sequential):
    def __init__(self, in_c, out_c1, out_c2, stride, scale, *, device,
                 generator):
        kw = dict(device=device, generator=generator)
        c1 = int(out_c1 * scale)
        c2 = int(out_c2 * scale)
        super().__init__(
            ConvBNLayer(in_c, c1, 3, stride, 1, groups=in_c, **kw),
            ConvBNLayer(c1, c2, 1, 1, 0, **kw),
        )


class MobileNetV1(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device=None, seed=0, generator=None):
        super().__init__()
        dev, gen = device_and_generator(device, seed, generator)
        kw = dict(device=dev, generator=gen)
        self.num_classes = num_classes
        self.with_pool = with_pool

        def s(c):
            return int(c * scale)
        self.conv1 = ConvBNLayer(3, s(32), 3, 2, 1, **kw)
        cfg = [  # in, out1, out2, stride
            (s(32), 32, 64, 1), (s(64), 64, 128, 2),
            (s(128), 128, 128, 1), (s(128), 128, 256, 2),
            (s(256), 256, 256, 1), (s(256), 256, 512, 2),
            (s(512), 512, 512, 1), (s(512), 512, 512, 1),
            (s(512), 512, 512, 1), (s(512), 512, 512, 1),
            (s(512), 512, 512, 1), (s(512), 512, 1024, 2),
            (s(1024), 1024, 1024, 1),
        ]
        self.blocks = nn.Sequential(*[
            DepthwiseSeparable(i, o1, o2, st, scale, **kw)
            for i, o1, o2, st in cfg])
        if with_pool:
            self.pool2d_avg = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(s(1024), num_classes, **kw)

    def forward(self, x):
        x = self.blocks(self.conv1(x))
        if self.with_pool:
            x = self.pool2d_avg(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV1(scale=scale, **kwargs)
