"""MobileNetV2.  Counterpart of `paddle_tpu/vision/models/mobilenetv2.py`:
inverted residuals (a 1x1 expansion, a depthwise 3x3 conv, `groups` =
channels, each with BatchNorm and ReLU6, then a linear 1x1 bottleneck
with BatchNorm; the input added back where the shape allows), a 1x1
conv to 1280 channels, an adaptive average pool to 1x1 and a Dropout +
Linear head; `scale` multiplies the widths."""
from __future__ import annotations

import torch

from ... import nn
from ._init import device_and_generator, no_pretrained

__all__ = ["MobileNetV2", "mobilenet_v2"]


def _make_divisible(v, divisor=8, min_value=None):
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ConvBNReLU(nn.Sequential):
    def __init__(self, in_c, out_c, kernel=3, stride=1, groups=1, *, device,
                 generator):
        kw = dict(device=device, generator=generator)
        pad = (kernel - 1) // 2
        super().__init__(
            nn.Conv2D(in_c, out_c, kernel, stride=stride, padding=pad,
                      groups=groups, bias_attr=False, **kw),
            nn.BatchNorm2D(out_c, **kw),
            nn.ReLU6(),
        )


class InvertedResidual(nn.Layer):
    def __init__(self, in_c, out_c, stride, expand_ratio, *, device,
                 generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.stride = stride
        hidden = int(round(in_c * expand_ratio))
        self.use_res = stride == 1 and in_c == out_c
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNReLU(in_c, hidden, kernel=1, **kw))
        layers += [
            ConvBNReLU(hidden, hidden, stride=stride, groups=hidden, **kw),
            nn.Conv2D(hidden, out_c, 1, bias_attr=False, **kw),
            nn.BatchNorm2D(out_c, **kw),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device=None, seed=0, generator=None):
        super().__init__()
        dev, gen = device_and_generator(device, seed, generator)
        kw = dict(device=dev, generator=gen)
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [
            # t, c, n, s
            (1, 16, 1, 1),
            (6, 24, 2, 2),
            (6, 32, 3, 2),
            (6, 64, 4, 2),
            (6, 96, 3, 1),
            (6, 160, 3, 2),
            (6, 320, 1, 1),
        ]
        in_c = _make_divisible(32 * scale)
        last_c = _make_divisible(1280 * max(1.0, scale))
        features = [ConvBNReLU(3, in_c, stride=2, **kw)]
        for t, c, n, s in cfg:
            out_c = _make_divisible(c * scale)
            for i in range(n):
                features.append(InvertedResidual(
                    in_c, out_c, s if i == 0 else 1, t, **kw))
                in_c = out_c
        features.append(ConvBNReLU(in_c, last_c, kernel=1, **kw))
        self.features = nn.Sequential(*features)
        if with_pool:
            self.pool2d_avg = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.2, generator=gen),
                nn.Linear(last_c, num_classes, **kw))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool2d_avg(x)
        if self.num_classes > 0:
            x = self.classifier(torch.flatten(x, 1))
        return x


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV2(scale=scale, **kwargs)
