"""Weight initializers.

Counterpart of `paddle_tpu/nn/initializer/__init__.py`: `Constant`
(:46), `Normal` (:54), `TruncatedNormal` (:66), `Uniform` (:79),
`XavierNormal` (:89), `XavierUniform` (:101), `KaimingNormal` (:113:
std = gain / sqrt(fan_in)) and `KaimingUniform` (:125: limit = gain
sqrt(3 / fan_in)), with the reference's fan rule `_fans` (:28) and
`calculate_gain` (:184).

An initializer is called as `init(shape, dtype, device=..., generator=...)`
and returns a new tensor.  The random ones draw in fp32 from the explicit
`torch.Generator` they are given (one on the tensor's device) and cast to
`dtype`, as the reference draws in fp32 from its key and casts; with no
generator they raise.  Shapes and distributions are the reference's, the
values are not: the two packages' random streams differ.
`TruncatedNormal` keeps the reference's bounds `a`, `b` in units of the
standard normal (the value lies in [mean + std a, mean + std b]) and
draws by the inverse CDF.
"""
from __future__ import annotations

import math

import torch

__all__ = ["Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
           "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
           "calculate_gain"]


def _fans(shape):
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


def _empty(shape, device):
    return torch.empty(tuple(shape), dtype=torch.float32, device=device)


def _need(generator, what):
    if generator is None:
        raise ValueError(f"{what} draws random values: pass generator= (a "
                         f"seeded torch.Generator on the parameter's device)")
    return generator


class Initializer:
    def __call__(self, shape, dtype=torch.float32, device="cpu",
                 generator=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype=torch.float32, device="cpu",
                 generator=None):
        return torch.full(tuple(shape), self.value, dtype=dtype,
                          device=device)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=torch.float32, device="cpu",
                 generator=None):
        gen = _need(generator, "Normal")
        return _empty(shape, device).normal_(
            self.mean, self.std, generator=gen).to(dtype)


class TruncatedNormal(Initializer):
    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0, name=None):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, shape, dtype=torch.float32, device="cpu",
                 generator=None):
        gen = _need(generator, "TruncatedNormal")
        cdf = lambda z: 0.5 * (1.0 + math.erf(z / math.sqrt(2.0)))
        u = _empty(shape, device).uniform_(cdf(self.a), cdf(self.b),
                                           generator=gen)
        z = (torch.special.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)) \
            .clamp_(self.a, self.b)
        return (self.mean + self.std * z).to(dtype)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, name=None):
        self.low, self.high = low, high

    def __call__(self, shape, dtype=torch.float32, device="cpu",
                 generator=None):
        gen = _need(generator, "Uniform")
        return _empty(shape, device).uniform_(
            self.low, self.high, generator=gen).to(dtype)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=torch.float32, device="cpu",
                 generator=None):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return Normal(0.0, std)(shape, dtype, device, generator)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=torch.float32, device="cpu",
                 generator=None):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return Uniform(-limit, limit)(shape, dtype, device, generator)



class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype=torch.float32, device="cpu",
                 generator=None):
        fi = self.fan_in if self.fan_in is not None else _fans(shape)[0]
        std = calculate_gain(self.nonlinearity, self.negative_slope) \
            / math.sqrt(fi)
        return Normal(0.0, std)(shape, dtype, device, generator)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype=torch.float32, device="cpu",
                 generator=None):
        fi = self.fan_in if self.fan_in is not None else _fans(shape)[0]
        limit = calculate_gain(self.nonlinearity, self.negative_slope) \
            * math.sqrt(3.0 / fi)
        return Uniform(-limit, limit)(shape, dtype, device, generator)


def calculate_gain(nonlinearity, param=None):
    if nonlinearity in ("sigmoid", "linear", "conv1d", "conv2d", "conv3d",
                        "conv_transpose1d", "conv_transpose2d",
                        "conv_transpose3d"):
        return 1.0
    if nonlinearity == "tanh":
        return 5.0 / 3.0
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        a = param if param is not None else 0.01
        return math.sqrt(2.0 / (1 + a ** 2))
    if nonlinearity == "selu":
        return 3.0 / 4.0
    raise ValueError(f"unknown nonlinearity {nonlinearity}")
