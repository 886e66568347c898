"""Conv1D/2D/3D and their transposes.

Counterpart of `paddle_tpu/nn/layer/conv.py` (:18-141): the weight
[out, in / groups, k...] ([in, out / groups, k...] for a transpose) from
`KaimingUniform(fan_in)` and the bias from Uniform(+-1 / sqrt(fan_in)),
fan_in = in / groups x prod(k) (:46-57), unless an attr says otherwise;
the forward is `nn.functional.conv*d`.  `_compute_dtype` (None, or the
dtype `nn.set_compute_dtype` switched the layer to) casts the input,
the weight and the bias before the call; the parameters stay fp32
masters (:64-72).  Parameters live on `device` (None: the CUDA device,
raising without one) and random initializers draw from `generator`.
"""
from __future__ import annotations

import math

from ...framework.device import resolve_device
from .. import functional as F
from .. import initializer as I
from . import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose"]

_FNS = {(1, False): F.conv1d, (2, False): F.conv2d, (3, False): F.conv3d,
        (1, True): F.conv1d_transpose, (2, True): F.conv2d_transpose,
        (3, True): F.conv3d_transpose}


class _ConvNd(Layer):
    _compute_dtype = None

    def __init__(self, in_channels, out_channels, kernel_size, nd,
                 stride=1, padding=0, dilation=1, groups=1,
                 padding_mode="zeros", weight_attr=None, bias_attr=None,
                 data_format="NCHW", transpose=False, output_padding=0, *,
                 device=None, generator=None):
        super().__init__()
        if padding_mode != "zeros":
            raise NotImplementedError(
                f"padding_mode {padding_mode!r}: only 'zeros' is ported, "
                f"as the reference computes only it")
        dev = resolve_device(device)
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = (kernel_size,) * nd \
            if isinstance(kernel_size, int) else tuple(kernel_size)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        self._nd = nd
        self._transpose = transpose
        self._output_padding = output_padding
        w_shape = [in_channels, out_channels // groups] if transpose \
            else [out_channels, in_channels // groups]
        fan_in = in_channels // groups * math.prod(self._kernel_size)
        self.weight = self.create_parameter(
            w_shape + list(self._kernel_size), weight_attr,
            default_initializer=I.KaimingUniform(fan_in=fan_in), device=dev,
            generator=generator)
        bound = 1.0 / math.sqrt(fan_in)
        self.bias = self.create_parameter(
            [out_channels], bias_attr, is_bias=True,
            default_initializer=I.Uniform(-bound, bound)
            if bias_attr is None else None, device=dev, generator=generator)

    def forward(self, x):
        fn = _FNS[self._nd, self._transpose]
        weight, bias = self.weight, self.bias
        if self._compute_dtype is not None:
            cd = self._compute_dtype
            x, weight = x.to(cd), weight.to(cd)
            bias = None if bias is None else bias.to(cd)
        if self._transpose:
            return fn(x, weight, bias, self._stride, self._padding,
                      self._output_padding, self._groups, self._dilation,
                      None, self._data_format)
        return fn(x, weight, bias, self._stride, self._padding,
                  self._dilation, self._groups, self._data_format)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}, "
                f"padding={self._padding}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device=device,
                         generator=generator)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device=device,
                         generator=generator)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW", *,
                 device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device=device,
                         generator=generator)


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding, device=device,
                         generator=generator)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding, device=device,
                         generator=generator)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW", *,
                 device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding, device=device,
                         generator=generator)
