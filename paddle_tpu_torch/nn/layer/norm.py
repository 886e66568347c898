"""LayerNorm and the BatchNorm family.

Counterpart of `paddle_tpu/nn/layer/norm.py::LayerNorm` (:27): weight
ones and bias zeros over `normalized_shape` (either left out with
`weight_attr` / `bias_attr` False), normalized through
`nn.functional.layer_norm` (`ops.layer_norm`: fp32 statistics).  With
`_compute_dtype` set (nn.set_compute_dtype) the statistics stay fp32 and
only the result is cast to that dtype, as in the reference.

`BatchNorm`, `BatchNorm1D`, `BatchNorm2D` and `BatchNorm3D` (:78-148):
weight ones and bias zeros over the channels, and the running statistics
as persistable buffers `_mean` (zeros) and `_variance` (ones), fp32, so
they appear in `state_dict` under the reference's names.  The forward
is `nn.functional.batch_norm` in the layer's mode: in training it
updates the buffers in place.  `BatchNorm` applies `act` (a
`nn.functional` name) after.  `SyncBatchNorm` is not ported: it raises,
naming ROADMAP queue 1 item 8.

`GroupNorm` (:175-198): weight ones and bias zeros over the channels
(either left out with `weight_attr` / `bias_attr` False), normalized
through `nn.functional.group_norm` (fp32 statistics); with
`_compute_dtype` set the result is cast to it, as LayerNorm's.
"""
from __future__ import annotations

import torch

from ...framework.device import resolve_device
from .. import functional as F
from .. import initializer as I
from . import Layer

__all__ = ["LayerNorm", "GroupNorm", "BatchNorm", "BatchNorm1D",
           "BatchNorm2D", "BatchNorm3D", "SyncBatchNorm"]


class LayerNorm(Layer):
    _compute_dtype = None

    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            self._normalized_shape, weight_attr,
            default_initializer=I.Constant(1.0), device=dev,
            generator=generator)
        self.bias = self.create_parameter(
            self._normalized_shape, bias_attr, is_bias=True, device=dev,
            generator=generator)

    def forward(self, input):
        out = F.layer_norm(input, self._normalized_shape, self.weight,
                           self.bias, self._epsilon)
        if self._compute_dtype is not None:
            out = out.to(self._compute_dtype)
        return out

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"


class GroupNorm(Layer):
    _compute_dtype = None

    def __init__(self, num_groups, num_channels, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        self._num_groups = num_groups
        self._num_channels = num_channels
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_channels], weight_attr, default_initializer=I.Constant(1.0),
            device=dev, generator=generator)
        self.bias = self.create_parameter(
            [num_channels], bias_attr, is_bias=True, device=dev,
            generator=generator)

    def forward(self, input):
        out = F.group_norm(input, self._num_groups, self._epsilon,
                           self.weight, self.bias, self._data_format)
        if self._compute_dtype is not None:
            out = out.to(self._compute_dtype)
        return out

    def extra_repr(self):
        return (f"num_groups={self._num_groups}, "
                f"num_channels={self._num_channels}")


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None,
                 generator=None):
        super().__init__()
        dev = resolve_device(device)
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            [num_features], weight_attr, default_initializer=I.Constant(1.0),
            device=dev, generator=generator)
        self.bias = self.create_parameter(
            [num_features], bias_attr, is_bias=True, device=dev,
            generator=generator)
        self.register_buffer("_mean", torch.zeros(num_features, device=dev))
        self.register_buffer("_variance",
                             torch.ones(num_features, device=dev))

    def forward(self, input):
        return F.batch_norm(input, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}"


class BatchNorm(_BatchNormBase):
    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-05,
                 param_attr=None, bias_attr=None, data_layout="NCHW",
                 use_global_stats=None, *, device=None, generator=None):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout, use_global_stats,
                         device=device, generator=generator)
        self._act = act

    def forward(self, input):
        out = super().forward(input)
        return getattr(F, self._act)(out) if self._act else out


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None, *, device=None,
                 generator=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats,
                         device=device, generator=generator)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None, *, device=None,
                 generator=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats,
                         device=device, generator=generator)


class SyncBatchNorm(_BatchNormBase):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "SyncBatchNorm (cross-replica statistics) is not ported yet: "
            "ROADMAP queue 1 item 8 (distributed training engines)")
