"""LayerNorm.

Counterpart of `paddle_tpu/nn/layer/norm.py::LayerNorm` (:27): weight
ones and bias zeros over `normalized_shape` (either left out with
`weight_attr` / `bias_attr` False), normalized through
`nn.functional.layer_norm` (`ops.layer_norm`: fp32 statistics).  With
`_compute_dtype` set (nn.set_compute_dtype) the statistics stay fp32 and
only the result is cast to that dtype, as in the reference.
"""
from __future__ import annotations

from ...framework.device import resolve_device
from .. import functional as F
from .. import initializer as I
from . import Layer

__all__ = ["LayerNorm"]


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
