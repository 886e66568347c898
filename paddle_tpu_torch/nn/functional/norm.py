"""`layer_norm` over the last len(normalized_shape) dims.

Counterpart of `paddle_tpu/nn/functional/norm.py::layer_norm` (:17):
`ops.layer_norm`'s math (fp32 statistics, the normalized value in the
input's dtype, then the affine in the promoted dtype).
"""
from __future__ import annotations

from ... import ops

__all__ = ["layer_norm"]


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05,
               name=None):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    return ops.layer_norm(x, weight, bias, epsilon,
                          normalized_shape=normalized_shape)
