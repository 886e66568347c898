"""Linear, Embedding and Dropout.

Counterpart of `paddle_tpu/nn/layer/common.py`: `Linear` (:31),
`Dropout` (:66) and `Embedding` (:112).

  * `Linear` keeps the reference's [in, out] weight (y = x @ W + b), so
    weights carry over with no transpose;
  * `Embedding` zeroes its `padding_idx` row at init, and the row reads
    as zeros in the forward (nn.functional.embedding);
  * `Dropout` is `nn.functional.dropout` with the layer's training flag
    and its own `generator`.

`Linear`, `Embedding` and `LayerNorm` carry `_compute_dtype` (None, or
the dtype `nn.set_compute_dtype` switched them to): the parameters stay
fp32 masters and the layer computes in that dtype.  Each layer is a
`nn.Layer`, so its parameters take the reference's automatic names
(`linear_3.weight`).  Parameters live on `device` (None: the CUDA
device, raising without one; "cpu" for the host); random initializers
draw from `generator`.
"""
from __future__ import annotations

from ...framework.device import resolve_device
from .. import functional as F
from . import Layer

__all__ = ["Linear", "Embedding", "Dropout"]


class Linear(Layer):
    _compute_dtype = None

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        self._in_features = in_features
        self._out_features = out_features
        self.weight = self.create_parameter(
            [in_features, out_features], weight_attr, device=dev,
            generator=generator)
        self.bias = self.create_parameter(
            [out_features], bias_attr, is_bias=True, device=dev,
            generator=generator)

    def forward(self, input):
        return F.linear(input, self.weight, self.bias,
                        compute_dtype=self._compute_dtype)

    def extra_repr(self):
        return (f"in_features={self._in_features}, "
                f"out_features={self._out_features}")


class Embedding(Layer):
    _compute_dtype = None

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *, device=None,
                 generator=None):
        super().__init__()
        dev = resolve_device(device)
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = padding_idx
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], weight_attr, device=dev,
            generator=generator)
        if padding_idx is not None:
            pid = padding_idx if padding_idx >= 0 \
                else num_embeddings + padding_idx
            self.weight.data[pid] = 0.0

    def forward(self, x):
        out = F.embedding(x, self.weight, padding_idx=self._padding_idx)
        if self._compute_dtype is not None:
            out = out.to(self._compute_dtype)
        return out

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None,
                 *, generator=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode
        self.generator = generator

    def forward(self, input):
        return F.dropout(input, self.p, axis=self.axis,
                         training=self.training, mode=self.mode,
                         generator=self.generator)

    def extra_repr(self):
        return f"p={self.p}"
