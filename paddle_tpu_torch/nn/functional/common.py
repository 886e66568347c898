"""linear, embedding and dropout.

Counterpart of `paddle_tpu/nn/functional/common.py`: `linear` (:17),
`dropout` (:36) and `embedding` (:85).  All three are plain PyTorch, as
the reference leaves them to XLA:

  * `linear`: y = x @ W + b with the reference's [in, out] weight.
    `compute_dtype` casts the operands (fp32 master parameters, bf16
    compute: nn.set_compute_dtype); without it the operands are promoted
    to a common dtype, as jnp promotes them.  One `F.linear` call over
    Wᵀ (a view), so cuBLAS adds the bias in its epilogue;
  * `embedding`: a row gather; the `padding_idx` row reads as zeros and
    passes no gradient, as the reference's masked table does;
  * `dropout`: `upscale_in_train` scales kept values by 1 / (1 - p) in
    training, `downscale_in_infer` only masks; the identity in eval or
    at p = 0 (the reference's rule for both modes).  The keep mask is
    drawn from the explicit `generator` (one on x's device); p > 0 in
    training without one raises.
"""
from __future__ import annotations

import torch

from ...framework.dtypes import to_torch

__all__ = ["linear", "embedding", "dropout"]

_MODES = ("upscale_in_train", "downscale_in_infer")


def linear(x, weight, bias=None, name=None, compute_dtype=None):
    if compute_dtype is not None:
        dt = to_torch(compute_dtype)
    else:
        dt = torch.promote_types(x.dtype, weight.dtype)
        if bias is not None:
            dt = torch.promote_types(dt, bias.dtype)
    return torch.nn.functional.linear(
        x.to(dt), weight.to(dt).t(), None if bias is None else bias.to(dt))


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    ids = x.to(torch.int64)
    out = torch.nn.functional.embedding(ids, weight)
    if padding_idx is not None:
        pid = padding_idx if padding_idx >= 0 \
            else weight.shape[0] + padding_idx
        out = out.masked_fill((ids == pid)[..., None], 0.0)
    return out


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, generator=None):
    if mode not in _MODES:
        raise ValueError(f"dropout mode {mode!r}: one of {_MODES}")
    if not training or p == 0.0:
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError("dropout with p > 0 in training draws its mask: "
                         "pass generator= (a seeded torch.Generator on the "
                         "input's device)")
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = torch.rand(shape, generator=generator, device=x.device) \
        < 1.0 - p
    k = keep.to(x.dtype)
    if mode == "upscale_in_train":
        return x * k / torch.tensor(1.0 - p, dtype=x.dtype, device=x.device)
    return x * k
