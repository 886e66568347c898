"""Dtype names.

The subset of `paddle_tpu/framework/dtypes.py::to_jax` (:123) the
models and the nn layers need: a float dtype's name (or a torch dtype)
to a torch dtype.
"""
from __future__ import annotations

import torch

__all__ = ["to_torch"]

_NAMES = {"float32": torch.float32, "float64": torch.float64,
          "bfloat16": torch.bfloat16, "float16": torch.float16}


def to_torch(d) -> torch.dtype:
    if isinstance(d, torch.dtype):
        return d
    name = str(d).replace("paddle.", "")
    if name not in _NAMES:
        raise ValueError(f"unknown dtype {d!r}; one of {sorted(_NAMES)}")
    return _NAMES[name]
