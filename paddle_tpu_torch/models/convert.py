"""Carry weights into the port by name.

`load_numpy_state_dict(model, {name: ndarray})` takes the values of a
`paddle_tpu` model's `state_dict()` as numpy arrays and copies them
into the port's parameters of the same names.  Both packages keep the
[in, out] layout (`x @ w`), so nothing is transposed.  A missing, extra
or mis-shaped name raises before any parameter is written.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["load_numpy_state_dict", "numpy_state_dict"]


def _to_tensor(arr) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.kind not in "fiub" or a.dtype.name == "bfloat16":
        # numpy has no native bfloat16 (ml_dtypes adds one torch cannot
        # read): widen exactly to float32, the parameter cast narrows
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a))


def load_numpy_state_dict(model: torch.nn.Module,
                          state: Mapping[str, object]) -> None:
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(state))
    extra = sorted(set(state) - set(params))
    if missing or extra:
        raise KeyError(f"state dict does not match the model: missing "
                       f"{missing}, unexpected {extra}")
    for name, p in params.items():
        shape = tuple(np.shape(state[name]))
        if shape != tuple(p.shape):
            raise ValueError(f"{name}: shape {shape} != parameter shape "
                             f"{tuple(p.shape)}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(_to_tensor(state[name]).to(device=p.device,
                                               dtype=p.dtype))


def numpy_state_dict(model: torch.nn.Module):
    """{name: float32 ndarray} of every parameter — the inverse view,
    for round-trip checks."""
    return {n: p.detach().float().cpu().numpy()
            for n, p in model.named_parameters()}
