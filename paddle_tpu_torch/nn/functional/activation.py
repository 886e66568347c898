"""Activations: `gelu` and `tanh`.

Counterpart of `paddle_tpu/nn/functional/activation.py`: `gelu` (:44,
`jax.nn.gelu`; `approximate=True` is the tanh form original BERT uses)
and `tanh` (:27).  Plain PyTorch, as the reference leaves them to XLA.
"""
from __future__ import annotations

import torch

__all__ = ["gelu", "tanh"]


def gelu(x, approximate=False, name=None):
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def tanh(x, name=None):
    return torch.tanh(x)
