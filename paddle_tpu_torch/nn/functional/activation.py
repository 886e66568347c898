"""Activations: `gelu`, `tanh`, `relu`, `relu6`, `silu` and `swish`.

Counterpart of `paddle_tpu/nn/functional/activation.py`: `gelu` (:44,
`jax.nn.gelu`; `approximate=True` is the tanh form original BERT uses),
`tanh` (:27), `relu` and `relu6` (:24-25), `silu` and its alias `swish`
(:28-29, `jax.nn.silu`: x sigmoid(x)).  Plain PyTorch, as the reference
leaves them to XLA.
"""
from __future__ import annotations

import torch

__all__ = ["gelu", "tanh", "relu", "relu6", "silu", "swish"]


def gelu(x, approximate=False, name=None):
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def tanh(x, name=None):
    return torch.tanh(x)


def relu(x, name=None):
    return torch.relu(x)


def relu6(x, name=None):
    return torch.nn.functional.relu6(x)


def silu(x, name=None):
    return torch.nn.functional.silu(x)


swish = silu
