"""ReLU and ReLU6.

Counterpart of `paddle_tpu/nn/layer/activation.py` (:15-44): each
calls its `nn.functional` activation.  The rest of that family is not
ported yet (ROADMAP queue 1 item 6).
"""
from __future__ import annotations

from .. import functional as F
from . import Layer

__all__ = ["ReLU", "ReLU6"]


class ReLU(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu(x)


class ReLU6(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu6(x)
