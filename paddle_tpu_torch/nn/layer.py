"""`Layer`: an `nn.Module` that names its parameters as the reference does.

Counterpart of `paddle_tpu/nn/layer/layers.py::Layer` naming (:48-50,
:106-111): each layer takes the full name `{class name lowered}_{n}`,
`n` counting the layers of that class built so far in this process, and
a parameter registered on it without a name takes
`{full name}.{attribute}` — `llamarmsnorm_0.weight`,
`llamaattention_0.q_proj`.  The first owner names a parameter: one
assigned to a second layer (a tied weight) keeps its name.

`torch.Tensor.name` exists and cannot be written, so the name lives in
the attribute `auto_name`.  It is what `apply_decay_param_fun` sees
(`Optimizer._decay_of`), as the reference passes `p.name or n`; state
dicts and `models.convert` keep the structural names, since the
counters differ between processes.
"""
from __future__ import annotations

import collections

from torch import nn

__all__ = ["Layer", "auto_name"]

_layer_name_counters = collections.defaultdict(int)


class Layer(nn.Module):
    def __init__(self):
        super().__init__()
        cls = type(self).__name__.lower()
        self._full_name = f"{cls}_{_layer_name_counters[cls]}"
        _layer_name_counters[cls] += 1

    def full_name(self) -> str:
        return self._full_name

    def register_parameter(self, name, param):
        # attribute assignment of a Parameter lands here too
        if param is not None and auto_name(param) is None:
            param.auto_name = f"{self._full_name}.{name}"
        super().register_parameter(name, param)


def auto_name(param):
    """The reference's automatic name of `param`, or None."""
    return getattr(param, "auto_name", None)
