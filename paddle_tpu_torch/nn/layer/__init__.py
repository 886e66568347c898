"""`Layer`: an `nn.Module` that names its parameters as the reference does.

Counterpart of `paddle_tpu/nn/layer/layers.py::Layer` naming (:38-50,
:106-111): `Layer(name_scope=None, dtype="float32")`; each layer takes
the full name `{name_scope or class name lowered}_{n}`, `n` counting the
layers of that scope built so far in this process, and a parameter
registered on it without a name takes
`{full name}.{attribute}` — `llamarmsnorm_0.weight`,
`linear_3.bias`.  The first owner names a parameter: one assigned to a
second layer (a tied weight) keeps its name.

`torch.Tensor.name` exists and cannot be written, so the name lives in
the attribute `auto_name`.  It is what `apply_decay_param_fun` sees
(`Optimizer._decay_of`), as the reference passes `p.name or n`; state
dicts and `models.convert` keep the structural names, since the
counters differ between processes.

`create_parameter` (reference :57-75) makes a parameter from a
`ParamAttr` (or an initializer, a name, or False for none) with the
reference's defaults: `Constant(0)` for a bias, `XavierNormal` for a
weight, in `dtype` or else the layer's.  It takes the device and the
seeded generator the random initializers draw from.

`register_buffer(name, tensor, persistable=True)` (reference :171-176)
is torch's buffer: it moves with the module, and a persistable one is in
`state_dict` (and `models.convert`) under its structural name
(`bn1._mean`); a non-persistable one is left out of both.

The layers the models are built from sit beside this module, as in the
reference: `common.py` (Linear, Embedding, Dropout), `norm.py`
(LayerNorm, the BatchNorm family), `conv.py`, `pooling.py`,
`activation.py` (ReLU, ReLU6), `container.py` (LayerList, Sequential).
"""
from __future__ import annotations

import collections

from torch import nn

__all__ = ["Layer", "auto_name"]

_layer_name_counters = collections.defaultdict(int)


class Layer(nn.Module):
    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = dtype
        scope = name_scope or type(self).__name__.lower()
        self._full_name = f"{scope}_{_layer_name_counters[scope]}"
        _layer_name_counters[scope] += 1

    def full_name(self) -> str:
        return self._full_name

    def register_parameter(self, name, param):
        # attribute assignment of a Parameter lands here too
        if param is not None and auto_name(param) is None:
            param.auto_name = f"{self._full_name}.{name}"
        super().register_parameter(name, param)

    def register_buffer(self, name, tensor, persistable=True):
        super().register_buffer(name, tensor, persistent=persistable)
        return tensor

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, *, device, generator=None):
        """A new parameter of `shape` in `dtype` (else the layer's dtype)
        on `device`, or None when `attr` is False.  The initializer: the
        attr's, else `default_initializer`, else Constant(0) for a bias
        and XavierNormal for a weight."""
        if attr is False:
            return None
        from ...framework.dtypes import to_torch
        from ...framework.param_attr import ParamAttr
        from .. import initializer as I
        attr = ParamAttr._to_attr(attr)
        init = attr.initializer or default_initializer or (
            I.Constant(0.0) if is_bias else I.XavierNormal())
        value = init(tuple(int(s) for s in shape),
                     to_torch(dtype or self._dtype or "float32"),
                     device=device, generator=generator)
        p = nn.Parameter(value, requires_grad=attr.trainable)
        if attr.name is not None:
            p.auto_name = attr.name
        return p


def auto_name(param):
    """The reference's automatic name of `param`, or None."""
    return getattr(param, "auto_name", None)
