"""ParamAttr: how a layer creates one parameter.

Counterpart of `paddle_tpu/framework/param_attr.py::ParamAttr` (:10)
and its `_to_attr` (:23): a name, an initializer and the trainable
switch (`do_model_average` and `need_clip` are taken and have no effect:
the port has no model averaging and no gradient clipping yet).  A
per-parameter learning rate and a regularizer are not ported yet (a
ParamAttr that sets either raises NotImplementedError; ROADMAP queue 1
item 7, with `lr_ratio`).
"""
from __future__ import annotations

__all__ = ["ParamAttr"]


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        if learning_rate != 1.0 or regularizer is not None:
            raise NotImplementedError(
                "ParamAttr: a per-parameter learning_rate or regularizer is "
                "not ported yet (ROADMAP queue 1 item 7)")
        self.name = name
        self.initializer = initializer
        self.trainable = trainable

    @staticmethod
    def _to_attr(attr):
        """None -> the default attr, a str -> a named one, an initializer
        -> an attr with it; `False` (no parameter) is the caller's."""
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if callable(attr):
            return ParamAttr(initializer=attr)
        raise TypeError(f"bad param attr {attr!r}")
