"""Optimizer base, SGD, Momentum, Adam and AdamW.

Counterpart of `paddle_tpu/optimizer/optimizer.py`: the parts of
`Optimizer` (:30) a train step needs (`get_lr`, `_wd_value`, the step
count, `apply_decay_param_fun`), `SGD` (:205), `Momentum` (:216, with
`use_nesterov`; the velocity in the parameter's dtype), `Adam` (:246)
with `moment_dtype`, `moment_ef` and its `ef` residual, and `AdamW`
(:319).  A float `weight_decay` of SGD and Momentum is L2 folded into
the gradient (g + wd p), as the reference's rules do.

The update rule `_update` is the reference's pure rule, in fp32, but
written IN PLACE: it overwrites the parameter and the state tensors
(moments stored in `moment_dtype`) instead of returning new ones.  A
train step sends Adam/AdamW updates to the fused kernel instead
(optimizer/jit_update.py) where the state layout allows it.
`FLAGS_bf16_adamw_moments` is read at construction, as at the
reference's :261-275.  Gradient clipping, LR schedulers and `lr_ratio`
are not ported yet (they raise).
"""
from __future__ import annotations

import torch

from ..framework.flags import get_flag
from ..nn.layer import auto_name

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW"]

_DTYPES = {None: torch.float32, "float32": torch.float32,
           "bfloat16": torch.bfloat16, "float16": torch.float16}


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None, **kwargs):
        if parameters is None:
            raise ValueError("parameters is required (pass "
                             "model.parameters())")
        if grad_clip is not None:
            raise NotImplementedError("grad_clip is not ported yet")
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError("LR schedulers are not ported yet; "
                                      "pass a float learning rate")
        self._parameter_list = list(parameters)
        self._learning_rate = float(learning_rate)
        self._weight_decay = weight_decay
        self._step_count = 0
        self._multi_precision = kwargs.get("multi_precision", False)

    def get_lr(self) -> float:
        return self._learning_rate

    def _init_state(self, p: torch.Tensor) -> dict:
        return {}

    def _hyper(self) -> dict:
        return {}

    @staticmethod
    def _update(param, grad, state, lr, wd, step, **hp):
        raise NotImplementedError

    def _wd_value(self, p) -> float:
        wd = self._weight_decay
        if wd is None:
            return 0.0
        if isinstance(wd, (int, float)):
            return float(wd)
        # L2Decay regularizer object
        return float(getattr(wd, "_coeff", getattr(wd, "coeff", 0.0)))

    def _decay_of(self, name: str, p) -> float:
        """The weight decay of parameter `p` (structural name `name`), 0
        where apply_decay_param_fun leaves it out or an optimizer's
        `_exclude_fn` (the reference's exclude_from_weight_decay_fn)
        excludes it.  Both see the reference's automatic name where `p`
        has one (nn/layer.py), else `name`: the reference's
        `p.name or n`."""
        key = auto_name(p) or name
        fn = getattr(self, "_apply_decay_param_fun", None)
        if fn is not None and not fn(key):
            return 0.0
        ex = getattr(self, "_exclude_fn", None)
        if ex is not None and ex(key):
            return 0.0
        return self._wd_value(p)


class SGD(Optimizer):
    @staticmethod
    @torch.no_grad()
    def _update(param, grad, state, lr, wd, step):
        """param - lr (g + wd param), IN PLACE, in the reference's order."""
        g = grad
        if wd:
            g = g + wd * param
        param.copy_(param - lr * g.to(param.dtype))


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, **kw)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_state(self, p):
        return {"velocity": torch.zeros_like(p)}

    def _hyper(self):
        return {"mu": self._momentum, "nesterov": self._nesterov}

    @staticmethod
    @torch.no_grad()
    def _update(param, grad, state, lr, wd, step, mu=0.9, nesterov=False):
        """v = mu v + g (g + wd param with decay); param - lr v, or
        param - lr (g + mu v) with Nesterov; IN PLACE, in the reference's
        order."""
        g = grad
        if wd:
            g = g + wd * param
        v = mu * state["velocity"] + g
        upd = g + mu * v if nesterov else v
        param.copy_(param - lr * upd.to(param.dtype))
        state["velocity"].copy_(v)


class Adam(Optimizer):
    """L2 regularization folded into the gradient (reference
    optimizer/adam.py)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None, moment_dtype=None, moment_ef=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision=multi_precision, **kw)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        # storage dtype of the moments (default fp32); the math runs in
        # fp32.  moment_ef adds the error-feedback residual of the
        # second moment for a sub-fp32 moment_dtype.
        # FLAGS_bf16_adamw_moments (read here, at construction): bf16
        # moments by default, with the residual unless moment_ef says
        # otherwise
        flag_on = bool(get_flag("bf16_adamw_moments"))
        if flag_on and moment_dtype is None:
            moment_dtype = "bfloat16"
        if moment_ef is None:
            moment_ef = flag_on
        if moment_dtype not in _DTYPES:
            raise ValueError(f"moment_dtype {moment_dtype!r}: one of "
                             f"{sorted(k for k in _DTYPES if k)}")
        self._moment_dtype = moment_dtype
        self._moment_ef = bool(moment_ef) \
            and _DTYPES[moment_dtype] != torch.float32

    def _init_state(self, p):
        md = _DTYPES[self._moment_dtype]
        st = {"moment1": torch.zeros_like(p, dtype=md),
              "moment2": torch.zeros_like(p, dtype=md)}
        if self._moment_ef:
            st["ef"] = torch.zeros_like(p, dtype=md)
        return st

    def _hyper(self):
        return {"b1": self._beta1, "b2": self._beta2, "eps": self._epsilon,
                "decoupled": False}

    @staticmethod
    @torch.no_grad()
    def _update(param, grad, state, lr, wd, step, b1=0.9, b2=0.999,
                eps=1e-8, decoupled=True):
        """One step of the rule, IN PLACE on `param` and `state`."""
        gf = grad.float()
        pf = param.float()
        if wd and not decoupled:
            gf = gf + wd * pf
        m = b1 * state["moment1"].float() + (1 - b1) * gf
        v_prev = state["moment2"].float()
        if "ef" in state:
            # error feedback: stored moment + residual IS the full-
            # precision second moment
            v_prev = v_prev + state["ef"].float()
        v = b2 * v_prev + (1 - b2) * gf * gf
        mhat = m / (1 - b1 ** step)
        vhat = v / (1 - b2 ** step)
        upd = mhat / (torch.sqrt(vhat) + eps)
        if wd and decoupled:
            upd = upd + wd * pf
        param.copy_(pf - lr * upd)
        state["moment1"].copy_(m)
        state["moment2"].copy_(v)
        if "ef" in state:
            state["ef"].copy_(v - state["moment2"].float())


class AdamW(Adam):
    """Decoupled weight decay (reference optimizer/adamw.py:49)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None, **kw):
        if lr_ratio is not None:
            raise NotImplementedError("lr_ratio is not ported yet")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         name, **kw)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _hyper(self):
        return {"b1": self._beta1, "b2": self._beta2, "eps": self._epsilon,
                "decoupled": True}
