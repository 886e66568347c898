"""The per-parameter update of a train step.

Counterpart of `paddle_tpu/optimizer/jit_update.py`: `wants_master` /
`maybe_master_state` (:63-75) and the pure-rule branch of
`apply_update` (:149-156).  With `multi_precision` and a half-precision
parameter the state carries an fp32 "master" copy: the rule runs on the
master and the parameter is re-derived by a cast.  Everything is
updated IN PLACE.  The fused AdamW kernel branch (`FLAGS_use_fused_adamw`)
is not ported yet.
"""
from __future__ import annotations

import torch

__all__ = ["wants_master", "maybe_master_state", "apply_update"]

_HALF = (torch.bfloat16, torch.float16)


def wants_master(optimizer, param) -> bool:
    return bool(getattr(optimizer, "_multi_precision", False)) \
        and param.dtype in _HALF


def maybe_master_state(optimizer, param, state: dict) -> dict:
    """Add the fp32 master copy to a freshly-initialised state dict."""
    if wants_master(optimizer, param):
        state = dict(state)
        state["master"] = param.detach().float().clone()
    return state


@torch.no_grad()
def apply_update(upd, p, g, s, lr, wd, step_i, hp):
    """One parameter's update, in place: `upd` is the optimizer class's
    `_update(param, grad, state, lr, wd, step, **hp)`."""
    if "master" in s:
        rest = {k: v for k, v in s.items() if k != "master"}
        upd(s["master"], g.float(), rest, lr, wd, step_i, **hp)
        p.copy_(s["master"])
        return
    upd(p, g, s, lr, wd, step_i, **hp)
