"""The per-parameter updates of a train step.

Counterpart of `paddle_tpu/optimizer/jit_update.py`: `wants_master` /
`maybe_master_state` (:63-75), `_fusable` (:82-93), `apply_update`
(:96-156) with its sharded branch, and `apply_updates` (:162-236).

  - Adam/AdamW hyper-parameters with `FLAGS_use_fused_adamw` on and the
    fused state layout — {moment1, moment2[, ef]} with an fp32 param,
    or {moment1, moment2, master[, ef]} — go to `ops.fused_adamw`: one
    Hopper kernel launch per parameter on the card (its plain version
    for CPU tensors);
  - everything else runs the optimizer's pure `_update` rule; with a
    "master" in the state the rule runs on the fp32 master and the
    half-precision parameter is re-derived by a cast;
  - `FLAGS_multi_tensor_adamw` groups the SMALL fusable parameters by
    (wd, lr scale, dtypes, master?) and updates each group with one
    launch over their concatenation, then splits it back, as the
    reference does.

Everything is updated IN PLACE: parameters and state tensors are
overwritten, nothing is returned.

The reference's shard_map branch (`fused_ok=False` with a mesh: each
chip runs the fused kernel on its local shard) is `apply_shard_updates`:
under `parallel.ShardedTrainStep` at ZeRO stage >= 1 each rank holds a
flat shard of a parameter's state (and at stage 3 of the parameter), and
updates that shard alone, one fused launch per parameter shard.
"""
from __future__ import annotations

import torch

from ..framework.flags import get_flag
from ..ops.fused_adamw import fused_adamw

__all__ = ["wants_master", "maybe_master_state", "apply_update",
           "apply_updates", "apply_shard_updates"]

_HALF = (torch.bfloat16, torch.float16)

# params below this element count are batched into one flat update; the
# big matmul weights above it dominate memory traffic, not launch count
_MULTI_TENSOR_MAX = 1 << 20


def wants_master(optimizer, param) -> bool:
    return bool(getattr(optimizer, "_multi_precision", False)) \
        and param.dtype in _HALF


def maybe_master_state(optimizer, param, state: dict) -> dict:
    """Add the fp32 master copy to a freshly-initialised state dict."""
    if wants_master(optimizer, param):
        state = dict(state)
        state["master"] = param.detach().float().clone()
    return state


def _is_adam_hp(hp):
    return {"b1", "b2", "eps", "decoupled"} <= set(hp)


def _fusable(hp, state, p_dtype):
    if not (_is_adam_hp(hp) and get_flag("use_fused_adamw")):
        return False
    keys = set(state) - {"ef"}   # the error-feedback residual rides along
    if "master" in keys:
        return {"moment1", "moment2", "master"} == keys
    return {"moment1", "moment2"} == keys and p_dtype == torch.float32


def _fused_kw(hp, wd, p):
    return dict(b1=hp["b1"], b2=hp["b2"], eps=hp["eps"], wd=wd,
                decoupled=hp["decoupled"], out_dtype=p.dtype)


@torch.no_grad()
def apply_update(upd, p, g, s, lr, wd, step_i, hp):
    """One parameter's update, in place: `upd` is the optimizer class's
    `_update(param, grad, state, lr, wd, step, **hp)`."""
    if _fusable(hp, s, p.dtype):
        master = s.get("master", p)
        fused_adamw(g, s["moment1"], s["moment2"], master, lr, step_i,
                    ef=s.get("ef"), param=None if master is p else p,
                    **_fused_kw(hp, wd, p))
        return
    if "master" in s:
        rest = {k: v for k, v in s.items() if k != "master"}
        upd(s["master"], g.float(), rest, lr, wd, step_i, **hp)
        p.copy_(s["master"])
        return
    upd(p, g, s, lr, wd, step_i, **hp)


@torch.no_grad()
def apply_updates(upd, params, grads, states, lr, wds, step_i, hp,
                  lr_scales=None):
    """Every parameter's update, in place.  With FLAGS_multi_tensor_adamw
    the many small fusable params (norm scales, biases) of one (wd, lr
    scale, param dtype, master?, moment dtypes) group are raveled,
    concatenated, updated by ONE fused launch and split back; params of
    _MULTI_TENSOR_MAX elements or more, ef states and lone members keep
    their own launch.  The math is elementwise, so grouping changes no
    bit of the result."""
    if lr_scales is None:
        lr_scales = [1.0] * len(params)

    def one(i):
        ls = lr_scales[i]
        apply_update(upd, params[i], grads[i], states[i],
                     lr if ls == 1.0 else lr * ls, wds[i], step_i, hp)

    groups: dict = {}
    if get_flag("multi_tensor_adamw"):
        for i, (p, s) in enumerate(zip(params, states)):
            # ef states stay per-param, as in the reference
            if (p.numel() < _MULTI_TENSOR_MAX and "ef" not in s
                    and _fusable(hp, s, p.dtype)):
                key = (float(wds[i]), float(lr_scales[i]), p.dtype,
                       "master" in s, s["moment1"].dtype,
                       s["moment2"].dtype, p.device)
                groups.setdefault(key, []).append(i)
    grouped = set()
    for (wd, ls, _pd, has_master, *_), idxs in groups.items():
        if len(idxs) < 2:
            continue
        grouped.update(idxs)
        keys = ("moment1", "moment2") + (("master",) if has_master else ())
        flat = {k: torch.cat([states[i][k].reshape(-1) for i in idxs])
                for k in keys}
        flat_p = torch.cat([params[i].reshape(-1) for i in idxs])
        flat_g = torch.cat([grads[i].reshape(-1) for i in idxs])
        p0 = params[idxs[0]]
        fused_adamw(flat_g, flat["moment1"], flat["moment2"],
                    flat["master"] if has_master else flat_p,
                    lr if ls == 1.0 else lr * ls, step_i,
                    param=flat_p if has_master else None,
                    **_fused_kw(hp, wd, p0))
        off = 0
        for i in idxs:
            n = params[i].numel()
            params[i].copy_(flat_p[off:off + n].view_as(params[i]))
            for k in keys:
                states[i][k].copy_(flat[k][off:off + n]
                                   .view_as(states[i][k]))
            off += n
    for i in range(len(params)):
        if i not in grouped:
            one(i)


@torch.no_grad()
def apply_shard_updates(upd, shards, grads, states, lr, wds, step_i, hp):
    """The sharded branch, in place: `shards[i]` is this rank's flat
    shard of parameter i (a view into the replicated parameter at
    stages 1-2, the parameter's only copy at stage 3), `grads[i]` and
    every tensor of `states[i]` the same slice of its gradient and
    state.  One update (one fused AdamW launch) per shard; no
    multi-tensor grouping, which stays with replicated parameters."""
    for i, (p, g, s) in enumerate(zip(shards, grads, states)):
        if any(t.shape != p.shape or not t.is_contiguous()
               for t in (p, g, *s.values())):
            raise ValueError(
                f"shard {i}: parameter, gradient and state shards must "
                f"be contiguous tensors of one shape {tuple(p.shape)}")
        apply_update(upd, p, g, s, lr, wds[i], step_i, hp)
