"""Activation recomputation (gradient checkpointing) — per-call API.

Counterpart of `paddle_tpu/distributed/fleet/recompute.py::recompute`,
over `torch.utils.checkpoint` in its non-reentrant form: the call saves
its inputs only, and the backward pass runs `function` again to rebuild
what its own backward needs.  Autograd sees the parameters the function
closes over, so nothing has to thread them through by hand as the
reference does for `jax.checkpoint`.

`preserve_rng_state` (default True) restores the RNG state for the
replay, so a dropout inside the region draws the same mask twice.  The
reference's `policy` (a `jax.checkpoint` save policy) has no
counterpart and raises; `use_reentrant=True` raises too.
"""
from __future__ import annotations

from torch.utils.checkpoint import checkpoint

__all__ = ["recompute"]


def recompute(function, *args, **kwargs):
    """Run `function(*args, **kwargs)` without saving its internal
    activations; the backward pass recomputes them."""
    if kwargs.pop("policy", None) is not None:
        raise NotImplementedError("save policies (jax.checkpoint policy=) "
                                  "have no counterpart in the port")
    if kwargs.pop("use_reentrant", False):
        raise NotImplementedError("use_reentrant=True is not supported; "
                                  "the port checkpoints non-reentrantly")
    preserve = kwargs.pop("preserve_rng_state", True)
    return checkpoint(function, *args, use_reentrant=False,
                      preserve_rng_state=preserve, **kwargs)
