"""paddle_tpu_torch.ops — the op layer of the decode path.

Counterpart of `paddle_tpu/ops/__init__.py`.  Each op whose reference
reaches a Pallas TPU kernel has a hand-written Hopper kernel here
(csrc/*.cu) with a plain PyTorch version beside it in the same module:

  rms_norm         ops/rms_norm.py        (ref :316, twin xla_rms_norm :306)
  apply_rope       ops/rope.py            (ref :383, XLA branch :399-409)
  paged_attention  ops/paged_attention.py (ref :269, twin xla_paged_attention :244)

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises.  There is no fallback — an argument the kernel
does not take is an error, not a detour to the plain version.

The rest (`gqa_scores`, `gqa_weighted_v`, `cached_attention`,
`paged_kv_update`, `rope_cos_sin`, `swiglu`) is plain PyTorch, as the
reference leaves it to XLA; projections, the MLP and the lm head are
plain matmuls.
"""
from __future__ import annotations

import importlib

import torch

from .attention import (cached_attention, dense_kv_update, gqa_scores,
                        gqa_weighted_v, paged_kv_update, paged_kv_write,
                        paged_write_rows)
from .paged_attention import paged_attention, plain_paged_attention
from .rms_norm import plain_rms_norm, rms_norm
from .rope import apply_rope, plain_apply_rope, rope_cos_sin

__all__ = ["gqa_scores", "gqa_weighted_v", "cached_attention",
           "paged_kv_update", "paged_write_rows", "paged_kv_write",
           "dense_kv_update",
           "paged_attention", "plain_paged_attention",
           "rms_norm", "plain_rms_norm",
           "apply_rope", "plain_apply_rope", "rope_cos_sin", "swiglu",
           "KERNELS", "kernel_module", "launch_counts",
           "reset_launch_counts"]

# the kernel-bearing modules, by the name of their wrapper
KERNELS = ("rms_norm", "rope", "paged_attention")


def kernel_module(name):
    """The module of kernel `name` (its wrapper function shadows the
    module's attribute on this package, so look it up by path)."""
    if name not in KERNELS:
        raise KeyError(f"unknown kernel {name!r}; one of {KERNELS}")
    return importlib.import_module(f"{__name__}.{name}")


def launch_counts():
    """{kernel: launches since the last reset}."""
    return {n: kernel_module(n).launches for n in KERNELS}


def reset_launch_counts():
    for n in KERNELS:
        kernel_module(n).launches = 0


def swiglu(x, gate=None):
    """silu(x) * gate; with gate None the last axis splits in half."""
    if gate is None:
        half = x.shape[-1] // 2
        x, gate = x[..., :half], x[..., half:]
    return torch.nn.functional.silu(x) * gate
