"""paddle_tpu_torch.ops — the op layer of the decode and training paths.

Counterpart of `paddle_tpu/ops/__init__.py`.  Each op whose reference
reaches a Pallas TPU kernel has a hand-written Hopper kernel here
(csrc/*.cu) with a plain PyTorch version beside it in the same module:

  rms_norm            ops/rms_norm.py        (ref :316, twin xla_rms_norm :306)
  fused_add_rms_norm  ops/rms_norm.py        (ref :337, twin :328)
  apply_rope          ops/rope.py            (ref :383, XLA branch :399-409)
  paged_attention     ops/paged_attention.py (ref :269, twin xla_paged_attention :244;
                                              bf16/fp16/fp32 pools and int8
                                              pools with page scales)
  quant_matmul        ops/quant_matmul.py    (ref :487, twin xla_quant_matmul :473;
                                              int8 and packed int4 weights)
  attention           ops/flash_attention.py (ref :289, twin xla_attention :80)
  fused_adamw         ops/fused_adamw.py     (ref pallas/fused_adamw.py:140,
                                              twin adamw_hostside :290)
  ce_rows             ops/fused_cross_entropy.py (ref pallas/
                      fused_cross_entropy.py _ce_rows_pallas :95, twin
                      _ce_rows_jnp :116), inside fused_linear_cross_entropy

The training ops have kernels for their backward too (autograd
Functions in the same modules).  Dispatch: a CPU tensor takes the plain
version and native autograd; a CUDA tensor launches the kernel or
raises, forward and backward.  There is no fallback — an argument the
kernel does not take is an error, not a detour to the plain version.

The rest (`gqa_scores`, `gqa_weighted_v`, `cached_attention`,
`paged_kv_update` with its int8 page write, `rope_cos_sin`, `swiglu`,
`layer_norm`, the int4 packing helpers) is plain PyTorch, as the
reference leaves it to XLA; projections, the MLP and the lm head are
plain matmuls unless weight-only quantization packed them (then
`quant_matmul`).
"""
from __future__ import annotations

import importlib

import torch

from .attention import (cached_attention, dense_kv_update, dequant_pages,
                        gqa_scores, gqa_weighted_v, paged_kv_update,
                        paged_kv_write, paged_kv_write_int8,
                        paged_write_rows, paged_write_window)
from .flash_attention import (attention, plain_attention, plain_flash_bwd,
                              plain_flash_fwd)
from .fused_adamw import fused_adamw, plain_fused_adamw
from .fused_cross_entropy import (ce_rows, fused_linear_cross_entropy,
                                  plain_ce_rows)
from .paged_attention import paged_attention, plain_paged_attention
from .quant_matmul import (dequant_weight, pack_int4, plain_quant_matmul,
                           quant_matmul, unpack_int4)
from .rms_norm import (fused_add_rms_norm, plain_fused_add_rms_norm,
                       plain_rms_norm, plain_rms_norm_bwd, rms_norm)
from .rope import apply_rope, plain_apply_rope, plain_rope_bwd, rope_cos_sin

__all__ = ["gqa_scores", "gqa_weighted_v", "cached_attention",
           "paged_kv_update", "paged_write_rows", "paged_kv_write",
           "paged_write_window", "paged_kv_write_int8", "dense_kv_update",
           "paged_attention", "plain_paged_attention", "dequant_pages",
           "quant_matmul", "plain_quant_matmul", "pack_int4", "unpack_int4",
           "dequant_weight",
           "rms_norm", "plain_rms_norm", "plain_rms_norm_bwd",
           "fused_add_rms_norm", "plain_fused_add_rms_norm",
           "apply_rope", "plain_apply_rope", "plain_rope_bwd",
           "rope_cos_sin", "swiglu", "layer_norm",
           "attention", "plain_attention",
           "plain_flash_fwd", "plain_flash_bwd",
           "fused_adamw", "plain_fused_adamw",
           "fused_linear_cross_entropy", "ce_rows", "plain_ce_rows",
           "KERNELS", "kernel_module", "launch_counts",
           "reset_launch_counts"]

# every kernel entry point (forward and backward), by the module that
# launches and counts it
KERNELS = {"rms_norm": "rms_norm", "rms_norm_bwd": "rms_norm",
           "fused_add_rms_norm": "rms_norm",
           "fused_add_rms_norm_bwd": "rms_norm",
           "rope": "rope", "rope_bwd": "rope",
           "paged_attention": "paged_attention",
           "flash_attention": "flash_attention",
           "flash_attention_bwd": "flash_attention",
           "fused_adamw": "fused_adamw",
           "cross_entropy": "fused_cross_entropy",
           "quant_matmul": "quant_matmul"}


def kernel_module(name):
    """The module of kernel-bearing module `name` (a wrapper function
    shadows the module's attribute on this package, so look it up by
    path)."""
    if name not in set(KERNELS.values()):
        raise KeyError(f"unknown kernel module {name!r}; one of "
                       f"{sorted(set(KERNELS.values()))}")
    return importlib.import_module(f"{__name__}.{name}")


def launch_counts():
    """{kernel entry point: launches since the last reset}."""
    return {n: kernel_module(m).launches[n] for n, m in KERNELS.items()}


def reset_launch_counts():
    """Zero every counter, the per-variant ones (fused_adamw,
    paged_attention, quant_matmul) too."""
    for n, m in KERNELS.items():
        mod = kernel_module(m)
        mod.launches[n] = 0
        for k in getattr(mod, "variant_launches", {}):
            mod.variant_launches[k] = 0


def swiglu(x, gate=None):
    """silu(x) * gate; with gate None the last axis splits in half."""
    if gate is None:
        half = x.shape[-1] // 2
        x, gate = x[..., :half], x[..., half:]
    return torch.nn.functional.silu(x) * gate


def layer_norm(x, weight=None, bias=None, epsilon=1e-5,
               normalized_shape=None):
    """The reference's `ops.layer_norm` (:351-360) over the last dims
    `normalized_shape` (default: the last one): mean and variance in
    fp32 for a bf16/fp16 x, the normalized value rounded to x's dtype,
    then `* weight` and `+ bias` in the promoted dtype (an fp32 weight
    makes a bf16 x's result fp32, as jnp promotes it).  The statistics
    and the normalization are one `torch.nn.functional.layer_norm`
    call, which keeps them in fp32 for a half-precision x."""
    shape = tuple(normalized_shape) if normalized_shape is not None \
        else tuple(x.shape[-1:])
    out = torch.nn.functional.layer_norm(x, shape, eps=epsilon)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out
