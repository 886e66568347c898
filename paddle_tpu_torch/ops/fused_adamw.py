"""Fused AdamW: the Hopper kernel (csrc/fused_adamw.cu) and its plain
PyTorch version.

Replaces the TPU kernel `paddle_tpu/ops/pallas/fused_adamw.py::
fused_adamw` (:140) with its four bodies `_kernel_fp32`,
`_kernel_fp32_ef`, `_kernel_master` and `_kernel_master_ef` (math in
`_step_math` :67).  `fused_adamw` keeps the reference's signature and
return convention: `(param, m, v, master)`, plus the new `ef` when an
error-feedback residual is given; with `out_dtype` float32 the
parameter IS the master and the returned param and master are the same
tensor.

Unlike the reference, which returns new arrays that the compiled step
donates back, both versions update IN PLACE: `m`, `v`, `master` and
`ef` are overwritten, and so is the parameter — the fp32 parameter
passed as `master`, or, with a half-precision `out_dtype`, the tensor
passed as `param` (a new one when None).

`plain_fused_adamw` is the math of the reference's `adamw_hostside`
(:290), op by op in fp32, with the bias corrections c1 = 1 - b1^step
and c2 = 1 - b2^step computed in fp32 as the TPU wrapper computes them
(:158-160; `adamw_hostside` rounds them from double, a difference of an
ulp of c1).  The kernel rounds every op on its own in the same order
(no FMA contraction, m / c1 a true division), so on the card it is
bit-identical to the plain version.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises (no fallback).
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build

__all__ = ["fused_adamw", "plain_fused_adamw", "bias_corrections",
           "launches", "variant_launches"]

# kernel launches since the last reset (chip_smoke.py zeroes and reads
# them), in total and by the TPU kernel body each launch stands for
launches = {"fused_adamw": 0}
variant_launches = {"fp32": 0, "fp32_ef": 0, "master": 0, "master_ef": 0}


def bias_corrections(b1, b2, step):
    """(1 - b1^step, 1 - b2^step), each computed in fp32 as the TPU
    wrapper does (`jnp.float32(b1) ** stepf`), as Python floats."""
    st = np.float32(step)
    one = np.float32(1.0)
    return (float(one - np.float32(b1) ** st),
            float(one - np.float32(b2) ** st))


def _outputs(param, m, v, master, ef):
    return (param, m, v, master) + ((ef,) if ef is not None else ())


@torch.no_grad()
def plain_fused_adamw(grad, m, v, master, lr, step, *, b1=0.9, b2=0.999,
                      eps=1e-8, wd=0.0, decoupled=True,
                      out_dtype=torch.bfloat16, ef=None, param=None):
    """One AdamW step, IN PLACE, op by op in fp32 (see the module
    docstring for the arguments and the return)."""
    c1, c2 = bias_corrections(b1, b2, step)
    # the bias corrections as tensors on the state's device: a division
    # by a Python scalar would become a multiply by its reciprocal on
    # the card, and the reference divides
    c1 = torch.tensor([c1], dtype=torch.float32, device=master.device)
    c2 = torch.tensor([c2], dtype=torch.float32, device=master.device)
    g = grad.float()
    mst = master.float()
    if wd and not decoupled:
        g = g + wd * mst
    mn = b1 * m.float() + (1 - b1) * g
    v_prev = v.float()
    if ef is not None:
        v_prev = v_prev + ef.float()
    vn = b2 * v_prev + (1 - b2) * g * g
    upd = (mn / c1) / (torch.sqrt(vn / c2) + eps)
    if wd and decoupled:
        upd = upd + wd * mst
    new = mst - lr * upd
    m.copy_(mn)
    if ef is not None:
        v_low = vn.to(v.dtype)
        ef.copy_(vn - v_low.float())
        v.copy_(v_low)
    else:
        v.copy_(vn)
    master.copy_(new)
    if out_dtype == torch.float32:
        return _outputs(master, m, v, master, ef)
    if param is None:
        param = torch.empty_like(master, dtype=out_dtype)
    param.copy_(new)
    return _outputs(param, m, v, master, ef)


def fused_adamw(grad, m, v, master, lr, step, *, b1=0.9, b2=0.999,
                eps=1e-8, wd=0.0, decoupled=True, out_dtype=torch.bfloat16,
                ef=None, param=None):
    """One fused AdamW step, IN PLACE.  grad: any float dtype; m, v (and
    ef): one float dtype, the shape of grad; master: fp32 (the parameter
    itself when out_dtype is float32).  lr: float; step: int, 1-based.
    Returns (param, m, v, master[, ef])."""
    kw = dict(b1=b1, b2=b2, eps=eps, wd=wd, decoupled=decoupled,
              out_dtype=out_dtype, ef=ef, param=param)
    if master.device.type == "cpu":
        return plain_fused_adamw(grad, m, v, master, lr, step, **kw)
    return _launch(grad, m, v, master, lr, step, **kw)


def _launch(grad, m, v, master, lr, step, *, b1, b2, eps, wd, decoupled,
            out_dtype, ef, param):
    req = _build.require
    fp32_params = out_dtype == torch.float32
    state = [m, v] + ([ef] if ef is not None else [])
    req(all(t.shape == grad.shape for t in (m, v, master, *state)),
        "fused_adamw kernel: grad, moments and master differ in shape",
        grad, m, v, master)
    req(master.dtype == torch.float32,
        "fused_adamw kernel takes an fp32 master (the parameter itself "
        "for fp32 parameters)", master)
    req(all(t.dtype == m.dtype for t in state),
        "fused_adamw kernel: m, v and ef must share one dtype", *state)
    if fp32_params:
        req(param is None or param is master,
            "fused_adamw kernel: with fp32 parameters the parameter is "
            "the master", master)
        p_code = -1
    else:
        if param is None:
            param = torch.empty_like(master, dtype=out_dtype)
        req(param.dtype == out_dtype and out_dtype in _build.DTYPE_CODES
            and param.shape == master.shape,
            "fused_adamw kernel writes a bf16 or fp16 parameter of the "
            "master's shape", param, master)
        p_code = _build.dtype_code(out_dtype)
    tensors = [grad, master, *state] + ([] if fp32_params else [param])
    req(all(t.is_contiguous() for t in tensors),
        "fused_adamw kernel needs contiguous operands", *tensors)
    req(grad.numel() > 0, "fused_adamw kernel: empty tensor", grad)
    dev = _build.cuda_device_index(*tensors)
    c1, c2 = bias_corrections(b1, b2, step)
    rc = _build.library().ptt_fused_adamw(
        dev, _build.dtype_code(grad.dtype), _build.dtype_code(m.dtype),
        p_code, grad.data_ptr(), m.data_ptr(), v.data_ptr(),
        None if ef is None else ef.data_ptr(), master.data_ptr(),
        None if fp32_params else param.data_ptr(), grad.numel(),
        float(lr), c1, c2, float(b1), float(1 - b1), float(b2),
        float(1 - b2), float(eps), float(wd), int(bool(decoupled)),
        _build.stream_of(grad.device))
    _build.check(rc, "fused_adamw")
    launches["fused_adamw"] += 1
    variant_launches[("fp32" if fp32_params else "master")
                     + ("_ef" if ef is not None else "")] += 1
    return _outputs(master if fp32_params else param, m, v, master, ef)
