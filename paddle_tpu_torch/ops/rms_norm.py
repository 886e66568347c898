"""RMSNorm forward and backward, and the fused residual-add + RMSNorm:
the Hopper kernels (csrc/rms_norm.cu) and their plain PyTorch versions.

Replaces the TPU kernels of `paddle_tpu/ops/pallas/rms_norm.py`:
`rms_norm` (:130; forward `_rms2` :78 / `_fwd_kernel` :43, backward
`_rms_bwd` :105 / `_bwd_kernel` :50) and `fused_add_rms_norm` (:228;
forward `_add_rms2` :170 / `_add_fwd_kernel` :142, backward
`_add_rms_bwd` :201 / `_add_bwd_kernel` :154).

The plain forward is the reference's twin `xla_rms_norm`
(ops/__init__.py:306): fp32 statistics, a cast to the input dtype, THEN
the multiply by the weight.  The kernel casts once, after the multiply
(as `_fwd_kernel` does), so in bf16 the two differ by one rounding; in
fp32 they agree to the sum order.  The plain fused add is the twin
`xla_fused_add_rms_norm` (:328): `x + y`, then `plain_rms_norm`; the
kernel rounds the residual before its statistics, so its residual is
bit-identical to `x + y`.  `plain_rms_norm_bwd` does the math of
`_bwd_kernel` and its dw reduction (:123).

On a CUDA tensor the forward and the backward both run kernels, through
`torch.autograd.Function`s that save `(x, w)` (the residual for the
fused add) as the reference's custom VJPs do; with no graph to record
(`_build.records_grad`) the forward kernel is launched directly.  A CPU
tensor takes the plain versions and native autograd; there is no
fallback.  The backward's body is chosen by shape in the kernel
library (csrc/rms_norm.cu's header), over a persistent grid that the
library sizes from the card's occupancy; its dw is reduced and rounded
there too, never by PyTorch.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["rms_norm", "plain_rms_norm", "plain_rms_norm_bwd",
           "fused_add_rms_norm", "plain_fused_add_rms_norm", "launches"]

# kernel launches per entry point since the last reset (chip_smoke.py
# zeroes and reads them)
launches = {"rms_norm": 0, "rms_norm_bwd": 0, "fused_add_rms_norm": 0,
            "fused_add_rms_norm_bwd": 0}

def plain_rms_norm(x, weight=None, epsilon=1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    return out


def plain_rms_norm_bwd(x, weight, g, epsilon=1e-6, g_resid=None):
    """(dx, dw) of `_bwd_kernel` / `_add_bwd_kernel`: fp32 math, dx
    (+ the residual cotangent g_resid) cast to x's dtype, dw summed over
    every row in fp32 and cast to the weight's dtype."""
    H = x.shape[-1]
    xf, wf, gf = x.float(), weight.float(), g.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + epsilon)
    gw = gf * wf
    dot = torch.mean(gw * xf, dim=-1, keepdim=True)
    dx = r * gw - (r * r * r) * xf * dot
    if g_resid is not None:
        dx = dx + g_resid.float()
    dw = (gf * xf * r).reshape(-1, H).sum(0)
    return dx.to(x.dtype), dw.to(weight.dtype)


def rms_norm(x, weight, epsilon=1e-6):
    """x [..., H]; weight [H] of x's dtype."""
    if x.device.type == "cpu":
        return plain_rms_norm(x, weight, epsilon)
    if not _build.records_grad(x, weight):
        return _launch(x, weight, float(epsilon))
    return _RMSNorm.apply(x, weight, float(epsilon))


def plain_fused_add_rms_norm(x, y, weight, epsilon=1e-6):
    resid = x + y
    return resid, plain_rms_norm(resid, weight, epsilon)


def fused_add_rms_norm(x, y, weight, epsilon=1e-6):
    """(x + y, rms_norm(x + y) * weight); x, y [..., H] of one dtype,
    weight [H] of that dtype."""
    if x.device.type == "cpu":
        return plain_fused_add_rms_norm(x, y, weight, epsilon)
    if not _build.records_grad(x, y, weight):
        return _launch_add(x, y, weight, float(epsilon))
    return _FusedAddRMSNorm.apply(x, y, weight, float(epsilon))


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _launch(x, weight, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw = _launch_bwd(x, weight, g.contiguous(), None, ctx.eps)
        return dx, dw, None


class _FusedAddRMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, weight, eps):
        resid, out = _launch_add(x, y, weight, eps)
        ctx.save_for_backward(resid, weight)
        ctx.eps = eps
        return resid, out

    @staticmethod
    def backward(ctx, g_resid, g_out):
        resid, weight = ctx.saved_tensors
        dresid, dw = _launch_bwd(resid, weight, g_out.contiguous(),
                                 g_resid.contiguous(), ctx.eps)
        return dresid, dresid, dw, None


def _check(x, weight, *more):
    req = _build.require
    H = x.shape[-1]
    req(x.numel() > 0, "rms_norm kernel: empty input", x)
    req(weight.dtype == x.dtype and weight.shape == (H,),
        "rms_norm kernel takes a weight [H] of x's dtype", x, weight)
    req(all(t.shape == x.shape and t.dtype == x.dtype for t in more),
        "rms_norm kernel: operands differ in shape or dtype", x, *more)
    req(x.is_contiguous() and weight.is_contiguous()
        and all(t.is_contiguous() for t in more),
        "rms_norm kernel needs contiguous operands", x, weight, *more)
    return _build.cuda_device_index(x, weight, *more), \
        _build.dtype_code(x.dtype), H


def _launch(x, weight, epsilon):
    _build.require(weight is not None, "rms_norm kernel needs a weight")
    dev, code, H = _check(x, weight)
    out = torch.empty_like(x)
    rc = _build.library().ptt_rms_norm(
        dev, code, x.data_ptr(), weight.data_ptr(), out.data_ptr(),
        x.numel() // H, H, epsilon, _build.stream_of(x.device))
    _build.check(rc, "rms_norm")
    launches["rms_norm"] += 1
    return out


def _launch_add(x, y, weight, epsilon):
    dev, code, H = _check(x, weight, y)
    resid, out = torch.empty_like(x), torch.empty_like(x)
    rc = _build.library().ptt_add_rms_norm(
        dev, code, x.data_ptr(), y.data_ptr(), weight.data_ptr(),
        resid.data_ptr(), out.data_ptr(), x.numel() // H, H, epsilon,
        _build.stream_of(x.device))
    _build.check(rc, "fused_add_rms_norm")
    launches["fused_add_rms_norm"] += 1
    return resid, out


def _bwd_vec(H, elem_size, *tensors):
    """Whether the backward takes the 16-byte vector path: H a multiple
    of 16 bytes' elements and every operand 16-byte aligned."""
    return H % (16 // elem_size) == 0 and all(
        t.data_ptr() % 16 == 0 for t in tensors)


def _launch_bwd(x, weight, g, g_resid, epsilon):
    """(dx, dw) on the card: dx (+ g_resid) and dw, both rounded once,
    from the body the shape takes and the dw reduction after it, over
    the grid the library asks for (their fp32 scratch: one dw partial
    row per block)."""
    more = (g,) if g_resid is None else (g, g_resid)
    dev, code, H = _check(x, weight, *more)
    rows = x.numel() // H
    dx = torch.empty_like(x)
    vec = int(_bwd_vec(H, x.element_size(), x, weight, dx, *more))
    name = "rms_norm_bwd" if g_resid is None else "fused_add_rms_norm_bwd"
    lib = _build.library()
    blocks = lib.ptt_rms_norm_bwd_blocks(dev, code, H, vec,
                                         int(g_resid is not None), rows)
    _build.check(-blocks if blocks < 0 else 0, name + " grid query")
    dw_part = torch.empty((blocks, H), dtype=torch.float32, device=x.device)
    dw = torch.empty_like(weight)
    rc = lib.ptt_rms_norm_bwd(
        dev, code, x.data_ptr(), weight.data_ptr(), g.data_ptr(),
        None if g_resid is None else g_resid.data_ptr(), dx.data_ptr(),
        dw_part.data_ptr(), dw.data_ptr(), rows, H, vec, blocks, epsilon,
        _build.stream_of(x.device))
    _build.check(rc, name)
    launches[name] += 1
    return dx, dw
