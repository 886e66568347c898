"""Rotary position embedding (NeoX rotate-half), forward and backward:
the Hopper kernel (csrc/rope.cu) and its plain PyTorch version.

Replaces the TPU kernel `paddle_tpu/ops/pallas/rope.py::rope_apply`
(:142, `_rope3` :73 / `_rope_kernel` :45, backward `_rope_bwd` :120).
The plain version is the XLA branch of the reference's `apply_rope`
(ops/__init__.py:399-409).  The kernel rounds each product and the sum
like the plain version, so the two agree bit for bit.

The backward is the same kernel on (g_q, g_k) with sin's halves swapped
and negated (`neg_sin`), the true adjoint of the half-split rotation
(rope.py:124-127); the cos/sin cotangents are plain PyTorch, computed
only when an input table asks for a gradient (`_cos_sin_cotangent`
:105).  q and k are saved for the backward only in that case.

`apply_rope` takes the plain version for CPU tensors and launches the
kernels for CUDA tensors, or raises — there is no fallback, and unlike
the TPU kernel every row count is served.  With no graph to record
(`_build.records_grad`, as in the decode loop) it launches the forward
kernel without the autograd.Function.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["apply_rope", "plain_apply_rope", "plain_rope_bwd",
           "rope_cos_sin", "launches"]

# kernel launches per entry point since the last reset (chip_smoke.py
# zeroes and reads them)
launches = {"rope": 0, "rope_bwd": 0}


def rope_cos_sin(seq_len, head_dim, base=10000.0, dtype=torch.float32,
                 position_ids=None, device=None):
    """cos/sin tables [seq_len, head_dim] — or [..., s, head_dim] for
    explicit position_ids — of the NeoX layout (frequencies repeated
    over both halves), computed in fp32."""
    if position_ids is not None:
        device = position_ids.device
    inv_freq = 1.0 / (base ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                            device=device) / head_dim))
    pos = (torch.arange(seq_len, dtype=torch.float32, device=device)
           if position_ids is None else position_ids.to(torch.float32))
    freqs = pos[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb).to(dtype), torch.sin(emb).to(dtype)


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def plain_apply_rope(q, k, cos, sin):
    """q [b, s, h, d], k [b, s, hk, d]; cos/sin [s, d] or [b, s, d]."""
    if cos.ndim == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    elif cos.ndim == 3:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    qf, kf = q.float(), k.float()
    cosf, sinf = cos.float(), sin.float()
    q_out = (qf * cosf + _rotate_half(qf) * sinf).to(q.dtype)
    k_out = (kf * cosf + _rotate_half(kf) * sinf).to(k.dtype)
    return q_out, k_out


def _swap_halves(t):
    half = t.shape[-1] // 2
    return torch.cat([t[..., half:], t[..., :half]], dim=-1)


def plain_rope_bwd(gq, gk, cos, sin):
    """(dq, dk) of the rotation: the forward's math on (g_q, g_k) with
    sin's halves swapped and negated."""
    return plain_apply_rope(gq, gk, cos, -_swap_halves(sin))


def _cos_sin_cotangent(g, x, cos_shape):
    """d/dcos, d/dsin of one operand's rotation (rope.py:105-117),
    summed over the heads, and over the batch for [s, d] tables."""
    half = g.shape[-1] // 2
    gf, xf = g.float(), x.float()
    g1, g2 = gf[..., :half], gf[..., half:]
    x1, x2 = xf[..., :half], xf[..., half:]
    dc = torch.cat([(g1 * x1).sum(2), (g2 * x2).sum(2)], dim=-1)
    ds = torch.cat([-(g1 * x2).sum(2), (g2 * x1).sum(2)], dim=-1)
    if len(cos_shape) == 2:
        dc, ds = dc.sum(0), ds.sum(0)
    return dc, ds


def apply_rope(q, k, cos, sin):
    if q.device.type == "cpu":
        return plain_apply_rope(q, k, cos, sin)
    if not _build.records_grad(q, k, cos, sin):
        return _launch(q, k, cos, sin)
    return _Rope.apply(q, k, cos, sin)


class _Rope(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, cos, sin):
        tables = ctx.needs_input_grad[2] or ctx.needs_input_grad[3]
        ctx.save_for_backward(cos, sin, *((q, k) if tables else ()))
        return _launch(q, k, cos, sin)

    @staticmethod
    def backward(ctx, gq, gk):
        cos, sin, *qk = ctx.saved_tensors
        gq, gk = gq.contiguous(), gk.contiguous()
        dq, dk = _launch(gq, gk, cos, _swap_halves(sin).contiguous(),
                         neg_sin=True)
        dcos = dsin = None
        if qk:
            dcq, dsq = _cos_sin_cotangent(gq, qk[0], cos.shape)
            dck, dsk = _cos_sin_cotangent(gk, qk[1], cos.shape)
            dcos, dsin = (dcq + dck).to(cos.dtype), (dsq + dsk).to(sin.dtype)
        return dq, dk, dcos, dsin


def _launch(q, k, cos, sin, neg_sin=False):
    """The rotation kernel; neg_sin rotates by -sin (the backward, with
    sin's halves swapped by the caller)."""
    req = _build.require
    dev = _build.cuda_device_index(q, k, cos, sin)
    code = _build.dtype_code(q.dtype)
    req(q.ndim == 4 and k.ndim == 4,
        "rope kernel takes q/k of shape [b, s, heads, d]", q, k)
    b, s, h, d = q.shape
    hk = k.shape[2]
    req(k.shape[:2] == (b, s) and k.shape[3] == d and k.dtype == q.dtype,
        "rope kernel: q and k differ in batch, length, head_dim or dtype",
        q, k)
    req(d % 2 == 0 and q.numel() > 0 and k.numel() > 0,
        "rope kernel needs an even head_dim and non-empty q/k", q, k)
    req(cos.dtype == torch.float32 and sin.dtype == torch.float32
        and cos.shape == sin.shape and cos.shape in ((s, d), (b, s, d)),
        "rope kernel takes float32 cos/sin of shape [s, d] or [b, s, d]",
        q, cos, sin)
    req(q.is_contiguous() and k.is_contiguous() and cos.is_contiguous()
        and sin.is_contiguous(),
        "rope kernel needs contiguous q, k, cos, sin", q, k, cos, sin)
    oq, ok = torch.empty_like(q), torch.empty_like(k)
    cs_rows = s if cos.ndim == 2 else b * s
    rc = _build.library().ptt_rope(
        dev, code, q.data_ptr(), k.data_ptr(), cos.data_ptr(), sin.data_ptr(),
        oq.data_ptr(), ok.data_ptr(), b * s, h, hk, d, cs_rows, int(neg_sin),
        _build.stream_of(q.device))
    name = "rope_bwd" if neg_sin else "rope"
    _build.check(rc, name)
    launches[name] += 1
    return oq, ok
