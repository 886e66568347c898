"""Rotary position embedding (NeoX rotate-half) forward: the Hopper
kernel (csrc/rope.cu) and its plain PyTorch version.

Replaces the TPU kernel `paddle_tpu/ops/pallas/rope.py::rope_apply`
(:142, `_rope3` :73 / `_rope_kernel` :45).  The plain version is the
XLA branch of the reference's `apply_rope` (ops/__init__.py:399-409).
The kernel rounds each product and the sum like the plain version, so
the two agree bit for bit.

`apply_rope` takes the plain version for CPU tensors and launches the
kernel for CUDA tensors, or raises — there is no fallback, and unlike
the TPU kernel every row count is served.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["apply_rope", "plain_apply_rope", "rope_cos_sin", "launches"]

# kernel launches since the last reset (chip_smoke.py zeroes and reads it)
launches = 0


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


def apply_rope(q, k, cos, sin):
    if q.device.type == "cpu":
        return plain_apply_rope(q, k, cos, sin)
    return _launch(q, k, cos, sin)


def _launch(q, k, cos, sin):
    global launches
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
        oq.data_ptr(), ok.data_ptr(), b * s, h, hk, d, cs_rows,
        _build.stream_of(q.device))
    _build.check(rc, "rope")
    launches += 1
    return oq, ok
