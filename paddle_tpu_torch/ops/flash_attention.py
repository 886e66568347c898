"""Attention for training: the Hopper flash-attention kernels
(csrc/flash_attention.cu), forward and backward, and their plain
PyTorch versions.

Replaces the TPU kernel
`paddle_tpu/ops/pallas/flash_attention.py::flash_attention` (:816):
forward `_fwd` :540 (and `_fwd_small` :131, `_fwd_1b` :367), backward
`_bwd` :679 (dq :697, dk/dv :737; `_bwd_small` :271, `_bwd_1b` :425).

  plain_attention   the reference twin `xla_attention`
                    (ops/__init__.py:80-102): fp32 softmax, causal
                    masked bottom-right when sq != sk, a bool or additive
                    mask; the weights are rounded to v's dtype before P.V
  plain_flash_bwd   the kernels' backward math (recompute from the saved
                    logsumexp; p and ds rounded to the operand dtype
                    before their products, :618, :664, :670)
  attention         the reference's `ops.attention` (:289), q [b, sq,
                    h, d], k/v [b, sk, hk, d] (h % hk == 0): the plain
                    version for CPU tensors; on CUDA a
                    torch.autograd.Function over the kernels, saving
                    (q, k, v, out, lse) as the TPU custom VJP does (:795).
                    It refuses a mask, dropout and causal with sq != sk
                    (the JAX kernel refuses them too, :832-837).  The
                    reference's `except ValueError` detour to the twin
                    (:296-299) is not carried over: those calls raise.

Dropout is not ported (dropout_p > 0 raises NotImplementedError).
"""
from __future__ import annotations

import torch

from . import _build
from .attention import NEG_INF, gqa_scores, gqa_weighted_v

__all__ = ["attention", "plain_attention",
           "plain_flash_fwd", "plain_flash_bwd", "launches"]

# kernel launches per entry point since the last reset (chip_smoke.py
# zeroes and reads them)
launches = {"flash_attention": 0, "flash_attention_bwd": 0}


def _scale(q, scale):
    return scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)


def plain_attention(q, k, v, mask=None, causal=False, scale=None,
                    dropout_p=0.0):
    """q [b, sq, h, d], k/v [b, sk, hk, d] → [b, sq, h, d] in q.dtype."""
    if dropout_p > 0.0:
        raise NotImplementedError("attention dropout is not ported yet")
    sq, sk = q.shape[1], k.shape[1]
    logits = gqa_scores(q, k) * _scale(q, scale)
    if causal:
        cm = torch.ones((sq, sk), dtype=torch.bool, device=q.device) \
            .tril(diagonal=sk - sq)
        logits = torch.where(cm[None, None], logits, NEG_INF)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = torch.where(mask, logits, NEG_INF)
        else:
            logits = logits + mask.to(logits.dtype)
    w = torch.softmax(logits, dim=-1)
    out = gqa_weighted_v(w.to(v.dtype), v)
    return out.transpose(1, 2).to(q.dtype)


def _masked_scores(q, k, causal, scale):
    """scale·q·kᵀ [b, h, sq, sk] fp32, NEG_INF above the top-left
    diagonal when causal (the kernels' convention)."""
    s = gqa_scores(q, k) * scale
    if causal:
        cm = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                        device=q.device).tril()
        s = torch.where(cm[None, None], s, NEG_INF)
    return s


def plain_flash_fwd(q, k, v, causal=False, scale=None):
    """(out, lse): the attention and the fp32 logsumexp [b, h, sq] of
    the scaled, masked logits that the forward kernel saves."""
    s = _scale(q, scale)
    lse = torch.logsumexp(_masked_scores(q, k, causal, s), dim=-1)
    return plain_attention(q, k, v, causal=causal, scale=s), lse


def plain_flash_bwd(q, k, v, out, lse, dout, causal=False, scale=None):
    """(dq, dk, dv) of `_bwd_dq_kernel` / `_bwd_dkv_kernel`, in the
    operands' dtypes: p = exp(s - lse), delta = rowsum(dO·O),
    ds = p·(dO·vᵀ - delta)·scale; dq = ds·k, dk = Σ_group dsᵀ·q,
    dv = Σ_group pᵀ·dO, with p and ds rounded to the operand dtype."""
    s = _scale(q, scale)
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    G = h // hk
    p = torch.exp(_masked_scores(q, k, causal, s) - lse[..., None])
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
    ds = p * (gqa_scores(dout, v) - delta[..., None]) * s
    p_r = p.to(v.dtype).float().reshape(b, hk, G, sq, sk)
    ds_r = ds.to(q.dtype).float()
    dq = gqa_weighted_v(ds_r, k.float()).transpose(1, 2)
    qg = q.float().reshape(b, sq, hk, G, d)
    dog = dout.float().reshape(b, sq, hk, G, d)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds_r.reshape(b, hk, G, sq, sk), qg)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p_r, dog)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention(q, k, v, mask=None, causal=False, scale=None, dropout_p=0.0):
    if q.device.type == "cpu":
        return plain_attention(q, k, v, mask, causal, scale, dropout_p)
    if dropout_p > 0.0:
        raise NotImplementedError("attention dropout is not ported yet")
    if mask is not None:
        raise ValueError("the flash_attention kernel takes no mask")
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError("flash_attention kernel: causal attention needs "
                         f"sq == sk (got {q.shape[1]} and {k.shape[1]}); "
                         "the kernel masks top-left aligned")
    return _FlashAttention.apply(q, k, v, bool(causal),
                                 float(_scale(q, scale)))


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = _launch_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _launch_bwd(q, k, v, out, lse, dout.contiguous(),
                                 ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def _check(q, k, v, *more):
    req = _build.require
    req(q.ndim == 4 and k.ndim == 4 and v.shape == k.shape,
        "flash_attention kernel takes q [b, sq, h, d] and k/v "
        "[b, sk, hk, d]", q, k, v)
    b, sq, h, d = q.shape
    req(k.shape[0] == b and k.shape[3] == d and h % k.shape[2] == 0,
        "flash_attention kernel: k/v differ from q in batch or head_dim, "
        "or kv heads do not divide q heads", q, k)
    req(d in (64, 128), "flash_attention kernel takes head_dim 64 or 128",
        q)
    req(k.dtype == q.dtype and v.dtype == q.dtype
        and all(t.dtype == q.dtype and t.shape == q.shape for t in more),
        "flash_attention kernel: operands differ in dtype or shape",
        q, k, v, *more)
    req(q.numel() > 0 and k.numel() > 0,
        "flash_attention kernel: empty input", q, k)
    req(all(t.is_contiguous() for t in (q, k, v, *more)),
        "flash_attention kernel needs contiguous operands", q, k, v, *more)
    return (_build.cuda_device_index(q, k, v, *more),
            _build.dtype_code(q.dtype))


def _launch_fwd(q, k, v, causal, scale):
    dev, code = _check(q, k, v)
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    rc = _build.library().ptt_flash_fwd(
        dev, code, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, sq, sk, h, hk, d, scale, int(causal),
        _build.stream_of(q.device))
    _build.check(rc, "flash_attention")
    launches["flash_attention"] += 1
    return out, lse


def _launch_bwd(q, k, v, out, lse, dout, causal, scale):
    dev, code = _check(q, k, v, out, dout)
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    _build.require(lse.shape == (b, h, sq) and lse.dtype == torch.float32
                   and lse.is_contiguous(),
                   "flash_attention kernel: lse must be fp32 [b, h, sq]",
                   lse)
    # rowsum(dO·O) in fp32 (the TPU wrapper's, :686): scratch that the
    # first kernel of the launch fills for the second
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    rc = _build.library().ptt_flash_bwd(
        dev, code, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, sq, sk, h, hk, d, scale, int(causal),
        _build.stream_of(q.device))
    _build.check(rc, "flash_attention_bwd")
    launches["flash_attention_bwd"] += 1
    return dq, dk, dv
