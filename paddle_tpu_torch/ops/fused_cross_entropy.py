"""Chunked fused linear + cross-entropy: the loss is computed from the
hidden states in row chunks, so the [N, V] fp32 logits never exist.

Counterpart of `paddle_tpu/ops/pallas/fused_cross_entropy.py`:
`fused_linear_cross_entropy` (:396), `_pad_rows`, `_scale_of`,
`_chunk_fwdgrad`, `_chunk_loss_only`, the online vocab-chunk variant
(`_online_stats`, `_chunk_fwdgrad_online`, :203-285) and the `_flce`
custom VJP (:362-393), here a `torch.autograd.Function` whose gradient
work happens in the forward pass; its backward only multiplies by the
upstream scalar.

Per row chunk c (of `chunk_rows`, 1024 by default):

    logits_c = h_c @ W (+ b)          fp32 result (cuBLAS on the card)
    loss_c, dlog_c = ce_rows(logits_c, labels_c, scale)     the kernel
    dh_c     = dlog_c @ W^T           fp32 result, cast to h's dtype
    dW      += h_c^T @ dlog_c         summed over chunks in fp32, cast
                                      to W's dtype at the end

`ce_rows` replaces the TPU kernel `_ce_rows_pallas` (:95), body
`_ce_kernel` (:78), with csrc/cross_entropy.cu, which picks its body,
vector width, block and cluster from the shape and the operands'
alignment (csrc/cross_entropy_plan.cuh); `plain_ce_rows` is its plain
version, the math of the reference's twin `_ce_rows_jnp` (:116).
The matmuls stay plain PyTorch, as the reference leaves them to XLA.
The logits are fp32 products of the operands, as the reference's
`jnp.dot(..., preferred_element_type=f32)`: on the card
`torch.mm(..., out_dtype=torch.float32)`, on the CPU fp32 operands.
`scale` = 1 / max(#valid labels, 1) over the padded labels, a tensor on
the device: nothing synchronises with the host (under a data-parallel
trainer the count is the group's: framework/data_parallel.py).

The online `vocab_chunk` variant folds a running (max, denominator,
picked logit) over vocab slices and never holds a [chunk, V] buffer; it
is plain PyTorch on every device, as the reference's is jnp only.
`axis_name` (the vocab-sharded ParallelCrossEntropy mode) raises
NotImplementedError: it waits for tensor parallelism.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import _build
from ..framework.data_parallel import mean_denominator

__all__ = ["fused_linear_cross_entropy", "ce_rows", "plain_ce_rows",
           "launches"]

# kernel launches since the last reset (chip_smoke.py zeroes and reads
# them)
launches = {"cross_entropy": 0}

# rows per chunk: bounds the transient fp32 logits slice to
# [_DEFAULT_CHUNK, V] (32 MB at V = 8192) whatever batch * seq is
_DEFAULT_CHUNK = 1024


class _CEConfig(NamedTuple):
    chunk_rows: int
    vocab_chunk: Optional[int]


# ---------------------------------------------------------------------------
# the rows: kernel and plain version

def plain_ce_rows(logits, labels, scale, out_dtype):
    """(loss_rows fp32 [C], dlogits [C, V] out_dtype) of fp32 logits
    [C, V] and int labels [C]: per row (lse - logit[label]) * scale and
    (softmax - onehot) * scale, zero where the label is negative."""
    x = logits.float()
    m = x.amax(-1, keepdim=True)
    e = torch.exp(x - m)
    s = e.sum(-1, keepdim=True)
    lse = (m + torch.log(s))[:, 0]
    valid = labels >= 0
    safe = labels.clamp_min(0).long()
    picked = torch.gather(x, -1, safe[:, None])[:, 0]
    loss_rows = torch.where(valid, lse - picked, 0.0) * scale
    onehot = torch.nn.functional.one_hot(safe, x.shape[-1]).float()
    d = (e / s - onehot) * scale
    return loss_rows, torch.where(valid[:, None], d, 0.0).to(out_dtype)


def ce_rows(logits, labels, scale, out_dtype):
    """The kernel on a CUDA tensor, the plain version on a CPU one.
    logits fp32 [C, V]; labels int32 [C]; scale an fp32 tensor of one
    element on the same device."""
    if logits.device.type == "cpu":
        return plain_ce_rows(logits, labels, scale, out_dtype)
    return _launch(logits, labels, scale, out_dtype)


def _launch(logits, labels, scale, out_dtype):
    req = _build.require
    req(logits.ndim == 2 and logits.dtype == torch.float32
        and logits.numel() > 0,
        "cross_entropy kernel takes non-empty fp32 logits [C, V]", logits)
    C, V = logits.shape
    req(labels.shape == (C,) and labels.dtype == torch.int32,
        "cross_entropy kernel takes int32 labels [C]", logits, labels)
    req(scale.numel() == 1 and scale.dtype == torch.float32,
        "cross_entropy kernel takes an fp32 scale of one element", scale)
    req(logits.is_contiguous() and labels.is_contiguous()
        and scale.is_contiguous(),
        "cross_entropy kernel needs contiguous operands", logits, labels)
    dev = _build.cuda_device_index(logits, labels, scale)
    code = _build.dtype_code(out_dtype)
    loss = torch.empty((C,), dtype=torch.float32, device=logits.device)
    dlog = torch.empty((C, V), dtype=out_dtype, device=logits.device)
    rc = _build.library().ptt_ce_rows(
        dev, code, logits.data_ptr(), labels.data_ptr(), scale.data_ptr(),
        loss.data_ptr(), dlog.data_ptr(), C, V,
        _build.stream_of(logits.device))
    _build.check(rc, "cross_entropy")
    launches["cross_entropy"] += 1
    return loss, dlog


# ---------------------------------------------------------------------------
# the chunk: matmuls around the rows

def _mm_f32(a, b):
    """a @ b as an fp32 result with fp32 accumulation (the reference's
    preferred_element_type=f32): cuBLAS's fp32-output GEMM on the card,
    fp32 operands (exact widenings) on the CPU."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _vocab_chunked(cfg, v):
    return bool(cfg.vocab_chunk) and v > cfg.vocab_chunk


def _chunk_fwdgrad(h_c, w, b, lbl_c, scale, cfg):
    """One row chunk: (loss_sum, dh_c, dW partial fp32, db partial fp32
    or None), all carrying the 1/n_valid scale."""
    if _vocab_chunked(cfg, w.shape[1]):
        return _chunk_fwdgrad_online(h_c, w, b, lbl_c, scale, cfg)
    cd = w.dtype
    logits = _mm_f32(h_c, w)
    if b is not None:
        logits = logits + b.float()
    loss_rows, dlog = ce_rows(logits, lbl_c, scale, cd)
    del logits
    dh = _mm_f32(dlog, w.t()).to(h_c.dtype)
    dw = _mm_f32(h_c.t().to(cd), dlog)
    db = dlog.float().sum(0) if b is not None else None
    return loss_rows.sum(), dh, dw, db


def _online_logits_at(h_c, w, b, vc, j):
    wj = w[:, j * vc:(j + 1) * vc]
    lg = _mm_f32(h_c, wj)
    if b is not None:
        lg = lg + b[j * vc:(j + 1) * vc].float()
    return lg, wj


def _online_hit(lbl_c, vc, j):
    loc = lbl_c.long() - j * vc
    hit = (loc >= 0) & (loc < vc)
    return hit, loc.clamp(0, vc - 1)


def _online_stats(h_c, w, b, lbl_c, vc):
    """Running (max, denominator, picked logit) folded over vocab
    chunks of vc — never a [rows, V] buffer."""
    rows = h_c.shape[0]
    dev = h_c.device
    m = torch.full((rows,), float("-inf"), dtype=torch.float32, device=dev)
    s = torch.zeros((rows,), dtype=torch.float32, device=dev)
    picked = torch.zeros((rows,), dtype=torch.float32, device=dev)
    for j in range(w.shape[1] // vc):
        lg, _ = _online_logits_at(h_c, w, b, vc, j)
        m_new = torch.maximum(m, lg.amax(-1))
        s = s * torch.exp(m - m_new) \
            + torch.exp(lg - m_new[:, None]).sum(-1)
        hit, safe = _online_hit(lbl_c, vc, j)
        picked = picked + torch.where(
            hit, torch.gather(lg, -1, safe[:, None])[:, 0], 0.0)
        m = m_new
    return m, s, picked


def _chunk_fwdgrad_online(h_c, w, b, lbl_c, scale, cfg):
    """Online-denominator variant: pass 1 folds the statistics, pass 2
    recomputes each logits slice to emit dh / dW / db per vocab chunk."""
    vc = cfg.vocab_chunk
    cd = w.dtype
    valid = lbl_c >= 0
    m, s, picked = _online_stats(h_c, w, b, lbl_c, vc)
    lse = m + torch.log(s)
    loss_sum = torch.where(valid, lse - picked, 0.0).sum() * scale
    dh = torch.zeros((h_c.shape[0], h_c.shape[1]), dtype=torch.float32,
                     device=h_c.device)
    dw = torch.zeros(w.shape, dtype=torch.float32, device=h_c.device)
    db = torch.zeros((w.shape[1],), dtype=torch.float32, device=h_c.device) \
        if b is not None else None
    for j in range(w.shape[1] // vc):
        lg, wj = _online_logits_at(h_c, w, b, vc, j)
        hit, safe = _online_hit(lbl_c, vc, j)
        onehot = torch.nn.functional.one_hot(safe, vc).float() \
            * hit[:, None].float()
        d = (torch.exp(lg - m[:, None]) / s[:, None] - onehot) * scale
        dlog = torch.where(valid[:, None], d, 0.0).to(cd)
        dh = dh + _mm_f32(dlog, wj.t())
        dw[:, j * vc:(j + 1) * vc] = _mm_f32(h_c.t().to(cd), dlog)
        if db is not None:
            db[j * vc:(j + 1) * vc] = dlog.float().sum(0)
    return loss_sum, dh.to(h_c.dtype), dw, db


def _chunk_loss_only(h_c, w, b, lbl_c, scale, cfg):
    """The loss with no gradient work (the forward when nothing needs a
    gradient); honours vocab_chunk through the online statistics."""
    valid = lbl_c >= 0
    if _vocab_chunked(cfg, w.shape[1]):
        m, s, picked = _online_stats(h_c, w, b, lbl_c, cfg.vocab_chunk)
        lse = m + torch.log(s)
    else:
        logits = _mm_f32(h_c, w)
        if b is not None:
            logits = logits + b.float()
        lse = torch.logsumexp(logits, dim=-1)
        safe = lbl_c.clamp_min(0).long()
        picked = torch.gather(logits, -1, safe[:, None])[:, 0]
    return torch.where(valid, lse - picked, 0.0).sum() * scale


# ---------------------------------------------------------------------------
# row chunks + the autograd Function

def _pad_rows(hidden, labels, chunk):
    n = hidden.shape[0]
    pad = -n % chunk
    if pad:
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
    return hidden, labels.contiguous(), n


def _scale_of(labels):
    valid = (labels >= 0).float()
    return 1.0 / mean_denominator(valid.sum()).reshape(1)


class _FLCE(torch.autograd.Function):
    """Mean CE of hidden [N, H] @ weight [H, V] (+ bias [V]) against
    int32 labels [N].  When a gradient is needed the forward computes
    it (dh, dW, db) chunk by chunk and saves it; the backward scales it
    by the upstream cotangent."""

    @staticmethod
    def forward(ctx, hidden, weight, bias, labels, cfg):
        chunk = cfg.chunk_rows
        h_p, l_p, n = _pad_rows(hidden, labels, chunk)
        scale = _scale_of(l_p)
        loss = torch.zeros((), dtype=torch.float32, device=hidden.device)
        if not any(ctx.needs_input_grad[:3]):
            for i in range(0, h_p.shape[0], chunk):
                loss = loss + _chunk_loss_only(
                    h_p[i:i + chunk], weight, bias, l_p[i:i + chunk],
                    scale, cfg).reshape(())
            return loss
        dw = db = None
        dhs = []
        for i in range(0, h_p.shape[0], chunk):
            ls, dh_c, dw_c, db_c = _chunk_fwdgrad(
                h_p[i:i + chunk], weight, bias, l_p[i:i + chunk], scale,
                cfg)
            loss = loss + ls.reshape(())
            dw = dw_c if dw is None else dw.add_(dw_c)
            if db_c is not None:
                db = db_c if db is None else db.add_(db_c)
            dhs.append(dh_c)
        dh = torch.cat(dhs)[:n]
        ctx.save_for_backward(dh, dw.to(weight.dtype),
                              None if db is None else db.to(bias.dtype))
        return loss

    @staticmethod
    def backward(ctx, g):
        dh, dw, db = ctx.saved_tensors
        return (dh * g.to(dh.dtype), dw * g.to(dw.dtype),
                None if db is None else db * g.to(db.dtype), None, None)


def fused_linear_cross_entropy(hidden, weight, labels, bias=None, *,
                               transpose_weight=False, ignore_index=None,
                               chunk_rows=None, vocab_chunk=None,
                               axis_name=None):
    """Mean cross entropy of `hidden @ weight (+ bias)` against integer
    `labels`, in row chunks, so the full logits never exist.  hidden
    [N, H] (or [..., H], flattened); weight [H, V], or [V, H] with
    transpose_weight (the tied-embedding layout); labels [N] int — rows
    with `ignore_index` or any negative label are left out of the mean.
    Returns the fp32 scalar loss; gradients reach hidden, weight and
    bias."""
    if axis_name is not None:
        raise NotImplementedError(
            "the vocab-sharded mode (axis_name) waits for tensor "
            "parallelism in the port")
    h2 = hidden.reshape(-1, hidden.shape[-1])
    lbl = labels.reshape(-1).to(torch.int32)
    if ignore_index is not None and ignore_index >= 0:
        lbl = torch.where(lbl == ignore_index, -1, lbl)
    if transpose_weight:
        weight = weight.t()
    n = h2.shape[0]
    chunk = int(chunk_rows) if chunk_rows else min(_DEFAULT_CHUNK, n)
    chunk = max(1, min(chunk, n))
    if vocab_chunk and weight.shape[1] % int(vocab_chunk) != 0:
        raise ValueError(f"vocab_chunk={vocab_chunk} must divide the vocab "
                         f"dimension ({weight.shape[1]})")
    cfg = _CEConfig(chunk_rows=chunk,
                    vocab_chunk=int(vocab_chunk) if vocab_chunk else None)
    return _FLCE.apply(h2, weight, bias, lbl, cfg)
