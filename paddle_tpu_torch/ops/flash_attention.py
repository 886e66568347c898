"""Attention for training: the Hopper flash-attention kernels
(csrc/flash_attention.cu; head dims off a multiple of 64:
csrc/flash_attention_narrow.cu; fp32: csrc/flash_attention_f32.cu),
forward and backward, and their plain PyTorch versions.

Replaces the TPU kernel
`paddle_tpu/ops/pallas/flash_attention.py::flash_attention` (:816):
forward `_fwd` :540 (and `_fwd_small` :131, `_fwd_1b` :367), backward
`_bwd` :679 (dq :697, dk/dv :737; `_bwd_small` :271, `_bwd_1b` :425).

  plain_attention   the reference twin `xla_attention`
                    (ops/__init__.py:80-102): fp32 softmax, causal
                    masked bottom-right when sq != sk, a bool or additive
                    mask; the weights are rounded to v's dtype before P.V
  plain_flash_fwd   the kernels' forward: the twin's math on the
                    kernels' masked logits (`_masked_scores`) and the
                    row statistics that the kernels save (`_stats`)
  plain_flash_bwd   the kernels' backward math (recompute from the saved
                    statistics; p and ds rounded to the operand dtype
                    before their products, :618, :664, :670)
  attention         the reference's `ops.attention` (:289), q [b, sq,
                    h, d], k/v [b, sk, hk, d] (h % hk == 0): the plain
                    version for CPU tensors; on CUDA a
                    torch.autograd.Function over the kernels, saving
                    (q, k, v, out, lse) as the TPU custom VJP does (:795).

The saved statistics.  A call without a key bias (no mask, causal only
with sq <= sk) saves lse [b, h, sq], the fp32 logsumexp of each row, as
the TPU kernel does.  A call with one saves [b, h, sq, 2]: each row's
max m and the log g of its sum of exp(x - m), so that the backward's
p = exp((x - m) - g) loses nothing where the logits are large: under an
additive mask of -1e9, a fully padded row's lse = -1e9 + log(sk) is
-1e9 in fp32, and exp(x - lse) would give p = 1 where the twin has
1/sk.

The kernels take what the twin takes on the path's shapes, a wider
domain than the TPU kernel's (d % 64 == 0, no mask, causal only with
sq == sk, :826-837): head dims d % 8 == 0 from 8 to 256, a key-padding
mask [b or 1, 1, 1, sk] (bool, True = attend, or additive float), and
causal attention with sq != sk, bottom-right aligned.  The reference's
`except ValueError` detour to the twin (:296-299) is not carried over:
what the kernels do not take (another mask shape, another head dim,
dropout) raises.

A masked logit is -1e30, as in the twin, so a row whose every key is
masked (a fully padded sequence; under causal with sq > sk, the first
sq - sk rows) weighs all sk keys alike: its output is the mean of v,
its dq and ds are 0 (autograd through the twin's `where`), and each
key's dv gains 1/sk of its dO.  Its saved max m is +inf: exp(x - m) = 0
gives the zeros, and the mark gives dv its 1/sk.  An additive mask is
clamped at -1e30 (a bias of -inf or the dtype's minimum masks the key);
elsewhere its values add to the logits, and a row whose logits all carry
a large finite bias (-1e9) keeps the twin's gradients: uniform weights,
ds = p (dp - delta) scale.  The kernels take no gradient for the mask:
a float mask that requires one raises.  Where the kernels and the twin
differ: a row whose every logit an additive bias at or below -1e30
masks gets ds = 0, where the twin's autodiff through its sum gives
ds = p (dp - delta) scale; and a logit that causal masks is -1e30
whatever its bias, where the twin adds the bias to the -1e30, so a row
whose every logit is masked, by causal and by an additive bias below
about -4e22 (where -1e30 plus the bias is no longer -1e30 in fp32), is
weighed by its bias in the twin and uniformly in the kernels.

A call with a key bias builds it once (`_key_bias`: `_FlashAttention`
hands the forward's to the backward), with each bias row's live keys
[first, end) (`_key_range`, on the device, no host sync): the bf16 /
fp16 bodies of width 64-256 walk only the key tiles between them where
every row of a tile has a live key, with the bits of the whole walk.

Dropout is not ported (dropout_p > 0 raises NotImplementedError).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from . import _build
from .attention import NEG_INF, gqa_scores, gqa_weighted_v

__all__ = ["attention", "plain_attention",
           "plain_flash_fwd", "plain_flash_bwd", "kernel_plan", "launches"]

# kernel launches per entry point since the last reset (chip_smoke.py
# zeroes and reads them)
launches = {"flash_attention": 0, "flash_attention_bwd": 0}

_DOMAIN = "ROADMAP queue 1 item 3"


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


def _masked_scores(q, k, causal, scale, mask=None):
    """The kernels' logits [b, h, sq, sk] fp32: scale·q·kᵀ plus an
    additive mask clamped at NEG_INF, or NEG_INF where a bool mask
    masks; then NEG_INF where causal masks (bottom-right: key j live for
    row i iff j <= i + sk - sq), whatever the bias there."""
    s = gqa_scores(q, k) * scale
    if mask is not None:
        if mask.dtype == torch.bool:
            s = torch.where(mask, s, NEG_INF)
        else:
            s = s + mask.float().clamp_min(NEG_INF)
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        cm = torch.ones((sq, sk), dtype=torch.bool,
                        device=q.device).tril(diagonal=sk - sq)
        s = torch.where(cm[None, None], s, NEG_INF)
    return s


def _biased(mask, q, k, causal):
    """Whether the kernels take a key bias for this call (`_key_bias`):
    a mask, or causal with sq > sk.  Such a call saves the two-statistic
    form [b, h, sq, 2]."""
    return mask is not None or (causal and q.shape[1] > k.shape[1])


def _stats(x, biased):
    """The row statistics the forward kernels save for the logits x
    [b, h, sq, sk]: lse [b, h, sq] without a key bias; with one, [b, h,
    sq, 2] of the row max m (+inf for a row whose every logit is masked)
    and g = log sum exp(x - m)."""
    if not biased:
        return torch.logsumexp(x, dim=-1)
    m = x.amax(-1)
    g = torch.exp(x - m[..., None]).sum(-1).log()
    return torch.stack((m.masked_fill(m <= 0.5 * NEG_INF, float("inf")), g),
                       dim=-1)


def _weights(x, lse):
    """(p, p_v) from the logits x and the saved statistics (`_stats`):
    p = exp(x - lse), or exp((x - m) - g), the weights of dS (0 across a
    row marked +inf), and p_v, those of P.V and Pᵀ.dO: p, but 1/sk
    across a marked row."""
    if lse.ndim == x.ndim:
        m, g = lse[..., :1], lse[..., 1:]
        p = torch.exp((x - m) - g)
    else:
        m = lse[..., None]
        p = torch.exp(x - m)
    return p, torch.where(torch.isinf(m), 1.0 / x.shape[-1], p)


def plain_flash_fwd(q, k, v, causal=False, scale=None, mask=None):
    """(out, lse): the attention and the row statistics of the scaled,
    masked logits that the forward kernel saves (`_stats`)."""
    s = _scale(q, scale)
    x = _masked_scores(q, k, causal, s, mask)
    lse = _stats(x, _biased(mask, q, k, causal))
    out = gqa_weighted_v(torch.softmax(x, dim=-1).to(v.dtype), v)
    return out.transpose(1, 2).to(q.dtype), lse


def plain_flash_bwd(q, k, v, out, lse, dout, causal=False, scale=None,
                    mask=None):
    """(dq, dk, dv) of `_bwd_dq_kernel` / `_bwd_dkv_kernel`, in the
    operands' dtypes: p and p_v from the saved statistics (`_weights`),
    delta = rowsum(dO·O), ds = p·(dO·vᵀ - delta)·scale; dq = ds·k,
    dk = Σ_group dsᵀ·q, dv = Σ_group p_vᵀ·dO, with p and ds rounded to
    the operand dtype."""
    s = _scale(q, scale)
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    G = h // hk
    p, pv = _weights(_masked_scores(q, k, causal, s, mask), lse)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
    ds = p * (gqa_scores(dout, v) - delta[..., None]) * s
    p_r = pv.to(v.dtype).float().reshape(b, hk, G, sq, sk)
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
        _check_mask(mask, q, k)
        _build.require(
            not mask.requires_grad,
            "flash_attention kernel takes no gradient for the mask: a float "
            f"mask that requires grad is not taken ({_DOMAIN})", mask)
    return _FlashAttention.apply(q, k, v, bool(causal),
                                 float(_scale(q, scale)), mask)


class _FlashAttention(torch.autograd.Function):
    """The kernels under autograd: the key bias and its live range are
    built once a call (`_key_bias`) and handed to both launches."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, mask=None):
        keys = _key_bias(mask, q, k, causal)
        out, lse = _launch_fwd(q, k, v, causal, scale, keys)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.keys = causal, scale, keys
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _launch_bwd(q, k, v, out, lse, dout.contiguous(),
                                 ctx.causal, ctx.scale, ctx.keys)
        return (dq, dk, dv) + (None,) * (len(ctx.needs_input_grad) - 3)


def _check_mask(mask, q, k):
    b, sk = q.shape[0], k.shape[1]
    _build.require(
        mask.ndim == 4 and mask.shape[0] in (1, b)
        and tuple(mask.shape[1:]) == (1, 1, sk)
        and (mask.dtype == torch.bool or mask.is_floating_point()),
        "flash_attention kernel takes a key-padding mask [b or 1, 1, 1, "
        f"sk], bool or float ({_DOMAIN})", mask, q, k)


def _check(q, k, v, *more):
    req = _build.require
    req(q.ndim == 4 and k.ndim == 4 and v.shape == k.shape,
        "flash_attention kernel takes q [b, sq, h, d] and k/v "
        "[b, sk, hk, d]", q, k, v)
    b, sq, h, d = q.shape
    req(k.shape[0] == b and k.shape[3] == d and h % k.shape[2] == 0,
        "flash_attention kernel: k/v differ from q in batch or head_dim, "
        "or kv heads do not divide q heads", q, k)
    req(d % 8 == 0 and 8 <= d <= 256,
        f"flash_attention kernel takes head_dim 8-256, a multiple of 8 "
        f"({_DOMAIN})", q)
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


class _Keys(NamedTuple):
    """The keys of a call (`_key_bias`): its mask, and what the kernels
    take for it."""
    mask: Optional[torch.Tensor]    # the call's mask, or None
    bias: Optional[torch.Tensor]    # fp32 [b or 1, skp], or None
    live: Optional[torch.Tensor]    # int32 [b or 1, 2] (`_key_range`)
    stride: int                     # the bias's row stride, 0: one row


def _key_bias(mask, q, k, causal):
    """The kernels' key bias for `mask` and its live range (`_Keys`):
    fp32 [b or 1, skp], skp = sk rounded up to 128 (the kernels read
    whole key tiles), a bool mask as 0 / NEG_INF, an additive one
    clamped at NEG_INF; the row stride 0 for one row shared by the
    batch.  Without a mask none, except under causal with sq > sk,
    whose first rows have no live key: only the kernels' bias bodies
    handle those, so they get a zero bias.  Built on the device without
    a host sync, once a call (`_FlashAttention`), and handed to both
    launches."""
    sk = k.shape[1]
    if not _biased(mask, q, k, causal):
        return _Keys(mask, None, None, 0)
    mb = 1 if mask is None else mask.shape[0]
    skp = -(-sk // 128) * 128
    bias = torch.zeros((mb, skp), dtype=torch.float32, device=q.device)
    if mask is not None:
        _check_mask(mask, q, k)
        m = mask.reshape(mb, sk)
        if m.dtype == torch.bool:
            bias[:, :sk].masked_fill_(~m, NEG_INF)
        else:
            torch.clamp_min(m.float(), NEG_INF, out=bias[:, :sk])
    return _Keys(mask, bias, _key_range(bias, sk), skp if mb > 1 else 0)


@functools.lru_cache(maxsize=32)
def _key_weights(sk, device):
    """int32 [2, sk]: sk - j and j + 1 for key j (`_key_range`)."""
    j = torch.arange(sk, dtype=torch.int32, device=device)
    return torch.stack((sk - j, j + 1))


def _key_range(bias, sk):
    """int32 [rows, 2] of a key bias [rows, >= sk]: each row's
    (sk - first, end), where [first, end) spans its live keys (a bias
    above NEG_INF; a bool mask's padding and an additive one's at or
    below NEG_INF are dead, a finite bias such as -1e9 is live), and
    (0, 0) for a row with none.  The kernels walk only the key tiles in
    that span (csrc/flash_attention.cuh::key_range).  Three launches:
    the live keys, their weights, the weights' max a row."""
    live = bias[:, :sk] > NEG_INF
    return (live[:, None, :] * _key_weights(sk, bias.device)).amax(-1)


# ptt_flash_plan's fields (csrc/flash_attention.cu)
PLAN_FIELDS = ("width", "tile_width", "query_tile", "key_tile",
               "dkv_chunks", "dkv_chunk_width", "fit", "narrow")


def kernel_plan(q, k, causal=False, mask=None):
    """The body the kernels run for these operands, from the library
    (`ptt_flash_plan`, no launch): the width their products run over and
    that of their shared-memory tiles, the forward's query and key tiles,
    dk/dv's column chunks and their width, and whether it is a FIT body
    or a narrow one (csrc/flash_attention_narrow.cu).  fp32 reports the
    two widths alone (its tiles are csrc/flash_attention_f32.cu's)."""
    plan = (ctypes.c_int * len(PLAN_FIELDS))()
    rc = _build.library().ptt_flash_plan(
        _build.dtype_code(q.dtype), q.shape[1], k.shape[1], q.shape[3],
        int(_biased(mask, q, k, causal)), int(causal), ctypes.addressof(plan))
    _build.check(rc, "flash_attention plan")
    got = dict(zip(PLAN_FIELDS, plan))
    got["fit"], got["narrow"] = bool(got["fit"]), bool(got["narrow"])
    return got


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_fwd(q, k, v, causal, scale, keys):
    """(out, lse) from the forward kernel; `keys`: the call's
    `_key_bias`."""
    dev, code = _check(q, k, v)
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    # with a key bias: each row's max and log sum (`_stats`)
    lse = torch.empty((b, h, sq) + ((2,) if keys.bias is not None else ()),
                      dtype=torch.float32, device=q.device)
    rc = _build.library().ptt_flash_fwd(
        dev, code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        _ptr(keys.bias), _ptr(keys.live), out.data_ptr(), lse.data_ptr(), b,
        sq, sk, h, hk, d, keys.stride, scale, int(causal),
        _build.stream_of(q.device))
    _build.check(rc, "flash_attention")
    launches["flash_attention"] += 1
    return out, lse


def _launch_bwd(q, k, v, out, lse, dout, causal, scale, keys):
    """(dq, dk, dv) from the backward kernels; `keys`: the forward's
    `_key_bias`."""
    dev, code = _check(q, k, v, out, dout)
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    _build.require(
        lse.shape == (b, h, sq) + ((2,) if keys.bias is not None else ())
        and lse.dtype == torch.float32 and lse.is_contiguous(),
        "flash_attention kernel: lse must be the forward's fp32 [b, h, sq] "
        "([b, h, sq, 2] with a mask or causal sq > sk)", lse)
    # rowsum(dO·O) in fp32 (the TPU wrapper's, :686): scratch that the
    # first kernel of the launch fills for the second
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    rc = _build.library().ptt_flash_bwd(
        dev, code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        _ptr(keys.bias), _ptr(keys.live), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, sq, sk, h, hk, d, keys.stride, scale, int(causal),
        _build.stream_of(q.device))
    _build.check(rc, "flash_attention_bwd")
    launches["flash_attention_bwd"] += 1
    return dq, dk, dv
