"""Cross entropy: the classifier's and the token-level LM loss.

`cross_entropy` is `paddle_tpu/nn/functional/loss.py::cross_entropy`
(:24) for hard labels: fp32 log-softmax of a half-precision input, the
label's entry picked, `ignore_index` left out of the mean (the count of
the others, under a data-parallel trainer the group's).  Class weights,
soft labels, label smoothing and `use_softmax=False` are not ported yet
(they raise NotImplementedError).

`fused_cross_entropy` is the reference's (:95), both modes:

  * weight None (:134-152): `input` IS the logits.  fp32 `logsumexp −
    picked logit`, with the picked logit taken from the compute-dtype
    logits and only then upcast, and a masked mean over labels that are
    non-negative and differ from `ignore_index` (under a data-parallel
    trainer, over the group's labels: framework/data_parallel.py);
  * weight given (:154-173): `input` is the HIDDEN states and the
    lm-head matmul folds into the chunked fused linear + cross-entropy
    (`ops.fused_linear_cross_entropy`, the cross-entropy rows a Hopper
    kernel on the card), so the [B, S, V] fp32 logits never exist.  The
    weight is cast to the hidden states' dtype before the call (so an
    fp32 parameter's gradient passes through that dtype, as in the
    reference) and a bias to fp32.
"""
from __future__ import annotations

import torch

from ...framework.data_parallel import mean_denominator
from ...ops.fused_cross_entropy import fused_linear_cross_entropy

__all__ = ["cross_entropy", "fused_cross_entropy"]


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """input: logits [..., C]; label: int [...] (or [..., 1]).  Returns
    the mean over labels that differ from `ignore_index` ("mean"), the
    sum ("sum") or the per-row losses ("none")."""
    if weight is not None or soft_label or not use_softmax \
            or label_smoothing or axis not in (-1, input.ndim - 1):
        raise NotImplementedError(
            "cross_entropy: class weights, soft labels, label smoothing, "
            "use_softmax=False and an axis other than the last are not "
            "ported yet")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction {reduction!r}: mean, sum or none")
    x = input.float() if input.dtype in (torch.bfloat16, torch.float16) \
        else input
    logp = torch.log_softmax(x, dim=-1)
    idx = label.to(torch.int64)
    if idx.ndim == logp.ndim:
        idx = idx.squeeze(-1)
    keep = idx != ignore_index
    picked = torch.gather(logp, -1, torch.where(keep, idx, 0)[..., None])
    loss = torch.where(keep, -picked[..., 0], 0.0)
    if reduction == "mean":
        return loss.sum() / mean_denominator(keep.to(logp.dtype).sum())
    return loss.sum() if reduction == "sum" else loss


def fused_cross_entropy(input, label, weight=None, bias=None, *,
                        transpose_weight=False, ignore_index=None,
                        shift=False, chunk_rows=None, vocab_chunk=None,
                        axis_name=None):
    """input: logits [..., V], or hidden states [..., H] with `weight`
    [H, V] ([V, H] with transpose_weight, the tied-embedding layout) and
    an optional `bias` [V]; label: int [...].  shift=True drops the last
    input position and the first label column (next-token prediction),
    identically in both modes.  Returns the fp32 scalar mean loss."""
    x, tgt = (input[:, :-1], label[:, 1:]) if shift else (input, label)
    if weight is not None:
        return fused_linear_cross_entropy(
            x, weight.to(x.dtype), tgt,
            bias=None if bias is None else bias.float(),
            transpose_weight=transpose_weight, ignore_index=ignore_index,
            chunk_rows=chunk_rows, vocab_chunk=vocab_chunk,
            axis_name=axis_name)
    if bias is not None:
        raise ValueError("bias= needs weight=: with logits as input there "
                         "is no lm-head matmul to add it to")
    tgt = tgt.to(torch.int64)
    if ignore_index is not None:
        tgt = torch.where(tgt == ignore_index, -1, tgt)
    picked = torch.gather(x, -1, tgt.clamp_min(0)[..., None])[..., 0]
    lse = torch.logsumexp(x.float(), dim=-1)
    mask = (tgt >= 0).float()
    return ((lse - picked.float()) * mask).sum() / mean_denominator(mask.sum())
