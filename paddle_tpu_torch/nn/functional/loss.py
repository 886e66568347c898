"""Token-level LM cross entropy.

Counterpart of `paddle_tpu/nn/functional/loss.py::fused_cross_entropy`
(:95), its logits path (:134-152): fp32 `logsumexp − picked logit`,
with the picked logit taken from the compute-dtype logits and only then
upcast, and a masked mean over labels that are non-negative and differ
from `ignore_index`.  The fused linear + cross-entropy path (`weight=`,
a Pallas kernel in the reference) is not ported yet and raises.
"""
from __future__ import annotations

import torch

__all__ = ["fused_cross_entropy"]


def fused_cross_entropy(input, label, weight=None, bias=None, *,
                        ignore_index=None, shift=False):
    """input: logits [..., V]; label: int [...].  shift=True drops the
    last input position and the first label column (next-token
    prediction).  Returns the fp32 scalar mean loss."""
    if weight is not None or bias is not None:
        raise NotImplementedError("the fused linear + cross-entropy path "
                                  "(weight=) is not ported yet")
    logits, tgt = (input[:, :-1], label[:, 1:]) if shift else (input, label)
    tgt = tgt.to(torch.int64)
    if ignore_index is not None:
        tgt = torch.where(tgt == ignore_index, -1, tgt)
    picked = torch.gather(logits, -1, tgt.clamp_min(0)[..., None])[..., 0]
    lse = torch.logsumexp(logits.float(), dim=-1)
    mask = (tgt >= 0).float()
    return ((lse - picked.float()) * mask).sum() / mask.sum().clamp_min(1.0)
