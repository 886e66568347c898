"""The denominator of a masked mean under data parallelism.

The reference computes a loss over the global batch in one program, so
its masked token mean divides by the count of valid labels of the whole
batch.  Under torch.distributed each rank holds its own rows: if each
divided by its own count, ranks with more ignored labels would weigh
their tokens more.  Inside `loss_mean_scope(group, ranks)` (opened by
`parallel.ShardedTrainStep` around its forward and loss) the
masked-mean losses of the port (`nn.functional.fused_cross_entropy`
and `ops.fused_linear_cross_entropy`) divide by `mean_denominator`:
max(sum of the count over the group, 1) / ranks.  Each rank's loss is
then its share of the global mean scaled by `ranks`, so the mean of the
ranks' losses, and of their gradients (what the trainer reduces), is
the global masked mean and its gradient.  Outside a scope the
denominator is max(count, 1).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["loss_mean_scope", "mean_denominator"]

_SCOPES: list = []


class loss_mean_scope:
    """Make masked means global over `group` (`ranks` processes)."""

    def __init__(self, group, ranks: int):
        self._entry = (group, int(ranks))

    def __enter__(self):
        _SCOPES.append(self._entry)
        return self

    def __exit__(self, *exc):
        _SCOPES.pop()
        return False


def mean_denominator(count: torch.Tensor) -> torch.Tensor:
    """`count`: this rank's number of valid labels (a float tensor)."""
    if not _SCOPES:
        return torch.clamp_min(count, 1.0)
    group, ranks = _SCOPES[-1]
    total = count.detach().clone()
    dist.all_reduce(total, group=group)
    return torch.clamp_min(total, 1.0) / ranks
