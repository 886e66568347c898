"""Greedy KV-cached generation over the dense cache.

Counterpart of `paddle_tpu/inference/generation.py::generate` (:188),
greedy branch of `_sample` (:33).  The reference compiles prefill plus a
`lax.scan` of decode steps into one program; here the prefill and each
decode step run eagerly over device tensors, with the dense KV ring
buffers updated in place and the tokens fetched to the host once, at
the end.  The serving tests use it as the isolated-request oracle.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..framework.device import module_device, resolve_device

__all__ = ["generate"]


@torch.inference_mode()
def generate(model, input_ids, max_new_tokens: int = 32,
             eos_token_id: Optional[int] = None,
             max_length: Optional[int] = None, device=None) -> torch.Tensor:
    """Greedily generate [b, max_new_tokens] token ids (int32, on the
    model's device).  `device` None means CUDA (raises without one);
    the model must live on the resolved device."""
    dev = resolve_device(device)
    if module_device(model) != dev:
        raise ValueError(f"model lives on {module_device(model)}, "
                         f"generate asked for {dev}")
    ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.int32,
                          device=dev)
    if ids.ndim == 1:
        ids = ids[None]
    b, s = ids.shape
    n = int(max_new_tokens)
    max_len = int(max_length or (s + n))
    if s + n > max_len:
        raise ValueError(f"max_length={max_len} cannot hold prompt ({s}) + "
                         f"{n} new tokens; raise max_length")
    cache = model.init_cache(b, max_len)
    logits, cache = model.forward_cached(ids, cache, 0)
    tok = torch.argmax(logits[:, -1].float(), dim=-1).to(torch.int32)
    done = tok == eos_token_id if eos_token_id is not None else None
    out = [tok]
    for step in range(n - 1):
        lg, cache = model.forward_cached(tok[:, None], cache, s + step)
        nxt = torch.argmax(lg[:, 0].float(), dim=-1).to(torch.int32)
        if eos_token_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_token_id), nxt)
            done = done | (nxt == eos_token_id)
        out.append(nxt)
        tok = nxt
    return torch.stack(out, dim=1)
