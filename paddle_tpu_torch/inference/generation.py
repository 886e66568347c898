"""KV-cached generation over the dense cache, greedy or sampled.

Counterpart of `paddle_tpu/inference/generation.py::generate` (:188) and
`_sample` (:33).  The reference compiles prefill plus a `lax.scan` of
decode steps into one program; here the prefill and each decode step
run eagerly over device tensors, with the dense KV ring buffers updated
in place and the tokens fetched to the host once, at the end.  The
serving tests use it as the isolated-request oracle.

Sampling (temperature > 0) follows `_sample`: the logits are scaled by
1/temperature, then `sample_filter` masks them (top-k keeps every logit
>= the k-th largest, so ties are kept; top-p keeps the sorted tokens
whose preceding probability mass is <= top_p, which always keeps the
top one; masked logits become -1e30), and a token is drawn from the
rest.  The reference draws with `jax.random.categorical`, which is the
argmax of the logits plus Gumbel noise; the port takes the same Gumbel
argmax with its noise from an explicit `torch.Generator` on the model's
device, seeded from `seed` (or, with no seed, from torch's global
generator).  The two packages' random streams differ, so a seed picks
different tokens in each; the filter is what is held equal.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..framework.device import module_device, resolve_device

__all__ = ["generate", "sample_filter"]

_MASKED = -1e30


def sample_filter(logits, temperature: float, top_p: Optional[float] = None,
                  top_k: Optional[int] = None) -> torch.Tensor:
    """The logits `_sample` draws from, [b, V] fp32: scaled by
    1/temperature, then top-k and top-p masked to -1e30."""
    logits = logits.float() / temperature
    if top_k is not None:
        kth = torch.sort(logits, dim=-1).values[:, -int(top_k)][:, None]
        logits = torch.where(logits < kth, _MASKED, logits)
    if top_p is not None:
        # a stable sort, as jnp.argsort's, so tied logits keep their order
        sort_idx = torch.argsort(-logits, dim=-1, stable=True)
        sorted_l = torch.gather(logits, -1, sort_idx)
        probs = torch.softmax(sorted_l, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = cum - probs <= top_p               # always keeps top-1
        sorted_l = torch.where(keep, sorted_l, _MASKED)
        logits = torch.empty_like(sorted_l).scatter_(-1, sort_idx, sorted_l)
    return logits


def _next_token(logits, temperature, top_p, top_k, gen):
    """Greedy at temperature 0, else the Gumbel argmax of the filtered
    logits (Gumbel noise -log(E), E ~ Exp(1), drawn from `gen`)."""
    if temperature == 0.0:
        return torch.argmax(logits.float(), dim=-1).to(torch.int32)
    filt = sample_filter(logits, temperature, top_p, top_k)
    e = torch.empty_like(filt).exponential_(1.0, generator=gen)
    return torch.argmax(filt - e.log(), dim=-1).to(torch.int32)


@torch.inference_mode()
def generate(model, input_ids, max_new_tokens: int = 32,
             temperature: float = 0.0, top_p: Optional[float] = None,
             top_k: Optional[int] = None,
             eos_token_id: Optional[int] = None,
             max_length: Optional[int] = None, seed: Optional[int] = None,
             device=None) -> torch.Tensor:
    """Generate [b, max_new_tokens] token ids (int32, on the model's
    device); temperature 0 is greedy.  `device` None means CUDA (raises
    without one); the model must live on the resolved device."""
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
    temperature = float(temperature)
    gen = None
    if temperature != 0.0:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed) if seed is not None else
                        int(torch.randint(0, 2 ** 62, (1,)).item()))
    cache = model.init_cache(b, max_len)
    logits, cache = model.forward_cached(ids, cache, 0)
    tok = _next_token(logits[:, -1], temperature, top_p, top_k, gen)
    done = tok == eos_token_id if eos_token_id is not None else None
    out = [tok]
    for step in range(n - 1):
        lg, cache = model.forward_cached(tok[:, None], cache, s + step)
        nxt = _next_token(lg[:, 0], temperature, top_p, top_k, gen)
        if eos_token_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_token_id), nxt)
            done = done | (nxt == eos_token_id)
        out.append(nxt)
        tok = nxt
    return torch.stack(out, dim=1)
