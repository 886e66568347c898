"""Plain PyTorch attention math of the decode path and the KV writes.

Counterparts of `paddle_tpu/ops/__init__.py`: `gqa_scores` (:51),
`gqa_weighted_v` (:68), `cached_attention` (:105) and `paged_kv_update`
(:160).  None of these is a TPU kernel in the reference (XLA fuses
them), so they stay plain PyTorch here too.  Scores are taken in fp32
(the reference's `preferred_element_type=float32`); the weighted sum
runs in the value dtype, as the reference's does.

The reference's KV writes are pure functions whose outputs are donated
back; here they are IN-PLACE writes into the caller's buffers.
"""
from __future__ import annotations

import torch

__all__ = ["gqa_scores", "gqa_weighted_v", "cached_attention",
           "paged_kv_update", "paged_write_rows", "paged_kv_write",
           "dense_kv_update", "NEG_INF"]

NEG_INF = -1e30


def gqa_scores(q, k):
    """q·kᵀ logits [b, h, sq, sk] (fp32) for q [b, sq, h, d] against
    k [b, sk, hk, d] where hk divides h (GQA/MQA), without repeating
    K: the group folds into an extra q dim."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    qf, kf = q.float(), k.float()
    if hk == h:
        return torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    qg = qf.reshape(b, sq, hk, h // hk, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf)
    return logits.reshape(b, h, sq, sk)


def gqa_weighted_v(w, v):
    """Σₖ w·v → [b, h, sq, d] for weights w [b, h, sq, sk] against
    v [b, sk, hk, d] with hk dividing h."""
    b, h, sq, sk = w.shape
    hk, d = v.shape[2], v.shape[3]
    if hk == h:
        return torch.einsum("bhqk,bkhd->bhqd", w, v)
    wg = w.reshape(b, hk, h // hk, sq, sk)
    out = torch.einsum("bhgqk,bkhd->bhgqd", wg, v)
    return out.reshape(b, h, sq, d)


def cached_attention(q, k_cache, v_cache, q_pos0, scale=None):
    """Incremental-decode attention against a KV buffer.

    q [b, s_new, h, d]; k_cache/v_cache [b, S, h_kv, d]; q_pos0 an int
    (uniform depth) or a [b] tensor (per-slot depths — continuous
    batching, including the chunked-prefill form s_new > 1).  Query i
    of slot b attends cache rows j <= q_pos0[b] + i."""
    b, sq, h, d = q.shape
    sk = k_cache.shape[1]
    s = scale if scale is not None else 1.0 / (d ** 0.5)
    logits = gqa_scores(q, k_cache) * s
    dev = q.device
    kj = torch.arange(sk, dtype=torch.int64, device=dev)
    qi = torch.arange(sq, dtype=torch.int64, device=dev)
    if not torch.is_tensor(q_pos0) or q_pos0.ndim == 0:
        pos_q = int(q_pos0) + qi[:, None]
        valid = kj[None, :] <= pos_q                          # [sq, sk]
        logits = torch.where(valid[None, None], logits, NEG_INF)
    else:
        pos_q = q_pos0.to(torch.int64)[:, None] + qi[None]    # [b, sq]
        valid = kj[None, None, :] <= pos_q[:, :, None]        # [b, sq, sk]
        logits = torch.where(valid[:, None], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = gqa_weighted_v(w.to(v_cache.dtype), v_cache)
    return out.transpose(1, 2).to(q.dtype)


def paged_kv_update(k_pool, v_pool, page_table, pos, k_new, v_new, layer):
    """Write one step's K/V rows into the paged pool, IN PLACE.

    k_pool/v_pool [P, ps, L, n_kv, hd]; page_table [B, P_slot] int32
    (entry 0 = the reserved null page); pos [B] int32; k_new/v_new
    [B, C, n_kv, hd]; layer a python int.  Row c of slot b lands at
    logical row pos[b]+c, i.e. page page_table[b, row // ps], offset
    row % ps — exactly the rows the reference's windowed page write
    produces.  Free slots map every page to the null page, whose rows
    are junk by contract, so colliding junk writes there are harmless.
    Returns (k_pool, v_pool)."""
    rows = paged_write_rows(page_table, pos, k_new.shape[1],
                            k_pool.shape[1])
    paged_kv_write(k_pool, v_pool, rows, k_new, v_new, layer)
    return k_pool, v_pool


def paged_write_rows(page_table, pos, C, page_size):
    """Flat pool row (page * page_size + offset) of each of the C rows
    slot b writes at logical rows pos[b]..pos[b]+C-1: [B * C] int64.
    The same for every layer, so a model computes it once per step."""
    P_slot = page_table.shape[1]
    rows = pos.to(torch.int64)[:, None] \
        + torch.arange(C, dtype=torch.int64, device=pos.device)[None]
    pidx = torch.clamp(rows // page_size, max=P_slot - 1)
    page = torch.gather(page_table.to(torch.int64), 1, pidx)
    return (page * page_size + rows % page_size).reshape(-1)


def paged_kv_write(k_pool, v_pool, rows, k_new, v_new, layer):
    """Scatter k_new/v_new [B, C, n_kv, hd] into layer `layer` of the
    pools at the flat rows from `paged_write_rows`, IN PLACE."""
    P, ps, L = k_pool.shape[:3]
    for pool, new in ((k_pool, k_new), (v_pool, v_new)):
        flat = pool.view(P * ps, L, -1)[:, layer]
        flat.index_copy_(0, rows, new.reshape(rows.shape[0], -1)
                         .to(pool.dtype))


def dense_kv_update(k_cache, v_cache, pos, k_new, v_new):
    """Write k_new/v_new [b, C, n_kv, hd] into the dense ring buffers
    [b, S, n_kv, hd] at `pos` (an int, or a [b] tensor of per-slot
    depths), IN PLACE.  The start row clamps to S - C like the
    reference's dynamic_update_slice."""
    S = k_cache.shape[1]
    b, C = k_new.shape[0], k_new.shape[1]
    if not torch.is_tensor(pos) or pos.ndim == 0:
        start = min(max(int(pos), 0), S - C)
        k_cache[:, start:start + C] = k_new.to(k_cache.dtype)
        v_cache[:, start:start + C] = v_new.to(v_cache.dtype)
        return k_cache, v_cache
    start = torch.clamp(pos.to(torch.int64), 0, S - C)
    rows = start[:, None] + torch.arange(C, dtype=torch.int64,
                                         device=pos.device)[None]
    bi = torch.arange(b, dtype=torch.int64, device=pos.device)[:, None]
    k_cache[bi, rows] = k_new.to(k_cache.dtype)
    v_cache[bi, rows] = v_new.to(v_cache.dtype)
    return k_cache, v_cache
