"""Plain PyTorch attention math of the decode path and the KV writes.

Counterparts of `paddle_tpu/ops/__init__.py`: `gqa_scores` (:51),
`gqa_weighted_v` (:68), `cached_attention` (:105) and `paged_kv_update`
(:160).  None of these is a TPU kernel in the reference (XLA fuses
them), so they stay plain PyTorch here too.  Scores are taken in fp32
(the reference's `preferred_element_type=float32`); the weighted sum
runs in the value dtype, as the reference's does.

The reference's KV writes are pure functions whose outputs are donated
back; here they are IN-PLACE writes into the caller's buffers.  Pools
of the compute dtype take a row scatter (`paged_kv_write`); int8 pools
take the reference's windowed page write (`paged_kv_write_int8`),
which requantizes every page a step writes.
"""
from __future__ import annotations

import torch

__all__ = ["gqa_scores", "gqa_weighted_v", "cached_attention",
           "paged_kv_update", "paged_write_rows", "paged_kv_write",
           "paged_write_window", "paged_kv_write_int8", "dequant_pages",
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


def paged_kv_update(k_pool, v_pool, page_table, pos, k_new, v_new, layer,
                    k_scale=None, v_scale=None):
    """Write one step's K/V rows into the paged pool, IN PLACE.

    k_pool/v_pool [P, ps, L, n_kv, hd] (int8 pools with per-page
    per-head scales k_scale/v_scale [P, L, n_kv] fp32); page_table
    [B, P_slot] int32 (entry 0 = the reserved null page); pos [B] int32;
    k_new/v_new [B, C, n_kv, hd]; layer a python int.  Row c of slot b
    lands at logical row pos[b]+c, i.e. page page_table[b, row // ps],
    offset row % ps — exactly the rows the reference's windowed page
    write produces.  Free slots map every page to the null page, whose
    rows are junk by contract, so colliding junk writes there are
    harmless.  Returns (k_pool, v_pool, k_scale, v_scale)."""
    if k_pool.dtype == torch.int8:
        win = paged_write_window(page_table, pos, k_new.shape[1],
                                 k_pool.shape[1])
        paged_kv_write_int8(k_pool, v_pool, k_scale, v_scale, win, k_new,
                            v_new, layer)
    else:
        rows = paged_write_rows(page_table, pos, k_new.shape[1],
                                k_pool.shape[1])
        paged_kv_write(k_pool, v_pool, rows, k_new, v_new, layer)
    return k_pool, v_pool, k_scale, v_scale


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


def dequant_pages(pages, scales):
    """pages [..., ps, n_kv, hd] int8 × per-page per-head scales
    [..., n_kv] → fp32 (the reference's `_dequant_pages`)."""
    return pages.float() * scales[..., None, :, None]


def paged_write_window(page_table, pos, C, page_size):
    """The page window a C-row step writes, per slot (the reference's
    paged_kv_update :194-203); the same for every layer, so a model
    computes it once per step.  A dict of:

      ids      [B, n_t] int64  pool pages of the window, n_t =
               ceil(C/ps) + 1 pages starting at p0 = pos // ps, with p0
               clipped to P_slot - n_t (the capacity edge)
      touched  [B, n_t] bool   pages holding any of rows pos..pos+C-1
      r0       [B] int64       the first row's offset in the window,
               clamped to [0, n_t*ps - C] as dynamic_update_slice clamps
      src      [B * n_t] int64 for each window entry, the last entry
               naming the same page: a page named twice (the null page
               of free slots and unmapped table entries) is written
               with the bytes of its last entry, as the reference's
               scatter leaves it, whatever order the writes land in
      c127     a 0-dim fp32 127 on pos's device: the scale divisor as a
               tensor, so the card divides as the CPU does (a Python
               scalar divisor becomes a reciprocal multiply on the card)
    """
    B, P_slot = page_table.shape
    ps = int(page_size)
    n_t = -(-int(C) // ps) + 1
    dev = pos.device
    pos = pos.to(torch.int64)
    p0 = torch.clamp(torch.div(pos, ps, rounding_mode="floor"), 0,
                     max(P_slot - n_t, 0))
    win = torch.clamp(p0[:, None] + torch.arange(n_t, device=dev)[None], 0,
                      P_slot - 1)
    ids = torch.gather(page_table.to(torch.int64), 1, win)
    start = win * ps
    touched = (start < (pos + C)[:, None]) & ((start + ps) > pos[:, None])
    r0 = torch.clamp(pos - p0 * ps, 0, n_t * ps - int(C))
    flat = ids.reshape(-1)
    order = torch.arange(flat.numel(), device=dev)
    src = torch.where(flat[:, None] == flat[None, :], order[None, :],
                      -1).amax(dim=1)
    return {"ids": ids, "touched": touched, "r0": r0, "src": src,
            "c127": torch.full((), 127.0, device=dev)}


def paged_kv_write_int8(k_pool, v_pool, k_scale, v_scale, win, k_new, v_new,
                        layer):
    """The reference's int8 page write (paged_kv_update :205-227), IN
    PLACE: gather the window's pages of layer `layer`, dequantize them
    to the rows' dtype, write the C rows, requantize each TOUCHED page
    against its new amax over (rows, head_dim) — scale max(amax,
    1e-8)/127, codes rounded half to even and clipped to ±127 — and
    scatter pages and scales back.  Untouched window pages go back with
    their original bytes and scales, so shared pages are never
    re-encoded.  `win` is paged_write_window's."""
    ids, touched, src = win["ids"], win["touched"], win["src"]
    B, n_t = ids.shape
    C = k_new.shape[1]
    flat = ids.reshape(-1)
    rows = win["r0"][:, None] + torch.arange(C, device=ids.device)[None]
    bi = torch.arange(B, device=ids.device)[:, None]
    for pool, scales, new in ((k_pool, k_scale, k_new),
                              (v_pool, v_scale, v_new)):
        _, ps, _, n_kv, hd = pool.shape
        layer_pool = pool[:, :, layer]                # [P, ps, n_kv, hd]
        layer_sc = scales[:, layer]                   # [P, n_kv]
        raw = layer_pool[ids]                         # [B, n_t, ps, ..]
        sc = layer_sc[ids]                            # [B, n_t, n_kv]
        w = dequant_pages(raw, sc).to(new.dtype)
        w = w.reshape(B, n_t * ps, n_kv, hd)
        w[bi, rows] = new.to(w.dtype)
        wf = w.reshape(B, n_t, ps, n_kv, hd).float()
        sc_new = torch.clamp_min(wf.abs().amax(dim=(2, 4)), 1e-8) \
            / win["c127"]
        q8 = torch.clamp(torch.round(wf / sc_new[:, :, None, :, None]),
                         -127, 127).to(torch.int8)
        pages = torch.where(touched[:, :, None, None, None], q8, raw)
        sc_out = torch.where(touched[..., None], sc_new, sc)
        layer_pool.index_copy_(0, flat,
                               pages.reshape(B * n_t, ps, n_kv, hd)[src])
        layer_sc.index_copy_(0, flat, sc_out.reshape(B * n_t, n_kv)[src])


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
