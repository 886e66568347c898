"""Paged decode / chunked-prefill attention: the Hopper kernel
(csrc/paged_attention.cu) and its plain PyTorch version.

Replaces the TPU kernel
`paddle_tpu/ops/pallas/paged_attention.py::paged_attention` (:108,
`_kernel` :53, its int8 branch :77-80).  The plain version is the
reference's twin `xla_paged_attention` (ops/__init__.py:244): gather
each slot's logical KV view through the page table (int8 pools
dequantized with their per-page per-head scales, `_dequant_pages`
:154, and rounded to q's dtype), then the dense `cached_attention`
math.  The kernel walks only the pages up to each slot's frontier and
never materialises that view.  bf16/fp16 queries with head_dim 64 or
128 over 16-byte aligned pools take the tensor-core ring body (pages
streamed through shared memory with cp.async; an int8 page dequantized
after it lands, rounded to q's dtype as the plain version rounds it);
everything else takes the CUDA-core body.  The C launcher chooses the
body from dtype, head_dim and alignment (`ptt_paged_attention_body`
reports it).  The library also owns the plan (`ptt_paged_attention_plan`,
csrc/paged_attention_plan.cuh): the pages a block walks, from shapes and
the card's SM count alone; a slot longer than one chunk is merged by its
last block, through fp32 scratch and the int32 counters of
`_merge_counters`.  Those are kept per (device, stream) and are zero
between launches, so launches that share them run one after another.

Layout (models/llama.py::init_paged_cache): pools [P, ps, L, n_kv, d]
of q's dtype, or int8 with scales k_scale/v_scale [P, L, n_kv] fp32;
page_table [B, P_slot] int32 with entry 0 the reserved null page;
pos [B] int32; query lane c of slot b attends rows <= pos[b] + c.

`paged_attention` takes the plain version for CPU tensors and launches
the kernel for CUDA tensors, or raises — there is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .attention import cached_attention, dequant_pages

__all__ = ["paged_attention", "plain_paged_attention", "launches",
           "variant_launches"]

# kernel launches since the last reset (chip_smoke.py zeroes and reads
# them), in total and by pool: "fp" pools of q's dtype, "int8" pools
# dequantized in the kernel
launches = {"paged_attention": 0}
variant_launches = {"fp": 0, "int8": 0}

# pool codes of the C entry point: a pool of q's dtype, or int8
_POOL_SAME, _POOL_INT8 = 0, 3


def _check_args(q, k_pool, k_scale, v_scale):
    n_kv = k_pool.shape[3]
    if q.shape[2] % n_kv:
        raise ValueError(f"q heads {q.shape[2]} not a multiple of kv heads {n_kv}")
    if k_pool.dtype == torch.int8 and (k_scale is None or v_scale is None):
        raise ValueError("int8 KV pool needs k_scale/v_scale")


def plain_paged_attention(q, k_pool, v_pool, page_table, pos, layer,
                          k_scale=None, v_scale=None, scale=None):
    """q [B, C, h, d] → [B, C, h, d] in q.dtype."""
    _check_args(q, k_pool, k_scale, v_scale)
    B = q.shape[0]
    _, ps, _, n_kv, hd = k_pool.shape
    P_slot = page_table.shape[1]
    idx = page_table.to(torch.int64)
    quant = k_pool.dtype == torch.int8

    def gather(pool, scales):
        lg = pool[:, :, layer][idx]
        if quant:
            lg = dequant_pages(lg, scales[:, layer][idx]).to(q.dtype)
        return lg.reshape(B, P_slot * ps, n_kv, hd)

    return cached_attention(q, gather(k_pool, k_scale),
                            gather(v_pool, v_scale), pos, scale)


def paged_attention(q, k_pool, v_pool, page_table, pos, layer,
                    k_scale=None, v_scale=None, scale=None):
    _check_args(q, k_pool, k_scale, v_scale)
    if q.device.type == "cpu":
        return plain_paged_attention(q, k_pool, v_pool, page_table, pos,
                                     layer, k_scale, v_scale, scale)
    return _launch(q, k_pool, v_pool, page_table, pos, layer, k_scale,
                   v_scale, scale)


def _launch(q, k_pool, v_pool, page_table, pos, layer, k_scale, v_scale,
            scale):
    """One kernel launch on the current stream of q's device, with the
    library's plan.  Slots longer than one chunk are merged through the
    merge counters of that (device, stream): the kernel leaves them
    zero, and launches on one stream run one after another, so no two
    launches ever count on the same counter at once."""
    req = _build.require
    quant = k_pool.dtype == torch.int8
    scales = (k_scale, v_scale) if quant else ()
    dev = _build.cuda_device_index(q, k_pool, v_pool, page_table, pos,
                                   *scales)
    code = _build.dtype_code(q.dtype)
    req(q.ndim == 4 and k_pool.ndim == 5,
        "paged_attention kernel takes q [B, C, h, d] and pools "
        "[P, ps, L, n_kv, d]", q, k_pool)
    B, C, h, d = q.shape
    _, ps, L, n_kv, dk = k_pool.shape
    pool_dtype = torch.int8 if quant else q.dtype
    req(v_pool.shape == k_pool.shape and dk == d
        and k_pool.dtype == pool_dtype and v_pool.dtype == pool_dtype,
        "paged_attention kernel takes K/V pools of one shape, q's head_dim "
        "and q's dtype (or int8 with scales)", q, k_pool, v_pool)
    if quant:
        req(all(s.dtype == torch.float32 and s.shape == (k_pool.shape[0], L,
                                                          n_kv)
                and s.is_contiguous() for s in scales),
            "paged_attention kernel takes int8 pool scales [P, L, n_kv] "
            "fp32, contiguous", k_pool, *scales)
    req(page_table.dtype == torch.int32 and pos.dtype == torch.int32
        and page_table.ndim == 2 and page_table.shape[0] == B
        and pos.shape == (B,),
        "paged_attention kernel takes int32 page_table [B, P_slot] and "
        "pos [B]", q, page_table, pos)
    req(0 <= layer < L, "paged_attention kernel: layer outside the pool",
        k_pool)
    req(q.numel() > 0 and page_table.shape[1] > 0,
        "paged_attention kernel: empty input", q, page_table)
    req(q.is_contiguous() and k_pool.is_contiguous()
        and v_pool.is_contiguous() and page_table.is_contiguous()
        and pos.is_contiguous(),
        "paged_attention kernel needs contiguous q, pools, page_table and "
        "pos", q, k_pool, v_pool, page_table, pos)
    s = scale if scale is not None else 1.0 / (d ** 0.5)
    P_slot = page_table.shape[1]
    R = C * (h // n_kv)
    lib = _build.library()
    chunk, splits, n_counters = _plan(lib, dev, B, n_kv, R, P_slot, ps)
    stream = _build.stream_of(q.device)
    out = torch.empty_like(q)
    part_acc = part_ml = counters = None
    if splits > 1:
        part_acc = torch.empty((B, n_kv, splits, R, d), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((B, n_kv, splits, R, 2), dtype=torch.float32,
                              device=q.device)
        counters = _merge_counters(q.device, stream, n_counters)
    rc = lib.ptt_paged_attention(
        dev, code, _POOL_INT8 if quant else _POOL_SAME, q.data_ptr(),
        k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None,
        page_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
        None if part_acc is None else part_acc.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(),
        None if counters is None else counters.data_ptr(), B, C, h, d, ps, L,
        n_kv, P_slot, int(layer), float(s), chunk, stream)
    _build.check(rc, "paged_attention")
    launches["paged_attention"] += 1
    variant_launches["int8" if quant else "fp"] += 1
    return out


# the plan by (device, B, n_kv, R, P_slot, ps), as the library answered
_plans = {}
# the int32 merge counters by (device, stream): zero between launches (the
# last block of each slot re-arms its counter), so launches that share
# them must run one after another, as launches on one stream do
_counters = {}


def _plan(lib, dev, B, n_kv, R, P_slot, ps):
    """(chunk, splits, counters) of a launch, from the library
    (csrc/paged_attention_plan.cuh): shapes and the card's SM count
    alone, never pos."""
    key = (dev, B, n_kv, R, P_slot, ps)
    got = _plans.get(key)
    if got is None:
        buf = (ctypes.c_int * 3)()
        _build.check(lib.ptt_paged_attention_plan(
            dev, B, n_kv, R, P_slot, ps, ctypes.addressof(buf)),
            "paged_attention plan")
        got = _plans[key] = tuple(buf)
    return got


def _merge_counters(device, stream, n):
    """At least n zeroed int32 counters for launches on `stream` of
    `device`, kept across those launches."""
    buf = _counters.get((device, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1), dtype=torch.int32, device=device)
        _counters[(device, stream)] = buf
    return buf
