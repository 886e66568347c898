#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (`paddle_tpu_torch`).

Run from the repo root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

  1. card    print `nvidia-smi --query-gpu=name,power.limit` for card 0
  2. build   compile the hand-written kernels (csrc/*.cu, nvcc sm_90a)
  3. kernels each kernel against its plain PyTorch version on the card,
             at the serving path's shapes in bf16 (query widths 1 of a
             decode step, 5 of a speculative verify pass, 32 of an
             admission step): every element against
             its own tolerance from the kernel's rounding model (the
             share of it used and median tol / median |plain| logged),
             the kernel's, the plain version's and a library
             yardstick's time (CUDA events, median of 30 after warm-up;
             phases 3 and 6 first settle the card with a second of
             copies), and the least time the work could take.  rms_norm also
             at RMS_FWD_EDGE_CASES (one row, 7 rows, 8192 rows of 4096,
             H 8192, the scalar path H 1003, the wide body H 16384 /
             32768 / 58079 and an unaligned x, fp16, fp32) and rope at both
             serve shapes, each launched twice (bit-identical; rope
             bit-identical to its plain version too), with the plan the
             library reports held to the header's table (RMS_FWD_PLANS,
             ROPE_PLANS) and the kernel / library ratio and the share of
             the bound logged.  paged_attention
             also on int8 pools (the bf16 pools quantized per page), each
             case launched twice (outputs bit-identical) with the body
             the library takes for it logged, then at PAGED_EDGE_CASES
             (one slot of 4096 keys, 32 slots, every pos 0, the table's
             last row, ragged C 5 and 17, group 8, two row tiles, d 64,
             fp16, pages of 8 and 32 rows, an fp32 pool on the CUDA-core
             body), each on a pool of q's dtype and its int8 copy,
             beside SDPA on the gathered view;
             quant_matmul int8 and int4 (group 64) at M = 8 and 256 and
             every [K, N] of Llama-2-7B's decode matmuls, then at
             QM_EDGE_CASES (ragged M, K and N, int4 groups 128, and 50
             and 54 at M <= 16, fp16 x, bf16 and fp32 scales, x
             unaligned) and QM_DECODE_EDGE_CASES (M 1, 5, 13, 16, K 4104,
             4160 and 200, N 1040 and 48, int4 groups 16, 32 and 128, fp16
             x, bf16/fp16/fp32 scales, x unaligned); each case launched
             twice (bit-identical), logging the body that ran (M <= 16
             the decode body with its plan, but int4 groups not a
             multiple of 16 the mma.sync body; the rest wgmma; checked),
             its time beside torch.matmul's, the bound and its share of
             it
  4. parity  a 2-layer Llama at full width (hidden 4096, 32 heads, vocab
             32000) in fp32: the card (kernels) against the CPU (plain
             versions) on the same weights — prefill logits, and the
             greedy tokens of a short serve.  Three times: unquantized,
             int8 weights with an int8 KV pool, int4 group-64 weights;
             the packed codes must agree card vs CPU
  5. serve   Llama-2-7B (`llama_7b_config`, 32 layers) in bf16 with
             seeded random weights through ContinuousBatcher (paged KV,
             8 slots, max_len 1024, prefill_chunk 32, chunk 16): 16
             requests of 64-512 prompt tokens, 8 of them sharing a
             256-token system prefix, 64 new tokens each.  Every kernel's
             launch count must equal what the model's structure predicts
             for the forward steps the batcher ran.  Then a short decode
             window under torch.profiler: device time per step by
             kernel, and the busy share of the step's wall time.
  6. train kernels  each training kernel, forward and backward, against
             its plain version at the training path's shapes in bf16
             (x [8192, 2560]; q [4, 2048, 20, 128], kv [4, 2048, 4, 128]
             causal); both RMSNorm backwards also at RMS_BWD_EDGE_CASES
             (Llama-2-7B's [4096, 4096], one row, 8193 rows, H 8192, the
             element path H 1003, fp16, fp32, the widest H 58079, an
             unaligned x), each bit-identical across two launches, and
             the library's body by shape held to RMS_BWD_PLANS (the
             table in csrc/rms_norm.cu's header); the RMSNorm forward
             launched twice with its plan, the fused add's forward
             kernel's source held to ADD_RMS_NORM_SHA256; RoPE forward
             and backward at the training shape and ROPE_EDGE_CASES (d
             64 / 96, the scalar path d 100 and an unaligned q, h + hk =
             65 at decode and 70000 over one row, per-slot and shared
             tables, fp16, fp32), each launched twice and bit-identical
             to the plain versions; flash attention also
             at FLASH_EDGE_CASES (ragged s,
             sq != sk, d 64, fp16, MHA and group 8, B 1) and at
             Llama-2-7B's attention, each beside SDPA; the fused AdamW
             in its four variants (fp32 params
             or bf16 params + fp32 master, each with and without the ef
             residual; bf16 moments) at [2560, 6912], [2560] and [2563];
             the cross-entropy rows at [1024, 8192] with ignored rows:
             every element against its own tolerance from the kernel's
             rounding model, the kernel's, the plain version's and a
             library yardstick's time, the bound
  7. train parity  a 2-layer Llama at the training width (hidden 2560,
             20/4 heads, vocab 8192, seq 256) in fp32: 3 TrainStep AdamW
             steps on the card (kernels) and on the CPU (plain versions)
             from the same weights; losses and parameters must agree.
             Twice: the logits-path loss, then FLAGS_fused_ce with the
             first layer under selective recompute.  fp32 takes the
             CUDA-core flash kernels; the tensor-core ones of the bf16
             path are held by phase 6
  8. train   bench.py::bench_llama's configuration (14 layers, hidden
             2560, bf16 compute, fp32 parameters, the first 3 layers
             under selective recompute, batch 4 x 2048, AdamW with bf16
             moments through the fused AdamW kernel) for 6 TrainStep
             steps on one fixed batch: per-step loss (finite and
             falling), step ms, tokens/s, MFU, peak memory; every
             kernel's launch count must equal steps x what the model's
             structure predicts, the recomputed regions' replays
             included.  Then one more step under torch.profiler: device
             time by kernel and kind, and the busy share of the step's
             wall time.
  8a. beside it, the same configuration without recompute and with the
             pure AdamW rule (FLAGS_use_fused_adamw off): step ms and the
             trace's split of the pure rule's share, in the same call;
             not the main path, so its launches do not count toward the
             kernels line
  9. train, fused  the same with FLAGS_fused_ce (the lm head folded into
             the chunked loss: 8 cross-entropy-row launches a step) and
             FLAGS_bf16_adamw_moments (the ef variant of the fused
             AdamW); its first loss must match phase 8's within the bf16
             rounding of phase 8's logits.
  10. serve, int8  phase 5's requests, geometry and seed through
             ContinuousBatcher(weight_only_dtype="int8", kv_dtype="int8"):
             every decode matmul and the lm head on quant_matmul, the int8
             page write, paged_attention on the int8 pool; launch counts
             per step 225 quant_matmul (int8), 32 paged_attention (int8
             pool), 65 rms_norm, 32 rope; the decode trace split by
             kind, and the trace of one admission chunk ([8 slots, 32
             tokens] a step) by kind, quant_matmul's device ms per
             admission step among them
  11. serve, int4  the same with weight_only_dtype="int4" (group 64) and
             the bf16 pool.
  12. train, ZeRO-3  `init_parallel_env()` (a one-rank NCCL group), then
             bench.py's call: ShardedTrainStep(model, opt,
             build_mesh(devices=[dev]), sharding_stage=3,
             rematerialize=False) on phase 8's configuration, seed,
             weights and batch for 6 steps: each loss within phase 9's
             tolerance (2^-7 max|logit|) of phase 8's, the launches equal
             to phase 8's (129 fused AdamW launches a step, one a
             parameter shard), the parameter all-gathers, gradient
             reduce-scatters and all-reduces a step equal to the
             structure's; step ms and peak memory beside phase 8's, and a
             profiled step.  Then 2 layers, 2 steps with FLAGS_fused_ce
             and FLAGS_bf16_adamw_moments through the same stage 3
             (cross_entropy and the ef AdamW variant on the sharded path)
             against TrainStep on the same weights; then
             destroy_process_group().
  13. serve, request plane  Llama-2-7B in bf16 (phase 5's seed, geometry
             and requests): 13a speculative decoding as bench.py runs it
             (spec_tokens 4, an early-exit draft of 8 layers): every
             request completes, every emitted token is re-scored by one
             teacher-forced forward of the target (its logit within the
             bf16 rounding tolerance of its row's maximum), the launches
             equal the structure's (a verify step 2L+1 rms_norm, L rope,
             L paged_attention with 5 query rows; a draft step and the
             draft's prefill in each admission step their norms and
             ropes); accept rate, accepted per step, tokens/s and decode
             ms per step beside phase 5's, and a profiled window of
             speculative decode steps.  13b the target as its own
             draft on 4 requests: accept rate > 0.5, accepted per step >
             1, each emitted token equal to its verify pass's target
             (every pass spied on the device) and re-scored as 13a's,
             each rejected draft's gap from its row's maximum logged in
             units of that tolerance.  13c ten requests of mixed SLO classes under
             FLAGS_serve_queue_depth=4 (the shed set the queue rule
             predicts), one poisoned slot (FLAGS_fault_injection
             "serve.decode:times=1": evicted, requeued, completed), every
             id once in run()'s results, submitted == completed + shed,
             the on_token bursts joined equal to each output.  13d
             generate: every top_k=1 token a maximum of its own step's
             logits (its history replayed step by step; greedy's replay
             equal to greedy), a seed repeats its sample, ids in the
             vocabulary.  All four count toward the kernels line.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
With no CUDA device the script exits 2 and prints no result.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)
BF16_FLOP_PER_S = 989e12           # H100 SXM dense bf16 tensor peak
FP32_FLOP_PER_S = 67e12            # H100 SXM fp32 outside the tensor cores
REPS = 30
# the training path's shapes: bench.py::bench_llama, batch 4 x 2048,
# the first 3 layers under selective recompute (bench.py:240-248)
TRAIN_BATCH, TRAIN_SEQ = 4, 2048
TRAIN_RECOMPUTE = 3


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(msg):
    print(msg, flush=True)


def time_ms(torch, fn, reps=REPS, warm=5):
    """Median device time of one call of `fn`, from CUDA events around
    each call.  The calls are queued behind a device-side sleep, so the
    host's time to enqueue them never shows as a gap between events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    # ~2e9 cycles/s; cover twice the host time of all the enqueues
    torch.cuda._sleep(int(min(2e9, 2 * reps * host_s * 2e9) + 2e5))
    evs[0].record()
    for i in range(reps):
        fn()
        evs[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(evs[i].elapsed_time(evs[i + 1])
                             for i in range(reps))


def settle(torch, dev, seconds=1.0):
    """Keep the card copying device memory for `seconds` before a phase's
    timings.  Right after phases 3-5 the first memory-bound timings read
    ~10% slow for the kernels and the library calls alike, and normal a
    second later."""
    a = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    b = torch.empty_like(a)
    t_end = time.perf_counter() + seconds
    while time.perf_counter() < t_end:
        for _ in range(16):
            b.copy_(a)
        torch.cuda.synchronize()


def _ms(t):
    return None if t is None else round(t, 4)


def bound(nbytes, flops, flop_rate):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
# RMSNorm forward shapes of phase 3 beside the serve shapes, each launched
# twice (bit-identical): one row, 7 rows, Llama-2-7B's width at a
# 8192-token prefill, two vectors a thread (H 8192), the scalar path (H %
# 8 != 0), the wide body (H 16384 and 32768, an unaligned x, the widest
# scalar row H 58079), fp16 and fp32
RMS_FWD_EDGE_CASES = [
    dict(case="one row", rows=1, H=4096),
    dict(case="7 rows", rows=7, H=4096),
    dict(case="llama-2-7b prefill", rows=8192, H=4096),
    dict(case="H=8192", rows=2048, H=8192),
    dict(case="H=16384", rows=512, H=16384),
    dict(case="scalar H=1003", rows=4096, H=1003),
    dict(case="unaligned x", rows=1024, H=2048, offset=1),
    dict(case="wide H=32768", rows=256, H=32768),
    dict(case="widest H=58079", rows=64, H=58079),
    dict(case="fp16", rows=8192, H=2560, dtype="float16"),
    dict(case="fp32", rows=8192, H=2560, dtype="float32"),
]

# csrc/rms_norm.cu's table of the forward's body by shape: (dtype, H,
# vector path) -> (vectors a thread, threads, rows a block once the rows
# outnumber the blocks the card holds at once; one row a block till
# then); vectors 0 is the wide body, a row a block
RMS_FWD_PLANS = {
    ("bfloat16", 2560, True): (1, 320, 4),
    ("float16", 2560, True): (1, 320, 4),
    ("bfloat16", 4096, True): (1, 512, 4),
    ("bfloat16", 8192, True): (2, 512, 2),
    ("bfloat16", 16384, True): (0, 256, 1),
    ("float32", 2560, True): (2, 320, 2),
    ("bfloat16", 1003, False): (2, 512, 2),
    ("bfloat16", 2048, False): (0, 256, 1),
    ("bfloat16", 32768, True): (0, 256, 1),
    ("bfloat16", 58079, False): (0, 256, 1),
}


def _rms_fwd_plan(torch, rn, x, w):
    """The library's forward plan for these operands, as a launch takes
    it: [vectors a thread (0: the wide body), threads, rows a block,
    blocks, the one-row body's blocks an SM], held to RMS_FWD_PLANS."""
    import ctypes
    from paddle_tpu_torch.ops import _build
    rows, H = x.shape
    vec = rn._bwd_vec(H, x.element_size(), x, w)
    plan = (ctypes.c_int * 5)()
    rc = _build.library().ptt_rms_norm_plan(
        0, _build.dtype_code(x.dtype), H, int(vec), rows,
        ctypes.addressof(plan))
    check(rc == 0, f"rms_norm plan [{rows}, {H}]: CUDA error {rc}")
    got = list(plan)
    V, threads, R, blocks, per_sm = got
    key = (str(x.dtype).split(".")[-1], H, vec)
    want = RMS_FWD_PLANS.get(key)
    check(want is not None and [V, threads] == list(want[:2]),
          f"rms_norm plan {key}: the library picks {got[:2]}, the header's "
          f"table says {want}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fits = V == 0 or rows <= per_sm * sms
    check(R == (1 if fits else want[2]) and blocks == -(-rows // R)
          and (V == 0) == (per_sm == 0),
          f"rms_norm plan {key} over {rows} rows: {R} rows a block, "
          f"{blocks} blocks at {per_sm} an SM")
    return got


def _rms_fwd_case(torch, ops, rn, randn, case, rows, H, dtype="bfloat16",
                  offset=0):
    """The RMSNorm forward at one shape: launched twice (bit-identical),
    every element within 2^-6 |plain| of plain_rms_norm (the kernel
    casts once after * w, as the TPU kernel; the plain version casts
    before * w, as the reference twin: one extra rounding, <= 3 u of each
    output, plus ~2^-12 from the fp32 sum order) plus what those
    roundings move a subnormal output, e (|w| + 2) (ROUNDING; fp16's
    subnormals start at 2^-14), timed beside
    torch.nn.functional.rms_norm, with the body the library took."""
    F = torch.nn.functional
    dt = getattr(torch, dtype)
    x = randn(rows * H + offset, dtype=dt)[offset:].view(rows, H)
    w = (1.0 + 0.1 * randn(H, dtype=torch.float32)).to(dt)
    eps = 1e-5
    k, again = rn._launch(x, w, eps), rn._launch(x, w, eps)
    p = ops.plain_rms_norm(x, w, eps)
    torch.cuda.synchronize()
    check(torch.equal(k, again), f"rms_norm {case} [{rows}, {H}] {dtype}: "
          f"two launches on the same inputs differ")
    b_ms, b_by = bound((2 * rows * H + H) * x.element_size(), 4 * rows * H,
                       BF16_FLOP_PER_S)
    c = dict(case=case, shape=[rows, H], dtype=dtype, x_offset=offset,
             **_checked([k], [p], [2.0 ** -6 * p.float().abs()
                                   + ROUNDING[dtype][1]
                                   * (w.float().abs() + 2.0)]),
             ms=time_ms(torch, lambda: rn._launch(x, w, eps)),
             plain_ms=time_ms(torch, lambda: ops.plain_rms_norm(x, w, eps)),
             library_ms=time_ms(torch, lambda: F.rms_norm(x, (H,), w, eps)),
             library="torch.nn.functional.rms_norm", bound_ms=b_ms,
             bound_by=b_by, plan=_rms_fwd_plan(torch, rn, x, w))
    log(f"[kernels] rms_norm {case} {[rows, H]} {dtype}"
        f"{' x+' + str(offset) if offset else ''}: plan {c['plan']}, "
        f"{c['ms']:.4f} ms, {c['ms'] / c['library_ms']:.2f}x the library, "
        f"{b_ms / c['ms']:.3f} of the {b_by} bound")
    return c


# RoPE shapes of phase 6 beside the training shape, each forward and
# backward (neg_sin), launched twice (bit-identical to the plain
# versions): d 64 and 96, the scalar path (d / 2 not a multiple of 8; an
# unaligned q), h + hk = 65 at decode and 70000 over one row (past the
# 65535 of a grid's y), per-slot and shared tables, fp16 and fp32
ROPE_EDGE_CASES = [
    dict(case="d=64", b=2, s=1024, h=20, hk=4, d=64),
    dict(case="d=96", b=2, s=512, h=8, hk=2, d=96),
    dict(case="scalar d=100", b=2, s=256, h=8, hk=2, d=100),
    dict(case="unaligned q", b=2, s=256, h=20, hk=4, d=128, offset=1),
    dict(case="h+hk=65, per-slot", b=8, s=1, h=64, hk=1, d=128,
         per_slot=True),
    dict(case="h+hk=70000", b=1, s=1, h=69000, hk=1000, d=128),
    dict(case="fp16, per-slot", b=8, s=32, h=32, hk=32, d=128,
         dtype="float16", per_slot=True),
    dict(case="fp32", b=2, s=2048, h=20, hk=4, d=128, dtype="float32"),
]

# csrc/rope.cu's table of the plan at 132 SMs: (dtype, d, vector path,
# rows, heads) -> (pairs a thread, threads a head, head splits, heads
# loaded before any is formed, threads, blocks)
ROPE_PLANS = {
    ("bfloat16", 128, True, 8192, 24): (8, 8, 1, 4, 128, 512),
    ("bfloat16", 128, True, 8, 64): (8, 8, 64, 1, 128, 32),
    ("bfloat16", 128, True, 40, 64): (8, 8, 64, 1, 128, 160),
    ("bfloat16", 128, True, 256, 64): (8, 8, 32, 2, 128, 512),
    ("float16", 128, True, 256, 64): (8, 8, 32, 2, 128, 512),
    ("float32", 128, True, 4096, 24): (4, 16, 1, 4, 128, 512),
    ("bfloat16", 64, True, 2048, 24): (8, 4, 8, 2, 128, 512),
    ("bfloat16", 96, True, 1024, 10): (8, 6, 8, 2, 128, 384),
    ("bfloat16", 100, False, 512, 10): (1, 50, 4, 2, 128, 800),
    ("bfloat16", 128, False, 512, 24): (1, 64, 2, 4, 128, 512),
    ("bfloat16", 128, True, 8, 65): (8, 8, 64, 2, 128, 32),
    ("bfloat16", 128, True, 1, 70000): (8, 8, 8192, 4, 128, 512),
}


def _rope_vec(q, k, cos, sin):
    """Whether a launch takes the 16-byte path: d / 2 a multiple of 16
    bytes' elements, every operand 16-byte aligned (the outputs are
    fresh allocations)."""
    d = q.shape[-1]
    return (d // 2) % (16 // q.element_size()) == 0 and all(
        t.data_ptr() % 16 == 0 for t in (q, k, cos, sin))


def _rope_plan(torch, q, k, cos, sin):
    """The library's plan for these operands: [pairs a thread, threads a
    head, head splits, heads loaded before any is formed, threads,
    blocks, SMs], held to ROPE_PLANS on a card of 132 SMs and to the
    plan's invariants on any."""
    import ctypes
    from paddle_tpu_torch.ops import _build
    b, s, h, d = q.shape
    heads = h + k.shape[2]
    vec = _rope_vec(q, k, cos, sin)
    plan = (ctypes.c_int * 7)()
    rc = _build.library().ptt_rope_plan(
        0, _build.dtype_code(q.dtype), d, int(vec), b * s, heads,
        ctypes.addressof(plan))
    check(rc == 0, f"rope plan {list(q.shape)}: CUDA error {rc}")
    got = list(plan)
    vw, P, J, U, threads, blocks, sms = got
    per = -(-heads // J)
    key = (str(q.dtype).split(".")[-1], d, vec, b * s, heads)
    check(vw == (16 // q.element_size() if vec else 1) and vw * P * 2 == d
          and J <= heads and J & (J - 1) == 0
          and U == (4 if per >= 4 else 2 if per >= 2 else 1)
          and blocks == min(-(-b * s * P * J // threads), 16 * sms),
          f"rope plan {key}: {got} breaks the plan's rules")
    check(sms != 132 or key not in ROPE_PLANS
          or got[:6] == list(ROPE_PLANS[key]),
          f"rope plan {key}: the library picks {got[:6]}, the header's "
          f"table says {ROPE_PLANS.get(key)}")
    return got


def _rope_edge_case(torch, ops, ro, randn, case, b, s, h, hk, d,
                    dtype="bfloat16", per_slot=False, offset=0):
    """_rope_case, forward and backward, on inputs of one ROPE_EDGE_CASES
    row: q and k `offset` elements into their storage, per-slot [b, s, d]
    tables of scattered positions or a shared [s, d] one."""
    from paddle_tpu_torch.ops import rope_cos_sin
    dt = getattr(torch, dtype)

    def operand(*shape):
        n = int(np.prod(shape))
        return randn(n + offset, dtype=dt)[offset:].view(shape)

    q, kk = operand(b, s, h, d), operand(b, s, hk, d)
    dev = q.device
    if per_slot:
        pos = torch.arange(b, device=dev)[:, None] * 97 + torch.arange(
            s, device=dev)[None]
        cos, sin = rope_cos_sin(s, d, 10000.0, position_ids=pos)
    else:
        cos, sin = rope_cos_sin(s, d, 10000.0, device=dev)
    return _rope_case(torch, ops, ro, case, q, kk, cos.contiguous(),
                      sin.contiguous(), bwd=True)


def _rope_case(torch, ops, ro, case, q, kk, cos, sin, bwd=False):
    """RoPE forward (and, with bwd, its backward: sin's halves swapped,
    neg_sin) at one shape: each launched twice and held bit-identical to
    the plain version (the same fp32 products and sum, each rounded as
    there, one cast), timed, with the plan the library took."""
    d = q.shape[-1]
    # q, k read and written once; each cos/sin row read once
    nbytes = 2 * (q.numel() + kk.numel()) * q.element_size() \
        + 2 * cos.numel() * 4
    b_ms, b_by = bound(nbytes, 3 * (q.numel() + kk.numel()),
                       BF16_FLOP_PER_S)
    plan = _rope_plan(torch, q, kk, cos, sin)
    out = []
    dirs = [("rope", sin, False, ops.plain_apply_rope)]
    if bwd:
        sw = torch.cat([sin[..., d // 2:], sin[..., :d // 2]],
                       dim=-1).contiguous()
        dirs.append(("rope_bwd", sw, True, ops.plain_rope_bwd))
    for name, tab, neg, plain in dirs:
        k1 = ro._launch(q, kk, cos, tab, neg_sin=neg)
        k2 = ro._launch(q, kk, cos, tab, neg_sin=neg)
        refs = plain(q, kk, cos, sin)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b_) for a, b_ in zip(k1, k2)),
              f"{name} {case} {list(q.shape)}: two launches differ")
        c = dict(case=case, shape=list(q.shape),
                 dtype=str(q.dtype).split(".")[-1],
                 **_checked(list(k1), list(refs),
                            [torch.zeros_like(t, dtype=torch.float32)
                             for t in refs]),
                 ms=time_ms(torch, lambda: ro._launch(q, kk, cos, tab,
                                                      neg_sin=neg)),
                 plain_ms=time_ms(torch, lambda: plain(q, kk, cos, sin)),
                 library_ms=None, library=None, bound_ms=b_ms, bound_by=b_by,
                 plan=plan)
        log(f"[kernels] {name} {case} {list(q.shape)} hk {kk.shape[2]} "
            f"{c['dtype']}: plan {plan}, {c['ms']:.4f} ms, "
            f"{b_ms / c['ms']:.3f} of the {b_by} bound")
        out.append(c)
    return out


def phase_kernels(torch, ops, dev):
    from paddle_tpu_torch.ops import rope_cos_sin
    g = torch.Generator(device=dev)
    g.manual_seed(1234)
    bf16 = torch.bfloat16

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.float32).to(dtype)

    B, H, heads, hd = 8, 4096, 32, 128
    results = {"rms_norm": [], "rope": [], "paged_attention": [],
               "quant_matmul": []}
    settle(torch, dev)

    # serve widths: a decode step (1), a speculative verify pass (K + 1)
    # and an admission step (32)
    widths = (1, SPEC_TOKENS + 1, 32)

    # -- rms_norm on [8*C, 4096], then RMS_FWD_EDGE_CASES --------------------
    rn = ops.kernel_module("rms_norm")
    for C in widths:
        results["rms_norm"].append(_rms_fwd_case(
            torch, ops, rn, randn, case="serve", rows=B * C, H=H))
    for case in RMS_FWD_EDGE_CASES:
        results["rms_norm"].append(_rms_fwd_case(torch, ops, rn, randn,
                                                 **case))
        torch.cuda.empty_cache()

    # -- rope on q/k [8, C, 32, 128], cos/sin [8, C, 128] --------------------
    ro = ops.kernel_module("rope")
    pos = torch.tensor([0, 9, 100, 333, 517, 700, 990, 1023],
                       dtype=torch.int32, device=dev)
    for C in widths:
        q, kk = randn(B, C, heads, hd), randn(B, C, heads, hd)
        positions = pos[:, None] + torch.arange(C, dtype=torch.int32,
                                                device=dev)[None]
        cos, sin = rope_cos_sin(C, hd, 10000.0, position_ids=positions)
        cos, sin = cos.contiguous(), sin.contiguous()
        results["rope"].append(_rope_case(torch, ops, ro, "serve", q, kk,
                                          cos, sin)[0])

    # -- paged_attention: pool [529, 16, 32, 32, 128], table [8, 66] ---------
    P, ps, L, n_kv, P_slot, layer = 529, 16, 32, 32, 66, 17
    kpool, vpool = randn(P, ps, L, n_kv, hd), randn(P, ps, L, n_kv, hd)
    perm = torch.randperm(P - 1, generator=g, device=dev)[: B * P_slot] + 1
    pt = perm.reshape(B, P_slot).to(torch.int32).contiguous()
    for C in widths:
        for group in (1, 4):
            q = randn(B, C, n_kv * group, hd)
            results["paged_attention"].append(_paged_case(
                torch, ops, q, kpool, vpool, pt, pos, layer))
    # the int8 pools: the bf16 pools quantized per page
    k8, ks = _quantize_pool(torch, kpool)
    v8, vs = _quantize_pool(torch, vpool)
    for C in widths:
        for group in (1, 4):
            q = randn(B, C, n_kv * group, hd)
            results["paged_attention"].append(_paged_case(
                torch, ops, q, k8, v8, pt, pos, layer, ks, vs))
    del kpool, vpool, k8, v8
    torch.cuda.empty_cache()
    results["paged_edge"] = _paged_edge_cases(torch, ops, g)
    torch.cuda.empty_cache()
    results["quant_matmul"] = _quant_matmul_cases(torch, ops, g)
    def msq(c):
        m = c.get("msq_share")
        return "" if m is None else f"; mean square / variance {m:.3f}"

    for name, cases in results.items():
        for c in cases:
            if name == "paged_edge":        # logged by _paged_edge_cases
                check(c["tol_share"] <= 1.0,
                      f"paged_attention '{c['case']}' {c['variant']} "
                      f"disagrees with its plain version: errors "
                      f"{c['errs']} use {c['shares']} of their tolerances")
                continue
            log(f"[kernels] {name} {c['shape']}"
                f"{' ' + c['variant'] if 'variant' in c else ''}"
                f"{' group ' + str(c['group']) if 'group' in c else ''}: "
                f"err {c['errs']}, share of the per-element tolerance "
                f"{c['shares']}, median tol / median |plain| {c['tight']}; "
                f"kernel {c['ms']:.4f} ms, plain {_ms(c['plain_ms'])} ms, "
                f"library {_ms(c['library_ms'])} ms, "
                f"bound {c['bound_ms']:.5f} ms ({c['bound_by']})"
                f"{'; ' + c['body'] + ' body' if 'body' in c else ''}"
                f"{msq(c)}")
            check(c["tol_share"] <= 1.0,
                  f"{name} {c['shape']} disagrees with its plain version: "
                  f"errors {c['errs']} use {c['shares']} of their "
                  f"per-element tolerances")
    return results


def _quantize_pool(torch, pool):
    """An int8 copy of a [P, ps, L, n_kv, d] pool with one scale per
    (page, layer, kv head): amax over (rows, head_dim) / 127, as the
    serving page write quantizes a full page."""
    amax = pool.float().abs().amax(dim=(1, 4))                 # [P, L, n_kv]
    sc = torch.clamp_min(amax, 1e-8) / 127.0
    q8 = torch.clamp(torch.round(pool.float() / sc[:, None, :, :, None]),
                     -127, 127).to(torch.int8)
    return q8, sc.contiguous()


def _paged_body(torch, q, kp, vp):
    """The body the kernel library takes for these operands, by shape
    (csrc/paged_attention.cu::body_of): "ring" or "cuda-core"."""
    from paddle_tpu_torch.ops import _build
    code = _build.library().ptt_paged_attention_body(
        _build.dtype_code(q.dtype), 3 if kp.dtype == torch.int8 else 0,
        q.shape[-1], q.data_ptr(), kp.data_ptr(), vp.data_ptr())
    check(code in (0, 1), f"ptt_paged_attention_body returned {code}")
    return ("cuda-core", "ring")[code]


def _paged_dense_view(torch, q, kp, vp, pt, pos, layer, ks=None, vs=None):
    """The pre-gathered dense view of a paged batch, as SDPA takes it: qt
    [B, h, C, d], each slot's K and V rows (an int8 pool's dequantized and
    rounded to q's dtype) repeated over the query-head group, kg/vg [B, h,
    P_slot * ps, d], and the causal mask by position, [B, 1, C, S]."""
    B, C, h, d = q.shape
    n_kv = kp.shape[3]
    S = pt.shape[1] * kp.shape[1]
    idx = pt.long()

    def view(pool, sc):
        x = pool[:, :, layer][idx]
        if pool.dtype == torch.int8:
            x = (x.float() * sc[:, layer][idx][:, :, None, :, None]).to(q.dtype)
        return x.reshape(B, S, n_kv, d).repeat_interleave(h // n_kv, dim=2) \
            .transpose(1, 2)
    mask = (torch.arange(S, device=q.device)[None, None, :]
            <= (pos[:, None, None].long()
                + torch.arange(C, device=q.device)[None, :, None]))[:, None]
    return q.transpose(1, 2), view(kp, ks), view(vp, vs), mask


def _paged_case(torch, ops, q, kp, vp, pt, pos, layer, ks=None, vs=None,
                time_plain=True):
    """paged_attention against plain_paged_attention at one shape, a pool
    of q's dtype or an int8 pool with its scales: every element within
    `_paged_tolerance` on the gathered (dequantized) dense view and, for
    16-bit q, the mean square error within its variance (for fp32 q
    nothing is rounded to a narrower dtype, and the variance leaves out
    fp32's differences), two launches bit-identical, the body by shape;
    the kernel's, the plain version's and SDPA's time on the
    pre-gathered view (the gather and dequant left out of its time), and
    the bound from the rows this run's slots need."""
    from paddle_tpu_torch.ops import plain_paged_attention
    dev = q.device
    B, C, h, d = q.shape
    _, ps, L, n_kv, _ = kp.shape
    P_slot = pt.shape[1]
    group = h // n_kv
    quant = kp.dtype == torch.int8
    args = (q, kp, vp, pt, pos, layer) + ((ks, vs) if quant else ())
    k = ops.paged_attention(*args)
    k2 = ops.paged_attention(*args)
    p = plain_paged_attention(*args)
    torch.cuda.synchronize()
    same = torch.equal(k.view(torch.uint8), k2.view(torch.uint8))
    # the K/V rows each slot needs (up to its last lane's position), the
    # page-table entries of its live pages (and an int8 pool's two
    # scales a live page and kv head), q, out and pos
    rows = torch.clamp(pos.long() + C, max=P_slot * ps)
    n_rows = int(rows.sum().item())
    n_pages = int(((rows + ps - 1) // ps).sum().item())
    nbytes = (n_rows * n_kv * d * kp.element_size() * 2
              + n_pages * (4 + (n_kv * 4 * 2 if quant else 0))
              + 2 * q.numel() * q.element_size() + B * 4)
    keys = (pos[:, None].long() + torch.arange(C, device=dev)[None]
            + 1).clamp(max=P_slot * ps)
    flops = int(keys.sum().item()) * h * d * 4
    b_ms, b_by = bound(nbytes, flops, BF16_FLOP_PER_S)
    qt, kg, vg, mask = _paged_dense_view(torch, q, kp, vp, pt, pos, layer,
                                         ks, vs)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = sdpa(qt, kg, vg, attn_mask=mask)
    tol, var = _paged_tolerance(torch, qt, kg, vg, mask, p)
    # (an element with no error where the model allows none counts 0)
    msq = ((k.float() - p.float()).square_() / var.clamp_min(1e-30)).mean() \
        .item() if q.dtype != torch.float32 else None
    c = dict(
        shape=[B, C, h, d], group=group, variant="int8" if quant else "fp",
        dtype=str(q.dtype).split(".")[-1], ps=ps, P_slot=P_slot,
        body=_paged_body(torch, q, kp, vp), bit_identical=same,
        **_checked([k], [p], [tol]), msq_share=msq,
        library_err=(lib.transpose(1, 2).float() - p.float()).abs().max()
        .item(),
        ms=time_ms(torch, lambda: ops.paged_attention(*args)),
        plain_ms=time_ms(torch, lambda: plain_paged_attention(*args))
        if time_plain else None,
        library_ms=time_ms(torch, lambda: sdpa(qt, kg, vg, attn_mask=mask)),
        library="scaled_dot_product_attention on the pre-gathered dense "
                + ("dequantized " if quant else "") + "view (gather"
                + (", dequant" if quant else "") + " excluded)",
        bound_ms=b_ms, bound_by=b_by)
    c["library_ratio"] = c["ms"] / c["library_ms"]
    c["bound_share"] = c["bound_ms"] / c["ms"]
    check(same, f"paged_attention {c['shape']} {c['variant']}: two launches "
          f"on the same inputs differ")
    check(msq is None or msq <= 1.0,
          f"paged_attention {c['shape']} {c['variant']}: mean square error "
          f"{msq} of the rounding model's variance")
    del kg, vg, lib, k, k2, p, tol, var
    return c


# paged_attention edge shapes, each on a pool of q's dtype and on an int8
# pool: (name, B, C, group, head_dim, q dtype, ps, P_slot, pos) with pos a
# list, "zero", "full" (the last lane on the table's last row) or
# "spread" (seeded, over the whole table); h = 32 query heads
PAGED_EDGE_CASES = (
    ("B 1, pos 4095", 1, 1, 1, 128, "bfloat16", 16, 256, [4095]),
    ("32 slots", 32, 1, 1, 128, "bfloat16", 16, 66, "spread"),
    ("every pos 0", 8, 1, 1, 128, "bfloat16", 16, 66, "zero"),
    ("last row of a full table", 8, 1, 1, 128, "bfloat16", 16, 66, "full"),
    ("C 5", 8, 5, 1, 128, "bfloat16", 16, 66, "spread"),
    ("C 17, group 4", 8, 17, 4, 128, "bfloat16", 16, 66, "spread"),
    ("group 8", 8, 1, 8, 128, "bfloat16", 16, 66, "spread"),
    ("group 8, C 32 (two row tiles)", 8, 32, 8, 128, "bfloat16", 16, 66,
     "spread"),
    ("d 64", 8, 1, 1, 64, "bfloat16", 16, 66, "spread"),
    ("d 64, C 32", 8, 32, 1, 64, "bfloat16", 16, 66, "spread"),
    ("fp16", 8, 32, 1, 128, "float16", 16, 66, "spread"),
    ("ps 8", 8, 1, 1, 128, "bfloat16", 8, 132, "spread"),
    ("ps 32", 8, 32, 1, 128, "bfloat16", 32, 33, "spread"),
    ("fp32 pool (CUDA-core body)", 8, 1, 1, 128, "float32", 16, 66,
     "spread"),
)


def _paged_edge_cases(torch, ops, g):
    """`_paged_case` at every PAGED_EDGE_CASES shape, on a pool of q's
    dtype and on its int8 copy (2 layers, layer 1; each slot's pages
    drawn at random from the pool); the body must be the ring body for
    bf16/fp16 q and the CUDA-core body for fp32."""
    dev = g.device
    out = []
    for name, B, C, group, d, dt, ps, P_slot, pos in PAGED_EDGE_CASES:
        dtype = getattr(torch, dt)
        n_kv = 32 // group
        P = 1 + B * P_slot
        cap = P_slot * ps

        def randn(*shape):
            return torch.randn(shape, generator=g, device=dev).to(dtype)
        kp, vp = randn(P, ps, 2, n_kv, d), randn(P, ps, 2, n_kv, d)
        pt = (torch.randperm(P - 1, generator=g, device=dev)[:B * P_slot]
              + 1).reshape(B, P_slot).to(torch.int32).contiguous()
        if pos == "zero":
            pos = [0] * B
        elif pos == "full":
            pos = [cap - C] * B
        elif pos == "spread":
            pos = torch.randint(0, cap - C + 1, (B,), generator=g,
                                device=dev).tolist()
        pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
        q = randn(B, C, n_kv * group, d)
        k8, ks = _quantize_pool(torch, kp)
        v8, vs = _quantize_pool(torch, vp)
        for pools in ((kp, vp), (k8, v8, ks, vs)):
            c = _paged_case(torch, ops, q, pools[0], pools[1], pt, pos_t, 1,
                            *pools[2:], time_plain=False)
            c["case"] = name
            want = "cuda-core" if dtype == torch.float32 else "ring"
            log(f"[kernels] paged_attention edge '{name}' {c['variant']} "
                f"{c['shape']} ps {ps} P_slot {P_slot}: {c['body']} body, "
                f"{c['ms']:.4f} ms, SDPA {c['library_ms']:.4f} ms "
                f"({c['library_ratio']:.2f}x), bound {c['bound_ms']:.5f} ms "
                f"({c['bound_share']:.3f} of it), share of the tolerance "
                f"{c['tol_share']:.3f}, mean square / variance "
                f"{c['msq_share']}, bit-identical {c['bit_identical']}")
            check(c["body"] == want, f"paged_attention '{name}' took the "
                  f"{c['body']} body, not {want}")
            out.append(c)
        del kp, vp, k8, v8
    return out


# quant_matmul at the serving path's shapes: [K, N] of q/k/v/o, gate/up,
# down and the lm head of Llama-2-7B; M = 8 slots decoding, 8 x 32 lanes
# of an admission chunk
QM_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000))
QM_GROUP = 64


def _quant_matmul_tolerance(torch, x, w, ref):
    """Per-element tolerance of quant_matmul against plain_quant_matmul.
    Both dequantize every weight to the same bf16 value (the same fp32
    product, rounded once) and sum the exact products x*w in fp32; only
    the order of the sums (the kernel's K tiles, splits and mma
    accumulation against cuBLAS's fp32 GEMM) and the final rounding
    differ: one ulp of the output dtype for an output rounding that
    flips (2^-7 |plain| in bf16, 2^-10 in fp16), 2^-12 sum |x| |w| for
    fp32 sums of up to 11008 terms in another order (a random walk of
    rounding errors stays near 2^-17 of it)."""
    ulp = 2.0 ** -7 if ref.dtype == torch.bfloat16 else 2.0 ** -10
    return ulp * ref.float().abs() + 2.0 ** -12 * (x.float().abs()
                                                   @ w.float().abs())


# edge shapes of the admission body (M > 16): ragged M (one and two
# 256-row tiles), a ragged last K tile, N not a multiple of its 128-column
# strips, int4 group 128, fp16 x, bf16 and fp32 scales; and of the
# mma.sync body at M <= 16: int4 groups that are not a multiple of 16
# (54, and 50 with x at an odd offset): (fmt, M, K, N, group, x dtype,
# scale dtype, x's offset in elements)
QM_EDGE_CASES = (
    ("int8", 17, 4096, 4096, 64, "bfloat16", "bfloat16", 0),
    ("int4", 100, 4096, 4096, 64, "bfloat16", "bfloat16", 0),
    ("int8", 255, 4096, 11008, 64, "bfloat16", "float32", 0),
    ("int4", 300, 4096, 4096, 64, "bfloat16", "bfloat16", 0),
    ("int8", 256, 4104, 4096, 64, "bfloat16", "bfloat16", 0),
    ("int8", 100, 1000, 1040, 64, "float16", "float32", 0),
    ("int4", 256, 4096, 4096, 128, "bfloat16", "float32", 0),
    ("int4", 256, 11008, 4096, 64, "float16", "float16", 0),
    ("int4", 8, 4104, 1040, 54, "float16", "float16", 0),
    ("int4", 13, 200, 48, 50, "bfloat16", "bfloat16", 3),
)

# edge shapes of the decode body (M <= 16): one, five, thirteen and
# sixteen rows, a ragged last K tile (int8, and int4 with its x staged),
# N not a multiple of its 128-column blocks, int4 groups 16, 32 and 128,
# fp16 x, bf16 and fp32 scales, x at an odd element offset: (fmt, M, K,
# N, group, x dtype, scale dtype, x's offset in elements)
QM_DECODE_EDGE_CASES = (
    ("int8", 1, 4096, 4096, 64, "bfloat16", "bfloat16", 0),
    ("int4", 5, 4096, 11008, 64, "bfloat16", "bfloat16", 0),
    ("int8", 16, 4096, 32000, 64, "bfloat16", "bfloat16", 0),
    ("int4", 16, 11008, 4096, 16, "bfloat16", "bfloat16", 0),
    ("int8", 8, 4104, 1040, 64, "bfloat16", "float32", 0),
    ("int4", 8, 4160, 1040, 32, "bfloat16", "bfloat16", 0),
    ("int8", 3, 200, 48, 64, "float16", "bfloat16", 1),
    ("int4", 8, 4096, 4096, 128, "bfloat16", "float32", 0),
    ("int4", 8, 4096, 4096, 16, "float16", "float32", 1),
    ("int4", 13, 256, 48, 32, "bfloat16", "bfloat16", 3),
    ("int8", 8, 4096, 4096, 64, "float16", "float16", 1),
)


def _quant_matmul_case(torch, ops, g, fmt, M, K, N, group, xdt, sdt,
                       w=None, x_offset=0):
    """quant_matmul against plain_quant_matmul at one shape: the weight
    (seeded random, or `w`) quantized in `sdt`, x in `xdt` (`x_offset`
    elements into its storage); two launches bit-identical; logs the body
    that ran (and the decode body's plan), the ratio to the library
    yardstick and the share of the bound."""
    from paddle_tpu_torch.ops import dequant_weight, plain_quant_matmul
    from paddle_tpu_torch.quantization import quantize_weight
    qm = ops.kernel_module("quant_matmul")
    dev = g.device
    if w is None:
        w = torch.randn((K, N), generator=g, device=dev) / K ** 0.5
    qw, sc = quantize_weight(w.to(sdt), fmt, group)
    wd = dequant_weight(qw, sc, fmt, group).to(xdt)
    x = torch.randn(M * K + x_offset, generator=g, device=dev).to(xdt)
    x = x[x_offset:].view(M, K)
    args = (x, qw, sc, fmt, group)
    k = ops.quant_matmul(*args)
    k2 = ops.quant_matmul(*args)
    p = plain_quant_matmul(*args)
    lib = torch.matmul(x, wd)
    torch.cuda.synchronize()
    check(torch.equal(k.view(torch.int16), k2.view(torch.int16)),
          f"quant_matmul {fmt} [{M}, {K}, {N}]: two launches differ")
    nbytes = (x.numel() * x.element_size() + qw.numel()
              + sc.numel() * sc.element_size() + M * N * x.element_size())
    b_ms, b_by = bound(nbytes, 2 * M * K * N, BF16_FLOP_PER_S)
    c = dict(
        shape=[M, K, N], variant=fmt, group=group,
        dtypes=[str(xdt).split(".")[-1], str(sdt).split(".")[-1]],
        body=qm._body(dev.index or 0, x, sc, M, K, N, fmt, group),
        x_offset=x_offset,
        **_checked([k], [p], [_quant_matmul_tolerance(torch, x, wd, p)]),
        library_err=(lib.float() - p.float()).abs().max().item(),
        ms=time_ms(torch, lambda: ops.quant_matmul(*args)),
        plain_ms=time_ms(torch, lambda: plain_quant_matmul(*args), reps=10),
        library_ms=time_ms(torch, lambda: torch.matmul(x, wd)),
        library="torch.matmul on the dequantized weight (dequant "
                "excluded)",
        bound_ms=b_ms, bound_by=b_by)
    c["library_ratio"] = c["ms"] / c["library_ms"]
    c["bound_share"] = c["bound_ms"] / c["ms"]
    extra = ""
    if c["body"] == "decode":
        _, splits, stages, smem, xtma = qm._decode_plan(
            dev.index or 0, x, sc, M, K, N, fmt == "int4", group)
        c["plan"] = dict(splits=splits, stages=stages, smem=smem,
                         x_by_tma=bool(xtma))
        extra = f" plan {c['plan']}"
    if c["body"] == "wgmma":
        int4 = fmt == "int4"
        c["rows_splits"] = qm._schedule(
            M, K, N, int4,
            lambda r: qm._cluster_capacity(dev.index or 0, int4, r))
        # the earlier design, the mma.sync body, on the same inputs
        c["mma_sync_ms"] = time_ms(torch, lambda: _quant_matmul_mma_sync(
            torch, qm, *args))
        extra = (f" (rows, splits) {c['rows_splits']}; the mma.sync body "
                 f"{c['mma_sync_ms']:.4f} ms")
    log(f"[kernels] quant_matmul {fmt} {c['shape']} group {group} "
        f"{c['dtypes']}{f' x at +{x_offset}' if x_offset else ''} "
        f"{c['body']}: {c['ms']:.4f} ms (torch.matmul "
        f"{c['library_ms']:.4f}), {c['library_ratio']:.2f}x the library, "
        f"bound {b_ms:.4f} ms, {c['bound_share']:.3f} of it ({b_by}), "
        f"{c['tol_share']:.3f} of the tolerance{extra}")
    del qw, sc, wd, x, k, k2, p, lib
    return c


def _quant_matmul_mma_sync(torch, qm, x, qw, sc, fmt, group):
    """quant_matmul through its mma.sync body (rows 0) whatever the
    shape: the design the wgmma body replaced at M > 16, for timing."""
    from paddle_tpu_torch.ops import _build
    M, K = x.shape
    N = qw.shape[1]
    splits = qm._splits(M, K, N, qw.numel())
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    part = torch.empty((splits, M, N), dtype=torch.float32,
                       device=x.device) if splits > 1 else None
    rc = _build.library().ptt_quant_matmul(
        x.device.index or 0, _build.dtype_code(x.dtype),
        _build.dtype_code(sc.dtype), int(fmt == "int4"),
        int(group) if fmt == "int4" else 0, x.data_ptr(), qw.data_ptr(),
        sc.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), M, K, N, splits, 0,
        _build.stream_of(x.device))
    _build.check(rc, "quant_matmul")
    return out


def _quant_matmul_cases(torch, ops, g):
    """quant_matmul against plain_quant_matmul, int8 and int4 (group 64)
    bf16 weights from seeded random ones, bf16 x, at M in {8, 256} and
    every [K, N] of the serving path, then at QM_EDGE_CASES (the wgmma
    body's, and the mma.sync body's at M <= 16) and QM_DECODE_EDGE_CASES
    (the decode body's).  Library
    yardstick: torch.matmul of x with the already-dequantized weight
    (the dequant is left out of its time)."""
    bf16 = torch.bfloat16
    out = []
    for fmt in ("int8", "int4"):
        for K, N in QM_SHAPES:
            w = (torch.randn((K, N), generator=g, device=g.device)
                 / K ** 0.5).to(bf16)
            for M in (8, 256):
                out.append(_quant_matmul_case(torch, ops, g, fmt, M, K, N,
                                              QM_GROUP, bf16, bf16, w=w))
            del w
    for fmt, M, K, N, group, xdt, sdt, off in (QM_EDGE_CASES
                                               + QM_DECODE_EDGE_CASES):
        out.append(_quant_matmul_case(torch, ops, g, fmt, M, K, N, group,
                                      getattr(torch, xdt),
                                      getattr(torch, sdt), x_offset=off))
    # the decode shapes (M <= 16) take the decode body, but int4 groups
    # that are not a multiple of 16 the mma.sync body; the admission
    # chunks (and QM_EDGE_CASES past 16 rows) the wgmma body
    for c in out:
        want = ("wgmma" if c["shape"][0] > 16 else "mma.sync"
                if c["variant"] == "int4" and c["group"] % 16 else "decode")
        check(c["body"] == want, f"quant_matmul {c['shape']} took the "
              f"{c['body']} body, not {want}")
    return out


def _checked(outs, refs, tols):
    """_compare's rows folded into one result: the largest error, the
    share of its per-element tolerance the worst element uses, and the
    tolerance there; per output, the errors, shares and tightness."""
    rows = _compare(outs, refs, tols)
    worst = max(rows, key=lambda r: r["share"])
    return dict(max_abs_err=max(r["err"] for r in rows), tol=worst["tol"],
                tol_share=worst["share"], errs=[r["err"] for r in rows],
                shares=[r["share"] for r in rows],
                tight=[r["tight"] for r in rows])


# (u, e) of a dtype: a rounding to it moves x by at most max(u |x|, e)
ROUNDING = {"bfloat16": (2.0 ** -8, 2.0 ** -134),
            "float16": (2.0 ** -11, 2.0 ** -25),
            "float32": (2.0 ** -24, 2.0 ** -150)}


def _rounding_tolerance(torch, dtype, ref, total, w, x, extra=0.0):
    """(tolerance, variance) of an output out = total(w, x), a sum of
    weight x operand terms, against a version that rounds every weight
    to `dtype` at another point (or keeps it fp32) and rounds the output
    once.  In that dtype a rounding moves x by at most r(x) = max(u |x|,
    e) (`ROUNDING`: e is half the subnormal step; a 0 weight, a masked
    key's, rounds exactly).  So per element:
      2 r(plain)               an output rounding that flips (2^-7
                               |plain| for bf16, 2^-10 for fp16);
      16 sqrt(sum r(w)^2 x^2)  the weight roundings: independent and of
                               mean zero, so by Hoeffding each side's sum
                               exceeds 8 sqrt(sum r(w)^2 x^2) with
                               probability < 3e-14; 2^-4 sqrt(sum w^2
                               x^2) for bf16, 2^-7 for fp16;
      2^-12 sum |w| |x|        fp32: scores, hence weights, that differ
                               by ~2^-13 relative, and sums in another
                               order;
      extra                    what the caller adds.
    The variance bounds the mean square of the same rounding errors:
    each is at most r in size, so its variance at most r^2 / 3 a side,
    (2/3)(r(plain)^2 + sum r(w)^2 x^2) for both (fp32 differences, ~2^-20
    relative, left out: so it bounds a 16-bit dtype's errors only).  16 r
    of slack a term is more than the 8x between bf16's and fp16's u, so
    the per-element tolerance alone passes fp16 weights rounded at bf16;
    their mean square error is ~11x this variance, an honest kernel's
    below it."""
    u, e = ROUNDING[str(dtype).split(".")[-1]]

    def r(t):                      # the most one rounding moves t
        return t.float().abs().mul_(u).clamp_min_(e)

    xf = x.float()
    rw2 = total(r(w).masked_fill_(w == 0, 0.0).square_(), xf * xf)
    return (2.0 * r(ref) + 16.0 * rw2.sqrt()
            + 2.0 ** -12 * total(w.abs(), xf.abs()) + extra,
            (2.0 / 3.0) * (r(ref).square_() + rw2) + extra ** 2)


def _paged_tolerance(torch, qt, kg, vg, mask, ref):
    """(tolerance, variance) of paged attention against
    plain_paged_attention, on the pre-gathered dense view (qt [B, h, C,
    d], kg/vg [B, h, S, d], mask [B, 1, C, S]): out = P.V with the
    softmax weights P rounded to q's dtype before P.V, as the reference
    twin rounds them (`_rounding_tolerance` in q's dtype)."""
    scale = qt.shape[-1] ** -0.5
    s = (qt.float() @ kg.float().transpose(-1, -2)) * scale
    P = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return _rounding_tolerance(torch, qt.dtype, ref,
                               lambda w, x: (w @ x).transpose(1, 2), P, vg)


# ---------------------------------------------------------------------------
# phase 4: full-width parity, card kernels vs CPU plain versions
# ---------------------------------------------------------------------------
def phase_parity(torch, dev):
    """The unquantized model, then the quantized ones (int8 weights with
    an int8 KV pool, int4 group-64 weights with an fp32 pool)."""
    return [_parity_case(torch, dev, fmt, kv)
            for fmt, kv in ((None, None), ("int8", "int8"), ("int4", None))]


def _parity_case(torch, dev, fmt, kv):
    from paddle_tpu_torch.inference import ContinuousBatcher
    from paddle_tpu_torch.models import (LlamaForCausalLM, llama_7b_config,
                                         load_numpy_state_dict,
                                         numpy_state_dict)
    from paddle_tpu_torch.quantization import quantize_model
    cfg = llama_7b_config(num_hidden_layers=2, dtype="float32")
    gpu = LlamaForCausalLM(cfg, device=dev, seed=7)
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=7)
    load_numpy_state_dict(cpu, numpy_state_dict(gpu))
    code_diffs = None
    if fmt is not None:
        # each side packs the same fp32 weights (on its own device); the
        # codes must agree, and the card's are carried to the CPU so the
        # logits below compare the kernels on identical weights
        quantize_model(gpu, fmt, QM_GROUP)
        quantize_model(cpu, fmt, QM_GROUP)
        cpu_packed = numpy_state_dict(cpu)
        gpu_packed = numpy_state_dict(gpu)
        code_diffs = int(sum((cpu_packed[n] != a).sum()
                             for n, a in gpu_packed.items()
                             if a.dtype == np.int8))
        check(code_diffs == 0, f"{fmt} codes differ card vs CPU in "
              f"{code_diffs} places")
        load_numpy_state_dict(cpu, gpu_packed)
        del cpu_packed, gpu_packed
    rng = np.random.RandomState(7)
    ids = rng.randint(1, cfg.vocab_size, (2, 48)).astype(np.int32)
    B, ps, P_slot = 2, 16, 4
    pt = np.arange(1, 1 + B * P_slot, dtype=np.int32).reshape(B, P_slot)
    pos = np.zeros((B,), np.int32)
    logits, pools = {}, {}
    with torch.inference_mode():
        for name, m, d in (("gpu", gpu, dev), ("cpu", cpu, "cpu")):
            cache = m.init_paged_cache(1 + B * P_slot, ps, kv)
            lg, cache = m.forward_cached_paged(
                torch.from_numpy(ids).to(d), cache,
                torch.from_numpy(pt).to(d), torch.from_numpy(pos).to(d))
            logits[name] = lg.float().cpu()
            pools[name] = {k: v.cpu() for k, v in cache.items()}
    ref = logits["cpu"]
    err = (logits["gpu"] - ref).abs().max().item()
    # fp32 on both sides: cuBLAS (or quant_matmul's fp32 kernel) and the
    # CPU BLAS sum the 4096- and 11008-long dot products in different
    # orders, and the kernels' reductions differ from the plain versions'
    # — relative drift of ~1e-5; 1e-3 of the logit scale leaves a wide
    # margin.  An int8 pool requantizes each page it writes, which turns
    # that drift (~1e-6 of a K/V value) into occasional one-step code
    # flips (at most one step each, checked below), each moving one K/V
    # element by 1/127 of its page's amax: 2^-6 of the logit scale
    tol = (2.0 ** -6 if kv == "int8" else 1e-3) * max(1.0,
                                                      ref.abs().max().item())
    flips = None
    if kv == "int8":
        steps = [(pools["gpu"][k].int() - pools["cpu"][k].int()).abs()
                 for k in ("k", "v")]
        flips = int(sum((d > 0).sum().item() for d in steps))
        check(max(d.max().item() for d in steps) <= 1,
              "int8 KV codes differ card vs CPU by more than one step")
    check(torch.isfinite(logits["gpu"]).all().item(), "non-finite logits")
    check(err <= tol, f"{fmt or 'unquantized'} prefill logits disagree card "
          f"vs CPU: {err} > {tol}")
    toks = {}
    prompts = [ids[0], ids[1, :40]]
    for name, m, d in (("gpu", gpu, dev), ("cpu", cpu, "cpu")):
        bat = ContinuousBatcher(m, max_batch_size=2, max_len=128,
                                prefill_chunk=32, chunk=4, kv_dtype=kv,
                                device=d)
        rids = [bat.submit(p, 8) for p in prompts]
        out = bat.run()
        toks[name] = [out[r].tolist() for r in rids]
    check(toks["gpu"] == toks["cpu"],
          f"greedy tokens disagree card vs CPU: {toks}")
    what = "fp32" if fmt is None else f"{fmt} weights, {kv or 'fp32'} KV"
    log(f"[parity] 2-layer full-width {what}: prefill logits max abs err "
        f"{err:.3g} (tol {tol:.3g}); greedy tokens equal: {toks['gpu']}"
        + ("" if code_diffs is None else
           f"; packed codes equal card vs CPU ({code_diffs} differ)")
        + ("" if flips is None else
           f"; int8 KV codes one step apart in {flips} places"))
    del gpu, cpu
    torch.cuda.empty_cache()
    return dict(weights=fmt, kv=kv, err=err, tol=tol, kv_code_flips=flips)


# ---------------------------------------------------------------------------
# phase 5: serve Llama-2-7B at full width and depth
# ---------------------------------------------------------------------------
def serve_requests(V):
    """Phase 5's 16 requests (seed 2024): 8 of 64-512 random tokens and 8
    of a shared 256-token system prefix plus 32-256 of their own, in the
    order they are submitted; 64 new tokens each."""
    rng = np.random.RandomState(2024)
    system = rng.randint(1, V, 256).astype(np.int32)
    shared = [np.concatenate([system, rng.randint(1, V, L).astype(np.int32)])
              for L in np.linspace(32, 256, 8).astype(int)]   # 288..512
    plain = [rng.randint(1, V, L).astype(np.int32)
             for L in np.linspace(64, 512, 8).astype(int)]    # 64..512
    # the first wave holds one shared-prefix request, so the seven that
    # follow find its prefix pages complete and resident
    return [shared[0]] + plain[:7] + shared[1:] + plain[7:], 64


def phase_serve(torch, ops, dev, weight_only=None, kv_dtype=None,
                tag="serve"):
    """Serve Llama-2-7B through ContinuousBatcher: phase 5 (bf16, as
    built), 10 (weight_only "int8", kv_dtype "int8") and 11 (weight_only
    "int4" at FLAGS_weight_only_group_size 64, bf16 KV) — the same
    requests, geometry and seed.  Returns (the logged record, launch
    counts, per-variant launches)."""
    from paddle_tpu_torch.inference import ContinuousBatcher
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_7b_config
    from paddle_tpu_torch.quantization import weight_pool_bytes
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = llama_7b_config()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, seed=2024)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bat = ContinuousBatcher(model, max_batch_size=8, max_len=1024,
                            prefill_chunk=32, chunk=16,
                            weight_only_dtype=weight_only, kv_dtype=kv_dtype,
                            device=dev)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    V = cfg.vocab_size
    prompts, new = serve_requests(V)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rids = [bat.submit(p, new) for p in prompts]
    out = bat.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    variants = {n: dict(ops.kernel_module(n).variant_launches)
                for n in ("paged_attention", "quant_matmul")}
    st = bat.stats()
    reqs = bat.finished_requests
    check(len(out) == 16 and all(len(out[r]) == new for r in rids),
          f"{tag}: not every request completed with 64 tokens")
    check(all(((out[r] >= 0) & (out[r] < V)).all() for r in rids),
          f"{tag}: token ids outside the vocabulary")
    check(st["prefix_hit_tokens"] > 0, f"{tag}: no prefix hits")
    check(st["weight_only"] == (weight_only or "none"),
          f"{tag}: stats weight_only {st['weight_only']}")
    steps, L = st["forward_steps"], cfg.num_hidden_layers
    # per forward step: 2 norms a layer and the final one, rope and
    # attention once a layer; quantized, 7 projections a layer and the
    # untied lm head
    want = dict.fromkeys(counts, 0)
    want.update({"rms_norm": steps * (2 * L + 1), "rope": steps * L,
                 "paged_attention": steps * L,
                 "quant_matmul": steps * (7 * L + 1) if weight_only else 0})
    check(counts == want, f"{tag} launch counts {counts} != predicted {want}")
    want_var = {"paged_attention": {"fp": 0, "int8": 0},
                "quant_matmul": {"int8": 0, "int4": 0}}
    want_var["paged_attention"]["int8" if kv_dtype == "int8" else "fp"] = \
        steps * L
    if weight_only:
        want_var["quant_matmul"][weight_only] = steps * (7 * L + 1)
    check(variants == want_var,
          f"{tag} variant launches {variants} != predicted {want_var}")
    ttft = sorted((reqs[r].t_first - reqs[r].t_submit) * 1e3 for r in rids)
    serve = dict(
        weight_only=st["weight_only"], kv_dtype=st["kv_dtype"],
        requests=16, new_tokens_each=new,
        prompt_tokens=int(sum(len(p) for p in prompts)),
        wall_s=wall, tok_per_s=st["tokens_produced"] / wall,
        ttft_ms_p50=ttft[len(ttft) // 2],
        decode_ms_per_step=st["decode_chunk_time_p50"] / bat.chunk * 1e3,
        admit_ms_per_step=st["admit_chunk_time_p50"] / bat.admit_steps * 1e3,
        forward_steps=steps, admit_chunks=st["admit_chunks"],
        decode_chunks=st["decode_chunks"],
        prefix_hit_tokens=st["prefix_hit_tokens"],
        prefill_tokens=st["prefill_tokens"], cow_copies=st["cow_copies"],
        evictions=st["evictions"], kv_bytes=st["kv_bytes"],
        weight_pool_bytes=weight_pool_bytes(model),
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
        model_init_s=init_s, batcher_init_s=quantize_s, launches=counts,
        variant_launches=variants)
    log(f"[{tag}] " + json.dumps(serve))
    trace = decode_trace(torch, model, dev, bat.chunk, kv_dtype)
    log(f"[{tag}-trace] " + json.dumps(trace))
    if weight_only:
        trace = admit_trace(torch, model, dev, kv_dtype)
        log(f"[{tag}-admit-trace] " + json.dumps(trace))
    del bat, model
    torch.cuda.empty_cache()
    return serve, counts, variants


def decode_trace(torch, model, dev, chunk, kv_dtype=None, **batcher_kw):
    """Where a decode step's time goes: 8 slots in pure decode, two
    chunks timed without a profiler (wall), then two more under
    torch.profiler (device time per kernel name and kind).  busy_share
    is the profiled device time over the unprofiled wall of as many
    steps.  batcher_kw: the speculation arguments of phase 13."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.inference import ContinuousBatcher
    bat = ContinuousBatcher(model, max_batch_size=8, max_len=1024,
                            prefill_chunk=32, chunk=chunk, kv_dtype=kv_dtype,
                            device=dev, **batcher_kw)
    rng = np.random.RandomState(99)
    for _ in range(8):
        bat.submit(rng.randint(1, model.config.vocab_size, 100), 200)
    while bat.stats()["decode_chunks"] < 1:     # finish every prefill
        bat.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bat.step()
    bat.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        bat.step()
        bat.step()
        torch.cuda.synchronize()
    return _trace_record(prof, wall_ms, 2 * chunk)


def _trace_record(prof, wall_ms, steps):
    """A profiled window of `steps` forward steps against the unprofiled
    wall of as many: device ms per step by kind, events per step, the
    busy share and the top kernels."""
    from torch.autograd import DeviceType
    # device-side rows only (kernels, copies): the CPU op rows would
    # count the same kernel time a second time
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    by_kind, events = _by_kind(rows)
    return dict(steps=steps, wall_ms_per_step=wall_ms / steps,
                device_ms_per_step=busy_ms / steps if rows else None,
                busy_share=busy_ms / wall_ms if rows else None,
                by_kind_ms_per_step={k: v / steps for k, v in by_kind.items()},
                events_per_step={k: v / steps for k, v in events.items()},
                top=[(k[:60], round(ms / steps, 4)) for k, ms, _ in rows[:10]])


def admit_trace(torch, model, dev, kv_dtype=None):
    """Where an admission step's time goes (a quantized model): 8 slots
    prefilling 512-token prompts, each chunk admit_steps forward steps
    of [8 slots, 32 tokens] (M = 256 on every projection).  After a
    first chunk, one chunk is timed without a profiler (wall) and the
    next one under torch.profiler: device ms per admission step by kind
    (quant_matmul's among them) and the busy share."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.inference import ContinuousBatcher
    bat = ContinuousBatcher(model, max_batch_size=8, max_len=1024,
                            prefill_chunk=32, chunk=16, kv_dtype=kv_dtype,
                            device=dev)
    rng = np.random.RandomState(98)
    for _ in range(8):
        bat.submit(rng.randint(1, model.config.vocab_size, 512), 8)
    bat.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bat.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        bat.step()
        torch.cuda.synchronize()
    st = bat.stats()
    check(st["admit_chunks"] == 3 and st["decode_chunks"] == 0,
          f"the admission trace ran {st['admit_chunks']} admission and "
          f"{st['decode_chunks']} decode chunks, not 3 and 0")
    rec = _trace_record(prof, wall_ms, bat.admit_steps)
    rec["quant_matmul_ms_per_step"] = \
        rec["by_kind_ms_per_step"]["quant_matmul"]
    del bat
    torch.cuda.empty_cache()
    return rec


# trace kinds: the first kind whose pattern a kernel's name holds;
# PyTorch's own kernels split by what they are (an int8 pool's page write
# is index/gather/scatter, elementwise and reduce kernels)
TRACE_KINDS = {"nccl": ("nccl",), "memcpy": ("Memcpy",),
               "flash_attention": ("flash_",),
               "paged_attention": ("paged_attention",),
               "quant_matmul": ("quant_matmul",),
               "rms_norm": ("rms_norm", "rms_fwd", "rms_bwd", "rms_dw"),
               "rope": ("rope_kernel",), "fused_adamw": ("fused_adamw",),
               "cross_entropy": ("ce_rows",),
               "matmul": ("nvjet", "gemm", "cutlass", "sm90_xmma"),
               "copy_cast": ("copy", "Copy"),
               "reduce": ("reduce_kernel",),
               "index_embedding": ("index", "gather", "scatter",
                                   "embedding"),
               "softmax_loss": ("softmax", "nll_loss", "cross_entropy"),
               "elementwise": ("elementwise",)}


def _by_kind(rows):
    """(device ms by kind, kernel events by kind) of trace rows (name,
    ms, count)."""
    by_kind = dict.fromkeys(list(TRACE_KINDS) + ["other"], 0.0)
    events = dict.fromkeys(by_kind, 0)
    for key, ms, n in rows:
        kind = next((k for k, pats in TRACE_KINDS.items()
                     if any(p in key for p in pats)), "other")
        by_kind[kind] += ms
        events[kind] += n
    return by_kind, events


# ---------------------------------------------------------------------------
# phase 6: training kernels against their plain versions
# ---------------------------------------------------------------------------
def _compare(outs, refs, tols):
    """Kernel outputs against their plain versions, element by element,
    each against its own tolerance `tols[i]` (a tensor like the output).
    Per output: the max |kernel - plain|, the largest share of its
    tolerance that any element uses (the check is share <= 1), the
    tolerance at that element, and the median tolerance over the median
    |plain| -- how tight the check is against a typical entry."""
    rows = []
    for o, r, t in zip(outs, refs, tols):
        diff = (o.float() - r.float()).abs()
        share = (diff / t.clamp_min(1e-30)).flatten()
        i = int(share.argmax())
        rows.append(dict(err=diff.max().item(), share=share[i].item(),
                         tol=t.flatten()[i].item(),
                         tight=(t.float().median()
                                / r.float().abs().median().clamp_min(1e-30))
                         .item()))
    return rows


def _grad_timer(torch, outs, ins, cots):
    """One backward of an already-recorded graph (the forward excluded)."""
    return lambda: torch.autograd.grad(outs, ins, cots, retain_graph=True)


def _rms_bwd_tolerances(torch, x, w, g, dx_ref, dw_ref, eps):
    """Per-element tolerances of the RMSNorm backward kernel against
    plain_rms_norm_bwd.  Both do the same fp32 math and round dx and dw
    once, so a rounding that flips gives one ulp of the output's dtype,
    at most eps |plain| (eps: 2^-7 bf16, 2^-10 fp16, 2^-23 fp32).
    The fp32 parts differ in summation order and FMA contraction: the
    sum of squares by <= H 2^-24 relative (so r^3 by 3x that, < 2^-10),
    the row dot by <= 2^-16 of the sum of its |terms|, dw by <= rows
    2^-24 <= 2^-10 of the sum of its |terms|.  dx's two terms can
    cancel, so their slack is taken from each term's own size."""
    xf, wf, gf = x.float(), w.float(), g.float()
    rows, H = xf.shape
    r = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    gw = gf * wf
    dot = (gw * xf).mean(-1, keepdim=True)
    dot_abs = (gw * xf).abs().mean(-1, keepdim=True)
    ulp = torch.finfo(dx_ref.dtype).eps
    dx_tol = (ulp * dx_ref.float().abs()
              + 2.0 ** -10 * (r * gw.abs() + r ** 3 * xf.abs() * dot.abs())
              + 2.0 ** -16 * r ** 3 * xf.abs() * dot_abs)
    dw_tol = (torch.finfo(dw_ref.dtype).eps * dw_ref.float().abs()
              + 2.0 ** -10 * (gf * xf * r).abs().sum(0))
    return dx_tol, dw_tol


def _flash_tolerances(torch, ops, fa, q, k, v, out, lse, dout, refs, scale,
                      causal=True):
    """Per-element tolerances of the flash kernels (out, dq, dk, dv)
    against plain_flash_fwd / plain_flash_bwd, from the rounding model.
    q [b, sq, h, d], k/v [b, sk, hk, d]: any query-head group, sq != sk
    when not causal, the causal mask top-left as the kernels'.

    Each output is a sum of weight x operand terms: P.V (out), dS.K
    (dq), dS^T.Q and P^T.dO summed over the query-head group (dk, dv).
    Each side rounds every weight (p or ds) to the operand dtype once
    and rounds each output once: `_rounding_tolerance` in q's dtype,
    whose fp16 weights reach its subnormals at long rows.  dq and dk
    add dP = dO.v^T, an fp32 dot of 128 terms (<= 2^-17 of ||dO_i||
    ||v_j|| per side) that delta can cancel; it enters ds unrounded.
    Weights of masked keys are 0 on both sides.

    Returns (tolerance, variance) per output."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    grp = h // hk
    P = torch.exp(fa._masked_scores(q, k, causal, scale) - lse[..., None])
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
    dS = (ops.gqa_scores(dout, v) - delta[..., None]).mul_(P).mul_(scale)
    dn = dout.float().norm(dim=-1).transpose(1, 2)             # [b, h, sq]
    vn = v.float().norm(dim=-1).transpose(1, 2)                # [b, hk, sk]
    slack = (2.0 ** -16 * scale) * P * dn[..., None] \
        * vn.repeat_interleave(grp, dim=1)[:, :, None, :]

    def rows(w, x):                # sum over keys: [b, sq, h, d]
        return ops.gqa_weighted_v(w, x).transpose(1, 2)

    def keys(w, x):                # sum over the group's rows: [b, sk, hk, d]
        return torch.einsum("bhgqk,bqhgd->bkhd",
                            w.reshape(b, hk, grp, sq, sk),
                            x.reshape(b, sq, hk, grp, d))

    def tol(ref, total, w, x, extra=0.0):
        return _rounding_tolerance(torch, q.dtype, ref, total, w, x, extra)

    return [tol(refs[0], rows, P, v),
            tol(refs[1], rows, dS, k, rows(slack, k.float().abs())),
            tol(refs[2], keys, dS, q, keys(slack, q.float().abs())),
            tol(refs[3], keys, P, dout)]


# RMSNorm backward shapes of phase 6 beside the training shape, each run
# with and without the residual cotangent: Llama-2-7B's width at a
# 4096-token prefill, one row, a ragged last batch, H = 8192 (two vectors
# a thread), the element path (H % 8 != 0), fp16, fp32, the widest row
# (the wide body) and an unaligned x (the element path's wide body)
RMS_BWD_EDGE_CASES = [
    dict(case="llama-2-7b prefill", rows=4096, H=4096),
    dict(case="one row", rows=1, H=2560),
    dict(case="ragged rows", rows=8193, H=2560),
    dict(case="H=8192", rows=2048, H=8192),
    dict(case="element path H=1003", rows=4096, H=1003),
    dict(case="fp16", rows=8192, H=2560, dtype="float16"),
    dict(case="fp32", rows=8192, H=2560, dtype="float32"),
    dict(case="widest H=58079", rows=256, H=58079),
    dict(case="unaligned x", rows=1024, H=2560, offset=1),
]


# sha256 of add_rms_norm_kernel's source text in csrc/rms_norm.cu, from
# its template line to its closing brace: the fused add's forward that
# PERF.md's kernel table times.  An edit to it changes the digest and
# must come with that row's new numbers.
ADD_RMS_NORM_SHA256 = \
    "542380841772355e0b53bfb930fd6694871adc4a037fbd621f9449171e09c771"


def _check_add_rms_norm_source():
    import hashlib
    src = open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "paddle_tpu_torch", "csrc", "rms_norm.cu")).read()
    start = src.index(
        "template <typename T>\n__global__ void add_rms_norm_kernel(")
    text = src[start:src.index("\n}\n", start) + 3]
    digest = hashlib.sha256(text.encode()).hexdigest()
    check(digest == ADD_RMS_NORM_SHA256,
          f"add_rms_norm_kernel's source changed (sha256 {digest})")
    log(f"[train-kernels] add_rms_norm_kernel source unchanged "
        f"(sha256 {digest[:16]})")


def _rms_bwd_bytes(x, resid):
    """x, g (and g_resid) read and dx written once, w read and dw
    written once."""
    rows, H = x.shape
    return ((4 if resid else 3) * rows * H + 2 * H) * x.element_size()


# csrc/rms_norm.cu's table of the backward's body by shape: (dtype, H,
# vector path) -> (vectors a thread, threads, rows a batch, rows a batch
# with the residual cotangent); vectors 0 is the wide body
RMS_BWD_PLANS = {
    ("bfloat16", 2560, True): (1, 320, 4, 2),
    ("float16", 2560, True): (1, 320, 4, 2),
    ("bfloat16", 4096, True): (1, 512, 4, 2),
    ("bfloat16", 8192, True): (2, 512, 2, 1),
    ("float16", 8192, True): (2, 512, 2, 1),
    ("float32", 2560, True): (2, 320, 2, 1),
    ("bfloat16", 1003, False): (2, 512, 2, 1),
    ("bfloat16", 32768, True): (0, 256, 1, 1),
    ("bfloat16", 58079, False): (0, 256, 1, 1),
    ("float16", 58079, False): (0, 256, 1, 1),
}


def _rms_bwd_plan(torch, dtype, H, vec, resid):
    """The library's backward body for a shape: [vectors a thread,
    threads, rows a batch], vectors 0 the wide body; None where no body
    takes the shape."""
    import ctypes
    from paddle_tpu_torch.ops import _build
    plan = (ctypes.c_int * 3)()
    rc = _build.library().ptt_rms_norm_bwd_plan(
        _build.dtype_code(getattr(torch, dtype)), H, int(vec), int(resid),
        ctypes.addressof(plan))
    return None if rc else list(plan)


def _rms_bwd_check_plans(torch):
    """Every row of the header's table is the body the library picks,
    and a row past the wide body (H 58080) is refused."""
    for (dtype, H, vec), (v, threads, r, r_resid) in RMS_BWD_PLANS.items():
        for resid, rows in ((False, r), (True, r_resid)):
            got = _rms_bwd_plan(torch, dtype, H, vec, resid)
            check(got == [v, threads, rows],
                  f"rms_norm backward plan {dtype} H {H} vec {vec} residual "
                  f"{resid}: the library picks {got}, the header's table "
                  f"says {[v, threads, rows]}")
    check(_rms_bwd_plan(torch, "bfloat16", 58080, False, False) is None,
          "rms_norm backward plan: H 58080 is past the wide body but taken")


def _rms_bwd_body(torch, rn, x, w, g, gr):
    """The body the library takes for these operands."""
    ops_ = (x, w, g) if gr is None else (x, w, g, gr)
    vec = rn._bwd_vec(x.shape[-1], x.element_size(), *ops_)
    return _rms_bwd_plan(torch, str(x.dtype).split(".")[-1], x.shape[-1],
                         vec, gr is not None)


def _rms_bwd_deterministic(torch, rn, x, w, g, gr, eps):
    """(dx, dw) of the backward, launched twice: both bit-identical."""
    outs = rn._launch_bwd(x, w, g, gr, eps)
    again = rn._launch_bwd(x, w, g, gr, eps)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(outs, again)),
          f"rms_norm backward {list(x.shape)} (residual {gr is not None}): "
          f"dx or dw differ between two launches on the same inputs")
    return list(outs)


def _rms_bwd_case(torch, ops, rn, randn, add, eps, case, rows, H,
                  dtype="bfloat16", offset=0):
    """Both RMSNorm backwards at one shape: every element of dx and dw
    against plain_rms_norm_bwd within _rms_bwd_tolerances, bit-identical
    across two launches, timed beside the library's autograd."""
    F = torch.nn.functional
    dt = getattr(torch, dtype)

    def operand():                 # `offset` elements into its storage
        return randn(rows * H + offset, dtype=dt)[offset:].view(rows, H)

    x, gy, gr = operand(), operand(), operand()
    w = (1.0 + 0.1 * randn(H, dtype=torch.float32)).to(dt)
    for resid in (False, True):
        gres = gr if resid else None
        name = "fused_add_rms_norm_bwd" if resid else "rms_norm_bwd"
        refs = ops.plain_rms_norm_bwd(x, w, gy, eps, gres)
        outs = _rms_bwd_deterministic(torch, rn, x, w, gy, gres, eps)
        xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        if resid:                  # x + 0 then rms_norm: the same work
            yr = torch.zeros_like(x).requires_grad_(True)
            lib_res = xr + yr
            lib = _grad_timer(torch, (lib_res, F.rms_norm(lib_res, (H,), wr,
                                                          eps)),
                              (xr, yr, wr), (gr, gy))
        else:
            lib = _grad_timer(torch, F.rms_norm(xr, (H,), wr, eps), (xr, wr),
                              gy)
        c = add(name, [rows, H], outs, list(refs),
                _rms_bwd_tolerances(torch, x, w, gy, *refs, eps),
                time_ms(torch, lambda: rn._launch_bwd(x, w, gy, gres, eps)),
                time_ms(torch, lambda: ops.plain_rms_norm_bwd(x, w, gy, eps,
                                                              gres), reps=5),
                time_ms(torch, lib),
                "autograd of " + ("x + y then " if resid else "")
                + "torch.nn.functional.rms_norm (backward only)",
                _rms_bwd_bytes(x, resid), (11 if resid else 10) * rows * H,
                case=case, dtype=dtype,
                body=_rms_bwd_body(torch, rn, x, w, gy, gres))
        log(f"[train-kernels] {name} {case} {[rows, H]} {dtype}: body "
            f"{c['body']}, {c['ms']:.4f} ms, {c['ms'] / c['library_ms']:.2f}x "
            f"the library, {c['bound_ms'] / c['ms']:.3f} of the "
            f"{c['bound_by']} bound")
        del refs, outs, xr, wr, lib


# flash attention shapes of phase 6 beside the training shape: the edges
# of the kernels' tiling (ragged s, sq != sk without the causal mask,
# d = 64, fp16, MHA and group 8, B = 1) and Llama-2-7B's attention
FLASH_EDGE_CASES = [
    dict(case="ragged s=1000", b=2, sq=1000, sk=1000, h=8, hk=2, d=128),
    dict(case="ragged s=77, d=64, fp16", b=3, sq=77, sk=77, h=4, hk=1, d=64,
         dtype="float16"),
    dict(case="non-causal sq=300 sk=1000, group 8", b=2, sq=300, sk=1000,
         h=16, hk=2, d=128, causal=False),
    dict(case="non-causal sq=1000 sk=77, d=64, MHA", b=1, sq=1000, sk=77,
         h=4, hk=4, d=64, causal=False),
    dict(case="d=64, MHA, B=1", b=1, sq=2048, sk=2048, h=16, hk=16, d=64),
    dict(case="fp16, group 8", b=2, sq=1024, sk=1024, h=32, hk=4, d=128,
         dtype="float16"),
    dict(case="llama-2-7b", b=1, sq=4096, sk=4096, h=32, hk=32, d=128),
]


def _flash_case(torch, ops, fa, randn, add, case, b, sq, sk, h, hk, d,
                causal=True, dtype="bfloat16"):
    """Flash attention forward and backward at one shape: every element
    against the plain versions within `_flash_tolerances`, the kernels'
    time beside the plain versions' and SDPA's."""
    dt = getattr(torch, dtype)
    q, k, v, do = randn(b, sq, h, d, dtype=dt), randn(b, sk, hk, d, dtype=dt), \
        randn(b, sk, hk, d, dtype=dt), randn(b, sq, h, d, dtype=dt)
    sc = d ** -0.5
    out, lse = fa._launch_fwd(q, k, v, causal, sc)
    p_out, p_lse = ops.plain_flash_fwd(q, k, v, causal, sc)
    grads = fa._launch_bwd(q, k, v, out, lse, do, causal, sc)
    refs = ops.plain_flash_bwd(q, k, v, out, lse, do, causal, sc)
    tols, var = zip(*_flash_tolerances(torch, ops, fa, q, k, v, out, lse,
                                       do, [p_out, *refs], sc, causal))
    # mean square error over the rounding model's variance: <= 1
    msq = [((o.float() - p.float()).square_() / s2).mean().item()
           for o, p, s2 in zip([out, *grads], [p_out, *refs], var)]
    del var
    check(max(msq) <= 1.0, f"flash attention ({case}): mean square errors "
          f"{msq} of out, dq, dk, dv exceed the rounding model's variance")
    torch.cuda.synchronize()
    # causal: half the (row, key) pairs
    fwd_flops = 4 * b * h * (sq * sk // 2 if causal else sq * sk) * d
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    extra = dict(case=case, kv_heads=hk, sk=sk, causal=causal, dtype=dtype)
    # lse = m + log l: fp32 scores, exp and sums in another order move
    # it by a few ulps of m and of log l (each |.| < ~10), ~1e-6; an
    # entry near 0 keeps that absolute error, so 1e-5 (1 + |lse|)
    fwd = add("flash_attention", [b, sq, h, d], [out, lse], [p_out, p_lse],
              [tols[0], 1e-5 * (1.0 + p_lse.abs())],
              time_ms(torch, lambda: fa._launch_fwd(q, k, v, causal, sc)),
              time_ms(torch, lambda: ops.plain_flash_fwd(q, k, v, causal, sc),
                      reps=5),
              time_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=causal,
                                          enable_gqa=True)),
              "scaled_dot_product_attention(is_causal, enable_gqa)",
              (2 * q.numel() + 2 * k.numel()) * q.element_size()
              + lse.numel() * 4, fwd_flops, msq_share=msq[:1], **extra)
    del p_out, p_lse
    qr, kr, vr = (t.clone().requires_grad_(True) for t in (qt, kt, vt))
    lib_out = sdpa(qr, kr, vr, is_causal=causal, enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    bwd = add("flash_attention_bwd", [b, sq, h, d], list(grads), list(refs),
              tols[1:],
              time_ms(torch, lambda: fa._launch_bwd(q, k, v, out, lse, do,
                                                    causal, sc)),
              time_ms(torch, lambda: ops.plain_flash_bwd(
                  q, k, v, out, lse, do, causal, sc), reps=5),
              time_ms(torch, _grad_timer(torch, lib_out, (qr, kr, vr), dot)),
              "scaled_dot_product_attention backward (is_causal, enable_gqa)",
              (4 * q.numel() + 4 * k.numel()) * q.element_size()
              + 2 * lse.numel() * 4, 5 * fwd_flops // 2, msq_share=msq[1:],
              **extra)
    log(f"[train-kernels] flash {case}: kernel / SDPA forward "
        f"{fwd['ms'] / fwd['library_ms']:.2f}x, backward "
        f"{bwd['ms'] / bwd['library_ms']:.2f}x")


def phase_train_kernels(torch, ops, dev):
    F = torch.nn.functional
    rn = ops.kernel_module("rms_norm")
    ro = ops.kernel_module("rope")
    fa = ops.kernel_module("flash_attention")
    g = torch.Generator(device=dev)
    g.manual_seed(4321)
    bf16 = torch.bfloat16
    # the plain versions' bf16 and fp16 GEMMs accumulate in fp32
    # throughout, as the tolerances below assume
    mm = torch.backends.cuda.matmul
    reduced = (mm.allow_bf16_reduced_precision_reduction,
               mm.allow_fp16_reduced_precision_reduction)
    mm.allow_bf16_reduced_precision_reduction = False
    mm.allow_fp16_reduced_precision_reduction = False

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.float32).to(dtype)

    cfg = train_config()
    b, s = TRAIN_BATCH, TRAIN_SEQ
    R, H, eps = b * s, cfg.hidden_size, cfg.rms_norm_eps
    h, hk, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    res = {}

    def add(name, shape, outs, refs, tols, ms, plain_ms, library_ms,
            library, nbytes, flops, rate=BF16_FLOP_PER_S, **extra):
        b_ms, b_by = bound(nbytes, flops, rate)
        res.setdefault(name, []).append(dict(
            shape=shape, **extra, **_checked(outs, refs, tols), ms=ms,
            plain_ms=plain_ms, library_ms=library_ms, library=library,
            bound_ms=b_ms, bound_by=b_by))
        return res[name][-1]

    # Tolerances are per element.  bf16 has 8 significant bits: one
    # rounding moves a value by <= 2^-8 of it, so two roundings that
    # differ (kernel, plain) by <= 2^-7.

    # -- RMSNorm forward and backward on [8192, 2560] ------------------------
    x, gy = randn(R, H), randn(R, H)
    settle(torch, dev)
    w = (1.0 + 0.1 * randn(H, dtype=torch.float32)).to(bf16)
    # the kernel rounds once, after * w; the plain version before and
    # after: <= 3 2^-8 of each output, plus ~2^-12 from fp32 sum order
    p_out = ops.plain_rms_norm(x, w, eps)
    k_out = rn._launch(x, w, eps)
    check(torch.equal(k_out, rn._launch(x, w, eps)),
          "rms_norm train: two launches on the same inputs differ")
    c = add("rms_norm", [R, H], [k_out], [p_out],
            [2.0 ** -6 * p_out.float().abs()],
            time_ms(torch, lambda: rn._launch(x, w, eps)),
            time_ms(torch, lambda: ops.plain_rms_norm(x, w, eps)),
            time_ms(torch, lambda: F.rms_norm(x, (H,), w, eps)),
            "torch.nn.functional.rms_norm", (2 * R * H + H) * 2, 4 * R * H,
            case="train", plan=_rms_fwd_plan(torch, rn, x, w))
    log(f"[train-kernels] rms_norm train {[R, H]}: plan {c['plan']}, "
        f"{c['ms']:.4f} ms, {c['ms'] / c['library_ms']:.2f}x the library, "
        f"{c['bound_ms'] / c['ms']:.3f} of the bytes bound")
    del k_out
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    lib_out = F.rms_norm(xr, (H,), wr, eps)
    refs = ops.plain_rms_norm_bwd(x, w, gy, eps)
    add("rms_norm_bwd", [R, H],
        _rms_bwd_deterministic(torch, rn, x, w, gy, None, eps), list(refs),
        _rms_bwd_tolerances(torch, x, w, gy, *refs, eps),
        time_ms(torch, lambda: rn._launch_bwd(x, w, gy, None, eps)),
        time_ms(torch, lambda: ops.plain_rms_norm_bwd(x, w, gy, eps)),
        time_ms(torch, _grad_timer(torch, lib_out, (xr, wr), gy)),
        "autograd of torch.nn.functional.rms_norm (backward only)",
        _rms_bwd_bytes(x, False), 10 * R * H, case="train",
        body=_rms_bwd_body(torch, rn, x, w, gy, None))
    del lib_out, xr, wr, refs, p_out

    # -- fused add + RMSNorm forward and backward ----------------------------
    y, gr = randn(R, H), randn(R, H)
    k_res, k_out = rn._launch_add(x, y, w, eps)
    p_res, p_out = ops.plain_fused_add_rms_norm(x, y, w, eps)
    torch.cuda.synchronize()
    # the residual must be bit-identical to x + y: tolerance 0
    add("fused_add_rms_norm", [R, H], [k_res, k_out], [p_res, p_out],
        [torch.zeros_like(p_res, dtype=torch.float32),
         2.0 ** -6 * p_out.float().abs()],
        time_ms(torch, lambda: rn._launch_add(x, y, w, eps)),
        time_ms(torch, lambda: ops.plain_fused_add_rms_norm(x, y, w, eps)),
        time_ms(torch, lambda: F.rms_norm(x + y, (H,), w, eps)),
        "x + y, then torch.nn.functional.rms_norm (two calls)",
        4 * R * H * 2 + H * 2, 5 * R * H)
    _check_add_rms_norm_source()
    xr, yr = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
    wr = w.clone().requires_grad_(True)
    lib_res = xr + yr
    lib_out = F.rms_norm(lib_res, (H,), wr, eps)
    refs = ops.plain_rms_norm_bwd(k_res, w, gy, eps, gr)
    add("fused_add_rms_norm_bwd", [R, H],
        _rms_bwd_deterministic(torch, rn, k_res, w, gy, gr, eps), list(refs),
        _rms_bwd_tolerances(torch, k_res, w, gy, *refs, eps),
        time_ms(torch, lambda: rn._launch_bwd(k_res, w, gy, gr, eps)),
        time_ms(torch, lambda: ops.plain_rms_norm_bwd(k_res, w, gy, eps,
                                                      gr)),
        time_ms(torch, _grad_timer(torch, (lib_res, lib_out), (xr, yr, wr),
                                   (gr, gy))),
        "autograd of x + y then torch.nn.functional.rms_norm (backward "
        "only)", _rms_bwd_bytes(x, True), 11 * R * H, case="train",
        body=_rms_bwd_body(torch, rn, k_res, w, gy, gr))
    del x, y, gy, gr, k_res, k_out, p_res, p_out, lib_res, lib_out, xr, yr, \
        wr, refs
    for name in ("rms_norm_bwd", "fused_add_rms_norm_bwd"):
        c = res[name][0]
        log(f"[train-kernels] {name} train {c['shape']}: body {c['body']} "
            f"{c['ms']:.4f} ms, the library {c['library_ms']:.4f} ms, "
            f"{c['bound_ms'] / c['ms']:.3f} of the {c['bound_by']} bound")
    _rms_bwd_check_plans(torch)
    for case in RMS_BWD_EDGE_CASES:
        _rms_bwd_case(torch, ops, rn, randn, add, eps, **case)
    torch.cuda.empty_cache()

    # -- RoPE forward and backward, q [4, 2048, 20, 128], k [.., 4, ..],
    # then ROPE_EDGE_CASES -----------------------------------------------
    q, kk = randn(b, s, h, d), randn(b, s, hk, d)
    cos, sin = ops.rope_cos_sin(s, d, 10000.0, device=dev)
    fwd, bwd = _rope_case(torch, ops, ro, "train", q, kk, cos.contiguous(),
                          sin.contiguous(), bwd=True)
    res["rope"], res["rope_bwd"] = [fwd], [bwd]
    del q, kk
    for case in ROPE_EDGE_CASES:
        for name, c in zip(("rope", "rope_bwd"),
                           _rope_edge_case(torch, ops, ro, randn, **case)):
            res[name].append(c)
        torch.cuda.empty_cache()

    # -- flash attention forward and backward: the training shape (causal
    # GQA, the head case of the kernels line), then the edge shapes -------
    for case in [dict(case="train", b=b, sq=s, sk=s, h=h, hk=hk, d=d),
                 *FLASH_EDGE_CASES]:
        _flash_case(torch, ops, fa, randn, add, **case)
        torch.cuda.empty_cache()
    _adamw_kernel_cases(torch, ops, g, add)
    _ce_kernel_case(torch, ops, g, add)
    torch.cuda.empty_cache()
    (mm.allow_bf16_reduced_precision_reduction,
     mm.allow_fp16_reduced_precision_reduction) = reduced
    for name, cases in res.items():
        for c in cases:
            ms = {k: c[k] if c[k] is None else round(c[k], 4)
                  for k in ("ms", "plain_ms", "library_ms")}
            msq = (f", mean square / variance {c['msq_share']}"
                   if "msq_share" in c else "")
            log(f"[train-kernels] {name} {c['shape']}"
                f"{' ' + c['variant'] if 'variant' in c else ''}"
                f"{' (' + c['case'] + ')' if 'case' in c else ''}: err "
                f"{c['errs']}, share of the per-element tolerance "
                f"{c['shares']}, median tol / median |plain| {c['tight']}"
                f"{msq}; "
                f"kernel {ms['ms']} ms, plain {ms['plain_ms']} ms, library "
                f"{ms['library_ms']} ms, bound {c['bound_ms']:.5f} ms "
                f"({c['bound_by']})")
            check(c["tol_share"] <= 1.0,
                  f"{name} {c['shape']} disagrees with its plain version: "
                  f"errors {c['errs']} use {c['shares']} of their "
                  f"per-element tolerances")
    return res


# AdamW variants: (fp32 parameters?, ef?) -> the TPU kernel body each
# stands for; the first is the one the bench_llama step runs
ADAMW_VARIANTS = {"fp32": (True, False), "fp32_ef": (True, True),
                  "master": (False, False), "master_ef": (False, True)}


def _adamw_kernel_cases(torch, ops, gen, add):
    """The fused AdamW kernel against plain_fused_adamw, all four
    variants, at the MLP weight's [2560, 6912] (the largest parameter of
    the training step; timed), a norm weight's [2560] and a [2563] whose
    last 3 elements take the kernel's scalar tail.  bf16 moments as in
    the training step; grads fp32 for fp32 parameters, bf16 for bf16
    ones.  Both sides update in place, so each runs on its own copy."""
    fam = ops.kernel_module("fused_adamw")
    bf16, f32 = torch.bfloat16, torch.float32
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.1, decoupled=True)
    lr, step = 3e-4, 5
    for name, (fp32_params, ef) in ADAMW_VARIANTS.items():
        for shape in ((2560, 6912), (2560,), (2563,)):
            def rnd(scale, dtype=f32, positive=False):
                t = torch.randn(shape, generator=gen, device=gen.device,
                                dtype=f32) * scale
                return (t.abs() if positive else t).to(dtype)
            g = rnd(1e-2, f32 if fp32_params else bf16)
            m = rnd(1e-2, bf16)
            v = rnd(1e-2, f32, True).square().to(bf16)
            # a residual of the size bf16 rounding leaves on v
            e = (v.float() * torch.empty_like(v, dtype=f32).uniform_(
                -2.0 ** -9, 2.0 ** -9, generator=gen)).to(bf16) if ef \
                else None
            mst = rnd(1.0)
            out_dtype = f32 if fp32_params else bf16
            state = lambda: [t.clone() if t is not None else None
                             for t in (m, v, mst, e)]
            km, kv, kmst, ke = state()
            pm, pv, pmst, pe = state()
            kp = None if fp32_params else torch.empty_like(mst, dtype=bf16)
            kout = fam._launch(g, km, kv, kmst, lr, step, ef=ke, param=kp,
                               out_dtype=out_dtype, **kw)
            pout = fam.plain_fused_adamw(g, pm, pv, pmst, lr, step, ef=pe,
                                         out_dtype=out_dtype, **kw)
            torch.cuda.synchronize()
            # the same fp32 ops in the same order, each rounded once (no
            # FMA, true divisions): expected bit-identical.  Tolerance one
            # rounding of each stored value: 2^-7 |plain| for a bf16 one;
            # the fp32 master an ulp of itself plus 2^-22 of its step (an
            # ulp of sqrt or of a quotient upstream)
            step_size = (pout[3] - mst).abs()
            tols = [2.0 ** -7 * pout[0].float().abs(),
                    2.0 ** -7 * pout[1].float().abs(),
                    2.0 ** -7 * pout[2].float().abs(),
                    2.0 ** -23 * pout[3].abs() + 2.0 ** -22 * step_size]
            if fp32_params:
                tols[0] = tols[3]
            if ef:
                # ef is v's rounding residual: where v came out the same,
                # an ulp of ef itself; where v's rounding flipped, an ulp
                # of v
                same_v = kout[2] == pout[2]
                tols.append(torch.where(same_v, 2.0 ** -7 * pout[4].float()
                                        .abs(), 2.0 ** -7 * pout[2].float()
                                        .abs()))
            n = g.numel()
            # bytes: grad, m, v, [ef], master read; m, v, [ef], master,
            # [half param] written; ~20 fp32 operations per element
            per = (g.element_size() + 2 * 2 + 4 + (2 if ef else 0)
                   + 2 * 2 + 4 + (2 if ef else 0) + (0 if fp32_params else 2))
            # compared first: the timed calls below go on updating the
            # same tensors in place
            entry = add("fused_adamw", list(shape), list(kout), list(pout),
                        tols, None, None, None, None, n * per, 20 * n,
                        rate=FP32_FLOP_PER_S, variant=name)
            if shape == (2560, 6912):
                # library yardstick: torch.optim.AdamW(fused=True)'s step
                # on an fp32 copy of the same parameter and gradient (its
                # moments are fp32: a yardstick, not the same function)
                lp = torch.nn.Parameter(mst.clone())
                lp.grad = g.float()
                lopt = torch.optim.AdamW([lp], lr=lr, weight_decay=0.1,
                                         fused=True)
                entry.update(
                    ms=time_ms(torch, lambda: fam._launch(
                        g, km, kv, kmst, lr, step, ef=ke, param=kp,
                        out_dtype=out_dtype, **kw)),
                    plain_ms=time_ms(torch, lambda: fam.plain_fused_adamw(
                        g, pm, pv, pmst, lr, step, ef=pe,
                        out_dtype=out_dtype, **kw)),
                    library_ms=time_ms(torch, lopt.step),
                    library="torch.optim.AdamW(fused=True).step, fp32 "
                            "moments")
                del lp, lopt
            del g, m, v, e, mst, km, kv, kmst, ke, pm, pv, pmst, pe, kp, \
                kout, pout, tols, step_size


# Cross-entropy rows of phase 6 beside the training chunk, each launched
# twice (bit-identical): one row, rows that are not 16-byte aligned (V % 4
# != 0), Llama-2's vocab with bf16 and fp32 dlog, GPT-2's (fp16 dlog),
# Llama 3's, Qwen2's 151936 (past the largest cluster: the wide body),
# every label -1 (scale 1), and logits at an offset pointer.  Labels are
# random, every 26th -1, row 1's V - 1 and row 2's 0.
CE_EDGE_CASES = [
    dict(case="one row", C=1, V=8192),
    dict(case="unaligned rows", C=1024, V=8191),
    dict(case="llama-2 vocab", C=1024, V=32000),
    dict(case="llama-2 vocab fp32", C=1024, V=32000, dtype="float32"),
    dict(case="gpt-2 vocab fp16", C=256, V=50257, dtype="float16"),
    dict(case="llama-3 vocab", C=64, V=128256),
    dict(case="qwen2 vocab (wide)", C=256, V=151936),
    dict(case="all labels -1", C=1024, V=8192, ignored=True),
    dict(case="logits at x+1", C=1024, V=8192, offset=1),
]

# csrc/cross_entropy.cu's plan by case (ptt_ce_rows_plan): body, logits a
# vector, threads a block, blocks a row
CE_PLANS = {
    "train": ("rows", 4, 256, 1),
    "one row": ("rows", 4, 256, 1),
    "unaligned rows": ("rows", 1, 256, 1),
    "llama-2 vocab": ("cluster", 4, 512, 2),
    "llama-2 vocab fp32": ("cluster", 4, 512, 2),
    "gpt-2 vocab fp16": ("cluster", 1, 416, 4),
    "llama-3 vocab": ("cluster", 4, 512, 8),
    "qwen2 vocab (wide)": ("wide", 1, 256, 1),
    "all labels -1": ("rows", 4, 256, 1),
    "logits at x+1": ("rows", 1, 256, 1),
}
CE_BODIES = ("rows", "cluster", "wide")


def _ce_plan(torch, x, dlog):
    """The library's plan for a launch on these operands: (body, logits a
    vector, threads, blocks a row, blocks, blocks an SM)."""
    import ctypes
    from paddle_tpu_torch.ops import _build
    C, V = x.shape
    plan = (ctypes.c_int * 6)()
    rc = _build.library().ptt_ce_rows_plan(
        0, _build.dtype_code(dlog.dtype), x.data_ptr(), dlog.data_ptr(), C,
        V, ctypes.addressof(plan))
    check(rc == 0, f"cross_entropy plan [{C}, {V}]: CUDA error {rc}")
    return (CE_BODIES[plan[0]], *plan[1:])


def _ce_case(torch, fce, gen, add, case, C, V, dtype="bfloat16",
             ignored=False, offset=0):
    """The cross-entropy rows kernel against plain_ce_rows at one shape
    (fp32 logits ~ 2 N(0, 1), `dtype` dlogits): launched twice
    (bit-identical), held per element, timed beside F.cross_entropy's
    forward + backward, with the plan the library took."""
    dt = getattr(torch, dtype)
    dev = gen.device
    x = (torch.randn((C * V + offset,), generator=gen, device=dev)
         * 2.0)[offset:].view(C, V)
    lbl = torch.randint(0, V, (C,), generator=gen, device=dev,
                        dtype=torch.int32)
    if ignored:
        lbl.fill_(-1)
    elif C == 1:
        lbl[0] = V - 1
    else:
        lbl[::26] = -1
        lbl[1] = V - 1
        lbl[2] = 0
    valid = int((lbl >= 0).sum())
    scale = 1.0 / (lbl >= 0).sum().clamp_min(1).float().reshape(1)
    k_loss, k_d = fce._launch(x, lbl, scale, dt)
    again = fce._launch(x, lbl, scale, dt)
    p_loss, p_d = fce.plain_ce_rows(x, lbl, scale, dt)
    torch.cuda.synchronize()
    check(torch.equal(k_loss, again[0]) and torch.equal(k_d, again[1]),
          f"cross_entropy {case} [{C}, {V}] {dtype}: two launches on the "
          f"same inputs differ")
    check(not k_d[lbl < 0].any() and not k_loss[lbl < 0].any(),
          f"cross_entropy {case}: a row with label -1 is not zero")
    del again
    # per element: lse = m + log(s) with s summed in another order, each
    # side <= ~2^-19 relative, so the row loss within scale 2^-18
    # (|lse| + |picked| + 1) plus an ulp of itself; dlog's fp32 value
    # p - onehot within scale p 2^-18 before its rounding to `dtype`, then
    # one rounding that may flip, 2u |plain| (2^-7 for bf16); fp16's
    # subnormals start at 2^-14, where dlog's entries (~scale / V) lie, so
    # a flip there moves one step, 2e (ROUNDING)
    m = x.amax(-1, keepdim=True)
    e = torch.exp(x - m)
    sm = e.sum(-1, keepdim=True)
    p = e / sm
    lse = (m + sm.log())[:, 0]
    picked = x.gather(-1, lbl.clamp_min(0).long()[:, None])[:, 0]
    loss_tol = scale * 2.0 ** -18 * (lse.abs() + picked.abs() + 1) \
        + 2.0 ** -22 * p_loss.abs()
    u, eps = ROUNDING[dtype]
    d_tol = 2.0 * u * p_d.float().abs() + scale * 2.0 ** -18 * p
    if dtype == "float16":
        d_tol += 2.0 * eps
    del e, p, m, sm, lse, picked
    plan = _ce_plan(torch, x, k_d)
    want = CE_PLANS[case]
    check(plan[:4] == want, f"cross_entropy {case} [{C}, {V}]: the library "
          f"plans {plan[:4]}, CE_PLANS says {want}")
    F = torch.nn.functional
    xr = x.clone().requires_grad_(True)
    lbl64 = lbl.long()

    def library():
        loss = F.cross_entropy(xr, lbl64, ignore_index=-1)
        return torch.autograd.grad(loss, xr)

    # bytes: the logits of the rows with a label (an ignored row's output
    # is zero whatever its logits), dlog written, labels, losses, scale
    c = add("cross_entropy", [C, V], [k_loss, k_d], [p_loss, p_d],
            [loss_tol, d_tol],
            time_ms(torch, lambda: fce._launch(x, lbl, scale, dt)),
            time_ms(torch, lambda: fce.plain_ce_rows(x, lbl, scale, dt)),
            time_ms(torch, library),
            "F.cross_entropy(ignore_index=-1) forward + backward, fp32 grad",
            valid * V * 4 + C * V * k_d.element_size() + C * 4 * 2 + 4,
            6 * valid * V, rate=FP32_FLOP_PER_S, case=case, dtype=dtype,
            x_offset=offset, plan=list(plan))
    log(f"[train-kernels] cross_entropy {case} [{C}, {V}] {dtype}"
        f"{' x+' + str(offset) if offset else ''}: plan {plan}, "
        f"{c['ms']:.4f} ms, {c['ms'] / c['library_ms']:.2f}x the library, "
        f"{c['bound_ms'] / c['ms']:.3f} of the {c['bound_by']} bound, "
        f"tolerance share {c['tol_share']:.3f}")
    del x, xr, k_d, p_d, k_loss, p_loss


def _ce_kernel_case(torch, ops, gen, add):
    """The cross-entropy rows kernel at the training chunk [1024, 8192]
    (bf16 dlogits, the main path's), then at CE_EDGE_CASES."""
    fce = ops.kernel_module("fused_cross_entropy")
    for case in [dict(case="train", C=1024, V=8192), *CE_EDGE_CASES]:
        _ce_case(torch, fce, gen, add, **case)
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 7: train parity at the training width, card kernels vs CPU plain
# ---------------------------------------------------------------------------
def train_config(**kw):
    """bench.py::bench_llama's configuration (bench.py:238-248)."""
    from paddle_tpu_torch.models import LlamaConfig
    cfg = dict(vocab_size=8192, hidden_size=2560, intermediate_size=6912,
               num_hidden_layers=14, num_attention_heads=20,
               num_key_value_heads=4, max_position_embeddings=2048,
               dtype="bfloat16", param_dtype="float32")
    cfg.update(kw)
    return LlamaConfig(**cfg)


def phase_train_parity(torch, dev, fused=False):
    """fused=False: the logits-path loss, no recompute.
    fused=True: FLAGS_fused_ce on and the first of the 2 layers under
    selective recompute.  Both update through the fused AdamW (the
    kernel on the card, its plain version on the CPU)."""
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (LlamaForCausalLM,
                                         load_numpy_state_dict,
                                         numpy_state_dict)
    from paddle_tpu_torch.optimizer import AdamW
    extra = dict(recompute=True, recompute_layers=1,
                 recompute_granularity="selective") if fused else {}
    cfg = train_config(num_hidden_layers=2, dtype="float32",
                       param_dtype=None, **extra)
    gpu = LlamaForCausalLM(cfg, device=dev, seed=11)
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=11)
    load_numpy_state_dict(cpu, numpy_state_dict(gpu))
    rng = np.random.RandomState(11)
    batches = [rng.randint(0, cfg.vocab_size, (2, 256)).astype(np.int32)
               for _ in range(3)]
    lr, losses = 3e-4, {}
    set_flags({"FLAGS_fused_ce": fused})
    try:
        for name, m in (("gpu", gpu), ("cpu", cpu)):
            step = TrainStep(m, m.compute_loss,
                             AdamW(lr, parameters=m.parameters(),
                                   weight_decay=0.1))
            losses[name] = [step(bt, bt).item() for bt in batches]
    finally:
        set_flags({"FLAGS_fused_ce": False})
    # fp32 on both sides: cuBLAS and the CPU sum in other orders and the
    # kernels' reductions differ from the plain versions' (~1e-6
    # relative), so the losses agree to 1e-4 relative.  Adam normalises
    # each update to ~lr, so a gradient entry near zero can flip the sign
    # of its update: every parameter within 2 lr per step, and all but
    # 0.1% of each tensor's entries within 1e-5
    loss_err = max(abs(a - c) / abs(c) for a, c in zip(losses["gpu"],
                                                       losses["cpu"]))
    check(all(np.isfinite(losses["gpu"])), f"non-finite losses {losses}")
    check(loss_err <= 1e-4, f"train losses disagree card vs CPU: {losses}")
    cpu_params = dict(cpu.named_parameters())
    worst_frac, worst_max = 0.0, 0.0
    with torch.no_grad():
        for n, p in gpu.named_parameters():
            diff = (p.cpu() - cpu_params[n]).abs()
            worst_frac = max(worst_frac, (diff > 1e-5).float().mean().item())
            worst_max = max(worst_max, diff.max().item())
    check(worst_frac <= 1e-3 and worst_max <= 2 * lr * len(batches),
          f"train parameters disagree card vs CPU: {worst_frac} of entries "
          f"beyond 1e-5, max {worst_max}")
    log(f"[train-parity] 2-layer hidden 2560 fp32, 3 AdamW steps"
        f"{', fused CE, layer 0 selective recompute' if fused else ''}: "
        f"losses card {losses['gpu']} cpu {losses['cpu']} (max rel err "
        f"{loss_err:.3g}, tol 1e-4); parameters: {worst_frac:.3g} of "
        f"entries beyond 1e-5 (tol 1e-3), max abs diff {worst_max:.3g} "
        f"(tol {2 * lr * len(batches):.3g})")
    del gpu, cpu
    torch.cuda.empty_cache()
    return losses


# ---------------------------------------------------------------------------
# phases 8 and 9: train the bench_llama configuration at full width/depth
# ---------------------------------------------------------------------------
def phase_train(torch, ops, dev, mode="bench", ref=None, steps=6):
    """mode "bench" (phase 8): bench_llama as bench.py runs it — 3
    selective-recompute layers, bf16 AdamW moments, the fused AdamW.
    "fused" (phase 9): the same with FLAGS_fused_ce and
    FLAGS_bf16_adamw_moments; `ref` is phase 8's result, whose first
    loss (same seed, weights and batch) the first loss must match.
    "unfused" (phase 8a, beside the main path): the configuration
    without recompute and with the pure AdamW rule (FLAGS_use_fused_adamw
    off), so that one call times both and splits the pure rule's share
    of the step."""
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    fused = mode == "fused"
    tag = {"bench": "train", "fused": "train-fused",
           "unfused": "train-unfused"}[mode]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    R = 0 if mode == "unfused" else TRAIN_RECOMPUTE
    cfg = train_config(recompute=R > 0, recompute_layers=R,
                       recompute_granularity="selective")
    model = LlamaForCausalLM(cfg, device=dev, seed=2025)
    n_params = sum(p.numel() for p in model.parameters())
    n_tensors = sum(1 for _ in model.parameters())
    b, s = TRAIN_BATCH, TRAIN_SEQ
    rng = np.random.RandomState(2025)
    batch = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, s))
                             .astype(np.int32)).to(dev)
    logit_max = None
    if mode == "bench":
        # the largest |logit| of the initial model: phase 9's first-loss
        # tolerance scales with it
        with torch.no_grad():
            logit_max = model(batch).float().abs().max().item()
    flags = {"FLAGS_fused_ce": fused, "FLAGS_bf16_adamw_moments": fused,
             "FLAGS_use_fused_adamw": mode != "unfused"}
    set_flags(flags)
    try:
        step = TrainStep(model, model.compute_loss,
                         AdamW(3e-4, parameters=model.parameters(),
                               weight_decay=0.1, moment_dtype="bfloat16"))
        ops.reset_launch_counts()
        fam = ops.kernel_module("fused_adamw")
        losses, walls = [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step(batch, batch)
            losses.append(loss.item())
            walls.append((time.perf_counter() - t0) * 1e3)
        counts = ops.launch_counts()
        variants = dict(fam.variant_launches)
        # a profiled step whose trace lost kernel events (fewer flash or
        # fused AdamW kernels than the step launches) is profiled again
        full = {"flash_attention": 3 * cfg.num_hidden_layers,
                "fused_adamw": 0 if mode == "unfused" else n_tensors}
        for tries in range(1, 4):
            trace = train_trace(torch, step, batch,
                                statistics.median(walls[1:]))
            if all(trace["events"][k] == n for k, n in full.items()):
                break
        trace["tries"] = tries
    finally:
        set_flags({"FLAGS_fused_ce": False,
                   "FLAGS_bf16_adamw_moments": False,
                   "FLAGS_use_fused_adamw": True})
    L = cfg.num_hidden_layers
    # forward: every layer once, plus the replays of the R selective
    # layers' regions (A: input norm + rope; B: fused add + norm); flash
    # attention sits outside the regions.  Backward: once per layer.
    fwd = {"rms_norm": L + 1 + R, "fused_add_rms_norm": L + R,
           "rope": L + R, "flash_attention": L}
    bwd = {"rms_norm": L + 1, "fused_add_rms_norm": L, "rope": L,
           "flash_attention": L}
    want = dict.fromkeys(counts, 0)
    for n in fwd:
        want[n], want[n + "_bwd"] = steps * fwd[n], steps * bwd[n]
    want["fused_adamw"] = 0 if mode == "unfused" else steps * n_tensors
    ce_chunks = -(-b * (s - 1) // 1024)
    if fused:
        want["cross_entropy"] = steps * ce_chunks
    check(counts == want, f"{tag} launch counts {counts} != predicted {want}")
    want_var = dict.fromkeys(variants, 0)
    if mode != "unfused":
        want_var["fp32_ef" if fused else "fp32"] = steps * n_tensors
    check(variants == want_var,
          f"{tag} fused_adamw variants {variants} != predicted {want_var}")
    check(all(np.isfinite(losses)), f"non-finite {tag} losses {losses}")
    check(losses[-1] < losses[0], f"{tag} loss did not fall: {losses}")
    step_ms = statistics.median(walls[1:])
    tok_s = b * s / (step_ms / 1e3)
    train = dict(
        layers=L, recompute_layers=R, params=n_params, tensors=n_tensors,
        batch=b, seq=s, steps=steps, fused_ce=fused, bf16_moments_ef=fused,
        losses=losses, step_ms=walls, step_ms_p50=step_ms,
        tokens_per_s=tok_s, mfu=6 * n_params * tok_s / BF16_FLOP_PER_S,
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
        launches=counts, adamw_variants=variants, logit_max=logit_max)
    if fused:
        # the first step's loss: logits in fp32 here against logits
        # rounded to bf16 in phase 8 (each <= 2^-9 of itself, and up to a
        # few more roundings in cuBLAS's reduced-precision split-K
        # reductions): a token's lse - picked moves by <= 2 x 2^-8
        # max|logit|, and so does the mean
        tol = 2.0 ** -7 * ref["logit_max"]
        diff = abs(losses[0] - ref["losses"][0])
        check(diff <= tol, f"phase 9's first loss {losses[0]} differs from "
              f"phase 8's {ref['losses'][0]} by {diff} > {tol}")
        train.update(first_loss_diff=diff, first_loss_tol=tol,
                     vs_phase8=dict(
                         step_ms=step_ms / ref["step_ms_p50"],
                         mfu=train["mfu"] - ref["mfu"],
                         peak_mem_gb=train["peak_mem_gb"]
                         - ref["peak_mem_gb"]))
    log(f"[{tag}] " + json.dumps(train))
    log(f"[{tag}-trace] " + json.dumps(trace))
    del step, model, batch
    torch.cuda.empty_cache()
    return train, counts


# ---------------------------------------------------------------------------
# phase 12: bench_llama through ShardedTrainStep (ZeRO-3) over NCCL
# ---------------------------------------------------------------------------
def phase_sharded(torch, ops, dev, ref, ref_counts, steps=6):
    """bench.py's call, `ShardedTrainStep(model, opt, build_mesh(devices=
    [dev]), sharding_stage=3, rematerialize=False)`, over a one-rank NCCL
    group: phase 8's configuration, seed, weights and batch, each step's
    loss held to phase 8's, its launches to phase 8's, its gathers and
    reduce-scatters to the structure's; then 2 layers, 2 steps with
    FLAGS_fused_ce and FLAGS_bf16_adamw_moments through the same one-rank
    stage 3, held against TrainStep on the same weights (each
    parameter's change within lr / 100 of TrainStep's), and a planted
    control whose sharded update never runs, which that check must
    catch.  Returns (phase 12's record, the launches of both sharded
    runs: the main path's)."""
    import gc
    from paddle_tpu_torch.distributed import build_mesh, init_parallel_env
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaForCausalLM, numpy_state_dict
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ShardedTrainStep, sharded_trainer
    env = init_parallel_env()
    check(env.world_size == 1 and torch.distributed.get_backend() == "nccl",
          f"phase 12 wants one NCCL rank, got {env.world_size} "
          f"{torch.distributed.get_backend()}")
    mesh = build_mesh(devices=[dev])
    fam = ops.kernel_module("fused_adamw")

    def sharded(model, lr):
        return ShardedTrainStep(
            model, AdamW(lr, parameters=model.parameters(), weight_decay=0.1,
                         moment_dtype="bfloat16"),
            mesh, sharding_stage=3, rematerialize=False)

    # 12: phase 8's run through stage 3.  Phases 3-11 can leave objects
    # in reference cycles; collected here, the collector's passes over
    # them stay out of the timed steps, which at stage 3 are partly
    # host-bound (tools/zero3_host.py)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    R = TRAIN_RECOMPUTE
    cfg = train_config(recompute=True, recompute_layers=R,
                       recompute_granularity="selective")
    model = LlamaForCausalLM(cfg, device=dev, seed=2025)
    n_params = sum(p.numel() for p in model.parameters())
    n_tensors = sum(1 for _ in model.parameters())
    L = cfg.num_hidden_layers
    b, s = TRAIN_BATCH, TRAIN_SEQ
    rng = np.random.RandomState(2025)
    batch = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, s))
                             .astype(np.int32)).to(dev)
    step = sharded(model, 3e-4)
    ops.reset_launch_counts()
    fam.variant_launches.update(dict.fromkeys(fam.variant_launches, 0))
    losses, walls = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(batch, batch).item())
        walls.append((time.perf_counter() - t0) * 1e3)
    counts = ops.launch_counts()
    variants = dict(fam.variant_launches)
    comm = dict(step.comm_counts)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    step_ms = statistics.median(walls[1:])
    trace = train_trace(torch, step, batch, step_ms)
    # the parameters ZeRO-3 shards: 7 matrices a layer, the embedding and
    # the lm head, moved a unit at a time (a layer's, the root's); each
    # layer's are gathered for its forward and again for its backward,
    # the root's once a step; the vectors' gradients are all-reduced
    matrices = 7 * L + 2
    want_comm = dict(all_gather=2 * L + 1, reduce_scatter=L + 1,
                     all_reduce=n_tensors - matrices)
    check(comm == want_comm, f"phase 12 collectives a step {comm} != "
          f"predicted {want_comm}")
    check(counts == ref_counts, f"phase 12 launch counts {counts} != phase "
          f"8's {ref_counts}")
    check(variants["fp32"] == steps * n_tensors
          and sum(variants.values()) == steps * n_tensors,
          f"phase 12 fused_adamw variants {variants}: want "
          f"{steps * n_tensors} fp32 launches, one a parameter shard a step")
    tol = 2.0 ** -7 * ref["logit_max"]
    diffs = [abs(a - r) for a, r in zip(losses, ref["losses"])]
    check(all(np.isfinite(losses)) and max(diffs) <= tol,
          f"phase 12 losses {losses} differ from phase 8's {ref['losses']} "
          f"by up to {max(diffs)} > {tol}")
    tok_s = b * s / (step_ms / 1e3)
    zero3 = dict(
        layers=L, recompute_layers=R, params=n_params, tensors=n_tensors,
        batch=b, seq=s, steps=steps, losses=losses, loss_diff_max=max(diffs),
        loss_tol=tol, step_ms=walls, step_ms_p50=step_ms, tokens_per_s=tok_s,
        mfu=6 * n_params * tok_s / BF16_FLOP_PER_S, peak_mem_gb=peak,
        collectives_per_step=comm, launches=counts, adamw_variants=variants,
        phase8=dict(step_ms_p50=ref["step_ms_p50"], mfu=ref["mfu"],
                    peak_mem_gb=ref["peak_mem_gb"]),
        vs_phase8=dict(step_ms=step_ms / ref["step_ms_p50"],
                       peak_mem_gb=peak - ref["peak_mem_gb"]))
    log("[train-zero3] " + json.dumps(zero3))
    log("[train-zero3-trace] " + json.dumps(trace))
    step.close()
    del step, model, batch
    torch.cuda.empty_cache()

    # 12b: 2 layers, fused CE + bf16 moments with ef, against TrainStep.
    # One rank runs the same ops on the same values as TrainStep (its
    # gathers and reduce-scatters are copies), so the losses may differ
    # by a few roundings at most and each parameter's change by far less
    # than one update (Adam moves an entry by ~lr a step): lr / 100.
    cfg2 = train_config(num_hidden_layers=2)
    lr = 3e-4
    rng = np.random.RandomState(12)
    batches = [torch.from_numpy(rng.randint(0, cfg2.vocab_size, (b, s))
                                .astype(np.int32)).to(dev) for _ in range(2)]

    def opt_of(model):
        return AdamW(lr, parameters=model.parameters(), weight_decay=0.1,
                     moment_dtype="bfloat16")

    def train2(make_step):
        """(losses, parameters after, launches, variants, collectives)
        of 2 steps from the seed-12 weights."""
        model = LlamaForCausalLM(cfg2, device=dev, seed=12)
        step = make_step(model)
        ops.reset_launch_counts()
        fam.variant_launches.update(dict.fromkeys(fam.variant_launches, 0))
        losses = [step(bt, bt).item() for bt in batches]
        out = (losses, numpy_state_dict(model), ops.launch_counts(),
               dict(fam.variant_launches),
               dict(getattr(step, "comm_counts", {})))
        if hasattr(step, "close"):
            step.close()
        del step, model
        torch.cuda.empty_cache()
        return out

    set_flags({"FLAGS_fused_ce": True, "FLAGS_bf16_adamw_moments": True})
    real_update = sharded_trainer.apply_shard_updates
    try:
        before = numpy_state_dict(LlamaForCausalLM(cfg2, device=dev,
                                                   seed=12))
        (fused_losses, got, fused_counts, fused_variants,
         fused_comm) = train2(lambda m: sharded(m, lr))
        plain_losses, want, *_ = train2(
            lambda m: TrainStep(m, m.compute_loss, opt_of(m)))
        # the planted control: the sharded update never runs
        sharded_trainer.apply_shard_updates = lambda *a, **k: None
        control_losses, control, *_ = train2(lambda m: sharded(m, lr))
    finally:
        sharded_trainer.apply_shard_updates = real_update
        set_flags({"FLAGS_fused_ce": False,
                   "FLAGS_bf16_adamw_moments": False})

    def change_diff(params):
        """The largest gap between a parameter's change over the 2 steps
        and TrainStep's change of it."""
        return max(float(np.abs((params[n] - before[n])
                                - (want[n] - before[n])).max())
                   for n in want)

    n2 = 2 + 7 * 2 + 5
    chunks = -(-b * (s - 1) // 1024)
    check(fused_counts["cross_entropy"] == 2 * chunks,
          f"phase 12b cross_entropy launches {fused_counts['cross_entropy']}"
          f" != {2 * chunks}")
    check(fused_variants["fp32_ef"] == 2 * n2
          and sum(fused_variants.values()) == 2 * n2,
          f"phase 12b fused_adamw variants {fused_variants}: want "
          f"{2 * n2} fp32_ef")
    check(fused_comm["all_gather"] > 0 and fused_comm["reduce_scatter"] > 0,
          f"phase 12b collectives {fused_comm}")
    loss_tol = 4 * 2.0 ** -23 * max(abs(x) for x in plain_losses)
    param_tol = lr / 100
    moved = max(float(np.abs(want[n] - before[n]).max()) for n in want)
    ldiff = max(abs(a - c) for a, c in zip(fused_losses, plain_losses))
    pdiff, control_pdiff = change_diff(got), change_diff(control)
    control_ldiff = max(abs(a - c)
                        for a, c in zip(control_losses, plain_losses))
    check(moved >= lr, f"phase 12b: TrainStep moved no parameter by lr "
          f"({moved})")
    check(ldiff <= loss_tol and pdiff <= param_tol,
          f"phase 12b sharded vs TrainStep: losses {fused_losses} vs "
          f"{plain_losses} (tol {loss_tol}), parameters' changes up to "
          f"{pdiff} apart (tol {param_tol})")
    check(control_pdiff > param_tol,
          f"phase 12b's planted control (no sharded update) passed the "
          f"parameter check: {control_pdiff} <= {param_tol}")
    log("[train-zero3-fused] " + json.dumps(dict(
        layers=2, steps=2, losses=fused_losses, train_step_losses=plain_losses,
        loss_diff_max=ldiff, loss_tol=loss_tol, change_diff_max=pdiff,
        change_tol=param_tol, train_step_change_max=moved,
        control_change_diff_max=control_pdiff,
        control_loss_diff_max=control_ldiff,
        collectives_per_step=fused_comm, launches=fused_counts,
        adamw_variants=fused_variants)))
    torch.distributed.destroy_process_group()
    total = {n: counts[n] + fused_counts[n] for n in counts}
    return zero3, total


def train_trace(torch, step, batch, wall_ms):
    """Where a train step's time goes: one more step under torch.profiler
    (after the counted steps), device time by kernel and by kind; the
    busy share is that device time over the median unprofiled step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(batch, batch)
        torch.cuda.synchronize()
    # the device ranges c10d annotates its collectives with
    # ("nccl:_all_gather_base") span the copies or kernels that do the
    # work: they are listed on their own and not added to the busy time
    rows, annotations = [], []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            (annotations if getattr(e, "is_user_annotation", False)
             else rows).append((e.key, e.self_device_time_total / 1e3,
                                e.count))
    rows.sort(key=lambda r: -r[1])
    # kernel events seen per kind: a trace that dropped events (the
    # counts fall short of the launch counters' structure) is not read
    by_kind, events = _by_kind(rows)
    busy = sum(r[1] for r in rows)
    return dict(wall_ms=wall_ms, device_ms=busy if rows else None,
                busy_share=busy / wall_ms if rows else None,
                by_kind_ms=by_kind, events=events,
                top=[(k[:60], round(ms, 3), n) for k, ms, n in rows[:20]],
                annotations=[(k[:60], round(ms, 3), n)
                             for k, ms, n in annotations])


# ---------------------------------------------------------------------------
# phase 13: the serving request plane — speculative decoding, SLO classes,
# shedding, fault recovery, streaming, and sampling in generate
# ---------------------------------------------------------------------------
SPEC_TOKENS, SPEC_DRAFT_LAYERS = 4, 8      # bench.py:1106-1107, L // 4


def _spec_want(counts, A, S, L, n, K):
    """Launches of a speculative serve: A admission steps, each the
    target's (2L+1 norms, L ropes, L paged attentions) and the draft's
    prefill over n layers (2n+1 norms, n ropes); S draft/verify steps,
    each K+1 draft steps of n layers and one verify pass of the target."""
    want = dict.fromkeys(counts, 0)
    want.update({"rms_norm": A * (2 * L + 1 + 2 * n + 1)
                 + S * (2 * L + 1 + (K + 1) * (2 * n + 1)),
                 "rope": A * (L + n) + S * (L + (K + 1) * n),
                 "paged_attention": (A + S) * L})
    return want


def _spec_serve(torch, ops, dev, model, prompts, new, tag, verify=None,
                **kw):
    """Serve `prompts` speculatively (kw: the draft) from zeroed launch
    counters; check completion and the launches the structure predicts.
    With a list `verify`, every verify pass appends what it saw (see
    _verify_spy).  Returns (the batcher, the outputs, the record, the
    launches)."""
    from paddle_tpu_torch.inference import ContinuousBatcher
    cfg = model.config
    torch.cuda.reset_peak_memory_stats(dev)
    bat = ContinuousBatcher(model, max_batch_size=8, max_len=1024,
                            prefill_chunk=32, chunk=16,
                            spec_tokens=SPEC_TOKENS, device=dev, **kw)
    if verify is not None:
        _verify_spy(torch, bat, verify)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rids = [bat.submit(p, new) for p in prompts]
    out = bat.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    pa_var = dict(ops.kernel_module("paged_attention").variant_launches)
    st = bat.stats()
    V, L = cfg.vocab_size, cfg.num_hidden_layers
    check(len(out) == len(prompts) and all(len(out[r]) == new for r in rids),
          f"{tag}: not every request completed with {new} tokens")
    check(all(((out[r] >= 0) & (out[r] < V)).all() for r in rids),
          f"{tag}: token ids outside the vocabulary")
    A = st["admit_chunks"] * bat.admit_steps
    S = st["decode_chunks"] * bat.chunk
    check(st["forward_steps"] == A + S, f"{tag}: forward steps")
    n = getattr(bat._draft, "num_layers", L)
    want = _spec_want(counts, A, S, L, n, SPEC_TOKENS)
    check(counts == want, f"{tag} launch counts {counts} != predicted {want}")
    check(pa_var == {"fp": (A + S) * L, "int8": 0},
          f"{tag} paged_attention variants {pa_var}")
    acc = st["spec_accepted_per_step"]
    rec = dict(requests=len(prompts), new_tokens_each=new,
               spec_tokens=SPEC_TOKENS, draft_layers=n,
               accept_rate=st["spec_accept_rate"],
               accepted_per_step_mean=acc["mean"],
               accepted_per_step_p50=acc["p50"],
               drafted=st["spec_drafted"], accepted=st["spec_accepted"],
               wall_s=wall, tok_per_s=st["tokens_produced"] / wall,
               decode_ms_per_step=st["decode_chunk_time_p50"] / bat.chunk
               * 1e3,
               decode_ms_per_token=st["decode_chunk_time_p50"] / bat.chunk
               * 1e3 / max(acc["mean"], 1e-9),
               admit_ms_per_step=st["admit_chunk_time_p50"]
               / bat.admit_steps * 1e3,
               admission_steps=A, spec_steps=S,
               prefix_sharing=bat.prefix_sharing,
               peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               target_kv_gb=st["kv_bytes"] / 1e9,
               draft_kv_gb=st["draft_kv_bytes"] / 1e9,
               verify_spy=verify is not None, launches=counts)
    log(f"[{tag}] " + json.dumps(rec))
    return bat, [out[r] for r in rids], rec, counts


def _verify_spy(torch, bat, verify):
    """Wrap the batcher's target pass so that each verify pass (width
    K+1; an admission step is prefill_chunk wide) appends, as device
    tensors: the drafts [B, K], the verify's targets (argmax of lanes
    0..K-1), its row maxima and its logit of each draft, the slots' pos
    and done before the step, and each slot's request id.  It adds device
    work to the steps and no host transfer."""
    target, K = bat._target, bat.spec_k

    def spy(x, pos):
        lg = target(x, pos)
        if x.shape[1] == K + 1:
            lgf = lg[:, :K].float()
            drafts = x[:, 1:]
            verify.append((
                drafts.clone(), lgf.argmax(-1), lgf.amax(-1),
                lgf.gather(2, drafts[..., None].long())[..., 0],
                pos.clone(), bat._done.clone(),
                [r.req_id if r is not None else None for r in bat._slots]))
        return lg

    bat._target = spy


def _verify_probes(verify, rids, prompts, outs, K):
    """From the spied verify passes: hold each live slot's emitted tokens
    to the verify's targets (lane i's target is output pos + i + 1 -
    len(prompt) of the slot's request, for every accepted lane and the
    first rejected one), and list each rejected draft as (output index,
    the draft, the verify's gap from its row maximum to the draft's
    logit).  Returns (probes per request, lanes checked, rejected drafts
    past the request's last output)."""
    index = {r: i for i, r in enumerate(rids)}
    probes = [[] for _ in rids]
    checked = past = 0
    for rec in verify:
        drafts, tgt, vmax, vd, pos, done = (t.cpu().numpy()
                                            for t in rec[:6])
        for b, rid in enumerate(rec[6]):
            if rid is None or done[b]:
                continue
            i = index[rid]
            acc = int(np.cumprod(drafts[b] == tgt[b]).sum())
            base = int(pos[b]) + 1 - len(prompts[i])
            for lane in range(min(acc + 1, K)):
                j = base + lane
                if j < len(outs[i]):
                    check(int(outs[i][j]) == int(tgt[b, lane]),
                          f"request {rid}: output {j} is "
                          f"{int(outs[i][j])}, the verify pass's target "
                          f"{int(tgt[b, lane])}")
                    checked += 1
            if acc < K:
                j = base + acc
                if j < len(outs[i]):
                    probes[i].append((j, int(drafts[b, acc]),
                                      float(vmax[b, acc] - vd[b, acc])))
                else:
                    past += 1
    return probes, checked, past


def _rescore(torch, model, prompts, outs, probes=None):
    """Hold every emitted token to one teacher-forced forward of the
    target over prompt + output: its logit must lie within the bf16
    rounding tolerance of its row's maximum (`_rounding_tolerance` of the
    lm head's product, its weights rounded, then its hidden states
    rounded, for the emitted token and the row's argmax).  The serve
    computed the same logits at other widths (verify 5, admission 32) on
    other kernels, so a near-tied argmax may flip; a token outside the
    tolerance is an error.  `probes`, a list a request of (output index,
    token, the verify's gap): each such token's gap from the same row's
    maximum, in the teacher-forced row and in the verify's, over the
    same tolerance (reported, not checked)."""
    W = model.lm_head.detach().float()
    bf16 = torch.bfloat16
    shares, n_top, n_tok = [], 0, 0
    tf_shares, v_shares = [], []
    probes = probes or [[] for _ in outs]
    with torch.inference_mode():
        for p, o, pr in zip(prompts, outs, probes):
            seq = torch.as_tensor(np.concatenate([p, o]), dtype=torch.int32,
                                  device=W.device)[None]
            h = model.llama(seq)[0, len(p) - 1: len(p) - 1 + len(o)]
            ref = model._lm_logits(h).float()
            hf = h.float()
            tol = _rounding_tolerance(torch, bf16, ref, lambda w, x: x @ w,
                                      W, hf)[0] \
                + _rounding_tolerance(torch, bf16, ref, lambda w, x: w @ x,
                                      hf, W)[0]
            tok = torch.as_tensor(o, dtype=torch.int64,
                                  device=W.device)[:, None]
            top = ref.argmax(-1, keepdim=True)
            gap = (ref.gather(1, top) - ref.gather(1, tok))[:, 0]
            allowed = (tol.gather(1, top) + tol.gather(1, tok))[:, 0]
            shares.append((gap / allowed).cpu())
            n_top += int((top == tok).sum())
            n_tok += len(o)
            for j, t, vgap in pr:
                a = float(tol[j, top[j, 0]] + tol[j, t])
                tf_shares.append(float(ref[j, top[j, 0]] - ref[j, t]) / a)
                v_shares.append(vgap / a)
    shares = torch.cat(shares)
    out = dict(tokens=n_tok, rescored_argmax=n_top,
               worst_share=float(shares.max()),
               over_tolerance=int((shares > 1).sum()))
    if tf_shares:
        out["rejected_drafts"] = dict(
            count=len(tf_shares),
            teacher_forced_shares=sorted(round(x, 4) for x in tf_shares),
            verify_shares=sorted(round(x, 4) for x in v_shares),
            teacher_forced_over_tolerance=sum(x > 1 for x in tf_shares),
            verify_over_tolerance=sum(x > 1 for x in v_shares))
    return out


def _queue_rule(slos, depth):
    """The shed set FLAGS_serve_queue_depth predicts for requests
    submitted in this order with no admission between them: past `depth`
    queued, the lowest class's newest arrival goes (the incoming one when
    nothing queued ranks below it)."""
    order = {"interactive": 0, "batch": 1, "best_effort": 2}
    queue, shed = [], set()
    for rid, slo in enumerate(slos):
        if len(queue) >= depth:
            victim = max(queue + [rid], key=lambda r: (order[slos[r]], r))
            shed.add(victim)
            if victim == rid:
                continue
            queue.remove(victim)
        queue.append(rid)
    return shed


def _robust_serve(torch, ops, dev, model):
    """13c: mixed SLO classes under FLAGS_serve_queue_depth=4, one
    poisoned slot (FLAGS_fault_injection "serve.decode:times=1") and a
    streaming callback on every request."""
    from paddle_tpu_torch.distributed import fault
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.inference import ContinuousBatcher
    cfg = model.config
    V, L = cfg.vocab_size, cfg.num_hidden_layers
    rng = np.random.RandomState(13)
    slos = ["batch", "best_effort", "interactive", "best_effort", "batch",
            "interactive", "best_effort", "batch", "interactive", "batch"]
    prompts = [rng.randint(1, V, n).astype(np.int32)
               for n in rng.randint(16, 96, len(slos))]
    new = 24
    events = {}

    def cb(rid, toks, done):
        events.setdefault(rid, []).append(([int(t) for t in toks], done))

    bat = ContinuousBatcher(model, max_batch_size=8, max_len=256,
                            prefill_chunk=32, chunk=16, device=dev)
    ops.reset_launch_counts()
    set_flags({"FLAGS_serve_queue_depth": 4})
    with fault.scope("serve.decode:times=1"):
        rids = [bat.submit(p, new, slo=s, on_token=cb)
                for p, s in zip(prompts, slos)]
        out = bat.run()
        fired = fault.fired_counts().get("serve.decode", 0)
    set_flags({"FLAGS_serve_queue_depth": 0})
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    st = bat.stats()
    reqs = bat.finished_requests
    want_shed = _queue_rule(slos, 4)
    shed = {r for r in rids if reqs[r].shed}
    check(shed == want_shed and all(reqs[r].shed_reason == "queue_full"
                                    for r in shed),
          f"13c shed {sorted(shed)} != the queue rule's {sorted(want_shed)}")
    check(sorted(out) == rids, "13c: an id missing from run()'s results")
    check(st["requests_submitted"] == st["requests_completed"]
          + st["requests_shed"], f"13c leaked a request: {st}")
    requeued = [r for r in rids if reqs[r].requeues]
    check(fired == 1 and st["requests_requeued"] == 1 and len(requeued) == 1
          and not reqs[requeued[0]].shed
          and len(out[requeued[0]]) == new,
          f"13c: fault fired {fired}, requeued {requeued}")
    for r in rids:
        bursts = events.get(r, [])
        check([t for b, _ in bursts for t in b] == [int(t) for t in out[r]]
              and [d for _, d in bursts].count(True) == 1,
              f"13c: request {r}'s streamed bursts differ from its output")
        if r not in shed:
            check(len(out[r]) == new and ((out[r] >= 0) & (out[r] < V)).all(),
                  f"13c: request {r} incomplete")
    want = dict.fromkeys(counts, 0)
    steps = st["forward_steps"]
    want.update({"rms_norm": steps * (2 * L + 1), "rope": steps * L,
                 "paged_attention": steps * L})
    check(counts == want, f"13c launch counts {counts} != predicted {want}")
    rec = dict(submitted=st["requests_submitted"],
               completed=st["requests_completed"], shed=sorted(shed),
               shed_by_class=st["shed_by_class"], requeued=requeued,
               decode_faults=fired, callback_bursts=sum(
                   len(b) for b in events.values()),
               forward_steps=steps)
    log("[spec-serve-robust] " + json.dumps(rec))
    return counts


def _replay_logits(torch, model, prompt, n, dev, forced=None):
    """generate's computation step by step (the same cache depth, shapes
    and kernels), feeding back greedy's argmax or, given `forced` [b, n],
    those tokens: (tokens [b, n], the logits of each step [n] x [b, V] in
    the compute dtype)."""
    ids = torch.as_tensor(prompt, dtype=torch.int32, device=dev)
    b, s = ids.shape
    cache = model.init_cache(b, s + n)

    def pick(step, row):
        if forced is not None:
            return forced[:, step].to(torch.int32)
        return torch.argmax(row.float(), dim=-1).to(torch.int32)

    with torch.inference_mode():
        lg, _ = model.forward_cached(ids, cache, 0)
        rows = [lg[:, -1]]
        toks = [pick(0, rows[-1])]
        for step in range(n - 1):
            lg, _ = model.forward_cached(toks[-1][:, None], cache, s + step)
            rows.append(lg[:, 0])
            toks.append(pick(step + 1, rows[-1]))
    return torch.stack(toks, dim=1), rows


def _sampling(torch, ops, dev, model):
    """13d: generate on the card — top_k=1 is greedy (a sampler keeps
    every logit tied at the top, as the reference's does, so each
    top_k=1 token must be a maximum of its own step's logits, replayed
    step by step on its own history), a seed repeats its draw, every id
    in the vocabulary."""
    from paddle_tpu_torch.inference import generate
    cfg = model.config
    V, L = cfg.vocab_size, cfg.num_hidden_layers
    prompt = np.random.RandomState(7).randint(1, V, (2, 16)).astype(np.int32)
    n = 16
    ops.reset_launch_counts()
    greedy = generate(model, prompt, n, device=dev)
    top1 = generate(model, prompt, n, temperature=1.0, top_k=1, seed=3,
                    device=dev)
    a = generate(model, prompt, n, temperature=0.8, top_p=0.9, seed=7,
                 device=dev)
    b = generate(model, prompt, n, temperature=0.8, top_p=0.9, seed=7,
                 device=dev)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    replay, _ = _replay_logits(torch, model, prompt, n, dev)
    check(torch.equal(replay, greedy),
          "13d: greedy generate differs from its step-by-step replay")
    _, rows = _replay_logits(torch, model, prompt, n, dev, forced=top1)
    ties = 0
    for j, lg in enumerate(rows):
        lg = lg.float()
        mx = lg.amax(-1)
        drawn = lg.gather(1, top1[:, j:j + 1].long())[:, 0]
        check(torch.equal(drawn, mx),
              f"13d: top_k=1's token at step {j} is not a maximum of its "
              f"logits: {drawn.tolist()} against {mx.tolist()}")
        ties += int(((lg == mx[:, None]).sum(-1) > 1).sum())
    check(torch.equal(a, b), "13d: one seed drew two different outputs")
    check(all(int(t.min()) >= 0 and int(t.max()) < V
              for t in (greedy, top1, a)),
          "13d: a token outside the vocabulary")
    want = dict.fromkeys(counts, 0)
    want.update({"rms_norm": 4 * n * (2 * L + 1), "rope": 4 * n * L})
    check(counts == want, f"13d launch counts {counts} != predicted {want}")
    rec = dict(greedy=greedy.tolist(), top_k1=top1.tolist(),
               top_k1_steps_at_a_tie=ties, sampled=a.tolist(),
               sampled_equal_greedy=bool(torch.equal(a, greedy)))
    log("[spec-generate] " + json.dumps(rec))
    return counts


def phase_spec(torch, ops, dev, serve5):
    """Phase 13 at Llama-2-7B width and depth (bf16, seed 2024, phase 5's
    geometry and requests): 13a speculative serve as bench.py runs it
    (4 draft tokens, an 8-layer early-exit draft), every token re-scored;
    13b self-speculation (the target as its own draft) on 4 requests;
    13c SLO classes, shedding, a decode fault and streaming; 13d
    sampling in generate.  Returns the launches of all four (the main
    path's) and paged_attention's variant launches."""
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_7b_config
    cfg = llama_7b_config()
    model = LlamaForCausalLM(cfg, device=dev, seed=2024)
    prompts, new = serve_requests(cfg.vocab_size)
    total = None

    def add(counts):
        nonlocal total
        total = counts if total is None else {
            k: total[k] + counts[k] for k in total}

    # 13a
    bat, outs, rec, counts = _spec_serve(
        torch, ops, dev, model, prompts, new, "spec-serve",
        draft_layers=SPEC_DRAFT_LAYERS)
    add(counts)
    del bat
    trace = decode_trace(torch, model, dev, 16, spec_tokens=SPEC_TOKENS,
                         draft_layers=SPEC_DRAFT_LAYERS)
    log("[spec-serve-trace] " + json.dumps(trace))
    t0 = time.perf_counter()
    rs = _rescore(torch, model, prompts, outs)
    rs["seconds"] = time.perf_counter() - t0
    log("[spec-serve-rescore] " + json.dumps(rs))
    check(rs["over_tolerance"] == 0,
          f"13a: {rs['over_tolerance']} tokens outside the rounding "
          f"tolerance of their row's maximum")
    log("[spec-serve-vs-phase5] " + json.dumps(dict(
        tok_per_s=(rec["tok_per_s"], serve5["tok_per_s"]),
        decode_ms_per_step=(rec["decode_ms_per_step"],
                            serve5["decode_ms_per_step"]),
        peak_mem_gb=(rec["peak_mem_gb"], serve5["peak_mem_gb"]))))
    # 13b: every emitted token held to its verify pass and re-scored;
    # each rejected draft's gap from its row's maximum logged
    verify = []
    bat, outs_b, rec_b, counts = _spec_serve(
        torch, ops, dev, model, prompts[:4], new, "spec-serve-self",
        verify=verify, draft_model=model)
    add(counts)
    rids_b = sorted(bat.finished_requests)
    del bat
    check(rec_b["accept_rate"] > 0.5 and rec_b["accepted_per_step_mean"] > 1,
          f"13b: self-speculation accept rate {rec_b['accept_rate']}, "
          f"accepted per step {rec_b['accepted_per_step_mean']}")
    t0 = time.perf_counter()
    probes, checked, past = _verify_probes(verify, rids_b, prompts[:4],
                                           outs_b, SPEC_TOKENS)
    del verify
    rs = _rescore(torch, model, prompts[:4], outs_b, probes)
    rs.update(verify_lanes_checked=checked,
              rejected_past_the_output=past,
              seconds=time.perf_counter() - t0)
    log("[spec-serve-self-rescore] " + json.dumps(rs))
    check(rs["over_tolerance"] == 0 and checked > 0,
          f"13b: {rs['over_tolerance']} tokens outside the rounding "
          f"tolerance of their row's maximum ({checked} held to their "
          f"verify pass)")
    torch.cuda.empty_cache()
    # 13c, 13d
    add(_robust_serve(torch, ops, dev, model))
    add(_sampling(torch, ops, dev, model))
    del model
    torch.cuda.empty_cache()
    variants = {"paged_attention": {"fp": total["paged_attention"],
                                    "int8": 0},
                "quant_matmul": {"int8": 0, "int4": 0}}
    return total, variants


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # 1. card
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    log(card)
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    info = _build.build_info
    log(f"[build] {time.perf_counter() - t0:.1f} s "
        f"({'compiled' if info['built'] else 'cached'}) {info['path']}")
    # per source file, and only the kernels that spill (with their
    # registers) or whose wgmma products ptxas serialized (ptxas -v
    # prints registers, stack and spills for every kernel instantiated)
    lines = info["log"].splitlines()
    log(f"[build] {sum('Compiling entry function' in x for x in lines)} "
        f"kernels compiled")
    for prev, line, nxt in zip([""] + lines, lines, lines[1:] + [""]):
        if line.startswith("==") or "Performance Loss" in line or (
                "spill" in line and " 0 bytes spill stores" not in line):
            log("[build] " + (prev.strip() + " | " if "spill" in line
                              else "") + line.strip()
                + (" | " + nxt.strip() if "spill" in line and "Used" in nxt
                   else ""))

    # 3-12, each phase's wall time logged
    walls = {}

    def timed(name, fn, *a, **k):
        t = time.perf_counter()
        out = fn(*a, **k)
        walls[name] = round(time.perf_counter() - t, 1)
        log(f"[time] {name} {walls[name]} s")
        return out

    kern = timed("3 kernels", phase_kernels, torch, ops, dev)
    timed("4 parity", phase_parity, torch, dev)
    serve5, counts, variants = timed("5 serve", phase_serve, torch, ops,
                                     dev)
    train_kern = timed("6 train kernels", phase_train_kernels, torch, ops,
                       dev)
    for name in ("rms_norm", "rope"):       # the forwards at train shapes
        kern[name] += train_kern.pop(name)
    kern.update(train_kern)
    timed("7 train parity", phase_train_parity, torch, dev)
    timed("7 train parity (fused CE, recompute)", phase_train_parity, torch,
          dev, fused=True)
    timed("8a train (no recompute, pure AdamW rule)", phase_train, torch,
          ops, dev, mode="unfused")
    train, train_counts = timed("8 train", phase_train, torch, ops, dev)
    _, fused_counts = timed("9 train (fused CE, bf16 moments + ef)",
                            phase_train, torch, ops, dev, mode="fused",
                            ref=train)
    _, int8_counts, int8_var = timed(
        "10 serve (int8 weights, int8 KV)", phase_serve, torch, ops, dev,
        weight_only="int8", kv_dtype="int8", tag="serve-int8")
    _, int4_counts, int4_var = timed(
        "11 serve (int4 g64 weights, bf16 KV)", phase_serve, torch, ops,
        dev, weight_only="int4", tag="serve-int4")
    _, zero3_counts = timed("12 train (ShardedTrainStep stage 3, NCCL)",
                            phase_sharded, torch, ops, dev, train,
                            train_counts)
    spec_counts, spec_var = timed(
        "13 serve (speculative, SLO classes, faults, streaming, sampling)",
        phase_spec, torch, ops, dev, serve5)
    # launches on the main path: the serves (5, 10, 11, 13) and the
    # trainings (8, 9, 12)
    counts = {n: counts[n] + train_counts[n] + fused_counts[n]
              + int8_counts[n] + int4_counts[n] + zero3_counts[n]
              + spec_counts[n] for n in counts}
    variants = {n: {v: variants[n][v] + int8_var[n][v] + int4_var[n][v]
                    + spec_var[n][v] for v in variants[n]}
                for n in variants}
    check(all(counts[n] > 0 for n in ops.KERNELS),
          f"a kernel never launched on the main path: {counts}")
    check(all(c > 0 for v in variants.values() for c in v.values()),
          f"a kernel variant never launched on the main path: {variants}")

    cu = "paddle_tpu_torch/csrc/"
    tpu = "paddle_tpu/ops/pallas/"
    sources = {
        "rms_norm": (cu + "rms_norm.cu", tpu + "rms_norm.py:130"),
        "rms_norm_bwd": (cu + "rms_norm.cu", tpu + "rms_norm.py:105"),
        "fused_add_rms_norm": (cu + "rms_norm.cu", tpu + "rms_norm.py:228"),
        "fused_add_rms_norm_bwd": (cu + "rms_norm.cu",
                                   tpu + "rms_norm.py:201"),
        "rope": (cu + "rope.cu", tpu + "rope.py:142"),
        "rope_bwd": (cu + "rope.cu", tpu + "rope.py:120"),
        "paged_attention": (cu + "paged_attention.cu",
                            tpu + "paged_attention.py:108"),
        "flash_attention": (cu + "flash_attention.cu",
                            tpu + "flash_attention.py:816"),
        "flash_attention_bwd": (cu + "flash_attention.cu",
                                tpu + "flash_attention.py:679"),
        "fused_adamw": (cu + "fused_adamw.cu", tpu + "fused_adamw.py:140"),
        "cross_entropy": (cu + "cross_entropy.cu",
                          tpu + "fused_cross_entropy.py:95"),
        "quant_matmul": (cu + "quant_matmul.cu", tpu + "quant_matmul.py:58")}
    line = []

    def entry(name, cases, launches, **extra):
        # serving kernels: the decode shape (C=1 / M=8, group 1) first;
        # fused_adamw: the fp32-parameter variant at [2560, 6912], the
        # training step's
        head = cases[0]
        return dict(
            name=name, route="cuda", source=sources[name][0],
            replaces=sources[name][1], launches=launches, **extra,
            max_abs_err=head["max_abs_err"], tol=head["tol"],
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"], shape=head["shape"],
            cases=cases)

    for name in ops.KERNELS:
        extra = {"variant_launches": variants[name]} if name in variants \
            else {}
        line.append(entry(name, kern[name], counts[name], **extra))
    # the int8 pool variant of paged_attention and the int4 body of
    # quant_matmul on their own lines: each its own launches and head case
    for name, variant in (("paged_attention", "int8"),
                          ("quant_matmul", "int4")):
        line.append(entry(name, [c for c in kern[name]
                                 if c["variant"] == variant],
                          variants[name][variant], variant=variant))
    log(f"[time] phases {walls}")
    log(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
