#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (`paddle_tpu_torch`).

Run from the repo root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

  1. card    print `nvidia-smi --query-gpu=name,power.limit` for card 0
  2. build   compile the hand-written kernels (csrc/*.cu, nvcc sm_90a)
  3. kernels each kernel against its plain PyTorch version on the card,
             at the serving path's shapes in bf16: max abs error against
             a stated tolerance, the kernel's, the plain version's and a
             library yardstick's time (CUDA events, median of 30 after
             warm-up), and the least time the work could take
  4. parity  a 2-layer Llama at full width (hidden 4096, 32 heads, vocab
             32000) in fp32: the card (kernels) against the CPU (plain
             versions) on the same weights — prefill logits, and the
             greedy tokens of a short serve
  5. serve   Llama-2-7B (`llama_7b_config`, 32 layers) in bf16 with
             seeded random weights through ContinuousBatcher (paged KV,
             8 slots, max_len 1024, prefill_chunk 32, chunk 16): 16
             requests of 64-512 prompt tokens, 8 of them sharing a
             256-token system prefix, 64 new tokens each.  Every kernel's
             launch count must equal what the model's structure predicts
             for the forward steps the batcher ran.  Then a short decode
             window under torch.profiler: device time per step by
             kernel, and the busy share of the step's wall time.

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
REPS = 30


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


def bound(nbytes, flops, flop_rate):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def phase_kernels(torch, ops, dev):
    from paddle_tpu_torch.ops import (plain_apply_rope, plain_paged_attention,
                                      plain_rms_norm, rope_cos_sin)
    g = torch.Generator(device=dev)
    g.manual_seed(1234)
    bf16 = torch.bfloat16

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.float32).to(dtype)

    B, H, heads, hd = 8, 4096, 32, 128
    results = {"rms_norm": [], "rope": [], "paged_attention": []}

    # -- rms_norm on [8*C, 4096] -------------------------------------------
    for C in (1, 32):
        x = randn(B * C, H)
        w = (1.0 + 0.1 * randn(H, dtype=torch.float32)).to(bf16)
        k = ops.rms_norm(x, w, 1e-5)
        p = plain_rms_norm(x, w, 1e-5)
        torch.cuda.synchronize()
        err = (k.float() - p.float()).abs().max().item()
        # the kernel casts once after * w (as the TPU kernel); the plain
        # version casts before * w (as the reference twin): one extra
        # bf16 rounding, i.e. at most ~1.5 ulp, within 2 ulps of the
        # largest output (2 * 2**-7 relative)
        tol = 2.0 ** -6 * p.float().abs().max().item()
        nbytes = 2 * x.numel() * 2 + H * 2
        b_ms, b_by = bound(nbytes, 4 * x.numel(), BF16_FLOP_PER_S)
        results["rms_norm"].append(dict(
            shape=[B * C, H], max_abs_err=err, tol=tol,
            ms=time_ms(torch, lambda: ops.rms_norm(x, w, 1e-5)),
            plain_ms=time_ms(torch, lambda: plain_rms_norm(x, w, 1e-5)),
            library_ms=time_ms(torch, lambda: torch.nn.functional.rms_norm(
                x, (H,), w, 1e-5)),
            library="torch.nn.functional.rms_norm",
            bound_ms=b_ms, bound_by=b_by))

    # -- rope on q/k [8, C, 32, 128], cos/sin [8, C, 128] --------------------
    pos = torch.tensor([0, 9, 100, 333, 517, 700, 990, 1023],
                       dtype=torch.int32, device=dev)
    for C in (1, 32):
        q, kk = randn(B, C, heads, hd), randn(B, C, heads, hd)
        positions = pos[:, None] + torch.arange(C, dtype=torch.int32,
                                                device=dev)[None]
        cos, sin = rope_cos_sin(C, hd, 10000.0, position_ids=positions)
        cos, sin = cos.contiguous(), sin.contiguous()
        kq, kk_ = ops.apply_rope(q, kk, cos, sin)
        pq, pk = plain_apply_rope(q, kk, cos, sin)
        torch.cuda.synchronize()
        err = max((kq.float() - pq.float()).abs().max().item(),
                  (kk_.float() - pk.float()).abs().max().item())
        # same fp32 products and sum, each rounded as in the plain
        # version, one final cast: expected bit-identical; tolerance
        # one bf16 ulp of the largest output
        tol = 2.0 ** -7 * max(pq.float().abs().max().item(),
                              pk.float().abs().max().item())
        nbytes = 2 * (q.numel() + kk.numel()) * 2 + 2 * cos.numel() * 4
        b_ms, b_by = bound(nbytes, 3 * (q.numel() + kk.numel()),
                           BF16_FLOP_PER_S)
        results["rope"].append(dict(
            shape=[B, C, heads, hd], max_abs_err=err, tol=tol,
            ms=time_ms(torch, lambda: ops.apply_rope(q, kk, cos, sin)),
            plain_ms=time_ms(torch, lambda: plain_apply_rope(q, kk, cos, sin)),
            library_ms=None, library=None, bound_ms=b_ms, bound_by=b_by))

    # -- paged_attention: pool [529, 16, 32, 32, 128], table [8, 66] ---------
    P, ps, L, n_kv, P_slot, layer = 529, 16, 32, 32, 66, 17
    kpool, vpool = randn(P, ps, L, n_kv, hd), randn(P, ps, L, n_kv, hd)
    perm = torch.randperm(P - 1, generator=g, device=dev)[: B * P_slot] + 1
    pt = perm.reshape(B, P_slot).to(torch.int32).contiguous()
    for C in (1, 32):
        for group in (1, 4):
            h = n_kv * group
            q = randn(B, C, h, hd)
            k = ops.paged_attention(q, kpool, vpool, pt, pos, layer)
            p = plain_paged_attention(q, kpool, vpool, pt, pos, layer)
            torch.cuda.synchronize()
            err = (k.float() - p.float()).abs().max().item()
            # the plain version rounds the softmax weights to bf16
            # before P.V (as the reference twin does); the kernel keeps
            # them fp32: |err| <= 2**-8 * max|v| from the weights, plus
            # half an ulp of the output from each final rounding
            pages = torch.clamp((pos + C - 1) // ps + 1, max=P_slot)
            vmax = vpool[:, :, layer].float().abs().max().item()
            tol = 2.0 ** -7 * vmax + 2.0 ** -7 * p.float().abs().max().item()
            kv_bytes = int(pages.sum().item()) * ps * n_kv * hd * 2 * 2
            nbytes = kv_bytes + 2 * q.numel() * 2 + pt.numel() * 4 + B * 4
            keys = (pos[:, None].long() + torch.arange(C, device=dev)[None]
                    + 1).clamp(max=P_slot * ps)
            flops = int(keys.sum().item()) * h * hd * 4
            b_ms, b_by = bound(nbytes, flops, BF16_FLOP_PER_S)
            # library yardstick: SDPA on the PRE-GATHERED dense view
            # (the gather itself is excluded from its time)
            S = P_slot * ps
            kg = kpool[:, :, layer][pt.long()].reshape(B, S, n_kv, hd)
            vg = vpool[:, :, layer][pt.long()].reshape(B, S, n_kv, hd)
            kg = kg.repeat_interleave(group, dim=2).transpose(1, 2)
            vg = vg.repeat_interleave(group, dim=2).transpose(1, 2)
            qt = q.transpose(1, 2)
            mask = (torch.arange(S, device=dev)[None, None, :]
                    <= (pos[:, None, None].long()
                        + torch.arange(C, device=dev)[None, :, None]))[:, None]
            sdpa = torch.nn.functional.scaled_dot_product_attention
            lib = sdpa(qt, kg, vg, attn_mask=mask)
            lib_err = (lib.transpose(1, 2).float() - p.float()).abs().max()
            results["paged_attention"].append(dict(
                shape=[B, C, h, hd], group=group, max_abs_err=err, tol=tol,
                library_err=lib_err.item(),
                ms=time_ms(torch, lambda: ops.paged_attention(
                    q, kpool, vpool, pt, pos, layer)),
                plain_ms=time_ms(torch, lambda: plain_paged_attention(
                    q, kpool, vpool, pt, pos, layer)),
                library_ms=time_ms(torch, lambda: sdpa(qt, kg, vg,
                                                       attn_mask=mask)),
                library="scaled_dot_product_attention on the pre-gathered "
                        "dense view (gather excluded)",
                bound_ms=b_ms, bound_by=b_by))
            del kg, vg, lib
    del kpool, vpool
    for name, cases in results.items():
        for c in cases:
            log(f"[kernels] {name} {c['shape']}"
                f"{' group ' + str(c['group']) if 'group' in c else ''}: "
                f"err {c['max_abs_err']:.3g} (tol {c['tol']:.3g}) "
                f"kernel {c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, "
                f"library {c['library_ms'] if c['library_ms'] is None else round(c['library_ms'], 4)} ms, "
                f"bound {c['bound_ms']:.5f} ms ({c['bound_by']})")
            check(c["max_abs_err"] <= c["tol"],
                  f"{name} {c['shape']} disagrees with its plain version: "
                  f"{c['max_abs_err']} > {c['tol']}")
    return results


# ---------------------------------------------------------------------------
# phase 4: full-width parity, card kernels vs CPU plain versions
# ---------------------------------------------------------------------------
def phase_parity(torch, dev):
    from paddle_tpu_torch.inference import ContinuousBatcher
    from paddle_tpu_torch.models import (LlamaForCausalLM, llama_7b_config,
                                         load_numpy_state_dict,
                                         numpy_state_dict)
    cfg = llama_7b_config(num_hidden_layers=2, dtype="float32")
    gpu = LlamaForCausalLM(cfg, device=dev, seed=7)
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=7)
    load_numpy_state_dict(cpu, numpy_state_dict(gpu))
    rng = np.random.RandomState(7)
    ids = rng.randint(1, cfg.vocab_size, (2, 48)).astype(np.int32)
    B, ps, P_slot = 2, 16, 4
    pt = np.arange(1, 1 + B * P_slot, dtype=np.int32).reshape(B, P_slot)
    pos = np.zeros((B,), np.int32)
    logits = {}
    with torch.inference_mode():
        for name, m, d in (("gpu", gpu, dev), ("cpu", cpu, "cpu")):
            cache = m.init_paged_cache(1 + B * P_slot, ps)
            lg, _ = m.forward_cached_paged(
                torch.from_numpy(ids).to(d), cache,
                torch.from_numpy(pt).to(d), torch.from_numpy(pos).to(d))
            logits[name] = lg.float().cpu()
    ref = logits["cpu"]
    err = (logits["gpu"] - ref).abs().max().item()
    # fp32 on both sides: cuBLAS and the CPU BLAS sum the 4096- and
    # 11008-long dot products in different orders, and the kernels'
    # reductions differ from the plain versions' — relative drift of
    # ~1e-5; 1e-3 of the logit scale leaves a wide margin
    tol = 1e-3 * max(1.0, ref.abs().max().item())
    check(torch.isfinite(logits["gpu"]).all().item(), "non-finite logits")
    check(err <= tol, f"prefill logits disagree card vs CPU: {err} > {tol}")
    toks = {}
    prompts = [ids[0], ids[1, :40]]
    for name, m, d in (("gpu", gpu, dev), ("cpu", cpu, "cpu")):
        bat = ContinuousBatcher(m, max_batch_size=2, max_len=128,
                                prefill_chunk=32, chunk=4, device=d)
        rids = [bat.submit(p, 8) for p in prompts]
        out = bat.run()
        toks[name] = [out[r].tolist() for r in rids]
    check(toks["gpu"] == toks["cpu"],
          f"greedy tokens disagree card vs CPU: {toks}")
    log(f"[parity] 2-layer full-width fp32: prefill logits max abs err "
        f"{err:.3g} (tol {tol:.3g}); greedy tokens equal: {toks['gpu']}")
    del gpu, cpu
    torch.cuda.empty_cache()
    return err, tol


# ---------------------------------------------------------------------------
# phase 5: serve Llama-2-7B at full width and depth
# ---------------------------------------------------------------------------
def phase_serve(torch, ops, dev):
    from paddle_tpu_torch.inference import ContinuousBatcher
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_7b_config
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = llama_7b_config()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, seed=2024)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    bat = ContinuousBatcher(model, max_batch_size=8, max_len=1024,
                            prefill_chunk=32, chunk=16, device=dev)
    rng = np.random.RandomState(2024)
    V = cfg.vocab_size
    system = rng.randint(1, V, 256).astype(np.int32)
    shared = [np.concatenate([system, rng.randint(1, V, L).astype(np.int32)])
              for L in np.linspace(32, 256, 8).astype(int)]   # 288..512
    plain = [rng.randint(1, V, L).astype(np.int32)
             for L in np.linspace(64, 512, 8).astype(int)]    # 64..512
    # the first wave holds one shared-prefix request, so the seven that
    # follow find its prefix pages complete and resident
    prompts = [shared[0]] + plain[:7] + shared[1:] + plain[7:]
    new = 64
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rids = [bat.submit(p, new) for p in prompts]
    out = bat.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    st = bat.stats()
    reqs = bat.finished_requests
    check(len(out) == 16 and all(len(out[r]) == new for r in rids),
          "not every request completed with 64 tokens")
    check(all(((out[r] >= 0) & (out[r] < V)).all() for r in rids),
          "token ids outside the vocabulary")
    check(st["prefix_hit_tokens"] > 0, "no prefix hits")
    steps, L = st["forward_steps"], cfg.num_hidden_layers
    want = {"rms_norm": steps * (2 * L + 1), "rope": steps * L,
            "paged_attention": steps * L}
    check(counts == want, f"launch counts {counts} != predicted {want}")
    ttft = sorted((reqs[r].t_first - reqs[r].t_submit) * 1e3 for r in rids)
    serve = dict(
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
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
        model_init_s=init_s, launches=counts)
    log("[serve] " + json.dumps(serve))
    trace = decode_trace(torch, model, dev, bat.chunk)
    log("[trace] " + json.dumps(trace))
    del bat, model
    torch.cuda.empty_cache()
    return serve, counts


def decode_trace(torch, model, dev, chunk):
    """Where a decode step's time goes: 8 slots in pure decode, two
    chunks timed without a profiler (wall), then two more under
    torch.profiler (device time per kernel name).  busy_share is the
    profiled device time over the unprofiled wall of as many steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.inference import ContinuousBatcher
    bat = ContinuousBatcher(model, max_batch_size=8, max_len=1024,
                            prefill_chunk=32, chunk=chunk, device=dev)
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
    # device-side rows only (kernels, copies): the CPU op rows would
    # count the same kernel time a second time
    rows = [(e.key, e.self_device_time_total / 1e3)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    steps = 2 * chunk
    return dict(steps=steps, wall_ms_per_step=wall_ms / steps,
                device_ms_per_step=busy_ms / steps if rows else None,
                busy_share=busy_ms / wall_ms if rows else None,
                top=[(k[:60], round(ms / steps, 4)) for k, ms in rows[:10]])


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
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log("[build] " + line.strip())

    # 3-5
    kern = phase_kernels(torch, ops, dev)
    phase_parity(torch, dev)
    serve, counts = phase_serve(torch, ops, dev)

    sources = {"rms_norm": ("paddle_tpu_torch/csrc/rms_norm.cu",
                            "paddle_tpu/ops/pallas/rms_norm.py:130"),
               "rope": ("paddle_tpu_torch/csrc/rope.cu",
                        "paddle_tpu/ops/pallas/rope.py:142"),
               "paged_attention": (
                   "paddle_tpu_torch/csrc/paged_attention.cu",
                   "paddle_tpu/ops/pallas/paged_attention.py:108")}
    line = []
    for name in ops.KERNELS:
        cases = kern[name]
        head = cases[0]        # the decode shape (C=1, group 1)
        line.append(dict(
            name=name, route="cuda", source=sources[name][0],
            replaces=sources[name][1], launches=counts[name],
            max_abs_err=head["max_abs_err"], tol=head["tol"],
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"], shape=head["shape"],
            cases=cases))
    log(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
