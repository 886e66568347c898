#!/usr/bin/env python3
"""bench_llama's configuration through ShardedTrainStep on N cards, one
process a card over NCCL: the multi-card path that chip_smoke.py's
phase 12 runs on one rank.

    python3 tools/zero_ranks.py [--ranks 4] [--stages 0,1,2,3] [--steps 6]

First one rank on card 0 trains at stage 3 (the comparison), then N
ranks (cards 0..N-1, each started as torchrun would: RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT) train at each stage given on
`build_mesh(sharding=N)`, the global batch split by rows.  Every run is
phase 8's: 14 layers of width 2560, 3 under selective recompute, fp32
parameters and bf16 compute, AdamW with bf16 moments, batch 4 x 2048,
seed 2025.  Each run's losses (the global mean, equal on every rank)
must lie within 2^-7 max|logit| of the one-rank run's (phase 9's
tolerance: the ranks' matmuls see other row counts, so their bf16
roundings differ).  One JSON line a run: step ms (median of steps 2 to
the last, each ending in a device sync), tokens/s over the cards, MFU
over the cards' peak, the largest peak memory of a rank, collectives a
step; the last line sums up.  Exits 2 without N CUDA devices.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_FLOP_PER_S = 989e12           # H100 SXM dense bf16 tensor peak


def worker(stages, steps, out):
    """One rank: every stage in turn, its record to `out`."""
    import torch
    sys.path.insert(0, ROOT)
    from paddle_tpu_torch.distributed import build_mesh, init_parallel_env
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ShardedTrainStep
    torch.backends.cuda.matmul.allow_tf32 = False
    env = init_parallel_env()
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = LlamaConfig(vocab_size=8192, hidden_size=2560,
                      intermediate_size=6912, num_hidden_layers=14,
                      num_attention_heads=20, num_key_value_heads=4,
                      max_position_embeddings=2048, dtype="bfloat16",
                      param_dtype="float32", recompute=True,
                      recompute_layers=3, recompute_granularity="selective")
    rng = np.random.RandomState(2025)
    batch = torch.from_numpy(rng.randint(0, cfg.vocab_size, (4, 2048))
                             .astype(np.int32)).to(dev)
    runs = []
    for stage in stages:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        model = LlamaForCausalLM(cfg, device=dev, seed=2025)
        logit_max = None
        if env.world_size == 1:
            with torch.no_grad():
                logit_max = model(batch).float().abs().max().item()
        n_params = sum(p.numel() for p in model.parameters())
        step = ShardedTrainStep(
            model, AdamW(3e-4, parameters=model.parameters(),
                         weight_decay=0.1, moment_dtype="bfloat16"),
            build_mesh(sharding=env.world_size), sharding_stage=stage)
        losses, walls = [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(step(batch, batch).item())
            walls.append((time.perf_counter() - t0) * 1e3)
        runs.append(dict(stage=stage, losses=losses, step_ms=walls,
                         comm=dict(step.comm_counts), params=n_params,
                         logit_max=logit_max,
                         peak_mem_gb=torch.cuda.max_memory_allocated(dev)
                         / 1e9))
        step.close()
        del step, model
    with open(out, "w") as f:
        json.dump(runs, f)
    torch.distributed.destroy_process_group()


def launch(ranks, stages, steps, tmp):
    """Start `ranks` processes of this script; their records by rank."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(ranks):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(ranks),
                   LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
        log = open(os.path.join(tmp, f"w{ranks}r{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker",
             "--stages", ",".join(map(str, stages)), "--steps", str(steps),
             "--out", os.path.join(tmp, f"w{ranks}r{r}.json")],
            env=env, stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + 900
    for p, _ in procs:
        try:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            break
    for p, log in procs:                # none outlives the launch
        if p.poll() is None:
            p.kill()
            p.wait()
        log.close()
    failed = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
    if failed:
        for r in failed:
            with open(os.path.join(tmp, f"w{ranks}r{r}.log")) as f:
                sys.stderr.write(f"--- rank {r} of {ranks}\n"
                                 f"{f.read()[-4000:]}")
        raise SystemExit(f"zero_ranks: ranks {failed} of {ranks} failed")
    out = []
    for r in range(ranks):
        with open(os.path.join(tmp, f"w{ranks}r{r}.json")) as f:
            out.append(json.load(f))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--stages", default="0,1,2,3")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--out")
    a = ap.parse_args()
    stages = [int(s) for s in a.stages.split(",")]
    if a.worker:
        worker(stages, a.steps, a.out)
        return 0
    import torch
    if torch.cuda.device_count() < a.ranks:
        print(f"zero_ranks: {a.ranks} CUDA devices wanted, "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    tmp = tempfile.mkdtemp(prefix="zero_ranks_")
    t0 = time.perf_counter()
    one = launch(1, [3], a.steps, tmp)[0][0]
    many = launch(a.ranks, stages, a.steps, tmp)
    tol = 2.0 ** -7 * one["logit_max"]
    summary = []
    for i, stage in enumerate(stages):
        recs = [rank[i] for rank in many]
        losses = recs[0]["losses"]
        same = all(r["losses"] == losses for r in recs)
        diff = max(abs(x - y) for x, y in zip(losses, one["losses"]))
        ms = statistics.median(recs[0]["step_ms"][1:])
        tok_s = 4 * 2048 / (ms / 1e3)
        run = dict(ranks=a.ranks, stage=stage, losses=losses,
                   same_on_every_rank=same, loss_diff_max=diff,
                   loss_tol=tol, step_ms=recs[0]["step_ms"], step_ms_p50=ms,
                   tokens_per_s=tok_s,
                   mfu=6 * one["params"] * tok_s
                   / (a.ranks * BF16_FLOP_PER_S),
                   peak_mem_gb=max(r["peak_mem_gb"] for r in recs),
                   collectives_per_step=recs[0]["comm"])
        print("[zero-ranks] " + json.dumps(run), flush=True)
        summary.append(dict(stage=stage, step_ms_p50=ms,
                            peak_mem_gb=run["peak_mem_gb"],
                            ok=same and diff <= tol
                            and all(np.isfinite(losses))))
    ms1 = statistics.median(one["step_ms"][1:])
    print("[zero-ranks] " + json.dumps(dict(
        ranks=1, stage=3, losses=one["losses"], step_ms=one["step_ms"],
        step_ms_p50=ms1, tokens_per_s=4 * 2048 / (ms1 / 1e3),
        peak_mem_gb=one["peak_mem_gb"],
        collectives_per_step=one["comm"])), flush=True)
    ok = all(s["ok"] for s in summary)
    print(json.dumps(dict(ok=ok, card=card, one_rank_step_ms_p50=ms1,
                          runs=summary,
                          seconds=round(time.perf_counter() - t0, 1))),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
