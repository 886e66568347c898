#!/usr/bin/env python3
"""Where the time of chip_smoke.py's phase 12 goes, and how another
tree's stage 3 compares: bench_llama's configuration through
ShardedTrainStep over a one-rank NCCL group, timed after phase 8.

    python3 tools/zero3_host.py [TREE ...]

Runs phase 8 (`chip_smoke.phase_train`, the TrainStep baseline), then
stage-3 steps of this tree's trainer and of each TREE's in turns (this
tree, the TREEs, the TREEs again, this tree), then one stage-0 run of
this tree.  A TREE's `paddle_tpu_torch/parallel/sharded_trainer.py` is
loaded into this tree's package: its kernels, model and optimizer are
this tree's, so the runs differ only in the trainer.  Each run: 6 steps
(median of steps 2-6, each ending in a device sync), the collectives a
step, peak memory, one step under `torch.profiler` for the device time
by kind (`chip_smoke.train_trace`) and one more with the CPU activity
alone for the host time of the collectives (`record_param_comms`) and
of the copies.  One `[zero3-host]` JSON line a run.  Exits 2 without a
CUDA device.
"""
import gc
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
HOST_KEYS = ("record_param_comms", "aten::copy_", "aten::cat",
             "c10d::_allgather_base_", "c10d::_reduce_scatter_base_",
             "c10d::allreduce_")


def trainer_of(tree):
    """ShardedTrainStep of `tree` (None: this tree's)."""
    if tree is None:
        from paddle_tpu_torch.parallel import ShardedTrainStep
        return ShardedTrainStep
    name = "paddle_tpu_torch.parallel._tree%d" % abs(hash(tree))
    spec = importlib.util.spec_from_file_location(name, os.path.join(
        tree, "paddle_tpu_torch", "parallel", "sharded_trainer.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.ShardedTrainStep


def run(torch, cs, dev, mesh, tag, cls, stage=3, steps=6):
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = cs.train_config(recompute=True, recompute_layers=3,
                          recompute_granularity="selective")
    model = LlamaForCausalLM(cfg, device=dev, seed=2025)
    batch = torch.from_numpy(np.random.RandomState(2025).randint(
        0, cfg.vocab_size, (4, 2048)).astype(np.int32)).to(dev)
    step = cls(model, AdamW(3e-4, parameters=model.parameters(),
                            weight_decay=0.1, moment_dtype="bfloat16"),
               mesh, sharding_stage=stage)
    walls, losses = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(batch, batch).item())
        walls.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    p50 = statistics.median(walls[1:])
    trace = cs.train_trace(torch, step, batch, p50)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(batch, batch).item()
    host = {e.key: [e.self_cpu_time_total / 1e3, e.count]
            for e in prof.key_averages() if e.key in HOST_KEYS}
    print("[zero3-host] " + json.dumps(dict(
        tree=tag, stage=stage, step_ms=walls, step_ms_p50=p50,
        peak_mem_gb=peak, losses=losses, collectives=dict(step.comm_counts),
        host_ms=host, device_ms=trace["device_ms"],
        busy_share=trace["busy_share"], by_kind_ms=trace["by_kind_ms"],
        annotations=trace["annotations"])), flush=True)
    if hasattr(step, "close"):
        step.close()
    del step, model, batch
    gc.collect()          # a trainer of another tree may hold cycles
    torch.cuda.empty_cache()


def main():
    import torch
    if not torch.cuda.is_available():
        print("zero3_host: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.distributed import build_mesh, init_parallel_env
    from paddle_tpu_torch.ops import _build
    print(subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build.library()
    trees = [os.path.abspath(t) for t in sys.argv[1:]]
    classes = {t: trainer_of(t) for t in [None] + trees}
    init_parallel_env()
    mesh = build_mesh(devices=[dev])
    train, _ = cs.phase_train(torch, ops, dev)
    print("[zero3-host] " + json.dumps(dict(
        tree="phase 8 (TrainStep)", step_ms_p50=train["step_ms_p50"],
        peak_mem_gb=train["peak_mem_gb"])), flush=True)
    gc.collect()
    order = [None] + trees + trees + [None]
    for t in order:
        run(torch, cs, dev, mesh, t or "this tree", classes[t])
    run(torch, cs, dev, mesh, "this tree", classes[None], stage=0)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
