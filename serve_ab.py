#!/usr/bin/env python3
"""Serving, training or kernel speed of several trees of this repo, in
turns, on one card.

    python3 serve_ab.py [--weight-only int8|int4] [--kv-dtype int8]
                        TREE [TREE ...]
    python3 serve_ab.py --train [--fused-ce] TREE [TREE ...]
    python3 serve_ab.py --kernels TREE [TREE ...]

Each TREE is a checkout of this repository: `.` for this one, or another
commit unpacked with `git archive` into a directory that .gitignore lists
(only `chip_smoke.py` and `paddle_tpu_torch/` are needed).  In the order
given, each tree's own `chip_smoke.py` builds that tree's kernels and runs
its serve phase (phase 5: Llama-2-7B, bf16, 16 requests, then a profiled
pure-decode window; with --weight-only / --kv-dtype, phase 10's or 11's
quantized serve, which also profiles one admission chunk) twice in a
fresh process; the second run is kept, so first-call costs fall on the
first (which skips the profiled windows: its traces are never read, and
the kept run's unprofiled serve comes before its own).  Each run reports decode and admission ms a step, tokens/s, TTFT
p50, and from the traces the device ms a step, paged attention's,
quant_matmul's, RMSNorm's and RoPE's among them.  With --train it runs
the tree's training phase instead (phase 8: `bench.py::bench_llama`'s
configuration, 6 TrainStep steps from the same seeded weights and batch,
then one profiled step) once in a fresh process; with --fused-ce also
phase 9 after it (the same with FLAGS_fused_ce and bf16 AdamW moments,
phase 8 its reference) and reports phase 9's step, with the
`cross_entropy` kernels' device ms in its profiled step.  With --kernels it
runs the tree's phase 3 (each kernel against its plain version at the
serving shapes, from the same seed) once in a fresh process and reports
each case's kernel ms, keyed by kernel, case, shape, pool or format,
group, dtypes and x's offset; the medians cover the cases every tree
ran.  Give the trees in
turns (A B B A) so that a drift of the card's clocks falls on each
alike.

Prints the card's name and power limit, one JSON line per run, and last
the median and the range (least, most) of each tree's runs.  Exits 2 without a CUDA device.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

# run inside each tree: its own chip_smoke.py and paddle_tpu_torch
_RUN = """
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from paddle_tpu_torch import ops
from paddle_tpu_torch.ops import _build
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
_build.library()
traces = cs.decode_trace, cs.admit_trace
cs.decode_trace = cs.admit_trace = lambda *a, **k: {{}}
for i in range(2):
    if i:
        cs.decode_trace, cs.admit_trace = traces
    cs.phase_serve(torch, ops, dev, weight_only={wo!r}, kv_dtype={kv!r},
                   tag={tag!r})
"""

_RUN_TRAIN = """
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from paddle_tpu_torch import ops
from paddle_tpu_torch.ops import _build
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
_build.library()
train = cs.phase_train(torch, ops, dev)[0]
if {fused!r}:
    cs.phase_train(torch, ops, dev, mode="fused", ref=train)
"""

_RUN_KERNELS = """
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from paddle_tpu_torch import ops
from paddle_tpu_torch.ops import _build
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
_build.library()
ms = {}
for name, cases in cs.phase_kernels(torch, ops, dev).items():
    for c in cases:
        key = " ".join(str(x) for x in (
            name, c.get("case", ""), c["shape"], c.get("variant", ""),
            c.get("group", ""), " ".join(c.get("dtypes", ())),
            f"x+{c['x_offset']}" if c.get("x_offset") else "") if x != "")
        ms[key] = c["ms"]
print("[kernels-ab] " + json.dumps(ms), flush=True)
"""

# device ms a step of these kernel kinds, from the traces
TRACE_KINDS = ("paged_attention", "quant_matmul", "rms_norm", "rope")
METRICS = ("decode_ms_per_step", "admit_ms_per_step", "tok_per_s",
           "ttft_ms_p50", "trace_wall_ms_per_step",
           "trace_device_ms_per_step") + tuple(
               f"{k}_ms_per_step" for k in TRACE_KINDS)
# the quantized serves also trace one admission chunk
ADMIT_METRICS = ("admit_trace_wall_ms_per_step",
                 "admit_trace_device_ms_per_step") + tuple(
                     f"admit_{k}_ms_per_step" for k in TRACE_KINDS)
TRAIN_METRICS = ("step_ms_p50", "mfu", "busy_share", "rms_norm_ms",
                 "rope_ms")
FUSED_CE_METRICS = TRAIN_METRICS + ("cross_entropy_ms",)


def _last(lines, tag):
    rows = [ln[len(tag):] for ln in lines if ln.startswith(tag)]
    if not rows:
        raise RuntimeError(f"serve_ab: no {tag!r} line in the run's output")
    return json.loads(rows[-1])


def _output(tree, code):
    proc = subprocess.run([sys.executable, "-c", code], cwd=tree, text=True,
                          capture_output=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"serve_ab: {tree} failed (rc {proc.returncode})"
                           f":\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return proc.stdout.splitlines()


def run_train(tree, fused=False):
    lines = _output(tree, _RUN_TRAIN.format(fused=fused))
    tag = "train-fused" if fused else "train"
    train = _last(lines, f"[{tag}] ")
    trace = _last(lines, f"[{tag}-trace] ")
    rec = dict(tree=tree, step_ms_p50=train["step_ms_p50"],
               mfu=train["mfu"], losses=train["losses"],
               busy_share=trace["busy_share"],
               rms_norm_ms=trace["by_kind_ms"]["rms_norm"],
               rope_ms=trace["by_kind_ms"]["rope"],
               by_kind_ms=trace["by_kind_ms"])
    if fused:
        rec["cross_entropy_ms"] = trace["by_kind_ms"]["cross_entropy"]
    return rec


def run_kernels(tree):
    return dict(tree=tree, **_last(_output(tree, _RUN_KERNELS),
                                   "[kernels-ab] "))


def run(tree, weight_only=None, kv_dtype=None):
    tag = "serve" + (f"-{weight_only}" if weight_only else "")
    lines = _output(tree, _RUN.format(wo=weight_only, kv=kv_dtype, tag=tag))
    serve = _last(lines, f"[{tag}] ")
    trace = _last(lines, f"[{tag}-trace] ")
    rec = dict(tree=tree, decode_ms_per_step=serve["decode_ms_per_step"],
               admit_ms_per_step=serve["admit_ms_per_step"],
               tok_per_s=serve["tok_per_s"], ttft_ms_p50=serve["ttft_ms_p50"],
               trace_wall_ms_per_step=trace["wall_ms_per_step"],
               trace_device_ms_per_step=trace["device_ms_per_step"])
    rec.update({f"{k}_ms_per_step": trace["by_kind_ms_per_step"][k]
                for k in TRACE_KINDS})
    if weight_only:
        admit = _last(lines, f"[{tag}-admit-trace] ")
        rec.update(admit_trace_wall_ms_per_step=admit["wall_ms_per_step"],
                   admit_trace_device_ms_per_step=admit["device_ms_per_step"])
        rec.update({f"admit_{k}_ms_per_step": admit["by_kind_ms_per_step"][k]
                    for k in TRACE_KINDS})
    return rec


def main(argv):
    opts = {"--weight-only": None, "--kv-dtype": None}
    trees, mode, fused = [], "serve", False
    it = iter(argv)
    for a in it:
        if a in opts:
            opts[a] = next(it)
        elif a == "--fused-ce":
            fused = True
        elif a in ("--train", "--kernels"):
            mode = a[2:]
        else:
            trees.append(a)
    import torch
    if not torch.cuda.is_available():
        print("serve_ab: no CUDA device is available", file=sys.stderr)
        return 2
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in trees:
        if not os.path.isfile(os.path.join(tree, "chip_smoke.py")):
            raise SystemExit(f"serve_ab: {tree} holds no chip_smoke.py")
    print(subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip(), flush=True)
    runs = []
    for tree in trees:
        runs.append(run_train(tree, fused) if mode == "train" else
                    run_kernels(tree) if mode == "kernels" else
                    run(tree, opts["--weight-only"], opts["--kv-dtype"]))
        print(json.dumps(runs[-1]), flush=True)
    if mode == "kernels":       # the cases every tree ran
        metrics = [k for k in runs[0] if k != "tree"
                   and all(k in r for r in runs)]
    else:
        metrics = (FUSED_CE_METRICS if fused else TRAIN_METRICS) \
            if mode == "train" else METRICS + (
            ADMIT_METRICS if opts["--weight-only"] else ())
    by_tree = {t: {m: [r[m] for r in runs if r["tree"] == t]
                   for m in metrics} for t in dict.fromkeys(trees)}
    print(json.dumps({
        "medians": {t: {m: statistics.median(v) for m, v in ms.items()}
                    for t, ms in by_tree.items()},
        "ranges": {t: {m: [min(v), max(v)] for m, v in ms.items()}
                   for t, ms in by_tree.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
