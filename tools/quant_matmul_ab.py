#!/usr/bin/env python3
"""quant_matmul of several trees of this repo, in turns, on one card.

    python3 tools/quant_matmul_ab.py TREE [TREE ...]

Each TREE is a checkout of this repository: `.` for this one, or another
commit unpacked with `git archive` into a directory that .gitignore lists
(only `chip_smoke.py` and `paddle_tpu_torch/` are needed).  In the order
given, each tree builds its own kernels in a fresh process and runs
`ops.quant_matmul` on the same seeded inputs: int8 and int4 (group 64)
bf16 weights, bf16 x, at M = 8 (decode) and M = 256 (an admission chunk)
and every [K, N] of Llama-2-7B's projections and lm head.  Each output
is hashed, and its time taken (CUDA events, median of 30), and the host's
time a call (five batches of 200 calls, each queued behind a device-side
sleep, so the host never waits for the card: what a host-bound decode
step pays a launch; the median and the least of the five).
Give the trees in turns (A B B A) so that a drift of the card's clocks
falls on each alike.

Prints the card's name and power limit, one JSON line per run, then per
case whether every tree's output is bit-identical to the first tree's
and the median of each tree's times.  Exits 2 without a CUDA device.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

# run inside each tree: its own chip_smoke.py and paddle_tpu_torch
_RUN = """
import hashlib, json, sys, time, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from paddle_tpu_torch import ops
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.quantization import quantize_weight
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
_build.library()
g = torch.Generator(device=dev)
g.manual_seed(606)
res = {}
for fmt in ("int8", "int4"):
    for K, N in cs.QM_SHAPES:
        w = torch.randn((K, N), generator=g, device=dev) / K ** 0.5
        qw, sc = quantize_weight(w.to(torch.bfloat16), fmt, 64)
        for M in (8, 256):
            x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
            args = (x, qw, sc, fmt, 64)
            out = ops.quant_matmul(*args)
            torch.cuda.synchronize()
            digest = hashlib.sha256(out.view(torch.int16).cpu().numpy()
                                    .tobytes()).hexdigest()[:16]
            host = []
            for _ in range(5):
                torch.cuda._sleep(int(1e8))
                t0 = time.perf_counter()
                for _ in range(200):
                    ops.quant_matmul(*args)
                host.append((time.perf_counter() - t0) / 200 * 1e6)
                torch.cuda.synchronize()
            res[f"{fmt} {M}x{K}x{N}"] = dict(sha=digest, ms=cs.time_ms(
                torch, lambda: ops.quant_matmul(*args)),
                host_us=sorted(host)[2], host_us_min=min(host))
print("RESULT " + json.dumps(res), flush=True)
"""


def _median(values):
    """The median of numbers; of anything else (a plan), the first."""
    if not values:                   # a tree that does not report it
        return None
    if all(isinstance(v, (int, float)) for v in values):
        return statistics.median(values)
    return values[0]


def main(trees, run=_RUN, name="quant_matmul_ab"):
    """Run `run` (a script that prints one `RESULT {case: {"sha": ...,
    metric: value}}` line) in each tree in turns; print each run, then per
    case whether every tree's sha is the first tree's and each metric's
    median by tree (a value that is not a number: the tree's first)."""
    import torch
    if not torch.cuda.is_available():
        print(f"{name}: no CUDA device is available", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    runs = []
    for tree in trees:
        proc = subprocess.run([sys.executable, "-c", run], cwd=tree,
                              capture_output=True, text=True, timeout=900)
        if proc.returncode:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        res = json.loads(next(line for line in proc.stdout.splitlines()
                              if line.startswith("RESULT "))[7:])
        print(json.dumps({"tree": tree, "cases": res}), flush=True)
        runs.append((tree, res))
    first = runs[0][1]
    for case in first:
        same = all(r[case]["sha"] == first[case]["sha"] for _, r in runs)
        med = {key: {t: _median([r[case][key] for tt, r in runs
                                 if tt == t and key in r[case]])
                     for t in dict.fromkeys(trees)}
               for key in first[case] if key != "sha"}
        print(json.dumps({"case": case, "bit_identical": same, **med}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main([os.path.abspath(t) for t in sys.argv[1:]] or ["."]))
