#!/usr/bin/env python3
"""The cross-entropy rows kernel of several trees of this repo, in turns,
on one card.

    python3 tools/ce_rows_ab.py TREE [TREE ...]

Each TREE is a checkout of this repository: `.` for this one, or another
commit unpacked with `git archive` into a directory that .gitignore lists
(only `chip_smoke.py` and `paddle_tpu_torch/` are needed).  In the order
given, each tree builds its own kernels in a fresh process and launches
its wrapper's kernel (`_launch` of ops/fused_cross_entropy.py) on the same
seeded inputs, chip_smoke.py's phase 6 shapes: fp32 logits ~ 2 N(0, 1),
every 26th label -1, bf16 dlog at the training chunk [1024, 8192], one
row, [1024, 8191] (V % 4 != 0), [1024, 32000] bf16 and fp32, [256,
50257] fp16, [64, 128256], [256, 151936], and logits one element past an
aligned address.  Each output is hashed and timed (CUDA events, median of
30), beside F.cross_entropy's forward + backward on the same inputs, the
bytes bound (the labelled rows' logits read once, dlog written once, at
3.35 TB/s), the host's time a call (five batches of 200 calls queued
behind a device-side sleep; the median and the least) and, where the
tree's chip_smoke.py has `_ce_plan`, the library's plan.  Give the trees
in turns (A B B A) so that a drift of the card's clocks falls on each
alike.

Prints the card's name and power limit, one JSON line per run, then per
case whether every tree's output is bit-identical to the first tree's
and the median of each tree's numbers (tools/quant_matmul_ab.py's
`main`).  Exits 2 without a CUDA device.
"""
from __future__ import annotations

import os
import sys

import quant_matmul_ab          # its main: trees in turns, medians

# run inside each tree: its own chip_smoke.py and paddle_tpu_torch
_RUN = """
import hashlib, json, sys, time, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from paddle_tpu_torch import ops
from paddle_tpu_torch.ops import _build
F = torch.nn.functional
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
_build.library()
fce = ops.kernel_module("fused_cross_entropy")
plan_of = getattr(cs, "_ce_plan", None)
g = torch.Generator(device=dev)
g.manual_seed(1111)


def digest(outs):
    h = hashlib.sha256()
    for t in outs:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def host_us(fn):
    runs = []
    for _ in range(5):
        torch.cuda._sleep(int(1e8))
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        runs.append((time.perf_counter() - t0) / 200 * 1e6)
        torch.cuda.synchronize()
    return sorted(runs)[2], min(runs)


res = {}
for C, V, dtype, offset in ((1024, 8192, "bfloat16", 0),
                            (1, 8192, "bfloat16", 0),
                            (1024, 8191, "bfloat16", 0),
                            (1024, 32000, "bfloat16", 0),
                            (1024, 32000, "float32", 0),
                            (256, 50257, "float16", 0),
                            (64, 128256, "bfloat16", 0),
                            (256, 151936, "bfloat16", 0),
                            (1024, 8192, "bfloat16", 1)):
    dt = getattr(torch, dtype)
    x = (torch.randn((C * V + offset,), generator=g, device=dev)
         * 2.0)[offset:].view(C, V)
    lbl = torch.randint(0, V, (C,), generator=g, device=dev,
                        dtype=torch.int32)
    lbl[::26] = -1
    if C == 1:
        lbl[0] = V - 1
    valid = int((lbl >= 0).sum())
    scale = 1.0 / (lbl >= 0).sum().clamp_min(1).float().reshape(1)
    fn = lambda: fce._launch(x, lbl, scale, dt)
    outs = fn()
    torch.cuda.synchronize()
    xr = x.clone().requires_grad_(True)
    lbl64 = lbl.long()

    def library():
        return torch.autograd.grad(
            F.cross_entropy(xr, lbl64, ignore_index=-1), xr)

    med, least = host_us(fn)
    key = f"[{C}, {V}] {dtype}" + (f" x+{offset}" if offset else "")
    res[key] = dict(
        sha=digest(outs), ms=cs.time_ms(torch, fn),
        library_ms=cs.time_ms(torch, library),
        bound_ms=(valid * V * 4 + C * V * outs[1].element_size() + 8 * C
                  + 4) / cs.HBM_BYTES_PER_S * 1e3,
        host_us=med, host_us_min=least,
        **({} if plan_of is None
           else {"plan": list(plan_of(torch, x, outs[1]))}))
    del x, xr, outs
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(res), flush=True)
"""


if __name__ == "__main__":
    sys.exit(quant_matmul_ab.main(
        [os.path.abspath(t) for t in sys.argv[1:]] or ["."], _RUN,
        "ce_rows_ab"))
