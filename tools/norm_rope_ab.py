#!/usr/bin/env python3
"""The RMSNorm forward and RoPE kernels of several trees of this repo, in
turns, on one card.

    python3 tools/norm_rope_ab.py TREE [TREE ...]

Each TREE is a checkout of this repository: `.` for this one, or another
commit unpacked with `git archive` into a directory that .gitignore lists
(only `chip_smoke.py` and `paddle_tpu_torch/` are needed).  In the order
given, each tree builds its own kernels in a fresh process and launches
its wrappers' kernels (`_launch` of ops/rms_norm.py and ops/rope.py) on
the same seeded bf16 inputs: the RMSNorm forward at the decode [8,
4096], admission [256, 4096] and training [8192, 2560] shapes; RoPE at
the decode q/k [8, 1, 32 + 32, 128] and admission [8, 32, 32 + 32, 128]
shapes with per-slot tables, and forward and backward (sin's halves
swapped, neg_sin) at the training shape [4, 2048, 20 + 4, 128] with a
shared table.  Each output is hashed and timed (CUDA events, median of
30), beside torch.nn.functional.rms_norm's time on the same inputs, the
bytes bound (inputs read once, outputs written once, at 3.35 TB/s) and
the host's time a call (five batches of 200 calls queued behind a
device-side sleep; the median and the least).  Give the trees in turns
(A B B A) so that a drift of the card's clocks falls on each alike.

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
rn, ro = ops.kernel_module("rms_norm"), ops.kernel_module("rope")
g = torch.Generator(device=dev)
g.manual_seed(1010)
bf16 = torch.bfloat16


def randn(*shape):
    return torch.randn(shape, generator=g, device=dev).to(bf16)


def digest(outs):
    h = hashlib.sha256()
    for t in outs:
        h.update(t.view(torch.int16).cpu().numpy().tobytes())
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


def case(key, fn, nbytes, library=None):
    outs = fn()
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.cuda.synchronize()
    med, least = host_us(fn)
    res[key] = dict(sha=digest(outs), ms=cs.time_ms(torch, fn),
                    bound_ms=nbytes / cs.HBM_BYTES_PER_S * 1e3,
                    **({} if library is None
                       else {"library_ms": cs.time_ms(torch, library)}),
                    host_us=med, host_us_min=least)


for rows, H in ((8, 4096), (256, 4096), (8192, 2560)):
    x = randn(rows, H)
    w = (1.0 + 0.1 * torch.randn(H, generator=g, device=dev)).to(bf16)
    case(f"rms_norm [{rows}, {H}]", lambda: rn._launch(x, w, 1e-5),
         (2 * rows * H + H) * 2,
         lambda: F.rms_norm(x, (H,), w, 1e-5))
for b, s, h, hk, per_slot in ((8, 1, 32, 32, True), (8, 32, 32, 32, True),
                              (4, 2048, 20, 4, False)):
    d = 128
    q, k = randn(b, s, h, d), randn(b, s, hk, d)
    if per_slot:
        pos = torch.arange(b, device=dev)[:, None] * 97 + torch.arange(
            s, device=dev)[None]
        cos, sin = ops.rope_cos_sin(s, d, 10000.0, position_ids=pos)
    else:
        cos, sin = ops.rope_cos_sin(s, d, 10000.0, device=dev)
    cos, sin = cos.contiguous(), sin.contiguous()
    nbytes = 2 * (q.numel() + k.numel()) * 2 + 2 * cos.numel() * 4
    shape = f"[{b}, {s}, {h}+{hk}, {d}]"
    case(f"rope {shape}", lambda: ro._launch(q, k, cos, sin), nbytes)
    if not per_slot:
        sw = torch.cat([sin[:, d // 2:], sin[:, :d // 2]], -1).contiguous()
        case(f"rope_bwd {shape}",
             lambda: ro._launch(q, k, cos, sw, neg_sin=True), nbytes)
print("RESULT " + json.dumps(res), flush=True)
"""


if __name__ == "__main__":
    sys.exit(quant_matmul_ab.main(
        [os.path.abspath(t) for t in sys.argv[1:]] or ["."], _RUN,
        "norm_rope_ab"))
