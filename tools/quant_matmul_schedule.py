#!/usr/bin/env python3
"""Fit quant_matmul's wgmma schedule model to the card.

    python3 tools/quant_matmul_schedule.py

On one CUDA card: builds the kernels, then times the wgmma body of
`csrc/quant_matmul.cu` (CUDA events, median of 30) at every row tile
(128, 256) and cluster size (1-4) on Llama-2-7B's admission shapes: M =
256 rows of bf16 x against int8 and int4 (group 64) bf16 weights of
every [K, N] of its projections and lm head.  It fits the model of
`ops/quant_matmul.py::_schedule` by least squares,

    time = c + waves * (tiles per block * TILE[fmt, rows] + WAVE[rows][s])

(waves from the clusters the card holds at once, `ptt_quant_matmul_
clusters`), and prints the card's name and power limit, one JSON line
per shape with every time, the clusters of 1-4 blocks the card holds at
once, the fitted constants beside the ones in
`_TILE_US` / `_WAVE_US`, and per shape the pick of the fitted model and
of the module's model against the fastest measured.  Exits 2 without a
CUDA device.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000))
M = 256


def _call(lib, x, qw, sc, fmt, out, rows, splits):
    from paddle_tpu_torch.ops import _build
    K, N = x.shape[1], qw.shape[1]
    rc = lib.ptt_quant_matmul(
        0, _build.dtype_code(x.dtype), _build.dtype_code(sc.dtype),
        int(fmt == "int4"), 64 if fmt == "int4" else 0, x.data_ptr(),
        qw.data_ptr(), sc.data_ptr(), out.data_ptr(), None, x.shape[0], K,
        N, splits, rows, _build.stream_of(x.device))
    _build.check(rc, "quant_matmul")


def main():
    import torch
    if not torch.cuda.is_available():
        print("quant_matmul_schedule: no CUDA device is available",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops import (_build, dequant_weight,
                                      plain_quant_matmul)
    from paddle_tpu_torch.quantization import quantize_weight
    qm = ops.kernel_module("quant_matmul")
    print(subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    lib = _build.library()
    g = torch.Generator(device=dev)
    g.manual_seed(77)
    cap = {(i4, r): qm._cluster_capacity(0, i4, r)
           for i4 in (False, True) for r in (128, 256)}
    print(json.dumps({"clusters_at_once": {f"int4={i4} rows={r}": c
                                           for (i4, r), c in cap.items()}}),
          flush=True)
    names = ["c"] + [f"TILE[{i4},{r}]" for i4 in (False, True)
                     for r in (128, 256)] + [
        f"WAVE[{r}][{s}]" for r in (128, 256) for s in (1, 2, 3, 4)]
    A, b, meta = [], [], []
    for fmt in ("int8", "int4"):
        i4 = fmt == "int4"
        for K, N in SHAPES:
            w = torch.randn((K, N), generator=g, device=dev) / K ** 0.5
            qw, sc = quantize_weight(w.to(torch.bfloat16), fmt, 64)
            x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
            ref = plain_quant_matmul(x, qw, sc, fmt, 64)
            tol = cs._quant_matmul_tolerance(
                torch, x, dequant_weight(qw, sc, fmt, 64).to(x.dtype), ref)
            out = torch.empty_like(ref)
            n_k = -(-(K // 2 if i4 else K) // 64)
            times = {}
            for rows in (128, 256):
                for s in range(1, 5):
                    _call(lib, x, qw, sc, fmt, out, rows, s)
                    torch.cuda.synchronize()
                    cs.check(bool(((out.float() - ref.float()).abs()
                                   <= tol).all()),
                             f"{fmt} [{K}, {N}] rows {rows} splits {s} "
                             f"disagrees with the plain version")
                    ms = cs.time_ms(torch, lambda: _call(
                        lib, x, qw, sc, fmt, out, rows, s))
                    times[f"{rows}/{s}"] = ms
                    tiles = -(-N // 128) * -(-M // rows)
                    waves = -(-tiles // cap[i4, rows][s])
                    row = np.zeros(len(names))
                    row[0] = 1.0
                    row[names.index(f"TILE[{i4},{rows}]")] = \
                        waves * -(-n_k // s)
                    row[names.index(f"WAVE[{rows}][{s}]")] = waves
                    A.append(row)
                    b.append(ms * 1e3)
                    meta.append((fmt, K, N, rows, s))
            print(json.dumps({"fmt": fmt, "shape": [M, K, N],
                              "ms": times}), flush=True)
    A, b = np.array(A), np.array(b)
    fit, *_ = np.linalg.lstsq(A, b, rcond=None)
    print(json.dumps({"fitted_us": {n: round(float(v), 3)
                                    for n, v in zip(names, fit)},
                      "module_us": {"TILE": {str(k): v for k, v in
                                             qm._TILE_US.items()},
                                    "WAVE": qm._WAVE_US}}), flush=True)
    pred = A @ fit
    for fmt in ("int8", "int4"):
        for K, N in SHAPES:
            idx = [i for i, m in enumerate(meta) if m[:3] == (fmt, K, N)]
            best = min(idx, key=lambda i: b[i])
            fitted = min(idx, key=lambda i: pred[i])
            pick = qm._schedule(M, K, N, fmt == "int4",
                                lambda r, i4=fmt == "int4": cap[i4, r])
            picked = next(i for i in idx if meta[i][3:] == pick)
            print(json.dumps({
                "fmt": fmt, "shape": [M, K, N],
                "fastest": [*meta[best][3:], b[best] / 1e3],
                "fitted_pick": [*meta[fitted][3:], b[fitted] / 1e3],
                "module_pick": [*pick, b[picked] / 1e3]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
