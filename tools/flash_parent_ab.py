#!/usr/bin/env python3
"""Hold this tree's unmasked flash kernels to an earlier tree's, bit for
bit and in time.

    python3 tools/flash_parent_ab.py OLD_CSRC

OLD_CSRC holds the earlier tree's `flash_attention.cu`, `hopper.cuh` and
`common.cuh` with the C entry points of commit d0025e8 (no key bias:
`ptt_flash_fwd(device, dtype, q, k, v, out, lse, B, sq, sk, h, hk, d,
scale, causal, stream)` and the matching `ptt_flash_bwd`), for example
unpacked with `git show d0025e8:paddle_tpu_torch/csrc/<file>` into a
directory under build/.  From the repo root, on one CUDA card: builds
this tree's library (`_build.library()`) and the old source alone into
OLD_CSRC/libold.so, then at each shape of `SHAPES` launches both trees'
forward and backward on the same inputs and checks out, lse, dq, dk and
dv for identical bits; the shapes marked timed also get each tree's
forward and backward time (`chip_smoke.time_ms`) in the order old, new,
new, old.  Prints the card's name and power limit, one JSON line a
shape and a last line `{"ok": ...}`; exits 1 if any output differs, 2
without a CUDA device.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

# (b, sq, sk, h, hk, d, causal, dtype, timed): the 64 / 128 bodies with
# the causal mask and without, GQA and MHA, ragged lengths, the three
# dtypes; timed: the training shape and BERT-base's
SHAPES = [(2, 1000, 1000, 8, 2, 128, True, "bfloat16", False),
          (3, 77, 77, 4, 1, 64, True, "float16", False),
          (2, 300, 1000, 16, 2, 128, False, "bfloat16", False),
          (2, 256, 256, 4, 2, 64, True, "float32", False),
          (2, 100, 300, 4, 2, 128, False, "float32", False),
          (4, 2048, 2048, 20, 4, 128, True, "bfloat16", True),
          (64, 512, 512, 12, 12, 64, False, "bfloat16", True)]


def main(old_dir):
    import torch
    if not torch.cuda.is_available():
        print("flash_parent_ab: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops import _build
    print(subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    old_so = os.path.join(old_dir, "libold.so")
    build = subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", old_dir, "-shared", "-o",
         old_so, os.path.join(old_dir, "flash_attention.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _build.library()
    log = build.communicate()[0]
    if build.returncode:
        print(log[-5000:], file=sys.stderr)
        return 1
    old = ctypes.CDLL(old_so)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    old.ptt_flash_fwd.argtypes = [I, I, P, P, P, P, P, I, I, I, I, I, I, F,
                                  I, P]
    old.ptt_flash_bwd.argtypes = [I, I, P, P, P, P, P, P, P, P, P, P, I, I,
                                  I, I, I, I, F, I, P]
    fa = ops.kernel_module("flash_attention")
    dev = torch.device("cuda", 0)
    stream = _build.stream_of(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(5)

    def old_fwd(q, k, v, causal, sc):
        b, sq, h, d = q.shape
        out = torch.empty_like(q)
        lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
        rc = old.ptt_flash_fwd(0, _build.dtype_code(q.dtype), q.data_ptr(),
                               k.data_ptr(), v.data_ptr(), out.data_ptr(),
                               lse.data_ptr(), b, sq, k.shape[1], h,
                               k.shape[2], d, sc, int(causal), stream)
        cs.check(rc == 0, f"old flash forward returned {rc}")
        return out, lse

    def old_bwd(q, k, v, out, lse, do, causal, sc):
        b, sq, h, d = q.shape
        delta = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        rc = old.ptt_flash_bwd(0, _build.dtype_code(q.dtype), q.data_ptr(),
                               k.data_ptr(), v.data_ptr(), out.data_ptr(),
                               do.data_ptr(), lse.data_ptr(),
                               delta.data_ptr(), dq.data_ptr(),
                               dk.data_ptr(), dv.data_ptr(), b, sq,
                               k.shape[1], h, k.shape[2], d, sc, int(causal),
                               stream)
        cs.check(rc == 0, f"old flash backward returned {rc}")
        return dq, dk, dv

    ok = True
    for b, sq, sk, h, hk, d, causal, dtype, timed in SHAPES:
        dt = getattr(torch, dtype)
        q, do = (torch.randn(b, sq, h, d, generator=g, device=dev).to(dt)
                 for _ in range(2))
        k, v = (torch.randn(b, sk, hk, d, generator=g, device=dev).to(dt)
                for _ in range(2))
        sc = d ** -0.5
        n_fwd = fa._launch_fwd(q, k, v, causal, sc)
        o_fwd = old_fwd(q, k, v, causal, sc)
        n_bwd = fa._launch_bwd(q, k, v, *n_fwd, do, causal, sc)
        o_bwd = old_bwd(q, k, v, *o_fwd, do, causal, sc)
        same = [torch.equal(x, y) for x, y in zip((*n_fwd, *n_bwd),
                                                  (*o_fwd, *o_bwd))]
        ok &= all(same)
        rec = dict(shape=[b, sq, sk, h, hk, d], causal=causal, dtype=dtype,
                   same=same)
        if timed:
            runs = dict(
                fwd=(lambda: old_fwd(q, k, v, causal, sc),
                     lambda: fa._launch_fwd(q, k, v, causal, sc)),
                bwd=(lambda: old_bwd(q, k, v, *o_fwd, do, causal, sc),
                     lambda: fa._launch_bwd(q, k, v, *n_fwd, do, causal, sc)))
            for name, (f_old, f_new) in runs.items():
                rec[name + "_ms_old_new_new_old"] = [
                    cs.time_ms(torch, f) for f in (f_old, f_new, f_new, f_old)]
        print(json.dumps(rec), flush=True)
    print(json.dumps({"ok": bool(ok)}))
    return 0 if ok else 1


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1]))
