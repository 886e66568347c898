#!/usr/bin/env python3
"""Hold this tree's flash kernels to an earlier tree's: the 16-bit bodies
bit for bit, the fp32 bodies to the plain versions, and both in time.

    python3 tools/flash_parent_ab.py OLD_CSRC [--changed CASE ...]

OLD_CSRC holds the earlier tree's flash sources (`flash_attention*.cu`,
`flash_attention*.cuh`, `hopper.cuh` and `common.cuh`) with this tree's C
entry points (`ptt_flash_fwd` / `ptt_flash_bwd` as `_build._SIGNATURES` has
them, key bias included: commit 4a6fc6d on), or those without the key
bias's live range (before it: found in the old flash_attention.cu and
dropped from the calls), for example unpacked with
`git archive ad85551 paddle_tpu_torch/csrc | tar -x --strip-components=2
-C build/old`.  From the repo root, on one CUDA card: builds this tree's
library (`_build.library()`) and the old flash sources alone (one nvcc a
source, in parallel) into OLD_CSRC/libold.so, then launches both trees'
forward and backward on the same inputs:

  * 16-bit shapes (`SHAPES`, `NARROW_SHAPES`, and every bf16 / fp16 case
    of `chip_smoke.FLASH_WIDE_CASES`): out, lse, dq, dk and dv must have
    identical bits (or, where `--changed` names the case, stay within
    `chip_smoke._flash_tolerances`, each output's share of it printed);
    the shapes marked timed (the FIT bodies) and the 17a cases also get
    each tree's forward and backward time (`chip_smoke.time_ms`), old,
    new, new, old, the 17a cases (and `_walk_shapes`: the MASK bodies
    at more batch sizes and widths) beside SDPA's and the bound at the
    bf16 rate (bytes by the K / V rows of live keys, `chip_smoke.
    _flash_kv_rows`), with this tree's body (`kernel_plan`);
  * fp32 shapes (`F32_SHAPES`, and the fp32 cases of `FLASH_WIDE_CASES`):
    each tree's outputs against the plain versions, as a share of
    `chip_smoke._flash_tolerances` (and of 1e-5 (1 + |lse|) for lse);
    this tree's must stay within them.  The 17a cases are timed old, new,
    new, old, beside SDPA's forward and backward and the bound at the
    three-pass TF32 rate (`chip_smoke.TF32X3_FLOP_PER_S`);
  * ViT-B/16's fp32 training (phase 17e: `vit_b_16(num_classes=10)`,
    batch 32 of 224x224, AdamW in `TrainStep`): after a warm-up step,
    the wall of two steps with the old flash kernels and with the new
    (the rest of the library this tree's), old, new, new, old.
  * phase 17d's masked BERT-base step (64 x 512, one sequence fully
    padded): the flash kernels' device ms in one profiled step with the
    old kernels and with the new, old, new, new, old.

Prints the card's name and power limit, one JSON line a shape and a last
line `{"ok": ...}`; exits 1 if a 16-bit output differs or an fp32 one
leaves its tolerance, 2 without a CUDA device.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np

# (b, sq, sk, h, hk, d, causal, dtype, timed): the 64 / 128 bodies with
# the causal mask and without, GQA and MHA, ragged lengths; timed: the
# training shape and BERT-base's
SHAPES = [(2, 1000, 1000, 8, 2, 128, True, "bfloat16", False),
          (3, 77, 77, 4, 1, 64, True, "float16", False),
          (2, 300, 1000, 16, 2, 128, False, "bfloat16", False),
          (4, 2048, 2048, 20, 4, 128, True, "bfloat16", True),
          (64, 512, 512, 12, 12, 64, False, "bfloat16", True)]
# the narrow bodies (d off a multiple of 64: products at d rounded up to
# 16) at their edges: d below the width (8, 72, 152, 40), ragged and
# one-row lengths, causal sq < sk and sq > sk, every kind of key-padding
# mask, GQA, fp16
NARROW_SHAPES = [
    dict(case="d8 ragged", b=2, sq=100, sk=77, h=4, hk=2, d=8, causal=False),
    dict(case="d72 causal gqa", b=2, sq=300, sk=300, h=4, hk=2, d=72),
    dict(case="d80 causal sq < sk, additive", b=3, sq=130, sk=200, h=4,
         hk=4, d=80, mask="additive", lengths=[200, 0, 77]),
    dict(case="d152 bool, fp16", b=2, sq=100, sk=300, h=4, hk=1, d=152,
         causal=False, dtype="float16", mask="bool", lengths=[300, 150]),
    dict(case="d160 causal sq > sk", b=2, sq=300, sk=77, h=8, hk=2, d=160),
    dict(case="d40 causal sq < sk", b=2, sq=77, sk=1000, h=4, hk=4, d=40),
    dict(case="d48 -1e9 padding, fp16", b=3, sq=64, sk=64, h=2, hk=1, d=48,
         causal=False, dtype="float16", mask="additive_1e9",
         lengths=[64, 0, 5]),
    dict(case="d16 one row", b=1, sq=1, sk=5, h=2, hk=2, d=16, causal=False),
]
# fp32 beyond 17a's: causal GQA, ragged lengths, the head dims of every
# body width (8, 136 and 200 split dK / dV's columns), a key padding
F32_SHAPES = [
    dict(case="causal gqa", b=2, sq=256, sk=256, h=4, hk=2, d=64),
    dict(case="sq < sk", b=2, sq=100, sk=300, h=4, hk=2, d=128,
         causal=False),
    dict(case="d8", b=2, sq=100, sk=100, h=4, hk=2, d=8, causal=False),
    dict(case="d136 additive", b=3, sq=130, sk=200, h=4, hk=4, d=136,
         causal=False, mask="additive", lengths=[200, 0, 77]),
    dict(case="d200 bool causal sq < sk", b=2, sq=100, sk=300, h=4, hk=1,
         d=200, mask="bool", lengths=[300, 150]),
    dict(case="d256 causal", b=2, sq=300, sk=300, h=4, hk=4, d=256),
]


class _Mixed:
    """The kernel library with its flash entry points taken from `old`."""

    def __init__(self, old, new):
        self.old, self.new = old, new

    def __getattr__(self, name):
        return getattr(self.old if name.startswith("ptt_flash")
                       else self.new, name)


# where the key bias's live range sits among the entry points' arguments
# (after the bias pointer)
RANGE_ARG = 6


class _NoRange:
    """An earlier library whose flash entry points take no live range:
    each call's range pointer is dropped."""

    def __init__(self, lib):
        self.lib = lib

    def __getattr__(self, name):
        fn = getattr(self.lib, name)
        if name not in ("ptt_flash_fwd", "ptt_flash_bwd"):
            return fn
        return lambda *a: fn(*a[:RANGE_ARG], *a[RANGE_ARG + 1:])


def main(old_dir, changed=()):
    import torch
    if not torch.cuda.is_available():
        print("flash_parent_ab: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    old_so = os.path.join(old_dir, "libold.so")
    srcs = sorted(f for f in os.listdir(old_dir)
                  if f.startswith("flash_attention") and f.endswith(".cu"))
    builds = [subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", old_dir, "-c", "-o",
         os.path.join(old_dir, f + ".o"), os.path.join(old_dir, f)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for f in srcs]
    t0 = time.perf_counter()
    new = _build.library()
    # the flash kernels whose registers spilled (ptxas -v), if any
    lines = _build.build_info["log"].splitlines()
    spills = [prev.strip().split()[-1] + ": " + x.strip()
              for prev, x in zip([""] + lines, lines)
              if "spill" in x and " 0 bytes spill stores" not in x
              and "flash" in prev]
    print(json.dumps(dict(new_build_s=_build.build_info["seconds"],
                          built=_build.build_info["built"], spills=spills)),
          flush=True)
    for proc in builds:
        log = proc.communicate()[0]
        if proc.returncode:
            print(log[-5000:], file=sys.stderr)
            return 1
    link = subprocess.run(
        [_build._nvcc(), "-shared", "-o", old_so,
         *[os.path.join(old_dir, f + ".o") for f in srcs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode:
        print(link.stdout[-5000:], file=sys.stderr)
        return 1
    print(json.dumps(dict(old_sources=srcs, both_built_s=time.perf_counter()
                          - t0)), flush=True)
    old = ctypes.CDLL(old_so)
    with open(os.path.join(old_dir, "flash_attention.cu")) as f:
        ranged = "const void* range" in f.read()
    for name in ("ptt_flash_fwd", "ptt_flash_bwd"):
        sig = list(_build._SIGNATURES[name])
        getattr(old, name).argtypes = sig if ranged else \
            sig[:RANGE_ARG] + sig[RANGE_ARG + 1:]
        getattr(old, name).restype = ctypes.c_int
    mixed = _Mixed(old if ranged else _NoRange(old), new)
    fa = ops.kernel_module("flash_attention")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(5)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.float32).to(dtype)

    def on(lib, fn):
        """fn() with `lib` as the kernel library."""
        def call():
            saved = _build.library
            _build.library = lambda: lib
            try:
                return fn()
            finally:
                _build.library = saved
        return call

    ok = True

    def run_16bit(case, b, sq, sk, h, hk, d, causal=True, dtype="bfloat16",
                  mask=None, lengths=None, timed=False, wide=False):
        nonlocal ok
        dt = getattr(torch, dtype)
        q, do = randn(b, sq, h, d, dtype=dt), randn(b, sq, h, d, dtype=dt)
        k, v = randn(b, sk, hk, d, dtype=dt), randn(b, sk, hk, d, dtype=dt)
        m = None if mask is None else cs._flash_mask(torch, randn, mask,
                                                     lengths, sk, dev)
        sc = d ** -0.5
        # the call's key bias and live range, built once outside the timed
        # launches (an old tree without the range drops it: `_NoRange`)
        keys = fa._key_bias(m, q, k, causal)
        f = {t: on(lib, lambda: fa._launch_fwd(q, k, v, causal, sc, keys))
             for t, lib in (("old", mixed), ("new", new))}
        outs = {t: f[t]() for t in f}
        bw = {t: on(lib, lambda t=t: fa._launch_bwd(q, k, v, *outs[t], do,
                                                    causal, sc, keys))
              for t, lib in (("old", mixed), ("new", new))}
        grads = {t: bw[t]() for t in bw}
        same = [torch.equal(x, y) for x, y in zip(
            (*outs["new"], *grads["new"]), (*outs["old"], *grads["old"]))]
        rec = dict(case=case, shape=[b, sq, sk, h, hk, d], causal=causal,
                   dtype=dtype, mask=mask, same=same,
                   body=on(new, lambda: fa.kernel_plan(q, k, causal, m))())
        if case in changed:
            # a body whose walk changed: each tree's outputs against the
            # plain versions, as a share of _flash_tolerances
            p_out, _ = ops.plain_flash_fwd(q, k, v, causal, sc, m)
            for t in ("old", "new"):
                out, lse = outs[t]
                refs = ops.plain_flash_bwd(q, k, v, out, lse, do, causal, sc,
                                           m)
                tols = [tl for tl, _ in cs._flash_tolerances(
                    torch, ops, fa, q, k, v, out, lse, do, [p_out, *refs],
                    sc, causal, m)]
                shares = [r["share"] for r in cs._compare(
                    (out, *grads[t]), (p_out, *refs), tols)]
                rec[t + "_tol_shares_out_dq_dk_dv"] = shares
                ok &= t == "old" or all(x <= 1.0 for x in shares)
        else:
            ok &= all(same)
        if timed or wide:
            for name, fn in (("fwd", f), ("bwd", bw)):
                rec[name + "_ms_old_new_new_old"] = [
                    cs.time_ms(torch, fn[t]) for t in ("old", "new", "new",
                                                       "old")]
        if wide:
            rec.update(_library_and_bound(torch, cs, q, k, v, do, m, causal,
                                          lengths, cs.BF16_FLOP_PER_S,
                                          mask))
        print(json.dumps(rec), flush=True)

    def run_fp32(case, b, sq, sk, h, hk, d, causal=True, dtype="float32",
                 mask=None, lengths=None, timed=False):
        nonlocal ok
        dt = torch.float32
        q, do = randn(b, sq, h, d, dtype=dt), randn(b, sq, h, d, dtype=dt)
        k, v = randn(b, sk, hk, d, dtype=dt), randn(b, sk, hk, d, dtype=dt)
        m = None if mask is None else cs._flash_mask(torch, randn, mask,
                                                     lengths, sk, dev)
        sc = d ** -0.5
        p_out, p_lse = ops.plain_flash_fwd(q, k, v, causal, sc, m)
        rec = dict(case=case, shape=[b, sq, sk, h, hk, d], causal=causal,
                   dtype=dtype, mask=mask)
        f, bw = {}, {}
        keys = fa._key_bias(m, q, k, causal)
        for t, lib in (("old", mixed), ("new", new)):
            f[t] = on(lib, lambda: fa._launch_fwd(q, k, v, causal, sc, keys))
            out, lse = f[t]()
            bw[t] = on(lib, lambda out=out, lse=lse: fa._launch_bwd(
                q, k, v, out, lse, do, causal, sc, keys))
            grads = bw[t]()
            refs = ops.plain_flash_bwd(q, k, v, out, lse, do, causal, sc, m)
            tols = [tl for tl, _ in cs._flash_tolerances(
                torch, ops, fa, q, k, v, out, lse, do, [p_out, *refs], sc,
                causal, m)]
            live = torch.isfinite(p_lse)
            tols.append(1e-5 * (1.0 + p_lse.abs().where(live, 0.0)))
            shares = [r["share"] for r in cs._compare(
                (out, *grads, lse.where(live, 0.0)),
                (p_out, *refs, p_lse.where(live, 0.0)), tols)]
            marks = torch.equal(torch.isinf(lse), torch.isinf(p_lse))
            rec[t + "_tol_shares_out_dq_dk_dv_lse"] = shares
            if t == "new":
                ok &= marks and all(s <= 1.0 for s in shares)
                again = (*f[t](), *bw[t]())
                rec["new_bit_identical_twice"] = all(
                    torch.equal(x, y) for x, y in zip((out, lse, *grads),
                                                      again))
                ok &= rec["new_bit_identical_twice"]
        if timed:
            for name, fn in (("fwd", f), ("bwd", bw)):
                rec[name + "_ms_old_new_new_old"] = [
                    cs.time_ms(torch, fn[t]) for t in ("old", "new", "new",
                                                       "old")]
            rec.update(_library_and_bound(torch, cs, q, k, v, do, m, causal,
                                          lengths, cs.TF32X3_FLOP_PER_S,
                                          mask))
        print(json.dumps(rec), flush=True)

    for b, sq, sk, h, hk, d, causal, dtype, timed in SHAPES:
        run_16bit("ab", b, sq, sk, h, hk, d, causal, dtype, timed=timed)
    for c in NARROW_SHAPES:
        run_16bit(**c)
    for c in cs.FLASH_WIDE_CASES:
        if c.get("dtype", "bfloat16") != "float32":
            run_16bit(wide=True, **c)
        torch.cuda.empty_cache()
    for c in _walk_shapes(cs):
        run_16bit(wide=True, **c)
        torch.cuda.empty_cache()
    for c in F32_SHAPES:
        run_fp32(**c)
    for c in cs.FLASH_WIDE_CASES:
        if c.get("dtype") == "float32":
            run_fp32(timed=True, **c)
        torch.cuda.empty_cache()
    print(json.dumps(dict(vit_b_16_two_steps_s_old_new_new_old=_vit_walls(
        torch, cs, dev, {"old": mixed, "new": new}, on))), flush=True)
    torch.cuda.empty_cache()
    print(json.dumps(dict(bert_flash_device_ms_old_new_new_old=_bert_flash(
        torch, cs, dev, {"old": mixed, "new": new}, on))), flush=True)
    print(json.dumps({"ok": bool(ok)}))
    return 0 if ok else 1


def _walk_shapes(cs):
    """The MASK bodies beyond 17a, timed like its cases: BERT's padding
    (`chip_smoke._BERT_LENGTHS`) over fewer sequences, so fewer query
    tiles an SM, and random lengths at the widths 128 and 192."""
    rs = np.random.RandomState(20)
    bert = [dict(case=f"bert bool, {b} sequences", b=b, sq=512, sk=512,
                 h=12, hk=12, d=64, causal=False, mask="bool",
                 lengths=cs._BERT_LENGTHS[:b]) for b in (8, 16, 32)]
    return bert + [dict(case=f"d{d} bool", b=8, sq=1024, sk=1024, h=h, hk=h,
                        d=d, causal=False, mask="bool",
                        lengths=[int(n) for n in rs.randint(1, 1025, 8)])
                   for d, h in ((128, 16), (192, 8))]


def _library_and_bound(torch, cs, q, k, v, do, m, causal, lengths, rate,
                       kind=None):
    """SDPA's forward and backward times on the same inputs (an explicit
    mask for a key-padding mask and for causal with sq != sk) and the
    bound of the work at d: bytes at the memory rate (the K / V rows of
    live keys read, as `chip_smoke._flash_case` counts them) or
    operations at `rate`, whichever is longer."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if m is not None:
        lib = dict(attn_mask=m if m.dtype == torch.bool
                   else m.clamp_min(-1e30).to(q.dtype))
    elif causal and sq != sk:
        lib = dict(attn_mask=torch.ones(sq, sk, dtype=torch.bool,
                                        device=q.device).tril(sk - sq))
    else:
        lib = dict(is_causal=causal)
    rec = dict(sdpa_fwd_ms=cs.time_ms(
        torch, lambda: sdpa(qt, kt, vt, enable_gqa=True, **lib)))
    qr, kr, vr = (x.clone().requires_grad_(True) for x in (qt, kt, vt))
    lo = sdpa(qr, kr, vr, enable_gqa=True, **lib)
    rec["sdpa_bwd_ms"] = cs.time_ms(torch, cs._grad_timer(
        torch, lo, (qr, kr, vr), do.transpose(1, 2).contiguous()))
    flops = 4 * h * cs._flash_pairs(b, sq, sk, causal, lengths) * d
    stats = b * h * sq * (2 if m is not None or causal and sq > sk else 1)
    es = q.element_size()
    kv = cs._flash_kv_rows(b, sq, sk, causal, cs._flash_live(kind, lengths)) \
        * k.shape[2] * d
    rec["bound_fwd_ms"] = cs.bound(
        (2 * q.numel() + 2 * kv) * es + stats * 4, flops, rate)
    rec["bound_bwd_ms"] = cs.bound(
        (4 * q.numel() + 2 * kv + 2 * k.numel()) * es + 2 * stats * 4,
        5 * flops // 2, rate)
    return rec


def _vit_walls(torch, cs, dev, libs, on):
    """Phase 17e's two ViT-B/16 steps, timed with each library in turns
    old, new, new, old after a warm-up step."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.vision.models import vit_b_16
    model = vit_b_16(num_classes=10, device=dev, seed=17)
    rng = np.random.RandomState(17)
    x = rng.randn(cs.VIT_BATCH, 3, 224, 224).astype(np.float32)
    y = rng.randint(0, 10, cs.VIT_BATCH).astype(np.int64)
    step = TrainStep(model, F.cross_entropy,
                     AdamW(1e-4, parameters=model.parameters()))
    step(x, y).item()
    walls = []
    for t in ("old", "new", "new", "old"):
        def two():
            return [step(x, y).item() for _ in range(2)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        on(libs[t], two)()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls


def _bert_flash(torch, cs, dev, libs, on):
    """Phase 17d's masked BERT-base step (`bench_bert`'s 64 x 512, a
    keep-mask of `chip_smoke._BERT_LENGTHS`, AdamW in `TrainStep`): after
    a warm-up step, one profiled step with each library in turns old,
    new, new, old, and the flash kernels' device ms in it
    (`chip_smoke.train_trace`)."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import BertForMaskedLM, bert_base_config
    from paddle_tpu_torch.optimizer import AdamW
    cfg = bert_base_config(dtype="bfloat16")
    model = BertForMaskedLM(cfg, device=dev, seed=17)
    b, sq = cs.BERT_BATCH, cs.BERT_SEQ
    rng = np.random.RandomState(17)
    keep = (np.arange(sq)[None] < np.array(cs._BERT_LENGTHS)[:, None]
            ).astype(np.int32)
    ids = rng.randint(0, cfg.vocab_size, (b, sq)).astype(np.int32)
    labels = np.where(keep > 0, ids, -100).astype(np.int32)
    types = np.zeros((b, sq), np.int32)
    step = TrainStep(model, model.compute_loss,
                     AdamW(cs.BERT_LR, parameters=model.parameters(),
                           weight_decay=cs.BERT_WD))
    step(ids, types, keep, labels).item()
    ms = []
    for t in ("old", "new", "new", "old"):
        trace = on(libs[t], lambda: cs.train_trace(
            torch, lambda *_: step(ids, types, keep, labels), None, 1.0))()
        ms.append(trace["by_kind_ms"]["flash_attention"])
    return ms


if __name__ == "__main__":
    if len(sys.argv) < 2 or len(sys.argv) > 2 and sys.argv[2] != "--changed":
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1], tuple(sys.argv[3:])))
