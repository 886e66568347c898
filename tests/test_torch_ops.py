"""paddle_tpu_torch.ops against paddle_tpu.ops, on the CPU.

Each port op with a Hopper kernel is held, through its plain PyTorch
version (what a CPU tensor takes), against (a) the reference's jnp twin
and (b) the reference's Pallas kernel run in interpret mode, as
tests/test_pallas_kernels.py runs it.  Inputs are made from a seed with
numpy and handed to both packages.

Tolerance: atol = rtol = 1e-5 in fp32 — the two packages do the same
fp32 arithmetic with different reduction orders (XLA vs PyTorch CPU
kernels), which moves results by a few ulps.
"""
import ctypes
import importlib.util
import pathlib
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_cpu import one_cpu_thread  # noqa: F401 (autouse)

import paddle_tpu.ops as jops
from paddle_tpu.ops.pallas.paged_attention import \
    paged_attention as pallas_paged_attention
from paddle_tpu.ops.pallas.rms_norm import rms_norm as pallas_rms_norm
from paddle_tpu.ops.pallas.rope import rope_apply as pallas_rope_apply

import paddle_tpu_torch.ops as tops
from paddle_tpu_torch.ops import _build

TOL = dict(atol=1e-5, rtol=1e-5)


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               **TOL)


@pytest.mark.parametrize("rows,H", [(3, 64), (16, 128), (1, 4096)])
def test_rms_norm(rows, H):
    rng = np.random.RandomState(rows + H)
    x, w = _rand(rng, rows, H), 1.0 + 0.1 * _rand(rng, H)
    port = tops.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    _close(port, jops.xla_rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    _close(port, pallas_rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))


@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("b,s,h,hk", [(2, 8, 4, 2), (8, 1, 4, 4)])
def test_apply_rope(b, s, h, hk, per_slot):
    rng = np.random.RandomState(b * s + h + per_slot)
    d = 16
    q, k = _rand(rng, b, s, h, d), _rand(rng, b, s, hk, d)
    if per_slot:
        pos = rng.randint(0, 500, (b, s)).astype(np.int32)
        cos_j, sin_j = jops.rope_cos_sin(s, d, position_ids=jnp.asarray(pos))
        cos_t, sin_t = tops.rope_cos_sin(s, d,
                                         position_ids=torch.from_numpy(pos))
    else:
        cos_j, sin_j = jops.rope_cos_sin(s, d)
        cos_t, sin_t = tops.rope_cos_sin(s, d)
    _close(cos_t, cos_j)
    _close(sin_t, sin_j)
    # both packages rotate the SAME tables, so only the rotation differs
    cos_n, sin_n = np.array(cos_j), np.array(sin_j)
    oq, ok = tops.apply_rope(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(cos_n), torch.from_numpy(sin_n))
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(cos_n),
            jnp.asarray(sin_n))
    for ref_q, ref_k in (jops.apply_rope(*args), pallas_rope_apply(*args)):
        _close(oq, ref_q)
        _close(ok, ref_k)


def _paged_inputs(rng, B, C, h, n_kv, d=16, P=24, ps=8, L=2, P_slot=5):
    q = _rand(rng, B, C, h, d)
    kp, vp = _rand(rng, P, ps, L, n_kv, d), _rand(rng, P, ps, L, n_kv, d)
    pt = (rng.permutation(P - 1)[:B * P_slot].reshape(B, P_slot) + 1) \
        .astype(np.int32)
    pt[-1] = 0                 # a free slot: every entry on the null page
    cap = P_slot * ps
    # slot at pos 0, one mid-page, one near capacity, the free slot
    pos = np.asarray([0, ps + 3, cap - C - 1, 6][:B], np.int32)
    return q, kp, vp, pt, pos


@pytest.mark.parametrize("C", [1, 8])
@pytest.mark.parametrize("group", [1, 2])
def test_paged_attention(C, group):
    rng = np.random.RandomState(10 * C + group)
    n_kv = 2
    q, kp, vp, pt, pos = _paged_inputs(rng, 4, C, n_kv * group, n_kv)
    for layer in (0, 1):
        port = tops.paged_attention(
            torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
            torch.from_numpy(pt), torch.from_numpy(pos), layer)
        jargs = (jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                 jnp.asarray(pt), jnp.asarray(pos), layer)
        _close(port, jops.xla_paged_attention(*jargs))
        _close(port, pallas_paged_attention(*jargs, interpret=True))


@pytest.mark.parametrize("scalar_pos", [False, True])
@pytest.mark.parametrize("group", [1, 2])
def test_cached_attention(scalar_pos, group):
    rng = np.random.RandomState(group + 7 * scalar_pos)
    b, s, n_kv, d, S = 3, 4, 2, 16, 24
    q = _rand(rng, b, s, n_kv * group, d)
    kc, vc = _rand(rng, b, S, n_kv, d), _rand(rng, b, S, n_kv, d)
    if scalar_pos:
        pos_t, pos_j = 5, jnp.asarray(5, jnp.int32)
    else:
        p = np.asarray([0, 9, S - s], np.int32)
        pos_t, pos_j = torch.from_numpy(p), jnp.asarray(p)
    port = tops.cached_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                 torch.from_numpy(vc), pos_t)
    _close(port, jops.cached_attention(jnp.asarray(q), jnp.asarray(kc),
                                       jnp.asarray(vc), pos_j))


@pytest.mark.parametrize("C", [1, 5, 11])
def test_paged_kv_update(C):
    """The rows a query can see — logical rows < pos + C of every live
    slot — match the reference's windowed write; pages no live slot
    maps are untouched.  The free slot's junk lanes are not compared."""
    rng = np.random.RandomState(C)
    B, P, ps, L, n_kv, d, P_slot = 4, 30, 4, 2, 2, 8, 6
    kp, vp = _rand(rng, P, ps, L, n_kv, d), _rand(rng, P, ps, L, n_kv, d)
    pt = (rng.permutation(P - 1)[:B * P_slot].reshape(B, P_slot) + 1) \
        .astype(np.int32)
    pt[-1] = 0
    pos = np.asarray([0, 3, P_slot * ps - C - ps, 2], np.int32)
    kn, vn = _rand(rng, B, C, n_kv, d), _rand(rng, B, C, n_kv, d)
    layer = 1
    kj, vj, _, _ = jops.paged_kv_update(
        jnp.asarray(kp), jnp.asarray(vp), None, None, jnp.asarray(pt),
        jnp.asarray(pos), jnp.asarray(kn), jnp.asarray(vn), layer)
    kt, vt = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    out = tops.paged_kv_update(kt, vt, torch.from_numpy(pt),
                               torch.from_numpy(pos), torch.from_numpy(kn),
                               torch.from_numpy(vn), layer)
    assert out[0] is kt and out[1] is vt          # written in place
    for port, ref in ((kt.numpy(), np.asarray(kj)),
                      (vt.numpy(), np.asarray(vj))):
        for b in range(B - 1):                    # live slots
            view_p = port[pt[b]][:, :, layer].reshape(P_slot * ps, n_kv, d)
            view_r = ref[pt[b]][:, :, layer].reshape(P_slot * ps, n_kv, d)
            n = pos[b] + C
            np.testing.assert_array_equal(view_p[:n], view_r[:n])
        unmapped = np.setdiff1d(np.arange(1, P), pt[:-1].reshape(-1))
        np.testing.assert_array_equal(port[unmapped], ref[unmapped])


def test_swiglu():
    rng = np.random.RandomState(0)
    x, g = _rand(rng, 3, 10), _rand(rng, 3, 10)
    _close(tops.swiglu(torch.from_numpy(x), torch.from_numpy(g)),
           jops.swiglu(jnp.asarray(x), jnp.asarray(g)))
    _close(tops.swiglu(torch.from_numpy(np.concatenate([x, g], -1))),
           jops.swiglu(jnp.asarray(np.concatenate([x, g], -1))))


@pytest.fixture(scope="module")
def paged_plan(tmp_path_factory):
    """The kernel library's plan (csrc/paged_attention_plan.cuh, plain
    C++), built by the host's C++ compiler: (B, n_kv, R, P_slot, ps,
    sms) -> (chunk, splits, counters)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "the plan test needs a C++ compiler"
    d = tmp_path_factory.mktemp("paged_plan")
    (d / "shim.cpp").write_text(
        '#include "paged_attention_plan.cuh"\n'
        'extern "C" void plan(int B, int n_kv, int R, int P_slot, int ps,\n'
        '                     int sms, int* out) {\n'
        '  const ptt_paged::Plan p =\n'
        '      ptt_paged::plan(B, n_kv, R, P_slot, ps, sms);\n'
        '  out[0] = p.chunk; out[1] = p.splits; out[2] = p.counters;\n'
        '}\n')
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-I", str(_build.CSRC), str(d / "shim.cpp"), "-o",
                    str(d / "plan.so")], check=True)
    fn = ctypes.CDLL(str(d / "plan.so")).plan
    fn.restype = None

    def plan(B, n_kv, R, P_slot, ps, sms=H100_SMS):
        out = (ctypes.c_int * 3)()
        fn(*(ctypes.c_int(v) for v in (B, n_kv, R, P_slot, ps, sms)), out)
        return tuple(out)
    return plan


H100_SMS = 132


@pytest.mark.parametrize("B,n_kv,R,P_slot,ps,sms,want", [
    (8, 32, 1, 66, 16, 132, (32, 3)),     # 7B decode: 512 keys a block
    (8, 32, 32, 66, 16, 132, (32, 3)),    # 7B admission chunk, group 1
    (8, 32, 128, 66, 16, 132, (64, 2)),   # group 4: 1024 keys (8 a row)
    (1, 32, 1, 256, 16, 132, (16, 16)),   # one long slot: 256 keys
    (1, 32, 1, 256, 16, 66, (32, 8)),     # the same on 66 SMs: 512 keys
    (8, 32, 1, 4, 16, 132, (4, 1)),       # P_slot under a chunk: one split
    (64, 32, 1, 66, 16, 132, (32, 3)),    # many slots
    (8, 32, 1, 132, 8, 132, (64, 3)),     # pages of 8 rows: the keys stay
    (8, 4, 256, 66, 16, 132, (16, 5)),    # two row tiles of 128
    (1, 1, 1, 300, 1, 132, (128, 3)),     # pages of one row: 128 keys
])
def test_paged_attention_split_count(paged_plan, B, n_kv, R, P_slot, ps,
                                     sms, want):
    """The library's plan from shapes and the card's SM count alone:
    pages a block walks and the blocks that cover a slot (splits =
    ceil(P_slot / chunk)), and a merge counter for each (slot, kv head,
    row tile) when a slot can take more than one split."""
    chunk, splits, counters = paged_plan(B, n_kv, R, P_slot, ps, sms)
    assert (chunk, splits) == want
    assert splits == -(-P_slot // chunk)
    assert counters == (B * n_kv * -(-R // 128) if splits > 1 else 0)


class _PagedLib:
    """Stands in for the kernel library's ptt_paged_attention_plan (the
    real plan, at an H100's SM count) and ptt_paged_attention: checks
    each call's arguments against `_build._SIGNATURES`, then writes the
    plain version's result where `out` points."""

    CTYPE = {ctypes.c_void_p: int, ctypes.c_int: int, ctypes.c_float: float}

    def __init__(self, args, plan):
        self.args = args          # the wrapper's inputs, as the test made them
        self.plan = plan
        self.calls = []
        self.plan_calls = []

    def _check(self, name, a, nullable=()):
        sig = _build._SIGNATURES[name]
        assert len(a) == len(sig)
        for i, (x, c) in enumerate(zip(a, sig)):
            assert type(x) is self.CTYPE[c] or (i in nullable
                                                and x is None), (name, i, x)

    def ptt_paged_attention_plan(self, *a):
        self._check("ptt_paged_attention_plan", a)
        self.plan_calls.append(a)
        _view(a[6], (3,), torch.int32).copy_(
            torch.tensor(self.plan(*a[1:6]), dtype=torch.int32))
        return 0

    def ptt_paged_attention(self, *a):
        # scales (int8 pools only) and the merge scratch may be null
        self._check("ptt_paged_attention", a, (6, 7, 11, 12, 13))
        self.calls.append(a)
        out = tops.plain_paged_attention(*self.args)
        _view(a[10], out.shape, out.dtype).copy_(out)
        return 0


def _view(ptr, shape, dtype):
    """A tensor over the CPU memory at address `ptr`."""
    n = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
    buf = (ctypes.c_char * n).from_address(ptr)
    return torch.frombuffer(buf, dtype=dtype).view(shape)


@pytest.mark.parametrize("dt,pool,C,group,ps", [
    ("bf16", "fp", 1, 1, 16),       # decode
    ("bf16", "int8", 1, 1, 16),
    ("bf16", "fp", 32, 4, 16),      # admission chunk, GQA
    ("bf16", "int8", 32, 4, 16),
    ("bf16", "fp", 1, 4, 8),        # pages of 8 rows
    ("fp16", "int8", 5, 1, 8),
    ("fp32", "fp", 1, 1, 16),       # the CUDA-core body's pool
    ("bf16", "fp", 3, 1, 64),       # one chunk covers the table: no scratch
])
def test_paged_attention_launch_marshalling(monkeypatch, paged_plan, dt,
                                            pool, C, group, ps):
    """`_launch` as the card runs it, with the kernel library stood in
    for: the plan asked of the library once for the shapes, every
    argument in the C signatures' order and type, the plan's chunk
    handed over, fp32 scratch part_acc [B, n_kv, splits, R, d] and
    part_ml [..., 2] with the plan's count of zeroed int32 merge
    counters, kept for the launch's (device, stream), only when a slot
    can take more than one split, and one launch counted under the
    pool's variant."""
    pa = tops.kernel_module("paged_attention")
    monkeypatch.setattr(_build, "cuda_device_index", lambda *t: 0)
    monkeypatch.setattr(_build, "stream_of", lambda d: 7)
    monkeypatch.setattr(pa, "_counters", {})
    monkeypatch.setattr(pa, "_plans", {})
    empty, made = torch.empty, []

    def spy_empty(*shape, **kw):
        t = empty(*shape, **kw)
        made.append(t)
        return t

    monkeypatch.setattr(torch, "empty", spy_empty)
    dtype = {"bf16": torch.bfloat16, "fp16": torch.float16,
             "fp32": torch.float32}[dt]
    rng = np.random.RandomState(C * 10 + group + ps)
    # three chunks' pages, or (pages of 64 rows) exactly one chunk
    B, n_kv, d, L, layer = 3, 2, 64, 2, 1
    P_slot = 2 if ps == 64 else 192 // ps
    h = n_kv * group
    q, kp, vp, pt, pos = _paged_inputs(rng, B, C, h, n_kv, d=d,
                                       P=1 + B * P_slot, ps=ps, L=L,
                                       P_slot=P_slot)
    q = torch.from_numpy(q).to(dtype)
    kp, vp = torch.from_numpy(kp).to(dtype), torch.from_numpy(vp).to(dtype)
    scales = ()
    if pool == "int8":
        amax = kp.float().abs().amax(dim=(1, 4))
        ks = (amax.clamp_min(1e-8) / 127).contiguous()
        kp = (kp.float() / ks[:, None, :, :, None]).round().clamp(
            -127, 127).to(torch.int8)
        vp = (vp.float() / ks[:, None, :, :, None]).round().clamp(
            -127, 127).to(torch.int8)
        scales = (ks, ks.clone())
    pt, pos = torch.from_numpy(pt), torch.from_numpy(pos)
    args = (q, kp, vp, pt, pos, layer) + scales
    lib = _PagedLib(args, paged_plan)
    monkeypatch.setattr(_build, "library", lambda: lib)
    before = tops.launch_counts()["paged_attention"]
    var = dict(pa.variant_launches)
    out = pa._launch(q, kp, vp, pt, pos, layer, *(scales or (None, None)),
                     None)
    R = C * group
    (plan_call,) = lib.plan_calls
    assert plan_call[:6] == (0, B, n_kv, R, P_slot, ps)
    chunk, splits, n_counters = paged_plan(B, n_kv, R, P_slot, ps)
    (call,) = lib.calls
    assert call[:11] == (
        0, _build.DTYPE_CODES[dtype], 3 if pool == "int8" else 0,
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
        scales[0].data_ptr() if scales else None,
        scales[1].data_ptr() if scales else None, pt.data_ptr(),
        pos.data_ptr(), out.data_ptr())
    assert call[14:] == (B, C, h, d, ps, L, n_kv, P_slot, layer,
                         pytest.approx(d ** -0.5), chunk, 7)
    if splits == 1:
        assert n_counters == 0 and ps == 64
        assert call[11:14] == (None, None, None)
    else:
        part_acc, part_ml = [next(t for t in made if t.data_ptr() == p)
                             for p in call[11:13]]
        assert part_acc.shape == (B, n_kv, splits, R, d)
        assert part_ml.shape == (B, n_kv, splits, R, 2)
        assert part_acc.dtype == part_ml.dtype == torch.float32
        counters = pa._counters[(q.device, 7)]
        assert call[13] == counters.data_ptr()
        assert counters.dtype == torch.int32
        assert counters.numel() >= n_counters == B * n_kv
        assert not counters.any()
    assert out.shape == q.shape and out.dtype == q.dtype
    assert torch.equal(out, tops.plain_paged_attention(*args))
    assert tops.launch_counts()["paged_attention"] == before + 1
    assert pa.variant_launches[pool] == var[pool] + 1
    # a second launch of the same shapes reuses the plan and the counters
    pa._launch(q, kp, vp, pt, pos, layer, *(scales or (None, None)), None)
    assert len(lib.plan_calls) == 1 and len(lib.calls) == 2
    assert lib.calls[1][13] == call[13]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dt", ["float16", "float32"])
def test_paged_tolerance_refuses_a_bf16_rounding(dt):
    """chip_smoke's check of paged attention at fp16 and fp32 (q and the
    pool), on float64 twins of out = P.V over the gathered view: a twin
    that rounds the weights P to q's dtype (the plain version's math) or
    keeps them fp32 (a rounding at another point) passes the
    per-element tolerance and, at fp16, the mean square bound.  The
    plain result rounded through bf16 fails the per-element tolerance at
    fp32; at fp16 it passes it (16 r of slack on each weight rounding is
    more than the 8x between the two unit roundoffs) and fails the mean
    square bound, as do weights rounded to bf16."""
    cs = _chip_smoke()
    tdt = getattr(torch, dt)
    rng = np.random.RandomState(17)
    B, C, n_kv, group, d, ps, P_slot = 4, 4, 2, 2, 64, 8, 40
    q, kp, vp, pt, pos = _paged_inputs(rng, B, C, n_kv * group, n_kv, d=d,
                                       P=1 + B * P_slot, ps=ps, P_slot=P_slot)
    q, kp, vp = (torch.from_numpy(x).to(tdt) for x in (q, kp, vp))
    pt, pos = torch.from_numpy(pt), torch.from_numpy(pos)
    ref = tops.plain_paged_attention(q, kp, vp, pt, pos, 1)
    qt, kg, vg, mask = cs._paged_dense_view(torch, q, kp, vp, pt, pos, 1)
    tol, var = cs._paged_tolerance(torch, qt, kg, vg, mask, ref)
    s = (qt.double() @ kg.double().transpose(-1, -2)) * d ** -0.5
    P = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1).float()

    def twin(wdt):
        return (P.to(wdt).double() @ vg.double()).transpose(1, 2).to(tdt)

    def fits(got):
        err = (got.double() - ref.double()).abs()
        return (bool((err <= tol.double()).all()),
                float((err ** 2 / var.double()).mean()) <= 1.0)

    bf = torch.bfloat16
    if tdt == torch.float32:
        assert fits(twin(tdt))[0] and fits(twin(torch.float32))[0]
        assert not fits(ref.to(bf).to(tdt))[0]
    else:
        assert fits(twin(tdt)) == fits(twin(torch.float32)) == (True, True)
        assert fits(ref.to(bf).to(tdt)) == (True, False)
        assert fits(twin(bf)) == (True, False)


def test_paged_attention_rejects_bad_gqa():
    rng = np.random.RandomState(1)
    q, kp, vp, pt, pos = _paged_inputs(rng, 4, 1, 3, 2)
    with pytest.raises(ValueError, match="multiple"):
        tops.paged_attention(torch.from_numpy(q), torch.from_numpy(kp),
                             torch.from_numpy(vp), torch.from_numpy(pt),
                             torch.from_numpy(pos), 0)


@pytest.fixture(scope="module")
def norm_rope_plans(tmp_path_factory):
    """The kernel library's plans of the RMSNorm forward
    (csrc/rms_norm_plan.cuh) and of RoPE (csrc/rope_plan.cuh), plain C++
    built by the host's C++ compiler: rms(H, elem, vec, rows, sms,
    per_sm) -> (V, threads, R, blocks), None where no body takes the
    shape; rope(elem, d, vec, rows, heads, sms) -> (VW, P, J, U, threads,
    blocks)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "the plan test needs a C++ compiler"
    d = tmp_path_factory.mktemp("norm_rope_plans")
    (d / "shim.cpp").write_text(
        '#include "rms_norm_plan.cuh"\n'
        '#include "rope_plan.cuh"\n'
        'extern "C" int rms(int H, int elem, int vec, long long rows,\n'
        '                   int sms, int per_sm, long long* out) {\n'
        '  ptt_rms::FwdPlan p;\n'
        '  if (!ptt_rms::fwd_plan(H, elem, vec != 0, rows, sms, per_sm, &p))\n'
        '    return 1;\n'
        '  out[0] = p.V; out[1] = p.threads; out[2] = p.R; out[3] = p.blocks;\n'
        '  return 0;\n'
        '}\n'
        'extern "C" void rope(int elem, int d, int vec, long long rows,\n'
        '                     long long heads, int sms, long long* out) {\n'
        '  const ptt_rotary::Plan p =\n'
        '      ptt_rotary::plan(elem, d, vec != 0, rows, heads, sms);\n'
        '  out[0] = p.VW; out[1] = p.P; out[2] = p.J; out[3] = p.U;\n'
        '  out[4] = p.threads; out[5] = p.blocks;\n'
        '}\n')
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-I", str(_build.CSRC), str(d / "shim.cpp"), "-o",
                    str(d / "plans.so")], check=True)
    so = ctypes.CDLL(str(d / "plans.so"))
    so.rms.argtypes = [ctypes.c_int] * 3 + [ctypes.c_longlong] \
        + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    so.rope.argtypes = [ctypes.c_int] * 3 + [ctypes.c_longlong] * 2 \
        + [ctypes.c_int, ctypes.c_void_p]
    so.rope.restype = None

    def rms(H, elem, vec, rows, sms=H100_SMS, per_sm=3):
        out = (ctypes.c_longlong * 4)()
        if so.rms(H, elem, int(vec), rows, sms, per_sm,
                  ctypes.addressof(out)):
            return None
        return tuple(out)

    def rope(elem, d, vec, rows, heads, sms=H100_SMS):
        out = (ctypes.c_longlong * 6)()
        so.rope(elem, d, int(vec), rows, heads, sms, ctypes.addressof(out))
        return tuple(out)
    return rms, rope


@pytest.mark.parametrize("H,elem,vec,rows,sms,per_sm,want", [
    (4096, 2, True, 8, 132, 3, (1, 512, 1, 8)),         # 7B decode
    (4096, 2, True, 256, 132, 3, (1, 512, 1, 256)),     # 7B admission
    (4096, 2, True, 8192, 132, 3, (1, 512, 4, 2048)),   # 7B prefill
    (2560, 2, True, 8192, 132, 5, (1, 320, 4, 2048)),   # training
    (2560, 2, True, 660, 132, 5, (1, 320, 1, 660)),     # all resident
    (2560, 2, True, 661, 132, 5, (1, 320, 4, 166)),     # one past
    (2560, 2, True, 661, 114, 5, (1, 320, 4, 166)),     # another SM count
    (2560, 2, True, 570, 114, 5, (1, 320, 1, 570)),
    (2560, 2, True, 1, 132, 5, (1, 320, 1, 1)),         # one row
    (2560, 2, True, 8193, 132, 5, (1, 320, 4, 2049)),   # a ragged block
    (8192, 2, True, 2048, 132, 2, (2, 512, 2, 1024)),
    (16384, 2, True, 512, 132, 2, (0, 256, 1, 512)),    # the wide body
    (2560, 4, True, 8192, 132, 3, (2, 320, 2, 4096)),   # fp32
    (4096, 4, True, 8, 132, 2, (2, 512, 1, 8)),
    (1003, 2, False, 4096, 132, 2, (2, 512, 2, 2048)),  # the scalar path
    (1024, 2, False, 1024, 132, 2, (2, 512, 2, 512)),
    (2048, 2, False, 1024, 132, 2, (0, 256, 1, 1024)),
    (2560, 2, False, 1024, 132, 2, (0, 256, 1, 1024)),  # unaligned x: wide
    (32768, 2, True, 256, 132, 2, (0, 256, 1, 256)),    # the wide body
    (58079, 2, False, 64, 132, 2, (0, 256, 1, 64)),
    (64, 2, True, 5, 132, 2, (1, 32, 1, 5)),
    (1003, 2, True, 8, 132, 2, None),                   # no 16-byte path
    (0, 2, False, 8, 132, 2, None),
])
def test_rms_norm_forward_plan(norm_rope_plans, H, elem, vec, rows, sms,
                               per_sm, want):
    """The RMSNorm forward's plan (csrc/rms_norm.cu's header tables): the
    rows body with the least V of 1 or 2 vectors a thread that keeps a
    block within 512 threads, one batch of R rows a block: R = 1 while
    the rows fit on the card at once (per_sm blocks an SM), else 4 / V;
    wider rows a block each on the wide body."""
    got = norm_rope_plans[0](H, elem, vec, rows, sms, per_sm)
    assert got == want
    if got is not None and got[0]:
        V, threads, R, blocks = got
        assert threads <= 512 and blocks == -(-rows // R)
        assert R == (1 if rows <= per_sm * sms else 4 // V)
        assert threads * V * (16 // elem if vec else 1) >= H


@pytest.mark.parametrize("elem,d,vec,rows,heads,sms,want", [
    (2, 128, True, 8192, 24, 132, (8, 8, 1, 4, 128, 512)),     # training
    (2, 128, True, 8, 64, 132, (8, 8, 64, 1, 128, 32)),        # 7B decode
    (2, 128, True, 256, 64, 132, (8, 8, 32, 2, 128, 512)),     # admission
    (4, 128, True, 4096, 24, 132, (4, 16, 1, 4, 128, 512)),    # fp32
    (4, 128, True, 8192, 24, 132, (4, 16, 1, 4, 128, 1024)),
    (4, 128, True, 8, 64, 132, (4, 16, 64, 1, 128, 64)),
    (2, 64, True, 2048, 24, 132, (8, 4, 8, 2, 128, 512)),      # d = 64
    (2, 64, True, 8192, 24, 132, (8, 4, 2, 4, 128, 512)),
    (2, 96, True, 1024, 10, 132, (8, 6, 8, 2, 128, 384)),      # d = 96
    (2, 96, True, 8192, 24, 114, (8, 6, 1, 4, 128, 384)),      # 114 SMs
    (2, 100, False, 512, 10, 132, (1, 50, 4, 2, 128, 800)),    # scalar d
    (2, 100, False, 512, 10, 114, (1, 50, 2, 4, 128, 400)),
    (2, 128, False, 512, 24, 132, (1, 64, 2, 4, 128, 512)),    # unaligned
    (2, 128, False, 8192, 24, 132, (1, 64, 1, 4, 128, 2112)),  # capped grid
    (2, 128, False, 8192, 24, 114, (1, 64, 1, 4, 128, 1824)),
    (2, 128, True, 8, 65, 132, (8, 8, 64, 2, 128, 32)),        # h + hk = 65
    (2, 128, True, 1, 70000, 132, (8, 8, 8192, 4, 128, 512)),  # past 65535
    (2, 128, True, 1, 64, 132, (8, 8, 64, 1, 128, 4)),         # one row
    (2, 10, False, 3, 4, 132, (1, 5, 4, 1, 128, 1)),           # tiny d
])
def test_rope_plan(norm_rope_plans, elem, d, vec, rows, heads, sms, want):
    """RoPE's plan (csrc/rope.cu's header table): VW pairs a thread (16
    bytes, or 1 on the scalar path), P = d / 2 / VW threads a head, J
    the least power of two giving 400 threads an SM (at most the heads),
    U = 4 heads loaded before any is formed (2 or 1 when a split holds
    fewer), blocks of 128 capped at 16 an SM."""
    got = norm_rope_plans[1](elem, d, vec, rows, heads, sms)
    assert got == want
    VW, P, J, U, threads, blocks = got
    assert VW * P * 2 == d and J <= heads and J & (J - 1) == 0
    assert U == min(4, 2 ** int(np.log2(-(-heads // J))))
    assert blocks == min(-(-rows * P * J // threads), 16 * sms)


class _NormRopeLib:
    """Stands in for the kernel library's ptt_rms_norm and ptt_rope:
    checks each call's arguments against `_build._SIGNATURES`, then
    writes the plain versions' results where the outputs point."""

    CTYPE = {ctypes.c_void_p: int, ctypes.c_int: int, ctypes.c_longlong: int,
             ctypes.c_float: float}
    DTYPE = {code: dt for dt, code in _build.DTYPE_CODES.items()}

    def __init__(self):
        self.calls = []

    def _record(self, name, args):
        sig = _build._SIGNATURES[name]
        assert len(args) == len(sig), name
        for i, (a, c) in enumerate(zip(args, sig)):
            assert type(a) is self.CTYPE[c], (name, i, a, c)
        self.calls.append((name, args))

    def ptt_rms_norm(self, *args):
        self._record("ptt_rms_norm", args)
        dev, code, x, w, out, rows, H, eps, stream = args
        dt = self.DTYPE[code]
        ref = tops.plain_rms_norm(_view(x, (rows, H), dt), _view(w, (H,), dt),
                                  eps)
        _view(out, (rows, H), dt).copy_(ref)
        return 0

    def ptt_rope(self, *args):
        self._record("ptt_rope", args)
        dev, code, q, k, cos, sin, oq, ok, rows, h, hk, d, cs_rows, neg, \
            stream = args
        dt = self.DTYPE[code]
        c = _view(cos, (cs_rows, d), torch.float32)
        s = _view(sin, (cs_rows, d), torch.float32)
        rep = rows // cs_rows                     # [s, d] tables: batch rows
        qo, ko = tops.plain_apply_rope(
            _view(q, (rep, cs_rows, h, d), dt),
            _view(k, (rep, cs_rows, hk, d), dt), c, -s if neg else s)
        _view(oq, qo.shape, dt).copy_(qo)
        _view(ok, ko.shape, dt).copy_(ko)
        return 0


@pytest.mark.parametrize("dt,rows,H,offset", [
    ("bfloat16", 8, 4096, 0), ("bfloat16", 7, 1003, 0),
    ("float16", 3, 2560, 1), ("float32", 1, 64, 0)])
def test_rms_norm_launch_marshalling(monkeypatch, dt, rows, H, offset):
    """`_launch` as the card runs it, with the kernel library stood in
    for: one library call a launch, every argument in the C signature's
    order and type (the library picks the body and grid itself, so no
    plan or scratch crosses), the output as the kernel wrote it, one
    launch counted."""
    rn = tops.kernel_module("rms_norm")
    lib = _NormRopeLib()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "cuda_device_index", lambda *t: 0)
    monkeypatch.setattr(_build, "stream_of", lambda d: 5)
    tdt = getattr(torch, dt)
    rng = np.random.RandomState(rows + H)
    x = torch.from_numpy(_rand(rng, rows * H + offset)).to(tdt)[offset:] \
        .view(rows, H)
    w = torch.from_numpy(1 + 0.1 * _rand(rng, H)).to(tdt)
    before = tops.launch_counts()["rms_norm"]
    out = rn._launch(x, w, 1e-5)
    ((name, args),) = lib.calls
    assert name == "ptt_rms_norm"
    assert args == (0, _build.DTYPE_CODES[tdt], x.data_ptr(), w.data_ptr(),
                    out.data_ptr(), rows, H, 1e-5, 5)
    assert torch.equal(out, tops.plain_rms_norm(x, w, 1e-5))
    assert tops.launch_counts()["rms_norm"] == before + 1


@pytest.mark.parametrize("neg_sin", [False, True])
@pytest.mark.parametrize("dt,b,s,h,hk,d,per_slot", [
    ("bfloat16", 8, 1, 4, 4, 16, True),      # decode: per-slot tables
    ("bfloat16", 2, 6, 5, 1, 32, False),     # shared tables
    ("float32", 1, 3, 3, 2, 10, False),
    ("float16", 2, 2, 70, 2, 8, True)])
def test_rope_launch_marshalling(monkeypatch, neg_sin, dt, b, s, h, hk, d,
                                 per_slot):
    """`_launch` as the card runs it, with the kernel library stood in
    for: one library call a launch, every argument in the C signature's
    order and type (rows b*s, cs_rows s for a shared table and b*s for a
    per-slot one, neg_sin as an int), the outputs as the kernel wrote
    them, one launch counted under its direction."""
    ro = tops.kernel_module("rope")
    lib = _NormRopeLib()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "cuda_device_index", lambda *t: 0)
    monkeypatch.setattr(_build, "stream_of", lambda dev: 3)
    tdt = getattr(torch, dt)
    rng = np.random.RandomState(b * s + h + d)
    q = torch.from_numpy(_rand(rng, b, s, h, d)).to(tdt)
    k = torch.from_numpy(_rand(rng, b, s, hk, d)).to(tdt)
    shape = (b, s, d) if per_slot else (s, d)
    cos = torch.from_numpy(_rand(rng, *shape))
    sin = torch.from_numpy(_rand(rng, *shape))
    name = "rope_bwd" if neg_sin else "rope"
    before = tops.launch_counts()[name]
    oq, ok = ro._launch(q, k, cos, sin, neg_sin=neg_sin)
    ((called, args),) = lib.calls
    assert called == "ptt_rope"
    assert args == (0, _build.DTYPE_CODES[tdt], q.data_ptr(), k.data_ptr(),
                    cos.data_ptr(), sin.data_ptr(), oq.data_ptr(),
                    ok.data_ptr(), b * s, h, hk, d, b * s if per_slot else s,
                    int(neg_sin), 3)
    want = tops.plain_apply_rope(q, k, cos, -sin if neg_sin else sin)
    assert torch.equal(oq, want[0]) and torch.equal(ok, want[1])
    assert tops.launch_counts()[name] == before + 1
