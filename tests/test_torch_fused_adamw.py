"""The port's fused AdamW against paddle_tpu's, on the CPU.

  * `plain_fused_adamw` (the math of the Hopper kernel, what a CPU
    tensor takes) against the reference's Pallas `fused_adamw` run in
    interpret mode and against its jnp twin `adamw_hostside`: all four
    kernel variants (fp32 params / half params + fp32 master, each with
    and without the ef residual), fp32 and bf16 moments, no decay, L2
    and decoupled decay, and two shapes: [64, 128], which takes the
    reference's 2-D (rows, 1024) path, and [37, 29], which takes its
    padded flat path;
  * the kernel wrapper's marshalling: `_launch` driven with a stand-in
    library that maps the pointers it receives back to the test's
    tensors and runs the plain math with the scalars it was handed;
  * the dispatch of `apply_update(s)`: fusable states go to the fused
    update, the rest to the pure rule, and FLAGS_multi_tensor_adamw's
    grouped launches give bit-identical results;
  * the optimizer reads FLAGS_bf16_adamw_moments at construction;
  * N TrainStep steps of the port against `paddle_tpu.jit.TrainStep`
    with FLAGS_fused_adamw_interpret on (the reference's fused kernel in
    interpret mode), with and without FLAGS_bf16_adamw_moments.

Inputs are made from a seed with numpy and handed to both packages.
Tolerances, with their reasons:

  * fp32 outputs: atol 2e-7, rtol 1e-6 (the reference's own lockstep
    tolerance, tests/test_bf16_moments.py) — the bias corrections are
    fp32 powers in the port and in the Pallas wrapper but doubles in
    `adamw_hostside` (an ulp of c1), and PyTorch's and XLA's CPU sqrt
    can differ by an ulp;
  * half-precision outputs (bf16/fp16 moments, ef, a bf16 parameter):
    one ulp of the stored value, 2^-7 relative (2^-10 for fp16) plus
    the fp32 tolerance — an fp32 value an ulp apart can round the other
    way;
  * TrainStep trajectories, 4 steps of a 2-layer fp32 Llama: losses
    rtol 1e-5, parameters as tests/test_torch_llama_train.py (99.9% of
    each tensor within 1e-5, all within 2·lr·steps: a near-zero
    gradient's sign can flip Adam's update).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_cpu import one_cpu_thread  # noqa: F401 (autouse)

import paddle_tpu
from paddle_tpu.framework import flags as jflags
from paddle_tpu.framework.tensor import Tensor as JTensor
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.llama import llama_tiny_config as j_tiny
from paddle_tpu.ops.pallas.fused_adamw import adamw_hostside
from paddle_tpu.ops.pallas.fused_adamw import fused_adamw as pallas_adamw

from paddle_tpu_torch import ops
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny_config,
                                     load_numpy_state_dict, numpy_state_dict)
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.optimizer import AdamW, apply_updates
from paddle_tpu_torch.optimizer import jit_update

fam = ops.kernel_module("fused_adamw")

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
       "float16": torch.float16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
       "float16": jnp.float16}
HP = dict(b1=0.9, b2=0.999, eps=1e-8)
LR, STEP = 1e-3, 3


def _inputs(shape, md, ef, seed=0):
    rng = np.random.RandomState(seed)
    g = (rng.randn(*shape) * 0.01).astype(np.float32)
    m = (rng.randn(*shape) * 0.01).astype(np.float32)
    v = np.abs(rng.randn(*shape) * 0.01).astype(np.float32) ** 2
    mst = rng.randn(*shape).astype(np.float32)
    # a residual of the size bf16 rounding leaves on v
    e = (v * 2.0 ** -9 * rng.uniform(-1, 1, shape)).astype(np.float32) \
        if ef else None
    # the moments start as values of their storage dtype
    m, v = (np.asarray(jnp.asarray(a).astype(JDT[md]).astype(jnp.float32))
            for a in (m, v))
    if ef:
        e = np.asarray(jnp.asarray(e).astype(JDT[md]).astype(jnp.float32))
    return g, m, v, mst, e


def _tol(dtype):
    ulp = {"float32": 0.0, "bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}
    return dict(atol=2e-7, rtol=1e-6 + ulp[dtype])


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


VARIANTS = [(out, md, ef)
            for out in ("float32", "bfloat16")
            for md in ("float32", "bfloat16")
            for ef in (False, True) if not (ef and md == "float32")]


@pytest.mark.parametrize("shape", [(64, 128), (37, 29)],
                         ids=["2d-path", "flat-path"])
@pytest.mark.parametrize("wd,decoupled", [(0.0, True), (0.01, False),
                                          (0.01, True)],
                         ids=["no-decay", "l2", "decoupled"])
@pytest.mark.parametrize("out,md,ef", VARIANTS,
                         ids=[f"{o}-params-m{m}{'-ef' if e else ''}"
                              for o, m, e in VARIANTS])
def test_plain_matches_pallas_kernel_and_hostside(out, md, ef, wd,
                                                  decoupled, shape):
    g, m, v, mst, e = _inputs(shape, md, ef)
    kw = dict(HP, wd=wd, decoupled=decoupled)
    jargs = [jnp.asarray(g), jnp.asarray(m).astype(JDT[md]),
             jnp.asarray(v).astype(JDT[md]), jnp.asarray(mst)]
    jef = None if e is None else jnp.asarray(e).astype(JDT[md])
    ref_k = pallas_adamw(*jargs, jnp.float32(LR), jnp.int32(STEP), ef=jef,
                         out_dtype=JDT[out], **kw)
    ref_h = adamw_hostside(*jargs, jnp.float32(LR), jnp.int32(STEP),
                           ef=jef, out_dtype=JDT[out], **kw)
    tm, tv = (torch.tensor(a, dtype=TDT[md]) for a in (m, v))
    tmst = torch.tensor(mst)
    tef = None if e is None else torch.tensor(e, dtype=TDT[md])
    got = ops.fused_adamw(torch.tensor(g), tm, tv, tmst, LR, STEP,
                          ef=tef, out_dtype=TDT[out], **kw)
    assert len(got) == len(ref_k) == len(ref_h) == (5 if ef else 4)
    # in place: the state tensors ARE the returned ones
    assert got[1] is tm and got[2] is tv and got[3] is tmst
    if out == "float32":
        assert got[0] is tmst
    if ef:
        assert got[4] is tef
    dts = [out, md, md, "float32", md]
    for i, (x, rk, rh) in enumerate(zip(got, ref_k, ref_h)):
        np.testing.assert_allclose(_np(x), _np(rk), err_msg=f"out {i} vs "
                                   "Pallas", **_tol(dts[i]))
        np.testing.assert_allclose(_np(x), _np(rh), err_msg=f"out {i} vs "
                                   "adamw_hostside", **_tol(dts[i]))


def test_bias_corrections_are_fp32_powers():
    c1, c2 = fam.bias_corrections(0.9, 0.999, 7)
    assert c1 == float(np.float32(1) - np.float32(0.9) ** np.float32(7))
    assert c2 == float(np.float32(1) - np.float32(0.999) ** np.float32(7))
    # the double-precision value rounds elsewhere: the two are distinct
    # computations (the tolerance note above)
    assert abs(c1 - (1 - 0.9 ** 7)) < 1e-7


class _FakeLib:
    """Stands in for the kernel library: maps the pointers `_launch`
    passes back to the test's tensors and runs the plain math with the
    scalars it was handed."""

    def __init__(self, tensors):
        self.by_ptr = {t.data_ptr(): t for t in tensors if t is not None}
        self.calls = []

    def ptt_fused_adamw(self, dev, g_code, m_code, p_code, g, m, v, ef, mst,
                        p_out, n, lr, c1, c2, b1, omb1, b2, omb2, eps, wd,
                        decoupled, stream):
        self.calls.append(dict(g_code=g_code, m_code=m_code, p_code=p_code,
                               n=n, c1=c1, c2=c2, omb1=omb1, omb2=omb2,
                               ef=ef is not None, p_out=p_out is not None))
        t = self.by_ptr
        # the test runs step STEP; the bias corrections are checked below
        out = torch.float32 if p_code < 0 else \
            {1: torch.bfloat16, 2: torch.float16}[p_code]
        fam.plain_fused_adamw(
            t[g], t[m], t[v], t[mst], lr, STEP, b1=b1, b2=b2, eps=eps,
            wd=wd, decoupled=bool(decoupled), out_dtype=out,
            ef=None if ef is None else t[ef],
            param=None if p_out is None else t[p_out])
        return 0


@pytest.mark.parametrize("out,md,ef", VARIANTS,
                         ids=[f"{o}-params-m{m}{'-ef' if e else ''}"
                              for o, m, e in VARIANTS])
def test_launch_marshalling(monkeypatch, out, md, ef):
    g, m, v, mst, e = _inputs((5, 7), md, ef, seed=3)
    make = lambda: [torch.tensor(g), torch.tensor(m, dtype=TDT[md]),
                    torch.tensor(v, dtype=TDT[md]), torch.tensor(mst),
                    None if e is None else torch.tensor(e, dtype=TDT[md])]
    ref, got = make(), make()
    param = None if out == "float32" else torch.empty((5, 7),
                                                      dtype=TDT[out])
    lib = _FakeLib(got + [param])
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "cuda_device_index", lambda *t: 0)
    monkeypatch.setattr(_build, "stream_of", lambda d: 0)
    kw = dict(HP, wd=0.01, decoupled=True, out_dtype=TDT[out])
    before = dict(fam.variant_launches)
    res = fam._launch(*got[:4], LR, STEP, ef=got[4], param=param, **kw)
    want = fam.plain_fused_adamw(*ref[:4], LR, STEP, ef=ref[4], **kw)
    for a, b in zip(res, want):
        assert torch.equal(a, b)
    call, = lib.calls
    assert call["p_code"] == (-1 if out == "float32" else 1)
    assert call["m_code"] == _build.DTYPE_CODES[TDT[md]]
    assert call["ef"] == ef and call["p_out"] == (out != "float32")
    assert call["n"] == 35
    assert (call["c1"], call["c2"]) == fam.bias_corrections(0.9, 0.999, STEP)
    assert call["omb1"] == np.float32(1 - 0.9)
    assert call["omb2"] == np.float32(1 - 0.999)
    variant = ("fp32" if out == "float32" else "master") + \
        ("_ef" if ef else "")
    assert fam.variant_launches[variant] == before[variant] + 1


def test_launch_refuses_what_the_kernel_does_not_take(monkeypatch):
    monkeypatch.setattr(_build, "cuda_device_index", lambda *t: 0)
    z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt)
    kw = dict(HP, wd=0.0, decoupled=True)
    with pytest.raises(ValueError, match="differ in shape"):
        fam._launch(z(4), z(4), z(4), z(5), LR, 1, out_dtype=torch.float32,
                    ef=None, param=None, **kw)
    with pytest.raises(ValueError, match="share one dtype"):
        fam._launch(z(4), z(4), z(4, dt=torch.bfloat16), z(4), LR, 1,
                    out_dtype=torch.float32, ef=None, param=None, **kw)
    with pytest.raises(ValueError, match="fp32 master"):
        fam._launch(z(4), z(4), z(4), z(4, dt=torch.bfloat16), LR, 1,
                    out_dtype=torch.float32, ef=None, param=None, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        fam._launch(z(4, 4).t(), z(4, 4), z(4, 4), z(4, 4), LR, 1,
                    out_dtype=torch.float32, ef=None, param=None, **kw)


def _params(seed=0):
    """A mix the step meets: fp32 params of several sizes, and bf16
    params with an fp32 master."""
    rng = np.random.RandomState(seed)
    out = []
    for shape, dt in (((8,), torch.float32), ((3, 5), torch.float32),
                      ((16,), torch.float32), ((4, 4), torch.bfloat16),
                      ((7,), torch.bfloat16), ((6, 6), torch.float32)):
        p = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dt)
        g = torch.from_numpy((rng.randn(*shape) * 0.1).astype(np.float32)) \
            .to(dt)
        out.append((p, g))
    return out


def _run_updates(multi, moment_dtype, steps=3):
    tflags.set_flags({"FLAGS_multi_tensor_adamw": multi})
    try:
        pg = _params()
        params = [p for p, _ in pg]
        opt = AdamW(LR, parameters=params, weight_decay=0.1,
                    multi_precision=True, moment_dtype=moment_dtype)
        states = [jit_update.maybe_master_state(opt, p, opt._init_state(p))
                  for p in params]
        wds = [0.1, 0.1, 0.0, 0.1, 0.1, 0.0]
        for s in range(1, steps + 1):
            apply_updates(type(opt)._update, params, [g for _, g in pg],
                          states, LR, wds, s, opt._hyper())
        return params, states
    finally:
        tflags.set_flags({"FLAGS_multi_tensor_adamw": False})


@pytest.mark.parametrize("moment_dtype", [None, "bfloat16"])
def test_multi_tensor_grouping_is_bit_identical(monkeypatch, moment_dtype):
    calls = []
    real = jit_update.fused_adamw

    def counting(g, *a, **k):
        calls.append(g.numel())
        return real(g, *a, **k)

    monkeypatch.setattr(jit_update, "fused_adamw", counting)
    p1, s1 = _run_updates(False, moment_dtype)
    per_param = list(calls)
    calls.clear()
    p2, s2 = _run_updates(True, moment_dtype)
    assert per_param == [8, 15, 16, 16, 7, 36] * 3
    # groups: fp32 wd 0.1 (8 + 15), fp32 wd 0 (16 + 36), bf16 + master
    # wd 0.1 (16 + 7): one launch each
    assert sorted(calls) == sorted([23, 52, 23] * 3)
    for a, b in zip(p1, p2):
        assert torch.equal(a, b)
    for a, b in zip(s1, s2):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_dispatch_fused_versus_pure_rule(monkeypatch):
    seen = []
    real = jit_update.fused_adamw
    monkeypatch.setattr(jit_update, "fused_adamw",
                        lambda g, *a, **k: seen.append(k) or real(g, *a, **k))
    p = torch.ones(4)
    hp = dict(HP, decoupled=True)
    s = {"moment1": torch.zeros(4), "moment2": torch.zeros(4)}
    jit_update.apply_update(None, p, torch.ones(4), s, LR, 0.0, 1, hp)
    assert len(seen) == 1 and seen[0]["out_dtype"] == torch.float32
    # a bf16 parameter with no master is not fusable: the pure rule
    pure = []
    pb = torch.ones(4, dtype=torch.bfloat16)
    jit_update.apply_update(lambda *a, **k: pure.append(1), pb,
                            torch.ones(4, dtype=torch.bfloat16),
                            {"moment1": torch.zeros(4),
                             "moment2": torch.zeros(4)}, LR, 0.0, 1, hp)
    assert pure == [1] and len(seen) == 1
    # the flag off: the pure rule
    tflags.set_flags({"FLAGS_use_fused_adamw": False})
    try:
        jit_update.apply_update(lambda *a, **k: pure.append(2), p,
                                torch.ones(4), s, LR, 0.0, 2, hp)
    finally:
        tflags.set_flags({"FLAGS_use_fused_adamw": True})
    assert pure == [1, 2] and len(seen) == 1
    # master state: the kernel writes the half parameter in place
    pm = torch.ones(4, dtype=torch.bfloat16)
    sm = {"moment1": torch.zeros(4), "moment2": torch.zeros(4),
          "master": torch.ones(4)}
    jit_update.apply_update(None, pm, torch.ones(4, dtype=torch.bfloat16),
                            sm, LR, 0.0, 1, hp)
    assert seen[-1]["param"] is pm and seen[-1]["out_dtype"] == torch.bfloat16
    assert torch.equal(pm, sm["master"].to(torch.bfloat16))
    assert not torch.equal(sm["master"], torch.ones(4))


def test_optimizer_reads_bf16_moments_flag_at_construction():
    p = [torch.nn.Parameter(torch.ones(3))]
    tflags.set_flags({"FLAGS_bf16_adamw_moments": True})
    try:
        on = AdamW(LR, parameters=p)
        explicit = AdamW(LR, parameters=p, moment_dtype="float32")
        no_ef = AdamW(LR, parameters=p, moment_ef=False)
    finally:
        tflags.set_flags({"FLAGS_bf16_adamw_moments": False})
    off = AdamW(LR, parameters=p)
    st = on._init_state(p[0])
    assert set(st) == {"moment1", "moment2", "ef"}
    assert all(t.dtype == torch.bfloat16 for t in st.values())
    assert set(explicit._init_state(p[0])) == {"moment1", "moment2"}
    assert set(no_ef._init_state(p[0])) == {"moment1", "moment2"}
    assert no_ef._init_state(p[0])["moment1"].dtype == torch.bfloat16
    assert off._init_state(p[0])["moment1"].dtype == torch.float32


CFG = dict(dtype="float32", num_hidden_layers=2, num_key_value_heads=2)


def _pair(seed):
    jm = JLlama(j_tiny(**CFG))
    rng = np.random.RandomState(seed)
    weights = {}
    for name, p in jm.state_dict().items():
        shape = tuple(p.shape)
        weights[name] = ((1.0 + 0.1 * rng.randn(*shape)) if len(shape) == 1
                         else rng.randn(*shape) / np.sqrt(shape[0])) \
            .astype(np.float32)
    jm.set_state_dict(weights)
    tm = LlamaForCausalLM(llama_tiny_config(**CFG), device="cpu")
    load_numpy_state_dict(tm, weights)
    return jm, tm


@pytest.mark.parametrize("bf16_moments", [False, True],
                         ids=["fp32-moments", "bf16-moments-ef"])
def test_train_steps_match_reference_fused_kernel(bf16_moments):
    flags = {"FLAGS_bf16_adamw_moments": bf16_moments}
    jflags.set_flags(dict(flags, FLAGS_fused_adamw_interpret=True))
    tflags.set_flags(flags)
    try:
        jm, tm = _pair(seed=8)
        jstep = JTrainStep(jm, jm.compute_loss, paddle_tpu.optimizer.AdamW(
            LR, parameters=jm.parameters(), weight_decay=0.1))
        tstep = TrainStep(tm, tm.compute_loss, AdamW(
            LR, parameters=tm.parameters(), weight_decay=0.1))
        # one batch, repeated: the loss must fall
        batches = [np.random.RandomState(9).randint(0, 512, (2, 64))
                   .astype(np.int32)] * 4
        jl = [float(jstep(JTensor(jnp.asarray(b)), JTensor(jnp.asarray(b)))
                    .value) for b in batches]
        before = ops.launch_counts()["fused_adamw"]
        tl = [tstep(b, b).item() for b in batches]
    finally:
        jflags.set_flags({"FLAGS_bf16_adamw_moments": False,
                          "FLAGS_fused_adamw_interpret": False})
        tflags.set_flags({"FLAGS_bf16_adamw_moments": False})
    # CPU tensors take the plain version: no kernel launch is counted
    assert ops.launch_counts()["fused_adamw"] == before
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    keys = {"moment1", "moment2"} | ({"ef"} if bf16_moments else set())
    assert all(set(s) == keys for s in tstep._opt_states)
    assert all(set(s) == keys for s in jstep._opt_states)
    tp = numpy_state_dict(tm)
    jp = {k: np.asarray(v.value, np.float32)
          for k, v in jm.state_dict().items()}
    for n in jp:
        d = np.abs(tp[n] - jp[n])
        assert np.quantile(d, 0.999) <= 1e-5 and d.max() <= 2 * LR * 4, \
            (n, np.quantile(d, 0.999), d.max())


def test_train_step_sends_every_parameter_through_the_kernel_path(
        monkeypatch):
    """The card's route through TrainStep, on the CPU: the update goes
    through `_launch` (monkeypatched to the plain function, counting as
    the kernel does) for every parameter and step, with the ef variant
    under FLAGS_bf16_adamw_moments; the parameters come out bit-identical
    to the plain route."""
    def plain_launch(*a, ef, param, out_dtype, **k):
        fam.launches["fused_adamw"] += 1
        fam.variant_launches[("fp32" if out_dtype == torch.float32
                              else "master")
                             + ("_ef" if ef is not None else "")] += 1
        return fam.plain_fused_adamw(*a, ef=ef, param=param,
                                     out_dtype=out_dtype, **k)

    batch = np.random.RandomState(10).randint(0, 512, (2, 32)) \
        .astype(np.int32)
    params = {}
    for route in ("plain", "kernel"):
        _, tm = _pair(seed=11)
        if route == "kernel":
            monkeypatch.setattr(fam, "_launch", plain_launch)
            monkeypatch.setattr(jit_update, "fused_adamw",
                                lambda g, m, v, mst, lr, step, **k:
                                fam._launch(g, m, v, mst, lr, step, **{
                                    "ef": None, "param": None, **k}))
            ops.reset_launch_counts()
        tflags.set_flags({"FLAGS_bf16_adamw_moments": True})
        try:
            step = TrainStep(tm, tm.compute_loss, AdamW(
                LR, parameters=tm.parameters(), weight_decay=0.1))
        finally:
            tflags.set_flags({"FLAGS_bf16_adamw_moments": False})
        for _ in range(2):
            step(batch, batch)
        params[route] = numpy_state_dict(tm)
    n = sum(1 for _ in tm.parameters())
    assert ops.launch_counts()["fused_adamw"] == 2 * n
    assert fam.variant_launches == {"fp32": 0, "fp32_ef": 2 * n,
                                    "master": 0, "master_ef": 0}
    for name, v in params["plain"].items():
        np.testing.assert_array_equal(params["kernel"][name], v, name)
