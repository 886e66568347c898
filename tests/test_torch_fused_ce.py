"""The port's fused linear + cross-entropy against paddle_tpu's, on the
CPU.

  * `plain_ce_rows` (the math of the Hopper kernel, what a CPU tensor
    takes) against the reference's Pallas `_ce_rows_pallas` in
    interpret mode and its jnp twin `_ce_rows_jnp`, with some labels
    negative or all of them, V = 300, 257 and 1, fp32 and bf16
    gradients;
  * the kernel's plan (csrc/cross_entropy_plan.cuh, built by the host's
    C++ compiler) held to its table, and `_launch`'s arguments to the
    C signature through a stand-in library;
  * `ops.fused_linear_cross_entropy` (loss, dh, dW, db) against the
    reference's `fused_linear_cross_entropy` with `use_pallas=True`
    (interpret) and `use_pallas=False`: ragged rows with `ignore_index`
    and a chunk that does not divide them, the tied-embedding
    `transpose_weight`, a bias, the online `vocab_chunk` variant, fp32
    and bf16;
  * the chunk loop's wiring: one `ce_rows` call per row chunk, on fp32
    logits, int32 labels and a one-element scale; the loss-only forward
    (nothing needs a gradient) equals the gradient forward's loss;
  * Llama under FLAGS_fused_ce: loss and gradients against
    `paddle_tpu` Llama under the same flag and against the port's own
    logits-path loss, untied and tied embeddings.  (The port is held
    against the reference's functions directly, not against its
    `TestNoMaterializedLogits`, which runs the fused path under
    `ShardedTrainStep`.)

Inputs are made from a seed with numpy and handed to both packages.
Tolerances, with their reasons:

  * fp32: the loss rtol 1e-5; gradients atol 1e-6 + rtol 1e-4 of each
    tensor's largest entry — the same fp32 math, matmuls and sums in
    other orders;
  * bf16 (hidden states and weight bf16, logits and statistics fp32):
    the loss rtol 1e-4; gradients 2^-6 of each tensor's largest entry
    (two bf16 ulps) — dlog and dh are rounded to bf16 at the same
    points, so a rounding flipped by an fp32 sum order differs by one
    ulp, and dW sums such terms;
  * rows: loss rows rtol 1e-5, fp32 dlog atol 1e-7 (entries <= scale),
    bf16 dlog one ulp (2^-7 relative) plus 1e-7.
"""
import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_cpu import one_cpu_thread  # noqa: F401 (autouse)

from paddle_tpu.framework.flags import set_flags as j_set_flags
from paddle_tpu.framework.tensor import Tensor as JTensor
from paddle_tpu.jit import _swapped_state
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.llama import llama_tiny_config as j_tiny
from paddle_tpu.ops.pallas import fused_cross_entropy as jfce

from paddle_tpu_torch import ops
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny_config,
                                     load_numpy_state_dict)
from paddle_tpu_torch.ops import _build

fce = ops.kernel_module("fused_cross_entropy")

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _grad_close(port, ref, dt, name):
    p, r = _np(port), _np(ref)
    big = float(np.abs(r).max())
    tol = 1e-6 + 1e-4 * big if dt == "float32" else 2.0 ** -6 * big
    np.testing.assert_allclose(p, r, atol=tol, rtol=0, err_msg=name)


# (dt, C, V, labels): "some" random labels with rows 0, 5 and 17 at -1,
# "all" every label -1 (scale 1); V = 257 and 1 are not multiples of a
# vector, V = 1 puts every label on the only column
ROWS_CASES = [
    pytest.param("float32", 24, 300, "some", id="float32"),
    pytest.param("bfloat16", 24, 300, "some", id="bfloat16"),
    pytest.param("float32", 24, 257, "some", id="float32-V257"),
    pytest.param("bfloat16", 24, 257, "some", id="bfloat16-V257"),
    pytest.param("float32", 24, 1, "some", id="float32-V1"),
    pytest.param("bfloat16", 24, 1, "some", id="bfloat16-V1"),
    pytest.param("float32", 24, 300, "all", id="float32-all-ignored"),
    pytest.param("bfloat16", 24, 257, "all", id="bfloat16-all-ignored"),
]


@pytest.mark.parametrize("dt,C,V,labels", ROWS_CASES)
def test_plain_ce_rows_matches_pallas_and_twin(dt, C, V, labels):
    rng = np.random.RandomState(0)
    x = (rng.randn(C, V) * 3).astype(np.float32)
    lbl = rng.randint(0, V, C).astype(np.int32)
    ignored = [0, 5, 17] if labels == "some" else list(range(C))
    lbl[ignored] = -1
    scale = np.float32(1.0 / max((lbl >= 0).sum(), 1))
    got = ops.plain_ce_rows(torch.from_numpy(x), torch.from_numpy(lbl),
                            torch.tensor(scale), TDT[dt])
    jx, jl, js = jnp.asarray(x), jnp.asarray(lbl), jnp.asarray(scale)
    for ref in (jfce._ce_rows_pallas(jx, jl, js, JDT[dt]),
                jfce._ce_rows_jnp(jx, jl, js, JDT[dt])):
        np.testing.assert_allclose(_np(got[0]), _np(ref[0]), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(
            _np(got[1]), _np(ref[1]), atol=1e-7,
            rtol=2.0 ** -7 if dt == "bfloat16" else 1e-6)
    assert got[1].dtype == TDT[dt]
    assert not _np(got[1])[ignored].any()
    assert not _np(got[0])[ignored].any()


@pytest.fixture(scope="module")
def ce_plan(tmp_path_factory):
    """The kernel library's plan of the cross-entropy rows
    (csrc/cross_entropy_plan.cuh), plain C++ built by the host's C++
    compiler: plan(V, rows, align) -> (body, VW, threads, cluster, slice,
    blocks), None where no body takes the shape."""
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "the plan test needs a C++ compiler"
    d = tmp_path_factory.mktemp("ce_plan")
    (d / "shim.cpp").write_text(
        '#include "cross_entropy_plan.cuh"\n'
        'extern "C" int plan(long long V, long long rows, int align,\n'
        '                    long long* out) {\n'
        '  ptt_ce::Plan p;\n'
        '  if (!ptt_ce::plan(V, rows, align, &p)) return 1;\n'
        '  out[0] = p.body; out[1] = p.VW; out[2] = p.threads;\n'
        '  out[3] = p.cluster; out[4] = p.slice; out[5] = p.blocks;\n'
        '  return 0;\n'
        '}\n')
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I",
                    str(_build.CSRC), str(d / "shim.cpp"), "-o",
                    str(d / "plan.so")], check=True)
    so = ctypes.CDLL(str(d / "plan.so"))
    so.plan.argtypes = [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_void_p]

    def plan(V, rows, align):
        out = (ctypes.c_longlong * 6)()
        if so.plan(V, rows, align, ctypes.addressof(out)):
            return None
        return tuple(out)
    return plan


ROWS, CLUSTER, WIDE = 0, 1, 2


@pytest.mark.parametrize("V,rows,align,want", [
    (8192, 1024, 4, (ROWS, 4, 256, 1, 2048, 1024)),         # training
    (8192, 1, 4, (ROWS, 4, 256, 1, 2048, 1)),               # one row
    (8191, 1024, 4, (ROWS, 1, 256, 1, 8191, 1024)),         # V % 4 != 0
    (8192, 1024, 1, (ROWS, 1, 256, 1, 8192, 1024)),         # logits x + 1
    (8192, 1024, 2, (ROWS, 2, 256, 1, 4096, 1024)),         # 8-byte aligned
    (8194, 64, 4, (ROWS, 2, 288, 1, 4097, 64)),             # V % 4 == 2
    (32000, 1024, 4, (CLUSTER, 4, 512, 2, 4000, 2048)),     # Llama-2
    (32000, 1024, 2, (CLUSTER, 2, 512, 2, 8000, 2048)),
    (50257, 256, 4, (CLUSTER, 1, 416, 4, 12565, 1024)),     # GPT-2
    (128256, 64, 4, (CLUSTER, 4, 512, 8, 4008, 512)),       # Llama 3
    (151936, 256, 4, (WIDE, 1, 256, 1, 0, 256)),            # Qwen2: wide
    (16384, 10, 4, (ROWS, 4, 512, 1, 4096, 10)),            # widest rows
    (16388, 10, 4, (CLUSTER, 4, 288, 2, 2049, 20)),         # one past
    (131072, 3, 4, (CLUSTER, 4, 512, 8, 4096, 24)),         # widest cluster
    (131072, 3, 1, (CLUSTER, 1, 512, 8, 16384, 24)),
    (131076, 3, 4, (WIDE, 1, 256, 1, 0, 3)),                # one past
    (257, 24, 4, (ROWS, 1, 32, 1, 257, 24)),                # one warp
    (1, 5, 4, (ROWS, 1, 32, 1, 1, 5)),
    (4096, 2 ** 31 - 1, 4, (ROWS, 4, 128, 1, 1024, 2 ** 31 - 1)),
    (0, 8, 4, None),
    (8192, 0, 4, None),
])
def test_ce_rows_plan(ce_plan, V, rows, align, want):
    """The cross-entropy rows kernel's plan (csrc/cross_entropy.cu's
    header table): the widest vector (4, 2 or 1 logits) that V and the
    addresses allow; 32 logits a thread in registers, so a block of <= 512
    threads holds 16384; a wider row splits into the fewest slices of
    that size, up to a cluster of 8; past that the wide body, a 256-thread
    block a row.  The card's SM count takes no part: a block is a row or a
    slice of one, and the grid rows x cluster blocks."""
    got = ce_plan(V, rows, align)
    assert got == want
    if got is None or got[0] == WIDE:
        return
    body, VW, threads, cluster, slice_, blocks = got
    vecs = V // VW
    assert threads % 32 == 0 and threads <= 512 and cluster <= 8
    assert threads * (32 // VW) >= slice_           # a slice in registers
    assert (threads - 32) * (32 // VW) < slice_     # the fewest warps
    assert cluster * slice_ >= vecs > (cluster - 1) * slice_   # none empty
    assert blocks == rows * cluster and (body == CLUSTER) == (cluster > 1)


def _view(ptr, shape, dtype):
    """A tensor over the CPU memory at address `ptr`."""
    n = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
    buf = (ctypes.c_char * n).from_address(ptr)
    return torch.frombuffer(buf, dtype=dtype).view(shape)


class _CELib:
    """Stands in for the kernel library's ptt_ce_rows: checks each call's
    arguments against `_build._SIGNATURES`, then writes the plain
    version's results where the outputs point."""

    CTYPE = {ctypes.c_void_p: int, ctypes.c_int: int, ctypes.c_longlong: int,
             ctypes.c_float: float}
    DTYPE = {code: dt for dt, code in _build.DTYPE_CODES.items()}

    def __init__(self):
        self.calls = []

    def ptt_ce_rows(self, *args):
        sig = _build._SIGNATURES["ptt_ce_rows"]
        assert len(args) == len(sig)
        for i, (a, c) in enumerate(zip(args, sig)):
            assert type(a) is self.CTYPE[c], (i, a, c)
        self.calls.append(args)
        dev, code, x, lbl, scale, loss, dlog, rows, V, stream = args
        dt = self.DTYPE[code]
        ref = fce.plain_ce_rows(_view(x, (rows, V), torch.float32),
                                _view(lbl, (rows,), torch.int32),
                                _view(scale, (1,), torch.float32), dt)
        _view(loss, (rows,), torch.float32).copy_(ref[0])
        _view(dlog, (rows, V), dt).copy_(ref[1])
        return 0


@pytest.mark.parametrize("dt,C,V,offset", [
    ("bfloat16", 8, 64, 0), ("float16", 5, 257, 0),    # V % 4 != 0
    ("float32", 3, 300, 1),                              # logits x + 1
    ("bfloat16", 4, 1, 2)])
def test_ce_rows_launch_marshalling(monkeypatch, dt, C, V, offset):
    """`_launch` as the card runs it, with the kernel library stood in
    for: one library call a launch, every argument in the C signature's
    order and type (the library picks body, vector width and cluster
    from the shape and the addresses, so no plan crosses; an offset
    logits pointer goes as it is), the outputs as the kernel wrote them,
    one launch counted."""
    lib = _CELib()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "cuda_device_index", lambda *t: 0)
    monkeypatch.setattr(_build, "stream_of", lambda d: 7)
    rng = np.random.RandomState(C + V)
    x = torch.from_numpy((rng.randn(C * V + offset) * 3)
                         .astype(np.float32))[offset:].view(C, V)
    lbl = torch.from_numpy(rng.randint(0, V, C).astype(np.int32))
    lbl[0] = -1
    scale = torch.tensor([1.0 / max(int((lbl >= 0).sum()), 1)])
    before = ops.launch_counts()["cross_entropy"]
    loss, dlog = fce._launch(x, lbl, scale, getattr(torch, dt))
    (args,) = lib.calls
    assert args == (0, _build.DTYPE_CODES[dlog.dtype], x.data_ptr(),
                    lbl.data_ptr(), scale.data_ptr(), loss.data_ptr(),
                    dlog.data_ptr(), C, V, 7)
    assert x.data_ptr() - x.untyped_storage().data_ptr() == 4 * offset
    assert loss.shape == (C,) and loss.dtype == torch.float32
    assert dlog.shape == (C, V) and dlog.dtype == getattr(torch, dt)
    want = fce.plain_ce_rows(x, lbl, scale, dlog.dtype)
    assert torch.equal(loss, want[0]) and torch.equal(dlog, want[1])
    assert ops.launch_counts()["cross_entropy"] == before + 1


CASES = {
    "ragged-ignore": dict(n=(2, 37), chunk_rows=16, ignore_index=3),
    "transpose": dict(n=(3, 20), transpose_weight=True),
    "bias": dict(n=(2, 30), bias=True, chunk_rows=8),
    "vocab-chunk": dict(n=(2, 25), vocab_chunk=64, chunk_rows=16),
}


def _case(name, dt, H=32, V=256, seed=1):
    c = dict(CASES[name])
    rng = np.random.RandomState(seed)
    b, s = c.pop("n")
    h = rng.randn(b, s, H).astype(np.float32)
    tw = c.get("transpose_weight", False)
    w = (rng.randn(*((V, H) if tw else (H, V))) / np.sqrt(H)) \
        .astype(np.float32)
    lbl = rng.randint(0, V, (b, s)).astype(np.int32)
    lbl[0, :4] = 3               # some rows hit ignore_index when set
    lbl[-1, -2:] = -1
    bias = (rng.randn(V) * 0.1).astype(np.float32) if c.pop("bias", False) \
        else None
    # bf16 operands: round them once so both packages see the same values
    h, w = (np.asarray(jnp.asarray(a).astype(JDT[dt]).astype(jnp.float32))
            for a in (h, w))
    return h, w, lbl, bias, c


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CASES))
def test_fused_linear_cross_entropy_matches_reference(name, dt):
    h, w, lbl, bias, kw = _case(name, dt)
    th = torch.tensor(h, dtype=TDT[dt], requires_grad=True)
    tw = torch.tensor(w, dtype=TDT[dt], requires_grad=True)
    tb = None if bias is None else torch.tensor(bias, requires_grad=True)
    loss = ops.fused_linear_cross_entropy(th, tw, torch.from_numpy(lbl),
                                          bias=tb, **kw)
    loss.backward()
    assert loss.dtype == torch.float32 and loss.shape == ()
    argnums = (0, 1) if bias is None else (0, 1, 2)
    for use_pallas in (True, False):
        def f(hh, ww, *bb):
            return jfce.fused_linear_cross_entropy(
                hh, ww, jnp.asarray(lbl), bias=bb[0] if bb else None,
                use_pallas=use_pallas, **kw)
        args = [jnp.asarray(h).astype(JDT[dt]),
                jnp.asarray(w).astype(JDT[dt])]
        if bias is not None:
            args.append(jnp.asarray(bias))
        jloss, jgrads = jax.value_and_grad(f, argnums=argnums)(*args)
        np.testing.assert_allclose(
            loss.item(), float(jloss),
            rtol=1e-5 if dt == "float32" else 1e-4)
        tgrads = [th.grad, tw.grad] + ([] if tb is None else [tb.grad])
        for nm, tg, jg in zip(("dh", "dW", "db"), tgrads, jgrads):
            assert tuple(tg.shape) == tuple(jg.shape), nm
            _grad_close(tg, jg, dt, f"{nm} use_pallas={use_pallas}")


def test_chunk_loop_wiring_and_loss_only_path(monkeypatch):
    h, w, lbl, bias, kw = _case("ragged-ignore", "float32")
    calls = []
    real = fce.ce_rows

    def recording(logits, labels, scale, out_dtype):
        calls.append((tuple(logits.shape), logits.dtype, labels.dtype,
                      labels.is_contiguous(), tuple(scale.shape)))
        return real(logits, labels, scale, out_dtype)

    monkeypatch.setattr(fce, "ce_rows", recording)
    th = torch.tensor(h, requires_grad=True)
    loss = ops.fused_linear_cross_entropy(th, torch.tensor(w),
                                          torch.from_numpy(lbl), **kw)
    # 74 rows in chunks of 16: 5 chunks, the last padded with label -1
    assert calls == [((16, 256), torch.float32, torch.int32, True,
                      (1,))] * 5
    with torch.no_grad():
        plain = ops.fused_linear_cross_entropy(
            torch.tensor(h), torch.tensor(w), torch.from_numpy(lbl), **kw)
    assert len(calls) == 5           # the loss-only forward runs no rows
    np.testing.assert_allclose(plain.item(), loss.item(), rtol=1e-6)
    # the upstream cotangent scales every gradient
    (3.0 * loss).backward()
    g3 = th.grad.clone()
    th.grad = None
    ops.fused_linear_cross_entropy(th, torch.tensor(w),
                                   torch.from_numpy(lbl), **kw).backward()
    np.testing.assert_allclose(g3.numpy(), 3.0 * th.grad.numpy(),
                               rtol=1e-6, atol=1e-9)


def test_not_ported_and_invalid_options_raise():
    h, w = torch.zeros(4, 8), torch.zeros(8, 16)
    lbl = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        ops.fused_linear_cross_entropy(h, w, lbl, axis_name="mp")
    with pytest.raises(ValueError, match="must divide"):
        ops.fused_linear_cross_entropy(h, w, lbl, vocab_chunk=5)
    from paddle_tpu_torch.nn.functional import fused_cross_entropy
    with pytest.raises(ValueError, match="needs weight"):
        fused_cross_entropy(torch.zeros(2, 3, 16),
                            torch.zeros(2, 3, dtype=torch.int64),
                            bias=torch.zeros(16))


LCFG = dict(dtype="float32", num_hidden_layers=2, num_key_value_heads=2)


def _llama_pair(tie, seed=4):
    cfg = dict(LCFG, tie_word_embeddings=tie)
    jm = JLlama(j_tiny(**cfg))
    rng = np.random.RandomState(seed)
    weights = {}
    for name, p in jm.state_dict().items():
        shape = tuple(p.shape)
        weights[name] = ((1.0 + 0.1 * rng.randn(*shape)) if len(shape) == 1
                         else rng.randn(*shape) / np.sqrt(shape[0])) \
            .astype(np.float32)
    jm.set_state_dict(weights)
    tm = LlamaForCausalLM(llama_tiny_config(**cfg), device="cpu")
    load_numpy_state_dict(tm, weights)
    return jm, tm


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_llama_fused_ce_matches_reference_and_legacy_loss(tie):
    jm, tm = _llama_pair(tie)
    ids = np.random.RandomState(5).randint(0, 512, (2, 48)).astype(np.int32)
    tids = torch.from_numpy(ids)
    # the port's legacy (logits) loss and grads
    legacy = tm.compute_loss(tm(tids), tids)
    legacy.backward()
    lgrads = {n: p.grad.clone() for n, p in tm.named_parameters()}
    tm.zero_grad(set_to_none=True)
    tflags.set_flags({"FLAGS_fused_ce": True})
    j_set_flags({"FLAGS_fused_ce": True})
    try:
        hidden = tm(tids)
        assert hidden.shape == (2, 48, 128)      # hidden states, no logits
        loss = tm.compute_loss(hidden, tids)
        loss.backward()
        names = [n for n, _ in jm.named_parameters()]
        vals = [jm.state_dict()[n]._value for n in names]

        def loss_of(param_vals):
            with _swapped_state(jm, names, list(param_vals)):
                out = jm(JTensor(jnp.asarray(ids)))
                return jm.compute_loss(out, JTensor(jnp.asarray(ids))).value

        jloss, jgrads = jax.value_and_grad(loss_of)(vals)
        tm.eval()
        assert tm(tids).shape == (2, 48, 512)    # eval: logits again
    finally:
        tflags.set_flags({"FLAGS_fused_ce": False})
        j_set_flags({"FLAGS_fused_ce": False})
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(loss.item(), legacy.item(), rtol=1e-5)
    tgrads = dict(tm.named_parameters())
    for n, g in zip(names, jgrads):
        _grad_close(tgrads[n].grad, g, "float32", f"{n} vs reference")
        _grad_close(tgrads[n].grad, lgrads[n], "float32", f"{n} vs legacy")
