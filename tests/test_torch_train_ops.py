"""The training ops of paddle_tpu_torch against paddle_tpu's, on the CPU.

For flash attention, RMSNorm, the fused residual-add + RMSNorm and the
RoPE backward:

  * the port's plain forward (what a CPU tensor takes) and its native
    autograd are held against the reference's jnp twin under `jax.vjp`;
  * the port's plain backward functions (the math of the Hopper
    backward kernels) are held against `jax.vjp` of the reference's
    Pallas kernels run in interpret mode, as tests/test_pallas_kernels.py
    runs them;
  * each `torch.autograd.Function` that carries a kernel on the card is
    run here with its `_launch*` functions replaced by the plain ones:
    its gradients must equal native autograd of the plain forward, which
    checks the saved tensors, the sin swap and the dw reduction without
    a card;
  * the flash wrappers `_launch_fwd` / `_launch_bwd` run against a
    stand-in for the kernel library: every argument against the C
    signature, out passed to the backward, delta allocated fp32
    [b, h, sq] and filled by the (stand-in) kernel, not by PyTorch;
  * chip_smoke.py's flash check at fp16 passes a weight rounding at
    another point and refuses one at bf16 (float64 twins).

Inputs are made from a seed with numpy and handed to both packages.
Tolerances, with their reasons:

  * fp32: atol = rtol = 1e-5 (2e-5 for attention gradients, which sum
    over a sequence and a GQA group; atol 1e-4 for dw and the cos/sin
    cotangents, sums over every row of entries of size ~1) — the same
    fp32 arithmetic in other reduction orders moves results by a few
    ulps;
  * bf16, plain backward vs the Pallas kernel: 2^-6 of the largest
    entry (two bf16 ulps) — both round at the same points, so only a
    rounding flipped by the sum order can differ, by one ulp of an
    entry (or of a p / ds term, for attention);
  * bf16 forward RMSNorm vs Pallas: 2^-6 of the largest entry — the
    plain version rounds before `* w`, the kernel after;
  * bf16 RoPE backward vs Pallas: 2^-7 (one ulp) — the same products
    and sums, each rounded once;
  * bf16 attention forward: 2^-7 against the twin (the same math), 2^-5
    against the Pallas kernel, which rounds the unnormalised p before
    P.V and divides after, where the twin rounds the normalised
    weights — every term of the sum carries its own one-ulp difference.
"""
import ctypes
import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_cpu import one_cpu_thread  # noqa: F401 (autouse)

import paddle_tpu.ops as jops
from paddle_tpu.ops.pallas.flash_attention import \
    flash_attention as pallas_flash_attention
from paddle_tpu.ops.pallas.rms_norm import \
    fused_add_rms_norm as pallas_fused_add_rms_norm
from paddle_tpu.ops.pallas.rms_norm import rms_norm as pallas_rms_norm
from paddle_tpu.ops.pallas.rope import rope_apply as pallas_rope_apply

import paddle_tpu_torch.ops as tops
from paddle_tpu_torch.ops import _build

F32 = dict(atol=1e-5, rtol=1e-5)
DT = {"float32": (torch.float32, jnp.float32),
      "bfloat16": (torch.bfloat16, jnp.bfloat16)}
EPS = 1e-5


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _t(a, dt):
    return torch.from_numpy(a).to(DT[dt][0])


def _j(a, dt):
    return jnp.asarray(a).astype(DT[dt][1])


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(port, ref, dt, rel=2.0 ** -6, **f32):
    p, r = _np(port), _np(ref)
    if dt == "float32":
        np.testing.assert_allclose(p, r, **(f32 or F32))
    else:
        np.testing.assert_allclose(p, r, atol=rel * np.abs(r).max(), rtol=0)


def _leaf(a):
    return torch.from_numpy(a.copy()).requires_grad_(True)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,H", [(16, 128), (24, 256)])
def test_rms_norm_forward_and_backward(dt, rows, H):
    rng = np.random.RandomState(rows + H)
    x, w, g = _rand(rng, rows, H), 1 + 0.1 * _rand(rng, H), _rand(rng, rows, H)
    jx, jw, jg = _j(x, dt), _j(w, dt), _j(g, dt)
    out, vjp = jax.vjp(lambda a, b: pallas_rms_norm(a, b, EPS), jx, jw)
    jdx, jdw = vjp(jg)
    _close(tops.plain_rms_norm(_t(x, dt), _t(w, dt), EPS), out, dt)
    dx, dw = tops.plain_rms_norm_bwd(_t(x, dt), _t(w, dt), _t(g, dt), EPS)
    _close(dx, jdx, dt)
    _close(dw, jdw, dt)
    if dt == "float32":
        # native autograd of the plain forward against the jnp twin
        tx, tw = _leaf(x), _leaf(w)
        (tops.plain_rms_norm(tx, tw, EPS) * torch.from_numpy(g)).sum() \
            .backward()
        _, vjp_x = jax.vjp(lambda a, b: jops.xla_rms_norm(a, b, EPS), jx, jw)
        rdx, rdw = vjp_x(jg)
        _close(tx.grad, rdx, dt)
        _close(tw.grad, rdw, dt, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_fused_add_rms_norm(dt):
    rng = np.random.RandomState(7)
    rows, H = 32, 128
    x, y = _rand(rng, rows, H), _rand(rng, rows, H)
    w = 1 + 0.1 * _rand(rng, H)
    gr, go = _rand(rng, rows, H), _rand(rng, rows, H)
    tx, ty = _t(x, dt), _t(y, dt)
    resid, out = tops.plain_fused_add_rms_norm(tx, ty, _t(w, dt), EPS)
    assert torch.equal(resid, tx + ty)            # bit-identical residual
    (jr, jo), vjp = jax.vjp(
        lambda a, b, c: pallas_fused_add_rms_norm(a, b, c, EPS),
        _j(x, dt), _j(y, dt), _j(w, dt))
    np.testing.assert_array_equal(_np(resid), _np(jr))
    _close(out, jo, dt)
    jdx, jdy, jdw = vjp((_j(gr, dt), _j(go, dt)))
    dres, dw = tops.plain_rms_norm_bwd(resid, _t(w, dt), _t(go, dt), EPS,
                                       g_resid=_t(gr, dt))
    _close(dres, jdx, dt)
    _close(dres, jdy, dt)
    _close(dw, jdw, dt, atol=1e-4, rtol=1e-5)
    if dt == "float32":
        lx, ly, lw = _leaf(x), _leaf(y), _leaf(w)
        r, o = tops.plain_fused_add_rms_norm(lx, ly, lw, EPS)
        ((r * torch.from_numpy(gr)).sum() + (o * torch.from_numpy(go)).sum()) \
            .backward()
        _, vjp_x = jax.vjp(
            lambda a, b, c: jops.xla_fused_add_rms_norm(a, b, c, EPS),
            _j(x, dt), _j(y, dt), _j(w, dt))
        rdx, rdy, rdw = vjp_x((_j(gr, dt), _j(go, dt)))
        _close(lx.grad, rdx, dt)
        _close(ly.grad, rdy, dt)
        _close(lw.grad, rdw, dt, atol=1e-4, rtol=1e-5)


# ---------------------------------------------------------------------------
# RoPE backward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_slot", [False, True])
def test_rope_backward_asymmetric_sin_halves(dt, per_slot):
    """sin tables whose halves differ: the adjoint must swap them."""
    rng = np.random.RandomState(3 + per_slot)
    b, s, h, hk, d = 2, 16, 4, 2, 16
    q, k = _rand(rng, b, s, h, d), _rand(rng, b, s, hk, d)
    shape = (b, s, d) if per_slot else (s, d)
    cos, sin = _rand(rng, *shape), _rand(rng, *shape)
    gq, gk = _rand(rng, b, s, h, d), _rand(rng, b, s, hk, d)
    jc, js = jnp.asarray(cos), jnp.asarray(sin)
    _, vjp = jax.vjp(lambda a, c: pallas_rope_apply(a, c, jc, js),
                     _j(q, dt), _j(k, dt))
    jdq, jdk = vjp((_j(gq, dt), _j(gk, dt)))
    dq, dk = tops.plain_rope_bwd(_t(gq, dt), _t(gk, dt),
                                 torch.from_numpy(cos), torch.from_numpy(sin))
    _close(dq, jdq, dt, rel=2.0 ** -7)
    _close(dk, jdk, dt, rel=2.0 ** -7)
    if dt == "float32":
        # the cos/sin cotangents too, against the twin's autodiff
        lq, lk, lc, ls = _leaf(q), _leaf(k), _leaf(cos), _leaf(sin)
        oq, ok = tops.plain_apply_rope(lq, lk, lc, ls)
        ((oq * torch.from_numpy(gq)).sum() + (ok * torch.from_numpy(gk)).sum()) \
            .backward()
        _, vjp_x = jax.vjp(jops.apply_rope, _j(q, dt), _j(k, dt), jc, js)
        for port, ref in zip((lq.grad, lk.grad, lc.grad, ls.grad),
                             vjp_x((_j(gq, dt), _j(gk, dt)))):
            _close(port, ref, dt, atol=1e-4, rtol=1e-5)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
# the Pallas kernels' and the twin's vjp, jitted: one compile a shape,
# not one an interpreted grid step or op
@functools.partial(jax.jit, static_argnames="causal")
def _pallas_flash_vjp(q, k, v, do, causal):
    out, vjp = jax.vjp(lambda a, c, e: pallas_flash_attention(
        a, c, e, causal=causal, block_q=16, block_k=16), q, k, v)
    return out, vjp(do)


@functools.partial(jax.jit, static_argnames="causal")
def _twin_vjp(q, k, v, do, causal):
    out, vjp = jax.vjp(lambda a, c, e: jops.xla_attention(
        a, c, e, causal=causal), q, k, v)
    return out, vjp(do)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("group,d", [(1, 64), (2, 128), (5, 64)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention(dt, group, d, causal):
    rng = np.random.RandomState(group * d + causal)
    b, s, hk = 1, 32, 2
    h = hk * group
    q, k, v = _rand(rng, b, s, h, d), _rand(rng, b, s, hk, d), \
        _rand(rng, b, s, hk, d)
    do = _rand(rng, b, s, h, d)
    jq, jk, jv = _j(q, dt), _j(k, dt), _j(v, dt)
    jout, jgrads = _pallas_flash_vjp(jq, jk, jv, _j(do, dt), causal)
    tq, tk, tv = _t(q, dt), _t(k, dt), _t(v, dt)
    out, lse = tops.plain_flash_fwd(tq, tk, tv, causal)
    _close(out, jout, dt, rel=2.0 ** -5)
    _close(out, jops.xla_attention(jq, jk, jv, causal=causal), dt,
           rel=2.0 ** -7)
    # the backward kernels' math against the Pallas kernels', on the
    # Pallas forward's output
    t_out = torch.from_numpy(np.array(_np(jout))).to(DT[dt][0])
    grads = tops.plain_flash_bwd(tq, tk, tv, t_out, lse, _t(do, dt), causal)
    for port, ref in zip(grads, jgrads):
        _close(port, ref, dt, atol=2e-5, rtol=2e-5)
    if dt == "float32":
        lq, lk, lv = _leaf(q), _leaf(k), _leaf(v)
        (tops.plain_attention(lq, lk, lv, causal=causal)
         * torch.from_numpy(do)).sum().backward()
        _, xgrads = _twin_vjp(jq, jk, jv, _j(do, dt), causal)
        for port, ref in zip((lq.grad, lk.grad, lv.grad), xgrads):
            _close(port, ref, dt, atol=2e-5, rtol=2e-5)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("which", ["out", "dq"])
def test_flash_tolerances_refuse_a_bf16_rounding_at_fp16(which):
    """chip_smoke's check of the flash kernels at fp16, on float64 twins
    of `out` = sum_j p_j v_j and dq = sum_j ds_j k_j: a twin that keeps
    the weights in fp32 (a rounding at another point, as the kernel's)
    passes the per-element tolerance and the mean square / variance
    bound; one that rounds them to bf16 passes the per-element
    tolerance (8 standard deviations a side exceed the 8x between the
    unit roundoffs) but fails the mean square bound."""
    cs = _chip_smoke()
    fa = tops.kernel_module("flash_attention")
    rng = np.random.RandomState(7)
    b, s, h, hk, d, f16 = 2, 200, 4, 2, 64, torch.float16
    q, k, v, do = (torch.from_numpy(_rand(rng, b, s, n, d)).to(f16)
                   for n in (h, hk, hk, h))
    sc = d ** -0.5
    S = fa._masked_scores(q, k, True, sc)
    lse = torch.logsumexp(S, -1)
    P = torch.exp(S - lse[..., None])
    out, _ = tops.plain_flash_fwd(q, k, v, True, sc)
    refs = tops.plain_flash_bwd(q, k, v, out, lse, do, True, sc)
    pairs = cs._flash_tolerances(torch, tops, fa, q, k, v, out, lse, do,
                                 [out, *refs], sc, True)
    if which == "out":
        w, x, ref, (tol, var) = P, v, out, pairs[0]
    else:
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
        w = P * (tops.gqa_scores(do, v) - delta[..., None]) * sc
        x, ref, (tol, var) = k, refs[0], pairs[1]

    def twin(dtype):
        return tops.gqa_weighted_v(w.to(dtype).double(), x.double()) \
            .transpose(1, 2).to(f16)

    for dtype, msq_ok in ((torch.float32, True), (torch.bfloat16, False)):
        err = (twin(dtype).double() - ref.double()).abs()
        assert float((err / tol).max()) <= 1.0, dtype
        assert (float((err ** 2 / var).mean()) <= 1.0) == msq_ok, dtype


def _view(ptr, shape, dtype):
    """A tensor over the CPU memory at address `ptr`, as a kernel
    handed that pointer would address it."""
    n = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
    buf = (ctypes.c_char * n).from_address(ptr)
    return torch.frombuffer(buf, dtype=dtype).view(shape)


class _FlashLib:
    """Stands in for the kernel library's flash entry points: checks
    each call's arguments against `_build._SIGNATURES`, then fills the
    memory it was pointed at as the kernels do, with the plain math.
    The backward computes delta = rowsum(dO·O) itself."""

    CTYPE = {ctypes.c_void_p: int, ctypes.c_int: int, ctypes.c_float: float}
    DTYPE = {code: dt for dt, code in _build.DTYPE_CODES.items()}

    def __init__(self):
        self.calls = []

    def _record(self, name, args):
        sig = _build._SIGNATURES[name]
        assert len(args) == len(sig), name
        for i, (a, c) in enumerate(zip(args, sig)):
            assert type(a) is self.CTYPE[c] or (
                a is None and c is ctypes.c_void_p), (name, i, a, c)
        self.calls.append((name, args))

    def ptt_flash_fwd(self, *args):
        self._record("ptt_flash_fwd", args)
        dev, code, q, k, v, bias, rng, out, lse, b, sq, sk, h, hk, d, \
            bstride, scale, causal, stream = args
        assert bias is None and rng is None and bstride == 0     # no mask
        dt = self.DTYPE[code]
        o, l = tops.plain_flash_fwd(
            _view(q, (b, sq, h, d), dt), _view(k, (b, sk, hk, d), dt),
            _view(v, (b, sk, hk, d), dt), bool(causal), scale)
        _view(out, (b, sq, h, d), dt).copy_(o)
        _view(lse, (b, h, sq), torch.float32).copy_(l)
        return 0

    def ptt_flash_bwd(self, *args):
        self._record("ptt_flash_bwd", args)
        dev, code, q, k, v, bias, rng, out, dout, lse, delta, dq, dk, dv, b, \
            sq, sk, h, hk, d, bstride, scale, causal, stream = args
        assert bias is None and rng is None and bstride == 0     # no mask
        dt = self.DTYPE[code]
        qs, ks = (b, sq, h, d), (b, sk, hk, d)
        o, g = _view(out, qs, dt), _view(dout, qs, dt)
        dl = _view(delta, (b, h, sq), torch.float32)
        assert torch.isnan(dl).all()     # nothing filled it before the kernel
        dl.copy_((g.float() * o.float()).sum(-1).transpose(1, 2))
        grads = tops.plain_flash_bwd(
            _view(q, qs, dt), _view(k, ks, dt), _view(v, ks, dt), o,
            _view(lse, (b, h, sq), torch.float32), g, bool(causal), scale)
        for ptr, shape, grad in zip((dq, dk, dv), (qs, ks, ks), grads):
            _view(ptr, shape, dt).copy_(grad)
        return 0


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_launch_marshalling(monkeypatch, dt, causal):
    """`_launch_fwd` and `_launch_bwd` as the card runs them, with the
    kernel library stood in for: the arguments in the C signature's
    order and types, out passed to the backward, delta fp32 [b, h, sq]
    scratch that the kernel fills, outputs shaped and typed as before."""
    fa = tops.kernel_module("flash_attention")
    lib = _FlashLib()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "cuda_device_index", lambda *t: 0)
    monkeypatch.setattr(_build, "stream_of", lambda d: 0)
    empty, made = torch.empty, []

    def nan_empty(*shape, **kw):        # fresh allocations start as NaN
        t = empty(*shape, **kw)
        made.append(t.fill_(float("nan")) if t.is_floating_point() else t)
        return t

    monkeypatch.setattr(torch, "empty", nan_empty)
    rng = np.random.RandomState(7)
    b, s, h, hk, d = 2, 24, 4, 2, 64
    q, do = _t(_rand(rng, b, s, h, d), dt), _t(_rand(rng, b, s, h, d), dt)
    k, v = _t(_rand(rng, b, s, hk, d), dt), _t(_rand(rng, b, s, hk, d), dt)
    before = tops.launch_counts()
    keys = fa._key_bias(None, q, k, causal)
    out, lse = fa._launch_fwd(q, k, v, causal, 0.125, keys)
    dq, dk, dv = fa._launch_bwd(q, k, v, out, lse, do, causal, 0.125, keys)
    (fwd, af), (bwd, ab) = lib.calls
    code = _build.DTYPE_CODES[DT[dt][0]]
    assert (fwd, bwd) == ("ptt_flash_fwd", "ptt_flash_bwd")
    assert af == (0, code, q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                  None, out.data_ptr(), lse.data_ptr(), b, s, s, h, hk, d, 0,
                  0.125, int(causal), 0)
    delta, = [t for t in made if t.data_ptr() == ab[10]]
    assert ab == (0, code, q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                  None, out.data_ptr(), do.data_ptr(), lse.data_ptr(),
                  delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), b, s, s, h, hk, d, 0, 0.125, int(causal), 0)
    assert delta.shape == (b, h, s) and delta.dtype == torch.float32
    torch.testing.assert_close(
        delta, (do.float() * out.float()).sum(-1).transpose(1, 2),
        atol=0, rtol=0)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    for g, x in zip((dq, dk, dv), (q, k, v)):
        assert g.shape == x.shape and g.dtype == x.dtype
    want = tops.plain_flash_bwd(q, k, v, out, lse, do, causal, 0.125)
    for g, w in zip((dq, dk, dv), want):
        assert torch.equal(g, w)
    after = tops.launch_counts()
    assert after["flash_attention"] == before["flash_attention"] + 1
    assert after["flash_attention_bwd"] == before["flash_attention_bwd"] + 1


class _RmsBwdLib:
    """Stands in for the kernel library's RMSNorm backward: checks each
    call's arguments against `_build._SIGNATURES`, then writes dx and dw
    where it was pointed, as the kernel and its reduction do, with the
    plain math.  The grid query answers `blocks`."""

    CTYPE = {ctypes.c_void_p: int, ctypes.c_int: int, ctypes.c_longlong: int,
             ctypes.c_float: float}
    DTYPE = {code: dt for dt, code in _build.DTYPE_CODES.items()}

    def __init__(self, blocks):
        self.blocks = blocks
        self.calls = []

    def _record(self, name, args):
        sig = _build._SIGNATURES[name]
        assert len(args) == len(sig), name
        for i, (a, c) in enumerate(zip(args, sig)):
            assert type(a) is self.CTYPE[c] or (
                a is None and c is ctypes.c_void_p), (name, i, a, c)
        self.calls.append((name, args))

    def ptt_rms_norm_bwd_blocks(self, *args):
        self._record("ptt_rms_norm_bwd_blocks", args)
        return self.blocks

    def ptt_rms_norm_bwd(self, *args):
        self._record("ptt_rms_norm_bwd", args)
        dev, code, x, w, g, gr, dx, part, dw, rows, H, vec, blocks, eps, \
            stream = args
        dt = self.DTYPE[code]
        p = _view(part, (blocks, H), torch.float32)
        assert torch.isnan(p).all()      # scratch, the kernel's to fill
        ref = tops.plain_rms_norm_bwd(
            _view(x, (rows, H), dt), _view(w, (H,), dt),
            _view(g, (rows, H), dt), eps,
            None if gr is None else _view(gr, (rows, H), dt))
        _view(dx, (rows, H), dt).copy_(ref[0])
        _view(dw, (H,), dt).copy_(ref[1])
        return 0


def test_rms_bwd_grid_query_error_stops_the_launch(monkeypatch):
    """A shape no body takes (the library's grid query answers a CUDA
    error, negated) raises before any scratch is made or kernel
    launched."""
    rn = tops.kernel_module("rms_norm")
    lib = _RmsBwdLib(blocks=-1)          # -cudaErrorInvalidValue
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "cuda_device_index", lambda *t: 0)
    x = torch.zeros((2, 58080), dtype=torch.bfloat16)
    w = torch.ones(58080, dtype=torch.bfloat16)
    before = tops.launch_counts()["rms_norm_bwd"]
    with pytest.raises(RuntimeError, match="grid query.*CUDA error 1"):
        rn._launch_bwd(x, w, x, None, EPS)
    assert [c[0] for c in lib.calls] == ["ptt_rms_norm_bwd_blocks"]
    assert tops.launch_counts()["rms_norm_bwd"] == before


@pytest.mark.parametrize("resid", [False, True])
@pytest.mark.parametrize("dt,H,offset", [
    ("bfloat16", 2560, 0), ("bfloat16", 4096, 0), ("bfloat16", 8192, 0),
    ("bfloat16", 1003, 0), ("bfloat16", 2560, 1), ("bfloat16", 58079, 0),
    ("float32", 2560, 0)])
def test_rms_bwd_launch_marshalling(monkeypatch, resid, dt, H, offset):
    """`_launch_bwd` as the card runs it, with the kernel library stood
    in for: the grid query and then the launch, with arguments in the C
    signatures' order and types; the 16-byte vector path only for an
    aligned H that is a multiple of 16 bytes (H 1003 and an unaligned x
    take the element path); fp32 dw_part [blocks, H] scratch sized by
    the query's answer that PyTorch never sums; dx and dw as the kernel
    wrote them; one launch counted."""
    rn = tops.kernel_module("rms_norm")
    lib = _RmsBwdLib(blocks=5)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "cuda_device_index", lambda *t: 0)
    monkeypatch.setattr(_build, "stream_of", lambda d: 0)
    empty, made = torch.empty, []

    def nan_empty(*shape, **kw):        # fresh allocations start as NaN
        t = empty(*shape, **kw)
        made.append(t.fill_(float("nan")))
        return t

    monkeypatch.setattr(torch, "empty", nan_empty)
    tdt = DT[dt][0]
    rng = np.random.RandomState(H + offset)
    rows = 6

    def operand(*shape):                # `offset` elements into its storage
        n = int(np.prod(shape))
        return _t(_rand(rng, n + offset), dt)[offset:].view(shape)

    x, g = operand(rows, H), operand(rows, H)
    gr = operand(rows, H) if resid else None
    w = _t(1 + 0.1 * _rand(rng, H), dt)
    name = "fused_add_rms_norm_bwd" if resid else "rms_norm_bwd"
    before = tops.launch_counts()[name]
    dx, dw = rn._launch_bwd(x, w, g, gr, EPS)
    (qname, qargs), (bname, bargs) = lib.calls
    vec = int(offset == 0 and H % (16 // x.element_size()) == 0)
    code = _build.DTYPE_CODES[tdt]
    assert (qname, bname) == ("ptt_rms_norm_bwd_blocks", "ptt_rms_norm_bwd")
    assert qargs == (0, code, H, vec, int(resid), rows)
    part, = [t for t in made if t.data_ptr() == bargs[7]]
    assert part.shape == (5, H) and part.dtype == torch.float32
    assert bargs == (0, code, x.data_ptr(), w.data_ptr(), g.data_ptr(),
                     None if gr is None else gr.data_ptr(), dx.data_ptr(),
                     part.data_ptr(), dw.data_ptr(), rows, H, vec, 5, EPS, 0)
    assert torch.isnan(part).all()      # no PyTorch reduction read it
    assert dx.shape == x.shape and dx.dtype == tdt
    assert dw.shape == (H,) and dw.dtype == tdt
    want = tops.plain_rms_norm_bwd(x, w, g, EPS, gr)
    assert torch.equal(dx, want[0]) and torch.equal(dw, want[1])
    assert tops.launch_counts()[name] == before + 1


@pytest.mark.parametrize("dt", ["float16", "float32"])
def test_rms_bwd_tolerances_refuse_a_bf16_rounding(dt):
    """chip_smoke's per-element check of the RMSNorm backward at fp16
    and fp32: the plain result passes, and so does the same math in
    float64 rounded once (a rounding at another point); a body that
    rounded dx, x or g through bf16 on the way fails it."""
    cs = _chip_smoke()
    tdt = getattr(torch, dt)
    rng = np.random.RandomState(11)
    rows, H = 256, 1024
    x, g, gr = (torch.from_numpy(_rand(rng, rows, H)).to(tdt)
                for _ in range(3))
    w = torch.from_numpy(1 + 0.1 * _rand(rng, H)).to(tdt)
    bf = torch.bfloat16

    def through_bf16(t):
        return t.to(bf).to(tdt)

    for resid in (None, gr):
        dx, dw = tops.plain_rms_norm_bwd(x, w, g, EPS, resid)
        tol_dx, tol_dw = cs._rms_bwd_tolerances(torch, x, w, g, dx, dw, EPS)

        def fits(got, ref, tol):
            return bool(((got.double() - ref.double()).abs()
                         <= tol.double()).all())

        d64 = tops.plain_rms_norm_bwd(x.double(), w.double(), g.double(),
                                      EPS, None if resid is None
                                      else resid.double())
        assert fits(d64[0].to(tdt), dx, tol_dx)
        assert fits(d64[1].to(tdt), dw, tol_dw)
        assert not fits(through_bf16(dx), dx, tol_dx)
        for bx, bg in ((through_bf16(x), g), (x, through_bf16(g))):
            got = tops.plain_rms_norm_bwd(bx, w, bg, EPS, resid)[0]
            assert not fits(got, dx, tol_dx)


@pytest.mark.parametrize("mask_kind", ["bool", "additive"])
def test_plain_attention_masks_and_cross_causal(mask_kind):
    """The twin's other arguments: a mask, and causal with sq != sk
    masked bottom-right."""
    rng = np.random.RandomState(11)
    q, k, v = _rand(rng, 2, 6, 4, 16), _rand(rng, 2, 9, 2, 16), \
        _rand(rng, 2, 9, 2, 16)
    m = rng.rand(2, 1, 6, 9) > 0.3
    m[..., 0] = True
    mask = m if mask_kind == "bool" else np.where(m, 0.0, -5.0) \
        .astype(np.float32)
    for causal in (False, True):
        port = tops.plain_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v),
                                    torch.from_numpy(mask), causal)
        ref = jops.xla_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(mask), causal)
        _close(port, ref, "float32")


# ---------------------------------------------------------------------------
# wiring: the autograd Functions, their kernels replaced by the plain math
# ---------------------------------------------------------------------------
def _grads(fn, leaves, cot):
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    sum((o * c).sum() for o, c in zip(outs, cot)).backward()
    got = [t.grad.clone() for t in leaves]
    for t in leaves:
        t.grad = None
    return got


def test_rms_norm_function_wiring(monkeypatch):
    rn = tops.kernel_module("rms_norm")
    monkeypatch.setattr(rn, "_launch", tops.plain_rms_norm)
    monkeypatch.setattr(rn, "_launch_bwd", lambda x, w, g, gr, eps:
                        tops.plain_rms_norm_bwd(x, w, g, eps, gr))
    monkeypatch.setattr(rn, "_launch_add", tops.plain_fused_add_rms_norm)
    rng = np.random.RandomState(0)
    x, y, w = _rand(rng, 12, 64), _rand(rng, 12, 64), 1 + 0.1 * _rand(rng, 64)
    c1, c2 = torch.from_numpy(_rand(rng, 12, 64)), \
        torch.from_numpy(_rand(rng, 12, 64))
    leaves = [_leaf(x), _leaf(w)]
    got = _grads(lambda a, b: rn._RMSNorm.apply(a, b, EPS), leaves, [c1])
    want = _grads(lambda a, b: tops.plain_rms_norm(a, b, EPS), leaves, [c1])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **F32)
    leaves = [_leaf(x), _leaf(y), _leaf(w)]
    got = _grads(lambda a, b, c: rn._FusedAddRMSNorm.apply(a, b, c, EPS),
                 leaves, [c1, c2])
    want = _grads(lambda a, b, c: tops.plain_fused_add_rms_norm(a, b, c, EPS),
                  leaves, [c1, c2])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **F32)


@pytest.mark.parametrize("per_slot", [False, True])
def test_rope_function_wiring(monkeypatch, per_slot):
    ro = tops.kernel_module("rope")
    monkeypatch.setattr(ro, "_launch", lambda q, k, c, s, neg_sin=False:
                        tops.plain_apply_rope(q, k, c, -s if neg_sin else s))
    rng = np.random.RandomState(1)
    b, s, d = 2, 5, 8
    shape = (b, s, d) if per_slot else (s, d)
    q, k = _rand(rng, b, s, 3, d), _rand(rng, b, s, 1, d)
    cos, sin = _rand(rng, *shape), _rand(rng, *shape)
    cot = [torch.from_numpy(_rand(rng, b, s, 3, d)),
           torch.from_numpy(_rand(rng, b, s, 1, d))]
    leaves = [_leaf(q), _leaf(k), _leaf(cos), _leaf(sin)]
    got = _grads(ro._Rope.apply, leaves, cot)
    want = _grads(tops.plain_apply_rope, leaves, cot)
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a, b_, **F32)
    # with tables that need no gradient, q and k are not kept
    ql, kl = _leaf(q), _leaf(k)
    oq, ok = ro._Rope.apply(ql, kl, torch.from_numpy(cos),
                            torch.from_numpy(sin))
    assert len(oq.grad_fn.saved_tensors) == 2


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_function_wiring(monkeypatch, causal):
    fa = tops.kernel_module("flash_attention")
    # the launches take the call's keys (`_key_bias`), the plain
    # versions its mask
    monkeypatch.setattr(fa, "_launch_fwd", lambda *a:
                        tops.plain_flash_fwd(*a[:-1], a[-1].mask))
    monkeypatch.setattr(fa, "_launch_bwd", lambda *a:
                        tops.plain_flash_bwd(*a[:-1], a[-1].mask))
    rng = np.random.RandomState(2)
    q, k, v = _rand(rng, 2, 24, 4, 64), _rand(rng, 2, 24, 2, 64), \
        _rand(rng, 2, 24, 2, 64)
    cot = [torch.from_numpy(_rand(rng, 2, 24, 4, 64))]
    leaves = [_leaf(q), _leaf(k), _leaf(v)]
    got = _grads(lambda a, b, c: fa._FlashAttention.apply(a, b, c, causal,
                                                          0.125),
                 leaves, cot)
    want = _grads(lambda a, b, c: tops.plain_attention(a, b, c,
                                                       causal=causal),
                  leaves, cot)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)


def _meta(*shape):
    return torch.zeros(shape, device="meta")


@pytest.mark.parametrize("mod,launch,outs,function,call", [
    ("rms_norm", "_launch", 1, "_RMSNorm",
     lambda m, t: m.rms_norm(t, _meta(8))),
    ("rms_norm", "_launch_add", 2, "_FusedAddRMSNorm",
     lambda m, t: m.fused_add_rms_norm(t, _meta(4, 8), _meta(8))[1]),
    ("rope", "_launch", 2, "_Rope",
     lambda m, t: m.apply_rope(t, _meta(4, 1, 8), _meta(4, 8),
                               _meta(4, 8))[0]),
], ids=["rms_norm", "fused_add_rms_norm", "rope"])
def test_wrapper_skips_the_function_without_a_graph(monkeypatch, mod, launch,
                                                     outs, function, call):
    """Off the CPU (a meta tensor stands in for the card's here) the
    wrapper launches the forward kernel directly when no graph is
    recorded, as in the decode loop, and goes through its
    autograd.Function, whose backward is a kernel too, when one is."""
    m = tops.kernel_module(mod)

    def fake_launch(x, *args):
        return torch.empty_like(x) if outs == 1 else \
            (torch.empty_like(x),) * outs

    monkeypatch.setattr(m, launch, fake_launch)
    x = _meta(4, 8) if mod == "rms_norm" else _meta(4, 4, 2, 8)
    with torch.inference_mode():
        assert call(m, x).grad_fn is None
    x.requires_grad_()
    with torch.no_grad():
        assert call(m, x).grad_fn is None
    assert type(call(m, x).grad_fn).__name__ == function + "Backward"


@pytest.mark.parametrize("call,err,match", [
    (lambda: tops.attention(_meta(1, 4, 2, 64), _meta(1, 4, 2, 64),
                            _meta(1, 4, 2, 64), mask=_meta(1, 1, 4, 4)),
     ValueError, "key-padding mask"),
    (lambda: tops.attention(_meta(1, 4, 2, 64), _meta(1, 4, 2, 64),
                            _meta(1, 4, 2, 64), dropout_p=0.1),
     NotImplementedError, "dropout"),
    (lambda: tops.attention(_meta(1, 4, 2, 36), _meta(1, 6, 2, 36),
                            _meta(1, 6, 2, 36), causal=True), ValueError,
     "head_dim 8-256"),
    (lambda: tops.attention(_meta(1, 4, 2, 264), _meta(1, 4, 2, 264),
                            _meta(1, 4, 2, 264)), ValueError,
     "head_dim 8-256"),
    (lambda: tops.attention(_meta(1, 4, 2, 64), _meta(1, 4, 2, 64),
                            _meta(1, 4, 2, 64),
                            mask=_meta(1, 1, 1, 4).requires_grad_()),
     ValueError, "no gradient for the mask"),
], ids=["mask", "dropout", "head_dim_36", "head_dim_264",
        "mask_requires_grad"])
def test_attention_kernel_refuses_what_it_does_not_take(call, err, match):
    """Off the CPU there is no detour to the plain version: arguments
    the kernel does not take raise: a mask of another shape than [b or
    1, 1, 1, sk], a float mask that requires grad (the kernels give it
    none) and a head dim that is not a multiple of 8 from 8 to 256
    (ValueError, naming ROADMAP), dropout (NotImplementedError)."""
    before = tops.launch_counts()
    with pytest.raises(err, match=match):
        call()
    assert tops.launch_counts() == before


def test_launch_counters_cover_every_entry_point():
    counts = tops.launch_counts()
    assert set(counts) == {
        "rms_norm", "rms_norm_bwd", "fused_add_rms_norm",
        "fused_add_rms_norm_bwd", "rope", "rope_bwd", "paged_attention",
        "flash_attention", "flash_attention_bwd", "fused_adamw",
        "cross_entropy", "quant_matmul"}
    fam = tops.kernel_module("fused_adamw")
    fam.variant_launches["master_ef"] += 1
    variant_mods = [fam, tops.kernel_module("paged_attention"),
                    tops.kernel_module("quant_matmul")]
    variant_mods[1].variant_launches["int8"] += 1
    variant_mods[2].variant_launches["int4"] += 1
    tops.reset_launch_counts()
    assert set(tops.launch_counts().values()) == {0}
    for mod in variant_mods:
        assert set(mod.variant_launches.values()) == {0}
