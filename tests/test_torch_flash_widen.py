"""The flash attention domain the kernels take beyond the TPU kernel's:
head dims 8-256 (a multiple of 8), key-padding masks (bool and additive)
and causal attention with sq != sk (bottom-right), on the CPU.

The port's plain versions (`plain_attention`, the twin; `plain_flash_fwd`
and `plain_flash_bwd`, the kernels' math) are held against the
reference twin `paddle_tpu.ops.xla_attention` and `jax.vjp` of it, rows
whose every key is masked included (a fully padded sequence; under
causal with sq > sk the first sq - sk rows): there the twin weighs all
sk keys alike (every logit is -1e30), its dq and ds are 0 and each dv
gains 1/sk of the row's dO.  A fully padded sequence under an additive
mask of -1e9 keeps the twin's gradients too: uniform weights and
ds = p (dp - delta) scale, which the saved (max, log sum) pair gives
where a saved lse, -1e9 + log(sk) rounded to -1e9, would not.  The autograd Function that carries the
kernels on the card runs here with `_launch_fwd` / `_launch_bwd`
monkeypatched to the plain functions, as tests/test_torch_train_ops.py
runs it; and `_launch_fwd` / `_launch_bwd` run against a stand-in for
the kernel library, which checks the key bias they hand the kernels.

Inputs are made from a seed with numpy and handed to both packages.
Tolerances, with their reasons:

  * fp32: atol = rtol = 1e-5 for outputs, 2e-5 for gradients (sums over
    a sequence and a GQA group) -- the same fp32 arithmetic in other
    reduction orders;
  * bf16 forward: 2^-7 of the largest entry (one bf16 ulp of it): both
    round the weights to bf16 before P.V and the output once;
  * bf16 gradients of the kernels' math against the twin's autodiff in
    fp32 on the same bf16 inputs: 2^-5 of the largest entry -- the
    kernels round p and ds to bf16 before their products (each term
    carries a 2^-8 relative rounding), the twin's fp32 autodiff does not;
  * fp16, the same two with fp16's three more bits: 2^-10 and 2^-8.

The head dims cover every width the kernels' bodies take: the narrow
bodies' (d rounded up to 16: 16, 48, 80, 160; d 8, 40, 72 and 152 below
their width) and those of a multiple of 64, each as self-attention and
as cross-attention over the UNet's 77 context keys.
"""
import ctypes
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_cpu import one_cpu_thread  # noqa: F401 (autouse)

import paddle_tpu.ops as jops

import paddle_tpu_torch.ops as tops
from paddle_tpu_torch.ops import _build

fa = tops.kernel_module("flash_attention")

F32_OUT, F32_GRAD = 1e-5, 2e-5
DT = {"float32": (torch.float32, jnp.float32),
      "bfloat16": (torch.bfloat16, jnp.bfloat16),
      "float16": (torch.float16, jnp.float16)}
# the forward's and the gradients' tolerances in 16 bits, as shares of
# the largest entry (see above)
TOL16 = {"bfloat16": (2.0 ** -7, 2.0 ** -5), "float16": (2.0 ** -10, 2.0 ** -8)}

# (id, b, sq, sk, h, hk, d, causal, mask kind, kept lengths)
CASES = [
    ("d16", 2, 24, 24, 4, 4, 16, False, None, None),
    ("d16_gqa_causal", 2, 24, 24, 4, 2, 16, True, None, None),
    ("d40", 2, 33, 20, 4, 4, 40, False, None, None),
    ("d40_gqa_causal", 1, 33, 33, 6, 2, 40, True, None, None),
    ("d80", 2, 32, 32, 2, 2, 80, False, None, None),
    ("d80_gqa_cross", 2, 32, 7, 4, 2, 80, False, None, None),
    ("d160", 2, 16, 16, 2, 2, 160, True, None, None),
    ("d160_gqa_cross", 2, 16, 7, 4, 1, 160, False, None, None),
    ("d192", 1, 20, 20, 2, 2, 192, True, None, None),
    ("d192_gqa", 1, 20, 28, 4, 2, 192, False, None, None),
    ("d256", 1, 20, 20, 2, 2, 256, False, None, None),
    ("d256_gqa_causal", 1, 20, 20, 4, 2, 256, True, None, None),
    ("bool_mask", 4, 24, 24, 4, 4, 64, False, "bool", [24, 0, 9, 17]),
    ("bool_mask_gqa_d80", 3, 20, 20, 4, 2, 80, False, "bool", [0, 5, 20]),
    ("bool_mask_shared", 1, 24, 24, 2, 2, 64, False, "bool", [13]),
    ("bool_mask_causal", 3, 20, 20, 2, 2, 64, True, "bool", [0, 7, 20]),
    ("additive_mask", 3, 24, 24, 4, 4, 64, False, "additive",
     [24, 3, 17]),
    ("additive_mask_gqa_d160", 2, 16, 16, 4, 2, 160, False, "additive",
     [16, 5]),
    ("additive_mask_causal_sq_lt_sk", 2, 12, 20, 2, 2, 40, True, "additive",
     [20, 9]),
    ("padding_1e9", 3, 24, 24, 4, 4, 64, False, "additive_1e9",
     [24, 0, 9]),
    ("padding_1e9_gqa_causal_d80", 3, 20, 20, 4, 2, 80, True,
     "additive_1e9", [0, 7, 20]),
    ("causal_sq_lt_sk", 2, 12, 30, 4, 2, 64, True, None, None),
    ("causal_sq_gt_sk", 2, 30, 12, 4, 2, 64, True, None, None),
    ("causal_sq_gt_sk_d80", 1, 40, 9, 2, 1, 80, True, None, None),
    ("causal_sq_lt_sk_d256", 1, 8, 33, 2, 2, 256, True, None, None),
    ("causal_sq_gt_sk_bool_mask", 3, 20, 12, 2, 2, 64, True, "bool",
     [12, 0, 4]),
    # the narrow bodies' widths against the UNet's 77 context keys, and
    # head dims below their width
    ("d16_cross77", 2, 20, 77, 2, 2, 16, False, None, None),
    ("d40_gqa_cross77", 1, 20, 77, 4, 2, 40, False, None, None),
    ("d80_cross77", 2, 16, 77, 2, 2, 80, False, None, None),
    ("d160_cross77", 1, 16, 77, 2, 2, 160, False, None, None),
    ("d8_gqa", 2, 20, 20, 4, 2, 8, False, None, None),
    ("d72_causal", 1, 24, 24, 2, 2, 72, True, None, None),
    ("d152_bool_mask_cross", 2, 16, 40, 2, 1, 152, False, "bool", [40, 13]),
    # the kept keys as spans (start, stop): leading padding, one live key
    # last, a hole of dead keys between live ones, and under causal sq <
    # sk leading padding that leaves the first rows no live key
    ("bool_mask_leading", 3, 20, 24, 2, 2, 64, False, "bool",
     [[(7, 24)], [(23, 24)], 0]),
    ("bool_mask_hole", 2, 16, 24, 2, 1, 64, False, "bool",
     [[(0, 5), (19, 24)], [(3, 4), (20, 22)]]),
    ("bool_mask_causal_leading", 2, 16, 24, 2, 2, 64, True, "bool",
     [[(14, 24)], 24]),
    ("padding_1e9_leading", 2, 16, 20, 2, 2, 64, False, "additive_1e9",
     [[(6, 20)], 0]),
]
IDS = [c[0] for c in CASES]


def _keep(lengths, sk):
    """[len(lengths), sk] bool: entry i keeps the first lengths[i] keys,
    or, a list of spans (start, stop), the keys in them."""
    keep = np.zeros((len(lengths), sk), bool)
    for i, n in enumerate(lengths):
        for a, z in ([(0, n)] if np.isscalar(n) else n):
            keep[i, a:z] = True
    return keep


def _inputs(case, seed):
    """q, k, v, dO and the mask (numpy, None without one): the bool mask
    keeps the keys `_keep` gives sequence i (none: a fully padded
    sequence); the additive one adds N(0, 0.25) on the kept keys and
    -1e4 on the padding (a sequence keeps some key), "additive_1e9"
    -1e9 on the padding (none kept: a fully padded sequence)."""
    _, b, sq, sk, h, hk, d, _, kind, lengths = case
    rng = np.random.RandomState(seed)
    q = rng.randn(b, sq, h, d).astype(np.float32)
    k = rng.randn(b, sk, hk, d).astype(np.float32)
    v = rng.randn(b, sk, hk, d).astype(np.float32)
    do = rng.randn(b, sq, h, d).astype(np.float32)
    mask = None
    if kind is not None:
        keep = _keep(lengths, sk)
        if kind == "bool":
            mask = keep[:, None, None, :]
        else:
            pad = -1e9 if kind == "additive_1e9" else -1e4
            mask = np.where(keep, 0.5 * rng.randn(len(lengths), sk),
                            pad).astype(np.float32)[:, None, None, :]
    return q, k, v, do, mask


def _j(a, dt="float32"):
    return jnp.asarray(a).astype(DT[dt][1])


def _t(a, dt="float32"):
    if a is None:
        return None
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if a.dtype == np.bool_ else t.to(DT[dt][0])


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@functools.partial(jax.jit, static_argnames="causal")
def _twin_vjp(q, k, v, do, mask, causal):
    out, vjp = jax.vjp(lambda a, b, c: jops.xla_attention(
        a, b, c, mask=mask, causal=causal), q, k, v)
    return out, vjp(do)


def _ref(case, q, k, v, do, mask, dt="float32"):
    """The twin's output and jax.vjp cotangents, in fp32 on the inputs
    rounded to dt (jitted: one compile a shape, not one an op)."""
    args = [jnp.asarray(_np(_t(a, dt))) for a in (q, k, v, do)]
    jm = None if mask is None else jnp.asarray(mask)
    return _twin_vjp(*args, jm, causal=case[7])


def _mark(lse):
    """The saved statistics' mark plane: lse [b, h, sq], or the row max
    of the (max, log sum) pairs [b, h, sq, 2]."""
    return lse[..., 0] if lse.ndim == 4 else lse


def _dead_rows(case, mask):
    """[b, sq] bool: the rows whose every key is masked."""
    _, b, sq, sk, _, _, _, causal, kind, lengths = case
    live = np.ones((b, sq, sk), bool)
    if causal:
        live &= np.tril(np.ones((sq, sk), bool), sk - sq)[None]
    if kind == "bool":
        live &= mask[:, 0, 0, :][:, None, :]
    return ~live.any(-1)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_flash_matches_the_twin_fp32(case):
    """plain_flash_fwd's output against xla_attention and its lse
    against the logsumexp of the twin's logits (+inf exactly where every
    key of the row is masked); plain_flash_bwd's dq, dk, dv against
    jax.vjp of xla_attention; and plain_attention with native autograd
    against both."""
    q, k, v, do, mask = _inputs(case, 7)
    causal = case[7]
    jout, jgrads = _ref(case, q, k, v, do, mask)
    tq, tk, tv, tdo, tm = (_t(a) for a in (q, k, v, do, mask))
    out, lse = tops.plain_flash_fwd(tq, tk, tv, causal, None, tm)
    np.testing.assert_allclose(_np(out), _np(jout), atol=F32_OUT,
                               rtol=F32_OUT)
    dead = _dead_rows(case, mask)
    inf = torch.isinf(_mark(lse)).numpy()              # [b, h, sq]
    assert (inf == dead[:, None, :]).all()
    assert (_mark(lse).numpy()[inf] > 0).all()
    assert lse.ndim == (4 if tm is not None or causal and case[2] > case[3]
                        else 3)
    assert torch.isfinite(lse[..., 1]).all() if lse.ndim == 4 else True
    grads = tops.plain_flash_bwd(tq, tk, tv, out, lse, tdo, causal, None,
                                 tm)
    for name, got, want in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(_np(got), _np(want), atol=F32_GRAD,
                                   rtol=F32_GRAD, err_msg="d" + name)
    # a dead row: the mean of v forward, dq = 0
    if dead.any():
        bi, ri = np.nonzero(dead)
        g = case[4] // case[5]
        mean_v = np.repeat(v.mean(1), g, axis=1)       # [b, h, d]
        np.testing.assert_allclose(_np(out)[bi, ri], mean_v[bi],
                                   atol=F32_OUT, rtol=F32_OUT)
        assert (_np(grads[0])[bi, ri] == 0).all()
    leaves = [torch.from_numpy(a.copy()).requires_grad_(True)
              for a in (q, k, v)]
    (tops.plain_attention(*leaves, mask=tm, causal=causal)
     * tdo).sum().backward()
    for name, leaf, want in zip("qkv", leaves, jgrads):
        np.testing.assert_allclose(_np(leaf.grad), _np(want), atol=F32_GRAD,
                                   rtol=F32_GRAD, err_msg="d" + name)


# the narrow bodies' widths (16, 48, 80, 160), self and cross
NARROW_IDS = ("d16", "d40", "d40_gqa_causal", "d80", "d160", "d16_cross77",
              "d40_gqa_cross77", "d80_cross77", "d160_cross77",
              "d80_gqa_cross", "d8_gqa", "d72_causal", "d152_bool_mask_cross")


def _twin_16bit(case, dt, seed):
    """plain_flash_fwd / plain_flash_bwd in the 16-bit dtype `dt` against
    the twin: the forward at TOL16's first share of the largest entry,
    the kernels' backward math against the twin's fp32 autodiff on the
    same rounded inputs at its second."""
    q, k, v, do, mask = _inputs(case, seed)
    causal = case[7]
    f_tol, g_tol = TOL16[dt]
    jq, jk, jv = (_j(a, dt) for a in (q, k, v))
    jm = None if mask is None else jnp.asarray(mask)
    jout = jops.xla_attention(jq, jk, jv, mask=jm, causal=causal)
    _, jgrads = _ref(case, q, k, v, do, mask, dt)
    tq, tk, tv, tdo = (_t(a, dt) for a in (q, k, v, do))
    tm = _t(mask)
    out, lse = tops.plain_flash_fwd(tq, tk, tv, causal, None, tm)
    ref = _np(jout)
    np.testing.assert_allclose(_np(out), ref, rtol=0,
                               atol=f_tol * np.abs(ref).max())
    grads = tops.plain_flash_bwd(tq, tk, tv, out, lse, tdo, causal, None,
                                 tm)
    for name, got, want in zip("qkv", grads, jgrads):
        w = _np(want)
        np.testing.assert_allclose(_np(got), w, rtol=0,
                                   atol=g_tol * np.abs(w).max(),
                                   err_msg="d" + name)


@pytest.mark.parametrize("case", [c for c in CASES if c[0] in (
    "d80", "d160_gqa_cross", "d256_gqa_causal", "bool_mask",
    "additive_mask", "causal_sq_gt_sk", "causal_sq_lt_sk_d256",
    "padding_1e9", "bool_mask_causal_leading") + NARROW_IDS],
    ids=lambda c: c[0])
def test_plain_flash_matches_the_twin_bf16(case):
    """In bf16: the forward against the twin at one bf16 ulp of the
    largest entry, the kernels' backward math against the twin's fp32
    autodiff on the same bf16 inputs at 2^-5 of the largest entry."""
    _twin_16bit(case, "bfloat16", 11)


@pytest.mark.parametrize("case", [c for c in CASES if c[0] in NARROW_IDS],
                         ids=lambda c: c[0])
def test_plain_flash_matches_the_twin_fp16(case):
    """In fp16, at the narrow bodies' widths: the forward against the
    twin at one fp16 ulp of the largest entry, the backward math against
    the twin's fp32 autodiff on the same fp16 inputs at 2^-8 of it."""
    _twin_16bit(case, "float16", 13)


def test_causal_logit_is_masked_whatever_its_bias():
    """A logit that causal masks is -1e30 in the kernels' math whatever
    the additive bias there (the twin adds the bias to -1e30): a row
    whose every key is masked, by causal and by a -1e30 bias, weighs
    all sk keys alike, and its lse carries the +inf mark."""
    q, k, v, do, _ = _inputs(("", 1, 6, 4, 2, 2, 16, True, None, None), 3)
    bias = np.zeros((1, 1, 1, 4), np.float32)
    bias[..., :2] = -np.inf                # clamped to -1e30: masked
    tq, tk, tv = (_t(a) for a in (q, k, v))
    out, lse = tops.plain_flash_fwd(tq, tk, tv, True, None, _t(bias))
    # rows 0 and 1 see keys <= i - 2: none; rows 2 and 3 only masked keys
    assert torch.isinf(_mark(lse)[0, :, :4]).all()
    assert torch.isfinite(_mark(lse)[0, :, 4:]).all()
    np.testing.assert_allclose(_np(out)[0, :4], np.broadcast_to(
        v.mean(1)[0], (4, 2, 16)), atol=F32_OUT, rtol=F32_OUT)


@pytest.mark.parametrize("case", [c for c in CASES if c[0] in (
    "d40_gqa_causal", "d192_gqa", "bool_mask", "additive_mask",
    "causal_sq_gt_sk", "causal_sq_gt_sk_bool_mask", "padding_1e9",
    "padding_1e9_gqa_causal_d80", "d16_cross77", "d40_gqa_cross77",
    "d80_cross77", "d160_cross77", "d152_bool_mask_cross",
    "bool_mask_hole")],
    ids=lambda c: c[0])
def test_flash_function_with_plain_launches(monkeypatch, case):
    """`_FlashAttention` with `_launch_fwd` / `_launch_bwd` replaced by
    the plain functions: its gradients equal native autograd of the
    plain attention, masks and offsets included, and the mask and the
    key bias built once (`_key_bias`, the same `_Keys` object) reach
    both launches."""
    seen, keys_seen = [], []

    def fwd(q, k, v, causal, scale, keys):
        seen.append(keys.mask)
        keys_seen.append(keys)
        return tops.plain_flash_fwd(q, k, v, causal, scale, keys.mask)

    def bwd(q, k, v, out, lse, dout, causal, scale, keys):
        seen.append(keys.mask)
        keys_seen.append(keys)
        return tops.plain_flash_bwd(q, k, v, out, lse, dout, causal, scale,
                                    keys.mask)

    monkeypatch.setattr(fa, "_launch_fwd", fwd)
    monkeypatch.setattr(fa, "_launch_bwd", bwd)
    q, k, v, do, mask = _inputs(case, 5)
    causal, tm, cot = case[7], _t(mask), torch.from_numpy(do)
    sc = case[6] ** -0.5

    def grads(fn):
        leaves = [torch.from_numpy(a.copy()).requires_grad_(True)
                  for a in (q, k, v)]
        (fn(*leaves) * cot).sum().backward()
        return [x.grad for x in leaves]

    got = grads(lambda a, b, c: fa._FlashAttention.apply(a, b, c, causal,
                                                         sc, tm))
    want = grads(lambda a, b, c: tops.plain_attention(a, b, c, mask=tm,
                                                      causal=causal))
    assert len(seen) == 2 and all(m is tm for m in seen)
    assert keys_seen[0] is keys_seen[1]
    assert (keys_seen[0].bias is None) == (
        tm is None and not (causal and case[2] > case[3]))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=F32_GRAD, rtol=F32_GRAD)


def _view(ptr, shape, dtype):
    n = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
    buf = (ctypes.c_char * n).from_address(ptr)
    return torch.frombuffer(buf, dtype=dtype).view(shape)


class _BiasLib:
    """Stands in for the kernel library's flash entry points: checks
    each call's arguments against `_build._SIGNATURES`, reads the key
    bias and its live range it was handed, and writes the plain math's
    results."""

    CTYPE = {ctypes.c_void_p: int, ctypes.c_int: int, ctypes.c_float: float}
    DTYPE = {code: dt for dt, code in _build.DTYPE_CODES.items()}

    def __init__(self):
        self.bias = []
        self.ptrs = []          # (bias, range) pointers a call

    def _record(self, name, args):
        sig = _build._SIGNATURES[name]
        assert len(args) == len(sig), name
        for a, c in zip(args, sig):
            assert type(a) is self.CTYPE[c] or (
                a is None and c is ctypes.c_void_p), (name, a, c)

    def _read_bias(self, ptr, rng, b, sk, bstride):
        self.ptrs.append((ptr, rng))
        assert (ptr is None) == (rng is None)
        if ptr is None:
            self.bias.append(None)
            return None
        rows = b if bstride else 1
        skp = bstride or -(-sk // 128) * 128
        full = _view(ptr, (rows, skp), torch.float32).clone()
        live = _view(rng, (rows, 2), torch.int32).clone()
        self.bias.append((full, bstride, live))
        return full

    def ptt_flash_fwd(self, *args):
        self._record("ptt_flash_fwd", args)
        dev, code, q, k, v, bias, rng, out, lse, b, sq, sk, h, hk, d, \
            bstride, scale, causal, stream = args
        dt = self.DTYPE[code]
        full = self._read_bias(bias, rng, b, sk, bstride)
        m = None if full is None else full[:, None, None, :sk]
        o, l = tops.plain_flash_fwd(
            _view(q, (b, sq, h, d), dt), _view(k, (b, sk, hk, d), dt),
            _view(v, (b, sk, hk, d), dt), bool(causal), scale, m)
        _view(out, (b, sq, h, d), dt).copy_(o)
        _view(lse, l.shape, torch.float32).copy_(l)
        return 0

    def ptt_flash_bwd(self, *args):
        self._record("ptt_flash_bwd", args)
        dev, code, q, k, v, bias, rng, out, dout, lse, delta, dq, dk, dv, b, \
            sq, sk, h, hk, d, bstride, scale, causal, stream = args
        dt = self.DTYPE[code]
        full = self._read_bias(bias, rng, b, sk, bstride)
        m = None if full is None else full[:, None, None, :sk]
        qs, ks = (b, sq, h, d), (b, sk, hk, d)
        o, g = _view(out, qs, dt), _view(dout, qs, dt)
        _view(delta, (b, h, sq), torch.float32).copy_(
            (g.float() * o.float()).sum(-1).transpose(1, 2))
        stats = (b, h, sq) + ((2,) if bias is not None else ())
        grads = tops.plain_flash_bwd(
            _view(q, qs, dt), _view(k, ks, dt), _view(v, ks, dt), o,
            _view(lse, stats, torch.float32), g, bool(causal), scale, m)
        for ptr, shape, grad in zip((dq, dk, dv), (qs, ks, ks), grads):
            _view(ptr, shape, dt).copy_(grad)
        return 0


@pytest.mark.parametrize("kind,mb", [("bool", 3), ("additive", 3),
                                     ("bool", 1), (None, 3)])
def test_launch_hands_the_kernels_the_key_bias(monkeypatch, kind, mb):
    """`_launch_fwd` / `_launch_bwd` with the library stood in for: the
    key bias fp32 [b or 1, skp] (skp = sk rounded up to 128, 0 past sk),
    0 / -1e30 for a bool mask, the additive values clamped at -1e30, the
    row stride skp (0 for a mask shared by the batch, and no pointer
    without a mask), and its live range int32 [b or 1, 2] (`_live_spans`);
    the results equal the plain versions'."""
    lib = _BiasLib()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "cuda_device_index", lambda *t: 0)
    monkeypatch.setattr(_build, "stream_of", lambda d: 0)
    rng = np.random.RandomState(3)
    b, sq, sk, h, hk, d = 3, 10, 130, 2, 1, 24
    q, do = (torch.from_numpy(rng.randn(b, sq, h, d).astype(np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(b, sk, hk, d).astype(np.float32))
            for _ in range(2))
    keep = torch.from_numpy(np.arange(sk)[None]
                            < np.array([130, 0, 77])[:mb, None])
    mask = want = None
    if kind == "bool":
        mask = keep[:, None, None, :]
        want = torch.where(keep, 0.0, -1e30)
    elif kind == "additive":
        vals = torch.from_numpy(rng.randn(mb, sk).astype(np.float32))
        vals[~keep] = -np.inf
        vals[0, 5] = -3e38
        mask = vals[:, None, None, :]
        want = vals.clamp_min(-1e30)
    keys = fa._key_bias(mask, q, k, False)
    out, lse = fa._launch_fwd(q, k, v, False, 0.2, keys)
    grads = fa._launch_bwd(q, k, v, out, lse, do, False, 0.2, keys)
    assert len(lib.bias) == 2
    for got in lib.bias:
        if kind is None:
            assert got is None
            continue
        full, bstride, live = got
        assert full.shape == (mb, 256)
        assert bstride == (256 if mb > 1 else 0)
        assert torch.equal(full[:, :sk], want)
        assert (full[:, sk:] == 0).all()
        assert live.tolist() == _live_spans(want.numpy() > -1e30)
    p_out, p_lse = tops.plain_flash_fwd(q, k, v, False, 0.2, mask)
    assert torch.equal(out, p_out) and torch.equal(lse, p_lse)
    for g, w in zip(grads, tops.plain_flash_bwd(q, k, v, out, lse, do,
                                                False, 0.2, mask)):
        assert torch.equal(g, w)


def test_causal_with_more_rows_than_keys_gets_a_zero_bias(monkeypatch):
    """Causal with sq > sk and no mask: the first sq - sk rows have no
    live key, which only the kernels' bias bodies handle, so the launch
    hands them a zero bias shared by the batch; sq <= sk gets none."""
    lib = _BiasLib()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "cuda_device_index", lambda *t: 0)
    monkeypatch.setattr(_build, "stream_of", lambda d: 0)
    rng = np.random.RandomState(4)
    for sq, sk in ((9, 5), (5, 9)):
        q = torch.from_numpy(rng.randn(2, sq, 2, 16).astype(np.float32))
        k = torch.from_numpy(rng.randn(2, sk, 2, 16).astype(np.float32))
        out, lse = fa._launch_fwd(q, k, k, True, 0.25,
                                  fa._key_bias(None, q, k, True))
        p_out, p_lse = tops.plain_flash_fwd(q, k, k, True, 0.25)
        assert torch.equal(out, p_out) and torch.equal(lse, p_lse)
    (full, bstride, live), none = lib.bias
    assert none is None and bstride == 0
    assert full.shape == (1, 128) and (full == 0).all()
    assert live.tolist() == [[5, 5]]           # every key live


def _live_spans(live):
    """The kernels' live range of each row of a [rows, sk] bool array of
    live keys, by its definition: (sk - first, end) for the live keys'
    span [first, end), (0, 0) for a row with none."""
    sk = live.shape[1]
    out = []
    for row in live:
        at = np.nonzero(row)[0]
        out.append([sk - int(at[0]), int(at[-1]) + 1] if len(at) else [0, 0])
    return out


@pytest.mark.parametrize("kind", ["bool", "additive_inf", "additive_min",
                                  "additive_1e9"])
def test_key_range_matches_its_definition(kind):
    """`_key_bias`'s live range against `_live_spans` on random masks:
    runs of live and dead keys, rows with none, one key, a key first or
    last.  A bool mask's padding is dead, so is an additive one's at
    -inf or float32's minimum (clamped to -1e30); -1e9 is live."""
    rng = np.random.RandomState(23)
    b, sk = 12, 300
    keep = rng.rand(b, sk) < rng.rand(b, 1)
    keep &= rng.rand(b, sk) < 0.9 ** rng.randint(0, 40, (b, 1))
    keep[0] = False
    keep[1] = False
    keep[1, 150] = True
    keep[2] = False
    keep[2, [0, sk - 1]] = True
    keep[3] = True
    if kind == "bool":
        mask = torch.from_numpy(keep)
    else:
        pad = {"additive_inf": -np.inf, "additive_1e9": -1e9,
               "additive_min": np.finfo(np.float32).min}[kind]
        mask = torch.from_numpy(np.where(
            keep, rng.randn(b, sk), pad).astype(np.float32))
    q, k = torch.zeros(b, 4, 1, 8), torch.zeros(b, sk, 1, 8)
    keys = fa._key_bias(mask[:, None, None, :], q, k, False)
    assert keys.live.dtype == torch.int32 and keys.live.shape == (b, 2)
    want = keep if kind != "additive_1e9" else np.ones_like(keep)
    assert keys.live.tolist() == _live_spans(want)


def _chip_smoke():
    import importlib.util
    import pathlib
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("sq,sk,causal", [(24, 40, False), (24, 40, True),
                                          (40, 24, True)])
def test_chip_smoke_counts_the_work_by_the_mask(sq, sk, causal):
    """chip_smoke's bound of a masked case counts the (row, key) pairs
    the function needs (`_flash_pairs`) and the K / V rows it reads
    (`_flash_kv_rows`) by their definitions, on random spans of kept
    keys (none kept, leading padding, holes): a pair is a kept key at or
    before the row's bottom-right causal frontier; a sequence reads its
    kept keys, or all sk where a row of it has none."""
    cs = _chip_smoke()
    rng = np.random.RandomState(sq + sk + causal)
    lengths = [0, sk, [(sk - 3, sk)], [(0, 2), (sk - 5, sk - 1)]]
    for _ in range(4):
        a, z = sorted(rng.randint(0, sk + 1, 2))
        lengths.append([(int(a), int(z))])
    keep = _keep(lengths, sk)
    b = len(lengths)
    sees = np.arange(sq)[:, None] + sk - sq >= np.arange(sk)[None] \
        if causal else np.ones((sq, sk), bool)
    seen = keep[:, None, :] & sees[None]
    assert cs._flash_pairs(b, sq, sk, causal, lengths) == int(seen.sum())
    rows = sum(sk if not seen[i].any(-1).all() else int(keep[i].sum())
               for i in range(b))
    assert cs._flash_kv_rows(b, sq, sk, causal, lengths) == rows
    assert cs._flash_pairs(b, sq, sk, causal) == int(sees.sum()) * b
    assert cs._flash_kv_rows(b, sq, sk, causal) == b * sk


def test_backward_takes_the_forwards_key_bias(monkeypatch):
    """Under autograd the key bias and its live range are built once a
    call: `_launch_bwd` hands the library the very tensors (pointers)
    that `_launch_fwd` handed it, and `_key_bias` runs once."""
    lib, made = _BiasLib(), []
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "cuda_device_index", lambda *t: 0)
    monkeypatch.setattr(_build, "stream_of", lambda d: 0)
    key_bias = fa._key_bias

    def counted(*a):
        made.append(key_bias(*a))
        return made[-1]

    monkeypatch.setattr(fa, "_key_bias", counted)
    case = next(c for c in CASES if c[0] == "bool_mask_hole")
    q, k, v, do, mask = _inputs(case, 9)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = fa._FlashAttention.apply(*leaves, False, 0.125, _t(mask))
    (out * torch.from_numpy(do)).sum().backward()
    assert len(made) == 1 and len(lib.ptrs) == 2
    assert lib.ptrs[0] == lib.ptrs[1] == (made[0].bias.data_ptr(),
                                          made[0].live.data_ptr())
    assert lib.bias[0][2].tolist() == _live_spans(_keep(case[9], case[3]))


def _meta(*shape, dtype=torch.float32):
    return torch.zeros(shape, device="meta", dtype=dtype)


@pytest.mark.parametrize("d", [16, 40, 80, 160, 192, 256])
def test_attention_takes_the_new_head_dims(d):
    """Off the CPU (a meta tensor stands in for the card's here) head
    dims 8-256 that are multiples of 8 pass the kernels' domain check
    and reach the device check."""
    with pytest.raises(ValueError, match="must be CUDA tensors"):
        tops.attention(_meta(1, 4, 2, d), _meta(1, 6, 2, d),
                       _meta(1, 6, 2, d), causal=True,
                       mask=_meta(1, 1, 1, 6, dtype=torch.bool))


@pytest.mark.parametrize("shape", [(2, 1, 4, 6), (1, 2, 1, 6), (2, 6),
                                   (3, 1, 1, 6), (1, 1, 1, 5)],
                         ids=["per_query", "per_head", "2d", "batch_3",
                              "short"])
def test_attention_refuses_other_mask_shapes(shape):
    before = tops.launch_counts()
    with pytest.raises(ValueError, match="ROADMAP"):
        tops.attention(_meta(2, 4, 2, 64), _meta(2, 6, 2, 64),
                       _meta(2, 6, 2, 64), mask=_meta(*shape))
    assert tops.launch_counts() == before


@pytest.mark.parametrize("dtype,sq,sk,d,mask,causal,biased", [
    (torch.bfloat16, 1024, 77, 80, None, False, 0),
    (torch.float16, 30, 12, 40, None, True, 1),
    (torch.bfloat16, 24, 24, 160, "bool", False, 1),
    (torch.float32, 197, 197, 64, None, True, 0)],
    ids=["bf16_cross_d80", "fp16_causal_sq_gt_sk", "bf16_masked_d160",
         "fp32"])
def test_kernel_plan_asks_the_library(monkeypatch, dtype, sq, sk, d, mask,
                                      causal, biased):
    """`kernel_plan` hands the library's plan query the dtype code, sq,
    sk, d, whether the call takes a key bias (a mask, or causal with
    sq > sk) and causal, with the argument types `_build._SIGNATURES`
    gives, and reads back its eight fields by name."""
    seen = []

    class Lib:
        def ptt_flash_plan(self, *args):
            sig = _build._SIGNATURES["ptt_flash_plan"]
            assert len(args) == len(sig)
            assert all(type(a) is int for a in args)
            seen.append(args[:-1])
            (ctypes.c_int * 8).from_address(args[-1])[:] = [
                80, 128, 128, 128, 1, 80, 0, 1]
            return 0

    monkeypatch.setattr(_build, "library", lambda: Lib())
    q = torch.zeros((2, sq, 4, d), dtype=dtype)
    k = torch.zeros((2, sk, 2, d), dtype=dtype)
    m = None if mask is None else torch.ones((2, 1, 1, sk), dtype=torch.bool)
    got = fa.kernel_plan(q, k, causal, m)
    assert seen == [(_build.DTYPE_CODES[dtype], sq, sk, d, biased,
                     int(causal))]
    assert got == dict(width=80, tile_width=128, query_tile=128,
                       key_tile=128, dkv_chunks=1, dkv_chunk_width=80,
                       fit=False, narrow=True)
