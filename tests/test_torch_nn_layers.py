"""The port's nn layers against paddle_tpu's, on the CPU.

Linear, Embedding (with padding_idx), LayerNorm (eps 1e-12 and 1e-5),
gelu (tanh and erf) and tanh get the same numpy weights and inputs, made
from a seed, in both packages: outputs in fp32 and under
`set_compute_dtype("bfloat16")` (fp32 masters, bf16 compute), gradients
in fp32 against `jax.grad`.  Then `set_compute_dtype`'s count, the
automatic parameter names, the containers, Dropout's statistics and the
initializers' shapes and moments.  Tolerances, with their reasons:

  * fp32: 1e-5 absolute and relative — the packages sum the same terms
    in other orders (matmuls, LayerNorm's statistics);
  * bf16: tests/op_test.py's (2e-2 absolute and relative): both round
    to bf16 at the same points, but XLA and PyTorch's CPU kernels
    accumulate bf16 operands differently, so a value may round the
    other way by one bf16 ulp (2^-8 relative);
  * Dropout at p = 0.1 over 10^6 elements: the keep rate within 5
    standard deviations (5 sqrt(p (1 - p) / n) = 1.5e-3) of 0.9, kept
    values x / 0.9 to an fp32 rounding;
  * initializers over 10^6 draws: the sample mean within 5 standard
    errors of the distribution's, the sample std within 1% of it, in
    both packages.
"""
import collections
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_cpu import one_cpu_thread  # noqa: F401 (autouse)

import paddle_tpu
import paddle_tpu.nn.functional as JF
import paddle_tpu.nn.initializer as JI
import paddle_tpu.nn.layer.layers as jlayers
from paddle_tpu.framework.tensor import Tensor as JTensor
from paddle_tpu.jit import _swapped_state

import paddle_tpu_torch.nn.layer as tlayer
from paddle_tpu_torch import nn
from paddle_tpu_torch.models import load_numpy_state_dict
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as I

BF16_TOL = 2e-2         # tests/op_test.py DTYPE_ATOL / DTYPE_RTOL bf16
FP32_TOL = 1e-5


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _weights(jlayer, rng):
    """Random numpy weights for every parameter of a reference layer:
    scales ~1 + 0.1 N(0, 1) for 1-D ones (norm scales, biases), N(0, 1) /
    sqrt(fan-in) for matrices."""
    out = {}
    for name, p in jlayer.state_dict().items():
        shape = tuple(p.shape)
        if len(shape) == 1:
            out[name] = (1.0 + 0.1 * rng.randn(*shape)).astype(np.float32)
        else:
            out[name] = (rng.randn(*shape) / np.sqrt(shape[0])) \
                .astype(np.float32)
    return out


def _pair(make_j, make_t, rng):
    jl, tl = make_j(), make_t()
    w = _weights(jl, rng)
    jl.set_state_dict(w)
    load_numpy_state_dict(tl, w)
    return jl, tl


LAYERS = {
    "linear": (lambda: paddle_tpu.nn.Linear(48, 40),
               lambda: nn.Linear(48, 40, device="cpu", generator=_gen())),
    "linear_no_bias": (lambda: paddle_tpu.nn.Linear(48, 40, bias_attr=False),
                       lambda: nn.Linear(48, 40, bias_attr=False,
                                         device="cpu", generator=_gen())),
    "layer_norm_eps1e-12": (
        lambda: paddle_tpu.nn.LayerNorm(48, epsilon=1e-12),
        lambda: nn.LayerNorm(48, epsilon=1e-12, device="cpu")),
    "layer_norm_eps1e-5": (
        lambda: paddle_tpu.nn.LayerNorm(48, epsilon=1e-5),
        lambda: nn.LayerNorm(48, epsilon=1e-5, device="cpu")),
}


def _input(rng, dtype):
    x = (rng.randn(3, 7, 48) * 2.0 + 0.5).astype(np.float32)
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    j = jnp.asarray(x).astype(dtype)        # the same round-to-nearest
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_layer_forward_matches_reference(layer, dtype):
    rng = np.random.RandomState(1)
    jl, tl = _pair(*LAYERS[layer], rng)
    if dtype == "bfloat16":
        assert paddle_tpu.nn.set_compute_dtype(jl, dtype) \
            == nn.set_compute_dtype(tl, dtype) == 1
    jx, tx = _input(rng, dtype)
    jout = np.asarray(jl(JTensor(jx)).value.astype(jnp.float32))
    tout = tl(tx)
    assert str(tout.dtype) == "torch." + str(jl(JTensor(jx)).value.dtype)
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(tout.detach().float().numpy(), jout,
                               atol=tol, rtol=tol)


def _ref_grads(jl, jx, cot, wrt_x=True):
    names = list(jl.state_dict())
    vals = [jl.state_dict()[n]._value for n in names]

    def f(pv, xv):
        with _swapped_state(jl, names, pv):
            out = jl(JTensor(xv)).value
        return jnp.sum(out.astype(jnp.float32) * cot)

    if wrt_x:
        gp, gx = jax.grad(f, argnums=(0, 1))(vals, jx)
    else:
        gp, gx = jax.grad(f)(vals, jx), None
    return dict(zip(names, gp)), gx


@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_layer_grads_match_reference(layer):
    rng = np.random.RandomState(2)
    jl, tl = _pair(*LAYERS[layer], rng)
    jx, tx = _input(rng, "float32")
    cot = rng.randn(3, 7, *tl(tx).shape[2:]).astype(np.float32)
    jg, jgx = _ref_grads(jl, jx, jnp.asarray(cot))
    tx.requires_grad_(True)
    (tl(tx) * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx),
                               atol=FP32_TOL, rtol=FP32_TOL)
    params = dict(tl.named_parameters())
    assert sorted(params) == sorted(jg)
    for n, g in jg.items():
        np.testing.assert_allclose(params[n].grad.numpy(), np.asarray(g),
                                   atol=FP32_TOL, rtol=FP32_TOL, err_msg=n)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("padding_idx", [None, 0, -1])
def test_embedding_matches_reference(padding_idx, dtype):
    """Lookup, the padding row read as zeros and passing no gradient, and
    the row zeroed at init in both packages."""
    jl = paddle_tpu.nn.Embedding(30, 16, padding_idx=padding_idx)
    tl = nn.Embedding(30, 16, padding_idx=padding_idx, device="cpu",
                      generator=_gen())
    if padding_idx is not None:
        assert not np.asarray(jl.weight.value)[padding_idx].any()
        assert not tl.weight[padding_idx].any()
    rng = np.random.RandomState(3)
    w = {"weight": rng.randn(30, 16).astype(np.float32)}
    jl.set_state_dict(w)
    load_numpy_state_dict(tl, w)
    if dtype == "bfloat16":
        assert paddle_tpu.nn.set_compute_dtype(jl, dtype) \
            == nn.set_compute_dtype(tl, dtype) == 1
    ids = rng.randint(0, 30, (4, 9)).astype(np.int32)
    ids[0, :3] = 29
    ids[1, 2] = 0
    jout = jl(JTensor(jnp.asarray(ids))).value
    tout = tl(torch.from_numpy(ids))
    assert str(tout.dtype) == "torch." + str(jout.dtype)
    np.testing.assert_array_equal(tout.detach().float().numpy(),
                                  np.asarray(jout.astype(jnp.float32)))
    if dtype == "bfloat16":
        return
    cot = rng.randn(4, 9, 16).astype(np.float32)
    jg, _ = _ref_grads(jl, jnp.asarray(ids), jnp.asarray(cot), wrt_x=False)
    (tout * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(tl.weight.grad.numpy(),
                               np.asarray(jg["weight"]), atol=FP32_TOL,
                               rtol=FP32_TOL)
    if padding_idx is not None:
        assert not tl.weight.grad[padding_idx].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fn", ["gelu_tanh", "gelu_erf", "tanh"])
def test_activation_matches_reference(fn, dtype):
    rng = np.random.RandomState(4)
    jx, tx = _input(rng, dtype)
    jfn, tfn = {
        "gelu_tanh": (lambda v: JF.gelu(v, approximate=True),
                      lambda v: F.gelu(v, approximate=True)),
        "gelu_erf": (lambda v: JF.gelu(v, approximate=False),
                     lambda v: F.gelu(v, approximate=False)),
        "tanh": (JF.tanh, F.tanh)}[fn]
    jout = jfn(JTensor(jx)).value
    tout = tfn(tx)
    assert str(tout.dtype) == "torch." + str(jout.dtype)
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(tout.float().numpy(),
                               np.asarray(jout.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    if dtype == "float32":
        cot = rng.randn(*tx.shape).astype(np.float32)
        jg = jax.grad(lambda v: jnp.sum(jfn(JTensor(v)).value * cot))(jx)
        tx.requires_grad_(True)
        (tfn(tx) * torch.from_numpy(cot)).sum().backward()
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg),
                                   atol=FP32_TOL, rtol=FP32_TOL)


def test_layer_norm_keeps_fp32_statistics_for_bf16_input():
    """A bf16 row whose mean is far larger than its spread: statistics
    taken in bf16 would lose the spread; the reference's fp32 statistics
    keep it, and so does the port."""
    x = (1000.0 + torch.arange(48, dtype=torch.float32) / 8.0) \
        .to(torch.bfloat16)[None]
    out = F.layer_norm(x, 48, epsilon=1e-12)
    ref = JF.layer_norm(JTensor(jnp.asarray(x.float().numpy())
                                .astype(jnp.bfloat16)), 48, epsilon=1e-12)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.value.astype(jnp.float32)),
                               atol=BF16_TOL, rtol=BF16_TOL)
    assert out.float().std().item() > 0.9


# ---------------------------------------------------------------------------
# set_compute_dtype, automatic names, containers
# ---------------------------------------------------------------------------
def _nested(pkg, **kw):
    """Both packages' layers in one nested structure: a Sequential of a
    Linear, a LayerList of (Embedding, LayerNorm, Dropout), and a
    LayerNorm without parameters."""
    return pkg.Sequential(
        pkg.Linear(8, 8, **kw),
        pkg.LayerList([pkg.Embedding(10, 8, **kw),
                       pkg.LayerNorm(8, **{k: v for k, v in kw.items()
                                           if k == "device"}),
                       pkg.Dropout(0.0)]),
        pkg.LayerNorm(8, weight_attr=False, bias_attr=False,
                      **{k: v for k, v in kw.items() if k == "device"}))


def test_set_compute_dtype_count_and_names_match_reference(monkeypatch):
    """The same nested layers in both packages (counters reset in both):
    the same structural and automatic parameter names, the same count of
    switched layers, and every switched layer computing in bf16."""
    monkeypatch.setattr(jlayers, "_layer_name_counters",
                        collections.defaultdict(int))
    monkeypatch.setattr(tlayer, "_layer_name_counters",
                        collections.defaultdict(int))
    jm = _nested(paddle_tpu.nn)
    tm = _nested(nn, device="cpu", generator=_gen())
    jnames = {n: p.name for n, p in jm.named_parameters()}
    tnames = {n: p.auto_name for n, p in tm.named_parameters()}
    assert list(tnames) == list(jnames)
    assert tnames == jnames
    assert tnames["1.1.weight"] == "layernorm_0.weight"
    n = nn.set_compute_dtype(tm, "bfloat16")
    assert n == paddle_tpu.nn.set_compute_dtype(jm, "bfloat16") == 4
    assert tm[0](torch.ones(2, 8)).dtype == torch.bfloat16
    assert tm[1][0](torch.tensor([1, 2])).dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in tm.parameters())


def test_parameter_attributes():
    """A named ParamAttr names the parameter, trainable=False freezes it,
    an initializer given as weight_attr is used, False leaves it out."""
    g = _gen(5)
    lin = nn.Linear(4, 3, weight_attr=paddle_attr("w_main"),
                    bias_attr=I.Constant(0.5), device="cpu", generator=g)
    assert lin.weight.auto_name == "w_main"
    assert torch.equal(lin.bias, torch.full((3,), 0.5))
    frozen = nn.Linear(4, 3, weight_attr=paddle_attr(None, trainable=False),
                       bias_attr=False, device="cpu", generator=g)
    assert not frozen.weight.requires_grad and frozen.bias is None
    with pytest.raises(NotImplementedError, match="item 7"):
        paddle_attr(None, learning_rate=2.0)


def paddle_attr(name, **kw):
    from paddle_tpu_torch.framework.param_attr import ParamAttr
    return ParamAttr(name=name, **kw)


def test_containers():
    g = _gen(6)
    a, b = nn.Linear(4, 4, device="cpu", generator=g), \
        nn.Linear(4, 2, device="cpu", generator=g)
    seq = nn.Sequential(a, b)
    named = nn.Sequential(collections.OrderedDict([("first", a),
                                                   ("second", b)]))
    pairs = nn.Sequential(("first", a), ("second", b))
    x = torch.randn(3, 4, generator=g)
    assert torch.equal(seq(x), b(a(x))) and torch.equal(named(x), seq(x))
    assert [n for n, _ in pairs.named_children()] == ["first", "second"]
    lst = nn.LayerList([a, b])
    assert len(lst) == 2 and lst[1] is b and isinstance(lst,
                                                        torch.nn.ModuleList)
    assert [n for n, _ in lst.named_parameters()] == \
        ["0.weight", "0.bias", "1.weight", "1.bias"]


def test_layers_follow_the_device_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: nn.Linear(4, 4, generator=_gen()),
                 lambda: nn.Embedding(4, 4, generator=_gen()),
                 lambda: nn.LayerNorm(4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


# ---------------------------------------------------------------------------
# Dropout
# ---------------------------------------------------------------------------
def test_dropout_p0_and_eval_are_the_identity():
    x = torch.randn(5, 7, generator=_gen())
    d0 = nn.Dropout(0.0)
    assert torch.equal(d0(x), x)
    d = nn.Dropout(0.1, generator=_gen(1))
    d.eval()
    assert torch.equal(d(x), x)
    jx = JTensor(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(
        np.asarray(JF.dropout(jx, 0.1, training=False).value), x.numpy())


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_keep_rate_and_scale(mode):
    """At p = 0.1 over 10^6 elements, both packages keep ~0.9 of them;
    a kept value is x / 0.9 (upscale_in_train) or x (downscale_in_infer),
    a dropped one 0."""
    n, p = 1_000_000, 0.1
    x = torch.rand(n, generator=_gen(7)) + 1.0
    out = F.dropout(x, p, mode=mode, generator=_gen(8))
    jout = np.asarray(JF.dropout(JTensor(jnp.asarray(x.numpy())), p,
                                 mode=mode).value)
    scale = 1.0 / (1.0 - p) if mode == "upscale_in_train" else 1.0
    limit = 5.0 * math.sqrt(p * (1 - p) / n)
    for o in (out.numpy(), jout):
        kept = o != 0
        assert abs(kept.mean() - (1 - p)) <= limit
        np.testing.assert_allclose(o[kept], x.numpy()[kept] * scale,
                                   rtol=2e-7)
    # the mask comes from the generator: the same seed, the same mask
    assert torch.equal(out, F.dropout(x, p, mode=mode, generator=_gen(8)))


def test_dropout_edges():
    x = torch.randn(4, 6, 8, generator=_gen())
    assert not F.dropout(x, 1.0).any()
    with pytest.raises(ValueError, match="generator"):
        F.dropout(x, 0.5)
    with pytest.raises(ValueError, match="mode"):
        F.dropout(x, 0.5, mode="other", generator=_gen())
    # axis: one mask entry per (dim 0, dim 2) pair, shared along dim 1
    out = F.dropout(x, 0.5, axis=[0, 2], generator=_gen(9))
    kept = out != 0
    assert (kept == kept[:, :1, :]).all()


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------
def _trunc_std(a, b):
    """Standard deviation of the standard normal truncated to [a, b]."""
    pdf = lambda z: math.exp(-z * z / 2) / math.sqrt(2 * math.pi)
    cdf = lambda z: 0.5 * (1 + math.erf(z / math.sqrt(2)))
    zn = cdf(b) - cdf(a)
    mean = (pdf(a) - pdf(b)) / zn
    return math.sqrt(1 + (a * pdf(a) - b * pdf(b)) / zn - mean ** 2)


SHAPE = (1000, 1000)
INITS = {
    # name: (port initializer, reference initializer, mean, std, bounds)
    "constant": (I.Constant(0.25), JI.Constant(0.25), 0.25, 0.0, None),
    "normal": (I.Normal(0.5, 2.0), JI.Normal(0.5, 2.0), 0.5, 2.0, None),
    "truncated_normal": (I.TruncatedNormal(0.1, 0.5),
                         JI.TruncatedNormal(0.1, 0.5), 0.1,
                         0.5 * _trunc_std(-2.0, 2.0), (-0.9, 1.1)),
    "uniform": (I.Uniform(-0.5, 1.5), JI.Uniform(-0.5, 1.5), 0.5,
                2.0 / math.sqrt(12.0), (-0.5, 1.5)),
    "xavier_normal": (I.XavierNormal(), JI.XavierNormal(), 0.0,
                      math.sqrt(2.0 / 2000), None),
    "xavier_uniform": (I.XavierUniform(), JI.XavierUniform(), 0.0,
                       math.sqrt(6.0 / 2000) / math.sqrt(3.0),
                       (-math.sqrt(6.0 / 2000), math.sqrt(6.0 / 2000))),
}


@pytest.mark.parametrize("name", sorted(INITS))
def test_initializer_shape_and_moments_match_reference(name):
    init, jinit, mean, std, bounds = INITS[name]
    t = init(SHAPE, torch.float32, device="cpu", generator=_gen(10))
    j = np.asarray(jinit(SHAPE, "float32"))
    assert tuple(t.shape) == j.shape == SHAPE and t.dtype == torch.float32
    n = t.numel()
    for v in (t.numpy().astype(np.float64), j.astype(np.float64)):
        assert abs(v.mean() - mean) <= 5 * std / math.sqrt(n) + 1e-7
        assert abs(v.std() - std) <= 0.01 * std + 1e-7
        if bounds is not None:
            assert bounds[0] - 1e-6 <= v.min() and v.max() <= bounds[1] + 1e-6
    if std:
        again = init(SHAPE, torch.float32, device="cpu", generator=_gen(10))
        assert torch.equal(t, again)
        with pytest.raises(ValueError, match="generator"):
            init(SHAPE, torch.float32, device="cpu")
    assert init((3, 5), torch.bfloat16, device="cpu",
                generator=_gen()).dtype == torch.bfloat16


def test_layer_default_initializers_match_reference():
    """Linear and Embedding weights XavierNormal over their [in, out]
    fans, biases zero, LayerNorm ones and zeros — the reference's
    create_parameter defaults."""
    lin = nn.Linear(600, 400, device="cpu", generator=_gen(11))
    jlin = paddle_tpu.nn.Linear(600, 400)
    for w in (lin.weight.detach().numpy(), np.asarray(jlin.weight.value)):
        assert w.shape == (600, 400)
        assert abs(w.std() - math.sqrt(2.0 / 1000)) <= 0.01 * w.std()
    assert not lin.bias.any() and not np.asarray(jlin.bias.value).any()
    emb = nn.Embedding(3000, 100, device="cpu", generator=_gen(12))
    assert abs(emb.weight.std().item() - math.sqrt(2.0 / 3100)) \
        <= 0.01 * math.sqrt(2.0 / 3100)
    ln = nn.LayerNorm([4, 6], device="cpu")
    assert torch.equal(ln.weight, torch.ones(4, 6))
    assert torch.equal(ln.bias, torch.zeros(4, 6))
