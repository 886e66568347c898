"""The port's SD-style UNet and its new layers against paddle_tpu's, on
the CPU.

  * `silu` / `swish`, `group_norm` (NCHW and NHWC, with and without the
    affine) and the `GroupNorm` layer (fp32, and under
    `set_compute_dtype("bfloat16")` in both packages) against the
    reference's, gradients against `jax.vjp`;
  * `timestep_embedding` against the reference's (to a few ulps of its
    largest argument, t = 999: the frequencies are `exp` in two
    implementations);
  * `UNet2DConditionModel` at `unet_tiny_config` and at a narrow config
    with the SD config's head dims (160 and 320 channels over 2 heads:
    80 and 160, attention at both levels): the same numpy weights in
    both packages (models/convert.py), then the output, the epsilon MSE
    loss, every gradient (against `jax.value_and_grad`, jitted with the
    weights as arguments), and 2 AdamW `TrainStep` steps against the
    reference's `jit.TrainStep`.  On the CPU the port's attention is the
    plain version; the kernels are held on the card by chip_smoke.py
    phase 17.

Inputs and weights are made from a seed with numpy.  Tolerances, with
their reasons:

  * fp32 elementwise and normalization ops: 1e-5 absolute and relative
    (the same fp32 math; sums in another order);
  * bf16 results: 2^-7 of the largest entry plus one bf16 ulp of each
    (a rounding that flips between the packages' kernels);
  * fp32 model output and loss: 1e-5 of the output's largest entry, and
    rtol 1e-5 (convolutions, matmuls and GroupNorm statistics sum in
    other orders, ~1e-6 relative);
  * fp32 gradients: 1e-5 + 1e-4 of each tensor's largest entry
    (tests/test_torch_llama_train.py's limits);
  * after 2 AdamW steps (lr 1e-3): the losses rtol 1e-5; each
    parameter within 2e-5 of the reference for 99.9% of its entries and
    within 2 lr steps for all (Adam divides by the gradient's root mean
    square, so an entry whose gradient is rounding noise in both
    packages moves ~lr in either direction).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_cpu import one_cpu_thread  # noqa: F401 (autouse)

import paddle_tpu
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.framework import dtypes as jdtypes
from paddle_tpu.framework.tensor import Tensor as JTensor
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.jit import _swapped_state
from paddle_tpu.models import unet as junet
from paddle_tpu.nn.layer import layers as jlayers

from paddle_tpu_torch import nn
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (UNet2DConditionModel, UNetConfig,
                                     load_numpy_state_dict,
                                     numpy_state_dict, timestep_embedding,
                                     unet_tiny_config)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import AdamW

TOL = 1e-5
LR, STEPS = 1e-3, 2


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    v = x.value if isinstance(x, JTensor) else x
    return np.asarray(jnp.asarray(v).astype(jnp.float32))


def _bf16_close(got, want):
    g, w = _np(got), _np(want)
    np.testing.assert_allclose(g, w, rtol=2.0 ** -8,
                               atol=2.0 ** -7 * np.abs(w).max())


# ---------------------------------------------------------------------------
# silu, group_norm, GroupNorm, timestep_embedding
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fn", ["silu", "swish"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_silu_matches_reference(fn, dt):
    x = np.random.RandomState(0).randn(4, 7, 5).astype(np.float32) * 3
    got = getattr(F, fn)(torch.from_numpy(x).to(getattr(torch, dt)))
    want = getattr(JF, fn)(JTensor(jnp.asarray(x).astype(dt)))
    assert str(got.dtype) == "torch." + str(want.value.dtype)
    if dt == "float32":
        np.testing.assert_allclose(_np(got), _np(want), atol=TOL, rtol=TOL)
    else:
        _bf16_close(got, want)


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_group_norm_matches_reference(dt, fmt, affine):
    """Output (dtype promoted as jnp promotes: a bf16 input with fp32
    affine parameters gives fp32) and, in fp32, the gradients of x, the
    weight and the bias against jax.vjp."""
    rng = np.random.RandomState(1)
    shape = (2, 12, 5, 3) if fmt == "NCHW" else (2, 5, 3, 12)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.randn(12)).astype(np.float32)
    b = (0.1 * rng.randn(12)).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    wb = (w, b) if affine else (None, None)
    jx = jnp.asarray(x).astype(dt)

    def ref(xv, *p):
        pw, pb = (JTensor(v) for v in p) if p else (None, None)
        return JF.group_norm(JTensor(xv), 4, 1e-5, pw, pb, fmt).value

    jargs = [jnp.asarray(a) for a in wb if a is not None]
    want, vjp = jax.vjp(ref, jx, *jargs)
    leaves = [torch.from_numpy(a.copy()).requires_grad_(True)
              for a in wb if a is not None]
    tx = torch.from_numpy(x).to(getattr(torch, dt)).requires_grad_(True)
    got = F.group_norm(tx, 4, 1e-5, *(leaves or (None, None)),
                       data_format=fmt)
    assert str(got.dtype) == "torch." + str(want.dtype)
    if dt == "bfloat16":
        _bf16_close(got, want)
        return
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL, rtol=TOL)
    (got * torch.from_numpy(g)).sum().backward()
    for port, r in zip([tx, *leaves], vjp(jnp.asarray(g))):
        np.testing.assert_allclose(_np(port.grad), _np(r), atol=1e-4,
                                   rtol=TOL)


@pytest.mark.parametrize("compute", [None, "bfloat16"])
def test_group_norm_layer_matches_reference(compute):
    """The GroupNorm layer with the reference's default parameters and
    names, fp32 and switched to a bf16 compute dtype in both packages
    (fp32 statistics, the result cast)."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 16, 4, 4).astype(np.float32)
    jl = jnn.GroupNorm(4, 16)
    tl = nn.GroupNorm(4, 16, device="cpu")
    assert sorted(n for n, _ in tl.named_parameters()) == \
        sorted(jl.state_dict())
    w = {n: (1 + 0.1 * rng.randn(16)).astype(np.float32)
         for n in jl.state_dict()}
    jl.set_state_dict(w)
    load_numpy_state_dict(tl, w)
    if compute:
        assert jnn.set_compute_dtype(jl, compute) == \
            nn.set_compute_dtype(tl, compute) == 1
    want = jl(JTensor(jnp.asarray(x)))
    got = tl(torch.from_numpy(x))
    assert str(got.dtype) == "torch." + str(want.value.dtype)
    if compute:
        _bf16_close(got, want)
    else:
        np.testing.assert_allclose(_np(got), _np(want), atol=TOL, rtol=TOL)


def test_timestep_embedding_matches_reference():
    t = np.array([0, 1, 17, 500, 999], np.int32)
    for dim in (32, 320):
        got = timestep_embedding(torch.from_numpy(t), dim)
        want = junet.timestep_embedding(jnp.asarray(t), dim)
        assert got.dtype == torch.float32 and got.shape == (5, dim)
        # the frequencies are exp() in two implementations, an ulp or
        # two apart, which moves an argument t f by ~t 2^-23: at t = 999
        # the sines and cosines by up to ~1.2e-4 (measured 5.7e-5)
        np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                                   atol=8 * 2.0 ** -24 * t.max())


# ---------------------------------------------------------------------------
# the UNet
# ---------------------------------------------------------------------------
def _narrow_config(**kw):
    """bench_unet's head dims at a narrow width: 160 and 320 channels
    over 2 heads are head dims 80 and 160, attention at both levels."""
    return dict(block_channels=(160, 320), attention_levels=(0, 1),
                num_attention_heads=2, layers_per_block=1,
                cross_attention_dim=64, norm_groups=32, **kw)


CONFIGS = {"tiny": (lambda **kw: dict(**kw), 16, 8),
           "narrow": (_narrow_config, 8, 5)}


def _weights(jm, seed):
    """1-D parameters (norm scales, biases) 1 + 0.1 N(0, 1), matrices
    N(0, 1) / sqrt(fan in)."""
    rng = np.random.RandomState(seed)
    out = {}
    for n, p in jm.state_dict().items():
        shape = tuple(p.shape)
        fan = shape[0] if len(shape) == 2 else int(np.prod(shape[1:]))
        out[n] = ((1 + 0.1 * rng.randn(*shape)) if len(shape) == 1
                  else rng.randn(*shape) / np.sqrt(fan)).astype(np.float32)
    return out


@contextlib.contextmanager
def _zero_parameters():
    """The reference's layers built with zero parameters, put on the
    device from numpy: `_pair` sets every one from numpy right after,
    and the reference's initializers compile one XLA kernel a parameter
    shape on first use (~15 s a config on the CPU)."""
    create = jlayers.Layer.create_parameter

    def zeros(shape, dtype):
        return jnp.asarray(np.zeros(shape, jdtypes.to_jax(dtype)))

    def create_zero(self, shape, attr=None, dtype=None, is_bias=False,
                    default_initializer=None):
        return create(self, shape, attr=attr, dtype=dtype, is_bias=is_bias,
                      default_initializer=zeros)
    jlayers.Layer.create_parameter = create_zero
    try:
        yield
    finally:
        jlayers.Layer.create_parameter = create


def _pair(name, seed=0, dtype="float32"):
    make, hw, ctx_len = CONFIGS[name]
    kw = make(dtype=dtype)
    with _zero_parameters():
        jm = junet.UNet2DConditionModel(junet.unet_tiny_config(**kw))
    w = _weights(jm, seed)
    jm.set_state_dict(w)
    tm = UNet2DConditionModel(unet_tiny_config(**kw), device="cpu")
    load_numpy_state_dict(tm, w)
    return jm, tm, hw, ctx_len


def _batch(cfg_in, cross, hw, ctx_len, seed=1, b=2):
    """bench_unet's inputs at a small size: latents, timesteps in
    [0, 1000), the context and the noise target."""
    rng = np.random.RandomState(seed)
    return (rng.randn(b, cfg_in, hw, hw).astype(np.float32),
            rng.randint(0, 1000, (b,)).astype(np.int32),
            rng.randn(b, ctx_len, cross).astype(np.float32),
            rng.randn(b, 4, hw, hw).astype(np.float32))


def _ref_loss_and_grads(jm, x, t, ctx, eps):
    names = [n for n, _ in jm.named_parameters()]
    sd = jm.state_dict()

    def loss_of(vals, xv, tv, cv, ev):
        with _swapped_state(jm, names, list(vals)):
            out = jm(JTensor(xv), JTensor(tv), JTensor(cv))
            return jm.compute_loss(out, JTensor(ev)).value, out.value
    (loss, out), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
        [sd[n]._value for n in names], *(jnp.asarray(a)
                                         for a in (x, t, ctx, eps)))
    return np.asarray(out), float(loss), {n: np.asarray(g)
                                          for n, g in zip(names, grads)}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_unet_output_loss_and_grads_match_reference(name):
    jm, tm, hw, ctx_len = _pair(name)
    cfg = tm.config
    assert sorted(n for n, _ in tm.named_parameters()) == \
        sorted(jm.state_dict())
    x, t, ctx, eps = _batch(cfg.in_channels, cfg.cross_attention_dim, hw,
                            ctx_len)
    jout, jloss, jgrads = _ref_loss_and_grads(jm, x, t, ctx, eps)
    out = tm(*(torch.from_numpy(a) for a in (x, t, ctx)))
    assert out.shape == x.shape[:1] + (cfg.out_channels, hw, hw)
    np.testing.assert_allclose(_np(out), jout, rtol=TOL,
                               atol=TOL * np.abs(jout).max())
    loss = tm.compute_loss(out, torch.from_numpy(eps))
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), jloss, rtol=TOL)
    loss.backward()
    params = dict(tm.named_parameters())
    for n, ref in jgrads.items():
        np.testing.assert_allclose(_np(params[n].grad), ref,
                                   atol=1e-5 + 1e-4 * np.abs(ref).max(),
                                   err_msg=n)


def test_unet_bf16_output_matches_reference():
    """The tiny UNet under a bf16 compute dtype (fp32 masters) in both
    packages: the output within the bf16 rounding of its scale."""
    jm, tm, hw, ctx_len = _pair("tiny", dtype="bfloat16")
    x, t, ctx, _ = _batch(4, 32, hw, ctx_len)
    names = [n for n, _ in jm.named_parameters()]
    sd = jm.state_dict()

    def forward(vals, xv, tv, cv):      # jitted: one compile, not one an op
        with _swapped_state(jm, names, list(vals)):
            return jm(JTensor(xv), JTensor(tv), JTensor(cv)).value
    want = JTensor(jax.jit(forward)([sd[n]._value for n in names],
                                    *(jnp.asarray(a) for a in (x, t, ctx))))
    got = tm(*(torch.from_numpy(a) for a in (x, t, ctx)))
    assert got.dtype == torch.bfloat16 == getattr(torch, str(
        want.value.dtype))
    g, w = _np(got), _np(want)
    # ~20 layers of bf16 roundings: 2^-4 of the output's scale
    np.testing.assert_allclose(g, w, rtol=0, atol=2.0 ** -4 * np.abs(w).max())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_unet_adamw_train_steps_match_reference(name):
    """bench_unet's step (AdamW in TrainStep on compute_loss) for 2 steps
    from the same weights and batches, against the reference's."""
    jm, tm, hw, ctx_len = _pair(name, seed=3)
    cfg = tm.config
    jstep = JTrainStep(jm, lambda o, y: jm.compute_loss(o, y),
                       paddle_tpu.optimizer.AdamW(
                           LR, parameters=jm.parameters()))
    step = TrainStep(tm, tm.compute_loss,
                     AdamW(LR, parameters=tm.parameters()))
    jl, tl = [], []
    for i in range(STEPS):
        batch = _batch(cfg.in_channels, cfg.cross_attention_dim, hw,
                       ctx_len, seed=10 + i)
        jl.append(float(np.asarray(jstep(*(paddle_tpu.to_tensor(a)
                                           for a in batch)).value)))
        tl.append(step(*batch).item())
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    got = numpy_state_dict(tm)
    want = {k: np.asarray(v.value, np.float32)
            for k, v in jm.state_dict().items()}
    assert sorted(got) == sorted(want)
    for n in want:
        d = np.abs(got[n] - want[n])
        assert d.max() <= 2 * LR * STEPS, (n, d.max())
        assert np.quantile(d, 0.999) <= 2e-5, (n, np.quantile(d, 0.999))


def test_unet_config_and_attention_count():
    """unet_sd_config's shape: 3 levels of 320/640/1280 channels, 11
    attention blocks (2 + 2 down, the mid one, 3 + 3 up) at head dims 80
    and 160; unet_tiny_config's 2 levels and 4 blocks (1 down, the mid
    one, 2 up)."""
    from paddle_tpu_torch.models import unet_sd_config
    cfg = unet_sd_config()
    assert cfg == UNetConfig()
    assert cfg.block_channels == (320, 640, 1280)
    assert {c // cfg.num_attention_heads
            for i, c in enumerate(cfg.block_channels)
            if i in cfg.attention_levels} == {80, 160}
    tm = UNet2DConditionModel(unet_tiny_config(), device="cpu")
    blocks = [m for m in tm.modules() if type(m).__name__ == "AttentionBlock"]
    assert len(blocks) == 4
    assert sum(a is None for a in tm.down_attns) == 1
