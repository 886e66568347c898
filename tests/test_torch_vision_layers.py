"""The port's conv, pooling, BatchNorm and ReLU layers against
paddle_tpu's, on the CPU.

The same numpy inputs and weights, made from a seed, go through both
packages' functions and layers; gradients are held against `jax.vjp`
of the reference.  Then the Kaiming initializers, `calculate_gain`,
`Layer(name_scope, dtype)`, buffers (persistable or not) and the
raises for what the port leaves out.  Tolerances, with their reasons:

  * fp32 convolutions and their gradients: 1e-5 of the output's largest
    |value| plus 1e-5 relative — XLA and PyTorch's CPU convolutions sum
    the in-channel x window products in other orders;
  * pools, BatchNorm, ReLU and their gradients: 1e-5 absolute and
    relative (a max is exact; sums of a window, batch statistics and
    the normalization round alike up to order); the running statistics
    after 3 training forwards the same;
  * bf16 compute (`set_compute_dtype`) and a bf16 BatchNorm input:
    2^-4 of the largest |value| and 2e-2 relative — both round to bf16
    at the same points, but XLA and PyTorch's CPU kernels accumulate
    the bf16 products differently;
  * the initializers over 10^6 draws: the sample mean within 5 standard
    errors of 0, the sample std within 1% of the distribution's, every
    value inside a uniform's bounds, in both packages.
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

import paddle_tpu_torch.nn.layer as tlayer
from paddle_tpu_torch import nn
from paddle_tpu_torch.models import load_numpy_state_dict, numpy_state_dict
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as I

TOL = 1e-5
BF16_ATOL, BF16_RTOL = 2.0 ** -4, 2e-2


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _close(got, want, tol=TOL, err_msg=""):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape, (got.shape, want.shape, err_msg)
    np.testing.assert_allclose(
        got, want, rtol=tol,
        atol=tol * max(1.0, float(np.abs(want).max(initial=0.0))),
        err_msg=err_msg)


def _check_fn(jfn, tfn, arrays, seed):
    """Forward of both on the same numpy `arrays` (all fp32, all
    differentiable), then the vjp of each with one random cotangent."""
    jout = jfn(*[JTensor(jnp.asarray(a)) for a in arrays]).value
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    tout = tfn(*ts)
    _close(tout, jout)
    cot = np.random.RandomState(seed).randn(*jout.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda *vs: jfn(*[JTensor(v) for v in vs]).value,
                     *[jnp.asarray(a) for a in arrays])
    jgrads = vjp(jnp.asarray(cot))
    (tout * torch.from_numpy(cot)).sum().backward()
    for i, (t, g) in enumerate(zip(ts, jgrads)):
        _close(t.grad, g, err_msg=f"gradient of argument {i}")


# ---------------------------------------------------------------------------
# convolutions
# ---------------------------------------------------------------------------
# name: (nd, transpose, x shape (channels-first), in, out, kernel, kwargs)
CONVS = {
    "1d_stride2_pad1": (1, False, (2, 4, 13), 4, 6, 3,
                        dict(stride=2, padding=1)),
    "1d_same_dilation2_groups2": (1, False, (2, 4, 11), 4, 6, 3,
                                  dict(padding="same", dilation=2,
                                       groups=2)),
    "1d_nlc": (1, False, (2, 4, 9), 4, 5, 3,
               dict(padding=1, data_format="NLC")),
    "2d_plain": (2, False, (2, 3, 9, 9), 3, 8, 3, dict(padding=1)),
    "2d_stride2_n_ints": (2, False, (2, 3, 10, 9), 3, 8, 3,
                          dict(stride=2, padding=[1, 2])),
    "2d_asymmetric_2n_ints": (2, False, (2, 3, 9, 8), 3, 4, 3,
                              dict(padding=[1, 0, 2, 1])),
    "2d_nested_pairs": (2, False, (2, 3, 9, 8), 3, 4, 3,
                        dict(padding=[[2, 0], [0, 1]])),
    "2d_same_stride2": (2, False, (2, 3, 10, 11), 3, 4, 4,
                        dict(stride=2, padding="SAME")),
    "2d_valid": (2, False, (2, 3, 9, 9), 3, 4, 3, dict(padding="VALID")),
    "2d_dilation2": (2, False, (2, 3, 12, 12), 3, 4, 3,
                     dict(padding=2, dilation=2)),
    "2d_groups2": (2, False, (2, 4, 9, 9), 4, 6, 3,
                   dict(padding=1, groups=2)),
    "2d_depthwise": (2, False, (2, 6, 9, 9), 6, 6, 3,
                     dict(stride=2, padding=1, groups=6)),
    "2d_nhwc": (2, False, (2, 3, 8, 8), 3, 5, 3,
                dict(stride=2, padding=1, data_format="NHWC")),
    "3d_stride_1_2_1": (3, False, (2, 3, 5, 6, 5), 3, 4, 3,
                        dict(stride=(1, 2, 1), padding=1)),
    "3d_nested_pairs_with_nc": (3, False, (1, 3, 5, 6, 5), 3, 4, 3,
                                dict(padding=[[0, 0], [0, 0], [1, 0],
                                              [0, 1], [2, 1]])),
    "3d_same_ndhwc": (3, False, (1, 3, 5, 6, 5), 3, 4, 2,
                      dict(padding="SAME", data_format="NDHWC")),
    "t1d_stride2_outpad1": (1, True, (2, 4, 7), 4, 6, 3,
                            dict(stride=2, padding=1, output_padding=1)),
    "t1d_nlc": (1, True, (2, 4, 7), 4, 5, 3,
                dict(padding=1, data_format="NLC")),
    "t2d_stride2_outpad1": (2, True, (2, 4, 5, 6), 4, 3, 3,
                            dict(stride=2, padding=1, output_padding=1)),
    "t2d_groups2_dilation2": (2, True, (2, 4, 5, 5), 4, 6, 3,
                              dict(stride=2, padding=1, groups=2,
                                   dilation=2)),
    "t2d_same": (2, True, (2, 4, 5, 6), 4, 3, 4, dict(padding="SAME")),
    "t2d_valid_stride2": (2, True, (2, 4, 5, 6), 4, 3, 3,
                          dict(stride=2, padding="VALID")),
    "t2d_asymmetric": (2, True, (2, 4, 5, 6), 4, 3, 3,
                       dict(stride=2, padding=[1, 0, 2, 1])),
    "t2d_output_size": (2, True, (2, 4, 5, 6), 4, 3, 3,
                        dict(stride=2, padding=1, output_size=[10, 12])),
    "t2d_nhwc": (2, True, (2, 4, 5, 6), 4, 3, 3,
                 dict(stride=2, padding=1, data_format="NHWC")),
    "t3d_stride2": (3, True, (1, 4, 3, 4, 3), 4, 2, 3,
                    dict(stride=2, padding=1, output_padding=1)),
}
_FN_NAME = {(1, False): "conv1d", (2, False): "conv2d", (3, False): "conv3d",
            (1, True): "conv1d_transpose", (2, True): "conv2d_transpose",
            (3, True): "conv3d_transpose"}


def _conv_arrays(case, seed):
    nd, transpose, xshape, cin, cout, k, kw = CONVS[case]
    rng = np.random.RandomState(seed)
    groups = kw.get("groups", 1)
    wshape = (cin, cout // groups) if transpose else (cout, cin // groups)
    x = rng.randn(*xshape).astype(np.float32)
    if kw.get("data_format", "NCHW")[-1] == "C":
        x = np.ascontiguousarray(np.moveaxis(x, 1, -1))
    w = (rng.randn(*wshape, *(k,) * nd) / math.sqrt(cin * k ** nd)) \
        .astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("case", sorted(CONVS))
def test_conv_matches_reference(case):
    """Forward and the gradients of x, the weight and the bias."""
    nd, transpose, *_, kw = CONVS[case]
    name = _FN_NAME[nd, transpose]
    jfn, tfn = getattr(JF, name), getattr(F, name)
    _check_fn(lambda x, w, b: jfn(x, w, b, **kw),
              lambda x, w, b: tfn(x, w, b, **kw),
              _conv_arrays(case, 1), seed=2)


def test_conv_transpose_output_size_below_output_raises():
    x, w, b = _conv_arrays("t2d_stride2_outpad1", 3)
    with pytest.raises(ValueError, match="output_size"):
        F.conv2d_transpose(torch.from_numpy(x), torch.from_numpy(w),
                           stride=2, padding=1, output_size=[8, 8])


LAYER_CONVS = {
    "Conv1D": (lambda pkg, **kw: pkg.Conv1D(4, 6, 3, padding=1, **kw),
               (2, 4, 9)),
    "Conv2D": (lambda pkg, **kw: pkg.Conv2D(3, 8, 3, stride=2, padding=1,
                                            **kw), (2, 3, 9, 9)),
    "Conv2D_no_bias": (lambda pkg, **kw: pkg.Conv2D(3, 8, 1,
                                                    bias_attr=False, **kw),
                       (2, 3, 5, 5)),
    "Conv3D": (lambda pkg, **kw: pkg.Conv3D(3, 4, 3, padding=1, **kw),
               (1, 3, 4, 5, 4)),
    "Conv1DTranspose": (lambda pkg, **kw: pkg.Conv1DTranspose(
        4, 3, 3, stride=2, **kw), (2, 4, 7)),
    "Conv2DTranspose": (lambda pkg, **kw: pkg.Conv2DTranspose(
        4, 3, 3, stride=2, padding=1, output_padding=1, **kw), (2, 4, 5, 6)),
    "Conv3DTranspose": (lambda pkg, **kw: pkg.Conv3DTranspose(
        4, 2, 2, stride=2, **kw), (1, 4, 3, 3, 3)),
}


def _layer_pair(make, seed):
    jl = make(paddle_tpu.nn)
    tl = make(nn, device="cpu", generator=_gen(seed))
    w = {k: np.asarray(v.value) for k, v in jl.state_dict().items()}
    load_numpy_state_dict(tl, w)
    return jl, tl


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layer", sorted(LAYER_CONVS))
def test_conv_layer_matches_reference(layer, dtype):
    """The reference layer's own initial weights carried into the port;
    the outputs in fp32 and under set_compute_dtype("bfloat16") (fp32
    masters, bf16 compute: a bf16 output in both)."""
    make, xshape = LAYER_CONVS[layer]
    jl, tl = _layer_pair(make, 4)
    if dtype == "bfloat16":
        assert paddle_tpu.nn.set_compute_dtype(jl, dtype) \
            == nn.set_compute_dtype(tl, dtype) == 1
    x = np.random.RandomState(5).randn(*xshape).astype(np.float32)
    jout = jl(JTensor(jnp.asarray(x))).value
    tout = tl(torch.from_numpy(x))
    assert str(tout.dtype) == "torch." + str(jout.dtype)
    if dtype == "float32":
        _close(tout, jout)
    else:
        ref = np.asarray(jout.astype(jnp.float32))
        np.testing.assert_allclose(tout.float().detach().numpy(), ref,
                                   rtol=BF16_RTOL,
                                   atol=BF16_ATOL * np.abs(ref).max())
    assert all(p.dtype == torch.float32 for p in tl.parameters())


@pytest.mark.parametrize("transpose", [False, True])
def test_conv_layer_default_initializers(transpose):
    """KaimingUniform(fan_in) weights, limit sqrt(6 / fan_in), and
    Uniform(+-1 / sqrt(fan_in)) biases with fan_in = in / groups x
    prod(k), in both packages; the weight layout of each kind."""
    cls = "Conv2DTranspose" if transpose else "Conv2D"
    tl = getattr(nn, cls)(64, 96, 5, groups=2, device="cpu",
                          generator=_gen(6))
    jl = getattr(paddle_tpu.nn, cls)(64, 96, 5, groups=2)
    fan_in = 32 * 25
    shape = (64, 48, 5, 5) if transpose else (96, 32, 5, 5)
    for w, b in ((tl.weight.detach().numpy(), tl.bias.detach().numpy()),
                 (np.asarray(jl.weight.value), np.asarray(jl.bias.value))):
        assert w.shape == shape and b.shape == (96,)
        limit = math.sqrt(6.0 / fan_in)
        assert np.abs(w).max() <= limit
        assert abs(w.std() - limit / math.sqrt(3.0)) <= 0.03 * limit
        assert np.abs(b).max() <= 1.0 / math.sqrt(fan_in)


def test_conv_layer_padding_mode_other_than_zeros_raises():
    with pytest.raises(NotImplementedError, match="padding_mode"):
        nn.Conv2D(3, 4, 3, padding_mode="reflect", device="cpu",
                  generator=_gen())


# ---------------------------------------------------------------------------
# pools
# ---------------------------------------------------------------------------
# name: (function, x shape (channels-first), kwargs)
POOLS = {
    "max1d": ("max_pool1d", (2, 3, 11), dict(kernel_size=3, stride=2,
                                             padding=1)),
    "max2d_resnet_stem": ("max_pool2d", (2, 3, 16, 16),
                          dict(kernel_size=3, stride=2, padding=1)),
    "max2d_default_stride": ("max_pool2d", (2, 3, 8, 9),
                             dict(kernel_size=2)),
    "max2d_wide_pad": ("max_pool2d", (2, 3, 7, 7),
                       dict(kernel_size=3, stride=1, padding=2)),
    "max2d_asymmetric": ("max_pool2d", (2, 3, 7, 8),
                         dict(kernel_size=3, stride=2,
                              padding=[0, 1, 1, 0])),
    "max2d_same": ("max_pool2d", (2, 3, 9, 10),
                   dict(kernel_size=3, stride=2, padding="SAME")),
    "max2d_nhwc": ("max_pool2d", (2, 3, 8, 8),
                   dict(kernel_size=2, stride=2, data_format="NHWC")),
    "max3d": ("max_pool3d", (1, 2, 5, 6, 5),
              dict(kernel_size=2, stride=2, padding=1)),
    "avg1d_exclusive": ("avg_pool1d", (2, 3, 11),
                        dict(kernel_size=3, stride=2, padding=1)),
    "avg1d_inclusive": ("avg_pool1d", (2, 3, 11),
                        dict(kernel_size=3, stride=2, padding=1,
                             exclusive=False)),
    "avg2d_exclusive": ("avg_pool2d", (2, 3, 9, 9),
                        dict(kernel_size=3, stride=2, padding=1)),
    "avg2d_inclusive": ("avg_pool2d", (2, 3, 9, 9),
                        dict(kernel_size=3, stride=2, padding=1,
                             exclusive=False)),
    "avg2d_wide_pad_exclusive": ("avg_pool2d", (2, 3, 7, 7),
                                 dict(kernel_size=3, padding=2, stride=1)),
    "avg2d_asymmetric_exclusive": ("avg_pool2d", (2, 3, 7, 8),
                                   dict(kernel_size=3, stride=2,
                                        padding=[0, 1, 1, 0])),
    "avg2d_asymmetric_inclusive": ("avg_pool2d", (2, 3, 7, 8),
                                   dict(kernel_size=3, stride=2,
                                        padding=[0, 1, 1, 0],
                                        exclusive=False)),
    "avg2d_same": ("avg_pool2d", (2, 3, 9, 10),
                   dict(kernel_size=3, stride=2, padding="SAME")),
    "avg2d_valid": ("avg_pool2d", (2, 3, 9, 10),
                    dict(kernel_size=3, stride=2, padding="VALID")),
    "avg2d_nhwc": ("avg_pool2d", (2, 3, 8, 8),
                   dict(kernel_size=3, stride=2, padding=1,
                        data_format="NHWC")),
    "avg3d_exclusive": ("avg_pool3d", (1, 2, 5, 6, 5),
                        dict(kernel_size=3, stride=2, padding=1)),
    "adaptive_avg1d_7to3": ("adaptive_avg_pool1d", (2, 3, 7),
                            dict(output_size=3)),
    "adaptive_avg2d_1x1": ("adaptive_avg_pool2d", (2, 3, 4, 4),
                           dict(output_size=(1, 1))),
    "adaptive_avg2d_7to3_5to2": ("adaptive_avg_pool2d", (2, 3, 7, 5),
                                 dict(output_size=(3, 2))),
    "adaptive_avg2d_divides": ("adaptive_avg_pool2d", (2, 3, 8, 6),
                               dict(output_size=(4, 3))),
    "adaptive_avg2d_keep_width": ("adaptive_avg_pool2d", (2, 3, 7, 5),
                                  dict(output_size=(3, None))),
    "adaptive_avg2d_nhwc": ("adaptive_avg_pool2d", (2, 3, 7, 7),
                            dict(output_size=3, data_format="NHWC")),
    "adaptive_avg3d": ("adaptive_avg_pool3d", (1, 2, 5, 7, 4),
                       dict(output_size=(2, 3, 3))),
    "adaptive_max1d_7to3": ("adaptive_max_pool1d", (2, 3, 7),
                            dict(output_size=3)),
    "adaptive_max2d_7to3": ("adaptive_max_pool2d", (2, 3, 7, 7),
                            dict(output_size=3)),
    "adaptive_max3d": ("adaptive_max_pool3d", (1, 2, 5, 7, 4),
                       dict(output_size=(2, 3, 3))),
}


@pytest.mark.parametrize("case", sorted(POOLS))
def test_pool_matches_reference(case):
    """Forward and the gradient of x (random values: no ties in a max)."""
    name, xshape, kw = POOLS[case]
    x = np.random.RandomState(7).randn(*xshape).astype(np.float32)
    if kw.get("data_format", "NCHW")[-1] == "C":
        x = np.ascontiguousarray(np.moveaxis(x, 1, -1))
    jfn, tfn = getattr(JF, name), getattr(F, name)
    _check_fn(lambda v: jfn(v, **kw), lambda v: tfn(v, **kw), [x], seed=8)


POOL_LAYERS = {
    "MaxPool2D": dict(kernel_size=3, stride=2, padding=1),
    "AvgPool2D": dict(kernel_size=3, stride=2, padding=1, exclusive=False),
    "AvgPool1D": dict(kernel_size=2),
    "MaxPool3D": dict(kernel_size=2),
    "AdaptiveAvgPool2D": dict(output_size=(3, 2)),
    "AdaptiveMaxPool2D": dict(output_size=3),
    "AdaptiveAvgPool1D": dict(output_size=3),
    "AdaptiveMaxPool3D": dict(output_size=2),
}


@pytest.mark.parametrize("layer", sorted(POOL_LAYERS))
def test_pool_layer_matches_reference(layer):
    kw = POOL_LAYERS[layer]
    nd = int(layer[-2])
    x = np.random.RandomState(9).randn(2, 3, *(7,) * nd).astype(np.float32)
    jout = getattr(paddle_tpu.nn, layer)(**kw)(JTensor(jnp.asarray(x)))
    _close(getattr(nn, layer)(**kw)(torch.from_numpy(x)), jout.value)


@pytest.mark.parametrize("call", [
    lambda x: F.max_pool2d(x, 2, ceil_mode=True),
    lambda x: F.avg_pool2d(x, 2, ceil_mode=True),
    lambda x: F.max_pool2d(x, 2, return_mask=True),
    lambda x: F.max_pool1d(x[0], 2, return_mask=True),
    lambda x: F.adaptive_max_pool2d(x, 2, return_mask=True),
    lambda x: F.avg_pool2d(x, 2, divisor_override=3),
    lambda x: nn.MaxPool2D(2, ceil_mode=True)(x),
    lambda x: nn.MaxPool2D(2, return_mask=True)(x),
    lambda x: nn.AdaptiveMaxPool2D(2, return_mask=True)(x),
], ids=["max_ceil", "avg_ceil", "max_mask", "max1d_mask", "adaptive_mask",
        "divisor_override", "layer_ceil", "layer_mask",
        "layer_adaptive_mask"])
def test_pool_options_the_reference_ignores_raise(call):
    """The reference takes these and computes as if they were not given
    (paddle_tpu/nn/functional/pooling.py:48-77); the port raises."""
    with pytest.raises(NotImplementedError, match="not ported"):
        call(torch.randn(2, 3, 8, 8))


# ---------------------------------------------------------------------------
# BatchNorm
# ---------------------------------------------------------------------------
# name: (x shape, data_format, use_global_stats)
BN_CASES = {
    "nchw": ((4, 3, 5, 6), "NCHW", None),
    "nhwc": ((4, 5, 6, 3), "NHWC", None),
    "nc": ((8, 3), "NCHW", None),
    "ncl": ((4, 3, 7), "NCL", None),
    "ncdhw": ((2, 3, 3, 4, 3), "NCDHW", None),
    "global_stats": ((4, 3, 5, 6), "NCHW", True),
}


def _bn_arrays(shape, c, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 2.0 + 0.5).astype(np.float32)
    w = (1.0 + 0.1 * rng.randn(c)).astype(np.float32)
    b = (0.1 * rng.randn(c)).astype(np.float32)
    rm = (0.1 * rng.randn(c)).astype(np.float32)
    rv = (1.0 + 0.2 * rng.rand(c)).astype(np.float32)
    return x, w, b, rm, rv


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_batch_norm_matches_reference(case, training):
    """Three forwards (each updating the running statistics in place in
    training, unless use_global_stats), then the gradients of x, the
    weight and the bias of one more."""
    shape, fmt, ugs = BN_CASES[case]
    c = shape[-1] if fmt[-1] == "C" and len(shape) > 2 else shape[1]
    x, w, b, rm, rv = _bn_arrays(shape, c, 10)
    kw = dict(training=training, momentum=0.9, epsilon=1e-5,
              data_format=fmt, use_global_stats=ugs)
    jrm, jrv = JTensor(jnp.asarray(rm)), JTensor(jnp.asarray(rv))
    trm, trv = torch.from_numpy(rm.copy()), torch.from_numpy(rv.copy())
    for i in range(3):
        xi = x + 0.3 * i
        jout = JF.batch_norm(JTensor(jnp.asarray(xi)), jrm, jrv,
                             JTensor(jnp.asarray(w)), JTensor(jnp.asarray(b)),
                             **kw).value
        tout = F.batch_norm(torch.from_numpy(xi), trm, trv,
                            torch.from_numpy(w), torch.from_numpy(b), **kw)
        _close(tout, jout)
    _close(trm, jrm.value, err_msg="running mean")
    _close(trv, jrv.value, err_msg="running variance")
    moved = training and not ugs
    assert moved == (not np.array_equal(trm.numpy(), rm))

    def jfn(v, wt, bs):
        return JF.batch_norm(v, jrm, jrv, wt, bs, **kw)

    def tfn(v, wt, bs):
        return F.batch_norm(v, trm.clone(), trv.clone(), wt, bs, **kw)
    _check_fn(jfn, tfn, [x, w, b], seed=11)


def test_batch_norm_bf16_input_keeps_fp32_statistics():
    """A bf16 input: fp32 statistics, the normalized value rounded to
    bf16, then the fp32 affine (an fp32 result, as jnp promotes it); the
    running statistics stay fp32."""
    x, w, b, rm, rv = _bn_arrays((4, 3, 5, 6), 3, 12)
    jx = JTensor(jnp.asarray(x).astype(jnp.bfloat16))
    tx = torch.from_numpy(x).to(torch.bfloat16)
    jrm, jrv = JTensor(jnp.asarray(rm)), JTensor(jnp.asarray(rv))
    trm, trv = torch.from_numpy(rm.copy()), torch.from_numpy(rv.copy())
    jout = JF.batch_norm(jx, jrm, jrv, JTensor(jnp.asarray(w)),
                         JTensor(jnp.asarray(b)), training=True).value
    tout = F.batch_norm(tx, trm, trv, torch.from_numpy(w),
                        torch.from_numpy(b), training=True)
    assert str(tout.dtype) == "torch." + str(jout.dtype)
    np.testing.assert_allclose(tout.float().numpy(),
                               np.asarray(jout, np.float32),
                               atol=BF16_ATOL, rtol=BF16_RTOL)
    _close(trm, jrm.value)
    _close(trv, jrv.value)
    assert trm.dtype == trv.dtype == torch.float32


@pytest.mark.parametrize("layer", ["BatchNorm1D", "BatchNorm2D",
                                   "BatchNorm3D", "BatchNorm"])
def test_batch_norm_layers_match_reference(layer):
    """Each layer from the same weights and buffers, two training
    forwards and one in eval: outputs and the buffers `_mean` and
    `_variance`, in the state dict under those names."""
    nd = {"BatchNorm1D": 1, "BatchNorm2D": 2, "BatchNorm3D": 3,
          "BatchNorm": 2}[layer]
    jl = getattr(paddle_tpu.nn, layer)(3)
    tl = getattr(nn, layer)(3, device="cpu")
    assert list(tl.state_dict()) == ["weight", "bias", "_mean", "_variance"]
    assert list(jl.state_dict()) == list(tl.state_dict())
    x, w, b, rm, rv = _bn_arrays((4, 3, *(5,) * nd), 3, 13)
    state = {"weight": w, "bias": b, "_mean": rm, "_variance": rv}
    jl.set_state_dict(state)
    load_numpy_state_dict(tl, state)
    for mode in ("train", "train", "eval"):
        getattr(jl, mode)()
        getattr(tl, mode)()
        _close(tl(torch.from_numpy(x)), jl(JTensor(jnp.asarray(x))).value)
    got = numpy_state_dict(tl)
    for k, v in jl.state_dict().items():
        _close(got[k], v.value, err_msg=k)


def test_batch_norm_act_and_sync_batch_norm():
    x = torch.randn(4, 3, 5, 5, generator=_gen(14))
    bn = nn.BatchNorm(3, act="relu", device="cpu")
    assert (bn(x) >= 0).all()
    with pytest.raises(NotImplementedError, match="item 8"):
        nn.SyncBatchNorm(3, device="cpu")


# ---------------------------------------------------------------------------
# ReLU, ReLU6
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fn", ["relu", "relu6"])
def test_activation_matches_reference(fn):
    x = (np.random.RandomState(15).randn(4, 5, 6) * 4.0).astype(np.float32)
    _check_fn(getattr(JF, fn), getattr(F, fn), [x], seed=16)
    layer = {"relu": "ReLU", "relu6": "ReLU6"}[fn]
    _close(getattr(nn, layer)()(torch.from_numpy(x)),
           getattr(paddle_tpu.nn, layer)()(JTensor(jnp.asarray(x))).value)


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------
SHAPE = (1000, 1000)
FAN = 250


@pytest.mark.parametrize("fan_in", [None, FAN], ids=["fans", "given"])
@pytest.mark.parametrize("name", ["KaimingUniform", "KaimingNormal"])
def test_kaiming_bounds_and_moments_match_reference(name, fan_in):
    """std = sqrt(2 / fan_in) (relu's gain over sqrt(fan_in)); the
    uniform's limit sqrt(6 / fan_in).  fan_in from the shape's fans
    (1000 in) or given."""
    fi = SHAPE[0] if fan_in is None else fan_in
    std = math.sqrt(2.0 / fi)
    t = getattr(I, name)(fan_in=fan_in)(SHAPE, torch.float32, device="cpu",
                                          generator=_gen(17))
    j = np.asarray(getattr(JI, name)(fan_in=fan_in)(SHAPE, "float32"))
    n = t.numel()
    for v in (t.numpy().astype(np.float64), j.astype(np.float64)):
        assert abs(v.mean()) <= 5 * std / math.sqrt(n)
        assert abs(v.std() - std) <= 0.01 * std
        if name == "KaimingUniform":
            assert np.abs(v).max() <= math.sqrt(6.0 / fi) + 1e-7
    with pytest.raises(ValueError, match="generator"):
        getattr(I, name)()(SHAPE, torch.float32, device="cpu")


@pytest.mark.parametrize("nonlinearity,param", [
    ("linear", None), ("conv2d", None), ("sigmoid", None), ("tanh", None),
    ("relu", None), ("leaky_relu", None), ("leaky_relu", 0.2),
    ("selu", None)])
def test_calculate_gain_matches_reference(nonlinearity, param):
    assert I.calculate_gain(nonlinearity, param) \
        == JI.calculate_gain(nonlinearity, param)


def test_calculate_gain_unknown_raises():
    with pytest.raises(ValueError, match="unknown"):
        I.calculate_gain("swish")


# ---------------------------------------------------------------------------
# Layer(name_scope, dtype) and buffers
# ---------------------------------------------------------------------------
def test_layer_name_scope_and_dtype_match_reference(monkeypatch):
    """A name scope names the layer `{scope}_{n}` (its own counter) and
    its parameters `{scope}_{n}.{attr}`; `create_parameter` falls back
    to the layer's dtype."""
    monkeypatch.setattr(jlayers, "_layer_name_counters",
                        collections.defaultdict(int))
    monkeypatch.setattr(tlayer, "_layer_name_counters",
                        collections.defaultdict(int))
    names = []
    for pkg, kw in ((paddle_tpu.nn, {}),
                    (nn, dict(device="cpu", generator=_gen()))):
        a, b = pkg.Layer("block"), pkg.Layer("block", dtype="bfloat16")
        c = pkg.Layer()
        a.w = a.create_parameter([2, 3], **kw)
        b.w = b.create_parameter([2, 3], **kw)
        names.append([a.full_name(), b.full_name(), c.full_name(),
                      a.w.name if pkg is paddle_tpu.nn else a.w.auto_name,
                      str(b.w.dtype).split(".")[-1]])
    assert names[0] == names[1] == ["block_0", "block_1", "layer_0",
                                    "block_0.w", "bfloat16"]


def _buffered(pkg, tensor):
    layer = pkg.Layer()
    layer.lin = pkg.Linear(2, 2, **(
        dict(device="cpu", generator=_gen()) if pkg is nn else {}))
    layer.register_buffer("kept", tensor(np.arange(3, dtype=np.float32)))
    layer.register_buffer("scratch", tensor(np.ones(2, np.float32)),
                          persistable=False)
    layer.lin.register_buffer("inner", tensor(np.zeros(4, np.float32)))
    return layer


def test_buffers_persist_as_the_reference():
    """A persistable buffer is in `state_dict` (a sublayer's under its
    structural name) and in `models.convert`, a non-persistable one in
    neither, in both packages; buffers move with the module."""
    jl = _buffered(paddle_tpu.nn, lambda a: JTensor(jnp.asarray(a)))
    tl = _buffered(nn, torch.from_numpy)
    assert sorted(jl.state_dict()) == sorted(tl.state_dict()) \
        == ["kept", "lin.bias", "lin.inner", "lin.weight"]
    assert sorted(numpy_state_dict(tl)) == sorted(tl.state_dict())
    assert sorted(n for n, _ in tl.named_buffers()) == \
        ["kept", "lin.inner", "scratch"]
    state = numpy_state_dict(tl)
    state["kept"] = np.array([5.0, 6.0, 7.0], np.float32)
    load_numpy_state_dict(tl, state)
    assert tl.kept.tolist() == [5.0, 6.0, 7.0]
    assert tl.double().kept.dtype == torch.float64
