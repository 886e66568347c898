"""The numerical margin of the fp32 flash kernels' three-pass TF32 split
(`paddle_tpu_torch/csrc/flash_attention_f32.cu`), emulated on the CPU.

The kernels split each fp32 operand x into hi = tf32(x) (round to
nearest on the 10 mantissa bits kept, ties away from zero, as
`cvt.rna.tf32.f32` rounds a finite x; the kernels add 0x1000 to its bits
and clear the low 13) and lo = tf32(x - hi), and take a product a.b as
lo_a.hi_b + hi_a.lo_b + hi_a.hi_b: three TF32 products on the tensor
cores (mma.sync m16n8k8), each exact (11-bit significands), accumulated
in fp32 one k-step of 8 at a time.  Here the same arithmetic runs in plain PyTorch: each k-step's
products in fp64 (exact), rounded to fp32 and added to an fp32
accumulator in the kernels' order.

Both products of the forward are held against fp64, from numpy-seeded
inputs at ViT-B/16's head shape ([32, 197, 12, 64] cut to batch 2) and
at head dims 8, 80, 160 and 256: S = Q.K^T and P.V, P the softmax of
the scaled scores.  The three-pass result stays within 2^-18 sum |a||b|
of fp64 at every element: 1/64 of the fp32 term 2^-12 sum |w||x| that
chip_smoke.py's `_rounding_tolerance` allows the kernels against their
plain versions (each term is off by ~3 2^-22 |a||b|, the sums by a few
fp32 roundings).  One pass (hi.hi alone) strays beyond 2^-14 sum |a||b|
at some element: the split is what buys the accuracy.
"""
import numpy as np
import pytest
import torch
from torch_cpu import one_cpu_thread  # noqa: F401 (autouse)

THREE_PASS_TOL = 2.0 ** -18
ONE_PASS_MIN = 2.0 ** -14

# (case, b, sq, sk, h, d): q [b, sq, h, d], k/v [b, sk, h, d]
SHAPES = [("vit-b/16", 2, 197, 197, 12, 64),
          ("d8", 1, 64, 64, 2, 8),
          ("d80", 1, 96, 77, 2, 80),
          ("d160", 1, 64, 64, 2, 160),
          ("d256", 1, 64, 64, 2, 256)]


def tf32(x):
    """x (fp32) rounded to TF32 as `cvt.rna.tf32.f32` rounds it: to
    nearest on the 10 mantissa bits kept, ties away from zero (the int32
    view adds half of the dropped 13 bits' range to the magnitude)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def tf32_product(a, b, passes):
    """a [..., m, k] @ b [..., k, n] (fp32) as the kernels take it:
    per k-step of 8, the products lo_a.hi_b, hi_a.lo_b, hi_a.hi_b
    (passes 3) or hi_a.hi_b alone (passes 1), each added to an fp32
    accumulator."""
    k = a.shape[-1]
    pad = -k % 8
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    (ah, al), (bh, bl) = split(a), split(b)
    terms = [(al, bh), (ah, bl), (ah, bh)] if passes == 3 else [(ah, bh)]
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for s in range(0, k + pad, 8):
        for x, y in terms:
            acc += (x[..., s:s + 8].double() @ y[..., s:s + 8, :].double()) \
                .float()
    return acc


def operands(case, b, sq, sk, h, d, product):
    """(a, b) of one forward product per head: Q [b*h, sq, d] and
    K^T [b*h, d, sk] for the scores; P = softmax(S d^-1/2) [b*h, sq, sk]
    and V [b*h, sk, d] for the weighted values."""
    rng = np.random.RandomState(sum(map(ord, case)) + d)
    q, k, v = (torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32))
               .transpose(1, 2).reshape(b * h, s, d)
               for s in (sq, sk, sk))
    if product == "scores":
        return q, k.transpose(1, 2)
    p = torch.softmax((q @ k.transpose(1, 2)) * d ** -0.5, dim=-1)
    return p, v


@pytest.mark.parametrize("product", ["scores", "weighted_v"])
@pytest.mark.parametrize("case,b,sq,sk,h,d", SHAPES,
                         ids=[s[0] for s in SHAPES])
def test_three_pass_split_is_fp32_accurate(case, b, sq, sk, h, d, product):
    a, w = operands(case, b, sq, sk, h, d, product)
    got = tf32_product(a, w, passes=3).double()
    ref = a.double() @ w.double()
    mag = a.double().abs() @ w.double().abs()
    err = (got - ref).abs()
    assert (err <= THREE_PASS_TOL * mag).all(), \
        (err / mag).max().item()


def test_one_pass_is_not():
    a, w = operands("d8", 1, 64, 64, 2, 8, "scores")
    one = tf32_product(a, w, passes=1).double()
    ref = a.double() @ w.double()
    mag = a.double().abs() @ w.double().abs()
    assert ((one - ref).abs() > ONE_PASS_MIN * mag).any()


def test_split_keeps_ten_mantissa_bits_and_rounds_to_nearest():
    """hi and lo carry 10 mantissa bits (the low 13 are zero), hi is x
    rounded to nearest with ties away from zero, and hi + lo is x to
    within 2^-22 |x|."""
    rng = np.random.RandomState(18)
    x = torch.from_numpy((rng.randn(4096) * 10.0 ** rng.uniform(
        -6, 6, 4096)).astype(np.float32))
    hi, lo = split(x)
    for t in (hi, lo):
        assert ((t.view(torch.int32) & 0x1FFF) == 0).all()
    step = 2.0 ** (torch.frexp(x.double())[1] - 11)    # hi's ulp at x
    assert ((hi.double() - x.double()).abs() <= step / 2).all()
    ties = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 3 * 2.0 ** -11)])
    assert tf32(ties).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -9)]
    assert ((hi.double() + lo.double() - x.double()).abs()
            <= 2.0 ** -22 * x.double().abs()).all()
