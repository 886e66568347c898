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


@pytest.mark.parametrize("blocks,R,P_slot,want", [
    (256, 1, 66, 8),      # 7B decode: 8 slots x 32 kv heads -> 2048 blocks
    (256, 32, 66, 2),     # 7B prefill chunk: ~512 larger blocks
    (2, 1, 66, 16),       # capped at 16 splits
    (2, 1, 3, 3),         # never more splits than a slot has pages
    (4096, 4, 66, 1),     # enough blocks already
])
def test_paged_attention_split_count(blocks, R, P_slot, want):
    pa = tops.kernel_module("paged_attention")
    assert pa._splits(blocks, R, P_slot) == want


def test_paged_attention_rejects_bad_gqa():
    rng = np.random.RandomState(1)
    q, kp, vp, pt, pos = _paged_inputs(rng, 4, 1, 3, 2)
    with pytest.raises(ValueError, match="multiple"):
        tops.paged_attention(torch.from_numpy(q), torch.from_numpy(kp),
                             torch.from_numpy(vp), torch.from_numpy(pt),
                             torch.from_numpy(pos), 0)
