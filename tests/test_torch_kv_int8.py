"""The int8 paged KV pool of paddle_tpu_torch against paddle_tpu's, on
the CPU: the quantizing page write (`ops.paged_kv_update` on an int8
pool) byte for byte — pools and scales — over a sequence of writes, the
plain paged attention on int8 pools against the reference's jnp twin
and its Pallas kernel in interpret mode, the cache layout, and the byte
counts of a batcher's pool.

Inputs are made from a seed with numpy and handed to both packages.
The page write does the same fp32 arithmetic in the same order on the
same inputs, so its bytes and scales must be EQUAL; attention outputs
are compared at 1e-5 (fp32 sums in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_cpu import one_cpu_thread  # noqa: F401 (autouse)

from paddle_tpu import ops as jops
from paddle_tpu.inference import ContinuousBatcher as JBatcher
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.llama import llama_tiny_config as j_tiny
from paddle_tpu.ops.pallas.paged_attention import \
    paged_attention as pallas_paged_attention

import paddle_tpu_torch.ops as tops
from paddle_tpu_torch.inference import ContinuousBatcher
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config

CFG = dict(dtype="float32", num_hidden_layers=2, num_key_value_heads=2)


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _int8_pools(rng, P, ps, L, n_kv, d):
    """Random int8 pools with positive per-page per-head scales."""
    pools = [rng.randint(-127, 128, (P, ps, L, n_kv, d)).astype(np.int8)
             for _ in range(2)]
    scales = [(0.01 + 0.05 * rng.rand(P, L, n_kv)).astype(np.float32)
              for _ in range(2)]
    return pools + scales


def test_int8_page_write_equals_reference_byte_for_byte():
    """A sequence of writes into one int8 pool from zero: chunks of C in
    {5, 3, 1} that straddle pages, a write at the capacity edge (the
    window clamps back and the row start clamps inside it), a free slot
    on the null page, an unmapped tail, and a prefix page that two slots
    share and neither writes: it must stay byte-identical, and so must
    every page no slot maps."""
    rng = np.random.RandomState(0)
    B, P, ps, L, n_kv, d, P_slot = 4, 40, 4, 2, 2, 8, 6
    pools = [np.zeros((P, ps, L, n_kv, d), np.int8) for _ in range(2)]
    scales = [np.ones((P, L, n_kv), np.float32) for _ in range(2)]
    pt = (rng.permutation(P - 2)[:B * P_slot].reshape(B, P_slot) + 2) \
        .astype(np.int32)
    shared = 1
    pt[0, 0] = pt[1, 0] = shared          # both slots map the prefix page
    pt[1, 5:] = 0                         # an unmapped tail
    pt[3] = 0                             # a free slot: the null page
    # the shared page holds data before the slots start past it
    pools[0][shared] = rng.randint(-127, 128, pools[0][shared].shape)
    pools[1][shared] = rng.randint(-127, 128, pools[1][shared].shape)
    scales[0][shared] = 0.02
    scales[1][shared] = 0.03
    before = [p[shared].copy() for p in pools] + \
        [s[shared].copy() for s in scales]
    J = [jnp.asarray(a) for a in (*pools, *scales)]
    T = [torch.from_numpy(a.copy()) for a in (*pools, *scales)]
    pos = np.asarray([ps, ps + 1, 0, 2], np.int32)
    for step, C in enumerate([5, 3, 1, 1, 5, 3]):
        kn, vn = _rand(rng, B, C, n_kv, d), _rand(rng, B, C, n_kv, d)
        if step == 4:
            pos[2] = P_slot * ps - C - 1   # the capacity edge
        for layer in (1, 0):
            J = list(jops.paged_kv_update(
                J[0], J[1], J[2], J[3], jnp.asarray(pt), jnp.asarray(pos),
                jnp.asarray(kn), jnp.asarray(vn), layer))
            out = tops.paged_kv_update(
                T[0], T[1], torch.from_numpy(pt), torch.from_numpy(pos),
                torch.from_numpy(kn), torch.from_numpy(vn), layer, T[2],
                T[3])
            assert all(o is t for o, t in zip(out, T))   # in place
        for ref, port in zip(J, T):
            np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
        pos = pos + C
    for port, b in zip(T, before):
        np.testing.assert_array_equal(port[shared].numpy(), b)
    unmapped = np.setdiff1d(np.arange(1, P), pt.reshape(-1))
    for port in T[:2]:
        assert not port[unmapped].numpy().any()
    for port in T[2:]:
        assert (port[unmapped].numpy() == 1.0).all()


def test_write_window_matches_reference_clamps():
    """The window (pages, touched mask, clamped row start) at a page
    boundary, mid-page and at the capacity edge, where p0 clips to
    P_slot - n_t and the C rows still fit in the window."""
    ps, P_slot, C = 4, 6, 5
    pt = torch.arange(1, 1 + 3 * P_slot, dtype=torch.int32).reshape(3, P_slot)
    pos = torch.tensor([0, 6, P_slot * ps - C], dtype=torch.int32)
    win = tops.paged_write_window(pt, pos, C, ps)
    n_t = -(-C // ps) + 1
    assert win["ids"].shape == (3, n_t)
    assert win["ids"][0].tolist() == [1, 2, 3]
    assert win["touched"][0].tolist() == [True, True, False]
    assert win["ids"][1].tolist() == [8, 9, 10]          # p0 = 1
    assert win["r0"].tolist() == [0, 2, 7]
    assert win["ids"][2].tolist() == [16, 17, 18]        # clipped p0 = 3
    assert win["touched"][2].tolist() == [False, True, True]
    assert win["src"].tolist() == list(range(9))         # no page twice
    free = tops.paged_write_window(torch.zeros((2, P_slot), dtype=torch.int32),
                                   torch.zeros(2, dtype=torch.int32), 1, ps)
    assert free["src"].tolist() == [3, 3, 3, 3]          # the last wins


@pytest.mark.parametrize("C", [1, 8])
@pytest.mark.parametrize("group", [1, 2])
def test_plain_paged_attention_int8_matches_reference(C, group):
    rng = np.random.RandomState(10 * C + group)
    B, n_kv, d, P, ps, L, P_slot = 4, 2, 16, 24, 8, 2, 5
    h = n_kv * group
    q = _rand(rng, B, C, h, d)
    kp, vp, ks, vs = _int8_pools(rng, P, ps, L, n_kv, d)
    pt = (rng.permutation(P - 1)[:B * P_slot].reshape(B, P_slot) + 1) \
        .astype(np.int32)
    pt[-1] = 0
    pos = np.asarray([0, ps + 3, P_slot * ps - C - 1, 6], np.int32)
    t = [torch.from_numpy(a) for a in (q, kp, vp, pt, pos)]
    for layer in (0, 1):
        port = tops.paged_attention(*t, layer, torch.from_numpy(ks),
                                    torch.from_numpy(vs))
        assert port.dtype == torch.float32 and port.shape == q.shape
        jargs = (jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                 jnp.asarray(pt), jnp.asarray(pos), layer, jnp.asarray(ks),
                 jnp.asarray(vs))
        for ref in (jops.xla_paged_attention(*jargs),
                    pallas_paged_attention(*jargs, interpret=True)):
            np.testing.assert_allclose(port.numpy(), np.asarray(ref),
                                       atol=1e-5, rtol=1e-5)
        # the same as attention over the dequantized pool
        deq = [torch.from_numpy(p).float()
               * torch.from_numpy(s)[:, None, :, :, None]
               for p, s in ((kp, ks), (vp, vs))]
        np.testing.assert_array_equal(
            port.numpy(), tops.paged_attention(t[0], *deq, *t[3:], layer)
            .numpy())


def test_int8_pool_needs_scales():
    rng = np.random.RandomState(2)
    kp, vp, ks, vs = _int8_pools(rng, 6, 4, 1, 2, 8)
    args = [torch.from_numpy(a) for a in
            (_rand(rng, 1, 1, 2, 8), kp, vp,
             np.ones((1, 2), np.int32), np.zeros((1,), np.int32))]
    for scales in ((None, None), (torch.from_numpy(ks), None)):
        with pytest.raises(ValueError, match="k_scale/v_scale"):
            tops.paged_attention(*args, 0, *scales)
        with pytest.raises(ValueError, match="k_scale/v_scale"):
            tops.plain_paged_attention(*args, 0, *scales)
    with pytest.raises(ValueError, match="k_scale/v_scale"):
        jops.xla_paged_attention(*[jnp.asarray(a.numpy()) for a in args], 0)


def test_int8_cache_layout_matches_reference():
    jm = JLlama(j_tiny(**CFG))
    tm = LlamaForCausalLM(llama_tiny_config(**CFG), device="cpu")
    jc = jm.init_paged_cache(9, 8, "int8")
    tc = tm.init_paged_cache(9, 8, "int8")
    assert sorted(tc) == sorted(jc) == ["k", "k_scale", "v", "v_scale"]
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape, k
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))
    assert tc["k"].dtype == torch.int8 and tc["k_scale"].dtype == torch.float32
    assert set(tm.init_paged_cache(9, 8)) == {"k", "v"}


@pytest.mark.parametrize("kv", ["auto", "int8", "bfloat16"])
def test_kv_bytes_match_geometry_and_reference(kv):
    jm = JLlama(j_tiny(**CFG))
    tm = LlamaForCausalLM(llama_tiny_config(**CFG), device="cpu")
    geom = dict(max_batch_size=3, max_len=64, prefill_chunk=8, page_size=8,
                kv_dtype=kv)
    bat = ContinuousBatcher(tm, device="cpu", **geom)
    want = ContinuousBatcher.paged_kv_bytes(tm, **geom)
    assert bat.kv_cache_bytes() == want == bat.stats()["kv_bytes"]
    assert want == JBatcher.paged_kv_bytes(jm, **geom)
    assert want == JBatcher(jm, **geom).kv_cache_bytes()
    assert bat.stats()["kv_dtype"] == {"auto": "float32", "int8": "int8",
                                       "bfloat16": "bfloat16"}[kv]
