"""paddle_tpu_torch.models.llama decode paths against paddle_tpu's.

The same numpy weights (made from a seed) go into both packages through
their state dicts; the same tokens and positions go through the paged
and the dense cached paths.  Tolerances, with their reasons:

  * logits in fp32: atol 1e-4 — the packages' fp32 matmuls sum in
    different orders over 2 layers of width 128/384, which moves
    logits of magnitude ~1 by ~1e-6..1e-5;
  * paged vs dense inside the port: atol 1e-5 — identical math, the
    softmax only sees a different number of masked (exactly zero)
    columns;
  * greedy tokens: equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_cpu import one_cpu_thread  # noqa: F401 (autouse)

from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.llama import llama_tiny_config as j_tiny

from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny_config,
                                     load_numpy_state_dict, numpy_state_dict)

CFG = dict(dtype="float32", num_hidden_layers=2, num_key_value_heads=2)


def _numpy_weights(jmodel, seed):
    rng = np.random.RandomState(seed)
    out = {}
    for name, p in jmodel.state_dict().items():
        shape = tuple(p.shape)
        if len(shape) == 1:
            out[name] = (1.0 + 0.1 * rng.randn(*shape)).astype(np.float32)
        else:
            out[name] = (rng.randn(*shape) / np.sqrt(shape[0])) \
                .astype(np.float32)
    return out


@pytest.fixture(scope="module")
def models():
    jm = JLlama(j_tiny(**CFG))
    weights = _numpy_weights(jm, seed=0)
    jm.set_state_dict(weights)
    tm = LlamaForCausalLM(llama_tiny_config(**CFG), device="cpu")
    load_numpy_state_dict(tm, weights)
    return jm, tm, weights


def test_state_dict_round_trip(models):
    jm, tm, weights = models
    jsd = {k: np.asarray(v.value) for k, v in jm.state_dict().items()}
    got = numpy_state_dict(tm)
    assert sorted(got) == sorted(jsd)
    for k in jsd:
        np.testing.assert_array_equal(got[k], jsd[k])


def test_load_rejects_mismatch(models):
    _, _, weights = models
    tm = LlamaForCausalLM(llama_tiny_config(**CFG), device="cpu", seed=1)
    before = numpy_state_dict(tm)
    renamed = dict(weights)
    renamed["llama.layers.0.self_attn.q_weight"] = \
        renamed.pop("llama.layers.0.self_attn.q_proj")
    with pytest.raises(KeyError):
        load_numpy_state_dict(tm, renamed)
    extra = dict(weights, bias=np.zeros(3, np.float32))
    with pytest.raises(KeyError):
        load_numpy_state_dict(tm, extra)
    bad = dict(weights)
    bad["lm_head"] = bad["lm_head"][:, :10]
    with pytest.raises(ValueError):
        load_numpy_state_dict(tm, bad)
    # a rejected load writes nothing
    after = numpy_state_dict(tm)
    for k in before:
        np.testing.assert_array_equal(before[k], after[k])


# (C, tokens-per-slot) steps: a prefill chunk, a shorter one, two decodes
_STEPS = (5, 3, 1, 1)
_B, _PS, _P_SLOT = 3, 8, 4


def _tokens(rng, C):
    return rng.randint(1, 512, (_B, C)).astype(np.int32)


def test_paged_logits_match_reference(models):
    jm, tm, _ = models
    rng = np.random.RandomState(4)
    pt = (np.arange(_B * _P_SLOT).reshape(_B, _P_SLOT) + 1).astype(np.int32)
    pos = np.asarray([0, 3, 9], np.int32)
    jcache = jm.init_paged_cache(1 + _B * _P_SLOT, _PS)
    tcache = tm.init_paged_cache(1 + _B * _P_SLOT, _PS)
    for C in _STEPS:
        ids = _tokens(rng, C)
        jl, jcache = jm.forward_cached_paged(jnp.asarray(ids), jcache,
                                             jnp.asarray(pt), jnp.asarray(pos))
        tl, tcache2 = tm.forward_cached_paged(
            torch.from_numpy(ids), tcache, torch.from_numpy(pt),
            torch.from_numpy(pos))
        assert tcache2 is tcache                  # pool updated in place
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
        np.testing.assert_array_equal(tl.numpy().argmax(-1),
                                      np.asarray(jl).argmax(-1))
        pos = pos + C


@pytest.mark.parametrize("per_slot", [True, False])
def test_dense_logits_match_reference(models, per_slot):
    jm, tm, _ = models
    rng = np.random.RandomState(5)
    S = _P_SLOT * _PS
    jcache = jm.init_cache(_B, S)
    tcache = tm.init_cache(_B, S)
    pos = np.asarray([0, 3, 9], np.int32) if per_slot else 0
    for C in _STEPS:
        ids = _tokens(rng, C)
        jp = jnp.asarray(pos, jnp.int32)
        tp = torch.from_numpy(pos) if per_slot else pos
        jl, jcache = jm.forward_cached(jnp.asarray(ids), jcache, jp)
        tl, _ = tm.forward_cached(torch.from_numpy(ids), tcache, tp)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
        pos = pos + C


def test_paged_equals_dense_in_port(models):
    _, tm, _ = models
    rng = np.random.RandomState(6)
    pt = (np.arange(_B * _P_SLOT).reshape(_B, _P_SLOT) + 1).astype(np.int32)
    pos = np.asarray([0, 3, 9], np.int32)
    paged = tm.init_paged_cache(1 + _B * _P_SLOT, _PS)
    dense = tm.init_cache(_B, _P_SLOT * _PS)
    for C in _STEPS:
        ids = torch.from_numpy(_tokens(rng, C))
        lp, _ = tm.forward_cached_paged(ids, paged, torch.from_numpy(pt),
                                        torch.from_numpy(pos))
        ld, _ = tm.forward_cached(ids, dense, torch.from_numpy(pos))
        np.testing.assert_allclose(lp.numpy(), ld.numpy(), atol=1e-5)
        np.testing.assert_array_equal(lp.numpy().argmax(-1),
                                      ld.numpy().argmax(-1))
        pos = pos + C


def test_tied_embeddings_match_reference():
    kw = dict(CFG, tie_word_embeddings=True)
    jm = JLlama(j_tiny(**kw))
    weights = _numpy_weights(jm, seed=2)
    jm.set_state_dict(weights)
    tm = LlamaForCausalLM(llama_tiny_config(**kw), device="cpu")
    load_numpy_state_dict(tm, weights)
    assert "lm_head" not in weights
    ids = np.random.RandomState(3).randint(1, 512, (2, 6)).astype(np.int32)
    jl, _ = jm.forward_cached(jnp.asarray(ids), jm.init_cache(2, 8),
                              jnp.asarray(0, jnp.int32))
    tl, _ = tm.forward_cached(torch.from_numpy(ids), tm.init_cache(2, 8), 0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)


@pytest.mark.parametrize("eos_at", [None, 2])
def test_generate_matches_reference(models, eos_at):
    """Greedy generate, token for token; with an EOS (the third token of
    the first row) that row repeats EOS after it, as the reference's."""
    jm, tm, _ = models
    from paddle_tpu_torch.inference import generate
    rng = np.random.RandomState(8)
    ids = rng.randint(1, 512, (2, 7)).astype(np.int32)
    got = generate(tm, ids, 6, device="cpu").numpy()
    eos = None if eos_at is None else int(got[0, eos_at])
    if eos is not None:
        got = generate(tm, ids, 6, eos_token_id=eos, device="cpu").numpy()
        assert (got[0, eos_at:] == eos).all()
    want = np.asarray(jm.generate(jnp.asarray(ids), max_new_tokens=6,
                                  eos_token_id=eos).value)
    np.testing.assert_array_equal(got, want)
