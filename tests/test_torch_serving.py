"""paddle_tpu_torch.inference.serving.ContinuousBatcher against
paddle_tpu's, on the CPU.

The same numpy weights go into both packages and the same requests go
through both batchers with the same geometry and the same submission
stagger; the greedy tokens must be EQUAL, request for request.  The
workloads cover chunked prefill over several chunks with slot reuse
(more requests than slots), prefix sharing with a copy-on-write
divergence, and eviction under pool pressure.  Inside the port, the
batcher must equal isolated greedy `generate()` per request, and the
paged layout must equal the dense one.
"""
import numpy as np
import pytest
from torch_cpu import one_cpu_thread  # noqa: F401 (autouse)

from paddle_tpu.inference import ContinuousBatcher as JBatcher
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.llama import llama_tiny_config as j_tiny

from paddle_tpu_torch.inference import ContinuousBatcher, generate
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny_config,
                                     load_numpy_state_dict)

CFG = dict(dtype="float32", num_hidden_layers=2, num_key_value_heads=2)
GEOM = dict(max_len=96, chunk=4, prefill_chunk=8, page_size=8)


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
    weights = _numpy_weights(jm, seed=1)
    jm.set_state_dict(weights)
    tm = LlamaForCausalLM(llama_tiny_config(**CFG), device="cpu")
    load_numpy_state_dict(tm, weights)
    return jm, tm


def _serve(bat, prompts, new, stagger):
    """Submit `stagger[0]` requests, step, then one more per step for
    the next `stagger[1]`, then the rest; run to completion."""
    rids, it = [], iter(zip(prompts, new))
    for p, n in [next(it) for _ in range(stagger[0])]:
        rids.append(bat.submit(p, n))
    for _ in range(stagger[1]):
        bat.step()
        p, n = next(it)
        rids.append(bat.submit(p, n))
    rids += [bat.submit(p, n) for p, n in it]
    outs = bat.run()
    return [outs[r] for r in rids], bat.stats()


def _both(models, prompts, new, stagger, **kw):
    jm, tm = models
    jout, jst = _serve(JBatcher(jm, **kw), prompts, new, stagger)
    tout, tst = _serve(ContinuousBatcher(tm, device="cpu", **kw), prompts,
                       new, stagger)
    assert len(tout) == len(jout) == len(prompts)
    for t, j, n in zip(tout, jout, new):
        np.testing.assert_array_equal(t, j)
        assert len(t) == n or kw.get("eos_token_id") in t
    return tout, tst, jst


def _isolated(tm, prompts, new):
    return [generate(tm, p[None], n, device="cpu").numpy()[0]
            for p, n in zip(prompts, new)]


def test_staggered_chunked_prefill_slot_reuse(models):
    rng = np.random.RandomState(3)
    lens = (5, 23, 9, 40, 14, 31)
    prompts = [rng.randint(1, 512, L).astype(np.int32) for L in lens]
    new = [6, 9, 12, 5, 8, 7]
    tout, tst, jst = _both(models, prompts, new, (2, 2),
                           max_batch_size=2, **GEOM)
    assert tst["prefill_tokens"] == jst["prefill_tokens"] == sum(lens)
    assert tst["admit_chunks"] == jst["admit_chunks"]
    assert tst["decode_chunks"] == jst["decode_chunks"]
    # the batcher equals isolated generation, and paged equals dense
    for t, want in zip(tout, _isolated(models[1], prompts, new)):
        np.testing.assert_array_equal(t, want)
    dense, _ = _serve(ContinuousBatcher(models[1], max_batch_size=2,
                                        kv_layout="dense", device="cpu",
                                        **GEOM), prompts, new, (2, 2))
    for t, d in zip(tout, dense):
        np.testing.assert_array_equal(t, d)


def test_prefix_sharing_copy_on_write(models):
    rng = np.random.RandomState(4)
    system = rng.randint(1, 512, 20).astype(np.int32)   # 2.5 pages of 8
    tails = [rng.randint(1, 512, L).astype(np.int32) for L in (6, 11, 3, 9)]
    prompts = [np.concatenate([system, t]) for t in tails]
    new = [5, 6, 7, 4]
    tout, tst, jst = _both(models, prompts, new, (1, 1),
                           max_batch_size=2, **GEOM)
    assert tst["prefix_hit_tokens"] == jst["prefix_hit_tokens"] > 0
    assert tst["cow_copies"] > 0
    assert tst["prefix_hit_tokens"] + tst["prefill_tokens"] \
        == sum(len(p) for p in prompts)
    for t, want in zip(tout, _isolated(models[1], prompts, new)):
        np.testing.assert_array_equal(t, want)
    # with sharing off every prompt token prefills; the tokens are equal
    off, st = _serve(ContinuousBatcher(models[1], max_batch_size=2,
                                       prefix_sharing=False, device="cpu",
                                       **GEOM), prompts, new, (1, 1))
    assert st["prefix_hit_tokens"] == 0
    assert st["prefill_tokens"] == sum(len(p) for p in prompts)
    for t, o in zip(tout, off):
        np.testing.assert_array_equal(t, o)


def test_eviction_under_pressure(models):
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, 512, L).astype(np.int32)
               for L in (17, 19, 18, 21, 16)]
    new = [5] * len(prompts)
    # each request covers ~5-6 pages of 8 rows; 11 usable pages force
    # cached-page eviction and deferred admission
    tout, tst, jst = _both(models, prompts, new, (5, 0),
                           max_batch_size=4, num_pages=12, **GEOM)
    assert tst["evictions"] == jst["evictions"] > 0
    assert tst["kv_pages_used"] == tst["kv_pages_cached"]
    assert tst["requests_completed"] == len(prompts)


def test_eos_finishes_early(models):
    """An EOS token ends a request early (output trimmed after it) and
    frees its slot for the queue, in both packages alike."""
    rng = np.random.RandomState(6)
    prompts = [rng.randint(1, 512, L).astype(np.int32) for L in (7, 12, 9)]
    new = [10, 10, 10]
    eos = int(_isolated(models[1], prompts[:1], [10])[0][3])
    tout, _, _ = _both(models, prompts, new, (3, 0), max_batch_size=2,
                       eos_token_id=eos, **GEOM)
    assert len(tout[0]) == 4 and tout[0][-1] == eos


def test_pool_too_small_raises(models):
    bat = ContinuousBatcher(models[1], max_batch_size=1, num_pages=3,
                            device="cpu", **GEOM)
    bat.submit(np.arange(1, 30, dtype=np.int32), 5)
    with pytest.raises(RuntimeError, match="cannot ever hold"):
        bat.run()


def test_submit_validates(models):
    bat = ContinuousBatcher(models[1], max_batch_size=1, device="cpu",
                            **GEOM)
    with pytest.raises(ValueError, match="empty"):
        bat.submit(np.zeros((0,), np.int32), 4)
    with pytest.raises(ValueError, match="max_len"):
        bat.submit(np.ones((90,), np.int32), 10)


def _quantized_pair(seed):
    jm = JLlama(j_tiny(**CFG))
    weights = _numpy_weights(jm, seed=seed)
    jm.set_state_dict(weights)
    tm = LlamaForCausalLM(llama_tiny_config(**CFG), device="cpu")
    load_numpy_state_dict(tm, weights)
    return jm, tm


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
@pytest.mark.parametrize("wo", ["int8", "int4"])
def test_quantized_serving_tokens_equal(wo, kv_dtype):
    """Weight-only int8/int4 weights with an fp32 or int8 KV pool: each
    batcher packs its own model from the same fp32 weights and serves a
    staggered workload with a shared prefix and a mid-page divergence
    (the copy-on-write clone, which must carry an int8 page's scales);
    the greedy tokens equal the reference's, request for request."""
    jm, tm = _quantized_pair(seed=7)
    rng = np.random.RandomState(8)
    system = rng.randint(1, 512, 20).astype(np.int32)   # 2.5 pages of 8
    tails = [rng.randint(1, 512, L).astype(np.int32) for L in (6, 11, 3, 9)]
    prompts = [np.concatenate([system, t]) for t in tails] + \
        [rng.randint(1, 512, 13).astype(np.int32)]
    new = [5, 6, 7, 4, 6]
    kw = dict(max_batch_size=2, weight_only_dtype=wo, kv_dtype=kv_dtype,
              **GEOM)
    jout, jst = _serve(JBatcher(jm, **kw), prompts, new, (1, 2))
    bat = ContinuousBatcher(tm, device="cpu", **kw)
    tout, tst = _serve(bat, prompts, new, (1, 2))
    for t, j, n in zip(tout, jout, new):
        np.testing.assert_array_equal(t, j)
        assert len(t) == n
    assert tst["weight_only"] == jst["weight_only"] == wo
    assert tst["cow_copies"] > 0
    assert tst["prefix_hit_tokens"] == jst["prefix_hit_tokens"] > 0
    assert tst["kv_bytes"] == bat.kv_cache_bytes() \
        == JBatcher.paged_kv_bytes(jm, 2, GEOM["max_len"],
                                   GEOM["prefill_chunk"], GEOM["page_size"],
                                   kv_dtype=kv_dtype)
    assert tm._weight_only == jm._weight_only


def test_weight_only_flag_quantizes_in_the_batcher():
    """FLAGS_weight_only_dtype (None argument) packs the model; "none"
    leaves it alone and stats() says so."""
    from paddle_tpu_torch.framework.flags import set_flags
    _, tm = _quantized_pair(seed=9)
    plain = ContinuousBatcher(tm, max_batch_size=1, device="cpu", **GEOM)
    assert plain.stats()["weight_only"] == "none"
    assert getattr(tm, "_weight_only", None) is None
    set_flags({"FLAGS_weight_only_dtype": "int4",
               "FLAGS_weight_only_group_size": 32})
    try:
        bat = ContinuousBatcher(tm, max_batch_size=1, device="cpu", **GEOM)
    finally:
        set_flags({"FLAGS_weight_only_dtype": "none",
                   "FLAGS_weight_only_group_size": 64})
    assert tm._weight_only == {"dtype": "int4", "group_size": 32}
    rid = bat.submit(np.arange(1, 9, dtype=np.int32), 4)
    assert len(bat.run()[rid]) == 4 and bat.stats()["weight_only"] == "int4"
