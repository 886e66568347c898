"""Speculative decoding in paddle_tpu_torch's ContinuousBatcher against
paddle_tpu's, on the CPU, as tests/test_generation.py:127-230 and
tests/test_serving.py:300-337 pin it for the reference.

For the paged and dense layouts and for the early-exit, identity and
separate drafts, the same weights and requests must give the reference
speculative batcher's tokens, drafted and accepted counts and stats
counters (tests/torch_serve_pair.py), and the port's plain batcher's
tokens; a faulted slot's rollback leaks no page; and a chunk makes one
device-to-host transfer with speculation on or off."""
import warnings

import numpy as np
import pytest
import torch
from torch_cpu import one_cpu_thread  # noqa: F401 (autouse)
from torch_serve_pair import (CFG, both, model_pair, numpy_weights, record,
                              sides)

from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.llama import llama_tiny_config as j_tiny

from paddle_tpu_torch.framework.flags import set_flags
from paddle_tpu_torch.inference import ContinuousBatcher
from paddle_tpu_torch.models import (EarlyExitDraft, LlamaForCausalLM,
                                     llama_tiny_config,
                                     load_numpy_state_dict)

GEOM = dict(max_batch_size=2, max_len=64, chunk=4, prefill_chunk=4)


@pytest.fixture(scope="module")
def pair():
    torch.manual_seed(0)
    return model_pair(seed=3)


@pytest.fixture(scope="module")
def drafts():
    """A separate one-layer draft in each package, on the same weights
    (its own, not the target's)."""
    cfg = dict(CFG, num_hidden_layers=1)
    jd = JLlama(j_tiny(**cfg))
    w = numpy_weights(jd, seed=11)
    jd.set_state_dict(w)
    td = LlamaForCausalLM(llama_tiny_config(**cfg), device="cpu")
    load_numpy_state_dict(td, w)
    return {"paddle_tpu": jd, "port": td}


def _workload(side, **kw):
    rng = np.random.RandomState(6)
    prompts = [rng.randint(1, 128, L).astype(np.int32)
               for L in (6, 11, 4, 9)]
    bat = side.batcher(**dict(GEOM, **kw))
    for p in prompts[:2]:
        bat.submit(p, 6)
    bat.step()
    for p in prompts[2:]:
        bat.submit(p, 6)
    bat.run()
    return bat


def _draft_kw(side, drafts, kind):
    if kind == "early_exit":
        return dict(spec_tokens=2, draft_layers=1)
    if kind == "identity":
        return dict(spec_tokens=3, draft_model=side.model)
    return dict(spec_tokens=4, draft_model=drafts[side.name])


@pytest.mark.parametrize("layout", ["paged", "dense"])
@pytest.mark.parametrize("kind", ["early_exit", "identity", "separate"])
def test_speculative_tokens_equal_reference_and_plain(pair, drafts, layout,
                                                      kind):
    rec = both(pair, lambda s: record(_workload(
        s, kv_layout=layout, **_draft_kw(s, drafts, kind))))
    st = rec["stats"]
    assert st["spec_drafted"] > 0
    assert 0 <= st["spec_accepted"] <= st["spec_drafted"]
    plain = record(_workload(sides(*pair)[1], kv_layout=layout))
    assert rec["outs"] == plain["outs"]
    assert all(len(o) == 6 for o in rec["outs"].values())
    if kind == "identity":
        # the draft IS the target: every draft is accepted
        assert st["spec_accept_rate"] == 1.0
        assert st["spec_accepted_per_step"]["p50"] == 4.0


@pytest.fixture(scope="module")
def near_drafts(pair):
    """The target's weights with 30% noise, in each package: a draft
    that agrees with the target on some tokens and not on others."""
    tm = pair[1]
    rng = np.random.RandomState(12)
    w = {n: (p.detach().numpy() * (1 + 0.3 * rng.randn(*p.shape)))
         .astype(np.float32) for n, p in tm.named_parameters()}
    jd = JLlama(j_tiny(**CFG))
    jd.set_state_dict(w)
    td = LlamaForCausalLM(llama_tiny_config(**CFG), device="cpu")
    load_numpy_state_dict(td, w)
    return {"paddle_tpu": jd, "port": td}


def test_speculative_acceptance_partition(pair, near_drafts):
    """A draft that is sometimes right: every active slot-step drafts K
    = 3 tokens and emits its accepted ones plus the bonus (no step here
    meets the capacity clamp), so drafted == 3 x steps and accepted ==
    emitted - steps; the counts equal the reference's (both)."""
    def scenario(side):
        bat = _workload(side, spec_tokens=3,
                        draft_model=near_drafts[side.name])
        window = list(bat._spec_emit_window)
        return record(bat, emitted=sum(window), steps=len(window))

    rec = both(pair, scenario)
    st = rec["stats"]
    assert st["spec_drafted"] == 3 * rec["steps"] > 0
    assert st["spec_accepted"] == rec["emitted"] - rec["steps"]
    assert 0 < st["spec_accepted"] < st["spec_drafted"]
    assert st["spec_accept_rate"] == round(
        st["spec_accepted"] / st["spec_drafted"], 4)
    plain = record(_workload(sides(*pair)[1]))
    assert rec["outs"] == plain["outs"]


def test_speculative_paged_rollback_leak_free(pair):
    """A faulted slot mid-speculation: the requeued request re-decodes
    bit-exactly and the pool ends with nothing mapped."""
    plain = record(_workload(sides(*pair)[1]))

    def scenario(side):
        with side.fault.scope("serve.decode:step=3:mode=error"):
            bat = _workload(side, spec_tokens=3,
                            draft_model=side.model, kv_layout="paged")
            fired = side.fault.fired_counts().get("serve.decode", 0)
        pages = (bat._alloc.pages_used, bat._alloc.pages_cached,
                 sorted(set(bat._alloc._ref.values())))
        return record(bat, fired=fired, pages=pages)

    rec = both(pair, scenario)
    assert rec["fired"] == 1 and rec["stats"]["requests_requeued"] == 1
    assert rec["outs"] == plain["outs"]
    used, cached, refs = rec["pages"]
    assert used == cached and refs in ([], [0])


def test_speculative_near_capacity(pair):
    """Requests that fill their slot up to max_len: near the end the
    capacity clamp cuts an all-accepted run (K + 1 = 4 tokens a step
    against the rows left), and tokens and counts still equal the
    reference's and the plain batcher's."""
    rng = np.random.RandomState(8)
    prompts = [rng.randint(1, 128, L).astype(np.int32) for L in (9, 14)]

    def scenario(side, **kw):
        bat = side.batcher(max_batch_size=2, max_len=24, chunk=4,
                           prefill_chunk=4, **kw)
        for p in prompts:
            bat.submit(p, 24 - len(p))
        bat.run()
        return record(bat)

    rec = both(pair, lambda s: scenario(s, spec_tokens=3,
                                        draft_model=s.model))
    assert [len(rec["outs"][r]) for r in (0, 1)] == [15, 10]
    assert rec["outs"] == scenario(sides(*pair)[1])["outs"]
    # the identity draft matches every draft; the unclamped count keeps
    # accepted == drafted although the clamp cut the emitted runs
    st = rec["stats"]
    assert st["spec_accepted"] == st["spec_drafted"]
    assert st["spec_accepted_per_step"]["mean"] < 4.0


class _Transfers:
    """Counts the calls that move a tensor's value to the host."""

    NAMES = ("cpu", "item", "tolist", "__bool__", "__int__", "__float__",
             "__index__")

    def __init__(self, monkeypatch):
        self.n = 0
        for name in self.NAMES:
            orig = getattr(torch.Tensor, name)

            def counted(t, *a, _orig=orig, **k):
                self.n += 1
                return _orig(t, *a, **k)
            monkeypatch.setattr(torch.Tensor, name, counted)


@pytest.mark.parametrize("spec", [0, 3])
@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_one_host_transfer_per_chunk(pair, monkeypatch, spec, layout):
    tm = pair[1]
    kw = dict(spec_tokens=spec, draft_model=tm) if spec else {}
    bat = ContinuousBatcher(tm, device="cpu", kv_layout=layout, **GEOM, **kw)
    rng = np.random.RandomState(4)
    for L in (6, 11, 4):
        bat.submit(rng.randint(1, 128, L).astype(np.int32), 6)
    counter = _Transfers(monkeypatch)
    bat.run()
    monkeypatch.undo()
    st = bat.stats()
    assert st["chunks"] >= 4 and st["decode_chunks"] >= 1
    assert counter.n == st["chunks"], (counter.n, st["chunks"])


def test_speculative_needs_a_draft(pair):
    tm = pair[1]
    with pytest.raises(ValueError, match="draft"):
        ContinuousBatcher(tm, max_batch_size=2, max_len=32, spec_tokens=2,
                          device="cpu")
    with pytest.raises(TypeError, match="draft_model"):
        ContinuousBatcher(tm, max_batch_size=2, max_len=32, spec_tokens=2,
                          draft_model=object(), device="cpu")


def test_early_exit_draft_validates_layers_and_matches_reference(pair):
    jm, tm = pair
    with pytest.raises(ValueError):
        tm.early_exit_draft(0)
    with pytest.raises(ValueError):
        tm.early_exit_draft(99)
    d = tm.early_exit_draft(1)
    assert isinstance(d, EarlyExitDraft) and list(d.__dict__) \
        == ["_model", "num_layers", "config"]      # no weights of its own
    cache = d.init_cache(2, 16)
    assert len(cache) == 1
    ids = np.random.RandomState(1).randint(0, 128, (2, 3)).astype(np.int32)
    pos = np.array([0, 4], np.int32)
    lg, cache = d.forward_cached(torch.as_tensor(ids), cache,
                                 torch.as_tensor(pos))
    assert lg.shape == (2, 3, tm.config.vocab_size)
    import jax.numpy as jnp
    jd = jm.early_exit_draft(1)
    jlg, _ = jd.forward_cached(jnp.asarray(ids), jd.init_cache(2, 16),
                               jnp.asarray(pos))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=2e-5,
                               atol=2e-5)
    # fill_cache writes the same rows as forward_cached, without logits
    c2 = d.fill_cache(torch.as_tensor(ids), d.init_cache(2, 16),
                      torch.as_tensor(pos))
    for (k1, v1), (k2, v2) in zip(cache, c2):
        assert torch.equal(k1, k2) and torch.equal(v1, v2)


def test_speculative_flag_defaults(pair):
    """FLAGS_serve_spec_tokens / FLAGS_serve_draft_layers arm
    speculation without constructor arguments."""
    set_flags({"FLAGS_serve_spec_tokens": 2, "FLAGS_serve_draft_layers": 1})
    try:
        bat = _workload(sides(*pair)[1])
    finally:
        set_flags({"FLAGS_serve_spec_tokens": 0,
                   "FLAGS_serve_draft_layers": 0})
    assert bat.spec_k == 2 and isinstance(bat._draft, EarlyExitDraft)
    assert bat.stats()["spec_drafted"] > 0


def test_speculation_defaults_prefix_sharing_off(pair):
    tm = pair[1]
    kw = dict(max_batch_size=2, max_len=64, chunk=4, prefill_chunk=4,
              kv_layout="paged", device="cpu")
    bat = ContinuousBatcher(tm, spec_tokens=2, draft_model=tm, **kw)
    assert bat.prefix_sharing is False
    assert ContinuousBatcher(tm, **kw).prefix_sharing is True
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        both_on = ContinuousBatcher(tm, spec_tokens=2, draft_model=tm,
                                    prefix_sharing=True, **kw)
    assert both_on.prefix_sharing is True
    assert any("accept_rate" in str(x.message) for x in w)


def test_identity_draft_reads_the_target(pair):
    """Self-speculation uses the target itself as the draft: no copy of
    its weights, only a dense draft cache beside the pool."""
    tm = pair[1]
    bat = ContinuousBatcher(tm, max_batch_size=1, max_len=32, chunk=4,
                            prefill_chunk=4, spec_tokens=2, draft_model=tm,
                            device="cpu")
    assert bat._draft is tm
    assert len(bat._dcache) == tm.config.num_hidden_layers
    rid = bat.submit(np.random.RandomState(26).randint(1, 128, 5), 4)
    assert len(bat.run()[rid]) == 4


@pytest.mark.parametrize("kind", ["early_exit", "identity"])
def test_speculative_kv_bytes(pair, kind):
    """kv_cache_bytes() is the target's cache, sized for the verify
    pass's write window as paged_kv_bytes(spec_tokens=K) predicts and as
    the reference's speculative batcher holds it; the draft's dense cache
    is draft_kv_bytes(), in stats() too."""
    jm, tm = pair
    K = 3                       # 2K+2 = 8 rows, wider than prefill_chunk
    draft = dict(draft_layers=1) if kind == "early_exit" \
        else dict(draft_model=tm)
    jdraft = dict(draft_layers=1) if kind == "early_exit" \
        else dict(draft_model=jm)
    geom = dict(max_batch_size=2, max_len=64, prefill_chunk=4, page_size=4)
    bat = ContinuousBatcher(tm, chunk=4, kv_layout="paged", spec_tokens=K,
                            device="cpu", **geom, **draft)
    jbat = sides(jm, tm)[0].batcher(chunk=4, kv_layout="paged",
                                    spec_tokens=K, **geom, **jdraft)
    want = ContinuousBatcher.paged_kv_bytes(tm, spec_tokens=K, **geom)
    assert bat.kv_cache_bytes() == want == jbat.kv_cache_bytes()
    assert want > ContinuousBatcher.paged_kv_bytes(tm, **geom)
    cfg = tm.config
    n = 1 if kind == "early_exit" else cfg.num_hidden_layers
    rows = geom["max_len"] + 2 * K + 2 - 1
    dkv = 2 * n * geom["max_batch_size"] * rows * cfg.num_key_value_heads \
        * cfg.head_dim * 4
    st = bat.stats()
    assert bat.draft_kv_bytes() == dkv == st["draft_kv_bytes"]
    assert st["kv_bytes"] == want
    plain = ContinuousBatcher(tm, chunk=4, kv_layout="paged", device="cpu",
                              **geom)
    assert plain.draft_kv_bytes() == 0 == plain.stats()["draft_kv_bytes"]


def test_cached_walk_checks_cache_depth(pair):
    """A cached walk runs exactly as many blocks as its cache holds
    layers: a target handed a draft's short cache raises instead of
    skipping blocks."""
    tm = pair[1]
    ids = torch.ones((1, 2), dtype=torch.int32)
    short = tm.init_cache(1, 8, num_layers=1)
    assert len(short) == 1 and len(tm.init_cache(1, 8)) \
        == tm.config.num_hidden_layers
    with pytest.raises(ValueError, match="cache of 1 layers"):
        tm.forward_cached(ids, short, 0)
    with pytest.raises(ValueError, match="cache of 1 layers"):
        tm.fill_cache(ids, short, 0)
    lg, _ = tm.forward_cached(ids, short, 0, num_layers=1)
    d = tm.early_exit_draft(1)
    dl, _ = d.forward_cached(ids, d.init_cache(1, 8), 0)
    assert torch.equal(lg, dl)
