"""Disaggregated prefill/decode serving and the fleet-tier prefix cache of
paddle_tpu_torch against paddle_tpu's, on the CPU, as
tests/test_serve_disagg.py pins them for the reference (its chaos CLI
has no counterpart yet; its autoscaler role-flip unit is in
test_torch_autoscaler.py).

  * the hand-off: a frozen prompt's KV pages (an int8 pool's scales with
    them) survive export -> pack_handoff -> unpack_handoff -> import
    byte for byte, a blob crosses between the packages, and the decode
    side runs no prefill;
  * the fleet: a prefill/decode split serves bit-exact against the
    same replicas unified and equal to the reference's split fleet,
    streams without a duplicate token, and leaves both pools leak-free;
  * degraded fleets: the unfreeze fallback with no decode sink, and no
    orphan page after a prefill worker dies mid-hand-off;
  * the fleet-tier cache: the migration budget replicates a hot prefix,
    and `trie_digest` / `probe_digest` equal the reference's after the
    same allocator operations;
  * one model, several pools: a two-replica int8 fleet packs its
    weights once."""
import numpy as np
import pytest
import torch
from torch_cpu import one_cpu_thread  # noqa: F401 (autouse)
from torch_serve_pair import (Clock, both, fleet_no_leak, fleet_record,
                              model_pair, record, sides)

from paddle_tpu.inference import paged_kv as jpaged_kv
from paddle_tpu.inference import serving as jserving

from paddle_tpu_torch.inference import ContinuousBatcher, ServeRouter
from paddle_tpu_torch.inference import paged_kv as tpaged_kv
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.quantization import weight_only


@pytest.fixture(scope="module")
def pair():
    torch.manual_seed(0)
    return model_pair(seed=7)


GEOM = dict(max_batch_size=1, max_len=64, chunk=4, prefill_chunk=4)
KV_DTYPES = [None, "bfloat16", "int8"]


def _bat(side, **kw):
    return side.batcher(Clock(), **dict(GEOM, **kw))


def _prompts(n=6, shared=24):
    rng = np.random.RandomState(5)
    base = rng.randint(1, 127, size=shared).tolist()
    out = []
    for k in range(n):
        tail = rng.randint(1, 127, size=4 + k).tolist()
        out.append(np.asarray(base + tail if k % 2 == 0
                              else rng.randint(1, 127, 6 + k).tolist(),
                              np.int32))
    return out


def _frozen(bat, prompt, new):
    """Submit to a prefill batcher and step until the slot freezes."""
    rid = bat.submit(prompt, max_new_tokens=new)
    for _ in range(64):
        bat.step()
        if bat._handoff_ready:
            break
    assert rid in bat._handoff_ready
    return rid


def _np(t):
    """Raw bytes of a tensor or array, as numpy (bfloat16 by its bits)."""
    if torch.is_tensor(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    a = np.asarray(t)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


# ---------------------------------------------------------------------------
# the hand-off primitive

@pytest.mark.parametrize("kv", KV_DTYPES, ids=["fp32", "bf16", "int8"])
def test_handoff_pages_byte_identical(pair, kv):
    """Export -> pack -> unpack -> import keeps every page byte, K, V
    and an int8 pool's scales; the decode side's pages then hold the
    exported rows, it runs no prefill, and its tokens equal a unified
    batcher's and the reference's."""
    prompt = _prompts(1)[0]

    def scenario(side):
        pre = _bat(side, role="prefill", kv_dtype=kv)
        dec = _bat(side, role="decode", kv_dtype=kv)
        rid = _frozen(pre, prompt, 6)
        meta, data = pre.export_handoff(rid)
        n = meta["n_pages"]
        blob = side.serving.pack_handoff(meta, data)
        meta2, data2 = side.serving.unpack_handoff(blob)
        assert meta2["pos"] == meta["pos"] and meta2["n_pages"] == n
        assert np.array_equal(meta2["prompt"], meta["prompt"])
        assert sorted(data2) == sorted(data)
        assert ("k_scale" in data) == (kv == "int8")
        for name in data:
            assert np.array_equal(_np(data[name])[:n],
                                  _np(data2[name])[:n]), name
        lid = dec.import_handoff(meta2, data2)
        assert lid is not None
        n_tok, pages = dec._alloc.export_chain(meta["prompt"])
        assert n_tok >= dec.page_size and pages
        for name in data:
            got = _np(dec._cache[name])[np.asarray(pages)]
            assert np.array_equal(_np(data[name])[:len(pages)], got), name
        out = dec.run()[lid]
        st = dec.stats()
        assert st["prefill_tokens"] == 0 and st["handoffs_in"] == 1
        uni = _bat(side, kv_dtype=kv)
        uni.submit(prompt, 6)
        if kv is None:
            assert list(out) == list(uni.run()[0])
        return dict(out=[int(t) for t in out], pos=meta["pos"], n_pages=n,
                    nbytes=meta["nbytes"], pre=record(pre)["stats"],
                    dec=record(dec)["stats"])

    rec = both(pair, scenario)
    assert rec["pre"]["handoffs_out"] == 1
    assert rec["pre"]["requests_submitted"] == \
        rec["pre"]["requests_completed"] + rec["pre"]["requests_shed"] \
        + rec["pre"]["handoffs_out"]


@pytest.mark.parametrize("kv", KV_DTYPES, ids=["fp32", "bf16", "int8"])
def test_blob_crosses_between_packages(pair, kv):
    """A port blob unpacks in the reference with the port's valid-page
    bytes (padded to the reference's [pages_per_slot] export shape), a
    reference blob unpacks in the port with the reference's, and the
    port's decode batcher imports the reference's blob and decodes the
    reference's tokens."""
    prompt = _prompts(1)[0]
    js, ts = sides(*pair)
    jpre, tpre = (_bat(s, role="prefill", kv_dtype=kv) for s in (js, ts))
    jmeta, jdata = jpre.export_handoff(_frozen(jpre, prompt, 6))
    tmeta, tdata = tpre.export_handoff(_frozen(tpre, prompt, 6))
    n = tmeta["n_pages"]
    assert jmeta["n_pages"] == n and jmeta["nbytes"] == tmeta["nbytes"]
    for k in jmeta:         # the reference's keys, and pages_per_slot
        if k != "prompt":
            assert tmeta[k] == jmeta[k], k
    assert tmeta["pages_per_slot"] == tpre.pages_per_slot
    m, d = jserving.unpack_handoff(tserving.pack_handoff(tmeta, tdata))
    for name in tdata:
        a = _np(d[name])
        assert a.shape[0] == tpre.pages_per_slot
        assert np.array_equal(a[:n], _np(tdata[name])), name
    m2, d2 = tserving.unpack_handoff(jserving.pack_handoff(jmeta, jdata))
    for name in jdata:
        assert np.array_equal(_np(d2[name])[:n], _np(jdata[name])[:n]), name
    # the reference's pages land in the port's pool and decode there
    dec = _bat(ts, role="decode", kv_dtype=kv)
    lid = dec.import_handoff(m2, d2)
    jdec = _bat(js, role="decode", kv_dtype=kv)
    jlid = jdec.import_handoff(*jserving.unpack_handoff(
        jserving.pack_handoff(jmeta, jdata)))
    assert list(dec.run()[lid]) == list(jdec.run()[jlid])
    assert dec.stats()["prefill_tokens"] == 0


def test_role_checks_equal_reference(pair):
    """The role knob's refusals are the reference's: an unknown role, a
    role on the dense layout, an import into a prefill batcher, a
    geometry mismatch, an export of a slot that is not ready."""
    prompt = _prompts(1)[0]
    for side in sides(*pair):
        with pytest.raises(ValueError, match="role"):
            _bat(side, role="both")
        with pytest.raises(TypeError, match="paged"):
            _bat(side, role="decode", kv_layout="dense")
        pre = _bat(side, role="prefill")
        meta, data = pre.export_handoff(_frozen(pre, prompt, 4))
        with pytest.raises(RuntimeError, match="prefill-role"):
            pre.import_handoff(meta, data)
        with pytest.raises(ValueError, match="geometry"):
            _bat(side, role="decode", page_size=8).import_handoff(meta,
                                                                  data)
        with pytest.raises(KeyError):
            pre.export_handoff(12345)
        with pytest.raises(ValueError, match="role"):
            pre.set_role("none")


def test_prefill_batcher_parks_on_frozen_slots(pair):
    """A prefill batcher driven on its own freezes each slot at its
    prompt's end and parks: run() returns with the slots frozen and
    no chunk spent on them, as the reference's does; a set_role flip
    of a unified batcher mid-decode freezes its slot at pos = plen + k,
    and the hand-off finishes it with the unified tokens."""
    prompts = _prompts(3)

    def scenario(side):
        pre = _bat(side, role="prefill", max_batch_size=2)
        for p in prompts[:3]:
            pre.submit(p, 8)
        pre.run()
        chunks = pre.stats()["chunks"]
        pre.run()
        assert pre.stats()["chunks"] == chunks
        frozen = sorted(pre._handoff_ready)
        flip = _bat(side)
        rid = flip.submit(prompts[1], 10)
        while flip._slots[0] is None or len(flip._slots[0].tokens) < 2:
            flip.step()
        flip.set_role("prefill")
        flip.step()
        assert rid in flip._handoff_ready
        meta, data = flip.export_handoff(rid)
        assert meta["pos"] > meta["plen"]
        dec = _bat(side, role="decode")
        lid = dec.import_handoff(meta, data)
        got = list(dec.run()[lid])
        uni = _bat(side)
        uni.submit(prompts[1], 10)
        assert got == list(uni.run()[0])
        return dict(frozen=frozen, chunks=chunks, got=[int(t) for t in got],
                    pos=meta["pos"], pre=record(pre)["stats"])

    rec = both(pair, scenario)
    assert len(rec["frozen"]) == 2 and rec["pre"]["handoff_ready"] == 2


# ---------------------------------------------------------------------------
# the split fleet

def test_disagg_fleet_bit_exact_vs_unified(pair):
    """Two replicas split prefill/decode against the same two unified:
    identical outputs and streams (no token twice across the hand-off),
    no prefill on the decode side, both pools leak-free; tokens and
    counters equal to the reference's split fleet."""
    prompts, mnt = _prompts(), [12, 6, 10, 8, 14, 7]

    def run(side, roles):
        streamed = {}
        router = side.router.ServeRouter(
            batchers=[_bat(side, max_batch_size=2) for _ in range(2)],
            roles=roles)

        def cb(g, burst, done):
            streamed.setdefault(g, []).extend(int(t) for t in burst)

        for p, m in zip(prompts, mnt):
            router.submit(p, max_new_tokens=m, on_token=cb)
        return router, router.run(), streamed

    def scenario(side):
        _, ref, ref_stream = run(side, None)
        router, out, streamed = run(side, ["prefill", "decode"])
        for g in ref:
            assert list(ref[g]) == list(out[g]), g
            assert streamed[g] == list(out[g]) == ref_stream[g], g
        dec = router._reps[1].bat
        assert dec.role == "decode"
        assert dec.stats()["prefill_tokens"] == 0
        for rep in router._reps:
            s = rep.bat.stats()
            assert s["kv_pages_used"] == s["kv_pages_cached"], rep.idx
        return fleet_record(router, out)

    rec = both(pair, scenario)
    fleet_no_leak(rec)
    st = rec["stats"]
    assert st["requests_shed"] == 0 and st["handoffs"] > 0
    assert st["handoff_staged"] == 0
    assert st["handoff_windows"] == st["handoffs"]
    assert rec["replicas"][1]["handoffs_in"] == st["handoffs"]
    assert rec["replicas"][0]["handoffs_out"] == st["handoffs"]
    assert st["cross_prefix_hit_tokens"] > 0
    # each hand-off's bytes count once on its source and once on its sink
    assert 2 * st["handoff_bytes"] == sum(r["handoff_bytes"]
                                          for r in rec["replicas"]) > 0


def test_unfreeze_fallback_without_decode_sink(pair):
    """A prefill-only fleet unfreezes its frozen slot and decodes in
    place (no livelock on freeze/unfreeze), with the unified tokens."""
    prompt = _prompts(1)[0]

    def scenario(side):
        uni = _bat(side)
        uni.submit(prompt, 5)
        want = list(uni.run()[0])
        router = side.router.ServeRouter(
            batchers=[_bat(side, role="prefill")], roles=["prefill"])
        gid = router.submit(prompt, 5)
        out = router.run()
        assert list(out[gid]) == want
        return fleet_record(router, out)

    rec = both(pair, scenario)
    assert rec["stats"]["handoffs"] == 0
    assert rec["stats"]["requests_shed"] == 0


def test_interrupted_handoff_leaves_no_orphans(pair):
    """The prefill worker dies holding a frozen slot: the request
    requeues and completes elsewhere, and no survivor pool leaks."""
    rng = np.random.RandomState(5)
    prompts = [np.asarray(rng.randint(1, 127, 8 + k), np.int32)
               for k in range(4)]
    mnt = [40, 40, 12, 12]

    def scenario(side):
        roles = ["prefill", "decode", "decode"]
        router = side.router.ServeRouter(
            batchers=[_bat(side, role=r) for r in roles], roles=roles)
        gids = [router.submit(p, m) for p, m in zip(prompts, mnt)]
        killed_at = None
        for t in range(64):
            router.step()
            if killed_at is None and router._reps[0].bat._handoff_ready:
                router.kill_replica(0)
                killed_at = t
        assert killed_at is not None
        out = router.run()
        assert all(len(out[g]) == m for g, m in zip(gids, mnt))
        for rep in router._live():
            s = rep.bat.stats()
            assert s["kv_pages_used"] == s["kv_pages_cached"], rep.idx
        return fleet_record(router, out, killed_at=killed_at)

    rec = both(pair, scenario)
    fleet_no_leak(rec)
    assert rec["stats"]["requests_shed"] == 0


@pytest.mark.parametrize("n", [2, 3, 4])
def test_serve_disagg_flag_default_split(pair, n):
    """FLAGS_serve_disagg splits a fleet built without roles prefill
    first, the odd replica on decode, as the reference does."""
    got = []
    for side in sides(*pair):
        side.set_flags({"FLAGS_serve_disagg": True})
        try:
            kw = dict(GEOM, device="cpu") if side.name == "port" else GEOM
            r = side.router.ServeRouter(model=side.model, replicas=n, **kw)
        finally:
            side.set_flags({"FLAGS_serve_disagg": False})
        got.append(([x.role for x in r._reps],
                    [x.bat.role for x in r._reps]))
    assert got[0] == got[1]
    assert got[1][0][:n // 2] == ["prefill"] * (n // 2)


def test_migration_budget_replicates_hot_prefix(pair):
    """Load steers a same-prefix request away from the holder; the
    budgeted sweep copies the prefix to where it landed, so the next
    same-prefix admission hits imported pages (cross-replica hits)."""
    rng = np.random.RandomState(5)
    shared = rng.randint(1, 127, size=24).tolist()

    def scenario(side):
        side.set_flags({"FLAGS_router_migration_budget": 8,
                        "FLAGS_router_prefix_weight": 0.001})
        try:
            b0, b1 = _bat(side, max_batch_size=2), \
                _bat(side, max_batch_size=2)
            p = np.asarray(shared + [5, 9], np.int32)
            b1.submit(p, 4)
            b1.run()
            router = side.router.ServeRouter(batchers=[b0, b1])
            b1.submit(np.asarray(shared + [7, 7], np.int32), 8)
            router.submit(p, 4)
            router.step()
            replicated = router.stats()["replicated_pages"]
            assert replicated > 0
            router.submit(np.asarray(shared + [5, 9, 3], np.int32), 4)
            return fleet_record(router, router.run(),
                                replicated=replicated)
        finally:
            side.set_flags({"FLAGS_router_migration_budget": 0,
                            "FLAGS_router_prefix_weight": 1.0})

    rec = both(pair, scenario)
    st = rec["stats"]
    assert st["cross_prefix_hit_tokens"] > 0 and st["requests_shed"] == 0
    assert rec["replicas"][0]["grafted_pages"] == rec["replicated"]


# ---------------------------------------------------------------------------
# the digests

def _allocator_ops(mod, seed):
    """A seeded sequence of admissions, progress, releases and grafts on
    one package's PageAllocator; returns what the fleet tier reads."""
    rng = np.random.RandomState(seed)
    alloc = mod.PageAllocator(num_pages=24, page_size=4)
    bases = [rng.randint(1, 50, 12).tolist() for _ in range(3)]
    live, probes = [], []
    for step in range(14):
        base = bases[rng.randint(3)]
        prompt = base[:4 * rng.randint(1, 4)] \
            + rng.randint(1, 50, rng.randint(1, 6)).tolist()
        probes.append(prompt)
        op = rng.rand()
        if op < 0.55:
            plan = alloc.admit(prompt, covered_pages=5,
                               imported=bool(rng.rand() < 0.3))
            if plan is not None:
                alloc.mark_progress(plan, len(prompt))
                live.append(plan)
        elif op < 0.8 and live:
            alloc.release_plan(live.pop(rng.randint(len(live))))
        else:
            alloc.graft(prompt, int(rng.randint(1, 4)))
    digest = alloc.trie_digest(8)
    return dict(digest=digest, full=alloc.trie_digest(),
                probes=[mod.probe_digest(digest, p, 4) for p in probes],
                chains=[alloc.export_chain(p) for p in probes],
                import_hit_tokens=alloc.import_hit_tokens,
                grafted_pages=alloc.grafted_pages,
                prefix_hit_tokens=alloc.prefix_hit_tokens,
                evictions=alloc.evictions)


@pytest.mark.parametrize("seed", range(4))
def test_digests_equal_reference(seed):
    """trie_digest, probe_digest, export_chain and the fleet-tier
    counters equal the reference's after the same allocator
    operations (admissions imported or not, progress, releases, grafts
    under pressure)."""
    ref = _allocator_ops(jpaged_kv, seed)
    got = _allocator_ops(tpaged_kv, seed)
    assert got == ref
    assert got["full"]
    assert tpaged_kv.probe_digest([], [1, 2, 3], 4) == 0
    assert tpaged_kv.probe_digest([["x", 1], [4]], [1, 2, 3, 4, 5], 4) \
        == jpaged_kv.probe_digest([["x", 1], [4]], [1, 2, 3, 4, 5], 4)


# ---------------------------------------------------------------------------
# one model, several pools

def test_int8_fleet_packs_weights_once(pair, monkeypatch):
    """Two int8 weight-only replicas over one model pack it once (the
    second batcher finds it packed and leaves it), share the packed
    weights, and serve the tokens one int8 batcher serves."""
    _, tm0 = pair
    tm = type(tm0)(tm0.config, device="cpu")
    tm.load_state_dict(tm0.state_dict())
    calls = []
    orig = weight_only._quantize_param

    def counting(layer, name, *a):
        calls.append(name)
        return orig(layer, name, *a)

    monkeypatch.setattr(weight_only, "_quantize_param", counting)
    router = ServeRouter(tm, replicas=2, weight_only_dtype="int8",
                         device="cpu", **dict(GEOM, max_batch_size=2))
    n_sites = len(calls)
    assert n_sites > 0
    a, b = (r.bat for r in router._reps)
    assert a.model is b.model and tm._weight_only["dtype"] == "int8"
    ptrs = {n: p.data_ptr() for n, p in tm.named_parameters()}
    extra = ContinuousBatcher(tm, weight_only_dtype="int8", device="cpu",
                              **dict(GEOM, max_batch_size=2))
    assert len(calls) == n_sites
    assert {n: p.data_ptr() for n, p in tm.named_parameters()} == ptrs
    prompts = _prompts(4)
    gids = [router.submit(p, 5) for p in prompts]
    out = router.run()
    rids = [extra.submit(p, 5) for p in prompts]
    single = extra.run()
    for g, r in zip(gids, rids):
        assert list(out[g]) == list(single[r])
    with pytest.raises(ValueError, match="re-quantize"):
        ContinuousBatcher(tm, weight_only_dtype="int4", device="cpu",
                          **GEOM)
