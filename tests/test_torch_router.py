"""The serve-fleet router of paddle_tpu_torch against paddle_tpu's, on the
CPU, as tests/test_serve_router.py pins it for the reference (its
compile-count pin, chaos CLI and telemetry-event tests have no
counterpart: the port compiles no step programs and has no telemetry
plane yet; its KVServer round trip runs here over the in-process
`_LocalKV`, the launch plane's KVClient not being ported).

`pick_replica` is held to the reference's on the reference's cases and
on seeded random views.  Each fleet scenario runs on both packages with
the same weights, requests and patched batcher clocks
(tests/torch_serve_pair.py) and must give the same tokens for every
global id, the same router counters and the same per-replica batcher
counters; a two-replica fleet's tokens must also equal one replica's."""
import copy

import numpy as np
import pytest
import torch
from torch_cpu import one_cpu_thread  # noqa: F401 (autouse)
from torch_serve_pair import (Clock, both, fleet_no_leak, fleet_record,
                              model_pair, sides)

from paddle_tpu.inference import router as jrouter
from paddle_tpu.inference.paged_kv import PageAllocator as JAlloc

from paddle_tpu_torch.fleet.autoscaler import _LocalKV
from paddle_tpu_torch.framework.flags import set_flags
from paddle_tpu_torch.inference import ContinuousBatcher, fleet_serve
from paddle_tpu_torch.inference import router as trouter
from paddle_tpu_torch.inference.paged_kv import PageAllocator


@pytest.fixture(scope="module")
def pair():
    torch.manual_seed(0)
    return model_pair(seed=7)


GEOM = dict(max_batch_size=1, max_len=64, chunk=4, prefill_chunk=4)


def _bat(side, **kw):
    return side.batcher(Clock(), **dict(GEOM, **kw))


def _fleet(side, n=2, roles=None, **kw):
    return side.router.ServeRouter(batchers=[_bat(side, **kw)
                                             for _ in range(n)],
                                   roles=roles)


def _workload(seed, n=6):
    rng = np.random.RandomState(seed)
    lens = (6, 11, 4, 9, 13, 5)[:n]
    news = (6, 5, 7, 4, 6, 5)[:n]
    return [rng.randint(1, 128, L).astype(np.int32) for L in lens], news


# ---------------------------------------------------------------------------
# the policy: the reference's cases, then seeded random views

def _view(replica, hit=0, queued=0, active=0, slots=1, draining=False,
          shed_rate=0.0, interactive_att=None):
    return {"replica": replica, "prefix_hit_tokens": hit,
            "queued": queued, "active": active, "slots": slots,
            "draining": draining, "shed_rate": shed_rate,
            "attainment": {"interactive": interactive_att,
                           "batch": None, "best_effort": None}}


# (views, pick_replica kwargs, the reference test's expected choice)
PICK_CASES = {
    "prefix_beats_queue": ([_view(0), _view(1, hit=64, queued=1)],
                           dict(prefix_weight=1.0), 1),
    "load_beats_small_prefix": ([_view(0), _view(1, hit=4, queued=3)],
                                dict(prefix_weight=1.0), 0),
    "weight_zero": ([_view(0), _view(1, hit=512, queued=1)],
                    dict(prefix_weight=0.0), 0),
    "floor_overrides_prefix": (
        [_view(0, hit=256, interactive_att=0.3),
         _view(1, interactive_att=0.99)],
        dict(slo="interactive", attainment_floor=0.9), 1),
    "floor_skips_batch": (
        [_view(0, hit=256, interactive_att=0.3),
         _view(1, interactive_att=0.99)],
        dict(slo="batch", attainment_floor=0.9), 0),
    "no_signal_is_headroom": (
        [_view(0, hit=256), _view(1, interactive_att=0.99)],
        dict(slo="interactive", attainment_floor=0.9), 0),
    "floor_waived_all_below": (
        [_view(0, hit=32, interactive_att=0.2),
         _view(1, interactive_att=0.1)],
        dict(slo="interactive", attainment_floor=0.9), 0),
    "draining_never": ([_view(0, hit=512, draining=True),
                        _view(1, queued=5)], {}, 1),
    "all_draining": ([_view(0, draining=True), _view(1, draining=True)],
                     {}, None),
    "tie_lowest_id": ([_view(2), _view(0), _view(1)], {}, 0),
    "tie_fewer_queued": ([_view(0, hit=16, queued=1), _view(1)],
                         dict(prefix_weight=1.0, queue_cost=16.0), 1),
    "shed_penalized": ([_view(0, shed_rate=0.5), _view(1)], {}, 1),
}


@pytest.mark.parametrize("case", sorted(PICK_CASES))
def test_pick_replica_reference_cases(case):
    views, kw, want = PICK_CASES[case]
    assert jrouter.pick_replica(copy.deepcopy(views), **kw) == want
    assert trouter.pick_replica(copy.deepcopy(views), **kw) == want


def _digest_pool(rng):
    """A few complete chains of 4-token pages and their trie digest."""
    alloc = PageAllocator(num_pages=32, page_size=4)
    chains = []
    for _ in range(3):
        toks = rng.randint(1, 64, 4 * rng.randint(1, 4)).tolist()
        node = None
        for i in range(0, len(toks), 4):
            node = alloc.register_chunk(node, toks[i:i + 4],
                                        alloc.alloc(1)[0])
            if node is None:
                break
            alloc.complete_node(node)
        chains.append(toks)
    return alloc.trie_digest(), chains


def _random_views(rng):
    n = rng.randint(1, 5)
    views = []
    digest, chains = _digest_pool(rng)
    for i in rng.permutation(8)[:n]:
        v = {"replica": int(i), "queued": int(rng.randint(0, 4)),
             "active": int(rng.randint(0, 3)), "slots": 2,
             "attainment": {"interactive": [None, 0.2, 0.85, 0.95, 1.0][
                 rng.randint(5)], "batch": None, "best_effort": None}}
        if rng.rand() < 0.15:
            v["draining"] = True
        if rng.rand() < 0.1:
            v["dead"] = True
        if rng.rand() < 0.5:
            v["shed_rate_window"] = float(rng.choice([0.0, 0.1, 0.6]))
        v["shed_rate"] = float(rng.choice([0.0, 0.25]))
        if rng.rand() < 0.6:
            v["prefix_hit_tokens"] = int(rng.choice([0, 4, 16, 40, 64]))
        elif rng.rand() < 0.7:
            v["trie_digest"] = digest
            v["page_size"] = 4
        views.append(v)
    chain = chains[rng.randint(len(chains))]
    prompt = np.asarray(chain + rng.randint(1, 64, 3).tolist()
                        if rng.rand() < 0.7
                        else rng.randint(1, 64, 9).tolist(), np.int32)
    kw = dict(slo=str(rng.choice(["interactive", "batch",
                                  "best_effort"])),
              prefix_weight=[None, 0.0, 0.001, 1.0][rng.randint(4)],
              attainment_floor=[None, 0.0, 0.9][rng.randint(3)],
              queue_cost=float(rng.choice([16.0, 4.0])))
    if rng.rand() < 0.8:
        kw["prompt"] = prompt
    return views, kw


@pytest.mark.parametrize("seed", range(4))
def test_pick_replica_random_views(seed):
    """60 seeded random view lists a seed (240 in all): draining, dead,
    shed rates windowed or not, attainment below and above the floor,
    in-process hits and published digests — the same choice as the
    reference's every time."""
    rng = np.random.RandomState(100 + seed)
    picks = []
    for _ in range(60):
        views, kw = _random_views(rng)
        want = jrouter.pick_replica(copy.deepcopy(views), **kw)
        assert trouter.pick_replica(copy.deepcopy(views), **kw) == want, \
            (views, kw)
        picks.append(want)
    assert len(set(picks)) > 2          # the cases reach several choices


def test_pick_replica_scores_a_published_digest():
    """A digest-bearing view scores its resident depth without a local
    probe: the holder wins over an idle cold replica, in both
    packages."""
    alloc = PageAllocator(num_pages=8, page_size=4)
    toks = list(range(1, 13))
    node = None
    for i in range(0, 12, 4):
        node = alloc.register_chunk(node, toks[i:i + 4], alloc.alloc(1)[0])
        alloc.complete_node(node)
    views = [{"replica": 0, "queued": 0, "active": 0, "slots": 1,
              "shed_rate": 0.0},
             {"replica": 1, "queued": 0, "active": 0, "slots": 1,
              "shed_rate": 0.0, "trie_digest": alloc.trie_digest(),
              "page_size": 4}]
    for pick in (jrouter.pick_replica, trouter.pick_replica):
        assert pick(views, prefix_weight=1.0,
                    prompt=np.asarray(toks + [99], np.int32)) == 1
        assert pick(views, prefix_weight=1.0,
                    prompt=np.asarray([88, 77, 66, 55, 44], np.int32)) == 0


# ---------------------------------------------------------------------------
# the read-only prefix probe

def _filled(alloc_cls):
    alloc = alloc_cls(num_pages=8, page_size=4)
    prompt = list(range(100, 112))
    plan = alloc.admit(prompt + [1], covered_pages=4)
    for node in plan.nodes:
        alloc.complete_node(node)
    alloc.release_plan(plan)
    return alloc, prompt


def test_prefix_probe_is_pure_and_equal_to_reference():
    """Probing pins no page, touches no LRU stamp and moves no counter;
    its answers equal the reference allocator's."""
    alloc, prompt = _filled(PageAllocator)
    jalloc, _ = _filled(JAlloc)
    ref = dict(alloc._ref)
    clock = alloc._clock
    lru = {n.page: n.lru for n in alloc._node_of.values()}
    probes = [prompt + [3], prompt[:6], prompt + [1, 2],
              prompt[:8] + [108, 109, 7, 7], [9, 9, 9, 9, 9], prompt[:4],
              [], [5]]
    for _ in range(4):
        for p in probes:
            assert alloc.prefix_match_len(p) == jalloc.prefix_match_len(p)
    assert dict(alloc._ref) == ref
    assert alloc._clock == clock
    assert {n.page: n.lru for n in alloc._node_of.values()} == lru
    assert alloc.cow_copies == 0 and alloc.prefix_hit_tokens == 0
    # pressure then evicts the same pages in the same order as an
    # allocator never probed
    fresh, _ = _filled(PageAllocator)
    assert sorted(alloc.alloc(6)) == sorted(fresh.alloc(6))
    assert alloc.evictions == fresh.evictions


def test_router_view_schema_equals_reference(pair):
    """router_view has the reference's keys, key for key, and the same
    values on the same history — queued, with a prompt, after a run,
    and with the published digest."""
    rng = np.random.RandomState(1)
    shared = rng.randint(1, 128, 16).astype(np.int32)
    prompt = np.concatenate([shared, rng.randint(1, 128, 5)
                             .astype(np.int32)])

    def scenario(side):
        bat = _bat(side, page_size=8)
        bat.submit(prompt, 3)
        views = [bat.router_view(prompt)]
        bat.run()
        views += [bat.router_view(), bat.router_view(prompt),
                  bat.router_view(digest=True)]
        dense = _bat(side, kv_layout="dense")
        views.append(dense.router_view(prompt))
        return dict(views=views, keys=[sorted(v) for v in views])

    rec = both(pair, scenario)
    assert rec["views"][2]["prefix_hit_tokens"] == 16
    assert rec["views"][3]["trie_digest"]


# ---------------------------------------------------------------------------
# the fleet

def test_fleet_tokens_equal_one_replica_and_reference(pair):
    """Two replicas give every request the tokens one replica gives it,
    and the same tokens, routes and counters as the reference's fleet;
    both replicas served."""
    prompts, news = _workload(5)

    def scenario(side):
        router = _fleet(side)
        gids = [router.submit(p, n) for p, n in zip(prompts, news)]
        outs = router.run()
        one = _bat(side, max_batch_size=2)
        rids = [one.submit(p, n) for p, n in zip(prompts, news)]
        single = one.run()
        for g, r in zip(gids, rids):
            assert list(outs[g]) == list(single[r]), g
        return fleet_record(router, outs)

    rec = both(pair, scenario)
    fleet_no_leak(rec)
    st = rec["stats"]
    assert st["requests_shed"] == 0
    assert all(v > 0 for v in st["routed_by_replica"].values()), st
    assert st["decisions"] == len(prompts)


def test_shared_prefix_routes_to_its_holder(pair):
    """A staggered shared-prefix workload (the fleet bench leg's shape
    at CPU size): later routes chase the resident prefix, so the
    prefix-route hit rate is positive, equal to the reference's."""
    rng = np.random.RandomState(4)
    system = rng.randint(1, 128, 24).astype(np.int32)
    prompts = [np.concatenate([system, rng.randint(1, 128, L)
                               .astype(np.int32)])
               for L in [4, 8, 6, 5] * 2]

    def scenario(side):
        router = _fleet(side, page_size=8, max_len=48)
        for p in prompts[:2]:
            router.submit(p, 8)
        for _ in range(3):
            router.step()
        for p in prompts[2:]:
            router.submit(p, 8)
        return fleet_record(router, router.run())

    rec = both(pair, scenario)
    fleet_no_leak(rec)
    assert rec["stats"]["prefix_route_hit_rate"] > 0
    assert rec["stats"]["requests_requeued"] == 0


@pytest.mark.parametrize("when", ["queued", "in_flight"])
def test_kill_requeues_losslessly(pair, when):
    """kill_replica migrates the victim's queued requests (and, mid-run,
    its in-flight ones) onto the survivor; every id completes with the
    tokens a fault-free single replica gives it, as in the
    reference."""
    prompts, news = _workload(5)
    slos = ("interactive", "batch", "best_effort", "interactive", "batch",
            "batch")

    def scenario(side):
        router = _fleet(side)
        gids = [router.submit(p, n, slo=s)
                for p, n, s in zip(prompts, news, slos)]
        if when == "in_flight":
            router.step()
            router.step()
        victim = max(range(2), key=lambda i: (router._reps[i].bat.queued
                                              + router._reps[i].bat.active,
                                              -i))
        migrated = router.kill_replica(victim)
        assert migrated > 0
        outs = router.run()
        one = _bat(side, max_batch_size=2)
        rids = [one.submit(p, n) for p, n in zip(prompts, news)]
        single = one.run()
        for g, r in zip(gids, rids):
            assert list(outs[g]) == list(single[r]), g
        return fleet_record(router, outs, migrated=migrated)

    rec = both(pair, scenario)
    fleet_no_leak(rec)
    st = rec["stats"]
    assert st["requests_requeued"] == rec["migrated"]
    assert st["requests_shed"] == 0 and st["live_replicas"] == 1


def test_requeue_keeps_arrival_order_and_deadline(pair):
    """Migrated requests land at their global arrival positions with
    their absolute deadlines."""
    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, 128, 6).astype(np.int32) for _ in range(6)]

    def scenario(side):
        router = _fleet(side)
        for b in (r.bat for r in router._reps):
            b._now = Clock()
            b._now.t = 0.0          # before any monotonic deadline
        gids = [router.submit(p, 3, deadline_ms=60000.0) for p in prompts]
        deadlines = {g: router._reqs[g].deadline for g in gids}
        victim = max(range(2), key=lambda i: router._reps[i].bat.queued)
        router.kill_replica(victim)
        survivor = next(r for r in router._reps if not r.dead)
        queued = [r for q in survivor.bat._queues.values() for r in q]
        arrivals = [r.arrival for r in queued]
        assert arrivals == sorted(arrivals)
        for r in queued:
            assert r.deadline == deadlines[survivor.local2g[r.req_id]]
        return fleet_record(router, router.run(), arrivals=arrivals)

    rec = both(pair, scenario)
    fleet_no_leak(rec)
    assert len(rec["arrivals"]) >= 2


def test_stream_gets_no_duplicate_across_a_kill(pair):
    """A replica killed while its requests are mid-stream: each
    consumer's joined bursts equal its final output (no token twice),
    and the survivor's pool is leak-free."""
    prompts, news = _workload(5)

    def scenario(side):
        streams = {}

        def cb(gid, toks, done):
            streams.setdefault(gid, []).append(([int(t) for t in toks],
                                                done))

        router = _fleet(side)
        gids = [router.submit(p, n, on_token=cb)
                for p, n in zip(prompts, news)]
        victim = None
        for _ in range(32):
            router.step()
            for i, rep in enumerate(router._reps):
                if any(r is not None and r.delivered
                       for r in rep.bat._slots):
                    victim = i
                    break
            if victim is not None:
                break
        assert victim is not None
        assert router.kill_replica(victim) > 0
        outs = router.run()
        for g in gids:
            bursts = streams[g]
            assert [t for b, _ in bursts for t in b] == list(outs[g]), g
            assert [d for _, d in bursts].count(True) == 1, g
        for rep in router._reps:
            if not rep.dead:
                a = rep.bat._alloc
                assert a.pages_used == a.pages_cached
        return fleet_record(router, outs, streams=streams)

    fleet_no_leak(both(pair, scenario))


def test_drain_replica_graceful(pair):
    """drain_replica migrates only queued work; the in-flight decode
    finishes on the replica, which retires once empty."""
    prompts, news = _workload(8, 4)

    def scenario(side):
        router = _fleet(side)
        for p, n in zip(prompts, news):
            router.submit(p, n)
        router.step()
        victim = max(range(2), key=lambda i: router._reps[i].bat.queued)
        in_flight = router._reps[victim].bat.active
        migrated = router.drain_replica(victim)
        outs = router.run()
        assert router._reps[victim].dead
        return fleet_record(router, outs, migrated=migrated,
                            in_flight=in_flight)

    rec = both(pair, scenario)
    fleet_no_leak(rec)
    assert rec["stats"]["requests_requeued"] == rec["migrated"]
    assert rec["in_flight"] and rec["migrated"] < len(prompts)


@pytest.mark.parametrize("order", ["before_place", "after_place"])
def test_drain_racing_a_route(pair, monkeypatch, order):
    """A drain landing between the pick and the enqueue (or just after
    it) re-places the request on the survivor; nothing sheds and the
    tokens are the fault-free ones."""
    rng = np.random.RandomState(5)
    p = rng.randint(1, 128, 6).astype(np.int32)

    def scenario(side):
        cls = side.router.ServeRouter
        orig = cls._place
        hit = {}

        def racing(self, rr, rep):
            if order == "before_place" and "victim" not in hit:
                hit["victim"] = rep.idx
                self.drain_replica(rep.idx)
            out = orig(self, rr, rep)
            if order == "after_place" and "victim" not in hit:
                hit["victim"] = rep.idx
                self.drain_replica(rep.idx)
            return out

        monkeypatch.setattr(cls, "_place", racing)
        router = _fleet(side)
        gid = router.submit(p, 6, slo="interactive")
        outs = router.run()
        monkeypatch.setattr(cls, "_place", orig)
        rr = router._reqs[gid]
        assert not rr.shed and rr.replica != hit["victim"]
        one = _bat(side)
        one.submit(p, 6)
        assert list(outs[gid]) == list(one.run()[0])
        return fleet_record(router, outs)

    rec = both(pair, scenario)
    assert rec["stats"]["requests_shed"] == 0


def test_all_draining_sheds_with_no_leak(pair):
    def scenario(side):
        router = _fleet(side, n=1)
        router.drain_replica(0)
        gid = router.submit(np.arange(1, 6, dtype=np.int32), 3)
        outs = router.run()
        assert len(outs[gid]) == 0
        return fleet_record(router, outs)

    rec = both(pair, scenario)
    fleet_no_leak(rec)
    assert rec["stats"]["requests_shed"] == 1
    assert rec["shed"] == {0: "drain"}


def test_rebalance_moves_queued_to_idle(pair):
    """With FLAGS_router_rebalance_ms set, queued work piled on one
    replica moves to the idle one; tokens and counters equal the
    reference's."""
    prompts, news = _workload(4, 4)

    def scenario(side):
        side.set_flags({"FLAGS_router_rebalance_ms": 0.001})
        try:
            router = _fleet(side)
            router._reps[1].draining = True
            for p, n in zip(prompts, news):
                router.submit(p, n)
            assert router.stats()["routed_by_replica"][1] == 0
            router._reps[1].draining = False
            return fleet_record(router, router.run())
        finally:
            side.set_flags({"FLAGS_router_rebalance_ms": 0.0})

    rec = both(pair, scenario)
    fleet_no_leak(rec)
    assert rec["stats"]["rebalanced"] > 0


def test_direct_batcher_request_survives_kill_and_rebalance(pair):
    """A request submitted straight to a replica's batcher is not
    router-managed: rebalance never moves it, and a kill sheds it on
    the batcher, whose accounting stays whole."""
    rng = np.random.RandomState(12)
    prompts = [rng.randint(1, 128, 6).astype(np.int32) for _ in range(6)]

    def scenario(side):
        side.set_flags({"FLAGS_router_rebalance_ms": 0.001})
        try:
            router = _fleet(side)
            direct = router._reps[0].bat.submit(prompts[0], 3)
            for p in prompts[1:4]:
                router.submit(p, 3)
            router.run()
            fin = router._reps[0].bat._finished[direct]
            assert not fin.shed
            router2 = _fleet(side)
            direct2 = router2._reps[0].bat.submit(prompts[4], 3)
            router2.submit(prompts[5], 3)
            router2.kill_replica(0)
            outs = router2.run()
            assert router2._reps[0].bat._finished[direct2].shed
            return fleet_record(router2, outs, direct=list(fin.output()))
        finally:
            side.set_flags({"FLAGS_router_rebalance_ms": 0.0})

    rec = both(pair, scenario)
    st0 = rec["replicas"][0]
    assert st0["requests_submitted"] == st0["requests_completed"] \
        + st0["requests_shed"]


def test_prefix_probe_skipped_when_weight_zero(pair, monkeypatch):
    """FLAGS_router_prefix_weight 0 takes the trie probes off the
    routing path; back at 1 each replica is probed once a route."""
    calls = []
    orig = ContinuousBatcher.prefix_match_len

    def counting(self, ids):
        calls.append(1)
        return orig(self, ids)

    monkeypatch.setattr(ContinuousBatcher, "prefix_match_len", counting)
    side = sides(*pair)[1]
    router = _fleet(side)
    prompt = np.arange(1, 7, dtype=np.int32)
    set_flags({"FLAGS_router_prefix_weight": 0.0})
    try:
        router.submit(prompt, 3)
        assert not calls
    finally:
        set_flags({"FLAGS_router_prefix_weight": 1.0})
    router.submit(prompt, 3)
    assert len(calls) == 2
    router.run()


def test_fleet_serve_reads_flag_and_shares_the_model(pair):
    """fleet_serve builds FLAGS_serve_replicas (0 -> 2) batchers over
    one model: the weights are shared, the pools are not."""
    tm = pair[1]
    set_flags({"FLAGS_serve_replicas": 3})
    try:
        router = fleet_serve(tm, device="cpu", **GEOM)
        assert router.replicas == 3
    finally:
        set_flags({"FLAGS_serve_replicas": 0})
    router = fleet_serve(tm, device="cpu", **GEOM)
    assert router.replicas == 2
    a, b = (r.bat for r in router._reps)
    assert a.model is b.model is tm
    assert a._cache["k"].data_ptr() != b._cache["k"].data_ptr()


# ---------------------------------------------------------------------------
# replica-per-rank discovery over a KV object

def test_publish_discover_roundtrip_and_tombstone(pair):
    """Every router step publishes each live replica's view under
    <job>/serve/<replica>/latest with a heartbeat; discover_replicas
    reads them back (views the policy accepts), a retired replica's
    tombstone hides it, and a string endpoint raises until the launch
    plane's KVClient is ported."""
    side = sides(*pair)[1]
    kv = _LocalKV()
    router = side.router.ServeRouter(
        batchers=[_bat(side) for _ in range(2)], kv=kv, job_id="rt")
    prompts, news = _workload(3, 4)
    for p, n in zip(prompts, news):
        router.submit(p, n)
    router.run()
    views = trouter.discover_replicas(kv, "rt")
    assert sorted(views) == [0, 1]
    for rid, v in views.items():
        assert v["replica"] == rid and v["role"] == "serve"
        assert kv.get(f"rt/serve/{rid}/hb") is not None
        assert "trie_digest" in v
    assert trouter.pick_replica(list(views.values())) in (0, 1)
    pub = trouter.ReplicaPublisher(kv, job_id="rt", replica=7)
    assert pub.publish(_bat(side).router_view())
    assert sorted(trouter.discover_replicas(kv, "rt")) == [0, 1, 7]
    assert pub.retire()
    assert sorted(trouter.discover_replicas(kv, "rt")) == [0, 1]
    assert kv.get("rt/serve/7/latest") is not None
    router.drain_replica(1)
    router.step()                   # an empty draining replica retires
    assert router._reps[1].dead
    assert sorted(trouter.discover_replicas(kv, "rt")) == [0]
    with pytest.raises(NotImplementedError, match="item 9"):
        trouter.discover_replicas("127.0.0.1:1", "rt")
    with pytest.raises(NotImplementedError, match="KVClient"):
        trouter.ReplicaPublisher("127.0.0.1:1")

