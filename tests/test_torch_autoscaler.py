"""The SLO-driven autoscaler of paddle_tpu_torch against paddle_tpu's, on
the CPU, as tests/test_autoscaler.py pins it for the reference (its two
CLI selftests have no counterpart yet, and its telemetry counters are
read here from the router instead: the port has no telemetry plane).

  * policy: `observe`, `decide` and `after_action` equal the reference's
    over seeded sequences of synthetic fleet views (hysteresis,
    cooldowns, floor repair, the scale-in victim, role repair both ways)
    and on the reference's own cases;
  * fencing and recovery: the lease, epoch claims past a foreign
    record, a crash before commit settled without re-execution, and the
    rollbacks under `autoscale.drain` and `autoscale.reform` faults;
  * the load: `DiurnalLoadSim` gives the reference's requests, and the
    bench's CPU curve gives the reference's journal, kind for kind and
    tick for tick, with nothing shed where the static fleet sheds."""
import json

import numpy as np
import pytest
import torch
from torch_cpu import one_cpu_thread  # noqa: F401 (autouse)
from torch_serve_pair import Clock, both, model_pair, sides

from paddle_tpu import fleet as jfleet

from paddle_tpu_torch import fleet as tfleet
from paddle_tpu_torch.fleet.autoscaler import _LocalKV, _SimulatedCrash

FLEETS = [jfleet, tfleet]
GEOM = dict(max_batch_size=1, max_len=64, chunk=4, prefill_chunk=4)


@pytest.fixture(scope="module")
def pair():
    torch.manual_seed(0)
    return model_pair(seed=7)


def _bat(side, **kw):
    return side.batcher(Clock(), **dict(GEOM, **kw))


def _router(side, n=1, **kw):
    return side.router.ServeRouter(batchers=[_bat(side, **kw)
                                             for _ in range(n)])


def _on(side):
    side.set_flags({"FLAGS_autoscale": True})


def _off(side):
    side.set_flags({"FLAGS_autoscale": False})


def _fv(occ, reps=2, draining=(), work=None, att=None, shed=0.0,
        roles=None):
    """Synthetic fleet view for the pure-policy tests."""
    replicas = []
    for i in range(reps):
        q = (work or {}).get(i, 0)
        replicas.append({"replica": i,
                         "role": (roles or {}).get(i, "serve"),
                         "draining": i in draining,
                         "queued": q, "active": 0,
                         "attainment_interactive": att})
    routable = reps - len(set(draining) & set(range(reps)))
    return {"replicas": replicas, "routable": routable,
            "slots": routable, "queued": sum((work or {}).values()),
            "active": 0, "occupancy": occ, "attainment_interactive": att,
            "shed_rate_window": shed}


def _state(st):
    return (st.pressure_streak, st.idle_streak, st.prefill_streak,
            st.decode_streak, dict(st.cooldowns))


# ---------------------------------------------------------------------------
# the policy

def _random_policy(mod, rng):
    kw = dict(min_replicas=int(rng.randint(1, 3)),
              max_replicas=int(rng.randint(3, 6)),
              queue_high=float(rng.choice([0.75, 1.0, 1.5])),
              queue_low=float(rng.choice([0.1, 0.25, 0.5])),
              attainment_floor=float(rng.choice([0.0, 0.9])),
              shed_high=float(rng.choice([0.05, 0.2])),
              window=int(rng.randint(1, 4)),
              cooldown=int(rng.randint(0, 4)),
              role_imbalance=float(rng.choice([0.0, 2.0, 3.0])))
    if rng.rand() < 0.25:
        kw["target_roles"] = {"prefill": 1, "decode": int(rng.randint(1, 3))}
    return mod.AutoscalePolicy(**kw)


def _random_view(rng):
    n = int(rng.randint(1, 6))
    split = rng.rand() < 0.5
    reps = []
    for i in range(n):
        role = (["prefill", "decode"][int(rng.rand() < 0.5)] if split
                else "serve")
        reps.append({"replica": i, "role": role,
                     "draining": bool(rng.rand() < 0.2),
                     "queued": int(rng.randint(0, 5)),
                     "active": int(rng.randint(0, 3)),
                     "handoff_ready": 0,
                     "attainment_interactive": [None, 0.5, 0.95][
                         rng.randint(3)]})
    view = {"replicas": reps,
            "routable": sum(not r["draining"] for r in reps),
            "occupancy": float(rng.choice([0.0, 0.2, 0.6, 1.2, 2.5])),
            "shed_rate_window": float(rng.choice([0.0, 0.0, 0.1])),
            "attainment_interactive": [None, 0.5, 0.95][rng.randint(3)]}
    if split and rng.rand() < 0.8:
        view["prefill_pressure"] = float(rng.choice([0.0, 0.5, 1.0, 3.0]))
        view["decode_pressure"] = float(rng.choice([0.0, 0.5, 1.0, 3.0]))
    return view


@pytest.mark.parametrize("seed", range(6))
def test_policy_sequences_equal_reference(seed):
    """observe -> decide -> after_action threaded through 60 seeded
    synthetic views (an executed action committed at random, as a
    rollback or a lost epoch would not be): every action and every
    state equal to the reference's."""
    runs = []
    for mod in FLEETS:
        rng = np.random.RandomState(seed)
        pol = _random_policy(mod, rng)
        st = mod.PolicyState()
        trace = []
        for _ in range(60):
            view = _random_view(rng)
            mod.observe(st, view, pol)
            act = mod.decide(view, pol, st)
            if act.kind != "none" and rng.rand() < 0.7:
                mod.after_action(st, act, pol)
            trace.append((act.to_dict(), _state(st)))
        runs.append(trace)
    assert runs[1] == runs[0]
    kinds = {a["kind"] for a, _ in runs[1]}
    assert len(kinds) >= 2, kinds


def _hysteresis(mod):
    pol = mod.AutoscalePolicy(min_replicas=1, max_replicas=4, window=2,
                              cooldown=0, queue_high=1.0, queue_low=0.2)
    st = mod.PolicyState()
    out = []
    for _ in range(2):
        mod.observe(st, _fv(2.0), pol)
        out.append(mod.decide(_fv(2.0), pol, st).kind)
    assert out == ["none", "scale_out"]
    return out


def _oscillating(mod):
    pol = mod.AutoscalePolicy(min_replicas=1, max_replicas=4, window=2,
                              cooldown=0, queue_high=1.0, queue_low=0.5)
    st = mod.PolicyState()
    out = []
    for t in range(20):
        view = _fv(2.0 if t % 2 == 0 else 0.0)
        mod.observe(st, view, pol)
        out.append(mod.decide(view, pol, st).kind)
    assert set(out) == {"none"}
    return out


def _cooldown(mod):
    pol = mod.AutoscalePolicy(min_replicas=1, max_replicas=4, window=1,
                              cooldown=3, queue_high=1.0, queue_low=0.5)
    st = mod.PolicyState()
    mod.observe(st, _fv(2.0), pol)
    act = mod.decide(_fv(2.0), pol, st)
    assert act.kind == "scale_out"
    mod.after_action(st, act, pol)
    assert st.cooling("scale_in") and st.cooling("scale_out")
    kinds = []
    for _ in range(4):
        mod.observe(st, _fv(0.0, reps=3), pol)
        kinds.append(mod.decide(_fv(0.0, reps=3), pol, st).kind)
    assert kinds == ["none", "none", "scale_in", "scale_in"]
    return kinds


def _floor(mod):
    pol = mod.AutoscalePolicy(min_replicas=2, max_replicas=4, window=5,
                              cooldown=5, queue_high=1.0, queue_low=0.2)
    st = mod.PolicyState()
    st.cooldowns["scale_out"] = 99
    a = mod.decide(_fv(0.0, reps=3, draining=(1, 2)), pol, st)
    b = mod.decide(_fv(0.0, reps=1), pol, st)
    assert (a.kind, a.replica, b.kind, b.replica) == \
        ("scale_out", 1, "scale_out", None)
    return [a.to_dict(), b.to_dict()]


def _victim(mod):
    pol = mod.AutoscalePolicy(min_replicas=1, max_replicas=4, window=1,
                              cooldown=0, queue_high=9.0, queue_low=0.5)
    st = mod.PolicyState()
    mod.observe(st, _fv(0.0, reps=3), pol)
    act = mod.decide(_fv(0.0, reps=3, work={0: 4, 1: 0, 2: 0}), pol, st)
    assert act.kind == "scale_in" and act.replica == 2
    return act.to_dict()


def _role_repair(mod):
    pol = mod.AutoscalePolicy(min_replicas=1, max_replicas=4, window=1,
                              cooldown=0, queue_high=9.0, queue_low=0.0,
                              target_roles={"serve": 1, "decode": 1})
    act = mod.decide(_fv(0.5, work={0: 3, 1: 1}), pol, mod.PolicyState())
    assert (act.kind, act.replica, act.role) == ("role_flip", 1, "decode")
    return act.to_dict()


def _rv(pp, dp, reps):
    return {"routable": len([r for r in reps if not r["draining"]]),
            "occupancy": 0.5, "prefill_pressure": pp,
            "decode_pressure": dp, "replicas": reps}


def _rp(i, role, queued=0, active=0):
    return {"replica": i, "role": role, "queued": queued,
            "active": active, "slots": 1, "draining": False,
            "handoff_ready": 0}


def _role_flip(mod):
    pol = mod.AutoscalePolicy(min_replicas=1, max_replicas=4, window=2,
                              cooldown=2, queue_high=99.0, queue_low=0.0,
                              role_imbalance=2.0, lease_ttl_s=0.0)
    out = []
    cases = [
        ([_rp(0, "prefill", queued=3), _rp(1, "decode"),
          _rp(2, "decode", active=1)], 3.0, 0.0, ("prefill", 1)),
        ([_rp(0, "prefill", queued=3), _rp(1, "decode")], 3.0, 0.0, None),
        ([_rp(0, "prefill", queued=1), _rp(1, "prefill"),
          _rp(2, "decode", active=1)], 0.0, 3.0, ("decode", 1)),
        ([_rp(0, "prefill", queued=3), _rp(1, "decode"),
          _rp(2, "decode", active=1)], 0.0, 3.0, None),
    ]
    for reps, pp, dp, want in cases:
        st = mod.PolicyState()
        v = _rv(pp, dp, reps)
        mod.observe(st, v, pol)
        assert mod.decide(v, pol, st).kind == "none"
        mod.observe(st, v, pol)
        act = mod.decide(v, pol, st)
        got = (act.role, act.replica) if act.kind == "role_flip" else None
        assert got == want, (reps, got)
        mod.observe(st, _rv(1.0, 1.0, reps), pol)
        assert st.prefill_streak == st.decode_streak == 0
        out.append(act.to_dict())
    return out


POLICY_CASES = {"hysteresis": _hysteresis, "oscillating": _oscillating,
                "cooldown": _cooldown, "floor_repair": _floor,
                "scale_in_victim": _victim, "role_repair": _role_repair,
                "role_flip": _role_flip}


@pytest.mark.parametrize("case", sorted(POLICY_CASES))
def test_policy_reference_cases(case):
    """The reference's policy cases, each with its own expectations,
    give the same decisions in both packages."""
    fn = POLICY_CASES[case]
    assert fn(tfleet) == fn(jfleet)


def test_fleet_view_equal_reference(pair):
    """fleet_view aggregates the same numbers as the reference's: a
    unified fleet with queued work (no role split), and a split fleet
    whose frozen slots count as decode demand."""
    rng = np.random.RandomState(4)
    prompts = [rng.randint(1, 128, 6).astype(np.int32) for _ in range(5)]

    def scenario(side):
        uni = _router(side, n=2)
        for p in prompts:
            uni.submit(p, 4)
        views = [side.fleet.fleet_view(uni)]
        uni.step()
        views.append(side.fleet.fleet_view(uni))
        split = side.router.ServeRouter(
            batchers=[_bat(side, role="prefill"),
                      _bat(side, role="decode")],
            roles=["prefill", "decode"])
        views.append(side.fleet.fleet_view(split))
        for p in prompts[:3]:
            split.submit(p, 6)
        for _ in range(3):
            split.step()
            views.append(side.fleet.fleet_view(split))
        split.run()
        return dict(views=views)

    rec = both(pair, scenario)
    assert "prefill_pressure" not in rec["views"][0]
    assert rec["views"][2]["prefill_pressure"] == 0.0


# ---------------------------------------------------------------------------
# lease and epochs

def test_lease_fences_a_second_daemon_and_expires(pair):
    side = sides(*pair)[1]
    _on(side)
    try:
        kv = _LocalKV()
        router = _router(side)
        pol = tfleet.AutoscalePolicy(min_replicas=1, max_replicas=2,
                                     lease_ttl_s=1000.0)
        d1 = tfleet.AutoscalerDaemon(router, kv=kv, policy=pol,
                                     daemon_id="a")
        d2 = tfleet.AutoscalerDaemon(router, kv=kv, policy=pol,
                                     daemon_id="b")
        assert d1.tick()["status"] != "no_lease"
        assert d2.tick()["status"] == "no_lease"
        assert d1.tick()["status"] != "no_lease"
        kv2 = _LocalKV()
        e1 = tfleet.AutoscalerDaemon(
            router, kv=kv2, daemon_id="a",
            policy=tfleet.AutoscalePolicy(min_replicas=1, max_replicas=2,
                                          lease_ttl_s=0.0))
        e2 = tfleet.AutoscalerDaemon(router, kv=kv2, daemon_id="b",
                                     policy=pol)
        assert e1.tick()["status"] != "no_lease"
        assert e2.tick()["status"] != "no_lease"      # expired: taken
        assert json.loads(kv2.get("serve/autoscale/lease"))["owner"] == "b"
        assert e1.tick()["status"] == "no_lease"
    finally:
        _off(side)
    assert tfleet.AutoscalerDaemon(router).tick() == {"status": "disabled"}


def test_epoch_claim_steps_past_foreign_record(pair):
    side = sides(*pair)[1]
    d = tfleet.AutoscalerDaemon(_router(side))
    foreign = json.dumps({"epoch": 0, "owner": "other", "status": "done",
                          "kind": "scale_out"})
    assert d.kv.put_new(d._journal_key(0), foreign)
    assert d._claim_epoch(tfleet.Action("scale_out"), {}) == 1
    assert d.kv.get(d._journal_key(0)) == foreign
    recs = d.journal()
    assert [r["epoch"] for r in recs] == [0, 1]
    assert recs[1]["status"] == "pending"
    with pytest.raises(NotImplementedError, match="item 9"):
        tfleet.AutoscalerDaemon(_router(side), kv="127.0.0.1:1")


def _idle_policy(mod, **kw):
    base = dict(min_replicas=1, max_replicas=3, window=1, cooldown=0,
                queue_high=9.0, queue_low=0.9, retry_budget=2,
                backoff_s=0.0, lease_ttl_s=0.0)
    base.update(kw)
    return mod.AutoscalePolicy(**base)


def _brief(recs):
    return [{k: r.get(k) for k in ("epoch", "tick", "status", "kind",
                                   "replica", "role", "recovered_by",
                                   "fleet_before", "view_before",
                                   "view_after")} for r in recs]


def test_crash_before_commit_recovers_without_reexecution(pair,
                                                          monkeypatch):
    """A daemon dying between the drain and the commit leaves a pending
    record; the next daemon commits it done without draining again."""
    def scenario(side):
        _on(side)
        try:
            router = _router(side, n=2)
            drains = []
            orig = router.drain_replica
            monkeypatch.setattr(router, "drain_replica",
                                lambda i: drains.append(i) or orig(i))
            d1 = side.fleet.AutoscalerDaemon(
                router, policy=_idle_policy(side.fleet), daemon_id="a")
            d1._crash_before_commit = True
            with pytest.raises(Exception) as err:
                d1.tick()
            assert type(err.value).__name__ == "_SimulatedCrash"
            (rec,) = d1.journal()
            assert rec["status"] == "pending"
            assert router._reps[rec["replica"]].draining
            d2 = side.fleet.AutoscalerDaemon(
                router, kv=d1.kv, policy=_idle_policy(side.fleet),
                daemon_id="b")
            out = d2.tick()
            assert out["status"] != "no_lease"
            (rec,) = d2.journal()
            assert rec["status"] == "done" and rec["recovered_by"] == "b"
            assert drains == [rec["replica"]]
            return dict(journal=_brief(d2.journal()), out=out,
                        drains=drains)
        finally:
            _off(side)

    both(pair, scenario)
    assert issubclass(_SimulatedCrash, RuntimeError)


def test_recover_rolls_back_a_scale_out_that_never_happened(pair):
    def scenario(side):
        router = _router(side)
        d = side.fleet.AutoscalerDaemon(router,
                                        policy=_idle_policy(side.fleet),
                                        daemon_id="a")
        d.kv.put_new(d._journal_key(0), json.dumps({
            "epoch": 0, "owner": "dead", "status": "pending",
            "kind": "scale_out", "replica": None,
            "fleet_before": len(router._reps)}))
        assert d.recover() == 1
        assert len(router._reps) == 1
        return dict(journal=_brief(d.journal()))

    rec = both(pair, scenario)
    assert rec["journal"][0]["status"] == "rolled_back"


@pytest.mark.parametrize("point", ["autoscale.drain", "autoscale.reform"])
def test_fault_rolls_back_and_keeps_the_fleet(pair, point):
    """Exhausted retries on the drain (a scale-in) or the re-form (a
    scale-out) roll the action back: every replica stays routable, the
    fleet's shape is unchanged, the journal records the failure, and
    queued work still completes."""
    rng = np.random.RandomState(4)
    prompts = [rng.randint(1, 128, 6).astype(np.int32) for _ in range(3)]

    def scenario(side):
        _on(side)
        try:
            if point == "autoscale.drain":
                router = _router(side, n=2)
                d = side.fleet.AutoscalerDaemon(
                    router, policy=_idle_policy(side.fleet),
                    daemon_id="a")
            else:
                router = _router(side)
                d = side.fleet.AutoscalerDaemon(
                    router, spawn=lambda: _bat(side), daemon_id="a",
                    policy=_idle_policy(side.fleet, queue_high=1.5,
                                        queue_low=0.1))
                for p in prompts:
                    router.submit(p, 4)
            n0 = len(router._reps)
            with side.fault.scope(f"{point}:times=*:mode=error"):
                out = d.tick()
            assert out["status"] == "rolled_back", out
            assert not any(r.draining for r in router._reps)
            assert len(router._reps) == n0
            (rec,) = d.journal()
            assert rec["status"] == "rolled_back" and rec["error"]
            outs = router.run()
            assert router.stats()["requests_shed"] == 0
            return dict(journal=_brief(d.journal()), out=out["action"],
                        outs={g: [int(t) for t in v]
                              for g, v in outs.items()})
        finally:
            _off(side)

    both(pair, scenario)


def test_decide_fault_degrades_the_tick(pair):
    def scenario(side):
        _on(side)
        try:
            d = side.fleet.AutoscalerDaemon(
                _router(side), policy=_idle_policy(side.fleet))
            with side.fault.scope("autoscale.decide:times=1:mode=error"):
                first = d.tick()["status"]
            return dict(first=first, then=d.tick()["status"],
                        journal=_brief(d.journal()))
        finally:
            _off(side)

    rec = both(pair, scenario)
    assert rec["first"] == "degraded" and rec["then"] == "noop"


# ---------------------------------------------------------------------------
# the load

@pytest.mark.parametrize("seed", [0, 3, 11])
def test_diurnal_sim_equal_reference(seed):
    kw = dict(vocab=128, seed=seed, period=6, low=1, high=6)
    a, b = jfleet.DiurnalLoadSim(**kw), tfleet.DiurnalLoadSim(**kw)
    b.requests(5)               # call order must not matter
    for t in range(13):
        ra, rb = a.requests(t), b.requests(t)
        assert a.rate(t) == b.rate(t) == len(ra) == len(rb)
        for x, y in zip(ra, rb):
            np.testing.assert_array_equal(x["prompt"], y["prompt"])
            assert (x["slo"], x["max_new"]) == (y["slo"], y["max_new"])
    assert b.rate(3) == 6 and b.rate(0) == 1


def _flap_count(records, cooldown):
    """tools/autoscale_report.py::flap_count: opposite executed scale
    actions closer than the cooldown, in ticks."""
    opposite = {"scale_out": "scale_in", "scale_in": "scale_out"}
    done = [r for r in records
            if r.get("status") == "done" and r.get("kind") in opposite]
    return sum(1 for a, b in zip(done, done[1:])
               if b["kind"] == opposite[a["kind"]]
               and int(b["tick"]) - int(a["tick"]) < cooldown)


def test_autoscale_curve_equal_reference(pair):
    """bench.py's CPU autoscale leg (:1352-1357): a diurnal curve through
    a fleet that starts at one replica; the autoscaled fleet scales out
    into the peak and back in at the trough with the reference's
    journal (kind, tick, replica, status), sheds nothing and never
    flaps, while the static one-replica fleet sheds."""
    ticks, period, low, high = 12, 6, 1, 6
    geom = dict(max_batch_size=2, max_len=48, chunk=4, prefill_chunk=4,
                page_size=8)

    def scenario(side):
        sim = side.fleet.DiurnalLoadSim(vocab=128, seed=3, period=period,
                                        low=low, high=high, prompt_len=6,
                                        max_new=6)
        pol = side.fleet.AutoscalePolicy(min_replicas=1, max_replicas=3,
                                         window=1, cooldown=2,
                                         queue_high=0.75, queue_low=0.5,
                                         lease_ttl_s=0.0)
        res = {}
        for auto in (True, False):
            router = side.router.ServeRouter(
                batchers=[side.batcher(Clock(), **geom)])
            d = side.fleet.AutoscalerDaemon(
                router, policy=pol,
                spawn=lambda: side.batcher(Clock(), **geom)) \
                if auto else None
            side.set_flags({"FLAGS_autoscale": auto,
                            "FLAGS_serve_queue_depth": 6})
            try:
                for t in range(ticks + 4):
                    if t < ticks:
                        for r in sim.requests(t):
                            router.submit(r["prompt"], r["max_new"],
                                          slo=r["slo"])
                    if d is not None:
                        d.tick()
                    for _ in range(8):
                        router.step()
                outs = router.run()
            finally:
                side.set_flags({"FLAGS_autoscale": False,
                                "FLAGS_serve_queue_depth": 0})
            st = router.stats()
            res["auto" if auto else "static"] = dict(
                shed=st["requests_shed"], live=st["live_replicas"],
                submitted=st["requests_submitted"],
                journal=[{k: r.get(k) for k in ("tick", "kind", "replica",
                                                "status")}
                         for r in (d.journal() if d else [])],
                outs={g: [int(x) for x in v] for g, v in outs.items()})
        return res

    rec = both(pair, scenario)
    auto, static = rec["auto"], rec["static"]
    kinds = [r["kind"] for r in auto["journal"] if r["status"] == "done"]
    assert "scale_out" in kinds and "scale_in" in kinds, auto["journal"]
    assert all(r["status"] != "pending" for r in auto["journal"])
    assert _flap_count(auto["journal"], 2) == 0
    assert auto["shed"] == 0 < static["shed"]
    assert len(auto["outs"]) == auto["submitted"]

