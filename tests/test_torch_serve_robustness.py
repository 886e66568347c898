"""The serving request plane of paddle_tpu_torch against paddle_tpu's, on
the CPU: SLO-aware admission, deadlines, load shedding, fault recovery,
the watchdog and the drain, as tests/test_serve_robustness.py pins them
for the reference (its compile-count pin, its chaos CLI and its
telemetry-event test have no counterpart: the port compiles no step
programs and has no telemetry plane yet).

Each scenario runs on both packages with the same weights, fault spec
and patched clock (tests/torch_serve_pair.py), and both must give the
same tokens request for request, the same shed ids and reasons and the
same stats counters; the port's surviving outputs must also equal its
isolated greedy generate()."""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from torch_cpu import one_cpu_thread  # noqa: F401 (autouse)
from torch_serve_pair import (Clock, both, isolated, model_pair, no_leak,
                              record, sides)

from paddle_tpu.inference import SLO_CLASSES as J_SLO_CLASSES

from paddle_tpu_torch.distributed import watchdog
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.inference import SLO_CLASSES


@pytest.fixture(scope="module")
def pair():
    torch.manual_seed(0)
    return model_pair(seed=7)


@pytest.fixture(autouse=True)
def _clean_drain():
    for s in sides(None, None):
        s.guard.clear_drain()
    yield
    for s in sides(None, None):
        s.guard.clear_drain()


GEOM = dict(max_batch_size=2, max_len=64, chunk=4, prefill_chunk=4)


def _bat(side, clock=None, **kw):
    return side.batcher(clock, **dict(GEOM, **kw))


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 128, L).astype(np.int32) for L in lens]


def _admit_order(bat):
    """Step to the end, noting each request the step it was admitted."""
    order, seen = [], {r.req_id for r in bat._slots if r is not None}
    while bat.queued or bat.active:
        bat.step()
        for req in bat._slots:
            if req is not None and req.req_id not in seen:
                seen.add(req.req_id)
                order.append(req.req_id)
    return order


def _check_isolated(pair, rec, prompts, new, rids=None):
    rids = range(len(prompts)) if rids is None else rids
    for rid, p, n in zip(rids, prompts, new):
        if rid not in rec["shed"]:
            assert rec["outs"][rid] == isolated(pair[1], p, n), rid


# ---------------------------------------------------------------------------
# SLO classes and admission order


def test_slo_priority_admission_order(pair):
    prompts = _prompts(3, (5, 6, 7, 4))

    def scenario(side):
        bat = _bat(side, max_batch_size=1)
        bat.submit(prompts[0], 6, slo="batch")
        bat.step()
        bat.submit(prompts[1], 4, slo="best_effort")
        bat.submit(prompts[2], 4, slo="batch")
        bat.submit(prompts[3], 4, slo="interactive")
        return record(bat, order=_admit_order(bat))

    rec = both(pair, scenario)
    assert rec["order"] == [3, 2, 1]
    _check_isolated(pair, rec, prompts, (6, 4, 4, 4))
    no_leak(rec)


def test_deferred_long_prompt_not_starved_by_short_stream(pair):
    short0, long_p, *shorts = _prompts(9, (4, 32, 4, 4, 4))

    def scenario(side):
        # 7 usable pages of 8 rows: the running short holds 2, the long
        # needs 6 -> deferred; the later shorts would fit
        bat = _bat(side, page_size=8, num_pages=8)
        bat.submit(short0, 4)
        bat.step()
        bat.submit(long_p, 4)
        for p in shorts:
            bat.submit(p, 4)
        admitted, step_no = {}, 0
        while bat.queued or bat.active:
            bat.step()
            step_no += 1
            for req in bat._slots:
                if req is not None and req.req_id not in admitted:
                    admitted[req.req_id] = step_no
        return record(bat, admitted=admitted)

    rec = both(pair, scenario)
    assert all(rec["admitted"][1] <= rec["admitted"][r] for r in (2, 3, 4))
    _check_isolated(pair, rec, [short0, long_p] + shorts, [4] * 5)
    assert rec["stats"]["requests_shed"] == 0
    no_leak(rec)


# ---------------------------------------------------------------------------
# load shedding: bounded queue and deadlines


def test_queue_depth_sheds_lowest_slo_newest_first(pair):
    ps = _prompts(5, (5, 4, 6, 7))

    def scenario(side):
        side.set_flags({"FLAGS_serve_queue_depth": 2})
        try:
            bat = _bat(side, max_batch_size=1)
            bat.submit(ps[0], 4, slo="best_effort")
            bat.step()                         # best_effort in flight
            bat.submit(ps[1], 4, slo="best_effort")
            bat.submit(ps[2], 4, slo="interactive")
            bat.submit(ps[3], 4, slo="batch")  # overflow
            bat.run()
        finally:
            side.set_flags({"FLAGS_serve_queue_depth": 0})
        return record(bat)

    rec = both(pair, scenario)
    assert rec["shed"] == {1: "queue_full"}
    assert rec["outs"][1] == []
    assert rec["stats"]["shed_by_class"]["best_effort"] == 1
    no_leak(rec)


def test_queue_depth_sheds_newest_within_class(pair):
    """Two queued best_effort requests and an incoming batch one past
    the bound: the NEWER best_effort goes, the older stays."""
    ps = _prompts(7, (5, 4, 6, 7))

    def scenario(side):
        side.set_flags({"FLAGS_serve_queue_depth": 2})
        try:
            bat = _bat(side, max_batch_size=1)
            bat.submit(ps[0], 4, slo="batch")
            bat.step()                         # in flight
            bat.submit(ps[1], 4, slo="best_effort")
            bat.submit(ps[2], 4, slo="best_effort")
            bat.submit(ps[3], 4, slo="batch")  # overflow
            bat.run()
        finally:
            side.set_flags({"FLAGS_serve_queue_depth": 0})
        return record(bat)

    rec = both(pair, scenario)
    assert rec["shed"] == {2: "queue_full"}
    _check_isolated(pair, rec, ps, (4, 4, 4, 4))
    no_leak(rec)


def test_queue_depth_incoming_lowest_sheds_itself(pair):
    ps = _prompts(6, (5, 4, 6))

    def scenario(side):
        side.set_flags({"FLAGS_serve_queue_depth": 1})
        try:
            bat = _bat(side, max_batch_size=1)
            bat.submit(ps[0], 4, slo="interactive")
            bat.step()
            bat.submit(ps[1], 4, slo="interactive")
            bat.submit(ps[2], 4, slo="best_effort")   # sheds itself
            bat.run()
        finally:
            side.set_flags({"FLAGS_serve_queue_depth": 0})
        return record(bat)

    rec = both(pair, scenario)
    assert rec["shed"] == {2: "queue_full"}
    no_leak(rec)


def test_deadline_miss_sheds_queued_only(pair):
    p1, p2, p3 = _prompts(8, (5, 7, 4))

    def scenario(side):
        clock = Clock()
        bat = _bat(side, clock, max_batch_size=1)
        bat.submit(p1, 8, deadline_ms=1000.0)
        bat.step()                                  # r1 admitted
        # r1's deadline passes while it is in flight: untouchable; r2's
        # passes while it waits
        clock.t += 10.0
        bat.submit(p2, 4, deadline_ms=0.001, slo="interactive")
        clock.t += 0.01
        bat.submit(p3, 4)                           # no deadline
        bat.run()
        return record(bat)

    rec = both(pair, scenario)
    assert rec["shed"] == {1: "deadline"}
    assert rec["stats"]["deadline_misses"] == 1
    _check_isolated(pair, rec, [p1, p2, p3], (8, 4, 4))
    no_leak(rec)


def test_default_deadline_flag(pair):
    p = _prompts(12, (4,))[0]

    def scenario(side):
        bat = _bat(side)
        side.set_flags({"FLAGS_serve_default_deadline_ms": 60000.0})
        try:
            rid = bat.submit(p, 4)
        finally:
            side.set_flags({"FLAGS_serve_default_deadline_ms": 0.0})
        req = next(r for q in bat._queues.values() for r in q
                   if r.req_id == rid)
        deadline = req.deadline - req.t_submit
        bat.run()
        return record(bat, deadline=deadline)

    rec = both(pair, scenario)
    assert rec["deadline"] == pytest.approx(60.0)


def test_explicit_zero_deadline_means_none(pair):
    p = _prompts(28, (5,))[0]

    def scenario(side):
        bat = _bat(side, max_batch_size=1)
        bat.submit(p, 4, deadline_ms=0)
        bat.run()
        return record(bat)

    rec = both(pair, scenario)
    assert rec["shed"] == {}
    _check_isolated(pair, rec, [p], (4,))


# ---------------------------------------------------------------------------
# fault recovery at the four serve points


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_decode_fault_evicts_requeues_bitexact(pair, layout):
    """A poisoned slot mid-generation is evicted and requeued at its
    arrival position, and re-decodes bit-exactly while the other slot
    keeps decoding; the discarded tokens never reach tokens_produced."""
    prompts = _prompts(11, (5, 9, 7, 4))
    new = (6, 5, 7, 4)

    def scenario(side):
        with side.fault.scope("serve.decode:step=3:mode=error"):
            bat = _bat(side, kv_layout=layout)
            for p, n in zip(prompts, new):
                bat.submit(p, n)
            bat.run()
            fired = side.fault.fired_counts().get("serve.decode", 0)
        return record(bat, fired=fired)

    rec = both(pair, scenario)
    assert rec["fired"] == 1 and rec["stats"]["requests_requeued"] == 1
    _check_isolated(pair, rec, prompts, new)
    assert rec["stats"]["tokens_produced"] == sum(new)
    assert rec["stats"]["requests_shed"] == 0
    no_leak(rec)


def test_decode_fault_budget_exhaustion_sheds(pair):
    p_ok, p_bad = _prompts(15, (4, 5))

    def scenario(side):
        with side.fault.scope("serve.decode:times=*:mode=error:match=slot1"):
            bat = _bat(side)
            bat.submit(p_ok, 5)        # slot 0
            bat.submit(p_bad, 5)       # slot 1: always poisoned
            bat.run()
        return record(bat)

    rec = both(pair, scenario)
    assert rec["shed"] == {1: "decode_fault"}
    assert rec["stats"]["requests_requeued"] == 3      # the budget
    _check_isolated(pair, rec, [p_ok], (5,))
    no_leak(rec)


def test_admit_fault_retries_then_completes(pair):
    prompts = _prompts(16, (5, 7, 6))

    def scenario(side):
        with side.fault.scope("serve.admit:step=2:mode=error"):
            bat = _bat(side)
            for p in prompts:
                bat.submit(p, 5)
            bat.run()
            fired = side.fault.fired_counts().get("serve.admit", 0)
        return record(bat, fired=fired)

    rec = both(pair, scenario)
    assert rec["fired"] == 1 and rec["shed"] == {}
    _check_isolated(pair, rec, prompts, (5, 5, 5))
    no_leak(rec)


def test_admit_reject_sheds_request(pair):
    prompts = _prompts(17, (5, 7))

    def scenario(side):
        with side.fault.scope("serve.admit:step=1:mode=skip"):
            bat = _bat(side)
            for p in prompts:
                bat.submit(p, 5)
            bat.run()
        return record(bat)

    rec = both(pair, scenario)
    assert rec["shed"] == {0: "admit_fault"}
    _check_isolated(pair, rec, prompts, (5, 5))
    no_leak(rec)


@pytest.mark.parametrize("mode", ["error", "skip"])
def test_kv_alloc_fault_defers_fifo(pair, mode):
    """A transient allocator fault (or a data-mode one: simulated pool
    exhaustion) defers the head FIFO-in-place."""
    prompts = _prompts(18, (6, 5, 4))

    def scenario(side):
        with side.fault.scope(f"serve.kv_alloc:step=1:times=2:mode={mode}"):
            bat = _bat(side, max_batch_size=1)
            for p in prompts:
                bat.submit(p, 4)
            order = _admit_order(bat)
            fired = side.fault.fired_counts().get("serve.kv_alloc", 0)
        return record(bat, order=order, fired=fired)

    rec = both(pair, scenario)
    assert rec["fired"] == 2 and rec["order"] == [0, 1, 2]
    assert rec["shed"] == {}
    _check_isolated(pair, rec, prompts, (4, 4, 4))
    no_leak(rec)


def test_chunk_fault_retries_without_losing_state(pair):
    """serve.chunk fires before the chunk's first in-place write: the
    chunk retries at the next boundary and every output is bit-exact."""
    prompts = _prompts(19, (5, 9, 6))

    def scenario(side):
        with side.fault.scope("serve.chunk:step=2:times=2:mode=error"):
            bat = _bat(side)
            for p in prompts:
                bat.submit(p, 5)
            bat.run()
        return record(bat)

    rec = both(pair, scenario)
    assert rec["stats"]["chunk_retries"] == 2
    _check_isolated(pair, rec, prompts, (5, 5, 5))
    no_leak(rec)


def test_persistent_chunk_fault_raises_past_budget(pair):
    p = _prompts(29, (5,))[0]

    def scenario(side):
        with side.fault.scope("serve.chunk:times=*:mode=error"):
            bat = _bat(side)
            bat.submit(p, 4)
            with pytest.raises(side.fault.FaultError):
                bat.run()
        return record(bat)

    rec = both(pair, scenario)
    assert rec["stats"]["chunk_retries"] == 4     # budget 3, then raise


def test_watched_last_reported_resets_per_entry():
    """One reported hang must not leak last_reported=True into later
    entries, in particular ones made after the watchdog is disabled."""
    w = watchdog.watched("serve.chunk", timeout=0.05)
    n = len(watchdog.timeout_log)
    with w:
        time.sleep(0.6)                   # ages past the deadline
    assert w.last_reported
    assert watchdog.timeout_log[n][0] == "serve.chunk"
    w.timeout = None
    tflags.set_flags({"FLAGS_stop_check_timeout": 0})
    with w:                               # watchdog disabled
        pass
    assert not w.last_reported
    with watchdog.watched("fast", timeout=5.0) as fast:
        pass                              # the timer is cancelled
    assert not fast.last_reported
    with pytest.raises(KeyError):
        with w:
            raise KeyError("a failing body still leaves the guard")
    assert w._stack == []


def test_hung_chunk_detected_by_watchdog(pair):
    p = _prompts(20, (5,))[0]

    def scenario(side):
        side.set_flags({"FLAGS_stop_check_timeout": 0.05})
        try:
            with side.fault.scope("serve.chunk:step=1:mode=delay:secs=0.8"):
                bat = _bat(side)
                bat.submit(p, 5)
                bat.run()
        finally:
            side.set_flags({"FLAGS_stop_check_timeout": 0})
        return record(bat, hung=bat.stats()["hung_chunks"])

    n = len(watchdog.timeout_log)
    rec = both(pair, scenario)
    assert rec["hung"] == 1
    assert [t[0] for t in watchdog.timeout_log[n:]] == ["serve.chunk"]
    _check_isolated(pair, rec, [p], (5,))


# ---------------------------------------------------------------------------
# SIGTERM drain


def test_drain_sheds_queue_finishes_in_flight(pair):
    p1, p2 = _prompts(22, (5, 7))

    def scenario(side):
        bat = _bat(side, max_batch_size=1)
        bat.submit(p1, 6)
        bat.submit(p2, 6)
        bat.step()                            # r1 in flight, r2 queued
        side.guard.request_drain()
        bat.run()
        return record(bat, drained=bat.drained)

    rec = both(pair, scenario)
    assert rec["drained"] and rec["stats"]["drained"]
    assert rec["shed"] == {1: "drain"} and rec["partial"] == []
    _check_isolated(pair, rec, [p1], (6,))
    no_leak(rec)


def test_drain_closes_submissions(pair):
    p1, p2 = _prompts(23, (4, 5))

    def scenario(side):
        bat = _bat(side, max_batch_size=1)
        bat.submit(p1, 4)
        bat.step()
        side.guard.request_drain()
        bat.step()                            # the drain engages
        bat.submit(p2, 4)
        bat.run()
        return record(bat)

    rec = both(pair, scenario)
    assert rec["shed"] == {1: "drain"} and rec["outs"][1] == []
    no_leak(rec)


def test_drain_grace_expiry_flushes_partial(pair, monkeypatch):
    """Grace 0: the in-flight request is flushed as a PARTIAL result,
    counted as completed, its tokens a prefix of isolation's."""
    monkeypatch.setenv("PADDLE_DRAIN_GRACE", "0")
    p = _prompts(24, (5,))[0]

    def scenario(side):
        bat = _bat(side, Clock(tick=0.001), max_batch_size=1)
        bat.submit(p, 24)                     # needs many decode chunks
        bat.step()
        side.guard.request_drain()
        bat.run()
        return record(bat)

    rec = both(pair, scenario)
    assert rec["partial"] == [0] and rec["shed"] == {}
    out = rec["outs"][0]
    assert 0 < len(out) < 24
    assert out == isolated(pair[1], p, 24)[: len(out)]
    assert rec["stats"]["requests_completed"] == 1


def test_sigterm_sets_the_drain_flag():
    """install_sigterm_drain turns a SIGTERM into the drain flag instead
    of killing the process, and refuses off the main thread (checked in
    a fresh interpreter, whose main thread takes the signal)."""
    code = (
        "import os, signal, threading\n"
        "from paddle_tpu_torch.distributed import guard\n"
        "got = []\n"
        "t = threading.Thread(target=lambda: got.append("
        "guard.install_sigterm_drain()))\n"
        "t.start(); t.join()\n"
        "assert got == [False] and not guard.drain_requested()\n"
        "assert guard.install_sigterm_drain()\n"
        "os.kill(os.getpid(), signal.SIGTERM)\n"
        "print('DRAIN', guard.drain_requested())\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=root))
    assert res.returncode == 0, res.stderr
    assert "DRAIN True" in res.stdout, res.stdout


# ---------------------------------------------------------------------------
# flags on, mixed SLO classes; the API


def test_flags_on_slo_mix_completes(pair):
    """Robustness flags on, a mixed-SLO multi-length workload: nothing
    sheds and every output equals isolation."""
    prompts = _prompts(26, (3, 6, 9, 12, 15, 18))
    slos = ("interactive", "batch", "best_effort") * 2

    def scenario(side):
        side.set_flags({"FLAGS_serve_queue_depth": 16,
                        "FLAGS_serve_default_deadline_ms": 60000.0})
        try:
            bat = _bat(side)
            for p, slo in zip(prompts, slos):
                bat.submit(p, 4, slo=slo)
            bat.run()
        finally:
            side.set_flags({"FLAGS_serve_queue_depth": 0,
                            "FLAGS_serve_default_deadline_ms": 0.0})
        return record(bat)

    rec = both(pair, scenario)
    assert rec["stats"]["requests_shed"] == 0
    _check_isolated(pair, rec, prompts, [4] * 6)
    no_leak(rec)


def test_slo_validation_and_api(pair):
    import paddle_tpu.distributed.watchdog  # noqa: F401 (defines two)
    from paddle_tpu.framework import flags as jflags
    bat = _bat(sides(*pair)[1])
    with pytest.raises(ValueError, match="SLO"):
        bat.submit(np.ones(4, np.int32), 4, slo="platinum")
    assert SLO_CLASSES == J_SLO_CLASSES \
        == ("interactive", "batch", "best_effort")
    assert bat.queue_snapshot() == {c: 0 for c in SLO_CLASSES}
    for name in ("serve_queue_depth", "serve_default_deadline_ms",
                 "serve_spec_tokens", "serve_draft_layers",
                 "serve_retry_budget", "fault_injection",
                 "stop_check_timeout", "comm_watchdog_abort"):
        assert tflags._registry[name]["default"] \
            == jflags._registry[name]["default"], name
        assert tflags._registry[name]["help"].split()[:4] \
            == jflags._registry[name]["help"].split()[:4], name
