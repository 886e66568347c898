"""SLO-driven elastic autoscaler for the serve fleet.

The port's own copy of `paddle_tpu/fleet/autoscaler.py`: `Action`,
`AutoscalePolicy`, `PolicyState`, `observe` / `after_action` / `decide`
(:209-372), `fleet_view` (:373), `_LocalKV` (:459), `AutoscalerDaemon`
(:509-815) and `DiurnalLoadSim` (:816), decision for decision the
reference's.  It connects what the router observes (per-class
attainment, queue depth, the sliding-window shed rate) with how the
fleet changes shape losslessly (drain / undrain / add / set_role).

Three layers, each testable alone:

  * **policy** — :func:`decide(view, policy, state) -> Action` is a
    PURE function over an aggregated fleet view (:func:`fleet_view`),
    a :class:`AutoscalePolicy` and a :class:`PolicyState`.  Hysteresis
    (``window`` consecutive pressured/idle ticks before acting) and
    per-action-kind cooldowns live in the state the caller threads
    through :func:`observe` / :func:`after_action` — oscillating load
    can never flap the fleet.

  * **fencing + journal** — the :class:`AutoscalerDaemon` holds a KV
    lease (``<job>/autoscale/lease``, master-clock TTL) and claims a
    MONOTONIC EPOCH per action via ``put_new`` on
    ``<job>/autoscale/journal/<epoch>`` — the atomic put-if-absent is
    the fence: two daemons (or one restarted mid-action) can never
    double-execute an epoch.  The journal record is written ``pending``
    BEFORE execution and flipped ``done``/``rolled_back`` after; a
    daemon that crashes mid-action leaves a pending record the next
    incarnation settles in :meth:`AutoscalerDaemon.recover` — completed
    or rolled back, never repeated.

  * **execution** — actions run through the router's lossless surface
    (`drain_replica` + retire-when-empty for scale-in, undrain or
    `add_replica` for scale-out, drain → `set_role` → undrain for a role
    flip).  Every step rides a fault point of `distributed/fault.py`
    (``autoscale.decide`` / ``autoscale.drain`` /
    ``autoscale.reform``); a failed action is retried with bounded
    backoff, then ROLLED BACK: the target replica returns to rotation
    and the journal records the failure.

With ``FLAGS_autoscale`` off ``tick()`` returns on one flag read.  The
policy flags (``autoscale_queue_high`` and the rest) live in
`framework/flags.py`.  A string KV endpoint needs `distributed/launch`'s
`KVClient`, not ported yet: it raises NotImplementedError; `kv=None` runs
the same protocol over the in-process :class:`_LocalKV`.  Left out: the
reference's `autoscaler.*` telemetry events and counters.

:class:`DiurnalLoadSim` generates the deterministic load curve the
tests and the card's smoke run share.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from ..distributed import fault
from ..framework.flags import get_flag

__all__ = ["Action", "AutoscalePolicy", "PolicyState", "decide",
           "observe", "after_action", "fleet_view",
           "AutoscalerDaemon", "DiurnalLoadSim"]

# ---------------------------------------------------------------------------
# the decision — pure data in, pure data out
# ---------------------------------------------------------------------------

KINDS = ("scale_out", "scale_in", "role_flip", "none")


class Action:
    """One autoscaling decision. ``kind`` ∈ scale_out | scale_in |
    role_flip | none; ``replica`` names the target (the scale-in/flip
    victim, or the draining replica a scale-out revives — None means
    spawn fresh); ``role`` is the flip target / new-replica role;
    ``reason`` is the human-readable trigger."""

    __slots__ = ("kind", "replica", "role", "reason")

    def __init__(self, kind: str, replica: Optional[int] = None,
                 role: Optional[str] = None, reason: str = ""):
        if kind not in KINDS:
            raise ValueError(f"unknown action kind {kind!r}")
        self.kind = kind
        self.replica = replica
        self.role = role
        self.reason = reason

    def to_dict(self) -> dict:
        return {"kind": self.kind, "replica": self.replica,
                "role": self.role, "reason": self.reason}

    def __repr__(self):
        return (f"Action({self.kind}, replica={self.replica}, "
                f"role={self.role}, reason={self.reason!r})")


class AutoscalePolicy:
    """The policy knobs — constructor args win, flags fill the rest
    (so a daemon built bare follows the FLAGS_autoscale_* surface)."""

    __slots__ = ("min_replicas", "max_replicas", "queue_high",
                 "queue_low", "attainment_floor", "shed_high",
                 "window", "cooldown", "retry_budget", "backoff_s",
                 "lease_ttl_s", "target_roles", "role_imbalance")

    def __init__(self, min_replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None,
                 queue_high: Optional[float] = None,
                 queue_low: Optional[float] = None,
                 attainment_floor: Optional[float] = None,
                 shed_high: Optional[float] = None,
                 window: Optional[int] = None,
                 cooldown: Optional[int] = None,
                 retry_budget: int = 3, backoff_s: float = 0.0,
                 lease_ttl_s: Optional[float] = None,
                 target_roles: Optional[Dict[str, int]] = None,
                 role_imbalance: Optional[float] = None):
        def flag(name, fallback):
            v = get_flag(name)
            return fallback if v is None else v
        self.min_replicas = int(min_replicas if min_replicas is not None
                                else flag("autoscale_min_replicas", 1))
        self.max_replicas = int(max_replicas if max_replicas is not None
                                else flag("autoscale_max_replicas", 4))
        self.queue_high = float(queue_high if queue_high is not None
                                else flag("autoscale_queue_high", 1.5))
        self.queue_low = float(queue_low if queue_low is not None
                               else flag("autoscale_queue_low", 0.25))
        self.attainment_floor = float(
            attainment_floor if attainment_floor is not None
            else flag("router_attainment_floor", 0.0))
        self.shed_high = float(shed_high if shed_high is not None
                               else flag("autoscale_shed_high", 0.05))
        self.window = max(1, int(window if window is not None
                                 else flag("autoscale_window", 2)))
        self.cooldown = max(0, int(cooldown if cooldown is not None
                                   else flag("autoscale_cooldown", 4)))
        self.retry_budget = max(1, int(retry_budget))
        self.backoff_s = float(backoff_s)
        self.lease_ttl_s = float(
            lease_ttl_s if lease_ttl_s is not None
            else flag("autoscale_lease_ttl_s", 5.0))
        self.target_roles = dict(target_roles) if target_roles else None
        # dynamic role repair — how many times MORE pressure
        # one side of a disaggregated fleet must carry (sustained for
        # `window` ticks) before a replica of the relaxed role flips
        # over.  0 disables; only acts when the fleet actually has
        # both prefill and decode replicas
        self.role_imbalance = float(
            role_imbalance if role_imbalance is not None
            else flag("autoscale_role_imbalance", 2.0))


class PolicyState:
    """The hysteresis state threaded between ticks: consecutive
    pressured/idle streaks and per-action-kind cooldown counters
    (ticks remaining).  Mutated only by `observe`/`after_action` —
    `decide` reads it and stays pure."""

    __slots__ = ("pressure_streak", "idle_streak", "prefill_streak",
                 "decode_streak", "cooldowns")

    def __init__(self):
        self.pressure_streak = 0
        self.idle_streak = 0
        # consecutive ticks of one-sided role pressure in a
        # disaggregated fleet: prefill_streak counts ticks
        # the prefill side out-pressured decode by policy.role_imbalance
        self.prefill_streak = 0
        self.decode_streak = 0
        self.cooldowns: Dict[str, int] = {}

    def cooling(self, kind: str) -> bool:
        return self.cooldowns.get(kind, 0) > 0


def _pressured(view: dict, policy: AutoscalePolicy) -> bool:
    if float(view.get("occupancy") or 0.0) > policy.queue_high:
        return True
    if float(view.get("shed_rate_window") or 0.0) > policy.shed_high:
        return True
    att = view.get("attainment_interactive")
    if policy.attainment_floor > 0 and att is not None \
            and att < policy.attainment_floor:
        return True
    return False


def observe(state: PolicyState, view: dict,
            policy: AutoscalePolicy) -> PolicyState:
    """Fold one tick's fleet view into the hysteresis state: cooldowns
    count down, the pressure/idle streaks advance (mutually exclusive;
    a neutral tick clears both — 'consecutive' means consecutive)."""
    for k in list(state.cooldowns):
        if state.cooldowns[k] > 0:
            state.cooldowns[k] -= 1
    if _pressured(view, policy):
        state.pressure_streak += 1
        state.idle_streak = 0
    elif float(view.get("occupancy") or 0.0) < policy.queue_low:
        state.idle_streak += 1
        state.pressure_streak = 0
    else:
        state.pressure_streak = 0
        state.idle_streak = 0
    # role-imbalance streaks: only meaningful when the
    # fleet view carries BOTH sides' pressure signals (a unified
    # fleet publishes neither) and the policy enables repair
    pp = view.get("prefill_pressure")
    dp = view.get("decode_pressure")
    ratio = policy.role_imbalance
    if ratio > 0 and pp is not None and dp is not None:
        if pp > dp * ratio and pp > 0:
            state.prefill_streak += 1
            state.decode_streak = 0
        elif dp > pp * ratio and dp > 0:
            state.decode_streak += 1
            state.prefill_streak = 0
        else:
            state.prefill_streak = 0
            state.decode_streak = 0
    else:
        state.prefill_streak = 0
        state.decode_streak = 0
    return state


_OPPOSITE = {"scale_out": "scale_in", "scale_in": "scale_out"}


def after_action(state: PolicyState, action: Action,
                 policy: AutoscalePolicy) -> PolicyState:
    """Commit an EXECUTED action into the state: its kind AND its
    opposite enter cooldown (the stabilization window — a scale-in
    immediately undone by a scale-out is exactly the flap the policy
    must forbid) and both streaks reset (the fleet just changed shape —
    old evidence is stale)."""
    if action.kind != "none":
        state.cooldowns[action.kind] = policy.cooldown
        opp = _OPPOSITE.get(action.kind)
        if opp:
            state.cooldowns[opp] = policy.cooldown
        state.pressure_streak = 0
        state.idle_streak = 0
        state.prefill_streak = 0
        state.decode_streak = 0
    return state


def decide(view: dict, policy: AutoscalePolicy,
           state: Optional[PolicyState] = None) -> Action:
    """THE decision — a pure function of (fleet view, policy,
    hysteresis state); nothing here touches a router, the KV plane or
    a clock.  Priority order (first match wins):

      1. **floor repair** — routable < min_replicas: scale out NOW
         (no hysteresis, no cooldown: a fleet below its floor is an
         availability incident, not an optimization).
      2. **role repair** — `policy.target_roles` set and the routable
         role counts mismatch it: flip the least-loaded replica of an
         over-represented role (cooldown-gated).
      3. **scale-out** — pressured for >= `window` consecutive ticks,
         routable < max_replicas, not cooling.  Prefers REVIVING a
         draining replica (its device state is intact — undrain is
         free) over spawning fresh.
      4. **scale-in** — idle for >= `window` consecutive ticks,
         routable > min_replicas, not cooling.  Victim: the routable
         replica with the least work, newest id on ties (LIFO — the
         longest-lived replicas hold the warmest prefix caches).
      5. otherwise ``none``.
    """
    state = state if state is not None else PolicyState()
    reps: List[dict] = list(view.get("replicas") or [])
    routable = [r for r in reps if not r.get("draining")]
    draining = [r for r in reps if r.get("draining")]
    n = len(routable)

    if n < policy.min_replicas:
        revive = min((r["replica"] for r in draining), default=None)
        return Action("scale_out", replica=revive,
                      reason=f"floor: {n} < min {policy.min_replicas}")

    if policy.target_roles:
        have: Dict[str, int] = {}
        for r in routable:
            have[r.get("role") or "serve"] = \
                have.get(r.get("role") or "serve", 0) + 1
        want = policy.target_roles
        over = [k for k in have if have[k] > want.get(k, 0)]
        under = [k for k in want if want[k] > have.get(k, 0)]
        if over and under and not state.cooling("role_flip"):
            donors = [r for r in routable
                      if (r.get("role") or "serve") == over[0]]
            victim = min(donors, key=lambda r: (
                float(r.get("queued") or 0)
                + float(r.get("active") or 0), -int(r["replica"])))
            return Action("role_flip", replica=int(victim["replica"]),
                          role=under[0],
                          reason=f"roles: {have} -> {want}")

    if not policy.target_roles and policy.role_imbalance > 0 \
            and not state.cooling("role_flip"):
        # dynamic role repair: sustained one-sided pressure
        # in a disaggregated fleet flips the least-loaded replica of
        # the relaxed role — never below one replica per role (a fleet
        # with no prefill worker admits nothing; one with no decode
        # worker deadlocks its hand-offs into the unfreeze fallback)
        pre = [r for r in routable if r.get("role") == "prefill"]
        dec = [r for r in routable if r.get("role") == "decode"]
        if pre and dec:
            def load(r):
                return (float(r.get("queued") or 0)
                        + float(r.get("active") or 0),
                        -int(r["replica"]))
            if state.prefill_streak >= policy.window and len(dec) > 1:
                victim = min(dec, key=load)
                return Action(
                    "role_flip", replica=int(victim["replica"]),
                    role="prefill",
                    reason=f"prefill pressure x{state.prefill_streak} "
                           f"(pp={view.get('prefill_pressure')} "
                           f"dp={view.get('decode_pressure')})")
            if state.decode_streak >= policy.window and len(pre) > 1:
                victim = min(pre, key=load)
                return Action(
                    "role_flip", replica=int(victim["replica"]),
                    role="decode",
                    reason=f"decode pressure x{state.decode_streak} "
                           f"(pp={view.get('prefill_pressure')} "
                           f"dp={view.get('decode_pressure')})")

    if state.pressure_streak >= policy.window \
            and n < policy.max_replicas \
            and not state.cooling("scale_out"):
        revive = min((r["replica"] for r in draining), default=None)
        return Action("scale_out", replica=revive,
                      reason=f"pressure x{state.pressure_streak} "
                             f"(occ={view.get('occupancy')})")

    if state.idle_streak >= policy.window \
            and n > policy.min_replicas \
            and not state.cooling("scale_in"):
        victim = min(routable, key=lambda r: (
            float(r.get("queued") or 0) + float(r.get("active") or 0),
            -int(r["replica"])))
        return Action("scale_in", replica=int(victim["replica"]),
                      reason=f"idle x{state.idle_streak} "
                             f"(occ={view.get('occupancy')})")

    return Action("none", reason="steady")


def fleet_view(router) -> dict:
    """Aggregate a `ServeRouter`'s live per-replica `router_view()`s
    into THE dict `decide` consumes — occupancy over routable slots,
    the WORST interactive attainment and sliding-window shed rate
    (one failing replica is a fleet problem), per-replica summaries.
    Pure aggregation: nothing here mutates the router."""
    views = router._views()
    routable = [v for v in views if not v.get("draining")]
    slots = sum(int(v.get("slots") or 0) for v in routable)
    queued = sum(int(v.get("queued") or 0) for v in views)
    active = sum(int(v.get("active") or 0) for v in views)
    work = queued + active
    occ = round(work / slots, 4) if slots \
        else (99.0 if work else 0.0)
    atts = [(v.get("attainment") or {}).get("interactive")
            for v in routable]
    atts = [a for a in atts if a is not None]
    sheds = [float(v.get("shed_rate_window") or 0.0) for v in routable]
    reps = []
    for v in views:
        reps.append({
            "replica": int(v["replica"]),
            "role": v.get("role") or "serve",
            "draining": bool(v.get("draining")),
            "queued": int(v.get("queued") or 0),
            "active": int(v.get("active") or 0),
            "handoff_ready": int(v.get("handoff_ready") or 0),
            "attainment_interactive":
                (v.get("attainment") or {}).get("interactive"),
        })
    out = {
        "replicas": reps,
        "routable": len(routable),
        "slots": slots,
        "queued": queued,
        "active": active,
        "occupancy": occ,
        "attainment_interactive": min(atts) if atts else None,
        "shed_rate_window": round(max(sheds), 4) if sheds else 0.0,
    }
    # disaggregated split: prefill demand is queued work
    # plus live prompt chunks — a slot FROZEN for hand-off is finished
    # prefill waiting on a decode slot, so it leaves the prefill side
    # and counts toward DECODE demand (the hand-off backlog) instead
    pre = [v for v in routable if v.get("role") == "prefill"]
    dec = [v for v in routable if v.get("role") == "decode"]
    if pre and dec:
        frozen = sum(int(v.get("handoff_ready") or 0) for v in pre)
        pre_work = sum(int(v.get("queued") or 0)
                       + int(v.get("active") or 0) for v in pre) - frozen
        pre_slots = sum(int(v.get("slots") or 0) for v in pre)
        dec_work = sum(int(v.get("queued") or 0)
                       + int(v.get("active") or 0)
                       for v in dec) + frozen
        dec_slots = sum(int(v.get("slots") or 0) for v in dec)
        out.update(
            handoff_ready=frozen,
            prefill_pressure=round(pre_work / pre_slots, 4)
            if pre_slots else (99.0 if pre_work else 0.0),
            decode_pressure=round(dec_work / dec_slots, 4)
            if dec_slots else (99.0 if dec_work else 0.0),
        )
    return out


def _view_brief(view: dict) -> dict:
    """The journal-sized slice of a fleet view (before/after per
    action): enough for autoscale_report's attainment table without
    dragging per-replica records into every record."""
    out = {"routable": view.get("routable"),
           "occupancy": view.get("occupancy"),
           "queued": view.get("queued"),
           "attainment_interactive":
               view.get("attainment_interactive"),
           "shed_rate_window": view.get("shed_rate_window")}
    if view.get("prefill_pressure") is not None:
        out["prefill_pressure"] = view["prefill_pressure"]
        out["decode_pressure"] = view["decode_pressure"]
        out["handoff_ready"] = view.get("handoff_ready")
    return out


# ---------------------------------------------------------------------------
# the daemon — lease-fenced, journaled, crash-recoverable
# ---------------------------------------------------------------------------

class _LocalKV:
    """In-process stand-in for `launch.master.KVClient` (same verb
    surface: put/put_new/get/delete/prefix/stamp/time) so a single-
    process fleet runs the identical lease/journal protocol without a
    KVServer — the tests and the card's smoke run ride this."""

    def __init__(self):
        self._d: Dict[str, str] = {}
        self._lock = threading.Lock()
        self._t0 = time.monotonic()

    def time(self) -> float:
        return time.monotonic() - self._t0

    def put(self, key: str, value: str) -> bool:
        with self._lock:
            self._d[key] = str(value)
        return True

    def put_new(self, key: str, value: str) -> bool:
        with self._lock:
            if key in self._d:
                return False
            self._d[key] = str(value)
            return True

    def get(self, key: str) -> Optional[str]:
        with self._lock:
            return self._d.get(key)

    def delete(self, key: str) -> bool:
        with self._lock:
            return self._d.pop(key, None) is not None

    def prefix(self, p: str) -> Dict[str, str]:
        with self._lock:
            return {k: v for k, v in self._d.items()
                    if k.startswith(p)}

    def stamp(self, key: str) -> bool:
        return self.put(key, repr(self.time()))


class _SimulatedCrash(RuntimeError):
    """Raised between execute and journal-commit when a chaos harness
    arms `daemon._crash_before_commit` — models the daemon dying
    mid-action so the next incarnation's recover() path is exercised
    without os._exit'ing the test process."""


class AutoscalerDaemon:
    """The loop body: ``tick()`` once per poll interval (the caller
    owns the clock — tests and the bench drive it synchronously, a
    deployment wraps it in a timer thread).

    Per tick: flag gate (off -> return, zero KV traffic) -> lease ->
    recover any pending journal record (complete-or-rollback) ->
    ``autoscale.decide`` fault point -> `fleet_view` -> `observe` /
    `decide` -> claim an epoch (``put_new`` journal record, pending)
    -> execute with bounded retry -> commit (done) or roll back
    (rolled_back + target returned to rotation).

    `spawn` is the scale-out factory (-> ContinuousBatcher); without
    one a fresh-spawn scale-out fails (and rolls back) but reviving a
    draining replica still works.  `kv=None` uses an in-process
    `_LocalKV` — identical protocol, no server."""

    def __init__(self, router, kv=None, job_id: str = "serve",
                 policy: Optional[AutoscalePolicy] = None,
                 spawn: Optional[Callable] = None,
                 daemon_id: str = "d0"):
        if isinstance(kv, str):
            raise NotImplementedError(
                "a KV endpoint string needs distributed/launch's "
                "KVClient, not ported yet (ROADMAP queue 1 item 9); pass "
                "kv=None (an in-process _LocalKV) or an object with its "
                "verbs")
        self.router = router
        self.kv = kv if kv is not None else _LocalKV()
        self.job = job_id
        self.policy = policy if policy is not None else AutoscalePolicy()
        self.spawn = spawn
        self.daemon_id = daemon_id
        self.state = PolicyState()
        self._ticks = 0
        self._next_epoch = 0
        self._recovered_once = False
        self._crash_before_commit = False   # chaos harness hook

    # -- KV keys -----------------------------------------------------------
    def _lease_key(self) -> str:
        return f"{self.job}/autoscale/lease"

    def _journal_key(self, epoch: int) -> str:
        return f"{self.job}/autoscale/journal/{epoch:08d}"

    # -- lease -------------------------------------------------------------
    def _hold_lease(self) -> bool:
        """Acquire/refresh the daemon lease.  The lease is an OPTIMIZER
        (it keeps a standby daemon from burning decide cycles), not the
        fence — the per-epoch ``put_new`` is what makes double-execution
        impossible even under a split-brain lease takeover."""
        key = self._lease_key()
        now = self.kv.time() or 0.0
        mine = json.dumps({"owner": self.daemon_id,
                           "expires": now + self.policy.lease_ttl_s})
        raw = self.kv.get(key)
        if raw is None:
            if self.kv.put_new(key, mine):
                return True
            raw = self.kv.get(key)
            if raw is None:
                return False
        try:
            rec = json.loads(raw)
        except ValueError:
            rec = {}
        if rec.get("owner") == self.daemon_id:
            self.kv.put(key, mine)          # refresh
            return True
        if float(rec.get("expires") or 0.0) > now:
            return False                    # live foreign lease
        self.kv.put(key, mine)              # expired: take over
        return True

    # -- journal -----------------------------------------------------------
    def journal(self) -> List[dict]:
        """All journal records, epoch order — what autoscale_report
        renders and chaos_check audits for double-execution."""
        out = []
        for key, raw in sorted(
                self.kv.prefix(f"{self.job}/autoscale/journal").items()):
            try:
                out.append(json.loads(raw))
            except ValueError:
                continue
        return out

    def recover(self) -> int:
        """Observe any PENDING journal record a dead incarnation left
        and settle it: completed-in-the-world -> commit ``done``,
        never-happened -> roll back (target replica returned to
        rotation, ``rolled_back``).  Also advances the epoch cursor
        past every journaled epoch.  Returns the number of records
        settled — idempotent, safe on every tick."""
        settled = 0
        for rec in self.journal():
            self._next_epoch = max(self._next_epoch,
                                   int(rec.get("epoch", -1)) + 1)
            if rec.get("status") != "pending":
                continue
            kind = rec.get("kind")
            idx = rec.get("replica")
            done = False
            if kind == "scale_in":
                rep = self._rep(idx)
                done = rep is not None and (rep.draining or rep.dead)
            elif kind == "scale_out":
                done = len(self.router._reps) \
                    > int(rec.get("fleet_before") or 0) \
                    or self._revived(idx)
            elif kind == "role_flip":
                rep = self._rep(idx)
                done = rep is not None and rep.role == rec.get("role")
                if rep is not None and not rep.dead:
                    # either way the flip's drain must not linger
                    self.router.undrain_replica(idx)
            if not done and kind in ("scale_in", "role_flip") \
                    and idx is not None:
                self.router.undrain_replica(idx)
            rec = dict(rec,
                       status="done" if done else "rolled_back",
                       recovered_by=self.daemon_id)
            self.kv.put(self._journal_key(int(rec["epoch"])),
                        json.dumps(rec))
            settled += 1
        return settled

    def _rep(self, idx):
        reps = self.router._reps
        return reps[idx] if idx is not None and 0 <= idx < len(reps) \
            else None

    def _revived(self, idx) -> bool:
        rep = self._rep(idx)
        return rep is not None and not rep.dead and not rep.draining

    # -- the loop body -----------------------------------------------------
    def tick(self) -> dict:
        """One poll: returns a status dict ({"status": ..., "action":
        ..., "epoch": ...}) for the caller's introspection.  With
        FLAGS_autoscale off this is ONE flag read — no KV traffic, no
        view aggregation (off costs one flag read)."""
        if not get_flag("autoscale"):
            return {"status": "disabled"}
        self._ticks += 1
        if not self._hold_lease():
            return {"status": "no_lease"}
        self.recover()
        try:
            f = fault.hit("autoscale.decide", key=f"tick{self._ticks}")
            if f is not None and f.mode == "skip":
                raise fault.FaultError("decide skipped")
        except fault.FaultError as e:
            # a broken metrics read / poisoned decide NEVER crashes the
            # daemon: the tick degrades to a no-op and retries next poll
            return {"status": "degraded", "error": str(e)}
        view = fleet_view(self.router)
        observe(self.state, view, self.policy)
        action = decide(view, self.policy, self.state)
        if action.kind == "none":
            return {"status": "noop", "action": action.to_dict()}
        epoch = self._claim_epoch(action, view)
        if epoch is None:
            return {"status": "lost_epoch",
                    "action": action.to_dict()}
        ok, err = self._execute(action, epoch)
        if ok:
            after = fleet_view(self.router)
            self.kv.put(self._journal_key(epoch), json.dumps({
                "epoch": epoch, "tick": self._ticks,
                "owner": self.daemon_id,
                "status": "done", "kind": action.kind,
                "replica": action.replica, "role": action.role,
                "reason": action.reason,
                "fleet_before": len(self.router._reps),
                "view_before": _view_brief(view),
                "view_after": _view_brief(after)}))
            after_action(self.state, action, self.policy)
            return {"status": "executed", "epoch": epoch,
                    "action": action.to_dict()}
        self._rollback(action, epoch, view, err)
        return {"status": "rolled_back", "epoch": epoch,
                "action": action.to_dict(), "error": err}

    def _claim_epoch(self, action: Action, view: dict
                     ) -> Optional[int]:
        """Claim the next free epoch with an atomic put-if-absent of
        the PENDING journal record — the tmp half of tmp-then-commit,
        and the fence: a 409 means another incarnation owns that
        epoch, so we step past it (bounded) without ever re-writing
        its record."""
        for _ in range(64):
            epoch = self._next_epoch
            self._next_epoch += 1
            rec = {"epoch": epoch, "tick": self._ticks,
                   "owner": self.daemon_id,
                   "status": "pending", "kind": action.kind,
                   "replica": action.replica, "role": action.role,
                   "reason": action.reason,
                   "fleet_before": len(self.router._reps),
                   "view_before": _view_brief(view)}
            if self.kv.put_new(self._journal_key(epoch),
                               json.dumps(rec)):
                return epoch
        return None

    def _execute(self, action: Action, epoch: int):
        """Run one claimed action through the lossless elastic surface
        with bounded retry (`policy.retry_budget`, `backoff_s` linear
        backoff) around the fault points.  Returns (ok, error)."""
        err = None
        for attempt in range(self.policy.retry_budget):
            if attempt and self.policy.backoff_s > 0:
                time.sleep(self.policy.backoff_s * attempt)
            try:
                self._execute_once(action, epoch)
                if self._crash_before_commit:
                    raise _SimulatedCrash(
                        f"daemon died before committing epoch {epoch}")
                return True, None
            except _SimulatedCrash:
                raise
            except Exception as e:      # FaultError, spawn failure...
                err = f"{type(e).__name__}: {e}"
        return False, err

    def _execute_once(self, action: Action, epoch: int):
        key = f"epoch{epoch}:rep{action.replica}"
        if action.kind == "scale_in":
            fault.hit("autoscale.drain", key=key)
            self.router.drain_replica(action.replica)
            return
        if action.kind == "scale_out":
            fault.hit("autoscale.reform", key=key)
            if action.replica is not None \
                    and self._rep(action.replica) is not None \
                    and not self._rep(action.replica).dead:
                if not self.router.undrain_replica(action.replica):
                    raise RuntimeError(
                        f"replica {action.replica} already retired")
                return
            if self.spawn is None:
                raise RuntimeError("scale_out needs a spawn factory")
            bat = self.spawn()
            self.router.add_replica(bat, role=action.role or "serve")
            return
        if action.kind == "role_flip":
            # drain first so in-flight work never straddles the flip;
            # queued requests migrate losslessly, decodes finish here
            fault.hit("autoscale.drain", key=key)
            self.router.drain_replica(action.replica)
            fault.hit("autoscale.reform", key=key)
            self.router.set_role(action.replica, action.role)
            if not self.router.undrain_replica(action.replica):
                raise RuntimeError(
                    f"replica {action.replica} retired mid-flip")

    def _rollback(self, action: Action, epoch: int, view: dict,
                  err: Optional[str]):
        """A scale action exhausted its retries: return the target to
        rotation (undrain — the drain half may have landed on any
        attempt) and journal the failure.  The fleet is exactly as
        routable as before the action; the policy's cooldown still
        applies so a persistently failing action can't hot-loop."""
        if action.replica is not None \
                and action.kind in ("scale_in", "role_flip"):
            self.router.undrain_replica(action.replica)
        after_action(self.state, action, self.policy)
        self.kv.put(self._journal_key(epoch), json.dumps({
            "epoch": epoch, "tick": self._ticks,
            "owner": self.daemon_id,
            "status": "rolled_back", "kind": action.kind,
            "replica": action.replica, "role": action.role,
            "reason": action.reason, "error": err,
            "fleet_before": len(self.router._reps),
            "view_before": _view_brief(view)}))


# ---------------------------------------------------------------------------
# deterministic load for the tests and the smoke run
# ---------------------------------------------------------------------------

class DiurnalLoadSim:
    """A deterministic diurnal load curve: request rate follows one
    raised-cosine 'day' (`low` at the troughs, `high` at the peak)
    with per-tick prompts drawn from a tick-seeded RandomState — the
    SAME (seed, tick) always yields the same prompts in the same
    order, so chaos runs replay exactly and a fixed-fleet reference
    run sees the identical workload."""

    def __init__(self, vocab: int, seed: int = 0, period: int = 8,
                 low: int = 1, high: int = 6, prompt_len: int = 6,
                 max_new: int = 4, interactive_frac: float = 0.5):
        self.vocab = int(vocab)
        self.seed = int(seed)
        self.period = max(1, int(period))
        self.low = int(low)
        self.high = int(high)
        self.prompt_len = int(prompt_len)
        self.max_new = int(max_new)
        self.interactive_frac = float(interactive_frac)

    def rate(self, tick: int) -> int:
        phase = 2.0 * np.pi * (tick % self.period) / self.period
        r = self.low + (self.high - self.low) \
            * 0.5 * (1.0 - np.cos(phase))
        return int(round(r))

    def requests(self, tick: int) -> List[dict]:
        """The tick's request batch: [{prompt, slo, max_new}, ...] —
        reproducible from (seed, tick) alone, independent of any
        earlier call."""
        rng = np.random.RandomState(
            (self.seed * 1000003 + tick) % (2 ** 31 - 1))
        out = []
        for _ in range(self.rate(tick)):
            ids = rng.randint(0, self.vocab,
                              size=self.prompt_len).astype(np.int32)
            slo = "interactive" \
                if rng.rand() < self.interactive_frac else "batch"
            out.append({"prompt": ids, "slo": slo,
                        "max_new": self.max_new})
        return out
