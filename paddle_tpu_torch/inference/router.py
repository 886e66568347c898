"""Serve-fleet router: prefix-aware, SLO-aware routing across N
`ContinuousBatcher` replicas, with lossless drain and requeue, the
disaggregated prefill-to-decode hand-off and hot-prefix replication.

The port's own copy of `paddle_tpu/inference/router.py`: `pick_replica`
(:82), `_RouterReq`, `_Replica` and `ServeRouter` (:159-1052),
`ReplicaPublisher` and `discover_replicas` (:1059-1131), decision for
decision the reference's, so the same replicas, requests and clock give
the same routes, hand-offs, migrations and counters.  Host-plane control
flow only: the replicas' step bodies and kernels are the batcher's.

Routing policy (``pick_replica``, a pure function over per-replica
policy views):

  1. prefix affinity: every replica's `PageAllocator` trie is probed
     read-only for the longest resident prefix of the incoming prompt
     (`ContinuousBatcher.prefix_match_len`: no page pinned, no LRU
     touch); hit tokens are prefill the route would skip, weighted by
     ``FLAGS_router_prefix_weight``.  A view with no in-process probe
     but a published ``trie_digest`` is scored by
     `paged_kv.probe_digest`;
  2. load/SLO balance: the score subtracts queue depth and shed rate (in
     token units), ties break by (fewer queued, fewer active, lowest
     replica id).  An interactive request never routes to a replica
     whose interactive attainment sits below
     ``FLAGS_router_attainment_floor`` while another has headroom;
     draining and dead replicas are never picked.

Drain and requeue: on a replica kill the router harvests what finished,
then requeues the replica's queued and in-flight requests onto survivors
at their GLOBAL arrival positions, so FIFO within a class holds
fleet-wide.  Greedy decode is deterministic, so a migrated request's
re-decode is bit-exact, and a streaming request keeps its delivered
prefix: the dedup wrapper forwards only tokens past the delivered
frontier.

Disaggregated serving: with prefill and decode replicas, fresh prompts
route to prefill-capable replicas; each router step moves frozen
(hand-off-ready) slots to the least-loaded decode sink
(`export_handoff` -> `import_handoff`, in-process tensors on the
current stream), stages a hand-off no sink can take yet, and unfreezes a
slot in place when no decode sink exists.  FLAGS_router_migration_budget
pages a step copy a hot prefix to the replica traffic landed on.

Replica-per-rank mode: ``ReplicaPublisher`` PUTs a replica's
``router_view()`` under ``<job>/serve/<replica>/latest`` (+ a heartbeat
stamp, + a tombstone when retired) on any object with the launch KV
plane's verbs (`put`, `stamp`, `prefix`; the autoscaler's in-process
`_LocalKV` is one), and ``discover_replicas`` reads them back.  A string
endpoint needs `distributed/launch`'s `KVClient`, which the port does
not have yet: it raises NotImplementedError.

Left out of the port so far: the reference's `router.*` telemetry events
and counters (`stats()` holds the same aggregates).
"""
from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from ..framework.flags import get_flag
from .serving import SLO_CLASSES, ContinuousBatcher, _percentiles

__all__ = ["ServeRouter", "pick_replica", "ReplicaPublisher",
           "discover_replicas"]


def _summary_of(values, qs=(50, 90, 99)) -> Dict[str, float]:
    """Count, true min and max, and nearest-rank percentiles over a
    window (the reference's `telemetry.summary_of`,
    `paddle_tpu/telemetry/registry.py:71`; it moves to the port's
    telemetry package when that is ported)."""
    vals = [float(v) for v in values]
    out = {"count": len(vals),
           "min": min(vals) if vals else 0.0,
           "max": max(vals) if vals else 0.0}
    out.update(_percentiles(vals, qs))
    return out


def _kv_plane(kv):
    """A KV object as given; a string endpoint would need the launch
    plane's KVClient."""
    if isinstance(kv, str):
        raise NotImplementedError(
            "a KV endpoint string needs distributed/launch's KVClient, "
            "not ported yet (ROADMAP queue 1 item 9); pass an object "
            "with put/put_new/get/delete/prefix/stamp/time, such as "
            "fleet.autoscaler._LocalKV")
    return kv

#: load penalty per queued request, in prefix-hit-token units — one
#: queued request costs the route as much as ~a page of skipped
#: prefill buys it (policy scale, overridable per call)
QUEUE_COST_TOKENS = 16.0


# ---------------------------------------------------------------------------
# the policy — a pure function over per-replica views
# ---------------------------------------------------------------------------

def pick_replica(views: List[dict], slo: str = "batch",
                 prefix_weight: Optional[float] = None,
                 attainment_floor: Optional[float] = None,
                 queue_cost: float = QUEUE_COST_TOKENS,
                 prompt=None) -> Optional[int]:
    """Choose one replica for a request of class `slo` from per-replica
    policy views (`ContinuousBatcher.router_view()` dicts, or the same
    records read back off the KV plane) — returns the chosen view's
    ``replica`` id, or None when nothing is routable (every replica
    draining/dead).

    Two-tier, deterministic:

      1. draining/dead replicas are dropped;
      2. interactive traffic drops replicas whose interactive
         attainment sits below the floor WHILE another candidate has
         headroom (at/above it, or no attainment signal yet); if every
         candidate is below the floor the tier is waived — degraded
         service beats no service;
      3. score = prefix_weight * prefix_hit_tokens
                 - queue_cost * queued  - queue_cost * shed_rate,
         ties broken by (fewer queued, fewer active, lowest replica
         id) — byte-for-byte reproducible for a given view list.

    The shed penalty reads the SLIDING-WINDOW rate
    (``shed_rate_window``) when the view carries
    one — current pressure, not lifetime history — and falls back to
    the cumulative ``shed_rate`` for older/synthetic views.

    Cross-replica prefix scores: with `prompt`, a view
    that carries no in-process ``prefix_hit_tokens`` but publishes a
    ``trie_digest`` (replica-per-rank mode over the KV plane) is
    scored by `paged_kv.probe_digest` — the advisory hash-chain
    estimate of the prompt's resident depth on that replica.
    """
    if prefix_weight is None:
        prefix_weight = float(get_flag("router_prefix_weight") or 0.0)
    if attainment_floor is None:
        attainment_floor = float(
            get_flag("router_attainment_floor") or 0.0)
    cands = [v for v in views
             if not v.get("draining") and not v.get("dead")]
    if not cands:
        return None
    if slo == "interactive" and attainment_floor > 0:
        def headroom(v):
            att = (v.get("attainment") or {}).get("interactive")
            return att is None or att >= attainment_floor
        floored = [v for v in cands if headroom(v)]
        if floored:
            cands = floored

    def hits(v):
        got = v.get("prefix_hit_tokens")
        if got is None and prompt is not None and v.get("trie_digest"):
            from .paged_kv import probe_digest
            got = probe_digest(v["trie_digest"], prompt,
                               int(v.get("page_size") or 16))
        return float(got or 0)

    def rank(v):
        shed = v.get("shed_rate_window")
        if shed is None:
            shed = v.get("shed_rate") or 0.0
        score = (prefix_weight * hits(v)
                 - queue_cost * float(v.get("queued") or 0)
                 - queue_cost * float(shed))
        return (score, -float(v.get("queued") or 0),
                -float(v.get("active") or 0),
                -int(v.get("replica", 0)))
    return int(max(cands, key=rank)["replica"])


# ---------------------------------------------------------------------------
# router bookkeeping
# ---------------------------------------------------------------------------

class _RouterReq:
    """The router's own record of one global request — everything a
    migration needs to re-place it losslessly: the prompt, the GLOBAL
    arrival number (FIFO across the fleet), the absolute deadline, and
    the streaming dedup state (`delivered` is authoritative across
    incarnations; `seen` counts the CURRENT incarnation's replay)."""
    __slots__ = ("gid", "prompt", "max_new", "slo", "deadline",
                 "arrival", "on_token", "delivered", "seen",
                 "incarnation", "replica", "local_id", "requeues",
                 "done", "shed", "shed_reason")

    def __init__(self, gid, prompt, max_new, slo, deadline, arrival,
                 on_token):
        self.gid = gid
        self.prompt = prompt
        self.max_new = max_new
        self.slo = slo
        self.deadline = deadline        # absolute monotonic, or None
        self.arrival = arrival
        self.on_token = on_token
        self.delivered: List[int] = []  # tokens the consumer HOLDS
        self.seen = 0                   # replay cursor, this incarnation
        self.incarnation = 0
        self.replica: Optional[int] = None
        self.local_id: Optional[int] = None
        self.requeues = 0
        self.done = False
        self.shed = False
        self.shed_reason: Optional[str] = None


class _Replica:
    """One in-process replica handle: the batcher plus the router's
    local-id <-> global-id mapping, the replica's ROLE (host-plane
    metadata the autoscaler flips: "serve", or the disaggregated
    "prefill"/"decode" split) and per-replica route counters."""
    __slots__ = ("idx", "bat", "dead", "draining", "role", "local2g",
                 "routed", "requeued_in")

    def __init__(self, idx, bat, role: str = "serve"):
        self.idx = idx
        self.bat = bat
        self.dead = False
        self.draining = False
        self.role = role
        self.local2g: Dict[int, int] = {}
        self.routed = 0
        self.requeued_in = 0


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------

class ServeRouter:
    """Front N `ContinuousBatcher` replicas with one submit/run API.

    Construction: either pass pre-built ``batchers=[...]`` (replicas
    may differ in geometry/KV precision) or a `model` plus `replicas=N`
    and batcher kwargs — N batchers are built over the shared model, so
    replicas share the weights and each keeps its own KV pool.  Batcher
    kwargs include ``device`` (None: CUDA, raising without one).
    ``replicas=None`` reads ``FLAGS_serve_replicas`` (0 -> 2).

    kv/job_id: optional KV plane (an object with the launch plane's
    verbs; a string endpoint raises until `KVClient` is ported) — every
    router step publishes each live replica's `router_view()` under
    ``<job_id>/serve/<replica>/latest`` so coordinators discover the
    fleet with `discover_replicas` and replay `pick_replica` offline.

    The router is single-threaded over its replicas (one scheduling
    round steps each replica that has work); submit() may race run()
    from another thread — the batcher's queue lock keeps the structure
    consistent.
    """

    def __init__(self, model=None, replicas: Optional[int] = None,
                 batchers: Optional[List[ContinuousBatcher]] = None,
                 kv=None, job_id: str = "serve",
                 roles: Optional[List[str]] = None, **batcher_kw):
        if batchers is None:
            if model is None:
                raise ValueError("ServeRouter needs a model (plus "
                                 "replicas=N) or explicit batchers=")
            n = int(replicas if replicas is not None
                    else get_flag("serve_replicas") or 0) or 2
            if roles is None and get_flag("serve_disagg", False):
                # FLAGS_serve_disagg default split: half the
                # fleet prefills, half decodes — decode gets the odd
                # replica (a decode round emits chunk tokens a slot
                # against an admission round's admit_steps, so decode
                # capacity is the scarcer resource on mixed workloads)
                n_pre = max(1, n // 2)
                roles = ["prefill"] * n_pre + ["decode"] * (n - n_pre) \
                    if n >= 2 else ["serve"]
            batchers = [ContinuousBatcher(
                model, role=self._bat_role(roles[i])
                if roles else "unified", **batcher_kw)
                for i in range(n)]
        elif batcher_kw or model is not None or replicas is not None:
            raise ValueError("pass model/replicas/batcher kwargs OR "
                             "batchers=, not both")
        if not batchers:
            raise ValueError("ServeRouter needs >= 1 replica")
        if roles is not None and len(roles) != len(batchers):
            raise ValueError(f"roles= has {len(roles)} entries for "
                             f"{len(batchers)} replicas")
        self._reps = []
        for i, b in enumerate(batchers):
            role = roles[i] if roles else (
                b.role if b.role != "unified" else "serve")
            if b.role != self._bat_role(role):
                b.set_role(self._bat_role(role))
            self._reps.append(_Replica(i, b, role=role))
        self._reqs: Dict[int, _RouterReq] = {}
        self._results: Dict[int, np.ndarray] = {}
        self._next_gid = 0
        self._arrival = 0
        self._completed = 0
        self._shed_count = 0
        self._requeued = 0
        self._rebalanced = 0
        self._kills = 0
        self._prefix_routed = 0
        self._routes = 0
        self._decision_ms: deque = deque(maxlen=4096)
        self._handoffs = 0
        self._handoff_bytes = 0
        self._handoff_ms: deque = deque(maxlen=4096)
        # hand-offs whose import failed (sink raced out of slots/
        # pages): the exported blob outlives even its source replica,
        # retried every sweep until a sink takes it
        self._handoff_staged: deque = deque()
        self._replicate_q: deque = deque()
        self._replicated_pages = 0
        self._last_rebalance = time.monotonic()
        self._draining = False
        self._kv = kv
        self._job = job_id
        self._pubs: List[Optional["ReplicaPublisher"]] = []
        if kv is not None:
            self._pubs = [ReplicaPublisher(kv, job_id=job_id,
                                           replica=r.idx)
                          for r in self._reps]

    # -- introspection -----------------------------------------------------
    @property
    def replicas(self) -> int:
        return len(self._reps)

    @property
    def live_replicas(self) -> int:
        return sum(not r.dead for r in self._reps)

    @property
    def drained(self) -> bool:
        """True once the process-level SIGTERM drain reached the
        fleet — same caller cue as `ContinuousBatcher.drained`."""
        return self._draining

    def _live(self) -> List[_Replica]:
        return [r for r in self._reps if not r.dead]

    @staticmethod
    def _bat_role(role: str) -> str:
        """Router role label -> batcher role knob ("serve" is the
        router's historical name for a unified replica)."""
        return role if role in ("prefill", "decode") else "unified"

    def _disagg_active(self) -> bool:
        return any(r.role in ("prefill", "decode")
                   for r in self._reps if not r.dead)

    def _views(self, prompt=None, exclude: Optional[int] = None,
               admission: bool = False) -> List[dict]:
        # prefix affinity off (weight 0) -> the hit count is
        # multiplied by zero anyway; skip the O(replicas x prompt)
        # trie probes on the routing hot path entirely
        if prompt is not None \
                and not float(get_flag("router_prefix_weight") or 0.0):
            prompt = None
        views = []
        for rep in self._reps:
            if rep.dead or rep.idx == exclude:
                continue
            v = rep.bat.router_view(prompt)
            v["replica"] = rep.idx
            v["role"] = rep.role
            if rep.draining:
                v["draining"] = True
            views.append(v)
        if admission and self._disagg_active():
            # fresh prompts start with a prefill: route them to
            # prefill-capable replicas only — decode replicas receive
            # work through the hand-off plane.  Degraded-fleet
            # fallback: with no prefill-capable replica left, a
            # decode-role replica still admits (its step body runs
            # both phases; the role only governs the freeze-at-prompt-end
            # behaviour), which beats shedding
            adm = [v for v in views if v["role"] != "decode"]
            if adm:
                views = adm
        return views

    # -- submission --------------------------------------------------------
    def submit(self, input_ids, max_new_tokens: int = 32,
               slo: str = "batch",
               deadline_ms: Optional[float] = None,
               on_token=None) -> int:
        """Route one request to a replica; returns its GLOBAL id (the
        key of run()'s results).  Same contract as the batcher's
        submit — SLO classes, deadlines (resolved to an absolute
        deadline HERE so a migration never restarts the clock),
        streaming on_token(gid, tokens, done) — plus the routing
        decision: prefix affinity first, load/SLO balance second."""
        ids = np.asarray(input_ids, np.int32).reshape(-1)
        if deadline_ms is None:
            deadline_ms = float(get_flag("serve_default_deadline_ms")
                                or 0.0)
        deadline = (time.monotonic() + float(deadline_ms) / 1e3) \
            if deadline_ms and deadline_ms > 0 else None
        gid = self._next_gid
        self._next_gid += 1
        rr = _RouterReq(gid, ids, int(max_new_tokens), slo, deadline,
                        self._arrival, on_token)
        self._arrival += 1
        self._reqs[gid] = rr
        t0 = time.perf_counter()
        views = self._views(ids, admission=True)
        idx = pick_replica(views, slo=slo)
        dt_ms = (time.perf_counter() - t0) * 1e3
        self._decision_ms.append(dt_ms)
        if idx is None:
            # nothing routable (whole fleet draining): terminal no-
            # service, accounted like a batcher-side drain shed — the
            # no-leak contract holds fleet-wide
            self._shed_router(rr, "drain")
            return gid
        chosen = next(v for v in views if v["replica"] == idx)
        hit = int(chosen.get("prefix_hit_tokens") or 0)
        self._routes += 1
        if hit > 0:
            self._prefix_routed += 1
        if int(get_flag("router_migration_budget") or 0) > 0:
            # cache PLACEMENT: when another replica holds a
            # longer resident prefix than where load/SLO pressure sent
            # this request, queue a bounded background copy of that
            # prefix TO the chosen replica — traffic pulls hot
            # prefixes to where it lands instead of chasing them
            best = max(views, key=lambda v: float(
                v.get("prefix_hit_tokens") or 0.0))
            bh = int(best.get("prefix_hit_tokens") or 0)
            if best["replica"] != idx and bh > hit and bh > 0:
                self._replicate_q.append(
                    (ids, int(best["replica"]), idx))
        rep = self._reps[idx]
        rep.routed += 1
        self._place(rr, rep)
        return gid

    def _shed_router(self, rr: _RouterReq, reason: str):
        rr.done = True
        rr.shed = True
        rr.shed_reason = reason
        self._results[rr.gid] = np.asarray(rr.delivered, np.int32)
        self._shed_count += 1
        if rr.on_token is not None:
            try:
                rr.on_token(rr.gid, [], True)
            except Exception:
                pass        # a broken consumer must not poison the fleet

    def _make_cb(self, rr: _RouterReq, incarnation: int):
        """Streaming dedup wrapper for one PLACEMENT of a request: the
        replica replays the request's whole output stream (a migrated
        request re-decodes from scratch, bit-exactly), and only tokens
        past the globally-delivered frontier are forwarded — the
        consumer never sees a duplicate across requeues.  A stale
        incarnation (a replica flushing after its request migrated)
        is ignored outright."""
        def cb(_local_id, burst, done):
            if rr.incarnation != incarnation:
                return
            new = []
            for t in burst:
                rr.seen += 1
                if rr.seen > len(rr.delivered):
                    rr.delivered.append(int(t))
                    new.append(int(t))
            if not new and not done:
                return
            rr.on_token(rr.gid, new, done)
        return cb

    def _place(self, rr: _RouterReq, rep: _Replica):
        """Submit `rr` to `rep` and rewrite the created Request to the
        router's GLOBAL coordinates: arrival number (re-sorted to its
        arrival position — fleet-wide FIFO within a class survives
        migrations) and the ABSOLUTE deadline (a migrated request's
        clock never restarts)."""
        if rep.dead or rep.draining:
            # the routing decision raced a drain/kill of its chosen
            # replica (drain_replica landing
            # between pick_replica and the enqueue): re-pick among the
            # survivors instead of parking the request on a replica
            # that stopped accepting routes — it lands on a survivor
            # or sheds only when the WHOLE fleet is draining, exactly
            # the submit-path contract
            views = self._views(rr.prompt, exclude=rep.idx,
                                admission=True)
            idx = pick_replica(views, slo=rr.slo)
            if idx is None:
                self._shed_router(rr, "drain")
                return
            rep = self._reps[idx]
        bat = rep.bat
        cb = None
        if rr.on_token is not None:
            cb = self._make_cb(rr, rr.incarnation)
        # ONE critical section for the enqueue AND the global-arrival/
        # absolute-deadline rewrite (the queue lock is reentrant, so
        # submit's own acquisition nests): a run() thread's admit()
        # must never pop the request in between — it would keep its
        # batcher-local arrival (fleet FIFO broken) and a freshly
        # restarted deadline clock
        with bat._qlock:
            lid = bat.submit(rr.prompt, rr.max_new, slo=rr.slo,
                             deadline_ms=None, on_token=cb)
            rep.local2g[lid] = rr.gid
            rr.replica, rr.local_id = rep.idx, lid
            rr.seen = 0
            q = bat._queues[rr.slo]
            req = next((r for r in q if r.req_id == lid), None)
            if req is not None:
                q.remove(req)
                req.arrival = rr.arrival
                req.deadline = rr.deadline
                if rr.deadline is not None:
                    bat._has_deadlines = True
                i = 0
                while i < len(q) and q[i].arrival <= rr.arrival:
                    i += 1
                q.insert(i, req)
        # shed on arrival (replica-side bounded queue / drain): the
        # terminal state is harvested like any other finish

    # -- scheduling --------------------------------------------------------
    def _harvest(self, rep: _Replica) -> List[int]:
        """Collect `rep`'s newly-terminal requests into the router's
        results (completed and shed both — the no-leak contract)."""
        out = []
        for lid, gid in list(rep.local2g.items()):
            req = rep.bat._finished.get(lid)
            if req is None:
                continue
            rr = self._reqs[gid]
            rr.done = True
            self._results[gid] = req.output()
            if req.shed:
                rr.shed, rr.shed_reason = True, req.shed_reason
                self._shed_count += 1
            else:
                self._completed += 1
            del rep.local2g[lid]
            out.append(gid)
        return out

    # -- the hand-off plane (disaggregated prefill -> decode) --------------
    def _handoff_import(self, meta, data, rr: _RouterReq,
                        sinks: List[_Replica], frm: int,
                        t0: Optional[float] = None) -> bool:
        """Land one exported hand-off on the least-loaded decode-
        capable sink.  The incarnation bump BEFORE the import means
        the decode side's full-stream replay (req.tokens re-seeded
        with the already-emitted prefix) dedups against the delivered
        frontier — the consumer never sees a duplicate token across
        the hand-off.  False when every sink refused (no free slot /
        pool pressure): the caller stages the blob for the next
        sweep."""
        for sink in sorted(sinks, key=lambda s: (s.bat.active, s.idx)):
            rr.incarnation += 1
            rr.seen = 0
            cb = None
            if rr.on_token is not None:
                cb = self._make_cb(rr, rr.incarnation)
            lid = sink.bat.import_handoff(meta, data, on_token=cb)
            if lid is None:
                continue
            sink.local2g[lid] = rr.gid
            rr.replica, rr.local_id = sink.idx, lid
            ms = (time.perf_counter() - t0) * 1e3 if t0 else 0.0
            self._handoffs += 1
            self._handoff_bytes += int(meta.get("nbytes") or 0)
            self._handoff_ms.append(ms)
            return True
        return False

    def _handoff_sweep(self):
        """Move finished-prefill requests off their prefill replicas:
        each frozen (hand-off-ready) slot exports its prompt KV pages
        and re-admits on a decode-capable sink at pos=prompt_len —
        zero prefill recomputed.  Exports happen only when some sink
        has a free slot (otherwise the request stays frozen, its pages
        pinned on the source, and retries next sweep); an import that
        still fails (lost the slot race) is staged host-side and
        survives even the source replica dying.  With NO decode-
        capable replica in the fleet the frozen slot unfreezes and
        decodes in place — degraded, never deadlocked."""
        srcs = [r for r in self._live() if r.bat._handoff_ready]
        if not srcs and not self._handoff_staged:
            return
        sinks = [r for r in self._live()
                 if not r.draining and r.role != "prefill"
                 and r.bat.role != "prefill"
                 and r.bat.kv_layout == "paged"]
        if self._handoff_staged:
            if sinks:
                for _ in range(len(self._handoff_staged)):
                    meta, data, rr = self._handoff_staged.popleft()
                    if rr.done:
                        continue
                    if not self._handoff_import(meta, data, rr, sinks,
                                                frm=-1):
                        self._handoff_staged.append((meta, data, rr))
            elif not any(r.bat.kv_layout == "paged"
                         and r.bat.role != "prefill"
                         for r in self._live()):
                # a staged blob has no source slot left to unfreeze;
                # with no import-capable replica even in the pipeline
                # (draining ones will retire, not recover) the request
                # is terminally unplaceable — shed it like a whole-
                # fleet drain, delivered prefix preserved
                while self._handoff_staged:
                    meta, data, rr = self._handoff_staged.popleft()
                    if not rr.done:
                        self._shed_router(rr, "drain")
        for src in srcs:
            for rid in list(src.bat._handoff_ready):
                gid = src.local2g.get(rid)
                if gid is None:
                    # not router-managed (submitted straight to the
                    # batcher): its owner drives the hand-off
                    continue
                if not sinks:
                    src.bat.unfreeze_handoff(rid)
                    continue
                free = any(s.bat.active - (1 if s is src else 0)
                           < s.bat.B for s in sinks)
                if not free:
                    break
                rr = self._reqs[gid]
                t0 = time.perf_counter()
                meta, data = src.bat.export_handoff(rid)
                del src.local2g[rid]
                if not self._handoff_import(meta, data, rr, sinks,
                                            frm=src.idx, t0=t0):
                    self._handoff_staged.append((meta, data, rr))

    def _maybe_replicate(self):
        """FLAGS_router_migration_budget pages per sweep of hot-prefix
        placement: pop queued (prompt, holder, target) intents, export
        the resident chain on the holder and graft it on the target.
        Best-effort end to end — a dead replica, an evicted chain or
        target pool pressure just drops the intent (the next routed
        request re-queues it); the budget caps device-copy bytes per
        round so placement never starves serving."""
        budget = int(get_flag("router_migration_budget") or 0)
        if budget <= 0:
            self._replicate_q.clear()
            return
        pages = 0
        rounds = len(self._replicate_q)
        while self._replicate_q and pages < budget and rounds > 0:
            rounds -= 1
            prompt, frm, to = self._replicate_q.popleft()
            src, dst = self._reps[frm], self._reps[to]
            if src.dead or dst.dead:
                continue
            got = src.bat.export_prefix(prompt)
            if not got:
                continue
            n_tokens, data = got
            n = dst.bat.import_prefix(prompt, n_tokens, data)
            if n <= 0:
                continue
            pages += n
            self._replicated_pages += n

    def step(self) -> List[int]:
        """One scheduling round across the fleet: every live replica
        with work runs one batcher round; newly-terminal global ids
        are returned.  A replica whose own drain protocol engaged
        (process-level SIGTERM) marks the router drained; a
        gracefully-draining replica with nothing left is retired
        (frozen hand-off-ready slots count as active, so a draining
        prefill replica exports them before retiring)."""
        finished: List[int] = []
        # placement BEFORE the batcher round: a prefix replicated now
        # is shared by this very round's admissions (grafting after
        # the admit would lose the race to the admit's own trie
        # registration and no-op)
        self._maybe_replicate()
        for rep in self._live():
            bat = rep.bat
            if bat.queued or bat.active:
                bat.step()
            finished += self._harvest(rep)
            if bat.drained:
                self._draining = True
            if rep.draining and not bat.queued and not bat.active:
                rep.dead = True
                self._retire_pub(rep)
        self._handoff_sweep()
        self._maybe_rebalance()
        self._publish()
        return finished

    def run(self) -> Dict[int, np.ndarray]:
        """Drive the fleet until every replica's queue and slots drain;
        returns {gid: tokens} for EVERY submitted request (shed ones
        included — empty or partial outputs), exactly the batcher's
        run() contract lifted fleet-wide.  Staged hand-offs count as
        live work: their requests occupy no slot anywhere until a sink
        admits them."""
        while any(r.bat.queued or r.bat.active
                  for r in self._live()) or self._handoff_staged:
            self.step()
        for rep in self._live():
            self._harvest(rep)
        return dict(self._results)

    # -- drain-and-requeue (the batcher's contract, fleet-wide) ---------
    def kill_replica(self, idx: int, reason: str = "kill") -> int:
        """Replica `idx` died (SIGTERM'd subprocess, poisoned host):
        harvest what it finished, collect its queued AND non-terminal
        in-flight requests, retire it, and requeue the collected
        requests onto survivors at their ARRIVAL POSITIONS.  Greedy
        re-decode is bit-exact, and streaming requests keep their
        delivered prefix (the dedup wrapper never re-sends it).
        Returns the number of migrated requests."""
        rep = self._reps[idx]
        if rep.dead:
            return 0
        self._harvest(rep)
        bat = rep.bat
        pending = []
        with bat._qlock:
            for cls in SLO_CLASSES:
                q = bat._queues[cls]
                while q:
                    pending.append(q.popleft())
            for i, req in enumerate(bat._slots):
                if req is not None:
                    pending.append(req)
                    bat._slots[i] = None    # host detach only: the
                    #                         replica is dead, its
                    #                         device state unreachable
            # frozen hand-off-ready slots are swept with the rest
            # (their requests migrate for a full re-prefill, which is
            # bit-exact); the ready-map must not dangle
            bat._handoff_ready.clear()
        rep.dead = True
        self._kills += 1
        migs = []
        for req in pending:
            gid = rep.local2g.pop(req.req_id, None)
            if gid is not None:
                migs.append(self._reqs[gid])
            else:
                # not router-managed (submitted straight to the
                # batcher): the router cannot re-place it, but it must
                # not vanish — shed it through the batcher so ITS
                # no-leak accounting (and any direct caller's run())
                # stays whole
                bat._shed(req, "drain")
        migs.sort(key=lambda r: r.arrival)
        self._retire_pub(rep)
        for rr in migs:
            self._migrate(rr, frm=idx)
        return len(migs)

    def drain_replica(self, idx: int) -> int:
        """Graceful replica drain (the planned-maintenance half):
        queued requests migrate to survivors NOW, in-flight decodes
        finish on the replica (it stops receiving routes), and the
        replica retires once empty — nothing is lost, nothing
        re-decoded.  Returns the number of migrated requests."""
        rep = self._reps[idx]
        if rep.dead or rep.draining:
            return 0
        rep.draining = True
        bat = rep.bat
        pending = []
        with bat._qlock:
            for cls in SLO_CLASSES:
                q = bat._queues[cls]
                while q:
                    pending.append(q.popleft())
        migs = []
        unmapped = []
        for req in pending:
            gid = rep.local2g.pop(req.req_id, None)
            if gid is not None:
                migs.append(self._reqs[gid])
            else:
                unmapped.append(req)
        if unmapped:
            # not router-managed: leave them queued on the draining
            # replica — it keeps stepping until empty, so they finish
            # there (unlike a kill, nothing is lost by waiting)
            with bat._qlock:
                for req in unmapped:
                    q = bat._queues[req.slo]
                    i = 0
                    while i < len(q) and q[i].arrival < req.arrival:
                        i += 1
                    q.insert(i, req)
        migs.sort(key=lambda r: r.arrival)
        for rr in migs:
            self._migrate(rr, frm=idx)
        return len(migs)

    def undrain_replica(self, idx: int) -> bool:
        """Return a DRAINING replica to rotation (the autoscaler's
        rollback half): routes flow to it again and it no
        longer retires when empty.  Requests already migrated off it
        stay where they landed (re-migrating them back would re-decode
        for nothing).  False when the replica already retired — a
        retired replica's device state is gone, only add_replica can
        re-grow the fleet."""
        rep = self._reps[idx]
        if rep.dead:
            return False
        if rep.draining:
            rep.draining = False
        return True

    def add_replica(self, bat: ContinuousBatcher,
                    role: str = "serve") -> int:
        """Grow the fleet by one live replica (the autoscaler's
        scale-out half): `bat` joins the rotation at the next
        routing decision under a fresh replica id.  With a KV plane attached the new replica publishes under the
        same ``<job>/serve/<idx>`` schema.  Returns the replica id."""
        idx = len(self._reps)
        rep = _Replica(idx, bat, role=role)
        if bat.role != self._bat_role(role) \
                and (self._bat_role(role) == "unified"
                     or bat.kv_layout == "paged"):
            bat.set_role(self._bat_role(role))
        self._reps.append(rep)
        if self._kv is not None:
            self._pubs.append(ReplicaPublisher(self._kv,
                                               job_id=self._job,
                                               replica=idx))
        elif self._pubs:
            self._pubs.append(None)
        return idx

    def set_role(self, idx: int, role: str) -> str:
        """Flip replica `idx`'s role — routing metadata AND the
        batcher's own role knob (host-plane only —
        the autoscaler drains before flipping so in-flight work never
        straddles a role change, and a slot already frozen for
        hand-off still leaves via the hand-off sweep).  Returns the
        previous role."""
        rep = self._reps[idx]
        prev, rep.role = rep.role, role
        want = self._bat_role(role)
        if rep.bat.role != want \
                and (want == "unified"
                     or rep.bat.kv_layout == "paged"):
            rep.bat.set_role(want)
        return prev

    def _retire_pub(self, rep: _Replica):
        """Tombstone a RETIRED replica's KV presence: its stale published view must never read as a live
        straggling replica to discover_replicas or a fleet
        aggregator."""
        if rep.idx < len(self._pubs) and self._pubs[rep.idx] is not None:
            self._pubs[rep.idx].retire()

    def _migrate(self, rr: _RouterReq, frm: int):
        rr.requeues += 1
        rr.incarnation += 1         # invalidates the old placement's
        rr.seen = 0                 # streaming wrapper
        views = self._views(rr.prompt, exclude=frm, admission=True)
        idx = pick_replica(views, slo=rr.slo)
        if idx is None:
            self._shed_router(rr, "drain")
            return
        rep = self._reps[idx]
        rep.requeued_in += 1
        self._requeued += 1
        self._place(rr, rep)

    # -- periodic rebalance ------------------------------------------------
    def _pop_newest_queued(self, rep: _Replica) -> Optional[_RouterReq]:
        """Detach `rep`'s lowest-SLO newest-arrival QUEUED request (the
        one that would wait longest — the shed-victim rank, reused for
        the opposite purpose: it migrates instead of dying)."""
        order = {c: i for i, c in enumerate(SLO_CLASSES)}
        bat = rep.bat
        with bat._qlock:
            victim = None
            for cls in SLO_CLASSES:
                for r in bat._queues[cls]:
                    # only router-managed requests are movable — one
                    # submitted straight to the batcher has no global
                    # record and must stay where its caller put it
                    if r.req_id not in rep.local2g:
                        continue
                    if victim is None or (order[r.slo], r.arrival) \
                            > (order[victim.slo], victim.arrival):
                        victim = r
            if victim is None:
                return None
            bat._queues[victim.slo].remove(victim)
        return self._reqs[rep.local2g.pop(victim.req_id)]

    def _maybe_rebalance(self):
        """FLAGS_router_rebalance_ms sweep: while some replica has
        queued work and another sits idle with a free slot, migrate
        the overloaded replica's newest queued request — lossless
        (only never-started requests move; their streaming state is
        empty) and bounded per sweep."""
        ms = float(get_flag("router_rebalance_ms") or 0.0)
        if ms <= 0:
            return
        now = time.monotonic()
        if (now - self._last_rebalance) * 1e3 < ms:
            return
        self._last_rebalance = now
        moved = 0
        while moved < 64:
            live = [r for r in self._live()
                    if not r.draining and not r.bat.drained]
            donors = [r for r in live if r.bat.queued > 0]
            takers = [r for r in live if r.bat.queued == 0
                      and r.bat.active < r.bat.B]
            if not donors or not takers:
                break
            donor = max(donors, key=lambda r: (r.bat.queued, -r.idx))
            taker = min(takers, key=lambda r: (r.bat.active, r.idx))
            if donor is taker:
                break
            rr = self._pop_newest_queued(donor)
            if rr is None:
                break
            rr.incarnation += 1
            rr.seen = 0
            taker.requeued_in += 1
            self._place(rr, taker)
            moved += 1
        if moved:
            self._rebalanced += moved

    # -- KV-plane publication ----------------------------------------------
    def _publish(self):
        if not self._pubs:
            return
        for rep, pub in zip(self._reps, self._pubs):
            if rep.dead or pub is None:
                continue
            v = rep.bat.router_view(digest=True)
            v["role"] = rep.role
            pub.publish(v)

    # -- stats -------------------------------------------------------------
    def stats(self) -> Dict[str, object]:
        """Fleet-level counters: the no-leak partition
        (submitted == completed + shed), routing/requeue accounting
        per replica, the prefix-route hit rate (fraction of routes
        whose chosen replica held a resident prefix) and the routing
        decision-time percentiles — what the `llama_serve_fleet`
        bench consumes."""
        per = []
        for rep in self._reps:
            rec: Dict[str, object] = {
                "replica": rep.idx, "dead": rep.dead,
                "routed": rep.routed, "requeued_in": rep.requeued_in}
            if not rep.dead:
                rec.update(rep.bat.router_view())
            rec["role"] = rep.role
            if rep.draining:        # router-level drain wins over the
                rec["draining"] = True  # batcher's own SIGTERM flag
            per.append(rec)
        dec = _summary_of(list(self._decision_ms))
        hand = _summary_of(list(self._handoff_ms))
        cross = 0
        lat: Dict[str, list] = {}
        for rep in self._reps:
            if rep.dead:
                continue
            alloc = getattr(rep.bat, "_alloc", None)
            if alloc is not None:
                cross += int(getattr(alloc, "import_hit_tokens", 0))
            for k, window in rep.bat._lat.items():
                lat.setdefault(k, []).extend(window)
        return {
            "replicas": len(self._reps),
            "live_replicas": self.live_replicas,
            "requests_submitted": self._next_gid,
            "requests_completed": self._completed,
            "requests_shed": self._shed_count,
            "requests_requeued": self._requeued,
            "rebalanced": self._rebalanced,
            "kills": self._kills,
            "routes": self._routes,
            "prefix_routed": self._prefix_routed,
            "prefix_route_hit_rate": round(
                self._prefix_routed / self._routes, 4)
            if self._routes else 0.0,
            "routed_by_replica": {r.idx: r.routed for r in self._reps},
            "requeued_by_replica": {r.idx: r.requeued_in
                                    for r in self._reps},
            "decision_ms": {"count": dec["count"],
                            "p50": round(dec["p50"], 4),
                            "p99": round(dec["p99"], 4),
                            "max": round(dec["max"], 4)},
            "handoffs": self._handoffs,
            "handoff_bytes": self._handoff_bytes,
            "handoff_staged": len(self._handoff_staged),
            "handoff_ms": {"count": hand["count"],
                           "p50": round(hand["p50"], 4),
                           "p99": round(hand["p99"], 4),
                           "max": round(hand["max"], 4)},
            "cross_prefix_hit_tokens": cross,
            "replicated_pages": self._replicated_pages,
            "latency": {k: _summary_of(v) for k, v in lat.items()},
            "per_replica": per,
        }


# ---------------------------------------------------------------------------
# replica-per-rank mode: discovery/heartbeat/stats over the launch KV plane
# ---------------------------------------------------------------------------

class ReplicaPublisher:
    """Worker-side publication for the replica-per-rank mode — the
    FleetSink key schema on the launch KV plane (any object with its
    put/stamp/prefix verbs):

        ``<job>/serve/<replica>/latest``  the replica's router_view()
        ``<job>/serve/<replica>/hb``      master-clock heartbeat stamp

    A subprocess replica calls ``publish(bat.router_view())`` at chunk
    boundaries (one JSON PUT + one stamp); the coordinator's
    `discover_replicas` + `pick_replica` then run the routing policy
    over the fleet without sharing a process with any replica.  The
    replica id defaults to the launcher's PADDLE_TRAINER_ID."""

    def __init__(self, kv, job_id: str = "serve",
                 replica: Optional[int] = None):
        self._kv = _kv_plane(kv)
        self._job = job_id
        if replica is None:
            replica = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        self.replica = int(replica)

    def publish(self, view: dict) -> bool:
        rec = dict(view, replica=self.replica)
        pre = f"{self._job}/serve/{self.replica}"
        ok = self._kv.put(f"{pre}/latest", json.dumps(rec))
        self._kv.stamp(f"{pre}/hb")
        return bool(ok)

    def retire(self) -> bool:
        """Tombstone this replica on the KV plane:
        a master-clock stamp under ``<job>/serve/<replica>/tombstone``.
        A retired/scaled-in replica stops heartbeating, so without the
        tombstone its last published view would read as a stale live
        replica forever; `discover_replicas` skips tombstoned ids."""
        ok = self._kv.stamp(f"{self._job}/serve/{self.replica}/tombstone")
        return bool(ok)


def discover_replicas(kv, job_id: str = "serve") -> Dict[int, dict]:
    """{replica: latest router_view} discovered from the KV plane —
    the coordinator-side read of ReplicaPublisher's schema.  Records
    that fail to parse are skipped (a torn PUT must not poison the
    fleet view); feed the values straight to `pick_replica` (each
    carries its ``replica`` id)."""
    kv = _kv_plane(kv)
    out: Dict[int, dict] = {}
    got = kv.prefix(f"{job_id}/serve")
    dead = set()
    for key in got:
        if key.endswith("/tombstone"):
            try:
                dead.add(int(key.split("/")[-2]))
            except ValueError:
                continue
    for key, raw in got.items():
        if not key.endswith("/latest"):
            continue
        try:
            rec = json.loads(raw)
            rid = int(rec["replica"])
        except (ValueError, KeyError, TypeError):
            continue
        if rid in dead:     # retired: the stale last view
            continue        # must not read as a live replica
        out[rid] = rec
    return out
