"""Continuous batching with chunked prefill over a paged KV cache, with
the request plane: SLO classes, deadlines and shedding, fault recovery,
the watchdog and drain, streaming, and speculative decoding.

Counterpart of `paddle_tpu/inference/serving.py` — `SLO_CLASSES` (:158),
`Request` (:162-206), `ContinuousBatcher.__init__` (:232, speculation
:281-338 and :413-466), `_paged_geometry` (:541), `submit` (:587),
`queue_snapshot` / `_shed_victim` (:656-688), `step` / `run` / `drained`
(:689-755), `_deliver`, `_shed`, `_shed_deadline_missed`, `_requeue`,
`_clear_slot` and `_fault_slot` (:757-905), `_finish_spans` (:906),
`_begin_drain` / `_flush_partial` (:966-1006), `_attainment_of` /
`shed_rate_window` (:1042-1065), `stats` (:1118), `_evict` (:1246),
`_admit_locked` (:1324, copy-on-write as `_page_copy_fn` :1458), the
step body `step_core` (:1798-1850), the draft/verify body `spec_core`
(:1986-2040) and `_run_chunk` (:2097).  The scheduling is the
reference's, decision for decision, so the same weights, requests, fault
spec and clock give the same greedy tokens, shed sets and counters:

  * `max_batch_size` slots; requests are admitted at chunk boundaries in
    SLO priority order (`interactive`, `batch`, `best_effort`), FIFO by
    arrival within a class, and evicted when they finish.  A class head
    deferred by KV-pool pressure blocks its own and lower classes;
  * a bounded queue (FLAGS_serve_queue_depth) sheds the lowest-class
    newest-arrival QUEUED request; a request still queued past its
    deadline sheds as a deadline miss; an in-flight decode is never
    shed.  Every submitted id appears once in run()'s results;
  * fault points (`distributed/fault.py`): `serve.admit` and
    `serve.kv_alloc` retry FIFO-in-place (bounded by
    FLAGS_serve_retry_budget); `serve.chunk` fires before the chunk's
    first in-place write, so a retried chunk finds the KV pool, the
    positions and the draft cache as they were (past the budget of
    consecutive chunk faults the FaultError reaches the caller);
    `serve.decode` poisons one slot, which is evicted (pages released,
    position reset) and its request requeued at its arrival position
    for a re-decode from scratch, or shed past its budget or deadline;
  * every chunk runs under `watched("serve.chunk")`
    (FLAGS_stop_check_timeout); the window ends after the chunk's one
    device-to-host transfer, which waits for the device, so a hung
    chunk is seen and counted;
  * drain: once `guard.drain_requested()`, admissions close (queued
    requests shed with reason "drain"), in-flight decodes finish within
    PADDLE_DRAIN_GRACE seconds, then the rest are flushed as partial
    results;
  * streaming: `submit(on_token=)` receives each chunk's new
    output-surviving tokens (EOS-trimmed, capped at max_new_tokens) and
    `done=True` once; `delivered_tokens` survives requeues, so a streamed
    token is never sent twice nor disowned.  Callback errors are counted,
    not raised; the queue lock is reentrant, so a callback may submit;
  * speculative decoding (`spec_tokens=K` with `draft_model=` or
    `draft_layers=`, the early-exit draft): each decode step drafts K
    tokens with the draft (its own dense per-slot cache, prefilled in
    lockstep inside the admission steps), verifies them in ONE target
    pass of width K+1 (the paged_attention kernel with K+1 query rows),
    and accepts the longest matching prefix plus the target's bonus
    token.  Acceptance stays on the device (a cumprod of the matches,
    the capacity clamp min(acc+1, max_len-1-pos)); rejected rows sit past
    the new frontier and are overwritten before any query reaches them.
    Greedy output equals plain decode's;
  * one [B, C] step body serves both phases: a prefilling slot feeds up
    to C prompt tokens (chunked prefill), a decoding slot its last token,
    a free or done slot nothing (its lanes write the null page or past
    its frontier, where no query can see them);
  * KV lives in ONE page pool shared by every slot through page tables
    (paged layout, the default) or in per-slot dense ring buffers
    (kv_layout="dense"); prefix sharing maps resident prompt pages
    (copy-on-write at a mid-page divergence) and is off by default under
    speculation (a skipped prefill never fills the draft's cache);
  * weight-only quantization (`weight_only_dtype`) packs the model's
    decode matmuls in place before the cache is built, and an int8 KV
    pool (`kv_dtype="int8"`) carries per-page per-head scales.

How the reference's compiled scan becomes PyTorch: the `lax.scan` of K
steps is a Python loop of K steps over device tensors (speculation's
inner draft scan too); the argmax, acceptance, the position advance and
the mode/done masks stay on the device; the KV pool, the page table, the
draft cache and the per-slot state are updated IN PLACE where the
reference donates them; and each chunk makes exactly ONE device-to-host
transfer (tokens, the state the host schedules on and the speculation
counts), as the reference's `_run_chunk` does.  A draft's prefill stops
at its hidden states (`fill_cache`): eager PyTorch would otherwise
compute an lm head the reference's compiler drops.

Left out of the port so far (later work, see ROADMAP.md):
prefill/decode roles and KV hand-off (`role=`, `export_handoff`,
`import_handoff`, their stats keys), the router view and the
autoscaler, and telemetry events (the reference's `serve.*` events,
counters and histograms; `stats()` holds the same aggregates).
`stats()` has no `compiled_programs`: the port compiles no step
programs until CUDA-graph capture lands.  Decoding is greedy.
"""
from __future__ import annotations

import os
import threading
import time
import warnings
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..distributed import fault, guard
from ..distributed.watchdog import watched
from ..framework.device import module_device, resolve_device
from ..framework.flags import get_flag
from ..models.llama import _resolve_kv_dtype
from ..quantization.weight_only import quantize_model
from .paged_kv import PageAllocator

__all__ = ["ContinuousBatcher", "Request", "SLO_CLASSES"]

# admission priority order, highest first; shedding walks it in reverse
SLO_CLASSES = ("interactive", "batch", "best_effort")


@dataclass
class Request:
    req_id: int
    prompt: np.ndarray              # [L] int32
    max_new_tokens: int
    tokens: List[int] = field(default_factory=list)
    finished: bool = False
    # SLO and robustness state
    slo: str = "batch"
    deadline: Optional[float] = None   # absolute monotonic seconds
    arrival: int = 0                   # global arrival sequence number
    shed: bool = False
    shed_reason: Optional[str] = None
    requeues: int = 0                  # faulted-slot re-admissions
    admit_faults: int = 0              # injected admission-fault retries
    partial: bool = False              # drain-flushed mid-generation
    # monotonic stamps: submit -> admit -> first token -> done (a
    # requeue resets admit and first, so the spans describe the decode
    # that served the user)
    t_submit: float = 0.0
    t_admit: Optional[float] = None
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    # streaming callback on_token(req_id, tokens, done), and every token
    # handed to it: the copy survives requeues, and a shed after faults
    # restores it as the partial output
    on_token: Optional[object] = None
    delivered_tokens: List[int] = field(default_factory=list)

    @property
    def delivered(self) -> int:
        """Tokens already streamed."""
        return len(self.delivered_tokens)

    def output(self) -> np.ndarray:
        return np.asarray(self.tokens[: self.max_new_tokens], np.int32)


def _percentiles(values, qs=(50, 90, 99)) -> Dict[str, float]:
    """Nearest-rank percentiles (the reference's telemetry
    `percentiles_of`)."""
    out = {f"p{q}": 0.0 for q in qs}
    xs = sorted(float(v) for v in values)
    for q in qs:
        if xs:
            k = min(len(xs) - 1, max(0, int(round(q / 100.0
                                                  * (len(xs) - 1)))))
            out[f"p{q}"] = xs[k]
    return out


class ContinuousBatcher:
    """One model, `max_batch_size` sequence slots, insert/evict at chunk
    boundaries, chunked prefill through the decode step, KV in a shared
    page pool.

    chunk: decode steps per host round trip.
    prefill_chunk: prompt tokens a prefilling slot consumes per step of
    an admission chunk (the step width C while any slot prefills).
    admit_steps: steps per admission chunk (default chunk // 4).
    kv_layout: "paged" (default) or "dense".
    page_size / num_pages / kv_dtype: paged-pool geometry and precision;
    None reads FLAGS_kv_page_size / FLAGS_kv_pool_pages /
    FLAGS_kv_cache_dtype (num_pages 0 = dense-equivalent capacity).
    prefix_sharing: map resident prefix pages (paged only).  None = on,
    except under speculation (off; an explicit True keeps both and
    warns).
    weight_only_dtype: "int8" | "int4" packs the model's decode matmuls
    in place (quantization.weight_only.quantize_model, group size from
    FLAGS_weight_only_group_size); None reads FLAGS_weight_only_dtype;
    "none" leaves the model as it is.
    spec_tokens: draft tokens K per verify step (None reads
    FLAGS_serve_spec_tokens; 0 = no speculation).
    draft_model: a decode-capable draft (forward_cached/init_cache) on
    the batcher's device; None with K > 0 builds the target's early-exit
    draft of `draft_layers` layers (None reads
    FLAGS_serve_draft_layers).
    device: None means CUDA (raises without one); the model must live
    on the resolved device.
    """

    def __init__(self, model, max_batch_size: int = 4, max_len: int = 256,
                 chunk: int = 16, prefill_chunk: int = 32,
                 admit_steps: Optional[int] = None,
                 eos_token_id: Optional[int] = None,
                 kv_layout: Optional[str] = None,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 kv_dtype: Optional[str] = None,
                 prefix_sharing: Optional[bool] = None,
                 weight_only_dtype: Optional[str] = None,
                 spec_tokens: Optional[int] = None,
                 draft_model=None,
                 draft_layers: Optional[int] = None,
                 device=None):
        if not hasattr(model, "forward_cached"):
            raise TypeError("ContinuousBatcher needs a decode-capable "
                            "model (forward_cached/init_cache)")
        self.device = resolve_device(device)
        if module_device(model) != self.device:
            raise ValueError(f"model lives on {module_device(model)}, the "
                             f"batcher was asked for {self.device}")
        # pack the decode weights in place before the cache is built
        wo = weight_only_dtype if weight_only_dtype is not None \
            else get_flag("weight_only_dtype", "none")
        quantize_model(model, wo)
        if kv_layout is None:
            kv_layout = "paged" if hasattr(model, "forward_cached_paged") \
                else "dense"
        if kv_layout not in ("paged", "dense"):
            raise ValueError(f"kv_layout {kv_layout!r}: paged|dense")
        self.model = model
        self.B = int(max_batch_size)
        self.max_len = int(max_len)
        self.chunk = int(chunk)
        self.prefill_chunk = max(1, min(int(prefill_chunk), self.max_len))
        self.admit_steps = max(1, int(admit_steps) if admit_steps is not None
                               else self.chunk // 4)
        self.eos = eos_token_id
        self.kv_layout = kv_layout
        # -- speculative decoding: K > 0 swaps the decode chunk for the
        # draft/verify body
        k = spec_tokens if spec_tokens is not None \
            else get_flag("serve_spec_tokens", 0)
        self.spec_k = max(0, int(k or 0))
        self._spec_w = self.spec_k + 1          # verify width
        self._draft = None
        if self.spec_k:
            if draft_model is None:
                n = draft_layers if draft_layers is not None \
                    else get_flag("serve_draft_layers", 0)
                n = int(n or 0)
                if n <= 0:
                    raise ValueError(
                        "speculative decoding needs a draft: pass "
                        "draft_model= or draft_layers= (or set "
                        "FLAGS_serve_draft_layers) for early-exit "
                        "self-drafting")
                if not hasattr(model, "early_exit_draft"):
                    raise TypeError(
                        f"{type(model).__name__} has no "
                        "early_exit_draft(); pass an explicit "
                        "draft_model instead")
                draft_model = model.early_exit_draft(n)
            else:
                if not hasattr(draft_model, "forward_cached"):
                    raise TypeError("draft_model needs a cached decode "
                                    "path (forward_cached/init_cache)")
                if isinstance(draft_model, torch.nn.Module) \
                        and module_device(draft_model) != self.device:
                    raise ValueError(
                        f"draft_model lives on {module_device(draft_model)}"
                        f", the batcher was asked for {self.device}")
            self._draft = draft_model
        self._spec_drafted = 0
        self._spec_accepted = 0
        self._spec_steps = 0
        self._spec_emit_window: deque = deque(maxlen=4096)
        # one FIFO per SLO class; the lock orders a submit() against
        # admission, and is reentrant because a shed inside submit()
        # fires on_token, which may itself submit()
        self._qlock = threading.RLock()
        self._queues: Dict[str, deque] = {c: deque() for c in SLO_CLASSES}
        self._slots: List[Optional[Request]] = [None] * self.B
        self._finished: Dict[int, Request] = {}
        self._next_id = 0
        self._arrival_seq = 0
        self._now = time.monotonic     # patchable time source (tests)
        self._has_deadlines = False    # the sweep is skipped until a
        #                                deadline ever enters the queue
        self._draining = False
        self._drain_deadline = None
        # robustness accounting: once queue and slots drain,
        # requests_submitted == requests_completed + requests_shed
        self._submitted = 0
        self._admissions = 0           # admission events (requeues
        #                                re-admit, so >= completed)
        self._completed = 0
        self._shed_count = 0
        self._shed_by_class = {c: 0 for c in SLO_CLASSES}
        # one 0/1 sample per terminal request (shed = 1), bounded: the
        # shed rate of current pressure
        self._terminal_window: deque = deque(maxlen=256)
        self._deadline_misses = 0
        self._requeue_count = 0
        self._chunk_retries = 0
        self._consecutive_chunk_faults = 0
        self._hung_chunks = 0
        self._cb_errors = 0
        self._watch = watched("serve.chunk")
        # the logical KV depth is C-1 rows DEEPER than max_len: a [B, C]
        # step's pad lanes write up to C-1 rows past a slot's valid
        # depth.  Under speculation the widest writer is the verify pass,
        # and a done slot's frozen pos can sit up to K rows past the
        # clamp with another K+1 junk rows beyond it: hence 2K+2
        self._eff_chunk = max(self.prefill_chunk, 2 * self.spec_k + 2) \
            if self.spec_k else self.prefill_chunk
        self._cache_len = self.max_len + self._eff_chunk - 1
        dev = self.device
        if kv_layout == "paged":
            (self.page_size, self.pages_per_slot,
             self.num_pages) = self._paged_geometry(
                self.B, self.max_len, self._eff_chunk, page_size,
                num_pages)
            if prefix_sharing is None:
                self.prefix_sharing = not self.spec_k
            else:
                self.prefix_sharing = bool(prefix_sharing)
                if self.prefix_sharing and self.spec_k:
                    warnings.warn(
                        "prefix_sharing=True with speculative decoding:"
                        " shared-prefix admissions skip the prefill"
                        " chunks that would fill the DRAFT cache, so"
                        " accept_rate degrades on every prefix hit"
                        " (output stays bit-exact). Prefer one or the"
                        " other per workload.", stacklevel=2)
            # rows a slot can write past prompt+new before the host
            # evicts it: junk decode steps inside the finishing chunk
            # (each advancing up to K+1 rows under speculation), plus
            # the widest step's junk lanes
            self._overshoot = max(self.chunk * self._spec_w,
                                  self.admit_steps) + self._eff_chunk
            self._alloc = PageAllocator(self.num_pages, self.page_size)
            self._plans: List[Optional[object]] = [None] * self.B
            self._cache = model.init_paged_cache(self.num_pages,
                                                 self.page_size, kv_dtype)
            self._kv_dtype = str(self._cache["k"].dtype).replace("torch.", "")
            self._page_table = torch.zeros((self.B, self.pages_per_slot),
                                           dtype=torch.int32, device=dev)
        else:
            self.prefix_sharing = False
            self._cache = model.init_cache(self.B, self._cache_len)
        # the draft's cache is dense per-slot ring buffers even over a
        # paged target pool: its rows are never shared
        self._dcache = self._draft.init_cache(self.B, self._cache_len) \
            if self.spec_k else None
        i32 = dict(dtype=torch.int32, device=dev)
        self._pos = torch.zeros((self.B,), **i32)
        self._tok = torch.zeros((self.B,), **i32)
        self._mode = torch.zeros((self.B,), dtype=torch.bool, device=dev)
        self._plen = torch.zeros((self.B,), **i32)
        self._prompts = torch.zeros((self.B, self.max_len), **i32)
        self._done = torch.ones((self.B,), dtype=torch.bool, device=dev)
        self._mode_host = np.zeros((self.B,), bool)
        self._done_host = np.ones((self.B,), bool)
        self._pos_host = np.zeros((self.B,), np.int64)
        # bounded windows of chunk wall times (all, and by kind)
        self._chunk_times: deque = deque(maxlen=1024)
        self._kind_times = {"admit": deque(maxlen=1024),
                            "decode": deque(maxlen=1024)}
        self._chunk_time_max = 0.0
        # per-request latency windows and per-SLO-class attainment
        self._lat: Dict[str, deque] = {
            k: deque(maxlen=1024)
            for k in ("queue_ms", "ttft_ms", "tpot_ms", "e2e_ms")}
        self._slo_lat = {c: {"completed": 0, "with_deadline": 0,
                             "deadline_met": 0} for c in SLO_CLASSES}
        self._chunk_count = 0
        self._chunk_kind_counts = {"admit": 0, "decode": 0}
        self._forward_steps = 0
        self._occupancy_total = 0
        self._prefill_tok_total = 0
        self._decode_tok_total = 0

    # -- pool geometry -----------------------------------------------------
    @staticmethod
    def _paged_geometry(B, max_len, prefill_chunk, page_size=None,
                        num_pages=None):
        """(page_size, pages_per_slot, num_pages): pages_per_slot covers
        the logical depth plus the write window (ceil(C/ps)+1 pages);
        num_pages defaults to dense-equivalent capacity (every slot
        fully backed + the null page)."""
        ps = int(page_size or get_flag("kv_page_size", 16))
        cache_len = max_len + prefill_chunk - 1
        pages_per_slot = max(
            (max_len - 1) // ps + (-(-prefill_chunk // ps)) + 1,
            -(-cache_len // ps))
        auto = 1 + B * pages_per_slot
        num_pages = int(num_pages or get_flag("kv_pool_pages", 0) or auto)
        return ps, pages_per_slot, num_pages

    # -- public API --------------------------------------------------------
    def submit(self, input_ids, max_new_tokens: int = 32,
               slo: str = "batch", deadline_ms: Optional[float] = None,
               on_token=None) -> int:
        """Queue one request; returns its id.  Admission happens at the
        next chunk boundary, in SLO-class priority order (FIFO by
        arrival within a class).

        slo: "interactive" | "batch" | "best_effort".
        deadline_ms: latest time (from now) by which the request must be
        ADMITTED; still queued past it = shed as a deadline miss (None
        reads FLAGS_serve_default_deadline_ms; 0 = none).
        on_token: streaming callback `on_token(req_id, tokens, done)`,
        fired from run()/step() with each NEW burst of output-surviving
        tokens and `done=True` exactly once at the terminal delivery
        (finish, drain flush or shed).  Its exceptions are counted
        (`callback_errors`), not raised.

        A request shed by the bounded queue, a deadline or the drain
        comes back from run() with `shed=True` and an empty (or
        partial) output."""
        ids = np.asarray(input_ids, np.int32).reshape(-1)
        if len(ids) == 0:
            raise ValueError("empty prompt: a request needs at least one "
                             "token to condition on")
        if len(ids) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({len(ids)}) + {max_new_tokens} new tokens "
                f"exceeds the slot depth max_len={self.max_len}")
        if slo not in SLO_CLASSES:
            raise ValueError(f"unknown SLO class {slo!r}; known: "
                             f"{SLO_CLASSES}")
        rid = self._next_id
        self._next_id += 1
        req = Request(rid, ids, int(max_new_tokens), slo=slo,
                      arrival=self._arrival_seq, on_token=on_token)
        req.t_submit = self._now()
        self._arrival_seq += 1
        if deadline_ms is None:
            deadline_ms = float(get_flag("serve_default_deadline_ms")
                                or 0.0)
        if deadline_ms <= 0:
            deadline_ms = None          # 0 = no deadline, as the flag
        if deadline_ms is not None:
            req.deadline = self._now() + float(deadline_ms) / 1e3
            self._has_deadlines = True
        self._submitted += 1
        if self._draining:
            self._shed(req, "drain")    # admissions are closed
            return rid
        with self._qlock:
            depth = int(get_flag("serve_queue_depth") or 0)
            if depth > 0 and self._queued_count() >= depth:
                victim = self._shed_victim(req)
                if victim is req:
                    self._shed(req, "queue_full")
                    return rid
                self._queues[victim.slo].remove(victim)
                self._shed(victim, "queue_full")
            self._queues[slo].append(req)
        return rid

    def _queued_count(self) -> int:
        with self._qlock:
            return sum(len(q) for q in self._queues.values())

    def queue_snapshot(self) -> Dict[str, int]:
        """One consistent {slo_class: queued count} view."""
        with self._qlock:
            return {c: len(q) for c, q in self._queues.items()}

    def _shed_victim(self, incoming: Request) -> Request:
        """Queue-overflow victim: lowest SLO class first, newest arrival
        within it — the incoming request itself when nothing queued
        ranks below it.  In-flight slots are never candidates."""
        order = {c: i for i, c in enumerate(SLO_CLASSES)}

        def rank(r):
            return (order[r.slo], r.arrival)
        victim = incoming
        for q in self._queues.values():
            for r in q:
                if rank(r) > rank(victim):
                    victim = r
        return victim

    def step(self) -> List[Request]:
        """One scheduling round: evict finished slots, shed queued
        requests past their deadline, admit queued requests into free
        slots, run one chunk (admission-mode while any slot is still
        consuming its prompt, decode otherwise).  Returns the requests
        finished this round.  Once a drain is requested, admissions
        close and only the in-flight slots keep decoding."""
        if not self._draining and guard.drain_requested():
            self._begin_drain()
        newly = self._evict()
        if not self._draining:
            self._shed_deadline_missed()
            self._admit()
        if any(r is not None for r in self._slots):
            self._run_chunk(mixed=bool(self._mode_host.any()))
            newly += self._evict()
        return newly

    def run(self) -> Dict[int, np.ndarray]:
        """Drive until queue and slots drain; returns {req_id: tokens}
        for EVERY submitted request (shed ones included).  Under a drain
        the in-flight slots get PADDLE_DRAIN_GRACE seconds, then the
        rest are flushed as partial results and run() returns."""
        while self._queued_count() or any(r is not None
                                          for r in self._slots):
            if self._draining and self._drain_deadline is not None \
                    and self._now() > self._drain_deadline:
                self._flush_partial()
                break
            self.step()
        return {rid: r.output() for rid, r in self._finished.items()}

    @property
    def drained(self) -> bool:
        """True once the drain protocol engaged."""
        return self._draining

    @property
    def queued(self) -> int:
        """Requests waiting for a slot (all SLO classes)."""
        return self._queued_count()

    @property
    def active(self) -> int:
        return sum(r is not None for r in self._slots)

    @property
    def finished_requests(self) -> Dict[int, Request]:
        return dict(self._finished)

    @property
    def tokens_produced(self) -> int:
        """Tokens that survive to request outputs (junk lanes decoded
        between a finish and the next chunk boundary do not count)."""
        live = sum(min(len(r.tokens), r.max_new_tokens)
                   for r in self._slots if r is not None)
        done = sum(min(len(r.tokens), r.max_new_tokens)
                   for r in self._finished.values())
        return live + done

    def kv_cache_bytes(self) -> int:
        """Device bytes of the target's KV cache (pool + int8 scales +
        page table, or the dense ring buffers); a speculative draft's
        cache is draft_kv_bytes()."""
        if self.kv_layout == "paged":
            bufs = list(self._cache.values()) + [self._page_table]
        else:
            bufs = [t for kv in self._cache for t in kv]
        return int(sum(t.numel() * t.element_size() for t in bufs))

    def draft_kv_bytes(self) -> int:
        """Device bytes of the speculative draft's dense KV cache (0
        without speculation)."""
        if self._dcache is None:
            return 0
        return int(sum(t.numel() * t.element_size()
                       for kv in self._dcache for t in kv))

    @classmethod
    def paged_kv_bytes(cls, model, max_batch_size, max_len,
                       prefill_chunk: int = 32, page_size=None,
                       num_pages=None, kv_dtype=None,
                       spec_tokens: int = 0) -> int:
        """Device bytes a paged batcher of this geometry would hold
        (pool + scales + page table) — shape arithmetic, no allocation.
        Equals kv_cache_bytes() of a real instance; with spec_tokens K
        the pages cover the verify pass's write window (2K+2 rows when
        wider than prefill_chunk), and the draft's own cache,
        draft_kv_bytes(), comes on top."""
        cfg = model.config
        B = int(max_batch_size)
        prefill_chunk = max(1, min(int(prefill_chunk), int(max_len)))
        k = max(0, int(spec_tokens or 0))
        eff_chunk = max(prefill_chunk, 2 * k + 2) if k else prefill_chunk
        ps, p_slot, n_pages = cls._paged_geometry(
            B, int(max_len), eff_chunk, page_size, num_pages)
        dt, quant = _resolve_kv_dtype(cfg, kv_dtype)
        pool = 2 * n_pages * ps * cfg.num_hidden_layers \
            * cfg.num_key_value_heads * cfg.head_dim * dt.itemsize
        scales = (2 * n_pages * cfg.num_hidden_layers
                  * cfg.num_key_value_heads * 4) if quant else 0
        table = B * p_slot * 4
        return pool + scales + table

    def _attainment_of(self, cls: str) -> Optional[float]:
        """Per-SLO-class attainment: admitted-in-time / deadlined for
        deadline-bearing traffic, else the served fraction; None with no
        signal yet."""
        rec = self._slo_lat[cls]
        shed = self._shed_by_class[cls]
        if rec["with_deadline"]:
            return rec["deadline_met"] / rec["with_deadline"]
        if rec["completed"] or shed:
            return rec["completed"] / (rec["completed"] + shed)
        return None

    @property
    def shed_rate_window(self) -> float:
        """Shed fraction over the last 256 terminal requests (0.0 with
        none yet)."""
        w = self._terminal_window
        return round(sum(w) / len(w), 4) if w else 0.0

    def stats(self) -> Dict[str, object]:
        """Scheduler counters: chunks by kind, forward steps, occupancy,
        the prefill/decode token split (scan-level work), useful tokens,
        chunk wall times (p50 over the last 1024 chunks, all and by kind;
        max over the lifetime; seconds), the robustness counters, the
        speculation block, latency windows (ms) and per-SLO attainment,
        and the KV-pool block."""
        n = self._chunk_count

        def p50(xs):
            xs = sorted(xs)
            return xs[len(xs) // 2] if xs else 0.0
        qbc = self.queue_snapshot()
        out = {
            "chunks": n,
            "decode_chunks": self._chunk_kind_counts["decode"],
            "admit_chunks": self._chunk_kind_counts["admit"],
            "forward_steps": self._forward_steps,
            "slots": self.B,
            "avg_occupancy": (self._occupancy_total / (n * self.B)) if n
            else 0.0,
            "prefill_tokens": self._prefill_tok_total,
            "decode_tokens": self._decode_tok_total,
            "tokens_produced": self.tokens_produced,
            "chunk_time_p50": p50(self._chunk_times),
            "chunk_time_max": self._chunk_time_max,
            "admit_chunk_time_p50": p50(self._kind_times["admit"]),
            "decode_chunk_time_p50": p50(self._kind_times["decode"]),
            "kv_layout": self.kv_layout,
            "kv_bytes": self.kv_cache_bytes(),
            "draft_kv_bytes": self.draft_kv_bytes(),
            "requests_submitted": self._submitted,
            "requests_admitted": self._admissions,
            "requests_completed": self._completed,
            "requests_shed": self._shed_count,
            "requests_requeued": self._requeue_count,
            "shed_by_class": dict(self._shed_by_class),
            "shed_rate_window": self.shed_rate_window,
            "deadline_misses": self._deadline_misses,
            "chunk_retries": self._chunk_retries,
            "hung_chunks": self._hung_chunks,
            "callback_errors": self._cb_errors,
            "queued": sum(qbc.values()),
            "queued_by_class": qbc,
            "drained": self._draining,
        }
        wo = getattr(self.model, "_weight_only", None)
        out["weight_only"] = wo["dtype"] if wo else "none"
        if self.spec_k:
            window = list(self._spec_emit_window)
            pct = _percentiles(window)
            out.update(
                spec_tokens=self.spec_k,
                spec_drafted=self._spec_drafted,
                spec_accepted=self._spec_accepted,
                spec_accept_rate=round(
                    self._spec_accepted / self._spec_drafted, 4)
                if self._spec_drafted else 0.0,
                spec_accepted_per_step={
                    "mean": round(sum(window) / len(window), 3)
                    if window else 0.0,
                    "p50": round(pct["p50"], 3),
                    "p99": round(pct["p99"], 3)},
            )
        latency = {}
        for k, window in self._lat.items():
            vals = [float(v) for v in window]
            pct = _percentiles(vals)
            latency[k] = {"count": len(vals),
                          "min": round(min(vals), 3) if vals else 0.0,
                          "max": round(max(vals), 3) if vals else 0.0,
                          **{q: round(v, 3) for q, v in pct.items()}}
        out["latency"] = latency
        attain = {}
        for cls in SLO_CLASSES:
            rec = dict(self._slo_lat[cls])
            rec["shed"] = self._shed_by_class[cls]
            att = self._attainment_of(cls)
            if att is not None:
                rec["attainment"] = round(att, 4)
            attain[cls] = rec
        out["slo_attainment"] = attain
        if self.kv_layout == "paged":
            out.update(
                kv_page_size=self.page_size,
                kv_pages=self.num_pages,
                kv_pages_used=self._alloc.pages_used,
                kv_pages_free=self._alloc.pages_free,
                kv_pages_cached=self._alloc.pages_cached,
                kv_dtype=self._kv_dtype,
                prefix_hit_tokens=self._alloc.prefix_hit_tokens,
                evictions=self._alloc.evictions,
                cow_copies=self._alloc.cow_copies,
            )
        else:
            out.update(prefix_hit_tokens=0, evictions=0, cow_copies=0)
        return out

    # -- streaming and robustness plumbing ---------------------------------
    def _deliver(self, req: Request, done: bool):
        """Hand the request's NEW output-surviving tokens (EOS-trimmed,
        capped at max_new_tokens: exactly what output() returns) to its
        on_token callback; `done=True` fires once, at the terminal
        delivery."""
        if req.on_token is None:
            return
        cap = req.max_new_tokens
        if self.eos is not None and self.eos in req.tokens:
            cap = min(cap, req.tokens.index(self.eos) + 1)
        end = min(len(req.tokens), cap)
        burst = [int(t) for t in req.tokens[req.delivered:end]]
        if not burst and not done:
            return
        req.delivered_tokens.extend(burst)
        try:
            req.on_token(req.req_id, burst, done)
        except Exception:
            # a broken consumer must not poison the batch
            self._cb_errors += 1

    def _shed(self, req: Request, reason: str):
        """Terminal no-service state: the request is accounted in
        `_finished` (run() returns it) but marked shed.  Callers take it
        out of the queues first; an in-flight decode is never shed."""
        req.finished = True
        req.shed = True
        req.shed_reason = reason
        self._finished[req.req_id] = req
        self._deliver(req, done=True)
        self._shed_count += 1
        self._shed_by_class[req.slo] += 1
        self._terminal_window.append(1.0)

    def _shed_deadline_missed(self):
        """Shed every QUEUED request whose admission deadline passed."""
        if not self._has_deadlines:
            return
        now = self._now()
        with self._qlock:
            for cls in SLO_CLASSES:
                q = self._queues[cls]
                survivors = deque()
                while q:
                    req = q.popleft()
                    if req.deadline is not None and now > req.deadline:
                        self._deadline_misses += 1
                        self._shed(req, "deadline")
                    else:
                        survivors.append(req)
                self._queues[cls] = survivors

    def _requeue(self, req: Request):
        """Put a faulted-slot request back into its class queue AT ITS
        ARRIVAL POSITION."""
        with self._qlock:
            q = self._queues[req.slo]
            idx = 0
            while idx < len(q) and q[idx].arrival < req.arrival:
                idx += 1
            q.insert(idx, req)
        self._requeue_count += 1

    def _clear_slot(self, i: int):
        """Free slot i: done/mode flags, and for the paged layout its
        page mapping (prompt pages stay resident as cached prefix pages,
        pending ones are dropped; the freed slot's junk lanes write the
        null page)."""
        self._slots[i] = None
        self._done[i] = True
        self._mode[i] = False
        self._mode_host[i] = False
        self._done_host[i] = True
        if self.kv_layout == "paged" and self._plans[i] is not None:
            self._alloc.release_plan(self._plans[i])
            self._plans[i] = None
            self._page_table[i] = 0

    def _fault_slot(self, i: int, reason: str = "decode_fault"):
        """Slot i's decode came back poisoned: evict the slot, discard
        the request's tokens (the re-decode re-emits them) and requeue it
        at its arrival position — or shed it when its deadline passed,
        its retry budget (FLAGS_serve_retry_budget) is spent or a drain
        is on.  A shed request that already streamed tokens keeps exactly
        those as a partial output.  The rest of the batch is untouched."""
        req = self._slots[i]
        self._clear_slot(i)
        req.requeues += 1
        budget = int(get_flag("serve_retry_budget") or 3)
        shedding = (req.deadline is not None
                    and self._now() > req.deadline) \
            or req.requeues > budget or self._draining
        if shedding and req.delivered_tokens:
            req.tokens[:] = req.delivered_tokens
            req.partial = True
        else:
            req.tokens.clear()
        req.t_admit = None
        req.t_first = None
        if shedding:
            self._shed(req, reason)
        else:
            self._requeue(req)

    def _finish_spans(self, req: Request):
        """Close a DELIVERED request's latency spans into the bounded
        windows and the per-SLO attainment counters.  Shed requests
        never come here."""
        now = self._now()
        req.t_done = now
        self._terminal_window.append(0.0)
        self._lat["queue_ms"].append(
            ((req.t_admit if req.t_admit is not None else now)
             - req.t_submit) * 1e3)
        self._lat["e2e_ms"].append((now - req.t_submit) * 1e3)
        n = min(len(req.tokens), req.max_new_tokens)
        if req.t_first is not None:
            self._lat["ttft_ms"].append((req.t_first - req.t_submit) * 1e3)
            if n > 1:
                # tokens land in bursts: TPOT averages the decode window
                self._lat["tpot_ms"].append(
                    (now - req.t_first) * 1e3 / (n - 1))
        slo = self._slo_lat[req.slo]
        slo["completed"] += 1
        if req.deadline is not None:
            slo["with_deadline"] += 1
            if req.t_admit is not None and req.t_admit <= req.deadline:
                slo["deadline_met"] += 1

    def _begin_drain(self):
        """A drain was requested: close admissions (queued requests shed
        with reason "drain") and start the PADDLE_DRAIN_GRACE window."""
        self._draining = True
        grace = float(os.environ.get("PADDLE_DRAIN_GRACE", "60"))
        self._drain_deadline = self._now() + grace
        with self._qlock:
            for q in self._queues.values():
                while q:
                    self._shed(q.popleft(), "drain")

    def _flush_partial(self):
        """Grace expired: every still-running slot is delivered as a
        PARTIAL result (its tokens from completed chunks)."""
        for i, req in enumerate(self._slots):
            if req is None:
                continue
            self._clear_slot(i)
            req.finished = True
            req.partial = True
            self._finished[req.req_id] = req
            self._completed += 1
            self._finish_spans(req)
            self._deliver(req, done=True)

    # -- scheduling --------------------------------------------------------
    def _evict(self) -> List[Request]:
        out = []
        for i, req in enumerate(self._slots):
            if req is None:
                continue
            hit_eos = self.eos is not None and self.eos in req.tokens
            if hit_eos:
                req.tokens = req.tokens[: req.tokens.index(self.eos) + 1]
            # capacity clamp: a slot whose buffer filled stops emitting
            capped = (self._done_host[i] and not self._mode_host[i]
                      and req.tokens)
            if hit_eos or capped or len(req.tokens) >= req.max_new_tokens:
                req.finished = True
                self._finished[req.req_id] = req
                self._completed += 1
                self._finish_spans(req)
                self._deliver(req, done=True)
                self._clear_slot(i)
                out.append(req)
        return out

    def _admit(self):
        """Stage queued requests into free slots: plan the slot's page
        mapping (prefix-shared pages + fresh privates, CoW copy at a
        mid-page divergence), write the prompt into the device-side
        buffer and flip the slot to prefill mode; the unshared part of
        the prompt is consumed inside the next admission chunk.

        SLO order: classes in priority order, FIFO by arrival within a
        class.  Under pool pressure the class head defers to a later
        boundary and blocks its own and lower classes — unless nothing
        is running, which means the pool can never serve it: that
        raises.  Injected faults (`serve.admit`, `serve.kv_alloc`) retry
        FIFO-in-place, bounded by FLAGS_serve_retry_budget."""
        with self._qlock:
            self._admit_locked()

    def _admit_locked(self):
        free = [i for i in range(self.B) if self._slots[i] is None]

        def retry_exhausted(q, req, reason):
            """An injected admission-path fault: past the retry budget
            the request is shed (True: go on with the next one),
            otherwise it keeps its place for the next boundary (False:
            this class and lower wait)."""
            req.admit_faults += 1
            if req.admit_faults > int(get_flag("serve_retry_budget") or 3):
                q.popleft()
                self._shed(req, reason)
                return True
            return False

        for cls in SLO_CLASSES:
            q = self._queues[cls]
            while q and free:
                req = q[0]
                try:
                    f = fault.hit("serve.admit",
                                  key=f"req{req.req_id}:{cls}")
                except fault.FaultError:
                    if retry_exhausted(q, req, "admit_fault"):
                        continue
                    return
                if f is not None and f.mode == "skip":
                    q.popleft()
                    self._shed(req, "admit_fault")
                    continue
                plan = None
                if self.kv_layout == "paged":
                    ps = self.page_size
                    covered_rows = min(len(req.prompt) + req.max_new_tokens
                                       + self._overshoot, self._cache_len)
                    covered_pages = min(-(-covered_rows // ps),
                                        self.pages_per_slot)
                    try:
                        fk = fault.hit("serve.kv_alloc",
                                       key=f"req{req.req_id}")
                    except fault.FaultError:
                        # a transient allocator fault is pool pressure
                        if retry_exhausted(q, req, "kv_alloc_fault"):
                            continue
                        return
                    if fk is not None:
                        # a data-mode fault: simulated pool exhaustion
                        if retry_exhausted(q, req, "kv_alloc_fault"):
                            continue
                        return
                    plan = self._alloc.admit(
                        req.prompt if self.prefix_sharing else req.prompt[:0],
                        covered_pages)
                    if plan is None:
                        if self.active == 0:
                            raise RuntimeError(
                                f"KV pool ({self.num_pages - 1} usable pages"
                                f" of {ps} rows) cannot ever hold this "
                                f"request ({covered_pages} pages); grow "
                                f"num_pages or shrink the request")
                        return      # pressure: this class and lower wait
                q.popleft()
                i = free.pop(0)
                self._admissions += 1
                self._slots[i] = req
                req.t_admit = self._now()   # re-stamped on re-admission
                buf = np.zeros((self.max_len,), np.int32)
                buf[: len(req.prompt)] = req.prompt
                self._prompts[i] = torch.from_numpy(buf).to(self.device)
                self._plen[i] = len(req.prompt)
                self._tok[i] = 0
                self._done[i] = False
                self._done_host[i] = False
                start = 0
                if plan is not None:
                    self._plans[i] = plan
                    row = np.zeros((self.pages_per_slot,), np.int32)
                    row[: len(plan.pages)] = plan.pages
                    self._page_table[i] = torch.from_numpy(row).to(
                        self.device)
                    if plan.cow is not None:
                        # copy-on-write at the divergence boundary: clone
                        # the partially matched page into the slot's
                        # first private page, all layers, with every
                        # cache entry (an int8 pool's page scales too);
                        # admit() pinned the source until this copy
                        src, dst = plan.cow
                        for buf_ in self._cache.values():
                            buf_[dst].copy_(buf_[src])
                        self._alloc.release_page(src)
                    start = plan.shared_tokens
                # prefix-shared tokens are already resident: prefill
                # starts at the divergence, or straight to decode when
                # only the final prompt token remains
                self._pos[i] = start
                self._pos_host[i] = start
                prefilling = start < len(req.prompt)
                self._mode[i] = prefilling
                self._mode_host[i] = prefilling

    # -- the step bodies ----------------------------------------------------
    def _target(self, x, pos):
        """The target's logits [B, C, V] for x [B, C] at per-slot pos,
        writing the KV rows in place."""
        if self.kv_layout == "paged":
            lg, _ = self.model.forward_cached_paged(x, self._cache,
                                                    self._page_table, pos)
        else:
            lg, _ = self.model.forward_cached(x, self._cache, pos)
        return lg

    def _draft_fill(self, x, pos):
        """Write the draft's KV rows for x at pos, no logits."""
        d = self._draft
        if hasattr(d, "fill_cache"):
            d.fill_cache(x, self._dcache, pos)
        else:
            d.forward_cached(x, self._dcache, pos)

    def _step(self, C: int):
        """One [B, C] step (the reference's step_core).  Per slot:

          prefilling?  consume n = min(C, plen - pos) prompt tokens from
                       prompts[b, pos:pos+C]
          decoding?    feed [tok[b], pad...] (n = 1)
          free/done?   n = 0 (lanes run but nothing advances)

        Lanes past n write throwaway KV at pos+n..pos+C-1; queries only
        see rows <= pos+lane and the next step's valid lanes overwrite
        those rows before any query can reach them.  Under speculation
        the draft consumes the same x at the same pos, so its cache stays
        row for row in lockstep with the target's.  The logit at lane
        n-1 is argmax-sampled; a slot emits iff it decoded or consumed
        its final prompt chunk.  Updates the per-slot state in place and
        returns (emitted tokens [B] with -1 for none, prefill tokens,
        decode tokens) as device tensors."""
        B = self.B
        pos, tok, mode, done = self._pos, self._tok, self._mode, self._done
        prefilling = mode & ~done
        lanes = torch.arange(C, dtype=torch.int32, device=self.device)
        idx = torch.clamp(pos[:, None] + lanes[None], 0, self.max_len - 1)
        pref_x = torch.gather(self._prompts, 1, idx.to(torch.int64))
        dec_x = torch.cat([tok[:, None],
                           torch.zeros((B, C - 1), dtype=torch.int32,
                                       device=self.device)], dim=1)
        x = torch.where(prefilling[:, None], pref_x, dec_x)
        n_valid = torch.where(
            prefilling, torch.clamp(self._plen - pos, max=C),
            (~done).to(torch.int32)).to(torch.int32)
        lg = self._target(x, pos)
        if self.spec_k:
            self._draft_fill(x, pos)
        last = torch.clamp(n_valid - 1, 0, C - 1).to(torch.int64)
        lg_last = lg[torch.arange(B, device=self.device), last]
        nxt = torch.argmax(lg_last.float(), dim=-1).to(torch.int32)
        finishing = prefilling & (pos + n_valid >= self._plen)
        emit = finishing | (~prefilling & ~done)
        pos.add_(n_valid)
        mode &= ~finishing
        tok.copy_(torch.where(emit, nxt, tok))
        done |= pos >= self.max_len - 1       # a slot at capacity stops
        out_tok = torch.where(emit, nxt, torch.full_like(nxt, -1))
        n_pref = torch.where(prefilling, n_valid, 0).sum()
        n_dec = (~prefilling & (n_valid > 0)).sum()
        return out_tok, n_pref, n_dec

    def _spec_step(self):
        """One draft/verify decode step (the reference's spec_core).
        Per slot:

          drafts d_1..d_K = greedy draft continuations of tok (one more
                            draft step writes d_K's KV row, so an
                            all-accepted step leaves no hole)
          verify x        = [tok, d_1..d_K] at pos, one target pass of
                            width K+1
          targets t_i     = argmax of verify lane i-1 (t_1 is exactly
                            the non-speculative next token)
          accept a        = longest prefix with d_i == t_i; emit
                            t_1..t_{a+1}, capped at the max_len-1
                            frontier, and advance pos by that many

        Returns (tokens [B, K+1] with -1 past the emitted ones, n_emit
        [B], n_acc [B] = the unclamped accepted drafts of emitting
        slots) as device tensors; the state is updated in place."""
        Kd, W = self.spec_k, self._spec_w
        pos, tok, done = self._pos, self._tok, self._done
        d = self._draft
        dtok, dpos, drafts = tok, pos, []
        for _ in range(Kd):
            dlg, _ = d.forward_cached(dtok[:, None], self._dcache, dpos)
            dtok = torch.argmax(dlg[:, 0].float(), dim=-1).to(torch.int32)
            drafts.append(dtok)
            dpos = dpos + 1
        self._draft_fill(dtok[:, None], dpos)
        drafts = torch.stack(drafts, dim=1)                   # [B, K]
        x = torch.cat([tok[:, None], drafts], dim=1)          # [B, K+1]
        lg = self._target(x, pos)
        tgt = torch.argmax(lg.float(), dim=-1).to(torch.int32)
        match = (drafts == tgt[:, :Kd]).to(torch.int32)
        acc = torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32)
        allowed = torch.clamp(self.max_len - 1 - pos, min=0)
        n_emit = torch.where(done, 0, torch.minimum(acc + 1, allowed)) \
            .to(torch.int32)
        lanes = torch.arange(W, dtype=torch.int32, device=self.device)
        out_tok = torch.where(lanes[None] < n_emit[:, None], tgt,
                              torch.full_like(tgt, -1))
        last = torch.clamp(n_emit - 1, 0, W - 1).to(torch.int64)
        new_tok = torch.gather(tgt, 1, last[:, None])[:, 0]
        tok.copy_(torch.where(n_emit > 0, new_tok, tok))
        pos.add_(n_emit)
        done |= pos >= self.max_len - 1
        n_acc = torch.where(n_emit > 0, acc, 0)
        return out_tok, n_emit, n_acc

    @torch.inference_mode()
    def _run_chunk(self, mixed: bool):
        kind = "admit" if mixed else "decode"
        spec = bool(self.spec_k) and not mixed
        if mixed:
            C, K = self.prefill_chunk, self.admit_steps
        else:
            C, K = 1, self.chunk
        B = self.B
        t0 = time.perf_counter()
        try:
            # the whole chunk, its synchronising transfer included, runs
            # under the serve watchdog; serve.chunk fires before the
            # chunk's first in-place write, so a faulted chunk retries
            # from untouched state
            with self._watch:
                fault.hit("serve.chunk", key=kind)
                toks, n_emit, n_acc = [], [], []
                n_pref = n_dec = torch.zeros((), dtype=torch.int64,
                                             device=self.device)
                for _ in range(K):
                    if spec:
                        t, e, a = self._spec_step()
                        n_emit.append(e)
                        n_acc.append(a)
                        n_dec = n_dec + e.sum()
                    else:
                        t, p, dd = self._step(C)
                        n_pref = n_pref + p
                        n_dec = n_dec + dd
                    toks.append(t)
                # ONE device-to-host transfer per chunk: the emitted
                # tokens, the state the host schedules on and, under
                # speculation, the emitted and accepted counts
                parts = [torch.stack(toks, dim=1).reshape(-1),
                         self._mode, self._done, self._pos,
                         torch.stack([n_pref, n_dec])]
                if spec:
                    parts += [torch.stack(n_emit, dim=1).reshape(-1),
                              torch.stack(n_acc, dim=1).reshape(-1)]
                host = torch.cat([t.to(torch.int64) for t in parts]) \
                    .cpu().numpy()
        except fault.FaultError:
            self._chunk_retries += 1
            self._consecutive_chunk_faults += 1
            # a persistent chunk fault would spin run() forever: past
            # the budget it reaches the caller
            if self._consecutive_chunk_faults > int(
                    get_flag("serve_retry_budget") or 3):
                raise
            return
        self._consecutive_chunk_faults = 0
        if self._watch.last_reported:
            self._hung_chunks += 1
        W = self._spec_w if spec else 1
        o = B * K * W
        toks_h = host[:o].reshape(B, K * W)
        self._mode_host = host[o: o + B].astype(bool)
        self._done_host = host[o + B: o + 2 * B].astype(bool)
        self._pos_host = host[o + 2 * B: o + 3 * B].copy()
        o += 3 * B
        n_pref, n_dec = int(host[o]), int(host[o + 1])
        o += 2
        # serve.decode: the per-live-slot fault sweep — a poisoned slot
        # is evicted and its request requeued or shed before its pending
        # prefix pages could complete or its tokens be harvested
        if fault.is_active():
            faulted = []
            for i, req in enumerate(self._slots):
                if req is None:
                    continue
                try:
                    f = fault.hit("serve.decode",
                                  key=f"slot{i}:req{req.req_id}")
                except fault.FaultError:
                    faulted.append(i)
                    continue
                if f is not None:   # data modes poison the slot too
                    faulted.append(i)
            for i in faulted:
                self._fault_slot(i)
        dt = time.perf_counter() - t0
        self._chunk_times.append(dt)
        self._kind_times[kind].append(dt)
        self._chunk_time_max = max(self._chunk_time_max, dt)
        self._chunk_count += 1
        self._chunk_kind_counts[kind] += 1
        self._forward_steps += K
        self._occupancy_total += self.active
        self._prefill_tok_total += n_pref
        self._decode_tok_total += n_dec
        if spec:
            # n_emit [B, K]: tokens emitted per slot per step (0 =
            # inactive); n_acc the true accepted drafts, so accepted +
            # rejected == drafted holds under the capacity clamp too
            ne = host[o: o + B * K].reshape(B, K)
            na = host[o + B * K: o + 2 * B * K].reshape(B, K)
            active = ne > 0
            n_active = int(active.sum())
            self._spec_drafted += n_active * self.spec_k
            self._spec_accepted += int(na[active].sum())
            self._spec_steps += n_active
            self._spec_emit_window.extend(int(v) for v in ne[active])
        if self.kv_layout == "paged":
            # prompt pages that finished filling this chunk become
            # shareable for the NEXT admission
            for i, plan in enumerate(self._plans):
                if plan is not None and plan.nodes:
                    self._alloc.mark_progress(plan, int(self._pos_host[i]))
        t_harvest = self._now()
        for i, req in enumerate(self._slots):
            if req is None:
                continue
            req.tokens.extend(int(t) for t in toks_h[i] if t >= 0)
            if req.t_first is None and req.tokens:
                req.t_first = t_harvest
            # streaming: this chunk's burst goes out now
            self._deliver(req, done=False)
