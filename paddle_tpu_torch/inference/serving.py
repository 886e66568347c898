"""Continuous batching with chunked prefill over a paged KV cache.

Counterpart of `paddle_tpu/inference/serving.py` — `Request` (:162),
`ContinuousBatcher.__init__` (:232), `_paged_geometry` (:541),
`submit` (:587), `step` (:689), `run` (:718), `_evict` (:1246),
`_admit_locked` (:1324, copy-on-write as `_page_copy_fn` :1458), the
step body `step_core` (:1798-1850) and `_run_chunk` (:2097).  The
scheduling is the reference's, decision for decision, so the same
weights and requests give the same greedy tokens:

  * `max_batch_size` slots; requests are admitted FIFO into free slots
    at chunk boundaries and evicted when they finish;
  * one [B, C] step body serves both phases: a slot still consuming its
    prompt feeds up to C prompt tokens per step (chunked prefill), a
    decoding slot feeds its last token, a free or done slot feeds
    nothing (its lanes run, and its junk writes land on the null page or
    past its frontier, where no query can see them);
  * KV lives in ONE page pool shared by every slot through per-slot page
    tables (paged layout, the default) or in per-slot dense ring
    buffers (kv_layout="dense", the parity baseline);
  * prefix sharing: an admission whose prompt prefix matches resident
    pages maps them and skips their prefill; a mid-page divergence
    copies the matched page once (copy-on-write);
  * a pool smaller than total demand evicts cached prefix pages
    LRU-first and defers admissions — every request still completes;
  * weight-only quantization (`weight_only_dtype`, reference :250-259)
    packs the model's decode matmuls in place before the cache is built,
    and an int8 KV pool (`kv_dtype="int8"`) carries per-page per-head
    scales that every cache copy moves with the pages.

How the reference's compiled scan becomes PyTorch: the `lax.scan` of K
steps is a Python loop of K steps over device tensors; the argmax, the
position advance and the mode/done masks stay on the device; the KV
pool, the page table and the per-slot state (tokens, positions, modes,
prompt buffer) are updated IN PLACE where the reference donates them;
and each chunk makes exactly ONE device-to-host transfer (tokens plus
the state the host schedules on), as the reference's `_run_chunk` does.

Left out of the port so far (later work, see ROADMAP.md): SLO classes,
deadlines and shedding; fault points, the watchdog and drain; streaming
`on_token`; speculative decoding; prefill/decode roles and hand-off;
the router and autoscaler; telemetry.  Decoding is greedy.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..framework.device import module_device, resolve_device
from ..framework.flags import get_flag
from ..models.llama import _resolve_kv_dtype
from ..quantization.weight_only import quantize_model
from .paged_kv import PageAllocator

__all__ = ["ContinuousBatcher", "Request"]


@dataclass
class Request:
    req_id: int
    prompt: np.ndarray              # [L] int32
    max_new_tokens: int
    tokens: List[int] = field(default_factory=list)
    finished: bool = False
    # monotonic stamps: submit, first harvested token (TTFT)
    t_submit: float = 0.0
    t_first: Optional[float] = None

    def output(self) -> np.ndarray:
        return np.asarray(self.tokens[: self.max_new_tokens], np.int32)


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
    prefix_sharing: map resident prefix pages (paged only; default on).
    weight_only_dtype: "int8" | "int4" packs the model's decode matmuls
    in place (quantization.weight_only.quantize_model, group size from
    FLAGS_weight_only_group_size); None reads FLAGS_weight_only_dtype;
    "none" leaves the model as it is.
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
        self._queue: deque = deque()
        self._slots: List[Optional[Request]] = [None] * self.B
        self._finished: Dict[int, Request] = {}
        self._next_id = 0
        # the logical KV depth is C-1 rows DEEPER than max_len: a [B, C]
        # step's pad lanes write up to C-1 rows past a slot's valid depth
        self._cache_len = self.max_len + self.prefill_chunk - 1
        dev = self.device
        if kv_layout == "paged":
            (self.page_size, self.pages_per_slot,
             self.num_pages) = self._paged_geometry(
                self.B, self.max_len, self.prefill_chunk, page_size,
                num_pages)
            self.prefix_sharing = True if prefix_sharing is None \
                else bool(prefix_sharing)
            # rows a slot can write past prompt+new before the host
            # evicts it: junk decode steps inside the finishing chunk,
            # plus C-1 junk lanes
            self._overshoot = max(self.chunk, self.admit_steps) \
                + self.prefill_chunk
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
        self._chunk_times = {"admit": deque(maxlen=1024),
                             "decode": deque(maxlen=1024)}
        self._chunk_count = 0
        self._chunk_kind_counts = {"admit": 0, "decode": 0}
        self._forward_steps = 0
        self._occupancy_total = 0
        self._prefill_tok_total = 0
        self._decode_tok_total = 0
        self._submitted = 0
        self._completed = 0

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
    def submit(self, input_ids, max_new_tokens: int = 32) -> int:
        """Queue one request; returns its id.  Admission happens at the
        next chunk boundary, FIFO by arrival."""
        ids = np.asarray(input_ids, np.int32).reshape(-1)
        if len(ids) == 0:
            raise ValueError("empty prompt: a request needs at least one "
                             "token to condition on")
        if len(ids) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({len(ids)}) + {max_new_tokens} new tokens "
                f"exceeds the slot depth max_len={self.max_len}")
        rid = self._next_id
        self._next_id += 1
        req = Request(rid, ids, int(max_new_tokens))
        req.t_submit = time.monotonic()
        self._queue.append(req)
        self._submitted += 1
        return rid

    def step(self) -> List[Request]:
        """One scheduling round: evict finished slots, admit queued
        requests into free slots, run one chunk (admission-mode while
        any slot is still consuming its prompt, pure decode otherwise).
        Returns the requests finished this round."""
        newly = self._evict()
        self._admit()
        if any(r is not None for r in self._slots):
            self._run_chunk(mixed=bool(self._mode_host.any()))
            newly += self._evict()
        return newly

    def run(self) -> Dict[int, np.ndarray]:
        """Drive until queue and slots drain; returns {req_id: tokens}
        for every submitted request."""
        while self._queue or any(r is not None for r in self._slots):
            self.step()
        return {rid: r.output() for rid, r in self._finished.items()}

    @property
    def queued(self) -> int:
        return len(self._queue)

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
        """Device bytes of the KV cache (pool + int8 scales + page
        table, or the dense ring buffers)."""
        if self.kv_layout == "paged":
            bufs = list(self._cache.values()) + [self._page_table]
        else:
            bufs = [t for kv in self._cache for t in kv]
        return int(sum(t.numel() * t.element_size() for t in bufs))

    @classmethod
    def paged_kv_bytes(cls, model, max_batch_size, max_len,
                       prefill_chunk: int = 32, page_size=None,
                       num_pages=None, kv_dtype=None) -> int:
        """Device bytes a paged batcher of this geometry would hold
        (pool + scales + page table) — shape arithmetic, no allocation.
        Equals kv_cache_bytes() of a real instance."""
        cfg = model.config
        B = int(max_batch_size)
        prefill_chunk = max(1, min(int(prefill_chunk), int(max_len)))
        ps, p_slot, n_pages = cls._paged_geometry(
            B, int(max_len), prefill_chunk, page_size, num_pages)
        dt, quant = _resolve_kv_dtype(cfg, kv_dtype)
        pool = 2 * n_pages * ps * cfg.num_hidden_layers \
            * cfg.num_key_value_heads * cfg.head_dim * dt.itemsize
        scales = (2 * n_pages * cfg.num_hidden_layers
                  * cfg.num_key_value_heads * 4) if quant else 0
        table = B * p_slot * 4
        return pool + scales + table

    def stats(self) -> Dict[str, object]:
        """Scheduler counters: chunks by kind, model forward steps,
        occupancy, the prefill/decode token split (scan-level work),
        useful tokens, chunk wall-time medians (seconds), and the
        KV-pool block (pages, prefix-hit tokens, evictions, CoW
        copies)."""
        n = self._chunk_count

        def p50(xs):
            xs = sorted(xs)
            return xs[len(xs) // 2] if xs else 0.0
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
            "admit_chunk_time_p50": p50(self._chunk_times["admit"]),
            "decode_chunk_time_p50": p50(self._chunk_times["decode"]),
            "kv_layout": self.kv_layout,
            "kv_bytes": self.kv_cache_bytes(),
            "requests_submitted": self._submitted,
            "requests_completed": self._completed,
            "queued": self.queued,
        }
        wo = getattr(self.model, "_weight_only", None)
        out["weight_only"] = wo["dtype"] if wo else "none"
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

    # -- scheduling --------------------------------------------------------
    def _clear_slot(self, i: int):
        """Free slot i: done/mode flags, and for the paged layout its
        page mapping (prompt pages stay resident as cached prefix
        pages; the freed slot's junk lanes write the null page)."""
        self._slots[i] = None
        self._done[i] = True
        self._mode[i] = False
        self._mode_host[i] = False
        self._done_host[i] = True
        if self.kv_layout == "paged" and self._plans[i] is not None:
            self._alloc.release_plan(self._plans[i])
            self._plans[i] = None
            self._page_table[i] = 0

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
                self._clear_slot(i)
                out.append(req)
        return out

    def _admit(self):
        """Stage queued requests into free slots, FIFO: plan the slot's
        page mapping (prefix-shared pages + fresh privates, CoW copy at
        a mid-page divergence), write the prompt into the device-side
        buffer and flip the slot to prefill mode.  The unshared part of
        the prompt is consumed inside the next admission chunk.  Under
        pool pressure the queue head defers to a later boundary —
        unless nothing is running, which means the pool can never serve
        it: that raises."""
        free = [i for i in range(self.B) if self._slots[i] is None]
        while self._queue and free:
            req = self._queue[0]
            plan = None
            if self.kv_layout == "paged":
                ps = self.page_size
                covered_rows = min(len(req.prompt) + req.max_new_tokens
                                   + self._overshoot, self._cache_len)
                covered_pages = min(-(-covered_rows // ps),
                                    self.pages_per_slot)
                plan = self._alloc.admit(
                    req.prompt if self.prefix_sharing else req.prompt[:0],
                    covered_pages)
                if plan is None:
                    if self.active == 0:
                        raise RuntimeError(
                            f"KV pool ({self.num_pages - 1} usable pages of "
                            f"{ps} rows) cannot ever hold this request "
                            f"({covered_pages} pages); grow num_pages or "
                            f"shrink the request")
                    return
            self._queue.popleft()
            i = free.pop(0)
            self._slots[i] = req
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
                self._page_table[i] = torch.from_numpy(row).to(self.device)
                if plan.cow is not None:
                    # copy-on-write at the divergence boundary: clone
                    # the partially matched page into the slot's first
                    # private page, all layers, with every cache entry
                    # (an int8 pool's page scales too); admit() pinned
                    # the source until this copy — unpin it now
                    src, dst = plan.cow
                    for buf_ in self._cache.values():
                        buf_[dst].copy_(buf_[src])
                    self._alloc.release_page(src)
                start = plan.shared_tokens
            # prefix-shared tokens are already resident: prefill starts
            # at the divergence, or straight to decode when only the
            # final prompt token remains
            self._pos[i] = start
            self._pos_host[i] = start
            prefilling = start < len(req.prompt)
            self._mode[i] = prefilling
            self._mode_host[i] = prefilling

    # -- the step body ------------------------------------------------------
    def _step(self, C: int):
        """One [B, C] step (the reference's step_core).  Per slot:

          prefilling?  consume n = min(C, plen - pos) prompt tokens from
                       prompts[b, pos:pos+C]
          decoding?    feed [tok[b], pad...] (n = 1)
          free/done?   n = 0 (lanes run but nothing advances)

        Lanes past n write throwaway KV at pos+n..pos+C-1; queries only
        see rows <= pos+lane and the next step's valid lanes overwrite
        those rows before any query can reach them.  The logit at lane
        n-1 is argmax-sampled; a slot emits iff it decoded or consumed
        its final prompt chunk.  Updates the per-slot state in place
        and returns (emitted tokens [B] with -1 for none, prefill
        tokens, decode tokens) as device tensors."""
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
        if self.kv_layout == "paged":
            lg, _ = self.model.forward_cached_paged(x, self._cache,
                                                    self._page_table, pos)
        else:
            lg, _ = self.model.forward_cached(x, self._cache, pos)
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

    @torch.inference_mode()
    def _run_chunk(self, mixed: bool):
        C, K = (self.prefill_chunk, self.admit_steps) if mixed \
            else (1, self.chunk)
        kind = "admit" if mixed else "decode"
        t0 = time.perf_counter()
        toks, n_pref, n_dec = [], 0, 0
        for _ in range(K):
            t, p, d = self._step(C)
            toks.append(t)
            n_pref = n_pref + p
            n_dec = n_dec + d
        # ONE device-to-host transfer per chunk: the emitted tokens and
        # the state the host schedules on
        packed = torch.cat([
            torch.stack(toks, dim=1).reshape(-1).to(torch.int64),
            self._mode.to(torch.int64), self._done.to(torch.int64),
            self._pos.to(torch.int64), torch.stack([n_pref, n_dec])]).cpu()
        host = packed.numpy()
        B = self.B
        toks_h = host[: B * K].reshape(B, K)
        self._mode_host = host[B * K: B * K + B].astype(bool)
        self._done_host = host[B * K + B: B * K + 2 * B].astype(bool)
        self._pos_host = host[B * K + 2 * B: B * K + 3 * B].copy()
        self._prefill_tok_total += int(host[-2])
        self._decode_tok_total += int(host[-1])
        self._chunk_times[kind].append(time.perf_counter() - t0)
        self._chunk_count += 1
        self._chunk_kind_counts[kind] += 1
        self._forward_steps += K
        self._occupancy_total += self.active
        if self.kv_layout == "paged":
            # prompt pages that finished filling this chunk become
            # shareable for the NEXT admission
            for i, plan in enumerate(self._plans):
                if plan is not None and plan.nodes:
                    self._alloc.mark_progress(plan, int(self._pos_host[i]))
        t_harvest = time.monotonic()
        for i, req in enumerate(self._slots):
            if req is None:
                continue
            req.tokens.extend(int(t) for t in toks_h[i] if t >= 0)
            if req.t_first is None and req.tokens:
                req.t_first = t_harvest
