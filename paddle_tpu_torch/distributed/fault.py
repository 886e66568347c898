"""Deterministic, flag-gated fault injection.

Counterpart of `paddle_tpu/distributed/fault.py`: the same registry, spec
grammar (`parse_specs` :174), `Fault`, `FaultError` and `FaultSpecError`,
`is_active`, `reset`, `hit` (:240), `hit_counts`, `fired_counts` and
`scope` (:303), so one spec string plants the same failure in both
packages.  Left out: the telemetry a fired injection publishes (the
reference's `fault.fired` counter and `fault.hit` event, :270), because
the port has no telemetry plane yet.

Spec grammar (``FLAGS_fault_injection``)::

    spec      := point-spec (';' point-spec)*
    point-spec:= POINT (':' key '=' value)*
    POINT     := dotted name, e.g. serve.decode, ckpt.write
    keys      := step   — fire on the Nth hit of the point (1-based)
                 after  — fire on every hit > N
                 times  — how many firings total (default 1; '*' = all)
                 mode   — error | truncate | corrupt | nan | skip |
                          kill | delay   (default error)
                 match  — only hits whose key contains this substring
                 code   — process exit code for mode=kill (default 137)
                 secs   — sleep seconds for mode=delay (default 0.2)

Example: ``FLAGS_fault_injection="serve.decode:step=3:mode=error"``.

``hit`` handles the process-level modes itself (``error`` raises
:class:`FaultError`, ``kill`` calls ``os._exit``, ``delay`` sleeps) and
returns the :class:`Fault` for data modes (truncate/corrupt/nan/skip)
the call site must implement.  When ``FLAGS_fault_injection`` is unset
the whole machinery is a single cached-string comparison.

Determinism: hits are counted per point, only while a spec is armed,
and `reset()` (or re-arming a different spec) zeroes the counters.

`POINTS` is the reference's list, so every spec it accepts parses here.
The port's call sites are the serve plane's (inference/serving.py); keys
carry the request or slot a hit belongs to (``req<id>:<slo>`` /
``slot<i>:req<id>``) so `match=` can target one request:

    serve.admit       taking a queued request into a slot (error =
                      transient admission fault, retried FIFO-in-place;
                      skip = admission rejected, request shed)
    serve.kv_alloc    the KV page-pool allocation for one admission
                      (error = transient allocator fault -> FIFO defer;
                      a data mode = simulated pool exhaustion -> defer)
    serve.chunk       one chunk dispatch (error fires BEFORE the chunk's
                      first in-place write -> the chunk retries at the
                      next boundary; delay = hung chunk, seen by the
                      serve watchdog)
    serve.decode      per live slot after a chunk (error or a data mode
                      = that slot's decode is poisoned -> pages released,
                      request requeued or shed, the rest of the batch
                      keeps decoding)
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

from ..framework.flags import get_flag

__all__ = ["Fault", "FaultError", "FaultSpecError", "hit", "is_active",
           "reset", "scope", "parse_specs", "hit_counts", "fired_counts",
           "POINTS"]

# the documented injection points; hit() accepts only these so a typo'd
# spec or call site fails loudly instead of never firing
POINTS = ("ckpt.write", "ckpt.manifest", "ckpt.latest", "kv.request",
          "launch.heartbeat", "step.begin", "step.data",
          "serve.admit", "serve.kv_alloc", "serve.chunk",
          "serve.decode",
          "autoscale.decide", "autoscale.drain", "autoscale.reform")

MODES = ("error", "truncate", "corrupt", "nan", "skip", "kill", "delay")


class FaultError(IOError):
    """An injected fault (mode=error).  Subclasses IOError so IO retry
    paths classify it as transient."""


class FaultSpecError(ValueError):
    """Malformed FLAGS_fault_injection spec."""


class Fault:
    """One armed point-spec."""

    __slots__ = ("point", "step", "after", "times", "mode", "match",
                 "code", "secs", "fired")

    def __init__(self, point: str, step: int = 0, after: int = 0,
                 times: int = 1, mode: str = "error",
                 match: Optional[str] = None, code: int = 137,
                 secs: float = 0.2):
        if point not in POINTS:
            raise FaultSpecError(
                f"unknown injection point {point!r}; known: {POINTS}")
        if mode not in MODES:
            raise FaultSpecError(
                f"unknown mode {mode!r} for {point}; known: {MODES}")
        self.point = point
        self.step = int(step)
        self.after = int(after)
        self.times = times          # -1 = unlimited
        self.mode = mode
        self.match = match
        self.code = int(code)
        self.secs = float(secs)
        self.fired = 0

    def _wants(self, n_hit: int, key: Optional[str]) -> bool:
        if self.times >= 0 and self.fired >= self.times:
            return False
        if self.match is not None and (key is None
                                       or self.match not in str(key)):
            return False
        if self.step:
            # fire from the Nth hit on; `times` caps the total, so
            # step=3:times=2 fires at hits 3 and 4
            return n_hit >= self.step
        if self.after:
            return n_hit > self.after
        return True

    def __repr__(self):
        return (f"Fault({self.point}:mode={self.mode}:step={self.step}"
                f":times={self.times}:fired={self.fired})")


def parse_specs(raw: str) -> List[Fault]:
    """Parse a FLAGS_fault_injection string into Fault objects."""
    out = []
    for part in raw.split(";"):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        point, kw = fields[0].strip(), {}
        for f in fields[1:]:
            k, eq, v = f.partition("=")
            if not eq:
                raise FaultSpecError(
                    f"bad field {f!r} in spec {part!r} (want key=value)")
            k = k.strip()
            v = v.strip()
            if k in ("step", "after", "code"):
                kw[k] = int(v)
            elif k == "times":
                kw[k] = -1 if v == "*" else int(v)
            elif k == "secs":
                kw[k] = float(v)
            elif k in ("mode", "match"):
                kw[k] = v
            else:
                raise FaultSpecError(
                    f"unknown key {k!r} in spec {part!r}")
        out.append(Fault(point, **kw))
    return out


# -- registry state ---------------------------------------------------------
_lock = threading.Lock()
_raw_cache: str = ""            # last seen flag value
_armed: Optional[List[Fault]] = None
_hits: Dict[str, int] = {}      # per-point hit counters (armed only)


def _sync() -> Optional[List[Fault]]:
    """Re-parse iff the flag string changed (the unset fast path is one
    string compare + None return — no parsing, no locking)."""
    global _raw_cache, _armed
    raw = get_flag("fault_injection") or ""
    if raw == _raw_cache:
        return _armed
    with _lock:
        if raw != _raw_cache:
            _armed = parse_specs(raw) if raw else None
            _raw_cache = raw
            _hits.clear()
    return _armed


def is_active() -> bool:
    return _sync() is not None


def reset():
    """Zero the hit counters and re-arm the current flag value."""
    global _raw_cache
    with _lock:
        _raw_cache = "\0invalidated"   # force re-parse on next _sync
        _hits.clear()
    _sync()


def hit(point: str, key: Optional[str] = None) -> Optional[Fault]:
    """Record one hit of `point`; fire any matching armed spec.

    Returns None when nothing fires (always when FLAGS_fault_injection
    is unset).  Process-level modes act here: mode=error raises
    FaultError, mode=kill exits the process (`os._exit(code)`),
    mode=delay sleeps `secs`.  Data modes (truncate/corrupt/nan/skip)
    return the Fault for the call site to apply."""
    armed = _sync()
    if armed is None:
        return None
    if point not in POINTS:     # not an assert: must survive python -O
        raise FaultSpecError(
            f"unregistered injection point {point!r}; known: {POINTS}")
    with _lock:
        n = _hits.get(point, 0) + 1
        _hits[point] = n
        live = None
        for f in armed:
            if f.point == point and f._wants(n, key):
                f.fired += 1
                live = f
                break
    if live is None:
        return None
    if live.mode == "error":
        raise FaultError(
            f"injected fault at {point} (hit {n}, key={key!r})")
    if live.mode == "kill":
        os._exit(live.code)
    if live.mode == "delay":
        time.sleep(live.secs)
        return None
    return live


def hit_counts() -> Dict[str, int]:
    """Per-point hit counters (armed periods only)."""
    with _lock:
        return dict(_hits)


def fired_counts() -> Dict[str, int]:
    """point -> total firings of the currently armed specs."""
    armed = _sync() or []
    out: Dict[str, int] = {}
    for f in armed:
        out[f.point] = out.get(f.point, 0) + f.fired
    return out


class scope:
    """Arm a spec for a `with` block (tests): sets
    FLAGS_fault_injection, resets counters, restores the previous value
    (and zeroes the counters again) on exit."""

    def __init__(self, spec: str):
        self._spec = spec
        self._prev = None

    def __enter__(self):
        from ..framework.flags import set_flags
        self._prev = get_flag("fault_injection") or ""
        set_flags({"FLAGS_fault_injection": self._spec})
        reset()
        return self

    def __exit__(self, *exc):
        from ..framework.flags import set_flags
        set_flags({"FLAGS_fault_injection": self._prev})
        reset()
        return False
