"""SIGTERM drain protocol.

Counterpart of the drain part of `paddle_tpu/distributed/guard.py`
(:162-205): `install_sigterm_drain`, `drain_requested`, `request_drain`
and `clear_drain`.  A SIGTERM sets a process-wide flag instead of killing
the process; the serving batcher reads it at every scheduling round
(inference/serving.py: admissions close, in-flight decodes finish within
PADDLE_DRAIN_GRACE, then partial results are flushed).  The reference's
`StepAnomalyGuard` and elastic helpers are not ported yet.  One
difference: the reference swallows an error of a chained earlier
SIGTERM handler; here it propagates (this package holds no `try` that
could hide a failure).
"""
from __future__ import annotations

import signal
import threading

__all__ = ["install_sigterm_drain", "drain_requested", "request_drain",
           "clear_drain"]

_drain = threading.Event()
_prev_handler = None
_installed = False


def _on_sigterm(signum, frame):
    _drain.set()
    # chain a previously installed Python-level handler, but never the
    # default action: the point is to NOT die mid-step
    if callable(_prev_handler):
        _prev_handler(signum, frame)


def install_sigterm_drain() -> bool:
    """Install the SIGTERM -> drain-flag handler (idempotent).  Returns
    False off the main thread, where no signal handler can be set —
    callers treat that as 'no drain protocol available'."""
    global _prev_handler, _installed
    if _installed:
        return True
    if threading.current_thread() is not threading.main_thread():
        return False
    prev = signal.signal(signal.SIGTERM, _on_sigterm)
    if prev not in (signal.SIG_DFL, signal.SIG_IGN, None):
        _prev_handler = prev
    _installed = True
    return True


def drain_requested() -> bool:
    """True once SIGTERM arrived (or request_drain was called)."""
    return _drain.is_set()


def request_drain():
    """Set the drain flag directly (what the SIGTERM handler does) — for
    tests and tooling that trigger the drain protocol without a real
    signal."""
    _drain.set()


def clear_drain():
    _drain.clear()
