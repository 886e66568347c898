"""Host-side hang watchdog.

Counterpart of the `watched` guard of `paddle_tpu/distributed/watchdog.py`
(:192-229) and what it needs: a deadline timer for each entry,
`last_reported`, and on expiry a report of every Python thread's stack
and the card's allocated memory — or, under FLAGS_comm_watchdog_abort,
a stack dump and a process abort.  FLAGS_stop_check_timeout (seconds, 0
= off) arms it.  The reference's `CommTaskManager` ages every task on one
polling thread; here each entry arms a `threading.Timer` of its own that
its exit cancels.  The rest of `CommTaskManager` (collective tasks,
`active_tasks`, `on_timeout`) is not ported yet.

A device is asynchronous: a guarded block must end in a synchronising
step (a device-to-host copy, a `synchronize`) or a hung kernel would
never keep the block in flight.
"""
from __future__ import annotations

import faulthandler
import io
import os
import sys
import threading
import time
import traceback
from typing import List, Optional, Tuple

from ..framework.flags import get_flag

__all__ = ["watched", "timeout_log"]

# (task name, seconds in flight, report) of every expiry in this process
timeout_log: List[Tuple[str, float, str]] = []


class _Task:
    """One guarded entry in flight."""

    __slots__ = ("name", "started", "reported", "timer")

    def __init__(self, name: str, timeout: float):
        self.name = name
        self.started = time.monotonic()
        self.reported = False
        self.timer = threading.Timer(timeout, _expire, (self,))
        self.timer.daemon = True
        self.timer.start()


def _report(task: _Task, age: float) -> str:
    buf = io.StringIO()
    buf.write(f"\n[comm-watchdog] task '{task.name}' exceeded its "
              f"deadline ({age:.1f}s in flight)\n")
    buf.write("[comm-watchdog] python thread stacks:\n")
    for tid, frame in sys._current_frames().items():
        buf.write(f"--- thread {tid} ---\n")
        buf.write("".join(traceback.format_stack(frame)))
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        buf.write(f"[comm-watchdog] CUDA memory allocated: "
                  f"{torch.cuda.memory_allocated() / 1e9:.2f} GB\n")
    return buf.getvalue()


def _expire(task: _Task):
    """The timer fired while the entry was still in flight."""
    task.reported = True
    age = time.monotonic() - task.started
    report = _report(task, age)
    timeout_log.append((task.name, age, report))
    if get_flag("comm_watchdog_abort"):
        # the reference's abort path: dump every thread to stderr at
        # the file-descriptor level, then abort the process
        faulthandler.dump_traceback(all_threads=True)
        os.abort()
    sys.stderr.write(report)
    sys.stderr.flush()


class watched:
    """Guard a host-side suspension point:

        with watched("serve.chunk"):
            ...dispatch, then the synchronising transfer...

    No-op unless FLAGS_stop_check_timeout > 0 or `timeout` is given.
    Reentrant: nested entries keep a stack of tasks.  A body that raises
    still cancels its timer.

    `last_reported` says whether the most recently EXITED body aged past
    its deadline while in flight (the serving batcher counts these as
    hung chunks); every entry resets it."""

    def __init__(self, name: str, timeout: Optional[float] = None):
        self.name = name
        self.timeout = timeout
        self._stack: List[Optional[_Task]] = []
        self.last_reported = False

    def __enter__(self):
        self.last_reported = False
        t = self.timeout if self.timeout is not None \
            else float(get_flag("stop_check_timeout") or 0)
        self._stack.append(_Task(self.name, t) if t > 0 else None)
        return self

    def __exit__(self, *exc):
        task = self._stack.pop() if self._stack else None
        if task is not None:
            task.timer.cancel()
            self.last_reported = task.reported
        return False
