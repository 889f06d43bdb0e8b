"""Cycle watchdog: a wall-clock budget for the device phase.

A copy of ``volcano_tpu/faults/watchdog.py`` for the port.  A deadline
armed with :func:`configure_deadline` and stamped per cycle by
:func:`begin_cycle` bounds a call run through :func:`run_with_deadline`:
an overrun raises :class:`CycleDeadlineExceeded`, and the caller
completes its cycle another way.

The overrunning computation itself cannot be interrupted (a launched
kernel is not cancellable from Python); it is *abandoned* on a daemon
worker thread and its result discarded.  Code on the worker checks
:func:`abandoned` to stop mutating shared state (breakers, failure
counters, last-executor notes) for a cycle already completed.

Disabled (the default) costs nothing: ``remaining_s`` returns None and
``run_with_deadline`` calls the function inline — no thread, no timer.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional


class CycleDeadlineExceeded(RuntimeError):
    """The device phase overran the cycle deadline."""


_deadline_s: Optional[float] = None  # guarded-by: _lock
_cycle_start: Optional[float] = None  # guarded-by: _lock
_lock = threading.Lock()


def configure_deadline(ms: Optional[float]) -> None:
    """Arm (or, with None/0, disarm) the per-cycle deadline."""
    global _deadline_s, _cycle_start
    with _lock:
        _deadline_s = ms / 1e3 if ms else None
        _cycle_start = None


def begin_cycle() -> None:
    """Stamp the cycle start.  No-op when disarmed."""
    global _cycle_start
    if _deadline_s is not None:
        with _lock:
            _cycle_start = time.monotonic()


def deadline_s() -> Optional[float]:
    with _lock:
        return _deadline_s


def remaining_s() -> Optional[float]:
    """Budget left in this cycle; None = no deadline armed.  Before the
    first begin_cycle (e.g. a bare session outside the daemon loop) the
    full deadline applies — a deadline armed must always bound the
    device phase."""
    with _lock:
        if _deadline_s is None:
            return None
        if _cycle_start is None:
            return _deadline_s
        return max(0.0, _deadline_s - (time.monotonic() - _cycle_start))


_worker_state = threading.local()


def abandoned() -> bool:
    """True on a watchdog worker thread whose caller already gave up on
    it.  Long-running code on the worker (the dispatcher's breaker
    guard) checks this to stop doing work — and, critically, to stop
    MUTATING global state (breakers, failure counters, last-executor
    notes) — for a cycle that its caller has already completed without
    it; an abandoned worker racing those writes against the next live
    cycle would poison its records and duplicate device work."""
    ev = getattr(_worker_state, "event", None)
    return ev is not None and ev.is_set()


def run_with_deadline(fn: Callable, timeout_s: Optional[float], what: str):
    """Run ``fn()`` bounded by ``timeout_s``.  None runs inline (no
    watchdog).  On overrun the worker is abandoned (daemon thread, its
    eventual result discarded, its abandon token set — see
    :func:`abandoned`) and :class:`CycleDeadlineExceeded` raises; an
    exception from ``fn`` re-raises here."""
    if timeout_s is None:
        return fn()
    if timeout_s <= 0:
        raise CycleDeadlineExceeded(f"{what}: cycle budget already exhausted")
    box = {}
    done = threading.Event()
    abandon = threading.Event()

    def work():
        _worker_state.event = abandon
        try:
            box["result"] = fn()
        except BaseException as e:  # noqa: BLE001 — relayed to the caller
            box["error"] = e
        finally:
            done.set()

    t = threading.Thread(target=work, name=f"vtpu-watchdog-{what}",
                         daemon=True)
    t.start()
    if not done.wait(timeout_s):
        abandon.set()
        raise CycleDeadlineExceeded(
            f"{what} exceeded the cycle deadline ({timeout_s * 1e3:.0f} ms "
            "remaining); the caller completes the cycle without it"
        )
    if "error" in box:
        raise box["error"]
    return box["result"]
