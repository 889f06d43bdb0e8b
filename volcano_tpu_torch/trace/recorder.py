"""Cycle trace recorder — span/event capture keyed by a monotonically
increasing cycle id.  A copy of ``volcano_tpu/trace/recorder.py``.

The scheduler loop opens a cycle per ``run_once``; framework, actions and
ops emit spans (timed regions) and instant events into the recorder, and
session mutating ops emit the cycle's *decision set* (bind / pipeline /
evict / dispatch tuples).  At ``end_cycle`` the assembled record is kept
in memory (``last_cycle``) and appended to the journal when one is
attached.

Zero-cost when disabled: the module-level default is a ``NullRecorder``
whose methods are empty and whose ``enabled`` flag lets hot paths skip
argument construction entirely (``if rec.enabled: ...``).  The enabled
recorder buffers plain dicts in memory — no I/O inside the cycle except
the sampled snapshot capture.

Timestamps are ``time.perf_counter`` microseconds relative to the
recorder's epoch, the unit Chrome's ``trace_event`` format expects
(trace/export.py).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional


class _NullSpan:
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class NullRecorder:
    """No-op recorder — the disabled default.  Every method is empty and
    allocation-free so instrumented hot paths cost one attribute access."""

    enabled = False

    def begin_cycle(self) -> int:
        return -1

    def end_cycle(self, duration_s: float = 0.0) -> None:
        pass

    def event(self, name: str, cat: str = "event", **args) -> None:
        pass

    def span(self, name: str, cat: str = "span", **args) -> _NullSpan:
        return _NULL_SPAN

    def complete(
        self, name: str, cat: str, start_perf: float, duration_s: float, **args
    ) -> None:
        pass

    def decision(
        self, kind: str, task: str, node: str = "", reason: str = ""
    ) -> None:
        pass

    def should_capture(self) -> bool:
        return False

    def capture(
        self, snap, assignment, executor: str = "",
        weights=None, gang_rounds=None,
    ) -> None:
        pass

    def last_cycle(self) -> Optional[Dict[str, Any]]:
        return None


class _Span:
    """Context manager emitting one Chrome-style complete ("X") event."""

    __slots__ = ("_rec", "_name", "_cat", "_args", "_t0")

    def __init__(self, rec: "TraceRecorder", name: str, cat: str, args):
        self._rec = rec
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self._rec.complete(
            self._name,
            self._cat,
            self._t0,
            time.perf_counter() - self._t0,
            **(self._args or {}),
        )
        return False


class TraceRecorder:
    """Thread-safe span/event recorder with per-cycle assembly.

    ``journal`` (trace/journal.py) persists completed cycles; without one
    the recorder still serves ``last_cycle`` (the ``/trace/last``
    endpoint).  ``snapshot_every=N`` samples a PackedSnapshot + kernel
    assignment capture every Nth cycle (N=1 captures every cycle, 0
    never) — snapshot capture is the only potentially heavy step, hence
    the knob.
    """

    enabled = True

    #: per-cycle event cap — bounds memory when events are emitted by a
    #: process that never runs the scheduler loop (e.g. the compute-plane
    #: sidecar dispatching kernels per request): without begin/end_cycle
    #: the buffer would otherwise grow forever.  Excess events are
    #: dropped and counted in the cycle record's ``n_dropped``.
    max_events_per_cycle = 100_000

    def __init__(self, journal=None, snapshot_every: int = 0):
        self._lock = threading.Lock()
        self.journal = journal
        self.snapshot_every = snapshot_every
        self._epoch = time.perf_counter()
        self._cycle_id = -1  # guarded-by: self._lock
        if journal is not None:
            # resume after the journal's newest cycle: recording into a
            # non-empty directory must append, not interleave new cycles
            # with stale same-numbered ones (replay picks the newest
            # snapshot, which would otherwise be a previous run's).
            # Snapshot cycles count too — a crash between snapshot
            # capture and end_cycle leaves an orphan .npz whose id must
            # not be reused under a new run's event log.
            ids = journal.cycles() + journal.snapshot_cycles()
            if ids:
                self._cycle_id = max(ids)
        self._cycle_start_us = 0.0  # guarded-by: self._lock
        self._events: List[Dict[str, Any]] = []  # guarded-by: self._lock
        self._decisions: List[Dict[str, str]] = []  # guarded-by: self._lock
        self._dropped = 0  # guarded-by: self._lock
        self._last: Optional[Dict[str, Any]] = None

    # ---- time base ----

    def _to_us(self, perf_t: float) -> float:
        return (perf_t - self._epoch) * 1e6

    def now_us(self) -> float:
        return self._to_us(time.perf_counter())

    # ---- cycle lifecycle ----

    def begin_cycle(self) -> int:
        with self._lock:
            self._cycle_id += 1
            self._events = []
            self._decisions = []
            self._dropped = 0
            self._cycle_start_us = self.now_us()
            return self._cycle_id

    def end_cycle(self, duration_s: float = 0.0) -> None:
        with self._lock:
            record = {
                "cycle": self._cycle_id,
                "start_us": self._cycle_start_us,
                "duration_ms": duration_s * 1e3,
                "wall_time": time.time(),  # det: journal timestamp, never replayed
                "events": self._events,
                "decisions": self._decisions,
            }
            if self._dropped:
                record["n_dropped"] = self._dropped
            self._events = []
            self._decisions = []
            self._dropped = 0
        self._last = record
        if self.journal is not None:
            try:
                self.journal.write_cycle(record)
            except Exception:  # noqa: BLE001 — deliberate broad guard
                # forensics must never break scheduling: a full disk,
                # deleted journal dir, or an unserializable event arg
                # costs the record, not the cycle
                logging.getLogger(__name__).warning(
                    "trace journal write failed for cycle %d",
                    record["cycle"],
                    exc_info=True,
                )

    @property
    def cycle_id(self) -> int:
        with self._lock:
            return self._cycle_id

    # ---- emission ----

    def event(self, name: str, cat: str = "event", **args) -> None:
        e = {"name": name, "cat": cat, "ph": "i", "ts": self.now_us(),
             "tid": threading.get_ident()}
        if args:
            e["args"] = args
        self._append(e)

    def span(self, name: str, cat: str = "span", **args) -> _Span:
        return _Span(self, name, cat, args)

    def complete(
        self, name: str, cat: str, start_perf: float, duration_s: float, **args
    ) -> None:
        """Record an already-timed region: ``start_perf`` is the
        ``time.perf_counter`` value at region start.  Lets call sites
        reuse timings they already measure for metrics instead of timing
        twice."""
        e = {
            "name": name,
            "cat": cat,
            "ph": "X",
            "ts": self._to_us(start_perf),
            "dur": duration_s * 1e6,
            "tid": threading.get_ident(),
        }
        if args:
            e["args"] = args
        self._append(e)

    def _append(self, e: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._events) >= self.max_events_per_cycle:
                self._dropped += 1
                return
            self._events.append(e)

    def decision(
        self, kind: str, task: str, node: str = "", reason: str = ""
    ) -> None:
        """kind ∈ {allocate, bind, pipeline, evict} — the audit tuple the
        replayer diffs against.  "bind" is emitted exactly once per
        actual cache bind (Session.dispatch, Statement commit,
        fast-apply batch); "allocate" is the session-level placement
        that precedes it.  ``ts`` lets the Chrome export place the
        instant next to the span that produced it."""
        d = {"kind": kind, "task": task, "node": node, "ts": self.now_us()}
        if reason:
            d["reason"] = reason
        with self._lock:
            # same bound as _append: decisions must not grow without
            # limit either when no cycle loop is draining them
            if len(self._decisions) >= self.max_events_per_cycle:
                self._dropped += 1
                return
            self._decisions.append(d)

    # ---- snapshot capture (sampled) ----

    def should_capture(self) -> bool:
        # one locked read of the cycle id — the raw double-read raced
        # begin_cycle on another thread (lock-discipline lint catch)
        cid = self.cycle_id
        return (
            self.journal is not None
            and self.snapshot_every > 0
            and cid >= 0
            and cid % self.snapshot_every == 0
        )

    def capture(
        self, snap, assignment, executor: str = "",
        weights=None, gang_rounds=None,
    ) -> None:
        """Persist the packed session + kernel assignment for the current
        cycle when the sampling knob says so.  ``weights`` /
        ``gang_rounds`` record the kernel parameters the assignment was
        computed with, so replay re-runs the exact same configuration."""
        if not self.should_capture():
            return
        cid = self.cycle_id
        try:
            self.journal.write_snapshot(
                cid, snap, assignment, executor,
                weights=weights, gang_rounds=gang_rounds,
            )
        except Exception:  # noqa: BLE001 — deliberate broad guard
            # same invariant as end_cycle: forensics must never break
            # scheduling — this runs inside the allocate action
            logging.getLogger(__name__).warning(
                "trace snapshot capture failed for cycle %d",
                cid,
                exc_info=True,
            )
            return
        self.event("snapshot-capture", "journal", executor=executor)

    def last_cycle(self) -> Optional[Dict[str, Any]]:
        return self._last
