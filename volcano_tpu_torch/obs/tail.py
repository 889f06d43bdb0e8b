"""Tail-based trace retention — keep/drop decided at trace completion.

A copy of ``volcano_tpu/obs/tail.py``.

Head sampling (obs/channel.py) flips the coin at emission: an
anomalously slow trace is kept or dropped by the same hash as a fast
one, which is exactly backwards during an SLO breach.  This module
moves the decision to *trace completion*: spans of undecided traces
buffer in a bounded per-trace pending pool, and when the trace settles
(its root span has landed and no new span arrived for a settle
interval) the whole trace is kept if

* any span carried an ``error`` / ``fallback`` / ``degraded`` tag, or
* any span's duration breached its per-kind latency threshold — seeded
  from the windowed p99 of same-named spans (``factor ×`` the p99,
  floored), not a constant, or
* a cluster capture boost is active (obs/incident.py),

and otherwise falls back to the existing trace-id hash coin, so steady
traffic still samples at the configured rate.

Invariants inherited from the channel:

* **drop-not-block** — every entry point is a bounded lock-protected
  dict/deque operation; pool overflow and never-completed traces fall
  back to the head decision and count
  ``volcano_telemetry_tail_evictions_total{reason}``.
* **keep-or-drop-whole-traces** — the coin is a pure function of the
  trace id (every process agrees without coordination) and the only
  uncoordinated deviation is toward KEEP on local anomaly evidence;
  completion-time decisions are *published* through the segment
  channel (``vtpu-tail-<identity>`` objects) so late-arriving child
  spans on other processes resolve identically.

The sampler never touches the bus itself: the exporter's flusher calls
:meth:`sweep`, ships :meth:`drain_decisions`, and feeds peer records
back through :meth:`apply_remote`.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional

from volcano_tpu_torch import metrics

#: span-arg keys whose presence marks the whole trace anomalous
ANOMALY_ARGS = ("error", "fallback", "degraded")


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class TailConfig:
    """Knobs, each overridable by env (the daemon-flag-free path)."""

    def __init__(
        self,
        max_traces: int = 256,
        max_spans_per_trace: int = 512,
        settle_s: float = 0.25,
        pending_timeout_s: float = 15.0,
        floor_ms: float = 25.0,
        p99_factor: float = 4.0,
        min_kind_samples: int = 64,
        duration_window: int = 512,
        decision_memo: int = 8192,
    ):
        self.max_traces = int(_env_float("VTPU_TAIL_MAX_TRACES", max_traces))
        self.max_spans_per_trace = int(_env_float(
            "VTPU_TAIL_MAX_SPANS", max_spans_per_trace))
        self.settle_s = _env_float("VTPU_TAIL_SETTLE", settle_s)
        self.pending_timeout_s = _env_float(
            "VTPU_TAIL_TIMEOUT", pending_timeout_s)
        self.floor_ms = _env_float("VTPU_TAIL_FLOOR_MS", floor_ms)
        self.p99_factor = _env_float("VTPU_TAIL_FACTOR", p99_factor)
        self.min_kind_samples = int(_env_float(
            "VTPU_TAIL_MIN_SAMPLES", min_kind_samples))
        self.duration_window = max(16, duration_window)
        self.decision_memo = max(64, decision_memo)


class _Pending:
    """One undecided trace's buffered spans."""

    __slots__ = ("spans", "root_done", "first", "last")

    def __init__(self, now: float):
        self.spans: List[dict] = []
        self.root_done = False
        self.first = now
        self.last = now


class TailSampler:
    """Per-process pending pool + per-kind latency thresholds +
    decision memo for one :class:`~volcano_tpu_torch.obs.channel.SpanExporter`.

    ``coin`` is the head-sampling fallback (a pure function of the
    trace id, shared with the exporter so the configured rate means the
    same thing in both modes)."""

    def __init__(self, coin, config: Optional[TailConfig] = None):
        self.coin = coin
        self.cfg = config or TailConfig()
        self._lock = threading.Lock()
        with self._lock:
            #: tid → _Pending, oldest-first (eviction order)
            self._pending: "OrderedDict[str, _Pending]" = OrderedDict()  # guarded-by: self._lock
            #: tid → kept?  bounded memo of settled decisions
            self._decided: "OrderedDict[str, bool]" = OrderedDict()  # guarded-by: self._lock
            #: locally-made decisions awaiting publication
            self._outbox: Dict[str, bool] = {}  # guarded-by: self._lock
            #: span name → recent durations (µs), the p99 seed window
            self._durs: Dict[str, deque] = {}  # guarded-by: self._lock
            #: span name → (threshold_us, observations at compute time)
            self._thr: Dict[str, tuple] = {}  # guarded-by: self._lock
            #: name → total observations (amortizes threshold recompute)
            self._obs: Dict[str, int] = {}  # guarded-by: self._lock
            # test/observability counters
            self.kept_traces = 0  # guarded-by: self._lock
            self.dropped_traces = 0  # guarded-by: self._lock
            self.evicted_traces = 0  # guarded-by: self._lock
            self.anomaly_keeps = 0  # guarded-by: self._lock

    # ---- emission path (exporter.emit's thread — bounded work only) ----

    def keep(self, trace_id: str) -> bool:
        """Span-creation gate: only a memoized DROP suppresses span
        recording; undecided traces record and buffer."""
        with self._lock:
            decided = self._decided.get(trace_id)
        return decided is not False

    def offer(self, record: dict) -> List[dict]:
        """Route one emitted span.  Returns the records now ready for
        the export ring (possibly this trace's whole buffer, when this
        span's evidence decides it).  Empty trace ids never reach here
        (the exporter rings them directly)."""
        rooted = bool(record.pop("_root", False))
        tid = record.get("t", "")
        out: List[dict] = []
        evictions: List[str] = []
        decide_publish: Optional[bool] = None
        with self._lock:
            threshold_us = self._observe_duration(
                record.get("name", ""), float(record.get("dur", 0.0)))
            decided = self._decided.get(tid)
            if decided is True:
                return [record]
            if decided is False:
                return []
            anomalous = self._is_anomalous(record, threshold_us)
            pend = self._pending.get(tid)
            if pend is None:
                out.extend(self._evict_for_room_locked(evictions))
                pend = _Pending(time.monotonic())
                self._pending[tid] = pend
            pend.last = time.monotonic()
            pend.root_done = pend.root_done or rooted
            if anomalous:
                # decide KEEP immediately — any process holding the
                # anomalous span may decide; peers converge through the
                # published decision
                self.anomaly_keeps += 1
                pend.spans.append(record)
                out.extend(self._settle_locked(tid, True))
                decide_publish = True
            elif len(pend.spans) >= self.cfg.max_spans_per_trace:
                # a runaway trace cannot hold the pool hostage: fall
                # back to the head decision for the whole trace
                pend.spans.append(record)
                out.extend(self._evict_locked(tid, "pool-full", evictions))
            else:
                pend.spans.append(record)
        for reason in evictions:
            metrics.register_telemetry_tail_eviction(reason)
        if decide_publish is not None:
            metrics.register_telemetry_tail_decision(
                "keep" if decide_publish else "drop")
        return out

    # ---- flusher path (the exporter's background thread) ----

    def sweep(self, boost: bool = False) -> List[dict]:
        """Settle what's ready: under a capture boost everything
        pending is kept; otherwise traces whose root has landed and
        that have been quiet for ``settle_s`` take the completion-time
        decision, and rootless traces older than ``pending_timeout_s``
        fall back to the head decision (reason ``timeout``)."""
        now = time.monotonic()
        out: List[dict] = []
        evictions: List[str] = []
        kept = dropped = 0
        with self._lock:
            for tid in list(self._pending):
                pend = self._pending[tid]
                if boost:
                    out.extend(self._settle_locked(tid, True))
                    kept += 1
                elif pend.root_done and now - pend.last >= self.cfg.settle_s:
                    decision = bool(self.coin(tid))
                    records = self._settle_locked(tid, decision)
                    out.extend(records)
                    kept, dropped = (
                        (kept + 1, dropped) if decision
                        else (kept, dropped + 1)
                    )
                elif now - pend.first >= self.cfg.pending_timeout_s:
                    out.extend(self._evict_locked(tid, "timeout", evictions))
        for reason in evictions:
            metrics.register_telemetry_tail_eviction(reason)
        for _ in range(kept):
            metrics.register_telemetry_tail_decision("keep")
        for _ in range(dropped):
            metrics.register_telemetry_tail_decision("drop")
        return out

    def drain_decisions(self) -> Dict[str, bool]:
        """Locally-made decisions not yet published (flusher ships
        them as the ``vtpu-tail-<identity>`` object)."""
        with self._lock:
            if not self._outbox:
                return {}
            out, self._outbox = self._outbox, {}
        return out

    def apply_remote(self, decisions: Dict[str, bool]) -> List[dict]:
        """A peer's published completion-time decisions: memoize them
        and resolve any locally-pending spans of those traces the same
        way.  Remote decisions are not re-published (no echo storm)."""
        out: List[dict] = []
        with self._lock:
            for tid, keep in decisions.items():
                keep = bool(keep)
                local = self._decided.get(tid)
                if local is not None:
                    # local anomaly KEEP beats a remote coin DROP: the
                    # deviation is only ever toward keeping evidence
                    if local or not keep:
                        continue
                self._memoize_locked(tid, keep, publish=False)
                pend = self._pending.pop(tid, None)
                if pend is not None:
                    if keep:
                        out.extend(pend.spans)
                    self._count_locked(keep)
        return out

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    # ---- internals (all require self._lock held) ----

    def _observe_duration(self, name: str, dur_us: float) -> float:
        # requires-lock: self._lock
        window = self._durs.get(name)
        if window is None:
            window = self._durs[name] = deque(
                maxlen=self.cfg.duration_window)
        window.append(dur_us)
        n = self._obs.get(name, 0) + 1
        self._obs[name] = n
        cached = self._thr.get(name)
        if cached is not None and n - cached[1] < 32:
            return cached[0]
        floor_us = self.cfg.floor_ms * 1e3
        if n < self.cfg.min_kind_samples:
            threshold_us = floor_us
        else:
            ordered = sorted(window)
            p99 = ordered[min(len(ordered) - 1, int(len(ordered) * 0.99))]
            threshold_us = max(floor_us, self.cfg.p99_factor * p99)
        self._thr[name] = (threshold_us, n)
        return threshold_us

    def _is_anomalous(self, record: dict, threshold_us: float) -> bool:
        # requires-lock: self._lock
        args = record.get("args") or {}
        for key in ANOMALY_ARGS:
            if key in args:
                return True
        return float(record.get("dur", 0.0)) > threshold_us

    def _settle_locked(self, tid: str, keep: bool) -> List[dict]:
        # requires-lock: self._lock
        self._memoize_locked(tid, keep, publish=True)
        pend = self._pending.pop(tid, None)
        spans = pend.spans if pend is not None else []
        self._count_locked(keep)
        return spans if keep else []

    def _evict_locked(
        self, tid: str, reason: str, evictions: List[str]
    ) -> List[dict]:
        """Fall back to the head decision for one pending trace.
        reason ∈ {pool-full, timeout} — the counter's vocabulary; the
        caller counts the collected reasons after the lock drops."""
        # requires-lock: self._lock
        keep = bool(self.coin(tid))
        self._memoize_locked(tid, keep, publish=True)
        pend = self._pending.pop(tid, None)
        self.evicted_traces += 1
        self._count_locked(keep)
        evictions.append(reason)
        if pend is None or not keep:
            return []
        return pend.spans

    def _evict_for_room_locked(self, evictions: List[str]) -> List[dict]:
        # requires-lock: self._lock
        out: List[dict] = []
        while len(self._pending) >= self.cfg.max_traces:
            oldest = next(iter(self._pending))
            out.extend(self._evict_locked(oldest, "pool-full", evictions))
        return out

    def _memoize_locked(self, tid: str, keep: bool, publish: bool) -> None:
        # requires-lock: self._lock
        self._decided[tid] = keep
        self._decided.move_to_end(tid)
        while len(self._decided) > self.cfg.decision_memo:
            self._decided.popitem(last=False)
        if publish:
            self._outbox[tid] = keep

    def _count_locked(self, keep: bool) -> None:
        # requires-lock: self._lock
        if keep:
            self.kept_traces += 1
        else:
            self.dropped_traces += 1
