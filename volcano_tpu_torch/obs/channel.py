"""The telemetry bus channel — span batches as low-priority bus objects.

A copy of ``volcano_tpu/obs/channel.py``: segment payloads are
byte-equal to the JAX exporter's for the same records, so either
package's collector reads the other's segments.

Spans are forensics, not control state, so the channel's one invariant
is **drop-not-block**: emission is a bounded in-memory ring append
(never a lock the scheduler contends, never I/O), and a background
flusher ships batches to the bus on its own clock.  When the ring is
full, or the bus is down, or the store refuses the write, spans are
*dropped and counted* (``volcano_telemetry_dropped_total{reason}``) —
telemetry must never sit on the store lock or the commit path, and a
cycle with the flight recorder on binds exactly what it binds with it
off.

Segments land as ConfigMap objects in the ``volcano-telemetry``
namespace, one bounded ring of ``segments`` slots per daemon
(``vtpu-spans-<identity>-<slot>``), so the apiserver's existing
store *is* the collector: spans survive daemon death up to the last
flush, follow the leader across failover, and are readable by ``vtctl
trace`` from any client of the bus.  Retention is
honest and bounded: slot ``seq % segments`` overwrites the oldest
batch, so a daemon retains its most recent ``segments × batch`` spans
and no more.

Sampling is by **trace_id** (the Dapper discipline): a trace is kept
or dropped whole, identically in every process, because the decision
hashes the id itself.  Default sample rate comes from
``VTPU_TELEMETRY_SAMPLE`` (1.0 = keep everything).

Two retention layers sit on top of the head coin:

* **tail mode** (``VTPU_TELEMETRY_TAIL=1`` / ``enable(..., tail=True)``)
  routes identity-keyed spans through :class:`obs.tail.TailSampler` —
  keep/drop moves to trace completion, anomalous traces are force-kept,
  and completion-time decisions publish as ``vtpu-tail-<identity>``
  objects so peers resolve late-arriving child spans identically;
* a cluster **capture boost** (``vtpu-capture-boost``, CAS'd by
  obs/incident.py) that every flusher polls ~once a second: while the
  TTL-bounded record is live the effective sample rate is 1.0
  everywhere, so the fleet converges on full-fidelity capture within
  one heartbeat of the first breach.
"""

from __future__ import annotations

import json
import os
import threading
import time
import zlib
from collections import OrderedDict, deque
from typing import Dict, List, Optional

from volcano_tpu_torch import metrics
from volcano_tpu_torch.obs import spans as _spans
from volcano_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

#: the telemetry namespace — informers never watch ConfigMaps, so
#: segment churn cannot wake a micro-cycle or dirty a pack cache
NAMESPACE = "volcano-telemetry"
SEGMENT_KEY = "spans.volcano.tpu/batch"
SEGMENT_PREFIX = "vtpu-spans-"
#: per-daemon tail-decision publication (obs/tail.py)
TAIL_KEY = "tail.volcano.tpu/decisions"
TAIL_PREFIX = "vtpu-tail-"
#: the cluster-wide TTL-bounded capture-boost record (obs/incident.py
#: CASes it; every exporter polls it)
BOOST_NAME = "vtpu-capture-boost"
BOOST_KEY = "boost.volcano.tpu/record"


def _env_sample() -> float:
    try:
        return min(1.0, max(0.0, float(
            os.environ.get("VTPU_TELEMETRY_SAMPLE", "1.0")
        )))
    except ValueError:
        return 1.0


def _env_tail() -> bool:
    return os.environ.get("VTPU_TELEMETRY_TAIL", "") not in ("", "0")


class SpanExporter:
    """Bounded ring + batcher + bus flusher for one daemon's spans."""

    def __init__(
        self,
        api,
        identity: str,
        ring: int = 8192,
        segments: int = 16,
        batch: int = 2048,
        flush_interval: float = 0.25,
        sample: Optional[float] = None,
        tail: Optional[bool] = None,
    ):
        self.api = api
        self.identity = identity
        self.token = _spans._proc_token(identity)
        self.pid = os.getpid()
        self.ring_cap = max(1, ring)
        self.segments = max(1, segments)
        self.batch = max(1, batch)
        self.flush_interval = flush_interval
        self.sample = _env_sample() if sample is None else sample
        self._lock = threading.Lock()
        # populated under the lock: enable() publishes the exporter
        # through the unsynchronized _spans._set_exporter global, so a
        # thread alive before enable() first sees this state through
        # its own emit()-side lock acquire — construction must publish
        # through the same lock (the FaultPlane._points lesson, caught
        # by the happens-before detector)
        with self._lock:
            self._ring: deque = deque()  # guarded-by: self._lock
            self._seq = 0  # guarded-by: self._lock
            #: observability for tests; the metric is the operator
            #: surface
            self.dropped = 0  # guarded-by: self._lock
            self.exported = 0  # guarded-by: self._lock
            #: the cached cluster capture-boost record (None = no
            #: boost) and its wall-clock expiry, refreshed by the
            #: flusher's poll and by incident.set_boost
            self._boost: Optional[dict] = None  # guarded-by: self._lock
            self._boost_until = 0.0  # guarded-by: self._lock
            #: cumulative recent tail decisions published under
            #: vtpu-tail-<identity> (bounded; peers resolve from it)
            self._published: OrderedDict = OrderedDict()  # guarded-by: self._lock
            self._pub_seq = 0  # guarded-by: self._lock
        #: flusher-thread-only state (no lock needed): peer decision
        #: cursors + the beat counter pacing the boost poll
        self._peer_seqs: Dict[str, int] = {}
        self._beat = 0
        self._boost_poll_every = max(1, int(round(1.0 / max(
            flush_interval, 1e-3))))
        #: tail-based retention (obs/tail.py): None = head sampling.
        #: A sample rate of 1.0 keeps every trace either way, so tail
        #: mode only engages when the coin would actually drop.
        tail = _env_tail() if tail is None else tail
        self.tail = None
        if tail and self.sample < 1.0:
            from volcano_tpu_torch.obs.tail import TailSampler

            self.tail = TailSampler(self._coin)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- emission (any thread — must stay O(1), lock-only) ----

    def _coin(self, trace_id: str) -> bool:
        """The head-sampling hash coin — a pure function of the trace
        id, so every process agrees without coordination.  Tail mode
        reuses it as its steady-state fallback."""
        if self.sample >= 1.0:
            return True
        if self.sample <= 0.0:
            return False
        return (zlib.crc32(trace_id.encode()) % 10_000) < self.sample * 10_000

    def keep(self, trace_id: str) -> bool:
        """Trace-id sampling: "" (process-scope spans) always kept;
        otherwise the id's hash decides, so every process keeps or
        drops a given trace identically.  Under a capture boost
        everything is kept; in tail mode only a memoized
        completion-time DROP suppresses recording (undecided traces
        record and buffer in the pending pool)."""
        if self.sample >= 1.0 or not trace_id:
            return True
        if self.boost_active():
            return True
        if self.tail is not None:
            return self.tail.keep(trace_id)
        return self._coin(trace_id)

    def boost_active(self) -> bool:
        """Cheap hot-path check — the cached expiry is a GIL-atomic
        float; staleness is bounded by the flusher's ~1 s poll."""
        until = self._boost_until  # unlocked-ok: single float read; a raced refresh only shifts which span first sees the boost
        return until > 0.0 and time.time() < until

    def boost_record(self) -> Optional[dict]:
        """The active boost record (for the lease-heartbeat stats echo
        and /healthz-adjacent surfaces), or None."""
        with self._lock:
            boost = self._boost
        if boost and self.boost_active():
            return dict(boost)
        return None

    def set_boost(self, record: Optional[dict]) -> None:
        """Install (or clear) the cluster boost record locally — the
        poll's apply step, also called by the incident manager so the
        capturing daemon boosts without waiting a poll tick."""
        with self._lock:
            self._boost = record
            self._boost_until = float((record or {}).get("until", 0.0))
        metrics.update_capture_boost(1.0 if self.boost_active() else 0.0)

    def emit(self, record: dict) -> None:
        if self.tail is not None and record.get("t"):
            if self.boost_active():
                record.pop("_root", None)
                self._enqueue([record])
            else:
                self._enqueue(self.tail.offer(record))
            return
        record.pop("_root", None)
        with self._lock:
            if len(self._ring) >= self.ring_cap:
                self.dropped += 1
                dropped = True
            else:
                self._ring.append(record)
                dropped = False
        if dropped:
            metrics.register_telemetry_dropped("ring-full")

    def _enqueue(self, records: List[dict]) -> None:
        """Ring-append a tail decision's worth of records (drop-not-
        block: overflow drops and counts, exactly like emit)."""
        if not records:
            return
        dropped = 0
        with self._lock:
            for record in records:
                if len(self._ring) >= self.ring_cap:
                    self.dropped += 1
                    dropped += 1
                else:
                    self._ring.append(record)
        if dropped:
            metrics.register_telemetry_dropped("ring-full", dropped)

    # ---- flush (the exporter's own thread, or tests) ----

    def _drain(self) -> List[dict]:
        with self._lock:
            n = min(len(self._ring), self.batch)
            return [self._ring.popleft() for _ in range(n)]

    def flush(self) -> int:
        """Ship up to one batch; returns spans shipped (0 = ring empty
        or the write failed — failures DROP, with the counter bumped)."""
        batch = self._drain()
        if not batch:
            return 0
        with self._lock:
            seq = self._seq
            self._seq += 1
        slot = seq % self.segments
        name = f"{SEGMENT_PREFIX}{self.identity}-{slot:02d}"
        payload = json.dumps({
            "daemon": self.identity,
            "pid": self.pid,
            "seq": seq,
            "spans": batch,
        }, separators=(",", ":"))
        try:
            # the exporter's own bus traffic must not trace itself
            with _spans.suppressed():
                self._write_segment(name, payload)
        except Exception as e:  # noqa: BLE001 — drop-not-block: a bus
            # outage or a refused write costs this
            # batch, never a cycle and never an exception into a daemon
            with self._lock:
                self.dropped += len(batch)
            metrics.register_telemetry_dropped("export-error", len(batch))
            log.debug("telemetry export dropped %d span(s): %s",
                      len(batch), e)
            return 0
        with self._lock:
            self.exported += len(batch)
        metrics.observe_telemetry_batch(len(batch))
        return len(batch)

    def _write_segment(self, name: str, payload: str) -> None:
        self._write_segment_named(name, SEGMENT_KEY, payload)

    def _write_segment_named(self, name: str, key: str, payload: str) -> None:
        from volcano_tpu_torch.apis import core
        from volcano_tpu_torch.client.apiserver import AlreadyExistsError

        data = {key: payload}
        try:
            self.api.create(core.ConfigMap(
                metadata=core.ObjectMeta(name=name, namespace=NAMESPACE),
                data=data,
            ))
        except AlreadyExistsError:
            cm = self.api.get("ConfigMap", NAMESPACE, name)
            if cm is None:  # deleted between create and get — rare; drop
                raise
            cm.data = data
            self.api.update(cm)

    def flush_all(self, limit: int = 64) -> int:
        """Drain the whole ring (graceful shutdown / tests)."""
        total = 0
        for _ in range(limit):
            n = self.flush()
            if n == 0:
                break
            total += n
        return total

    # ---- tail + boost plumbing (the flusher's thread) ----

    def tick(self) -> None:
        """One flusher beat: poll the cluster boost record (about once
        a second), sweep the tail pending pool, exchange completion-
        time decisions with peers, then ship a batch.  Every bus touch
        is suppressed and failure-swallowed — drop-not-block."""
        self._beat += 1
        if self._beat % self._boost_poll_every == 0:
            self._poll_boost()
        if self.tail is not None:
            self._enqueue(self.tail.sweep(boost=self.boost_active()))
            self._publish_decisions()
            self._apply_peer_decisions()
        self.flush()

    def _poll_boost(self) -> None:
        try:
            with _spans.suppressed():
                cm = self.api.get("ConfigMap", NAMESPACE, BOOST_NAME)
            record = None
            if cm is not None:
                record = json.loads((cm.data or {}).get(BOOST_KEY, ""))
            if record is not None and float(record.get("until", 0.0)) \
                    <= time.time():
                record = None  # expired — TTL-bounded by construction
            self.set_boost(record)
        except Exception:  # noqa: BLE001 — a bus outage must not stop
            # flushing; the cached record simply ages out
            pass

    def _publish_decisions(self) -> None:
        """Ship locally-made tail decisions as the bounded cumulative
        ``vtpu-tail-<identity>`` object, so peers holding this trace's
        late-arriving child spans resolve them identically."""
        fresh = self.tail.drain_decisions()
        if not fresh:
            return
        with self._lock:
            for tid, kept in fresh.items():
                self._published[tid] = bool(kept)
                self._published.move_to_end(tid)
            while len(self._published) > 512:
                self._published.popitem(last=False)
            self._pub_seq += 1
            payload = json.dumps({
                "daemon": self.identity,
                "seq": self._pub_seq,
                "decisions": dict(self._published),
            }, separators=(",", ":"))
        try:
            with _spans.suppressed():
                self._write_segment_named(
                    f"{TAIL_PREFIX}{self.identity}", TAIL_KEY, payload)
        except Exception:  # noqa: BLE001 — decisions stay in the
            # cumulative map; the next publish retries them
            pass

    def _apply_peer_decisions(self) -> None:
        """Resolve pending traces with peers' published decisions.
        Polled only while something is actually pending — steady state
        costs nothing."""
        if self.tail.pending_count() == 0:
            return
        try:
            with _spans.suppressed():
                cms = list(self.api.list("ConfigMap", NAMESPACE))
        except Exception:  # noqa: BLE001 — resolution just waits
            return
        for cm in cms:
            name = cm.metadata.name or ""
            if not name.startswith(TAIL_PREFIX) or \
                    name == f"{TAIL_PREFIX}{self.identity}":
                continue
            try:
                seg = json.loads((cm.data or {}).get(TAIL_KEY, ""))
            except (ValueError, AttributeError):
                continue
            seq = int(seg.get("seq", 0))
            if seq <= self._peer_seqs.get(name, 0):
                continue
            self._peer_seqs[name] = seq
            decisions = {
                str(t): bool(k)
                for t, k in (seg.get("decisions") or {}).items()
            }
            self._enqueue(self.tail.apply_remote(decisions))

    # ---- lifecycle ----

    def _loop(self) -> None:
        while not self._stop.wait(self.flush_interval):
            self.tick()
        # best-effort final drain: settle what's ready, then flush
        if self.tail is not None:
            self._enqueue(self.tail.sweep(boost=self.boost_active()))
            self._publish_decisions()
        self.flush_all()

    def start(self) -> "SpanExporter":
        self._thread = threading.Thread(
            target=self._loop, name=f"vtpu-telemetry-{self.identity}",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


def enable(api, identity: str, **kw) -> SpanExporter:
    """Install the process-global flight recorder: spans emitted via
    :mod:`volcano_tpu_torch.obs` batch through a :class:`SpanExporter` onto
    ``api``.  Replaces (and stops) a previously installed exporter."""
    prev = _spans.get_exporter()
    if prev is not None:
        prev.stop()
    exp = SpanExporter(api, identity, **kw).start()
    _spans._set_exporter(exp)
    return exp


def disable() -> None:
    exp = _spans.get_exporter()
    _spans._set_exporter(None)
    if exp is not None:
        exp.stop()
