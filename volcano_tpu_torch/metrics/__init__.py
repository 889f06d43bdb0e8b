"""The port's metrics sink: what its dispatcher, breakers and fault plane
write, under the names of ``volcano_tpu/metrics/metrics.py``.

The scheduling cycle writes the series the JAX package's scheduler loop,
framework, cache, plugins and actions write (cycle, action, plugin and
task latencies, sessions opened, schedule attempts,
unschedulable reasons, kernel phase latencies, the explain reduction's
latency, preemption victims and attempts), and the event-driven loop the
series of its micro-cycles, full-cycle fallbacks, resident and
schedulable jobs and shadow cross-checks, and the cache's commit path
the series of its commit plane (queue depth, bind coalesce sizes,
overlap ratio), its failed effects, its quarantined resyncs and the
submit-to-bind latency, each under the same name and labels; a
histogram keeps the reference's buckets, its count and its sum.

``volcano_executor_failures_total{executor,cause}`` counts every failed or
refused kernel call, a device phase that overran the cycle deadline and
a preempt or reclaim result that diverged while it was applied included
(the reference counts a demotion to a lower rung or to the host; the
port's kernel executors fall to none),
``volcano_executor_fallbacks_total{from,to,cause}`` counts the one
demotion the port has, a compute-plane session that failed and ran on
the in-process kernel instead (``from="remote", to="local"``),
``volcano_circuit_breaker_open{executor}``
holds each breaker's state, and ``volcano_faults_injected_total{point}``
counts the fault plane's firings.  Values live in process memory in
``registry``, keyed as the JAX package's registry keys them, so a test or
an operator reads them with :meth:`Registry.counter` and
:meth:`Registry.gauge`, and ``GET /metrics`` (serving/http.py) prints
them with :meth:`Registry.render`, the Prometheus text exposition,
histograms in the reference's buckets.  A daemon stamps who it is once
at start (:func:`set_identity`): its labels are merged into every
rendered series, and ``volcano_build_info{version}`` is set.  The bus
(``bus/``) writes the reference's bus series: the client's requests,
reconnects, relists, watch events and lag, codec fallbacks; the
server's requests, watchers, codecs, frame bytes and watch-batch sizes.
The sharded scheduler federation (``federation/``) writes the
reference's federation series: nodes owned, spillover binds, shard
rebalances, lease renew latency, sketch solicitations, gang assemblies,
the ``txn_commit`` round trip and autoscale decisions.
The durable, replicated store (``bus/wal.py``, ``bus/replication.py``)
writes the reference's durability series: fsync latency, WAL size,
quorum wait, replication lag, role, membership epoch and recoveries.
The flight recorder (``obs/``) writes the reference's telemetry series:
spans dropped by reason, exported batch sizes, tail-sampler evictions and
decisions, the SLO burn gauges, incident bundles captured and the capture
boost; the kernel phase and explain timings also land as spans in its
waterfall when it is on.

The package holds the sink here, and beside it ``scrape.py`` (the read
side of ``/metrics``) and ``timeseries.py`` (the watchdog's ring of
samples).
"""

from __future__ import annotations

import bisect
import threading
from collections import defaultdict
import time
from typing import Dict, List, Optional, Tuple

from volcano_tpu_torch import trace

_NAMESPACE = "volcano"

# 5ms × 2^k buckets, like prometheus.ExponentialBuckets(5, 2, 10) in ms.
_LATENCY_BUCKETS_MS = [5.0 * (2**k) for k in range(10)]
# 5µs × 2^k up to ~160ms, for the microsecond histograms.
_LATENCY_BUCKETS_US = [5.0 * (2**k) for k in range(16)]
# Job-level latency, creation → first scheduled cycle: 100ms × 2^k.
_JOB_LATENCY_BUCKETS_MS = [100.0 * (2**k) for k in range(14)]

_Key = Tuple[str, Tuple[Tuple[str, str], ...]]


class _Histogram:
    __slots__ = ("buckets", "counts", "sum", "total")

    def __init__(self, buckets: List[float]):
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)
        self.sum = 0.0
        self.total = 0


class Registry:
    """In-process counters, gauges and histograms, keyed by (name,
    sorted labels)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[_Key, float] = defaultdict(float)  # guarded-by: self._lock
        self._gauges: Dict[_Key, float] = {}  # guarded-by: self._lock
        self._hists: Dict[_Key, _Histogram] = {}  # guarded-by: self._lock
        #: uniform identity labels merged into every rendered series
        #: (daemon / shard / replica_index / role); empty until
        #: set_identity(), so tests and library embedders see unchanged
        #: output
        self._identity: Tuple[Tuple[str, str], ...] = ()  # guarded-by: self._lock

    @staticmethod
    def _key(name: str, labels: Dict[str, str]) -> _Key:
        return name, tuple(sorted(labels.items()))

    def inc(self, name: str, labels: Dict[str, str], value: float = 1.0) -> None:
        with self._lock:
            self._counters[self._key(name, labels)] += value

    def set_gauge(self, name: str, labels: Dict[str, str], value: float) -> None:
        with self._lock:
            self._gauges[self._key(name, labels)] = value

    def observe(self, name: str, labels: Dict[str, str], value: float,
                buckets: Optional[List[float]] = None) -> None:
        """One sample into the histogram; ``buckets`` (upper bounds)
        fix its buckets at its first sample, ``_LATENCY_BUCKETS_MS``
        where None."""
        with self._lock:
            key = self._key(name, labels)
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = _Histogram(buckets or _LATENCY_BUCKETS_MS)
            h.counts[bisect.bisect_left(h.buckets, value)] += 1
            h.sum += value
            h.total += 1

    def counter(self, name: str, **labels: str) -> float:
        """A counter's value; 0 before its first count."""
        with self._lock:
            return self._counters.get(self._key(name, labels), 0.0)

    def counters(self, name: str) -> Dict[Tuple[Tuple[str, str], ...], float]:
        """Every label set of counter ``name`` with its value."""
        with self._lock:
            return {labels: v for (n, labels), v in self._counters.items() if n == name}

    def gauge(self, name: str, **labels: str) -> float:
        """A gauge's value; raises KeyError before it is first set."""
        with self._lock:
            return self._gauges[self._key(name, labels)]

    def histogram(self, name: str, **labels: str) -> Tuple[int, float]:
        """A histogram's (count, sum); (0, 0.0) before its first sample."""
        with self._lock:
            h = self._hists.get(self._key(name, labels))
            return (0, 0.0) if h is None else (h.total, h.sum)

    def histogram_snapshot(self, name: str, labels=None):
        """Cumulative scrape-shaped snapshot of one histogram —
        ``{"buckets": [(le, cumulative)...], "sum", "count"}``, the
        shape ``metrics/scrape.py`` parses from /metrics text, so the
        shard autoscaler's windowed quantiles reuse
        ``merge_histograms``/``histogram_quantile`` unchanged.  None
        when the series was never observed."""
        key = self._key(name, labels or {})
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                return None
            cumulative = 0
            buckets = []
            for bound, c in zip(h.buckets, h.counts):
                cumulative += c
                buckets.append((str(bound), float(cumulative)))
            buckets.append(("+Inf", float(h.total)))
            return {"buckets": buckets, "sum": h.sum, "count": float(h.total)}

    def set_identity(self, **labels: str) -> None:
        """Install the uniform identity labels (non-empty values only);
        they merge into every series at render time, so a role flip
        retags the whole exposition at the next scrape."""
        with self._lock:
            self._identity = tuple(sorted((k, v) for k, v in labels.items() if v))

    def refresh_identity_role(self, role: str) -> None:
        """Replace just the ``role`` identity label — called from the
        replication role transitions (:func:`update_repl_role`) so both
        directions retag: a deposed leader's series stop claiming
        role="leader" the moment it demotes.  No-op when no identity is
        installed (library embedders, tests)."""
        with self._lock:
            if not self._identity or not role:
                return
            self._identity = tuple(sorted(
                [(k, v) for k, v in self._identity if k != "role"] + [("role", role)]))

    def render(self) -> str:
        """Prometheus text exposition format, line for line the JAX
        package's ``_Registry.render``: histograms, then counters, then
        gauges, each sorted by name and labels, the identity labels
        merged into each series' own (a series' own label wins)."""
        identity: Tuple[Tuple[str, str], ...] = ()

        def fmt_labels(labels: Tuple[Tuple[str, str], ...]) -> str:
            if identity:
                keys = {k for k, _v in labels}
                labels = tuple(sorted(
                    labels + tuple((k, v) for k, v in identity if k not in keys)))
            if not labels:
                return ""
            return "{" + ",".join(f'{k}="{v}"' for k, v in labels) + "}"

        lines: List[str] = []
        with self._lock:
            identity = self._identity
            for (name, labels), h in sorted(self._hists.items()):
                cumulative = 0
                for bound, c in zip(h.buckets, h.counts):
                    cumulative += c
                    le = labels + (("le", str(bound)),)
                    lines.append(f"{name}_bucket{fmt_labels(le)} {cumulative}")
                le = labels + (("le", "+Inf"),)
                lines.append(f"{name}_bucket{fmt_labels(le)} {h.total}")
                lines.append(f"{name}_sum{fmt_labels(labels)} {h.sum}")
                lines.append(f"{name}_count{fmt_labels(labels)} {h.total}")
            for (name, labels), v in sorted(self._counters.items()):
                lines.append(f"{name}{fmt_labels(labels)} {v}")
            for (name, labels), v in sorted(self._gauges.items()):
                lines.append(f"{name}{fmt_labels(labels)} {v}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self._identity = ()


registry = Registry()


# ---- daemon identity + build info ----

#: bounded role vocabulary for the identity label
_IDENTITY_ROLES = (
    "scheduler", "controllers", "admission", "apiserver",
    "compute-plane", "leader", "follower", "standalone", "init",
    "removed",
)


def set_identity(daemon: str, shard: str = "", replica_index: str = "",
                 role: str = "") -> None:
    """Install the uniform identity labels and the ``volcano_build_info``
    gauge.  role ∈ _IDENTITY_ROLES (anything else renders ``other``);
    empty labels are omitted rather than rendered blank."""
    if role and role not in _IDENTITY_ROLES:
        role = "other"
    registry.set_identity(daemon=daemon, shard=shard, replica_index=replica_index, role=role)
    from volcano_tpu_torch import __version__

    # label-vocab: version — the package __version__, one value per build
    registry.set_gauge(f"{_NAMESPACE}_build_info", {"version": __version__}, 1.0)


def register_executor_failure(executor: str, cause: str) -> None:
    """One failed or refused call of ``executor``; cause ∈ {error,
    circuit-open, corrupt-output, deadline, diverged}."""
    # label-vocab: executor — the executor names (ops/dispatch.py
    # select_executor and the preempt routes), a static set
    registry.inc(f"{_NAMESPACE}_executor_failures_total",
                 {"executor": executor, "cause": cause})


def register_executor_fallback(from_: str, to: str, cause: str) -> None:
    """One session demoted from ``from_`` to ``to``: in the port only
    ``remote`` → ``local`` (a compute-plane session that failed ran on
    the in-process kernel); cause ∈ {error}."""
    # label-vocab: from, to — the executor route names, a static set
    registry.inc(f"{_NAMESPACE}_executor_fallbacks_total",
                 {"from": from_, "to": to, "cause": cause})


def update_circuit_breaker_state(executor: str, value: float) -> None:
    """0 = closed, 0.5 = half-open (probing), 1 = open (tripped)."""
    # label-vocab: executor — the per-name breaker registry
    # (faults/breaker.py), a static set of executor/seam names
    registry.set_gauge(f"{_NAMESPACE}_circuit_breaker_open", {"executor": executor}, value)


def register_fault_injected(point: str) -> None:
    """One firing of the fault plane at ``point``."""
    # label-vocab: point — the parsed fault schedule's point names
    registry.inc(f"{_NAMESPACE}_faults_injected_total", {"point": point})


def update_kernel_duration(phase: str, seconds: float) -> None:
    """phase ∈ {pack, execute} of gpu-allocate's KERNEL phase.  The same
    timing feeds the trace recorder's timeline when a cycle is being
    recorded — one measurement, two sinks."""
    registry.observe(f"{_NAMESPACE}_tpu_kernel_latency_milliseconds",
                     {"phase": phase}, seconds * 1e3)
    rec = trace.get_recorder()
    if rec.enabled:
        rec.complete(
            f"kernel:{phase}", "kernel", time.perf_counter() - seconds, seconds
        )
    from volcano_tpu_torch import obs

    if obs.enabled():
        # third sink: the flight recorder — kernel phases land in the
        # cross-process waterfall parented to the cycle span
        obs.complete(f"kernel:{phase}", seconds, cat="kernel")


def update_action_duration(action_name: str, seconds: float) -> None:
    registry.observe(f"{_NAMESPACE}_action_scheduling_latency_microseconds",
                     {"action": action_name}, seconds * 1e6, _LATENCY_BUCKETS_US)


def update_e2e_duration(seconds: float) -> None:
    """One scheduling cycle, open to close (``Scheduler.run_once``)."""
    registry.observe(f"{_NAMESPACE}_e2e_scheduling_latency_milliseconds", {},
                     seconds * 1e3)


def register_session_scope(mode: str) -> None:
    """One session opened, by scope; mode ∈ {full, restricted} (a
    restricted micro-cycle opens over the jobs with pending work only,
    incremental/subgraph.py)."""
    registry.inc(f"{_NAMESPACE}_session_scope_total", {"mode": mode})


# ---- event-driven micro-cycles (scheduler/scheduler.py) ----


def register_micro_cycle(trigger: str) -> None:
    """volcano_micro_cycles_total{trigger}: one count per event-driven
    micro-cycle; trigger ∈ {task, node, group, gang, topology, mixed} —
    the coalesced change category that woke the loop."""
    registry.inc(f"{_NAMESPACE}_micro_cycles_total", {"trigger": trigger})


def update_micro_cycle_duration(seconds: float) -> None:
    """volcano_micro_cycle_latency_milliseconds: wall-clock of one
    micro-cycle (wake → session closed), kept apart from the e2e
    histogram so full-cycle mass cannot hide a micro-path regression."""
    registry.observe(f"{_NAMESPACE}_micro_cycle_latency_milliseconds", {},
                     seconds * 1e3)


def register_full_cycle_fallback(cause: str) -> None:
    """volcano_full_cycle_fallbacks_total{cause}: an event that wanted a
    micro-cycle ran (or forced) a full cycle instead.  cause ∈
    {gang-arrival, topology, registry-overflow, axis-change, node-set,
    pack-cold} — the scheduler's routing causes plus the pack-level
    causes PackCache.last_stats reports."""
    registry.inc(f"{_NAMESPACE}_full_cycle_fallbacks_total", {"cause": cause})


# ---- incremental-session plane (volcano_tpu_torch/incremental) ----


def update_resident_jobs(count: int) -> None:
    """volcano_resident_jobs: jobs resident in the scheduler cache
    (everything with a PodGroup, running or pending) — the O(resident)
    cost a full session pays and a restricted session does not."""
    registry.set_gauge(f"{_NAMESPACE}_resident_jobs", {}, count)


def update_schedulable_jobs(count: int) -> None:
    """volcano_schedulable_jobs: jobs with schedulable pending work
    (the share ledger's schedulable set) — the O(pending) working set a
    restricted session opens over."""
    registry.set_gauge(f"{_NAMESPACE}_schedulable_jobs", {}, count)


def register_share_ledger_drift_check(result: str) -> None:
    """volcano_share_ledger_drift_checks_total{result}: one count per
    shadow full-session cross-check of a restricted session; result ∈
    {ok, divergence} (a divergence raises in strict mode)."""
    registry.inc(f"{_NAMESPACE}_share_ledger_drift_checks_total", {"result": result})


def update_plugin_duration(plugin_name: str, seconds: float) -> None:
    registry.observe(f"{_NAMESPACE}_plugin_scheduling_latency_microseconds",
                     {"plugin": plugin_name}, seconds * 1e6, _LATENCY_BUCKETS_US)


def update_task_schedule_duration(seconds: float) -> None:
    registry.observe(f"{_NAMESPACE}_task_scheduling_latency_microseconds", {},
                     seconds * 1e6, _LATENCY_BUCKETS_US)


def update_job_schedule_duration(seconds: float) -> None:
    """Per-job latency, creation → first scheduled cycle."""
    registry.observe(f"{_NAMESPACE}_e2e_job_scheduling_latency_milliseconds", {},
                     seconds * 1e3, _JOB_LATENCY_BUCKETS_MS)


def register_schedule_attempt(result: str) -> None:
    """One job scheduling attempt; result ∈ {scheduled, unschedulable,
    error}."""
    registry.inc(f"{_NAMESPACE}_schedule_attempts_total", {"result": result})


def update_pod_schedule_status(status: str, count: int = 1) -> None:
    """Pods whose bind landed (``successes``) or failed (``errors``)."""
    registry.inc(f"{_NAMESPACE}_pod_schedule_{status}", {}, count)


def update_preemption_victims_count(count: int) -> None:
    registry.inc(f"{_NAMESPACE}_total_preemption_victims", {}, count)


def register_preemption_attempts() -> None:
    registry.inc(f"{_NAMESPACE}_total_preemption_attempts", {})


def update_explain_duration(seconds: float) -> None:
    """The reason-count reduction behind a cycle's explanations
    (``ops/explain.run_explain``)."""
    registry.observe(f"{_NAMESPACE}_explain_latency_milliseconds", {}, seconds * 1e3)
    from volcano_tpu_torch import obs

    if obs.enabled():
        obs.complete("explain", seconds, cat="explain")


def register_commit_failure(kind: str) -> None:
    """volcano_commit_failures_total{kind}: commit effects that failed
    (kind ∈ {bind, evict, status}); binds/evicts take the resync path,
    status writebacks retry next cycle."""
    registry.inc(f"{_NAMESPACE}_commit_failures_total", {"kind": kind})


def update_resync_quarantined(count: int) -> None:
    """volcano_resync_quarantined_tasks: tasks whose resync exhausted
    its bounded retries and now sit quarantined awaiting fresh API
    truth (cache.SchedulerCache poison-task handling)."""
    registry.set_gauge(f"{_NAMESPACE}_resync_quarantined_tasks", {}, count)


# ---- pipelined commit plane (cache/commit_plane.py) ----

#: coalesce sizes are small powers of two up to the per-frame cap
_COALESCE_BUCKETS = [1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048,
                     4096, 8192]


def update_commit_queue_depth(depth: int) -> None:
    """volcano_commit_queue_depth: commit-plane items (binds / evicts /
    status writebacks) enqueued but not yet landed in the store."""
    registry.set_gauge(f"{_NAMESPACE}_commit_queue_depth", {}, depth)


def observe_bind_coalesce(size: int) -> None:
    """volcano_bind_coalesce_size: how many binds one coalesced commit
    frame carried."""
    registry.observe(f"{_NAMESPACE}_bind_coalesce_size", {}, size,
                     buckets=_COALESCE_BUCKETS)


def update_commit_overlap_ratio(ratio: float) -> None:
    """volcano_commit_overlap_ratio: per commit-barrier, the fraction of
    the plane's busy time that overlapped other host work instead of
    blocking the barrier — 1.0 means the whole commit landed behind the
    next cycle's pack+device phase, 0.0 means the barrier absorbed all
    of it (no better than synchronous)."""
    registry.set_gauge(f"{_NAMESPACE}_commit_overlap_ratio", {}, ratio)


def observe_submit_to_bind(seconds: float) -> None:
    """volcano_submit_to_bind_latency_milliseconds: pod creation (store
    timestamp) → bind effect landed in the store, recorded at the single
    bind-landing site shared by the synchronous and pipelined commit
    paths."""
    registry.observe(f"{_NAMESPACE}_submit_to_bind_latency_milliseconds", {},
                     seconds * 1e3)


# ---- bus (bus/remote.py client side, bus/server.py server side) ----

#: frame-size buckets (bytes): watch entries are hundreds of bytes,
#: relist replies and batch frames reach megabytes
_FRAME_BYTE_BUCKETS = [64, 256, 1024, 4096, 16384, 65536, 262144, 1048576, 4194304]


def observe_bus_request(method: str, seconds: float, code: str) -> None:
    """One client call; code ∈ {ok, error, timeout, disconnected}."""
    # label-vocab: method — the protocol.OP_VERSIONS op registry plus
    # "ping", a static set
    registry.inc(f"{_NAMESPACE}_bus_requests_total", {"method": method, "code": code})
    registry.observe(f"{_NAMESPACE}_bus_request_latency_milliseconds", {"method": method},
                     seconds * 1e3)


def register_bus_reconnect() -> None:
    registry.inc(f"{_NAMESPACE}_bus_reconnects_total", {})


def register_bus_relist(kind: str) -> None:
    """A watch that could not resume and relisted (410 Gone)."""
    # label-vocab: kind — the protocol.KINDS decode registry, a static set
    registry.inc(f"{_NAMESPACE}_bus_relists_total", {"kind": kind})


def register_bus_watch_event(kind: str) -> None:
    # label-vocab: kind — the protocol.KINDS decode registry, a static set
    registry.inc(f"{_NAMESPACE}_bus_watch_events_total", {"kind": kind})


def update_bus_watch_lag(seconds: float) -> None:
    """Server stamp → client dispatch of a watch event or bookmark."""
    registry.observe(f"{_NAMESPACE}_bus_watch_lag_milliseconds", {},
                     max(seconds, 0.0) * 1e3)


def update_bus_codec_connections(codec: str, count: int) -> None:
    """Live server connections per negotiated body codec."""
    # label-vocab: codec ∈ {json, binary}, a static set
    registry.set_gauge(f"{_NAMESPACE}_bus_codec", {"codec": codec}, count)


def observe_bus_frame_bytes(codec: str, nbytes: int) -> None:
    """Body size of one outbound server frame, by codec."""
    registry.observe(f"{_NAMESPACE}_bus_frame_bytes", {"codec": codec}, nbytes,
                     buckets=_FRAME_BYTE_BUCKETS)


def register_bus_codec_fallback() -> None:
    """A client offered binary and the peer declined."""
    registry.inc(f"{_NAMESPACE}_bus_codec_fallbacks_total", {})


def observe_bus_server_request(op: str, seconds: float, code: str) -> None:
    """One server-side request; code ∈ {ok, error}."""
    # label-vocab: op — the protocol.OP_VERSIONS registry, a static set
    registry.inc(f"{_NAMESPACE}_bus_server_requests_total", {"op": op, "code": code})
    registry.observe(f"{_NAMESPACE}_bus_server_request_latency_milliseconds", {"op": op},
                     seconds * 1e3)


def update_bus_server_watchers(count: int) -> None:
    registry.set_gauge(f"{_NAMESPACE}_bus_server_watchers", {}, count)


def observe_watch_batch(size: int) -> None:
    """Watch events one coalesced T_WATCH_BATCH frame carried."""
    registry.observe(f"{_NAMESPACE}_bus_watch_batch_size", {}, size,
                     buckets=_COALESCE_BUCKETS)


# ---- sharded scheduler federation (federation/) ----
# N scheduler processes each own a disjoint node shard via CAS leases;
# jobs that fail to place on their home shard spill over via optimistic
# CAS binds, and gangs below minMember assemble across shards through
# one txn_commit.  These are the federation's vital signs: slice size,
# spillover pressure (the shard-hash-skew signal), ownership churn, the
# lease plane's health, sketch staleness, gang assemblies and the
# transaction's round trip.


def update_shard_nodes_owned(count: int) -> None:
    """volcano_shard_nodes_owned: nodes this scheduler currently owns
    through its shard leases (the slice the cache and pack planes cover)."""
    registry.set_gauge(f"{_NAMESPACE}_shard_nodes_owned", {}, count)


def register_spillover_bind(result: str) -> None:
    """volcano_spillover_binds_total{result}: cross-shard optimistic
    CAS bind outcomes.  result ∈ {bound, conflict, exhausted, no-fit,
    lost-race, error} — conflicts are the Omega model working as
    intended; a high no-fit/exhausted rate means the cluster (not just
    the home shard) is full or the shard hash is skewed."""
    registry.inc(f"{_NAMESPACE}_spillover_binds_total", {"result": result})


def register_shard_rebalance(cause: str) -> None:
    """volcano_shard_rebalances_total{cause}: shard ownership moved.
    cause ∈ {expiry (absorbed a dead member's slice), join (claimed a
    free slice), release (shed a slice for a joining member)}."""
    registry.inc(f"{_NAMESPACE}_shard_rebalances_total", {"cause": cause})


def observe_shard_lease_renew(seconds: float) -> None:
    """volcano_shard_lease_renew_latency_milliseconds: read-modify-CAS
    round trip of one successful shard-map renew tick — creeping toward
    the lease duration is the early warning before ownership flaps."""
    registry.observe(f"{_NAMESPACE}_shard_lease_renew_latency_milliseconds", {},
                     seconds * 1e3)


def register_sketch_solicitation(result: str) -> None:
    """volcano_sketch_solicitations_total{result}: per-node outcomes of
    sketch-solicited foreign candidates (federation/sketches.py).
    result ∈ {verified (node truth read-back confirmed the sketch
    entry), stale (the sketch advertised a node the store says is gone
    or unschedulable — pruning signal, never a correctness event)}."""
    # label-vocab: result ∈ {verified, stale}, a static set
    registry.inc(f"{_NAMESPACE}_sketch_solicitations_total", {"result": result})


def register_gang_assembly(result: str) -> None:
    """volcano_gang_assemblies_total{result}: cross-shard gang assembly
    outcomes (federation/broker.py).  result ∈ {committed (one
    txn_commit bound the gang whole), conflict (a claim went stale —
    assembly discarded whole, retried with backoff), aborted
    (transport/unsupported — incl. the pre-v6 old-peer refusal mode),
    infeasible (no full-gang placement exists in the ledger's view —
    the honest Pending outcome)}."""
    registry.inc(f"{_NAMESPACE}_gang_assemblies_total", {"result": result})


def observe_txn_commit(seconds: float) -> None:
    """volcano_txn_commit_latency_milliseconds: the atomic multi-object
    transaction's round trip (VBUS v6) as the gang broker sees it —
    precondition sweep + N binds + one WAL fsync + quorum ack, over
    whichever backend the member holds."""
    registry.observe(f"{_NAMESPACE}_txn_commit_latency_milliseconds", {}, seconds * 1e3)


def register_autoscale_decision(direction: str) -> None:
    """volcano_shard_autoscale_decisions_total{direction}: one count
    per shard-count change the autoscale controller committed to the
    shard map."""
    # label-vocab: direction ∈ {up, down}
    registry.inc(f"{_NAMESPACE}_shard_autoscale_decisions_total", {"direction": direction})


# ---- the durable, replicated store (bus/wal.py, bus/replication.py) ----
# The durability plane's vital signs: fsync cost (the floor under every
# acked write), WAL growth between snapshots, the quorum wait, replication
# lag, the replica's role and membership epoch, and how often recovery
# ran.

def observe_wal_fsync(seconds: float) -> None:
    """volcano_wal_fsync_latency_milliseconds: one WAL fsync."""
    registry.observe(f"{_NAMESPACE}_wal_fsync_latency_milliseconds", {}, seconds * 1e3)


def update_wal_size(size_bytes: int) -> None:
    """volcano_wal_size_bytes: bytes in the live WAL segment (0 again at
    each snapshot rotation)."""
    registry.set_gauge(f"{_NAMESPACE}_wal_size_bytes", {}, size_bytes)


def observe_repl_quorum_wait(seconds: float) -> None:
    """volcano_repl_quorum_wait_milliseconds: how long a leader-side
    write waited for the follower majority."""
    registry.observe(f"{_NAMESPACE}_repl_quorum_wait_milliseconds", {}, seconds * 1e3)


def update_repl_lag(entries: int) -> None:
    """volcano_repl_lag_entries: on the leader the slowest follower's
    deficit, on a follower its own distance behind the leader (the
    ``repl-lag`` SLO's series)."""
    registry.set_gauge(f"{_NAMESPACE}_repl_lag_entries", {}, entries)


def update_membership_epoch(epoch: int) -> None:
    """volcano_repl_membership_epoch: the group's membership-config
    version, bumped by every committed add or remove."""
    registry.set_gauge(f"{_NAMESPACE}_repl_membership_epoch", {}, epoch)


#: bounded role vocabulary for the one-hot role gauge ("removed" is a
#: replica retired by a membership change, still alive for reads)
_REPL_ROLES = ("leader", "follower", "standalone", "init", "removed")


def update_repl_role(role: str) -> None:
    """volcano_repl_role{role}: one-hot role gauge; the identity ``role``
    label follows the same transitions."""
    for r in _REPL_ROLES:
        # label-vocab: role — the _REPL_ROLES enum above
        registry.set_gauge(f"{_NAMESPACE}_repl_role", {"role": r}, 1.0 if r == role else 0.0)
    registry.refresh_identity_role(role)


def register_bus_recovery(kind: str) -> None:
    """volcano_bus_recoveries_total{kind}: one recovery source used at
    start or resync; kind ∈ {snapshot, wal_tail}."""
    # label-vocab: kind ∈ {snapshot, wal_tail}
    registry.inc(f"{_NAMESPACE}_bus_recoveries_total", {"kind": kind})


# ---- the flight recorder's telemetry channel (obs/) ----
# The channel's one invariant is drop-not-block, so the drop counter is
# the health signal: a non-zero rate under steady load means the ring is
# undersized or the bus is refusing segments.


def register_telemetry_dropped(reason: str, count: int = 1) -> None:
    """volcano_telemetry_dropped_total{reason}: spans the telemetry
    channel dropped instead of blocking a cycle.  reason ∈ {ring-full,
    export-error}."""
    registry.inc(f"{_NAMESPACE}_telemetry_dropped_total", {"reason": reason}, count)


def observe_telemetry_batch(size: int) -> None:
    """volcano_telemetry_batch_size: spans per exported segment batch."""
    registry.observe(f"{_NAMESPACE}_telemetry_batch_size", {}, size,
                     buckets=_COALESCE_BUCKETS)


def register_telemetry_tail_eviction(reason: str) -> None:
    """volcano_telemetry_tail_evictions_total{reason}: pending-pool
    traces that fell back to the head coin.  reason ∈ {pool-full,
    timeout}."""
    registry.inc(f"{_NAMESPACE}_telemetry_tail_evictions_total", {"reason": reason})


def register_telemetry_tail_decision(result: str) -> None:
    """volcano_telemetry_tail_decisions_total{result}: completion-time
    keep/drop decisions.  result ∈ {keep, drop}."""
    registry.inc(f"{_NAMESPACE}_telemetry_tail_decisions_total", {"result": result})


def update_slo_burn(slo: str, window: str, value: float) -> None:
    """volcano_slo_burn{slo,window}: the burn-rate watchdog's consumption
    ratio per declared SLO and window (>= 1.0 in both = breach).
    window ∈ {fast, slow}."""
    # label-vocab: slo — the declared SLO names (obs/slo.py
    # DEFAULT_SLOS, a static per-process set)
    registry.set_gauge(f"{_NAMESPACE}_slo_burn", {"slo": slo, "window": window}, value)


def register_incident_captured(trigger: str) -> None:
    """volcano_incidents_captured_total{trigger}: incident bundles this
    daemon wrote; the trigger vocabulary is capped by bounded_label."""
    # label-vocab: trigger — the declared SLO names plus {manual,
    # watchdog}, routed through bounded_label
    registry.inc(
        f"{_NAMESPACE}_incidents_captured_total",
        {"trigger": bounded_label(f"{_NAMESPACE}_incidents_captured_total", "trigger",
                                  trigger)},
    )


def update_capture_boost(active: float) -> None:
    """volcano_capture_boost_active: 1 while this daemon's exporter is
    inside a cluster capture-boost window, else 0."""
    registry.set_gauge(f"{_NAMESPACE}_capture_boost_active", {}, active)


_LABEL_CARDINALITY_CAP = 256
_label_values: Dict[Tuple[str, str], set] = {}  # guarded-by: _label_values_lock
_label_values_lock = threading.Lock()


def bounded_label(metric: str, label: str, value: str) -> str:
    """Admit ``value`` into the metric's label vocabulary, or collapse
    it to "other" once the per-(metric, label) cap is reached."""
    key = (metric, label)
    with _label_values_lock:
        seen = _label_values.setdefault(key, set())
        if value in seen or len(seen) < _LABEL_CARDINALITY_CAP:
            seen.add(value)
            return value
    # label-vocab: metric — the fixed set of bounded_label call sites
    registry.inc(f"{_NAMESPACE}_metric_label_overflow_total", {"metric": metric})
    return "other"


def update_unschedule_task_count(job_name: str, count: int) -> None:
    """gang.go's per-job unready gauge.  job ∈ the bounded_label-capped
    vocabulary: past _LABEL_CARDINALITY_CAP job names, job="other"."""
    job_name = bounded_label("unschedule_task_count", "job", job_name)
    registry.set_gauge(f"{_NAMESPACE}_unschedule_task_count", {"job": job_name}, count)


def update_unschedule_job_count(count: int) -> None:
    registry.set_gauge(f"{_NAMESPACE}_unschedule_job_count", {}, count)


def register_job_retries(job_name: str) -> None:
    """job ∈ the bounded_label-capped vocabulary (see
    update_unschedule_task_count)."""
    job_name = bounded_label("job_retry_counts", "job", job_name)
    registry.inc(f"{_NAMESPACE}_job_retry_counts", {"job": job_name})


_WELL_KNOWN_REASONS: frozenset = frozenset()


def _well_known_reasons() -> frozenset:
    """The bounded label vocabulary of the per-reason counter (built
    lazily: the api package imports after this module)."""
    global _WELL_KNOWN_REASONS
    if not _WELL_KNOWN_REASONS:
        from volcano_tpu_torch.api import unschedule_info as ui

        _WELL_KNOWN_REASONS = frozenset((
            ui.NODE_RESOURCE_FIT_FAILED,
            ui.NODE_POD_NUMBER_EXCEEDED,
            ui.NODE_SELECTOR_MISMATCH,
            ui.NODE_AFFINITY_MISMATCH,
            ui.NODE_TAINT_UNTOLERATED,
            ui.NODE_PORT_CONFLICT,
            ui.NODE_UNSCHEDULABLE,
            ui.NODE_NOT_READY,
            ui.POD_AFFINITY_MISMATCH,
            "node(s) had memory pressure",
            "node(s) had disk pressure",
            "node(s) had pid pressure",
            "pod has unbound immediate PersistentVolumeClaims",
        ))
    return _WELL_KNOWN_REASONS


def register_unschedulable_reason(reason: str, tasks: int = 1) -> None:
    """Tasks left pending with ``reason`` in their fit-error histogram;
    reason ∈ _well_known_reasons() plus "other": a reason outside the
    well-known vocabulary counts as "other"."""
    if reason not in _well_known_reasons():
        reason = "other"
    registry.inc(f"{_NAMESPACE}_unschedulable_task_reasons", {"reason": reason}, tasks)
