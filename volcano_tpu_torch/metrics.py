"""The port's metrics sink: what its dispatcher, breakers and fault plane
write, under the names of ``volcano_tpu/metrics/metrics.py``.

The scheduling cycle writes the series the JAX package's framework, cache,
plugins and actions write (plugin and task latencies, schedule attempts,
unschedulable reasons, kernel phase latencies, the explain reduction's
latency, preemption victims and attempts), each under the same name
and labels; a histogram keeps its count and sum.

``volcano_executor_failures_total{executor,cause}`` counts every failed or
refused kernel call, a device phase that overran the cycle deadline and
a preempt or reclaim result that diverged while it was applied included
(the reference counts a demotion to a lower rung or to the host,
``volcano_executor_fallbacks_total``; the port falls to none),
``volcano_circuit_breaker_open{executor}``
holds each breaker's state, and ``volcano_faults_injected_total{point}``
counts the fault plane's firings.  Values live in process memory in
``registry``, keyed as the JAX package's registry keys them, so a test or
an operator reads them with :meth:`Registry.counter` and
:meth:`Registry.gauge`.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict, Tuple

_NAMESPACE = "volcano"

_Key = Tuple[str, Tuple[Tuple[str, str], ...]]


class Registry:
    """In-process counters and gauges, keyed by (name, sorted labels)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[_Key, float] = defaultdict(float)  # guarded-by: self._lock
        self._gauges: Dict[_Key, float] = {}  # guarded-by: self._lock
        #: (name, labels) → [count, sum]
        self._hists: Dict[_Key, list] = {}  # guarded-by: self._lock

    @staticmethod
    def _key(name: str, labels: Dict[str, str]) -> _Key:
        return name, tuple(sorted(labels.items()))

    def inc(self, name: str, labels: Dict[str, str], value: float = 1.0) -> None:
        with self._lock:
            self._counters[self._key(name, labels)] += value

    def set_gauge(self, name: str, labels: Dict[str, str], value: float) -> None:
        with self._lock:
            self._gauges[self._key(name, labels)] = value

    def observe(self, name: str, labels: Dict[str, str], value: float) -> None:
        with self._lock:
            h = self._hists.setdefault(self._key(name, labels), [0, 0.0])
            h[0] += 1
            h[1] += value

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
            count, total = self._hists.get(self._key(name, labels), (0, 0.0))
            return count, total

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


registry = Registry()


def register_executor_failure(executor: str, cause: str) -> None:
    """One failed or refused call of ``executor``; cause ∈ {error,
    circuit-open, corrupt-output, deadline, diverged}."""
    registry.inc(f"{_NAMESPACE}_executor_failures_total",
                 {"executor": executor, "cause": cause})


def update_circuit_breaker_state(executor: str, value: float) -> None:
    """0 = closed, 0.5 = half-open (probing), 1 = open (tripped)."""
    registry.set_gauge(f"{_NAMESPACE}_circuit_breaker_open", {"executor": executor}, value)


def register_fault_injected(point: str) -> None:
    """One firing of the fault plane at ``point``."""
    registry.inc(f"{_NAMESPACE}_faults_injected_total", {"point": point})


def update_kernel_duration(phase: str, seconds: float) -> None:
    """phase ∈ {pack, execute} of gpu-allocate's KERNEL phase."""
    registry.observe(f"{_NAMESPACE}_tpu_kernel_latency_milliseconds",
                     {"phase": phase}, seconds * 1e3)


def update_plugin_duration(plugin_name: str, seconds: float) -> None:
    registry.observe(f"{_NAMESPACE}_plugin_scheduling_latency_microseconds",
                     {"plugin": plugin_name}, seconds * 1e6)


def update_task_schedule_duration(seconds: float) -> None:
    registry.observe(f"{_NAMESPACE}_task_scheduling_latency_microseconds", {},
                     seconds * 1e6)


def update_job_schedule_duration(seconds: float) -> None:
    """Per-job latency, creation → first scheduled cycle."""
    registry.observe(f"{_NAMESPACE}_e2e_job_scheduling_latency_milliseconds", {},
                     seconds * 1e3)


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


def register_commit_failure(kind: str) -> None:
    """A bind or evict effect that failed (kind ∈ {bind, evict})."""
    registry.inc(f"{_NAMESPACE}_commit_failures_total", {"kind": kind})


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
    registry.inc(f"{_NAMESPACE}_metric_label_overflow_total", {"metric": metric})
    return "other"


def update_unschedule_task_count(job_name: str, count: int) -> None:
    job_name = bounded_label("unschedule_task_count", "job", job_name)
    registry.set_gauge(f"{_NAMESPACE}_unschedule_task_count", {"job": job_name}, count)


def update_unschedule_job_count(count: int) -> None:
    registry.set_gauge(f"{_NAMESPACE}_unschedule_job_count", {}, count)


def register_job_retries(job_name: str) -> None:
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
    a reason outside the well-known vocabulary counts as "other"."""
    if reason not in _well_known_reasons():
        reason = "other"
    registry.inc(f"{_NAMESPACE}_unschedulable_task_reasons", {"reason": reason}, tasks)
