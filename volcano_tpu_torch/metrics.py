"""The port's metrics sink: what its dispatcher, breakers and fault plane
write, under the names of ``volcano_tpu/metrics/metrics.py``.

``volcano_executor_failures_total{executor,cause}`` counts every failed or
refused kernel call (the reference counts a demotion to a lower rung,
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

    @staticmethod
    def _key(name: str, labels: Dict[str, str]) -> _Key:
        return name, tuple(sorted(labels.items()))

    def inc(self, name: str, labels: Dict[str, str], value: float = 1.0) -> None:
        with self._lock:
            self._counters[self._key(name, labels)] += value

    def set_gauge(self, name: str, labels: Dict[str, str], value: float) -> None:
        with self._lock:
            self._gauges[self._key(name, labels)] = value

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

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()


registry = Registry()


def register_executor_failure(executor: str, cause: str) -> None:
    """One failed or refused call of ``executor``; cause ∈ {error,
    circuit-open, corrupt-output}."""
    registry.inc(f"{_NAMESPACE}_executor_failures_total",
                 {"executor": executor, "cause": cause})


def update_circuit_breaker_state(executor: str, value: float) -> None:
    """0 = closed, 0.5 = half-open (probing), 1 = open (tripped)."""
    registry.set_gauge(f"{_NAMESPACE}_circuit_breaker_open", {"executor": executor}, value)


def register_fault_injected(point: str) -> None:
    """One firing of the fault plane at ``point``."""
    registry.inc(f"{_NAMESPACE}_faults_injected_total", {"point": point})
