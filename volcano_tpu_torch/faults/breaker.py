"""Circuit breakers for the kernel executors.

A copy of ``volcano_tpu/faults/breaker.py`` for the port: the same
states, threshold and cooldown.  Without a breaker, a kernel that fails
on a session shape would be re-attempted (and re-fail, and re-pay its
failure latency) every cycle:

    CLOSED      normal: requests flow, failures count
    OPEN        tripped (``failure_threshold`` consecutive failures):
                requests are refused without being attempted (the
                port's dispatcher raises; it has no lower rung)
    HALF_OPEN   ``cooldown_s`` after tripping, exactly ONE probe is let
                through; success re-closes (promotes the executor back),
                failure re-opens and restarts the cooldown

State transitions update the ``volcano_circuit_breaker_open{executor}``
gauge (volcano_tpu_torch/metrics/__init__.py).  The JAX package also journals
them in its trace recorder; the port has no trace recorder yet.

Breakers are process-global singletons by name (the executor ladder is
process-global state), fetched with :func:`get_breaker`; tests isolate
with :func:`reset_breakers`.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List

from volcano_tpu_torch import metrics, trace

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"

_STATE_GAUGE = {CLOSED: 0.0, HALF_OPEN: 0.5, OPEN: 1.0}


class CircuitBreaker:
    def __init__(
        self,
        name: str,
        failure_threshold: int = 3,
        cooldown_s: float = 30.0,
    ):
        assert failure_threshold >= 1
        self.name = name
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self._lock = threading.Lock()
        self._state = CLOSED  # guarded-by: self._lock
        self._failures = 0  # guarded-by: self._lock
        self._opened_at = 0.0  # guarded-by: self._lock
        self._probe_started = 0.0  # guarded-by: self._lock
        self._last_error = ""  # guarded-by: self._lock

    # ---- state machine ----

    def allow(self) -> bool:
        """May the protected path be attempted right now?  OPEN past the
        cooldown admits exactly one probe (HALF_OPEN); its outcome must
        be reported via record_success/record_failure."""
        with self._lock:
            now = time.monotonic()
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN:
                # one probe in flight; everyone else is refused.
                # A probe that never reports its outcome (abandoned by
                # the watchdog, killed by an uncaught exception type)
                # must not wedge the breaker half-open forever — after a
                # full cooldown with no verdict, grant a fresh probe.
                if now - self._probe_started >= self.cooldown_s:
                    self._probe_started = now
                    return True
                return False
            if now - self._opened_at >= self.cooldown_s:
                self._probe_started = now
                self._transition(HALF_OPEN)
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            if self._state != CLOSED:
                self._transition(CLOSED)

    def record_failure(self, error: str = "") -> None:
        with self._lock:
            self._last_error = error
            self._failures += 1
            if self._state == HALF_OPEN or (
                self._state == CLOSED
                and self._failures >= self.failure_threshold
            ):
                self._opened_at = time.monotonic()
                self._transition(OPEN)
            elif self._state == OPEN:
                # a failure reported while open (e.g. a half-open probe
                # raced another thread's failure) restarts the cooldown
                self._opened_at = time.monotonic()

    def _transition(self, state: str) -> None:
        # requires-lock: self._lock
        prev, self._state = self._state, state
        if state == OPEN:
            self._failures = 0
        metrics.update_circuit_breaker_state(self.name, _STATE_GAUGE[state])
        rec = trace.get_recorder()
        if rec.enabled:
            rec.event(
                f"breaker:{self.name}:{state}", "fault",
                prev=prev, error=self._last_error,
            )

    # ---- observability ----

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def open(self) -> bool:
        return self.state != CLOSED

    @property
    def degraded(self) -> bool:
        """Open or half-open, or closed with a streak of failures that
        has not yet tripped it: its executor failed at its last
        attempt."""
        with self._lock:
            return self._state != CLOSED or self._failures > 0

    def reason(self) -> str:
        with self._lock:
            msg = f"circuit breaker {self.name} {self._state}"
            if self._state == CLOSED and self._failures:
                msg += f" after {self._failures} consecutive failure(s)"
            if self._last_error:
                msg += f" (last error: {self._last_error})"
            return msg


_breakers: Dict[str, CircuitBreaker] = {}  # guarded-by: _registry_lock
_registry_lock = threading.Lock()


def get_breaker(
    name: str,
    failure_threshold: int = 3,
    cooldown_s: float = 30.0,
) -> CircuitBreaker:
    """Per-name singleton; constructor args apply on first fetch only."""
    with _registry_lock:
        br = _breakers.get(name)
        if br is None:
            br = CircuitBreaker(
                name,
                failure_threshold=failure_threshold,
                cooldown_s=cooldown_s,
            )
            _breakers[name] = br
        return br


def all_breakers() -> List[CircuitBreaker]:
    with _registry_lock:
        return list(_breakers.values())


def degraded_reasons() -> List[str]:
    """Human-readable reasons for every degraded breaker: open,
    half-open, or closed on a streak of failures (the JAX package lists
    only the first two; the port shows every failure until its executor
    succeeds again).  Empty list = fully healthy."""
    return [br.reason() for br in all_breakers() if br.degraded]


def reset_breakers() -> None:
    """Drop all breakers (test isolation)."""
    with _registry_lock:
        _breakers.clear()
