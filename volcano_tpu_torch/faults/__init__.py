"""volcano_tpu_torch.faults — deterministic fault injection and circuit
breakers for the port: copies of ``volcano_tpu/faults``.

* :mod:`.plane` — the seedable fault-injection plane (``VTPU_FAULTS``):
  named injection points at every recovery seam, deterministic per-point
  decision streams, a no-op by default.
* :mod:`.breaker` — per-executor circuit breakers with cooldown and
  half-open re-probe, around the kernel executors of
  ``ops/dispatch.py`` (``cuda``, ``preempt-cuda``), which raise where
  their kernel fails or their breaker is open.
* :mod:`.watchdog` — the cycle deadline and ``run_with_deadline``.

The hot-path guard::

    from volcano_tpu_torch import faults
    fp = faults.get_plane()
    if fp.enabled and fp.should("device.lowering"):
        ...inject...
"""

from volcano_tpu_torch.faults.breaker import (
    all_breakers,
    CircuitBreaker,
    degraded_reasons,
    get_breaker,
    reset_breakers,
)
from volcano_tpu_torch.faults.plane import (
    configure,
    FaultPlane,
    FaultRule,
    FaultSpec,
    get_plane,
    NullFaultPlane,
    parse_faults,
)
from volcano_tpu_torch.faults.watchdog import (
    abandoned,
    begin_cycle,
    configure_deadline,
    CycleDeadlineExceeded,
    remaining_s,
    run_with_deadline,
)

__all__ = [
    "abandoned",
    "all_breakers",
    "begin_cycle",
    "CircuitBreaker",
    "configure",
    "configure_deadline",
    "CycleDeadlineExceeded",
    "degraded_reasons",
    "FaultPlane",
    "FaultRule",
    "FaultSpec",
    "get_breaker",
    "get_plane",
    "NullFaultPlane",
    "parse_faults",
    "remaining_s",
    "reset_breakers",
    "run_with_deadline",
]
