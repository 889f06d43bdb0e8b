"""volcano_tpu_torch.trace — the cycle correlation id of
``volcano_tpu/trace/__init__.py``.

The scheduler loop numbers its cycles (``Scheduler.run_once``) and
parks the number here; the explain summary of a cycle
(``actions/gpu_allocate._publish_explain``) carries it to
``GET /explain``.  The trace recorder, its journal and replay are not
present in the port yet: a session carries a null recorder
(``framework/session.NullRecorder``).
"""

from __future__ import annotations

#: id of the scheduling cycle currently executing in this process (-1
#: outside a cycle), set by the scheduler loop every run_once
_current_cycle: int = -1


def set_current_cycle(cycle_id: int) -> None:
    global _current_cycle
    _current_cycle = cycle_id


def current_cycle() -> int:
    return _current_cycle
