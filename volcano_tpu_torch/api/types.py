"""Task/node status enums and callback result types.

A copy of ``volcano_tpu/api/types.py``.

Reference: pkg/scheduler/api/types.go.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class TaskStatus(enum.IntFlag):
    """Status of a task/pod in the scheduler (types.go:26-58)."""

    Pending = enum.auto()
    Allocated = enum.auto()
    Pipelined = enum.auto()
    Binding = enum.auto()
    Bound = enum.auto()
    Running = enum.auto()
    Releasing = enum.auto()
    Succeeded = enum.auto()
    Failed = enum.auto()
    Unknown = enum.auto()


#: Statuses whose resources are held on a node ("occupied").
#: Reference: types.go AllocatedStatus (Bound/Binding/Running/Allocated).
#: Frozenset membership instead of Flag arithmetic — enum ``__and__``
#: dominated the scheduler's hot comparator path (ready_task_num is
#: evaluated on every PriorityQueue compare).
ALLOCATED_STATUSES = frozenset(
    (TaskStatus.Bound, TaskStatus.Binding, TaskStatus.Running, TaskStatus.Allocated)
)


def allocated_status(status: TaskStatus) -> bool:
    return status in ALLOCATED_STATUSES


class NodePhase(enum.IntEnum):
    Ready = 1
    NotReady = 2


@dataclass
class ValidateResult:
    """Result of a JobValid callback (types.go ValidateResult)."""

    pass_: bool = True
    reason: str = ""
    message: str = ""
