"""Scheduler internal API — the pure data model of a scheduling session.

A copy of ``volcano_tpu/api/__init__.py``.

Reference: pkg/scheduler/api.  ClusterInfo/JobInfo/TaskInfo/NodeInfo/
QueueInfo plus Resource arithmetic.  This host-side model is the source of
truth for session semantics; the device path packs it into tensors
(volcano_tpu_torch/ops/packing.py) and must produce identical bindings.
"""

from volcano_tpu_torch.api.types import (
    TaskStatus,
    NodePhase,
    allocated_status,
    ValidateResult,
)
from volcano_tpu_torch.api.resource import Resource, MIN_MILLI_CPU, MIN_MEMORY, MIN_MILLI_SCALAR
from volcano_tpu_torch.api.job_info import TaskInfo, JobInfo, new_task_info
from volcano_tpu_torch.api.node_info import NodeInfo
from volcano_tpu_torch.api.queue_info import QueueInfo, NamespaceInfo, NamespaceCollection
from volcano_tpu_torch.api.cluster_info import ClusterInfo
from volcano_tpu_torch.api.unschedule_info import FitError, FitErrors

__all__ = [
    "TaskStatus",
    "NodePhase",
    "allocated_status",
    "ValidateResult",
    "Resource",
    "MIN_MILLI_CPU",
    "MIN_MEMORY",
    "MIN_MILLI_SCALAR",
    "TaskInfo",
    "JobInfo",
    "new_task_info",
    "NodeInfo",
    "QueueInfo",
    "NamespaceInfo",
    "NamespaceCollection",
    "ClusterInfo",
    "FitError",
    "FitErrors",
]
