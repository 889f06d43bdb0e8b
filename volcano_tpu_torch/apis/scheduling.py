"""Scheduling API: PodGroup and Queue.

A copy of ``volcano_tpu/apis/scheduling.py``.

Reference: pkg/apis/scheduling/v1alpha2/types.go (single hub version here —
the reference's v1alpha1/v1alpha2 dual-version plumbing is a Kubernetes
migration artifact with no behavioral content).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from volcano_tpu_torch.apis.core import K8sObject

# PodGroup phases (types.go:42-57)
POD_GROUP_PENDING = "Pending"
POD_GROUP_RUNNING = "Running"
POD_GROUP_UNKNOWN = "Unknown"
POD_GROUP_INQUEUE = "Inqueue"

# PodGroup condition types / reasons (types.go:61-113)
POD_GROUP_UNSCHEDULABLE_TYPE = "Unschedulable"
POD_GROUP_SCHEDULED_TYPE = "Scheduled"
NOT_ENOUGH_RESOURCES_REASON = "NotEnoughResources"
NOT_ENOUGH_PODS_REASON = "NotEnoughTasks"

# Queue states (types.go:30-39)
QUEUE_STATE_OPEN = "Open"
QUEUE_STATE_CLOSED = "Closed"
QUEUE_STATE_CLOSING = "Closing"
QUEUE_STATE_UNKNOWN = "Unknown"

# Annotation linking a Pod to its PodGroup (v1alpha2 GroupNameAnnotationKey).
GROUP_NAME_ANNOTATION_KEY = "scheduling.volcano-tpu.io/group-name"


@dataclass
class PodGroupCondition:
    type: str = ""
    status: str = ""
    transition_id: str = ""
    last_transition_time: float = 0.0
    reason: str = ""
    message: str = ""


@dataclass
class PodGroupSpec:
    min_member: int = 0
    queue: str = "default"
    priority_class_name: str = ""
    # Aggregate resource floor for minMember tasks; gate for enqueue.
    min_resources: Dict[str, object] = field(default_factory=dict)


@dataclass
class PodGroupStatus:
    phase: str = POD_GROUP_PENDING
    conditions: List[PodGroupCondition] = field(default_factory=list)
    running: int = 0
    succeeded: int = 0
    failed: int = 0


@dataclass
class PodGroup(K8sObject):
    spec: PodGroupSpec = field(default_factory=PodGroupSpec)
    status: PodGroupStatus = field(default_factory=PodGroupStatus)


@dataclass
class QueueSpec:
    weight: int = 1
    capability: Dict[str, object] = field(default_factory=dict)
    state: str = QUEUE_STATE_OPEN


@dataclass
class QueueStatus:
    state: str = ""
    unknown: int = 0
    pending: int = 0
    running: int = 0
    inqueue: int = 0


@dataclass
class Queue(K8sObject):
    spec: QueueSpec = field(default_factory=QueueSpec)
    status: QueueStatus = field(default_factory=QueueStatus)
