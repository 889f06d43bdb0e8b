"""Dual-version scheduling API: v1alpha1/v1alpha2 shims + conversion.

A copy of ``volcano_tpu/apis/scheme.py``.

Reference: pkg/apis/scheduling/{v1alpha1,v1alpha2}/types.go with the hub
conversion scheme in pkg/apis/scheduling/scheme/scheme.go, consumed by
the cache's dual informer set (pkg/scheduler/cache/cache.go:393-424 —
AddPodGroupV1alpha1/V1alpha2, AddQueueV1alpha1/V1alpha2).

The hub (volcano_tpu_torch/apis/scheduling.py) matches v1alpha2's shape; the
versioned types differ exactly where the reference's do:

  * v1alpha1 Queue has NO spec.state and NO status {state, inqueue}
    (QueueState/Inqueue were added in v1alpha2);
  * PodGroup is field-identical across versions (the v1alpha2 file only
    adds queue event/action enums, not PodGroup fields).

Conversion therefore defaults a v1alpha1 queue's state to Open on the
way in and drops state/inqueue on the way out — byte-faithful to what
scheme.Convert does through the hub types.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

from volcano_tpu_torch.apis import scheduling
from volcano_tpu_torch.apis.core import K8sObject


# ---- v1alpha1 types (pkg/apis/scheduling/v1alpha1/types.go) ----


@dataclass
class PodGroupV1alpha1(K8sObject):
    """Field-identical to the hub PodGroup; distinct type = distinct
    apiVersion on the wire."""

    spec: scheduling.PodGroupSpec = field(default_factory=scheduling.PodGroupSpec)
    status: scheduling.PodGroupStatus = field(
        default_factory=scheduling.PodGroupStatus
    )


@dataclass
class QueueSpecV1alpha1:
    weight: int = 1
    capability: Dict[str, object] = field(default_factory=dict)
    # no `state` — QueueState is v1alpha2-only


@dataclass
class QueueStatusV1alpha1:
    unknown: int = 0
    pending: int = 0
    running: int = 0
    # no `state` / `inqueue` — v1alpha2-only


@dataclass
class QueueV1alpha1(K8sObject):
    spec: QueueSpecV1alpha1 = field(default_factory=QueueSpecV1alpha1)
    status: QueueStatusV1alpha1 = field(default_factory=QueueStatusV1alpha1)


# v1alpha2 is the hub shape — aliases make the version explicit at call
# sites (the reference's v1alpha2 structs are what the hub mirrors).
PodGroupV1alpha2 = scheduling.PodGroup
QueueV1alpha2 = scheduling.Queue


# ---- conversions (scheme.go Convert through the hub) ----


def pod_group_v1alpha1_to_hub(pg: PodGroupV1alpha1) -> scheduling.PodGroup:
    # scheme.Convert deep-copies: the hub object must not alias the
    # versioned input (cache state would otherwise mutate silently when
    # the caller keeps writing to its object).
    src = pg.clone()
    return scheduling.PodGroup(metadata=src.metadata, spec=src.spec, status=src.status)


def pod_group_hub_to_v1alpha1(pg: scheduling.PodGroup) -> PodGroupV1alpha1:
    src = pg.clone()
    return PodGroupV1alpha1(metadata=src.metadata, spec=src.spec, status=src.status)


def queue_v1alpha1_to_hub(q: QueueV1alpha1) -> scheduling.Queue:
    q = q.clone()
    return scheduling.Queue(
        metadata=q.metadata,
        spec=scheduling.QueueSpec(
            weight=q.spec.weight,
            capability=dict(q.spec.capability),
            state=scheduling.QUEUE_STATE_OPEN,  # defaulted on conversion
        ),
        status=scheduling.QueueStatus(
            unknown=q.status.unknown,
            pending=q.status.pending,
            running=q.status.running,
        ),
    )


def queue_hub_to_v1alpha1(q: scheduling.Queue) -> QueueV1alpha1:
    q = q.clone()
    return QueueV1alpha1(
        metadata=q.metadata,
        spec=QueueSpecV1alpha1(
            weight=q.spec.weight, capability=dict(q.spec.capability)
        ),
        status=QueueStatusV1alpha1(
            unknown=q.status.unknown,
            pending=q.status.pending,
            running=q.status.running,
        ),
    )
