"""Shared API helpers (reference: pkg/apis/helpers/helpers.go).

A copy of ``volcano_tpu/apis/helpers.py``.
"""

from __future__ import annotations

from volcano_tpu_torch.apis.core import K8sObject, OwnerReference


def owner_reference(obj: K8sObject, controller: bool = True) -> OwnerReference:
    """Build an OwnerReference to ``obj`` (helpers.go CreatedBy* helpers)."""
    return OwnerReference(
        api_version="volcano-tpu.io/v1",
        kind=obj.kind,
        name=obj.metadata.name,
        uid=obj.metadata.uid,
        controller=controller,
        block_owner_deletion=True,
    )


def is_controlled_by(obj: K8sObject, owner: K8sObject) -> bool:
    for ref in obj.metadata.owner_references:
        if ref.controller and ref.uid == owner.metadata.uid:
            return True
    return False


def generate_podgroup_name(pod_or_job: K8sObject) -> str:
    """PodGroup name derived from its owning object (helpers.go)."""
    return f"podgroup-{pod_or_job.metadata.uid or pod_or_job.metadata.name}"
