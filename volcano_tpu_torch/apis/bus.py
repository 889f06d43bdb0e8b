"""Bus API: the Command CR — out-of-band operation channel.

A copy of ``volcano_tpu/apis/bus.py``.

Reference: pkg/apis/bus/v1alpha1/types.go:11-28.  A Command carries an
action aimed at a target object (Job or Queue); the owning controller
consumes and deletes it.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from volcano_tpu_torch.apis.core import K8sObject, OwnerReference


@dataclass
class Command(K8sObject):
    action: str = ""
    target_object: OwnerReference = field(default_factory=OwnerReference)
    reason: str = ""
    message: str = ""
