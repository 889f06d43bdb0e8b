"""Pod admission gate — delay pod creation until its PodGroup leaves
Pending.

A copy of ``volcano_tpu/admission/pods.py``.

Reference: pkg/admission/pods/admit_pod.go:96-134 (the delay-pod-creation
design, docs/design/delay-pod-creation.md).
"""

from __future__ import annotations

from typing import Optional

from volcano_tpu_torch.apis import core, scheduling
from volcano_tpu_torch.client.apiserver import AdmissionError, APIServer


def validate_pod(
    pod: core.Pod, api: APIServer, scheduler_name: str = "volcano-tpu"
) -> None:
    """Allow when (1) not our scheduler, (2) podgroup exists and is
    non-pending, (3) normal pod with no podgroup yet."""
    if pod.spec.scheduler_name != scheduler_name:
        return

    pg_name = pod.metadata.annotations.get(scheduling.GROUP_NAME_ANNOTATION_KEY, "")
    if pg_name:
        # vc-job pod: podgroup must exist and be past Pending.
        pg = api.get("PodGroup", pod.metadata.namespace, pg_name)
        if pg is None:
            raise AdmissionError(
                f"failed to create pod <{pod.key()}>: cannot find PodGroup {pg_name}"
            )
        if pg.status.phase == scheduling.POD_GROUP_PENDING:
            raise AdmissionError(
                f"failed to create pod <{pod.key()}>: PodGroup {pg_name} is Pending"
            )
        return

    # Normal pod: its auto-created podgroup (podgroup controller) may not
    # exist yet — allowed; once it exists it must be past Pending.
    from volcano_tpu_torch.controllers.podgroup_controller import pod_group_name

    pg = api.get("PodGroup", pod.metadata.namespace, pod_group_name(pod))
    if pg is not None and pg.status.phase == scheduling.POD_GROUP_PENDING:
        raise AdmissionError(
            f"failed to create pod <{pod.key()}>: PodGroup {pod_group_name(pod)} is Pending"
        )
