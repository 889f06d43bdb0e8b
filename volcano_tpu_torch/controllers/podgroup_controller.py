"""PodGroup controller — auto-create a PodGroup for normal pods using the
volcano scheduler so they gang-schedule as singletons.

A copy of ``volcano_tpu/controllers/podgroup_controller.py``.

Reference: pkg/controllers/podgroup/{pg_controller.go,
pg_controller_handler.go} (filter :73-91, createNormalPodPGIfNotExist).
"""

from __future__ import annotations

import queue as _queue

from volcano_tpu_torch.apis import core, scheduling
from volcano_tpu_torch.client import ADDED, AlreadyExistsError, APIServer, KubeClient, VolcanoClient
from volcano_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def pod_group_name(pod: core.Pod) -> str:
    """helpers.GeneratePodgroupName — podgroup-<pod uid>."""
    return f"podgroup-{pod.metadata.uid or pod.metadata.name}"


class PodGroupController:
    def __init__(self, api: APIServer, scheduler_name: str = "volcano-tpu"):
        self.api = api
        self.kube = KubeClient(api)
        self.vc = VolcanoClient(api)
        self.scheduler_name = scheduler_name
        self.queue: _queue.Queue = _queue.Queue()
        api.watch("Pod", self._on_pod)

    def _on_pod(self, event, old, new) -> None:
        """pg_controller.go:73-91 — normal (non-vc-job) pods using our
        scheduler and lacking a group annotation."""
        if event != ADDED:
            return
        pod: core.Pod = new
        if pod.spec.scheduler_name != self.scheduler_name:
            return
        if scheduling.GROUP_NAME_ANNOTATION_KEY in pod.metadata.annotations:
            return
        self.queue.put((pod.metadata.namespace, pod.metadata.name))

    def process_next(self) -> bool:
        try:
            namespace, name = self.queue.get(block=False)
        except _queue.Empty:
            return False
        pod = self.kube.get_pod(namespace, name)
        if pod is None:
            return True
        try:
            self._create_normal_pod_pg_if_not_exist(pod)
        except Exception as e:  # noqa: BLE001
            log.error("failed to create podgroup for pod %s/%s: %s", namespace, name, e)
        return True

    def drain(self) -> None:
        while self.process_next():
            pass

    def _create_normal_pod_pg_if_not_exist(self, pod: core.Pod) -> None:
        pg_name = pod_group_name(pod)
        if self.vc.get_pod_group(pod.metadata.namespace, pg_name) is None:
            pg = scheduling.PodGroup(
                metadata=core.ObjectMeta(
                    name=pg_name,
                    namespace=pod.metadata.namespace,
                    owner_references=list(pod.metadata.owner_references),
                ),
                spec=scheduling.PodGroupSpec(min_member=1, queue="default"),
                status=scheduling.PodGroupStatus(phase=scheduling.POD_GROUP_PENDING),
            )
            try:
                self.vc.create_pod_group(pg)
            except AlreadyExistsError:
                pass
        # Stamp the pod with the group annotation.
        pod.metadata.annotations[scheduling.GROUP_NAME_ANNOTATION_KEY] = pg_name
        self.kube.update_pod(pod)
