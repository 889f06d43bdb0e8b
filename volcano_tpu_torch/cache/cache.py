"""SchedulerCache — mutex-guarded mirror of cluster state.

The synchronous path of ``volcano_tpu/cache/cache.py``: the event
handlers for pods, nodes, PodGroups, queues, priority classes and PVCs,
the full snapshot, and bind/evict/volume/status effects dispatched
inline on the calling thread.  Not present in the port yet: the
pipelined commit plane, the warm packer's change tracking (PackEpoch,
dirty marks, ``pack_cache``), the incremental share ledger, the resync
worker and its quarantine, change listeners, the informer sink, and the
resource-quota handlers (the namespace weights of drf's weighted
namespace order).  A failed bind or evict is queued in ``err_tasks`` for
the resync a later slice brings, as the reference queues it when it has
no API client.

Reference: pkg/scheduler/cache/cache.go + event_handlers.go.  Fed by
event handlers (called directly, the reference's own unit-test pattern,
allocate_test.go:155-222); produces deep-copied snapshots.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from volcano_tpu_torch import metrics
from volcano_tpu_torch.api import (
    ClusterInfo,
    JobInfo,
    new_task_info,
    NodeInfo,
    QueueInfo,
    TaskInfo,
    TaskStatus,
)
from volcano_tpu_torch.apis import core, scheduling
from volcano_tpu_torch.cache.interface import Binder, Cache, Evictor, StatusUpdater
from volcano_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def is_terminated(status: TaskStatus) -> bool:
    return status in (TaskStatus.Succeeded, TaskStatus.Failed)


class SchedulerCache(Cache):
    def __init__(
        self,
        binder: Optional[Binder] = None,
        evictor: Optional[Evictor] = None,
        status_updater: Optional[StatusUpdater] = None,
        default_queue: str = "default",
        default_priority: int = 0,
    ):
        self._mutex = threading.RLock()
        self.default_queue = default_queue
        self.default_priority = default_priority

        self.jobs: Dict[str, JobInfo] = {}  # guarded-by: self._mutex
        self.nodes: Dict[str, NodeInfo] = {}  # guarded-by: self._mutex
        self.queues: Dict[str, QueueInfo] = {}  # guarded-by: self._mutex
        self.priority_classes: Dict[str, core.PriorityClass] = {}  # guarded-by: self._mutex
        #: PVCs keyed "ns/name" (pvcInformer, cache.go:415-421)
        self.pvcs: Dict[str, core.PersistentVolumeClaim] = {}  # guarded-by: self._mutex

        self.binder = binder
        self.evictor = evictor
        self.status_updater = status_updater

        #: tasks whose side effects failed, deduped by uid (cache.go:687-709
        #: errTasks); nothing drains it in the port yet
        self.err_tasks: List[TaskInfo] = []  # guarded-by: self._mutex

    # ---- lifecycle ----

    def run(self) -> None:
        """No informers: the port's cache is fed through its handlers."""

    def wait_for_cache_sync(self) -> bool:
        return True

    # ---- event handlers: pods (event_handlers.go:39-254) ----

    def _get_or_create_job(self, ti: TaskInfo) -> Optional[JobInfo]:
        # requires-lock: self._mutex
        """event_handlers.go:44-58 — only pods carrying a PodGroup
        annotation get a job; others are node-accounting-only."""
        if not ti.job:
            return None
        if ti.job not in self.jobs:
            self.jobs[ti.job] = JobInfo(ti.job)
        return self.jobs[ti.job]

    def _add_task(self, ti: TaskInfo) -> None:
        # requires-lock: self._mutex
        """event_handlers.go:60-79."""
        job = self._get_or_create_job(ti)
        if job is not None:
            job.add_task_info(ti)
        if ti.node_name:
            if ti.node_name not in self.nodes:
                self.nodes[ti.node_name] = NodeInfo(None)
                self.nodes[ti.node_name].name = ti.node_name
            if not is_terminated(ti.status):
                try:
                    self.nodes[ti.node_name].add_task(ti)
                except ValueError as e:
                    # a double add — the reference logs and keeps the
                    # node-held task (event_handlers.go AddPod error path)
                    log.debug("add task to node: %s", e)

    def _delete_task(self, ti: TaskInfo) -> None:
        # requires-lock: self._mutex
        """event_handlers.go:126-151."""
        if ti.job and ti.job in self.jobs:
            job = self.jobs[ti.job]
            stored = job.tasks.get(ti.uid)
            if stored is not None:
                job.delete_task_info(stored)
        if ti.node_name and ti.node_name in self.nodes:
            node = self.nodes[ti.node_name]
            if ti.uid in node.tasks:
                node.remove_task(ti)

    def add_pod(self, pod: core.Pod) -> None:
        with self._mutex:
            self._add_task(new_task_info(pod))

    def update_pod(self, old_pod: core.Pod, new_pod: core.Pod) -> None:
        with self._mutex:
            self._delete_task(new_task_info(old_pod))
            self._add_task(new_task_info(new_pod))

    def delete_pod(self, pod: core.Pod) -> None:
        with self._mutex:
            self._delete_task(new_task_info(pod))

    # ---- event handlers: nodes (event_handlers.go:255-354) ----

    def add_node(self, node: core.Node) -> None:
        with self._mutex:
            name = node.metadata.name
            if name in self.nodes:
                self.nodes[name].set_node(node)
            else:
                self.nodes[name] = NodeInfo(node)

    def update_node(self, old_node: core.Node, new_node: core.Node) -> None:
        self.add_node(new_node)

    def delete_node(self, node: core.Node) -> None:
        with self._mutex:
            self.nodes.pop(node.metadata.name, None)

    # ---- event handlers: podgroups (event_handlers.go:356-581) ----

    def add_pod_group(self, pg: scheduling.PodGroup) -> None:
        with self._mutex:
            job_id = pg.key()
            if job_id not in self.jobs:
                self.jobs[job_id] = JobInfo(job_id)
            self.jobs[job_id].set_pod_group(pg)

    def update_pod_group(self, old_pg, new_pg: scheduling.PodGroup) -> None:
        self.add_pod_group(new_pg)

    def delete_pod_group(self, pg: scheduling.PodGroup) -> None:
        with self._mutex:
            job = self.jobs.get(pg.key())
            if job is not None:
                job.pod_group = None
                # Jobs without scheduling spec drop out of snapshots; GC'd
                # when tasks drain (cleanup worker in the reference).
                if not job.tasks:
                    del self.jobs[pg.key()]

    # ---- event handlers: queues (event_handlers.go:696-863) ----

    def add_queue(self, queue: scheduling.Queue) -> None:
        with self._mutex:
            qi = QueueInfo(queue)
            self.queues[qi.uid] = qi

    def update_queue(self, old_queue, new_queue: scheduling.Queue) -> None:
        self.add_queue(new_queue)

    def delete_queue(self, queue: scheduling.Queue) -> None:
        with self._mutex:
            self.queues.pop(queue.metadata.name, None)

    # ---- event handlers: priority classes (event_handlers.go:865-958) ----

    def add_priority_class(self, pc: core.PriorityClass) -> None:
        with self._mutex:
            self.priority_classes[pc.metadata.name] = pc
            if pc.global_default:
                self.default_priority = pc.value

    def delete_priority_class(self, pc: core.PriorityClass) -> None:
        with self._mutex:
            self.priority_classes.pop(pc.metadata.name, None)
            if pc.global_default:
                self.default_priority = 0

    # ---- PVC handlers (pvcInformer wiring, cache.go:415-421) ----

    def add_pvc(self, pvc: core.PersistentVolumeClaim) -> None:
        with self._mutex:
            self.pvcs[f"{pvc.metadata.namespace}/{pvc.metadata.name}"] = pvc

    def update_pvc(self, old, new: core.PersistentVolumeClaim) -> None:
        self.add_pvc(new)

    def delete_pvc(self, pvc: core.PersistentVolumeClaim) -> None:
        with self._mutex:
            self.pvcs.pop(f"{pvc.metadata.namespace}/{pvc.metadata.name}", None)

    # ---- snapshot (cache.go:712-790) ----

    def snapshot(self) -> ClusterInfo:
        """Every ready node, queue and PVC, and every job with a PodGroup
        in a known queue, deep-copied for one session."""
        with self._mutex:
            snapshot = ClusterInfo()
            for node in self.nodes.values():
                if node.ready():
                    snapshot.nodes[node.name] = node.clone()
            for queue in self.queues.values():
                snapshot.queues[queue.uid] = queue.clone()
            for key, pvc in self.pvcs.items():
                snapshot.pvcs[key] = pvc.clone()
            for job in self.jobs.values():
                # No scheduling spec → not schedulable (cache.go:765-770).
                if job.pod_group is None:
                    continue
                if job.queue not in snapshot.queues:
                    continue
                job.priority = self.default_priority
                pc = self.priority_classes.get(job.pod_group.spec.priority_class_name)
                if pc is not None:
                    job.priority = pc.value
                snapshot.jobs[job.uid] = job.clone()
            return snapshot

    # ---- side effects (cache.go:498-615) ----

    def _find_job_and_task(self, task_info: TaskInfo):
        # requires-lock: self._mutex
        job = self.jobs.get(task_info.job)
        if job is None:
            raise KeyError(f"failed to find job {task_info.job}")
        task = job.tasks.get(task_info.uid)
        if task is None:
            raise KeyError(
                f"failed to find task in status {task_info.status.name} by id {task_info.uid}"
            )
        return job, task

    def bind(self, task_info: TaskInfo, hostname: str) -> None:
        """cache.go:557-615."""
        self.bind_batch([(task_info, hostname)])

    def bind_batch(self, pairs) -> None:
        """Bind many (task_info, hostname) pairs: the per-task state
        mutations under ONE mutex hold, then the binder effects in task
        order.  Every pair is resolved before any is mutated, so a bad
        pair leaves no task mutated with its binder effect dropped.
        This is the bulk-commit path of fully-placed device sessions
        (actions/fast_apply.py)."""
        bound = []
        with self._mutex:
            resolved = []
            for task_info, hostname in pairs:
                job, task = self._find_job_and_task(task_info)
                node = self.nodes.get(hostname)
                if node is None:
                    raise KeyError(
                        f"failed to bind task {task.uid} to host {hostname}:"
                        " host not found"
                    )
                resolved.append((job, task, node, hostname))
            for job, task, node, hostname in resolved:
                job.update_task_status(task, TaskStatus.Binding)
                task.node_name = hostname
                node.add_task(task)
                bound.append((task, hostname))

        for task, hostname in bound:
            try:
                if self.binder is not None:
                    self.binder.bind(task, hostname)
            except Exception as e:  # noqa: BLE001
                log.error("bind of %s/%s failed: %s", task.namespace, task.name, e)
                metrics.register_commit_failure("bind")
                metrics.update_pod_schedule_status("errors")
                self.resync_task(task)
            else:
                metrics.update_pod_schedule_status("successes")

    def evict(self, task_info: TaskInfo, reason: str) -> None:
        """cache.go:498-554."""
        with self._mutex:
            job, task = self._find_job_and_task(task_info)
            node = self.nodes.get(task.node_name)
            if node is None:
                raise KeyError(
                    f"failed to evict task {task.uid}: host {task.node_name} not found"
                )
            job.update_task_status(task, TaskStatus.Releasing)
            node.update_task(task)
        try:
            if self.evictor is not None:
                self.evictor.evict(task)
        except Exception as e:  # noqa: BLE001
            log.error("evict of %s/%s failed: %s", task.namespace, task.name, e)
            metrics.register_commit_failure("evict")
            self.resync_task(task)

    def resync_task(self, task: TaskInfo) -> None:
        """Queue a task whose effect failed for resync from API truth
        (cache.go:687-709), once per uid."""
        with self._mutex:
            if all(t.uid != task.uid for t in self.err_tasks):
                self.err_tasks.append(task)

    # ---- volume binding (cache.go:243-258, 617-623) ----

    @staticmethod
    def task_claim_names(task: TaskInfo) -> List[str]:
        """PVC claim names referenced by the task's pod."""
        if task.pod is None:
            return []
        claims = []
        for vol in task.pod.spec.volumes:
            ref = vol.source.get("persistentVolumeClaim")
            if ref and ref.get("claimName"):
                claims.append(ref["claimName"])
        return claims

    def allocate_volumes(self, task: TaskInfo, hostname: str) -> None:
        """AssumePodVolumes analogue: record whether every referenced PVC
        is already Bound (task.volume_ready), so bind_volumes knows
        whether there is provisioning left to do (cache.go:243-249)."""
        with self._mutex:
            all_bound = True
            for claim in self.task_claim_names(task):
                pvc = self.pvcs.get(f"{task.namespace}/{claim}")
                if pvc is None or pvc.status.get("phase") != "Bound":
                    all_bound = False
            task.volume_ready = all_bound

    def bind_volumes(self, task: TaskInfo) -> None:
        """BindPodVolumes analogue (cache.go:251-258): provision
        still-pending PVCs that carry a storage class — the selected
        node, a volume name, and phase Bound.  Raises on a PVC that
        cannot be bound (no storage class); the commit path turns that
        into an unbind + resync, like an apiserver bind failure."""
        if task.volume_ready:
            return
        for claim in self.task_claim_names(task):
            key = f"{task.namespace}/{claim}"
            with self._mutex:
                pvc = self.pvcs.get(key)
            if pvc is None:
                raise KeyError(f"persistentvolumeclaim {key} not found")
            if pvc.status.get("phase") == "Bound":
                continue
            if not pvc.spec.get("storageClassName"):
                raise RuntimeError(
                    f"pod has unbound immediate PersistentVolumeClaims: {key}"
                )
            pvc = pvc.clone()
            pvc.metadata.annotations["volume.kubernetes.io/selected-node"] = (
                task.node_name
            )
            pvc.spec["volumeName"] = f"pv-{pvc.metadata.name}"
            pvc.status["phase"] = "Bound"
            self.add_pvc(pvc)
        task.volume_ready = True

    # ---- status writeback ----

    def record_job_status_event(self, job: JobInfo) -> None:
        """cache.go:832-867 — pod conditions for unschedulable tasks."""
        if self.status_updater is None:
            return
        base_message = job.job_fit_errors
        for task in job.tasks.values():
            if task.status != TaskStatus.Pending:
                continue
            fit_errors = job.nodes_fit_errors.get(task.uid)
            message = fit_errors.error() if fit_errors is not None else base_message
            try:
                self.status_updater.update_pod_condition(task, "Unschedulable", message)
            except Exception as e:  # noqa: BLE001
                log.error("update pod condition failed: %s", e)

    def update_job_status(self, job: JobInfo) -> Optional[scheduling.PodGroup]:
        """cache.go:871-894."""
        self.record_job_status_event(job)
        if self.status_updater is None or job.pod_group is None:
            return job.pod_group
        return self.status_updater.update_pod_group(job.pod_group)
