"""TaskInfo and JobInfo — per-session views of pods and pod groups.

A copy of ``volcano_tpu/api/job_info.py``.

Reference: pkg/scheduler/api/job_info.go.
"""

from __future__ import annotations

from typing import Dict, Optional

from volcano_tpu_torch.api.resource import empty_resource, Resource
from volcano_tpu_torch.api.types import (
    allocated_status,
    ALLOCATED_STATUSES,
    TaskStatus,
)
from volcano_tpu_torch.api.unschedule_info import FitErrors
from volcano_tpu_torch.apis import core, scheduling

#: status sets for the readiness rollups (job_info.go:346-398) — hot on
#: every PriorityQueue compare, so plain set membership
_READY_STATUSES = frozenset(ALLOCATED_STATUSES | {TaskStatus.Succeeded})
_VALID_STATUSES = frozenset(
    ALLOCATED_STATUSES
    | {TaskStatus.Succeeded, TaskStatus.Pipelined, TaskStatus.Pending}
)


def _task_status_from_pod(pod: core.Pod) -> TaskStatus:
    """Map pod phase + nodeName + deletion to TaskStatus (job_info.go getTaskStatus)."""
    phase = pod.status.phase
    if phase == "Running":
        if pod.metadata.deletion_timestamp is not None:
            return TaskStatus.Releasing
        return TaskStatus.Running
    if phase == "Pending":
        if pod.metadata.deletion_timestamp is not None:
            return TaskStatus.Releasing
        if pod.spec.node_name:
            return TaskStatus.Bound
        return TaskStatus.Pending
    if phase == "Succeeded":
        return TaskStatus.Succeeded
    if phase == "Failed":
        return TaskStatus.Failed
    return TaskStatus.Unknown


def get_job_id(pod: core.Pod) -> str:
    gn = pod.metadata.annotations.get(scheduling.GROUP_NAME_ANNOTATION_KEY, "")
    if gn:
        return f"{pod.metadata.namespace}/{gn}"
    return ""


class TaskInfo:
    """One pod in the scheduler (job_info.go:38-93)."""

    __slots__ = (
        "uid",
        "job",
        "name",
        "namespace",
        "resreq",
        "init_resreq",
        "node_name",
        "status",
        "priority",
        "volume_ready",
        "pod",
    )

    def __init__(
        self,
        uid: str,
        job: str,
        name: str,
        namespace: str,
        resreq: Resource,
        init_resreq: Optional[Resource] = None,
        node_name: str = "",
        status: TaskStatus = TaskStatus.Pending,
        priority: int = 1,
        pod: Optional[core.Pod] = None,
    ):
        self.uid = uid
        self.job = job
        self.name = name
        self.namespace = namespace
        self.resreq = resreq
        # share, not clone: both attributes are immutable post-construction
        # (see clone() below)
        self.init_resreq = init_resreq if init_resreq is not None else resreq
        self.node_name = node_name
        self.status = status
        self.priority = priority
        self.volume_ready = False
        self.pod = pod

    @property
    def best_effort(self) -> bool:
        return self.resreq.is_empty()

    def clone(self) -> "TaskInfo":
        # __new__ bypass — two clones per placement (statement/node copy
        # + cache bind copy) put this on the session hot path.
        t = TaskInfo.__new__(TaskInfo)
        t.uid = self.uid
        t.job = self.job
        t.name = self.name
        t.namespace = self.namespace
        # resreq/init_resreq are IMMUTABLE after new_task_info — every
        # accounting op copies into owner-held accumulators (job.allocated,
        # node.idle, ...), never mutates a task's request in place
        # (job_info.go clones here; the invariant makes sharing safe and
        # removes two Resource copies per placement).  Anything that needs
        # a different request must REPLACE the attribute, not mutate it.
        t.resreq = self.resreq
        t.init_resreq = self.init_resreq
        t.node_name = self.node_name
        t.status = self.status
        t.priority = self.priority
        t.volume_ready = self.volume_ready
        t.pod = self.pod
        return t

    @property
    def creation_timestamp(self) -> float:
        return self.pod.metadata.creation_timestamp if self.pod else 0.0

    def __repr__(self) -> str:
        return (
            f"Task ({self.uid}:{self.namespace}/{self.name}): job {self.job}, "
            f"status {self.status.name}, pri {self.priority}, resreq {self.resreq}"
        )


def pod_request_resource(pod: core.Pod) -> Resource:
    """Summed container requests (the reference's GetPodResourceRequest
    without the init-container max — i.e. exactly what NodeInfo
    accounting charges per held task).  The single copy shared by
    new_task_info, the federation spill ledger, and the federation
    policy checker, so spill candidate selection and equivalence
    verification can never drift from the scheduler's own node
    accounting.  Init containers are deliberately excluded: the running
    steady state is what node Used/Idle tracks."""
    resreq = Resource()
    for c in pod.spec.containers:
        resreq.add(Resource.from_resource_list(c.resources.get("requests") or {}))
    return resreq


def new_task_info(pod: core.Pod) -> TaskInfo:
    """Build a TaskInfo from a Pod (job_info.go:68-93).

    Resreq sums container requests; InitResreq additionally maxes with init
    containers (pod_info.go:53-79).  Each quantity is converted to milli
    units *before* summing, exactly like the reference's per-quantity
    MilliValue — summing raw floats first would accumulate binary-float
    error (0.1+0.1+0.1 → 301 mCPU after ceil).
    """
    resreq = pod_request_resource(pod)
    init_resreq = resreq.clone()
    for c in pod.spec.init_containers:
        init_resreq.set_max(Resource.from_resource_list(c.resources.get("requests") or {}))
    # freeze: both objects are shared across every clone of this task
    # (see TaskInfo.clone), so an in-place mutation anywhere would skew
    # all of them — the guard makes that fail loudly under __debug__
    resreq.freeze()
    init_resreq.freeze()
    return TaskInfo(
        uid=pod.metadata.uid or f"{pod.metadata.namespace}/{pod.metadata.name}",
        job=get_job_id(pod),
        name=pod.metadata.name,
        namespace=pod.metadata.namespace,
        resreq=resreq,
        init_resreq=init_resreq,
        node_name=pod.spec.node_name,
        status=_task_status_from_pod(pod),
        priority=pod.spec.priority if pod.spec.priority is not None else 1,
        pod=pod,
    )


class JobInfo:
    """One PodGroup's worth of tasks (job_info.go:127-309)."""

    def __init__(self, uid: str, name: str = "", namespace: str = ""):
        self.uid = uid
        self.name = name
        self.namespace = namespace
        self.queue: str = ""
        self.priority: int = 0
        self.min_available: int = 0
        self.pod_group: Optional[scheduling.PodGroup] = None
        self.creation_timestamp: float = 0.0

        self.tasks: Dict[str, TaskInfo] = {}
        self.task_status_index: Dict[TaskStatus, Dict[str, TaskInfo]] = {}
        #: count of tasks in _READY_STATUSES, maintained by _index/_unindex
        #: — ready_task_num() is on the per-comparison hot path (PQ job
        #: order, gang readiness) and the bucket-sum recompute was ~4% of
        #: the whole generic apply loop
        self.ready_num: int = 0

        self.allocated: Resource = empty_resource()
        self.total_request: Resource = empty_resource()

        # diagnostics (job_info.go NodesFitDelta / NodesFitErrors)
        self.nodes_fit_delta: Dict[str, Resource] = {}
        self.nodes_fit_errors: Dict[str, FitErrors] = {}
        self.job_fit_errors: str = ""

    # ---- task bookkeeping ----

    def _index(self, task: TaskInfo) -> None:
        bucket = self.task_status_index.setdefault(task.status, {})
        # the dict write is idempotent under a watch-echo double add
        # (cache._add_task races its own bind echo) — the counter must
        # be too, so only count a uid actually entering the bucket
        if task.uid not in bucket and task.status in _READY_STATUSES:
            self.ready_num += 1
        bucket[task.uid] = task

    def _unindex(self, task: TaskInfo) -> None:
        bucket = self.task_status_index.get(task.status)
        if bucket and task.uid in bucket:
            del bucket[task.uid]
            if not bucket:
                del self.task_status_index[task.status]
            if task.status in _READY_STATUSES:
                self.ready_num -= 1

    def add_task_info(self, task: TaskInfo) -> None:
        self.tasks[task.uid] = task
        self._index(task)
        if allocated_status(task.status):
            self.allocated.add(task.resreq)
        self.total_request.add(task.resreq)

    def update_task_status(self, task: TaskInfo, status: TaskStatus) -> None:
        """Move a task between status buckets, maintaining Allocated rollup
        (job_info.go UpdateTaskStatus)."""
        existing = self.tasks.get(task.uid)
        if existing is not None:
            self.delete_task_info(existing)
        task.status = status
        self.add_task_info(task)

    def delete_task_info(self, task: TaskInfo) -> None:
        stored = self.tasks.pop(task.uid, None)
        if stored is None:
            return
        self._unindex(stored)
        if allocated_status(stored.status):
            self.allocated.sub(stored.resreq)
        self.total_request.sub_unchecked(stored.resreq)

    def set_pod_group(self, pg: scheduling.PodGroup) -> None:
        self.name = pg.metadata.name
        self.namespace = pg.metadata.namespace
        self.min_available = pg.spec.min_member
        self.queue = pg.spec.queue
        self.creation_timestamp = pg.metadata.creation_timestamp
        self.pod_group = pg

    # ---- readiness (job_info.go:346-398) ----

    def ready_task_num(self) -> int:
        return self.ready_num

    def waiting_task_num(self) -> int:
        return len(self.task_status_index.get(TaskStatus.Pipelined, {}))

    def valid_task_num(self) -> int:
        return sum(
            len(tasks)
            for status, tasks in self.task_status_index.items()
            if status in _VALID_STATUSES
        )

    def ready(self) -> bool:
        return self.ready_task_num() >= self.min_available

    def pipelined(self) -> bool:
        return self.waiting_task_num() + self.ready_task_num() >= self.min_available

    def fit_error(self) -> str:
        """Status histogram message for unschedulable jobs (job_info.go:327-344)."""
        reasons = {status.name: len(tasks) for status, tasks in self.task_status_index.items()}
        reasons["minAvailable"] = self.min_available
        hist = sorted(f"{v} {k}" for k, v in reasons.items())
        return f"pod group is not ready, {', '.join(hist)}."

    def clone(self) -> "JobInfo":
        # Field-level copy (same rationale as NodeInfo.clone): replaying
        # add_task_info per task re-sums allocated/total_request and
        # rebuilds the index at ~4µs/task — at 50k tasks that's the
        # second-largest snapshot cost.  The copy keeps the cache's
        # incrementally-maintained rollups as-is.  __new__ bypass: the
        # __init__ route re-created five dicts and two Resources per job
        # just to overwrite them — measurable at 10k-job snapshots.
        info = JobInfo.__new__(JobInfo)
        info.uid = self.uid
        info.name = self.name
        info.namespace = self.namespace
        info.queue = self.queue
        info.priority = self.priority
        info.min_available = self.min_available
        info.pod_group = self.pod_group
        info.creation_timestamp = self.creation_timestamp
        info.allocated = self.allocated.clone()
        info.total_request = self.total_request.clone()
        info.ready_num = self.ready_num
        info.nodes_fit_delta = {}
        info.nodes_fit_errors = {}
        info.job_fit_errors = ""
        tasks = info.tasks = {}
        index = info.task_status_index = {}
        for uid, t in self.tasks.items():
            ti = t.clone()
            tasks[uid] = ti
            bucket = index.get(ti.status)
            if bucket is None:
                bucket = index[ti.status] = {}
            bucket[uid] = ti
        return info

    def __repr__(self) -> str:
        return (
            f"Job ({self.uid}): namespace {self.namespace} ({self.queue}), "
            f"name {self.name}, minAvailable {self.min_available}"
        )
