"""Allocate action — THE hot path: namespace→queue→job→task nested
priority queues; per task predicate→prioritize→select→allocate/pipeline;
gang commit/discard at job granularity.

A copy of ``volcano_tpu/actions/allocate.py``.

Reference: pkg/scheduler/actions/allocate/allocate.go:42-241.

``drive_allocate_loop`` is the single copy of the control-flow skeleton;
it is shared by the host action below, the device-backed
gpu-allocate action, and its order-replay phase (actions/gpu_allocate.py),
so the replay-order == host-order premise cannot drift.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from volcano_tpu_torch import metrics
from volcano_tpu_torch.api import FitError, JobInfo, NodeInfo, TaskInfo, TaskStatus
from volcano_tpu_torch.api import unschedule_info as reasons
from volcano_tpu_torch.apis import scheduling
from volcano_tpu_torch.framework.interface import Action
from volcano_tpu_torch.framework.session import Session
from volcano_tpu_torch.scheduler import util as sched_util
from volcano_tpu_torch.utils.priority_queue import PriorityQueue


def eligible_jobs(ssn: Session):
    """Jobs allocate considers (allocate.go:60-92): not PodGroupPending,
    valid, and in a known queue.  Sorted by uid for determinism (the Go
    map iteration is random; bindings equivalence needs a fixed order)."""
    for job in sorted(ssn.jobs.values(), key=lambda j: j.uid):
        if (
            job.pod_group is not None
            and job.pod_group.status.phase == scheduling.POD_GROUP_PENDING
        ):
            continue
        vr = ssn.job_valid(job)
        if vr is not None and not vr.pass_:
            continue
        if job.queue not in ssn.queues:
            continue
        yield job


def build_pending_task_queue(ssn: Session, job: JobInfo) -> PriorityQueue:
    """Pending, non-best-effort tasks by TaskOrderFn (allocate.go:156-169)."""
    tasks = PriorityQueue(ssn.task_order_fn)
    for task in sorted(
        job.task_status_index.get(TaskStatus.Pending, {}).values(),
        key=lambda t: t.uid,
    ):
        if task.resreq.is_empty():
            continue
        tasks.push(task)
    return tasks


def drive_allocate_loop(
    ssn: Session,
    begin_job: Callable[[JobInfo], object],
    place_task: Callable[[object, TaskInfo, JobInfo], bool],
    end_job: Callable[[object, JobInfo], None],
) -> None:
    """The namespace→queue→job→task skeleton (allocate.go:112-240).

    ``place_task(ctx, task, job)`` returns False to stop the job's task
    loop (the reference's break on predicate failure)."""
    namespaces = PriorityQueue(ssn.namespace_order_fn)
    jobs_map: Dict[str, Dict[str, PriorityQueue]] = {}

    for job in eligible_jobs(ssn):
        queue_map = jobs_map.get(job.namespace)
        if queue_map is None:
            namespaces.push(job.namespace)
            queue_map = {}
            jobs_map[job.namespace] = queue_map
        queue_map.setdefault(job.queue, PriorityQueue(ssn.job_order_fn)).push(job)

    pending_tasks: Dict[str, PriorityQueue] = {}

    while not namespaces.empty():
        namespace = namespaces.pop()
        queue_in_namespace = jobs_map[namespace]

        # Least-share non-overused queue, linear scan because shares move
        # as allocations land (allocate.go:122-145).
        queue = None
        for queue_id in list(queue_in_namespace):
            current_queue = ssn.queues[queue_id]
            if ssn.overused(current_queue):
                del queue_in_namespace[queue_id]
                continue
            if queue is None or ssn.queue_order_fn(current_queue, queue):
                queue = current_queue
        if queue is None:
            continue

        jobs = queue_in_namespace.get(queue.uid)
        if jobs is None or jobs.empty():
            continue

        job = jobs.pop()
        if job.uid not in pending_tasks:
            pending_tasks[job.uid] = build_pending_task_queue(ssn, job)
        tasks = pending_tasks[job.uid]

        # the loop body may write fit errors/deltas onto the job clone
        # even when nothing places — conservatively touched
        ssn.touched_jobs.add(job.uid)
        ctx = begin_job(job)

        while not tasks.empty():
            task = tasks.pop()
            if not place_task(ctx, task, job):
                break
            if ssn.job_ready(job):
                jobs.push(job)
                break

        end_job(ctx, job)
        namespaces.push(namespace)


def make_predicate_fn(ssn: Session):
    """Resource-fit check prepended to plugin predicates
    (allocate.go:100-107)."""

    def predicate_fn(task: TaskInfo, node: NodeInfo) -> None:
        if not task.init_resreq.less_equal(node.future_idle()):
            raise FitError(task, node, reasons.NODE_RESOURCE_FIT_FAILED)
        ssn.predicate_fn(task, node)

    return predicate_fn


def host_node_chooser(ssn: Session):
    """The reference per-task path: PredicateNodes → PrioritizeNodes →
    SelectBestNode (allocate.go:191-199)."""
    all_nodes = sched_util.get_node_list(ssn.nodes)
    predicate_fn = make_predicate_fn(ssn)

    def choose(task: TaskInfo, job: JobInfo) -> Optional[NodeInfo]:
        predicate_nodes, fit_errors = sched_util.predicate_nodes(
            task, all_nodes, predicate_fn
        )
        if not predicate_nodes:
            job.nodes_fit_errors[task.uid] = fit_errors
            for reason in fit_errors.histogram():
                metrics.register_unschedulable_reason(reason)
            return None
        node_scores = sched_util.prioritize_nodes(
            task,
            predicate_nodes,
            ssn.batch_node_order_fn,
            ssn.node_order_map_fn,
            ssn.node_order_reduce_fn,
        )
        return sched_util.select_best_node(node_scores)

    return choose


def make_place_task(ssn: Session, chooser):
    """Per-task body shared by allocate and gpu-allocate
    (allocate.go:177-230): reset fit-delta, choose node, allocate into
    idle or pipeline onto future idle."""

    def place_task(stmt, task: TaskInfo, job: JobInfo) -> bool:
        if job.nodes_fit_delta:
            job.nodes_fit_delta = {}

        node = chooser(task, job)
        if node is None:
            return False

        if task.init_resreq.less_equal(node.idle):
            stmt.allocate(task, node.name)
        else:
            delta = node.idle.clone()
            delta.fit_delta(task.init_resreq)
            job.nodes_fit_delta[node.name] = delta
            if task.init_resreq.less_equal(node.future_idle()):
                stmt.pipeline(task, node.name)
        return True

    return place_task


def gang_end_job(ssn: Session):
    """Commit when the gang is ready, discard otherwise
    (allocate.go:232-236)."""

    def end_job(stmt, job: JobInfo) -> None:
        if ssn.job_ready(job):
            stmt.commit()
        else:
            stmt.discard()

    return end_job


class AllocateAction(Action):
    def name(self) -> str:
        return "allocate"

    def execute(self, ssn: Session) -> None:
        if ssn._trace.enabled:
            ssn._trace.event(
                "allocate:start", "action",
                jobs=len(ssn.jobs), nodes=len(ssn.nodes),
            )
        drive_allocate_loop(
            ssn,
            begin_job=lambda job: ssn.statement(),
            place_task=make_place_task(ssn, host_node_chooser(ssn)),
            end_job=gang_end_job(ssn),
        )


def new() -> AllocateAction:
    return AllocateAction()
