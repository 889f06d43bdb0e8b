"""Preempt action — in-queue preemption for starving jobs.

A copy of ``volcano_tpu/actions/preempt.py``.

Reference: pkg/scheduler/actions/preempt/preempt.go.
"""

from __future__ import annotations

from typing import Callable, Dict, List

from volcano_tpu_torch import metrics
from volcano_tpu_torch.api import TaskInfo, TaskStatus
from volcano_tpu_torch.api.resource import empty_resource
from volcano_tpu_torch.apis import scheduling
from volcano_tpu_torch.framework.interface import Action
from volcano_tpu_torch.framework.session import Session
from volcano_tpu_torch.framework.statement import Statement
from volcano_tpu_torch.scheduler import util as sched_util
from volcano_tpu_torch.utils.priority_queue import PriorityQueue


class PreemptAction(Action):
    def name(self) -> str:
        return "preempt"

    def execute(self, ssn: Session) -> None:
        """preempt.go:45-177."""
        if ssn._trace.enabled:
            ssn._trace.event("preempt:start", "action", jobs=len(ssn.jobs))
        preemptors_map: Dict[str, PriorityQueue] = {}
        preemptor_tasks: Dict[str, PriorityQueue] = {}
        under_request: List = []
        queues: Dict[str, object] = {}

        for job in sorted(ssn.jobs.values(), key=lambda j: j.uid):
            if (
                job.pod_group is not None
                and job.pod_group.status.phase == scheduling.POD_GROUP_PENDING
            ):
                continue
            vr = ssn.job_valid(job)
            if vr is not None and not vr.pass_:
                continue
            queue = ssn.queues.get(job.queue)
            if queue is None:
                continue
            queues.setdefault(queue.uid, queue)

            # Starving: pending tasks and not pipelined (preempt.go:72-82).
            if job.task_status_index.get(TaskStatus.Pending) and not ssn.job_pipelined(job):
                preemptors_map.setdefault(job.queue, PriorityQueue(ssn.job_order_fn)).push(job)
                under_request.append(job)
                tasks = PriorityQueue(ssn.task_order_fn)
                for task in sorted(
                    job.task_status_index[TaskStatus.Pending].values(),
                    key=lambda t: t.uid,
                ):
                    tasks.push(task)
                preemptor_tasks[job.uid] = tasks

        for queue in queues.values():
            # Preemption between jobs within queue (preempt.go:86-143).
            while True:
                preemptors = preemptors_map.get(queue.uid)
                if preemptors is None or preemptors.empty():
                    break
                preemptor_job = preemptors.pop()

                stmt = ssn.statement()
                assigned = False
                while True:
                    if ssn.job_pipelined(preemptor_job):
                        break
                    if preemptor_tasks[preemptor_job.uid].empty():
                        break
                    preemptor = preemptor_tasks[preemptor_job.uid].pop()

                    def job_filter(task: TaskInfo) -> bool:
                        if task.status != TaskStatus.Running:
                            return False
                        job = ssn.jobs.get(task.job)
                        if job is None:
                            return False
                        return job.queue == preemptor_job.queue and preemptor.job != task.job

                    if _preempt(ssn, stmt, preemptor, job_filter):
                        assigned = True

                if ssn.job_pipelined(preemptor_job):
                    stmt.commit()
                else:
                    stmt.discard()
                    continue

                if assigned:
                    preemptors.push(preemptor_job)

            # Preemption between tasks within job (preempt.go:146-175).
            for job in under_request:
                while True:
                    tasks = preemptor_tasks.get(job.uid)
                    if tasks is None or tasks.empty():
                        break
                    preemptor = tasks.pop()
                    stmt = ssn.statement()
                    assigned = _preempt(
                        ssn,
                        stmt,
                        preemptor,
                        lambda task: task.status == TaskStatus.Running
                        and preemptor.job == task.job,
                    )
                    stmt.commit()
                    if not assigned:
                        break


def _preempt(
    ssn: Session,
    stmt: Statement,
    preemptor: TaskInfo,
    filter_fn: Callable[[TaskInfo], bool],
) -> bool:
    """preempt.go:181-259."""
    all_nodes = sched_util.get_node_list(ssn.nodes)
    predicate_nodes, _ = sched_util.predicate_nodes(preemptor, all_nodes, ssn.predicate_fn)
    node_scores = sched_util.prioritize_nodes(
        preemptor,
        predicate_nodes,
        ssn.batch_node_order_fn,
        ssn.node_order_map_fn,
        ssn.node_order_reduce_fn,
    )
    selected_nodes = sched_util.sort_nodes(node_scores)

    assigned = False
    for node in selected_nodes:
        preemptees = [
            task.clone()
            for task in sorted(node.tasks.values(), key=lambda t: t.uid)
            if filter_fn(task)
        ]
        victims = ssn.preemptable(preemptor, preemptees)
        metrics.update_preemption_victims_count(len(victims))

        if not _validate_victims(preemptor, node, victims):
            continue

        # Lowest-priority victims first (preempt.go:216-221).  The
        # reference inverts with `!TaskOrderFn`, which makes equal-order
        # pop sequence heap-structural (unspecified); swapping the
        # arguments instead gives the same inverted order with a
        # well-defined stable tie-break (insertion = uid order) — required
        # for bindings-equivalence with the device path.
        victims_queue = PriorityQueue(lambda l, r: ssn.task_order_fn(r, l))
        for victim in victims:
            victims_queue.push(victim)

        preempted = empty_resource()
        while not victims_queue.empty():
            if preemptor.init_resreq.less_equal(node.future_idle()):
                break
            preemptee = victims_queue.pop()
            stmt.evict(preemptee, "preempt")
            preempted.add(preemptee.resreq)

        metrics.register_preemption_attempts()

        if preemptor.init_resreq.less_equal(node.future_idle()):
            stmt.pipeline(preemptor, node.name)
            assigned = True
            break

    return assigned


def _validate_victims(preemptor: TaskInfo, node, victims: List[TaskInfo]) -> bool:
    """preempt.go:261-276."""
    if not victims:
        return False
    future_idle = node.future_idle()
    for victim in victims:
        future_idle.add(victim.resreq)
    return preemptor.init_resreq.less_equal(future_idle)


def new() -> PreemptAction:
    return PreemptAction()
