"""Reclaim action — cross-queue reclaim for underserved queues.

A copy of ``volcano_tpu/actions/reclaim.py``.

Reference: pkg/scheduler/actions/reclaim/reclaim.go.
"""

from __future__ import annotations

from typing import Dict

from volcano_tpu_torch.api import FitError, TaskStatus
from volcano_tpu_torch.api.resource import empty_resource
from volcano_tpu_torch.apis import scheduling
from volcano_tpu_torch.framework.interface import Action
from volcano_tpu_torch.framework.session import Session
from volcano_tpu_torch.scheduler import util as sched_util
from volcano_tpu_torch.utils.priority_queue import PriorityQueue


class ReclaimAction(Action):
    def name(self) -> str:
        return "reclaim"

    def execute(self, ssn: Session) -> None:
        """reclaim.go:42-202."""
        if ssn._trace.enabled:
            ssn._trace.event("reclaim:start", "action", jobs=len(ssn.jobs))
        queues = PriorityQueue(ssn.queue_order_fn)
        queue_map: Dict[str, object] = {}
        preemptors_map: Dict[str, PriorityQueue] = {}
        preemptor_tasks: Dict[str, PriorityQueue] = {}

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
            if queue.uid not in queue_map:
                queue_map[queue.uid] = queue
                queues.push(queue)

            if job.task_status_index.get(TaskStatus.Pending):
                preemptors_map.setdefault(job.queue, PriorityQueue(ssn.job_order_fn)).push(job)
                tasks = PriorityQueue(ssn.task_order_fn)
                for task in sorted(
                    job.task_status_index[TaskStatus.Pending].values(),
                    key=lambda t: t.uid,
                ):
                    tasks.push(task)
                preemptor_tasks[job.uid] = tasks

        while not queues.empty():
            queue = queues.pop()
            if ssn.overused(queue):
                continue

            jobs = preemptors_map.get(queue.uid)
            if jobs is None or jobs.empty():
                continue
            job = jobs.pop()

            tasks = preemptor_tasks.get(job.uid)
            if tasks is None or tasks.empty():
                continue
            task = tasks.pop()

            assigned = False
            for node in sched_util.get_node_list(ssn.nodes):
                # If predicates failed, next node (reclaim.go:123-126).
                try:
                    ssn.predicate_fn(task, node)
                except FitError:
                    continue

                resreq = task.init_resreq.clone()
                reclaimed = empty_resource()

                reclaimees = [
                    t.clone()
                    for t in sorted(node.tasks.values(), key=lambda t: t.uid)
                    if t.status == TaskStatus.Running
                    and t.job in ssn.jobs
                    and ssn.jobs[t.job].queue != job.queue
                ]
                victims = ssn.reclaimable(task, reclaimees)
                if not victims:
                    continue

                # Enough victim resources in total? (reclaim.go:155-163)
                all_res = empty_resource()
                for v in victims:
                    all_res.add(v.resreq)
                if not resreq.less_equal(all_res):
                    continue

                # Evict until reclaimed enough (reclaim.go:165-180).
                for reclaimee in victims:
                    try:
                        ssn.evict(reclaimee, "reclaim")
                    except Exception:  # noqa: BLE001 — try next victim
                        continue
                    reclaimed.add(reclaimee.resreq)
                    if resreq.less_equal(reclaimed):
                        break

                if task.init_resreq.less_equal(reclaimed):
                    ssn.pipeline(task, node.name)
                    assigned = True
                    break

            # Only the queue returns for another round (reclaim.go:197-199).
            if assigned:
                queues.push(queue)


def new() -> ReclaimAction:
    return ReclaimAction()
