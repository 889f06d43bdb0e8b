"""Enqueue action — gate PodGroupPending → Inqueue by cluster headroom.

A copy of ``volcano_tpu/actions/enqueue.py``.

Reference: pkg/scheduler/actions/enqueue/enqueue.go.
"""

from __future__ import annotations

from typing import Dict

from volcano_tpu_torch.api import Resource
from volcano_tpu_torch.api.resource import empty_resource
from volcano_tpu_torch.apis import scheduling
from volcano_tpu_torch.conf import get_action_arguments
from volcano_tpu_torch.framework.interface import Action
from volcano_tpu_torch.framework.session import Session
from volcano_tpu_torch.utils.priority_queue import PriorityQueue

#: enqueue.go:36-37
OVERCOMMIT_FACTOR = "overcommit-factor"
DEFAULT_OVERCOMMIT_FACTOR = 1.2


class EnqueueAction(Action):
    def name(self) -> str:
        return "enqueue"

    def _overcommit_factor(self, ssn: Session) -> float:
        args = get_action_arguments(ssn.configurations, self.name())
        if args is not None:
            return args.get_float(OVERCOMMIT_FACTOR, DEFAULT_OVERCOMMIT_FACTOR)
        return DEFAULT_OVERCOMMIT_FACTOR

    def execute(self, ssn: Session) -> None:
        """enqueue.go:54-134."""
        queues = PriorityQueue(ssn.queue_order_fn)
        queue_map: Dict[str, object] = {}
        jobs_map: Dict[str, PriorityQueue] = {}

        for job in sorted(ssn.jobs.values(), key=lambda j: j.uid):
            queue = ssn.queues.get(job.queue)
            if queue is None:
                continue
            if queue.uid not in queue_map:
                queue_map[queue.uid] = queue
                queues.push(queue)
            if (
                job.pod_group is not None
                and job.pod_group.status.phase == scheduling.POD_GROUP_PENDING
            ):
                jobs_map.setdefault(job.queue, PriorityQueue(ssn.job_order_fn)).push(job)

        empty = empty_resource()
        nodes_idle = empty_resource()
        factor = self._overcommit_factor(ssn)
        for node in ssn.nodes.values():
            nodes_idle.add(
                node.allocatable.clone().multi(factor).sub_unchecked(node.used)
            )

        while not queues.empty():
            if nodes_idle.less(empty):
                break
            queue = queues.pop()
            jobs = jobs_map.get(queue.uid)
            if jobs is None or jobs.empty():
                continue
            job = jobs.pop()

            inqueue = False
            min_resources = job.pod_group.spec.min_resources if job.pod_group else None
            if not min_resources:
                inqueue = True
            else:
                pg_resource = Resource.from_resource_list(min_resources)
                if ssn.job_enqueueable(job) and pg_resource.less_equal(nodes_idle):
                    nodes_idle.sub_unchecked(pg_resource)
                    inqueue = True

            if inqueue and job.pod_group is not None:
                job.pod_group.status.phase = scheduling.POD_GROUP_INQUEUE
                ssn.jobs[job.uid] = job

            queues.push(queue)


def new() -> EnqueueAction:
    return EnqueueAction()
