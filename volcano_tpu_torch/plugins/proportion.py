"""Proportion plugin — queue fair share by iterative water-filling.

A copy of ``volcano_tpu/plugins/proportion.py`` for full sessions: the
port has no share-ledger seed, so the queue totals always come from the
job sweep.

Reference: pkg/scheduler/plugins/proportion/proportion.go.
"""

from __future__ import annotations

from typing import Dict, List

from volcano_tpu_torch.api import JobInfo, QueueInfo, Resource, TaskInfo
from volcano_tpu_torch.api.resource import empty_resource, min_resource, share as share_fn
from volcano_tpu_torch.api.types import allocated_status, TaskStatus
from volcano_tpu_torch.framework.arguments import Arguments
from volcano_tpu_torch.framework.events import Event, EventHandler
from volcano_tpu_torch.framework.interface import Plugin
from volcano_tpu_torch.framework.session import Session

PLUGIN_NAME = "proportion"


class _QueueAttr:
    __slots__ = ("queue_id", "name", "weight", "share", "deserved", "allocated", "request")

    def __init__(self, queue_id: str, name: str, weight: int):
        self.queue_id = queue_id
        self.name = name
        self.weight = weight
        self.share = 0.0
        self.deserved = empty_resource()
        self.allocated = empty_resource()
        self.request = empty_resource()


class ProportionPlugin(Plugin):
    def __init__(self, arguments: Arguments):
        self.arguments = arguments
        self.total_resource = empty_resource()
        self.queue_opts: Dict[str, _QueueAttr] = {}

    def name(self) -> str:
        return PLUGIN_NAME

    def _update_share(self, attr: _QueueAttr) -> None:
        """proportion.go:268-280 — max over resources of allocated/deserved."""
        res = 0.0
        for rn in attr.deserved.resource_names():
            s = share_fn(attr.allocated.get(rn), attr.deserved.get(rn))
            if s > res:
                res = s
        attr.share = res

    def on_session_open(self, ssn: Session) -> None:
        for node in ssn.nodes.values():
            self.total_resource.add(node.allocatable)

        # Build queue attributes (proportion.go:70-102).
        for job in ssn.jobs.values():
            if job.queue not in self.queue_opts:
                queue = ssn.queues.get(job.queue)
                if queue is None:
                    continue
                self.queue_opts[job.queue] = _QueueAttr(
                    queue.uid, queue.name, queue.weight
                )
            attr = self.queue_opts[job.queue]
            for status, tasks in job.task_status_index.items():
                if allocated_status(status):
                    for t in tasks.values():
                        attr.allocated.add(t.resreq)
                        attr.request.add(t.resreq)
                elif status == TaskStatus.Pending:
                    for t in tasks.values():
                        attr.request.add(t.resreq)

        # Iterative water-filling of deserved (proportion.go:104-157).
        remaining = self.total_resource.clone()
        meet: Dict[str, bool] = {}
        while True:
            total_weight = sum(
                attr.weight
                for attr in self.queue_opts.values()
                if attr.queue_id not in meet
            )
            if total_weight == 0:
                break

            increased = empty_resource()
            decreased = empty_resource()
            for attr in self.queue_opts.values():
                if attr.queue_id in meet:
                    continue
                old_deserved = attr.deserved.clone()
                attr.deserved.add(
                    remaining.clone().multi(float(attr.weight) / float(total_weight))
                )
                if attr.request.less(attr.deserved):
                    attr.deserved = min_resource(attr.deserved, attr.request)
                    meet[attr.queue_id] = True
                self._update_share(attr)
                inc, dec = attr.deserved.diff(old_deserved)
                increased.add(inc)
                decreased.add(dec)

            remaining.sub_unchecked(increased).add(decreased)
            if remaining.is_empty():
                break

        def queue_order_fn(l: QueueInfo, r: QueueInfo) -> int:
            """proportion.go:159-172 — smaller share first."""
            la = self.queue_opts.get(l.uid)
            ra = self.queue_opts.get(r.uid)
            ls = la.share if la else 0.0
            rs = ra.share if ra else 0.0
            if ls == rs:
                return 0
            return -1 if ls < rs else 1

        ssn.add_queue_order_fn(self.name(), queue_order_fn)

        def reclaimable_fn(reclaimer: TaskInfo, reclaimees: List[TaskInfo]) -> List[TaskInfo]:
            """proportion.go:174-199 — victims while queue stays >= deserved."""
            victims = []
            allocations: Dict[str, Resource] = {}
            for reclaimee in reclaimees:
                job = ssn.jobs.get(reclaimee.job)
                if job is None:
                    continue
                attr = self.queue_opts.get(job.queue)
                if attr is None:
                    continue
                allocated = allocations.get(job.queue)
                if allocated is None:
                    allocated = attr.allocated.clone()
                    allocations[job.queue] = allocated
                if allocated.less(reclaimee.resreq):
                    continue
                allocated.sub_unchecked(reclaimee.resreq)
                if attr.deserved.less_equal_strict(allocated):
                    victims.append(reclaimee)
            return victims

        ssn.add_reclaimable_fn(self.name(), reclaimable_fn)

        def overused_fn(queue) -> bool:
            """proportion.go:201-212."""
            attr = self.queue_opts.get(queue.uid)
            if attr is None:
                return False
            return not attr.allocated.less_equal(attr.deserved)

        ssn.add_overused_fn(self.name(), overused_fn)

        def job_enqueueable_fn(obj) -> bool:
            """proportion.go:214-236 — min resources fit under queue capability."""
            job: JobInfo = obj
            attr = self.queue_opts.get(job.queue)
            queue = ssn.queues.get(job.queue)
            if attr is None or queue is None:
                return True
            capability = queue.queue.spec.capability
            if not capability:
                return True
            pg_resource = Resource.from_resource_list(
                job.pod_group.spec.min_resources if job.pod_group else {}
            )
            return pg_resource.clone().add(attr.allocated).less_equal(
                Resource.from_resource_list(capability)
            )

        ssn.add_job_enqueueable_fn(self.name(), job_enqueueable_fn)

        def on_allocate(event: Event) -> None:
            job = ssn.jobs.get(event.task.job)
            if job is None:
                return
            attr = self.queue_opts.get(job.queue)
            if attr is None:
                return
            attr.allocated.add(event.task.resreq)
            self._update_share(attr)

        def on_deallocate(event: Event) -> None:
            job = ssn.jobs.get(event.task.job)
            if job is None:
                return
            attr = self.queue_opts.get(job.queue)
            if attr is None:
                return
            attr.allocated.sub_unchecked(event.task.resreq)
            self._update_share(attr)

        ssn.add_event_handler(
            EventHandler(allocate_func=on_allocate, deallocate_func=on_deallocate)
        )

    def on_session_close(self, ssn: Session) -> None:
        self.total_resource = empty_resource()
        self.queue_opts = {}


def new(arguments: Arguments) -> Plugin:
    return ProportionPlugin(arguments)
