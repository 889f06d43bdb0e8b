"""DRF plugin — Dominant Resource Fairness job ordering and preemption.

A copy of ``volcano_tpu/plugins/drf.py`` for full sessions: the port has
no share-ledger seed, so the namespace totals always come from the job
sweep.

Reference: pkg/scheduler/plugins/drf/drf.go.
"""

from __future__ import annotations

from typing import Dict, List

from volcano_tpu_torch.api import JobInfo, Resource, TaskInfo
from volcano_tpu_torch.api.resource import empty_resource, share as share_fn
from volcano_tpu_torch.api.types import allocated_status
from volcano_tpu_torch.framework.arguments import Arguments
from volcano_tpu_torch.framework.events import Event, EventHandler
from volcano_tpu_torch.framework.interface import Plugin
from volcano_tpu_torch.framework.session import Session

PLUGIN_NAME = "drf"

#: drf.go:33 shareDelta
SHARE_DELTA = 0.000001


class _Attr:
    __slots__ = ("allocated", "share", "dominant_resource")

    def __init__(self):
        self.allocated = empty_resource()
        self.share = 0.0
        self.dominant_resource = ""


class DrfPlugin(Plugin):
    def __init__(self, arguments: Arguments):
        self.arguments = arguments
        self.total_resource = empty_resource()
        self.job_attrs: Dict[str, _Attr] = {}
        self.namespace_opts: Dict[str, _Attr] = {}

    def name(self) -> str:
        return PLUGIN_NAME

    # ---- share math (drf.go:295-311) ----

    def _calculate_share(self, allocated: Resource, total: Resource):
        res = 0.0
        dominant = ""
        for rn in total.resource_names():
            s = share_fn(allocated.get(rn), total.get(rn))
            if s > res:
                res = s
                dominant = rn
        return dominant, res

    def _update_share(self, attr: _Attr) -> None:
        attr.dominant_resource, attr.share = self._calculate_share(
            attr.allocated, self.total_resource
        )

    def _namespace_order_enabled(self, ssn: Session) -> bool:
        """drf.go:68-78."""
        for tier in ssn.tiers:
            for plugin in tier.plugins:
                if plugin.name == PLUGIN_NAME:
                    return plugin.enabled_namespace_order
        return False

    def on_session_open(self, ssn: Session) -> None:
        for node in ssn.nodes.values():
            self.total_resource.add(node.allocatable)

        namespace_order_enabled = self._namespace_order_enabled(ssn)

        for job in ssn.jobs.values():
            attr = _Attr()
            for status, tasks in job.task_status_index.items():
                if allocated_status(status):
                    for t in tasks.values():
                        attr.allocated.add(t.resreq)
            self._update_share(attr)
            self.job_attrs[job.uid] = attr

            if namespace_order_enabled:
                ns_opt = self.namespace_opts.setdefault(job.namespace, _Attr())
                ns_opt.allocated.add(attr.allocated)
                self._update_share(ns_opt)

        def preemptable_fn(preemptor: TaskInfo, preemptees: List[TaskInfo]) -> List[TaskInfo]:
            """drf.go:120-199."""
            victims: List[TaskInfo] = []

            candidates = preemptees
            if namespace_order_enabled:
                # Namespace-weighted share policy first (drf.go:127-175).
                l_weight = ssn.namespace_info.get(
                    preemptor.namespace
                )
                l_weight = l_weight.get_weight() if l_weight else 1
                l_ns_att = self.namespace_opts.get(preemptor.namespace, _Attr())
                l_ns_alloc = l_ns_att.allocated.clone().add(preemptor.resreq)
                _, l_ns_share = self._calculate_share(l_ns_alloc, self.total_resource)
                l_weighted = l_ns_share / float(l_weight)

                namespace_allocation: Dict[str, Resource] = {}
                undecided: List[TaskInfo] = []
                for preemptee in preemptees:
                    if preemptor.namespace == preemptee.namespace:
                        undecided.append(preemptee)
                        continue
                    ns_alloc = namespace_allocation.get(preemptee.namespace)
                    if ns_alloc is None:
                        r_att = self.namespace_opts.get(preemptee.namespace, _Attr())
                        ns_alloc = r_att.allocated.clone()
                        namespace_allocation[preemptee.namespace] = ns_alloc
                    r_weight = ssn.namespace_info.get(preemptee.namespace)
                    r_weight = r_weight.get_weight() if r_weight else 1
                    ns_alloc.sub_unchecked(preemptee.resreq)
                    _, r_ns_share = self._calculate_share(ns_alloc, self.total_resource)
                    r_weighted = r_ns_share / float(r_weight)

                    if l_weighted < r_weighted:
                        victims.append(preemptee)
                    if l_weighted - r_weighted > SHARE_DELTA:
                        continue
                    undecided.append(preemptee)
                candidates = undecided

            l_att = self.job_attrs.get(preemptor.job, _Attr())
            l_alloc = l_att.allocated.clone().add(preemptor.resreq)
            _, ls = self._calculate_share(l_alloc, self.total_resource)

            allocations: Dict[str, Resource] = {}
            for preemptee in candidates:
                alloc = allocations.get(preemptee.job)
                if alloc is None:
                    r_att = self.job_attrs.get(preemptee.job, _Attr())
                    alloc = r_att.allocated.clone()
                    allocations[preemptee.job] = alloc
                alloc.sub_unchecked(preemptee.resreq)
                _, rs = self._calculate_share(alloc, self.total_resource)
                if ls < rs or abs(ls - rs) <= SHARE_DELTA:
                    victims.append(preemptee)
            return victims

        ssn.add_preemptable_fn(self.name(), preemptable_fn)

        def job_order_fn(l: JobInfo, r: JobInfo) -> int:
            """drf.go:203-219 — smaller share first."""
            ls = self.job_attrs[l.uid].share
            rs = self.job_attrs[r.uid].share
            if ls == rs:
                return 0
            return -1 if ls < rs else 1

        ssn.add_job_order_fn(self.name(), job_order_fn)

        if namespace_order_enabled:

            def namespace_order_fn(l: str, r: str) -> int:
                """drf.go:223-248 — weighted namespace share."""
                l_opt = self.namespace_opts.get(str(l), _Attr())
                r_opt = self.namespace_opts.get(str(r), _Attr())
                l_info = ssn.namespace_info.get(str(l))
                r_info = ssn.namespace_info.get(str(r))
                lw = l_info.get_weight() if l_info else 1
                rw = r_info.get_weight() if r_info else 1
                lws = l_opt.share / float(lw)
                rws = r_opt.share / float(rw)
                if lws == rws:
                    return 0
                return -1 if lws < rws else 1

            ssn.add_namespace_order_fn(self.name(), namespace_order_fn)

        def on_allocate(event: Event) -> None:
            """drf.go:255-272."""
            attr = self.job_attrs.get(event.task.job)
            if attr is None:
                return
            attr.allocated.add(event.task.resreq)
            self._update_share(attr)
            if namespace_order_enabled:
                ns_opt = self.namespace_opts.setdefault(event.task.namespace, _Attr())
                ns_opt.allocated.add(event.task.resreq)
                self._update_share(ns_opt)

        def on_deallocate(event: Event) -> None:
            """drf.go:274-291."""
            attr = self.job_attrs.get(event.task.job)
            if attr is None:
                return
            attr.allocated.sub_unchecked(event.task.resreq)
            self._update_share(attr)
            if namespace_order_enabled:
                ns_opt = self.namespace_opts.setdefault(event.task.namespace, _Attr())
                ns_opt.allocated.sub_unchecked(event.task.resreq)
                self._update_share(ns_opt)

        ssn.add_event_handler(
            EventHandler(allocate_func=on_allocate, deallocate_func=on_deallocate)
        )

    def on_session_close(self, ssn: Session) -> None:
        self.total_resource = empty_resource()
        self.job_attrs = {}
        self.namespace_opts = {}


def new(arguments: Arguments) -> Plugin:
    return DrfPlugin(arguments)
