"""Fast ORDER phase for gpu-allocate: episode-level simulation of
drive_allocate_loop's pop order without touching session state.

A copy of ``volcano_tpu/actions/fast_order.py``.

The exact replay in actions/gpu_allocate.py walks the real priority
queues and fires the real plugin event handlers per task (~40-50µs/task
— ~2s at the 50k headline shape, 10x the whole device-kernel budget).
But every order-determining quantity is a small scalar:

  * task order within a job — static (priority desc, ts, uid)
  * job order — (priority desc?, gang not-ready-first?, drf share?) per
    the session's comparator chain, then (ts, uid)
  * queue choice — proportion share (allocated/deserved) + overused
  * namespace order — lexicographic (weighted-namespace DRF bails)

and the dynamic ones (drf job share, proportion queue share, gang
readiness) change ONLY for the job being fed — never for a job sitting
in a heap.  So the loop decomposes into *episodes* (one job pop each):
feed the job's tasks until gang-ready (statically many), update its
share once, push it back.  Episode count is O(jobs + post-ready tasks),
so the simulation runs at Python-scalar speed instead of
comparator-replay speed, while producing the bit-identical order:
float updates are applied per task in the same sequence as the drf /
proportion event handlers (drf.go:255-272), so accumulated shares are
IEEE-identical to the replay's.

``try_compute_task_order`` returns None unless the session's comparator
chains and overused/job-ready registrations match the semantics modeled
here (the same refuse-loudly discipline as ops/preempt_pack); callers
fall back to the exact replay.  Equivalence is enforced by
tests/test_fast_order.py, which diffs this order against the replay's
across multi-queue / multi-namespace / priority / preallocated /
best-effort sessions.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional

from volcano_tpu_torch.api import TaskInfo, TaskStatus
from volcano_tpu_torch.api.resource import (
    MIN_MEMORY,
    MIN_MILLI_CPU,
    MIN_MILLI_SCALAR,
    Resource,
)
from volcano_tpu_torch.framework.session import Session

#: job-order comparators this simulator can express as scalar keys
_KNOWN_JOB_ORDER = {"priority", "gang", "drf"}
_KNOWN_TASK_ORDER = {"priority"}
_KNOWN_QUEUE_ORDER = {"proportion"}


def _chain(ssn: Session, fns: Dict, flag: str) -> List[str]:
    """Plugin names the session's _ordered dispatch would walk, in order."""
    return [
        p.name
        for tier in ssn.tiers
        for p in tier.plugins
        if getattr(p, flag) and p.name in fns
    ]


class _Share:
    """Mirror of a drf job attr / proportion queue attr: allocated lanes
    accumulated per task in event-handler order, share recomputed at
    episode boundaries with the plugins' exact formula."""

    __slots__ = ("cpu", "mem", "scalars", "share", "denom_cpu", "denom_mem",
                 "denom_scalars")

    def __init__(self, allocated: Resource, share: float, denom: Resource):
        self.cpu = allocated.milli_cpu
        self.mem = allocated.memory
        self.scalars = dict(allocated.scalars)
        self.share = share
        self.denom_cpu = denom.milli_cpu
        self.denom_mem = denom.memory
        self.denom_scalars = dict(denom.scalars)

    def add_task(self, rr: Resource) -> None:
        self.cpu += rr.milli_cpu
        self.mem += rr.memory
        if rr.scalars:
            for name, v in rr.scalars.items():
                self.scalars[name] = self.scalars.get(name, 0.0) + v

    def update_share(self) -> None:
        """share_fn max over the denominator's resource names (drf
        _update_share / proportion _update_share)."""
        res = _share_of(self.cpu, self.denom_cpu)
        s = _share_of(self.mem, self.denom_mem)
        if s > res:
            res = s
        for name, denom in self.denom_scalars.items():
            s = _share_of(self.scalars.get(name, 0.0), denom)
            if s > res:
                res = s
        self.share = res

    def overused(self) -> bool:
        """not allocated.less_equal(deserved) — Resource.less_equal with
        the reference's tolerance conventions."""
        if not _le(self.cpu, self.denom_cpu, MIN_MILLI_CPU):
            return True
        if not _le(self.mem, self.denom_mem, MIN_MEMORY):
            return True
        for name, v in self.scalars.items():
            if v <= MIN_MILLI_SCALAR:
                continue
            if not _le(v, self.denom_scalars.get(name, 0.0), MIN_MILLI_SCALAR):
                return True
        return False


def _share_of(l: float, r: float) -> float:
    if r == 0:
        return 1.0 if l > 0 else 0.0
    return l / r


def _le(l: float, r: float, diff: float) -> bool:
    return l < r or abs(l - r) < diff


def try_compute_task_order(ssn: Session) -> Optional[List[TaskInfo]]:
    """Simulated pop order, or None when the session's ordering semantics
    fall outside the modeled shape."""
    job_chain = _chain(ssn, ssn.job_order_fns, "enabled_job_order")
    task_chain = _chain(ssn, ssn.task_order_fns, "enabled_task_order")
    queue_chain = _chain(ssn, ssn.queue_order_fns, "enabled_queue_order")
    ns_chain = _chain(ssn, ssn.namespace_order_fns, "enabled_namespace_order")
    ready_chain = _chain(ssn, ssn.job_ready_fns, "enabled_job_ready")
    overused_names = set(ssn.overused_fns)

    if (
        not set(job_chain) <= _KNOWN_JOB_ORDER
        or not set(task_chain) <= _KNOWN_TASK_ORDER
        or not set(queue_chain) <= _KNOWN_QUEUE_ORDER
        or not set(ns_chain) <= {"drf"}
        or not set(ready_chain) <= {"gang"}
        or not overused_names <= {"proportion"}
    ):
        return None

    use_drf = "drf" in job_chain
    use_ns_drf = bool(ns_chain)  # weighted-namespace DRF order
    use_proportion = bool(queue_chain) or overused_names
    drf = ssn.plugins.get("drf") if use_drf or use_ns_drf else None
    proportion = ssn.plugins.get("proportion") if use_proportion else None
    if (use_drf or use_ns_drf) and (
        drf is None
        or not hasattr(drf, "job_attrs")
        or not hasattr(drf, "namespace_opts")
    ):
        return None
    if use_proportion and (
        proportion is None or not hasattr(proportion, "queue_opts")
    ):
        return None

    # ---- eligible jobs, namespace/queue maps (drive_allocate_loop) ----
    from volcano_tpu_torch.actions.allocate import eligible_jobs

    jobs = list(eligible_jobs(ssn))
    if not jobs:
        return []

    job_shares: Dict[str, _Share] = {}
    if use_drf:
        total = drf.total_resource
        for job in jobs:
            attr = drf.job_attrs.get(job.uid)
            if attr is None:
                return None
            job_shares[job.uid] = _Share(attr.allocated, attr.share, total)

    # queue uid -> _Share, or None when proportion has no attr for it
    # (the plugin then reports share 0.0 and never overused).
    queue_shares: Dict[str, Optional[_Share]] = {}
    if use_proportion:
        for job in jobs:
            if job.queue in queue_shares:
                continue
            attr = proportion.queue_opts.get(job.queue)
            queue_shares[job.queue] = (
                None
                if attr is None
                else _Share(attr.allocated, attr.share, attr.deserved)
            )

    # namespace shares for weighted-namespace DRF (drf.go:223-248): the
    # ns being fed is outside the heap during its episode, so the same
    # lazy-repush discipline applies.
    ns_shares: Dict[str, _Share] = {}
    ns_weights: Dict[str, float] = {}
    if use_ns_drf:
        total = drf.total_resource
        empty = Resource()
        for job in jobs:
            if job.namespace in ns_shares:
                continue
            opt = drf.namespace_opts.get(job.namespace)
            ns_shares[job.namespace] = (
                _Share(opt.allocated, opt.share, total)
                if opt is not None
                else _Share(empty, 0.0, total)
            )
            info = ssn.namespace_info.get(job.namespace)
            ns_weights[job.namespace] = float(
                info.get_weight() if info else 1
            )

    def ns_key(ns: str):
        if use_ns_drf:
            return (ns_shares[ns].share / ns_weights[ns], ns)
        return (ns,)

    gang_ready = bool(ready_chain)  # gang's JobReady registered

    # per-job mutable order state
    fed: Dict[str, int] = {j.uid: 0 for j in jobs}
    ready0: Dict[str, int] = {j.uid: j.ready_task_num() for j in jobs}

    def job_key(job):
        key = []
        for name in job_chain:
            if name == "priority":
                key.append(-job.priority)
            elif name == "gang":
                ready = ready0[job.uid] + fed[job.uid] >= job.min_available
                key.append(1 if ready else 0)
            else:  # drf
                key.append(job_shares[job.uid].share)
        key.append(job.creation_timestamp)
        key.append(job.uid)
        return tuple(key)

    # namespace -> {queue uid -> job heap}, insertion order preserved;
    # ns heap entries are ns_key tuples ending in the namespace string.
    ns_heap: List = []
    ns_map: Dict[str, Dict[str, List]] = {}
    for job in jobs:
        queue_map = ns_map.get(job.namespace)
        if queue_map is None:
            heapq.heappush(ns_heap, ns_key(job.namespace))
            queue_map = {}
            ns_map[job.namespace] = queue_map
        heapq.heappush(
            queue_map.setdefault(job.queue, []), (job_key(job), job)
        )

    # lazily-built static task order per job (build_pending_task_queue)
    pending: Dict[str, List[TaskInfo]] = {}
    use_task_priority = bool(task_chain)

    def build_pending(job) -> List[TaskInfo]:
        tasks = [
            t
            for t in job.task_status_index.get(TaskStatus.Pending, {}).values()
            if not t.resreq.is_empty()
        ]
        if use_task_priority:
            tasks.sort(key=lambda t: (-t.priority, t.creation_timestamp, t.uid))
        else:
            tasks.sort(key=lambda t: (t.creation_timestamp, t.uid))
        return tasks

    order: List[TaskInfo] = []

    while ns_heap:
        namespace = heapq.heappop(ns_heap)[-1]
        queue_in_namespace = ns_map[namespace]

        # least-share non-overused queue, same linear scan + tie-break as
        # drive_allocate_loop (queue_order_fn then ts/uid).  Shares only
        # participate when proportion's queue-order is in the chain.
        by_share = bool(queue_chain)
        queue = None
        queue_share = None
        for queue_id in list(queue_in_namespace):
            qinfo = ssn.queues[queue_id]
            qs = queue_shares.get(queue_id)
            if qs is not None and qs.overused():
                del queue_in_namespace[queue_id]
                continue
            if queue is None:
                queue, queue_share = qinfo, qs
                continue
            ls = qs.share if by_share and qs is not None else 0.0
            rs = queue_share.share if by_share and queue_share is not None else 0.0
            before = (
                ls < rs
                if ls != rs
                else (
                    qinfo.uid < queue.uid
                    if qinfo.creation_timestamp == queue.creation_timestamp
                    else qinfo.creation_timestamp < queue.creation_timestamp
                )
            )
            if before:
                queue, queue_share = qinfo, qs
        if queue is None:
            continue

        heap = queue_in_namespace.get(queue.uid)
        if not heap:
            continue

        _, job = heapq.heappop(heap)
        tasks = pending.get(job.uid)
        if tasks is None:
            tasks = build_pending(job)
            pending[job.uid] = tasks

        # feed tasks until gang-ready (or exhaustion); without a JobReady
        # registration every placement reports ready immediately.
        n_fed = fed[job.uid]
        consumed = 0
        became_ready = False
        jshare = job_shares.get(job.uid)
        qshare = queue_shares.get(job.queue) if use_proportion else None
        nshare = ns_shares.get(namespace) if use_ns_drf else None
        while consumed < len(tasks):
            task = tasks[consumed]
            consumed += 1
            order.append(task)
            if jshare is not None:
                jshare.add_task(task.resreq)
            if qshare is not None:
                qshare.add_task(task.resreq)
            if nshare is not None:
                nshare.add_task(task.resreq)
            if (
                not gang_ready
                or ready0[job.uid] + n_fed + consumed >= job.min_available
            ):
                became_ready = True
                break
        fed[job.uid] = n_fed + consumed
        del tasks[:consumed]
        if consumed:
            if jshare is not None:
                jshare.update_share()
            if qshare is not None:
                qshare.update_share()
            if nshare is not None:
                nshare.update_share()

        if became_ready:
            heapq.heappush(heap, (job_key(job), job))
        heapq.heappush(ns_heap, ns_key(namespace))

    return order
