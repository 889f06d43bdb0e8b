"""Incrementally-maintained fair-share ledger.

A copy of ``volcano_tpu/incremental/shares.py``.

The proportion and DRF plugins recompute per-queue / per-namespace
allocated+request totals on EVERY session open by sweeping every
resident JobInfo — O(resident jobs) per cycle, the exact cost the
restricted-session plane exists to remove.  The ledger maintains those
totals incrementally instead: ``SchedulerCache._mark_job`` (the single
choke point every job-mutating cache handler already passes through —
bind echoes, evictions, completions, pod/pod-group add/delete) calls
:meth:`ShareLedger.observe` with the post-mutation JobInfo, and the
ledger diffs the job's new contribution against the one it stored.

Sums stay EXACT, not approximate: resource quantities are integer
cpu-milli / memory-bytes held in float64, so addition is associative
and the incremental totals equal the swept totals bit-for-bit — which
is what lets ``proportion.py`` seed ``queue_opts`` from
:meth:`ShareLedger.seed` and still produce the same deserved/share
water-filling a full sweep would.

Locking: the ledger has no lock of its own.  Every mutating call
(:meth:`observe`, :meth:`forget`) happens inside
``SchedulerCache._mark_job`` under the cache mutex, and every read
(:meth:`seed`, :meth:`schedulable_uids`, the counters) is taken under
the same mutex by the cache's public accessors — the ledger is a
private component of the cache, never shared across locks.

``plant_divergence`` is the testability seam (à la ``vtctl explore
--plant``): it corrupts what the ledger REPORTS — never what it stores
— so the shadow cross-check in :mod:`volcano_tpu_torch.incremental.subgraph`
can prove it detects a broken ledger, then heal by clearing the plant.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Set, Tuple

from volcano_tpu_torch.api import TaskStatus
from volcano_tpu_torch.api.resource import empty_resource, Resource

#: plant kinds understood by :meth:`ShareLedger.plant_divergence`
PLANT_DROP_SCHEDULABLE = "drop-schedulable"
PLANT_INFLATE_ALLOCATED = "inflate-allocated"


class QueueShare:
    """One queue's ledger totals — the incremental twin of proportion's
    ``_QueueAttr`` accumulation phase."""

    __slots__ = ("allocated", "request", "jobs")

    def __init__(self):
        self.allocated = empty_resource()
        self.request = empty_resource()
        self.jobs = 0


class ShareSeed:
    """Read-only export handed to sessions via ``ClusterInfo.share_seed``:
    cloned totals, so session-side arithmetic can never corrupt the
    ledger."""

    __slots__ = ("queues", "namespaces")

    def __init__(
        self,
        queues: Dict[str, Tuple[Resource, Resource]],
        namespaces: Dict[str, Resource],
    ):
        #: queue uid → (allocated, request)
        self.queues = queues
        #: namespace → allocated (the DRF namespace-order aggregate)
        self.namespaces = namespaces


class _Contribution:
    """What one job currently adds to the aggregates."""

    __slots__ = ("queue", "namespace", "allocated", "request", "schedulable")

    def __init__(self, queue, namespace, allocated, request, schedulable):
        self.queue = queue
        self.namespace = namespace
        self.allocated = allocated
        self.request = request
        self.schedulable = schedulable


class ShareLedger:
    def __init__(self):
        #: job uid → its applied contribution
        self._jobs: Dict[str, _Contribution] = {}
        #: queue uid → QueueShare
        self._queues: Dict[str, QueueShare] = {}
        #: namespace → [allocated Resource, job count]
        self._namespaces: Dict[str, list] = {}
        #: uids of jobs with schedulable work (a non-empty Pending
        #: bucket under a live PodGroup) — the O(1) wake gate and the
        #: restricted-session subgraph
        self._schedulable: Set[str] = set()
        self._plant: Optional[Tuple[str, Optional[str]]] = None

    # ---- maintenance (called under the cache mutex) ----

    def observe(self, job, uid: str) -> None:
        """Re-derive ``uid``'s contribution from its post-mutation
        JobInfo and diff it into the aggregates.  ``job is None`` (gone
        from the cache) and ``job.pod_group is None`` (no scheduling
        spec — snapshots skip it, so share sweeps never saw it either)
        both retract the contribution entirely.

        Cost is O(pending tasks of THIS job): the allocated rollup is
        already maintained on JobInfo, only the Pending bucket is
        summed — so a bind burst over a 1M-resident cache touches one
        job's pending tasks per event, never the other 999 999 jobs.
        """
        if job is None or job.pod_group is None:
            self.forget(uid)
            return
        pending_bucket = job.task_status_index.get(TaskStatus.Pending)
        request = job.allocated.clone()
        for t in (pending_bucket or {}).values():
            request.add(t.resreq)
        new = _Contribution(
            queue=job.queue,
            namespace=job.namespace,
            allocated=job.allocated.clone(),
            request=request,
            schedulable=bool(pending_bucket),
        )
        old = self._jobs.get(uid)
        if old is not None:
            self._retract(old)
        self._jobs[uid] = new
        self._apply(new)
        if new.schedulable:
            self._schedulable.add(uid)
        else:
            self._schedulable.discard(uid)

    def forget(self, uid: str) -> None:
        old = self._jobs.pop(uid, None)
        if old is not None:
            self._retract(old)
        self._schedulable.discard(uid)

    def _apply(self, c: _Contribution) -> None:
        qs = self._queues.get(c.queue)
        if qs is None:
            qs = self._queues[c.queue] = QueueShare()
        qs.allocated.add(c.allocated)
        qs.request.add(c.request)
        qs.jobs += 1
        ns = self._namespaces.get(c.namespace)
        if ns is None:
            ns = self._namespaces[c.namespace] = [empty_resource(), 0]
        ns[0].add(c.allocated)
        ns[1] += 1

    def _retract(self, c: _Contribution) -> None:
        # sub_unchecked: the aggregate is a sum that INCLUDES this very
        # contribution, so the subtraction is exact by construction —
        # a less_equal guard would only add float comparisons
        qs = self._queues.get(c.queue)
        if qs is not None:
            qs.allocated.sub_unchecked(c.allocated)
            qs.request.sub_unchecked(c.request)
            qs.jobs -= 1
            if qs.jobs <= 0:
                del self._queues[c.queue]
        ns = self._namespaces.get(c.namespace)
        if ns is not None:
            ns[0].sub_unchecked(c.allocated)
            ns[1] -= 1
            if ns[1] <= 0:
                del self._namespaces[c.namespace]

    # ---- reads (taken under the cache mutex by cache accessors) ----

    @property
    def resident_count(self) -> int:
        """Jobs contributing to the ledger (live PodGroup)."""
        return len(self._jobs)

    @property
    def schedulable_count(self) -> int:
        return len(self._schedulable)

    def schedulable_uids(self) -> Set[str]:
        """Uids the restricted subgraph opens over.  A planted
        ``drop-schedulable`` is applied HERE, at read time — the stored
        set stays correct, so clearing the plant heals the ledger."""
        out = set(self._schedulable)
        if self._plant is not None and self._plant[0] == PLANT_DROP_SCHEDULABLE:
            key = self._plant[1]
            if key is not None:
                out.discard(key)
            elif out:
                out.discard(sorted(out)[0])
        return out

    def seed(self) -> ShareSeed:
        """Cloned per-queue / per-namespace totals for session seeding.
        A planted ``inflate-allocated`` corrupts the reported copy of
        one queue's allocated total (again read-time only)."""
        queues = {
            uid: (qs.allocated.clone(), qs.request.clone())
            for uid, qs in self._queues.items()
        }
        namespaces = {ns: pair[0].clone() for ns, pair in self._namespaces.items()}
        if self._plant is not None and self._plant[0] == PLANT_INFLATE_ALLOCATED:
            key = self._plant[1]
            targets: Iterable[str] = (
                [key] if key is not None else sorted(queues)[:1]
            )
            for q in targets:
                if q in queues:
                    alloc = queues[q][0]
                    alloc.add(Resource(milli_cpu=1e9, memory=1e15))
        return ShareSeed(queues, namespaces)

    # ---- fault seam ----

    def plant_divergence(self, kind: str, key: Optional[str] = None) -> None:
        """Arm a read-time corruption so tests can prove the shadow
        cross-check flags a broken ledger (and that clearing the plant
        heals it).  ``kind`` ∈ {``drop-schedulable``,
        ``inflate-allocated``}; ``key`` pins the victim uid/queue
        (default: the lexicographically first, deterministically)."""
        if kind not in (PLANT_DROP_SCHEDULABLE, PLANT_INFLATE_ALLOCATED):
            raise ValueError(f"unknown plant kind: {kind}")
        self._plant = (kind, key)

    def clear_plant(self) -> None:
        self._plant = None
