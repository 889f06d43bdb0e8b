"""Packing + dense reference for the reclaim pass.

A copy of ``volcano_tpu/ops/reclaim_pack.py``: numpy on the host, as the
reference runs it — the reference has no device program for reclaim, so
the port has none either.

Tensorizes the cross-queue reclaim session (actions/reclaim.py,
mirroring pkg/scheduler/actions/reclaim/reclaim.go:42-202) into flat
arrays:

  * reclaimer stream: per queue, starving jobs in job-order, ONE pending
    task each (the host pops exactly one task per job and never
    re-pushes the job — reclaim.go pops jobs once);
  * victim candidates (Running tasks of OTHER queues), per node in
    uid-sorted order (reclaim iterates ``sorted(node.tasks)``, no
    eviction-order inversion here — unlike preempt);
  * queue tables carrying the proportion plugin's session-open state
    (deserved from the water-filling, allocated) — queue ORDER and the
    ``overused`` gate evolve with evictions/pipelines, so the dense
    replay carries them as mutable state exactly like the plugin's
    event handlers do;
  * job tables for the gang reclaimable guard (min_available, ready).

``reclaim_dense`` is the numpy reference implementation of the exact
same semantics — asserted against the host ReclaimAction in
tests/test_reclaim_kernel.py, the same bindings-equivalence discipline
as ops/preempt_pack.py.

Semantics notes (verified against the host):

  * the reclaimable intersection under the supported tiers is
    gang ∩ conformance (tier 1) — proportion's reclaimable_fn sits in
    tier 2 and never runs once tier 1 yields; pack refuses sessions
    with a different first-reclaimable tier, and conformance-critical
    victims are excluded at pack time;
  * reclaim never checks node resource fit: victims are evicted until
    the accumulated reclaimed resources cover the reclaimer's request
    (reclaim.go:155-180), then the task pipelines on that node;
  * evictions are immediate session mutations (no Statement) — there is
    no rollback in this pass;
  * queue selection is DYNAMIC: smallest proportion share first with
    stable re-push order (PriorityQueue semantics), and ``overused``
    (allocated ≰ deserved) drops a queue from the rotation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from volcano_tpu_torch.api import TaskStatus
from volcano_tpu_torch.apis import scheduling
from volcano_tpu_torch.ops.packing import _res_vec, pack_session, PackedSnapshot
from volcano_tpu_torch.ops.preempt_pack import _order_stable


@dataclass
class ReclaimPacked:
    """Dense reclaim-session state.  ``base`` holds the reclaimer tasks
    (one per starving job, stream order) and all node arrays."""

    base: PackedSnapshot = None

    # reclaimer stream: per queue [start, end) rows (jobs in job-order)
    queue_p_start: np.ndarray = None  # [Q] i32
    queue_p_end: np.ndarray = None  # [Q] i32

    # queue tables (proportion state at session open)
    n_queues: int = 0
    q_deserved: np.ndarray = None  # [Q, R]
    q_alloc0: np.ndarray = None  # [Q, R]
    q_creation: np.ndarray = None  # [Q] f64 — queue_order tie-break
    queue_uids: List[str] = field(default_factory=list)

    # victims per node in uid order
    n_victims: int = 0
    vic_resreq: np.ndarray = None  # [V, R]
    vic_node: np.ndarray = None  # [V] i32
    vic_job: np.ndarray = None  # [V] i32
    vic_queue: np.ndarray = None  # [V] i32
    vic_uids: List[str] = field(default_factory=list)
    vic_names: List[str] = field(default_factory=list)

    # job tables (gang guard)
    n_jobs: int = 0
    job_min_avail: np.ndarray = None  # [J]
    job_ready0: np.ndarray = None  # [J]
    job_uids: List[str] = field(default_factory=list)

    ptask_uids: List[str] = field(default_factory=list)
    node_names: List[str] = field(default_factory=list)
    # resource lane view of deserved/allocated (same lanes as base)
    tolerance: np.ndarray = None


_SUPPORTED_RECLAIMABLE = {"gang", "conformance"}


def _check_reclaimable_tiers(ssn) -> None:
    """Raise unless the first tier with enabled reclaimable plugins is
    exactly the gang ∩ conformance intersection the dense formulation
    encodes (proportion's tier-2 reclaimable never runs under it)."""
    for tier in ssn.tiers:
        enabled = {
            p.name
            for p in tier.plugins
            if getattr(p, "enabled_reclaimable")
            and p.name in ssn.reclaimable_fns
        }
        if enabled:
            if enabled != _SUPPORTED_RECLAIMABLE:
                raise ValueError(
                    "dense reclaim formulation supports reclaimable tier "
                    f"{sorted(_SUPPORTED_RECLAIMABLE)}, session has "
                    f"{sorted(enabled)}"
                )
            return
    raise ValueError("session has no enabled reclaimable plugins")


def pack_reclaim_session(ssn) -> ReclaimPacked:
    """Session → ReclaimPacked (order replay host-side; queue rotation
    stays dynamic in the dense replay)."""
    _check_reclaimable_tiers(ssn)

    prop = ssn.plugins.get("proportion")
    if prop is None or not getattr(prop, "queue_opts", None):
        raise ValueError(
            "dense reclaim needs the proportion plugin's queue state "
            "(deserved/allocated) in the session"
        )

    # queue discovery (reclaim.go:56-76): uid-sorted job scan
    queues: Dict[str, object] = {}
    starving: Dict[str, List] = {}
    first_task: Dict[str, object] = {}
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
        pending = job.task_status_index.get(TaskStatus.Pending)
        if pending:
            starving.setdefault(queue.uid, []).append(job)
            # the host pops exactly ONE task per job: the task-order head
            ordered = _order_stable(
                sorted(pending.values(), key=lambda t: t.uid),
                lambda l, r: ssn.task_order_fn(l, r),
            )
            first_task[job.uid] = ordered[0]

    for quid in starving:
        starving[quid] = _order_stable(
            starving[quid], lambda l, r: ssn.job_order_fn(l, r)
        )

    queue_row = {quid: i for i, quid in enumerate(queues)}
    Q = len(queues)

    # reclaimer stream: queue-major, jobs in job-order, one task each
    stream_tasks: List = []
    stream_job_uids = set()
    qp_start = np.zeros(max(Q, 1), dtype=np.int32)
    qp_end = np.zeros(max(Q, 1), dtype=np.int32)
    for quid, qrow in queue_row.items():
        qp_start[qrow] = len(stream_tasks)
        for job in starving.get(quid, []):
            stream_tasks.append(first_task[job.uid])
            stream_job_uids.add(job.uid)
        qp_end[qrow] = len(stream_tasks)

    jobs = sorted(ssn.jobs.values(), key=lambda j: j.uid)
    job_row = {j.uid: i for i, j in enumerate(jobs)}
    nodes = [ssn.nodes[name] for name in sorted(ssn.nodes)]
    base = pack_session(
        stream_tasks,
        jobs,
        nodes,
        enforce_pod_count="predicates" in ssn.predicate_fns,
    )

    pk = ReclaimPacked(base=base)
    pk.ptask_uids = list(base.task_uids)
    pk.node_names = list(base.node_names)
    pk.tolerance = base.tolerance
    pk.queue_p_start = qp_start
    pk.queue_p_end = qp_end

    R = base.task_resreq.shape[1]
    names = base.resource_names
    pk.n_queues = Q
    pk.q_deserved = np.zeros((max(Q, 1), R), dtype=np.float64)
    pk.q_alloc0 = np.zeros((max(Q, 1), R), dtype=np.float64)
    pk.queue_uids = list(queues)
    pk.q_creation = np.zeros(max(Q, 1), dtype=np.float64)
    for quid, qrow in queue_row.items():
        attr = prop.queue_opts.get(quid)
        if attr is not None:
            pk.q_deserved[qrow] = _res_vec(attr.deserved, names, base)
            pk.q_alloc0[qrow] = _res_vec(attr.allocated, names, base)
        pk.q_creation[qrow] = queues[quid].creation_timestamp

    # victims: Running tasks of jobs with a known queue, non-critical
    from volcano_tpu_torch.plugins.conformance import _is_critical

    vics = []
    node_row = {n.name: i for i, n in enumerate(nodes)}
    for n in nodes:
        for t in sorted(n.tasks.values(), key=lambda t: t.uid):
            if t.status != TaskStatus.Running or t.job not in ssn.jobs:
                continue
            if _is_critical(t):
                continue
            vjob = ssn.jobs[t.job]
            # The host's reclaimee filter only needs the VICTIM's job to
            # exist and its queue NAME to differ from the reclaimer's —
            # it never requires the victim's queue to be discovered.
            # Undiscovered/dangling queues get sentinel row -1 (always a
            # "different queue"; no proportion state to update).
            vq = ssn.queues.get(vjob.queue)
            qrow = queue_row.get(vq.uid, -1) if vq is not None else -1
            if (
                vjob.uid in stream_job_uids
                and len(starving.get(vq.uid if vq else "", [])) >= 2
            ):
                # A job that is BOTH a reclaimer and a victim source makes
                # the frozen job order unsound when its queue has other
                # starving jobs to reorder against: evicting its tasks
                # flips gang readiness / DRF share, which the host's live
                # PriorityQueue pops would observe.  Refuse → host path.
                # (With a single starving job in the queue there is no
                # order to disturb — the frozen replay stays exact.)
                raise ValueError(
                    f"job {vjob.uid} is both reclaimer and victim source "
                    "in a multi-job queue; frozen order replay would diverge"
                )
            vics.append((node_row[n.name], qrow, t))
    V = len(vics)
    pk.n_victims = V
    pk.vic_resreq = np.zeros((max(V, 1), R), dtype=np.float32)
    pk.vic_node = np.zeros(max(V, 1), dtype=np.int32)
    pk.vic_job = np.zeros(max(V, 1), dtype=np.int32)
    pk.vic_queue = np.zeros(max(V, 1), dtype=np.int32)
    for i, (nrow, qrow, t) in enumerate(vics):
        pk.vic_resreq[i] = _res_vec(t.resreq, names, base)
        pk.vic_node[i] = nrow
        pk.vic_job[i] = job_row[t.job]
        pk.vic_queue[i] = qrow
        pk.vic_uids.append(t.uid)
        pk.vic_names.append(f"{t.namespace}/{t.name}")

    J = len(jobs)
    pk.n_jobs = J
    pk.job_min_avail = np.array([j.min_available for j in jobs], dtype=np.int32)
    pk.job_ready0 = np.array([j.ready_task_num() for j in jobs], dtype=np.int32)
    pk.job_uids = [j.uid for j in jobs]
    return pk


# ---- dense reference implementation (numpy, exact) ----


def _lanes_le(l: np.ndarray, r: np.ndarray, tol: np.ndarray) -> bool:
    """Resource.less_equal on packed lanes (scalar lanes skip when the
    left side is within tolerance)."""
    ok = l < r + tol
    skip = np.zeros_like(ok)
    skip[2:] = l[2:] <= tol[2:]
    return bool(np.all(ok | skip))


def _lanes_le_strict(l: np.ndarray, r: np.ndarray) -> bool:
    return bool(np.all(l <= r))


def reclaim_dense(pk: ReclaimPacked) -> Tuple[np.ndarray, np.ndarray]:
    """Dense replay → (evicted[V] bool, pipelined_node[P] i32, -1=none).

    Mutable state: victim alive[V], job ready[J], queue allocated[Q,R],
    node pod counts; queue rotation by smallest share with stable
    insertion order; ``overused`` drops queues (reclaim.go:86-199)."""
    base = pk.base
    R = base.task_resreq.shape[1]
    N = base.n_nodes
    V = pk.n_victims
    P = base.n_tasks
    Q = pk.n_queues
    tol = pk.tolerance

    # static per-(reclaimer, node) feasibility: labels/taints/node_ok
    sel_ok = (
        (base.task_sel_bits[:P, None, :] & ~base.node_label_bits[None, :N, :]) == 0
    ).all(-1)
    tol_ok = (
        (base.node_taint_bits[None, :N, :] & ~base.task_tol_bits[:P, None, :]) == 0
    ).all(-1)
    static_feas = sel_ok & tol_ok & base.node_ok[None, :N]  # [P, N]

    alive = np.ones(max(V, 1), dtype=bool)[:V]
    evicted = np.zeros(max(V, 1), dtype=bool)[:V]
    pipelined = np.full(max(P, 1), -1, dtype=np.int32)[:P]
    ready = pk.job_ready0.copy()
    qalloc = pk.q_alloc0.copy()
    cursor = pk.queue_p_start.copy()
    ncount = base.node_task_count[:N].astype(np.int64)
    nmax = base.node_max_tasks[:N].astype(np.int64)

    def share(q: int) -> float:
        s = 0.0
        for r in range(R):
            d = pk.q_deserved[q, r]
            a = qalloc[q, r]
            if d > 0:
                s = max(s, a / d)
            elif a > 0:
                s = max(s, 1.0)
        return s

    def overused(q: int) -> bool:
        return not _lanes_le(
            qalloc[q].astype(np.float32), pk.q_deserved[q].astype(np.float32), tol
        )

    # queue rotation: the SAME PriorityQueue implementation the host
    # action drives (heapq over a live less-fn) so heap artifacts under
    # mutating shares are reproduced bit-for-bit; less = session
    # queue_order_fn semantics (proportion share, then creation/uid)
    from volcano_tpu_torch.utils.priority_queue import PriorityQueue

    def qless(a: int, b: int) -> bool:
        sa, sb = share(a), share(b)
        if sa != sb:
            return sa < sb
        if pk.q_creation[a] == pk.q_creation[b]:
            return pk.queue_uids[a] < pk.queue_uids[b]
        return pk.q_creation[a] < pk.q_creation[b]

    rotation = PriorityQueue(qless)
    for i in range(Q):
        rotation.push(i)

    # ---- incremental eligibility state (pure acceleration; the
    # per-node body below recomputes its victim set exactly) ----
    # victims grouped per node in ascending victim-index order (matches
    # the original np.nonzero scan order)
    if V:
        vorder = np.argsort(pk.vic_node[:V], kind="stable")
        vnodes_sorted = pk.vic_node[vorder]
        starts = np.searchsorted(vnodes_sorted, np.arange(N), side="left")
        ends = np.searchsorted(vnodes_sorted, np.arange(N), side="right")
        node_vics = [vorder[starts[n]:ends[n]] for n in range(N)]
        # gang allowance per job — monotone (ready only decreases here)
        gang_ok_j = (pk.job_min_avail <= ready - 1) | (pk.job_min_avail == 1)
        vjob_members = [[] for _ in range(pk.n_jobs)]
        for v in range(V):
            vjob_members[pk.vic_job[v]].append(v)
        vr64 = pk.vic_resreq.astype(np.float64)
        # per-node reclaimable totals: all eligible-by-gang alive victims
        # (node_tot_all) and the same split by victim queue so a
        # reclaimer in queue q sees node_tot_all - node_tot_q[q]
        elig0 = gang_ok_j[pk.vic_job[:V]]
        node_tot_all = np.zeros((N, R), dtype=np.float64)
        node_tot_q = np.zeros((max(Q, 1), N, R), dtype=np.float64)
        for r in range(R):
            node_tot_all[:, r] = np.bincount(
                pk.vic_node[:V][elig0], weights=vr64[elig0, r], minlength=N
            )
        vq = pk.vic_queue[:V]
        for qi in range(Q):
            m = elig0 & (vq == qi)
            for r in range(R):
                node_tot_q[qi, :, r] = np.bincount(
                    pk.vic_node[:V][m], weights=vr64[m, r], minlength=N
                )

        def _drop_victim_total(v: int) -> None:
            n, qv = pk.vic_node[v], pk.vic_queue[v]
            node_tot_all[n] -= vr64[v]
            if qv >= 0:
                node_tot_q[qv, n] -= vr64[v]

        def _on_evict(v: int) -> None:
            """Maintain totals + gang flags after alive[v] flips."""
            j = pk.vic_job[v]
            if gang_ok_j[j]:
                _drop_victim_total(v)
            # ready[j] was just decremented by the caller
            if gang_ok_j[j] and not (
                pk.job_min_avail[j] <= ready[j] - 1 or pk.job_min_avail[j] == 1
            ):
                gang_ok_j[j] = False
                for w in vjob_members[j]:
                    if alive[w]:
                        _drop_victim_total(w)

    tol64 = tol.astype(np.float64)

    while not rotation.empty():
        q = rotation.pop()
        if overused(q):
            continue
        if cursor[q] >= pk.queue_p_end[q]:
            continue
        p = cursor[q]
        cursor[q] += 1
        resreq = base.task_resreq[p]

        # Vectorized candidate-node prefilter over incrementally
        # maintained reclaimable totals — the naive per-node rescan is
        # O(nodes × victims) per reclaimer and goes superlinear as early
        # nodes drain (21s → 3.2s at 45k victims, minutes → 12s at the
        # 90k×10k shape).  The totals
        # only GATE candidates: slack covers their incremental-float
        # drift vs the exact pairwise np.sum the body still performs, so
        # any node the exact check could accept passes the gate, and the
        # per-node body recomputes eligibility exactly (same victim set,
        # same ascending order as the original np.nonzero scan).
        if V:
            avail = node_tot_all - node_tot_q[q]
            enough = (
                resreq[None, :].astype(np.float64)
                <= avail * (1.0 + 1e-9) + tol64 + 1e-6
            ).all(axis=1)
            cand_nodes = np.nonzero(
                static_feas[p, :N] & (ncount < nmax) & enough
            )[0]
        else:
            cand_nodes = np.nonzero(static_feas[p, :N] & (ncount < nmax))[0]

        assigned = False
        for n in cand_nodes:
            # victims on node n from other queues, gang-allowed at
            # CURRENT ready counts (intersection per node attempt)
            elig_idx = [
                v
                for v in node_vics[n]
                if alive[v]
                and pk.vic_queue[v] != q
                and (
                    pk.job_min_avail[pk.vic_job[v]] <= ready[pk.vic_job[v]] - 1
                    or pk.job_min_avail[pk.vic_job[v]] == 1
                )
            ] if V else []
            if not elig_idx:
                continue
            total = pk.vic_resreq[elig_idx].astype(np.float64).sum(axis=0)
            if not _lanes_le(resreq, total.astype(np.float32), tol):
                continue
            reclaimed = np.zeros(R, dtype=np.float64)
            for v in elig_idx:
                alive[v] = False
                evicted[v] = True
                ready[pk.vic_job[v]] -= 1
                _on_evict(v)
                if pk.vic_queue[v] >= 0:
                    qalloc[pk.vic_queue[v]] -= pk.vic_resreq[v]
                reclaimed += pk.vic_resreq[v]
                if _lanes_le(resreq, reclaimed.astype(np.float32), tol):
                    break
            if _lanes_le(resreq, reclaimed.astype(np.float32), tol):
                pipelined[p] = n
                ncount[n] += 1
                qalloc[q] += resreq.astype(np.float64)
                assigned = True
                break

        if assigned:
            rotation.push(q)

    return evicted, pipelined
