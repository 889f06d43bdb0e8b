"""Bulk APPLY phase for gpu-allocate: vectorized commit of a fully-placed
kernel assignment, bypassing the per-task statement/heap/event machinery.

The slow path (drive_allocate_loop + Statement) costs ~90µs/task of pure
Python at the 50k headline shape — 20x the whole device-kernel budget —
yet when the packer encoded every predicate exactly and the kernel
committed every task, the loop is mechanical: each ordered task lands on
its proposed node, every job turns gang-ready, every statement commits.
This module reproduces that exact final state with one pass over the
ordered tasks plus per-object bulk writebacks:

  * float accounting (job.allocated/total_request, node.idle/used, drf /
    proportion / namespace shares) applies the same per-lane operation
    sequences the slow path would (grouped by owning object, which
    preserves IEEE bit-identity — lanes of different objects never mix)
  * dict state (job.tasks order, task_status_index buckets, node.tasks
    clones, the two PodLister views) is rebuilt with the same insertion
    orders
  * cache side effects flow through SchedulerCache.bind_batch — the same
    internal mutations as per-task bind() under one mutex hold, with the
    binder/event effects run in task order

The commit is PARTIAL at job granularity: jobs whose every pending task
carries a clean validated-exact proposal bulk-commit; jobs with a
preference task, a PVC-backed pod, or a missing proposal stay on the
slow Statement loop, which runs only over that residual (committed jobs
drain to empty pending queues).  ``try_fast_apply``'s verdict is True
only when nothing was left for the slow loop; session-level envelope
violations (unknown plugins, inexact packing, host-validation needs)
still refuse wholesale with nothing committed.

A copy of ``volcano_tpu/actions/fast_apply.py``.

Equivalence scope: for fully-applied sessions, tests/test_fast_apply.py
pins the resulting session + cache state equal to the slow path's,
field by field.  For PARTIAL sessions the bulk subset commits before
the residual loop runs, so when a residual job sorts BEFORE a clean job
in the drive order AND the two contend for capacity, placements can
differ from the pure slow path's interleaving — the same
capacity-race envelope the kernel-proposal fallback already documents
(gpu_allocate.py): every placement is still individually valid, kernel
resource accounting is conservative (it reserved for the residual tasks
too), and the partial-path tests pin exact state equality for the
residual-sorts-last case.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

from volcano_tpu_torch.api import TaskInfo, TaskStatus
from volcano_tpu_torch.api.job_info import _READY_STATUSES
from volcano_tpu_torch.framework.session import Session

#: plugins whose event handlers / state this bulk path models exactly
_KNOWN_PLUGINS = frozenset(
    (
        "priority",
        "gang",
        "conformance",
        "drf",
        "proportion",
        "predicates",
        "nodeorder",
        "binpack",
    )
)

#: plugins that register an allocate/deallocate EventHandler
_HANDLER_PLUGINS = ("drf", "proportion", "predicates", "nodeorder")


class _LaneAcc:
    """Float lanes (cpu, memory, scalars) mutated with the exact op
    sequence the slow path would apply to the owning Resource object."""

    __slots__ = ("cpu", "mem", "scalars")

    def __init__(self, res):
        self.cpu = res.milli_cpu
        self.mem = res.memory
        self.scalars = dict(res.scalars) if res.scalars else {}

    def store(self, res) -> None:
        res.milli_cpu = self.cpu
        res.memory = self.mem
        if self.scalars or res.scalars:
            res.scalars = self.scalars


def _acc_alloc(a0: _LaneAcc, a1: _LaneAcc, rr) -> None:
    """Statement.allocate's job-lane ops: allocated +r; total -r,+r
    (update_task_status Pending→Allocated = delete_task_info +
    add_task_info)."""
    a0.cpu += rr.milli_cpu
    a0.mem += rr.memory
    a1.cpu = (a1.cpu - rr.milli_cpu) + rr.milli_cpu
    a1.mem = (a1.mem - rr.memory) + rr.memory
    if rr.scalars:
        _seq_add_scalars(a0, rr.scalars, (1,))
        _seq_add_scalars(a1, rr.scalars, (-1, 1))


def _acc_commit(a0: _LaneAcc, a1: _LaneAcc, rr) -> None:
    """Commit's job-lane ops: allocated -r,+r; total -r,+r
    (update_task_status Allocated→Binding — both allocated statuses)."""
    a0.cpu = (a0.cpu - rr.milli_cpu) + rr.milli_cpu
    a0.mem = (a0.mem - rr.memory) + rr.memory
    a1.cpu = (a1.cpu - rr.milli_cpu) + rr.milli_cpu
    a1.mem = (a1.mem - rr.memory) + rr.memory
    if rr.scalars:
        _seq_add_scalars(a0, rr.scalars, (-1, 1))
        _seq_add_scalars(a1, rr.scalars, (-1, 1))


def _seq_add_scalars(acc: _LaneAcc, scalars, pattern) -> None:
    """Apply +v/-v in ``pattern`` order per scalar lane (float
    non-associativity means x+v-v+v != x+v in general — the sequence must
    match the slow path's)."""
    sc = acc.scalars
    for name, v in scalars.items():
        x = sc.get(name, 0.0)
        for sign in pattern:
            x = x + v if sign > 0 else x - v
        sc[name] = x


def try_fast_apply(
    ssn: Session,
    ordered: List[TaskInfo],
    proposals: Dict[str, str],
    snap,
) -> Tuple[bool, float]:
    """Bulk-commit the provably-clean subset of ``proposals``; returns
    (verdict, seconds the cache commit took, 0.0 when nothing committed).

    The verdict is True when EVERY ordered task committed (the caller can
    skip the Statement loop entirely), and False either because the
    session is outside the bulk envelope (nothing committed) or because
    only a subset of jobs was bulk-committed — the caller then runs the
    slow drive loop, which naturally skips the committed jobs (their
    pending queues are empty) and handles only the residual tasks
    (preference terms, PVC flows, missing proposals).  One odd task no
    longer costs a full-session Python loop.

    Bulk granularity is the JOB: gang commit/discard is all-or-nothing
    per job, and the kernel's gang fixpoint only emits proposals for
    jobs it could fully place, so a job whose every pending task has a
    clean validated-exact proposal commits exactly as the slow path
    would."""
    if snap.needs_host_validation or not snap.memory_exact:
        return False, 0.0
    if not set(ssn.plugins) <= _KNOWN_PLUGINS:
        return False, 0.0
    expected_handlers = sum(1 for p in _HANDLER_PLUGINS if p in ssn.plugins)
    if len(ssn.event_handlers) != expected_handlers:
        return False, 0.0
    ready_chain = [
        p.name
        for tier in ssn.tiers
        for p in tier.plugins
        if p.enabled_job_ready and p.name in ssn.job_ready_fns
    ]
    if not set(ready_chain) <= {"gang"}:
        return False, 0.0
    cache = ssn.cache
    if not hasattr(cache, "bind_batch"):
        return False, 0.0

    drf = ssn.plugins.get("drf")
    proportion = ssn.plugins.get("proportion")
    # weighted-namespace DRF mirrors the plugin's own enablement check
    ns_enabled = drf is not None and any(
        p.enabled_namespace_order
        for tier in ssn.tiers
        for p in tier.plugins
        if p.name == "drf"
    )
    # the PodLister views live only in handler closures; locate them so
    # the bulk path can update them without firing per-task events
    listers = _find_pod_listers(ssn)
    if listers is None:
        return False, 0.0
    # needs_host_validation only covers the packed (pending) tasks' own
    # affinity specs — a PRE-ASSIGNED pod with required anti-affinity
    # makes the host predicate's symmetry check load-bearing for every
    # placement, which the kernel cannot see.  Refuse.
    if any(pl.any_required_anti_affinity() for pl in listers):
        return False, 0.0

    nodes_by_name = ssn.nodes
    gang_ready = bool(ready_chain)

    # ---- classify jobs: bulk-eligible vs residual ----
    groups: Dict[str, List[TaskInfo]] = {}
    has_pref = snap.task_has_preferences
    pref_by_uid = {}
    for i, t in enumerate(ordered):
        groups.setdefault(t.job, []).append(t)
        pref_by_uid[t.uid] = bool(has_pref[i]) if i < len(has_pref) else False
    eligible: set = set()
    for uid, tasks in groups.items():
        job = ssn.jobs.get(uid)
        if job is None:
            continue
        ok = True
        for t in tasks:
            host = proposals.get(t.uid)
            if host is None or pref_by_uid[t.uid]:
                ok = False
                break
            node = nodes_by_name.get(host)
            if node is None or node.node is None:
                ok = False
                break
            if t.pod is not None and cache.task_claim_names(t):
                ok = False  # PVC flows keep the slow path's volume logic
                break
        # the slow path would gang-discard a job that cannot reach
        # min_available — such jobs (the kernel never proposes them
        # fully) stay on the slow path
        if ok and gang_ready and job.ready_task_num() + len(tasks) < job.min_available:
            ok = False
        if ok and drf is not None and uid not in drf.job_attrs:
            ok = False
        if ok and ns_enabled and any(
            t.namespace not in drf.namespace_opts for t in tasks
        ):
            ok = False
        if ok:
            eligible.add(uid)
    if not eligible:
        return False, 0.0
    bulk = [t for t in ordered if t.job in eligible]

    # ---- single pass over the bulk tasks ----
    job_accs: Dict[str, tuple] = {}
    job_ready0: Dict[str, int] = {}
    node_rows: Dict[str, list] = {}
    drf_accs: Dict[str, _LaneAcc] = {}
    ns_accs: Dict[str, _LaneAcc] = {}
    q_accs: Dict[str, _LaneAcc] = {}

    for t in bulk:
        host = proposals[t.uid]
        rr = t.resreq
        rc, rm = rr.milli_cpu, rr.memory
        scal = rr.scalars

        job = ssn.jobs[t.job]
        acc = job_accs.get(job.uid)
        if acc is None:
            acc = (_LaneAcc(job.allocated), _LaneAcc(job.total_request), job, [])
            job_accs[job.uid] = acc
            job_ready0[job.uid] = job.ready_task_num()
        acc[3].append(t)

        rows = node_rows.get(host)
        if rows is None:
            rows = []
            node_rows[host] = rows
        rows.append(t)

        if drf is not None:
            jacc = drf_accs.get(t.job)
            if jacc is None:
                jacc = _LaneAcc(drf.job_attrs[t.job].allocated)
                drf_accs[t.job] = jacc
            jacc.cpu += rc
            jacc.mem += rm
            if scal:
                _seq_add_scalars(jacc, scal, (1,))
            if ns_enabled:
                nacc = ns_accs.get(t.namespace)
                if nacc is None:
                    nacc = _LaneAcc(drf.namespace_opts[t.namespace].allocated)
                    ns_accs[t.namespace] = nacc
                nacc.cpu += rc
                nacc.mem += rm
                if scal:
                    _seq_add_scalars(nacc, scal, (1,))
        if proportion is not None:
            qacc = q_accs.get(job.queue)
            if qacc is None:
                attr = proportion.queue_opts.get(job.queue)
                if attr is None:
                    continue
                qacc = _LaneAcc(attr.allocated)
                q_accs[job.queue] = qacc
            qacc.cpu += rc
            qacc.mem += rm
            if scal:
                _seq_add_scalars(qacc, scal, (1,))

    # ---- mutate: everything above validated, nothing mutated yet ----
    binding = TaskStatus.Binding
    for host, rows in node_rows.items():
        node = nodes_by_name[host]
        idle, used = _LaneAcc(node.idle), _LaneAcc(node.used)
        ntasks = node.tasks
        for t in rows:
            rr = t.resreq
            idle.cpu -= rr.milli_cpu
            idle.mem -= rr.memory
            used.cpu += rr.milli_cpu
            used.mem += rr.memory
            if rr.scalars:
                _seq_add_scalars(idle, rr.scalars, (-1,))
                _seq_add_scalars(used, rr.scalars, (1,))
            t.volume_ready = True
            t.node_name = host
            ti = t.clone()
            ti.status = TaskStatus.Allocated
            ntasks[t.uid] = ti
        idle.store(node.idle)
        used.store(node.used)

    for alloc_acc, total_acc, job, tasks in job_accs.values():
        # job.allocated/total_request follow the slow path's EPISODE
        # structure: the first episode feeds until gang-ready (all its
        # Statement.allocate ops, then all its commit ops), later episodes
        # are one task each.  Per-lane op order must match for IEEE
        # bit-identity — per-task interleave rounds differently on lanes
        # with non-exact values.
        ready0 = job_ready0[job.uid]
        k1 = 1
        if gang_ready and ready0 < job.min_available:
            k1 = min(max(job.min_available - ready0, 1), len(tasks))
        first, rest = tasks[:k1], tasks[k1:]
        for t in first:  # episode-1 allocates
            _acc_alloc(alloc_acc, total_acc, t.resreq)
        for t in first:  # episode-1 commits
            _acc_commit(alloc_acc, total_acc, t.resreq)
        for t in rest:  # single-task episodes
            _acc_alloc(alloc_acc, total_acc, t.resreq)
            _acc_commit(alloc_acc, total_acc, t.resreq)
        alloc_acc.store(job.allocated)
        total_acc.store(job.total_request)
        jtasks = job.tasks
        pending = job.task_status_index.get(TaskStatus.Pending)
        bbucket = job.task_status_index.setdefault(binding, {})
        ready_gain = 0
        for t in tasks:
            jtasks.pop(t.uid, None)
            jtasks[t.uid] = t
            if pending is not None:
                pending.pop(t.uid, None)
            if t.status not in _READY_STATUSES:
                ready_gain += 1  # Pending → Binding enters the ready set
            t.status = binding
            bbucket[t.uid] = t
        job.ready_num += ready_gain
        if pending is not None and not pending:
            del job.task_status_index[TaskStatus.Pending]

    if drf is not None:
        for uid, jacc in drf_accs.items():
            attr = drf.job_attrs[uid]
            jacc.store(attr.allocated)
            drf._update_share(attr)
        for ns, nacc in ns_accs.items():
            opt = drf.namespace_opts[ns]
            nacc.store(opt.allocated)
            drf._update_share(opt)
    if proportion is not None:
        for q, qacc in q_accs.items():
            attr = proportion.queue_opts[q]
            qacc.store(attr.allocated)
            proportion._update_share(attr)

    for pl in listers:
        tn = pl._task_nodes
        for t in bulk:
            tn[t.uid] = t.node_name
        # anti-affinity sets: gate guarantees no pod (anti-)affinity terms
        # (needs_host_validation would be set), so nothing to maintain.

    t0 = time.perf_counter()
    cache.bind_batch([(t, t.node_name) for t in bulk])
    # what the scheduling thread paid for the commit: the mutex-held
    # state mutation plus the binder calls, inline
    commit_s = time.perf_counter() - t0
    # journal only after the batch landed — "bind" means an actual
    # cache bind, and bind_batch mutates nothing when it raises
    if ssn._trace.enabled:
        for t in bulk:
            ssn._trace.decision("bind", t.uid, t.node_name)
    if hasattr(ssn, "touched_jobs"):
        ssn.touched_jobs.update(job_accs)
        ssn.touched_nodes.update(node_rows)
        ssn.node_state_epoch += 1
    return len(bulk) == len(ordered), commit_s


def _find_pod_listers(ssn: Session):
    """The predicates/nodeorder PodListers live in handler closures; pull
    them out so the bulk path can update them without firing per-task
    events.  None when a closure doesn't look like a PodLister-backed
    handler (unknown handler shape — refuse)."""
    from volcano_tpu_torch.plugins.util import PodLister

    listers = []
    for eh in ssn.event_handlers:
        fn = eh.allocate_func
        if fn is None:
            continue
        found = None
        closure = getattr(fn, "__closure__", None) or ()
        for cell in closure:
            try:
                if isinstance(cell.cell_contents, PodLister):
                    found = cell.cell_contents
                    break
            except ValueError:  # pragma: no cover - empty cell
                continue
        if found is not None:
            listers.append(found)
    expected = sum(1 for p in ("predicates", "nodeorder") if p in ssn.plugins)
    if len(listers) != expected:
        return None
    return listers
