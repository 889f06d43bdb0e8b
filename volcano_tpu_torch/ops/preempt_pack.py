"""The preempt session as dense arrays, and its PyTorch specification.

The counterpart of ``volcano_tpu/ops/preempt_pack.py``: the same
``PreemptPacked`` fields, and ``preempt_dense`` — the in-queue preempt
pass (reference pkg/scheduler/actions/preempt/preempt.go:45-276) replayed
over the packed arrays — held to the JAX package's ``preempt_dense`` bit
for bit.  It is the ``dense`` executor of the preempt dispatcher and the
specification the CUDA preempt kernel (ops/preempt_kernel.py) is held to.

Facts the dense formulation relies on (see the JAX module's docstring):
evict and pipeline move only future-idle, never ``used``, so node scores
are static for the pass; gang's preemptable is a per-job boolean; the
priority plugin admits strictly-lower job priority; the host's ordered
node trial is a masked argmax with the lowest-index tie-break.

Packing a live session (``pack_preempt_session``) needs the session and
plugin layers and is not part of this package yet; sessions arrive
through ``preempt_packed_from_arrays`` or the synthetic generator.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from volcano_tpu_torch.ops.kernels import (
    as_tensor,
    DEFAULT_WEIGHTS,
    node_scores,
    resolve_device,
    ScoreWeights,
)
from volcano_tpu_torch.ops.packing import PackedSnapshot, snapshot_from_arrays

#: DRF's share tolerance (a copy of volcano_tpu/plugins/drf.py SHARE_DELTA)
SHARE_DELTA = 0.000001


@dataclass
class PreemptPacked:
    """Dense preempt-session state.  ``base`` holds the preemptor tasks
    (as the packed task axis) and all node arrays."""

    base: PackedSnapshot = None

    # future_idle at session open, aligned with base.node_* rows
    node_fi0: np.ndarray = None  # [N_pad, R]

    # victims sorted per node in eviction order
    n_victims: int = 0
    vic_resreq: np.ndarray = None  # [V, R]
    vic_node: np.ndarray = None  # [V] i32
    vic_job: np.ndarray = None  # [V] i32 → job table row
    vic_uids: List[str] = field(default_factory=list)
    vic_names: List[str] = field(default_factory=list)  # "ns/name"

    # job table (all session jobs, row 0..J-1)
    n_jobs: int = 0
    job_prio: np.ndarray = None  # [J] i64
    job_min_avail: np.ndarray = None  # [J] i32
    job_ready0: np.ndarray = None  # [J] i32 — ready_task_num at open
    job_waiting0: np.ndarray = None  # [J] i32 — waiting_task_num at open
    job_queue: np.ndarray = None  # [J] i32 → queue index
    job_uids: List[str] = field(default_factory=list)

    # preemptor grouping: base tasks are job-contiguous in task-order
    job_ptask_start: np.ndarray = None  # [J] i32
    job_ptask_end: np.ndarray = None  # [J] i32

    # processing schedule: rows of (phase, job_row); phase 1 = statement
    # scope with commit/discard, phase 2 = under-request sweep
    schedule: np.ndarray = None  # [S, 2] i32

    ptask_uids: List[str] = field(default_factory=list)
    node_names: List[str] = field(default_factory=list)

    # enabled-preemptable tier flags; the CUDA kernel models the classic
    # {priority, gang, conformance} triple only — drf routes to dense
    use_prio: bool = True
    use_gang: bool = True
    use_conf: bool = True
    use_drf: bool = False

    # DRF-preemptable state (drf.go:120-221, non-namespace policy)
    job_alloc0: np.ndarray = None  # [J, R] f64
    total_res: np.ndarray = None  # [R] f64
    total_lanes: np.ndarray = None  # [R] bool
    vic_uid_pos: np.ndarray = None  # [V] i32
    #: False for conformance-critical victims packed only so DRF's
    #: running subtraction sees them
    vic_evictable: np.ndarray = None  # [V] bool


def preempt_packed_from_arrays(
    base_arrays: Dict[str, np.ndarray], base_meta: dict, **fields_: object
) -> PreemptPacked:
    """A PreemptPacked from plain numpy arrays and lists — a session
    packed elsewhere (the JAX package's packer, a journal).  ``base``
    goes through ``snapshot_from_arrays``; the other keyword arguments
    are PreemptPacked fields.  Raises on an unknown field."""
    known = {f.name for f in fields(PreemptPacked)} - {"base"}
    unknown = set(fields_) - known
    if unknown:
        raise ValueError(f"not PreemptPacked fields: {sorted(unknown)}")
    pk = PreemptPacked(base=snapshot_from_arrays(base_arrays, base_meta))
    for name, value in fields_.items():
        if isinstance(value, np.ndarray):
            value = np.asarray(value)
        elif isinstance(value, list):
            value = list(value)
        setattr(pk, name, value)
    return pk


# ---- dense reference implementation ----


def _fit(resreq: np.ndarray, avail: np.ndarray, tol: np.ndarray) -> bool:
    """Resource.less_equal on packed lanes (scalar lanes skip when the
    request is within tolerance)."""
    ok = resreq < avail + tol
    skip = np.zeros_like(ok)
    skip[2:] = resreq[2:] <= tol[2:]
    return bool(np.all(ok | skip))


def preempt_dense(
    pk: PreemptPacked,
    weights: ScoreWeights = DEFAULT_WEIGHTS,
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Dense replay → (evicted[V] bool, pipelined_node[P] i32, -1 = none).

    Vector state (future_idle, victim alive/evicted, pod counts, DRF job
    allocations) lives on ``device``; the per-job scalars that drive the
    control flow (ready, waiting, cursor) live on the host, with a
    device copy of ``ready`` for the gang filter.  The eviction drain on
    the chosen node runs on the host in f32, victim by victim, as the
    reference does."""
    dev = resolve_device(device)
    base = pk.base
    R = base.task_resreq.shape[1]
    N = base.n_nodes
    V = pk.n_victims
    P = base.n_tasks
    tol = base.tolerance.astype(np.float32)
    tol_t = as_tensor(tol, dev)

    # static per-(preemptor, node) feasibility inputs: labels, taints,
    # readiness (evaluated per preemptor row when it attempts)
    sel_bits = as_tensor(base.task_sel_bits[:P], dev)
    tol_bits = as_tensor(base.task_tol_bits[:P], dev)
    labels = as_tensor(base.node_label_bits[:N], dev)
    taints = as_tensor(base.node_taint_bits[:N], dev)
    node_ok = as_tensor(base.node_ok[:N], dev)

    # static scores at session-open used, on the live [:P, :N] region
    # (the score is elementwise, so padding could not change it)
    scores = node_scores(
        as_tensor(base.task_resreq[:P], dev),
        as_tensor(base.node_used[:N], dev),
        as_tensor(base.node_alloc[:N], dev),
        weights,
    )

    fi = as_tensor(pk.node_fi0[:N].astype(np.float32), dev)
    vic_resreq_np = pk.vic_resreq[:V].astype(np.float32)
    vic_job_np = pk.vic_job[:V].astype(np.int64)
    vic_resreq = as_tensor(vic_resreq_np, dev)
    vic_node = as_tensor(pk.vic_node[:V].astype(np.int64), dev)
    vic_job = as_tensor(vic_job_np, dev)
    vic_queue = as_tensor(pk.job_queue[vic_job_np].astype(np.int64), dev)
    vic_prio = as_tensor(pk.job_prio[vic_job_np].astype(np.int64), dev)
    vic_min = as_tensor(pk.job_min_avail[vic_job_np].astype(np.int64), dev)
    evictable = (
        as_tensor(pk.vic_evictable[:V].astype(bool), dev)
        if pk.vic_evictable is not None else None
    )
    alive = torch.ones(V, dtype=torch.bool, device=dev)
    evicted = torch.zeros(V, dtype=torch.bool, device=dev)

    ready = pk.job_ready0.astype(np.int64).copy()
    waiting = pk.job_waiting0.astype(np.int64).copy()
    cursor = pk.job_ptask_start.astype(np.int64).copy()
    ready_t = torch.from_numpy(ready.copy()).to(dev)

    # DRF-preemptable live state: job allocated lanes move with every
    # evict (on_deallocate) / pipeline (on_allocate), drf.go:255-291
    job_alloc = (
        as_tensor(pk.job_alloc0.astype(np.float64), dev) if pk.use_drf else None
    )
    if pk.use_drf:
        drf_order = torch.from_numpy(
            np.lexsort((pk.vic_uid_pos[:V], pk.vic_job[:V], pk.vic_node[:V]))
        ).to(dev)
        total = as_tensor(pk.total_res.astype(np.float64), dev)
        total_lanes = as_tensor(pk.total_lanes.astype(bool), dev)

    def _share_max(alloc_lanes: torch.Tensor) -> torch.Tensor:
        """share = max over total.resource_names() lanes of alloc/total
        with the reference's zero conventions (drf.go:299-311), clamped
        at zero as the reference's accumulator starts at 0.0."""
        frac = torch.where(
            total > 0,
            alloc_lanes / torch.where(total > 0, total, 1.0),
            torch.where(alloc_lanes > 0, 1.0, 0.0).to(torch.float64),
        )
        frac = torch.where(total_lanes, frac, -torch.inf)
        return torch.clamp_min(frac.max(dim=-1).values, 0.0)

    # pod-count predicate state: pipeline adds the task to the node's
    # task map (count +1); evict only flips status, count unchanged
    ncount = as_tensor(base.node_task_count[:N].astype(np.int64), dev)
    nmax = as_tensor(base.node_max_tasks[:N].astype(np.int64), dev)

    pipelined_node = np.full(P, -1, dtype=np.int32)

    def job_pipelined(j: int) -> bool:
        return waiting[j] + ready[j] >= pk.job_min_avail[j]

    def try_preempt(p: int, pjob: int, same_job: bool) -> bool:
        """_preempt (preempt.go:181-259) for one preemptor task."""
        resreq = base.task_resreq[p].astype(np.float32)
        if same_job:
            cand = alive & (vic_job == pjob)
        else:
            cand = alive & (vic_queue == int(pk.job_queue[pjob])) & (vic_job != pjob)
        elig = cand
        if evictable is not None:
            elig = elig & evictable
        if pk.use_prio:
            elig = elig & (vic_prio < int(pk.job_prio[pjob]))
        if pk.use_gang:
            # gang: the victim's job must stay >= minAvailable
            elig = elig & ((vic_min <= ready_t[vic_job] - 1) | (vic_min == 1))
        if pk.use_drf and bool(cand.any()):
            # drf.go:180-199: per candidate in the per-node uid order,
            # subtract its resreq from a running same-(node, job) clone
            # and admit while ls < rs (or within SHARE_DELTA)
            ls = _share_max(job_alloc[pjob] + as_tensor(resreq, dev).to(torch.float64))
            order = drf_order[cand[drf_order]]
            vals = vic_resreq[order].to(torch.float64)
            cs = torch.cumsum(vals, dim=0)
            vn2, vj2 = vic_node[order], vic_job[order]
            new_grp = torch.cat([
                torch.ones(1, dtype=torch.bool, device=dev),
                (vn2[1:] != vn2[:-1]) | (vj2[1:] != vj2[:-1]),
            ])
            starts = torch.nonzero(new_grp).flatten()
            lengths = torch.diff(
                torch.cat([starts, torch.tensor([order.shape[0]], device=dev)])
            )
            run_start = torch.repeat_interleave(starts, lengths)
            offs = torch.where(
                (run_start > 0)[:, None], cs[torch.clamp_min(run_start - 1, 0)], 0.0
            )
            alloc_at = job_alloc[vj2] - (cs - offs)
            rs = _share_max(alloc_at)
            drf_ok = torch.zeros(V, dtype=torch.bool, device=dev)
            drf_ok[order] = (ls < rs) | (torch.abs(ls - rs) <= SHARE_DELTA)
            elig = elig & drf_ok
        if V == 0 or not bool(elig.any()):
            return False

        # per-node victim sums (float64, then cast) + counts
        vsum = torch.zeros((N, R), dtype=torch.float64, device=dev)
        vsum.index_add_(0, vic_node[elig], vic_resreq[elig].to(torch.float64))
        vcnt = torch.bincount(vic_node[elig], minlength=N)

        # validation per node (victims non-empty + resreq <= fi + victims)
        rr = as_tensor(resreq, dev)
        ok_lane = rr[None, :] < fi + vsum.to(torch.float32) + tol_t[None, :]
        ok_lane[:, 2:] |= (rr[2:] <= tol_t[2:])[None, :]
        static_feas = (
            ((sel_bits[p][None, :] & ~labels) == 0).all(-1)
            & ((taints & ~tol_bits[p][None, :]) == 0).all(-1)
            & node_ok
        )
        valid = static_feas & (ncount < nmax) & (vcnt > 0) & ok_lane.all(-1)
        s = torch.where(valid, scores[p], -torch.inf)
        # best validating node: max score, lowest index tie-break
        n_star = int(torch.argmax(s))
        if not bool(valid[n_star]):
            return False  # no node validates

        # evict in array order (node, prio, uid) until the task fits
        cand_v = torch.nonzero(elig & (vic_node == n_star)).flatten().cpu().numpy()
        fi_row = fi[n_star].cpu().numpy()
        gone = []
        for v in cand_v:
            if _fit(resreq, fi_row, tol):
                break
            gone.append(int(v))
            fi_row = fi_row + vic_resreq_np[v]
            ready[vic_job_np[v]] -= 1
            if job_alloc is not None:  # drf on_deallocate
                job_alloc[int(vic_job_np[v])] -= vic_resreq[v].to(torch.float64)
        if gone:
            idx = torch.tensor(gone, dtype=torch.long, device=dev)
            alive[idx] = False
            evicted[idx] = True
            ready_t.index_add_(
                0, vic_job[idx], torch.full((len(gone),), -1, dtype=torch.int64, device=dev)
            )
        fit = _fit(resreq, fi_row, tol)
        if fit:
            # pipeline
            fi_row = fi_row - resreq
            ncount[n_star] += 1
            waiting[pjob] += 1
            if job_alloc is not None:  # drf on_allocate for the pipelined task
                job_alloc[pjob] += rr.to(torch.float64)
            pipelined_node[p] = n_star
        fi[n_star] = torch.from_numpy(fi_row).to(dev)
        return fit

    ends = pk.job_ptask_end
    for phase, j in pk.schedule.tolist():
        if phase == 1:
            # statement scope: commit iff the job ends pipelined.  Task
            # pops are not part of the statement — the cursor is
            # excluded from the restore.
            saved = (
                fi.clone(), alive.clone(), ready.copy(), waiting.copy(),
                evicted.clone(), pipelined_node.copy(), ncount.clone(),
                job_alloc.clone() if job_alloc is not None else None,
            )
            while cursor[j] < ends[j]:
                if job_pipelined(j):
                    break
                p = int(cursor[j])
                cursor[j] += 1
                try_preempt(p, j, same_job=False)
            if not job_pipelined(j):
                fi, alive, ready, waiting, evicted, pipelined_node, ncount, job_alloc = saved
                ready_t = torch.from_numpy(ready.copy()).to(dev)
        else:
            # under-request sweep: unconditional commit, stop at the first
            # unassigned task (preempt.go:96-112)
            while cursor[j] < ends[j]:
                p = int(cursor[j])
                cursor[j] += 1
                if not try_preempt(p, j, same_job=True):
                    break

    return evicted.cpu().numpy(), pipelined_node
