"""The preempt pass on a GPU: the CUDA preempt kernel, its plain PyTorch
version, and the host packing into the kernel's layout.

The counterpart of ``volcano_tpu/ops/preempt_pallas.py``.  One pass is
one launch of ``csrc/preempt_kernel.cu``: it replays the whole in-queue
preempt pass over the static slot schedule of ``build_schedule_slots``
(slot kinds BEGIN / ATTEMPT / END per starving job, BURN per (queue,
job) for the under-request sweep).  ``run_preempt_cuda`` packs a
``PreemptPacked``, ships its arrays in one transfer, launches once and
fetches ``evicted`` and ``pipelined`` in one transfer.

Array layout (``prepare_preempt_arrays``), nodes flat over
NK = ceil(N/128)*128 columns:
  sched  [S, 4]      i32  kind, job, task (BURN: the job's task end), 0
  ptask  [P, R+2]    f32  request lanes, feasibility class, score class
  screq  [SC, R]     f32  distinct request rows (SC = 0: score inline)
  cf     [C, NK]     u8   class feasibility (labels, taints, node_ok)
  nd     [3R+2, NK]  f32  used | alloc | future idle at open | pods, max pods
  vr     [R*K, NK]   f32  victim requests, row r*K + k for slot k
  vjob   [K, NK]     i32  victim's job row, -1 = empty slot
  jobi   [3, J]      i32  first task (cursor) | queue | priority (clipped)
  jobf   [3, J]      f32  ready | waiting | min_available
  tol    [R]         f32
Slot k of a node holds its k-th victim in eviction order.  The wrapper
derives the queue-compacted slot lists and the job -> position lists from
``vjob`` on the card (``victim_lists``); the kernel builds its per-slot
planes in list order from them at launch, and derives the Pallas kernel's
other victim planes (gang allowance, alive) as it goes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple, Union

import numpy as np
import torch

from volcano_tpu_torch.ops.kernels import (
    _feasibility_classes,
    DEFAULT_WEIGHTS,
    f32_lr_exact,
    MAX_PRIORITY,
    resolve_device,
    ScoreWeights,
)
from volcano_tpu_torch.ops.preempt_pack import _fit, PreemptPacked
from volcano_tpu_torch.ops.session_kernel import (
    load_library,
    MAX_LANES,
    node_width,
    score_planes,
    SMEM_LIMIT,
)

#: beyond this many distinct request rows the kernel scores inline
#: instead of computing one static score plane per row at launch
SCORE_CLASS_CAP = 64

K_BEGIN1, K_ATT1, K_END1, K_BURN2, K_PAD = 0, 1, 2, 5, 9

#: launches of the CUDA kernel by preempt_pass_cuda in this process
LAUNCHES = 0

#: stats the kernel and its plain version count per pass
STATS = ("fired", "picks", "evictions", "rollbacks")
#: the kernel's stats: STATS, then the attempts that reused the plane
KERNEL_STATS = STATS + ("fast",)

#: the kernel's static shared memory: warp argmax slots (value, position),
#: the firing task row, tolerance, the attempt (9 ints), its task and
#: fast flag, the dirty set (2 ints)
_STATIC_SMEM = 32 * 4 * 2 + (MAX_LANES + 2) * 4 + MAX_LANES * 4 + 9 * 4 + 2 * 4 + 2 * 4


def plan_plane(max_len: int) -> int:
    """Plane length of a pass whose longest queue list holds ``max_len``
    positions: ``max_len`` where the plane of masked values fits one
    block's shared memory beside the kernel's static state (the
    repeated-attempt fast path runs), else 0 (every attempt sweeps its
    list)."""
    return max_len if max_len * 4 + _STATIC_SMEM <= SMEM_LIMIT else 0


def preempt_f32_exact(pk: PreemptPacked) -> bool:
    """f32 exactness for the preempt arrays: the base node planes and
    the accumulated future-idle plane — the kernel adds evicted victims'
    requests back, so the worst case per node is fi0 plus the sum of its
    victims' requests.  Inside it every accumulated value is an integer
    below 2^24 / 10, so the kernel's f32 sums in slot order and the
    specification's float64 sums agree."""
    limit = 2**24 / MAX_PRIORITY
    if not f32_lr_exact(pk.base):
        return False
    nv = max(pk.n_victims, 0)
    worst = pk.node_fi0[:, :2].astype(np.float64).copy()
    if nv:
        vic_node = pk.vic_node[:nv]
        np.add.at(worst[:, 0], vic_node, pk.vic_resreq[:nv, 0].astype(np.float64))
        np.add.at(worst[:, 1], vic_node, pk.vic_resreq[:nv, 1].astype(np.float64))
    return float(worst.max(initial=0.0)) < limit


def _score_class_rows(pk: PreemptPacked):
    """(distinct request rows, inverse), memoized on the PreemptPacked."""
    cached = getattr(pk, "_score_class_cache", None)
    if cached is not None:
        return cached
    P = pk.base.n_tasks
    rows, inv = np.unique(pk.base.task_resreq[:P], axis=0, return_inverse=True)
    pk._score_class_cache = (rows, inv.reshape(-1))
    return pk._score_class_cache


def build_schedule_slots(pk: PreemptPacked) -> np.ndarray:
    """Expand pk.schedule (phase, job) rows into kernel slots [S, 4] i32.
    Phase 1: BEGIN1, one ATT1 per job task offset (the cursor guard makes
    consumed offsets no-ops), END1.  Phase 2: a single BURN slot per
    (queue, job) carrying job_ptask_end in col 2 — under the supported
    tier an intra-job attempt never evicts (equal priority), so the
    under-request sweep reduces to consuming one task."""
    if pk.schedule.shape[0] == 0:
        return np.zeros((0, 4), np.int32)
    phases = pk.schedule[:, 0].astype(np.int64)
    jrows = pk.schedule[:, 1].astype(np.int64)
    starts = pk.job_ptask_start[jrows].astype(np.int64)
    ends = pk.job_ptask_end[jrows].astype(np.int64)
    ntasks = np.maximum(ends - starts, 0)
    # slots per schedule row: phase 1 → BEGIN + tasks + END; phase 2 → 1
    row_slots = np.where(phases == 1, ntasks + 2, 1)
    offsets = np.concatenate([[0], np.cumsum(row_slots)])
    S = int(offsets[-1])
    out = np.zeros((S, 4), dtype=np.int32)

    p1 = phases == 1
    out[offsets[:-1][p1], 0] = K_BEGIN1
    out[offsets[:-1][p1], 1] = jrows[p1]
    end_pos = offsets[1:][p1] - 1
    out[end_pos, 0] = K_END1
    out[end_pos, 1] = jrows[p1]
    # ATT1 runs: for each phase-1 row, positions offset+1 .. offset+n
    att_total = int(ntasks[p1].sum())
    if att_total:
        att_rows = np.repeat(np.flatnonzero(p1), ntasks[p1])
        within = np.arange(att_total) - np.repeat(
            np.concatenate([[0], np.cumsum(ntasks[p1])])[:-1], ntasks[p1]
        )
        att_pos = (offsets[:-1][p1].repeat(ntasks[p1]) + 1 + within).astype(np.int64)
        out[att_pos, 0] = K_ATT1
        out[att_pos, 1] = jrows[att_rows]
        out[att_pos, 2] = (starts[att_rows] + within).astype(np.int32)
    p2 = ~p1
    out[offsets[:-1][p2], 0] = K_BURN2
    out[offsets[:-1][p2], 1] = jrows[p2]
    out[offsets[:-1][p2], 2] = ends[p2].astype(np.int32)
    return out


def _node_rows(arr: np.ndarray, NK: int) -> np.ndarray:
    """[N_pad, X] → [X, NK] f32 rows over the first NK nodes."""
    wide = np.zeros((NK, arr.shape[1]), dtype=np.float32)
    n = min(NK, arr.shape[0])
    wide[:n] = arr[:n]
    return np.ascontiguousarray(wide.T)


def victim_lists(vjob: torch.Tensor, job_queue: torch.Tensor) -> dict:
    """The queue-compacted slot lists and the job -> position lists of the
    victim slots ``vjob`` [K, NK] (job row, -1 empty), each job's queue
    being ``job_queue[j]`` (>= 0), on vjob's device (three syncs).

    Queue q's list holds, ascending, the nodes with a victim of q
    (``qnode[qoff[q] : qoff[q+1]]``, Q = the highest victim queue + 1); at
    list position g, ``qslot[:, g]`` holds those victims' slots in slot
    order, -1 past the last (KQ = the most of one queue on one node).
    ``jlist[jlo[j] : jlo[j+1]]`` holds, ascending, the list positions (in
    job j's queue's list) of the nodes that hold a victim of j.  All i32;
    ``longest`` is the longest list."""
    K, NK = vjob.shape
    J = job_queue.shape[0]
    dev = vjob.device

    def i32(x):
        return x.to(torch.int32).contiguous()

    ns, ks = torch.nonzero(vjob.t() >= 0, as_tuple=True)  # by node, then slot
    V = ns.shape[0]
    if V == 0:
        empty = torch.zeros(0, dtype=torch.int32, device=dev)
        return dict(qoff=torch.zeros(1, dtype=torch.int32, device=dev), qnode=empty,
                    qslot=torch.full((1, 0), -1, dtype=torch.int32, device=dev),
                    jlo=torch.zeros(J + 1, dtype=torch.int32, device=dev), jlist=empty,
                    longest=0)
    vj = vjob[ks, ns].long()
    q = job_queue[vj].long()
    order = torch.sort(q, stable=True).indices  # by queue, node, slot
    ks, ns, vj, q = ks[order], ns[order], vj[order], q[order]
    new = torch.ones(V, dtype=torch.bool, device=dev)
    new[1:] = (ns[1:] != ns[:-1]) | (q[1:] != q[:-1])
    pos = torch.cumsum(new, 0) - 1  # each slot's list position
    idx = torch.arange(V, device=dev)
    kk = idx - torch.cummax(torch.where(new, idx, 0), 0).values  # rank at its position
    jorder = torch.sort(vj, stable=True).indices  # by job, then position
    jv, jpos = vj[jorder], pos[jorder]
    keep = torch.ones(V, dtype=torch.bool, device=dev)
    keep[1:] = (jv[1:] != jv[:-1]) | (jpos[1:] != jpos[:-1])  # one entry per node
    sizes = torch.stack([pos[-1] + 1, q[-1] + 1, kk.max() + 1, keep.sum(), q[0]]).tolist()
    LQ, Q, KQ, JL, lowest = sizes
    if lowest < 0:
        raise ValueError("a victim's job has a negative queue row")
    counts = torch.zeros(Q, dtype=torch.long, device=dev).index_add_(0, q, new.long())
    qoff = torch.zeros(Q + 1, dtype=torch.long, device=dev)
    qoff[1:] = torch.cumsum(counts, 0)
    qnode = torch.empty(LQ, dtype=torch.long, device=dev)
    qnode[pos] = ns  # every slot of a position writes its node
    qslot = torch.full((KQ, LQ), -1, dtype=torch.int32, device=dev)
    qslot[kk, pos] = i32(ks)
    jcounts = torch.zeros(J, dtype=torch.long, device=dev).index_add_(0, jv, keep.long())
    jlo = torch.zeros(J + 1, dtype=torch.long, device=dev)
    jlo[1:] = torch.cumsum(jcounts, 0)
    jlist = torch.empty(JL, dtype=torch.long, device=dev)
    jlist[torch.cumsum(keep, 0) - 1] = jpos  # a repeat writes its entry's value again
    return dict(qoff=i32(qoff), qnode=i32(qnode), qslot=qslot, jlo=i32(jlo), jlist=i32(jlist),
                longest=int(counts.max()))


def prepare_preempt_arrays(pk: PreemptPacked) -> Tuple[dict, dict, np.ndarray]:
    """Host packing of a PreemptPacked into the kernel's layout →
    (arrays, dims, vic_slot), where vic_slot[i] is victim i's slot on its
    node (to unpack ``evicted``)."""
    base = pk.base
    R = base.task_resreq.shape[1]
    P = base.n_tasks
    NK = node_width(base.n_nodes)
    NV = min(NK, base.node_idle.shape[0])

    # victim slots: the k-th victim of each node in eviction order (stable
    # rank within the node's group, preserving the packed order)
    V = pk.n_victims
    vnode = pk.vic_node[:V].astype(np.int64)
    order = np.argsort(vnode, kind="stable")
    sorted_nodes = vnode[order]
    vic_slot = np.zeros(max(V, 1), dtype=np.int64)
    if V:
        new_grp = np.concatenate([[True], sorted_nodes[1:] != sorted_nodes[:-1]])
        starts = np.flatnonzero(new_grp)
        group_start = np.repeat(starts, np.diff(np.append(starts, V)))
        vic_slot[order] = np.arange(V) - group_start
    K = int(np.bincount(vnode).max()) if V else 1

    vr = np.zeros((R * K, NK), dtype=np.float32)
    vjob = np.full((K, NK), -1, dtype=np.int32)
    if V:
        ks = vic_slot[:V]
        for r in range(R):
            vr[r * K + ks, vnode] = pk.vic_resreq[:V, r]
        vjob[ks, vnode] = pk.vic_job[:V]

    # class feasibility (the allocate kernel's construction)
    task_cls, class_sel, class_tol = _feasibility_classes(base)
    node_labels = base.node_label_bits[:NV]
    node_taints = base.node_taint_bits[:NV]
    sel_ok = ((class_sel[:, None, :] & ~node_labels[None, :, :]) == 0).all(-1)
    tol_ok = ((node_taints[None, :, :] & ~class_tol[:, None, :]) == 0).all(-1)
    cf = np.zeros((class_sel.shape[0], NK), dtype=np.uint8)
    cf[:, :NV] = sel_ok & tol_ok & base.node_ok[None, :NV]

    ptask = np.zeros((P, R + 2), dtype=np.float32)
    ptask[:, :R] = base.task_resreq[:P]
    ptask[:, R] = task_cls[:P].astype(np.float32)
    # score classes: one static plane per distinct request row, unless
    # there are more rows than the cap (then the kernel scores inline)
    screq_rows, sc_inv = _score_class_rows(pk)
    if screq_rows.shape[0] <= SCORE_CLASS_CAP:
        screq = np.ascontiguousarray(screq_rows, dtype=np.float32)
        ptask[:, R + 1] = sc_inv.astype(np.float32)
    else:
        screq = np.zeros((0, R), dtype=np.float32)

    nd = np.concatenate([
        _node_rows(base.node_used, NK),
        _node_rows(base.node_alloc, NK),
        _node_rows(pk.node_fi0, NK),
        _node_rows(
            np.stack([base.node_task_count.astype(np.float32),
                      base.node_max_tasks.astype(np.float32)], axis=1),
            NK,
        ),
    ])

    J = max(pk.n_jobs, 1)

    def jrow(vals, dtype):
        out = np.zeros(J, dtype=dtype)
        out[: vals.shape[0]] = vals
        return out

    jobi = np.stack([
        jrow(pk.job_ptask_start.astype(np.int32), np.int32),
        jrow(pk.job_queue.astype(np.int32), np.int32),
        jrow(np.clip(pk.job_prio, -(2**31), 2**31 - 1).astype(np.int32), np.int32),
    ])
    jobf = np.stack([
        jrow(pk.job_ready0.astype(np.float32), np.float32),
        jrow(pk.job_waiting0.astype(np.float32), np.float32),
        jrow(pk.job_min_avail.astype(np.float32), np.float32),
    ])
    arrays = dict(
        sched=np.ascontiguousarray(build_schedule_slots(pk)),
        ptask=ptask, screq=screq, cf=cf, nd=nd, vr=vr, vjob=vjob,
        jobi=jobi, jobf=jobf, tol=base.tolerance.astype(np.float32).reshape(R),
    )
    dims = dict(R=R, K=K, NK=NK, J=J, P=P, C=cf.shape[0], SC=screq.shape[0])
    return arrays, dims, vic_slot


#: operand order of preempt_pass_cuda / preempt_pass_reference
OPERANDS = ("sched", "ptask", "screq", "cf", "nd", "vr", "vjob", "jobi", "jobf", "tol")


# ---- the plain version ----

def eligible_slots(
    vjob: torch.Tensor,  # [..] i32, -1 = empty slot
    evicted: torch.Tensor,  # [..] i32
    vprio: torch.Tensor,  # [..] i32 — the victim's job priority
    vqueue: torch.Tensor,  # [..] i32 — the victim's job queue
    vmin: torch.Tensor,  # [..] f32 — the victim's job min_available
    vready: torch.Tensor,  # [..] f32 — the victim's job ready count
    pjob: int, pprio: int, pqueue: int,
) -> torch.Tensor:
    """Victim eligibility per slot for a cross-job attempt — the plain
    version of vt::victim_eligible."""
    gang_ok = (vmin == 1.0) | (vmin <= vready - 1.0)
    return ((vjob >= 0) & (evicted == 0) & gang_ok & (vprio < pprio) & (vqueue == pqueue)
            & (vjob != pjob))


def validation_plane(
    rr: list, tol: list,
    fi: torch.Tensor,  # [R, NK]
    vsum: list,  # R planes [NK]: eligible victims' requests, summed in slot order
    vcnt: torch.Tensor, ncnt: torch.Tensor, nmax: torch.Tensor,
    cls_ok: torch.Tensor,  # [NK] bool
) -> torch.Tensor:
    """[NK] nodes that validate an attempt — the plain version of
    vt::node_validates."""
    ok = None
    for r in range(len(rr)):
        lane = rr[r] < (fi[r] + vsum[r]) + tol[r]
        if r >= 2:
            lane = lane | bool(rr[r] <= tol[r])
        ok = lane if ok is None else ok & lane
    return cls_ok & (ncnt < nmax) & (vcnt > 0) & ok


def preempt_pass_reference(
    sched: torch.Tensor, ptask: torch.Tensor, screq: torch.Tensor, cf: torch.Tensor,
    nd: torch.Tensor, vr: torch.Tensor, vjob: torch.Tensor, jobi: torch.Tensor,
    jobf: torch.Tensor, tol: torch.Tensor,
    weights: ScoreWeights = DEFAULT_WEIGHTS,
    stats: Optional[torch.Tensor] = None,
    events: Optional[list] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One preempt pass → (evicted[K, NK] i32, pipelined[P] i32): a
    Python loop over the slots on [·, NK] tensors, every node validated
    at every attempt, with a full shadow copy of the state at every BEGIN.
    The plain version of the CUDA kernel, with the wrapper's operands;
    ``stats`` (i32 [4]) receives the counts named by STATS, and
    ``events`` gets, in order, ("fire", task, job) for each attempt that
    fires, ("pick", node, evicted victims' jobs) for each that picks a
    node, and ("rollback", job) for each rollback."""
    _check_pass_args(sched, ptask, screq, cf, nd, vr, vjob, jobi, jobf, tol, weights, stats,
                     len(STATS))
    dev = ptask.device
    P, RC = ptask.shape
    R = RC - 2
    K, NK = vjob.shape
    SC = screq.shape[0]
    used, alloc = nd[:R], nd[R : 2 * R]
    nmax = nd[3 * R + 1]
    fi = nd[2 * R : 3 * R].clone()
    ncnt = nd[3 * R].clone()
    evicted = torch.zeros((K, NK), dtype=torch.int32, device=dev)
    pipelined = torch.full((P,), -1, dtype=torch.int32, device=dev)
    counts = [0, 0, 0, 0]

    rows = ptask.cpu().numpy()
    tol_np = tol.cpu().numpy()
    tolf = tol_np.tolist()
    cursor = jobi[0].tolist()
    jqueue, jprio = jobi[1].tolist(), jobi[2].tolist()
    jobf_np = jobf.cpu().numpy()
    ready = jobf_np[0].copy()  # f32, host copy of the device ready counts
    wait = jobf_np[1].copy()
    minav = jobf_np[2]
    ready_t = jobf[0].clone()

    safe = torch.clamp_min(vjob, 0).long()
    vq = jobi[1][safe]
    vjp = jobi[2][safe]
    vmin = jobf[2][safe]
    vr_k = vr.view(R, K, NK)
    vjob_np = vjob.cpu().numpy()
    spre = [
        score_planes(screq[c].tolist(), [screq[c, r] + used[r] for r in range(R)], alloc, weights)
        for c in range(SC)
    ]

    def pipelined_job(j: int) -> bool:
        return bool(wait[j] + ready[j] >= minav[j])

    def attempt(p: int, j: int) -> None:
        nonlocal ready_t
        row = rows[p]
        rr = row[:R]
        rrf = [float(x) for x in rr]
        cls, scl = int(row[R]), int(row[R + 1])
        elig = eligible_slots(vjob, evicted, vjp, vq, vmin, ready_t[safe], j, jprio[j],
                              jqueue[j])
        vsum = []
        for r in range(R):
            acc = torch.where(elig[0], vr_k[r, 0], 0.0)
            for k in range(1, K):
                acc = acc + torch.where(elig[k], vr_k[r, k], 0.0)
            vsum.append(acc)
        if not 0 <= cls < cf.shape[0]:
            return
        valid = validation_plane(rrf, tolf, fi, vsum, elig.sum(0), ncnt, nmax, cf[cls] != 0)
        if SC:
            total = spre[scl]
        else:
            total = score_planes(rrf, [rrf[r] + used[r] for r in range(R)], alloc, weights)
        masked = torch.where(valid, total, -torch.inf)
        n = int(torch.argmax(masked))  # first max: lowest-index tie-break
        if not bool(torch.isfinite(masked[n])):
            return
        counts[1] += 1
        # the drain on node n, in slot order, with the attempt's eligibility
        elig_col = elig[:, n].cpu().numpy()
        vr_col = vr_k[:, :, n].cpu().numpy()
        fi_col = fi[:, n].cpu().numpy()
        cum = np.zeros(R, dtype=np.float32)
        gone = []
        for k in range(K):
            if elig_col[k] and not _fit(rr, fi_col + cum, tol_np):
                cum = cum + vr_col[:, k]
                gone.append(k)
        if events is not None:
            events.append(("pick", n, tuple(int(vjob_np[k, n]) for k in gone)))
        for k in gone:
            evicted[k, n] = 1
            ready[vjob_np[k, n]] -= np.float32(1.0)
        if gone:
            ready_t = torch.from_numpy(ready.copy()).to(dev)
        counts[2] += len(gone)
        fi_col = fi_col + cum
        if _fit(rr, fi_col, tol_np):
            fi_col = fi_col - rr
            ncnt[n] += 1.0
            wait[j] += np.float32(1.0)
            pipelined[p] = n
        fi[:, n] = torch.from_numpy(fi_col).to(dev)

    shadow = None
    for kind, j, p, _ in sched.cpu().tolist():
        if not 0 <= j < len(cursor):
            continue
        if kind == K_BEGIN1:
            shadow = (fi.clone(), ncnt.clone(), evicted.clone(), ready.copy(), wait.copy(),
                      pipelined.clone())
        elif kind == K_ATT1:
            if cursor[j] == p and 0 <= p < P and not pipelined_job(j):
                cursor[j] += 1
                counts[0] += 1
                if events is not None:
                    events.append(("fire", p, j))
                attempt(p, j)
        elif kind == K_END1:
            if not pipelined_job(j) and shadow is not None:
                fi, ncnt, evicted, ready, wait, pipelined = shadow
                shadow = None
                ready_t = torch.from_numpy(ready.copy()).to(dev)
                counts[3] += 1
                if events is not None:
                    events.append(("rollback", j))
        elif kind == K_BURN2:
            if cursor[j] < p:
                cursor[j] += 1
    if stats is not None:
        stats.copy_(torch.tensor(counts, dtype=torch.int32))
    return evicted, pipelined


def fast_attempts(events: list, ptask: torch.Tensor, jobi: torch.Tensor, vjob: torch.Tensor,
                  SC: int) -> list:
    """For each fired attempt of the plain pass's ``events``, in order,
    whether a pass with the plane takes it on the fast path: its key
    (class, score class, priority, queue) equals the last fired attempt's,
    from the same job or with neither job owning a victim slot, with no
    rollback between them, and there are score planes (SC > 0)."""
    R = ptask.shape[1] - 2
    rows = ptask.cpu().numpy()
    queue, prio = jobi[1].tolist(), jobi[2].tolist()
    owns = [False] * jobi.shape[1]
    for j in torch.unique(vjob[vjob >= 0]).tolist():
        owns[j] = True
    last, out = None, []
    for event in events:
        if event[0] == "rollback":
            last = None
        if event[0] != "fire":
            continue
        _, p, j = event
        key = (int(rows[p, R]), int(rows[p, R + 1]), prio[j], queue[j])
        out.append(SC > 0 and last is not None and key == last[0]
                   and (j == last[1] or not (owns[j] or owns[last[1]])))
        last = (key, j)
    return out


# ---- the kernel wrapper ----

def _check_pass_args(sched, ptask, screq, cf, nd, vr, vjob, jobi, jobf, tol, weights, stats,
                     n_stats: int) -> None:
    """Validate one pass's operands; raise before anything launches."""
    if ptask.device.type not in ("cpu", "cuda"):
        raise ValueError(f"a preempt pass takes cuda or cpu tensors, not {ptask.device}")
    if weights.lr_int_exact:
        raise ValueError("the preempt kernel runs the f32 least-requested path only")
    if ptask.dim() != 2 or not 2 <= ptask.shape[1] - 2 <= MAX_LANES:
        raise ValueError(f"ptask must be [P, R+2] with 2 <= R <= {MAX_LANES}")
    R = ptask.shape[1] - 2
    if cf.dim() != 2 or vjob.dim() != 2 or jobi.dim() != 2 or sched.dim() != 2:
        raise ValueError("cf, vjob, jobi and sched must be 2-d")
    K, NK = vjob.shape
    J = jobi.shape[1]
    if K < 1 or J < 1:
        raise ValueError("a pass needs at least one victim slot and one job row")
    expect = {
        "sched": (sched, torch.int32, (sched.shape[0], 4)),
        "ptask": (ptask, torch.float32, tuple(ptask.shape)),
        "screq": (screq, torch.float32, (screq.shape[0], R)),
        "cf": (cf, torch.uint8, (cf.shape[0], NK)),
        "nd": (nd, torch.float32, (3 * R + 2, NK)),
        "vr": (vr, torch.float32, (R * K, NK)),
        "vjob": (vjob, torch.int32, (K, NK)),
        "jobi": (jobi, torch.int32, (3, J)),
        "jobf": (jobf, torch.float32, (3, J)),
        "tol": (tol, torch.float32, (R,)),
    }
    if stats is not None:
        expect["stats"] = (stats, torch.int32, (n_stats,))
    for name, (x, dtype, shape) in expect.items():
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(
                f"{name}: expected {dtype} {shape}, got {x.dtype} {tuple(x.shape)}"
            )
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != ptask.device:
            raise ValueError(f"{name} is on {x.device}, ptask on {ptask.device}")
    P = ptask.shape[0]
    SC = screq.shape[0]
    if max(R * K * NK, SC * NK, P * K, P * (R + 2)) >= 2**31:
        raise ValueError("the pass's planes exceed the kernel's 32-bit indexing")
    # the kernel indexes the job tables through vjob and the score planes
    # through the task rows' score class without bounds checks
    bad = ((vjob < -1) | (vjob >= J)).any()
    if SC > 0 and P > 0:
        scl = ptask[:, R + 1]
        bad = bad | ((scl < 0) | (scl >= SC) | (scl != scl.floor())).any()
    if bool(bad):
        raise ValueError("vjob outside [-1, J) or a score class outside [0, SC)")


def preempt_pass_cuda(
    sched: torch.Tensor, ptask: torch.Tensor, screq: torch.Tensor, cf: torch.Tensor,
    nd: torch.Tensor, vr: torch.Tensor, vjob: torch.Tensor, jobi: torch.Tensor,
    jobf: torch.Tensor, tol: torch.Tensor,
    weights: ScoreWeights = DEFAULT_WEIGHTS,
    stats: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One preempt pass → (evicted[K, NK] i32, pipelined[P] i32).  On
    CUDA tensors it derives the victim lists on the card and launches the
    kernel (or raises), with the plane where ``plan_plane`` fits it, and
    ``stats`` (i32 [5]) receives the counts named by KERNEL_STATS; on CPU
    tensors it runs the plain version, which takes no fast path, and
    refuses ``stats``.  ``sched`` is build_schedule_slots' output: a
    statement's slots are not interleaved with another's, which bounds the
    kernel's undo journal by P attempts."""
    args = (sched, ptask, screq, cf, nd, vr, vjob, jobi, jobf, tol)
    if ptask.device.type == "cpu":
        if stats is not None:
            raise ValueError("stats counts the kernel's attempts; a CPU pass runs the plain "
                             "version (preempt_pass_reference takes STATS)")
        return preempt_pass_reference(*args, weights)
    _check_pass_args(*args, weights, stats, len(KERNEL_STATS))
    lists = victim_lists(vjob, jobi[1])
    if (ptask.shape[1] - 2) * lists["qslot"].numel() >= 2**31:
        raise ValueError("the pass's per-slot planes exceed the kernel's 32-bit indexing")
    return _launch(args, lists, weights, stats, plan_plane(lists["longest"]))


def _launch(args, lists: dict, weights: ScoreWeights, stats: Optional[torch.Tensor],
            plane_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch one pass on checked CUDA operands ``args`` (OPERANDS order)
    and their ``victim_lists``, with a plane of ``plane_len`` values (0:
    off)."""
    global LAUNCHES
    sched, ptask, screq, cf, nd, vr, vjob, jobi, jobf, tol = args
    qoff, qnode, qslot, jlo, jlist = (lists[k] for k in ("qoff", "qnode", "qslot", "jlo", "jlist"))
    dev = ptask.device
    P, RC = ptask.shape
    R = RC - 2
    K, NK = vjob.shape
    J = jobi.shape[1]
    SC = screq.shape[0]
    KQ, LQ = qslot.shape
    KL = max(KQ * LQ, 1)

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    def i32(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    scratch = dict(
        fi=f32(R, NK), ncnt=f32(NK), ready=f32(J), wait=f32(J), cursor=i32(J),
        spre=f32(max(SC, 1), NK), lvj=i32(KL), lprio=i32(KL), lqueue=i32(KL), lmin=f32(KL),
        lvr=f32(R, KL), jnode=i32(max(P, 1)), jvals=f32(max(P, 1), R + 1),
        jevict=i32(max(P * K, 1)), jpipe=i32(max(P, 1)), dirty=i32(2 * KQ),
    )
    evicted = i32(K, NK)
    pipelined = i32(P)
    if stats is None:
        stats = i32(len(KERNEL_STATS))
    lib = _preempt_library()
    err = lib.vt_preempt_pass(
        sched.data_ptr(), sched.shape[0], ptask.data_ptr(), P, R, screq.data_ptr(), SC,
        cf.data_ptr(), cf.shape[0], nd.data_ptr(), vr.data_ptr(), vjob.data_ptr(), K,
        jobi.data_ptr(), jobf.data_ptr(), J, tol.data_ptr(), NK,
        qoff.data_ptr(), qoff.numel() - 1, qnode.data_ptr(), LQ, qslot.data_ptr(), KQ,
        jlo.data_ptr(), jlist.data_ptr(),
        weights.binpack_weight, weights.binpack_cpu, weights.binpack_memory,
        weights.binpack_scalar, weights.least_requested_weight,
        weights.balanced_resource_weight, plane_len,
        *(scratch[k].data_ptr() for k in ("fi", "ncnt", "ready", "wait", "cursor", "spre",
                                           "lvj", "lprio", "lqueue", "lmin", "lvr", "jnode",
                                           "jvals", "jevict", "jpipe", "dirty")),
        evicted.data_ptr(), pipelined.data_ptr(), stats.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
        dev.index if dev.index is not None else torch.cuda.current_device(),
    )
    if err != 0:
        raise RuntimeError(f"preempt kernel launch failed: {lib.vt_error_string(err).decode()}")
    LAUNCHES += 1
    return evicted, pipelined


@functools.lru_cache(maxsize=None)
def _preempt_library() -> ctypes.CDLL:
    """The kernel library with vt_preempt_pass's signature declared."""
    lib = load_library()
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.vt_preempt_pass.argtypes = [
        p, i, p, i, i,  # sched, S, ptask, P, R
        p, i, p, i,  # screq, SC, cf, C
        p, p, p, i,  # nd, vr, vjob, K
        p, p, i, p, i,  # jobi, jobf, J, tol, NK
        p, i, p, i, p, i, p, p,  # qoff, Q, qnode, LQ, qslot, KQ, jlo, jlist
        f, f, f, f, f, f, i,  # weights, plane_len
        p, p, p, p, p, p,  # fi, ncnt, ready, wait, cursor, spre
        p, p, p, p, p,  # lvj, lprio, lqueue, lmin, lvr
        p, p, p, p, p,  # jnode, jvals, jevict, jpipe, dirty
        p, p, p,  # evicted, pipelined, stats
        p, i,  # stream, device
    ]
    lib.vt_preempt_pass.restype = ctypes.c_int
    return lib


# ---- the session ----

def ship_arrays(arrays: dict, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """The operands on ``device`` in OPERANDS order, from one transfer:
    every array's bytes go into one buffer (16-byte aligned chunks),
    copied once and viewed back as typed tensors."""
    parts, spans, off = [], [], 0
    for name in OPERANDS:
        a = np.ascontiguousarray(arrays[name])
        nbytes = a.nbytes
        pad = -nbytes % 16
        parts.append(a.reshape(-1).view(np.uint8))
        if pad:
            parts.append(np.zeros(pad, dtype=np.uint8))
        spans.append((off, a.dtype, a.shape))
        off += nbytes + pad
    buf = torch.from_numpy(np.concatenate(parts) if parts else np.zeros(0, np.uint8)).to(device)
    out = []
    for off, dtype, shape in spans:
        n = int(np.prod(shape)) * np.dtype(dtype).itemsize
        t = buf[off : off + n].view(getattr(torch, np.dtype(dtype).name))
        out.append(t.reshape(shape))
    return tuple(out)


def run_preempt_cuda(
    pk: PreemptPacked,
    weights: ScoreWeights = DEFAULT_WEIGHTS,
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """PreemptPacked → (evicted[V] bool, pipelined_node[P] i32, -1 = none):
    pack, ship once, launch once, fetch once, unpack ``evicted`` through
    each victim's slot."""
    if not preempt_f32_exact(pk):
        raise ValueError("preempt session outside the f32-exact envelope")
    dev = resolve_device(device)
    P = pk.base.n_tasks
    V = pk.n_victims
    evicted = np.zeros(V, dtype=bool)
    pipelined = np.full(P, -1, dtype=np.int32)
    if P == 0 or pk.schedule.shape[0] == 0:
        return evicted, pipelined
    arrays, dims, vic_slot = prepare_preempt_arrays(pk)
    if arrays["sched"].shape[0] == 0:
        return evicted, pipelined
    ev_planes, pipe = preempt_pass_cuda(*ship_arrays(arrays, dev), weights=weights)
    K, NK = dims["K"], dims["NK"]
    out = torch.cat([ev_planes.reshape(-1), pipe]).cpu().numpy()
    ev = out[: K * NK].reshape(K, NK)
    if V:
        evicted = ev[vic_slot[:V], pk.vic_node[:V]] > 0
    return evicted, out[K * NK :].astype(np.int32)
