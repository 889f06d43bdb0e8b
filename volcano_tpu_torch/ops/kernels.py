"""PyTorch specification of the allocate session kernels.

The counterpart of ``volcano_tpu/ops/kernels.py``, held to it bit for
bit: fused predicate mask, closed-form plugin scores (binpack +
least-requested + balanced), a greedy scan over tasks in priority order
with node state carried, lowest-index tie-break, and the host-driven
gang commit/discard loop.

Rules that keep it bit-identical to the reference:
  * every f32 expression is written as separate ops in the reference's
    order — no fused multiply-add, no folded constants;
  * sums over resource lanes run lane by lane, in lane order;
  * ``torch.argmax`` returns the first maximal index, the reference's
    deterministic tie-break;
  * uint32 bit planes travel as int32 views of the same bits.

This module is the ``device="cpu"`` executor (``torch-scan``) of the
dispatcher; on a GPU the session runs through the CUDA kernel in
``ops/session_kernel.py``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from volcano_tpu_torch.ops.packing import PackedSnapshot

MAX_PRIORITY = 10.0


class ScoreWeights(NamedTuple):
    """Plugin weights, matching binpack.go:94-151 + nodeorder.go:68-112.

    ``binpack_scalar`` defaults to 0 because the host plugin skips scalar
    resources absent from its ``binpack.resources`` weight map.

    ``lr_int_exact`` switches least-requested to exact int32 division for
    sessions with nodes beyond the f32 floor-division exactness envelope;
    run_packed sets it from the packed data.
    """

    binpack_weight: float = 1.0
    binpack_cpu: float = 1.0
    binpack_memory: float = 1.0
    binpack_scalar: float = 0.0
    least_requested_weight: float = 1.0
    balanced_resource_weight: float = 1.0
    lr_int_exact: bool = False


DEFAULT_WEIGHTS = ScoreWeights()


def f32_lr_exact(snap: PackedSnapshot) -> bool:
    """True when every node's cpu/memory capacity keeps the f32
    floor-division least-requested path exact (products stay below
    2^24 — see least_requested_score)."""
    return float(snap.node_alloc[:, :2].max(initial=0.0)) * MAX_PRIORITY < 2**24


def f32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """f32 → int32 as XLA converts (the JAX package's ``astype(int32)``):
    toward zero, saturating at the int32 range, NaN → 0.  ``.to(int32)``
    gives INT_MIN for every value out of range on the CPU."""
    y = torch.nan_to_num(x, nan=0.0).clamp(-(2.0**31), 2147483520.0).to(torch.int32)
    return torch.where(x >= 2.0**31, torch.iinfo(torch.int32).max, y)


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another.  With no GPU and no explicit device this raises
    rather than quietly running on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain torch version"
            )
        return torch.device("cuda")
    return torch.device(device)


def as_tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A packed plane on ``device``; a uint32 bit plane becomes an int32
    tensor holding the same bits."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(arr).to(device)


def _lane_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last (resource) axis, lane by lane in lane order."""
    total = x[..., 0]
    for r in range(1, x.shape[-1]):
        total = total + x[..., r]
    return total


# ---- predicate mask (vectorized over all T×N pairs) ----

def _component_planes(
    task_resreq: torch.Tensor,  # [T, R]
    task_sel_bits: torch.Tensor,  # [T, W] int32 bits
    task_tol_bits: torch.Tensor,  # [T, W]
    node_future_idle: torch.Tensor,  # [N, R]
    node_label_bits: torch.Tensor,  # [N, W]
    node_taint_bits: torch.Tensor,  # [N, W]
    node_task_count: torch.Tensor,  # [N] i32
    node_max_tasks: torch.Tensor,  # [N] i32
    tolerance: torch.Tensor,  # [R]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The four task-dependent predicate planes (fit, sel_ok, tol_ok,
    room), each [T, N] bool (room [1, N])."""
    # The sub-tolerance skip applies to scalar lanes only (host LessEqual,
    # resource_info.go:292-326, still compares cpu/memory).
    scalar_lane = torch.arange(task_resreq.shape[-1], device=task_resreq.device) >= 2
    req = task_resreq[:, None, :]
    tol = tolerance[None, None, :]
    fit = ((req < node_future_idle[None, :, :] + tol) | (scalar_lane & (req <= tol))).all(-1)
    sel_ok = ((task_sel_bits[:, None, :] & ~node_label_bits[None, :, :]) == 0).all(-1)
    tol_ok = ((node_taint_bits[None, :, :] & ~task_tol_bits[:, None, :]) == 0).all(-1)
    room = (node_task_count < node_max_tasks)[None, :]
    return fit, sel_ok, tol_ok, room


def predicate_mask(
    task_resreq: torch.Tensor,
    task_sel_bits: torch.Tensor,
    task_tol_bits: torch.Tensor,
    node_future_idle: torch.Tensor,
    node_label_bits: torch.Tensor,
    node_taint_bits: torch.Tensor,
    node_ok: torch.Tensor,  # [N] bool
    node_task_count: torch.Tensor,
    node_max_tasks: torch.Tensor,
    tolerance: torch.Tensor,
) -> torch.Tensor:
    """[T, N] feasibility — resource fit with tolerance, selector bits,
    taint bits, pod count, node readiness."""
    fit, sel_ok, tol_ok, room = _component_planes(
        task_resreq, task_sel_bits, task_tol_bits, node_future_idle,
        node_label_bits, node_taint_bits, node_task_count, node_max_tasks,
        tolerance,
    )
    return fit & sel_ok & tol_ok & room & node_ok[None, :]


# ---- scores (closed-form plugin math) ----

def binpack_score(
    task_resreq: torch.Tensor,  # [T, R]
    node_used: torch.Tensor,  # [N, R]
    node_alloc: torch.Tensor,  # [N, R]
    weights: ScoreWeights,
) -> torch.Tensor:
    """[T, N] — binpack.go:200-259: per-resource (used+req)*w/alloc summed
    over requested resources, normalized by summed weights, ×10×weight."""
    R = task_resreq.shape[-1]
    # filled on the device, with no host copy, so a CUDA graph can capture it
    lane_w = torch.full((R,), weights.binpack_scalar, dtype=torch.float32,
                        device=task_resreq.device)
    lane_w[0].fill_(weights.binpack_cpu)
    lane_w[1].fill_(weights.binpack_memory)
    req = task_resreq[:, None, :]
    used_finally = req + node_used[None, :, :]
    alloc = node_alloc[None, :, :]
    requested_mask = req > 0
    valid = requested_mask & (alloc > 0) & (used_finally <= alloc)
    lane_score = torch.where(valid, used_finally * lane_w / torch.clamp_min(alloc, 1.0), 0.0)
    score = _lane_sum(lane_score)
    weight_sum = _lane_sum(torch.where(requested_mask, lane_w, 0.0))
    score = torch.where(weight_sum > 0, score / weight_sum, 0.0)
    return score * MAX_PRIORITY * weights.binpack_weight


def least_requested_score(
    task_resreq: torch.Tensor,
    node_used: torch.Tensor,
    node_alloc: torch.Tensor,
    int_exact: bool = False,
) -> torch.Tensor:
    """[T, N] — least_requested.go:36-53 with the reference's integer
    floors: ((cap-req)*10)//cap averaged over cpu+memory.

    Default path: f32 floor division with a multiply-back correction
    (q is nudged so that q*c <= p < (q+1)*c holds), exact while the
    products stay below 2^24; ``int_exact`` selects int32 division."""
    req = task_resreq[:, None, :2] + node_used[None, :, :2]
    cap = node_alloc[None, :, :2]
    if int_exact:
        reqi = f32_to_i32(req)
        capi = f32_to_i32(cap)
        lane = torch.where(
            (capi > 0) & (reqi <= capi),
            torch.div((capi - reqi) * int(MAX_PRIORITY), torch.clamp_min(capi, 1),
                      rounding_mode="floor"),
            0,
        )
        return torch.div(lane.sum(-1), 2, rounding_mode="floor").to(torch.float32)
    c = torch.clamp_min(cap, 1.0)
    p = (cap - req) * MAX_PRIORITY
    q = torch.floor(p / c)
    # Correction for up-to-1-ulp divide error in either direction.
    q = q + ((q + 1.0) * c <= p).to(torch.float32) - (q * c > p).to(torch.float32)
    lane = torch.where((cap > 0) & (req <= cap), q, 0.0)
    return torch.floor(_lane_sum(lane) * 0.5)


def balanced_resource_score(
    task_resreq: torch.Tensor, node_used: torch.Tensor, node_alloc: torch.Tensor
) -> torch.Tensor:
    """[T, N] — balanced_resource_allocation.go:41-70, fractions in f32."""
    req = task_resreq[:, None, :2] + node_used[None, :, :2]
    cap = node_alloc[None, :, :2]
    frac = torch.where(cap > 0, req / torch.clamp_min(cap, 1.0), 1.0)
    cpu_f, mem_f = frac[..., 0], frac[..., 1]
    diff = torch.abs(cpu_f - mem_f)
    score = torch.floor((1.0 - diff) * MAX_PRIORITY)
    return torch.where((cpu_f >= 1.0) | (mem_f >= 1.0), 0.0, score)


def node_scores(
    task_resreq: torch.Tensor,
    node_used: torch.Tensor,
    node_alloc: torch.Tensor,
    weights: ScoreWeights,
) -> torch.Tensor:
    """[T, N] total score — the additive NodeOrderFn dispatch
    (session_plugins.go:423-441)."""
    s = binpack_score(task_resreq, node_used, node_alloc, weights)
    s = s + weights.least_requested_weight * least_requested_score(
        task_resreq, node_used, node_alloc, int_exact=weights.lr_int_exact
    )
    s = s + weights.balanced_resource_weight * balanced_resource_score(
        task_resreq, node_used, node_alloc
    )
    return s


# ---- greedy assignment scan ----

def step_feasible_score(
    weights: ScoreWeights,
    tolerance: torch.Tensor,  # [R]
    base: torch.Tensor,  # [N, R] = idle0 + used0 (idle = base - used)
    node_alloc: torch.Tensor,
    node_max_tasks: torch.Tensor,
    used_ext: torch.Tensor,  # [N, R+1] — used lanes, task count
    resreq: torch.Tensor,  # [R]
    feas_row: torch.Tensor,  # [N] bool — class feasibility
    active: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-step feasibility and masked score over all nodes."""
    used = used_ext[:, :-1]
    count = used_ext[:, -1]
    idle = base - used
    scalar_lane = torch.arange(resreq.shape[-1], device=resreq.device) >= 2
    fit = (
        (resreq[None, :] < idle + tolerance[None, :])
        | (scalar_lane[None, :] & (resreq[None, :] <= tolerance[None, :]))
    ).all(-1)
    feasible = fit & (count < node_max_tasks) & feas_row & active
    score = node_scores(resreq[None, :], used, node_alloc, weights)[0]
    return feasible, torch.where(feasible, score, -torch.inf)


def step_delta_ext(resreq: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Packed (resource, +1 count) update row, zeroed when not placing."""
    okf = torch.where(ok, 1.0, 0.0)
    return torch.cat([resreq, torch.ones(1, dtype=resreq.dtype, device=resreq.device)]) * okf


def _assign_step(
    weights: ScoreWeights,
    tolerance: torch.Tensor,
    base: torch.Tensor,
    node_alloc: torch.Tensor,
    node_max_tasks: torch.Tensor,
    used_ext: torch.Tensor,
    job_assigned: torch.Tensor,
    resreq: torch.Tensor,
    feas_row: torch.Tensor,
    job_idx: int,
    active: bool,
) -> torch.Tensor:
    """One task: mask → score → argmax → tentative allocate.  Updates
    ``used_ext`` and ``job_assigned`` in place (the reference returns new
    arrays) and returns the chosen node (0-d, -1 when none fits).  No
    host sync: the pick stays on the device."""
    feasible, score = step_feasible_score(
        weights, tolerance, base, node_alloc, node_max_tasks,
        used_ext, resreq, feas_row, active,
    )
    best = torch.argmax(score).view(1)  # first max index — the tie-break
    ok = feasible.index_select(0, best)[0]
    used_ext.index_add_(0, best, step_delta_ext(resreq, ok)[None, :])
    job_assigned[job_idx] += ok.to(job_assigned.dtype)
    return torch.where(ok, best[0], -1)


def schedule_pass(
    task_resreq: torch.Tensor,  # [T, R]
    task_job: torch.Tensor,  # [T]
    task_feas_class: torch.Tensor,  # [T] index into class_sel/tol_bits
    class_sel_bits: torch.Tensor,  # [C, W]
    class_tol_bits: torch.Tensor,  # [C, W]
    node_idle: torch.Tensor,
    node_used: torch.Tensor,
    node_alloc: torch.Tensor,
    node_label_bits: torch.Tensor,
    node_taint_bits: torch.Tensor,
    node_ok: torch.Tensor,
    node_task_count: torch.Tensor,
    node_max_tasks: torch.Tensor,
    job_min_available: torch.Tensor,
    tolerance: torch.Tensor,
    active: torch.Tensor,  # [T] bool
    weights: ScoreWeights = DEFAULT_WEIGHTS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One greedy pass → (chosen[T] i32, job_assigned[J]).  Static
    feasibility (labels/taints/readiness) is evaluated per distinct
    bitset-signature class as a [C, N] matrix."""
    sel_ok = ((class_sel_bits[:, None, :] & ~node_label_bits[None, :, :]) == 0).all(-1)
    tol_ok = ((node_taint_bits[None, :, :] & ~class_tol_bits[:, None, :]) == 0).all(-1)
    class_feasible = sel_ok & tol_ok & node_ok[None, :]  # [C, N]

    base = node_idle + node_used
    used_ext = torch.cat([node_used, node_task_count.to(node_used.dtype)[:, None]], dim=1)
    job_assigned = torch.zeros_like(job_min_available)
    T = task_resreq.shape[0]
    chosen = torch.full((T,), -1, dtype=torch.int32, device=task_resreq.device)
    # the per-task scalars drive Python control flow: one host copy per pass
    classes = task_feas_class.tolist()
    jobs = task_job.tolist()
    acts = active.tolist()
    for t in range(T):
        if not acts[t]:
            # an inactive task is infeasible everywhere: it places nothing
            # and its zero update leaves the state bit-identical
            continue
        chosen[t] = _assign_step(
            weights, tolerance, base, node_alloc, node_max_tasks, used_ext,
            job_assigned, task_resreq[t], class_feasible[classes[t]], jobs[t], True,
        )
    return chosen, job_assigned


def _feasibility_classes(snap: PackedSnapshot):
    """Unique (sel_bits, tol_bits) rows → (class idx per task, class bit
    matrices).

    Row-uniqueness is computed by cascading cheap 1D uniques column by
    column (code = code * |u| + inv, re-densified each step) instead of
    ``np.unique(axis=0)``.  Memoized on the snapshot object."""
    cached = getattr(snap, "_feas_classes_cache", None)
    if cached is not None:
        return cached
    combined = np.concatenate([snap.task_sel_bits, snap.task_tol_bits], axis=1)
    T, Wc = combined.shape
    code = np.zeros(T, dtype=np.int64)
    for c in range(Wc):
        u, inv = np.unique(combined[:, c], return_inverse=True)
        code = code * np.int64(len(u)) + inv
        if c < Wc - 1:
            _, code = np.unique(code, return_inverse=True)
            code = code.astype(np.int64)
    uc, inverse = np.unique(code, return_inverse=True)
    first = np.full(len(uc), T, dtype=np.int64)
    np.minimum.at(first, inverse, np.arange(T, dtype=np.int64))
    uniq = combined[first]
    W = snap.task_sel_bits.shape[1]
    result = (
        inverse.astype(np.int32),
        np.ascontiguousarray(uniq[:, :W]),
        np.ascontiguousarray(uniq[:, W:]),
    )
    snap._feas_classes_cache = result
    return result


def gang_fixpoint(run_pass: Callable, task_job: np.ndarray, job_min_available: np.ndarray,
                  job_ready_count: np.ndarray, n_tasks: int, t_total: int, gang_rounds: int,
                  discard_unstable: bool = False) -> np.ndarray:
    """The host-driven gang commit/discard loop, shared by run_packed and
    the blocked rung: ``run_pass(active)`` with ``active`` [t_total] bool
    numpy → (chosen, job_assigned) numpy; each round deactivates the
    tasks of jobs short of min_available and re-runs the pass, stopping
    as soon as the active set is stable, or after ``gang_rounds`` passes
    (an unsettled cascade ships the last round's commits).

    ``discard_unstable`` opts into the reference's Statement semantics
    (statement.go:309-337): the loop runs to the true fixpoint, ignoring
    the round bound.  Every non-stable round strictly shrinks the active
    set, so the fixpoint arrives within min(n_jobs, n_tasks)+1 passes."""
    active = np.zeros(t_total, dtype=bool)
    active[:n_tasks] = True
    min_avail = job_min_available.astype(np.int64)
    ready_count = job_ready_count.astype(np.int64)

    rounds = 0
    while True:
        chosen_np, job_assigned = run_pass(active)
        ready = np.asarray(job_assigned, dtype=np.int64) + ready_count >= min_avail
        committed = ready[task_job] & (chosen_np >= 0)
        next_active = active & ready[task_job]
        rounds += 1
        if (next_active == active).all():
            break
        if not discard_unstable and rounds >= gang_rounds:
            break
        active = next_active
    return np.where(committed & active, chosen_np, -1)[:n_tasks]


def run_packed(
    snap: PackedSnapshot,
    weights: ScoreWeights = DEFAULT_WEIGHTS,
    gang_rounds: int = 3,
    discard_unstable: bool = False,
    device: Optional[Union[str, torch.device]] = None,
) -> np.ndarray:
    """PackedSnapshot → assignment[n_tasks] (np.int32), with the gang
    fixpoint driven host-side: it stops as soon as the active set is
    stable, or after ``gang_rounds`` passes.

    ``discard_unstable`` opts into the reference's Statement semantics
    for an unsettled cascade (statement.go:309-337: discard until
    stable), ignoring the ``gang_rounds`` bound."""
    dev = resolve_device(device)

    # Large nodes fall outside the f32 floor-division exactness envelope
    # (see least_requested_score) — switch to exact int division.
    if not f32_lr_exact(snap):
        weights = weights._replace(lr_int_exact=True)

    task_feas_class, class_sel, class_tol = _feasibility_classes(snap)
    planes = [
        as_tensor(x, dev)
        for x in (
            snap.task_resreq,
            snap.task_job,
            task_feas_class,
            class_sel,
            class_tol,
            snap.node_idle,
            snap.node_used,
            snap.node_alloc,
            snap.node_label_bits,
            snap.node_taint_bits,
            snap.node_ok,
            snap.node_task_count,
            snap.node_max_tasks,
            snap.job_min_available,
            snap.tolerance,
        )
    ]

    def run_pass(active: np.ndarray):
        chosen, job_assigned = schedule_pass(
            *planes, torch.from_numpy(active).to(dev), weights=weights
        )
        return chosen.cpu().numpy(), job_assigned.cpu().numpy()

    return gang_fixpoint(run_pass, snap.task_job, snap.job_min_available,
                         snap.job_ready_count, snap.n_tasks, snap.task_resreq.shape[0],
                         gang_rounds, discard_unstable=discard_unstable)
