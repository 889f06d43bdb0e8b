"""The allocate session on a GPU: the CUDA greedy-scan kernel, its plain
PyTorch version, and the gang fixpoint around it.

The counterpart of ``volcano_tpu/ops/pallas_session.py``.  One pass is
one launch of ``csrc/session_kernel.cu`` (a single 1024-thread block
with node state resident in shared memory); ``schedule_session_cuda``
runs the gang commit/discard fixpoint of ``schedule_session_pallas`` as
torch ops around up to ``gang_rounds`` launches with no host sync in
between — a device ``done`` flag makes the launches after a settled
round return at once, as ``lax.while_loop`` stops early.  The session
ships its arrays once and fetches ``assignment`` once.

Array layout (``prepare_session_arrays``): the Pallas planes' bytes,
with nodes flat instead of [NS, 128] — ``cf_u8`` [C, NK] and ``nd``
[3R+2, NK] are ``prepare_pallas_arrays``' arrays reshaped; ``taskrow``
holds the first ``n_tasks`` rows (the kernel needs no task-block
padding); ``tol`` is [R].  NK stays a multiple of 128 nodes, so warps
stride over whole node blocks.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple, Union

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
from volcano_tpu_torch.ops.packing import PackedSnapshot

#: node planes are padded to a multiple of this many nodes
NODE_ALIGN = 128
#: resource lanes the kernel takes (vt::kMaxLanes in session_math.cuh)
MAX_LANES = 8
#: shared memory one block may use on sm_90 (227 KB)
SMEM_LIMIT = 232_448
#: the kernel's static shared memory: warp argmax slots, task row, tolerance
_STATIC_SMEM = 32 * 4 * 2 + (MAX_LANES + 2) * 4 + MAX_LANES * 4

#: launches of the CUDA kernel by session_pass_cuda in this process
LAUNCHES = 0

_lib: Optional[ctypes.CDLL] = None


def node_width(n_nodes: int) -> int:
    """NK: the node count rounded up to whole 128-node blocks."""
    return max(NODE_ALIGN, -(-max(n_nodes, 1) // NODE_ALIGN) * NODE_ALIGN)


def session_smem_bytes(R: int, NK: int) -> int:
    """Dynamic shared memory of one pass: used lanes + pod counts."""
    return (R + 1) * NK * 4


def fits_shared_memory(R: int, NK: int) -> bool:
    """The cuda executor's one gate: the node state of a pass must fit
    one block's shared memory."""
    return session_smem_bytes(R, NK) + _STATIC_SMEM <= SMEM_LIMIT


# ---- host packing ----

def _node_planes(arr: np.ndarray, NK: int) -> np.ndarray:
    """[N_pad, R] → [R, NK] f32 planes over the first NK nodes
    (zero-padded when the snapshot's node pad is narrower than NK)."""
    n = min(NK, arr.shape[0])
    wide = np.zeros((NK, arr.shape[1]), dtype=np.float32)
    wide[:n] = arr[:n]
    return np.ascontiguousarray(wide.T)


def prepare_session_arrays(snap: PackedSnapshot) -> Tuple[dict, int, int]:
    """Host-side packing into the kernel's layout → (arrays, T_act, NK).

    Nodes are cut to NK = ceil(n_nodes/128)*128; tasks to the n_tasks
    valid rows.  The active column of ``taskrow`` is left 0 for the
    caller to fill per gang round."""
    NK = node_width(snap.n_nodes)
    NV = min(NK, snap.node_idle.shape[0])  # snapshot-backed node rows
    T_act = min(snap.n_tasks, snap.task_resreq.shape[0])
    R = snap.task_resreq.shape[1]

    task_cls, class_sel, class_tol = _feasibility_classes(snap)
    # class feasibility: selector bits ⊆ node labels, node taints ⊆
    # tolerations, node_ok — schedule_pass's [C, N] matrix
    node_labels = snap.node_label_bits[:NV]
    node_taints = snap.node_taint_bits[:NV]
    sel_ok = ((class_sel[:, None, :] & ~node_labels[None, :, :]) == 0).all(-1)
    tol_ok = ((node_taints[None, :, :] & ~class_tol[:, None, :]) == 0).all(-1)
    cf = np.zeros((class_sel.shape[0], NK), dtype=np.uint8)
    cf[:, :NV] = sel_ok & tol_ok & snap.node_ok[None, :NV]

    taskrow = np.zeros((T_act, R + 2), dtype=np.float32)
    taskrow[:, :R] = snap.task_resreq[:T_act]
    taskrow[:, R] = task_cls[:T_act].astype(np.float32)

    # base | alloc | used0 | count0, maxt
    nd = np.concatenate(
        [
            _node_planes(snap.node_idle + snap.node_used, NK),
            _node_planes(snap.node_alloc, NK),
            _node_planes(snap.node_used, NK),
            _node_planes(
                np.stack(
                    [
                        snap.node_task_count.astype(np.float32),
                        snap.node_max_tasks.astype(np.float32),
                    ],
                    axis=1,
                ),
                NK,
            ),
        ]
    )
    arrays = dict(
        taskrow=taskrow,
        cf_u8=cf,
        nd=nd,
        tol=snap.tolerance.astype(np.float32).reshape(R),
    )
    return arrays, T_act, NK


# ---- the plain version ----

def score_planes(
    rr: Sequence[float],  # R task resource requests
    req: List[torch.Tensor],  # R planes: rr[r] + used[r]
    alloc: torch.Tensor,  # [R, N]
    weights: ScoreWeights,
) -> torch.Tensor:
    """Total node-score plane for one task (binpack + least-requested +
    balanced) — the plain version of the kernel's score block
    (vt::node_score), in the same op order and f32 rounding."""
    R = len(rr)
    maxal = torch.clamp_min(alloc, 1.0)
    allocpos = alloc > 0.0
    w_bp = float(weights.binpack_weight)
    lane_w = [float(weights.binpack_cpu), float(weights.binpack_memory)] + [
        float(weights.binpack_scalar)
    ] * (R - 2)

    # --- binpack ---
    bp = None
    ws = np.float32(0.0)
    for r in range(R):
        if lane_w[r] == 0.0:
            continue
        reqmask = rr[r] > 0.0
        valid = allocpos[r] & (req[r] <= alloc[r]) & reqmask
        lane = torch.where(valid, req[r] * lane_w[r] / maxal[r], 0.0)
        bp = lane if bp is None else bp + lane
        ws = np.float32(ws + (np.float32(lane_w[r]) if reqmask else np.float32(0.0)))
    if bp is None:
        s_bp = torch.zeros_like(req[0])
    else:
        s_bp = (bp / float(ws) if ws > 0.0 else torch.zeros_like(bp)) * MAX_PRIORITY
        if w_bp != 1.0:
            s_bp = s_bp * w_bp

    # --- least-requested (f32 floor division, corrected) ---
    lr = None
    fracs = []
    for r in range(2):
        cap = alloc[r]
        c = maxal[r]
        p = (cap - req[r]) * MAX_PRIORITY
        q = torch.floor(p / c)
        q = q + ((q + 1.0) * c <= p).to(torch.float32) - (q * c > p).to(torch.float32)
        lane = torch.where(allocpos[r] & (req[r] <= cap), q, 0.0)
        lr = lane if lr is None else lr + lane
        # balanced fractions reuse req/max(alloc, 1)
        fracs.append(torch.where(allocpos[r], req[r] / c, 1.0))
    s_lr = torch.floor(lr * 0.5)

    # --- balanced resource ---
    cpu_f, mem_f = fracs
    diff = torch.abs(cpu_f - mem_f)
    s_bal = torch.floor((1.0 - diff) * MAX_PRIORITY)
    s_bal = torch.where((cpu_f >= 1.0) | (mem_f >= 1.0), 0.0, s_bal)

    return s_bp + float(weights.least_requested_weight) * s_lr + float(
        weights.balanced_resource_weight
    ) * s_bal


def masked_score_plane(
    rr: Sequence[float],  # [R] task row resource lanes
    tol: Sequence[float],  # [R]
    act: float,
    cls_ok: torch.Tensor,  # [N] bool — class feasibility
    base: torch.Tensor,  # [R, N]
    alloc: torch.Tensor,  # [R, N]
    used: torch.Tensor,  # [R, N]
    cnt: torch.Tensor,  # [N]
    maxt: torch.Tensor,  # [N]
    weights: ScoreWeights,
) -> torch.Tensor:
    """[N] masked score of one task — the plain version of
    vt::masked_score: the score where the task fits, -inf elsewhere."""
    fit = None
    req = []
    for r in range(len(rr)):
        idle = base[r] - used[r]
        ok = rr[r] < idle + tol[r]
        if r >= 2:
            ok = ok | (rr[r] <= tol[r])
        fit = ok if fit is None else fit & ok
        req.append(rr[r] + used[r])  # shared by all three scores
    feasible = fit & (cnt < maxt) & cls_ok & (act > 0.0)
    total = score_planes(rr, req, alloc, weights)
    return torch.where(feasible, total, -torch.inf)


def session_pass_reference(
    taskrow: torch.Tensor,  # [T, R+2] f32 — resreq lanes, class, active
    cf: torch.Tensor,  # [C, NK] u8 class feasibility
    nd: torch.Tensor,  # [3R+2, NK] f32 — base | alloc | used0 | count0, maxt
    tol: torch.Tensor,  # [R] f32
    weights: ScoreWeights = DEFAULT_WEIGHTS,
    done: Optional[torch.Tensor] = None,  # [1] i32 — nonzero: place nothing
) -> torch.Tensor:
    """One greedy pass → chosen[T] i32 (node index or -1): a Python loop
    over tasks on [NK] tensors.  The plain version of the CUDA kernel,
    with the wrapper's signature."""
    _check_pass_args(taskrow, cf, nd, tol, weights, done)
    T, RC = taskrow.shape
    R = RC - 2
    chosen = torch.full((T,), -1, dtype=torch.int32, device=taskrow.device)
    if done is not None and int(done[0]) != 0:
        return chosen
    rows = taskrow.cpu().tolist()  # task scalars drive the loop: one host copy
    tolv = tol.cpu().tolist()
    base, alloc = nd[:R], nd[R : 2 * R]
    used = nd[2 * R : 3 * R].clone()
    cnt = nd[3 * R].clone()
    maxt = nd[3 * R + 1]
    cls_ok = cf != 0
    for t, row in enumerate(rows):
        cls, act = int(row[R]), row[R + 1]
        if act <= 0.0 or not 0 <= cls < cf.shape[0]:
            continue  # infeasible everywhere: places nothing
        masked = masked_score_plane(
            row[:R], tolv, act, cls_ok[cls], base, alloc, used, cnt, maxt, weights
        )
        best = torch.argmax(masked).view(1)  # first max: lowest-index tie-break
        ok = torch.isfinite(masked.index_select(0, best))
        used.index_add_(1, best, (taskrow[t, :R] * ok)[:, None])
        cnt.index_add_(0, best, ok.to(torch.float32))
        chosen[t] = torch.where(ok, best, -1)[0]
    return chosen


# ---- the kernel wrapper ----

def _check_pass_args(taskrow, cf, nd, tol, weights, done) -> None:
    """Validate one pass's operands; raise before anything launches."""
    if weights.lr_int_exact:
        raise ValueError("the session kernel runs the f32 least-requested path only")
    if taskrow.dim() != 2 or not 2 <= taskrow.shape[1] - 2 <= MAX_LANES:
        raise ValueError(f"taskrow must be [T, R+2] with 2 <= R <= {MAX_LANES}")
    R = taskrow.shape[1] - 2
    if cf.dim() != 2:
        raise ValueError("cf must be [C, NK]")
    NK = cf.shape[1]
    expect = {
        "taskrow": (taskrow, torch.float32, tuple(taskrow.shape)),
        "cf": (cf, torch.uint8, tuple(cf.shape)),
        "nd": (nd, torch.float32, (3 * R + 2, NK)),
        "tol": (tol, torch.float32, (R,)),
    }
    if done is not None:
        expect["done"] = (done, torch.int32, (1,))
    for name, (x, dtype, shape) in expect.items():
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(
                f"{name}: expected {dtype} {shape}, got {x.dtype} {tuple(x.shape)}"
            )
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != taskrow.device:
            raise ValueError(f"{name} is on {x.device}, taskrow on {taskrow.device}")
    if not fits_shared_memory(R, NK):
        raise ValueError(
            f"{NK} nodes x {R} lanes need {session_smem_bytes(R, NK)} bytes of shared "
            f"memory; one block has {SMEM_LIMIT}"
        )


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from volcano_tpu_torch.ops import _build

        lib = _build.load()
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.vt_session_pass.argtypes = [
            p, i, i,  # taskrow, T, R
            p, i,  # cf, C
            p, p,  # nd, tol
            p, i,  # done, NK
            f, f, f, f, f, f,  # weights
            p, p, i,  # chosen, stream, device
        ]
        lib.vt_session_pass.restype = ctypes.c_int
        lib.vt_step_probe.argtypes = [p, i, i, i, p, p, i]
        lib.vt_step_probe.restype = ctypes.c_int
        lib.vt_error_string.argtypes = [ctypes.c_int]
        lib.vt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def session_pass_cuda(
    taskrow: torch.Tensor,
    cf: torch.Tensor,
    nd: torch.Tensor,
    tol: torch.Tensor,
    weights: ScoreWeights = DEFAULT_WEIGHTS,
    done: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One greedy pass → chosen[T] i32.  On CUDA tensors it launches the
    kernel (or raises); on CPU tensors it runs the plain version."""
    global LAUNCHES
    _check_pass_args(taskrow, cf, nd, tol, weights, done)
    if taskrow.device.type == "cpu":
        return session_pass_reference(taskrow, cf, nd, tol, weights, done)
    if taskrow.device.type != "cuda":
        raise ValueError(f"session_pass_cuda takes cuda or cpu tensors, not {taskrow.device}")
    T, RC = taskrow.shape
    chosen = torch.empty(T, dtype=torch.int32, device=taskrow.device)
    if T == 0:
        return chosen
    lib = _library()
    device = taskrow.device
    err = lib.vt_session_pass(
        taskrow.data_ptr(), T, RC - 2,
        cf.data_ptr(), cf.shape[0],
        nd.data_ptr(), tol.data_ptr(),
        None if done is None else done.data_ptr(), cf.shape[1],
        weights.binpack_weight, weights.binpack_cpu, weights.binpack_memory,
        weights.binpack_scalar, weights.least_requested_weight,
        weights.balanced_resource_weight,
        chosen.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
        device.index if device.index is not None else torch.cuda.current_device(),
    )
    if err != 0:
        raise RuntimeError(f"session kernel launch failed: {lib.vt_error_string(err).decode()}")
    LAUNCHES += 1
    return chosen


def step_latency_probe(taskrow: torch.Tensor, reps: int = 4096) -> dict:
    """SM cycles of the serial chain of one pass step on the card
    (``vt_step_probe`` in csrc/session_kernel.cu, same launch shape as
    the pass): per warp_argmax with every warp and with warp 0 alone,
    per block barrier, per shared-memory round trip, per task row staged
    (over ``taskrow``'s rows), and the probe's ns per cycle.  Not a pass:
    ``LAUNCHES`` does not count it."""
    if taskrow.device.type != "cuda" or taskrow.dtype != torch.float32:
        raise ValueError("step_latency_probe takes a cuda f32 taskrow")
    if not taskrow.is_contiguous() or taskrow.dim() != 2 or taskrow.shape[0] == 0:
        raise ValueError("taskrow must be a contiguous, non-empty [T, R+2]")
    T, RC = taskrow.shape
    device = taskrow.device
    out = torch.zeros(7, dtype=torch.int64, device=device)
    lib = _library()
    err = lib.vt_step_probe(
        taskrow.data_ptr(), T, RC, reps, out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
        device.index if device.index is not None else torch.cuda.current_device(),
    )
    if err != 0:
        raise RuntimeError(f"step probe launch failed: {lib.vt_error_string(err).decode()}")
    c = out.cpu().tolist()
    return dict(
        argmax_all=c[0] / reps, argmax_one=c[1] / reps, barrier=c[2] / reps,
        smem_round_trip=c[3] / reps, row_stage=c[4] / T, ns_per_cycle=c[5] / c[6],
    )


# ---- the session: gang fixpoint around the kernel ----

def schedule_session_cuda(
    taskrow: torch.Tensor,  # [T, R+2] f32 (active column overwritten)
    cf: torch.Tensor,  # [C, NK] u8
    nd: torch.Tensor,  # [3R+2, NK] f32
    tol: torch.Tensor,  # [R] f32
    task_job: torch.Tensor,  # [T] i64 → job row
    job_min_avail: torch.Tensor,  # [J] i32
    job_ready: torch.Tensor,  # [J] i32
    active0: torch.Tensor,  # [T] bool
    weights: ScoreWeights = DEFAULT_WEIGHTS,
    gang_rounds: int = 3,
) -> torch.Tensor:
    """Whole session on the device → assignment[T] (node index or -1,
    gang-committed only).

    Each round re-runs the pass with the tasks of non-ready jobs
    deactivated; a round whose active set is stable sets ``done``, and
    the launches after it return at once.  No host sync between rounds.
    ``taskrow``'s active column is updated in place."""
    R = taskrow.shape[1] - 2
    J = job_min_avail.shape[0]
    active = active0
    taskrow[:, R + 1] = active.to(torch.float32)
    done = torch.zeros(1, dtype=torch.int32, device=taskrow.device)
    chosen = torch.full((taskrow.shape[0],), -1, dtype=torch.int32, device=taskrow.device)
    committed = torch.zeros(taskrow.shape[0], dtype=torch.bool, device=taskrow.device)
    for _ in range(gang_rounds):
        fresh = session_pass_cuda(taskrow, cf, nd, tol, weights, done)
        chosen = torch.where(done.bool(), chosen, fresh)
        placed = chosen >= 0
        assigned = torch.zeros(J, dtype=torch.int32, device=taskrow.device).index_add_(
            0, task_job, placed.to(torch.int32)
        )
        ready = (assigned + job_ready >= job_min_avail)[task_job]
        committed = ready & placed
        next_active = active & ready
        done = done | (next_active == active).all().to(torch.int32)
        active = next_active
        taskrow[:, R + 1] = active.to(torch.float32)
    # committed ⊆ {chosen >= 0} ⊆ active-at-pass
    return torch.where(committed, chosen, -1)


def run_packed_cuda(
    snap: PackedSnapshot,
    weights: ScoreWeights = DEFAULT_WEIGHTS,
    gang_rounds: int = 3,
    device: Optional[Union[str, torch.device]] = None,
) -> np.ndarray:
    """PackedSnapshot → assignment[n_tasks] (np.int32): pack, ship the
    arrays once, run the session on the device, fetch once."""
    if not f32_lr_exact(snap):
        raise ValueError("node capacity outside the f32-exact envelope")
    dev = resolve_device(device)
    arrays, T_act, NK = prepare_session_arrays(snap)
    if T_act == 0:
        return np.zeros(0, dtype=np.int32)
    task_job = snap.task_job[:T_act].astype(np.int64)
    J = snap.job_min_available.shape[0]
    if int(task_job.min(initial=0)) < 0 or int(task_job.max(initial=0)) >= J:
        raise ValueError("task_job indexes past the job planes")
    out = schedule_session_cuda(
        torch.from_numpy(arrays["taskrow"]).to(dev),
        torch.from_numpy(arrays["cf_u8"]).to(dev),
        torch.from_numpy(arrays["nd"]).to(dev),
        torch.from_numpy(arrays["tol"]).to(dev),
        torch.from_numpy(task_job).to(dev),
        torch.from_numpy(snap.job_min_available.astype(np.int32)).to(dev),
        torch.from_numpy(snap.job_ready_count.astype(np.int32)).to(dev),
        torch.ones(T_act, dtype=torch.bool, device=dev),
        weights=weights,
        gang_rounds=gang_rounds,
    )
    return out.cpu().numpy()
