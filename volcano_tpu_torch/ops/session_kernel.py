"""The allocate session on a GPU: the CUDA greedy-scan kernel, its plain
PyTorch version, and the gang fixpoint around it.

The counterpart of ``volcano_tpu/ops/pallas_session.py``.  One pass is
one launch of ``csrc/session_kernel.cu`` (a single 1024-thread block
with node state resident in shared memory, sweeping only the nodes of
each task's feasibility class; the wide instance, for node state beyond
one block's shared memory or more than ``MAX_LANES`` lanes, keeps it in
a global-memory scratch instead); ``schedule_session_cuda`` runs the gang
commit/discard fixpoint of ``schedule_session_pallas`` as torch ops
around up to ``gang_rounds`` launches with no host sync in between — a
device ``done`` flag makes the launches after a settled round return at
once, as ``lax.while_loop`` stops early.  The session ships its arrays
once and fetches ``assignment`` once.

Array layout (``prepare_session_arrays``): the Pallas planes' bytes,
with nodes flat instead of [NS, 128] — ``cf_u8`` [C, NK] and ``nd``
[3R+2, NK] are ``prepare_pallas_arrays``' arrays reshaped; ``taskrow``
holds the first ``n_tasks`` rows (the kernel needs no task-block
padding); ``tol`` is [R].  NK stays a multiple of 128 nodes.  Beside
them, the class-compacted node lists the kernel sweeps: ``cls_off``
[C+1] i32 and ``cls_nodes`` [sum L_c] i32, class c's nodes being
``cls_nodes[cls_off[c]:cls_off[c+1]] == np.flatnonzero(cf_u8[c])``.

Node operands from the resident planes (``device_node_operands``):
``nd``, ``cf_u8`` and the class lists are built on the device with torch
ops from the snapshot's planes staged there, equal bit for bit to
``prepare_session_arrays``' host arrays, which stay as their reference.
The warm packer's stager keeps the planes resident across cycles
(``snap.device_planes``, ops/device_stage.py); a snapshot it did not
stage gets one full put of its planes for the session.  Only the
task-side arrays are built on the host.

Shared memory (``plan_shared_memory``): where the node state, (R+1)*NK*4
bytes, fits one block and R <= ``MAX_LANES`` (``shared_layout``), it
stays there; the plane of masked scores over the longest list, max L_c
* 4 bytes, joins it where it fits too, and turns on the repeated-row
fast path.  Every other session runs the wide instance: node state in
global memory, the plane always on, in shared memory where it fits
beside the task rows and in global memory where it does not
(``plan_wide``).
"""

from __future__ import annotations

import ctypes
import time
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from volcano_tpu_torch.ops.device_stage import DeviceStager
from volcano_tpu_torch.ops.kernels import (
    _feasibility_classes,
    DEFAULT_WEIGHTS,
    f32_lr_exact,
    f32_to_i32,
    MAX_PRIORITY,
    resolve_device,
    ScoreWeights,
)
from volcano_tpu_torch.ops.packing import PackedSnapshot

#: node planes are padded to a multiple of this many nodes
NODE_ALIGN = 128
#: resource lanes the shared-memory layout takes (vt::kMaxLanes in
#: session_math.cuh); the wide instance takes any count
MAX_LANES = 8
#: shared memory one block may use on sm_90 (227 KB)
SMEM_LIMIT = 232_448
#: the kernel's static shared memory: warp argmax slots (value, key), three
#: task rows in flight with their list bounds and repeat flags, the last
#: pick, tolerance
_STATIC_SMEM = 32 * 4 * 2 + 3 * ((MAX_LANES + 2) * 4 + 2 * 4 + 4) + 4 + MAX_LANES * 4

#: the wide instance's static shared memory: warp argmax slots, list
#: bounds and repeat flags of three rows, the last pick, two unused words
_WIDE_STATIC_SMEM = 32 * 4 * 2 + 3 * (2 * 4 + 4) + 4 + 2 * 4

#: launches of the CUDA kernel's shared-memory layout in this process
LAUNCHES = 0
#: launches of its wide instance (node state in global memory)
WIDE_LAUNCHES = 0

#: the counts a pass writes into ``stats``
STATS = ("full_steps", "fast_steps")

#: how the last ``run_packed_cuda`` session prepared its operands:
#: ``prepare_ms`` (host clock from the call to the first launch: the
#: task-side arrays, the copies and the device-side build),
#: ``h2d_bytes`` (the bytes the session itself copied to the device,
#: a full put of planes no stager held included)
last_session_stats: dict = {}

_lib: Optional[ctypes.CDLL] = None


def node_width(n_nodes: int) -> int:
    """NK: the node count rounded up to whole 128-node blocks."""
    return max(NODE_ALIGN, -(-max(n_nodes, 1) // NODE_ALIGN) * NODE_ALIGN)


def session_smem_bytes(R: int, NK: int) -> int:
    """Dynamic shared memory of the node state: used lanes + pod counts."""
    return (R + 1) * NK * 4


def fits_shared_memory(R: int, NK: int) -> bool:
    """Whether the node state of a pass fits one block's shared memory."""
    return session_smem_bytes(R, NK) + _STATIC_SMEM <= SMEM_LIMIT


def shared_layout(R: int, NK: int) -> bool:
    """Whether a pass runs the shared-memory layout (else the wide
    instance): R <= MAX_LANES lanes and node state that fits one block."""
    return R <= MAX_LANES and fits_shared_memory(R, NK)


def plan_wide(R: int, max_len: int) -> bool:
    """Whether the wide instance keeps its masked-score plane (the
    longest list, ``max_len`` scores) in shared memory beside the three
    task rows and the tolerance (else in global memory).  Raises where
    even those do not fit."""
    rows = (3 * (R + 2) + R) * 4 + _WIDE_STATIC_SMEM
    if rows > SMEM_LIMIT:
        raise ValueError(f"{R} lanes: the task rows need {rows} bytes of shared memory")
    return rows + max_len * 4 <= SMEM_LIMIT


def plan_shared_memory(R: int, NK: int, max_len: int) -> int:
    """Masked-score plane length of a pass whose longest class list holds
    ``max_len`` nodes: ``max_len`` where the plane fits beside the node
    state (the repeated-row fast path runs), else 0 (every step sweeps
    its list).  Decided by the sizes alone; raises where the node state
    itself does not fit."""
    if not fits_shared_memory(R, NK):
        raise ValueError(
            f"{NK} nodes x {R} lanes need {session_smem_bytes(R, NK)} bytes of shared "
            f"memory; one block has {SMEM_LIMIT}"
        )
    fits = session_smem_bytes(R, NK) + max_len * 4 + _STATIC_SMEM <= SMEM_LIMIT
    return max_len if fits else 0


def class_lists(cf: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[C, NK] class feasibility → (cls_off [C+1] i32, cls_nodes i32):
    each class's feasible node ids, ascending, one list after another."""
    cls, nodes = np.nonzero(cf)  # row-major: by class, then ascending node
    cls_off = np.zeros(cf.shape[0] + 1, dtype=np.int32)
    cls_off[1:] = np.cumsum(np.bincount(cls, minlength=cf.shape[0]))
    return cls_off, nodes.astype(np.int32)


def repeated_rows(taskrow: torch.Tensor) -> int:
    """Rows equal bit for bit to the row before them: the steps a pass
    with the masked-score plane takes on its fast path."""
    if taskrow.shape[0] < 2:
        return 0
    bits = taskrow.contiguous().view(torch.int32)
    return int((bits[1:] == bits[:-1]).all(1).sum())


# ---- host packing ----

def _node_planes(arr: np.ndarray, NK: int) -> np.ndarray:
    """[N_pad, R] → [R, NK] f32 planes over the first NK nodes
    (zero-padded when the snapshot's node pad is narrower than NK)."""
    n = min(NK, arr.shape[0])
    wide = np.zeros((NK, arr.shape[1]), dtype=np.float32)
    wide[:n] = arr[:n]
    return np.ascontiguousarray(wide.T)


def task_rows(snap: PackedSnapshot) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The task side of the kernel's layout → (taskrow [T_act, R+2],
    class_sel [C, W], class_tol [C, W]): each valid task's requests and
    its feasibility class; the active column is left 0 for the caller
    to fill per gang round."""
    T_act = min(snap.n_tasks, snap.task_resreq.shape[0])
    R = snap.task_resreq.shape[1]
    task_cls, class_sel, class_tol = _feasibility_classes(snap)
    taskrow = np.zeros((T_act, R + 2), dtype=np.float32)
    taskrow[:, :R] = snap.task_resreq[:T_act]
    taskrow[:, R] = task_cls[:T_act].astype(np.float32)
    return taskrow, class_sel, class_tol


def prepare_session_arrays(snap: PackedSnapshot) -> Tuple[dict, int, int]:
    """Host-side packing into the kernel's layout → (arrays, T_act, NK).

    Nodes are cut to NK = ceil(n_nodes/128)*128; tasks to the n_tasks
    valid rows.  The active column of ``taskrow`` is left 0 for the
    caller to fill per gang round."""
    NK = node_width(snap.n_nodes)
    NV = min(NK, snap.node_idle.shape[0])  # snapshot-backed node rows
    R = snap.task_resreq.shape[1]

    taskrow, class_sel, class_tol = task_rows(snap)
    T_act = taskrow.shape[0]
    # class feasibility: selector bits ⊆ node labels, node taints ⊆
    # tolerations, node_ok — schedule_pass's [C, N] matrix
    node_labels = snap.node_label_bits[:NV]
    node_taints = snap.node_taint_bits[:NV]
    sel_ok = ((class_sel[:, None, :] & ~node_labels[None, :, :]) == 0).all(-1)
    tol_ok = ((node_taints[None, :, :] & ~class_tol[:, None, :]) == 0).all(-1)
    cf = np.zeros((class_sel.shape[0], NK), dtype=np.uint8)
    cf[:, :NV] = sel_ok & tol_ok & snap.node_ok[None, :NV]

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
    cls_off, cls_nodes = class_lists(cf)
    arrays = dict(
        taskrow=taskrow,
        cf_u8=cf,
        nd=nd,
        tol=snap.tolerance.astype(np.float32).reshape(R),
        cls_off=cls_off,
        cls_nodes=cls_nodes,
    )
    return arrays, T_act, NK


def device_node_operands(
    planes: dict, n_nodes: int, class_sel: np.ndarray, class_tol: np.ndarray,
) -> dict:
    """``prepare_session_arrays``' node operands built with torch ops on
    the device of the staged ``planes`` (``ops/device_stage``; bit planes
    as int32 with the same bits) → {nd, cf_u8, cls_off, cls_nodes}, equal
    bit for bit to the host arrays.  ``class_sel``/``class_tol`` are the
    host's feasibility classes (task side, [C, W] uint32)."""
    idle = planes["node_idle"]
    dev = idle.device
    NK = node_width(n_nodes)
    NV = min(NK, idle.shape[0])

    def lane_planes(x: torch.Tensor) -> torch.Tensor:
        """[N_pad, k] → [k, NK] f32, zero past the snapshot's rows."""
        wide = torch.zeros((NK, x.shape[1]), dtype=torch.float32, device=dev)
        wide[:NV] = x[:NV]
        return wide.t().contiguous()

    cs = torch.from_numpy(np.ascontiguousarray(class_sel).view(np.int32)).to(dev)
    ct = torch.from_numpy(np.ascontiguousarray(class_tol).view(np.int32)).to(dev)
    labels = planes["node_label_bits"][:NV]
    taints = planes["node_taint_bits"][:NV]
    sel_ok = ((cs[:, None, :] & ~labels[None, :, :]) == 0).all(-1)
    tol_ok = ((taints[None, :, :] & ~ct[:, None, :]) == 0).all(-1)
    cf = torch.zeros((cs.shape[0], NK), dtype=torch.uint8, device=dev)
    cf[:, :NV] = (sel_ok & tol_ok & planes["node_ok"][None, :NV]).to(torch.uint8)

    used = planes["node_used"]
    # base | alloc | used0 | count0, maxt
    nd = torch.cat([
        lane_planes(idle + used),
        lane_planes(planes["node_alloc"]),
        lane_planes(used),
        lane_planes(torch.stack([planes["node_task_count"].to(torch.float32),
                                 planes["node_max_tasks"].to(torch.float32)], dim=1)),
    ])
    cls, nodes = torch.nonzero(cf, as_tuple=True)  # by class, then ascending node
    cls_off = torch.zeros(cf.shape[0] + 1, dtype=torch.int32, device=dev)
    cls_off[1:] = torch.cumsum(torch.bincount(cls, minlength=cf.shape[0]), 0)
    return dict(nd=nd, cf_u8=cf, cls_off=cls_off, cls_nodes=nodes.to(torch.int32))


# ---- the plain version ----

def score_planes(
    rr: Sequence[float],  # R task resource requests
    req: List[torch.Tensor],  # R planes: rr[r] + used[r]
    alloc: torch.Tensor,  # [R, N]
    weights: ScoreWeights,
) -> torch.Tensor:
    """Total node-score plane for one task (binpack + least-requested +
    balanced) — the plain version of the kernel's score block
    (vt::node_score), in the same op order and f32 rounding;
    least-requested in int32 where ``weights.lr_int_exact`` is set."""
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

    # --- least-requested (f32 floor division, corrected; or int32) ---
    lr = None
    fracs = []
    for r in range(2):
        cap = alloc[r]
        c = maxal[r]
        if weights.lr_int_exact:
            reqi, capi = f32_to_i32(req[r]), f32_to_i32(cap)
            q = torch.div((capi - reqi) * int(MAX_PRIORITY), torch.clamp_min(capi, 1),
                          rounding_mode="floor")
            lane = torch.where((capi > 0) & (reqi <= capi), q, 0)
        else:
            p = (cap - req[r]) * MAX_PRIORITY
            q = torch.floor(p / c)
            q = q + ((q + 1.0) * c <= p).to(torch.float32) - (q * c > p).to(torch.float32)
            lane = torch.where(allocpos[r] & (req[r] <= cap), q, 0.0)
        lr = lane if lr is None else lr + lane
        # balanced fractions reuse req/max(alloc, 1)
        fracs.append(torch.where(allocpos[r], req[r] / c, 1.0))
    if weights.lr_int_exact:
        s_lr = torch.div(lr, 2, rounding_mode="floor").to(torch.float32)
    else:
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
    cls_off: torch.Tensor,  # [C+1] i32 — class list bounds (checked, not used)
    cls_nodes: torch.Tensor,  # [sum L_c] i32 — class lists (checked, not used)
    weights: ScoreWeights = DEFAULT_WEIGHTS,
    done: Optional[torch.Tensor] = None,  # [1] i32 — nonzero: place nothing
) -> torch.Tensor:
    """One greedy pass → chosen[T] i32 (node index or -1): a Python loop
    over tasks, each masking and scoring every node from ``cf`` — the
    full-recompute specification.  The plain version of the CUDA kernel,
    with the wrapper's operands; it takes no steps of the kernel's, so it
    counts none."""
    _check_pass_args(taskrow, cf, nd, tol, cls_off, cls_nodes, weights, done, None)
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

def _check_pass_args(taskrow, cf, nd, tol, cls_off, cls_nodes, weights, done, stats) -> int:
    """Validate one pass's operands; raise before anything launches.
    Returns the longest class list (one device read on CUDA tensors)."""
    if taskrow.device.type not in ("cpu", "cuda"):
        raise ValueError(f"a session pass takes cuda or cpu tensors, not {taskrow.device}")
    if taskrow.dim() != 2 or taskrow.shape[1] - 2 < 2:
        raise ValueError("taskrow must be [T, R+2] with R >= 2")
    R = taskrow.shape[1] - 2
    if cf.dim() != 2:
        raise ValueError("cf must be [C, NK]")
    NK = cf.shape[1]
    expect = {
        "taskrow": (taskrow, torch.float32, tuple(taskrow.shape)),
        "cf": (cf, torch.uint8, tuple(cf.shape)),
        "nd": (nd, torch.float32, (3 * R + 2, NK)),
        "tol": (tol, torch.float32, (R,)),
        "cls_off": (cls_off, torch.int32, (cf.shape[0] + 1,)),
        "cls_nodes": (cls_nodes, torch.int32, (cls_nodes.numel(),)),
    }
    if done is not None:
        expect["done"] = (done, torch.int32, (1,))
    if stats is not None:
        expect["stats"] = (stats, torch.int32, (len(STATS),))
    for name, (x, dtype, shape) in expect.items():
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(
                f"{name}: expected {dtype} {shape}, got {x.dtype} {tuple(x.shape)}"
            )
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != taskrow.device:
            raise ValueError(f"{name} is on {x.device}, taskrow on {taskrow.device}")
    if not shared_layout(R, NK):
        plan_wide(R, 0)  # raises where the task rows do not fit
    return _check_lists(cls_off, cls_nodes, NK)


def _check_lists(cls_off: torch.Tensor, cls_nodes: torch.Tensor, NK: int) -> int:
    """The kernel indexes node state through the lists without bounds
    checks: offsets from 0 to len(cls_nodes), never falling; node ids in
    [0, NK), strictly rising within a list (the tie-break needs it).
    Returns the longest list."""
    L = cls_nodes.numel()
    lens = cls_off[1:] - cls_off[:-1]
    bad = (cls_off[0] != 0) | (cls_off[-1] != L) | (lens < 0).any()
    if L:
        bad = bad | ((cls_nodes < 0) | (cls_nodes >= NK)).any()
        starts = torch.zeros(L + 1, dtype=torch.bool, device=cls_nodes.device)
        starts[cls_off.clamp(0, L).long()] = True
        rising = cls_nodes[1:] > cls_nodes[:-1]
        bad = bad | ~(rising | starts[1:L]).all()
    longest = lens.max() if lens.numel() else torch.zeros((), dtype=torch.int32,
                                                          device=cls_off.device)
    bad_v, longest_v = torch.stack([bad.to(torch.int32), longest.to(torch.int32)]).tolist()
    if bad_v:
        raise ValueError("cls_off/cls_nodes are not ascending class lists of nodes in [0, NK)")
    return longest_v


def load_library() -> ctypes.CDLL:
    """The kernel library, built from the checkout's sources at the first
    call (``ops/_build.py``); raises where the build fails."""
    global _lib
    if _lib is None:
        from volcano_tpu_torch.ops import _build

        lib = _build.load()
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.vt_session_pass.argtypes = [
            p, i, i,  # taskrow, T, R
            p, i, p,  # cls_off, C, cls_nodes
            p, i,  # lnd, LT
            p, p,  # nd, tol
            p, i,  # done, NK
            f, f, f, f, f, f, i,  # weights, lr_int
            i, p, p,  # plane_len, gstate, gplane
            p, p, p,  # tlist, chosen, stats
            p, i,  # stream, device
        ]
        lib.vt_session_pass.restype = ctypes.c_int
        lib.vt_step_probe.argtypes = [p, i, i, i, p, p, i]
        lib.vt_step_probe.restype = ctypes.c_int
        lib.vt_score_probe.argtypes = [p, p, p, i, i, f, f, f, f, f, f, p, p, i]
        lib.vt_score_probe.restype = ctypes.c_int
        lib.vt_error_string.argtypes = [ctypes.c_int]
        lib.vt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _device_index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


class LaunchPlan(NamedTuple):
    """What every launch over one session's checked CUDA operands reuses,
    made once by ``launch_plan``: neither ``nd`` nor the lists change
    between gang rounds."""

    plane_len: int  # masked-score plane, in scores (0: off)
    lnd: torch.Tensor  # [3R+2, LT] nd[:, cls_nodes]: the node planes in list order
    tlist: torch.Tensor  # [T, 2] i32 scratch: each task's list start and length
    gstate: Optional[torch.Tensor]  # [R+1, NK] f32: the wide instance's node state
    gplane: Optional[torch.Tensor]  # [plane_len] f32: its plane, where not in shared memory


def launch_plan(taskrow, cf, nd, cls_nodes, max_len: int) -> Optional[LaunchPlan]:
    """The plan of launches on checked operands whose longest list is
    ``max_len``: the layout (``shared_layout``), the plane
    ``plan_shared_memory`` or ``plan_wide`` picks, the list-order gather,
    the list-bounds scratch and the wide instance's global scratch.  None
    on CPU operands, where the plain version runs."""
    if taskrow.device.type == "cpu":
        return None
    R, NK, dev = taskrow.shape[1] - 2, cf.shape[1], taskrow.device
    gstate = gplane = None
    if shared_layout(R, NK):
        plane_len = plan_shared_memory(R, NK, max_len)
    else:
        plane_len = max_len
        gstate = torch.empty((R + 1, NK), dtype=torch.float32, device=dev)
        if not plan_wide(R, max_len):
            gplane = torch.empty(max(max_len, 1), dtype=torch.float32, device=dev)
    return LaunchPlan(
        plane_len,
        nd.index_select(1, cls_nodes),
        torch.empty((taskrow.shape[0], 2), dtype=torch.int32, device=dev),
        gstate,
        gplane,
    )


def _launch(taskrow, cf, nd, tol, cls_off, cls_nodes, weights, done, stats,
            plan: LaunchPlan) -> torch.Tensor:
    """Launch one pass on checked CUDA operands, by ``plan``."""
    global LAUNCHES, WIDE_LAUNCHES
    T, RC = taskrow.shape
    device = taskrow.device
    chosen = torch.empty(T, dtype=torch.int32, device=device)
    if T == 0:
        if stats is not None:
            stats.zero_()
        return chosen
    lib = load_library()
    err = lib.vt_session_pass(
        taskrow.data_ptr(), T, RC - 2,
        cls_off.data_ptr(), cf.shape[0], cls_nodes.data_ptr(),
        plan.lnd.data_ptr(), cls_nodes.numel(),
        nd.data_ptr(), tol.data_ptr(),
        None if done is None else done.data_ptr(), cf.shape[1],
        weights.binpack_weight, weights.binpack_cpu, weights.binpack_memory,
        weights.binpack_scalar, weights.least_requested_weight,
        weights.balanced_resource_weight, int(weights.lr_int_exact),
        plan.plane_len,
        None if plan.gstate is None else plan.gstate.data_ptr(),
        None if plan.gplane is None else plan.gplane.data_ptr(),
        plan.tlist.data_ptr(), chosen.data_ptr(),
        None if stats is None else stats.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream, _device_index(device),
    )
    if err != 0:
        raise RuntimeError(f"session kernel launch failed: {lib.vt_error_string(err).decode()}")
    if plan.gstate is None:
        LAUNCHES += 1
    else:
        WIDE_LAUNCHES += 1
    return chosen


def _pass(taskrow, cf, nd, tol, cls_off, cls_nodes, weights, done, stats,
          plan: Optional[LaunchPlan]) -> torch.Tensor:
    """One pass on checked operands: the kernel on CUDA tensors, by
    ``plan``; the plain version on CPU tensors (``plan`` None), which
    counts no steps."""
    if taskrow.device.type == "cpu":
        if stats is not None:
            raise ValueError("stats counts the kernel's steps; a pass on CPU tensors has none")
        return session_pass_reference(taskrow, cf, nd, tol, cls_off, cls_nodes, weights, done)
    return _launch(taskrow, cf, nd, tol, cls_off, cls_nodes, weights, done, stats, plan)


def session_pass_cuda(
    taskrow: torch.Tensor,
    cf: torch.Tensor,
    nd: torch.Tensor,
    tol: torch.Tensor,
    cls_off: torch.Tensor,
    cls_nodes: torch.Tensor,
    weights: ScoreWeights = DEFAULT_WEIGHTS,
    done: Optional[torch.Tensor] = None,
    stats: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One greedy pass → chosen[T] i32.  On CUDA tensors it launches the
    kernel (or raises), and ``stats`` (i32 [2]) receives the counts named
    by STATS; on CPU tensors it runs the plain version, and takes no
    ``stats``."""
    max_len = _check_pass_args(taskrow, cf, nd, tol, cls_off, cls_nodes, weights, done, stats)
    plan = launch_plan(taskrow, cf, nd, cls_nodes, max_len)
    return _pass(taskrow, cf, nd, tol, cls_off, cls_nodes, weights, done, stats, plan)


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
    lib = load_library()
    err = lib.vt_step_probe(
        taskrow.data_ptr(), T, RC, reps, out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream, _device_index(device),
    )
    if err != 0:
        raise RuntimeError(f"step probe launch failed: {lib.vt_error_string(err).decode()}")
    c = out.cpu().tolist()
    return dict(
        argmax_all=c[0] / reps, argmax_one=c[1] / reps, barrier=c[2] / reps,
        smem_round_trip=c[3] / reps, row_stage=c[4] / T, ns_per_cycle=c[5] / c[6],
    )


def score_latency_probe(nd: torch.Tensor, taskrow: torch.Tensor, tol: torch.Tensor,
                        weights: ScoreWeights = DEFAULT_WEIGHTS, reps: int = 2048) -> dict:
    """SM cycles of one node's score (``vt_score_probe``, R = 2), scored
    for ``taskrow``'s first row, each node dependent on the score before:
    on one thread with the node planes from L2 (``l2``), from L1 (``l1``)
    and already in registers (``score``); and per node with all 1024
    threads scoring at once from registers (``block``: near ``score``
    where latency binds, above it where the SM's issue rate does).  Not a
    pass: ``LAUNCHES`` does not count it."""
    if taskrow.device.type != "cuda" or taskrow.shape[1] != 4:
        raise ValueError("score_latency_probe takes cuda operands with R = 2")
    device = taskrow.device
    out = torch.zeros(5, dtype=torch.int64, device=device)
    lib = load_library()
    err = lib.vt_score_probe(
        nd.data_ptr(), taskrow[0].contiguous().data_ptr(), tol.data_ptr(), nd.shape[1], reps,
        weights.binpack_weight, weights.binpack_cpu, weights.binpack_memory,
        weights.binpack_scalar, weights.least_requested_weight,
        weights.balanced_resource_weight, out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream, _device_index(device),
    )
    if err != 0:
        raise RuntimeError(f"score probe launch failed: {lib.vt_error_string(err).decode()}")
    c = out.cpu().tolist()
    return dict(l2=c[0] / reps, l1=c[1] / reps, score=c[2] / reps, block=c[3] / (reps // 8))


# ---- the session: gang fixpoint around the kernel ----

def schedule_session_cuda(
    taskrow: torch.Tensor,  # [T, R+2] f32 (active column overwritten)
    cf: torch.Tensor,  # [C, NK] u8
    nd: torch.Tensor,  # [3R+2, NK] f32
    tol: torch.Tensor,  # [R] f32
    cls_off: torch.Tensor,  # [C+1] i32
    cls_nodes: torch.Tensor,  # [sum L_c] i32
    task_job: torch.Tensor,  # [T] i64 → job row
    job_min_avail: torch.Tensor,  # [J] i32
    job_ready: torch.Tensor,  # [J] i32
    active0: torch.Tensor,  # [T] bool
    weights: ScoreWeights = DEFAULT_WEIGHTS,
    gang_rounds: int = 3,
    discard_unstable: bool = False,
) -> torch.Tensor:
    """Whole session on the device → assignment[T] (node index or -1,
    gang-committed only).

    Each round re-runs the pass with the tasks of non-ready jobs
    deactivated; a round whose active set is stable sets ``done``, and
    the launches after it return at once.  The operands are checked
    and the launches planned (``launch_plan``) once, before the first
    launch; no host sync between rounds.  ``discard_unstable`` (the
    reference's Statement semantics, as in ``kernels.run_packed``) runs
    batches of ``gang_rounds`` rounds until ``done`` is set, one host
    read of ``done`` per batch; every unstable round shrinks the active
    set, so the loop ends.  ``taskrow``'s active column is updated in
    place."""
    R = taskrow.shape[1] - 2
    J = job_min_avail.shape[0]
    active = active0
    taskrow[:, R + 1] = active.to(torch.float32)
    done = torch.zeros(1, dtype=torch.int32, device=taskrow.device)
    max_len = _check_pass_args(taskrow, cf, nd, tol, cls_off, cls_nodes, weights, done, None)
    plan = launch_plan(taskrow, cf, nd, cls_nodes, max_len)
    chosen = torch.full((taskrow.shape[0],), -1, dtype=torch.int32, device=taskrow.device)
    committed = torch.zeros(taskrow.shape[0], dtype=torch.bool, device=taskrow.device)
    while True:
        for _ in range(max(gang_rounds, 1)):
            fresh = _pass(taskrow, cf, nd, tol, cls_off, cls_nodes, weights, done, None, plan)
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
        if not discard_unstable or int(done[0]):
            break
    # committed ⊆ {chosen >= 0} ⊆ active-at-pass
    return torch.where(committed, chosen, -1)


def run_packed_cuda(
    snap: PackedSnapshot,
    weights: ScoreWeights = DEFAULT_WEIGHTS,
    gang_rounds: int = 3,
    device: Optional[Union[str, torch.device]] = None,
    discard_unstable: bool = False,
) -> np.ndarray:
    """PackedSnapshot → assignment[n_tasks] (np.int32): build the node
    operands on the device from the staged planes (``snap.device_planes``,
    or one full put of the snapshot's planes where no stager staged
    them), copy the task-side arrays, run the session on the device,
    fetch once.  ``discard_unstable`` runs the gang fixpoint to its end
    (``schedule_session_cuda``).  How the operands were prepared lands
    in ``last_session_stats``.

    Least-requested runs in int32 where ``weights.lr_int_exact`` asks for
    it or a node's capacity leaves the f32 floor-division envelope — the
    rule of ``kernels.run_packed``."""
    global last_session_stats
    t0 = time.perf_counter()
    if not f32_lr_exact(snap):
        weights = weights._replace(lr_int_exact=True)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    taskrow, class_sel, class_tol = task_rows(snap)
    T_act = taskrow.shape[0]
    if T_act == 0:
        last_session_stats = {}
        return np.zeros(0, dtype=np.int32)
    J = snap.job_min_available.shape[0]
    task_job = snap.task_job[:T_act]
    if int(task_job.min(initial=0)) < 0 or int(task_job.max(initial=0)) >= J:
        raise ValueError("task_job indexes past the job planes")
    planes = snap.device_planes
    h2d = taskrow.nbytes + class_sel.nbytes + class_tol.nbytes
    if planes is None:
        stager = DeviceStager("session", dev)
        planes = stager.stage(snap)
        h2d += stager.take_bytes()
    elif planes["node_idle"].device != dev:
        raise ValueError(f"the staged planes are on {planes['node_idle'].device}, "
                         f"the session runs on {dev}")
    ops = device_node_operands(planes, snap.n_nodes, class_sel, class_tol)
    R = taskrow.shape[1] - 2
    operands = (
        torch.from_numpy(taskrow).to(dev), ops["cf_u8"], ops["nd"],
        planes["tolerance"].to(torch.float32).reshape(R), ops["cls_off"], ops["cls_nodes"],
        planes["task_job"][:T_act].long(), planes["job_min_available"].to(torch.int32),
        planes["job_ready_count"].to(torch.int32),
    )
    # a copy from pageable memory returns once its source is read, and
    # the class lists' nonzero waits for the build before it returns
    last_session_stats = dict(h2d_bytes=h2d, prepare_ms=(time.perf_counter() - t0) * 1e3)
    out = schedule_session_cuda(
        *operands,
        torch.ones(T_act, dtype=torch.bool, device=dev),
        weights=weights,
        gang_rounds=gang_rounds,
        discard_unstable=discard_unstable,
    )
    return out.cpu().numpy()
