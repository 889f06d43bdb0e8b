"""Blocked greedy assignment on a device.

The counterpart of ``volcano_tpu/ops/blocked.py``.  There it is an XLA
program, not a Pallas kernel, so here it is torch ops on the caller's
device, with the same semantics and the same exactness invariant.  The
reference runs it for the sessions its Pallas kernel does not take; the
port's session kernel takes every session (its wide instance), so no
dispatch path runs this module: it stands beside the kernel as a second,
independent formulation of the pass.

  1. Per block of B tasks, one wide [B, N] feasibility + score pass at
     block-start state, the top-K candidate nodes of each task (by a
     stable sort, so the lowest indices win ties, as ``lax.top_k``
     takes them: ``torch.topk`` takes any, and a tied node outside at a
     lower index stops the block), and each task's best value and
     lowest index among the nodes NOT tracked ("outside"), all at
     block-start state.
  2. A B-step inner loop resolves the block task by task over only the
     M = B*K tracked slots.
  3. Every placement inside a block lands on a tracked node, so an
     untracked node keeps its block-start score: the tracked current max
     against the outside max decides exactly.  Where the outside value
     would win (higher, or equal at a lower node index), the block stops
     at that task; the host resolves that one task with a full-width
     step at current state and starts the next block after it.  The
     chosen sequence equals the plain scan's, lowest-index tie-break
     included, whatever nodes top-K tracked.

The reference's inner resolution is one ``lax.scan``, compiled into one
device loop.  Here the inner loop is a fixed B steps of torch ops whose
state freezes after the stop task, so a block needs one host sync (its
consumed count), and on a GPU each block and each full-width step is
captured once in a ``torch.cuda.CUDAGraph`` and replayed: eager, a step
is ~85 launches from the host.

Nothing here runs on the host in the device's place: every op runs on
the device of the packed planes, the caller's.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from volcano_tpu_torch.ops.kernels import (
    _feasibility_classes,
    as_tensor,
    DEFAULT_WEIGHTS,
    f32_lr_exact,
    gang_fixpoint,
    node_scores,
    resolve_device,
    ScoreWeights,
)
from volcano_tpu_torch.ops.packing import PackedSnapshot


def _block_scores(weights, tolerance, base, node_alloc, node_max_tasks,
                  used_ext, resreq_blk, class_feas_blk, active_blk):
    """[B, N] feasibility + masked scores at current state."""
    used = used_ext[:, :-1]
    count = used_ext[:, -1]
    idle = base - used
    scalar_lane = torch.arange(resreq_blk.shape[-1], device=resreq_blk.device) >= 2
    fit = (
        (resreq_blk[:, None, :] < idle[None, :, :] + tolerance[None, None, :])
        | (scalar_lane[None, None, :] & (resreq_blk[:, None, :] <= tolerance[None, None, :]))
    ).all(-1)
    feasible = fit & (count < node_max_tasks)[None, :] & class_feas_blk & active_blk[:, None]
    score = node_scores(resreq_blk, used, node_alloc, weights)
    return torch.where(feasible, score, -torch.inf)


def make_inner_step(tracked, base_t, alloc_t, maxt_t, tolerance, weights):
    """The per-task decision over a block's compact tracked slots.

    ``tracked`` [M] holds the slots' node ids, ascending among the real
    slots (duplicates and the dummy node are masked by the caller's
    ``static_ok``), so the first max position is also the lowest node
    index among maxima.  ``inner(U, stopped, resreq, resreq_ext, below,
    static_ok, out_max, out_fin, out_arg)`` adds the task to ``U`` [M,
    R+1] in place where it places and returns (chosen node or -1,
    consumed), both 0-d; ``stopped`` is ``~consumed`` of the task
    before.  ``below`` is the task's scalar lanes under tolerance (None
    at R = 2)."""

    def inner(U, stopped, resreq, resreq_ext, below, static_ok, out_max, out_fin, out_arg):
        u = U[:, :-1]
        cnt = U[:, -1]
        lane_ok = resreq < (base_t - u) + tolerance
        if below is not None:
            lane_ok = lane_ok | below
        feas = lane_ok.all(-1) & (cnt < maxt_t) & static_ok
        s = node_scores(resreq[None, :], u, alloc_t, weights)[0]
        s = torch.where(feas, s, -torch.inf)
        maxv, pos = s.max(0)  # first max: the lowest tracked node
        pos = pos.view(1)
        t_node = tracked.index_select(0, pos)[0]
        outside_better = out_fin & (
            (out_max > maxv) | ((out_max == maxv) & (out_arg < t_node))
        )
        consumed = ~stopped & ~outside_better
        place = consumed & (maxv > -torch.inf)
        U.index_add_(0, pos, (resreq_ext * place)[None, :])
        return torch.where(place, t_node, -1), consumed

    return inner


class _Graphed:
    """``fn()`` run eagerly at its first call, then captured once in a CUDA
    graph and replayed at every later call.  ``fn`` reads and writes only
    tensors that outlive the graph, so a replay repeats it on their
    current values."""

    def __init__(self, fn: Callable[[], None]):
        self.fn = fn
        self.graph: Optional[torch.cuda.CUDAGraph] = None

    def __call__(self) -> None:
        if self.graph is not None:
            self.graph.replay()
            return
        self.fn()  # the warm-up before capture, and this call's work
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.fn()
        self.graph = graph


def schedule_pass_blocked(
    task_resreq: torch.Tensor,  # [T, R] (padded by an extra block)
    task_job: torch.Tensor,  # [T]
    task_feas_class: torch.Tensor,  # [T]
    class_sel_bits: torch.Tensor,  # [C, W]
    class_tol_bits: torch.Tensor,  # [C, W]
    node_idle: torch.Tensor,  # [Nw, R]: the last row is a dummy node
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
    block_size: int = 64,
    top_k: int = 8,
    stats: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One greedy pass, block formulation → (chosen[T] i32,
    job_assigned[J]).

    On a CUDA device each block and each full-width step is replayed
    from a CUDA graph instead of launching its ops from the host.
    ``stats``, where given, gains the pass's ``blocks`` and ``stops``
    (each stop is resolved by one full-width step)."""
    T, R = task_resreq.shape
    Nw = node_idle.shape[0]
    dev = task_resreq.device
    B = block_size
    K = min(top_k, Nw)
    M = B * K
    SENTINEL = Nw - 1  # the dummy node row

    sel_ok = ((class_sel_bits[:, None, :] & ~node_label_bits[None, :, :]) == 0).all(-1)
    tol_ok = ((node_taint_bits[None, :, :] & ~class_tol_bits[:, None, :]) == 0).all(-1)
    class_feasible = sel_ok & tol_ok & node_ok[None, :]  # [C, Nw]

    base = node_idle + node_used
    used_ext = torch.cat([node_used, node_task_count.to(node_used.dtype)[:, None]], dim=1)
    chosen = torch.full((T,), -1, dtype=torch.int32, device=dev)
    scalar_lane = torch.arange(R, device=dev) >= 2
    ones = torch.ones((1,), dtype=task_resreq.dtype, device=dev)
    # tasks from the last active one on place nothing: the pass ends there
    live = torch.nonzero(active)
    n_live = int(live[-1]) + 1 if live.numel() else 0

    # what the host sets before a block or a full step, and reads after
    cursor = torch.zeros((1,), dtype=torch.int64, device=dev)
    n_consumed = torch.zeros((), dtype=torch.int64, device=dev)
    offsets = torch.arange(B, device=dev)

    def run_block() -> None:
        """Resolve up to B tasks from ``cursor``; ``n_consumed`` gets how
        many."""
        idx = cursor + offsets
        resreq_blk = task_resreq.index_select(0, idx)
        act_blk = active.index_select(0, idx)
        cf_blk = class_feasible.index_select(0, task_feas_class.index_select(0, idx))
        S = _block_scores(weights, tolerance, base, node_alloc, node_max_tasks,
                          used_ext, resreq_blk, cf_blk, act_blk)  # [B, Nw]

        top = torch.sort(S, dim=1, descending=True, stable=True).indices[:, :K]
        flat = top.reshape(-1).sort().values
        dup = torch.zeros(M, dtype=torch.bool, device=dev)
        dup[1:] = flat[1:] == flat[:-1]
        tracked = torch.where(dup, SENTINEL, flat)  # [M]: unique reals + sentinels
        in_tracked = torch.zeros(Nw, dtype=torch.bool, device=dev).index_fill_(0, tracked, True)
        out_max, out_arg = S.masked_fill(in_tracked[None, :], -torch.inf).max(1)
        out_fin = torch.isfinite(out_max)

        # compact tracked state; sentinel slots never place
        U = used_ext.index_select(0, tracked)  # [M, R+1]
        static_ok = (cf_blk.index_select(1, tracked) & act_blk[:, None]
                     & (tracked != SENTINEL)[None, :])  # [B, M]
        resreq_ext = torch.cat([resreq_blk, ones.expand(B, 1)], dim=1)
        below = scalar_lane & (resreq_blk <= tolerance) if R > 2 else None
        inner = make_inner_step(tracked, base.index_select(0, tracked),
                                node_alloc.index_select(0, tracked),
                                node_max_tasks.index_select(0, tracked), tolerance, weights)
        stopped = torch.zeros((), dtype=torch.bool, device=dev)
        picks, done = [], []
        for t in range(B):
            pick, consumed = inner(U, stopped, resreq_blk[t], resreq_ext[t],
                                   None if below is None else below[t], static_ok[t],
                                   out_max[t], out_fin[t], out_arg[t])
            stopped = ~consumed
            picks.append(pick)
            done.append(consumed)
        # write the compact state back (sentinel slots carry unchanged
        # copies of the dummy row, so duplicate writes agree)
        used_ext.index_copy_(0, tracked, U)
        consumed = torch.stack(done)
        picks = torch.stack(picks).to(torch.int32)  # -1 past the stop
        chosen.index_copy_(0, idx, torch.where(consumed, picks, chosen.index_select(0, idx)))
        n_consumed.copy_(consumed.sum())

    def full_step() -> None:
        """The task at ``cursor`` at full width, at current state."""
        resreq = task_resreq.index_select(0, cursor)  # [1, R]
        s = _block_scores(weights, tolerance, base, node_alloc, node_max_tasks, used_ext,
                          resreq, class_feasible.index_select(
                              0, task_feas_class.index_select(0, cursor)),
                          active.index_select(0, cursor))[0]
        maxv, best = s.max(0)  # first max: the lowest node index
        ok = maxv > -torch.inf
        best = best.view(1)
        used_ext.index_add_(0, best, (torch.cat([resreq[0], ones]) * ok)[None, :])
        chosen.index_copy_(0, cursor, torch.where(ok, best, -1).to(torch.int32))

    block_fn, full_fn = (_Graphed(run_block), _Graphed(full_step)) if dev.type == "cuda" else (
        run_block, full_step)
    at = blocks = stops = 0
    while at < n_live:
        cursor.fill_(at)
        block_fn()
        n = int(n_consumed)  # the block's one host sync
        blocks += 1
        at += n
        if n < B:
            # stopped before the block drained: resolve ONE task full-width
            cursor.fill_(at)
            full_fn()
            stops += 1
            at += 1
    if stats is not None:
        stats["blocks"] = stats.get("blocks", 0) + blocks
        stats["stops"] = stats.get("stops", 0) + stops
    # gang accounting post hoc: one segment sum
    job_assigned = torch.zeros_like(job_min_available).index_add_(
        0, task_job, (chosen >= 0).to(job_min_available.dtype)
    )
    return chosen, job_assigned


def task_block_padding(snap: PackedSnapshot, block_size: int):
    """(T_blk, pad_tasks): T_pad rounded to the block size plus one block
    of headroom, so a block that starts at any live task stays inside
    the padded planes."""
    B = block_size
    T_pad = snap.task_resreq.shape[0]
    T_blk = T_pad + (-T_pad) % B + B

    def pad_tasks(arr, fill=0):
        out = np.full((T_blk, *arr.shape[1:]), fill, dtype=arr.dtype)
        out[:T_pad] = arr
        return out

    return T_blk, pad_tasks


def prepare_blocked_arrays(snap: PackedSnapshot, block_size: int = 64):
    """Host-side array prep: one dummy node row + task padding to block
    size → (arrays, T_blk)."""
    T_blk, pad_tasks = task_block_padding(snap, block_size)

    task_feas_class, class_sel, class_tol = _feasibility_classes(snap)

    # one guaranteed-infeasible dummy node row at the end (the sentinel)
    def pad_nodes(arr, fill=0):
        out = np.full((arr.shape[0] + 1, *arr.shape[1:]), fill, dtype=arr.dtype)
        out[:-1] = arr
        return out

    arrays = dict(
        task_resreq=pad_tasks(snap.task_resreq),
        task_job=pad_tasks(snap.task_job),
        task_feas_class=pad_tasks(task_feas_class),
        class_sel_bits=class_sel,
        class_tol_bits=class_tol,
        node_idle=pad_nodes(snap.node_idle),
        node_used=pad_nodes(snap.node_used),
        node_alloc=pad_nodes(snap.node_alloc),
        node_label_bits=pad_nodes(snap.node_label_bits),
        node_taint_bits=pad_nodes(snap.node_taint_bits),
        node_ok=pad_nodes(snap.node_ok, fill=False),
        node_task_count=pad_nodes(snap.node_task_count),
        node_max_tasks=pad_nodes(snap.node_max_tasks),
        job_min_available=snap.job_min_available,
        tolerance=snap.tolerance,
    )
    return arrays, T_blk


#: schedule_pass_blocked's operands, in order, from prepare_blocked_arrays
_PASS_ARRAYS = (
    "task_resreq", "task_job", "task_feas_class", "class_sel_bits", "class_tol_bits",
    "node_idle", "node_used", "node_alloc", "node_label_bits", "node_taint_bits", "node_ok",
    "node_task_count", "node_max_tasks", "job_min_available", "tolerance",
)


def run_packed_blocked(
    snap: PackedSnapshot,
    weights: ScoreWeights = DEFAULT_WEIGHTS,
    gang_rounds: int = 3,
    block_size: int = 64,
    top_k: int = 8,
    discard_unstable: bool = False,
    device: Optional[Union[str, torch.device]] = None,
    stats: Optional[dict] = None,
) -> np.ndarray:
    """PackedSnapshot → assignment[n_tasks] (np.int32) through the blocked
    pass, with the adaptive gang fixpoint of ``kernels.run_packed``.
    Runs on ``cuda`` unless ``device`` names another device.  ``stats``,
    where given, gains the session's ``blocks``, ``stops`` and
    ``passes``."""
    dev = resolve_device(device)
    if not f32_lr_exact(snap):
        weights = weights._replace(lr_int_exact=True)

    arrays, T_blk = prepare_blocked_arrays(snap, block_size)
    planes = [as_tensor(arrays[k], dev) for k in _PASS_ARRAYS]

    def run_pass(active: np.ndarray):
        chosen, job_assigned = schedule_pass_blocked(
            *planes, torch.from_numpy(active).to(dev), weights=weights,
            block_size=block_size, top_k=top_k, stats=stats,
        )
        if stats is not None:
            stats["passes"] = stats.get("passes", 0) + 1
        return chosen.cpu().numpy(), job_assigned.cpu().numpy()

    return gang_fixpoint(run_pass, arrays["task_job"], snap.job_min_available,
                         snap.job_ready_count, snap.n_tasks, T_blk, gang_rounds,
                         discard_unstable=discard_unstable)
