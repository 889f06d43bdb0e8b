"""Node-sharded blocked greedy assignment.

The counterpart of ``volcano_tpu/ops/sharded.py``.  There it is one XLA
program under ``shard_map`` over a device mesh, not a Pallas kernel, so
here it is torch ops, with the same semantics and the same exactness
invariant as the blocked pass (ops/blocked.py), whose own pieces it
calls (``_block_scores``, ``make_inner_step``, ``task_block_padding``,
``_Graphed``), so the two cannot drift apart.

One process drives every shard, as the reference's one controller
drives its mesh: shard ``s`` lives on ``devices[s]``, and entries may
repeat, so several shards can share one card (or the CPU).  The node
axis is cut into ``n`` equal shards, each with one trailing infeasible
dummy row.  Per block of B tasks:

  1. Each shard scores its local nodes at block-start state, keeps its
     top-K candidates per task (by a stable sort, so the lowest local
     rows win ties, as ``lax.top_k`` takes them) and, per task, the best
     value and lowest global id outside those candidates.
  2. Each shard packs its candidates into one flat int32 buffer: global
     ids, used and count rows, base, alloc, max tasks, the
     class-feasibility columns and the outside pairs (f32 planes by
     their bits).  The gather is one copy of that buffer into a row of
     a [n, L] buffer on ``devices[0]`` (a peer copy between GPUs, none
     where the shard already lives there).
  3. On ``devices[0]`` the slots are sorted by global node id (a stable
     sort, dummies last) and the block is resolved task by task with the
     blocked pass's inner step; dummy and duplicate slots are off in its
     ``static_ok`` mask.
  4. Each shard takes back the rows it owns from (ids, used) of the
     resolved slots.
  5. Where an untracked node would win, the block stops; that task is
     resolved at full width: each shard's best (first maximum, so the
     lowest local row), then on ``devices[0]`` the first maximum over
     the shards (the lowest shard among equal maxima), applied by the
     owning shard.

Every shard half and the replicated scan is captured once in a
``torch.cuda.CUDAGraph`` on its device and replayed; a block needs one
host sync (its consumed count).  Nothing falls back: a failure raises.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from volcano_tpu_torch.ops.blocked import (
    _block_scores,
    _Graphed,
    make_inner_step,
    task_block_padding,
)
from volcano_tpu_torch.ops.kernels import (
    _feasibility_classes,
    as_tensor,
    DEFAULT_WEIGHTS,
    f32_lr_exact,
    gang_fixpoint,
    ScoreWeights,
)
from volcano_tpu_torch.ops.packing import PackedSnapshot

INT_BIG = 2**31 - 1

Device = Union[str, torch.device]


def resolve_devices(devices: Optional[Sequence[Device]] = None) -> List[torch.device]:
    """One device per shard: by default every visible CUDA device.  With
    no GPU and no devices named this raises, as ``resolve_device`` does,
    rather than quietly running on the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass devices=['cpu', ...] to run the shards on the CPU"
            )
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    if not out:
        raise ValueError("run_packed_sharded needs at least one device")
    return out


def _launcher(dev: torch.device, fn: Callable[[], None]) -> Callable[[], None]:
    """``fn`` replayed from a CUDA graph captured on ``dev``; run eagerly
    on any other device."""
    if dev.type != "cuda":
        return fn
    graphed = _Graphed(fn)

    def run() -> None:
        with torch.cuda.device(dev):
            graphed()

    return run


class _Layout:
    """Offsets of the fields of one shard's candidate pack (int32)."""

    def __init__(self, B: int, M: int, R: int):
        self.span: Dict[str, tuple] = {}
        at = 0
        for name, size in (("ids", M), ("used", M * (R + 1)), ("base", M * R),
                           ("alloc", M * R), ("maxt", M), ("tf", B * M),
                           ("out_max", B), ("out_arg", B)):
            self.span[name] = (at, at + size)
            at += size
        self.size = at


class _Tasks:
    """The task planes and the pass's cursor on one device."""

    def __init__(self, dev, task_resreq, task_feas_class, class_sel_bits, class_tol_bits,
                 tolerance, B):
        self.dev = dev
        self.resreq = as_tensor(task_resreq, dev)
        self.feas_class = as_tensor(task_feas_class, dev).long()
        self.class_sel = as_tensor(class_sel_bits, dev)
        self.class_tol = as_tensor(class_tol_bits, dev)
        self.tolerance = as_tensor(tolerance, dev)
        self.active = torch.zeros(task_resreq.shape[0], dtype=torch.bool, device=dev)
        self.cursor = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.offsets = torch.arange(B, device=dev)
        self.ones = torch.ones((1,), dtype=self.resreq.dtype, device=dev)


class _Shard:
    """One shard's planes on its device, and its halves of a block and
    of a full-width step."""

    def __init__(self, s: int, n_loc: int, node: Dict[str, np.ndarray], tasks: _Tasks,
                 weights: ScoreWeights, B: int, K: int, layout: _Layout):
        dev = tasks.dev
        self.s, self.n_loc, self.tasks, self.weights = s, n_loc, tasks, weights
        self.B, self.K, self.layout = B, K, layout
        t = {k: as_tensor(v, dev) for k, v in node.items()}
        sel_ok = ((tasks.class_sel[:, None, :] & ~t["node_label_bits"][None, :, :]) == 0).all(-1)
        tol_ok = ((t["node_taint_bits"][None, :, :] & ~tasks.class_tol[:, None, :]) == 0).all(-1)
        self.class_feasible = sel_ok & tol_ok & t["node_ok"][None, :]  # [C, n_loc + 1]
        self.base = t["node_idle"] + t["node_used"]
        self.alloc = t["node_alloc"]
        self.maxt = t["node_max_tasks"]
        self.used_ext0 = torch.cat(
            [t["node_used"], t["node_task_count"].to(t["node_used"].dtype)[:, None]], dim=1)
        self.used_ext = self.used_ext0.clone()
        # what the replicated side reads and writes: set by the owner to
        # views of its own buffers where the shard lives on its device
        self.pack = torch.zeros(layout.size, dtype=torch.int32, device=dev)
        self.best = torch.zeros(2, dtype=torch.int32, device=dev)  # (score bits, global id)
        self.best_local = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.wb: Optional[torch.Tensor] = None  # [M_g, R + 2]: (global id, used row bits)
        self.win: Optional[torch.Tensor] = None  # [2]: (winner shard, ok)

    def to_global(self, local: torch.Tensor) -> torch.Tensor:
        """Local row → true global node id (the dummy → INT_BIG)."""
        return torch.where(local >= self.n_loc, INT_BIG,
                           self.s * self.n_loc + local).to(torch.int32)

    def _put(self, name: str, x: torch.Tensor) -> None:
        a, b = self.layout.span[name]
        self.pack[a:b].copy_(x.reshape(-1))

    def score_block(self) -> None:
        """Local top-K candidates and outside pairs of the block at
        ``cursor``, packed into ``pack``."""
        tk, n_loc1 = self.tasks, self.n_loc + 1
        idx = tk.cursor + tk.offsets
        resreq_blk = tk.resreq.index_select(0, idx)
        act_blk = tk.active.index_select(0, idx)
        cf_blk = self.class_feasible.index_select(0, tk.feas_class.index_select(0, idx))
        S = _block_scores(self.weights, tk.tolerance, self.base, self.alloc, self.maxt,
                          self.used_ext, resreq_blk, cf_blk, act_blk)  # [B, n_loc + 1]
        top = torch.sort(S, dim=1, descending=True, stable=True).indices[:, :self.K]
        flat = top.reshape(-1).sort().values
        dup = torch.zeros(flat.shape[0], dtype=torch.bool, device=flat.device)
        dup[1:] = flat[1:] == flat[:-1]
        tracked = torch.where(dup, self.n_loc, flat)  # [M]: unique rows + dummies
        in_tracked = torch.zeros(n_loc1, dtype=torch.bool, device=flat.device).index_fill_(
            0, tracked, True)
        out_max, out_arg = S.masked_fill(in_tracked[None, :], -torch.inf).max(1)
        self._put("ids", self.to_global(tracked))
        self._put("used", self.used_ext.index_select(0, tracked).view(torch.int32))
        self._put("base", self.base.index_select(0, tracked).view(torch.int32))
        self._put("alloc", self.alloc.index_select(0, tracked).view(torch.int32))
        self._put("maxt", self.maxt.index_select(0, tracked))
        self._put("tf", cf_blk.index_select(1, tracked))
        self._put("out_max", out_max.view(torch.int32))
        self._put("out_arg", self.to_global(out_arg))

    def writeback(self) -> None:
        """Take back the resolved slots' rows this shard owns."""
        tracked = self.wb[:, 0]
        U = self.wb[:, 1:].view(torch.float32)
        lo = self.s * self.n_loc
        own = (tracked >= lo) & (tracked < lo + self.n_loc)
        target = torch.where(own, tracked - lo, self.n_loc).long()
        # rows not owned all target the dummy and carry its unchanged row
        self.used_ext.index_copy_(0, target, torch.where(
            own[:, None], U, self.used_ext.index_select(0, target)))

    def full_best(self) -> None:
        """This shard's best node for the task at ``cursor``, at current
        state: its first maximum, so the lowest local row."""
        tk = self.tasks
        resreq = tk.resreq.index_select(0, tk.cursor)  # [1, R]
        s = _block_scores(self.weights, tk.tolerance, self.base, self.alloc, self.maxt,
                          self.used_ext, resreq, self.class_feasible.index_select(
                              0, tk.feas_class.index_select(0, tk.cursor)),
                          tk.active.index_select(0, tk.cursor))[0]
        maxv, best = s.max(0)
        self.best_local.copy_(best.view(1))
        self.best.copy_(torch.cat([maxv.view(1).view(torch.int32), self.to_global(best.view(1))]))

    def full_apply(self) -> None:
        """Place the task at ``cursor`` where this shard won the step."""
        tk = self.tasks
        mine = (self.win[0] == self.s) & (self.win[1] != 0)
        delta = torch.cat([tk.resreq.index_select(0, tk.cursor)[0], tk.ones])
        self.used_ext.index_add_(0, self.best_local, (delta * mine)[None, :])


class _ShardedPass:
    """The planes of one session placed on the shards' devices, and one
    greedy pass over them per call: ``(active) → (chosen[T] global node
    ids, job_assigned[J])``, both on ``devices[0]``."""

    def __init__(self, devices: List[torch.device], arrays: Dict[str, np.ndarray],
                 weights: ScoreWeights, block_size: int, top_k: int):
        n = len(devices)
        n_loc = arrays["node_idle"].shape[0] // n - 1
        R = arrays["task_resreq"].shape[1]
        B = block_size
        K = min(top_k, n_loc + 1)  # a small shard tracks at most what it owns
        M = B * K
        self.n, self.B, self.M, self.R = n, B, M, R
        self.layout = layout = _Layout(B, M, R)
        self.dev0 = dev0 = devices[0]
        self.weights = weights

        self.tasks: Dict[torch.device, _Tasks] = {}
        for d in devices:
            if d not in self.tasks:
                self.tasks[d] = _Tasks(d, arrays["task_resreq"], arrays["task_feas_class"],
                                       arrays["class_sel_bits"], arrays["class_tol_bits"],
                                       arrays["tolerance"], B)
        tk0 = self.tasks[dev0]
        self.task_job = as_tensor(arrays["task_job"], dev0).long()
        self.job_min_available = as_tensor(arrays["job_min_available"], dev0)
        self.chosen = torch.full((arrays["task_resreq"].shape[0],), -1, dtype=torch.int32,
                                 device=dev0)
        self.n_consumed = torch.zeros((), dtype=torch.int64, device=dev0)
        self.gbuf = torch.zeros((n, layout.size), dtype=torch.int32, device=dev0)
        self.gbest = torch.zeros((n, 2), dtype=torch.int32, device=dev0)
        self.wb = torch.zeros((n * M, R + 2), dtype=torch.int32, device=dev0)
        self.win = torch.zeros(2, dtype=torch.int32, device=dev0)
        # the writeback slots and the winner, mirrored once per other device
        self.mirrors = {d: (torch.zeros_like(self.wb, device=d),
                            torch.zeros_like(self.win, device=d))
                        for d in self.tasks if d != dev0}

        w = n_loc + 1
        self.shards: List[_Shard] = []
        for s, d in enumerate(devices):
            node = {k: arrays[k][s * w:(s + 1) * w] for k in _NODE_ARRAYS}
            sh = _Shard(s, n_loc, node, self.tasks[d], weights, B, K, layout)
            if d == dev0:  # the shard writes its halves straight into the gather rows
                sh.pack, sh.best = self.gbuf[s], self.gbest[s]
                sh.wb, sh.win = self.wb, self.win
            else:
                sh.wb, sh.win = self.mirrors[d]
            self.shards.append(sh)
        self._tk0 = tk0
        self.score_fns = [_launcher(sh.tasks.dev, sh.score_block) for sh in self.shards]
        self.writeback_fns = [_launcher(sh.tasks.dev, sh.writeback) for sh in self.shards]
        self.best_fns = [_launcher(sh.tasks.dev, sh.full_best) for sh in self.shards]
        self.apply_fns = [_launcher(sh.tasks.dev, sh.full_apply) for sh in self.shards]
        self.scan_fn = _launcher(dev0, self.scan)
        self.decide_fn = _launcher(dev0, self.decide)
        #: bytes each block gathers onto devices[0]
        self.gather_bytes = n * layout.size * 4

    def _field(self, name: str) -> torch.Tensor:
        a, b = self.layout.span[name]
        return self.gbuf[:, a:b]

    def scan(self) -> None:
        """The replicated scan over the gathered slots of the block at
        ``cursor``: chosen, the consumed count, and the slots' rows for
        the writeback."""
        n, B, M, R = self.n, self.B, self.M, self.R
        tk = self._tk0
        idx = tk.cursor + tk.offsets
        resreq_blk = tk.resreq.index_select(0, idx)
        act_blk = tk.active.index_select(0, idx)

        ids_g = self._field("ids").reshape(-1)
        U_g = self._field("used").reshape(n * M, R + 1).view(torch.float32)
        base_g = self._field("base").reshape(n * M, R).view(torch.float32)
        alloc_g = self._field("alloc").reshape(n * M, R).view(torch.float32)
        maxt_g = self._field("maxt").reshape(-1)
        tf_g = self._field("tf").reshape(n, B, M).permute(1, 0, 2).reshape(B, n * M) != 0
        out_max_all = self._field("out_max").view(torch.float32)  # [n, B]
        out_arg_all = self._field("out_arg")
        # the global outside: max value, lowest global id among shard maxima
        out_max = out_max_all.max(0).values
        out_arg = torch.where(out_max_all == out_max[None, :], out_arg_all, INT_BIG).min(0).values
        out_fin = torch.isfinite(out_max)

        # slots by global id (dummies, INT_BIG, last): the first max is the
        # lowest global node index among maxima
        tracked, perm = torch.sort(ids_g, stable=True)
        U = U_g.index_select(0, perm)
        static_ok = tf_g.index_select(1, perm) & act_blk[:, None] & (tracked != INT_BIG)[None, :]
        resreq_ext = torch.cat([resreq_blk, tk.ones.expand(B, 1)], dim=1)
        below = (torch.arange(R, device=tk.dev) >= 2) & (resreq_blk <= tk.tolerance) \
            if R > 2 else None
        inner = make_inner_step(tracked, base_g.index_select(0, perm),
                                alloc_g.index_select(0, perm), maxt_g.index_select(0, perm),
                                tk.tolerance, self.weights)
        stopped = torch.zeros((), dtype=torch.bool, device=tk.dev)
        picks, done = [], []
        for t in range(B):
            pick, consumed = inner(U, stopped, resreq_blk[t], resreq_ext[t],
                                   None if below is None else below[t], static_ok[t],
                                   out_max[t], out_fin[t], out_arg[t])
            stopped = ~consumed
            picks.append(pick)
            done.append(consumed)
        consumed = torch.stack(done)
        picks = torch.stack(picks).to(torch.int32)  # -1 past the stop
        self.chosen.index_copy_(0, idx, torch.where(consumed, picks,
                                                    self.chosen.index_select(0, idx)))
        self.n_consumed.copy_(consumed.sum())
        self.wb[:, 0].copy_(tracked)
        self.wb[:, 1:].copy_(U.view(torch.int32))

    def decide(self) -> None:
        """The full-width step's winner: the first maximum over the shards'
        bests, so the lowest shard among equal maxima."""
        tk = self._tk0
        scores = self.gbest[:, 0].view(torch.float32)
        maxv, winner = scores.max(0)
        ok = torch.isfinite(maxv)
        self.win.copy_(torch.stack([winner.to(torch.int32), ok.to(torch.int32)]))
        node = self.gbest[:, 1].index_select(0, winner.view(1))
        self.chosen.index_copy_(0, tk.cursor, torch.where(ok, node, -1).to(torch.int32))

    def _gather(self, bufs: List[torch.Tensor], into: torch.Tensor) -> None:
        for s, sh in enumerate(self.shards):
            if sh.tasks.dev != self.dev0:
                into[s].copy_(bufs[s], non_blocking=True)

    def _mirror(self, which: int) -> None:
        src = (self.wb, self.win)[which]
        for bufs in self.mirrors.values():
            bufs[which].copy_(src, non_blocking=True)

    def _set_cursor(self, at: int) -> None:
        for tk in self.tasks.values():
            tk.cursor.fill_(at)

    def __call__(self, active: np.ndarray, stats: Optional[dict] = None):
        for tk in self.tasks.values():
            tk.active.copy_(torch.from_numpy(active))
        for sh in self.shards:
            sh.used_ext.copy_(sh.used_ext0)
        self.chosen.fill_(-1)
        live = np.flatnonzero(active)
        n_live = int(live[-1]) + 1 if live.size else 0
        at = blocks = stops = 0
        while at < n_live:
            self._set_cursor(at)
            for fn in self.score_fns:
                fn()
            self._gather([sh.pack for sh in self.shards], self.gbuf)
            self.scan_fn()
            self._mirror(0)
            for fn in self.writeback_fns:
                fn()
            n = int(self.n_consumed)  # the block's one host sync
            blocks += 1
            at += n
            if n < self.B:
                # stopped before the block drained: resolve ONE task full-width
                self._set_cursor(at)
                for fn in self.best_fns:
                    fn()
                self._gather([sh.best for sh in self.shards], self.gbest)
                self.decide_fn()
                self._mirror(1)
                for fn in self.apply_fns:
                    fn()
                stops += 1
                at += 1
        if stats is not None:
            stats["blocks"] = stats.get("blocks", 0) + blocks
            stats["stops"] = stats.get("stops", 0) + stops
            stats["gather_bytes_per_block"] = self.gather_bytes
        job_assigned = torch.zeros_like(self.job_min_available).index_add_(
            0, self.task_job, (self.chosen >= 0).to(self.job_min_available.dtype))
        return self.chosen.clone(), job_assigned


#: the node-axis planes, split across the shards
_NODE_ARRAYS = ("node_idle", "node_used", "node_alloc", "node_label_bits", "node_taint_bits",
                "node_ok", "node_task_count", "node_max_tasks")


def make_sharded_session(
    devices: Sequence[Device],
    weights: ScoreWeights = DEFAULT_WEIGHTS,
    block_size: int = 64,
    top_k: int = 8,
):
    """Build the node-sharded blocked pass over ``devices`` (one shard
    each).  Returns ``fn(arrays)``: ``arrays`` holds the task, class and
    job planes and the node planes in the sharded layout of
    ``_shard_nodes_with_dummies``; ``fn`` splits the node planes across
    the devices and puts the task planes on each device ONCE, and
    returns ``run(active, stats=None) → (chosen global node ids,
    job_assigned)`` on ``devices[0]``; only ``active`` changes between
    gang rounds."""
    devs = resolve_devices(devices)

    def place(arrays: Dict[str, np.ndarray]) -> _ShardedPass:
        return _ShardedPass(devs, arrays, weights, block_size, top_k)

    return place


def _shard_nodes_with_dummies(snap: PackedSnapshot, n_dev: int):
    """Rearrange node arrays into n_dev chunks of n_loc real rows + one
    trailing infeasible dummy row each → global width n_dev*(n_loc+1).
    Global id mapping: (shard s, local i) ↔ true node s*n_loc + i."""
    N_pad = snap.node_idle.shape[0]
    if N_pad % n_dev:
        raise ValueError(
            f"padded node count {N_pad} not divisible by mesh size {n_dev}"
        )
    n_loc = N_pad // n_dev

    def rearrange(arr, fill=0):
        shaped = arr.reshape(n_dev, n_loc, *arr.shape[1:])
        dummy = np.full((n_dev, 1, *arr.shape[1:]), fill, dtype=arr.dtype)
        return np.concatenate([shaped, dummy], axis=1).reshape(
            n_dev * (n_loc + 1), *arr.shape[1:]
        )

    return {
        "node_idle": rearrange(snap.node_idle),
        "node_used": rearrange(snap.node_used),
        "node_alloc": rearrange(snap.node_alloc),
        "node_label_bits": rearrange(snap.node_label_bits),
        "node_taint_bits": rearrange(snap.node_taint_bits),
        "node_ok": rearrange(snap.node_ok, fill=False),
        "node_task_count": rearrange(snap.node_task_count),
        "node_max_tasks": rearrange(snap.node_max_tasks),
    }, n_loc


def run_packed_sharded(
    snap: PackedSnapshot,
    devices: Optional[Sequence[Device]] = None,
    weights: ScoreWeights = DEFAULT_WEIGHTS,
    gang_rounds: int = 3,
    block_size: int = 64,
    top_k: int = 8,
    discard_unstable: bool = False,
    stats: Optional[dict] = None,
) -> np.ndarray:
    """PackedSnapshot → assignment[n_tasks] (np.int32) over one shard per
    entry of ``devices`` (default: every visible CUDA device), with the
    adaptive gang fixpoint of ``run_packed_blocked`` around the sharded
    blocked pass.  ``stats``, where given, gains the session's
    ``blocks``, ``stops``, ``passes`` and ``gather_bytes_per_block``."""
    devs = resolve_devices(devices)
    if not f32_lr_exact(snap):
        weights = weights._replace(lr_int_exact=True)

    task_feas_class, class_sel, class_tol = _feasibility_classes(snap)
    node_arrays, _ = _shard_nodes_with_dummies(snap, len(devs))

    T_blk, pad_tasks = task_block_padding(snap, block_size)
    task_job = pad_tasks(snap.task_job)

    run_pass = make_sharded_session(devs, weights=weights, block_size=block_size,
                                    top_k=top_k)(dict(
        task_resreq=pad_tasks(snap.task_resreq),
        task_job=task_job,
        task_feas_class=pad_tasks(task_feas_class),
        class_sel_bits=class_sel,
        class_tol_bits=class_tol,
        job_min_available=snap.job_min_available,
        tolerance=snap.tolerance,
        **node_arrays,
    ))

    def one_pass(active: np.ndarray):
        chosen, job_assigned = run_pass(active, stats)
        if stats is not None:
            stats["passes"] = stats.get("passes", 0) + 1
        return chosen.cpu().numpy(), job_assigned.cpu().numpy()

    return gang_fixpoint(one_pass, task_job, snap.job_min_available, snap.job_ready_count,
                         snap.n_tasks, T_blk, gang_rounds, discard_unstable=discard_unstable)
