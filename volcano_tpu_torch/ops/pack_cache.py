"""PackCache — cycle-persistent delta packing for the device session.

A copy of ``volcano_tpu/ops/pack_cache.py``.  The scheduler runs a
cycle over a cache that changes *incrementally* between cycles, yet
``pack_session`` redoes the full O(tasks + nodes) Python marshaling
every cycle.  This module keeps the assembled planes — and the
label/taint bit registries — alive across cycles and rebuilds only what
the cache's event handlers dirtied:

  * task rows re-pack only for tasks whose POD SPEC changed
    (``cache._task_pack_relevant_changed``); bind/unbind churn
    re-derives node accounting but leaves task rows cached.  Reordering
    is a vectorized gather over the previous arrays, never a Python
    re-pack.
  * node rows split static (label/taint bitsets, allocatable, max
    tasks) from dynamic (idle/used/task count/ok): a warm cycle
    re-packs only dirty nodes and ships only those rows
    (``PackedSnapshot.delta`` → the device-side ``index_copy_`` of
    ops/device_stage.py).
  * the bit registries are append-only and persistent, which makes the
    equivalence contract testable: a warm pack must be BIT-IDENTICAL to
    a cold ``pack_session`` seeded with the same registries.

Wholesale invalidation (everything rebuilt, registries kept): node set
or ready-set change (topology revision / node list mismatch), resource
axis change, ``enforce_pod_count`` flip (plugin-set change), or an
out-of-order epoch (a newer session already consumed the dirty sets).
A task-bucket change rebuilds the task planes only (``mode`` micro).

Cross-pass couplings the delta path preserves (each mirrors a cold-pack
ordering guarantee):

  * a NEW label pair registered by a dirty task's selector must set the
    bit on every (clean) node carrying that label — an inverted
    label→node index back-patches those rows;
  * a NEW taint pair registered by a dirty node must reach clean tasks
    with keyed-Exists tolerations — those rows are re-resolved (the
    resolution only ORs bits in, so no re-pack is needed).

Single-threaded by design: one pack per cache at a time, from the
scheduler loop.  The assembled snapshot is always fully materialized on
the host, so every consumer sees exactly what a cold pack would give.
"""

from __future__ import annotations

import time
import uuid
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from volcano_tpu_torch.ops.packing import (
    _bucket,
    _resource_axis,
    alloc_planes,
    BitRegistry,
    DEFAULT_BIT_WORDS,
    MIB,
    pack_node_row,
    pack_session,
    pack_task_bits,
    PackedSnapshot,
    resolve_exists_tolerations,
    task_exists_tolerations,
    task_lane_row,
)
from volcano_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

#: planes rebuilt per task row
TASK_PLANES = (
    "task_resreq",
    "task_job",
    "task_sel_bits",
    "task_tol_bits",
    "task_has_preferences",
    "task_needs_host",
)

#: node planes that change with scheduling activity (re-shipped per delta)
NODE_DYNAMIC_PLANES = ("node_idle", "node_used", "node_task_count", "node_ok")

#: node planes that change only on node-object updates (usually resident)
NODE_STATIC_PLANES = (
    "node_alloc",
    "node_label_bits",
    "node_taint_bits",
    "node_max_tasks",
)

JOB_PLANES = ("job_min_available", "job_ready_count")


class PackDelta:
    """Per-plane change set of one pack vs the immediately previous one
    (``base_rev = snap.rev - 1``).  ``planes[name]`` is an int array of
    changed row indices, or None when the plane changed wholesale
    (reshape / reorder / rebuild); planes absent from the dict are
    byte-identical to the previous pack."""

    __slots__ = ("base_rev", "planes")

    def __init__(self, base_rev: int, planes: Dict[str, Optional[np.ndarray]]):
        self.base_rev = base_rev
        self.planes = planes


class PackCache:
    def __init__(self, cache=None, bit_words: int = DEFAULT_BIT_WORDS):
        self.cache = cache
        self.key = uuid.uuid4().hex[:12]  # det: session identity, not replay-visible
        self.label_reg = BitRegistry(bit_words)
        self.taint_reg = BitRegistry(bit_words)
        self.rev = 0
        self._consumed_rev = -1
        self._topo_rev = -1
        self._snap: Optional[PackedSnapshot] = None
        self._task_uids: List[str] = []
        self._task_pos: Dict[str, int] = {}
        self._task_jobs: List[str] = []  # job uid per task row
        self._node_names: List[str] = []
        self._node_pos: Dict[str, int] = {}
        self._node_label_pairs: List[Tuple] = []  # registered pairs per row
        self._label_to_nodes: Dict[Tuple, set] = {}
        self._job_uids: List[str] = []
        self._task_mem_ok: Optional[np.ndarray] = None
        self._node_mem_static_ok: Optional[np.ndarray] = None  # alloc lanes
        self._node_mem_dyn_ok: Optional[np.ndarray] = None  # idle/used lanes
        self._exists_uids: set = set()
        self._enforce_prev: Optional[bool] = None
        self._names_prev: Optional[List[str]] = None
        #: node-phase staging handoff (begin_nodes → pack)
        self._pending_nodes = None
        #: bench/diagnostics: how the last pack ran
        self.last_stats: Dict[str, object] = {}

    # ---- helpers ----

    def _alloc_snap(self, names, tol, T, N, J) -> PackedSnapshot:
        snap = PackedSnapshot()
        snap.resource_names = list(names)
        snap.tolerance = tol
        alloc_planes(
            snap, len(names), self.label_reg.words, T, N, J,
            _bucket(T), _bucket(N), _bucket(J, minimum=16),
        )
        return snap

    def _repack_task_row(self, snap: PackedSnapshot, i: int, t) -> None:
        names = snap.resource_names
        if not task_lane_row(t, names, snap.task_resreq[i]):
            self._task_mem_ok[i] = False
        if pack_task_bits(snap, i, t, self.label_reg, self.taint_reg):
            snap.task_needs_host[i] = True
        if t.pod is not None and t.pod.spec.tolerations:
            if task_exists_tolerations(t):
                self._exists_uids.add(t.uid)
            else:
                self._exists_uids.discard(t.uid)
        else:
            self._exists_uids.discard(t.uid)

    def _lane_rows(self, holder, nodes, rows, idx, field_name, arr, mem_ok):
        """Bulk lane refill for a subset of node rows — the exact float
        op sequence of the cold bulk extraction (elementwise identical
        on any subset)."""
        names = holder.resource_names
        R = len(names)
        res_list = [getattr(nodes[i], field_name) for i in rows]
        arr[idx, 0] = [r.milli_cpu for r in res_list]
        mem = np.array([r.memory for r in res_list], dtype=np.float64)
        mem_ok[idx] &= (mem % MIB) == 0
        arr[idx, 1] = mem / MIB
        if R > 2:
            for i, r in zip(rows, res_list):
                if r.scalars:
                    for k, name in enumerate(names[2:], start=2):
                        arr[i, k] = r.scalars.get(name, 0.0)

    def _repack_node_rows(
        self,
        holder: PackedSnapshot,
        nodes,
        full_rows: List[int],
        dyn_rows: List[int],
        enforce: bool,
    ) -> None:
        """Re-pack dirty node rows.  ``dyn_rows`` (bind/evict/pod churn)
        refresh only the dynamic planes — idle/used lanes, task count,
        ok flag; their static rows (label/taint bits, allocatable, max
        tasks) are provably unchanged, since no event can alter a node
        OBJECT without landing the node in ``full_rows`` instead.  Full
        rows re-derive everything, including the label→node inverted
        index used for new-pair back-patching."""
        all_rows = sorted(set(full_rows) | set(dyn_rows))
        if not all_rows:
            return
        idx_all = np.asarray(all_rows, dtype=np.int64)
        # dynamic planes, every dirty row
        holder.node_idle[idx_all] = 0
        holder.node_used[idx_all] = 0
        self._node_mem_dyn_ok[idx_all] = True
        self._lane_rows(
            holder, nodes, all_rows, idx_all, "idle", holder.node_idle,
            self._node_mem_dyn_ok,
        )
        self._lane_rows(
            holder, nodes, all_rows, idx_all, "used", holder.node_used,
            self._node_mem_dyn_ok,
        )
        holder.node_task_count[idx_all] = [len(nodes[i].tasks) for i in all_rows]
        holder.node_ok[idx_all] = [
            nodes[i].ready()
            and not (nodes[i].node is not None and nodes[i].node.spec.unschedulable)
            for i in all_rows
        ]
        # static planes, full rows only
        if not full_rows:
            return
        full_rows = sorted(full_rows)
        idx_full = np.asarray(full_rows, dtype=np.int64)
        holder.node_alloc[idx_full] = 0
        holder.node_label_bits[idx_full] = 0
        holder.node_taint_bits[idx_full] = 0
        self._node_mem_static_ok[idx_full] = True
        self._lane_rows(
            holder, nodes, full_rows, idx_full, "allocatable",
            holder.node_alloc, self._node_mem_static_ok,
        )
        for i in full_rows:
            n = nodes[i]
            # re-derives ok/count too (same values as above) plus the
            # bit planes and max-task row — the shared cold-pack helper
            pack_node_row(holder, i, n, self.label_reg, self.taint_reg, enforce)
            old_pairs = (
                self._node_label_pairs[i] if i < len(self._node_label_pairs) else ()
            )
            new_pairs = (
                tuple((k, v) for k, v in (n.node.metadata.labels or {}).items())
                if n.node is not None
                else ()
            )
            if old_pairs != new_pairs:
                for p in old_pairs:
                    s = self._label_to_nodes.get(p)
                    if s is not None:
                        s.discard(i)
                for p in new_pairs:
                    self._label_to_nodes.setdefault(p, set()).add(i)
                while len(self._node_label_pairs) <= i:
                    self._node_label_pairs.append(())
                self._node_label_pairs[i] = new_pairs

    # ---- cold assembly (also the wholesale-invalidation path) ----

    def _cold(self, tasks, jobs, nodes, epoch, enforce_pod_count) -> PackedSnapshot:
        t0 = time.perf_counter()
        # every cached row is about to be rebuilt, so the registries can
        # restart from the CURRENT session's pairs — without this, a
        # long-lived cache accumulates pairs from long-gone objects
        # until the bitset overflows, which would permanently latch
        # needs_host_validation (and kill the bulk-apply path) even
        # though no single session ever exceeds the capacity
        self.label_reg = BitRegistry(self.label_reg.words)
        self.taint_reg = BitRegistry(self.taint_reg.words)
        snap = pack_session(
            tasks,
            jobs,
            nodes,
            pad=True,
            enforce_pod_count=enforce_pod_count,
            label_registry=self.label_reg,
            taint_registry=self.taint_reg,
        )
        T, N = len(tasks), len(nodes)
        # per-row flag state the warm path needs; a memory-exact pack
        # found every task's and node's memory MiB-aligned, so only an
        # inexact one walks the rows
        self._task_mem_ok = np.ones(snap.task_resreq.shape[0], dtype=bool)
        self._node_mem_static_ok = np.ones(snap.node_idle.shape[0], dtype=bool)
        self._node_mem_dyn_ok = np.ones(snap.node_idle.shape[0], dtype=bool)
        if not snap.memory_exact:
            if T:
                mems = np.array([t.init_resreq.memory for t in tasks], dtype=np.float64)
                self._task_mem_ok[:T] = (mems % MIB) == 0
            for i, n in enumerate(nodes):
                if n.allocatable.memory % MIB:
                    self._node_mem_static_ok[i] = False
                if n.idle.memory % MIB or n.used.memory % MIB:
                    self._node_mem_dyn_ok[i] = False
        self._exists_uids = {
            t.uid
            for t in tasks
            if t.pod is not None
            and t.pod.spec.tolerations
            and task_exists_tolerations(t)
        }
        self._task_uids = list(snap.task_uids)
        self._task_pos = {uid: i for i, uid in enumerate(self._task_uids)}
        self._task_jobs = [t.job for t in tasks]
        self._node_names = list(snap.node_names)
        self._node_pos = {name: i for i, name in enumerate(self._node_names)}
        self._node_label_pairs = []
        self._label_to_nodes = {}
        for i, n in enumerate(nodes):
            pairs = (
                tuple((k, v) for k, v in (n.node.metadata.labels or {}).items())
                if n.node is not None
                else ()
            )
            self._node_label_pairs.append(pairs)
            for p in pairs:
                self._label_to_nodes.setdefault(p, set()).add(i)
        self._job_uids = list(snap.job_uids)
        self._names_prev = list(snap.resource_names)
        self._enforce_prev = enforce_pod_count
        self._snap = snap
        self.rev += 1
        snap.cache_key = self.key
        snap.rev = self.rev
        snap.delta = None
        if epoch is not None:
            self._topo_rev = epoch.topology_rev
            self._consumed_rev = epoch.rev
            if self.cache is not None:
                self.cache.clear_dirty_through(epoch)
        self.last_stats = {
            "mode": "cold",
            "repacked_tasks": T,
            "reused_tasks": 0,
            "repacked_nodes": N,
            "pack_ms": (time.perf_counter() - t0) * 1e3,
        }
        return snap

    # ---- micro pack: fresh task rows over warm node planes ----

    def _fresh_task_pack(
        self,
        tasks: Sequence,
        jobs: Sequence,
        nodes: Sequence,
        epoch,
        enforce_pod_count: bool,
        names,
        tol,
        pending,
    ) -> PackedSnapshot:
        """Assemble a snapshot whose TASK planes are rebuilt fresh (new
        bucket, every row re-packed — O(pending tasks)) while the NODE
        planes stay warm (dirty rows only, exactly :meth:`pack`'s node
        phase) and the label/taint registries persist.

        Under sustained churn the pending set's bucket crosses
        power-of-two boundaries every few cycles, so gather-reuse is
        worthless there but the O(nodes) planes — the expensive half at
        10k nodes — are fully reusable.  Equivalence contract is the
        warm path's: bit-identical to a cold ``pack_session`` seeded
        with the resulting registries, so device bindings cannot differ
        from a full cycle's.

        Preconditions (checked by :meth:`pack`): same node set/topology/
        resource axis/enforce flag, no registry overflow."""
        t0 = time.perf_counter()
        prev = self._snap
        tasks_list = list(tasks)
        T, N, J = len(tasks_list), len(nodes), len(jobs)
        snap = self._alloc_snap(names, tol, T, N, J)
        delta_planes: Dict[str, Optional[np.ndarray]] = {}

        # --- node planes (possibly pre-assembled by begin_nodes) ---
        label_size0 = len(self.label_reg.index)
        if pending is None or pending["epoch_rev"] != epoch.rev:
            pending = self._node_phase(list(nodes), epoch, enforce_pod_count)
        node_planes = pending["planes"]
        node_dirty = pending["dirty_pos"]
        node_full = pending["full_pos"]
        for name, arr in node_planes.items():
            setattr(snap, name, arr)
            rows = node_dirty if name in NODE_DYNAMIC_PLANES else node_full
            if rows.size:
                delta_planes[name] = rows

        # --- fresh task planes ---
        self._task_mem_ok = np.ones(snap.task_resreq.shape[0], dtype=bool)
        self._exists_uids = set()
        for i, t in enumerate(tasks_list):
            self._repack_task_row(snap, i, t)
        # keyed-Exists tolerations resolve against the now-complete
        # registry (persistent pairs + anything the rows above and the
        # node phase registered) — the cold pack's post-node-pass step
        resolve_exists_tolerations(snap, enumerate(tasks_list), self.taint_reg)
        # coupling: a NEW label pair registered by a fresh selector must
        # set the bit on every warm node row carrying that label, as a
        # cold pack's node pass would have
        patched = set()
        if len(self.label_reg.index) > label_size0:
            for pair, idx in list(self.label_reg.index.items())[label_size0:]:
                for npos in self._label_to_nodes.get(pair, ()):
                    snap.node_label_bits[npos, idx // 32] |= np.uint32(
                        1 << (idx % 32)
                    )
                    patched.add(npos)
        if patched:
            delta_planes["node_label_bits"] = np.asarray(
                sorted(patched | set(node_full.tolist())), dtype=np.int64
            )

        # --- job planes + positional task_job ---
        curr_uids = [t.uid for t in tasks_list]
        job_uids = [j.uid for j in jobs]
        job_index = {uid: i for i, uid in enumerate(job_uids)}
        task_jobs = [t.job for t in tasks_list]
        if T:
            snap.task_job[:T] = [job_index.get(j, 0) for j in task_jobs]
        for i, j in enumerate(jobs):
            snap.job_min_available[i] = j.min_available
            snap.job_ready_count[i] = j.ready_task_num()
            snap.job_uids.append(j.uid)

        # --- flags + delta vs previous pack ---
        snap.task_uids = curr_uids
        snap.node_names = list(self._node_names)
        snap.registry_overflow = bool(
            self.label_reg.overflow or self.taint_reg.overflow
        )
        snap.needs_host_validation = bool(
            snap.task_needs_host[:T].any() or snap.registry_overflow
        )
        snap.memory_exact = bool(
            self._task_mem_ok[:T].all()
            and self._node_mem_static_ok[:N].all()
            and self._node_mem_dyn_ok[:N].all()
        )
        for name in TASK_PLANES:  # includes task_job
            delta_planes[name] = None  # wholesale: the bucket changed
        for name in JOB_PLANES:
            if not np.array_equal(getattr(prev, name), getattr(snap, name)):
                delta_planes[name] = None
        if not np.array_equal(prev.tolerance, snap.tolerance):
            delta_planes["tolerance"] = None

        # --- bookkeeping (the micro pack IS the next warm base) ---
        self._task_uids = curr_uids
        self._task_pos = {uid: i for i, uid in enumerate(curr_uids)}
        self._task_jobs = task_jobs
        self._job_uids = job_uids
        self._snap = snap
        self.rev += 1
        snap.cache_key = self.key
        snap.rev = self.rev
        snap.delta = PackDelta(self.rev - 1, delta_planes)
        self._consumed_rev = epoch.rev
        if self.cache is not None:
            self.cache.clear_dirty_through(epoch)
        self.last_stats = {
            "mode": "micro",
            "repacked_tasks": T,
            "reused_tasks": 0,
            "repacked_nodes": int(node_dirty.size),
            "pack_ms": (time.perf_counter() - t0) * 1e3,
        }
        return snap

    # ---- node phase (callable before ORDER so staging overlaps it) ----

    def begin_nodes(self, nodes: Sequence, epoch, enforce_pod_count: bool = True):
        """Assemble the NODE planes for this cycle ahead of the task
        phase — node rows do not depend on the task processing order, so
        gpu-allocate calls this before its ORDER phase and stages the
        dynamic planes to the device while ORDER runs on the host.

        Returns the plane dict to stage, or None when this cycle cannot
        pack warm (the caller just skips prestaging; pack() recomputes)."""
        if self._snap is None or epoch is None or epoch.rev < self._consumed_rev:
            return None
        if epoch.topology_rev != self._topo_rev:
            return None
        node_names = [n.name for n in nodes]
        if node_names != self._node_names:
            return None
        if enforce_pod_count != self._enforce_prev:
            return None
        # the resource axis must be checked in pack() (it needs tasks);
        # a mismatch there discards this pre-pack
        t0 = time.perf_counter()
        self._pending_nodes = self._node_phase(list(nodes), epoch, enforce_pod_count)
        self.last_stats = {"node_prepack_ms": (time.perf_counter() - t0) * 1e3}
        return self._pending_nodes

    def _node_phase(self, nodes: List, epoch, enforce_pod_count: bool) -> Dict:
        """Warm node-plane assembly: copy the previous planes and re-pack
        the dirty rows (dynamic-only for accounting churn, everything
        for node-object updates).  The single copy behind begin_nodes
        and pack()'s no-prestage path."""
        prev = self._snap
        planes = {}
        for name in NODE_DYNAMIC_PLANES + NODE_STATIC_PLANES:
            planes[name] = getattr(prev, name).copy()
        self._node_mem_dyn_ok = self._node_mem_dyn_ok.copy()
        self._node_mem_static_ok = self._node_mem_static_ok.copy()
        taint_size0 = len(self.taint_reg.index)
        dirty_pos = sorted(
            self._node_pos[n] for n in epoch.dirty_nodes if n in self._node_pos
        )
        full_pos = [
            self._node_pos[n]
            for n in epoch.dirty_nodes_full
            if n in self._node_pos
        ]
        tmp = PackedSnapshot()
        tmp.resource_names = self._names_prev
        for name in NODE_DYNAMIC_PLANES + NODE_STATIC_PLANES:
            setattr(tmp, name, planes[name])
        self._repack_node_rows(
            tmp, nodes, full_pos, sorted(set(dirty_pos) - set(full_pos)),
            enforce_pod_count,
        )
        return {
            "planes": planes,
            "dirty_pos": np.asarray(dirty_pos, dtype=np.int64),
            "full_pos": np.asarray(sorted(full_pos), dtype=np.int64),
            "epoch_rev": epoch.rev,
            "taint_size0": taint_size0,
        }

    # ---- full pack ----

    def pack(
        self,
        tasks: Sequence,
        jobs: Sequence,
        nodes: Sequence,
        epoch,
        enforce_pod_count: bool = True,
    ) -> PackedSnapshot:
        """Assemble this cycle's PackedSnapshot, reusing everything the
        epoch's dirty sets allow.  Falls back to a (registry-seeded) cold
        pack whenever the warm preconditions fail."""
        pending, self._pending_nodes = self._pending_nodes, None
        if epoch is None:
            # cache without change tracking: plain one-shot pack
            return pack_session(
                tasks, jobs, nodes, pad=True, enforce_pod_count=enforce_pod_count
            )
        if epoch.rev < self._consumed_rev:
            # out-of-order session: its dirty information is already
            # partially consumed — pack one-shot without touching state
            log.debug("pack_cache: out-of-order epoch, one-shot cold pack")
            return pack_session(
                tasks, jobs, nodes, pad=True, enforce_pod_count=enforce_pod_count
            )
        # Cold-rebuild causes, in precedence order.  (node_names equality
        # implies equal node counts, so a node-bucket change can only
        # arrive as "node-set".)  The cause string lands in last_stats.
        # The resource axis and node names are read only where a cause
        # needs them: the cold pack derives its own.
        cold_cause = None
        if self._snap is None:
            cold_cause = "first-pack"
        elif epoch.topology_rev != self._topo_rev:
            cold_cause = "topology"
        else:
            names, tol = _resource_axis(tasks, nodes)
            node_names = [n.name for n in nodes]
            if names != self._names_prev:
                cold_cause = "axis-change"
            elif node_names != self._node_names:
                cold_cause = "node-set"
            elif enforce_pod_count != self._enforce_prev:
                cold_cause = "plugin-set"
            elif self.label_reg.overflow or self.taint_reg.overflow:
                # an overflowed registry recovers via the cold path's
                # registry rebuild — one cold pack instead of a
                # permanently latched needs_host_validation
                cold_cause = "registry-overflow"
        if cold_cause is not None:
            snap = self._cold(tasks, jobs, nodes, epoch, enforce_pod_count)
            self.last_stats["cold_cause"] = cold_cause
            return snap
        if _bucket(len(tasks)) != self._snap.task_resreq.shape[0]:
            # task-bucket change — the sustained-churn steady state,
            # where the pending set's size crosses power-of-two
            # boundaries every few cycles.  Rather than a COLD pack
            # (O(tasks + nodes) rebuild, registries reset), the micro
            # path rebuilds ONLY the task planes fresh (O(pending))
            # against the warm node planes and persistent registries.
            return self._fresh_task_pack(
                tasks, jobs, nodes, epoch, enforce_pod_count, names, tol,
                pending,
            )

        t0 = time.perf_counter()
        prev = self._snap
        T, N, J = len(tasks), len(nodes), len(jobs)
        snap = self._alloc_snap(names, tol, T, N, J)
        delta_planes: Dict[str, Optional[np.ndarray]] = {}

        # --- node planes (possibly pre-assembled by begin_nodes) ---
        label_size0 = len(self.label_reg.index)
        if pending is None or pending["epoch_rev"] != epoch.rev:
            pending = self._node_phase(list(nodes), epoch, enforce_pod_count)
        node_planes = pending["planes"]
        node_dirty = pending["dirty_pos"]
        node_full = pending["full_pos"]
        taint_size0 = pending["taint_size0"]
        for name, arr in node_planes.items():
            setattr(snap, name, arr)
            rows = node_dirty if name in NODE_DYNAMIC_PLANES else node_full
            if rows.size:
                delta_planes[name] = rows

        # --- task planes ---
        curr_uids = [t.uid for t in tasks]
        identical = curr_uids == self._task_uids and not (
            epoch.dirty_tasks and not epoch.dirty_tasks.isdisjoint(self._task_pos)
        )
        task_mem_ok = np.ones(snap.task_resreq.shape[0], dtype=bool)
        if identical:
            for name in TASK_PLANES:
                if name == "task_job":
                    continue
                getattr(snap, name)[:T] = getattr(prev, name)[:T]
            task_mem_ok[:T] = self._task_mem_ok[:T]
            self._task_mem_ok = task_mem_ok
            repack_rows = np.empty(0, dtype=np.int64)
            perm_full = False
        else:
            dirty = epoch.dirty_tasks
            pos = self._task_pos
            perm = np.empty(T, dtype=np.int64)
            for i, uid in enumerate(curr_uids):
                perm[i] = -1 if uid in dirty else pos.get(uid, -1)
            keep = np.nonzero(perm >= 0)[0]
            src = perm[keep]
            for name in TASK_PLANES:
                if name == "task_job":
                    continue
                getattr(snap, name)[keep] = getattr(prev, name)[src]
            task_mem_ok[keep] = self._task_mem_ok[src]
            self._task_mem_ok = task_mem_ok
            repack_rows = np.nonzero(perm < 0)[0]
            perm_full = True
        tasks_list = list(tasks)
        for i in repack_rows:
            self._repack_task_row(snap, int(i), tasks_list[int(i)])
        # stale exists entries for tasks that left the session
        if len(self._exists_uids) and not identical:
            curr_set = set(curr_uids)
            self._exists_uids &= curr_set

        # task_job: positional job indices (job list = first-occurrence
        # order of ordered tasks, same derivation as the cold caller's)
        job_uids = [j.uid for j in jobs]
        task_jobs = [t.job for t in tasks_list]
        if identical and job_uids == self._job_uids and task_jobs == self._task_jobs:
            snap.task_job[:T] = prev.task_job[:T]
            task_job_changed = False
        else:
            job_index = {uid: i for i, uid in enumerate(job_uids)}
            snap.task_job[:T] = [job_index.get(j, 0) for j in task_jobs]
            task_job_changed = not (
                prev.task_job.shape == snap.task_job.shape
                and np.array_equal(prev.task_job, snap.task_job)
            )
        self._task_jobs = task_jobs

        # --- cross-pass couplings ---
        # new label pairs (dirty tasks' selectors) → back-patch bits onto
        # every node carrying the label, exactly as a cold pack's node
        # pass would have, since the pair is now registered
        patched = set()
        if len(self.label_reg.index) > label_size0:
            for pair, idx in list(self.label_reg.index.items())[label_size0:]:
                for npos in self._label_to_nodes.get(pair, ()):
                    snap.node_label_bits[npos, idx // 32] |= np.uint32(
                        1 << (idx % 32)
                    )
                    patched.add(npos)
        if patched:
            rows = np.asarray(
                sorted(patched | set(node_full.tolist())), dtype=np.int64
            )
            delta_planes["node_label_bits"] = rows
        # new taint pairs (dirty nodes / dirty tasks' Equal tolerations) →
        # re-resolve keyed-Exists tolerations; resolution only ORs bits
        # in, so clean rows stay valid
        resolve_rows = {int(i) for i in repack_rows}
        taint_grew = len(self.taint_reg.index) > taint_size0
        if taint_grew and self._exists_uids:
            pos_by_uid = {uid: i for i, uid in enumerate(curr_uids)}
            for uid in self._exists_uids:
                i = pos_by_uid.get(uid)
                if i is not None:
                    resolve_rows.add(i)
        if resolve_rows:
            resolve_exists_tolerations(
                snap,
                ((i, tasks_list[i]) for i in sorted(resolve_rows)),
                self.taint_reg,
            )

        # --- job planes ---
        for i, j in enumerate(jobs):
            snap.job_min_available[i] = j.min_available
            snap.job_ready_count[i] = j.ready_task_num()
            snap.job_uids.append(j.uid)

        # --- flags + bookkeeping ---
        snap.task_uids = curr_uids
        snap.node_names = node_names
        snap.registry_overflow = bool(
            self.label_reg.overflow or self.taint_reg.overflow
        )
        snap.needs_host_validation = bool(
            snap.task_needs_host[:T].any() or snap.registry_overflow
        )
        snap.memory_exact = bool(
            self._task_mem_ok[:T].all()
            and self._node_mem_static_ok[:N].all()
            and self._node_mem_dyn_ok[:N].all()
        )

        # --- delta vs previous pack ---
        for name in TASK_PLANES:
            if name == "task_job":
                continue
            if perm_full:
                delta_planes[name] = None
            elif repack_rows.size or (name == "task_tol_bits" and resolve_rows):
                rows = set(int(i) for i in repack_rows)
                if name == "task_tol_bits":
                    rows |= set(resolve_rows)
                delta_planes[name] = np.asarray(sorted(rows), dtype=np.int64)
        if task_job_changed:
            delta_planes["task_job"] = None
        for name in JOB_PLANES:
            if not np.array_equal(getattr(prev, name), getattr(snap, name)):
                delta_planes[name] = None
        if not np.array_equal(prev.tolerance, snap.tolerance):
            delta_planes["tolerance"] = None

        self._task_uids = curr_uids
        if perm_full:  # positions unchanged on the identical fast path
            self._task_pos = {uid: i for i, uid in enumerate(curr_uids)}
        self._job_uids = job_uids
        self._snap = snap
        self.rev += 1
        snap.cache_key = self.key
        snap.rev = self.rev
        snap.delta = PackDelta(self.rev - 1, delta_planes)
        self._consumed_rev = epoch.rev
        if self.cache is not None:
            self.cache.clear_dirty_through(epoch)
        self.last_stats = {
            "mode": "warm",
            "repacked_tasks": int(repack_rows.size),
            "reused_tasks": T - int(repack_rows.size),
            "repacked_nodes": int(node_dirty.size),
            "reordered": perm_full,
            "pack_ms": (time.perf_counter() - t0) * 1e3,
        }
        return snap
