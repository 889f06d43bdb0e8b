"""The packed session: dense numpy arrays the kernels consume.

A copy of the snapshot container of ``volcano_tpu/ops/packing.py`` with
the same fields, padding buckets and npz layout, so a snapshot written
by either package loads in the other.  Layout (R = resource axis =
[cpu_milli, memory_MiB, *scalars]):

  task_resreq[T, R]   f32   task InitResreq lanes
  task_job[T]         i32   job index per task
  task_sel_bits[T, W] u32   required node-label bits
  task_tol_bits[T, W] u32   tolerated taint bits
  node_idle[N, R]     f32   node Idle lanes
  node_used[N, R]     f32   node Used lanes
  node_alloc[N, R]    f32   node Allocatable lanes
  node_label_bits[N,W]u32   node label bits
  node_taint_bits[N,W]u32   node NoSchedule/NoExecute taint bits
  node_ok[N]          bool  ready & schedulable
  node_task_count[N]  i32 / node_max_tasks[N] i32
  job_min_available[J]i32 / job_ready_count[J] i32

Label/taint relational predicates become pointwise bitset ops: W words
of 32 bits each; the registry assigns a bit per distinct (key,value)
label pair / taint referenced in the session.  ``pack_session`` packs a
live session's ordered tasks, jobs and nodes, as the JAX package's does
(``volcano_tpu/ops/packing.py``), with its warm packer's seams: seeded
bit registries and the per-row helpers ``task_lane_row``,
``node_lane_rows`` and ``task_exists_tolerations`` that
``ops/pack_cache.py`` shares with it.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from volcano_tpu_torch.api import JobInfo, NodeInfo, TaskInfo
from volcano_tpu_torch.api.resource import MIN_MEMORY, MIN_MILLI_CPU, MIN_MILLI_SCALAR

#: Default bitset width: 2 words = 64 distinct label pairs / taints.
DEFAULT_BIT_WORDS = 2

#: Memory lane quantization (bytes per MiB).
MIB = float(1 << 20)


class BitRegistry:
    """Assigns bit indices to distinct keys; overflow falls back to host."""

    def __init__(self, words: int = DEFAULT_BIT_WORDS):
        self.words = words
        self.index: Dict[Tuple, int] = {}
        self.overflow = False

    def bit(self, key: Tuple) -> Optional[int]:
        idx = self.index.get(key)
        if idx is None:
            idx = len(self.index)
            if idx >= self.words * 32:
                self.overflow = True
                return None
            self.index[key] = idx
        return idx

    def set_bit(self, arr: np.ndarray, row: int, key: Tuple) -> None:
        idx = self.bit(key)
        if idx is not None:
            arr[row, idx // 32] |= np.uint32(1 << (idx % 32))


def _bucket(n: int, minimum: int = 64) -> int:
    """Round up to the next power-of-two bucket."""
    if n <= minimum:
        return minimum
    return 1 << math.ceil(math.log2(n))


@dataclass
class PackedSnapshot:
    """Dense session state (numpy, host side; moved to the device by the
    executors)."""

    # resource axis metadata
    resource_names: List[str] = field(default_factory=list)
    tolerance: np.ndarray = None  # [R]

    # tasks (padded to T_pad; first n_tasks valid)
    n_tasks: int = 0
    task_resreq: np.ndarray = None
    task_job: np.ndarray = None
    task_sel_bits: np.ndarray = None
    task_tol_bits: np.ndarray = None

    # nodes (padded to N_pad; first n_nodes valid)
    n_nodes: int = 0
    node_idle: np.ndarray = None
    node_used: np.ndarray = None
    node_alloc: np.ndarray = None
    node_label_bits: np.ndarray = None
    node_taint_bits: np.ndarray = None
    node_ok: np.ndarray = None
    node_task_count: np.ndarray = None
    node_max_tasks: np.ndarray = None

    # jobs (padded to J_pad; first n_jobs valid)
    n_jobs: int = 0
    job_min_available: np.ndarray = None
    job_ready_count: np.ndarray = None

    # host-side keys for unpacking results
    task_uids: List[str] = field(default_factory=list)
    node_names: List[str] = field(default_factory=list)
    job_uids: List[str] = field(default_factory=list)

    #: True when a relational predicate could not be bitset-encoded;
    #: callers must then re-validate placements on the host.
    needs_host_validation: bool = False

    #: False when a memory quantity was not MiB-aligned (lane rounds).
    memory_exact: bool = True

    #: True when the label/taint bit registry overflowed — the sel/tol
    #: planes of every row are then suspect, not just flagged tasks.
    #: Host bookkeeping (the explain synthesis gate); not serialized.
    registry_overflow: bool = False

    #: [T] bool — tasks carrying preferred (anti-)affinity terms the
    #: kernel cannot score.
    task_has_preferences: np.ndarray = None

    #: [T] bool — the rows whose relational predicates could not be
    #: bitset-encoded (the per-row share of ``needs_host_validation``).
    #: Host bookkeeping (the explain synthesis gate); not serialized.
    task_needs_host: np.ndarray = None

    # ---- warm-cycle metadata (ops/pack_cache.py) ----
    #: identity of the producing PackCache (None for cold one-shot
    #: packs); the device stager keys its resident planes on it.  Not
    #: serialized.
    cache_key: Optional[str] = None
    #: monotonically increasing pack revision within the cache_key
    rev: int = 0
    #: PackDelta describing which rows changed since ``rev - 1``; None on
    #: cold packs and whenever the cache invalidated wholesale
    delta: Optional[object] = None
    #: {plane name → torch tensor} mirror staged on the kernel's device
    #: ahead of the kernel call (ops/device_stage.py); the session
    #: kernel builds its node operands from it, and puts the numpy
    #: planes on the device whole where it is absent
    device_planes: Optional[Dict[str, object]] = None


# ---- npz persistence (the trace journal's snapshot format) ----

#: array-valued PackedSnapshot fields, in npz key order
_SNAPSHOT_ARRAYS = (
    "tolerance",
    "task_resreq",
    "task_job",
    "task_sel_bits",
    "task_tol_bits",
    "node_idle",
    "node_used",
    "node_alloc",
    "node_label_bits",
    "node_taint_bits",
    "node_ok",
    "node_task_count",
    "node_max_tasks",
    "job_min_available",
    "job_ready_count",
    "task_has_preferences",
)

#: scalar/list fields carried in the JSON meta record
_SNAPSHOT_META = (
    "resource_names",
    "n_tasks",
    "n_nodes",
    "n_jobs",
    "task_uids",
    "node_names",
    "job_uids",
    "needs_host_validation",
    "memory_exact",
)

_EXTRA_PREFIX = "__extra__"


def snapshot_from_arrays(arrays: Dict[str, np.ndarray], meta: dict) -> PackedSnapshot:
    """A PackedSnapshot from its array planes and its meta record — the
    state carried across from a session packed elsewhere (a journal
    snapshot, or the JAX package's packer)."""
    unknown = (set(arrays) - set(_SNAPSHOT_ARRAYS)) | (set(meta) - set(_SNAPSHOT_META))
    if unknown:
        raise ValueError(f"not PackedSnapshot fields: {sorted(unknown)}")
    snap = PackedSnapshot()
    for name, value in meta.items():
        setattr(snap, name, value)
    for name, value in arrays.items():
        setattr(snap, name, np.asarray(value))
    return snap


def save_snapshot(snap: PackedSnapshot, path: str, **extras) -> str:
    """Persist a PackedSnapshot to a compressed npz (plus caller extras).
    Arrays go verbatim, list/str/bool fields via a JSON side record; no
    pickle."""
    payload = {}
    for name in _SNAPSHOT_ARRAYS:
        value = getattr(snap, name)
        if value is not None:
            payload[name] = value
    meta = {name: getattr(snap, name) for name in _SNAPSHOT_META}
    payload["__meta__"] = np.array(json.dumps(meta))
    for key, value in extras.items():
        payload[_EXTRA_PREFIX + key] = np.asarray(value)
    np.savez_compressed(path, **payload)
    return path


def load_snapshot(path: str):
    """Inverse of save_snapshot: (PackedSnapshot, extras dict).  String
    extras come back as 0-d unicode arrays (``str()`` them)."""
    arrays, meta, extras = {}, {}, {}
    with np.load(path, allow_pickle=False) as data:
        for key in data.files:
            if key == "__meta__":
                meta = json.loads(str(data[key]))
            elif key.startswith(_EXTRA_PREFIX):
                extras[key[len(_EXTRA_PREFIX):]] = data[key]
            else:
                arrays[key] = data[key]
    return snapshot_from_arrays(arrays, meta), extras


# ---- packing a live session ----

def _resource_axis(
    tasks: Sequence[TaskInfo], nodes: Sequence[NodeInfo]
) -> Tuple[List[str], np.ndarray]:
    scalars: List[str] = []
    seen = set()
    for t in tasks:
        for name in t.init_resreq.scalars:
            if name not in seen:
                seen.add(name)
                scalars.append(name)
    for n in nodes:
        for name in n.allocatable.scalars:
            if name not in seen:
                seen.add(name)
                scalars.append(name)
    names = ["cpu", "memory", *scalars]
    tol = np.array(
        [MIN_MILLI_CPU, MIN_MEMORY / MIB] + [MIN_MILLI_SCALAR] * len(scalars),
        dtype=np.float32,
    )
    return names, tol


def alloc_planes(
    snap: "PackedSnapshot",
    R: int,
    W: int,
    T: int,
    N: int,
    J: int,
    T_pad: int,
    N_pad: int,
    J_pad: int,
) -> None:
    """Allocate every plane of a PackedSnapshot zeroed at the given
    padded shapes."""
    snap.n_tasks, snap.n_nodes, snap.n_jobs = T, N, J
    snap.task_resreq = np.zeros((T_pad, R), dtype=np.float32)
    snap.task_job = np.zeros(T_pad, dtype=np.int32)
    snap.task_sel_bits = np.zeros((T_pad, W), dtype=np.uint32)
    snap.task_tol_bits = np.zeros((T_pad, W), dtype=np.uint32)
    snap.node_idle = np.zeros((N_pad, R), dtype=np.float32)
    snap.node_used = np.zeros((N_pad, R), dtype=np.float32)
    snap.node_alloc = np.zeros((N_pad, R), dtype=np.float32)
    snap.node_label_bits = np.zeros((N_pad, W), dtype=np.uint32)
    snap.node_taint_bits = np.zeros((N_pad, W), dtype=np.uint32)
    snap.node_ok = np.zeros(N_pad, dtype=bool)
    snap.node_task_count = np.zeros(N_pad, dtype=np.int32)
    snap.node_max_tasks = np.zeros(N_pad, dtype=np.int32)
    snap.job_min_available = np.zeros(J_pad, dtype=np.int32)
    # Padded jobs get min_available high so padded tasks never commit.
    snap.job_min_available[J:] = np.iinfo(np.int32).max
    snap.job_ready_count = np.zeros(J_pad, dtype=np.int32)
    snap.task_has_preferences = np.zeros(T_pad, dtype=bool)
    snap.task_needs_host = np.zeros(T_pad, dtype=bool)


def _res_vec(res, names: List[str], snap: PackedSnapshot) -> np.ndarray:
    """One Resource as a lane row; a memory quantity that is not
    MiB-aligned clears ``snap.memory_exact``."""
    out = np.zeros(len(names), dtype=np.float32)
    out[0] = res.milli_cpu
    if res.memory % MIB:
        snap.memory_exact = False
    out[1] = res.memory / MIB
    for i, name in enumerate(names[2:], start=2):
        out[i] = res.scalars.get(name, 0.0)
    return out


def task_exists_tolerations(t: TaskInfo) -> Tuple[Tuple[str, str], ...]:
    """(key, effect) pairs of the task's keyed Exists tolerations — what
    resolve_exists_tolerations matches against the taint registry.  The
    warm packer caches this per row so it can re-resolve only affected
    tasks when a dirty node registers a new taint."""
    pod = t.pod
    if pod is None:
        return ()
    out = []
    for tol_ in pod.spec.tolerations or []:
        if tol_.operator == "Exists" and tol_.key:
            out.append((tol_.key, tol_.effect or ""))
    return tuple(out)


def pack_task_bits(
    snap: "PackedSnapshot",
    i: int,
    t: TaskInfo,
    label_reg: BitRegistry,
    taint_reg: BitRegistry,
) -> bool:
    """Selector/affinity/toleration bit packing for one ordered task.
    Writes the task's sel/tol bit rows and preference flag into
    ``snap`` at row ``i``; returns True when the task needs host
    validation (affinity richer than the bitset encoding)."""
    needs_host = False
    pod = t.pod
    if pod is None:
        return needs_host
    for k, v in (pod.spec.node_selector or {}).items():
        label_reg.set_bit(snap.task_sel_bits, i, (k, v))
    # Required node affinity: single-term all-In expressions fold into
    # the selector bitset; anything richer flags host validation.
    node_aff = (pod.spec.affinity or {}).get("nodeAffinity") or {}
    req = node_aff.get("requiredDuringSchedulingIgnoredDuringExecution") or {}
    terms = req.get("nodeSelectorTerms") or []
    if len(terms) == 1:
        for e in terms[0].get("matchExpressions") or []:
            if e.get("operator", "In") == "In" and len(e.get("values") or []) == 1:
                label_reg.set_bit(
                    snap.task_sel_bits, i, (e["key"], e["values"][0])
                )
            else:
                needs_host = True
    elif terms:
        needs_host = True
    for tol_ in pod.spec.tolerations or []:
        if tol_.operator == "Exists" and not tol_.key:
            # tolerates everything: set all taint bits
            snap.task_tol_bits[i, :] = np.uint32(0xFFFFFFFF)
        elif tol_.operator == "Exists":
            pass  # keyed Exists resolved in the post-node pass
        else:
            for effect in ("NoSchedule", "NoExecute"):
                if not tol_.effect or tol_.effect == effect:
                    taint_reg.set_bit(
                        snap.task_tol_bits, i, (tol_.key, tol_.value, effect)
                    )
    aff = pod.spec.affinity or {}
    if aff.get("podAffinity") or aff.get("podAntiAffinity"):
        needs_host = True
    node_pref = (aff.get("nodeAffinity") or {}).get(
        "preferredDuringSchedulingIgnoredDuringExecution"
    )
    pod_pref = (aff.get("podAffinity") or {}).get(
        "preferredDuringSchedulingIgnoredDuringExecution"
    ) or (aff.get("podAntiAffinity") or {}).get(
        "preferredDuringSchedulingIgnoredDuringExecution"
    )
    if node_pref or pod_pref:
        # Preference terms contribute to host scoring (nodeorder.py);
        # the kernel has no lanes for them — route to host path.
        snap.task_has_preferences[i] = True
    return needs_host


def resolve_exists_tolerations(
    snap: "PackedSnapshot", indexed_tasks, taint_reg: BitRegistry
) -> None:
    """Set tol bits for keyed Exists tolerations against the (complete)
    taint registry, for each ``(row, task)`` in ``indexed_tasks``."""
    for i, t in indexed_tasks:
        pod = t.pod
        if pod is None:
            continue
        for tol_ in pod.spec.tolerations or []:
            if tol_.operator == "Exists" and tol_.key:
                for (k, v, eff), idx in taint_reg.index.items():
                    if k == tol_.key and (not tol_.effect or tol_.effect == eff):
                        snap.task_tol_bits[i, idx // 32] |= np.uint32(1 << (idx % 32))


def pack_node_row(
    snap: "PackedSnapshot",
    i: int,
    n: NodeInfo,
    label_reg: BitRegistry,
    taint_reg: BitRegistry,
    enforce_pod_count: bool,
) -> None:
    """Non-lane node state for one row: ok flag, task counts, label/taint
    bits."""
    snap.node_ok[i] = n.ready() and not (
        n.node is not None and n.node.spec.unschedulable
    )
    snap.node_task_count[i] = len(n.tasks)
    # Host semantics: the pod-count limit is the predicates plugin's
    # (max_task_num 0 ⇒ it rejects everything); without that plugin
    # no limit applies.
    snap.node_max_tasks[i] = (
        n.allocatable.max_task_num if enforce_pod_count else np.iinfo(np.int32).max
    )
    if n.node is None:
        return
    for k, v in (n.node.metadata.labels or {}).items():
        # Only label pairs some task references need bits.
        if (k, v) in label_reg.index:
            label_reg.set_bit(snap.node_label_bits, i, (k, v))
    for taint in n.node.spec.taints or []:
        if taint.effect in ("NoSchedule", "NoExecute"):
            taint_reg.set_bit(
                snap.node_taint_bits, i, (taint.key, taint.value, taint.effect)
            )


def task_lane_row(t: TaskInfo, names: List[str], row: np.ndarray) -> bool:
    """Fill one task's resreq lane row (same float op order as the cold
    bulk extraction: f64 memory divide, then f32 downcast on store).
    Returns False when the memory quantity was not MiB-aligned."""
    rr = t.init_resreq
    row[0] = rr.milli_cpu
    row[1] = rr.memory / MIB
    sc = rr.scalars
    if sc and len(names) > 2:
        for r, name in enumerate(names[2:], start=2):
            row[r] = sc.get(name, 0.0)
    return not rr.memory % MIB


def node_lane_rows(
    n: NodeInfo,
    names: List[str],
    idle_row: np.ndarray,
    used_row: np.ndarray,
    alloc_row: np.ndarray,
) -> bool:
    """Fill one node's idle/used/alloc lane rows; returns False when any
    memory quantity was not MiB-aligned."""
    mem_ok = True
    for res, row in ((n.idle, idle_row), (n.used, used_row), (n.allocatable, alloc_row)):
        row[0] = res.milli_cpu
        row[1] = res.memory / MIB
        if res.memory % MIB:
            mem_ok = False
        sc = res.scalars
        if sc and len(names) > 2:
            for r, name in enumerate(names[2:], start=2):
                row[r] = sc.get(name, 0.0)
    return mem_ok


def pack_session(
    tasks: Sequence[TaskInfo],
    jobs: Sequence[JobInfo],
    nodes: Sequence[NodeInfo],
    bit_words: int = DEFAULT_BIT_WORDS,
    pad: bool = True,
    enforce_pod_count: bool = True,
    label_registry: Optional[BitRegistry] = None,
    taint_registry: Optional[BitRegistry] = None,
) -> PackedSnapshot:
    """Pack pending tasks (in processing order), their jobs and all nodes.

    ``tasks`` must arrive in the order the kernel should consider them —
    the host computes it from the session's task/job order functions, which
    preserves the reference's priority semantics (allocate.go:54-92).

    ``enforce_pod_count`` mirrors whether the predicates plugin is in the
    session's tiers: the pod-number limit lives there (predicates.go:164),
    so without it the host never counts pods and neither should the kernel.

    ``label_registry``/``taint_registry`` seed the bit assignment with a
    persistent registry (ops/pack_cache.py).  Bit indices are append-only,
    so a pack seeded with a registry that already covers the session's
    label/taint pairs produces arrays bit-identical to the pack that
    built the registry — the equivalence contract the warm delta path is
    tested against.  The contract is dictionary-level: a warm pack may
    first-register new pairs in a different order than a cold pack would
    (it packs nodes before tasks), so equivalence is defined against a
    cold pack seeded with the resulting registry; bindings are invariant
    under bit permutation either way.
    """
    snap = PackedSnapshot()
    names, tol = _resource_axis(tasks, nodes)
    snap.resource_names = names
    snap.tolerance = tol
    R = len(names)

    T, N, J = len(tasks), len(nodes), len(jobs)
    T_pad = _bucket(T) if pad else max(T, 1)
    N_pad = _bucket(N) if pad else max(N, 1)
    J_pad = _bucket(J, minimum=16) if pad else max(J, 1)

    job_index = {j.uid: i for i, j in enumerate(jobs)}

    label_reg = label_registry if label_registry is not None else BitRegistry(bit_words)
    taint_reg = taint_registry if taint_registry is not None else BitRegistry(bit_words)
    W = label_reg.words

    alloc_planes(snap, R, W, T, N, J, T_pad, N_pad, J_pad)

    # Resource lanes: bulk-extract cpu/memory (the dominant cost at 50k
    # tasks was one tiny np array per task); scalar lanes stay per-task
    # but only exist when the session carries extended resources.
    if T:
        snap.task_resreq[:T, 0] = [t.init_resreq.milli_cpu for t in tasks]
        mem = np.array([t.init_resreq.memory for t in tasks], dtype=np.float64)
        if (mem % MIB).any():
            snap.memory_exact = False
        snap.task_resreq[:T, 1] = mem / MIB
        snap.task_job[:T] = [job_index.get(t.job, 0) for t in tasks]
        if R > 2:
            for i, t in enumerate(tasks):
                sc = t.init_resreq.scalars
                if sc:
                    for r, name in enumerate(names[2:], start=2):
                        snap.task_resreq[i, r] = sc.get(name, 0.0)

    # Tasks: selector/affinity/toleration bits come from the pod spec.
    for i, t in enumerate(tasks):
        snap.task_uids.append(t.uid)
        if pack_task_bits(snap, i, t, label_reg, taint_reg):
            snap.task_needs_host[i] = True
            snap.needs_host_validation = True

    # Nodes: same bulk lane extraction as tasks.
    if N:
        for arr, field_name in (
            (snap.node_idle, "idle"),
            (snap.node_used, "used"),
            (snap.node_alloc, "allocatable"),
        ):
            res_list = [getattr(n, field_name) for n in nodes]
            arr[:N, 0] = [r.milli_cpu for r in res_list]
            mem = np.array([r.memory for r in res_list], dtype=np.float64)
            if (mem % MIB).any():
                snap.memory_exact = False
            arr[:N, 1] = mem / MIB
            if R > 2:
                for i, r in enumerate(res_list):
                    if r.scalars:
                        for k, name in enumerate(names[2:], start=2):
                            arr[i, k] = r.scalars.get(name, 0.0)

    for i, n in enumerate(nodes):
        pack_node_row(snap, i, n, label_reg, taint_reg, enforce_pod_count)
        snap.node_names.append(n.name)

    # Keyed Exists tolerations need the full taint registry, which is only
    # complete after the node pass.
    resolve_exists_tolerations(snap, enumerate(tasks), taint_reg)

    # Jobs.
    for i, j in enumerate(jobs):
        snap.job_min_available[i] = j.min_available
        snap.job_ready_count[i] = j.ready_task_num()
        snap.job_uids.append(j.uid)

    if label_reg.overflow or taint_reg.overflow:
        snap.needs_host_validation = True
        snap.registry_overflow = True

    return snap
