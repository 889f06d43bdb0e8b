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

Packing a live scheduler cache (``pack_session``) needs the API types
and is not part of this package yet.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

#: Default bitset width: 2 words = 64 distinct label pairs / taints.
DEFAULT_BIT_WORDS = 2

#: Memory lane quantization (bytes per MiB).
MIB = float(1 << 20)


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

    #: [T] bool — tasks carrying preferred (anti-)affinity terms the
    #: kernel cannot score.
    task_has_preferences: np.ndarray = None


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
