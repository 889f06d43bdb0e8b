"""The native (C++) host baseline, driven via ctypes.

A copy of ``volcano_tpu/native/__init__.py``.  ``baseline_allocate`` is
the host-native greedy allocate loop and ``baseline_preempt`` the greedy
preempt replay, with the semantics of ``ops/kernels.run_packed`` and
``ops/preempt_pack.preempt_dense``; the node loop fans out over worker
threads, as the reference's 16-goroutine ParallelizeUntil does.

The rung is reached only by name (``trace.replay``'s ``native``
executor and ``python -m volcano_tpu_torch.cmd.trace ... --executor
native``): the dispatcher never selects it.

The library builds at first use with ``g++ -O2 -std=c++17 -shared -fPIC
-pthread`` (no fast math) into ``volcano_tpu_torch/csrc/_build/`` under
a name keyed by a hash of the source and the flags, never next to the
source.  A missing g++ or a failed build raises with g++'s output.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import numpy as np

from volcano_tpu_torch.ops._build import build_once, keyed_library

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "baseline.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "csrc", "_build")
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lib = None


def library_path() -> str:
    """Where the library lives for the current source and flags."""
    return keyed_library("libbaseline", (_SRC,), GXX_FLAGS, BUILD_DIR)


def _gxx(out: str) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("native baseline: g++ not found on PATH")
    proc = subprocess.run([gxx, *GXX_FLAGS, _SRC, "-o", out],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed (exit {proc.returncode}):\n{proc.stdout}")


def build() -> str:
    """Build the library unless it is built already; return its path.
    Raises RuntimeError when g++ is missing or the build fails."""
    return build_once(library_path(), _gxx)


def load() -> ctypes.CDLL:
    """The library, built first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u32 = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.baseline_allocate.argtypes = [
        f32, i32, u32, u32,              # task arrays
        f32, f32, f32, u32, u32, u8,     # node arrays
        i32, i32,                        # counts/max
        i32, i32,                        # job arrays
        f32,                             # tolerance
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        i32,                             # out assignment
    ]
    lib.baseline_allocate.restype = ctypes.c_int
    i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.baseline_preempt.argtypes = [
        f32, u32, u32,                   # preemptor task arrays
        f32, f32, f32, u32, u32, u8,     # node arrays (used/alloc/fi0/bits/ok)
        i32, i32,                        # node count/max
        f32, i32, i32,                   # victim arrays
        i64, i32, i32, i32, i32, i32, i32,  # job tables
        i32,                             # schedule [S,2]
        f32,                             # tolerance
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        u8, i32,                         # out evicted / pipelined
    ]
    lib.baseline_preempt.restype = ctypes.c_int
    _lib = lib
    return lib


def baseline_allocate(snap, n_threads: int = 16, gang_rounds: int = 3) -> np.ndarray:
    """Run the native greedy allocate on a PackedSnapshot → assignment[n_tasks]."""
    lib = load()
    J = snap.job_min_available.shape[0]
    R = snap.task_resreq.shape[1]
    W = snap.task_sel_bits.shape[1]
    task_valid_rows = snap.n_tasks
    out = np.full(task_valid_rows, -1, dtype=np.int32)
    # Padded task rows have resreq 0 and job pointing at a padded job with
    # min_available INT32_MAX, so they never commit; the C++ loop still
    # walks them — trim instead for speed.
    rc = lib.baseline_allocate(
        np.ascontiguousarray(snap.task_resreq[:task_valid_rows]),
        np.ascontiguousarray(snap.task_job[:task_valid_rows]),
        np.ascontiguousarray(snap.task_sel_bits[:task_valid_rows]),
        np.ascontiguousarray(snap.task_tol_bits[:task_valid_rows]),
        np.ascontiguousarray(snap.node_idle[: snap.n_nodes]),
        np.ascontiguousarray(snap.node_used[: snap.n_nodes]),
        np.ascontiguousarray(snap.node_alloc[: snap.n_nodes]),
        np.ascontiguousarray(snap.node_label_bits[: snap.n_nodes]),
        np.ascontiguousarray(snap.node_taint_bits[: snap.n_nodes]),
        np.ascontiguousarray(snap.node_ok[: snap.n_nodes].astype(np.uint8)),
        np.ascontiguousarray(snap.node_task_count[: snap.n_nodes]),
        np.ascontiguousarray(snap.node_max_tasks[: snap.n_nodes]),
        np.ascontiguousarray(snap.job_min_available),
        np.ascontiguousarray(snap.job_ready_count),
        np.ascontiguousarray(snap.tolerance),
        task_valid_rows,
        snap.n_nodes,
        J,
        R,
        W,
        n_threads,
        gang_rounds,
        out,
    )
    if rc != 0:
        raise RuntimeError(f"baseline_allocate failed: {rc}")
    return out


def baseline_preempt(pk, n_threads: int = 16):
    """Run the native greedy preempt on a PreemptPacked →
    (evicted[V] bool, pipelined_node[P] i32).  Semantics mirror
    ops/preempt_pack.preempt_dense (the host PreemptAction replay)."""
    lib = load()
    base = pk.base
    P = base.n_tasks
    N = base.n_nodes
    V = pk.n_victims
    J = pk.n_jobs
    R = base.task_resreq.shape[1]
    W = base.task_sel_bits.shape[1]
    S = pk.schedule.shape[0]
    evicted = np.zeros(max(V, 1), dtype=np.uint8)
    pipelined = np.full(max(P, 1), -1, dtype=np.int32)
    if P == 0 or S == 0:
        return evicted[:V].astype(bool), pipelined[:P]
    rc = lib.baseline_preempt(
        np.ascontiguousarray(base.task_resreq[:P]),
        np.ascontiguousarray(base.task_sel_bits[:P]),
        np.ascontiguousarray(base.task_tol_bits[:P]),
        np.ascontiguousarray(base.node_used[:N]),
        np.ascontiguousarray(base.node_alloc[:N]),
        np.ascontiguousarray(pk.node_fi0[:N]),
        np.ascontiguousarray(base.node_label_bits[:N]),
        np.ascontiguousarray(base.node_taint_bits[:N]),
        np.ascontiguousarray(base.node_ok[:N].astype(np.uint8)),
        np.ascontiguousarray(base.node_task_count[:N]),
        np.ascontiguousarray(base.node_max_tasks[:N]),
        np.ascontiguousarray(pk.vic_resreq[: max(V, 1)]),
        np.ascontiguousarray(pk.vic_node[: max(V, 1)]),
        np.ascontiguousarray(pk.vic_job[: max(V, 1)]),
        np.ascontiguousarray(pk.job_prio.astype(np.int64)),
        np.ascontiguousarray(pk.job_min_avail),
        np.ascontiguousarray(pk.job_ready0),
        np.ascontiguousarray(pk.job_waiting0),
        np.ascontiguousarray(pk.job_queue),
        np.ascontiguousarray(pk.job_ptask_start),
        np.ascontiguousarray(pk.job_ptask_end),
        np.ascontiguousarray(pk.schedule),
        np.ascontiguousarray(base.tolerance),
        P, N, V, J, R, W, S, n_threads,
        evicted, pipelined,
    )
    if rc != 0:
        raise RuntimeError(f"baseline_preempt failed: {rc}")
    return evicted[:V].astype(bool), pipelined[:P]
