"""Device-derived scheduling explainability.

A copy of ``volcano_tpu/ops/explain.py``.  The reference system's
unschedulable explanations histogram per-node predicate failures into
"0/N nodes are available: ..." messages (unschedule_info.go) and record
them as pod Events and ``Unschedulable`` conditions (cache.go:832-867).
The predicate component planes of ``ops/kernels._component_planes``
already hold every ingredient; ``run_explain`` reduces them on the
device to a per-task × reason node-count matrix
(``kernels.explain_counts``, torch ops) and synthesizes
reference-identical :class:`FitErrors` from it, so a device-scheduled
cycle explains a pending task without the O(T×N) host predicate sweep.
gpu-allocate (and the gpu-preempt/gpu-reclaim no-victim paths) populate
``job.nodes_fit_errors`` from the counts, feeding the Unschedulable
writeback of ``close_session`` unchanged.  Only the [T, P] counts come
back to the host, P = 5.

Unlike the reference, the reduction gathers the requested rows directly
(no power-of-two row buckets: PyTorch compiles nothing per shape) and
has no staged device planes.  The most recent cycle's explanation is
parked in :func:`set_last_explain` for the scheduler's ``GET /explain``
endpoint (serving/explain.py); full per-pair reason planes (node-level
attribution, [T, N]) come back only when asked (``retain_planes``).
``VTPU_NO_EXPLAIN`` turns explanations off by default
(:func:`explain_enabled`; an action may override it).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from volcano_tpu_torch import metrics, trace
from volcano_tpu_torch.api.unschedule_info import (
    FitErrors,
    NODE_POD_NUMBER_EXCEEDED,
    NODE_RESOURCE_FIT_FAILED,
    NODE_SELECTOR_MISMATCH,
    NODE_TAINT_UNTOLERATED,
    NODE_UNSCHEDULABLE,
)
from volcano_tpu_torch.ops.kernels import (
    as_tensor,
    explain_counts,
    N_EXPLAIN_REASONS,
    resolve_device,
)
from volcano_tpu_torch.ops.packing import PackedSnapshot

#: reason strings by plane index (kernels.R_FIT..R_TOL) — the host
#: first-failure precedence the planes mirror.
EXPLAIN_REASONS = (
    NODE_RESOURCE_FIT_FAILED,
    NODE_POD_NUMBER_EXCEEDED,
    NODE_UNSCHEDULABLE,
    NODE_SELECTOR_MISMATCH,
    NODE_TAINT_UNTOLERATED,
)

assert len(EXPLAIN_REASONS) == N_EXPLAIN_REASONS


class ExplainResult:
    """Reason counts for one packed session.

    ``counts[t, p]`` — valid nodes whose FIRST failing predicate for
    ordered task ``t`` is ``EXPLAIN_REASONS[p]``; ``reasons`` is the
    per-pair [T, N] plane (int8 reason index, ``N_EXPLAIN_REASONS`` =
    feasible) when retention was requested, else None."""

    __slots__ = ("counts", "n_nodes", "reasons")

    def __init__(self, counts: np.ndarray, n_nodes: int,
                 reasons: Optional[np.ndarray] = None):
        self.counts = counts
        self.n_nodes = n_nodes
        self.reasons = reasons

    def all_infeasible(self, i: int) -> bool:
        """Does the device prove task ``i`` fits NO node at all?"""
        return self.n_nodes > 0 and int(self.counts[i].sum()) >= self.n_nodes

    def histogram(self, i: int) -> Dict[str, int]:
        return {
            EXPLAIN_REASONS[p]: int(c)
            for p, c in enumerate(self.counts[i])
            if c > 0
        }

    def fit_errors(self, i: int) -> FitErrors:
        """Reference-identical FitErrors for task ``i`` — ``.error()``
        renders byte-equal to the host path's aggregate message for the
        same snapshot."""
        fe = FitErrors()
        fe.set_histogram(int(self.counts[i].sum()), self.histogram(i))
        return fe

    def node_reasons(self, i: int, node_names: List[str]) -> Dict[str, str]:
        """node name → failing reason for task ``i`` (plane-retention
        runs only)."""
        if self.reasons is None:
            return {}
        out: Dict[str, str] = {}
        for n, code in enumerate(self.reasons[i][: len(node_names)]):
            if code < N_EXPLAIN_REASONS:
                out[node_names[n]] = EXPLAIN_REASONS[code]
        return out


#: wall-clock ms of the most recent run_explain in this process — read
#: right after the call (ops/executor.last_explain_ms), same thread
last_run_ms: float = 0.0


def run_explain(
    snap: PackedSnapshot,
    retain_planes: bool = False,
    task_rows: Optional[np.ndarray] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> ExplainResult:
    """PackedSnapshot → ExplainResult, reduced on ``device`` (``cuda``
    unless named; raises where there is no GPU and no device is named).

    ``task_rows`` restricts the reduction to those task rows (the
    callers pass the UNPLACED rows — explaining 8 stuck tasks of a 50k
    session must not pay a [50k, N] reduction); rows outside the subset
    come back all-zero (reads as "not proven infeasible", which sends
    consumers to the host sweep — conservative, never wrong).  Only the
    [rows, P] counts come back from the device, and the [rows, N] reason
    plane with ``retain_planes`` (other rows all feasible).  Runs
    wherever the kernels run (scheduler process or compute-plane
    sidecar) and observes its duration into the explain latency
    histogram there."""
    global last_run_ms
    rec = trace.get_recorder()
    if rec.enabled:
        rec.event(
            "dispatch:explain", "kernel",
            tasks=snap.n_tasks, nodes=snap.n_nodes,
            rows=(len(task_rows) if task_rows is not None else snap.n_tasks),
        )
    dev = resolve_device(device)
    T, N = snap.n_tasks, snap.n_nodes
    rows = (
        np.arange(T, dtype=np.int64) if task_rows is None
        else np.asarray(task_rows, dtype=np.int64)
    )
    counts_np = np.zeros((T, N_EXPLAIN_REASONS), dtype=np.int32)
    planes_np = (np.full((T, N), N_EXPLAIN_REASONS, dtype=np.int8)
                 if retain_planes else None)
    if rows.size == 0:
        return ExplainResult(counts_np, N, planes_np)

    t0 = time.perf_counter()
    reasons, counts = explain_counts(
        as_tensor(snap.task_resreq[rows], dev),
        as_tensor(snap.task_sel_bits[rows], dev),
        as_tensor(snap.task_tol_bits[rows], dev),
        as_tensor(snap.node_idle[:N], dev),
        as_tensor(snap.node_label_bits[:N], dev),
        as_tensor(snap.node_taint_bits[:N], dev),
        as_tensor(snap.node_ok[:N], dev),
        as_tensor(snap.node_task_count[:N], dev),
        as_tensor(snap.node_max_tasks[:N], dev),
        as_tensor(snap.tolerance, dev),
        N,
    )
    counts_np[rows] = counts.cpu().numpy()
    if retain_planes:
        planes_np[rows] = reasons.cpu().numpy()
    elapsed = time.perf_counter() - t0
    last_run_ms = elapsed * 1e3
    metrics.update_explain_duration(elapsed)
    return ExplainResult(counts_np, N, planes_np)


def task_exactly_encoded(snap: PackedSnapshot, i: int) -> bool:
    """May device counts for row ``i`` be trusted as the host truth?
    Requires the row's predicates to be bitset-exact (no rich affinity),
    no registry overflow (every row suspect then), and MiB-exact memory
    lanes (the fit plane rounds otherwise)."""
    if getattr(snap, "registry_overflow", False) or not snap.memory_exact:
        return False
    needs_host = getattr(snap, "task_needs_host", None)
    if needs_host is None:
        # snapshots packed elsewhere carry no per-row bookkeeping — fall
        # back to the session-level flag
        return not snap.needs_host_validation
    return not bool(needs_host[i])


def explain_enabled() -> bool:
    """Process-wide default for device-derived explanations (the
    ``VTPU_NO_EXPLAIN`` escape hatch; actions may override it per
    instance)."""
    return not os.environ.get("VTPU_NO_EXPLAIN")


def session_explain_compatible(ssn) -> bool:
    """May device reason counts stand in for this session's host
    predicate chain?  Requires the predicates plugin (without it the
    host chain has none of the selector/taint/unschedulable checks the
    planes encode) and NO opt-in pressure predicates — the host chain
    raises 'node(s) had memory pressure' etc. BETWEEN the pod-count and
    unschedulable checks, a reason the device planes cannot see.  The
    single gate shared by gpu-allocate's context and the no-victim
    synthesis."""
    if "predicates" not in ssn.predicate_fns:
        return False
    pred = ssn.plugins.get("predicates")
    if pred is not None and (
        getattr(pred, "memory_pressure_enable", False)
        or getattr(pred, "disk_pressure_enable", False)
        or getattr(pred, "pid_pressure_enable", False)
    ):
        return False
    return True


def synthesize_no_victim_explanations(
    ssn, pk, device: Optional[Union[str, torch.device]] = None,
) -> int:
    """The gpu-preempt / gpu-reclaim no-victim path: the pass found
    nothing to evict, so the preemptors stay Pending with no recorded
    reason.  For every packed preemptor the device can PROVE fits no
    node at the current state, synthesize the reference FitErrors into
    ``job.nodes_fit_errors`` so the Unschedulable writeback fires
    exactly as on a host-scheduled cycle.  Returns the number of tasks
    explained.  The reduction runs on ``device``.

    The pack is fresh (the action packs, dispatches, and lands here
    before any Statement mutation), so the counts reflect the live
    session state."""
    if not explain_enabled() or not session_explain_compatible(ssn):
        return 0
    base = pk.base
    if base.n_nodes == 0 or base.n_tasks == 0:
        return 0
    result = run_explain(base, device=device)
    explained = 0
    for i in range(base.n_tasks):
        if not task_exactly_encoded(base, i):
            continue
        if not result.all_infeasible(i):
            continue
        job = ssn.jobs.get(pk.job_uids[base.task_job[i]])
        if job is None:
            continue
        uid = pk.ptask_uids[i]
        if uid in job.nodes_fit_errors:
            continue
        job.nodes_fit_errors[uid] = result.fit_errors(i)
        ssn.touched_jobs.add(job.uid)
        for reason in result.histogram(i):
            metrics.register_unschedulable_reason(reason)
        explained += 1
    if explained and ssn._trace.enabled:
        ssn._trace.event(
            "explain-no-victim", "action", tasks=explained,
        )
    return explained


# ---- last-cycle explanation (the /explain debug surface) ----

_last_lock = threading.Lock()
_last: Optional[Dict[str, Any]] = None  # guarded-by: _last_lock


def set_last_explain(info: Optional[Dict[str, Any]]) -> None:
    """Park the most recent cycle's explanation summary: read by the
    scheduler's ``GET /explain`` endpoint.  Written by the cycle loop,
    read from serving threads — hence the lock."""
    global _last
    with _last_lock:
        _last = info


def last_explain() -> Optional[Dict[str, Any]]:
    with _last_lock:
        return _last
