"""gpu-preempt — the preempt action with the victim-selection replay on
the GPU.

The port of ``volcano_tpu/actions/jax_preempt.py``.  Reference behavior:
pkg/scheduler/actions/preempt/preempt.go:45-276.  The host packs the
session (ops/preempt_pack.pack_preempt_session — the order replay and
the victim sort happen on the host), one pass replays the whole
preemption on the device (``execute_preempt``: the CUDA preempt kernel,
or the ``dense`` formulation where the dispatcher picks it — drf
preemptable tiers, sessions outside the f32 envelope, ``device="cpu"``),
and the result applies through a real Statement so plugin event handlers
and cache eviction stay intact.

Phase-1 discards are resolved on the device (the kernel rolls a gang
back), so (evicted, pipelined) is the committed outcome and the host
applies it as one statement:

  1. evict the device-chosen victims (global eviction order);
  2. pipeline each preemptor after validating it on its node (plugin
     predicates, then an O(R) fit against the node's future idle).

Routes (``last_route``):

  * ``host`` — the pack refuses the session (ValueError: a preemptable
    tier the dense formulation cannot express, a frozen order that
    would diverge) or flags relational predicates it could not encode
    (``needs_host_validation``).  Both are decided from the session
    before any kernel runs; the host ``PreemptAction`` runs, as in the
    reference, and ``last_host_reason`` says why.
  * ``device`` — the pass ran.  With nothing evicted and nothing
    pipelined, the preemptors the device proves fit no node get their
    FitErrors synthesized (ops/explain).
  * ``none`` — nothing starves.

Failures: ``ExecutorFailed`` from the pass leaves ``execute()`` before
anything is evicted.  A device result that fails validation while it is
applied is NOT handed to the host action (the reference does that): the
statement is discarded, the divergence is counted in
``volcano_executor_failures_total{cause="diverged"}`` and
``ApplyDiverged`` is raised, so no host answer stands in for a wrong
kernel result and nothing is evicted.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from volcano_tpu_torch import metrics
from volcano_tpu_torch.actions.preempt import PreemptAction
from volcano_tpu_torch.api import FitError, TaskStatus
from volcano_tpu_torch.framework.interface import Action
from volcano_tpu_torch.framework.session import Session
from volcano_tpu_torch.ops.dispatch import ApplyDiverged
from volcano_tpu_torch.ops.executor import execute_preempt, last_preempt_executor
from volcano_tpu_torch.ops.explain import synthesize_no_victim_explanations
from volcano_tpu_torch.ops.kernels import resolve_device
from volcano_tpu_torch.ops.preempt_pack import pack_preempt_session
from volcano_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


class GpuPreemptAction(Action):
    def __init__(self, device: Optional[Union[str, torch.device]] = None):
        """``device`` is where the pass runs: ``cuda`` when None (raising
        where there is no GPU), ``"cpu"`` for the PyTorch
        specification."""
        self.device = device
        #: "device", "host" or "none" — see the module docstring
        self.last_route = ""
        #: why the last execute() took the host action ("" otherwise)
        self.last_host_reason = ""
        #: the executor of the last pass ("cuda" or "dense"; "" if none ran)
        self.last_executor = ""
        #: phase timings (ms) of the last execute(): pack, execute, apply
        self.last_phase_stats: Dict[str, float] = {}

    def name(self) -> str:
        return "gpu-preempt"

    def _host(self, ssn: Session, reason: str) -> None:
        log.info("gpu-preempt takes the host action: %s", reason)
        self.last_route, self.last_host_reason = "host", reason
        PreemptAction().execute(ssn)

    def execute(self, ssn: Session) -> None:
        self.last_route = self.last_host_reason = self.last_executor = ""
        self.last_phase_stats = {}
        device = resolve_device(self.device)

        t0 = time.perf_counter()
        try:
            pk = pack_preempt_session(ssn)
        except ValueError as e:
            self._host(ssn, f"pack refused: {e}")
            return
        self.last_phase_stats["pack_ms"] = (time.perf_counter() - t0) * 1e3
        if pk.base.n_tasks == 0:
            self.last_route = "none"
            return
        if pk.base.needs_host_validation:
            # relational predicates the packer could not encode: victim
            # selection itself could diverge — run the host action
            self._host(ssn, "needs host validation")
            return

        t0 = time.perf_counter()
        # ExecutorFailed leaves execute() here, before anything is evicted
        evicted, pipelined = execute_preempt(pk, device=device)
        self.last_phase_stats["execute_ms"] = (time.perf_counter() - t0) * 1e3
        self.last_executor = last_preempt_executor()
        self.last_route = "device"

        t0 = time.perf_counter()
        if not evicted.any() and not (pipelined >= 0).any():
            # nothing to evict — the preemptors stay Pending; explain the
            # ones the device proves fit no node at all, so the
            # Unschedulable writeback fires as on a host-scheduled cycle
            synthesize_no_victim_explanations(ssn, pk, device=device)
            metrics.register_preemption_attempts()
            self.last_phase_stats["apply_ms"] = (time.perf_counter() - t0) * 1e3
            return

        executor = "preempt-cuda" if self.last_executor == "cuda" else self.last_executor
        stmt = apply_evictions(ssn, pk, evicted, pipelined, "preempt", executor, check_fit=True)
        metrics.update_preemption_victims_count(int(evicted.sum()))
        metrics.register_preemption_attempts()
        stmt.commit()
        self.last_phase_stats["apply_ms"] = (time.perf_counter() - t0) * 1e3


def apply_evictions(ssn: Session, pk, evicted: np.ndarray, pipelined: np.ndarray,
                    reason: str, executor: str, check_fit: bool):
    """Apply a pass's (evicted, pipelined) as one statement and return it
    uncommitted: evict the chosen victims in global (node-major)
    eviction order, then pipeline each task on its node after validating
    it against the live session (plugin predicates and, with
    ``check_fit``, an O(R) fit against the node's future idle).  A task
    that vanished or fails validation discards the statement, is counted
    in ``volcano_executor_failures_total{executor, cause="diverged"}``
    and raises ``ApplyDiverged``: nothing is evicted.  Shared by
    gpu-preempt and gpu-reclaim; ``pk`` is a PreemptPacked or a
    ReclaimPacked."""
    stmt = ssn.statement()
    try:
        for i in np.nonzero(evicted)[0]:
            job = ssn.jobs.get(pk.job_uids[pk.vic_job[i]])
            task = job.tasks.get(pk.vic_uids[i]) if job else None
            if task is None or task.status != TaskStatus.Running:
                raise FitError(task, None, "victim vanished")
            stmt.evict(task, reason)
        # pipelines in task order (tasks are laid out job-contiguously:
        # base.task_job[p] is the owning job row)
        for p in np.nonzero(pipelined >= 0)[0]:
            node = ssn.nodes.get(pk.node_names[pipelined[p]])
            job = ssn.jobs.get(pk.job_uids[pk.base.task_job[p]])
            task = job.tasks.get(pk.ptask_uids[p]) if job else None
            if task is None or node is None:
                raise FitError(task, node, "pipelined task vanished")
            ssn.predicate_fn(task, node)  # raises FitError on veto
            if check_fit and not task.init_resreq.less_equal(node.future_idle()):
                raise FitError(task, node, "device fit diverged")
            stmt.pipeline(task, node.name)
    except FitError as e:
        stmt.discard()
        metrics.register_executor_failure(executor, "diverged")
        log.error("%s %s result diverged while applied: %s", executor, reason, e)
        raise ApplyDiverged(executor, str(e)) from e
    return stmt


def new() -> GpuPreemptAction:
    return GpuPreemptAction()
