"""gpu-allocate — the allocate action with the O(tasks×nodes) hot loop
on the GPU.

The port of ``volcano_tpu/actions/jax_allocate.py``.  Reference behavior:
pkg/scheduler/actions/allocate/allocate.go.  The reference's per-task
PredicateNodes/PrioritizeNodes/SelectBestNode (scheduler_helper.go:64-211)
is replaced by one pass of the CUDA session kernel over the whole
session; results apply through the same Statement so gang
commit/discard and plugin event handlers stay intact.

Three phases, all built on the single control-flow skeleton in
actions/allocate.py (drive_allocate_loop):

1. ORDER — the task processing order: the episode simulation of
   actions/fast_order.py, or else a replay of the control flow *without
   placements*.  Exact because every order-determining quantity (DRF
   share, proportion queue share/overused, gang readiness, priorities)
   updates from task resreqs only, never from which node a task landed
   on.  The replay mutates session accounting through the real event
   handlers and then unwinds itself, Statement-style.
2. KERNEL — pack the session (ops/packing.py) and run it through
   ``execute_allocate``: the CUDA session kernel on a GPU, the PyTorch
   specification where the caller names ``device="cpu"``.
3. APPLY — the bulk commit of actions/fast_apply.py for a fully-placed
   exact session; otherwise the real control flow, placing each task on
   its kernel-proposed node after an O(1) host validation (plugin
   predicates + fit on that node only).  Tasks whose proposal fails
   validation — and tasks the kernel cannot score faithfully
   (preferred-affinity terms) — take the host scoring path for that
   task alone.

Failures: a kernel that fails raises ``ExecutorFailed`` out of
``execute`` before anything is applied, and an armed cycle deadline that
runs out raises ``CycleDeadlineExceeded`` the same way (counted by
``execute_allocate`` as a failure of the executor, cause ``deadline``).
Either way nothing is bound and nothing runs in the kernel's place.

Not present in the port yet: the reference's host-chooser route under an
expired deadline, the device-derived unschedulability explanations
(``explain``), the warm packer and node-plane prestage, and the trace
journal's capture of the packed session.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple, Union

import torch

from volcano_tpu_torch import metrics
from volcano_tpu_torch.actions.allocate import (
    drive_allocate_loop,
    gang_end_job,
    host_node_chooser,
    make_place_task,
    make_predicate_fn,
)
from volcano_tpu_torch.actions.fast_apply import try_fast_apply
from volcano_tpu_torch.actions.fast_order import try_compute_task_order
from volcano_tpu_torch.api import FitError, TaskInfo, TaskStatus
from volcano_tpu_torch.framework.interface import Action
from volcano_tpu_torch.framework.session import Session
from volcano_tpu_torch.ops.executor import execute_allocate
from volcano_tpu_torch.ops.packing import pack_session

def compute_task_order(ssn: Session) -> List[TaskInfo]:
    """Phase 1: the task processing order.

    Sessions whose ordering semantics match the standard plugin shape
    take the episode-level simulation (actions/fast_order.py); anything
    else falls back to the exact replay below."""
    fast = try_compute_task_order(ssn)
    if fast is not None:
        return fast
    return compute_task_order_replay(ssn)


def compute_task_order_replay(ssn: Session) -> List[TaskInfo]:
    """Replay the loop assuming every task places, recording pop
    order; then unwind all accounting (reverse order, like
    Statement.Discard)."""
    order: List[TaskInfo] = []
    touched: List[Tuple[TaskInfo, TaskStatus]] = []

    def place_task(_ctx, task: TaskInfo, job) -> bool:
        order.append(task)
        touched.append((task, task.status))
        ssn.touched_jobs.add(task.job)
        job.update_task_status(task, TaskStatus.Allocated)
        ssn._fire_allocate(task)
        return True

    drive_allocate_loop(
        ssn,
        begin_job=lambda job: None,
        place_task=place_task,
        end_job=lambda ctx, job: None,
    )

    for task, prior_status in reversed(touched):
        job = ssn.jobs[task.job]
        job.update_task_status(task, prior_status)
        ssn._fire_deallocate(task)

    return order


class GpuAllocateAction(Action):
    def __init__(self, device: Optional[Union[str, torch.device]] = None):
        """``device`` is where the KERNEL phase runs: ``cuda`` when None
        (raising where there is no GPU), ``"cpu"`` for the PyTorch
        specification."""
        self.device = device
        #: how the last execute() applied: "fast" (every task through the
        #: bulk commit), "loop" (the per-task loop), "" (nothing to apply)
        self.last_apply_route = ""
        #: phase timings (ms) of the last execute(): order, pack, execute,
        #: apply, and commit (the bulk bind inside apply)
        self.last_phase_stats: Dict[str, float] = {}

    def name(self) -> str:
        return "gpu-allocate"

    # ---- phase 2 ----

    def _kernel_proposals(
        self, ssn: Session, ordered_tasks: List[TaskInfo], nodes: List,
    ) -> Tuple[Dict[str, str], Optional[object]]:
        """Pack + run the session kernel; ({task uid → node name}, snap).

        Tasks flagged ``task_has_preferences`` are excluded — the kernel
        has no lanes for preferred (anti-)affinity scores, so those route
        to the host chooser.  Relational predicates the packer could not
        encode (needs_host_validation) are safe regardless: phase 3
        validates every proposal against the full host predicate set."""
        jobs = {}
        for t in ordered_tasks:
            job = ssn.jobs.get(t.job)
            if job is not None and job.uid not in jobs:
                jobs[job.uid] = job
        if not nodes or not ordered_tasks:
            return {}, None

        t0 = time.perf_counter()
        snap = pack_session(
            ordered_tasks,
            list(jobs.values()),
            nodes,
            enforce_pod_count="predicates" in ssn.predicate_fns,
        )
        pack_s = time.perf_counter() - t0
        self.last_phase_stats["pack_ms"] = pack_s * 1e3
        metrics.update_kernel_duration("pack", pack_s)

        t0 = time.perf_counter()
        # ExecutorFailed and CycleDeadlineExceeded leave execute() here,
        # before anything session-side has mutated
        assignment = execute_allocate(snap, device=self.device)
        execute_s = time.perf_counter() - t0
        self.last_phase_stats["execute_ms"] = execute_s * 1e3
        metrics.update_kernel_duration("execute", execute_s)

        proposals = {}
        for i, task in enumerate(ordered_tasks):
            if assignment[i] >= 0 and not snap.task_has_preferences[i]:
                proposals[task.uid] = nodes[assignment[i]].name
        return proposals, snap

    # ---- phase 3 ----

    def execute(self, ssn: Session) -> None:
        self.last_phase_stats = {}
        self.last_apply_route = ""
        nodes = [ssn.nodes[name] for name in sorted(ssn.nodes)]

        t0 = time.perf_counter()
        with ssn._trace.span("gpu-allocate:order", "action"):
            ordered = compute_task_order(ssn)
        self.last_phase_stats["order_ms"] = (time.perf_counter() - t0) * 1e3
        if not ordered:
            return
        proposals, snap = self._kernel_proposals(ssn, ordered, nodes)
        t0 = time.perf_counter()
        self.last_apply_route = self._apply(ssn, ordered, proposals, snap)
        self.last_phase_stats["apply_ms"] = (time.perf_counter() - t0) * 1e3

    def _apply(self, ssn, ordered, proposals, snap) -> str:
        # Fully-placed exact sessions commit in bulk (actions/fast_apply);
        # anything outside that envelope runs the loop below.
        if snap is not None:
            done, commit_s = try_fast_apply(ssn, ordered, proposals, snap)
            if commit_s:
                self.last_phase_stats["commit_ms"] = commit_s * 1e3
            if done:
                return "fast"

        predicate_fn = make_predicate_fn(ssn)
        host_choose = host_node_chooser(ssn)

        def choose_node(task: TaskInfo, job):
            """Kernel proposal with O(1) validation; host path fallback."""
            name = proposals.get(task.uid)
            if name is not None:
                node = ssn.nodes.get(name)
                if node is not None:
                    try:
                        predicate_fn(task, node)
                        return node
                    except FitError:
                        pass  # capacity/relational race → host fallback
            return host_choose(task, job)

        drive_allocate_loop(
            ssn,
            begin_job=lambda job: ssn.statement(),
            place_task=make_place_task(ssn, choose_node),
            end_job=gang_end_job(ssn),
        )
        return "loop"


def new() -> GpuAllocateAction:
    return GpuAllocateAction()
