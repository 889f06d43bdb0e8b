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
   task alone, unless the device's reason counts prove the task fits
   no node (explain, ops/explain.py): then its FitErrors are synthesized
   from the counts and the O(N) host predicate sweep is skipped.

Failures: a kernel that fails raises ``ExecutorFailed`` out of
``execute`` before anything is applied, and an armed cycle deadline that
runs out raises ``CycleDeadlineExceeded`` the same way (counted by
``execute_allocate`` as a failure of the executor, cause ``deadline``).
Either way nothing is bound and nothing runs in the kernel's place.

Not present in the port yet: the reference's host-chooser route under an
expired deadline, the warm packer and node-plane prestage, and the trace
journal's capture of the packed session.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from volcano_tpu_torch import metrics
from volcano_tpu_torch.actions.allocate import (
    drive_allocate_loop,
    eligible_jobs,
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
from volcano_tpu_torch.ops.explain import (
    ExplainResult,
    run_explain,
    session_explain_compatible,
    task_exactly_encoded,
)
from volcano_tpu_torch.ops.packing import pack_session


class _ExplainContext:
    """Device-derived unschedulability explanations for one session.

    Built from reason-count matrices (ops/explain): one for the kernel's
    unplaced rows, and one for the pending tasks the ORDER replay left
    out.  ``try_explain`` replaces the host fallback's O(N) predicate sweep
    for a task the device PROVED fits no node — synthesizing the
    reference-identical FitErrors from the counts — under gates that
    keep the messages byte-faithful to what the host path would have
    recorded on the same snapshot:

      * the predicates plugin is in the session, with no opt-in
        pressure predicates (ops.explain.session_explain_compatible;
        the caller builds no context otherwise);
      * the task row is bitset-exact and memory-exact
        (ops.explain.task_exactly_encoded);
      * no placement has mutated node state since the pack — after a
        placement the host's pop-time first failure can shift to a
        resource-fit failure the snapshot-time counts predate, so those
        tasks take the host sweep instead.
    """

    def __init__(self, ssn: Session):
        self.ssn = ssn
        #: node-state epoch at pack time — any later mutation advances it
        self._epoch0 = ssn.node_state_epoch
        #: task uid → (its snapshot, that snapshot's result, its row)
        self._rows: Dict[str, Tuple[object, ExplainResult, int]] = {}
        #: tasks whose FitErrors came from the counts
        self.explained = 0

    def add(self, snap, result: ExplainResult, tasks) -> None:
        """The reason counts of ``snap``, whose row i is ``tasks[i]``."""
        for i, t in enumerate(tasks):
            self._rows.setdefault(t.uid, (snap, result, i))

    def try_explain(self, task: TaskInfo):
        """FitErrors for ``task`` when the device counts prove it
        unschedulable everywhere — None sends the caller to the host
        sweep."""
        if self.ssn.node_state_epoch != self._epoch0:
            return None
        row = self._rows.get(task.uid)
        if row is None:
            return None
        snap, result, i = row
        if not task_exactly_encoded(snap, i) or not result.all_infeasible(i):
            return None
        self.explained += 1
        for reason in result.histogram(i):
            metrics.register_unschedulable_reason(reason)
        return result.fit_errors(i)


def unordered_pending(ssn: Session, ordered: List[TaskInfo]) -> List[TaskInfo]:
    """The pending tasks the allocate loop may try that ORDER left out:
    a queue that went overused in the replay (every task placing) drops
    the jobs behind it, while the real loop, where tasks fail, still
    reaches them.  Jobs in uid order, tasks in uid order."""
    seen = {t.uid for t in ordered}
    return [
        t
        for job in eligible_jobs(ssn)
        for t in sorted(job.task_status_index.get(TaskStatus.Pending, {}).values(),
                        key=lambda t: t.uid)
        if t.uid not in seen and not t.resreq.is_empty()
    ]


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
        """``device`` is where the KERNEL phase and the explain reduction
        run: ``cuda`` when None (raising where there is no GPU),
        ``"cpu"`` for the PyTorch specification.  Explain is always on:
        its reduction runs only when a task went unplaced, so
        fully-placed cycles pay nothing."""
        self.device = device
        #: how the last execute() applied: "fast" (every task through the
        #: bulk commit), "loop" (the per-task loop), "" (nothing to apply)
        self.last_apply_route = ""
        #: phase timings (ms) of the last execute(): order, pack, execute,
        #: explain (split into explain_pack, the pack of the rows ORDER
        #: left out, and explain_reduce, the reductions), apply, and
        #: commit (the bulk bind inside apply); explain_rows, the rows
        #: reduced; host_sweeps, the tasks that took the host chooser's
        #: O(N) predicate sweep, and explained, the tasks whose FitErrors
        #: came from the device's reason counts
        self.last_phase_stats: Dict[str, float] = {}

    def name(self) -> str:
        return "gpu-allocate"

    # ---- phase 2 ----

    def _kernel_proposals(
        self, ssn: Session, ordered_tasks: List[TaskInfo], nodes: List,
    ) -> Tuple[Dict[str, str], Optional[object], Optional[np.ndarray]]:
        """Pack + run the session kernel; ({task uid → node name}, snap,
        assignment).

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
            return {}, None, None

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
        return proposals, snap, assignment

    # ---- phase 3 ----

    def execute(self, ssn: Session) -> None:
        self.last_phase_stats = {"host_sweeps": 0, "explained": 0}
        self.last_apply_route = ""
        nodes = [ssn.nodes[name] for name in sorted(ssn.nodes)]

        t0 = time.perf_counter()
        with ssn._trace.span("gpu-allocate:order", "action"):
            ordered = compute_task_order(ssn)
        self.last_phase_stats["order_ms"] = (time.perf_counter() - t0) * 1e3
        if not ordered:
            return
        proposals, snap, assignment = self._kernel_proposals(ssn, ordered, nodes)

        explain_ctx = None
        if snap is not None:
            explain_ctx = self._explain_context(ssn, ordered, nodes, snap, assignment)

        t0 = time.perf_counter()
        try:
            self.last_apply_route = self._apply(ssn, ordered, proposals, snap, explain_ctx)
        finally:
            if explain_ctx is not None:
                self.last_phase_stats["explained"] = explain_ctx.explained
        self.last_phase_stats["apply_ms"] = (time.perf_counter() - t0) * 1e3

    def _explain_context(self, ssn, ordered, nodes, snap, assignment
                         ) -> Optional[_ExplainContext]:
        """The reason counts of this cycle, or None when every ordered
        task placed or the session's predicates are not the ones the
        counts encode: a reduction over the kernel's unplaced rows, and —
        the port's addition to the reference, which sends these to the
        host sweep — one over an explain-only pack of the pending tasks
        ORDER left out, both on the kernel's device, so a saturated cycle
        explains every task it tries."""
        unplaced = np.nonzero(np.asarray(assignment)[: snap.n_tasks] < 0)[0]
        if not unplaced.size or not session_explain_compatible(ssn):
            return None
        t0 = time.perf_counter()
        ctx = _ExplainContext(ssn)
        ctx.add(snap, run_explain(snap, task_rows=unplaced, device=self.device), ordered)
        rows, pack_s = int(unplaced.size), 0.0
        pending = sum(len(job.task_status_index.get(TaskStatus.Pending, {}))
                      for job in ssn.jobs.values())
        rest = unordered_pending(ssn, ordered) if pending > len(ordered) else []
        if rest:
            tp = time.perf_counter()
            jobs = list({t.job: ssn.jobs[t.job] for t in rest}.values())
            extra = pack_session(rest, jobs, nodes,
                                 enforce_pod_count="predicates" in ssn.predicate_fns)
            pack_s = time.perf_counter() - tp
            ctx.add(extra, run_explain(extra, device=self.device), rest)
            rows += len(rest)
        explain_s = time.perf_counter() - t0
        self.last_phase_stats.update(
            explain_ms=explain_s * 1e3, explain_pack_ms=pack_s * 1e3,
            explain_reduce_ms=(explain_s - pack_s) * 1e3, explain_rows=rows)
        return ctx

    def _apply(self, ssn, ordered, proposals, snap, explain_ctx) -> str:
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
            if explain_ctx is not None:
                fe = explain_ctx.try_explain(task)
                if fe is not None:
                    # device-proven unschedulable: record the synthesized
                    # FitErrors (the same writeback the host sweep feeds)
                    # and skip the O(N) host predicate sweep
                    job.nodes_fit_errors[task.uid] = fe
                    return None
            self.last_phase_stats["host_sweeps"] += 1
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
