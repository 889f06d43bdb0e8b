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
2. KERNEL — pack the session and run it through ``execute_allocate``:
   the CUDA session kernel on a GPU, the PyTorch specification where the
   caller names ``device="cpu"``.  A session whose cache tracks changes
   (``ssn.pack_epoch``) packs warm through the cache's cycle-persistent
   ``pack_cache`` (ops/pack_cache.py) and stages the planes on the
   kernel's device (ops/device_stage.py), where the session kernel
   builds its node operands from them; the dynamic node planes are
   packed and staged before ORDER, so their copy overlaps it; a warm
   pack that went cold during a micro-triggered cycle counts its cold
   cause in ``volcano_full_cycle_fallbacks_total``.  Any other session
   (a restricted or shadow session among them) packs cold
   (ops/packing.py), and the kernel puts its planes on the device
   whole.
3. APPLY — the bulk commit of actions/fast_apply.py for a fully-placed
   exact session; otherwise the real control flow, placing each task on
   its kernel-proposed node after an O(1) host validation (plugin
   predicates + fit on that node only).  Tasks whose proposal fails
   validation — and tasks the kernel cannot score faithfully
   (preferred-affinity terms) — take the host scoring path for that
   task alone, unless the device's reason counts prove the task fits
   no node (explain, ops/explain.py): then its FitErrors are synthesized
   from the counts and the O(N) host predicate sweep is skipped.

Explanations: ``execute_allocate(explain=True)`` returns the reason
counts of the kernel's unplaced rows with the assignment (reduced on the
sidecar when the session ran there, else on the kernel's device), and
each cycle's summary is published for ``GET /explain``
(``ops/explain.set_last_explain``, ``_publish_explain``), cleared when a
cycle explains nothing.

Failures: a kernel that fails raises ``ExecutorFailed`` out of
``execute`` before anything is applied, and an armed cycle deadline that
runs out raises ``CycleDeadlineExceeded`` the same way (counted by
``execute_allocate`` as a failure of the executor, cause ``deadline``).
Either way nothing is bound and nothing runs in the kernel's place.  A
staging failure raises too (the reference logs it and runs on the numpy
planes).

Tracing: with a live recorder (``volcano_tpu_torch.trace``) whose
sampling knob says so, the packed session, the kernel's assignment and
the kernel parameters are captured into the journal for replay
(``trace.replay.verify``), labelled with the executor that ran; each
explained cycle emits an ``explain-summary`` event, and an expired
deadline a ``watchdog:device-phase-abandoned`` event before it raises.

Not present in the port yet: the reference's host-chooser route under an
expired deadline.  With a compute-plane sidecar configured
(ops/executor.py) the planes are still staged and prestaged on this
process's device, as in the reference, so a session that falls back to
the in-process kernel finds them resident.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from volcano_tpu_torch import metrics, trace
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
from volcano_tpu_torch.faults.watchdog import CycleDeadlineExceeded
from volcano_tpu_torch.framework.interface import Action
from volcano_tpu_torch.framework.session import Session
from volcano_tpu_torch.ops import session_kernel
from volcano_tpu_torch.ops.device_stage import get_stager
from volcano_tpu_torch.ops.executor import (
    execute_allocate,
    last_allocate_executor,
    last_explain_counts,
    last_explain_ms,
)
from volcano_tpu_torch.ops.explain import (
    explain_enabled,
    ExplainResult,
    run_explain,
    session_explain_compatible,
    set_last_explain,
    task_exactly_encoded,
)
from volcano_tpu_torch.ops.kernels import DEFAULT_WEIGHTS, resolve_device
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

    def __init__(self, ssn: Session, nodes):
        self.ssn = ssn
        self.node_names = [n.name for n in nodes]
        #: node-state epoch at pack time — any later mutation advances it
        self._epoch0 = ssn.node_state_epoch
        #: task uid → (its snapshot, that snapshot's result, its row)
        self._rows: Dict[str, Tuple[object, ExplainResult, int]] = {}
        #: n_nodes of the reductions (one node set per session)
        self.n_nodes = len(nodes)
        #: task uid → reason histogram of the tasks whose FitErrors came
        #: from the counts, for the cycle summary
        self.explained: Dict[str, Dict[str, int]] = {}

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
        if (i >= len(result.counts) or not task_exactly_encoded(snap, i)
                or not result.all_infeasible(i)):
            return None
        hist = result.histogram(i)
        self.explained[task.uid] = hist
        for reason in hist:
            metrics.register_unschedulable_reason(reason)
        return result.fit_errors(i)

    def node_reasons(self, uid: str) -> Optional[Dict[str, str]]:
        """node name → failing reason for an explained task, where its
        reduction retained the per-pair plane; else None."""
        _, result, i = self._rows[uid]
        if result.reasons is None:
            return None
        return result.node_reasons(i, self.node_names)

    def summary(self) -> Dict[str, int]:
        """Aggregate reason → node-count histogram over the explained
        tasks."""
        agg: Dict[str, int] = {}
        for hist in self.explained.values():
            for reason, count in hist.items():
                agg[reason] = agg.get(reason, 0) + count
        return agg


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
    def __init__(
        self,
        device: Optional[Union[str, torch.device]] = None,
        explain: Optional[bool] = None,
        explain_planes: Optional[bool] = None,
    ):
        """``device`` is where the KERNEL phase and the explain reduction
        run: ``cuda`` when None (raising where there is no GPU),
        ``"cpu"`` for the PyTorch specification; a configured
        compute-plane sidecar runs the kernel on its own device instead.
        ``explain``: device-derived unschedulability explanations, on by
        default (the reduction runs only when a task went unplaced, so
        fully-placed cycles pay nothing); ``VTPU_NO_EXPLAIN=1`` or
        ``explain=False`` turns them off.  ``explain_planes`` (or
        ``VTPU_EXPLAIN_PLANES``) additionally retains the per-pair
        [T, N] reason plane for ``/explain``'s node-level attribution."""
        self.device = device
        self.explain = explain_enabled() if explain is None else explain
        self.explain_planes = (
            bool(os.environ.get("VTPU_EXPLAIN_PLANES"))
            if explain_planes is None
            else explain_planes
        )
        #: how the last execute() applied: "fast" (every task through the
        #: bulk commit), "loop" (the per-task loop), "" (nothing to apply)
        self.last_apply_route = ""
        #: phase timings (ms) of the last execute(), none inside another
        #: but commit and explain_kernel_rows: order, pack, execute,
        #: explain (= explain_pack, the pack of the rows ORDER left out,
        #: + explain_reduce, the reductions made after execute), apply,
        #: and commit (the bulk bind inside apply); explain_kernel_rows,
        #: the reduction of the kernel's unplaced rows inside execute
        #: (in-process only: over the sidecar it is inside the round
        #: trip and not timed here); explain_rows, the rows
        #: reduced; host_sweeps, the tasks that took the host chooser's
        #: O(N) predicate sweep, and explained, the tasks whose FitErrors
        #: came from the device's reason counts.  A warm-packed session
        #: adds the packer's ``last_stats`` (mode, cold_cause,
        #: repacked_tasks, reused_tasks, repacked_nodes),
        #: node_prepack_ms (the node planes packed and staged before
        #: ORDER), relay_overlap_ms (the ORDER window that copy
        #: overlapped), stage_ms and stage_bytes (the planes brought to
        #: the pack's revision on the device).  A session on the CUDA
        #: kernel adds prepare_ms (its operands ready on the device) and
        #: h2d_bytes (every byte the session copied to the device,
        #: staging included).
        self.last_phase_stats: Dict[str, float] = {}

    def name(self) -> str:
        return "gpu-allocate"

    # ---- phase 2 ----

    def _kernel_proposals(
        self, ssn: Session, ordered_tasks: List[TaskInfo], nodes: List, pack_cache=None,
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

        enforce = "predicates" in ssn.predicate_fns
        t0 = time.perf_counter()
        if pack_cache is not None and ssn.pack_epoch is not None:
            # warm path: delta-assemble from the cycle-persistent cache
            snap = pack_cache.pack(
                ordered_tasks, list(jobs.values()), nodes, ssn.pack_epoch,
                enforce_pod_count=enforce,
            )
            self.last_phase_stats.update(pack_cache.last_stats)
            if getattr(ssn.cache, "in_micro_cycle", False):
                # a micro-triggered cycle that still had to cold-rebuild
                # (registry overflow, axis change, …) paid full-cycle
                # cost — attribute the cause
                cause = pack_cache.last_stats.get("cold_cause")
                if cause is not None:
                    metrics.register_full_cycle_fallback(cause)
        else:
            snap = pack_session(
                ordered_tasks, list(jobs.values()), nodes, enforce_pod_count=enforce,
            )
        pack_s = time.perf_counter() - t0
        self.last_phase_stats["pack_ms"] = pack_s * 1e3
        metrics.update_kernel_duration("pack", pack_s)

        stage_bytes = 0
        if snap.cache_key is not None:
            # the device-resident mirror: only dirty rows travel; a
            # failure raises (nothing runs on the numpy planes instead)
            t0 = time.perf_counter()
            stager = get_stager(snap.cache_key, resolve_device(self.device))
            snap.device_planes = stager.stage(snap)
            stage_bytes = stager.take_bytes()
            self.last_phase_stats.update(stage_ms=(time.perf_counter() - t0) * 1e3,
                                         stage_bytes=stage_bytes)

        t0 = time.perf_counter()
        # ExecutorFailed and CycleDeadlineExceeded leave execute() here,
        # before anything session-side has mutated; explain=True brings
        # the reason counts of the unplaced rows back with the assignment
        try:
            assignment = execute_allocate(snap, device=self.device, explain=self.explain)
        except CycleDeadlineExceeded as e:
            # journaled before the cycle ends with nothing bound
            rec = ssn._trace
            if rec.enabled:
                rec.event("watchdog:device-phase-abandoned", "fault",
                          error=str(e))
            raise
        execute_s = time.perf_counter() - t0
        self.last_phase_stats["execute_ms"] = execute_s * 1e3
        metrics.update_kernel_duration("execute", execute_s)
        if last_allocate_executor() == "cuda":
            sk = session_kernel.last_session_stats
            self.last_phase_stats.update(
                prepare_ms=sk["prepare_ms"], h2d_bytes=stage_bytes + sk["h2d_bytes"])

        rec = ssn._trace
        if rec.enabled and rec.should_capture():
            # sampled journal capture: the packed session + the kernel's
            # assignment + the kernel parameters, the replayable tuple
            # trace.replay.verify diffs.  The label is the executor that
            # produced the assignment ('auto' when the compute-plane
            # sidecar ran it); the dispatch vocabulary is the replay one.
            rec.capture(
                snap,
                assignment,
                executor=last_allocate_executor(),
                weights=DEFAULT_WEIGHTS,
                gang_rounds=3,
            )

        proposals = {}
        for i, task in enumerate(ordered_tasks):
            if assignment[i] >= 0 and not snap.task_has_preferences[i]:
                proposals[task.uid] = nodes[assignment[i]].name
        return proposals, snap, assignment

    # ---- phase 3 ----

    def execute(self, ssn: Session) -> None:
        self.last_phase_stats = {"host_sweeps": 0, "explained": 0}
        self.last_apply_route = ""
        epoch = ssn.pack_epoch
        pc = getattr(ssn.cache, "pack_cache", None) if epoch is not None else None
        nodes = [ssn.nodes[name] for name in sorted(ssn.nodes)]

        # Warm cycles stage the dynamic node planes BEFORE the ORDER
        # phase: node rows don't depend on task order, so the host→device
        # copy runs while ORDER runs on the host and the rest of the
        # relay is only the (delta-sized) remaining planes.
        prestaged = False
        if pc is not None and nodes:
            t0 = time.perf_counter()
            stager = get_stager(pc.key, resolve_device(self.device))
            stager.take_bytes()  # this session's copies start here
            pending = pc.begin_nodes(nodes, epoch, "predicates" in ssn.predicate_fns)
            if pending is not None:
                stager.prestage(pending["planes"], pending["dirty_pos"], pc.rev + 1)
                prestaged = True
            self.last_phase_stats["node_prepack_ms"] = (time.perf_counter() - t0) * 1e3

        t0 = time.perf_counter()
        with ssn._trace.span("gpu-allocate:order", "action"):
            ordered = compute_task_order(ssn)
        order_ms = (time.perf_counter() - t0) * 1e3
        self.last_phase_stats["order_ms"] = order_ms
        if prestaged:
            # the window the staged copy had to overlap host work
            self.last_phase_stats["relay_overlap_ms"] = order_ms
        explain_ctx = None
        try:
            if not ordered:
                # nothing pending → nothing to explain; the finally
                # clears the surface so /explain never serves a previous
                # cycle
                return
            proposals, snap, assignment = self._kernel_proposals(ssn, ordered, nodes, pc)
            if snap is not None and self.explain:
                explain_ctx = self._explain_context(ssn, ordered, nodes, snap, assignment)

            t0 = time.perf_counter()
            self.last_apply_route = self._apply(ssn, ordered, proposals, snap, explain_ctx)
            self.last_phase_stats["apply_ms"] = (time.perf_counter() - t0) * 1e3
        finally:
            if explain_ctx is not None:
                self.last_phase_stats["explained"] = len(explain_ctx.explained)
            if self.explain:
                # also clears: a cycle that explained nothing (all
                # placed, gate closed, a kernel failure) must not leave
                # /explain serving a previous cycle's explanation
                self._publish_explain(ssn, explain_ctx)

    def _explain_context(self, ssn, ordered, nodes, snap, assignment
                         ) -> Optional[_ExplainContext]:
        """The reason counts of this cycle, or None when every ordered
        task placed or the session's predicates are not the ones the
        counts encode: the counts of the kernel's unplaced rows that
        ``execute_allocate`` brought back (reduced on the sidecar, or on
        the kernel's device), and — the port's addition to the
        reference, which sends these to the host sweep — a reduction over
        an explain-only pack of the pending tasks ORDER left out, on this
        action's device, so a saturated cycle explains every task it
        tries.  With ``explain_planes`` the per-pair reason planes of the
        rows that recorded any infeasibility are reduced here too (the
        wire ships counts only)."""
        counts = last_explain_counts()
        if counts is None or not session_explain_compatible(ssn):
            return None
        t0 = time.perf_counter()
        ctx = _ExplainContext(ssn, nodes)
        planes = None
        if self.explain_planes:
            planes = run_explain(snap, retain_planes=True,
                                 task_rows=np.nonzero(counts.sum(axis=1) > 0)[0],
                                 device=self.device).reasons
        ctx.add(snap, ExplainResult(counts, snap.n_nodes, planes), ordered)
        unplaced = np.nonzero(np.asarray(assignment)[: snap.n_tasks] < 0)[0]
        rows, pack_s = int(unplaced.size), 0.0
        kernel_rows_ms = last_explain_ms()
        if kernel_rows_ms is not None:
            self.last_phase_stats["explain_kernel_rows_ms"] = kernel_rows_ms
        pending = sum(len(job.task_status_index.get(TaskStatus.Pending, {}))
                      for job in ssn.jobs.values())
        rest = unordered_pending(ssn, ordered) if pending > len(ordered) else []
        if rest:
            tp = time.perf_counter()
            jobs = list({t.job: ssn.jobs[t.job] for t in rest}.values())
            extra = pack_session(rest, jobs, nodes,
                                 enforce_pod_count="predicates" in ssn.predicate_fns)
            pack_s = time.perf_counter() - tp
            ctx.add(extra, run_explain(extra, retain_planes=self.explain_planes,
                                       device=self.device), rest)
            rows += len(rest)
        reduce_ms = (time.perf_counter() - t0 - pack_s) * 1e3
        self.last_phase_stats.update(
            explain_ms=pack_s * 1e3 + reduce_ms, explain_pack_ms=pack_s * 1e3,
            explain_reduce_ms=reduce_ms, explain_rows=rows)
        return ctx

    def _publish_explain(self, ssn: Session, ctx: Optional[_ExplainContext]) -> None:
        """Per-cycle reason summary → trace journal + the ``/explain``
        surface (``ops/explain.set_last_explain``).  A ``None`` context
        or an empty explained set CLEARS the surface — it reflects the
        most recent cycle, never a stale one."""
        if ctx is None or not ctx.explained:
            set_last_explain(None)
            return
        summary = ctx.summary()
        rec = ssn._trace
        if rec.enabled:
            rec.event(
                "explain-summary", "action",
                tasks=len(ctx.explained), reasons=summary,
            )
        tasks = {}
        for uid, hist in ctx.explained.items():
            nodes = ctx.node_reasons(uid)
            tasks[uid] = {"reasons": hist, **({"nodes": nodes} if nodes is not None else {})}
        set_last_explain({
            "cycle": trace.current_cycle(),
            "n_nodes": ctx.n_nodes,
            "tasks": tasks,
            "summary": summary,
        })

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
