"""Statement — the session transaction log enabling gang all-or-nothing.

A copy of ``volcano_tpu/framework/statement.py``.

Reference: pkg/scheduler/framework/statement.go.  Operations apply to the
session state immediately (so subsequent decisions see them) and are logged;
Commit flushes side effects through the cache, Discard unwinds in reverse.
"""

from __future__ import annotations

from typing import List, Tuple, TYPE_CHECKING

from volcano_tpu_torch.api import TaskInfo, TaskStatus
from volcano_tpu_torch.utils.logging import get_logger

if TYPE_CHECKING:
    from volcano_tpu_torch.framework.session import Session

log = get_logger(__name__)


class Statement:
    def __init__(self, ssn: "Session"):
        self.ssn = ssn
        self.operations: List[Tuple[str, tuple]] = []

    # ---- evict (statement.go:40-113) ----

    def evict(self, reclaimee: TaskInfo, reason: str) -> None:
        self.ssn.touched_jobs.add(reclaimee.job)
        self.ssn.touched_nodes.add(reclaimee.node_name)
        self.ssn.node_state_epoch += 1
        job = self.ssn.jobs.get(reclaimee.job)
        if job is not None:
            job.update_task_status(reclaimee, TaskStatus.Releasing)
        node = self.ssn.nodes.get(reclaimee.node_name)
        if node is not None:
            node.update_task(reclaimee)
        self.ssn._fire_deallocate(reclaimee)
        self.operations.append(("evict", (reclaimee, reason)))

    def _commit_evict(self, reclaimee: TaskInfo, reason: str) -> None:
        try:
            self.ssn.cache.evict(reclaimee, reason)
        except Exception as e:  # noqa: BLE001 — bind/evict failures resync later
            log.error("Failed to evict task %s/%s: %s", reclaimee.namespace, reclaimee.name, e)
            self._unevict(reclaimee)
            return
        if self.ssn._trace.enabled:
            self.ssn._trace.decision(
                "evict", reclaimee.uid, reclaimee.node_name, reason
            )

    def _unevict(self, reclaimee: TaskInfo) -> None:
        job = self.ssn.jobs.get(reclaimee.job)
        if job is not None:
            job.update_task_status(reclaimee, TaskStatus.Running)
        node = self.ssn.nodes.get(reclaimee.node_name)
        if node is not None:
            node.update_task(reclaimee)
        self.ssn._fire_allocate(reclaimee)

    # ---- pipeline (statement.go:116-196) ----

    def pipeline(self, task: TaskInfo, hostname: str) -> None:
        self.ssn.touched_jobs.add(task.job)
        self.ssn.touched_nodes.add(hostname)
        self.ssn.node_state_epoch += 1
        job = self.ssn.jobs.get(task.job)
        if job is not None:
            job.update_task_status(task, TaskStatus.Pipelined)
        task.node_name = hostname
        node = self.ssn.nodes.get(hostname)
        if node is not None:
            node.add_task(task)
        self.ssn._fire_allocate(task)
        self.operations.append(("pipeline", (task, hostname)))

    def _unpipeline(self, task: TaskInfo) -> None:
        job = self.ssn.jobs.get(task.job)
        if job is not None:
            job.update_task_status(task, TaskStatus.Pending)
        node = self.ssn.nodes.get(task.node_name)
        if node is not None:
            node.remove_task(task)
        self.ssn._fire_deallocate(task)

    # ---- allocate (statement.go:199-305) ----

    def allocate(self, task: TaskInfo, hostname: str) -> None:
        self.ssn.touched_jobs.add(task.job)
        self.ssn.touched_nodes.add(hostname)
        self.ssn.node_state_epoch += 1
        self.ssn.cache.allocate_volumes(task, hostname)
        job = self.ssn.jobs.get(task.job)
        if job is None:
            raise KeyError(f"failed to find job {task.job}")
        job.update_task_status(task, TaskStatus.Allocated)
        task.node_name = hostname
        node = self.ssn.nodes.get(hostname)
        if node is None:
            raise KeyError(f"failed to find node {hostname}")
        node.add_task(task)
        self.ssn._fire_allocate(task)
        self.operations.append(("allocate", (task, hostname)))

    def _stage_allocate(self, task: TaskInfo, hostname: str,
                        pending: list) -> None:
        """Queue an allocate's cache bind for the next coalesced flush.
        The volume bind stays per-task and synchronous — its failure
        unwinds THIS task only (statement.go:263-270), before anything
        was staged for it."""
        try:
            self.ssn.cache.bind_volumes(task)
        except Exception as e:  # noqa: BLE001 — statement.go:263-270: a
            # volume-bind failure unwinds the allocation and resyncs from
            # API truth instead of binding a pod whose volumes never came
            log.error(
                "bind volumes of %s/%s failed: %s", task.namespace, task.name, e
            )
            self._unallocate(task)
            self.ssn.cache.resync_task(task)
            return
        pending.append(task)

    def _flush_binds(self, pending: list) -> None:
        """Land the staged allocates through ONE cache.bind_batch — the
        same per-task mutations in the same order under one mutex hold,
        with the binder effects coalesced into one commit-frame instead
        of per-object round trips.  Caches without bind_batch get the
        per-task calls."""
        if not pending:
            return
        cache = self.ssn.cache
        if hasattr(cache, "bind_batch"):
            cache.bind_batch([(t, t.node_name) for t in pending])
        else:
            for t in pending:
                cache.bind(t, t.node_name)
        for task in pending:
            if self.ssn._trace.enabled:
                self.ssn._trace.decision("bind", task.uid, task.node_name)
            job = self.ssn.jobs.get(task.job)
            if job is not None:
                job.update_task_status(task, TaskStatus.Binding)
        pending.clear()

    def _unallocate(self, task: TaskInfo) -> None:
        job = self.ssn.jobs.get(task.job)
        if job is not None:
            job.update_task_status(task, TaskStatus.Pending)
        node = self.ssn.nodes.get(task.node_name)
        if node is not None:
            node.remove_task(task)
        self.ssn._fire_deallocate(task)

    # ---- transaction end (statement.go:308-337) ----

    def discard(self) -> None:
        for name, args in reversed(self.operations):
            if name == "evict":
                self._unevict(args[0])
            elif name == "pipeline":
                self._unpipeline(args[0])
            elif name == "allocate":
                self._unallocate(args[0])
        self.operations.clear()

    def commit(self) -> None:
        # consecutive allocates coalesce into one bind_batch (one mutex
        # hold, one commit frame); an interleaved evict flushes first so
        # cache-side effect ordering matches the operation log
        pending: List[TaskInfo] = []
        for name, args in self.operations:
            if name == "evict":
                self._flush_binds(pending)
                self._commit_evict(*args)
            elif name == "allocate":
                self._stage_allocate(args[0], args[1], pending)
            # pipeline has no cache-side commit (statement.go:158-159),
            # but a committed pipeline IS a decision — journal it
            elif name == "pipeline" and self.ssn._trace.enabled:
                self.ssn._trace.decision("pipeline", args[0].uid, args[1])
        self._flush_binds(pending)
        self.operations.clear()
