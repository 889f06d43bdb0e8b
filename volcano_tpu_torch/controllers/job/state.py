"""Job lifecycle state machine — 8 states mapping Action → Sync/Kill with
a status-mutating callback.

A copy of ``volcano_tpu/controllers/job/state.py``.

Reference: pkg/controllers/job/state/*.go.  One module instead of eight
files; each state is a small class with the same Execute(action) shape.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Set

from volcano_tpu_torch.apis import batch
from volcano_tpu_torch.controllers.apis import JobInfo

#: Pod phases a kill retains (factory.go:37-44).
POD_RETAIN_PHASE_NONE: Set[str] = set()
POD_RETAIN_PHASE_SOFT: Set[str] = {"Succeeded", "Failed"}

DEFAULT_MAX_RETRY = 3

UpdateStatusFn = Callable[[batch.JobStatus], bool]
#: Wired by the controller at init (job_controller.go:217-218).
SyncJob: Callable[[JobInfo, Optional[UpdateStatusFn]], None] = None
KillJob: Callable[[JobInfo, Set[str], Optional[UpdateStatusFn]], None] = None


def total_tasks(job: batch.Job) -> int:
    """state/util.go TotalTasks."""
    return sum(task.replicas for task in job.spec.tasks)


class _State:
    def __init__(self, job_info: JobInfo):
        self.job = job_info


class PendingState(_State):
    """state/pending.go."""

    def execute(self, action: str) -> None:
        if action == batch.RESTART_JOB_ACTION:
            def fn(status):
                status.retry_count += 1
                status.state.phase = batch.JOB_RESTARTING
                return True
            KillJob(self.job, POD_RETAIN_PHASE_NONE, fn)
        elif action == batch.ABORT_JOB_ACTION:
            def fn(status):
                status.state.phase = batch.JOB_ABORTING
                return True
            KillJob(self.job, POD_RETAIN_PHASE_SOFT, fn)
        elif action == batch.COMPLETE_JOB_ACTION:
            def fn(status):
                status.state.phase = batch.JOB_COMPLETING
                return True
            KillJob(self.job, POD_RETAIN_PHASE_SOFT, fn)
        elif action == batch.TERMINATE_JOB_ACTION:
            def fn(status):
                status.state.phase = batch.JOB_TERMINATING
                return True
            KillJob(self.job, POD_RETAIN_PHASE_SOFT, fn)
        else:
            def fn(status):
                phase = batch.JOB_PENDING
                if self.job.job.spec.min_available <= (
                    status.running + status.succeeded + status.failed
                ):
                    phase = batch.JOB_RUNNING
                status.state.phase = phase
                return True
            SyncJob(self.job, fn)


class RunningState(_State):
    """state/running.go."""

    def execute(self, action: str) -> None:
        if action == batch.RESTART_JOB_ACTION:
            def fn(status):
                status.state.phase = batch.JOB_RESTARTING
                status.retry_count += 1
                return True
            KillJob(self.job, POD_RETAIN_PHASE_NONE, fn)
        elif action == batch.ABORT_JOB_ACTION:
            def fn(status):
                status.state.phase = batch.JOB_ABORTING
                return True
            KillJob(self.job, POD_RETAIN_PHASE_SOFT, fn)
        elif action == batch.TERMINATE_JOB_ACTION:
            def fn(status):
                status.state.phase = batch.JOB_TERMINATING
                return True
            KillJob(self.job, POD_RETAIN_PHASE_SOFT, fn)
        elif action == batch.COMPLETE_JOB_ACTION:
            def fn(status):
                status.state.phase = batch.JOB_COMPLETING
                return True
            KillJob(self.job, POD_RETAIN_PHASE_SOFT, fn)
        else:
            def fn(status):
                if status.succeeded + status.failed == total_tasks(self.job.job):
                    status.state.phase = batch.JOB_COMPLETED
                    return True
                return False
            SyncJob(self.job, fn)


class RestartingState(_State):
    """state/restarting.go — every action re-kills until retry budget or
    restartable."""

    def execute(self, action: str) -> None:
        def fn(status):
            max_retry = self.job.job.spec.max_retry or DEFAULT_MAX_RETRY
            if status.retry_count >= max_retry:
                status.state.phase = batch.JOB_FAILED
                return True
            if total_tasks(self.job.job) - status.terminating >= status.min_available:
                status.state.phase = batch.JOB_PENDING
                return True
            return False

        KillJob(self.job, POD_RETAIN_PHASE_NONE, fn)


class AbortingState(_State):
    """state/aborting.go."""

    def execute(self, action: str) -> None:
        if action == batch.RESUME_JOB_ACTION:
            def fn(status):
                status.state.phase = batch.JOB_RESTARTING
                status.retry_count += 1
                return True
            KillJob(self.job, POD_RETAIN_PHASE_SOFT, fn)
        else:
            def fn(status):
                if status.terminating or status.pending or status.running:
                    return False
                status.state.phase = batch.JOB_ABORTED
                return True
            KillJob(self.job, POD_RETAIN_PHASE_SOFT, fn)


class AbortedState(_State):
    """state/aborted.go."""

    def execute(self, action: str) -> None:
        if action == batch.RESUME_JOB_ACTION:
            def fn(status):
                status.state.phase = batch.JOB_RESTARTING
                status.retry_count += 1
                return True
            KillJob(self.job, POD_RETAIN_PHASE_SOFT, fn)
        else:
            KillJob(self.job, POD_RETAIN_PHASE_SOFT, None)


class TerminatingState(_State):
    """state/terminating.go."""

    def execute(self, action: str) -> None:
        def fn(status):
            if status.terminating or status.pending or status.running:
                return False
            status.state.phase = batch.JOB_TERMINATED
            return True

        KillJob(self.job, POD_RETAIN_PHASE_SOFT, fn)


class CompletingState(_State):
    """state/completing.go."""

    def execute(self, action: str) -> None:
        def fn(status):
            if status.terminating or status.pending or status.running:
                return False
            status.state.phase = batch.JOB_COMPLETED
            return True

        KillJob(self.job, POD_RETAIN_PHASE_SOFT, fn)


class FinishedState(_State):
    """state/finished.go — always re-kill non-retained pods."""

    def execute(self, action: str) -> None:
        KillJob(self.job, POD_RETAIN_PHASE_SOFT, None)


_STATES: Dict[str, type] = {
    batch.JOB_PENDING: PendingState,
    batch.JOB_RUNNING: RunningState,
    batch.JOB_RESTARTING: RestartingState,
    batch.JOB_TERMINATED: FinishedState,
    batch.JOB_COMPLETED: FinishedState,
    batch.JOB_FAILED: FinishedState,
    batch.JOB_TERMINATING: TerminatingState,
    batch.JOB_ABORTING: AbortingState,
    batch.JOB_ABORTED: AbortedState,
    batch.JOB_COMPLETING: CompletingState,
}


def new_state(job_info: JobInfo) -> _State:
    """state/factory.go:61-84 — pending by default."""
    phase = job_info.job.status.state.phase if job_info.job else batch.JOB_PENDING
    cls = _STATES.get(phase, PendingState)
    return cls(job_info)
