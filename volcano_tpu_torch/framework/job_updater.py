"""Parallel job status writeback at session close.

A copy of ``volcano_tpu/framework/job_updater.py`` without the pipelined
commit plane: every writeback is the synchronous one.

Reference: pkg/scheduler/framework/job_updater.go.  The reference fans out
over 16 goroutines; host-side Python uses a thread pool for the same effect
(the writes are I/O-bound API calls).
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, TYPE_CHECKING

from volcano_tpu_torch.api import JobInfo
from volcano_tpu_torch.apis import scheduling
from volcano_tpu_torch import metrics
from volcano_tpu_torch.utils.logging import get_logger

if TYPE_CHECKING:
    from volcano_tpu_torch.framework.session import Session

log = get_logger(__name__)

_WORKERS = 16


def is_pod_group_status_updated(old, new) -> bool:
    """job_updater.go:56-76 — compare phase, counts and conditions."""
    if old is None or new is None:
        return True
    if old.phase != new.phase:
        return True
    if (old.running, old.succeeded, old.failed) != (new.running, new.succeeded, new.failed):
        return True
    old_conds = {(c.type, c.status, c.reason, c.message) for c in old.conditions}
    new_conds = {(c.type, c.status, c.reason, c.message) for c in new.conditions}
    return old_conds != new_conds


class JobUpdater:
    def __init__(self, ssn: "Session"):
        self.ssn = ssn
        self.job_queue: List[JobInfo] = list(ssn.jobs.values())

    def _update_job(self, job: JobInfo) -> None:
        ssn = self.ssn
        if job.pod_group is None:
            return
        # was the job already Running when this session OPENED?  The
        # conditions-based pod_group_status record is empty for healthy
        # Running groups, so the phase is snapshotted separately at open
        # (Session.pod_group_phase0) — steady-state Running jobs must
        # not re-count as a fresh "scheduled" attempt every cycle.
        was_running = (
            ssn.pod_group_phase0.get(job.uid) == scheduling.POD_GROUP_RUNNING
        )
        job.pod_group.status = ssn.job_status(job)
        old_status = ssn.pod_group_status.get(job.uid)
        # schedule_attempts_total (metrics.go:74-121): exactly ONE
        # attempt per job the session actually worked on, bucketed by
        # outcome (a writeback failure overrides it to "error")
        phase = job.pod_group.status.phase
        attempt = None
        if phase == scheduling.POD_GROUP_RUNNING:
            if not was_running:
                attempt = "scheduled"
                if job.creation_timestamp > 0:
                    metrics.update_job_schedule_duration(
                        max(time.time() - job.creation_timestamp, 0.0)
                    )
        elif job.job_fit_errors or phase == scheduling.POD_GROUP_UNKNOWN:
            attempt = "unschedulable"
        try:
            if is_pod_group_status_updated(old_status, job.pod_group.status):
                self.ssn.cache.update_job_status(job)
        except Exception as e:  # noqa: BLE001 — next session retries
            attempt = "error"
            log.error("Failed to update job status <%s/%s>: %s", job.namespace, job.name, e)
        if attempt is not None:
            metrics.register_schedule_attempt(attempt)

    def update_all(self) -> None:
        if not self.job_queue:
            return
        if len(self.job_queue) == 1:
            self._update_job(self.job_queue[0])
            return
        # the reference's 16-goroutine fan-out (job_updater.go), for the
        # I/O overlap of the status writes
        with ThreadPoolExecutor(max_workers=_WORKERS) as pool:
            list(pool.map(self._update_job, self.job_queue))
