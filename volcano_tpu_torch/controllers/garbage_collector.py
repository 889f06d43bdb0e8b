"""Garbage collector — TTLSecondsAfterFinished reaper for finished Jobs.

A copy of ``volcano_tpu/controllers/garbage_collector.py``.

Reference: pkg/controllers/garbagecollector/garbagecollector.go:47-165.
"""

from __future__ import annotations

import heapq
import time
from typing import List, Optional, Tuple

from volcano_tpu_torch.apis import batch
from volcano_tpu_torch.client import ADDED, APIServer, MODIFIED, NotFoundError, VolcanoClient
from volcano_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

_FINISHED = {batch.JOB_COMPLETED, batch.JOB_FAILED, batch.JOB_TERMINATED}


def is_job_finished(job: batch.Job) -> bool:
    return job.status.state.phase in _FINISHED


class GarbageCollector:
    def __init__(self, api: APIServer, clock=time.time):
        self.api = api
        self.vc = VolcanoClient(api)
        self.clock = clock
        # (fire_at, ns, name) delayed-delete heap (enqueueAfter :124).
        self._heap: List[Tuple[float, str, str]] = []
        api.watch("Job", self._on_job)

    def _on_job(self, event, old, new) -> None:
        if event not in (ADDED, MODIFIED):
            return
        job: batch.Job = new
        if job.spec.ttl_seconds_after_finished is None or not is_job_finished(job):
            return
        expire_at = (
            job.status.state.last_transition_time or job.metadata.creation_timestamp
        ) + job.spec.ttl_seconds_after_finished
        heapq.heappush(self._heap, (expire_at, job.metadata.namespace, job.metadata.name))

    def process_expired(self) -> int:
        """Delete every job whose TTL has passed; returns count."""
        n = 0
        now = self.clock()
        while self._heap and self._heap[0][0] <= now:
            _, namespace, name = heapq.heappop(self._heap)
            job = self.vc.get_job(namespace, name)
            if job is None:
                continue
            # Re-check TTL against current status (processJob freshness).
            if job.spec.ttl_seconds_after_finished is None or not is_job_finished(job):
                continue
            expire_at = (
                job.status.state.last_transition_time or job.metadata.creation_timestamp
            ) + job.spec.ttl_seconds_after_finished
            if expire_at > now:
                # Stale entry (job restarted and re-finished later):
                # re-push and keep draining the rest of the expired set.
                heapq.heappush(self._heap, (expire_at, namespace, name))
                continue
            try:
                self.vc.delete_job(namespace, name)
                n += 1
                log.info("GC deleted finished job %s/%s", namespace, name)
            except NotFoundError:
                pass
        return n

    def next_fire_at(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None
