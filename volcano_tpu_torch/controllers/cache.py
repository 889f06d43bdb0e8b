"""Controller job cache — local JobInfo store keyed ns/name.

A copy of ``volcano_tpu/controllers/cache.py``.

Reference: pkg/controllers/cache/cache.go:76-320 (jobCache with
delayed-clean of terminated jobs).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from volcano_tpu_torch.apis import batch, core
from volcano_tpu_torch.controllers.apis import JobInfo


class JobCache:
    def __init__(self):
        self._lock = threading.RLock()
        self._jobs: Dict[str, JobInfo] = {}  # guarded-by: self._lock
        self._deleted: List[str] = []  # guarded-by: self._lock

    @staticmethod
    def _job_key(job: batch.Job) -> str:
        return f"{job.metadata.namespace}/{job.metadata.name}"

    @staticmethod
    def _pod_job_key(pod: core.Pod) -> str:
        name = pod.metadata.annotations.get(batch.JOB_NAME_KEY, "")
        return f"{pod.metadata.namespace}/{name}"

    def get(self, key: str) -> Optional[JobInfo]:
        with self._lock:
            info = self._jobs.get(key)
            return info.clone() if info is not None else None

    def add(self, job: batch.Job) -> None:
        with self._lock:
            key = self._job_key(job)
            info = self._jobs.get(key)
            if info is None:
                self._jobs[key] = JobInfo(job)
            elif info.job is None:
                # pods arrived before the job object (cache.go Add on
                # a shell entry).
                info.set_job(job)
            else:
                raise ValueError(f"duplicated job {key}")

    def update(self, job: batch.Job) -> None:
        with self._lock:
            key = self._job_key(job)
            info = self._jobs.get(key)
            if info is None:
                self._jobs[key] = JobInfo(job)
            else:
                info.set_job(job)

    def delete(self, job: batch.Job) -> None:
        with self._lock:
            self._jobs.pop(self._job_key(job), None)

    def add_pod(self, pod: core.Pod) -> None:
        with self._lock:
            key = self._pod_job_key(pod)
            info = self._jobs.setdefault(key, JobInfo())
            info.add_pod(pod)

    def update_pod(self, pod: core.Pod) -> None:
        with self._lock:
            key = self._pod_job_key(pod)
            info = self._jobs.setdefault(key, JobInfo())
            info.update_pod(pod)

    def delete_pod(self, pod: core.Pod) -> None:
        with self._lock:
            key = self._pod_job_key(pod)
            info = self._jobs.get(key)
            if info is not None:
                info.delete_pod(pod)
                # GC shell entries whose job is gone and pods drained.
                if info.job is None and not info.pods:
                    del self._jobs[key]

    def task_completed(self, key: str, task_name: str) -> bool:
        """All pods of the task Succeeded (cache.go TaskCompleted)."""
        with self._lock:
            info = self._jobs.get(key)
            if info is None:
                return False
            pods = info.pods.get(task_name)
            if not pods:
                return False
            return all(p.status.phase == "Succeeded" for p in pods.values())
