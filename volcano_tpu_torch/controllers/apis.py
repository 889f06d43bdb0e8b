"""Controller-internal request and job-info types.

A copy of ``volcano_tpu/controllers/apis.py``.

Reference: pkg/controllers/apis/job_info.go.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from volcano_tpu_torch.apis import batch, core


@dataclass
class Request:
    """One unit of reconcile work (job_info.go:138-151)."""

    namespace: str = ""
    job_name: str = ""
    task_name: str = ""
    queue_name: str = ""
    event: str = ""
    action: str = ""
    job_version: int = 0
    exit_code: Optional[int] = None
    retries: int = 0

    def key(self) -> str:
        return f"{self.namespace}/{self.job_name}"


class JobInfo:
    """Controller-cache view of a job and its pods grouped by task
    (job_info.go:29-102)."""

    def __init__(self, job: Optional[batch.Job] = None):
        self.job = job
        self.name = job.metadata.name if job else ""
        self.namespace = job.metadata.namespace if job else ""
        # task name -> pod name -> pod
        self.pods: Dict[str, Dict[str, core.Pod]] = {}

    def clone(self) -> "JobInfo":
        out = JobInfo(self.job)
        out.name, out.namespace = self.name, self.namespace
        for task, pods in self.pods.items():
            out.pods[task] = dict(pods)
        return out

    def set_job(self, job: batch.Job) -> None:
        self.job = job
        self.name = job.metadata.name
        self.namespace = job.metadata.namespace

    def add_pod(self, pod: core.Pod) -> None:
        task = pod.metadata.annotations.get(batch.TASK_SPEC_KEY, "")
        if not task:
            raise ValueError(f"failed to find taskName of pod {pod.key()}")
        self.pods.setdefault(task, {})[pod.metadata.name] = pod

    def update_pod(self, pod: core.Pod) -> None:
        task = pod.metadata.annotations.get(batch.TASK_SPEC_KEY, "")
        if not task:
            raise ValueError(f"failed to find taskName of pod {pod.key()}")
        self.pods.setdefault(task, {})[pod.metadata.name] = pod

    def delete_pod(self, pod: core.Pod) -> None:
        task = pod.metadata.annotations.get(batch.TASK_SPEC_KEY, "")
        if not task:
            raise ValueError(f"failed to find taskName of pod {pod.key()}")
        bucket = self.pods.get(task)
        if bucket is not None:
            bucket.pop(pod.metadata.name, None)
            if not bucket:
                del self.pods[task]
