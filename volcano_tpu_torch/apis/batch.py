"""Batch API: the Job CRD with lifecycle policies.

A copy of ``volcano_tpu/apis/batch.py``.

Reference: pkg/apis/batch/v1alpha1/job.go — JobSpec (tasks, policies,
plugins, queue, maxRetry, TTL), lifecycle Events/Actions, JobPhases and
JobStatus with phase counts + Version + RetryCount fencing.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from volcano_tpu_torch.apis.core import K8sObject, PodTemplateSpec

# ---- Lifecycle events (job.go:124-144) ----
ANY_EVENT = "*"
POD_FAILED_EVENT = "PodFailed"
POD_EVICTED_EVENT = "PodEvicted"
JOB_UNKNOWN_EVENT = "Unknown"
TASK_COMPLETED_EVENT = "TaskCompleted"
OUT_OF_SYNC_EVENT = "OutOfSync"
COMMAND_ISSUED_EVENT = "CommandIssued"

VALID_EVENTS = {
    ANY_EVENT,
    POD_FAILED_EVENT,
    POD_EVICTED_EVENT,
    JOB_UNKNOWN_EVENT,
    TASK_COMPLETED_EVENT,
    OUT_OF_SYNC_EVENT,
    COMMAND_ISSUED_EVENT,
}

# ---- Lifecycle actions (job.go:149-172) ----
ABORT_JOB_ACTION = "AbortJob"
RESTART_JOB_ACTION = "RestartJob"
RESTART_TASK_ACTION = "RestartTask"
TERMINATE_JOB_ACTION = "TerminateJob"
COMPLETE_JOB_ACTION = "CompleteJob"
RESUME_JOB_ACTION = "ResumeJob"
SYNC_JOB_ACTION = "SyncJob"
ENQUEUE_JOB_ACTION = "EnqueueJob"

VALID_ACTIONS = {
    ABORT_JOB_ACTION,
    RESTART_JOB_ACTION,
    RESTART_TASK_ACTION,
    TERMINATE_JOB_ACTION,
    COMPLETE_JOB_ACTION,
    RESUME_JOB_ACTION,
}

# ---- Job phases (job.go:224-245) ----
JOB_PENDING = "Pending"
JOB_ABORTING = "Aborting"
JOB_ABORTED = "Aborted"
JOB_RUNNING = "Running"
JOB_RESTARTING = "Restarting"
JOB_COMPLETING = "Completing"
JOB_COMPLETED = "Completed"
JOB_TERMINATING = "Terminating"
JOB_TERMINATED = "Terminated"
JOB_FAILED = "Failed"

# Annotations stamped on every pod the job controller creates
# (reference: job_controller_util.go:102-105).
TASK_SPEC_KEY = "volcano-tpu.io/task-spec"
JOB_NAME_KEY = "volcano-tpu.io/job-name"
JOB_VERSION_KEY = "volcano-tpu.io/job-version"
DEFAULT_TASK_SPEC = "default"


@dataclass
class LifecyclePolicy:
    """Event/ExitCode → Action mapping (job.go:175-200)."""

    action: str = ""
    event: str = ""
    events: List[str] = field(default_factory=list)
    exit_code: Optional[int] = None
    timeout_seconds: Optional[float] = None

    def matches_event(self, event: str) -> bool:
        return (
            event == self.event
            or event in self.events
            or self.event == ANY_EVENT
            or ANY_EVENT in self.events
        )


@dataclass
class TaskSpec:
    name: str = ""
    replicas: int = 1
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    policies: List[LifecyclePolicy] = field(default_factory=list)


@dataclass
class VolumeSpec:
    mount_path: str = ""
    volume_claim_name: str = ""
    volume_claim: Dict[str, object] = field(default_factory=dict)


@dataclass
class JobSpec:
    scheduler_name: str = "volcano-tpu"
    min_available: int = 0
    volumes: List[VolumeSpec] = field(default_factory=list)
    tasks: List[TaskSpec] = field(default_factory=list)
    policies: List[LifecyclePolicy] = field(default_factory=list)
    # plugin name → arguments, e.g. {"ssh": [], "svc": [], "env": []}
    plugins: Dict[str, List[str]] = field(default_factory=dict)
    queue: str = "default"
    max_retry: int = 3
    ttl_seconds_after_finished: Optional[int] = None
    priority_class_name: str = ""


@dataclass
class JobCondition:
    status: str = ""
    last_transition_time: float = 0.0


@dataclass
class JobState:
    phase: str = JOB_PENDING
    reason: str = ""
    message: str = ""
    last_transition_time: float = 0.0


@dataclass
class JobStatus:
    state: JobState = field(default_factory=JobState)
    min_available: int = 0
    pending: int = 0
    running: int = 0
    succeeded: int = 0
    failed: int = 0
    terminating: int = 0
    unknown: int = 0
    version: int = 0
    retry_count: int = 0
    # kind/name of resources the controller created for the job
    # (services, configmaps, secrets) — job.go:303-306.
    controlled_resources: Dict[str, str] = field(default_factory=dict)


@dataclass
class Job(K8sObject):
    spec: JobSpec = field(default_factory=JobSpec)
    status: JobStatus = field(default_factory=JobStatus)
