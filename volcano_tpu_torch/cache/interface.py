"""Cache interface — the session's only channel for side effects.

A copy of ``volcano_tpu/cache/interface.py`` without the event-driven
scheduling surface (change listeners), which the port has not yet.

Reference: pkg/scheduler/cache/interface.go:27-77.
"""

from __future__ import annotations

import abc
from typing import Optional

from volcano_tpu_torch.api import ClusterInfo, JobInfo, TaskInfo
from volcano_tpu_torch.apis import scheduling


class Cache(abc.ABC):
    """Mirror of cluster state + executor of bind/evict/status effects."""

    @abc.abstractmethod
    def run(self) -> None:
        """Start watching events (interface.go:30)."""

    @abc.abstractmethod
    def snapshot(self) -> ClusterInfo:
        """Deep-copied, session-immutable cluster state (interface.go:36)."""

    @abc.abstractmethod
    def wait_for_cache_sync(self) -> bool: ...

    @abc.abstractmethod
    def bind(self, task: TaskInfo, hostname: str) -> None:
        """Bind the task's pod to the host (interface.go:39)."""

    @abc.abstractmethod
    def evict(self, task: TaskInfo, reason: str) -> None:
        """Evict the task's pod (interface.go:42)."""

    @abc.abstractmethod
    def record_job_status_event(self, job: JobInfo) -> None:
        """Emit a cluster event for the job's scheduling outcome (interface.go:45)."""

    @abc.abstractmethod
    def update_job_status(self, job: JobInfo) -> Optional[scheduling.PodGroup]:
        """Write PodGroup status back (interface.go:48)."""

    def allocate_volumes(self, task: TaskInfo, hostname: str) -> None:
        """interface.go:51 — volume binding is a no-op in the default cache."""

    def bind_volumes(self, task: TaskInfo) -> None:
        """interface.go:54."""


class Binder(abc.ABC):
    """interface.go:60-63."""

    @abc.abstractmethod
    def bind(self, task: TaskInfo, hostname: str) -> None: ...


class Evictor(abc.ABC):
    """interface.go:66-69."""

    @abc.abstractmethod
    def evict(self, task: TaskInfo) -> None: ...


class StatusUpdater(abc.ABC):
    """interface.go:72-77."""

    @abc.abstractmethod
    def update_pod_condition(self, task: TaskInfo, reason: str, message: str) -> None: ...

    @abc.abstractmethod
    def update_pod_group(self, pg: scheduling.PodGroup) -> Optional[scheduling.PodGroup]: ...
