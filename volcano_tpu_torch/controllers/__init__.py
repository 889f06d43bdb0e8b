"""Controller manager (reference: pkg/controllers + cmd/controllers).

A copy of ``volcano_tpu/controllers/__init__.py``.
"""

from volcano_tpu_torch.controllers.apis import JobInfo, Request
from volcano_tpu_torch.controllers.cache import JobCache
from volcano_tpu_torch.controllers.garbage_collector import GarbageCollector
from volcano_tpu_torch.controllers.job.job_controller import JobController
from volcano_tpu_torch.controllers.podgroup_controller import PodGroupController
from volcano_tpu_torch.controllers.queue_controller import QueueController

__all__ = [
    "JobInfo",
    "Request",
    "JobCache",
    "GarbageCollector",
    "JobController",
    "PodGroupController",
    "QueueController",
]
