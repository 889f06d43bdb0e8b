"""Admission webhooks: job validation/mutation + pod creation gate.

A copy of ``volcano_tpu/admission/__init__.py``.

Reference: pkg/admission — jobs/validate/admit_job.go, jobs/mutate/
mutate_job.go, pods/admit_pod.go, wired through the router into the API
server (here: registered as in-process admission hooks, the standalone
equivalent of webhook configurations with CA bundles).
"""

from volcano_tpu_torch.admission.jobs import DEFAULT_QUEUE, mutate_job, validate_job
from volcano_tpu_torch.admission.pods import validate_pod
from volcano_tpu_torch.admission.server import register_webhooks

__all__ = ["mutate_job", "validate_job", "validate_pod", "register_webhooks"]
