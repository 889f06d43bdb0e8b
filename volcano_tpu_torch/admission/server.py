"""Webhook registration — wires admission hooks into the API server.

A copy of ``volcano_tpu/admission/server.py``.

Reference: cmd/admission/app/server.go:37-99 + pkg/admission/router
(path→handler registry; TLS/CA plumbing has no in-process equivalent).
"""

from __future__ import annotations

from volcano_tpu_torch.client.apiserver import APIServer


def register_webhooks(
    api: APIServer,
    scheduler_name: str = "volcano-tpu",
    gate_pods: bool = False,
) -> None:
    """Register mutate-then-validate hooks for Jobs and (optionally) the
    pod-creation gate.  ``gate_pods`` mirrors deploying the pod webhook —
    off by default like the reference's optional configuration."""
    from volcano_tpu_torch.admission.jobs import mutate_job, validate_job
    from volcano_tpu_torch.admission.pods import validate_pod

    def job_hook(operation: str, job):
        job = mutate_job(job)
        validate_job(job, api)
        return job

    api.register_admission("Job", "CREATE", job_hook)
    api.register_admission("Job", "UPDATE", job_hook)

    if gate_pods:
        api.register_admission(
            "Pod",
            "CREATE",
            lambda op, pod: (validate_pod(pod, api, scheduler_name), pod)[1],
        )
