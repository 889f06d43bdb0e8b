"""env plugin — inject task index env vars into every container.

A copy of ``volcano_tpu/controllers/job/plugins/env.py``.

Reference: pkg/controllers/job/plugins/env/env.go:45-61 (VK_TASK_INDEX +
VC_TASK_INDEX from the pod name suffix).
"""

from __future__ import annotations

from typing import List

from volcano_tpu_torch.apis import batch, core
from volcano_tpu_torch.controllers.job.plugins import (
    plugin_done_key,
    PluginInterface,
)

PLUGIN_NAME = "env"

TASK_VK_INDEX = "VK_TASK_INDEX"
TASK_VC_INDEX = "VC_TASK_INDEX"


class EnvPlugin(PluginInterface):
    def __init__(self, client, arguments: List[str]):
        self.client = client
        self.arguments = arguments

    def name(self) -> str:
        return PLUGIN_NAME

    def on_pod_create(self, pod: core.Pod, job: batch.Job) -> None:
        index = pod.metadata.name.rsplit("-", 1)[-1]
        for container in pod.spec.containers:
            names = {e.name for e in container.env}
            if TASK_VK_INDEX not in names:
                container.env.append(core.EnvVar(name=TASK_VK_INDEX, value=index))
            if TASK_VC_INDEX not in names:
                container.env.append(core.EnvVar(name=TASK_VC_INDEX, value=index))

    def on_job_add(self, job: batch.Job) -> None:
        job.status.controlled_resources[plugin_done_key(PLUGIN_NAME)] = PLUGIN_NAME

    def on_job_delete(self, job: batch.Job) -> None:
        job.status.controlled_resources.pop(plugin_done_key(PLUGIN_NAME), None)


def new(client, arguments: List[str]) -> EnvPlugin:
    return EnvPlugin(client, arguments)
