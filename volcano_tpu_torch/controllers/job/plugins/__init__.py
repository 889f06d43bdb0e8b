"""Job-controller plugins: mutate pods/jobs at creation for distributed
workloads.

A copy of ``volcano_tpu/controllers/job/plugins/__init__.py``.

Reference: pkg/controllers/job/plugins — interface (OnPodCreate/OnJobAdd/
OnJobDelete, interface/interface.go:32-44) + env/ssh/svc implementations +
the builder registry (factory.go).
"""

from __future__ import annotations

import abc
from typing import Callable, Dict, List

from volcano_tpu_torch.apis import batch, core


class PluginInterface(abc.ABC):
    @abc.abstractmethod
    def name(self) -> str: ...

    def on_pod_create(self, pod: core.Pod, job: batch.Job) -> None:
        """Mutate the pod before creation."""

    def on_job_add(self, job: batch.Job) -> None:
        """Create auxiliary resources when the job is created."""

    def on_job_delete(self, job: batch.Job) -> None:
        """Clean auxiliary resources when the job is killed."""


PluginBuilder = Callable[[object, List[str]], PluginInterface]

_builders: Dict[str, PluginBuilder] = {}


def register_plugin_builder(name: str, builder: PluginBuilder) -> None:
    _builders[name] = builder


def get_plugin_builder(name: str) -> PluginBuilder:
    return _builders.get(name)


def plugin_done_key(plugin_name: str) -> str:
    """ControlledResources marker for an executed plugin."""
    return f"plugin-{plugin_name}"


from volcano_tpu_torch.controllers.job.plugins import env, ssh, svc  # noqa: E402

register_plugin_builder(env.PLUGIN_NAME, env.new)
register_plugin_builder(ssh.PLUGIN_NAME, ssh.new)
register_plugin_builder(svc.PLUGIN_NAME, svc.new)
