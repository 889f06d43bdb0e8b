"""svc plugin — headless Service + hosts ConfigMap + NetworkPolicy for
stable intra-job DNS.

A copy of ``volcano_tpu/controllers/job/plugins/svc.py``.

Reference: pkg/controllers/job/plugins/svc/svc.go:72-134 — create a
headless service named after the job, publish every task pod's FQDN in a
ConfigMap (``hosts`` file style), restrict traffic with a NetworkPolicy,
and set each pod's hostname/subdomain so DNS resolves.
"""

from __future__ import annotations

from typing import List

from volcano_tpu_torch.apis import batch, core
from volcano_tpu_torch.client.apiserver import AlreadyExistsError
from volcano_tpu_torch.controllers.job.plugins import (
    plugin_done_key,
    PluginInterface,
)

PLUGIN_NAME = "svc"

CONFIG_MAP_TASK_KEY = "VC_TASK_HOSTS"


def _cm_name(job: batch.Job) -> str:
    return f"{job.metadata.name}-svc"


def hosts_for(job: batch.Job) -> List[str]:
    """FQDNs of every task pod (svc.go GenerateHosts)."""
    hosts = []
    for ts in job.spec.tasks:
        for i in range(ts.replicas):
            hosts.append(f"{job.metadata.name}-{ts.name}-{i}.{job.metadata.name}")
    return hosts


class SvcPlugin(PluginInterface):
    def __init__(self, client, arguments: List[str]):
        self.client = client  # KubeClient
        self.arguments = arguments

    def name(self) -> str:
        return PLUGIN_NAME

    def on_job_add(self, job: batch.Job) -> None:
        ns = job.metadata.namespace
        owner = core.OwnerReference(
            kind="Job", name=job.metadata.name, uid=job.metadata.uid, controller=True
        )

        if self.client.get_service(ns, job.metadata.name) is None:
            svc = core.Service(
                metadata=core.ObjectMeta(
                    name=job.metadata.name, namespace=ns, owner_references=[owner]
                ),
                spec=core.ServiceSpec(
                    cluster_ip="None",  # headless
                    selector={batch.JOB_NAME_KEY: job.metadata.name},
                ),
            )
            try:
                self.client.create_service(svc)
            except AlreadyExistsError:
                pass

        hosts = "\n".join(hosts_for(job))
        cm = self.client.get_config_map(ns, _cm_name(job))
        if cm is None:
            cm = core.ConfigMap(
                metadata=core.ObjectMeta(
                    name=_cm_name(job), namespace=ns, owner_references=[owner]
                ),
                data={CONFIG_MAP_TASK_KEY: hosts},
            )
            try:
                self.client.create_config_map(cm)
            except AlreadyExistsError:
                pass
        elif cm.data.get(CONFIG_MAP_TASK_KEY) != hosts:
            cm.data[CONFIG_MAP_TASK_KEY] = hosts
            self.client.update_config_map(cm)

        np = core.NetworkPolicy(
            metadata=core.ObjectMeta(
                name=job.metadata.name, namespace=ns, owner_references=[owner]
            ),
            spec={
                "podSelector": {"matchLabels": {batch.JOB_NAME_KEY: job.metadata.name}},
                "ingress": [
                    {"from": [{"podSelector": {"matchLabels": {batch.JOB_NAME_KEY: job.metadata.name}}}]}
                ],
            },
        )
        try:
            self.client.create_network_policy(np)
        except AlreadyExistsError:
            pass

        job.status.controlled_resources[plugin_done_key(PLUGIN_NAME)] = PLUGIN_NAME

    def on_pod_create(self, pod: core.Pod, job: batch.Job) -> None:
        """svc.go:72-99 — stable hostname/subdomain + hosts configmap
        mount."""
        if not pod.spec.hostname:
            pod.spec.hostname = pod.metadata.name
        if not pod.spec.subdomain:
            pod.spec.subdomain = job.metadata.name

        volume_name = f"{job.metadata.name}-svc"
        pod.spec.volumes.append(
            core.Volume(name=volume_name, source={"configMap": {"name": _cm_name(job)}})
        )
        for container in pod.spec.containers + pod.spec.init_containers:
            container.volume_mounts.append(
                core.VolumeMount(name=volume_name, mount_path="/etc/volcano")
            )

    def on_job_delete(self, job: batch.Job) -> None:
        job.status.controlled_resources.pop(plugin_done_key(PLUGIN_NAME), None)


def new(client, arguments: List[str]) -> SvcPlugin:
    return SvcPlugin(client, arguments)
