"""Job admission: defaulting mutation + deep validation.

A copy of ``volcano_tpu/admission/jobs.py``.

Reference: pkg/admission/jobs/mutate/mutate_job.go:105-143 and
jobs/validate/admit_job.go:103-258.

Validation SUBSET note: this module checks job/task naming (DNS-1123),
replica/minAvailable arithmetic, duplicate task names, policy event/
action legality (incl. exclusiveness rules), container identity
(DNS-1123 names, non-empty image), resource quantity syntax and
requests≤limits, restart-policy allowed values, port legality, env-var
names, volume-mount/volume cross-references, and pod volume/hostname/
subdomain identity.  The reference runs the complete vendored k8s
PodTemplateSpec validators (admit_job.go:194+ → k8s
validation.ValidatePodTemplateSpec); fields outside this subset
(probes, security contexts, lifecycle hooks) fail at pod-creation time
rather than at admission.  Documented in README "Known gaps".
"""

from __future__ import annotations

import re
from typing import List, Optional

from volcano_tpu_torch.apis import batch
from volcano_tpu_torch.client.apiserver import AdmissionError, APIServer

DEFAULT_QUEUE = "default"

_DNS1123_RE = re.compile(r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?$")
_DNS1123_MAX = 63


def is_dns1123_label(name: str) -> bool:
    return len(name) <= _DNS1123_MAX and bool(_DNS1123_RE.match(name))


def mutate_job(job: batch.Job) -> batch.Job:
    """Defaulting patch: queue="default", task name=default<idx>
    (mutate_job.go:105-143)."""
    if not job.spec.queue:
        job.spec.queue = DEFAULT_QUEUE
    for index, task in enumerate(job.spec.tasks):
        if not task.name:
            task.name = f"{batch.DEFAULT_TASK_SPEC}{index}"
    return job


def _validate_policies(policies: List[batch.LifecyclePolicy], path: str) -> List[str]:
    """admit_job.go validatePolicies: event/action legality, event+events
    exclusivity, duplicates, exit code rules."""
    msgs: List[str] = []
    events_seen = set()
    exit_codes_seen = set()
    for policy in policies:
        if policy.event and policy.events:
            msgs.append(f"{path}: both event and events are specified")
        for event in [policy.event, *policy.events]:
            if event and event not in batch.VALID_EVENTS:
                msgs.append(f"{path}: invalid event {event}")
            if event:
                if event in events_seen:
                    msgs.append(f"{path}: duplicate event {event}")
                events_seen.add(event)
        if policy.action and policy.action not in batch.VALID_ACTIONS:
            msgs.append(f"{path}: invalid action {policy.action}")
        if policy.exit_code is not None:
            if policy.exit_code == 0:
                msgs.append(f"{path}: 0 is not a valid error code")
            if policy.exit_code in exit_codes_seen:
                msgs.append(f"{path}: duplicate exitCode {policy.exit_code}")
            exit_codes_seen.add(policy.exit_code)
        if not policy.event and not policy.events and policy.exit_code is None:
            msgs.append(f"{path}: either event(s) or exitCode must be specified")
    return msgs


_VALID_RESTART_POLICIES = {"", "Always", "OnFailure", "Never"}
_VALID_PROTOCOLS = {"TCP", "UDP", "SCTP"}
#: k8s validation.IsEnvVarName
_ENV_NAME_RE = re.compile(r"^[-._a-zA-Z][-._a-zA-Z0-9]*$")


def _validate_task_template(task: batch.TaskSpec, index: int) -> List[str]:
    """admit_job.go:194+ validateTaskTemplate — the used subset of the
    k8s pod-template validators: container identity, resource quantity
    parse + requests≤limits, restart policy, port legality."""
    from volcano_tpu_torch.apis import quantity

    msgs: List[str] = []
    path = f"spec.tasks[{index}].template"
    spec = task.template.spec

    if spec.restart_policy not in _VALID_RESTART_POLICIES:
        msgs.append(
            f"{path}.spec.restartPolicy: unsupported value "
            f"{spec.restart_policy!r};"
        )

    # pod-level identity: volume names unique + DNS-1123; hostname /
    # subdomain DNS-1123 when set (k8s ValidatePodSpec)
    volume_names = set()
    for vi, vol in enumerate(spec.volumes or []):
        vpath = f"{path}.spec.volumes[{vi}]"
        # invalid names are flagged once and kept OUT of volume_names:
        # they can't satisfy a mount reference, and two unnamed volumes
        # are not "duplicates" of each other
        if not vol.name or not is_dns1123_label(vol.name):
            msgs.append(f"{vpath}.name: must be a valid DNS-1123 label;")
        elif vol.name in volume_names:
            msgs.append(f"{vpath}.name: duplicate volume name {vol.name!r};")
        else:
            volume_names.add(vol.name)
    if spec.hostname and not is_dns1123_label(spec.hostname):
        msgs.append(f"{path}.spec.hostname: must be a valid DNS-1123 label;")
    if spec.subdomain and not is_dns1123_label(spec.subdomain):
        msgs.append(f"{path}.spec.subdomain: must be a valid DNS-1123 label;")

    container_names = set()
    all_containers = [
        (f"{path}.spec.initContainers[{ci}]", c)
        for ci, c in enumerate(getattr(spec, "init_containers", []) or [])
    ] + [
        (f"{path}.spec.containers[{ci}]", c)
        for ci, c in enumerate(spec.containers)
    ]
    for cpath, container in all_containers:
        # port dedup is PER CONTAINER (k8s allows two containers to
        # declare the same containerPort; only hostPort conflicts matter
        # across containers, which scheduling handles)
        port_keys = set()
        port_names = set()
        if not container.name or not is_dns1123_label(container.name):
            msgs.append(f"{cpath}.name: must be a valid DNS-1123 label;")
        if container.name in container_names:
            msgs.append(f"{cpath}.name: duplicate container name {container.name!r};")
        container_names.add(container.name)

        # k8s validation.ValidateContainers: image is required — an
        # imageless template is undeployable and previously failed only
        # at pod-creation time, far from the submitter (admit_job.go:194+)
        if not container.image:
            msgs.append(f"{cpath}.image: required;")

        resources = container.resources or {}
        parsed = {}
        for field_name in ("requests", "limits"):
            for res, value in (resources.get(field_name) or {}).items():
                try:
                    parsed[(field_name, res)] = quantity.parse_quantity(value)
                except (ValueError, TypeError):
                    msgs.append(
                        f"{cpath}.resources.{field_name}[{res}]: "
                        f"invalid quantity {value!r};"
                    )
                    continue
                if parsed[(field_name, res)] < 0:
                    msgs.append(
                        f"{cpath}.resources.{field_name}[{res}]: "
                        "must be non-negative;"
                    )
        for res in resources.get("requests") or {}:
            req = parsed.get(("requests", res))
            lim = parsed.get(("limits", res))
            if req is not None and lim is not None and req > lim:
                msgs.append(
                    f"{cpath}.resources.requests[{res}]: "
                    "must be less than or equal to the limit;"
                )

        for ei, env in enumerate(container.env or []):
            epath = f"{cpath}.env[{ei}]"
            # duplicates are VALID in k8s (last entry wins) — only the
            # name syntax is checked, matching validation.ValidateEnv
            if not env.name or not _ENV_NAME_RE.match(env.name):
                msgs.append(f"{epath}.name: not a valid environment variable name;")

        mount_paths_seen = set()
        for mi, mount in enumerate(container.volume_mounts or []):
            mpath = f"{cpath}.volumeMounts[{mi}]"
            if not mount.mount_path:
                msgs.append(f"{mpath}.mountPath: required;")
            elif mount.mount_path in mount_paths_seen:
                msgs.append(
                    f"{mpath}.mountPath: duplicate mount path "
                    f"{mount.mount_path!r};"
                )
            mount_paths_seen.add(mount.mount_path)
            if mount.name not in volume_names:
                msgs.append(
                    f"{mpath}.name: volume {mount.name!r} not declared "
                    "in spec.volumes;"
                )

        for pi, port in enumerate(container.ports):
            ppath = f"{cpath}.ports[{pi}]"
            if not (0 < port.container_port < 65536):
                msgs.append(f"{ppath}.containerPort: must be between 1 and 65535;")
            if port.host_port and not (0 < port.host_port < 65536):
                msgs.append(f"{ppath}.hostPort: must be between 1 and 65535;")
            if port.protocol and port.protocol not in _VALID_PROTOCOLS:
                msgs.append(f"{ppath}.protocol: unsupported protocol {port.protocol!r};")
            if port.name:
                if port.name in port_names:
                    msgs.append(f"{ppath}.name: duplicate port name {port.name!r};")
                port_names.add(port.name)
            key = (port.container_port, port.protocol or "TCP")
            if key in port_keys:
                msgs.append(
                    f"{ppath}.containerPort: duplicate port "
                    f"{port.container_port}/{port.protocol or 'TCP'};"
                )
            port_keys.add(key)
    return msgs


def validate_job(job: batch.Job, api: Optional[APIServer] = None) -> None:
    """admit_job.go:103-192 — raises AdmissionError on the first deny."""
    if job.spec.min_available <= 0:
        raise AdmissionError("'minAvailable' must be greater than zero.")
    if job.spec.max_retry < 0:
        raise AdmissionError("'maxRetry' cannot be less than zero.")
    if (
        job.spec.ttl_seconds_after_finished is not None
        and job.spec.ttl_seconds_after_finished < 0
    ):
        raise AdmissionError("'ttlSecondsAfterFinished' cannot be less than zero.")
    if not job.spec.tasks:
        raise AdmissionError("No task specified in job spec")

    msgs: List[str] = []
    task_names = set()
    total_replicas = 0
    for index, task in enumerate(job.spec.tasks):
        if task.replicas <= 0:
            msgs.append(f"'replicas' is not set positive in task: {task.name};")
        total_replicas += max(task.replicas, 0)
        if not is_dns1123_label(task.name):
            msgs.append(f"task name {task.name!r} must be a valid DNS-1123 label;")
        if task.name in task_names:
            msgs.append(f"duplicated task name {task.name};")
            break
        task_names.add(task.name)
        msgs.extend(_validate_policies(task.policies, f"spec.tasks[{index}].policies"))
        if not task.template.spec.containers:
            msgs.append(f"task {task.name} has no containers in pod template;")
        else:
            msgs.extend(_validate_task_template(task, index))

    if total_replicas < job.spec.min_available:
        msgs.append("'minAvailable' should not be greater than total replicas in tasks;")

    msgs.extend(_validate_policies(job.spec.policies, "spec.policies"))

    # Plugin existence (admit_job.go:169-176).
    from volcano_tpu_torch.controllers.job.plugins import get_plugin_builder

    for name in job.spec.plugins:
        if get_plugin_builder(name) is None:
            msgs.append(f"unable to find job plugin: {name}")

    # Duplicated volume mount paths (validateIO).
    mount_paths = set()
    for volume in job.spec.volumes:
        if not volume.mount_path:
            msgs.append("mountPath is required;")
        elif volume.mount_path in mount_paths:
            msgs.append(f"duplicated mountPath: {volume.mount_path};")
        mount_paths.add(volume.mount_path)

    # Queue existence (admit_job.go:179-185).
    if api is not None:
        if api.get("Queue", "", job.spec.queue) is None:
            msgs.append(f"unable to find job queue: {job.spec.queue}")

    if msgs:
        raise AdmissionError(" ".join(msgs))
