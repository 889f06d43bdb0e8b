"""Core Kubernetes-style objects used by the framework.

A copy of ``volcano_tpu/apis/core.py``.

Only the fields the reference framework actually reads/writes are modeled
(e.g. Pod: requests/ports/selector/affinity/tolerations/priority; Node:
allocatable/capacity/taints/labels/conditions).  Affinity is kept as the
k8s dict schema and interpreted by the predicate/score layers.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from volcano_tpu_torch.apis import serde


@dataclass
class OwnerReference:
    api_version: str = ""
    kind: str = ""
    name: str = ""
    uid: str = ""
    controller: bool = False
    block_owner_deletion: bool = False


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    uid: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    creation_timestamp: float = 0.0
    resource_version: int = 0
    owner_references: List[OwnerReference] = field(default_factory=list)
    deletion_timestamp: Optional[float] = None

    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class K8sObject:
    """Base for all API objects: kind + metadata + dict round-trip."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)

    @property
    def kind(self) -> str:
        return type(self).__name__

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

    def key(self) -> str:
        return self.metadata.key()

    def to_dict(self) -> dict:
        out = serde.to_dict(self)
        out["kind"] = self.kind
        return out

    @classmethod
    def from_dict(cls, data: dict):
        data = {k: v for k, v in data.items() if k not in ("kind", "apiVersion")}
        return serde.from_dict(cls, data)

    def clone(self):
        # a structural copy (serde.structural_copy: deepcopy's result,
        # without its generic dispatch), NOT a to_dict/from_dict round
        # trip: the store clones on every get/update/notify.  Objects
        # built from the wire still normalize through from_dict; a clone
        # of a well-formed object is structurally identical either way.
        return serde.structural_copy(self)


@dataclass
class Toleration:
    key: str = ""
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # "" tolerates all effects
    toleration_seconds: Optional[int] = None


@dataclass
class Taint:
    key: str = ""
    value: str = ""
    effect: str = "NoSchedule"  # NoSchedule | PreferNoSchedule | NoExecute


@dataclass
class ContainerPort:
    container_port: int = 0
    host_port: int = 0
    protocol: str = "TCP"
    name: str = ""


@dataclass
class EnvVar:
    name: str = ""
    value: str = ""


@dataclass
class VolumeMount:
    name: str = ""
    mount_path: str = ""
    sub_path: str = ""
    read_only: bool = False


@dataclass
class Container:
    name: str = "main"
    image: str = ""
    command: List[str] = field(default_factory=list)
    args: List[str] = field(default_factory=list)
    # {"requests": {"cpu": "1", ...}, "limits": {...}}
    resources: Dict[str, Dict[str, object]] = field(default_factory=dict)
    ports: List[ContainerPort] = field(default_factory=list)
    env: List[EnvVar] = field(default_factory=list)
    volume_mounts: List[VolumeMount] = field(default_factory=list)
    working_dir: str = ""


@dataclass
class Volume:
    name: str = ""
    # one of: {"persistentVolumeClaim": {"claimName": ...}}, {"configMap": ...},
    # {"secret": {"secretName": ...}}, {"emptyDir": {}} — kept schemaless.
    source: Dict[str, object] = field(default_factory=dict)


@dataclass
class PodSpec:
    containers: List[Container] = field(default_factory=list)
    init_containers: List[Container] = field(default_factory=list)
    node_name: str = ""
    node_selector: Dict[str, str] = field(default_factory=dict)
    # k8s affinity schema: nodeAffinity / podAffinity / podAntiAffinity dicts.
    affinity: Dict[str, object] = field(default_factory=dict)
    tolerations: List[Toleration] = field(default_factory=list)
    scheduler_name: str = ""
    priority: Optional[int] = None
    priority_class_name: str = ""
    restart_policy: str = "OnFailure"
    hostname: str = ""
    subdomain: str = ""
    service_account_name: str = ""
    volumes: List[Volume] = field(default_factory=list)


@dataclass
class PodCondition:
    type: str = ""
    status: str = ""
    reason: str = ""
    message: str = ""


@dataclass
class PodStatus:
    phase: str = "Pending"  # Pending|Running|Succeeded|Failed|Unknown
    reason: str = ""
    message: str = ""
    conditions: List[PodCondition] = field(default_factory=list)
    # exit code of first failed container, surfaced for lifecycle policies.
    exit_code: Optional[int] = None


@dataclass
class Pod(K8sObject):
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)


@dataclass
class PodTemplateSpec:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)


@dataclass
class NodeCondition:
    type: str = "Ready"
    status: str = "True"
    reason: str = ""


@dataclass
class NodeSpec:
    taints: List[Taint] = field(default_factory=list)
    unschedulable: bool = False


@dataclass
class NodeStatus:
    allocatable: Dict[str, object] = field(default_factory=dict)
    capacity: Dict[str, object] = field(default_factory=dict)
    conditions: List[NodeCondition] = field(default_factory=lambda: [NodeCondition()])


@dataclass
class Node(K8sObject):
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)


@dataclass
class PriorityClass(K8sObject):
    value: int = 0
    global_default: bool = False


@dataclass
class ConfigMap(K8sObject):
    data: Dict[str, str] = field(default_factory=dict)


@dataclass
class Secret(K8sObject):
    data: Dict[str, str] = field(default_factory=dict)
    type: str = "Opaque"


@dataclass
class ServicePort:
    name: str = ""
    port: int = 0
    protocol: str = "TCP"


@dataclass
class ServiceSpec:
    selector: Dict[str, str] = field(default_factory=dict)
    cluster_ip: str = ""
    ports: List[ServicePort] = field(default_factory=list)


@dataclass
class Service(K8sObject):
    spec: ServiceSpec = field(default_factory=ServiceSpec)


@dataclass
class PersistentVolumeClaim(K8sObject):
    spec: Dict[str, object] = field(default_factory=dict)
    status: Dict[str, object] = field(default_factory=dict)


@dataclass
class NetworkPolicy(K8sObject):
    spec: Dict[str, object] = field(default_factory=dict)


@dataclass
class Event(K8sObject):
    """Kubernetes Event — the user-facing audit trail.  ``count``
    aggregates repeats of the same (object, type, reason) — the message
    is deliberately NOT part of the aggregation key, matching the k8s
    correlator, so variable-detail repeats collapse into one Event
    (whose message refreshes to the latest occurrence)."""

    involved_object: Dict[str, str] = field(default_factory=dict)
    type: str = "Normal"
    reason: str = ""
    message: str = ""
    count: int = 1
