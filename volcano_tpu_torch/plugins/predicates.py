"""Predicates plugin — node feasibility checks.

A copy of ``volcano_tpu/plugins/predicates.py``.

Reference: pkg/scheduler/plugins/predicates/predicates.go, with the used
subset of the vendored k8s predicate algorithms implemented natively:
pod count, node condition/unschedulable, node selector + required node
affinity, host ports, taints/tolerations, optional memory/disk/pid
pressure, pod (anti-)affinity.
"""

from __future__ import annotations

from volcano_tpu_torch.api import FitError, NodeInfo, TaskInfo
from volcano_tpu_torch.api import unschedule_info as reasons
from volcano_tpu_torch.framework.arguments import Arguments
from volcano_tpu_torch.framework.events import EventHandler
from volcano_tpu_torch.framework.interface import Plugin
from volcano_tpu_torch.framework.session import Session
from volcano_tpu_torch.plugins import util as putil

PLUGIN_NAME = "predicates"

# Argument keys (predicates.go:37-43)
MEMORY_PRESSURE_PREDICATE = "predicate.MemoryPressureEnable"
DISK_PRESSURE_PREDICATE = "predicate.DiskPressureEnable"
PID_PRESSURE_PREDICATE = "predicate.PIDPressureEnable"


class PredicatesPlugin(Plugin):
    def __init__(self, arguments: Arguments):
        self.arguments = arguments
        self.memory_pressure_enable = arguments.get_bool(MEMORY_PRESSURE_PREDICATE, False)
        self.disk_pressure_enable = arguments.get_bool(DISK_PRESSURE_PREDICATE, False)
        self.pid_pressure_enable = arguments.get_bool(PID_PRESSURE_PREDICATE, False)

    def name(self) -> str:
        return PLUGIN_NAME

    def on_session_open(self, ssn: Session) -> None:
        pl = putil.PodLister(ssn)

        ssn.add_event_handler(
            EventHandler(
                allocate_func=lambda e: pl.update_task(e.task, e.task.node_name),
                deallocate_func=lambda e: pl.update_task(e.task, ""),
            )
        )

        def predicate_fn(task: TaskInfo, node: NodeInfo) -> None:
            """predicates.go:156-301; raises FitError on first failure."""
            # Pod number limit (predicates.go:164-168).
            if node.allocatable.max_task_num <= len(node.tasks):
                raise FitError(task, node, reasons.NODE_POD_NUMBER_EXCEEDED)

            node_obj = node.node
            if node_obj is None:
                raise FitError(task, node, reasons.NODE_NOT_READY)

            # CheckNodeCondition: Ready condition + pressure conditions.
            for cond in node_obj.status.conditions:
                if cond.type == "Ready" and cond.status != "True":
                    raise FitError(task, node, reasons.NODE_NOT_READY)
                if (
                    self.memory_pressure_enable
                    and cond.type == "MemoryPressure"
                    and cond.status == "True"
                ):
                    raise FitError(task, node, "node(s) had memory pressure")
                if (
                    self.disk_pressure_enable
                    and cond.type == "DiskPressure"
                    and cond.status == "True"
                ):
                    raise FitError(task, node, "node(s) had disk pressure")
                if (
                    self.pid_pressure_enable
                    and cond.type == "PIDPressure"
                    and cond.status == "True"
                ):
                    raise FitError(task, node, "node(s) had pid pressure")

            # CheckNodeUnschedulable.
            if node_obj.spec.unschedulable:
                raise FitError(task, node, reasons.NODE_UNSCHEDULABLE)

            pod = task.pod
            if pod is None:
                return

            # NodeSelector + required node affinity.
            if not putil.pod_matches_node_selector(pod, node_obj):
                raise FitError(task, node, reasons.NODE_SELECTOR_MISMATCH)

            # Taints/tolerations.
            if not putil.pod_tolerates_node_taints(pod, node_obj):
                raise FitError(task, node, reasons.NODE_TAINT_UNTOLERATED)

            # HostPorts.
            if not putil.fits_host_ports(pod, pl.pods_on_node(node)):
                raise FitError(task, node, reasons.NODE_PORT_CONFLICT)

            # Pod (anti-)affinity (predicates.go:280-298).
            if pod.spec.affinity and (
                pod.spec.affinity.get("podAffinity")
                or pod.spec.affinity.get("podAntiAffinity")
            ) or pl.any_required_anti_affinity():
                if not putil.pod_affinity_predicate(
                    pod, node, ssn.nodes, pl.assigned_pods()
                ):
                    raise FitError(task, node, reasons.POD_AFFINITY_MISMATCH)

            # Volume binding (the vendored VolumeBindingChecker /
            # FindPodVolumes analogue): every referenced PVC must exist
            # and be Bound or dynamically provisionable (storage class).
            for vol in pod.spec.volumes:
                ref = vol.source.get("persistentVolumeClaim")
                if not ref or not ref.get("claimName"):
                    continue
                key = f"{pod.metadata.namespace}/{ref['claimName']}"
                pvc = ssn.pvcs.get(key)
                if pvc is None:
                    raise FitError(
                        task, node, f'persistentvolumeclaim "{key}" not found'
                    )
                if pvc.status.get("phase") != "Bound" and not pvc.spec.get(
                    "storageClassName"
                ):
                    raise FitError(
                        task, node,
                        "pod has unbound immediate PersistentVolumeClaims",
                    )

        ssn.add_predicate_fn(self.name(), predicate_fn)


def new(arguments: Arguments) -> Plugin:
    return PredicatesPlugin(arguments)
