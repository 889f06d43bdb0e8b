"""Conformance plugin — never evict critical system pods.

A copy of ``volcano_tpu/plugins/conformance.py``.

Reference: pkg/scheduler/plugins/conformance/conformance.go.
"""

from __future__ import annotations

from typing import List

from volcano_tpu_torch.api import TaskInfo
from volcano_tpu_torch.framework.arguments import Arguments
from volcano_tpu_torch.framework.interface import Plugin
from volcano_tpu_torch.framework.session import Session

PLUGIN_NAME = "conformance"

_CRITICAL_POD_ANNOTATION = "scheduler.alpha.kubernetes.io/critical-pod"
_SYSTEM_NAMESPACE = "kube-system"
_SYSTEM_PRIORITY_CLASSES = ("system-cluster-critical", "system-node-critical")


def _is_critical(task: TaskInfo) -> bool:
    """conformance.go:45-60 — critical annotation, kube-system namespace, or
    system priority class."""
    pod = task.pod
    if task.namespace == _SYSTEM_NAMESPACE:
        return True
    if pod is None:
        return False
    if _CRITICAL_POD_ANNOTATION in pod.metadata.annotations:
        return True
    return pod.spec.priority_class_name in _SYSTEM_PRIORITY_CLASSES


class ConformancePlugin(Plugin):
    def __init__(self, arguments: Arguments):
        self.arguments = arguments

    def name(self) -> str:
        return PLUGIN_NAME

    def on_session_open(self, ssn: Session) -> None:
        def evictable_fn(evictor: TaskInfo, evictees: List[TaskInfo]) -> List[TaskInfo]:
            return [t for t in evictees if not _is_critical(t)]

        ssn.add_preemptable_fn(self.name(), evictable_fn)
        ssn.add_reclaimable_fn(self.name(), evictable_fn)


def new(arguments: Arguments) -> Plugin:
    return ConformancePlugin(arguments)
