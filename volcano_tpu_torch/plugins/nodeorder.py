"""Nodeorder plugin — least-requested, balanced-allocation, node-affinity
and inter-pod-affinity node scoring.

A copy of ``volcano_tpu/plugins/nodeorder.py``.

Reference: pkg/scheduler/plugins/nodeorder/nodeorder.go, with the vendored
k8s priority formulas re-expressed natively:
- least requested: ((capacity-requested)*10/capacity averaged over cpu+mem)
  (vendor .../priorities/least_requested.go:36-53)
- balanced: 10*(1-|cpuFraction-memFraction|)
  (vendor .../priorities/balanced_resource_allocation.go:41-70)
- node affinity: sum of matching preferred term weights
  (vendor .../priorities/node_affinity.go)
"""

from __future__ import annotations

from typing import Dict, List

from volcano_tpu_torch.api import NodeInfo, TaskInfo
from volcano_tpu_torch.framework.arguments import Arguments
from volcano_tpu_torch.framework.events import EventHandler
from volcano_tpu_torch.framework.interface import Plugin
from volcano_tpu_torch.framework.session import Session
from volcano_tpu_torch.plugins import util as putil

PLUGIN_NAME = "nodeorder"

MAX_PRIORITY = 10

# Argument keys (nodeorder.go:37-45)
NODE_AFFINITY_WEIGHT = "nodeaffinity.weight"
POD_AFFINITY_WEIGHT = "podaffinity.weight"
LEAST_REQUESTED_WEIGHT = "leastrequested.weight"
BALANCED_RESOURCE_WEIGHT = "balancedresource.weight"


def least_requested_score(requested: float, capacity: float) -> int:
    """least_requested.go:44-53 (integer math preserved)."""
    if capacity == 0 or requested > capacity:
        return 0
    return int((capacity - requested) * MAX_PRIORITY // capacity)


def least_requested_priority(requested_cpu, requested_mem, alloc_cpu, alloc_mem) -> int:
    return (
        least_requested_score(requested_cpu, alloc_cpu)
        + least_requested_score(requested_mem, alloc_mem)
    ) // 2


def balanced_resource_priority(requested_cpu, requested_mem, alloc_cpu, alloc_mem) -> int:
    """balanced_resource_allocation.go:41-70."""

    def fraction(requested: float, capacity: float) -> float:
        if capacity == 0:
            return 1.0
        return requested / capacity

    cpu_fraction = fraction(requested_cpu, alloc_cpu)
    mem_fraction = fraction(requested_mem, alloc_mem)
    if cpu_fraction >= 1 or mem_fraction >= 1:
        return 0
    diff = abs(cpu_fraction - mem_fraction)
    return int((1 - diff) * MAX_PRIORITY)


class NodeOrderPlugin(Plugin):
    def __init__(self, arguments: Arguments):
        self.arguments = arguments
        self.least_req_weight = arguments.get_int(LEAST_REQUESTED_WEIGHT, 1)
        self.node_affinity_weight = arguments.get_int(NODE_AFFINITY_WEIGHT, 1)
        self.pod_affinity_weight = arguments.get_int(POD_AFFINITY_WEIGHT, 1)
        self.balanced_resource_weight = arguments.get_int(BALANCED_RESOURCE_WEIGHT, 1)

    def name(self) -> str:
        return PLUGIN_NAME

    def on_session_open(self, ssn: Session) -> None:
        pl = putil.PodLister(ssn)

        # Track allocations as the session mutates (nodeorder.go:133-158) —
        # node.used is maintained by NodeInfo itself; the lister tracks
        # which node each pod currently sits on for pod-affinity scoring.
        ssn.add_event_handler(
            EventHandler(
                allocate_func=lambda e: pl.update_task(e.task, e.task.node_name),
                deallocate_func=lambda e: pl.update_task(e.task, ""),
            )
        )

        def node_order_fn(task: TaskInfo, node: NodeInfo) -> float:
            """nodeorder.go:160-198."""
            # requested = node's current request + the incoming pod, the
            # vendored ResourceAllocationPriority semantics.
            requested_cpu = node.used.milli_cpu + task.resreq.milli_cpu
            requested_mem = node.used.memory + task.resreq.memory
            alloc_cpu = node.allocatable.milli_cpu
            alloc_mem = node.allocatable.memory

            score = 0.0
            score += float(
                least_requested_priority(requested_cpu, requested_mem, alloc_cpu, alloc_mem)
                * self.least_req_weight
            )
            score += float(
                balanced_resource_priority(requested_cpu, requested_mem, alloc_cpu, alloc_mem)
                * self.balanced_resource_weight
            )
            if task.pod is not None and node.node is not None:
                score += float(
                    putil.node_affinity_score(task.pod, node.node)
                    * self.node_affinity_weight
                )
            return score

        ssn.add_node_order_fn(self.name(), node_order_fn)

        def batch_node_order_fn(task: TaskInfo, nodes: List[NodeInfo]) -> Dict[str, float]:
            """nodeorder.go:201-218 — inter-pod affinity over all nodes."""
            if task.pod is None:
                return {}
            scores = putil.inter_pod_affinity_score(
                task.pod, nodes, ssn.nodes, pl.assigned_pods()
            )
            return {n: s * self.pod_affinity_weight for n, s in scores.items()}

        ssn.add_batch_node_order_fn(self.name(), batch_node_order_fn)


def new(arguments: Arguments) -> Plugin:
    return NodeOrderPlugin(arguments)
