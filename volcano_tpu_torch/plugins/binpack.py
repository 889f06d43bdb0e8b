"""Binpack plugin — best-fit bin packing node score.

A copy of ``volcano_tpu/plugins/binpack.py``.

Reference: pkg/scheduler/plugins/binpack/binpack.go.
"""

from __future__ import annotations

from typing import Dict

from volcano_tpu_torch.api import NodeInfo, TaskInfo
from volcano_tpu_torch.api.resource import CPU, MEMORY
from volcano_tpu_torch.framework.arguments import Arguments
from volcano_tpu_torch.framework.interface import Plugin
from volcano_tpu_torch.framework.session import Session

PLUGIN_NAME = "binpack"

MAX_PRIORITY = 10  # schedulerapi.MaxPriority

# Argument keys (binpack.go:36-57)
BINPACK_WEIGHT = "binpack.weight"
BINPACK_CPU = "binpack.cpu"
BINPACK_MEMORY = "binpack.memory"
BINPACK_RESOURCES = "binpack.resources"
BINPACK_RESOURCES_PREFIX = "binpack.resources."


class PriorityWeight:
    def __init__(self, weight=1, cpu=1, memory=1, resources=None):
        self.bin_packing_weight = weight
        self.bin_packing_cpu = cpu
        self.bin_packing_memory = memory
        self.bin_packing_resources: Dict[str, int] = resources or {}


def calculate_weight(args: Arguments) -> PriorityWeight:
    """binpack.go:94-151."""
    w = PriorityWeight()
    w.bin_packing_weight = args.get_int(BINPACK_WEIGHT, 1)
    w.bin_packing_cpu = args.get_int(BINPACK_CPU, 1)
    if w.bin_packing_cpu < 0:
        w.bin_packing_cpu = 1
    w.bin_packing_memory = args.get_int(BINPACK_MEMORY, 1)
    if w.bin_packing_memory < 0:
        w.bin_packing_memory = 1
    for resource in args.get_list(BINPACK_RESOURCES):
        rw = args.get_int(BINPACK_RESOURCES_PREFIX + resource, 1)
        if rw < 0:
            rw = 1
        w.bin_packing_resources[resource] = rw
    return w


def resource_bin_packing_score(
    requested: float, capacity: float, used: float, weight: int
) -> float:
    """binpack.go:248-259 — (used+request)/capacity × weight, 0 if overflow."""
    if capacity == 0 or weight == 0:
        return 0.0
    used_finally = requested + used
    if used_finally > capacity:
        return 0.0
    return used_finally * float(weight) / capacity


def bin_packing_score(task: TaskInfo, node: NodeInfo, weight: PriorityWeight) -> float:
    """binpack.go:200-245."""
    score = 0.0
    weight_sum = 0
    requested = task.resreq
    allocatable = node.allocatable
    used = node.used

    for resource in requested.resource_names():
        request = requested.get(resource)
        if request == 0:
            continue
        if resource == CPU:
            resource_weight = weight.bin_packing_cpu
        elif resource == MEMORY:
            resource_weight = weight.bin_packing_memory
        elif resource in weight.bin_packing_resources:
            resource_weight = weight.bin_packing_resources[resource]
        else:
            continue
        score += resource_bin_packing_score(
            request, allocatable.get(resource), used.get(resource), resource_weight
        )
        weight_sum += resource_weight

    if weight_sum > 0:
        score /= float(weight_sum)
    return score * MAX_PRIORITY * float(weight.bin_packing_weight)


class BinpackPlugin(Plugin):
    def __init__(self, arguments: Arguments):
        self.weight = calculate_weight(arguments)

    def name(self) -> str:
        return PLUGIN_NAME

    def on_session_open(self, ssn: Session) -> None:
        if self.weight.bin_packing_weight == 0:
            return

        def node_order_fn(task: TaskInfo, node: NodeInfo) -> float:
            return bin_packing_score(task, node, self.weight)

        ssn.add_node_order_fn(self.name(), node_order_fn)


def new(arguments: Arguments) -> Plugin:
    return BinpackPlugin(arguments)
