"""Fit-error bookkeeping for unschedulable tasks.

A copy of ``volcano_tpu/api/unschedule_info.py``.

Reference: pkg/scheduler/api/unschedule_info.go.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional

# Well-known predicate failure reasons.
NODE_RESOURCE_FIT_FAILED = "node(s) resource fit failed"
NODE_POD_NUMBER_EXCEEDED = "node(s) pod number exceeded"
NODE_SELECTOR_MISMATCH = "node(s) didn't match node selector"
NODE_AFFINITY_MISMATCH = "node(s) didn't match node affinity"
NODE_TAINT_UNTOLERATED = "node(s) had taints that the pod didn't tolerate"
NODE_PORT_CONFLICT = "node(s) didn't have free ports for the requested pod ports"
NODE_UNSCHEDULABLE = "node(s) were unschedulable"
NODE_NOT_READY = "node(s) were not ready"
POD_AFFINITY_MISMATCH = "node(s) didn't match pod affinity/anti-affinity"


class FitError(Exception):
    """A task failed a predicate on one node."""

    def __init__(self, task, node, *reasons: str):
        self.task_name = getattr(task, "name", str(task))
        self.node_name = getattr(node, "name", str(node))
        self.reasons: List[str] = list(reasons)
        super().__init__(
            f"task {self.task_name} on node {self.node_name}: {', '.join(self.reasons)}"
        )


def format_fit_errors(total_nodes: int, histogram: Dict[str, int]) -> str:
    """The reference's aggregate message (unschedule_info.go Error()):
    ``0/N nodes are available: <count> <reason>, ...`` with the parts
    lexicographically sorted.  The single copy of the format string —
    host-collected FitErrors and device-derived reason counts both
    render through it, which is what makes the two byte-comparable."""
    parts = sorted(f"{count} {reason}" for reason, count in histogram.items())
    return f"0/{total_nodes} nodes are available: {', '.join(parts)}."


class FitErrors:
    """Aggregated per-node fit errors for one task (unschedule_info.go:22-110)."""

    def __init__(self):
        self.nodes: Dict[str, FitError] = {}
        self._message: str = ""
        #: device-derived reason histogram (ops/explain synthesis) —
        #: set instead of per-node FitError entries when the counts came
        #: off the device
        self._histogram: Optional[Dict[str, int]] = None
        self._total_nodes: int = 0

    def set_node_error(self, node_name: str, err: FitError) -> None:
        self.nodes[node_name] = err

    def set_error(self, message: str) -> None:
        self._message = message

    def set_histogram(self, total_nodes: int, histogram: Dict[str, int]) -> None:
        """Install an already-reduced reason histogram (the device
        explain path) in place of per-node errors."""
        self._histogram = dict(histogram)
        self._total_nodes = total_nodes

    def histogram(self) -> Dict[str, int]:
        """reason → node count, whichever way this FitErrors was built."""
        if self._histogram is not None:
            return dict(self._histogram)
        histogram: Counter = Counter()
        for err in self.nodes.values():
            for reason in err.reasons:
                histogram[reason] += 1
        return dict(histogram)

    def error(self) -> str:
        if self._message:
            return self._message
        total = (
            self._total_nodes if self._histogram is not None else len(self.nodes)
        )
        return format_fit_errors(total, self.histogram())
