"""NodeInfo — per-session resource accounting for one node.

A copy of ``volcano_tpu/api/node_info.py``.

Reference: pkg/scheduler/api/node_info.go.
"""

from __future__ import annotations

from typing import Dict, Optional

from volcano_tpu_torch.api.job_info import TaskInfo
from volcano_tpu_torch.api.resource import empty_resource, Resource
from volcano_tpu_torch.api.types import NodePhase, TaskStatus
from volcano_tpu_torch.apis import core


class NodeInfo:
    """Idle/Used/Releasing/Pipelined accounting (node_info.go:27-58)."""

    def __init__(self, node: Optional[core.Node] = None):
        self.node = node
        self.name = node.metadata.name if node else ""
        self.releasing = empty_resource()
        self.pipelined = empty_resource()
        self.used = empty_resource()
        self.tasks: Dict[str, TaskInfo] = {}
        self.others: Dict[str, object] = {}
        if node is not None:
            self.allocatable = Resource.from_resource_list(node.status.allocatable)
            self.idle = self.allocatable.clone()
            self.capability = Resource.from_resource_list(node.status.capacity)
        else:
            self.idle = empty_resource()
            self.allocatable = empty_resource()
            self.capability = empty_resource()
        self.phase = NodePhase.NotReady
        self.reason = "UnInitialized"
        self._set_node_state(node, self.allocatable)

    # ---- state ----

    def _set_node_state(
        self, node: Optional[core.Node], allocatable: Optional[Resource] = None
    ) -> None:
        if node is None:
            self.phase, self.reason = NodePhase.NotReady, "UnInitialized"
            return
        if allocatable is None:
            allocatable = Resource.from_resource_list(node.status.allocatable)
        if not self.used.less_equal(allocatable):
            self.phase, self.reason = NodePhase.NotReady, "OutOfSync"
            return
        for cond in node.status.conditions:
            if cond.type == "Ready" and cond.status != "True":
                self.phase, self.reason = NodePhase.NotReady, "NotReady"
                return
        self.phase, self.reason = NodePhase.Ready, ""

    def ready(self) -> bool:
        return self.phase == NodePhase.Ready

    def set_node(self, node: core.Node) -> None:
        """Refresh from the API object, re-deriving Idle/Used from held tasks
        (node_info.go:158-190)."""
        allocatable = Resource.from_resource_list(node.status.allocatable)
        self._set_node_state(node, allocatable)
        if not self.ready():
            return
        self.node = node
        self.name = node.metadata.name
        self.allocatable = allocatable
        self.capability = Resource.from_resource_list(node.status.capacity)
        self.releasing = empty_resource()
        self.pipelined = empty_resource()
        self.idle = allocatable.clone()
        self.used = empty_resource()
        for task in self.tasks.values():
            if task.status == TaskStatus.Releasing:
                self.idle.sub(task.resreq)
                self.releasing.add(task.resreq)
                self.used.add(task.resreq)
            elif task.status == TaskStatus.Pipelined:
                self.pipelined.add(task.resreq)
            else:
                self.idle.sub(task.resreq)
                self.used.add(task.resreq)

    def future_idle(self) -> Resource:
        """Idle + Releasing − Pipelined (node_info.go:56-58)."""
        return self.idle.clone().add(self.releasing).sub_unchecked(self.pipelined)

    # ---- task accounting (node_info.go:205-275) ----

    def _allocate_idle(self, task: TaskInfo) -> None:
        if not task.resreq.less_equal(self.idle):
            self.phase, self.reason = NodePhase.NotReady, "OutOfSync"
            raise ValueError(f"Selected node {self.name} NotReady")
        self.idle.sub(task.resreq)

    def add_task(self, task: TaskInfo) -> None:
        key = task.uid
        if key in self.tasks:
            raise ValueError(f"task {task.namespace}/{task.name} already on node {self.name}")
        # Hold a copy so later status changes don't skew accounting.
        ti = task.clone()
        if self.node is not None:
            if ti.status == TaskStatus.Releasing:
                self._allocate_idle(ti)
                self.releasing.add(ti.resreq)
                self.used.add(ti.resreq)
            elif ti.status == TaskStatus.Pipelined:
                self.pipelined.add(ti.resreq)
            else:
                self._allocate_idle(ti)
                self.used.add(ti.resreq)
        self.tasks[key] = ti

    def remove_task(self, task: TaskInfo) -> None:
        stored = self.tasks.get(task.uid)
        if stored is None:
            raise KeyError(f"task {task.namespace}/{task.name} not on node {self.name}")
        if self.node is not None:
            if stored.status == TaskStatus.Releasing:
                self.releasing.sub_unchecked(stored.resreq)
                self.idle.add(stored.resreq)
                self.used.sub_unchecked(stored.resreq)
            elif stored.status == TaskStatus.Pipelined:
                self.pipelined.sub_unchecked(stored.resreq)
            else:
                self.idle.add(stored.resreq)
                self.used.sub_unchecked(stored.resreq)
        del self.tasks[task.uid]

    def update_task(self, task: TaskInfo) -> None:
        self.remove_task(task)
        self.add_task(task)

    def clone(self) -> "NodeInfo":
        # Field-level copy.  The reference clones by replay
        # (node_info.go: NewNodeInfo + AddTask per task), which re-parses
        # the node's quantity strings and re-runs per-task accounting —
        # ~150µs/node, the dominant cost of the session snapshot at 10k
        # nodes.  The copy keeps the incrementally-maintained accounting
        # exactly as the cache holds it (replay would also re-normalize
        # float op order; the cache's sequences are already the canonical
        # ones — see fast_apply's bit-identity contract).
        res = NodeInfo.__new__(NodeInfo)
        res.node = self.node
        res.name = self.name
        res.releasing = self.releasing.clone()
        res.pipelined = self.pipelined.clone()
        res.used = self.used.clone()
        res.idle = self.idle.clone()
        res.allocatable = self.allocatable.clone()
        res.capability = self.capability.clone()
        res.tasks = {uid: t.clone() for uid, t in self.tasks.items()}
        res.others = self.others
        res.phase = self.phase
        res.reason = self.reason
        return res

    @property
    def labels(self) -> Dict[str, str]:
        return self.node.metadata.labels if self.node else {}

    def __repr__(self) -> str:
        return f"Node ({self.name}): idle <{self.idle}>, used <{self.used}>"
