"""ClusterInfo — the immutable snapshot a session computes on.

A copy of ``volcano_tpu/api/cluster_info.py``.

Reference: pkg/scheduler/api/cluster_info.go.
"""

from __future__ import annotations

from typing import Dict

from volcano_tpu_torch.api.job_info import JobInfo
from volcano_tpu_torch.api.node_info import NodeInfo
from volcano_tpu_torch.api.queue_info import NamespaceInfo, QueueInfo


class ClusterInfo:
    def __init__(self):
        self.jobs: Dict[str, JobInfo] = {}
        self.nodes: Dict[str, NodeInfo] = {}
        self.queues: Dict[str, QueueInfo] = {}
        self.namespace_info: Dict[str, NamespaceInfo] = {}
        #: PVCs keyed "ns/name" — consumed by the volume-binding
        #: predicate (the vendored VolumeBindingChecker analogue).
        self.pvcs: Dict[str, object] = {}
        #: PackEpoch describing what changed since the warm packer's last
        #: consumed revision (cache/cache.py); None for caches that do
        #: not track dirtiness (tests' fakes, custom Cache impls).
        self.pack_epoch = None
        #: clone-pool generation for opt-in snapshot reuse (cache.snapshot
        #: ↔ cache.release_session_clones handshake)
        self.clone_gen: int = 0

    def __repr__(self) -> str:
        return (
            f"Cluster: {len(self.jobs)} jobs, {len(self.nodes)} nodes, "
            f"{len(self.queues)} queues"
        )
