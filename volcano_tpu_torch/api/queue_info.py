"""QueueInfo, NamespaceInfo and the namespace weight collection.

A copy of ``volcano_tpu/api/queue_info.py``.

Reference: pkg/scheduler/api/queue_info.go and namespace_info.go.
"""

from __future__ import annotations

from typing import Dict, Optional

from volcano_tpu_torch.apis import scheduling

DEFAULT_NAMESPACE_WEIGHT = 1
NAMESPACE_WEIGHT_KEY = "namespace.weight"


class QueueInfo:
    """Weighted queue (queue_info.go:29-66)."""

    def __init__(self, queue: scheduling.Queue):
        self.uid = queue.metadata.name
        self.name = queue.metadata.name
        self.weight = queue.spec.weight
        self.queue = queue

    def clone(self) -> "QueueInfo":
        return QueueInfo(self.queue)

    @property
    def creation_timestamp(self) -> float:
        return self.queue.metadata.creation_timestamp


class NamespaceInfo:
    """Namespace + scheduling weight (namespace_info.go:33-53)."""

    def __init__(self, name: str, weight: int = DEFAULT_NAMESPACE_WEIGHT):
        self.name = name
        self.weight = weight

    def get_weight(self) -> int:
        return self.weight if self.weight > 0 else DEFAULT_NAMESPACE_WEIGHT


class NamespaceCollection:
    """Derives a namespace's weight from its ResourceQuotas: the weight is
    the max over quotas of the ``namespace.weight`` hard limit, defaulting
    to 1 (namespace_info.go:74-141).  Modeled directly on weighted quota
    dicts: quota name → weight value.
    """

    def __init__(self, name: str):
        self.name = name
        self._quota_weights: Dict[str, int] = {}

    def update(self, quota_name: str, weight: Optional[int]) -> None:
        if weight is None:
            self._quota_weights.pop(quota_name, None)
        else:
            self._quota_weights[quota_name] = int(weight)

    def delete(self, quota_name: str) -> None:
        self._quota_weights.pop(quota_name, None)

    def snapshot(self) -> NamespaceInfo:
        weight = max(self._quota_weights.values(), default=DEFAULT_NAMESPACE_WEIGHT)
        return NamespaceInfo(self.name, max(weight, 0) or DEFAULT_NAMESPACE_WEIGHT)
