"""Feed a cache from cluster state carried across as plain dicts.

The dicts are what ``apis.serde.to_dict`` (or ``K8sObject.to_dict``) of
either package gives: each is rebuilt as the port's API object with
``K8sObject.from_dict`` and delivered through the cache's event
handlers, in the order the scheduler tests feed a cache: nodes, pods,
PodGroups, queues, priority classes, then PVCs.
"""

from __future__ import annotations

from typing import Iterable

from volcano_tpu_torch.apis import core, scheduling
from volcano_tpu_torch.cache.cache import SchedulerCache


def feed_from_dicts(
    cache: SchedulerCache,
    nodes: Iterable[dict] = (),
    pods: Iterable[dict] = (),
    pod_groups: Iterable[dict] = (),
    queues: Iterable[dict] = (),
    priority_classes: Iterable[dict] = (),
    pvcs: Iterable[dict] = (),
) -> SchedulerCache:
    """Add every object to ``cache``; returns the cache."""
    for d in nodes:
        cache.add_node(core.Node.from_dict(d))
    for d in pods:
        cache.add_pod(core.Pod.from_dict(d))
    for d in pod_groups:
        cache.add_pod_group(scheduling.PodGroup.from_dict(d))
    for d in queues:
        cache.add_queue(scheduling.Queue.from_dict(d))
    for d in priority_classes:
        cache.add_priority_class(core.PriorityClass.from_dict(d))
    for d in pvcs:
        cache.add_pvc(core.PersistentVolumeClaim.from_dict(d))
    return cache
