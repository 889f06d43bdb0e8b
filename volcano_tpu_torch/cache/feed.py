"""Feed a cache from cluster state carried across as plain dicts.

The dicts are what ``apis.serde.to_dict`` (or ``K8sObject.to_dict``) of
either package gives: each is rebuilt as the port's API object with
``K8sObject.from_dict`` and delivered through the cache's event
handlers — by :func:`feed_from_dicts` as adds, in the order the
scheduler tests feed a cache (nodes, pods, PodGroups, queues, priority
classes, then PVCs), and by :func:`feed_events` as a stream of adds,
updates and deletes (``ops.synthetic.generate_loop_events``).
"""

from __future__ import annotations

from typing import Iterable, Sequence

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


#: event kind → (API type, the cache's add, update and delete handler names)
_HANDLERS = {
    "node": (core.Node, "add_node", "update_node", "delete_node"),
    "pod": (core.Pod, "add_pod", "update_pod", "delete_pod"),
    "pod_group": (scheduling.PodGroup, "add_pod_group", "update_pod_group",
                  "delete_pod_group"),
    "queue": (scheduling.Queue, "add_queue", "update_queue", "delete_queue"),
    "priority_class": (core.PriorityClass, "add_priority_class", None,
                       "delete_priority_class"),
    "pvc": (core.PersistentVolumeClaim, "add_pvc", "update_pvc", "delete_pvc"),
}


def feed_events(cache: SchedulerCache, events: Sequence[dict]) -> SchedulerCache:
    """Deliver each event ``{"op": "add" | "update" | "delete", "kind",
    "object"}`` (an update also carries ``"old"``) through the cache's
    handler for it; returns the cache."""
    for ev in events:
        cls, add, update, delete = _HANDLERS[ev["kind"]]
        obj = cls.from_dict(ev["object"])
        if ev["op"] == "add":
            getattr(cache, add)(obj)
        elif ev["op"] == "update":
            getattr(cache, update)(cls.from_dict(ev["old"]), obj)
        elif ev["op"] == "delete":
            getattr(cache, delete)(obj)
        else:
            raise ValueError(f"unknown event op {ev['op']!r}")
    return cache
