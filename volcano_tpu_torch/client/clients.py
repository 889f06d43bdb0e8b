"""Typed clients over the in-process API server.

A copy of ``volcano_tpu/client/clients.py``: the core group
(``KubeClient``: pods, nodes, services, config maps, secrets, PVCs,
network policies, priority classes, Events), the CRD group
(``VolcanoClient``: Jobs, PodGroups with their v1alpha1 creates,
Queues, Commands), the whole ``SchedulerClient`` and the Event
correlator ``record_event_via``.

Reference: the generated clientsets (pkg/client) — here thin typed
facades, since serde/codegen is unnecessary for in-process dataclasses.
``SchedulerClient`` is the adapter the scheduler cache drives for its
informer feed and bind/evict/status side effects.
"""

from __future__ import annotations

from typing import List, Optional

from volcano_tpu_torch.apis import batch, bus, core, scheduling, scheme
from volcano_tpu_torch.client.apiserver import ADDED, APIServer, DELETED, MODIFIED, NotFoundError


class KubeClient:
    """Core-group operations (pods/nodes/services/configmaps/secrets/pvcs)."""

    def __init__(self, api: APIServer):
        self.api = api

    # pods
    def create_pod(self, pod: core.Pod) -> core.Pod:
        return self.api.create(pod)

    def get_pod(self, namespace: str, name: str) -> Optional[core.Pod]:
        return self.api.get("Pod", namespace, name)

    def list_pods(self, namespace: Optional[str] = None) -> List[core.Pod]:
        return self.api.list("Pod", namespace)

    def delete_pod(self, namespace: str, name: str) -> None:
        self.api.delete("Pod", namespace, name)

    def bind_pod(self, namespace: str, name: str, hostname: str) -> None:
        """POST /binding equivalent (cache.go defaultBinder:122-134)."""
        pod = self.api.get("Pod", namespace, name)
        if pod is None:
            raise NotFoundError(f"pod {namespace}/{name} not found")
        pod.spec.node_name = hostname
        self.api.update_status(pod)

    def update_pod(self, pod: core.Pod) -> core.Pod:
        return self.api.update(pod)

    def update_pod_status(self, pod: core.Pod) -> core.Pod:
        return self.api.update_status(pod)

    def update_pod_condition(self, namespace: str, name: str, reason: str, message: str) -> None:
        pod = self.api.get("Pod", namespace, name)
        if pod is None:
            return
        for cond in pod.status.conditions:
            if cond.type == "PodScheduled":
                cond.status, cond.reason, cond.message = "False", reason, message
                break
        else:
            pod.status.conditions.append(
                core.PodCondition(type="PodScheduled", status="False", reason=reason, message=message)
            )
        self.api.update_status(pod)

    # nodes
    def create_node(self, node: core.Node) -> core.Node:
        return self.api.create(node)

    def list_nodes(self) -> List[core.Node]:
        return self.api.list("Node")

    # namespaced simple kinds
    def create_service(self, svc: core.Service) -> core.Service:
        return self.api.create(svc)

    def get_service(self, namespace: str, name: str) -> Optional[core.Service]:
        return self.api.get("Service", namespace, name)

    def create_config_map(self, cm: core.ConfigMap) -> core.ConfigMap:
        return self.api.create(cm)

    def get_config_map(self, namespace: str, name: str) -> Optional[core.ConfigMap]:
        return self.api.get("ConfigMap", namespace, name)

    def update_config_map(self, cm: core.ConfigMap) -> core.ConfigMap:
        return self.api.update(cm)

    def create_secret(self, secret: core.Secret) -> core.Secret:
        return self.api.create(secret)

    def get_secret(self, namespace: str, name: str) -> Optional[core.Secret]:
        return self.api.get("Secret", namespace, name)

    def delete_secret(self, namespace: str, name: str) -> None:
        self.api.delete("Secret", namespace, name)

    def create_network_policy(self, np: core.NetworkPolicy) -> core.NetworkPolicy:
        return self.api.create(np)

    def create_pvc(self, pvc: core.PersistentVolumeClaim) -> core.PersistentVolumeClaim:
        return self.api.create(pvc)

    def update_pvc(self, pvc: core.PersistentVolumeClaim) -> core.PersistentVolumeClaim:
        return self.api.update(pvc)

    def list_pvcs(self, namespace: Optional[str] = None) -> List[core.PersistentVolumeClaim]:
        return self.api.list("PersistentVolumeClaim", namespace)

    def get_pvc(self, namespace: str, name: str) -> Optional[core.PersistentVolumeClaim]:
        return self.api.get("PersistentVolumeClaim", namespace, name)

    def create_priority_class(self, pc: core.PriorityClass) -> core.PriorityClass:
        return self.api.create(pc)

    def create_event(self, event: core.Event) -> core.Event:
        return self.api.create(event)

    def list_events(self, namespace: Optional[str] = None) -> List[core.Event]:
        return self.api.list("Event", namespace)


class VolcanoClient:
    """CRD-group operations (jobs/podgroups/queues/commands)."""

    def __init__(self, api: APIServer):
        self.api = api

    # jobs
    def create_job(self, job: batch.Job) -> batch.Job:
        return self.api.create(job)

    def get_job(self, namespace: str, name: str) -> Optional[batch.Job]:
        return self.api.get("Job", namespace, name)

    def list_jobs(self, namespace: Optional[str] = None) -> List[batch.Job]:
        return self.api.list("Job", namespace)

    def update_job(self, job: batch.Job) -> batch.Job:
        return self.api.update(job)

    def update_job_status(self, job: batch.Job) -> batch.Job:
        return self.api.update_status(job)

    def delete_job(self, namespace: str, name: str) -> None:
        self.api.delete("Job", namespace, name)

    # podgroups
    def create_pod_group(self, pg: scheduling.PodGroup) -> scheduling.PodGroup:
        return self.api.create(pg)

    def get_pod_group(self, namespace: str, name: str) -> Optional[scheduling.PodGroup]:
        return self.api.get("PodGroup", namespace, name)

    def list_pod_groups(self, namespace: Optional[str] = None) -> List[scheduling.PodGroup]:
        return self.api.list("PodGroup", namespace)

    def update_pod_group(self, pg: scheduling.PodGroup) -> scheduling.PodGroup:
        return self.api.update_status(pg)

    def delete_pod_group(self, namespace: str, name: str) -> None:
        self.api.delete("PodGroup", namespace, name)

    # versioned creates (the v1alpha1 client surface; objects convert
    # through the scheme to the hub/storage version before the store —
    # pkg/apis/scheduling/scheme semantics)
    def create_pod_group_v1alpha1(self, pg):
        """Returns the stored object converted BACK to v1alpha1 — a
        versioned clientset is uniformly versioned on create and get."""
        hub = self.api.create(scheme.pod_group_v1alpha1_to_hub(pg))
        return scheme.pod_group_hub_to_v1alpha1(hub)

    def create_queue_v1alpha1(self, queue):
        hub = self.api.create(scheme.queue_v1alpha1_to_hub(queue))
        return scheme.queue_hub_to_v1alpha1(hub)

    def get_queue_v1alpha1(self, name: str):
        q = self.get_queue(name)
        return scheme.queue_hub_to_v1alpha1(q) if q is not None else None

    # queues
    def create_queue(self, queue: scheduling.Queue) -> scheduling.Queue:
        return self.api.create(queue)

    def get_queue(self, name: str) -> Optional[scheduling.Queue]:
        return self.api.get("Queue", "", name)

    def list_queues(self) -> List[scheduling.Queue]:
        return self.api.list("Queue")

    def update_queue(self, queue: scheduling.Queue) -> scheduling.Queue:
        return self.api.update(queue)

    def update_queue_status(self, queue: scheduling.Queue) -> scheduling.Queue:
        return self.api.update_status(queue)

    def delete_queue(self, name: str) -> None:
        self.api.delete("Queue", "", name)

    # commands
    def create_command(self, cmd: bus.Command) -> bus.Command:
        return self.api.create(cmd)

    def delete_command(self, namespace: str, name: str) -> None:
        self.api.delete("Command", namespace, name)

    def list_commands(self, namespace: Optional[str] = None) -> List[bus.Command]:
        return self.api.list("Command", namespace)


class SchedulerClient:
    """The scheduler cache's view: informer wiring + side-effect REST calls.

    Mirrors the informer set in pkg/scheduler/cache/cache.go:321-427 (the
    subset with behavioral content: pods, nodes, podgroups, queues,
    priority classes, resource quotas)."""

    def __init__(self, api: APIServer):
        self.api = api
        self.kube = KubeClient(api)
        self.vc = VolcanoClient(api)

    def watch(self, cache) -> None:
        def pods(event, old, new):
            if event == ADDED:
                cache.add_pod(new)
            elif event == MODIFIED:
                cache.update_pod(old, new)
            elif event == DELETED:
                cache.delete_pod(old)

        def nodes(event, old, new):
            if event == ADDED:
                cache.add_node(new)
            elif event == MODIFIED:
                cache.update_node(old, new)
            elif event == DELETED:
                cache.delete_node(old)

        def pod_groups(event, old, new):
            if event == ADDED:
                cache.add_pod_group(new)
            elif event == MODIFIED:
                cache.update_pod_group(old, new)
            elif event == DELETED:
                cache.delete_pod_group(old)

        def queues(event, old, new):
            if event == ADDED:
                cache.add_queue(new)
            elif event == MODIFIED:
                cache.update_queue(old, new)
            elif event == DELETED:
                cache.delete_queue(old)

        def priority_classes(event, old, new):
            if event in (ADDED, MODIFIED):
                cache.add_priority_class(new)
            elif event == DELETED:
                cache.delete_priority_class(old)

        def pvcs(event, old, new):
            if event == ADDED:
                cache.add_pvc(new)
            elif event == MODIFIED:
                cache.update_pvc(old, new)
            elif event == DELETED:
                cache.delete_pvc(old)

        # dual informer set (cache.go:393-424): legacy writers that put
        # RAW v1alpha1 objects on the bus feed the same cache through the
        # converting handler set
        def pod_groups_v1alpha1(event, old, new):
            if event == ADDED:
                cache.add_pod_group_v1alpha1(new)
            elif event == MODIFIED:
                cache.update_pod_group_v1alpha1(old, new)
            elif event == DELETED:
                cache.delete_pod_group_v1alpha1(old)

        def queues_v1alpha1(event, old, new):
            if event == ADDED:
                cache.add_queue_v1alpha1(new)
            elif event == MODIFIED:
                cache.update_queue_v1alpha1(old, new)
            elif event == DELETED:
                cache.delete_queue_v1alpha1(old)

        self.api.watch("Pod", pods)
        self.api.watch("Node", nodes)
        self.api.watch("PodGroup", pod_groups)
        self.api.watch("Queue", queues)
        self.api.watch("PodGroupV1alpha1", pod_groups_v1alpha1)
        self.api.watch("QueueV1alpha1", queues_v1alpha1)
        self.api.watch("PriorityClass", priority_classes)
        self.api.watch("PersistentVolumeClaim", pvcs)

    # side effects used by SchedulerCache
    def bind_pod(self, namespace: str, name: str, hostname: str) -> None:
        self.kube.bind_pod(namespace, name, hostname)

    def delete_pod(self, namespace: str, name: str) -> None:
        self.kube.delete_pod(namespace, name)

    def get_pod(self, namespace: str, name: str) -> Optional[core.Pod]:
        return self.kube.get_pod(namespace, name)

    def update_pod_condition(self, namespace: str, name: str, reason: str, message: str) -> None:
        self.kube.update_pod_condition(namespace, name, reason, message)

    def update_pod_group(self, pg: scheduling.PodGroup) -> Optional[scheduling.PodGroup]:
        try:
            return self.vc.update_pod_group(pg)
        except NotFoundError:
            # the object may live on the bus as a RAW v1alpha1 kind (the
            # dual informer set read it); write status back to THAT kind
            try:
                v1 = scheme.pod_group_hub_to_v1alpha1(pg)
                self.api.update_status(v1)
                return pg
            except NotFoundError:
                return None

    def update_pvc(self, pvc: core.PersistentVolumeClaim) -> core.PersistentVolumeClaim:
        return self.kube.update_pvc(pvc)

    def commit_batch(self, binds=(), evicts=(), events=(), conditions=(),
                     pod_groups=()):
        """Coalesced commit frame — one store transaction for N binds /
        evicts / events / conditions / PodGroup writebacks (the commit
        plane's fast path), applied by the in-process APIServer under one
        lock hold."""
        return self.api.commit_batch(
            binds=binds, evicts=evicts, events=events,
            conditions=conditions, pod_groups=pod_groups,
        )

    def record_event(
        self,
        namespace: str,
        involved: dict,
        type_: str,
        reason: str,
        message: str,
    ) -> core.Event:
        return record_event_via(self.api, namespace, involved, type_,
                                reason, message)


def record_event_via(
    api,
    namespace: str,
    involved: dict,
    type_: str,
    reason: str,
    message: str,
) -> core.Event:
    """Event recorder (the scheduler's user-facing audit trail —
    cache.go:304-306 eventBroadcaster + :600-610, 832-867 call
    sites).  Repeats of the same (object, type, reason) aggregate
    into one Event with a bumped ``count`` — the k8s correlator's
    aggregation key excludes the message precisely so that
    variable-detail repeats (\"failed to bind to n1: ...\", \"... n2:
    ...\") cannot mint unbounded distinct Events for one stuck
    object across scheduling cycles.

    ``api`` is any APIServer surface — the single copy shared by
    SchedulerClient and the commit frame."""
    import hashlib

    digest = hashlib.sha1(
        f"{involved.get('kind')}/{involved.get('name')}|{type_}|{reason}".encode()
    ).hexdigest()[:10]
    name = f"{involved.get('name', 'obj')}.{digest}"
    existing = api.get("Event", namespace, name)
    if existing is not None:
        existing.count += 1
        # refresh to the latest occurrence's detail, like the k8s
        # correlator — operators act on the current cause, not the
        # first-seen one
        existing.message = message
        return api.update(existing)
    return api.create(
        core.Event(
            metadata=core.ObjectMeta(name=name, namespace=namespace),
            involved_object=involved,
            type=type_,
            reason=reason,
            message=message,
        )
    )
