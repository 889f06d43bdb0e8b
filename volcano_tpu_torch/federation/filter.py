"""Shard-filtered informer delivery + the owned-slice capacity ledger.

A copy of ``volcano_tpu/federation/filter.py``.

The filter sits between the informer feed and the ``SchedulerCache``
(``SchedulerCache.set_informer_sink``): it receives every watch event,
forwards the slice this scheduler owns, and drops the rest — so the
cache, its snapshots, and the packed device planes all stay O(nodes/N)
while the watch stream itself remains the unfiltered cluster feed
(which is exactly what lets ownership move without resubscribing).

Forwarding rules:

* **nodes** — forwarded iff ``shard_of_node(name)`` is owned;
* **pods** — forwarded iff the pod's job hashes to an owned home shard
  (we schedule it), OR it is bound to an owned node (we must account
  it; the cache's job entry for such a foreign pod stays inert because
  its PodGroup is filtered out, so it is node accounting only);
* **podgroups** (both API versions) — forwarded iff home-shard owned;
* **queues / priority classes / PVCs** — global, always forwarded.

Ownership changes replay state instead of resubscribing: on acquire,
nodes/pods/podgroups are relisted through the client; on release, the
now-foreign slice is delivered to the cache as deletions.  A short
tombstone set papers over the classic list-vs-delete race during a
relist.

The ledger half tracks the OWNED nodes' raw objects plus the summed
requests of active bound pods — the capacity view behind the
free-capacity sketch this member piggybacks on its lease heartbeat
(:meth:`capacity_sketch`) and the home tier of gang-assembly plans.
Earlier builds kept this ledger cluster-wide so spillover could pick
foreign candidates locally; that mirror — the last O(cluster)
structure per member — is gone.  Foreign capacity now comes
exclusively from the other members' published sketches
(federation/sketches.py), verified against per-node store truth at
bind time, so every per-member structure is O(nodes/N).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from volcano_tpu_torch.api.resource import Resource
from volcano_tpu_torch.apis import core, scheduling, scheme
from volcano_tpu_torch.client.apiserver import ApiError
from volcano_tpu_torch.federation.sharding import shard_of_node, ShardState
from volcano_tpu_torch import metrics
from volcano_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

#: how long a delete observed for a not-yet-forwarded key shields the
#: relist path from resurrecting the object
_TOMBSTONE_TTL_S = 10.0


def _pod_key(pod: core.Pod) -> str:
    return f"{pod.metadata.namespace}/{pod.metadata.name}"


def _pod_group_of(pod: core.Pod) -> str:
    return (pod.metadata.annotations or {}).get(
        scheduling.GROUP_NAME_ANNOTATION_KEY, ""
    )


def _pod_active(pod: core.Pod) -> bool:
    return bool(pod.spec.node_name) and pod.status.phase not in (
        "Succeeded", "Failed",
    )


def _pod_resreq(pod: core.Pod) -> Resource:
    """The ledger's accounting unit — THE shared request summation
    (api/job_info.pod_request_resource), so ledger capacity math cannot
    drift from the scheduler's own NodeInfo accounting."""
    from volcano_tpu_torch.api.job_info import pod_request_resource

    return pod_request_resource(pod)


class ShardInformerFilter:
    """Informer-facing wrapper over a ``SchedulerCache``.

    Implements exactly the handler surface ``SchedulerClient.watch``
    drives; unknown attributes delegate to the cache so future handler
    additions fail loudly there instead of silently here.
    """

    def __init__(self, cache, state: ShardState, lister=None):
        self.cache = cache
        self.state = state
        #: API surface used for relist-on-acquire (pods + podgroups);
        #: None leaves acquire to the node ledger only (unit tests)
        self.lister = lister
        self._lock = threading.Lock()
        # ---- ledger: OWNED nodes + their bound-pod accounting ----
        self._nodes: Dict[str, core.Node] = {}  # guarded-by: self._lock
        self._node_alloc: Dict[str, Resource] = {}  # guarded-by: self._lock
        self._node_used: Dict[str, Resource] = {}  # guarded-by: self._lock
        self._node_ntasks: Dict[str, int] = {}  # guarded-by: self._lock
        #: pod key → (node_name, resreq) for ACTIVE pods bound to owned
        #: nodes
        self._pod_loc: Dict[str, Tuple[str, Resource]] = {}  # guarded-by: self._lock
        # ---- forwarding bookkeeping ----
        self._fwd_nodes: set = set()  # guarded-by: self._lock
        #: pod key → latest forwarded pod object (release needs the
        #: object to synthesize the deletion)
        self._fwd_pods: Dict[str, core.Pod] = {}  # guarded-by: self._lock
        #: "ns/name" → latest forwarded PodGroup (hub version)
        self._fwd_groups: Dict[str, scheduling.PodGroup] = {}  # guarded-by: self._lock
        #: key → monotonic stamp of a delete seen while not forwarded
        self._tombstones: Dict[str, float] = {}  # guarded-by: self._lock
        #: shards whose pod/podgroup relist failed and must be retried
        self._pending_relist: set = set()  # guarded-by: self._lock
        #: the highest pod resourceVersion the ledger has taken in: a
        #: pod bound onto an owned node at or below it is in the ledger
        #: (the feed delivers pods in resourceVersion order, and a
        #: relist lists the store as of after it)
        self._pod_rv = 0  # guarded-by: self._lock

    def __getattr__(self, name):
        return getattr(self.cache, name)

    # ---- relevance ----

    def _pod_relevant(self, pod: core.Pod) -> bool:
        if self.state.n_shards == 1:
            return True
        group = _pod_group_of(pod)
        if group and self.state.owns_job(pod.metadata.namespace, group):
            return True
        node = pod.spec.node_name
        return bool(node) and self.state.owns_node(node)

    def _group_relevant(self, namespace: str, name: str) -> bool:
        return self.state.n_shards == 1 or self.state.owns_job(
            namespace, name
        )

    # ---- ledger maintenance (callers hold no lock) ----

    def _ledger_node(self, node: core.Node) -> None:
        # requires-lock: self._lock
        name = node.metadata.name
        self._nodes[name] = node
        self._node_alloc[name] = Resource.from_resource_list(
            node.status.allocatable
        )
        self._node_used.setdefault(name, Resource())
        self._node_ntasks.setdefault(name, 0)

    def _ledger_drop_node(self, name: str) -> None:
        # requires-lock: self._lock
        self._nodes.pop(name, None)
        self._node_alloc.pop(name, None)
        self._node_used.pop(name, None)
        self._node_ntasks.pop(name, None)

    def _ledger_pod(self, pod: Optional[core.Pod]) -> None:
        # requires-lock: self._lock
        """Reconcile one pod's contribution to the used accounting (pass
        None-shaped deletes via _ledger_unpod).  Only pods bound to
        OWNED nodes are tracked — the ledger is the owned slice; a pod
        on a foreign node is the foreign holder's accounting problem
        (its sketch reflects it)."""
        key = _pod_key(pod)
        self._pod_rv = max(self._pod_rv, pod.metadata.resource_version or 0)
        prev = self._pod_loc.pop(key, None)
        if prev is not None:
            node, req = prev
            if node in self._node_used:
                self._node_used[node].sub_unchecked(req)
                self._node_ntasks[node] = max(
                    self._node_ntasks.get(node, 1) - 1, 0
                )
        if _pod_active(pod) and self.state.owns_node(pod.spec.node_name):
            req = _pod_resreq(pod)
            node = pod.spec.node_name
            self._pod_loc[key] = (node, req)
            self._node_used.setdefault(node, Resource()).add(req)
            self._node_ntasks[node] = self._node_ntasks.get(node, 0) + 1

    def _ledger_unpod(self, pod: core.Pod) -> None:
        # requires-lock: self._lock
        prev = self._pod_loc.pop(_pod_key(pod), None)
        if prev is not None:
            node, req = prev
            if node in self._node_used:
                self._node_used[node].sub_unchecked(req)
                self._node_ntasks[node] = max(
                    self._node_ntasks.get(node, 1) - 1, 0
                )

    # ---- node handlers ----

    def add_node(self, node: core.Node) -> None:
        name = node.metadata.name
        with self._lock:
            self._tombstones.pop(name, None)  # fresh truth supersedes
            fwd = self.state.owns_node(name)
            if fwd:
                self._ledger_node(node)
                self._fwd_nodes.add(name)
                self._owned_gauge()
        if fwd:
            self.cache.add_node(node)

    def update_node(self, old: core.Node, node: core.Node) -> None:
        name = node.metadata.name
        with self._lock:
            self._tombstones.pop(name, None)
            fwd = self.state.owns_node(name)
            if fwd:
                self._ledger_node(node)
                if name not in self._fwd_nodes:
                    self._fwd_nodes.add(name)
                    self._owned_gauge()
        if fwd:
            self.cache.update_node(old, node)

    def delete_node(self, node: core.Node) -> None:
        name = node.metadata.name
        with self._lock:
            self._ledger_drop_node(name)
            # node names carry no "/" so they can never collide with
            # pod/podgroup keys in the shared tombstone map
            self._tombstones[name] = time.monotonic()
            fwd = name in self._fwd_nodes
            self._fwd_nodes.discard(name)
            if fwd:
                self._owned_gauge()
        if fwd:
            self.cache.delete_node(node)

    def _owned_gauge(self) -> None:
        # requires-lock: self._lock
        metrics.update_shard_nodes_owned(len(self._fwd_nodes))

    # ---- pod handlers ----

    def add_pod(self, pod: core.Pod) -> None:
        key = _pod_key(pod)
        with self._lock:
            self._tombstones.pop(key, None)  # fresh truth supersedes
            self._ledger_pod(pod)
            fwd = self._pod_relevant(pod)
            if fwd:
                self._fwd_pods[key] = pod
        if fwd:
            self.cache.add_pod(pod)

    def update_pod(self, old: core.Pod, pod: core.Pod) -> None:
        key = _pod_key(pod)
        with self._lock:
            self._tombstones.pop(key, None)  # fresh truth supersedes
            self._ledger_pod(pod)
            was = key in self._fwd_pods
            rel = self._pod_relevant(pod)
            if rel:
                self._fwd_pods[key] = pod
            elif was:
                del self._fwd_pods[key]
        if was and rel:
            self.cache.update_pod(old, pod)
        elif rel:
            # became relevant mid-life (e.g. a foreign scheduler's
            # spillover bound it onto one of our nodes)
            self.cache.add_pod(pod)
        elif was:
            self.cache.delete_pod(old)

    def delete_pod(self, pod: core.Pod) -> None:
        key = _pod_key(pod)
        with self._lock:
            self._ledger_unpod(pod)
            fwd = self._fwd_pods.pop(key, None) is not None
            # recorded for FORWARDED deletes too: a concurrent relist's
            # stale list could otherwise re-add the object right after
            # this delete un-forwarded it — and no later event would
            # ever correct the ghost
            self._tombstones[key] = time.monotonic()
        if fwd:
            self.cache.delete_pod(pod)

    # ---- podgroup handlers (hub + v1alpha1) ----

    def add_pod_group(self, pg: scheduling.PodGroup) -> None:
        if self._forward_group(pg):
            self.cache.add_pod_group(pg)

    def update_pod_group(self, old, pg: scheduling.PodGroup) -> None:
        if self._forward_group(pg):
            self.cache.update_pod_group(old, pg)

    def delete_pod_group(self, pg: scheduling.PodGroup) -> None:
        key = pg.key()
        with self._lock:
            fwd = self._fwd_groups.pop(key, None) is not None
            self._tombstones[key] = time.monotonic()
        if fwd:
            self.cache.delete_pod_group(pg)

    def _forward_group(self, pg: scheduling.PodGroup) -> bool:
        with self._lock:
            self._tombstones.pop(pg.key(), None)
            rel = self._group_relevant(
                pg.metadata.namespace, pg.metadata.name
            )
            if rel:
                self._fwd_groups[pg.key()] = pg
            return rel

    def add_pod_group_v1alpha1(self, pg) -> None:
        self.add_pod_group(scheme.pod_group_v1alpha1_to_hub(pg))

    def update_pod_group_v1alpha1(self, old, pg) -> None:
        self.update_pod_group(
            scheme.pod_group_v1alpha1_to_hub(old) if old is not None else None,
            scheme.pod_group_v1alpha1_to_hub(pg),
        )

    def delete_pod_group_v1alpha1(self, pg) -> None:
        self.delete_pod_group(scheme.pod_group_v1alpha1_to_hub(pg))

    # ---- global kinds: pass through unfiltered ----

    def add_queue(self, queue) -> None:
        self.cache.add_queue(queue)

    def update_queue(self, old, queue) -> None:
        self.cache.update_queue(old, queue)

    def delete_queue(self, queue) -> None:
        self.cache.delete_queue(queue)

    def add_queue_v1alpha1(self, queue) -> None:
        self.cache.add_queue_v1alpha1(queue)

    def update_queue_v1alpha1(self, old, queue) -> None:
        self.cache.update_queue_v1alpha1(old, queue)

    def delete_queue_v1alpha1(self, queue) -> None:
        self.cache.delete_queue_v1alpha1(queue)

    def add_priority_class(self, pc) -> None:
        self.cache.add_priority_class(pc)

    def delete_priority_class(self, pc) -> None:
        self.cache.delete_priority_class(pc)

    def add_pvc(self, pvc) -> None:
        self.cache.add_pvc(pvc)

    def update_pvc(self, old, pvc) -> None:
        self.cache.update_pvc(old, pvc)

    def delete_pvc(self, pvc) -> None:
        self.cache.delete_pvc(pvc)

    # ---- ownership transitions (lease-manager thread) ----

    def on_acquire(self, shard: int) -> None:
        """Replay the acquired slice into the cache via a node + pod +
        podgroup relist through the client (the slice's ADDED events
        were dropped while foreign, and nothing is mirrored locally —
        the ledger is owned-only).  ``ShardState`` has already flipped,
        so live events for the shard forward concurrently; the
        forwarded sets make replay-vs-event delivery exactly-once."""
        self._relist_objects(shard)

    def _relist_objects(self, shard: int) -> None:
        if self.lister is None:
            return
        start = time.monotonic()
        try:
            nodes = self.lister.list("Node")
            groups = list(self.lister.list("PodGroup"))
            try:
                raw = self.lister.list("PodGroupV1alpha1")
            except ApiError:
                raw = []
            groups.extend(scheme.pod_group_v1alpha1_to_hub(g) for g in raw)
            pods = self.lister.list("Pod")
        except ApiError as e:
            log.error("shard %d relist failed (%s); will retry", shard, e)
            with self._lock:
                self._pending_relist.add(shard)
            return
        with self._lock:
            self._pending_relist.discard(shard)
        # nodes too, not just the ledger replay in on_acquire: a member
        # that wins a lease moments after joining may not have seen the
        # Node initial sync yet — and nodes are STATIC, so a slice
        # missed here would stay invisible forever (no later event)
        for node in nodes:
            name = node.metadata.name
            if not self.state.owns_node(name):
                continue
            with self._lock:
                if self._tombstoned(name, start):
                    continue  # deleted since the list snapshot — a
                    # resurrected node would be permanent (no re-event)
                self._ledger_node(node)
                fresh = name not in self._fwd_nodes
                self._fwd_nodes.add(name)
                if fresh:
                    self._owned_gauge()
            if fresh:
                self.cache.add_node(node)
        for pg in groups:
            if not self._group_relevant(pg.metadata.namespace,
                                        pg.metadata.name):
                continue
            with self._lock:
                if self._tombstoned(pg.key(), start):
                    continue
                fresh = pg.key() not in self._fwd_groups
                self._fwd_groups[pg.key()] = pg
            if fresh:
                self.cache.add_pod_group(pg)
            else:
                self.cache.update_pod_group(pg, pg)
        for pod in pods:
            if not self._pod_relevant(pod):
                continue
            key = _pod_key(pod)
            with self._lock:
                self._ledger_pod(pod)
                if self._tombstoned(key, start):
                    continue
                fresh = key not in self._fwd_pods
                self._fwd_pods[key] = pod
            if fresh:
                self.cache.add_pod(pod)
            else:
                self.cache.update_pod(pod, pod)

    def _tombstoned(self, key: str, since: float) -> bool:
        # requires-lock: self._lock
        """Was a delete for ``key`` observed after the relist snapshot
        was taken?  (A delete processed later than our delivery finds
        the key forwarded and flows through normally.)"""
        now = time.monotonic()
        for k, ts in list(self._tombstones.items()):
            if now - ts > _TOMBSTONE_TTL_S:
                del self._tombstones[k]
        ts = self._tombstones.get(key)
        return ts is not None and ts >= since

    def has_pending_relists(self) -> bool:
        with self._lock:
            return bool(self._pending_relist)

    def retry_pending_relists(self) -> None:
        """Re-run relists that failed on a flaky bus (driven by the
        lease manager's stats tick, so a failed acquire cannot leave a
        shard's jobs invisible forever)."""
        with self._lock:
            pending = list(self._pending_relist)
        for shard in pending:
            if self.state.owns_shard(shard):
                self._relist_objects(shard)

    def on_release(self, shard: int) -> None:
        """Deliver the released slice to the cache as deletions — the
        inverse replay.  Only objects that lost ALL relevance go (a pod
        may stay forwarded because its other anchor — home job vs bound
        node — is still owned)."""
        with self._lock:
            drop_nodes = [
                self._nodes[name]
                for name in list(self._fwd_nodes)
                if name in self._nodes
                and shard_of_node(name, self.state.n_shards) == shard
                and not self.state.owns_node(name)
            ]
            for node in drop_nodes:
                self._fwd_nodes.discard(node.metadata.name)
                self._ledger_drop_node(node.metadata.name)
            # shed the released slice's pod accounting with it — the
            # new holder's relist rebuilds it there; keeping the
            # entries here would leak one record per pod forever
            for key, (node_name, _req) in list(self._pod_loc.items()):
                if not self.state.owns_node(node_name):
                    del self._pod_loc[key]
            drop_pods = [
                pod for key, pod in list(self._fwd_pods.items())
                if not self._pod_relevant(pod)
            ]
            for pod in drop_pods:
                del self._fwd_pods[_pod_key(pod)]
            drop_groups = [
                pg for key, pg in list(self._fwd_groups.items())
                if not self._group_relevant(pg.metadata.namespace,
                                            pg.metadata.name)
            ]
            for pg in drop_groups:
                del self._fwd_groups[pg.key()]
            self._owned_gauge()
        for pod in drop_pods:
            self.cache.delete_pod(pod)
        for pg in drop_groups:
            self.cache.delete_pod_group(pg)
        for node in drop_nodes:
            self.cache.delete_node(node)

    # ---- spillover support ----

    def owned_node_count(self) -> int:
        with self._lock:
            return len(self._fwd_nodes)

    def _capacity_entries(self) -> List[list]:
        # requires-lock: self._lock
        """``[free_cpu, name, node, free, slots]`` for every
        schedulable OWNED ledger node with pod slots left — the ONE
        copy of the node-eligibility + free-capacity math shared by
        ``capacity_sketch`` and ``plan_gang_assembly``'s home tier, so
        a fix to either's view of "can this node take a claim" cannot
        drift from the other's.  (Foreign entries in the same shape are
        built from published sketches by federation/sketches.py.)"""
        out = []
        for name, node in self._nodes.items():
            if node.spec.unschedulable:
                continue
            alloc = self._node_alloc.get(name)
            if alloc is None:
                continue
            slots = alloc.max_task_num - self._node_ntasks.get(name, 0)
            if slots <= 0:
                continue
            free = alloc.clone()
            used = self._node_used.get(name)
            if used is not None:
                free.sub_unchecked(used)
            out.append([free.get("cpu"), name, node, free, slots])
        return out

    @staticmethod
    def _task_fits(task, node, free) -> bool:
        """Per-claim fit: resources against the free view, selector +
        taints via the plugin predicate helpers."""
        from volcano_tpu_torch.plugins import util as putil

        if not task.resreq.less_equal(free):
            return False
        pod = task.pod
        return pod is None or (
            putil.pod_matches_node_selector(pod, node)
            and putil.pod_tolerates_node_taints(pod, node)
        )

    def note_spill_bind(self, pod: core.Pod) -> None:
        """Account a successful spillover bind immediately (the watch
        echo also lands later; _ledger_pod reconciles, so this is not
        double-counted)."""
        with self._lock:
            self._ledger_pod(pod)
            self._fwd_pods[_pod_key(pod)] = pod

    # ---- gang-assembly support (federation/broker.py) ----

    #: sketch topNodes depth: enough freest nodes per shard that a
    #: burst of spills/claims has alternatives after in-pass debits,
    #: small enough that N shards' sketches stay a trivial map record
    _SKETCH_TOP_NODES = 8

    def capacity_sketch(self) -> dict:
        """The owned slice's free capacity, summarized — piggybacked on
        the lease-map heartbeat (the member stats blob).  Since the
        foreign-node mirror was deleted, this is the ONLY foreign state
        in the federation: spillover and the gang broker solicit
        candidates from these sketches (federation/sketches.py) and
        verify per-node store truth at CAS/txn time, so O(cluster)
        capacity knowledge lives nowhere — each member publishes
        O(nodes/N) and reads O(shards · K).

        Fields (cpu in milli, memory in bytes, like Resource):
        ``freeCpuMilli``/``freeMemory`` — summed free capacity across
        schedulable owned nodes with pod slots left; ``maxFreeCpuMilli``
        /``maxFreeMemory`` — the single best node (a gang TASK needs
        one node that fits it, not an aggregate); ``freeSlots`` — owned
        nodes that can still take a pod; ``topNodes`` — the K freest
        owned nodes by free cpu, each carrying the free view plus the
        predicate inputs (labels/taints/unschedulable) a foreign
        member needs to run the same selector/taint checks it runs on
        its own candidates.

        One field the reference does not publish: ``rv``, the highest
        pod resourceVersion the ledger has taken in, where the
        federation has more than one shard — a foreign member's own
        binds onto these nodes above it are not in this sketch yet
        (``SketchSolicitor.note_claim``)."""
        free_cpu = free_mem = 0.0
        max_cpu = max_mem = 0.0
        slots = 0
        entries = []
        with self._lock:
            rv = self._pod_rv
            for cpu, name, node, free, nslots in self._capacity_entries():
                if name not in self._fwd_nodes:
                    continue  # the sketch advertises the OWNED slice
                c = max(cpu, 0.0)
                m = max(free.get("memory"), 0.0)
                free_cpu += c
                free_mem += m
                max_cpu = max(max_cpu, c)
                max_mem = max(max_mem, m)
                slots += 1
                entries.append((c, m, name, node, nslots))
        entries.sort(key=lambda e: (-e[0], e[2]))
        top = [
            {
                "name": name,
                "freeCpuMilli": round(c),
                "freeMemory": round(m),
                "slots": nslots,
                "labels": dict(node.metadata.labels or {}),
                "taints": [
                    {"key": t.key, "value": t.value, "effect": t.effect}
                    for t in (node.spec.taints or [])
                ],
                "unschedulable": bool(node.spec.unschedulable),
            }
            for c, m, name, node, nslots in entries[: self._SKETCH_TOP_NODES]
        ]
        out = {
            "freeCpuMilli": round(free_cpu),
            "freeMemory": round(free_mem),
            "maxFreeCpuMilli": round(max_cpu),
            "maxFreeMemory": round(max_mem),
            "freeSlots": slots,
            "topNodes": top,
        }
        if self.state.n_shards > 1:
            out["rv"] = rv
        return out

    def plan_gang_assembly(
        self, tasks, foreign_entries: Optional[List[list]] = None,
    ) -> List[Tuple[object, str]]:
        """Greedy full-gang placement plan: HOME-owned nodes fill first
        (the home cycle only refused because the gang could not
        complete, not because home had no room), foreign claims fill
        the remainder from ``foreign_entries`` — capacity entries the
        broker builds out of the other members' published sketches
        (``SketchSolicitor.foreign_entries``); None/empty means
        home-only.  Claims are accounted within the plan — each
        placement debits its node's free view (foreign entries are
        per-call copies, so the debits are plan-local) — so one
        assembly can never overcommit a node against itself.

        Returns ``[(task, hostname)]`` for every task it could place,
        in task order; the caller judges sufficiency (and re-verifies
        everything against store truth via the ``txn_commit``
        preconditions before anything binds)."""
        with self._lock:
            home = self._capacity_entries()
        foreign = list(foreign_entries or [])
        # most-free-cpu first within each tier (the deterministic
        # spread), name as the tie-break
        home.sort(key=lambda e: (-e[0], e[1]))
        foreign.sort(key=lambda e: (-e[0], e[1]))
        candidates = home + foreign
        plan: List[Tuple[object, str]] = []
        for task in tasks:
            for entry in candidates:
                _key, name, node, free, slots = entry
                if slots <= 0:
                    continue
                if not self._task_fits(task, node, free):
                    continue
                free.sub_unchecked(task.resreq)
                entry[4] -= 1
                plan.append((task, name))
                break
        return plan
