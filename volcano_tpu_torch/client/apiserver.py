"""In-process API server — the communication bus of the framework.

A copy of ``volcano_tpu/client/apiserver.py``: a thread-safe versioned
object store with watch fan-out (the informer feed the scheduler cache
fills from), owner-reference cascade deletion, and the coalesced commit
frame (``commit_batch``) the cache's binds, evictions, audit Events, pod
conditions and PodGroup statuses land through.

Reference architecture: Volcano's only bus is the Kubernetes API server;
every binary talks exclusively to it via list/watch in and REST out.

``bus_status`` is the status surface every backend answers (the bus
server relays it): this volatile store is standalone and not
persistent, and names its daemon's /metrics address once the daemon has
set ``metrics_address``.

Not present in the port yet: admission hooks (``register_admission``;
with none registered the reference's ``create`` and ``update`` behave as
these do) and the federation primitives ``cas_bind`` and ``txn_commit``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple


# Watch event types (client-go semantics).
ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"

WatchHandler = Callable[[str, Optional[object], Optional[object]], None]


class ApiError(Exception):
    pass


class NotFoundError(ApiError):
    pass


class AlreadyExistsError(ApiError):
    pass


class ConflictError(ApiError):
    pass


class AdmissionError(ApiError):
    """Request rejected by an admission hook (the webhook deny path)."""


class APIServer:
    def __init__(self):
        self._lock = threading.RLock()
        self._store: Dict[str, Dict[str, object]] = {}  # guarded-by: self._lock
        self._watchers: Dict[str, List[WatchHandler]] = {}  # guarded-by: self._lock
        self._rv = 0  # guarded-by: self._lock
        #: reverse owner index for cascade deletion (the k8s garbage
        #: collector the reference relies on for Job → Pod/PodGroup/
        #: ConfigMap cleanup): (owner kind, ns, owner name) → set of
        #: (child kind, child key).  Entries are validated lazily at
        #: cascade time, so staleness is harmless.
        self._owned: Dict[Tuple[str, str, str], set] = {}  # guarded-by: self._lock
        #: the serving daemon's /metrics address ("host:port"), set by
        #: the apiserver daemon at start; "" until then
        self.metrics_address = ""

    # ---- helpers ----

    @contextlib.contextmanager
    def locked(self):
        """Hold the store lock.  Watch notifications fire under this
        lock, so a caller holding it can atomically combine a list with
        a subscription point (a gapless watch establishment)."""
        with self._lock:
            yield

    @staticmethod
    def _key(obj) -> str:
        return f"{obj.metadata.namespace}/{obj.metadata.name}"

    def _bump(self, obj) -> None:
        # requires-lock: self._lock
        self._rv += 1
        obj.metadata.resource_version = self._rv
        if not obj.metadata.creation_timestamp:
            obj.metadata.creation_timestamp = time.time()

    def _notify(self, kind: str, event: str, old, new) -> None:
        # requires-lock: self._lock
        for handler in self._watchers.get(kind, []):
            handler(event, old, new)

    # ---- watch (the informer feed) ----

    def watch(self, kind: str, handler: WatchHandler, send_initial: bool = True) -> None:
        with self._lock:
            self._watchers.setdefault(kind, []).append(handler)
            if send_initial:
                for obj in list(self._store.get(kind, {}).values()):
                    handler(ADDED, None, obj)

    def unwatch(self, kind: str, handler: WatchHandler) -> None:
        """Detach a watch handler."""
        with self._lock:
            handlers = self._watchers.get(kind, [])
            if handler in handlers:
                handlers.remove(handler)

    # ---- CRUD ----

    def _register_owners(self, obj, key: str) -> None:
        # requires-lock: self._lock
        for ref in obj.metadata.owner_references:
            if not ref.controller:
                continue
            parent = (ref.kind, obj.metadata.namespace, ref.name)
            self._owned.setdefault(parent, set()).add((obj.kind, key))

    def _unregister_owners(self, obj, key: str) -> None:
        # requires-lock: self._lock
        """Prune the reverse index when a child is deleted or its owner
        refs change on update — without this the index grows unbounded
        and keys re-created under a dead owner's name inherit its doom."""
        for ref in obj.metadata.owner_references:
            if not ref.controller:
                continue
            parent = (ref.kind, obj.metadata.namespace, ref.name)
            members = self._owned.get(parent)
            if members is not None:
                members.discard((obj.kind, key))
                if not members:
                    del self._owned[parent]

    @staticmethod
    def _controlled_by(child, owner) -> bool:
        """Does ``child`` carry a controller ownerReference matching
        ``owner``?  The k8s GC matches owners by UID; fall back to
        kind+name when either side predates UID assignment."""
        for ref in child.metadata.owner_references:
            if not ref.controller:
                continue
            if ref.kind != owner.kind or ref.name != owner.metadata.name:
                continue
            if ref.uid and owner.metadata.uid:
                return ref.uid == owner.metadata.uid
            return True
        return False

    def create(self, obj):
        with self._lock:
            kind = obj.kind
            bucket = self._store.setdefault(kind, {})
            key = self._key(obj)
            if key in bucket:
                raise AlreadyExistsError(f"{kind} {key} already exists")
            self._bump(obj)
            stored = obj.clone()
            bucket[key] = stored
            self._register_owners(stored, key)
            self._notify(kind, ADDED, None, stored.clone())
            return obj

    def update(self, obj, expected_rv: Optional[int] = None):
        """Update; with ``expected_rv`` set, an optimistic-concurrency
        CAS: succeeds only if the stored resourceVersion still equals it
        (the k8s semantics the reference's ConfigMap leader lock relies
        on, cmd/scheduler/app/server.go:110-156)."""
        with self._lock:
            kind = obj.kind
            bucket = self._store.setdefault(kind, {})
            key = self._key(obj)
            old = bucket.get(key)
            if old is None:
                raise NotFoundError(f"{kind} {key} not found")
            if (
                expected_rv is not None
                and old.metadata.resource_version != expected_rv
            ):
                raise ConflictError(
                    f"{kind} {key} resourceVersion {old.metadata.resource_version}"
                    f" != expected {expected_rv}"
                )
            self._bump(obj)
            stored = obj.clone()
            bucket[key] = stored
            self._unregister_owners(old, key)
            self._register_owners(stored, key)
            self._notify(kind, MODIFIED, old.clone(), stored.clone())
            return obj

    def compare_and_update(self, obj, expected_rv: int):
        """CAS alias: ``update`` with a required expected resourceVersion."""
        return self.update(obj, expected_rv=expected_rv)

    def update_status(self, obj):
        """Status subresource write — same store."""
        with self._lock:
            kind = obj.kind
            bucket = self._store.setdefault(kind, {})
            key = self._key(obj)
            old = bucket.get(key)
            if old is None:
                raise NotFoundError(f"{kind} {key} not found")
            self._bump(obj)
            stored = obj.clone()
            bucket[key] = stored
            self._unregister_owners(old, key)
            self._register_owners(stored, key)
            self._notify(kind, MODIFIED, old.clone(), stored.clone())
            return obj

    def bus_status(self) -> dict:
        """Durability/replication status surface (``vtctl top``'s target
        discovery, the incident bundle's ``bus_status.json``).  The
        in-process store is neither persistent nor replicated;
        ``bus.RemoteAPIServer`` fetches the same payload over the
        wire."""
        out = {"role": "standalone", "persistent": False}
        if self.metrics_address:
            out["metrics_address"] = self.metrics_address
        return out

    def get(self, kind: str, namespace: str, name: str):
        with self._lock:
            obj = self._store.get(kind, {}).get(f"{namespace}/{name}")
            return obj.clone() if obj is not None else None

    # ---- coalesced commit transaction (the multi-bind frame) ----

    def commit_batch(
        self,
        binds=(),
        evicts=(),
        events=(),
        conditions=(),
        pod_groups=(),
    ) -> Dict[str, List[Optional[str]]]:
        """Apply one coalesced commit frame — N pod bindings, evictions,
        audit events, pod conditions, and PodGroup status writebacks —
        under ONE store lock hold, so the whole scheduler cycle's commit
        is a single store transaction with one watch-notification flush
        instead of O(pods) independent round trips.

        Sections (plain dicts; ``pod_groups`` are API objects):

        * ``binds``: ``{namespace, name, hostname, event?}`` — the
          binding subresource write (get + node_name + update_status,
          exactly ``KubeClient.bind_pod``); on success the optional
          ``event`` (``{type, reason, message}``) is recorded — the
          per-object path's success-gated Scheduled audit event.
        * ``evicts``: ``{namespace, name, event?}`` — pod delete with
          the same success-gated Evict event.
        * ``events``: ``{namespace, involved, type, reason, message}``
          — standalone audit events (Unschedulable writebacks), run
          through the same aggregation correlator as record_event.
        * ``conditions``: ``{namespace, name, reason, message}`` — the
          PodScheduled=False condition write.
        * ``pod_groups``: PodGroup objects for status writeback, with
          the raw-v1alpha1 fallback ``SchedulerClient.update_pod_group``
          applies.

        Per-item failures are COLLECTED, not raised: the return maps
        each section to a list of ``None`` (success) or an error string
        aligned with the input order, so the caller can route failed
        binds/evicts to the resync path exactly like the per-object
        effects do.

        The per-item application lives in :func:`apply_commit_batch`,
        which works against any APIServer surface."""
        with self._lock:
            return apply_commit_batch(
                self, binds=binds, evicts=evicts, events=events,
                conditions=conditions, pod_groups=pod_groups,
            )

    def list(self, kind: str, namespace: Optional[str] = None) -> List:
        with self._lock:
            out = []
            for key, obj in self._store.get(kind, {}).items():
                if namespace is None or obj.metadata.namespace == namespace:
                    out.append(obj.clone())
            return sorted(out, key=lambda o: (o.metadata.namespace, o.metadata.name))

    def delete(self, kind: str, namespace: str, name: str):
        with self._lock:
            bucket = self._store.get(kind, {})
            key = f"{namespace}/{name}"
            old = bucket.pop(key, None)
            if old is None:
                raise NotFoundError(f"{kind} {key} not found")
            self._unregister_owners(old, key)
            # Owner-reference cascade — the k8s garbage collector the
            # reference leans on: deleting a Job must take its Pods,
            # PodGroup, and plugin resources (ConfigMaps/Secrets) with
            # it (createJobPod sets the controller ownerReference;
            # pkg/apis/helpers CreatedBy*).  Children are popped
            # transitively under the same lock; DELETED notifications
            # fire parent-first so controller caches unwind top-down.
            # A stale index entry — the child was deleted directly and a
            # NEW object re-created under the same (kind, key) — must NOT
            # cascade: like the k8s GC, ownership is re-verified against
            # the child's CURRENT controller ownerReference (by UID when
            # both sides carry one, else kind+name).
            deleted = [(kind, old)]
            frontier = [old]
            while frontier:
                owner = frontier.pop()
                parent = (
                    owner.kind,
                    owner.metadata.namespace,
                    owner.metadata.name,
                )
                survivors = set()
                for ckind, ckey in self._owned.pop(parent, ()):  # noqa: B020
                    cbucket = self._store.get(ckind, {})
                    child = cbucket.get(ckey)
                    if child is None:
                        continue  # stale index entry — drop
                    if not self._controlled_by(child, owner):
                        # same owner key but a different controller (the
                        # owner name was re-created with a new uid) —
                        # keep the entry for that owner's own cascade
                        survivors.add((ckind, ckey))
                        continue
                    del cbucket[ckey]
                    self._unregister_owners(child, ckey)
                    deleted.append((ckind, child))
                    frontier.append(child)
                if survivors:
                    self._owned[parent] = survivors
            for dkind, dobj in deleted:
                self._notify(dkind, DELETED, dobj.clone(), None)
            return old


def apply_commit_batch(
    api,
    binds=(),
    evicts=(),
    events=(),
    conditions=(),
    pod_groups=(),
) -> Dict[str, List[Optional[str]]]:
    """Apply the commit-frame sections through ``api``'s public surface
    — delegating to the SAME typed-client helpers the per-object
    effects use (``KubeClient.bind_pod`` / ``update_pod_condition``,
    the event correlator, ``SchedulerClient.update_pod_group``'s
    v1alpha1 fallback), so batched and per-object semantics cannot
    drift."""
    from volcano_tpu_torch.apis import scheme
    from volcano_tpu_torch.client.clients import KubeClient, record_event_via

    kube = KubeClient(api)

    results: Dict[str, List[Optional[str]]] = {
        "binds": [], "evicts": [], "events": [],
        "conditions": [], "pod_groups": [],
    }

    def _err(e: Exception) -> str:
        return f"{type(e).__name__}: {e}"

    def _commit_event(namespace: str, name: str, event) -> None:
        # success-gated audit event for a bind/evict item — best-effort,
        # like the per-object _record_event discipline
        if not event:
            return
        try:
            record_event_via(
                api, namespace,
                {"kind": "Pod", "namespace": namespace, "name": name},
                event["type"], event["reason"], event["message"],
            )
        except ApiError:
            pass

    for b in binds:
        try:
            kube.bind_pod(b["namespace"], b["name"], b["hostname"])
            results["binds"].append(None)
        except ApiError as e:
            results["binds"].append(_err(e))
            continue
        _commit_event(b["namespace"], b["name"], b.get("event"))
    for ev in evicts:
        try:
            api.delete("Pod", ev["namespace"], ev["name"])
            results["evicts"].append(None)
        except ApiError as e:
            results["evicts"].append(_err(e))
            continue
        _commit_event(ev["namespace"], ev["name"], ev.get("event"))
    for e in events:
        try:
            record_event_via(
                api, e["namespace"], e["involved"], e["type"],
                e["reason"], e["message"],
            )
            results["events"].append(None)
        except ApiError as exc:
            results["events"].append(_err(exc))
    for c in conditions:
        try:
            # silently no-ops when the pod is gone, like the per-object
            # update_pod_condition
            kube.update_pod_condition(
                c["namespace"], c["name"], c["reason"], c["message"]
            )
            results["conditions"].append(None)
        except ApiError as e:
            results["conditions"].append(_err(e))
    for pg in pod_groups:
        try:
            api.update_status(pg)
            results["pod_groups"].append(None)
        except NotFoundError:
            # raw-v1alpha1 residents (the dual informer set) get status
            # written to THAT kind, like SchedulerClient.update_pod_group
            # — including its missing-from-both silent no-op (a job
            # deleted mid-cycle must not read as a commit failure)
            try:
                api.update_status(scheme.pod_group_hub_to_v1alpha1(pg))
                results["pod_groups"].append(None)
            except NotFoundError:
                results["pod_groups"].append(None)
            except ApiError as e:
                results["pod_groups"].append(_err(e))
        except ApiError as e:
            results["pod_groups"].append(_err(e))
    return results

