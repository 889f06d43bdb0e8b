"""SchedulerCache — mutex-guarded mirror of cluster state.

The synchronous path of ``volcano_tpu/cache/cache.py``: the event
handlers for pods, nodes, PodGroups, queues, priority classes, PVCs and
resource quotas (the namespace weights of drf's weighted namespace
order, in every snapshot's ``namespace_info``), bind/evict/volume/status
effects dispatched inline on the calling thread, the warm packer's
change tracking (``PackEpoch``, the dirty marks every handler makes,
``clear_dirty_through`` and the lazy ``pack_cache``) and the opt-in
snapshot clone pool (``snapshot_reuse``, ``release_session_clones``).

The event surface of the event-driven scheduler loop: every handler
tells the change listeners (``add_change_listener``) what kind of change
it made, after the mutex is released, and every job mutation passes
through ``_mark_job``, where the incremental share ledger
(``incremental/shares.py``) observes it — the O(1) wake gate
(``has_schedulable_pending``, ``ledger_counts``) and the seed of a
restricted snapshot (``snapshot(scope="restricted" | "shadow")``).

The client half: with ``client=SchedulerClient(api)`` the cache fills
from the store's watch (``run()`` registers it once) and its binds,
evictions, audit Events, pod conditions and PodGroup statuses land in
the store through the default binder, evictor and status updater — as
coalesced commit frames (``client.commit_batch``) when those defaults
are wired to the cache's own client.  The effects run on the calling
thread, or, with ``pipelined_commit=True``, on the bind workers of
``cache/commit_plane.py``, whose barrier at the head of the next
``snapshot()`` lands them before new state is read.  A failed bind or
evict takes the FailedScheduling Event and the resync queue
(``err_tasks``): the task is refetched from API truth with bounded
retries and backoff, then quarantined until a watch event for its pod
arrives or its cooldown ends.  The v1alpha1 PodGroup and Queue handlers
convert through ``apis/scheme.py``.

Reference: pkg/scheduler/cache/cache.go + event_handlers.go.  Fed by
event handlers — wired to the store's watch, or called directly (the
reference's own unit-test pattern, allocate_test.go:155-222); produces
deep-copied snapshots.  ``scheduler_name`` is kept as the reference
keeps it, set by the scheduler daemon and read by nothing in the cache.
The informer sink (:meth:`SchedulerCache.set_informer_sink`) routes
the watch deliveries through the federation's shard filter, and
:meth:`SchedulerCache.pending_spill_view` is the per-job pending view
its spillover pass and gang broker share.  Not present in the port
yet: the reference's ``sync_side_effects`` switch (its thread-pool
route for the effects; the daemon never sets it).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from volcano_tpu_torch import faults, metrics, obs
from volcano_tpu_torch.api import (
    ClusterInfo,
    JobInfo,
    NamespaceCollection,
    new_task_info,
    NodeInfo,
    QueueInfo,
    TaskInfo,
    TaskStatus,
)
from volcano_tpu_torch.apis import core, scheduling, scheme
from volcano_tpu_torch.cache.interface import Binder, Cache, Evictor, StatusUpdater
from volcano_tpu_torch.incremental.shares import ShareLedger
from volcano_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def is_terminated(status: TaskStatus) -> bool:
    return status in (TaskStatus.Succeeded, TaskStatus.Failed)


class PackEpoch:
    """What changed since the warm packer's last consumed revision —
    attached to every snapshot (ClusterInfo.pack_epoch) and consumed by
    ops/pack_cache.PackCache.  ``dirty_tasks``/``dirty_nodes`` are
    cumulative: entries survive until a packer acknowledges them via
    ``SchedulerCache.clear_dirty_through``, so a cycle that skips packing
    (different action set, crash) cannot lose invalidations.
    ``topology_rev`` bumps when the node SET changes — positional node
    planes cannot be delta-patched across that, so the packer rebuilds
    them wholesale.

    ``dirty_nodes`` is every node whose accounting moved (binds, evicts,
    pod events — only the DYNAMIC planes: idle/used/task count/ok);
    ``dirty_nodes_full`` is the subset whose node OBJECT changed
    (update_node), which additionally invalidates the static planes
    (labels/taints/allocatable/max tasks)."""

    __slots__ = (
        "rev",
        "topology_rev",
        "dirty_tasks",
        "dirty_nodes",
        "dirty_nodes_full",
    )

    def __init__(
        self, rev: int, topology_rev: int, dirty_tasks, dirty_nodes,
        dirty_nodes_full=(),
    ):
        self.rev = rev
        self.topology_rev = topology_rev
        self.dirty_tasks = dirty_tasks
        self.dirty_nodes = dirty_nodes
        self.dirty_nodes_full = set(dirty_nodes_full)


def _task_pack_relevant_changed(old_pod: core.Pod, new_pod: core.Pod) -> bool:
    """Did an update_pod change anything the packed TASK ROW encodes
    (resource requests, selector/affinity/tolerations, job membership)?
    Status/phase/node_name churn — the overwhelmingly common update in a
    bind/complete cycle — keeps the row clean, which is what makes a
    steady-state warm cycle actually warm.  Errs dirty on any doubt."""
    try:
        so, sn = old_pod.spec, new_pod.spec
        if so is not sn:
            if len(so.containers) != len(sn.containers) or any(
                a.resources != b.resources
                for a, b in zip(so.containers, sn.containers)
            ):
                return True
            if len(so.init_containers) != len(sn.init_containers) or any(
                a.resources != b.resources
                for a, b in zip(so.init_containers, sn.init_containers)
            ):
                return True
            if (
                so.node_selector != sn.node_selector
                or so.affinity != sn.affinity
                or so.tolerations != sn.tolerations
            ):
                return True
        mo, mn = old_pod.metadata, new_pod.metadata
        if mo is not mn:
            if (mo.annotations or {}).get(
                scheduling.GROUP_NAME_ANNOTATION_KEY
            ) != (mn.annotations or {}).get(scheduling.GROUP_NAME_ANNOTATION_KEY):
                return True
            # pod labels feed (anti-)affinity matching of OTHER tasks;
            # the packer only bit-encodes selector→node-label relations,
            # but a label change flips host-validation outcomes — dirty.
            if mo.labels != mn.labels:
                return True
        return False
    except Exception:  # noqa: BLE001 — unknown shapes never stay clean
        return True


class DefaultBinder(Binder):
    """POSTs the pod binding through the API client (cache.go:122-134)."""

    def __init__(self, client):
        self.client = client

    def bind(self, task: TaskInfo, hostname: str) -> None:
        self.client.bind_pod(task.namespace, task.name, hostname)


class DefaultEvictor(Evictor):
    """Deletes the pod (cache.go:141-149)."""

    def __init__(self, client):
        self.client = client

    def evict(self, task: TaskInfo) -> None:
        self.client.delete_pod(task.namespace, task.name)


class DefaultStatusUpdater(StatusUpdater):
    """cache.go defaultStatusUpdater."""

    def __init__(self, client):
        self.client = client

    def update_pod_condition(self, task: TaskInfo, reason: str, message: str) -> None:
        self.client.update_pod_condition(task.namespace, task.name, reason, message)

    def update_pod_group(self, pg: scheduling.PodGroup):
        return self.client.update_pod_group(pg)


class SchedulerCache(Cache):
    def __init__(
        self,
        binder: Optional[Binder] = None,
        evictor: Optional[Evictor] = None,
        status_updater: Optional[StatusUpdater] = None,
        scheduler_name: str = "volcano",
        default_queue: str = "default",
        default_priority: int = 0,
        client=None,
        snapshot_reuse: bool = False,
        pipelined_commit: bool = False,
    ):
        self._mutex = threading.RLock()
        self.scheduler_name = scheduler_name
        self.default_queue = default_queue
        self.default_priority = default_priority

        self.jobs: Dict[str, JobInfo] = {}  # guarded-by: self._mutex
        #: incremental fair-share ledger + schedulable-work counter,
        #: maintained by _mark_job (the choke point every job-mutating
        #: handler passes through) so micro-cycles can gate wakes and
        #: open restricted sessions without O(resident jobs) sweeps
        self.share_ledger = ShareLedger()  # guarded-by: self._mutex
        self.nodes: Dict[str, NodeInfo] = {}  # guarded-by: self._mutex
        self.queues: Dict[str, QueueInfo] = {}  # guarded-by: self._mutex
        self.priority_classes: Dict[str, core.PriorityClass] = {}  # guarded-by: self._mutex
        self.namespace_collections: Dict[str, NamespaceCollection] = {}  # guarded-by: self._mutex
        #: PVCs keyed "ns/name" (pvcInformer, cache.go:415-421)
        self.pvcs: Dict[str, core.PersistentVolumeClaim] = {}  # guarded-by: self._mutex

        self.client = client
        self.binder = binder or (DefaultBinder(client) if client else None)
        self.evictor = evictor or (DefaultEvictor(client) if client else None)
        self.status_updater = status_updater or (
            DefaultStatusUpdater(client) if client else None
        )

        #: tasks whose side effects failed; re-synced from API truth
        #: (cache.go:687-709 errTasks workqueue).  Entries are
        #: ``[task, attempts, next_try_monotonic]``; uids are deduped
        #: (the reference's workqueue semantics) so a bind burst cannot
        #: enqueue the same task N times.  Without a client nothing
        #: drains the queue.
        self.err_tasks: List[list] = []  # guarded-by: self._mutex
        #: uid → [task, quarantined_at_monotonic] for entries that
        #: exhausted _RESYNC_MAX_RETRIES: requeueing such a poison task
        #: forever would grind the queue.  A quarantined task leaves
        #: through fresh API truth (any watch event for its pod clears
        #: it) or, failing that, re-enters the queue after
        #: _QUARANTINE_COOLDOWN with its attempt budget reset — an
        #: unchanged pod gets no watch event.  Visible via the
        #: ResyncFailed Warning Event and the
        #: volcano_resync_quarantined_tasks gauge.
        self.quarantined_tasks: Dict[str, list] = {}  # guarded-by: self._mutex
        #: uids popped from err_tasks whose (blocking, mutex-free) fetch
        #: is in flight — resync_task dedupes against this too, or a
        #: concurrent enqueue during the fetch window would mint a
        #: duplicate entry
        self._resync_inflight: set = set()  # guarded-by: self._mutex
        #: one-shot flag for the "client can't record events" warning
        self._warned_no_events = False
        #: change listeners for the event-driven scheduler loop: each is
        #: called with a coarse category string AFTER the mutating
        #: handler releases the mutex (so a listener that takes its own
        #: lock — the scheduler's wake condition — never nests inside
        #: the cache mutex).  Categories: "task" (schedulable work
        #: appeared/changed), "node" (capacity moved: pod finished/
        #: deleted, node object updated), "topology" (node set changed),
        #: "gang" (a PodGroup with min_member > 1 arrived), "group"
        #: (other scheduling-relevant object churn).  Bind echoes of our
        #: own placements are deliberately NOT emitted — they would
        #: wake the loop once per bind for cycles with nothing to do.
        self._change_listeners: List = []  # guarded-by: self._mutex
        #: job uid → the unschedulable tasks its last status writeback
        #: recorded (record_job_status_event); the durable source of
        #: ``GET /explain`` (serving/explain.py), since fit errors live on
        #: session clones and go with the session.  Cleared when a
        #: writeback records none, and when the job leaves the cache.
        self.unschedulable_digest: Dict[str, dict] = {}  # guarded-by: self._mutex

        # ---- warm-cycle change tracking (ops/pack_cache.py) ----
        #: bumped on every pack-relevant mutation; the dirty dicts map
        #: uid/name → the revision that last dirtied it, so consumers can
        #: acknowledge a prefix without losing later invalidations
        self._rev = 0  # guarded-by: self._mutex
        self._topology_rev = 0  # guarded-by: self._mutex
        self._dirty_tasks: Dict[str, int] = {}  # guarded-by: self._mutex
        self._dirty_nodes: Dict[str, int] = {}  # guarded-by: self._mutex
        self._dirty_nodes_full: Dict[str, int] = {}  # guarded-by: self._mutex
        #: per-object last-mutation revision (never cleared — validity
        #: stamps for the opt-in snapshot clone pool below)
        self._job_mut_rev: Dict[str, int] = {}  # guarded-by: self._mutex
        self._node_mut_rev: Dict[str, int] = {}  # guarded-by: self._mutex
        #: lazily built cycle-persistent packer; gpu-allocate picks it up
        #: through the session's cache reference
        self._pack_cache = None

        # ---- opt-in snapshot clone reuse ----
        #: when True, snapshot() reuses the previous session's clones for
        #: objects that session left untouched AND the cache has not
        #: mutated since — the handshake is close_session →
        #: release_session_clones.  Off by default: correctness relies on
        #: the session-side touched-set discipline, which custom actions
        #: outside the shipped set may not follow.
        self.snapshot_reuse = snapshot_reuse
        self._clone_gen = 0
        self._handed_nodes: Dict[str, NodeInfo] = {}
        self._handed_jobs: Dict[str, JobInfo] = {}
        self._handed_rev = -1
        self._pool_nodes: Dict[str, NodeInfo] = {}
        self._pool_jobs: Dict[str, JobInfo] = {}
        self._pool_rev = -1
        self._pool_open = False
        #: clones the last snapshot() took from the pool (nodes, jobs)
        self.last_pool_reuse = (0, 0)

        #: set by the scheduler loop for the length of a micro-triggered
        #: cycle (plain attribute, single-threaded cycle-loop
        #: discipline); gpu-allocate reads it to attribute a cold pack
        self.in_micro_cycle = False

        #: informer registration latch (run() is idempotent)
        self._watch_started = False
        #: optional informer-facing proxy (federation's shard filter):
        #: run() registers IT with the client instead of the cache, so
        #: every watch delivery flows through its forwarding rules.
        #: Must be set before run(); plain attribute, startup-ordered.
        self._informer_sink = None

        # ---- pipelined commit plane (cache/commit_plane.py) ----
        # Opt-in: bind/evict/status effects are queued and drained by a
        # pool of bind workers, coalesced into batched commit frames,
        # with a commit barrier at the next snapshot().  Off by default:
        # the synchronous effects stay the deterministic baseline every
        # equivalence test pins the pipelined plane against.
        self._commit_plane = None
        if pipelined_commit:
            from volcano_tpu_torch.cache.commit_plane import CommitPlane

            self._commit_plane = CommitPlane(self)
        # Fast-path eligibility for the coalesced commit frame: only the
        # DEFAULT binder/evictor/status-updater wired to THIS cache's
        # client are known to be equivalent to the frame's server-side
        # application; custom implementations (tests, recorders) keep
        # the per-object calls so they observe every effect.
        _cb = getattr(self.client, "commit_batch", None) if self.client \
            else None
        self._fast_bind = (
            _cb is not None
            and isinstance(self.binder, DefaultBinder)
            and self.binder.client is self.client
        )
        self._fast_evict = (
            _cb is not None
            and isinstance(self.evictor, DefaultEvictor)
            and self.evictor.client is self.client
        )
        self._fast_status = (
            _cb is not None
            and isinstance(self.status_updater, DefaultStatusUpdater)
            and self.status_updater.client is self.client
        )

    # ---- lifecycle ----

    def run(self) -> None:
        # idempotent: Scheduler.run() calls this unconditionally, and a
        # harness may already have started the informers — registering
        # the watch handlers twice would deliver every event twice.
        # The latch is set AFTER watch() returns: a registration that
        # raised mid-way stays retryable on the next run() instead of
        # poisoning the latch and leaving an informer-less scheduler.
        if self.client is not None and not self._watch_started:
            self.client.watch(self._informer_sink or self)
            self._watch_started = True

    def wait_for_cache_sync(self, timeout: Optional[float] = None) -> bool:
        """The reference scheduler's WaitForCacheSync: True once the
        informers' first lists are in the cache.  An in-process store
        delivers them inside ``run()``; a ``RemoteAPIServer`` delivers
        them on its dispatch thread, so this waits for it
        (``wait_synced``).  (The JAX package's returns True at once.)"""
        wait = getattr(getattr(self.client, "api", None), "wait_synced", None)
        return True if wait is None else wait(timeout)

    def flush(self) -> None:
        """Wait for the pipelined effects to land (test/shutdown aid)."""
        if self._commit_plane is not None:
            self._commit_plane.barrier()

    def stop_commit_plane(self) -> None:
        """Drain and stop the pipelined commit workers (shutdown aid)."""
        if self._commit_plane is not None:
            self._commit_plane.stop()

    # ---- change notification (the event-driven scheduler's wake) ----

    def add_change_listener(self, fn) -> None:
        """Register ``fn(category: str)`` to be called after every
        scheduling-relevant cache mutation (watch events and resyncs —
        never our own bind/evict accounting, which would be a feedback
        loop).
        Listeners run outside the cache mutex, on the thread that
        delivered the event; they must be cheap and non-blocking (the
        scheduler's listener just flips a condition variable)."""
        with self._mutex:
            if fn not in self._change_listeners:
                self._change_listeners.append(fn)

    def remove_change_listener(self, fn) -> None:
        with self._mutex:
            if fn in self._change_listeners:
                self._change_listeners.remove(fn)

    def _emit_change(self, category: Optional[str]) -> None:
        """Fan a change category out to the listeners.  Called OUTSIDE
        the mutex by the public event handlers; ``None`` (a suppressed
        bind-echo) is a no-op."""
        if category is None:
            return
        with self._mutex:
            listeners = list(self._change_listeners)
        for fn in listeners:
            try:
                fn(category)
            except Exception as e:  # noqa: BLE001 — a bad listener must
                # not break event delivery
                log.error("cache change listener failed: %s", e)

    def set_informer_sink(self, sink) -> None:
        """Route informer deliveries through ``sink`` (an object with
        the same handler surface — the federation shard filter).  Must
        run before :meth:`run` registers the watches."""
        if self._watch_started:
            raise RuntimeError(
                "set_informer_sink must run before the informers start"
            )
        self._informer_sink = sink

    def pending_spill_view(self) -> List[dict]:
        """Per-job view of still-Pending tasks for the federation
        spillover pass: ``[{job_id, min_member, ready, tasks}]`` taken
        under one mutex hold.  Task entries are the live TaskInfo
        references — the consumer reads only stable identity fields
        (namespace/name/resreq/pod) and re-verifies everything against
        store truth before acting (the CAS bind)."""
        out: List[dict] = []
        with self._mutex:
            for job in self.jobs.values():
                if job.pod_group is None:
                    continue
                pending = job.task_status_index.get(TaskStatus.Pending)
                if not pending:
                    continue
                out.append({
                    "job_id": job.uid,
                    "min_member": job.pod_group.spec.min_member or 0,
                    "ready": job.ready_task_num(),
                    "tasks": list(pending.values()),
                })
        return out

    def has_schedulable_pending(self) -> bool:
        """Is there any pending task a scheduling cycle could act on?
        The event-driven loop consults this before spending a session on
        a capacity-freed wake ("node"/"group" triggers).  Answered O(1)
        from the incremental ledger's schedulable-work counter (the set
        of jobs with a live PodGroup and a non-empty Pending bucket)."""
        with self._mutex:
            return self.share_ledger.schedulable_count > 0

    def ledger_counts(self):
        """(resident, schedulable) job counts from the incremental
        ledger — the volcano_resident_jobs / volcano_schedulable_jobs
        gauges."""
        with self._mutex:
            return (
                self.share_ledger.resident_count,
                self.share_ledger.schedulable_count,
            )

    @staticmethod
    def _classify_pod_update(old_ti: TaskInfo, new_ti: TaskInfo,
                             spec_changed: bool) -> Optional[str]:
        """Wake category for a pod MODIFIED event — or None for churn a
        scheduling cycle cannot act on (the common case in steady
        state: our own bind's watch echo and the kubelet's
        Pending→Running flip, which would otherwise wake the loop once
        per placement)."""
        if spec_changed:
            return "task"
        if is_terminated(new_ti.status) and not is_terminated(old_ti.status):
            return "node"  # capacity freed — stuck tasks may now fit
        if not old_ti.node_name and new_ti.node_name:
            return None  # bind echo of a placement this loop made
        if old_ti.status != new_ti.status and new_ti.status == TaskStatus.Pending:
            return "task"  # task returned to schedulable
        return None

    # ---- warm-cycle change tracking ----

    def _mark_task(self, uid: str) -> None:
        # requires-lock: self._mutex
        self._rev += 1
        self._dirty_tasks[uid] = self._rev

    def _mark_node(self, name: str) -> None:
        # requires-lock: self._mutex
        self._rev += 1
        self._dirty_nodes[name] = self._rev
        self._node_mut_rev[name] = self._rev

    def _mark_node_full(self, name: str) -> None:
        # requires-lock: self._mutex
        """Node OBJECT change: static packed planes invalidate too."""
        self._mark_node(name)
        self._dirty_nodes_full[name] = self._rev

    def _mark_job(self, uid: str) -> None:
        # requires-lock: self._mutex
        self._rev += 1
        self._job_mut_rev[uid] = self._rev
        # every handler marks AFTER mutating the JobInfo, so the ledger
        # observes the post-mutation truth here — one diff per event,
        # never a sweep.  (delete_pod_group marks with pod_group already
        # None before dropping the job, so the retraction is covered.)
        self.share_ledger.observe(self.jobs.get(uid), uid)

    def _mark_topology(self) -> None:
        # requires-lock: self._mutex
        self._rev += 1
        self._topology_rev = self._rev

    #: dirty-set growth bound for deployments whose action set never
    #: packs (host allocate only): nothing acks the sets, so once they
    #: exceed this, reset them and bump the topology revision — any
    #: future packer then cold-packs instead of trusting pruned sets
    _DIRTY_CAP = 250_000

    def _bound_dirty(self) -> None:
        # requires-lock: self._mutex
        if (
            len(self._dirty_tasks) > self._DIRTY_CAP
            or len(self._dirty_nodes) > self._DIRTY_CAP
        ):
            self._dirty_tasks.clear()
            self._dirty_nodes.clear()
            self._dirty_nodes_full.clear()
            self._mark_topology()

    def clear_dirty_through(self, epoch: PackEpoch) -> None:
        """Acknowledge consumption of an epoch's dirty sets (the warm
        packer calls this after a successful pack).  Entries dirtied
        AFTER the epoch's revision stay queued."""
        with self._mutex:
            if self._rev == epoch.rev:
                # nothing marked since the snapshot took the epoch: every
                # queued entry is the epoch's (a copy of the reference's
                # per-entry loop below would walk every dirty task of a
                # fresh cache)
                self._dirty_tasks.clear()
                self._dirty_nodes.clear()
                self._dirty_nodes_full.clear()
                return
            for uid in list(epoch.dirty_tasks):
                if self._dirty_tasks.get(uid, epoch.rev + 1) <= epoch.rev:
                    del self._dirty_tasks[uid]
            for name in list(epoch.dirty_nodes):
                if self._dirty_nodes.get(name, epoch.rev + 1) <= epoch.rev:
                    del self._dirty_nodes[name]
            for name in list(epoch.dirty_nodes_full):
                if self._dirty_nodes_full.get(name, epoch.rev + 1) <= epoch.rev:
                    del self._dirty_nodes_full[name]

    @property
    def pack_cache(self):
        """The cycle-persistent warm packer bound to this cache (lazy —
        pure-host deployments that never run gpu-allocate don't pay for
        it)."""
        if self._pack_cache is None:
            from volcano_tpu_torch.ops.pack_cache import PackCache

            self._pack_cache = PackCache(self)
        return self._pack_cache

    # ---- event handlers: pods (event_handlers.go:39-254) ----

    def _get_or_create_job(self, ti: TaskInfo) -> Optional[JobInfo]:
        # requires-lock: self._mutex
        """event_handlers.go:44-58 — only pods carrying a PodGroup
        annotation get a job; others are node-accounting-only."""
        if not ti.job:
            return None
        if ti.job not in self.jobs:
            self.jobs[ti.job] = JobInfo(ti.job)
        return self.jobs[ti.job]

    def _add_task(self, ti: TaskInfo) -> None:
        # requires-lock: self._mutex
        """event_handlers.go:60-79."""
        job = self._get_or_create_job(ti)
        if job is not None:
            job.add_task_info(ti)
            self._mark_job(ti.job)
        if ti.node_name:
            self._mark_node(ti.node_name)
        if ti.node_name:
            if ti.node_name not in self.nodes:
                self.nodes[ti.node_name] = NodeInfo(None)
                self.nodes[ti.node_name].name = ti.node_name
            if not is_terminated(ti.status):
                try:
                    self.nodes[ti.node_name].add_task(ti)
                except ValueError as e:
                    # a double add — the reference logs and keeps the
                    # node-held task (event_handlers.go AddPod error path)
                    log.debug("add task to node: %s", e)

    def _delete_task(self, ti: TaskInfo) -> None:
        # requires-lock: self._mutex
        """event_handlers.go:126-151."""
        if ti.job and ti.job in self.jobs:
            job = self.jobs[ti.job]
            stored = job.tasks.get(ti.uid)
            if stored is not None:
                job.delete_task_info(stored)
                self._mark_job(ti.job)
        if ti.node_name and ti.node_name in self.nodes:
            node = self.nodes[ti.node_name]
            if ti.uid in node.tasks:
                node.remove_task(ti)
                self._mark_node(ti.node_name)

    def add_pod(self, pod: core.Pod) -> None:
        with self._mutex:
            ti = new_task_info(pod)
            self._mark_task(ti.uid)
            self._clear_quarantine(ti.uid)
            self._add_task(ti)
        # a freshly-submitted schedulable pod is THE micro-cycle trigger;
        # a pre-bound or terminated pod only moves accounting
        self._emit_change(
            "task"
            if not ti.node_name and ti.status == TaskStatus.Pending
            else None
        )

    def update_pod(self, old_pod: core.Pod, new_pod: core.Pod) -> None:
        with self._mutex:
            old_ti = new_task_info(old_pod)
            new_ti = new_task_info(new_pod)
            # status/node churn re-derives job/node accounting (marked by
            # _delete/_add below) but keeps the packed task row clean —
            # only spec-level changes invalidate it
            spec_changed = _task_pack_relevant_changed(old_pod, new_pod)
            if spec_changed:
                self._mark_task(new_ti.uid)
            self._clear_quarantine(new_ti.uid)
            self._delete_task(old_ti)
            self._add_task(new_ti)
        self._emit_change(
            self._classify_pod_update(old_ti, new_ti, spec_changed)
        )

    def delete_pod(self, pod: core.Pod) -> None:
        with self._mutex:
            ti = new_task_info(pod)
            self._mark_task(ti.uid)
            self._clear_quarantine(ti.uid)
            self._delete_task(ti)
        # a deleted bound pod frees capacity stuck tasks may want; a
        # deleted pending pod just removes work
        self._emit_change("node" if ti.node_name else None)

    # ---- event handlers: nodes (event_handlers.go:255-354) ----

    def add_node(self, node: core.Node) -> None:
        with self._mutex:
            name = node.metadata.name
            fresh = name not in self.nodes
            if fresh:
                self.nodes[name] = NodeInfo(node)
                self._mark_topology()
            else:
                self.nodes[name].set_node(node)
            self._mark_node_full(name)
        self._emit_change("topology" if fresh else "node")

    def update_node(self, old_node: core.Node, new_node: core.Node) -> None:
        self.add_node(new_node)

    def delete_node(self, node: core.Node) -> None:
        with self._mutex:
            popped = self.nodes.pop(node.metadata.name, None) is not None
            if popped:
                self._mark_topology()
                self._mark_node_full(node.metadata.name)
                # mutation stamps only matter for LIVE objects (absent
                # entry = never reusable) — drop so the dict tracks the
                # live node set, not historical churn
                self._node_mut_rev.pop(node.metadata.name, None)
        if popped:
            self._emit_change("topology")

    # ---- event handlers: podgroups (event_handlers.go:356-581) ----

    def _set_pod_group(self, pg: scheduling.PodGroup) -> None:
        with self._mutex:
            job_id = pg.key()
            if job_id not in self.jobs:
                self.jobs[job_id] = JobInfo(job_id)
            self.jobs[job_id].set_pod_group(pg)
            self._mark_job(job_id)

    def add_pod_group(self, pg: scheduling.PodGroup) -> None:
        self._set_pod_group(pg)
        # a gang group's members arrive as an event storm right behind
        # it — route the whole arrival to a full cycle (the gang/fair-
        # share re-equilibration path) instead of micro-scheduling a
        # half-arrived gang
        self._emit_change(
            "gang" if (pg.spec.min_member or 0) > 1 else "group"
        )

    def update_pod_group(self, old_pg, new_pg: scheduling.PodGroup) -> None:
        self._set_pod_group(new_pg)
        # the overwhelmingly common MODIFIED is our own status writeback
        # echoing back through the watch — only a SPEC change is
        # scheduling-relevant
        self._emit_change(
            "group" if old_pg is None or old_pg.spec != new_pg.spec else None
        )

    def delete_pod_group(self, pg: scheduling.PodGroup) -> None:
        with self._mutex:
            job = self.jobs.get(pg.key())
            if job is not None:
                job.pod_group = None
                self._mark_job(pg.key())
                # Jobs without scheduling spec drop out of snapshots; GC'd
                # when tasks drain (cleanup worker in the reference).
                if not job.tasks:
                    del self.jobs[pg.key()]
                    self._job_mut_rev.pop(pg.key(), None)
                    self.unschedulable_digest.pop(pg.key(), None)
        self._emit_change("group")

    # ---- dual-version handlers (cache.go:393-424: the v1alpha1
    # informer set converts BOTH old and new through the scheme, then
    # delegates) ----

    def add_pod_group_v1alpha1(self, pg) -> None:
        self.add_pod_group(scheme.pod_group_v1alpha1_to_hub(pg))

    def update_pod_group_v1alpha1(self, old_pg, new_pg) -> None:
        self.update_pod_group(
            scheme.pod_group_v1alpha1_to_hub(old_pg) if old_pg is not None else None,
            scheme.pod_group_v1alpha1_to_hub(new_pg),
        )

    def delete_pod_group_v1alpha1(self, pg) -> None:
        self.delete_pod_group(scheme.pod_group_v1alpha1_to_hub(pg))

    def add_queue_v1alpha1(self, queue) -> None:
        self.add_queue(scheme.queue_v1alpha1_to_hub(queue))

    def update_queue_v1alpha1(self, old_queue, new_queue) -> None:
        self.update_queue(
            scheme.queue_v1alpha1_to_hub(old_queue) if old_queue is not None else None,
            scheme.queue_v1alpha1_to_hub(new_queue),
        )

    def delete_queue_v1alpha1(self, queue) -> None:
        self.delete_queue(scheme.queue_v1alpha1_to_hub(queue))

    # ---- event handlers: queues (event_handlers.go:696-863) ----

    def add_queue(self, queue: scheduling.Queue) -> None:
        with self._mutex:
            qi = QueueInfo(queue)
            self.queues[qi.uid] = qi
        self._emit_change("group")

    def update_queue(self, old_queue, new_queue: scheduling.Queue) -> None:
        with self._mutex:
            qi = QueueInfo(new_queue)
            self.queues[qi.uid] = qi
        # status writebacks echo through the watch every cycle — only a
        # spec change (weight/capability) is scheduling-relevant
        self._emit_change(
            "group"
            if old_queue is None or old_queue.spec != new_queue.spec
            else None
        )

    def delete_queue(self, queue: scheduling.Queue) -> None:
        with self._mutex:
            self.queues.pop(queue.metadata.name, None)
        self._emit_change("group")

    # ---- event handlers: priority classes (event_handlers.go:865-958) ----

    def add_priority_class(self, pc: core.PriorityClass) -> None:
        with self._mutex:
            self.priority_classes[pc.metadata.name] = pc
            if pc.global_default:
                self.default_priority = pc.value
        self._emit_change("group")

    def delete_priority_class(self, pc: core.PriorityClass) -> None:
        with self._mutex:
            self.priority_classes.pop(pc.metadata.name, None)
            if pc.global_default:
                self.default_priority = 0
        self._emit_change("group")

    # ---- PVC handlers (pvcInformer wiring, cache.go:415-421) ----

    def _put_pvc(self, pvc: core.PersistentVolumeClaim) -> None:
        with self._mutex:
            self.pvcs[f"{pvc.metadata.namespace}/{pvc.metadata.name}"] = pvc

    def add_pvc(self, pvc: core.PersistentVolumeClaim) -> None:
        self._put_pvc(pvc)
        self._emit_change("group")

    def update_pvc(self, old, new: core.PersistentVolumeClaim) -> None:
        # echo suppression: bind_volumes already parked our own
        # provisioning write via _put_pvc, so when the watch echoes it
        # back the cached object matches the incoming one (modulo the
        # store's resourceVersion bump) — such an update carries no new
        # scheduling information and must not wake the event loop
        with self._mutex:
            key = f"{new.metadata.namespace}/{new.metadata.name}"
            cached = self.pvcs.get(key)
        if cached is not None:
            a, b = cached.clone(), new.clone()
            a.metadata.resource_version = b.metadata.resource_version = 0
            if a == b:
                self._put_pvc(new)  # keep the fresher resourceVersion
                return
        self.add_pvc(new)

    def delete_pvc(self, pvc: core.PersistentVolumeClaim) -> None:
        with self._mutex:
            self.pvcs.pop(f"{pvc.metadata.namespace}/{pvc.metadata.name}", None)
        self._emit_change("group")

    # ---- event handlers: resource quotas (event_handlers.go:961-1036) ----

    def add_resource_quota(self, namespace: str, quota_name: str, weight: Optional[int]) -> None:
        with self._mutex:
            coll = self.namespace_collections.setdefault(
                namespace, NamespaceCollection(namespace)
            )
            coll.update(quota_name, weight)
        self._emit_change("group")

    def delete_resource_quota(self, namespace: str, quota_name: str) -> None:
        with self._mutex:
            coll = self.namespace_collections.get(namespace)
            if coll is not None:
                coll.delete(quota_name)
        self._emit_change("group")

    # ---- snapshot (cache.go:712-790) ----

    def snapshot(self, scope: str = "full") -> ClusterInfo:
        """Every ready node, queue and PVC, each namespace's weight, and
        every job with a PodGroup in a known queue, deep-copied for one
        session — or, with ``snapshot_reuse``, the previous session's
        clone of an object that session left untouched and the cache has
        not mutated since.  Stamps the change-tracking epoch
        (``pack_epoch``).

        ``scope`` is the incremental-session seam:
          "full"       — every job (the classic snapshot);
          "restricted" — clone ONLY jobs with schedulable work
                         (O(pending), the restricted micro-cycle);
          "shadow"     — full job set, but ALSO annotated like a
                         restricted snapshot, so one atomic world can
                         feed both the restricted session and its
                         shadow full-session cross-check (computing the
                         restricted set outside the mutex would race
                         cache churn into false divergence).
        "restricted"/"shadow" attach ``share_seed`` (the ledger's cloned
        totals) and ``restricted_uids`` (the schedulable jobs that made
        it into the snapshot).

        COMMIT BARRIER: every in-flight pipelined effect (binds, evicts,
        status writebacks handed off last cycle) lands before new
        cluster state is read, which keeps the overlapped commit plane
        coherent with the store; failed items enqueued their resyncs,
        which the drain below then retries on the cycle boundary."""
        if self._commit_plane is not None:
            self._commit_plane.barrier()
        self.process_due_resyncs()
        with self._mutex:
            snapshot = ClusterInfo()
            self._bound_dirty()

            pool_n, pool_j = {}, {}
            if self.snapshot_reuse and not self._pool_open and self._pool_rev >= 0:
                pool_n, pool_j = self._pool_nodes, self._pool_jobs
            reused_n = reused_j = 0

            for node in self.nodes.values():
                if not node.ready():
                    continue
                pooled = pool_n.get(node.name)
                if (
                    pooled is not None
                    and self._node_mut_rev.get(node.name, self._rev + 1)
                    <= self._pool_rev
                ):
                    snapshot.nodes[node.name] = pooled
                    reused_n += 1
                else:
                    snapshot.nodes[node.name] = node.clone()
            for queue in self.queues.values():
                snapshot.queues[queue.uid] = queue.clone()
            for key, pvc in self.pvcs.items():
                snapshot.pvcs[key] = pvc.clone()
            for name, coll in self.namespace_collections.items():
                snapshot.namespace_info[name] = coll.snapshot()
            if scope == "restricted":
                job_iter = [
                    self.jobs[uid]
                    for uid in sorted(self.share_ledger.schedulable_uids())
                    if uid in self.jobs
                ]
            else:
                job_iter = self.jobs.values()
            for job in job_iter:
                # No scheduling spec → not schedulable (cache.go:765-770).
                if job.pod_group is None:
                    continue
                if job.queue not in snapshot.queues:
                    continue
                job.priority = self.default_priority
                pc = self.priority_classes.get(job.pod_group.spec.priority_class_name)
                if pc is not None:
                    job.priority = pc.value
                pooled = pool_j.get(job.uid)
                if (
                    pooled is not None
                    and self._job_mut_rev.get(job.uid, self._rev + 1)
                    <= self._pool_rev
                ):
                    snapshot.jobs[job.uid] = pooled
                    reused_j += 1
                else:
                    snapshot.jobs[job.uid] = job.clone()
                # re-stamped even on pooled clones: priority classes are
                # not tracked by the mutation revs
                snapshot.jobs[job.uid].priority = job.priority

            snapshot.pack_epoch = PackEpoch(
                rev=self._rev,
                topology_rev=self._topology_rev,
                dirty_tasks=set(self._dirty_tasks),
                dirty_nodes=set(self._dirty_nodes),
                dirty_nodes_full=set(self._dirty_nodes_full),
            )
            if scope != "full":
                snapshot.share_seed = self.share_ledger.seed()
                if scope == "restricted":
                    snapshot.restricted_uids = set(snapshot.jobs)
                else:
                    snapshot.restricted_uids = (
                        self.share_ledger.schedulable_uids()
                        & set(snapshot.jobs)
                    )
            self.last_pool_reuse = (reused_n, reused_j)
            if self.snapshot_reuse:
                self._clone_gen += 1
                snapshot.clone_gen = self._clone_gen
                self._handed_nodes = dict(snapshot.nodes)
                self._handed_jobs = dict(snapshot.jobs)
                self._handed_rev = self._rev
                self._pool_nodes = {}
                self._pool_jobs = {}
                self._pool_rev = -1
                self._pool_open = True
            return snapshot

    def release_session_clones(
        self, clone_gen: int, touched_jobs, touched_nodes
    ) -> None:
        """close_session hands back the session's untouched clones so the
        next snapshot can reuse them (opt-in, ``snapshot_reuse=True``).
        ``touched_*`` are the session's mutation sets — anything in them
        (or from a stale generation) is simply dropped."""
        with self._mutex:
            if not self.snapshot_reuse or clone_gen != self._clone_gen:
                return
            self._pool_nodes = {
                name: cl
                for name, cl in self._handed_nodes.items()
                if name not in touched_nodes
            }
            self._pool_jobs = {
                uid: cl
                for uid, cl in self._handed_jobs.items()
                if uid not in touched_jobs
            }
            self._pool_rev = self._handed_rev
            self._handed_nodes = {}
            self._handed_jobs = {}
            self._pool_open = False

    # ---- side effects (cache.go:498-615) ----

    def _find_job_and_task(self, task_info: TaskInfo):
        # requires-lock: self._mutex
        job = self.jobs.get(task_info.job)
        if job is None:
            raise KeyError(f"failed to find job {task_info.job}")
        task = job.tasks.get(task_info.uid)
        if task is None:
            raise KeyError(
                f"failed to find task in status {task_info.status.name} by id {task_info.uid}"
            )
        return job, task

    def bind(self, task_info: TaskInfo, hostname: str) -> None:
        """cache.go:557-615."""
        self.bind_batch([(task_info, hostname)])

    @staticmethod
    def _maybe_fail_bind() -> None:
        """``cache.bind_fail`` injection point: a burst of apiserver
        bind rejections feeding the errTask resync queue, through the
        exact except path a real rejection takes."""
        fp = faults.get_plane()
        if fp.enabled and fp.should("cache.bind_fail"):
            raise RuntimeError("fault-injected bind failure")

    def bind_batch(self, pairs) -> None:
        """Bind many (task_info, hostname) pairs: the per-task state
        mutations under ONE mutex hold, then the binder effects in task
        order (one commit frame, or one commit-plane submission).  Every
        pair is resolved before any is mutated, so a bad pair leaves no
        task mutated with its binder effect dropped.  This is the
        bulk-commit path of fully-placed device sessions
        (actions/fast_apply.py)."""
        bound = []
        with self._mutex:
            resolved = []
            for task_info, hostname in pairs:
                job, task = self._find_job_and_task(task_info)
                node = self.nodes.get(hostname)
                if node is None:
                    raise KeyError(
                        f"failed to bind task {task.uid} to host {hostname}:"
                        " host not found"
                    )
                resolved.append((job, task, node, hostname))
            for job, task, node, hostname in resolved:
                job.update_task_status(task, TaskStatus.Binding)
                task.node_name = hostname
                node.add_task(task)
                self._mark_job(task.job)
                self._mark_node(hostname)
                bound.append((task, hostname))

        self._dispatch_binds(bound)

    # ---- commit dispatch: pipelined plane or synchronous effects ----

    def _dispatch_binds(self, pairs) -> None:
        if not pairs:
            return
        if self._commit_plane is not None:
            self._commit_plane.submit_binds(pairs)
        else:
            self._run_bind_items([(t, h, None) for t, h in pairs])

    def _dispatch_evicts(self, pairs) -> None:
        if not pairs:
            return
        if self._commit_plane is not None:
            self._commit_plane.submit_evicts(pairs)
        else:
            self._run_evict_items([(t, r, None) for t, r in pairs])

    def _run_bind_items(self, items, inject: bool = True) -> None:
        """Land ``[(task, hostname, doom)]`` binder effects: one
        coalesced commit frame when the default binder is wired to a
        commit_batch-capable client (the in-process APIServer),
        per-object binder calls otherwise.  ``doom`` is a
        pre-drawn injected failure (the commit plane evaluates fault
        points at submit time); ``inject`` draws cache.bind_fail here —
        the synchronous path, where this IS the submitting thread.
        Failures, injected or real, take the same FailedScheduling-event
        + resync path the synchronous effects always have."""
        ok = []
        for task, hostname, doom in items:
            try:
                if doom is not None:
                    raise doom
                if inject:
                    self._maybe_fail_bind()
            except Exception as e:  # noqa: BLE001
                self._fail_bind_item(task, hostname, e)
                continue
            ok.append((task, hostname))
        if not ok:
            return
        metrics.observe_bind_coalesce(len(ok))
        if self._fast_bind:
            frame = [
                {
                    "namespace": t.namespace, "name": t.name, "hostname": h,
                    "event": {
                        "type": "Normal", "reason": "Scheduled",
                        "message": f"Successfully assigned"
                                   f" {t.namespace}/{t.name} to {h}",
                    },
                }
                for t, h in ok
            ]
            try:
                results = self.client.commit_batch(binds=frame)["binds"]
            except Exception as e:  # noqa: BLE001 — frame-level failure:
                # every item takes the resync path
                for t, h in ok:
                    self._fail_bind_item(t, h, e)
                return
            for (t, h), err in zip(ok, results):
                if err is not None:
                    self._fail_bind_item(t, h, RuntimeError(err))
                else:
                    self._observe_bind_latency(t, h)
            return
        for task, hostname in ok:
            try:
                if self.binder is not None:
                    self.binder.bind(task, hostname)
            except Exception as e:  # noqa: BLE001
                self._fail_bind_item(task, hostname, e)
            else:
                self._observe_bind_latency(task, hostname)
                # cache.go:600-610 — the Scheduled audit event
                self._record_event(
                    task, "Normal", "Scheduled",
                    f"Successfully assigned {task.namespace}/{task.name}"
                    f" to {hostname}",
                )

    @staticmethod
    def _observe_bind_latency(task: TaskInfo, hostname: str = "") -> None:
        """volcano_submit_to_bind_latency_milliseconds: store creation
        timestamp → bind effect landed — the sustained-load SLO number,
        recorded here so the synchronous and pipelined paths share the
        one landing site.  Synthetic fixtures carry small ordinal
        timestamps, not epochs — only a plausible wall-clock stamp is
        observed (everything else would land in +Inf and poison the
        percentiles).  The flight-recorder ``bind:landed`` span rides
        the same site: one landing, every sink."""
        metrics.update_pod_schedule_status("successes")
        pod = task.pod
        ts = pod.metadata.creation_timestamp if pod is not None else 0
        if ts and ts > 1e9:  # epoch seconds, not an ordinal fixture stamp
            # det: submit-to-bind latency from the pod's epoch stamp, a metric, not a decision
            metrics.observe_submit_to_bind(max(time.time() - ts, 0.0))
        if obs.enabled():
            args = {"pod": f"{task.namespace}/{task.name}"}
            if hostname:
                args["node"] = hostname
            gang = ""
            if pod is not None:
                gang = pod.metadata.annotations.get(scheduling.GROUP_NAME_ANNOTATION_KEY, "")
            if gang:
                args["gang"] = f"{task.namespace}/{gang}"
            obs.complete(
                "bind:landed", 0.0, cat="bind",
                trace_id=obs.trace_id_for_pod(task.namespace, task.name),
                args=args,
            )

    def _fail_bind_item(self, task, hostname, e) -> None:
        log.error("bind of %s/%s failed: %s", task.namespace, task.name, e)
        metrics.register_commit_failure("bind")
        metrics.update_pod_schedule_status("errors")
        self._record_event(
            task, "Warning", "FailedScheduling",
            f"failed to bind to {hostname}: {e}",
        )
        self.resync_task(task)

    def _run_evict_items(self, items) -> None:
        """Land ``[(task, reason, doomed)]`` evictor effects — same
        fast/slow split and failure semantics as the bind items."""
        ok = []
        for task, reason, doom in items:
            if doom is not None:
                self._fail_evict_item(task, doom)
                continue
            ok.append((task, reason))
        if not ok:
            return
        if self._fast_evict:
            frame = [
                {
                    "namespace": t.namespace, "name": t.name,
                    "event": {
                        "type": "Normal", "reason": "Evict",
                        "message": f"Evicted {t.namespace}/{t.name}: {r}",
                    },
                }
                for t, r in ok
            ]
            try:
                results = self.client.commit_batch(evicts=frame)["evicts"]
            except Exception as e:  # noqa: BLE001
                for t, _r in ok:
                    self._fail_evict_item(t, e)
                return
            for (t, _r), err in zip(ok, results):
                if err is not None:
                    self._fail_evict_item(t, RuntimeError(err))
            return
        for task, reason in ok:
            try:
                if self.evictor is not None:
                    self.evictor.evict(task)
            except Exception as e:  # noqa: BLE001
                self._fail_evict_item(task, e)
            else:
                # cache.go:528 — the Evict audit event (reason carries
                # the action: "preempt" / "reclaim")
                self._record_event(
                    task, "Normal", "Evict",
                    f"Evicted {task.namespace}/{task.name}: {reason}",
                )

    def _fail_evict_item(self, task, e) -> None:
        log.error("evict of %s/%s failed: %s", task.namespace, task.name, e)
        metrics.register_commit_failure("evict")
        self.resync_task(task)

    def _record_event(self, task: TaskInfo, type_: str, reason: str, message: str) -> None:
        """Record a pod-scoped Event through the client (the user-facing
        audit trail, cache.go:832-867, 600-610); best-effort."""
        if self.client is None or not hasattr(self.client, "record_event"):
            # SchedulerClient records; a client genuinely without the
            # capability silently losing the audit trail is worth
            # exactly one log line, not one per event
            if self.client is not None and not self._warned_no_events:
                self._warned_no_events = True
                log.warning(
                    "cache client %s cannot record events — the "
                    "Scheduled/Unschedulable audit trail is disabled",
                    type(self.client).__name__,
                )
            return
        try:
            self.client.record_event(
                task.namespace,
                {"kind": "Pod", "namespace": task.namespace, "name": task.name},
                type_,
                reason,
                message,
            )
        except Exception as e:  # noqa: BLE001 — events must never fail ops
            log.error("record event failed: %s", e)

    def evict(self, task_info: TaskInfo, reason: str) -> None:
        """cache.go:498-554."""
        with self._mutex:
            job, task = self._find_job_and_task(task_info)
            node = self.nodes.get(task.node_name)
            if node is None:
                raise KeyError(
                    f"failed to evict task {task.uid}: host {task.node_name} not found"
                )
            job.update_task_status(task, TaskStatus.Releasing)
            node.update_task(task)
            self._mark_job(task.job)
            self._mark_node(task.node_name)

        self._dispatch_evicts([(task, reason)])

    # ---- volume binding (cache.go:243-258, 617-623) ----

    @staticmethod
    def task_claim_names(task: TaskInfo) -> List[str]:
        """PVC claim names referenced by the task's pod."""
        if task.pod is None:
            return []
        claims = []
        for vol in task.pod.spec.volumes:
            ref = vol.source.get("persistentVolumeClaim")
            if ref and ref.get("claimName"):
                claims.append(ref["claimName"])
        return claims

    def allocate_volumes(self, task: TaskInfo, hostname: str) -> None:
        """AssumePodVolumes analogue: record whether every referenced PVC
        is already Bound (task.volume_ready), so bind_volumes knows
        whether there is provisioning left to do (cache.go:243-249)."""
        with self._mutex:
            all_bound = True
            for claim in self.task_claim_names(task):
                pvc = self.pvcs.get(f"{task.namespace}/{claim}")
                if pvc is None or pvc.status.get("phase") != "Bound":
                    all_bound = False
            task.volume_ready = all_bound

    def bind_volumes(self, task: TaskInfo) -> None:
        """BindPodVolumes analogue (cache.go:251-258): dynamically
        provision still-pending PVCs that carry a storage class — write
        the selected node, a volume name, and phase Bound through the
        client.  Raises on a PVC that cannot be bound (no storage class,
        nothing provisionable) — the commit path converts that into an
        unbind + resync, exactly like an apiserver bind failure."""
        if task.volume_ready:
            return
        for claim in self.task_claim_names(task):
            key = f"{task.namespace}/{claim}"
            with self._mutex:
                pvc = self.pvcs.get(key)
            if pvc is None:
                raise KeyError(f"persistentvolumeclaim {key} not found")
            if pvc.status.get("phase") == "Bound":
                continue
            if not pvc.spec.get("storageClassName"):
                raise RuntimeError(
                    f"pod has unbound immediate PersistentVolumeClaims: {key}"
                )
            pvc = pvc.clone()
            pvc.metadata.annotations["volume.kubernetes.io/selected-node"] = (
                task.node_name
            )
            pvc.spec["volumeName"] = f"pv-{pvc.metadata.name}"
            pvc.status["phase"] = "Bound"
            if self.client is not None and hasattr(self.client, "update_pvc"):
                self.client.update_pvc(pvc)
            # _put_pvc, not add_pvc: our own provisioning write must not
            # wake the event loop (the watch echo is suppressed the same
            # way bind echoes are)
            self._put_pvc(pvc)
        task.volume_ready = True

    #: resync retry bound + backoff (cache.go:687-709 errTasks uses a
    #: rate-limited workqueue with MaxRetries; these are that policy)
    _RESYNC_MAX_RETRIES = 5
    _RESYNC_BACKOFF_BASE = 0.2  # seconds; exponential per attempt
    _QUARANTINE_COOLDOWN = 30.0  # seconds before a quarantined task retries
    #: per-cycle drain bounds: each retry is a blocking get_pod on the
    #: scheduling thread, so during a store outage an unbounded drain
    #: would stall snapshot() by queue-length × RPC-timeout
    _RESYNC_DRAIN_MAX = 16
    _RESYNC_DRAIN_BUDGET_S = 1.0

    def resync_task(self, task: TaskInfo) -> None:
        """Requeue for resync from API truth (cache.go:687-709).
        Deduped by uid; a task already in quarantine stays there until
        fresh API truth for its pod arrives."""
        with self._mutex:
            if (
                task.uid in self.quarantined_tasks
                or task.uid in self._resync_inflight
                or any(e[0].uid == task.uid for e in self.err_tasks)
            ):
                return
            self.err_tasks.append([task, 0, time.monotonic()])
        if self.client is not None:
            self.process_resync_task()

    def process_resync_task(self) -> None:
        """Re-fetch the pod and rebuild the task (cache.go syncTask).
        One DUE entry per call; a failed fetch backs off exponentially
        and, past _RESYNC_MAX_RETRIES, quarantines the task with a
        Warning Event instead of requeueing forever."""
        if self.client is None:
            return
        now = time.monotonic()
        with self._mutex:
            entry = None
            for i, e in enumerate(self.err_tasks):
                if e[2] <= now:
                    entry = self.err_tasks.pop(i)
                    break
            if entry is None:
                return
            self._resync_inflight.add(entry[0].uid)
        task, attempts = entry[0], entry[1]
        try:
            fp = faults.get_plane()
            if fp.enabled and fp.should("cache.resync_fail"):
                raise RuntimeError("fault-injected resync fetch failure")
            pod = self.client.get_pod(task.namespace, task.name)
        except Exception as e:  # noqa: BLE001 — API truth unreachable
            # note: the requeue/quarantine insertions below happen
            # BEFORE the finally's inflight release, so dedup never has
            # a gap where the task is in neither set
            attempts += 1
            if attempts >= self._RESYNC_MAX_RETRIES:
                log.error(
                    "resync of %s/%s failed %d times (%s); quarantining",
                    task.namespace, task.name, attempts, e,
                )
                self._record_event(
                    task, "Warning", "ResyncFailed",
                    f"task state resync failed {attempts} times and was "
                    f"quarantined pending fresh API truth: {e}",
                )
                with self._mutex:
                    self.quarantined_tasks[task.uid] = [
                        task, time.monotonic()
                    ]
                    self._update_quarantine_gauge()
            else:
                backoff = self._RESYNC_BACKOFF_BASE * (2 ** (attempts - 1))
                log.warning(
                    "resync of %s/%s failed (%s); retry %d/%d in %.1fs",
                    task.namespace, task.name, e, attempts,
                    self._RESYNC_MAX_RETRIES, backoff,
                )
                with self._mutex:
                    self.err_tasks.append(
                        [task, attempts, time.monotonic() + backoff]
                    )
            return
        finally:
            with self._mutex:
                self._resync_inflight.discard(task.uid)
        with self._mutex:
            # resync exists precisely because the cached view may have
            # diverged from API truth — the refetched spec can differ,
            # so the packed task row must not be reused
            self._mark_task(task.uid)
            self._delete_task(task)
            if pod is not None:
                self._add_task(new_task_info(pod))
        # a resynced task is schedulable work again (the failed bind was
        # unwound against API truth) — wake the event loop for it
        self._emit_change("task" if pod is not None else None)

    def process_due_resyncs(self) -> None:
        """Drain every due resync entry (called once per scheduling
        cycle from snapshot(), so backed-off entries retry without a
        dedicated timer thread).  Quarantined tasks past the cooldown
        re-enter the queue with a fresh attempt budget — a slow retry
        lane, since an unchanged pod never produces the watch event
        that is the quarantine's fast exit."""
        now = time.monotonic()
        with self._mutex:
            expired = [
                uid for uid, (task, ts) in self.quarantined_tasks.items()
                if now - ts >= self._QUARANTINE_COOLDOWN
            ]
            for uid in expired:
                task, _ts = self.quarantined_tasks.pop(uid)
                self.err_tasks.append([task, 0, now])
            if expired:
                self._update_quarantine_gauge()
        drain_deadline = now + self._RESYNC_DRAIN_BUDGET_S
        # bounded by _RESYNC_DRAIN_MAX alone: each due iteration pops one
        # entry, and the due-check exits when the queue has nothing left
        for _ in range(self._RESYNC_DRAIN_MAX):
            with self._mutex:
                due = any(e[2] <= time.monotonic() for e in self.err_tasks)
            if not due or time.monotonic() >= drain_deadline:
                return
            self.process_resync_task()

    def _update_quarantine_gauge(self) -> None:
        # requires-lock: self._mutex
        metrics.update_resync_quarantined(len(self.quarantined_tasks))

    def _clear_quarantine(self, uid: str) -> None:
        # requires-lock: self._mutex
        """Fresh API truth for a quarantined task's pod arrived through
        the watch — the quarantine's exit condition."""
        if self.quarantined_tasks.pop(uid, None) is not None:
            self._update_quarantine_gauge()

    # ---- status writeback ----

    def record_job_status_event(self, job: JobInfo) -> None:
        """cache.go:832-867 — pod conditions for unschedulable tasks."""
        if self.status_updater is None:
            return
        base_message = job.job_fit_errors
        tasks_digest: Dict[str, dict] = {}
        for task in job.tasks.values():
            if task.status != TaskStatus.Pending:
                continue
            fit_errors = job.nodes_fit_errors.get(task.uid)
            message = fit_errors.error() if fit_errors is not None else base_message
            if message:
                tasks_digest[task.uid] = {
                    "name": task.name,
                    "message": message,
                }
            self._record_event(task, "Warning", "Unschedulable", message)
            try:
                self.status_updater.update_pod_condition(task, "Unschedulable", message)
            except Exception as e:  # noqa: BLE001
                log.error("update pod condition failed: %s", e)
        with self._mutex:
            if tasks_digest:
                self.unschedulable_digest[job.uid] = {
                    "namespace": job.namespace,
                    "name": job.name,
                    "queue": job.queue,
                    "job_fit_errors": job.job_fit_errors,
                    "tasks": tasks_digest,
                }
            else:
                self.unschedulable_digest.pop(job.uid, None)

    def update_job_status(self, job: JobInfo) -> Optional[scheduling.PodGroup]:
        """cache.go:871-894."""
        self.record_job_status_event(job)
        if self.status_updater is None or job.pod_group is None:
            return job.pod_group
        return self.status_updater.update_pod_group(job.pod_group)

    def update_job_status_async(self, job: JobInfo) -> Optional[scheduling.PodGroup]:
        """Pipelined per-job status writeback: capture the whole
        writeback — Unschedulable events + PodScheduled conditions for
        pending tasks, plus the PodGroup status update — as ONE
        commit-plane item, so a 50k-pod cycle's close issues O(jobs)
        coalesced frames instead of O(pods) store writes.  Falls back
        to the synchronous :meth:`update_job_status` when the plane is
        off.  The /explain digest is parked synchronously (it is
        host-side state the next request may read); the store writes
        land before the next snapshot's commit barrier."""
        if self._commit_plane is None:
            return self.update_job_status(job)
        payload = {"events": [], "conditions": [], "pod_group": None}
        if self.status_updater is not None:
            # same capture as record_job_status_event, deferred delivery
            base_message = job.job_fit_errors
            tasks_digest: Dict[str, dict] = {}
            for task in job.tasks.values():
                if task.status != TaskStatus.Pending:
                    continue
                fit_errors = job.nodes_fit_errors.get(task.uid)
                message = (
                    fit_errors.error() if fit_errors is not None
                    else base_message
                )
                if message:
                    tasks_digest[task.uid] = {
                        "name": task.name,
                        "message": message,
                    }
                payload["events"].append(
                    (task, "Warning", "Unschedulable", message)
                )
                payload["conditions"].append(
                    (task, "Unschedulable", message)
                )
            with self._mutex:
                if tasks_digest:
                    self.unschedulable_digest[job.uid] = {
                        "namespace": job.namespace,
                        "name": job.name,
                        "queue": job.queue,
                        "job_fit_errors": job.job_fit_errors,
                        "tasks": tasks_digest,
                    }
                else:
                    self.unschedulable_digest.pop(job.uid, None)
            if job.pod_group is not None:
                payload["pod_group"] = job.pod_group
        if payload["events"] or payload["conditions"] or payload["pod_group"]:
            self._commit_plane.submit_status(payload)
        return job.pod_group

    @staticmethod
    def _fail_status_attempts(n: int) -> None:
        """A failed async status writeback is a failed schedule attempt
        for each affected JOB: the synchronous path's JobUpdater
        converts its exception into ``schedule_attempts_total{error}``,
        but with the commit plane on, JobUpdater already returned
        success by the time the worker sees the failure — so the plane
        counts the error attempts itself (one per job payload), landing
        before the commit barrier releases the next cycle."""
        for _ in range(n):
            metrics.register_schedule_attempt("error")

    def _run_status_items(self, items) -> None:
        """Land ``[(payload, doomed)]`` status-writeback items (one
        payload = one job's whole writeback).  Fast path: the batch of
        jobs becomes one commit frame (events + conditions + PodGroup
        statuses).  Slow path: the per-object calls the synchronous
        writeback makes.  Failures are logged and counted — both in
        ``volcano_commit_failures_total{status}`` and as one
        ``schedule_attempts_total{error}`` per affected job — and the
        next cycle's updater recomputes and retries, the same
        convergence a synchronous writeback error relies on."""
        live = []
        for payload, doom in items:
            if doom is not None:
                metrics.register_commit_failure("status")
                self._fail_status_attempts(1)
                log.error("status writeback dropped by injected fault; "
                          "next cycle retries")
                continue
            live.append(payload)
        if not live:
            return
        if self._fast_status:
            # flatten the per-job payloads into one frame, remembering
            # which job each frame row came from so per-row errors can
            # be attributed back (one error ATTEMPT per failed job, no
            # matter how many of its rows failed)
            events, conditions, pod_groups = [], [], []
            ev_owner, cond_owner, pg_owner = [], [], []
            for pi, p in enumerate(live):
                for t, type_, reason, message in p["events"]:
                    events.append({
                        "namespace": t.namespace,
                        "involved": {"kind": "Pod",
                                     "namespace": t.namespace,
                                     "name": t.name},
                        "type": type_, "reason": reason,
                        "message": message,
                    })
                    ev_owner.append(pi)
                for t, reason, message in p["conditions"]:
                    conditions.append({
                        "namespace": t.namespace, "name": t.name,
                        "reason": reason, "message": message,
                    })
                    cond_owner.append(pi)
                if p["pod_group"] is not None:
                    pod_groups.append(p["pod_group"])
                    pg_owner.append(pi)
            try:
                results = self.client.commit_batch(
                    events=events, conditions=conditions,
                    pod_groups=pod_groups,
                )
            except Exception as e:  # noqa: BLE001 — frame-level failure:
                # every job's writeback was lost
                metrics.register_commit_failure("status")
                self._fail_status_attempts(len(live))
                log.error("batched status writeback failed: %s", e)
                return
            failed_jobs = set()
            for section, owners in (
                ("events", ev_owner),
                ("conditions", cond_owner),
                ("pod_groups", pg_owner),
            ):
                for i, err in enumerate(results.get(section, ())):
                    if err is not None:
                        metrics.register_commit_failure("status")
                        if i < len(owners):
                            failed_jobs.add(owners[i])
                        log.error("status writeback %s failed: %s",
                                  section, err)
            self._fail_status_attempts(len(failed_jobs))
            return
        for p in live:
            failed = False
            for t, type_, reason, message in p["events"]:
                self._record_event(t, type_, reason, message)
            for t, reason, message in p["conditions"]:
                try:
                    self.status_updater.update_pod_condition(
                        t, reason, message
                    )
                except Exception as e:  # noqa: BLE001
                    metrics.register_commit_failure("status")
                    failed = True
                    log.error("update pod condition failed: %s", e)
            if p["pod_group"] is not None and self.status_updater is not None:
                try:
                    self.status_updater.update_pod_group(p["pod_group"])
                except Exception as e:  # noqa: BLE001
                    metrics.register_commit_failure("status")
                    failed = True
                    log.error("update pod group failed: %s", e)
            if failed:
                self._fail_status_attempts(1)
