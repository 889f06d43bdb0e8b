"""SchedulerCache — mutex-guarded mirror of cluster state.

The synchronous path of ``volcano_tpu/cache/cache.py``: the event
handlers for pods, nodes, PodGroups, queues, priority classes and PVCs,
the full snapshot, bind/evict/volume/status effects dispatched inline on
the calling thread, the warm packer's change tracking (``PackEpoch``,
the dirty marks every handler makes, ``clear_dirty_through`` and the
lazy ``pack_cache``) and the opt-in snapshot clone pool
(``snapshot_reuse``, ``release_session_clones``).  Not present in the
port yet: the pipelined commit plane, the incremental share ledger (and
with it restricted snapshots), the resync worker and its quarantine,
change listeners, the informer sink, and the resource-quota handlers
(the namespace weights of drf's weighted namespace order).  A failed
bind or evict is queued in ``err_tasks`` for the resync a later slice
brings, as the reference queues it when it has no API client.

Reference: pkg/scheduler/cache/cache.go + event_handlers.go.  Fed by
event handlers (called directly, the reference's own unit-test pattern,
allocate_test.go:155-222); produces deep-copied snapshots.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from volcano_tpu_torch import metrics
from volcano_tpu_torch.api import (
    ClusterInfo,
    JobInfo,
    new_task_info,
    NodeInfo,
    QueueInfo,
    TaskInfo,
    TaskStatus,
)
from volcano_tpu_torch.apis import core, scheduling
from volcano_tpu_torch.cache.interface import Binder, Cache, Evictor, StatusUpdater
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


class SchedulerCache(Cache):
    def __init__(
        self,
        binder: Optional[Binder] = None,
        evictor: Optional[Evictor] = None,
        status_updater: Optional[StatusUpdater] = None,
        default_queue: str = "default",
        default_priority: int = 0,
        snapshot_reuse: bool = False,
    ):
        self._mutex = threading.RLock()
        self.default_queue = default_queue
        self.default_priority = default_priority

        self.jobs: Dict[str, JobInfo] = {}  # guarded-by: self._mutex
        self.nodes: Dict[str, NodeInfo] = {}  # guarded-by: self._mutex
        self.queues: Dict[str, QueueInfo] = {}  # guarded-by: self._mutex
        self.priority_classes: Dict[str, core.PriorityClass] = {}  # guarded-by: self._mutex
        #: PVCs keyed "ns/name" (pvcInformer, cache.go:415-421)
        self.pvcs: Dict[str, core.PersistentVolumeClaim] = {}  # guarded-by: self._mutex

        self.binder = binder
        self.evictor = evictor
        self.status_updater = status_updater

        #: tasks whose side effects failed, deduped by uid (cache.go:687-709
        #: errTasks); nothing drains it in the port yet
        self.err_tasks: List[TaskInfo] = []  # guarded-by: self._mutex
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

    # ---- lifecycle ----

    def run(self) -> None:
        """No informers: the port's cache is fed through its handlers."""

    def wait_for_cache_sync(self) -> bool:
        return True

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
            self._add_task(ti)

    def update_pod(self, old_pod: core.Pod, new_pod: core.Pod) -> None:
        with self._mutex:
            new_ti = new_task_info(new_pod)
            # status/node churn re-derives job/node accounting (marked by
            # _delete/_add below) but keeps the packed task row clean —
            # only spec-level changes invalidate it
            if _task_pack_relevant_changed(old_pod, new_pod):
                self._mark_task(new_ti.uid)
            self._delete_task(new_task_info(old_pod))
            self._add_task(new_ti)

    def delete_pod(self, pod: core.Pod) -> None:
        with self._mutex:
            ti = new_task_info(pod)
            self._mark_task(ti.uid)
            self._delete_task(ti)

    # ---- event handlers: nodes (event_handlers.go:255-354) ----

    def add_node(self, node: core.Node) -> None:
        with self._mutex:
            name = node.metadata.name
            if name in self.nodes:
                self.nodes[name].set_node(node)
            else:
                self.nodes[name] = NodeInfo(node)
                self._mark_topology()
            self._mark_node_full(name)

    def update_node(self, old_node: core.Node, new_node: core.Node) -> None:
        self.add_node(new_node)

    def delete_node(self, node: core.Node) -> None:
        with self._mutex:
            if self.nodes.pop(node.metadata.name, None) is not None:
                self._mark_topology()
                self._mark_node_full(node.metadata.name)
                # mutation stamps only matter for LIVE objects (absent
                # entry = never reusable) — drop so the dict tracks the
                # live node set, not historical churn
                self._node_mut_rev.pop(node.metadata.name, None)

    # ---- event handlers: podgroups (event_handlers.go:356-581) ----

    def add_pod_group(self, pg: scheduling.PodGroup) -> None:
        with self._mutex:
            job_id = pg.key()
            if job_id not in self.jobs:
                self.jobs[job_id] = JobInfo(job_id)
            self.jobs[job_id].set_pod_group(pg)
            self._mark_job(job_id)

    def update_pod_group(self, old_pg, new_pg: scheduling.PodGroup) -> None:
        self.add_pod_group(new_pg)

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

    # ---- event handlers: queues (event_handlers.go:696-863) ----

    def add_queue(self, queue: scheduling.Queue) -> None:
        with self._mutex:
            qi = QueueInfo(queue)
            self.queues[qi.uid] = qi

    def update_queue(self, old_queue, new_queue: scheduling.Queue) -> None:
        self.add_queue(new_queue)

    def delete_queue(self, queue: scheduling.Queue) -> None:
        with self._mutex:
            self.queues.pop(queue.metadata.name, None)

    # ---- event handlers: priority classes (event_handlers.go:865-958) ----

    def add_priority_class(self, pc: core.PriorityClass) -> None:
        with self._mutex:
            self.priority_classes[pc.metadata.name] = pc
            if pc.global_default:
                self.default_priority = pc.value

    def delete_priority_class(self, pc: core.PriorityClass) -> None:
        with self._mutex:
            self.priority_classes.pop(pc.metadata.name, None)
            if pc.global_default:
                self.default_priority = 0

    # ---- PVC handlers (pvcInformer wiring, cache.go:415-421) ----

    def add_pvc(self, pvc: core.PersistentVolumeClaim) -> None:
        with self._mutex:
            self.pvcs[f"{pvc.metadata.namespace}/{pvc.metadata.name}"] = pvc

    def update_pvc(self, old, new: core.PersistentVolumeClaim) -> None:
        self.add_pvc(new)

    def delete_pvc(self, pvc: core.PersistentVolumeClaim) -> None:
        with self._mutex:
            self.pvcs.pop(f"{pvc.metadata.namespace}/{pvc.metadata.name}", None)

    # ---- snapshot (cache.go:712-790) ----

    def snapshot(self) -> ClusterInfo:
        """Every ready node, queue and PVC, and every job with a PodGroup
        in a known queue, deep-copied for one session — or, with
        ``snapshot_reuse``, the previous session's clone of an object
        that session left untouched and the cache has not mutated since.
        Stamps the change-tracking epoch (``pack_epoch``)."""
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
            for job in self.jobs.values():
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

    def bind_batch(self, pairs) -> None:
        """Bind many (task_info, hostname) pairs: the per-task state
        mutations under ONE mutex hold, then the binder effects in task
        order.  Every pair is resolved before any is mutated, so a bad
        pair leaves no task mutated with its binder effect dropped.
        This is the bulk-commit path of fully-placed device sessions
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

        for task, hostname in bound:
            try:
                if self.binder is not None:
                    self.binder.bind(task, hostname)
            except Exception as e:  # noqa: BLE001
                log.error("bind of %s/%s failed: %s", task.namespace, task.name, e)
                metrics.register_commit_failure("bind")
                metrics.update_pod_schedule_status("errors")
                self.resync_task(task)
            else:
                metrics.update_pod_schedule_status("successes")

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
        try:
            if self.evictor is not None:
                self.evictor.evict(task)
        except Exception as e:  # noqa: BLE001
            log.error("evict of %s/%s failed: %s", task.namespace, task.name, e)
            metrics.register_commit_failure("evict")
            self.resync_task(task)

    def resync_task(self, task: TaskInfo) -> None:
        """Queue a task whose effect failed for resync from API truth
        (cache.go:687-709), once per uid."""
        with self._mutex:
            if all(t.uid != task.uid for t in self.err_tasks):
                self.err_tasks.append(task)

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
        """BindPodVolumes analogue (cache.go:251-258): provision
        still-pending PVCs that carry a storage class — the selected
        node, a volume name, and phase Bound.  Raises on a PVC that
        cannot be bound (no storage class); the commit path turns that
        into an unbind + resync, like an apiserver bind failure."""
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
            self.add_pvc(pvc)
        task.volume_ready = True

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
