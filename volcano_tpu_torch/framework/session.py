"""Session — per-cycle facade over the snapshot plus plugin callback registries.

A copy of ``volcano_tpu/framework/session.py``.

Reference: pkg/scheduler/framework/session.go (struct + mutating ops) and
session_plugins.go (tiered dispatch).  Dispatch semantics preserved exactly:

- order fns: first non-zero comparison in tier order wins, fallback to
  creation-timestamp/uid (session_plugins.go:286-420)
- preemptable/reclaimable: per-tier intersection across plugins; first tier
  yielding a non-None victim set decides (session_plugins.go:106-188)
- predicates: first veto wins (session_plugins.go:403-420)
- node order: additive across all enabled plugins (session_plugins.go:423-467)
"""

from __future__ import annotations

import uuid
from typing import TYPE_CHECKING, Callable, Dict, List, Optional, Tuple

from volcano_tpu_torch import trace
from volcano_tpu_torch.api import (
    JobInfo,
    NodeInfo,
    QueueInfo,
    TaskInfo,
    TaskStatus,
    ValidateResult,
)
from volcano_tpu_torch.api.queue_info import NamespaceInfo
from volcano_tpu_torch.apis import scheduling
from volcano_tpu_torch.cache.interface import Cache
from volcano_tpu_torch.framework.events import Event, EventHandler
from volcano_tpu_torch.framework.interface import Plugin
from volcano_tpu_torch.utils.logging import get_logger

if TYPE_CHECKING:  # the policy types import the framework package
    from volcano_tpu_torch.conf import Configuration, Tier

log = get_logger(__name__)


CompareFn = Callable[[object, object], int]
PredicateFn = Callable[[TaskInfo, NodeInfo], None]  # raises FitError to veto
NodeOrderFn = Callable[[TaskInfo, NodeInfo], float]
BatchNodeOrderFn = Callable[[TaskInfo, List[NodeInfo]], Dict[str, float]]
NodeMapFn = Callable[[TaskInfo, NodeInfo], float]
NodeReduceFn = Callable[[TaskInfo, Dict[str, List[Tuple[str, int]]]], None]
EvictableFn = Callable[[TaskInfo, List[TaskInfo]], Optional[List[TaskInfo]]]
ValidateFn = Callable[[object], bool]
ValidateExFn = Callable[[object], Optional[ValidateResult]]


class Session:
    def __init__(self, cache: Cache):
        self.uid: str = str(uuid.uuid4())
        self.cache = cache
        #: trace recorder pinned at open — the decision audit trail
        #: (bind/pipeline/evict tuples) for this cycle.  NullRecorder
        #: when tracing is off, so the emit guards cost one attribute
        #: access per placement.
        self._trace = trace.get_recorder()

        self.pod_group_status: Dict[str, scheduling.PodGroupStatus] = {}
        #: pod-group PHASE of every job at session open — the attempts
        #: accounting needs "was it Running before this cycle", which
        #: the conditions-based record above cannot answer for healthy
        #: Running groups (they carry no conditions)
        self.pod_group_phase0: Dict[str, str] = {}

        self.jobs: Dict[str, JobInfo] = {}
        self.nodes: Dict[str, NodeInfo] = {}
        self.queues: Dict[str, QueueInfo] = {}
        self.namespace_info: Dict[str, NamespaceInfo] = {}
        self.pvcs: Dict[str, object] = {}

        #: change-tracking epoch of the snapshot this session computes on
        #: (ClusterInfo.pack_epoch) — consumed by the warm packer
        self.pack_epoch = None
        #: clone-pool generation (cache.snapshot ↔ release_session_clones)
        self.clone_gen: int = 0
        #: job uids / node names whose CLONES this session mutated; every
        #: mutating path (session ops, Statement ops, the bulk apply, the
        #: drive loops, gang's close) records here so close_session can
        #: hand untouched clones back for reuse
        self.touched_jobs: set = set()
        self.touched_nodes: set = set()
        #: monotone count of node-state mutations (allocate / pipeline /
        #: dispatch / evict / bulk apply).  Unlike len(touched_nodes),
        #: it advances on REPEAT mutations of an already-touched node —
        #: the explain synthesis gate (actions/gpu_allocate) compares
        #: epochs to know whether node state moved since a pack.
        self.node_state_epoch: int = 0

        self.tiers: List[Tier] = []
        self.configurations: List[Configuration] = []

        self.plugins: Dict[str, Plugin] = {}
        self.event_handlers: List[EventHandler] = []
        self.job_order_fns: Dict[str, CompareFn] = {}
        self.queue_order_fns: Dict[str, CompareFn] = {}
        self.task_order_fns: Dict[str, CompareFn] = {}
        self.namespace_order_fns: Dict[str, CompareFn] = {}
        self.predicate_fns: Dict[str, PredicateFn] = {}
        self.node_order_fns: Dict[str, NodeOrderFn] = {}
        self.batch_node_order_fns: Dict[str, BatchNodeOrderFn] = {}
        self.node_map_fns: Dict[str, NodeMapFn] = {}
        self.node_reduce_fns: Dict[str, NodeReduceFn] = {}
        self._ordered_chains: Dict = {}
        self.preemptable_fns: Dict[str, EvictableFn] = {}
        self.reclaimable_fns: Dict[str, EvictableFn] = {}
        self.overused_fns: Dict[str, ValidateFn] = {}
        self.job_ready_fns: Dict[str, ValidateFn] = {}
        self.job_pipelined_fns: Dict[str, ValidateFn] = {}
        self.job_valid_fns: Dict[str, ValidateExFn] = {}
        self.job_enqueueable_fns: Dict[str, ValidateFn] = {}

    # ---- registration (session_plugins.go:26-104) ----

    def add_job_order_fn(self, name: str, fn: CompareFn) -> None:
        self.job_order_fns[name] = fn
        self._ordered_chains.clear()

    def add_queue_order_fn(self, name: str, fn: CompareFn) -> None:
        self.queue_order_fns[name] = fn
        self._ordered_chains.clear()

    def add_task_order_fn(self, name: str, fn: CompareFn) -> None:
        self.task_order_fns[name] = fn
        self._ordered_chains.clear()

    def add_namespace_order_fn(self, name: str, fn: CompareFn) -> None:
        self.namespace_order_fns[name] = fn
        self._ordered_chains.clear()

    def add_preemptable_fn(self, name: str, fn: EvictableFn) -> None:
        self.preemptable_fns[name] = fn

    def add_reclaimable_fn(self, name: str, fn: EvictableFn) -> None:
        self.reclaimable_fns[name] = fn

    def add_job_ready_fn(self, name: str, fn: ValidateFn) -> None:
        self.job_ready_fns[name] = fn

    def add_job_pipelined_fn(self, name: str, fn: ValidateFn) -> None:
        self.job_pipelined_fns[name] = fn

    def add_predicate_fn(self, name: str, fn: PredicateFn) -> None:
        self.predicate_fns[name] = fn

    def add_node_order_fn(self, name: str, fn: NodeOrderFn) -> None:
        self.node_order_fns[name] = fn

    def add_batch_node_order_fn(self, name: str, fn: BatchNodeOrderFn) -> None:
        self.batch_node_order_fns[name] = fn

    def add_node_map_fn(self, name: str, fn: NodeMapFn) -> None:
        self.node_map_fns[name] = fn

    def add_node_reduce_fn(self, name: str, fn: NodeReduceFn) -> None:
        self.node_reduce_fns[name] = fn

    def add_overused_fn(self, name: str, fn: ValidateFn) -> None:
        self.overused_fns[name] = fn

    def add_job_valid_fn(self, name: str, fn: ValidateExFn) -> None:
        self.job_valid_fns[name] = fn

    def add_job_enqueueable_fn(self, name: str, fn: ValidateFn) -> None:
        self.job_enqueueable_fns[name] = fn

    def add_event_handler(self, eh: EventHandler) -> None:
        self.event_handlers.append(eh)

    # ---- tiered dispatch ----

    def _evictable(self, fns: Dict[str, EvictableFn], flag: str, evictor, evictees):
        """Per-tier intersection of victim candidates (session_plugins.go:106-188)."""
        victims: Optional[List[TaskInfo]] = None
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not getattr(plugin, flag):
                    continue
                fn = fns.get(plugin.name)
                if fn is None:
                    continue
                candidates = fn(evictor, evictees)
                if victims is None:
                    victims = list(candidates or [])
                else:
                    cand_uids = {c.uid for c in (candidates or [])}
                    victims = [v for v in victims if v.uid in cand_uids]
            if victims is not None:
                return victims
        return victims or []

    def reclaimable(self, reclaimer: TaskInfo, reclaimees: List[TaskInfo]) -> List[TaskInfo]:
        return self._evictable(
            self.reclaimable_fns, "enabled_reclaimable", reclaimer, reclaimees
        )

    def preemptable(self, preemptor: TaskInfo, preemptees: List[TaskInfo]) -> List[TaskInfo]:
        return self._evictable(
            self.preemptable_fns, "enabled_preemptable", preemptor, preemptees
        )

    def overused(self, queue: QueueInfo) -> bool:
        """Any plugin veto marks the queue overused (session_plugins.go:191-206).
        Note: the reference does not gate this on an enabled flag."""
        for tier in self.tiers:
            for plugin in tier.plugins:
                fn = self.overused_fns.get(plugin.name)
                if fn is not None and fn(queue):
                    return True
        return False

    def job_ready(self, obj: object) -> bool:
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not plugin.enabled_job_ready:
                    continue
                fn = self.job_ready_fns.get(plugin.name)
                if fn is not None and not fn(obj):
                    return False
        return True

    def job_pipelined(self, obj: object) -> bool:
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not plugin.enabled_job_pipelined:
                    continue
                fn = self.job_pipelined_fns.get(plugin.name)
                if fn is not None and not fn(obj):
                    return False
        return True

    def job_valid(self, obj: object) -> Optional[ValidateResult]:
        """First failing validation wins (session_plugins.go:249-266);
        not gated on an enabled flag, like the reference."""
        for tier in self.tiers:
            for plugin in tier.plugins:
                fn = self.job_valid_fns.get(plugin.name)
                if fn is None:
                    continue
                vr = fn(obj)
                if vr is not None and not vr.pass_:
                    return vr
        return None

    def job_enqueueable(self, obj: object) -> bool:
        for tier in self.tiers:
            for plugin in tier.plugins:
                fn = self.job_enqueueable_fns.get(plugin.name)
                if fn is not None and not fn(obj):
                    return False
        return True

    # ---- comparator dispatch ----

    def _ordered(self, fns: Dict[str, CompareFn], flag: str, l, r) -> int:
        # The tier walk is invariant after session open; flatten it once
        # per flag (each flag maps 1:1 to a registry) — comparators run
        # on every heap operation.  add_*_order_fn invalidates the cache,
        # so late registrations (nothing does this today) stay correct.
        chain = self._ordered_chains.get(flag)
        if chain is None:
            chain = [
                fns[plugin.name]
                for tier in self.tiers
                for plugin in tier.plugins
                if getattr(plugin, flag) and plugin.name in fns
            ]
            self._ordered_chains[flag] = chain
        for fn in chain:
            j = fn(l, r)
            if j != 0:
                return j
        return 0

    def job_order_fn(self, l: JobInfo, r: JobInfo) -> bool:
        j = self._ordered(self.job_order_fns, "enabled_job_order", l, r)
        if j != 0:
            return j < 0
        if l.creation_timestamp == r.creation_timestamp:
            return l.uid < r.uid
        return l.creation_timestamp < r.creation_timestamp

    def namespace_order_fn(self, l: str, r: str) -> bool:
        j = self._ordered(self.namespace_order_fns, "enabled_namespace_order", l, r)
        if j != 0:
            return j < 0
        return l < r

    def queue_order_fn(self, l: QueueInfo, r: QueueInfo) -> bool:
        j = self._ordered(self.queue_order_fns, "enabled_queue_order", l, r)
        if j != 0:
            return j < 0
        if l.creation_timestamp == r.creation_timestamp:
            return l.uid < r.uid
        return l.creation_timestamp < r.creation_timestamp

    def task_compare_fns(self, l: TaskInfo, r: TaskInfo) -> int:
        return self._ordered(self.task_order_fns, "enabled_task_order", l, r)

    def task_order_fn(self, l: TaskInfo, r: TaskInfo) -> bool:
        j = self.task_compare_fns(l, r)
        if j != 0:
            return j < 0
        if l.creation_timestamp == r.creation_timestamp:
            return l.uid < r.uid
        return l.creation_timestamp < r.creation_timestamp

    # ---- predicate / scoring dispatch ----

    def predicate_fn(self, task: TaskInfo, node: NodeInfo) -> None:
        """Raises FitError on first veto (session_plugins.go:403-420)."""
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not plugin.enabled_predicate:
                    continue
                fn = self.predicate_fns.get(plugin.name)
                if fn is not None:
                    fn(task, node)

    def node_order_fn(self, task: TaskInfo, node: NodeInfo) -> float:
        score = 0.0
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not plugin.enabled_node_order:
                    continue
                fn = self.node_order_fns.get(plugin.name)
                if fn is not None:
                    score += fn(task, node)
        return score

    def batch_node_order_fn(
        self, task: TaskInfo, nodes: List[NodeInfo]
    ) -> Dict[str, float]:
        scores: Dict[str, float] = {}
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not plugin.enabled_node_order:
                    continue
                fn = self.batch_node_order_fns.get(plugin.name)
                if fn is None:
                    continue
                for node_name, s in fn(task, nodes).items():
                    scores[node_name] = scores.get(node_name, 0.0) + s
        return scores

    def node_order_map_fn(
        self, task: TaskInfo, node: NodeInfo
    ) -> Tuple[Dict[str, float], float]:
        """(per-plugin map scores, additive order score) — session_plugins.go:474-500."""
        node_score_map: Dict[str, float] = {}
        priority_score = 0.0
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not plugin.enabled_node_order:
                    continue
                fn = self.node_order_fns.get(plugin.name)
                if fn is not None:
                    priority_score += fn(task, node)
                mfn = self.node_map_fns.get(plugin.name)
                if mfn is not None:
                    node_score_map[plugin.name] = mfn(task, node)
        return node_score_map, priority_score

    def node_order_reduce_fn(
        self, task: TaskInfo, plugin_node_scores: Dict[str, List[Tuple[str, int]]]
    ) -> Dict[str, float]:
        """Sum reduced per-plugin host scores (session_plugins.go:503-524)."""
        node_scores: Dict[str, float] = {}
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not plugin.enabled_node_order:
                    continue
                fn = self.node_reduce_fns.get(plugin.name)
                if fn is None:
                    continue
                fn(task, plugin_node_scores)
                for host, score in plugin_node_scores.get(plugin.name, []):
                    node_scores[host] = node_scores.get(host, 0.0) + float(score)
        return node_scores

    # ---- mutating operations (session.go:205-329) ----

    def statement(self) -> "Statement":
        from volcano_tpu_torch.framework.statement import Statement

        return Statement(self)

    def _fire_allocate(self, task: TaskInfo) -> None:
        for eh in self.event_handlers:
            if eh.allocate_func is not None:
                eh.allocate_func(Event(task))

    def _fire_deallocate(self, task: TaskInfo) -> None:
        for eh in self.event_handlers:
            if eh.deallocate_func is not None:
                eh.deallocate_func(Event(task))

    def pipeline(self, task: TaskInfo, hostname: str) -> None:
        """session.go:205-245."""
        job = self.jobs.get(task.job)
        if job is None:
            raise KeyError(f"failed to find job {task.job} when pipelining")
        self.touched_jobs.add(task.job)
        self.touched_nodes.add(hostname)
        self.node_state_epoch += 1
        job.update_task_status(task, TaskStatus.Pipelined)
        task.node_name = hostname
        node = self.nodes.get(hostname)
        if node is None:
            raise KeyError(f"failed to find node {hostname}")
        node.add_task(task)
        if self._trace.enabled:
            self._trace.decision("pipeline", task.uid, hostname)
        self._fire_allocate(task)

    def allocate(self, task: TaskInfo, hostname: str) -> None:
        """session.go:247-303 — status updates in session; binds the whole
        job's Allocated set once the job turns ready."""
        import time as _time

        _t0 = _time.perf_counter()
        self.cache.allocate_volumes(task, hostname)
        job = self.jobs.get(task.job)
        if job is None:
            raise KeyError(f"failed to find job {task.job} when allocating")
        self.touched_jobs.add(task.job)
        self.touched_nodes.add(hostname)
        self.node_state_epoch += 1
        job.update_task_status(task, TaskStatus.Allocated)
        task.node_name = hostname
        node = self.nodes.get(hostname)
        if node is None:
            raise KeyError(f"failed to find node {hostname}")
        node.add_task(task)
        if self._trace.enabled:
            # session-level placement; the cache bind (if the job turns
            # ready) is journaled as "bind" by dispatch below
            self._trace.decision("allocate", task.uid, hostname)
        self._fire_allocate(task)
        # metrics.go UpdateTaskScheduleDuration: per-task allocation cost
        from volcano_tpu_torch import metrics as _metrics

        _metrics.update_task_schedule_duration(_time.perf_counter() - _t0)

        if self.job_ready(job):
            for t in list(job.task_status_index.get(TaskStatus.Allocated, {}).values()):
                self.dispatch(t)

    def dispatch(self, task: TaskInfo) -> None:
        """session.go:305-329 — bind through the cache.  A volume-bind
        failure unwinds the allocation and resyncs from API truth (same
        discipline as Statement._commit_allocate) so session state never
        holds a half-dispatched task."""
        try:
            self.cache.bind_volumes(task)
        except Exception as e:  # noqa: BLE001
            log.error(
                "bind volumes of %s/%s failed: %s", task.namespace, task.name, e
            )
            job = self.jobs.get(task.job)
            if job is not None:
                job.update_task_status(task, TaskStatus.Pending)
            node = self.nodes.get(task.node_name)
            if node is not None:
                node.remove_task(task)
            self._fire_deallocate(task)
            self.cache.resync_task(task)
            return
        self.cache.bind(task, task.node_name)
        self.touched_jobs.add(task.job)
        self.touched_nodes.add(task.node_name)
        self.node_state_epoch += 1
        if self._trace.enabled:
            # one "bind" decision per actual cache.bind, same as the
            # Statement commit and fast-apply paths
            self._trace.decision("bind", task.uid, task.node_name)
        job = self.jobs.get(task.job)
        if job is None:
            raise KeyError(f"failed to find job {task.job} when dispatching")
        job.update_task_status(task, TaskStatus.Binding)

    def evict(self, reclaimee: TaskInfo, reason: str) -> None:
        """session.go Evict — immediate cache eviction + Releasing status."""
        self.cache.evict(reclaimee, reason)
        self.touched_jobs.add(reclaimee.job)
        self.touched_nodes.add(reclaimee.node_name)
        self.node_state_epoch += 1
        if self._trace.enabled:
            self._trace.decision(
                "evict", reclaimee.uid, reclaimee.node_name, reason
            )
        job = self.jobs.get(reclaimee.job)
        if job is None:
            raise KeyError(f"failed to find job {reclaimee.job} when evicting")
        job.update_task_status(reclaimee, TaskStatus.Releasing)
        node = self.nodes.get(reclaimee.node_name)
        if node is not None:
            node.update_task(reclaimee)
        self._fire_deallocate(reclaimee)

    # ---- status writeback helpers ----

    def update_job_condition(self, job: JobInfo, cond: scheduling.PodGroupCondition) -> None:
        """Append or refresh the job's PodGroup condition (session.go UpdateJobCondition)."""
        if job.pod_group is None:
            return
        for i, c in enumerate(job.pod_group.status.conditions):
            if c.type == cond.type:
                job.pod_group.status.conditions[i] = cond
                return
        job.pod_group.status.conditions.append(cond)

    def job_status(self, job: JobInfo) -> scheduling.PodGroupStatus:
        """Derive the PodGroup phase from session outcome (session.go:157-195)."""
        status = job.pod_group.status
        unschedulable = any(
            c.type == scheduling.POD_GROUP_UNSCHEDULABLE_TYPE
            and c.status == "True"
            and c.transition_id == self.uid
            for c in status.conditions
        )
        from volcano_tpu_torch.api.types import allocated_status as _alloc

        if job.task_status_index.get(TaskStatus.Running) and unschedulable:
            status.phase = scheduling.POD_GROUP_UNKNOWN
        else:
            allocated = sum(
                len(tasks)
                for st, tasks in job.task_status_index.items()
                if _alloc(st) or st == TaskStatus.Succeeded
            )
            if allocated >= job.pod_group.spec.min_member:
                status.phase = scheduling.POD_GROUP_RUNNING
            elif job.pod_group.status.phase != scheduling.POD_GROUP_INQUEUE:
                status.phase = scheduling.POD_GROUP_PENDING

        status.running = len(job.task_status_index.get(TaskStatus.Running, {}))
        status.failed = len(job.task_status_index.get(TaskStatus.Failed, {}))
        status.succeeded = len(job.task_status_index.get(TaskStatus.Succeeded, {}))
        return status

    def __repr__(self) -> str:
        return f"Session {self.uid}: jobs {len(self.jobs)}, nodes {len(self.nodes)}"
