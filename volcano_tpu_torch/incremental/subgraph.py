"""Restricted-subgraph session construction + shadow cross-check.

A copy of ``volcano_tpu/incremental/subgraph.py``, with the port's
device action ``gpu-allocate`` in place of ``jax-allocate`` among the
restrictable actions.  The shadow session packs cold: its snapshot has
no pack epoch and its cache's ``pack_cache`` is None, so the warm
packer's registry and the device stager of the live cache never see the
throwaway world.

A restricted micro-cycle opens its session over only the jobs with
schedulable work (the ledger's schedulable set) plus the ledger's share
seed — O(pending) clones and plugin state instead of O(resident).  The
equivalence argument (why a restricted session binds exactly what a
full session would, for the restrictable action set):

* every job a full ``enqueue``/``allocate``/``gpu-allocate`` pass can
  possibly BIND has a non-empty Pending bucket — which is precisely the
  ledger's schedulable predicate, so no bindable job is excluded;
* excluded jobs influence those actions only through AGGREGATES — the
  per-queue allocated/request totals behind proportion's deserved
  water-filling and DRF's namespace shares — and the seed reproduces
  those totals exactly (integer cpu-milli/bytes in float64: the
  incremental sums equal the swept sums bit-for-bit);
* node state is snapshotted in full either way, so predicates and
  scoring see identical capacity.

Actions outside :data:`RESTRICTABLE_ACTIONS` (preempt, reclaim,
backfill, shuffle — anything that selects VICTIMS among running jobs)
need full-residency visibility; a conf containing them keeps full
sessions regardless of the flag.

Soundness is pinned, not assumed: ``run_shadow_session`` replays the
cycle as a FULL session over private clones of the same snapshot and
any divergence in the resulting bind set fails the cross-check (every
restricted cycle in tests, sampled via ``shadow_every`` in production).
``ShareLedger.plant_divergence`` proves the checker actually catches a
broken ledger.  The shadow session never touches the store: its cache
is a recording stub, its PodGroups/PVCs are isolated copies, and it is
discarded without the close-side writebacks.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from volcano_tpu_torch.api import ClusterInfo
from volcano_tpu_torch.framework.framework import open_session
from volcano_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

#: actions whose outcome depends on excluded jobs only through the
#: seeded share aggregates — the proof obligation carried by the shadow
#: cross-check.  Victim-selecting actions (preempt/reclaim) and
#: best-effort passes over running state (backfill/shuffle) are out.
RESTRICTABLE_ACTIONS = frozenset({"enqueue", "allocate", "gpu-allocate"})


def conf_is_restrictable(action_names) -> bool:
    return bool(action_names) and set(action_names) <= RESTRICTABLE_ACTIONS


class ShadowDivergence(RuntimeError):
    """Raised in strict mode when the restricted session's bind set
    differs from the shadow full session's."""

    def __init__(self, diffs: List[str]):
        super().__init__(
            "restricted session diverged from shadow full session: "
            + "; ".join(diffs)
        )
        self.diffs = diffs


class RecordingCache:
    """Pass-through cache proxy for the REAL restricted session: records
    every bind/evict the session commits (for the divergence compare),
    then delegates to the real cache so effects land normally."""

    def __init__(self, cache):
        self._inner = cache
        self.binds: Dict[str, str] = {}  # task uid → hostname
        self.evicts: Dict[str, str] = {}  # task uid → reason

    def bind(self, task, hostname):
        self.binds[task.uid] = hostname
        return self._inner.bind(task, hostname)

    def bind_batch(self, items):
        items = list(items)
        for task, hostname in items:
            self.binds[task.uid] = hostname
        return self._inner.bind_batch(items)

    def evict(self, task, reason):
        self.evicts[task.uid] = reason
        return self._inner.evict(task, reason)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class _ShadowCache:
    """Cache stand-in for the shadow full session: records placement
    decisions and mirrors the volume-binding OUTCOMES against the
    snapshot's PVC state, with zero store writes and zero real-cache
    mutation.  Everything else delegates read-only to the real cache."""

    # JobUpdater probes these with getattr(..., None); the class
    # attributes shadow the real cache's so the (skipped) close path
    # could never reach a real writeback even if invoked
    update_job_status_async = None
    _commit_plane = None
    #: gpu-allocate only consults the warm packer when the session
    #: carries a pack epoch (shadow sessions never do), but a plain None
    #: here also shadows the real cache's lazy pack_cache property
    pack_cache = None

    def __init__(self, cache, pvcs):
        self._inner = cache
        #: shadow-local PVC overlay (key → clone), seeded from the
        #: snapshot so shadow provisioning decisions match what the
        #: restricted session sees — without client writes
        self._pvcs = pvcs
        self.binds: Dict[str, str] = {}
        self.evicts: Dict[str, str] = {}

    # ---- recorded placement effects ----

    def bind(self, task, hostname):
        self.binds[task.uid] = hostname

    def bind_batch(self, items):
        for task, hostname in items:
            self.binds[task.uid] = hostname

    def evict(self, task, reason):
        self.evicts[task.uid] = reason

    # ---- volume binding, mirrored against the shadow PVC overlay ----

    def allocate_volumes(self, task, hostname) -> None:
        all_bound = True
        for claim in self._inner.task_claim_names(task):
            pvc = self._pvcs.get(f"{task.namespace}/{claim}")
            if pvc is None or pvc.status.get("phase") != "Bound":
                all_bound = False
        task.volume_ready = all_bound

    def bind_volumes(self, task) -> None:
        if task.volume_ready:
            return
        for claim in self._inner.task_claim_names(task):
            key = f"{task.namespace}/{claim}"
            pvc = self._pvcs.get(key)
            if pvc is None:
                raise KeyError(f"persistentvolumeclaim {key} not found")
            if pvc.status.get("phase") == "Bound":
                continue
            if not pvc.spec.get("storageClassName"):
                raise RuntimeError(
                    f"pod has unbound immediate PersistentVolumeClaims: {key}"
                )
            pvc = pvc.clone()
            pvc.metadata.annotations[
                "volume.kubernetes.io/selected-node"
            ] = task.node_name
            pvc.spec["volumeName"] = f"pv-{pvc.metadata.name}"
            pvc.status["phase"] = "Bound"
            self._pvcs[key] = pvc
        task.volume_ready = True

    # ---- writeback surface, inert ----

    def resync_task(self, task) -> None:
        pass

    def update_job_status(self, job) -> None:
        pass

    def record_job_status_event(self, job) -> None:
        pass

    def release_session_clones(self, clone_gen, touched_jobs, touched_nodes):
        pass

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _shadow_snapshot(snap: ClusterInfo) -> ClusterInfo:
    """Private full-world clone of ``snap`` for the shadow session.

    ``JobInfo.clone()`` SHARES the ``pod_group`` reference, and a
    session mutates ``pod_group.status`` in place (``job_status``,
    ``update_job_condition``) — so each shadow job gets an isolated
    PodGroup copy, or the shadow's phase transitions would leak into
    the clones the real session computes on."""
    shadow = ClusterInfo()
    for uid, job in snap.jobs.items():
        j = job.clone()
        if j.pod_group is not None:
            j.pod_group = j.pod_group.clone()
        shadow.jobs[uid] = j
    for name, node in snap.nodes.items():
        shadow.nodes[name] = node.clone()
    for uid, queue in snap.queues.items():
        shadow.queues[uid] = queue.clone()
    # NamespaceInfo snapshots are read-only to sessions; PVC entries are
    # cloned lazily by the shadow cache's bind_volumes overlay
    shadow.namespace_info = dict(snap.namespace_info)
    shadow.pvcs = dict(snap.pvcs)
    shadow.pack_epoch = None  # cold pack: the warm PackCache registry
    # must never see a throwaway world
    shadow.clone_gen = 0
    return shadow


def run_shadow_session(
    cache, snap: ClusterInfo, tiers, configurations, actions
) -> Tuple[Dict[str, str], Dict[str, str]]:
    """Replay the cycle as a FULL session over private clones of
    ``snap`` and return the (binds, evicts) it would have committed.
    Store-inert by construction: the shadow cache records instead of
    writing, and the session is discarded without plugin closes or the
    job updater (shadow outcomes are judged on BINDINGS only)."""
    shadow_snap = _shadow_snapshot(snap)
    shadow_cache = _ShadowCache(cache, shadow_snap.pvcs)
    ssn = open_session(
        shadow_cache, tiers, configurations, snapshot=shadow_snap
    )
    try:
        for action in actions:
            action.execute(ssn)
    finally:
        # discard, never close: close_session would run plugin closes
        # (gang writes conditions), the job updater, and clone release —
        # all writeback paths a shadow must not take
        ssn.jobs = {}
        ssn.nodes = {}
        ssn.plugins = {}
        ssn.event_handlers = []
    return shadow_cache.binds, shadow_cache.evicts


def compare_outcomes(
    restricted_binds: Dict[str, str],
    restricted_evicts: Dict[str, str],
    shadow_binds: Dict[str, str],
    shadow_evicts: Dict[str, str],
) -> Optional[List[str]]:
    """ANY divergence fails — a list of human-readable diffs, or None
    when the outcome sets are identical."""
    diffs: List[str] = []
    for uid in sorted(set(restricted_binds) | set(shadow_binds)):
        r = restricted_binds.get(uid)
        s = shadow_binds.get(uid)
        if r != s:
            diffs.append(
                f"bind {uid}: restricted={r or 'UNBOUND'} "
                f"shadow={s or 'UNBOUND'}"
            )
    for uid in sorted(set(restricted_evicts) | set(shadow_evicts)):
        if (uid in restricted_evicts) != (uid in shadow_evicts):
            where = "restricted" if uid in restricted_evicts else "shadow"
            diffs.append(f"evict {uid}: only in {where}")
    return diffs or None
