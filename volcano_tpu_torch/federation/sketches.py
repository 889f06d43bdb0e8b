"""Per-shard free-capacity sketches — the ONLY foreign state.

A copy of ``volcano_tpu/federation/sketches.py``.

Earlier federation builds kept a cluster-wide node mirror inside every
member's ``ShardInformerFilter`` (one record per node + one (node,
resreq) pair per bound pod, maintained from the unfiltered watch feed)
so spillover and the gang broker could pick foreign candidates locally.
That mirror was the last O(cluster) structure per member.  It is gone:
the filter's ledger now covers only the OWNED slice, and the capacity
view of every foreign slice is the *sketch* its holder piggybacks on
the lease-map heartbeat (``ShardInformerFilter.capacity_sketch`` →
``ShardLeaseManager`` stats blob) — aggregate free capacity plus a
top-K list of its freest nodes, each entry carrying just enough truth
(labels, taints, unschedulable) to run the same selector/taint
predicates the owned-side candidates go through.

The trade is staleness-for-size, and it is safe because sketches PRUNE
and never decide: a candidate solicited from a sketch is re-verified
against per-node store truth (:meth:`SketchSolicitor.verify_node`)
right before the CAS/txn that would bind onto it, and the bind itself
is conditional at the store (``cas_bind`` / ``txn_commit``
preconditions).  A stale sketch can only cost a wasted solicitation —
counted in ``volcano_sketch_solicitations_total{result}`` and the
shard-map stats blob (``vtctl shards`` renders both freshness and the
verified/stale split) — never an overcommit.  The old mirror had the
same staleness window in kind (watch lag vs lease-tick lag); what
changed is the memory bill, not the correctness argument.

One difference from the reference, which takes a sketch at its word
until its holder's next heartbeat: ``cas_bind`` checks only the pod's
resourceVersion and ``verify_node`` only that the node exists, so two
cross-shard binds onto one node within that window (a spill burst, a
gang and then a spill) overcommit it.  Here a member keeps its own binds
onto foreign nodes (:meth:`SketchSolicitor.note_claim`) and debits them
from the node's sketch entry until the holder publishes a sketch whose
``rv`` (the highest pod resourceVersion its ledger has taken in) covers
them.  A sketch without ``rv`` (a holder that publishes none) is taken
at its word, as the reference takes every sketch.  And a sketch's node
counts only while the sketch's member holds the node's shard: a member
may publish its last sketch for a moment after it released a slice
(``FederatedScheduler._stats``).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from volcano_tpu_torch.api.resource import Resource
from volcano_tpu_torch.apis import core
from volcano_tpu_torch.client.apiserver import ApiError
from volcano_tpu_torch.federation.leases import read_shard_map
from volcano_tpu_torch.federation.sharding import shard_of_node, ShardState
from volcano_tpu_torch import metrics
from volcano_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

#: sentinel for "the shard map has not been read yet this pass" (None
#: is a meaningful value — "no map / read failed, no foreign state")
UNREAD = object()


def node_from_sketch(entry: dict) -> core.Node:
    """Reconstruct the minimal ``core.Node`` the per-claim predicates
    (``ShardInformerFilter._task_fits``) consult from a sketch topNodes
    entry: name + labels feed the selector/matchFields helpers, taints
    and unschedulable feed the taint gate.  Status stays empty — the
    free view travels separately as a Resource."""
    return core.Node(
        metadata=core.ObjectMeta(
            name=entry.get("name", ""),
            namespace="",
            labels=dict(entry.get("labels") or {}),
        ),
        spec=core.NodeSpec(
            taints=[
                core.Taint(
                    key=t.get("key", ""),
                    value=t.get("value", ""),
                    effect=t.get("effect", "NoSchedule"),
                )
                for t in entry.get("taints") or []
            ],
            unschedulable=bool(entry.get("unschedulable")),
        ),
    )


def entry_from_sketch(entry: dict) -> Optional[list]:
    """One sketch topNodes record → the ``[free_cpu, name, node, free,
    slots]`` capacity-entry shape ``plan_gang_assembly`` consumes, so
    foreign candidates flow through the very same placement loop as
    owned ones."""
    name = entry.get("name", "")
    if not name or entry.get("unschedulable"):
        return None
    slots = int(entry.get("slots", 0))
    if slots <= 0:
        return None
    free = Resource(
        milli_cpu=float(entry.get("freeCpuMilli", 0)),
        memory=float(entry.get("freeMemory", 0)),
    )
    return [free.get("cpu"), name, node_from_sketch(entry), free, slots]


class SketchSolicitor:
    """Foreign-candidate solicitation from the lease map's per-shard
    sketches, plus the bind-time node-truth verification both
    cross-shard bind paths (spillover + gang broker) run candidates
    through.  One instance per federation member; the verified/stale
    counters it keeps feed the stats blob ``vtctl shards`` renders."""

    def __init__(self, api, state: ShardState):
        self.api = api
        self.state = state
        self._ctr_lock = threading.Lock()
        #: result → count (verified / stale), mirrored into the
        #: shard-map stats blob
        self._counters: Dict[str, int] = {}  # guarded-by: self._ctr_lock
        self._claims_lock = threading.Lock()
        #: node → [(resourceVersion, requests)] of this member's binds
        #: onto that foreign node that no sketch of its holder covers yet
        self._claims: Dict[str, List[tuple]] = {}  # guarded-by: self._claims_lock

    def counters(self) -> Dict[str, int]:
        with self._ctr_lock:
            return dict(self._counters)

    def _count(self, result: str) -> None:
        metrics.register_sketch_solicitation(result)
        with self._ctr_lock:
            self._counters[result] = self._counters.get(result, 0) + 1

    # ---- solicitation ----

    def read_map(self) -> Optional[dict]:
        """One shard-map read per post-cycle pass (the map only changes
        on lease ticks; per-candidate truth is re-verified anyway).
        None means no foreign state this pass — home-only behavior, the
        honest degraded mode when the map is unreadable."""
        try:
            return read_shard_map(self.api)
        except ApiError as e:
            log.debug("shard-map read for solicitation failed: %s", e)
            return None

    def note_claim(self, pod: core.Pod) -> None:
        """Keep this member's bind of ``pod`` onto a foreign node: it is
        debited from the node's sketch entry until the holder's sketch
        covers its resourceVersion."""
        from volcano_tpu_torch.api.job_info import pod_request_resource

        with self._claims_lock:
            self._claims.setdefault(pod.spec.node_name, []).append(
                (pod.metadata.resource_version or 0, pod_request_resource(pod))
            )

    def _uncovered_claims(self, shards: dict, stats: dict) -> Dict[str, list]:
        """The kept claims no sketch on the map covers yet, the covered
        ones dropped: a claim is covered once the sketch of its node's
        holder carries an ``rv`` at or above it; a holder's sketch
        without ``rv`` covers every claim on its nodes."""
        with self._claims_lock:
            for node in list(self._claims):
                shard = shard_of_node(node, self.state.n_shards)
                holder = (shards.get(str(shard)) or {}).get("holder") or ""
                sketch = (stats.get(holder) or {}).get("sketch") or {}
                rv = sketch.get("rv")
                kept = [] if rv is None else [
                    c for c in self._claims[node] if c[0] > rv
                ]
                if kept:
                    self._claims[node] = kept
                else:
                    del self._claims[node]
            return {node: list(c) for node, c in self._claims.items()}

    def foreign_entries(
        self, rec: Optional[dict],
        shard_ok: Optional[Callable[[int], bool]] = None,
    ) -> List[list]:
        """Capacity entries for every foreign topNodes record on the
        map, optionally gated by ``shard_ok`` (the broker derives it
        from ``solicitable_shards`` so obviously-full shards are pruned
        at aggregate level before their nodes are even materialized),
        this member's uncovered claims debited."""
        out: List[list] = []
        shards = (rec or {}).get("shards", {})
        stats = (rec or {}).get("stats", {})
        claims = self._uncovered_claims(shards, stats)
        seen: set = set()
        for shard_key, lease in shards.items():
            holder = (lease or {}).get("holder") or ""
            if not holder or holder in seen:
                continue
            seen.add(holder)
            sketch = (stats.get(holder) or {}).get("sketch") or {}
            for nentry in sketch.get("topNodes") or []:
                name = nentry.get("name", "")
                if not name or self.state.owns_node(name):
                    continue
                shard = shard_of_node(name, self.state.n_shards)
                if (shards.get(str(shard)) or {}).get("holder") != holder:
                    continue  # a slice its holder no longer holds
                if shard_ok is not None and not shard_ok(shard):
                    continue
                entry = entry_from_sketch(nentry)
                if entry is None:
                    continue
                for _rv, req in claims.get(name, ()):
                    entry[3].sub_unchecked(req)
                    entry[4] -= 1
                entry[0] = entry[3].get("cpu")
                if entry[4] > 0:
                    out.append(entry)
        return out

    def spill_candidates(self, task, rec: Optional[dict],
                         limit: int = 8) -> List[str]:
        """Foreign nodes that could host ``task`` by the sketches' view:
        resource fit against the advertised free capacity, selector +
        taints against the reconstructed node.  Most-free-CPU first
        (the deterministic spread that avoids dogpiling one node),
        capped at ``limit`` — same contract the old cluster-mirror
        candidates had, sourced from O(shards·K) sketch entries."""
        from volcano_tpu_torch.federation.filter import ShardInformerFilter

        out = []
        for free_cpu, name, node, free, _slots in self.foreign_entries(rec):
            if ShardInformerFilter._task_fits(task, node, free):
                out.append((free_cpu, name))
        out.sort(key=lambda t: (-t[0], t[1]))
        return [name for _free, name in out[:limit]]

    # ---- bind-time truth ----

    def verify_node(self, name: str) -> bool:
        """Per-node store truth right before a CAS/txn would bind onto a
        sketch-solicited node: the node must still exist and be
        schedulable.  A False here is the sketch's staleness window
        showing — a pruning event the caller skips past, never a
        correctness event (the conditional bind would also have caught
        a vanished pod, just less cheaply)."""
        try:
            node = self.api.get("Node", "", name)
        except ApiError as e:
            log.debug("sketch verify read of node %s failed: %s", name, e)
            self._count("stale")
            return False
        if node is None or node.spec.unschedulable:
            self._count("stale")
            return False
        self._count("verified")
        return True
