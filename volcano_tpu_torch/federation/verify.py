"""Multi-shard policy-equivalence checker.

A copy of ``volcano_tpu/federation/verify.py``.

``--shards 1`` is held to bit-identity with the non-federated scheduler
(``trace.replay.verify`` + binding-map equality — the tests pin it).
Multi-shard runs cannot be bit-identical to any single process (N
independent session streams interleave at the store), so they are held
to **policy equivalence** instead, judged entirely from API truth:

* every pod is bound at most once (an audit history, when the harness
  provides one, proves "at most once *ever*"; the store itself proves
  "at most one node *now*");
* every bind satisfies the core predicates against the bound node —
  capacity (summed active requests ≤ allocatable, pod count ≤ the pods
  quantity), schedulability, node selector, taints/tolerations;
* gang semantics hold **across shards**: no PodGroup with
  ``minMember > 1`` is left partially placed (some tasks bound while
  others wait) below its minimum — judged from the cluster-wide pod
  set, so a gang the broker assembled across N shards is held to
  exactly the same invariant as a home-only gang, and each violation
  names the shards the partial placement spans.  The report counts
  ``cross_shard_gangs`` (gangs whose bound members span ≥ 2 shards),
  which is how the chaos drills prove an assembly happened at all.

Reads only the API surface, so the same checker runs over the
in-process store and a ``--bus`` backend: the federation chaos tests'
and ``chip_smoke.phase_federation``'s exit gate.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from volcano_tpu_torch.api.resource import Resource
from volcano_tpu_torch.apis import scheduling


def _pod_requests(pod) -> Resource:
    # the shared summation (api/job_info) — the checker must judge
    # capacity by exactly the accounting the schedulers themselves use
    from volcano_tpu_torch.api.job_info import pod_request_resource

    return pod_request_resource(pod)


def verify_federation(
    api,
    n_shards: int,
    bind_history: Optional[Dict[str, List[str]]] = None,
) -> dict:
    """Run the policy-equivalence checks; returns a report dict with
    ``ok`` plus the violation list (empty when equivalent)."""
    from volcano_tpu_torch.plugins import util as putil

    violations: List[str] = []
    nodes = {n.metadata.name: n for n in api.list("Node")}
    pods = api.list("Pod")

    # ---- at-most-once ----
    if bind_history is not None:
        for key, hosts in bind_history.items():
            if len(hosts) > 1:
                violations.append(
                    f"pod {key} was bound more than once: {hosts}"
                )

    # ---- per-bind predicates + per-node capacity ----
    used: Dict[str, Resource] = {}
    counts: Dict[str, int] = {}
    for pod in pods:
        node_name = pod.spec.node_name
        if not node_name:
            continue
        node = nodes.get(node_name)
        if node is None:
            violations.append(
                f"pod {pod.metadata.namespace}/{pod.metadata.name} bound "
                f"to nonexistent node {node_name}"
            )
            continue
        if node.spec.unschedulable:
            violations.append(
                f"pod {pod.metadata.namespace}/{pod.metadata.name} bound "
                f"to unschedulable node {node_name}"
            )
        if not putil.pod_matches_node_selector(pod, node):
            violations.append(
                f"pod {pod.metadata.namespace}/{pod.metadata.name} on "
                f"{node_name} violates its node selector/affinity"
            )
        if not putil.pod_tolerates_node_taints(pod, node):
            violations.append(
                f"pod {pod.metadata.namespace}/{pod.metadata.name} on "
                f"{node_name} does not tolerate the node's taints"
            )
        if pod.status.phase in ("Succeeded", "Failed"):
            continue
        used.setdefault(node_name, Resource()).add(_pod_requests(pod))
        counts[node_name] = counts.get(node_name, 0) + 1
    for name, u in used.items():
        alloc = Resource.from_resource_list(nodes[name].status.allocatable)
        if not u.less_equal(alloc):
            violations.append(
                f"node {name} overcommitted: used {u} > allocatable {alloc}"
            )
        if counts.get(name, 0) > alloc.max_task_num:
            violations.append(
                f"node {name} holds {counts[name]} pods > capacity "
                f"{alloc.max_task_num}"
            )

    # ---- gang minMember, proven ACROSS shards ----
    # Judged from the cluster-wide pod set (API truth), so the
    # invariant covers every placement path at once: the home gang
    # loop, surplus spillover, AND the cross-shard broker's txn_commit
    # assemblies — a transaction that could land part of a gang would
    # fail here no matter which shards the parts landed on.
    from volcano_tpu_torch.federation.sharding import shard_of_node

    by_group: Dict[str, List] = {}
    for pod in pods:
        group = (pod.metadata.annotations or {}).get(
            scheduling.GROUP_NAME_ANNOTATION_KEY
        )
        if group:
            by_group.setdefault(
                f"{pod.metadata.namespace}/{group}", []
            ).append(pod)
    cross_shard_gangs = 0
    for pg in api.list("PodGroup"):
        mm = pg.spec.min_member or 0
        if mm <= 1:
            continue
        members = by_group.get(pg.key(), [])
        placed = [p for p in members if p.spec.node_name]
        bound = len(placed)
        spanned = sorted({
            shard_of_node(p.spec.node_name, n_shards) for p in placed
        })
        if len(spanned) > 1:
            cross_shard_gangs += 1
        pending = sum(
            1 for p in members
            if not p.spec.node_name and p.status.phase == "Pending"
        )
        # partial gang: some members placed, others still waiting, and
        # the placed count is below the minimum — the exact state gang
        # scheduling exists to forbid.  (A group mid-churn whose bound
        # members already completed and were deleted has no pending
        # members and is not judged.)
        if bound and pending and bound < mm:
            violations.append(
                f"podgroup {pg.key()} partially placed: {bound} bound "
                f"< minMember {mm} with {pending} still pending "
                f"(bound members span shards {spanned})"
            )

    return {
        "ok": not violations,
        "violations": violations,
        "checked": {
            "pods": len(pods),
            "bound": sum(1 for p in pods if p.spec.node_name),
            "nodes": len(nodes),
            "pod_groups": len(by_group),
            "cross_shard_gangs": cross_shard_gangs,
            "n_shards": n_shards,
        },
    }
