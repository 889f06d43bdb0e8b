"""Shared predicate/score helpers: label selectors, affinity terms, taints.

A copy of ``volcano_tpu/plugins/util.py``.

Reference: pkg/scheduler/plugins/util/util.go (listers) and the used subset
of the vendored k8s predicate algorithms
(vendor/k8s.io/kubernetes/pkg/scheduler/algorithm/predicates) re-expressed
natively — these are the exact semantics the device kernels encode as
bitmask lanes (volcano_tpu_torch.ops.predicates).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

from volcano_tpu_torch.api import NodeInfo, TaskInfo
from volcano_tpu_torch.apis import core

DEFAULT_TOPOLOGY_KEY = "kubernetes.io/hostname"


# ---- label selector (k8s metav1.LabelSelector semantics) ----

def match_expressions(labels: Dict[str, str], exprs: Iterable[dict]) -> bool:
    for e in exprs or []:
        key = e.get("key", "")
        op = e.get("operator", "In")
        values = e.get("values", []) or []
        have = key in labels
        val = labels.get(key)
        if op == "In":
            if not have or val not in values:
                return False
        elif op == "NotIn":
            if have and val in values:
                return False
        elif op == "Exists":
            if not have:
                return False
        elif op == "DoesNotExist":
            if have:
                return False
        elif op == "Gt":
            if not have or not values or not _int_cmp(val, values[0], greater=True):
                return False
        elif op == "Lt":
            if not have or not values or not _int_cmp(val, values[0], greater=False):
                return False
        else:
            return False
    return True


def _int_cmp(val: Optional[str], bound: str, greater: bool) -> bool:
    try:
        v, b = int(str(val)), int(str(bound))
    except (TypeError, ValueError):
        return False
    return v > b if greater else v < b


def match_label_selector(labels: Dict[str, str], selector: Optional[dict]) -> bool:
    """k8s LabelSelectorAsSelector semantics: empty selector matches all."""
    if not selector:
        return True
    for k, v in (selector.get("matchLabels") or {}).items():
        if labels.get(k) != v:
            return False
    return match_expressions(labels, selector.get("matchExpressions"))


# ---- node selector / node affinity ----

def pod_matches_node_selector(pod: core.Pod, node: core.Node) -> bool:
    """vendored predicates.PodMatchNodeSelector: nodeSelector AND required
    node affinity must both hold."""
    for k, v in (pod.spec.node_selector or {}).items():
        if node.metadata.labels.get(k) != v:
            return False

    node_affinity = (pod.spec.affinity or {}).get("nodeAffinity") or {}
    required = node_affinity.get("requiredDuringSchedulingIgnoredDuringExecution")
    if required:
        terms = required.get("nodeSelectorTerms") or []
        # OR over terms, AND within a term.
        if terms and not any(
            match_expressions(node.metadata.labels, t.get("matchExpressions"))
            and _match_fields(node, t.get("matchFields"))
            for t in terms
        ):
            return False
    return True


def _match_fields(node: core.Node, field_exprs: Optional[List[dict]]) -> bool:
    """Only metadata.name is a valid field selector in k8s."""
    for e in field_exprs or []:
        if e.get("key") == "metadata.name":
            values = e.get("values", []) or []
            op = e.get("operator", "In")
            if op == "In" and node.metadata.name not in values:
                return False
            if op == "NotIn" and node.metadata.name in values:
                return False
    return True


def node_affinity_score(pod: core.Pod, node: core.Node) -> int:
    """vendored priorities.CalculateNodeAffinityPriorityMap: sum of weights
    of matching preferred terms (normalized to 0-10 by the caller when the
    max is known; the reference applies no per-node normalization in
    nodeorder, so raw weight sum capped at MaxPriority semantics are applied
    at reduce time — here we return the raw sum like the map phase does)."""
    node_affinity = (pod.spec.affinity or {}).get("nodeAffinity") or {}
    preferred = (
        node_affinity.get("preferredDuringSchedulingIgnoredDuringExecution") or []
    )
    count = 0
    for p in preferred:
        weight = int(p.get("weight", 0))
        term = p.get("preference") or {}
        if weight == 0:
            continue
        if match_expressions(node.metadata.labels, term.get("matchExpressions")):
            count += weight
    return count


# ---- taints / tolerations ----

def toleration_tolerates_taint(tol: core.Toleration, taint: core.Taint) -> bool:
    if tol.effect and tol.effect != taint.effect:
        return False
    if tol.key and tol.key != taint.key:
        return False
    # empty key with Exists matches all taints
    if tol.operator == "Exists":
        return True
    return tol.value == taint.value


def pod_tolerates_node_taints(pod: core.Pod, node: core.Node) -> bool:
    """vendored predicates.PodToleratesNodeTaints — only NoSchedule/NoExecute
    taints are scheduling-relevant."""
    for taint in node.spec.taints or []:
        if taint.effect not in ("NoSchedule", "NoExecute"):
            continue
        if not any(
            toleration_tolerates_taint(t, taint) for t in pod.spec.tolerations or []
        ):
            return False
    return True


# ---- host ports ----

def pod_host_ports(pod: core.Pod) -> List[tuple]:
    out = []
    for c in pod.spec.containers:
        for p in c.ports or []:
            if p.host_port:
                out.append((p.protocol or "TCP", p.host_port))
    return out


def fits_host_ports(pod: core.Pod, existing_pods: Iterable[core.Pod]) -> bool:
    wanted = set(pod_host_ports(pod))
    if not wanted:
        return True
    used = set()
    for ep in existing_pods:
        used.update(pod_host_ports(ep))
    return not (wanted & used)


# ---- pod (anti-)affinity ----

def _affinity_terms(pod: core.Pod, kind: str) -> List[dict]:
    aff = (pod.spec.affinity or {}).get(kind) or {}
    return aff.get("requiredDuringSchedulingIgnoredDuringExecution") or []


def _preferred_terms(pod: core.Pod, kind: str) -> List[dict]:
    aff = (pod.spec.affinity or {}).get(kind) or {}
    return aff.get("preferredDuringSchedulingIgnoredDuringExecution") or []


def _term_matches_pod(term: dict, pod: core.Pod, candidate: core.Pod) -> bool:
    """Does `candidate` (an existing pod) match the term from `pod`'s view?
    Namespace semantics: empty namespaces list = the affinity pod's own
    namespace."""
    namespaces = term.get("namespaces") or [pod.metadata.namespace]
    if candidate.metadata.namespace not in namespaces:
        return False
    return match_label_selector(
        candidate.metadata.labels, term.get("labelSelector")
    )


def _same_topology(
    node_a: Optional[core.Node], node_b: Optional[core.Node], topology_key: str
) -> bool:
    if node_a is None or node_b is None:
        return False
    key = topology_key or DEFAULT_TOPOLOGY_KEY
    va = node_a.metadata.labels.get(key)
    vb = node_b.metadata.labels.get(key)
    return va is not None and va == vb


class PodLister:
    """Session-wide pod view for relational predicates.

    Reference: plugins/util/util.go PodLister — presents session tasks as
    pods with up-to-date NodeName as allocations mutate mid-session.
    """

    def __init__(self, session):
        self.session = session
        # task uid -> (pod, node_name); node objects resolved via session.
        self._task_nodes: Dict[str, str] = {}
        # Assigned tasks whose pod declares required anti-affinity —
        # maintained incrementally so the symmetry gate in the predicates
        # plugin is O(1) per call instead of an O(tasks) sweep (which made
        # a session's predicate validation O(tasks²)).
        self._assigned_anti_affinity: set = set()
        self._has_anti_affinity: set = set()
        for job in session.jobs.values():
            for task in job.tasks.values():
                if task.pod is not None:
                    self._task_nodes[task.uid] = task.node_name
                    if _affinity_terms(task.pod, "podAntiAffinity"):
                        self._has_anti_affinity.add(task.uid)
                        if task.node_name:
                            self._assigned_anti_affinity.add(task.uid)

    def update_task(self, task: TaskInfo, node_name: str) -> None:
        self._task_nodes[task.uid] = node_name
        if task.uid in self._has_anti_affinity:
            if node_name:
                self._assigned_anti_affinity.add(task.uid)
            else:
                self._assigned_anti_affinity.discard(task.uid)

    def any_required_anti_affinity(self) -> bool:
        """True iff any assigned pod declares required anti-affinity."""
        return bool(self._assigned_anti_affinity)

    def pods_on_node(self, node: NodeInfo) -> List[core.Pod]:
        return [t.pod for t in node.tasks.values() if t.pod is not None]

    def assigned_pods(self) -> List[tuple]:
        """[(pod, node_name)] for every assigned task in the session."""
        out = []
        for job in self.session.jobs.values():
            for task in job.tasks.values():
                if task.pod is None:
                    continue
                nn = self._task_nodes.get(task.uid, task.node_name)
                if nn:
                    out.append((task.pod, nn))
        return out


def pod_affinity_predicate(
    pod: core.Pod,
    node: NodeInfo,
    all_nodes: Dict[str, NodeInfo],
    assigned_pods: List[tuple],
) -> bool:
    """Required pod affinity/anti-affinity + symmetric anti-affinity of
    existing pods, the used subset of vendored InterPodAffinityMatches."""
    node_obj = node.node

    def domain_pods(topology_key: str) -> List[core.Pod]:
        """Existing pods whose node shares the candidate's topology domain."""
        out = []
        for ep, nn in assigned_pods:
            other = all_nodes.get(nn)
            other_node = other.node if other is not None else None
            if _same_topology(node_obj, other_node, topology_key):
                out.append(ep)
        return out

    # Required affinity: each term needs >=1 matching pod in the domain.
    for term in _affinity_terms(pod, "podAffinity"):
        pods = domain_pods(term.get("topologyKey", DEFAULT_TOPOLOGY_KEY))
        if not any(_term_matches_pod(term, pod, ep) for ep in pods):
            return False

    # Required anti-affinity: no matching pod in the domain.
    for term in _affinity_terms(pod, "podAntiAffinity"):
        pods = domain_pods(term.get("topologyKey", DEFAULT_TOPOLOGY_KEY))
        if any(_term_matches_pod(term, pod, ep) for ep in pods if ep is not pod):
            return False

    # Symmetry: existing pods' required anti-affinity must not match the
    # incoming pod within their topology domain.
    for ep, nn in assigned_pods:
        if ep is pod:
            continue
        for term in _affinity_terms(ep, "podAntiAffinity"):
            other = all_nodes.get(nn)
            other_node = other.node if other is not None else None
            if _same_topology(node_obj, other_node, term.get("topologyKey", DEFAULT_TOPOLOGY_KEY)):
                if _term_matches_pod(term, ep, pod):
                    return False
    return True


def inter_pod_affinity_score(
    pod: core.Pod,
    nodes: List[NodeInfo],
    all_nodes: Dict[str, NodeInfo],
    assigned_pods: List[tuple],
) -> Dict[str, float]:
    """Preferred pod (anti-)affinity scoring, the used subset of the
    vendored InterPodAffinityPriority: per node, sum the weights of
    preferred terms satisfied by pods in the node's topology domain
    (affinity adds weight, anti-affinity subtracts), then normalize to
    0..10 like CalculateAntiAffinityPriority's reduce."""
    raw: Dict[str, float] = {}
    aff_terms = _preferred_terms(pod, "podAffinity")
    anti_terms = _preferred_terms(pod, "podAntiAffinity")
    if not aff_terms and not anti_terms:
        return {}

    for node in nodes:
        score = 0.0
        for p in aff_terms:
            term = p.get("podAffinityTerm") or {}
            weight = float(p.get("weight", 0))
            for ep, nn in assigned_pods:
                other = all_nodes.get(nn)
                if other is None or other.node is None:
                    continue
                if _same_topology(node.node, other.node, term.get("topologyKey", DEFAULT_TOPOLOGY_KEY)):
                    if _term_matches_pod(term, pod, ep):
                        score += weight
        for p in anti_terms:
            term = p.get("podAffinityTerm") or {}
            weight = float(p.get("weight", 0))
            for ep, nn in assigned_pods:
                other = all_nodes.get(nn)
                if other is None or other.node is None:
                    continue
                if _same_topology(node.node, other.node, term.get("topologyKey", DEFAULT_TOPOLOGY_KEY)):
                    if _term_matches_pod(term, pod, ep):
                        score -= weight
        raw[node.name] = score

    max_score = max(raw.values(), default=0.0)
    min_score = min(raw.values(), default=0.0)
    spread = max_score - min_score
    if spread == 0:
        return {n: 0.0 for n in raw}
    return {n: 10.0 * (s - min_score) / spread for n, s in raw.items()}
