"""Predicate / prioritize / select helpers driven per-task by the actions.

A copy of ``volcano_tpu/scheduler/util.py``.

Reference: pkg/scheduler/util/scheduler_helper.go.  The Go version fans out
over 16 goroutines with adaptive node subsampling; this host-side fallback
is a straight loop (gpu-allocate replaces it wholesale with the session
kernel — at device speed no subsampling is needed).  Flag parity for subsampling is kept via ``ServerOpts``.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from volcano_tpu_torch.api import FitError, FitErrors, NodeInfo, TaskInfo

#: scheduler_helper.go:35 baselinePercentageOfNodesToFind
_BASELINE_PERCENTAGE = 50


@dataclass
class ServerOpts:
    """Subsampling knobs (cmd/scheduler/app/options/options.go:38-40)."""

    min_nodes_to_find: int = 100
    min_percentage_of_nodes_to_find: int = 5
    percentage_of_nodes_to_find: int = 100


server_opts = ServerOpts()

#: Round-robin fairness cursor (scheduler_helper.go:39 lastProcessedNodeIndex).
_last_processed_node_index = 0


def calculate_num_of_feasible_nodes_to_find(num_all_nodes: int) -> int:
    """scheduler_helper.go:42-61."""
    opts = server_opts
    if num_all_nodes <= opts.min_nodes_to_find or opts.percentage_of_nodes_to_find >= 100:
        return num_all_nodes

    adaptive = opts.percentage_of_nodes_to_find
    if adaptive <= 0:
        adaptive = _BASELINE_PERCENTAGE - num_all_nodes // 125
        if adaptive < opts.min_percentage_of_nodes_to_find:
            adaptive = opts.min_percentage_of_nodes_to_find

    num = num_all_nodes * adaptive // 100
    return max(num, opts.min_nodes_to_find)


def get_node_list(nodes: Dict[str, NodeInfo]) -> List[NodeInfo]:
    """Deterministic node ordering (util.go GetNodeList iterates map —
    nondeterministic in Go; sorted here so the host path is reproducible
    and bindings-equivalent with the device path)."""
    return [nodes[name] for name in sorted(nodes)]


def predicate_nodes(
    task: TaskInfo,
    nodes: List[NodeInfo],
    fn: Callable[[TaskInfo, NodeInfo], None],
) -> Tuple[List[NodeInfo], FitErrors]:
    """scheduler_helper.go:64-117 — collect up to numNodesToFind feasible
    nodes starting at the round-robin cursor."""
    global _last_processed_node_index
    fe = FitErrors()
    all_nodes = len(nodes)
    if all_nodes == 0:
        return [], fe
    num_to_find = calculate_num_of_feasible_nodes_to_find(all_nodes)

    # In deterministic mode the fairness cursor is pinned to 0 so the host
    # path's examination order (and thus tie-breaks) matches the device
    # kernel's lowest-index argmax.  The cursor only matters for
    # subsampling fairness (scheduler_helper.go:84-85).
    start = 0 if deterministic_tie_break else _last_processed_node_index

    found: List[NodeInfo] = []
    processed = 0
    for i in range(all_nodes):
        node = nodes[(start + i) % all_nodes]
        processed += 1
        try:
            fn(task, node)
        except FitError as err:
            fe.set_node_error(node.name, err)
            continue
        found.append(node)
        if len(found) >= num_to_find:
            break

    if not deterministic_tie_break:
        _last_processed_node_index = (start + processed) % all_nodes
    return found, fe


def prioritize_nodes(
    task: TaskInfo,
    nodes: List[NodeInfo],
    batch_fn: Callable[[TaskInfo, List[NodeInfo]], Dict[str, float]],
    map_fn: Callable[[TaskInfo, NodeInfo], Tuple[Dict[str, float], float]],
    reduce_fn: Callable[[TaskInfo, Dict[str, List[Tuple[str, int]]]], Dict[str, float]],
) -> Dict[float, List[NodeInfo]]:
    """scheduler_helper.go:120-182 — score → {score: [nodes]}."""
    import math

    plugin_node_score_map: Dict[str, List[Tuple[str, int]]] = {}
    node_order_score_map: Dict[str, float] = {}
    node_scores: Dict[float, List[NodeInfo]] = {}

    for node in nodes:
        map_scores, order_score = map_fn(task, node)
        for plugin, score in map_scores.items():
            plugin_node_score_map.setdefault(plugin, []).append(
                (node.name, int(math.floor(score)))
            )
        node_order_score_map[node.name] = order_score

    reduce_scores = reduce_fn(task, plugin_node_score_map)
    batch_node_score = batch_fn(task, nodes)

    for node in nodes:
        score = reduce_scores.get(node.name, 0.0)
        score += node_order_score_map.get(node.name, 0.0)
        score += batch_node_score.get(node.name, 0.0)
        node_scores.setdefault(score, []).append(node)
    return node_scores


def sort_nodes(node_scores: Dict[float, List[NodeInfo]]) -> List[NodeInfo]:
    """scheduler_helper.go:185-197 — nodes in descending score order."""
    out: List[NodeInfo] = []
    for score in sorted(node_scores, reverse=True):
        out.extend(node_scores[score])
    return out


#: When True (default), equal-score ties break on the first node in list
#: order instead of randomly.  The reference picks randomly
#: (scheduler_helper.go:210); determinism is required for the device path's
#: bindings-equivalence contract, so deterministic is our default and the
#: random behavior is opt-in.
deterministic_tie_break = True


def select_best_node(node_scores: Dict[float, List[NodeInfo]]) -> Optional[NodeInfo]:
    """scheduler_helper.go:200-211."""
    best_nodes: List[NodeInfo] = []
    max_score = float("-inf")
    for score, nodes in node_scores.items():
        if score > max_score:
            max_score = score
            best_nodes = nodes
    if not best_nodes:
        return None
    if deterministic_tie_break:
        return best_nodes[0]
    return best_nodes[random.randrange(len(best_nodes))]
