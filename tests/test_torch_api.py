"""The port's object model against the JAX package's on the CPU.

``Resource`` arithmetic and comparisons on seeded values (the float64
lanes compared bit for bit: ``fast_apply``'s bulk commit depends on the
same operation order), quantity parsing, and the ``serde`` round trip of
the API objects: the JAX package's ``to_dict`` → the port's
``from_dict`` → the port's ``to_dict`` gives the dict it started from.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from volcano_tpu.api import resource as jax_resource
from volcano_tpu.apis import core as jax_core, quantity as jax_quantity
from volcano_tpu.apis import scheduling as jax_scheduling, serde as jax_serde
from volcano_tpu.ops.synthetic import generate_cluster_objects as jax_generate_cluster_objects
from volcano_tpu_torch.api import resource
from volcano_tpu_torch.apis import core, quantity, scheduling, serde

from tests.builders import build_node, build_pod, build_pod_group, build_priority_class, build_queue


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: one intra-op thread is as fast, and keeps
    the suite's parallel workers from contending for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(rng):
    """One seeded resource list as (JAX Resource, port Resource):
    fractional cpu, byte memory, and sometimes a scalar lane."""
    rl = {"cpu": f"{rng.randint(0, 8000)}m", "memory": str(int(rng.randint(0, 1 << 34))),
          "pods": int(rng.randint(0, 110))}
    if rng.rand() < 0.5:
        rl["nvidia.com/gpu"] = str(rng.randint(0, 8))
    if rng.rand() < 0.2:
        rl["cpu"] = f"{rng.rand() * 4:.3f}"
    return (jax_resource.Resource.from_resource_list(rl),
            resource.Resource.from_resource_list(rl))


def _lanes(r):
    return (r.milli_cpu, r.memory, sorted(r.scalars.items()), r.max_task_num)


@pytest.mark.parametrize("seed", range(8))
def test_resource_arithmetic_matches(seed):
    rng = np.random.RandomState(seed)
    pairs = [_pair(rng) for _ in range(24)]
    ja, pa = jax_resource.Resource(), resource.Resource()
    for (jr, pr) in pairs:
        assert _lanes(pr) == _lanes(jr)
        ja.add(jr)
        pa.add(pr)
        assert _lanes(pa) == _lanes(ja)
    for (jr, pr), (jq, pq) in zip(pairs, pairs[1:]):
        for op in ("less", "less_equal", "less_equal_strict"):
            assert getattr(pr, op)(pq) == getattr(jr, op)(jq), op
        assert pr.is_empty() == jr.is_empty()
        assert (pr == pq) == (jr == jq)
        jd, pd = jr.clone().fit_delta(jq), pr.clone().fit_delta(pq)
        assert _lanes(pd) == _lanes(jd)
        assert _lanes(pr.clone().set_max(pq)) == _lanes(jr.clone().set_max(jq))
        assert _lanes(pr.clone().multi(0.37)) == _lanes(jr.clone().multi(0.37))
        assert _lanes(resource.min_resource(pr, pq)) == _lanes(jax_resource.min_resource(jr, jq))
        assert [_lanes(x) for x in pr.diff(pq)] == [_lanes(x) for x in jr.diff(jq)]
        for name in ("cpu", "memory", "nvidia.com/gpu"):
            assert pr.is_zero(name) == jr.is_zero(name)
            assert resource.share(pr.get(name), pq.get(name)) == \
                jax_resource.share(jr.get(name), jq.get(name))
    for jr, pr in pairs:
        if jr.less_equal(ja):
            ja.sub(jr)
            pa.sub(pr)
        assert _lanes(pa) == _lanes(ja)


QUANTITIES = ["100m", "1", "2.5", "1Gi", "512Mi", "1G", "1500k", "13m", "1e3", "0.1",
              7, 2.25, "", "3Ti", "250u", "4E"]


@pytest.mark.parametrize("value", QUANTITIES, ids=[repr(q) for q in QUANTITIES])
def test_quantity_parsing_matches(value):
    for fn in ("parse_quantity", "milli_value", "int_value"):
        assert getattr(quantity, fn)(value) == getattr(jax_quantity, fn)(value), fn


def _objects():
    nodes, pods, pgs, queues = jax_generate_cluster_objects(
        n_tasks=64, n_nodes=16, gang_size=4, label_classes=3, taint_fraction=0.3, seed=5)
    affinity = {"nodeAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": {
        "nodeSelectorTerms": [{"matchExpressions": [
            {"key": "zone", "operator": "In", "values": ["z1"]}]}]}}}
    return [
        (core.Node, nodes + [build_node("n-t", {"cpu": "4", "memory": "8Gi", "nvidia.com/gpu": 2},
                                        labels={"zone": "z1"}, unschedulable=True)]),
        (core.Pod, pods + [build_pod("ns", "p-aff", "n-t", {"cpu": "500m", "memory": "1G"},
                                     phase="Running", group="pg", affinity=affinity,
                                     priority=7, ports=[8080])]),
        (scheduling.PodGroup, pgs + [build_pod_group("ns", "pg", 2, queue="q",
                                                     min_resources={"cpu": "2"},
                                                     priority_class_name="high")]),
        (scheduling.Queue, queues + [build_queue("q", weight=3, capability={"cpu": "64"})]),
        (core.PriorityClass, [build_priority_class("high", 1000)]),
    ]


@pytest.mark.parametrize("kind", ["Node", "Pod", "PodGroup", "Queue", "PriorityClass"])
def test_serde_round_trip(kind):
    (cls, objs), = [(c, o) for c, o in _objects() if c.__name__ == kind]
    for obj in objs:
        want = jax_serde.to_dict(obj)
        assert serde.to_dict(serde.from_dict(cls, want)) == want
        assert cls.from_dict(obj.to_dict()).to_dict() == obj.to_dict()


def test_scheduling_constants_match():
    for name in ("GROUP_NAME_ANNOTATION_KEY", "POD_GROUP_PENDING", "POD_GROUP_INQUEUE",
                 "POD_GROUP_RUNNING", "POD_GROUP_UNKNOWN", "POD_GROUP_UNSCHEDULABLE_TYPE"):
        assert getattr(scheduling, name) == getattr(jax_scheduling, name)
    assert {f for f in vars(core) if not f.startswith("_")} <= set(vars(jax_core))
