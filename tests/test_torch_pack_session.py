"""The port's ``pack_session`` against the JAX package's, array for
array and flag for flag.

Each session is opened in both packages on the same cluster (the JAX
package's objects, carried to the port as dicts); the task order is
computed in each and must agree, then each package packs its own
session and every field of the packed snapshot (every plane and every
meta record the npz carries) must be equal, dtype and shape included.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from volcano_tpu.actions.jax_allocate import compute_task_order as jax_compute_task_order
from volcano_tpu.framework import (
    close_session as jax_close_session,
    open_session as jax_open_session,
)
from volcano_tpu.ops.packing import pack_session as jax_pack_session
from volcano_tpu.ops.synthetic import generate_cluster_objects as jax_generate_cluster_objects
from volcano_tpu_torch.actions.gpu_allocate import compute_task_order
from volcano_tpu_torch.framework import close_session, open_session
from volcano_tpu_torch.ops.packing import _SNAPSHOT_ARRAYS, _SNAPSHOT_META, pack_session
from volcano_tpu_torch.ops.synthetic import generate_cluster_objects

from tests.test_torch_cycle import _jax_allocate_predicates, _mib_gangs, Case


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: one intra-op thread is as fast, and keeps
    the suite's parallel workers from contending for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _generated(**kwargs):
    nodes, pods, pod_groups, queues = jax_generate_cluster_objects(**kwargs)
    return Case(nodes=nodes, pods=pods, pod_groups=pod_groups, queues=queues)


CASES = {
    # labels (8 zone classes) and taints on a tenth of the nodes
    "generated-2k-200": lambda: _generated(n_tasks=2_000, n_nodes=200, gang_size=8,
                                           label_classes=8, taint_fraction=0.1, seed=3),
    "generated-fairshare": lambda: _generated(n_tasks=1_000, n_nodes=100, gang_size=4,
                                              seed=7),
    "jax-predicates": _jax_allocate_predicates,
    "mib-gangs": lambda: _mib_gangs(2),
}


def _pack(ordered, ssn, pack):
    jobs = {}
    for t in ordered:
        jobs.setdefault(t.job, ssn.jobs[t.job])
    nodes = [ssn.nodes[name] for name in sorted(ssn.nodes)]
    return pack(ordered, list(jobs.values()), nodes,
                enforce_pod_count="predicates" in ssn.predicate_fns)


@pytest.mark.parametrize("name", sorted(CASES))
def test_pack_session_matches(name):
    case = CASES[name]()
    jax_ssn = jax_open_session(case.jax_cache(), case.jax_tiers(), [])
    ssn = open_session(case.port_cache(), case.port_tiers(), [])
    try:
        want_order, order = jax_compute_task_order(jax_ssn), compute_task_order(ssn)
        assert [t.uid for t in order] == [t.uid for t in want_order] and order
        want = _pack(want_order, jax_ssn, jax_pack_session)
        got = _pack(order, ssn, pack_session)
    finally:
        jax_close_session(jax_ssn)
        close_session(ssn)
    for field in _SNAPSHOT_ARRAYS:
        a, b = getattr(want, field), getattr(got, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert np.array_equal(a, b), field
    for field in _SNAPSHOT_META:
        assert getattr(got, field) == getattr(want, field), field


def test_generated_cluster_objects_match():
    """The port's generator gives the JAX package's objects: their dicts
    are equal, object for object."""
    kwargs = dict(n_tasks=600, n_nodes=50, gang_size=4, label_classes=3,
                  taint_fraction=0.2, seed=11)
    want = jax_generate_cluster_objects(**kwargs)
    got = generate_cluster_objects(**kwargs)
    for w, g in zip(want, got, strict=True):
        assert [o.to_dict() for o in g] == [o.to_dict() for o in w]
