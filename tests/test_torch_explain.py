"""The port's explain against the JAX package's on the CPU.

``kernels.explain_counts`` (torch ops) is held to the JAX package's
jitted reduction bit for bit on generated snapshots edited to reach
every reason, over all rows and over a subset, with padded node rows;
``ops/explain.run_explain`` likewise, on two seeds.  Then the sessions
of ``tests/test_explain.py`` run through the port's ``gpu-allocate``
and ``gpu-preempt`` (``device="cpu"``) against ``jax-allocate`` and
``jax-preempt`` (explain on, the port's only setting): the same
fit-error messages, the same split between device-synthesized and
host-swept explanations and the same close-time writeback.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_explain as ref_explain
from tests.test_torch_preempt_cycle import Case, FULL, KINDS
from volcano_tpu.actions.allocate import AllocateAction as JaxAllocate
from volcano_tpu.actions.jax_allocate import JaxAllocateAction
from volcano_tpu.actions.jax_preempt import JaxPreemptAction
from volcano_tpu.apis import core as jax_core
from volcano_tpu.framework import close_session as jax_close, open_session as jax_open
from volcano_tpu.ops import explain as jax_explain
from volcano_tpu.ops.kernels import explain_counts as jax_explain_counts
from volcano_tpu.ops.synthetic import (
    generate_cluster_objects as jax_generate_cluster_objects,
    generate_snapshot as jax_generate_snapshot,
)
from volcano_tpu_torch import metrics
from volcano_tpu_torch.actions.allocate import AllocateAction
from volcano_tpu_torch.actions.gpu_allocate import GpuAllocateAction
from volcano_tpu_torch.actions.gpu_preempt import GpuPreemptAction
from volcano_tpu_torch.framework import close_session, open_session
from volcano_tpu_torch.ops import explain
from volcano_tpu_torch.ops.kernels import as_tensor, explain_counts, N_EXPLAIN_REASONS
from volcano_tpu_torch.ops.synthetic import generate_snapshot

from tests.builders import build_node, build_pod, build_pod_group, build_queue


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread keeps the suite's parallel workers from
    contending for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- the reduction ----

def _mixed_snapshots(seed: int):
    """The same generated snapshot from each package (byte-identical
    arrays), edited alike so every reason shows: oversized requests,
    cordoned nodes, full pod counts, selectors and taints."""
    kwargs = dict(n_tasks=96, n_nodes=40, gang_size=4, seed=seed, label_classes=3,
                  taint_fraction=0.3)
    snaps = jax_generate_snapshot(**kwargs), generate_snapshot(**kwargs)
    rng = np.random.RandomState(seed)
    big = rng.rand(96) < 0.2
    cordoned = rng.rand(40) < 0.2
    full = rng.rand(40) < 0.2
    for snap in snaps:
        snap.task_resreq[:96][big, 0] = 1e9
        snap.node_ok[:40][cordoned] = False
        snap.node_task_count[:40][full] = snap.node_max_tasks[:40][full]
    return snaps


_PLANES = ("task_resreq", "task_sel_bits", "task_tol_bits", "node_idle", "node_label_bits",
           "node_taint_bits", "node_ok", "node_task_count", "node_max_tasks", "tolerance")


@pytest.mark.parametrize("padded", [True, False])
@pytest.mark.parametrize("seed", range(4))
def test_explain_counts_match(seed, padded):
    """(reason[T, N], counts[T, P]) equal bit for bit, over the padded
    planes (padding nodes count as feasible) or the live rows only."""
    want_snap, snap = _mixed_snapshots(seed)
    T, N = snap.n_tasks, snap.n_nodes

    def planes(s, conv):
        out = []
        for name in _PLANES:
            a = getattr(s, name)
            if not padded and name.startswith("task_"):
                a = a[:T]
            elif not padded and name.startswith("node_"):
                a = a[:N]
            out.append(conv(a))
        return out

    want = jax_explain_counts(*planes(want_snap, jnp.asarray), jnp.int32(N))
    got = explain_counts(*planes(snap, lambda a: as_tensor(a, torch.device("cpu"))), N)
    for g, w in zip(got, want, strict=True):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and np.array_equal(g.numpy(), w)
    counts = got[1].numpy()[:T]
    assert (counts.sum(axis=1) <= N).all() and (counts > 0).any(axis=0).all()


@pytest.mark.parametrize("seed", [7, 11])
@pytest.mark.parametrize("rows", ["all", "every-third", "none"])
def test_run_explain_matches(rows, seed):
    """``run_explain`` over every row, a subset (other rows come back
    zero) or none."""
    want_snap, snap = _mixed_snapshots(seed)
    task_rows = {"all": None, "every-third": np.arange(0, snap.n_tasks, 3),
                 "none": np.zeros(0, dtype=np.int64)}[rows]
    want = jax_explain.run_explain(want_snap, task_rows=task_rows)
    got = explain.run_explain(snap, task_rows=task_rows, device="cpu")
    assert got.n_nodes == want.n_nodes
    assert got.counts.dtype == want.counts.dtype and np.array_equal(got.counts, want.counts)
    for i in range(snap.n_tasks):
        assert got.all_infeasible(i) == want.all_infeasible(i)
        assert got.fit_errors(i).error() == want.fit_errors(i).error()


def test_reduction_observes_its_latency():
    name = "volcano_explain_latency_milliseconds"
    before = metrics.registry.histogram(name)[0]
    _, snap = _mixed_snapshots(1)
    explain.run_explain(snap, task_rows=np.arange(4), device="cpu")
    assert metrics.registry.histogram(name)[0] == before + 1


# ---- tests/test_explain.py's sessions through the port's actions ----

def _fit_error_map(ssn):
    """(namespace/name) → (message, synthesized from device counts)."""
    return {
        f"{job.tasks[uid].namespace}/{job.tasks[uid].name}": (fe.error(), fe._histogram is not None)
        for job in ssn.jobs.values() for uid, fe in job.nodes_fit_errors.items()
    }


def _capture(case, actions, jax: bool):
    """Run the actions and capture the fit-error map before close."""
    cache = case.jax_cache() if jax else case.port_cache()
    conf = case.jax_conf() if jax else case.port_conf()
    ssn = (jax_open if jax else open_session)(cache, *conf)
    try:
        for action in actions:
            action.execute(ssn)
        fe = _fit_error_map(ssn)
    finally:
        (jax_close if jax else close_session)(ssn)
    return fe, cache


def _mixed():
    return Case(dict(zip(KINDS, ref_explain._mixed_reason_objects())))


def _with_easy_job():
    nodes, pods, pgs, queues = ref_explain._mixed_reason_objects()
    pods = pods + [build_pod("ns", "easy-0", "", {"cpu": "1", "memory": "1Gi"},
                             group="pg-easy")]
    pgs = pgs + [build_pod_group("ns", "pg-easy", 1, queue="q1")]
    return Case(dict(zip(KINDS, (nodes, pods, pgs, queues))))


def _stuck_cluster():
    return Case(dict(zip(KINDS, jax_generate_cluster_objects(
        n_tasks=48, n_nodes=12, gang_size=4, seed=3, label_classes=3, taint_fraction=0.4,
        node_cpu_milli=100, node_mem_mib=64))))


PRESSURE = (FULL[0], (("predicates", {"predicate.MemoryPressureEnable": "true"}),
                      "drf", "proportion", "nodeorder", "binpack"))

def _stuck_cluster_wide():
    """The randomized stuck cluster of tests/test_explain.py at another
    seed and shape: more zones, more taints."""
    return Case(dict(zip(KINDS, jax_generate_cluster_objects(
        n_tasks=64, n_nodes=20, gang_size=4, seed=11, label_classes=5, taint_fraction=0.6,
        node_cpu_milli=100, node_mem_mib=64))))


EXPLAIN_CASES = {
    # name: (case, the device must synthesize)
    "mixed-reasons": (_mixed, True),
    "randomized-stuck-cluster": (_stuck_cluster, True),
    "randomized-stuck-cluster-wide": (_stuck_cluster_wide, True),
    "refused-after-placements": (_with_easy_job, False),
    "pressure-predicates": (lambda: Case(dict(zip(KINDS, ref_explain._mixed_reason_objects())),
                                         tiers=PRESSURE), False),
}


@pytest.mark.parametrize("name", sorted(EXPLAIN_CASES))
def test_gpu_allocate_explains_as_jax_allocate(name):
    """gpu-allocate against jax-allocate, explain on: the same messages
    for the same tasks, equal to the host allocate's sweep; every task
    jax-allocate synthesized, gpu-allocate synthesized too.  gpu-allocate
    may synthesize more: the pending tasks its ORDER replay left out (a
    queue gone overused in the replay) have device counts in the port
    and take the host sweep in the JAX package — the same message either
    way."""
    make, synth = EXPLAIN_CASES[name]
    case = make()
    want, want_cache = _capture(case, [JaxAllocateAction(explain=True)], jax=True)
    action = GpuAllocateAction(device="cpu")
    got, cache = _capture(case, [action], jax=False)
    assert got and {k: m for k, (m, _) in got.items()} == {k: m for k, (m, _) in want.items()}
    want_synth = {k for k, (_, s) in want.items() if s}
    got_synth = {k for k, (_, s) in got.items() if s}
    assert want_synth <= got_synth and bool(got_synth) == synth
    assert action.last_phase_stats["explained"] == len(got_synth)
    assert cache.binder.binds == want_cache.binder.binds
    host, _ = _capture(case, [AllocateAction()], jax=False)
    assert {k: m for k, (m, _) in host.items()} == {k: m for k, (m, _) in got.items()}


def test_explained_tasks_skip_the_host_sweep():
    """A task the counts prove unplaceable takes no host sweep; the
    explain phase reports the rows it reduced and its pack/reduce split."""
    action = GpuAllocateAction(device="cpu")
    got, _ = _capture(_mixed(), [action], jax=False)
    stats = action.last_phase_stats
    assert stats["explained"] == 1 and stats["host_sweeps"] == 0
    assert stats["explain_rows"] >= stats["explained"]
    assert stats["explain_ms"] >= stats["explain_pack_ms"] >= 0
    assert stats["explain_reduce_ms"] >= 0


def test_fully_placed_cycle_reduces_nothing():
    """Everything placed: no reduction runs, nothing is explained."""
    easy = Case(dict(
        nodes=[build_node("n1", {"cpu": "8", "memory": "8Gi"})],
        pods=[build_pod("ns", "easy-0", "", {"cpu": "1", "memory": "1Gi"}, group="pg1")],
        pod_groups=[build_pod_group("ns", "pg1", 1, queue="q1")],
        queues=[build_queue("q1", weight=1)]))
    name = "volcano_explain_latency_milliseconds"
    before = metrics.registry.histogram(name)[0]
    action = GpuAllocateAction(device="cpu")
    got, cache = _capture(easy, [action], jax=False)
    assert not got and cache.binder.binds
    assert "explain_ms" not in action.last_phase_stats
    assert action.last_phase_stats["explained"] == 0
    assert metrics.registry.histogram(name)[0] == before


def test_unschedulable_reason_metric_recorded():
    name = "volcano_unschedulable_task_reasons"
    reason = "node(s) had taints that the pod didn't tolerate"
    before = metrics.registry.counter(name, reason=reason)
    _capture(_mixed(), [GpuAllocateAction(device="cpu")], jax=False)
    assert metrics.registry.counter(name, reason=reason) == before + 1


def test_gpu_preempt_no_victim_synthesizes():
    """tests/test_explain.py's no-victim session: gpu-preempt evicts
    nothing and synthesizes the preemptor's FitErrors, as jax-preempt."""
    from tests.test_torch_preempt_cycle import PREEMPT_CASES

    case = PREEMPT_CASES["explain-no-victim"]()
    want, want_cache = _capture(case, [JaxPreemptAction()], jax=True)
    action = GpuPreemptAction(device="cpu")
    got, cache = _capture(case, [action], jax=False)
    assert got == want and got["ns/preemptor"][1]
    assert cache.evictor.evicts == want_cache.evictor.evicts == []
    assert action.last_route == "device"


def _writeback():
    return Case(dict(
        nodes=[build_node("n1", {"cpu": "8", "memory": "8Gi"},
                          taints=[jax_core.Taint(key="dedicated", value="x", effect="NoSchedule")])],
        pods=[build_pod("ns", "pg1-stuck-0", "", {"cpu": "1", "memory": "1Gi"}, group="pg1")],
        pod_groups=[build_pod_group("ns", "pg1", 1, queue="q1")],
        queues=[build_queue("q1", weight=1)]))


@pytest.mark.parametrize("action", ["allocate", "gpu-allocate"])
def test_one_condition_per_cycle(action):
    """Two identical stuck cycles on one cache: the second writes no
    condition again, and each cycle's writeback equals the JAX
    package's (allocate, jax-allocate)."""
    make_jax = {"allocate": JaxAllocate, "gpu-allocate": JaxAllocateAction}[action]
    make_port = {"allocate": AllocateAction,
                 "gpu-allocate": lambda: GpuAllocateAction(device="cpu")}[action]
    case = _writeback()
    caches = case.jax_cache(), case.port_cache()
    for cycle in range(2):
        for cache, jax, make in zip(caches, (True, False), (make_jax, make_port)):
            ssn = (jax_open if jax else open_session)(cache, *(
                case.jax_conf() if jax else case.port_conf()))
            try:
                make().execute(ssn)
            finally:
                (jax_close if jax else close_session)(ssn)
        want, got = (c.status_updater for c in caches)
        assert got.conditions == want.conditions and got.pod_groups == want.pod_groups
        (key,) = got.conditions
        assert got.conditions[key] == 1 and key[1] == "Unschedulable"
        assert key[2] == "0/1 nodes are available: 1 node(s) had taints that the pod " \
                         "didn't tolerate."


def test_explains_every_reason_kind():
    """The reduction's reason codes name the host's reasons, in the
    host's first-failure order."""
    assert explain.EXPLAIN_REASONS == jax_explain.EXPLAIN_REASONS
    assert N_EXPLAIN_REASONS == len(explain.EXPLAIN_REASONS)
