"""The port's scheduling cycle against the JAX package's on the CPU.

Every case is built once with the JAX package's test builders; the JAX
package's cache is fed the objects, the port's cache the same objects
carried across as dicts (``serde.to_dict`` → ``feed_from_dicts``).  Each
cycle (open_session → action → close_session) is held against its
counterpart for equality, never closeness: the binds in the order the
binder received them, the PodGroup statuses and pod conditions written
at close, the order of ``fast_order`` (and of the exact replay), and the
verdict of ``try_fast_apply``.  ``gpu-allocate`` runs with
``device="cpu"``, where the PyTorch specification takes the KERNEL
phase; ``jax-allocate`` runs as the JAX package's own tests run it.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

import volcano_tpu.actions  # noqa: F401 — registers the JAX package's actions
import volcano_tpu.plugins  # noqa: F401 — registers its plugin builders
import volcano_tpu_torch.actions  # noqa: F401 — registers the port's actions
import volcano_tpu_torch.plugins  # noqa: F401 — registers its plugin builders
from volcano_tpu.actions import fast_apply as jax_fast_apply
from volcano_tpu.actions.allocate import AllocateAction as JaxHostAllocate
from volcano_tpu.actions.fast_order import try_compute_task_order as jax_fast_order
from volcano_tpu.actions.jax_allocate import (
    compute_task_order_replay as jax_order_replay,
    JaxAllocateAction,
)
from volcano_tpu.apis import core as jax_core, serde as jax_serde
from volcano_tpu.cache import SchedulerCache as JaxCache
from volcano_tpu.conf import PluginOption as JaxPluginOption, Tier as JaxTier
from volcano_tpu.framework import (
    close_session as jax_close_session,
    open_session as jax_open_session,
)
from volcano_tpu_torch import faults, metrics
from volcano_tpu_torch.actions import allocate, gpu_allocate
from volcano_tpu_torch.actions.allocate import AllocateAction
from volcano_tpu_torch.actions.fast_order import try_compute_task_order
from volcano_tpu_torch.actions.gpu_allocate import (
    compute_task_order_replay,
    GpuAllocateAction,
)
from volcano_tpu_torch.cache import feed_from_dicts, SchedulerCache
from volcano_tpu_torch.conf import PluginOption, Tier
from volcano_tpu_torch.faults import watchdog
from volcano_tpu_torch.faults.watchdog import CycleDeadlineExceeded
from volcano_tpu_torch.framework import close_session, open_session
from volcano_tpu_torch.ops import dispatch, kernels
from volcano_tpu_torch.ops.dispatch import ExecutorFailed

from tests.builders import (
    build_node,
    build_pod,
    build_pod_group,
    build_priority_class,
    build_queue,
)
from tests.test_fast_apply import _cluster as _fast_apply_cluster, _residual_cluster
from tests.test_fast_order import _gang_cluster
from tests.test_jax_allocate import (
    _case_gang_partial_discard,
    _case_multi_job_spread,
    _case_multi_namespace,
    _case_multi_queue_fairshare,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: one intra-op thread is as fast, and keeps
    the suite's parallel workers from contending for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: the headline tiers (bench/_profsetup.py)
STANDARD = (("priority", "gang"), ("drf", "predicates", "proportion", "nodeorder", "binpack"))
#: the order in which a cache is fed
KINDS = ("nodes", "pods", "pod_groups", "queues", "priority_classes", "pvcs")


class ListBinder:
    """Records ``(ns/name, hostname)`` in the order binds arrive."""

    def __init__(self):
        self.binds = []

    def bind(self, task, hostname):
        self.binds.append((f"{task.namespace}/{task.name}", hostname))


class StatusRecorder:
    """Records the close-time writeback: PodGroup statuses and pod
    conditions, keyed (the job updater writes from a thread pool).
    Session-unique fields (transition id, time) are left out."""

    def __init__(self):
        self.pod_groups = {}
        self.conditions = {}

    def update_pod_condition(self, task, reason, message):
        self.conditions[f"{task.namespace}/{task.name}"] = (reason, message)

    def update_pod_group(self, pg):
        st = pg.status
        self.pod_groups[pg.key()] = (
            st.phase, st.running, st.succeeded, st.failed,
            tuple((c.type, c.status, c.reason, c.message) for c in st.conditions),
        )
        return pg


class Case:
    """One cluster: the JAX package's objects and the same objects as
    dicts, with the tiers its cycle runs under."""

    def __init__(self, tiers=STANDARD, **objects):
        self.tiers = tiers
        self.objects = {k: list(objects.get(k, ())) for k in KINDS}
        self.dicts = {k: [jax_serde.to_dict(o) for o in v] for k, v in self.objects.items()}

    def jax_cache(self) -> JaxCache:
        cache = JaxCache(binder=ListBinder(), status_updater=StatusRecorder())
        for kind, add in zip(KINDS, (cache.add_node, cache.add_pod, cache.add_pod_group,
                                     cache.add_queue, cache.add_priority_class,
                                     cache.add_pvc)):
            for obj in self.objects[kind]:
                add(obj)
        return cache

    def port_cache(self) -> SchedulerCache:
        cache = SchedulerCache(binder=ListBinder(), status_updater=StatusRecorder())
        return feed_from_dicts(cache, **self.dicts)

    def jax_tiers(self):
        return [JaxTier(plugins=[JaxPluginOption(name=n) for n in g]) for g in self.tiers]

    def port_tiers(self):
        return [Tier(plugins=[PluginOption(name=n) for n in g]) for g in self.tiers]


def run_jax(case: Case, action):
    cache = case.jax_cache()
    ssn = jax_open_session(cache, case.jax_tiers(), [])
    try:
        action.execute(ssn)
    finally:
        jax_close_session(ssn)
    return cache


def run_port(case: Case, action):
    cache = case.port_cache()
    ssn = open_session(cache, case.port_tiers(), [])
    try:
        action.execute(ssn)
    finally:
        close_session(ssn)
    return cache


def _lanes(r):
    return r.milli_cpu, r.memory, sorted(r.scalars.items())


def outcome(cache):
    """What a cycle left behind: binds in order, the writeback, and the
    cache's float accounting (job allocated, node idle and used lanes,
    compared bit for bit)."""
    st = cache.status_updater
    jobs = {uid: _lanes(j.allocated) for uid, j in cache.jobs.items()}
    nodes = {name: (_lanes(n.idle), _lanes(n.used), list(n.tasks))
             for name, n in cache.nodes.items()}
    return cache.binder.binds, st.pod_groups, st.conditions, jobs, nodes


# ---- the cases ----

def _allocate_one_job_two_pods():
    return Case(
        tiers=(("drf", "proportion"),),
        nodes=[build_node("n1", {"cpu": "2", "memory": "4Gi"})],
        pods=[build_pod("c1", "p1", "", {"cpu": "1", "memory": "1G"}, group="pg1"),
              build_pod("c1", "p2", "", {"cpu": "1", "memory": "1G"}, group="pg1")],
        pod_groups=[build_pod_group("c1", "pg1", 0, queue="c1")],
        queues=[build_queue("c1", weight=1)],
    )


def _allocate_two_jobs_namespace_balanced():
    return Case(
        tiers=(("drf", "proportion"),),
        nodes=[build_node("n1", {"cpu": "2", "memory": "4G"})],
        pods=[build_pod(ns, p, "", {"cpu": "1", "memory": "1G"}, group=g)
              for ns, g in (("c1", "pg1"), ("c2", "pg2")) for p in ("p1", "p2")],
        pod_groups=[build_pod_group("c1", "pg1", 0, queue="c1"),
                    build_pod_group("c2", "pg2", 0, queue="c2")],
        queues=[build_queue("c1", weight=1), build_queue("c2", weight=1)],
    )


def _allocate_gang(n_nodes: int):
    return Case(
        tiers=(("priority", "gang"), ("drf", "proportion")),
        nodes=[build_node(f"n{i + 1}", {"cpu": "1", "memory": "2G"}) for i in range(n_nodes)],
        pods=[build_pod("c1", p, "", {"cpu": "1", "memory": "1G"}, group="pg1")
              for p in ("p1", "p2")],
        pod_groups=[build_pod_group("c1", "pg1", 2, queue="c1")],
        queues=[build_queue("c1")],
    )


def _allocate_pending_pod_group():
    return Case(
        tiers=(("drf", "proportion"),),
        nodes=[build_node("n1", {"cpu": "2", "memory": "4G"})],
        pods=[build_pod("c1", "p1", "", {"cpu": "1", "memory": "1G"}, group="pg1")],
        pod_groups=[build_pod_group("c1", "pg1", 0, queue="c1", phase="Pending")],
        queues=[build_queue("c1")],
    )


def _allocate_best_effort():
    return Case(
        tiers=(("drf", "proportion"),),
        nodes=[build_node("n1", {"cpu": "2", "memory": "4G"})],
        pods=[build_pod("c1", "p1", "", {}, group="pg1")],
        pod_groups=[build_pod_group("c1", "pg1", 0, queue="c1")],
        queues=[build_queue("c1")],
    )


def _allocate_node_selector():
    return Case(
        tiers=(("gang",), ("drf", "predicates", "proportion")),
        nodes=[build_node("n1", {"cpu": "2", "memory": "4G"}, labels={"disk": "hdd"}),
               build_node("n2", {"cpu": "2", "memory": "4G"}, labels={"disk": "ssd"})],
        pods=[build_pod("c1", "p1", "", {"cpu": "1", "memory": "1G"}, group="pg1",
                        selector={"disk": "ssd"})],
        pod_groups=[build_pod_group("c1", "pg1", 0, queue="c1")],
        queues=[build_queue("c1")],
    )


def _allocate_taints():
    return Case(
        tiers=(("gang",), ("drf", "predicates", "proportion")),
        nodes=[build_node("n1", {"cpu": "2", "memory": "4G"},
                          taints=[jax_core.Taint(key="dedicated", value="infra",
                                                 effect="NoSchedule")]),
               build_node("n2", {"cpu": "2", "memory": "4G"})],
        pods=[build_pod("c1", "p1", "", {"cpu": "1", "memory": "1G"}, group="pg1")],
        pod_groups=[build_pod_group("c1", "pg1", 0, queue="c1")],
        queues=[build_queue("c1")],
    )


def _jax_allocate_predicates():
    """tests/test_jax_allocate.py's predicates case: a selector, a
    toleration and a plain pod over a labelled, a tainted and a plain
    node (memory in G: not MiB-aligned, so the session is inexact)."""
    return Case(
        nodes=[build_node("n1", {"cpu": "8", "memory": "16G"}, labels={"zone": "a"}),
               build_node("n2", {"cpu": "8", "memory": "16G"},
                          taints=[jax_core.Taint(key="dedicated", value="x",
                                                 effect="NoSchedule")]),
               build_node("n3", {"cpu": "8", "memory": "16G"})],
        pods=[build_pod("ns", "sel", "", {"cpu": "1", "memory": "1G"}, group="pg",
                        selector={"zone": "a"}),
              build_pod("ns", "tol", "", {"cpu": "1", "memory": "1G"}, group="pg",
                        tolerations=[jax_core.Toleration(key="dedicated", value="x",
                                                         effect="NoSchedule")]),
              build_pod("ns", "any", "", {"cpu": "1", "memory": "1G"}, group="pg")],
        pod_groups=[build_pod_group("ns", "pg", 0, queue="q")],
        queues=[build_queue("q")],
    )


def _mib_gangs(seed: int):
    """Gangs of MiB-aligned pods on MiB-aligned nodes: an exact session,
    so the bulk commit takes every task."""
    rng = np.random.RandomState(seed)
    nodes = [build_node(f"n{i}", {"cpu": "8", "memory": "16Gi"}) for i in range(6)]
    pods, pgs = [], []
    for j in range(7):
        pgs.append(build_pod_group("ns", f"pg{j}", 3, queue="q"))
        for i in range(3):
            cpu = ["500m", "1", "2"][rng.randint(3)]
            pods.append(build_pod("ns", f"j{j}-t{i}", "", {"cpu": cpu, "memory": "512Mi"},
                                  group=f"pg{j}"))
    return Case(nodes=nodes, pods=pods, pod_groups=pgs, queues=[build_queue("q")])


def _fractional_cpu():
    """tests/test_fast_apply.py's fractional-cpu session: float lanes
    whose sums are round-sensitive, so the bulk commit's operation order
    shows in the bits."""
    rng = np.random.RandomState(7)
    nodes = [build_node(f"n{i}", {"cpu": "16", "memory": "64Gi"}) for i in range(4)]
    pods, pgs = [], []
    for j in range(5):
        pgs.append(build_pod_group("ns", f"pg{j}", 3, queue="q"))
        pods += [build_pod("ns", f"j{j}-t{i}", "",
                           {"cpu": ["0.1003", "0.2507", "0.4701"][rng.randint(3)],
                            "memory": "1Gi"}, group=f"pg{j}") for i in range(3)]
    return Case(nodes=nodes, pods=pods, pod_groups=pgs, queues=[build_queue("q")])


def _preferred_affinity():
    """A pod with a preferred node-affinity term toward the one labelled
    node, among plain pods: the kernel has no lane for the preference,
    so that task takes the host chooser, which nodeorder steers there."""
    pref = {"nodeAffinity": {"preferredDuringSchedulingIgnoredDuringExecution": [
        {"weight": 100, "preference": {"matchExpressions": [
            {"key": "zone", "operator": "In", "values": ["z1"]}]}}]}}
    nodes = [build_node(f"n{i}", {"cpu": "8", "memory": "16Gi"},
                        labels={"zone": "z1"} if i == 2 else {}) for i in range(3)]
    pods = [build_pod("ns", f"t{i}", "", {"cpu": "1", "memory": "1Gi"}, group="pg",
                      affinity=pref if i == 1 else None) for i in range(3)]
    return Case(nodes=nodes, pods=pods, pod_groups=[build_pod_group("ns", "pg", 3, queue="q")],
                queues=[build_queue("q")])


def _order_multi_queue():
    cluster = _gang_cluster(n_jobs=8, gang=3, min_avail=2)
    for i, pg in enumerate(cluster["pod_groups"]):
        pg.spec.queue = "qa" if i % 2 == 0 else "qb"
    cluster["queues"] = [build_queue("qa", weight=3), build_queue("qb", weight=1)]
    return Case(**cluster)


def _order_priorities_and_preallocated():
    nodes = [build_node(f"n{i}", {"cpu": "16", "memory": "32G"}) for i in range(4)]
    pcs = [build_priority_class("high", 1000), build_priority_class("low", 10)]
    pods = [build_pod("ns", "warm-r0", "n0", {"cpu": "2", "memory": "2G"},
                      phase="Running", group="warm")]
    pods += [build_pod("ns", f"warm-t{i}", "", {"cpu": "1", "memory": "1G"}, group="warm")
             for i in range(3)]
    pgs = [build_pod_group("ns", "warm", 2, queue="q")]
    for j, pc in [(0, "high"), (1, "low"), (2, "high")]:
        pgs.append(build_pod_group("ns", f"pg{j}", 2, queue="q", priority_class_name=pc))
        pods += [build_pod("ns", f"j{j}-t{i}", "", {"cpu": "1", "memory": "1G"},
                           group=f"pg{j}") for i in range(3)]
    return Case(nodes=nodes, pods=pods, pod_groups=pgs, queues=[build_queue("q")],
                priority_classes=pcs)


def _order_best_effort():
    return Case(
        nodes=[build_node("n0", {"cpu": "8", "memory": "16G"})],
        pods=[build_pod("ns", "be", "", {}, group="pg"),
              build_pod("ns", "real", "", {"cpu": "1", "memory": "1G"}, group="pg")],
        pod_groups=[build_pod_group("ns", "pg", 1, queue="q")],
        queues=[build_queue("q")],
    )


def _fuzz(seed: int):
    """tests/test_fast_order.py's seeded fuzz sessions."""
    rng = np.random.RandomState(seed)
    n_jobs = int(rng.randint(3, 12))
    gang = int(rng.randint(1, 6))
    min_avail = int(rng.randint(1, gang + 1))
    return Case(**_gang_cluster(n_jobs=n_jobs, gang=gang, min_avail=min_avail, seed=seed))


CASES = {
    "allocate-one-job-two-pods": _allocate_one_job_two_pods,
    "allocate-namespace-balanced": _allocate_two_jobs_namespace_balanced,
    "allocate-gang-discard": lambda: _allocate_gang(1),
    "allocate-gang-binds": lambda: _allocate_gang(2),
    "allocate-pending-pod-group": _allocate_pending_pod_group,
    "allocate-best-effort": _allocate_best_effort,
    "allocate-node-selector": _allocate_node_selector,
    "allocate-taints": _allocate_taints,
    "jax-multi-job-spread": lambda: Case(**_case_multi_job_spread()),
    "jax-multi-queue-fairshare": lambda: Case(**_case_multi_queue_fairshare()),
    "jax-multi-namespace": lambda: Case(**_case_multi_namespace()),
    "jax-gang-partial-discard": lambda: Case(**_case_gang_partial_discard()),
    "jax-predicates": _jax_allocate_predicates,
    "mib-gangs-0": lambda: _mib_gangs(0),
    "fast-apply-multi-queue": lambda: Case(**_fast_apply_cluster(
        n_jobs=9, gang=3, queues=[build_queue("qa", weight=3), build_queue("qb", weight=1)])),
    "fast-apply-fractional-cpu": _fractional_cpu,
    "fast-apply-residual-preference": lambda: Case(**_residual_cluster("preference")),
    "fast-apply-residual-pvc": lambda: Case(**_residual_cluster("pvc")),
    "preferred-affinity": _preferred_affinity,
    "mib-gangs-1": lambda: _mib_gangs(1),
    "order-simple-gangs": lambda: Case(**_gang_cluster()),
    "order-min-available": lambda: Case(**_gang_cluster(n_jobs=5, gang=6, min_avail=2)),
    "order-multi-queue": _order_multi_queue,
    "order-priorities-preallocated": _order_priorities_and_preallocated,
    "order-best-effort": _order_best_effort,
    **{f"order-fuzz-{seed}": (lambda s=seed: _fuzz(s)) for seed in range(6)},
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_host_allocate_matches(name):
    """The port's host ``allocate`` against the JAX package's."""
    case = CASES[name]()
    assert outcome(run_port(case, AllocateAction())) == outcome(run_jax(case, JaxHostAllocate()))


@pytest.mark.parametrize("name", sorted(CASES))
def test_gpu_allocate_matches_jax_allocate(name, monkeypatch):
    """``gpu-allocate`` on the CPU against ``jax-allocate``: binds,
    writeback and the bulk commit's verdict."""
    verdicts = {"jax": [], "port": []}

    def recording(fn, key, verdict=lambda out: out):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            verdicts[key].append(verdict(out))
            return out
        return wrapped

    monkeypatch.setattr(jax_fast_apply, "try_fast_apply",
                        recording(jax_fast_apply.try_fast_apply, "jax"))
    monkeypatch.setattr(gpu_allocate, "try_fast_apply",
                        recording(gpu_allocate.try_fast_apply, "port", lambda out: out[0]))
    case = CASES[name]()
    want = outcome(run_jax(case, JaxAllocateAction(explain=False)))
    action = GpuAllocateAction(device="cpu")
    assert outcome(run_port(case, action)) == want
    assert verdicts["port"] == verdicts["jax"]
    route = {(): "", (True,): "fast", (False,): "loop"}[tuple(verdicts["port"])]
    assert action.last_apply_route == route
    if route == "fast":
        assert action.last_phase_stats["commit_ms"] > 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_task_order_matches(name):
    """``fast_order``'s order and the exact replay's, as uids, against
    the JAX package's on the same session (a refusal must agree too)."""
    case = CASES[name]()
    jax_ssn = jax_open_session(case.jax_cache(), case.jax_tiers(), [])
    ssn = open_session(case.port_cache(), case.port_tiers(), [])
    try:
        want_fast, got_fast = jax_fast_order(jax_ssn), try_compute_task_order(ssn)
        assert (got_fast is None) == (want_fast is None)
        if got_fast is not None:
            assert [t.uid for t in got_fast] == [t.uid for t in want_fast]
        want = [t.uid for t in jax_order_replay(jax_ssn)]
        assert [t.uid for t in compute_task_order_replay(ssn)] == want
    finally:
        jax_close_session(jax_ssn)
        close_session(ssn)


def test_mib_sessions_take_the_bulk_commit():
    """The exact sessions above do reach try_fast_apply's bulk path, so
    the verdict comparison covers both of its answers; each cycle's pack
    and device phase land in the kernel latency histogram."""
    name = "volcano_tpu_kernel_latency_milliseconds"
    before = [metrics.registry.histogram(name, phase=p)[0] for p in ("pack", "execute")]
    action = GpuAllocateAction(device="cpu")
    run_port(_mib_gangs(0), action)
    assert action.last_apply_route == "fast"
    run_port(_jax_allocate_predicates(), action)
    assert action.last_apply_route == "loop"
    assert [metrics.registry.histogram(name, phase=p)[0] for p in ("pack", "execute")] == \
        [n + 2 for n in before]


def test_executor_failed_raises_and_binds_nothing(monkeypatch):
    """A kernel failure leaves the cycle: ExecutorFailed propagates out
    of execute(), nothing is bound, and neither the plain version, the
    host chooser nor the bulk commit runs in the kernel's place."""
    monkeypatch.setattr(dispatch, "select_executor",
                        lambda snap, weights=None, device=None: "cuda")
    ran = []
    for mod, name in ((kernels, "run_packed"), (dispatch, "run_packed"),
                      (gpu_allocate, "host_node_chooser"), (allocate, "host_node_chooser"),
                      (gpu_allocate, "try_fast_apply")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **k: ran.append(_n))
    case = Case(**_case_multi_job_spread())
    cache = case.port_cache()
    ssn = open_session(cache, case.port_tiers(), [])
    before = metrics.registry.counter("volcano_executor_failures_total",
                                      executor="cuda", cause="error")
    faults.configure("seed=1;device.lowering=1:count=1")
    try:
        with pytest.raises(ExecutorFailed, match="lowering"):
            GpuAllocateAction(device="cpu").execute(ssn)
    finally:
        faults.configure(None)
        faults.reset_breakers()
        close_session(ssn)
    assert cache.binder.binds == [] and ran == []
    assert metrics.registry.counter("volcano_executor_failures_total",
                                    executor="cuda", cause="error") == before + 1


def test_deadline_raises_and_binds_nothing(monkeypatch):
    """An armed deadline with no budget left: CycleDeadlineExceeded
    leaves execute() before APPLY, nothing is bound, neither the host
    chooser nor the bulk commit runs in the kernel's place, and the
    overrun is counted once as a failure of the executor."""
    ran = []
    for mod, name in ((gpu_allocate, "host_node_chooser"), (allocate, "host_node_chooser"),
                      (gpu_allocate, "try_fast_apply")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **k: ran.append(_n))
    case = Case(**_case_multi_job_spread())
    labels = {"executor": "torch-scan", "cause": "deadline"}
    before = metrics.registry.counter("volcano_executor_failures_total", **labels)
    cache = case.port_cache()
    ssn = open_session(cache, case.port_tiers(), [])
    action = GpuAllocateAction(device="cpu")
    watchdog.configure_deadline(1.0)
    try:
        watchdog.begin_cycle()
        time.sleep(0.01)  # the 1 ms budget is spent
        with pytest.raises(CycleDeadlineExceeded):
            action.execute(ssn)
    finally:
        watchdog.configure_deadline(None)
        close_session(ssn)
    assert "execute_ms" not in action.last_phase_stats
    assert action.last_apply_route == ""
    assert cache.binder.binds == [] and ran == []
    assert metrics.registry.counter("volcano_executor_failures_total", **labels) == before + 1


def test_cache_event_handlers_match():
    """The cache's update and delete handlers against the JAX package's:
    the same events, as objects and as dicts, on both caches, then one
    cycle each; equal outcomes (binds, writeback, accounting)."""
    import copy

    from volcano_tpu_torch.apis import core, scheduling

    case = _mib_gangs(3)
    objs = {k: {o.metadata.name: o for o in v} for k, v in case.objects.items()}
    pc = build_priority_class("urgent", 50)
    pvc = jax_core.PersistentVolumeClaim(metadata=jax_core.ObjectMeta(name="c", namespace="ns"),
                                         spec={"storageClassName": "std"})
    bound = copy.deepcopy(objs["pods"]["j0-t0"])
    bound.spec.node_name, bound.status.phase = "n0", "Running"
    cordoned = copy.deepcopy(objs["nodes"]["n1"])
    cordoned.metadata.labels["zone"] = "z9"
    cordoned.spec.unschedulable = True
    heavier = copy.deepcopy(objs["queues"]["q"])
    heavier.spec.weight = 2
    claimed = copy.deepcopy(pvc)
    claimed.status["phase"] = "Bound"
    port_cls = {jax_core.Pod: core.Pod, jax_core.Node: core.Node,
                jax_core.PriorityClass: core.PriorityClass,
                jax_core.PersistentVolumeClaim: core.PersistentVolumeClaim,
                type(heavier): scheduling.Queue,
                type(objs["pod_groups"]["pg6"]): scheduling.PodGroup}
    events = [
        ("update_pod", objs["pods"]["j0-t0"], bound),
        ("delete_pod", objs["pods"]["j1-t0"]),
        ("update_node", objs["nodes"]["n1"], cordoned),
        ("delete_node", objs["nodes"]["n5"]),
        ("delete_pod_group", objs["pod_groups"]["pg6"]),
        ("update_queue", objs["queues"]["q"], heavier),
        ("add_priority_class", pc),
        ("delete_priority_class", pc),
        ("add_pvc", pvc),
        ("update_pvc", pvc, claimed),
        ("delete_pvc", claimed),
    ]
    jax_cache, port_cache = case.jax_cache(), case.port_cache()
    for name, *args in events:
        getattr(jax_cache, name)(*args)
        getattr(port_cache, name)(*(port_cls[type(a)].from_dict(jax_serde.to_dict(a))
                                    for a in args))
    jax_ssn = jax_open_session(jax_cache, case.jax_tiers(), [])
    ssn = open_session(port_cache, case.port_tiers(), [])
    try:
        assert sorted(ssn.jobs) == sorted(jax_ssn.jobs) and sorted(ssn.nodes) == sorted(jax_ssn.nodes)
        JaxAllocateAction(explain=False).execute(jax_ssn)
        GpuAllocateAction(device="cpu").execute(ssn)
    finally:
        jax_close_session(jax_ssn)
        close_session(ssn)
    assert outcome(port_cache) == outcome(jax_cache) and port_cache.binder.binds
