"""The port's warm packer, change tracking, clone pool and resident
planes against the JAX package's, on the CPU.

Every case of ``tests/test_pack_cache.py`` runs on both packages over
the same cluster (built once with the JAX package's builders and carried
to the port as dicts) and the same mutation script (numpy
``RandomState``; each mutation is a store event, as dicts, or a bind,
applied to both caches).  For each case:

  * the port's warm pack equals the port's cold ``pack_session`` seeded
    with copies of its registries (the warm packer's contract);
  * the port's warm pack equals the JAX package's, plane for plane, in
    its fields, its delta rows, its registries and its ``last_stats``;
  * after every mutation, the port cache's change tracking (revisions,
    dirty tasks, dirty nodes, dirty node objects) equals the JAX
    cache's.

Beside them: the staged planes (``ops/device_stage``, on CPU tensors)
against the numpy planes, ``index_copy_`` deltas against a full put,
and the session kernel's node operands built from the staged planes
(``session_kernel.device_node_operands``) against
``prepare_session_arrays``' host arrays, bit for bit.  No tolerance:
every comparison is exact.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

import volcano_tpu.actions  # noqa: F401 — registers the JAX package's actions
import volcano_tpu.plugins  # noqa: F401 — registers its plugin builders
import volcano_tpu_torch.actions  # noqa: F401 — registers the port's actions
import volcano_tpu_torch.plugins  # noqa: F401 — registers its plugin builders
from volcano_tpu.actions.jax_allocate import (
    compute_task_order as jax_compute_task_order,
    JaxAllocateAction,
)
from volcano_tpu.apis import core as jax_core, scheduling as jax_scheduling
from volcano_tpu.apis import serde as jax_serde
from volcano_tpu.framework import (
    close_session as jax_close_session,
    open_session as jax_open_session,
)
from volcano_tpu.ops.pack_cache import PackCache as JaxPackCache
from volcano_tpu_torch.actions.gpu_allocate import compute_task_order, GpuAllocateAction
from volcano_tpu_torch.cache import feed_events, feed_from_dicts, SchedulerCache
from volcano_tpu_torch.conf import PluginOption, Tier
from volcano_tpu_torch.framework import close_session, open_session
from volcano_tpu_torch.ops.device_stage import (
    DeviceStager,
    fetch_plane,
    get_stager,
    PRESTAGE_PLANES,
    STAGED_PLANES,
)
from volcano_tpu_torch.ops.kernels import _feasibility_classes, run_packed
from volcano_tpu_torch.ops.pack_cache import (
    JOB_PLANES,
    NODE_DYNAMIC_PLANES,
    NODE_STATIC_PLANES,
    PackCache,
    TASK_PLANES,
)
from volcano_tpu_torch.ops.packing import BitRegistry, pack_session
from volcano_tpu_torch.ops.session_kernel import (
    device_node_operands,
    prepare_session_arrays,
    run_packed_cuda,
)

from tests.builders import build_node, build_pod, build_pod_group
from tests.fakes import FakeBinder, FakeEvictor, FakeStatusUpdater
from tests.scheduler_helpers import make_cache, tiers as jax_tiers
from tests.test_pack_cache import _base_cluster, _snapshot_state


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: one intra-op thread is as fast, and keeps
    the suite's parallel workers from contending for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


STANDARD = (("priority", "gang"), ("drf", "predicates", "proportion", "nodeorder", "binpack"))

ALL_PLANES = TASK_PLANES + NODE_DYNAMIC_PLANES + NODE_STATIC_PLANES + JOB_PLANES + ("tolerance",)

META_FIELDS = (
    "n_tasks",
    "n_nodes",
    "n_jobs",
    "task_uids",
    "node_names",
    "job_uids",
    "resource_names",
    "needs_host_validation",
    "memory_exact",
)

#: last_stats keys both packers write with equal values (the times differ)
STAT_KEYS = ("mode", "cold_cause", "repacked_tasks", "reused_tasks", "repacked_nodes",
             "reordered")

#: event kind → (the JAX package's API type, its cache's handler suffix)
JAX_KINDS = {
    "node": (jax_core.Node, "node"),
    "pod": (jax_core.Pod, "pod"),
    "pod_group": (jax_scheduling.PodGroup, "pod_group"),
    "queue": (jax_scheduling.Queue, "queue"),
}


def jax_feed_events(cache, events) -> None:
    """The JAX package's counterpart of ``cache.feed_events``."""
    for ev in events:
        cls, kind = JAX_KINDS[ev["kind"]]
        obj = cls.from_dict(ev["object"])
        if ev["op"] == "add":
            getattr(cache, f"add_{kind}")(obj)
        elif ev["op"] == "update":
            getattr(cache, f"update_{kind}")(cls.from_dict(ev["old"]), obj)
        else:
            getattr(cache, f"delete_{kind}")(obj)


class Pair:
    """The same cluster in a JAX cache and a port cache, each with its
    warm packer, and the script that mutates both alike."""

    def __init__(self, cluster: dict, snapshot_reuse: bool = False):
        self.jax = make_cache(**copy.deepcopy(cluster))
        self.jax.snapshot_reuse = snapshot_reuse
        self.port = SchedulerCache(binder=FakeBinder(), evictor=FakeEvictor(),
                                   status_updater=FakeStatusUpdater(),
                                   snapshot_reuse=snapshot_reuse)
        feed_from_dicts(self.port, **{k: [jax_serde.to_dict(o) for o in v]
                                      for k, v in cluster.items()})
        self.jax_pc = JaxPackCache(self.jax)
        self.pc = PackCache(self.port)
        self.assert_tracking_equal()

    # ---- mutations, applied to both caches ----

    def events(self, events) -> None:
        jax_feed_events(self.jax, events)
        feed_events(self.port, events)
        self.assert_tracking_equal()

    def add(self, kind: str, obj) -> None:
        self.events([{"op": "add", "kind": kind, "object": jax_serde.to_dict(obj)}])

    def update(self, kind: str, old, new) -> None:
        self.events([{"op": "update", "kind": kind, "old": jax_serde.to_dict(old),
                      "object": jax_serde.to_dict(new)}])

    def delete(self, kind: str, obj) -> None:
        self.events([{"op": "delete", "kind": kind, "object": jax_serde.to_dict(obj)}])

    def bind(self, job_uid: str, task_uid: str, host: str) -> None:
        """Bind the task in both caches; a failure must fail alike."""
        outcomes = []
        for cache in (self.jax, self.port):
            try:
                cache.bind(cache.jobs[job_uid].tasks[task_uid], host)
                outcomes.append(None)
            except Exception as e:  # noqa: BLE001 — compared below
                outcomes.append(type(e).__name__)
        assert outcomes[0] == outcomes[1]
        self.assert_tracking_equal()

    def assert_tracking_equal(self) -> None:
        """The port cache's change tracking is the JAX cache's."""
        for attr in ("_rev", "_topology_rev", "_dirty_tasks", "_dirty_nodes",
                     "_dirty_nodes_full", "_job_mut_rev", "_node_mut_rev"):
            assert getattr(self.port, attr) == getattr(self.jax, attr), attr

    # ---- one cycle's packs ----

    def pack_both(self, ctx: str = ""):
        """One cycle on each cache: the warm pack through the PackCache,
        and on the port a cold pack seeded with copies of the resulting
        registries.  Checks the contract and the cross-package equality;
        returns (port session, port warm, port cold, JAX warm) with the
        port session open."""
        jssn = jax_open_session(self.jax, jax_tiers(*STANDARD), [])
        try:
            ordered, jobs, nodes = _inputs(jssn, jax_compute_task_order(jssn))
            jwarm = self.jax_pc.pack(ordered, jobs, nodes, jssn.pack_epoch,
                                     enforce_pod_count=True)
        finally:
            jax_close_session(jssn)
        ssn = open_session(self.port, [Tier(plugins=[PluginOption(name=n) for n in t])
                                       for t in STANDARD], [])
        ordered, jobs, nodes = _inputs(ssn, compute_task_order(ssn))
        warm = self.pc.pack(ordered, jobs, nodes, ssn.pack_epoch, enforce_pod_count=True)
        cold = pack_session(ordered, jobs, nodes, label_registry=copy_reg(self.pc.label_reg),
                            taint_registry=copy_reg(self.pc.taint_reg))
        assert_identical(warm, cold, f"{ctx} (port warm vs seeded cold)")
        assert_identical(warm, jwarm, f"{ctx} (port vs JAX package)")
        assert_delta_equal(warm, jwarm, ctx)
        assert self.pc.label_reg.index == self.jax_pc.label_reg.index
        assert self.pc.taint_reg.index == self.jax_pc.taint_reg.index
        assert ({k: self.pc.last_stats.get(k) for k in STAT_KEYS}
                == {k: self.jax_pc.last_stats.get(k) for k in STAT_KEYS}), ctx
        assert self.pc._exists_uids == self.jax_pc._exists_uids
        assert self.pc._consumed_rev == self.jax_pc._consumed_rev
        self.assert_tracking_equal()
        return ssn, warm, cold, jwarm

    def cycle(self, ctx: str = ""):
        """pack_both, closing the port session; returns (warm, cold, jwarm)."""
        ssn, warm, cold, jwarm = self.pack_both(ctx)
        close_session(ssn)
        return warm, cold, jwarm

    # ---- the mutation script of tests/test_pack_cache.py ----

    def mutate(self, rng, step: int) -> None:
        """``tests/test_pack_cache._mutate`` with the same draws from
        ``rng``, through events (or binds) applied to both caches."""
        cache = self.jax
        kind = rng.randint(7)
        if kind == 0:
            j = f"new{step}"
            self.add("pod_group", build_pod_group("ns", f"pg-{j}", 2, queue="q"))
            sel = {"disk": "ssd"} if step % 2 else {"zone": "z1"}
            for i in range(2):
                self.add("pod", build_pod("ns", f"{j}-t{i}", "", {"cpu": "1", "memory": "1Gi"},
                                          group=f"pg-{j}", selector=sel))
        elif kind in (1, 2):
            for job in cache.jobs.values():
                for t in job.tasks.values():
                    if t.pod is not None and not t.node_name:
                        new = copy.deepcopy(t.pod)
                        if kind == 1:
                            new.spec.containers[0].resources = {
                                "requests": {"cpu": "3", "memory": "2Gi"}}
                        else:
                            new.status.phase = "Pending"
                        self.update("pod", t.pod, new)
                        return
        elif kind in (3, 4):
            name = sorted(cache.nodes)[int(rng.randint(len(cache.nodes)))]
            node = cache.nodes[name].node
            if node is None:
                return
            new = copy.deepcopy(node)
            if kind == 3:
                new.spec.taints = [jax_core.Taint(key="dedicated", value=f"v{step}",
                                                  effect="NoSchedule")]
            else:
                new.metadata.labels = dict(new.metadata.labels)
                new.metadata.labels["zone"] = f"z{int(rng.randint(4))}"
            self.update("node", node, new)
        elif kind == 5:
            for job in cache.jobs.values():
                for t in list(job.tasks.values()):
                    if not t.node_name:
                        host = sorted(cache.nodes)[int(rng.randint(len(cache.nodes)))]
                        self.bind(job.uid, t.uid, host)
                        return
        else:
            self.add("node", build_node(f"nx{step}", {"cpu": "16", "memory": "32Gi"},
                                        labels={"zone": "z9"}))


def copy_reg(reg: BitRegistry) -> BitRegistry:
    c = BitRegistry(reg.words)
    c.index = dict(reg.index)
    c.overflow = reg.overflow
    return c


def _inputs(ssn, ordered):
    jobs = {}
    for t in ordered:
        j = ssn.jobs.get(t.job)
        if j is not None and j.uid not in jobs:
            jobs[j.uid] = j
    return ordered, list(jobs.values()), [ssn.nodes[name] for name in sorted(ssn.nodes)]


def assert_identical(a, b, ctx: str = "") -> None:
    for name in ALL_PLANES:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), f"{ctx}: plane {name} diverged"
    for f in META_FIELDS:
        assert getattr(a, f) == getattr(b, f), f"{ctx}: {f}"


def assert_delta_equal(a, b, ctx: str = "") -> None:
    """The two packs' deltas name the same planes with the same rows."""
    assert (a.delta is None) == (b.delta is None), ctx
    if a.delta is None:
        return
    assert a.delta.base_rev == b.delta.base_rev
    assert set(a.delta.planes) == set(b.delta.planes), ctx
    for name, rows in a.delta.planes.items():
        other = b.delta.planes[name]
        assert (rows is None) == (other is None), (ctx, name)
        if rows is not None:
            assert np.array_equal(rows, other), (ctx, name)


def _pending(cache):
    return next(t for job in cache.jobs.values() for t in job.tasks.values()
                if t.pod is not None and not t.node_name)


# ---- the cases of tests/test_pack_cache.py ----


def test_pack_cache_property_random_mutations():
    rng = np.random.RandomState(7)
    pair = Pair(_base_cluster(rng))
    warm, cold, _ = pair.cycle("cycle 0 (cold)")
    for cycle in range(1, 9):
        for _ in range(int(rng.randint(1, 4))):
            pair.mutate(rng, cycle * 10 + int(rng.randint(10)))
        warm, cold, _ = pair.cycle(f"cycle {cycle}")
        if cycle in (3, 8) and warm.n_tasks:
            assert np.array_equal(run_packed(warm, device="cpu"),
                                  run_packed(cold, device="cpu"))


def test_pack_cache_warm_reuses_rows_after_bind_churn():
    rng = np.random.RandomState(3)
    pair = Pair(_base_cluster(rng, n_jobs=4, gang=3, n_nodes=6))
    pair.cycle()
    assert pair.pc.last_stats["mode"] == "cold"
    for job in list(pair.jax.jobs.values()):
        for t in list(job.tasks.values()):
            if t.pod is not None and not t.node_name:
                pair.update("pod", t.pod, copy.deepcopy(t.pod))
    warm, _, _ = pair.cycle("status churn")
    assert pair.pc.last_stats["mode"] == "warm"
    assert pair.pc.last_stats["repacked_tasks"] == 0
    assert pair.pc.last_stats["reused_tasks"] == warm.n_tasks


def test_delta_reconstructs_snapshot():
    rng = np.random.RandomState(11)
    pair = Pair(_base_cluster(rng))
    warm0, _, _ = pair.cycle()
    prev = {name: np.copy(getattr(warm0, name)) for name in ALL_PLANES}
    pair.mutate(rng, 1)
    t = next(t for job in pair.jax.jobs.values() for t in job.tasks.values()
             if not t.node_name)
    pair.bind(t.job, t.uid, sorted(pair.jax.nodes)[0])
    warm1, _, _ = pair.cycle()
    assert warm1.delta is not None
    for name in ALL_PLANES:
        new = getattr(warm1, name)
        if name not in warm1.delta.planes:
            assert np.array_equal(prev[name], new), name
            continue
        rows = warm1.delta.planes[name]
        if rows is None:
            continue
        rebuilt = prev[name].copy()
        rebuilt[rows] = new[rows]
        assert np.array_equal(rebuilt, new), name


def test_device_stager_matches_numpy_planes():
    """Staged on CPU tensors: each plane, fetched, equals the numpy
    plane in dtype and bits, cycle after cycle."""
    rng = np.random.RandomState(5)
    pair = Pair(_base_cluster(rng, n_jobs=3, gang=2, n_nodes=5))
    for cycle in range(3):
        if cycle:
            pair.mutate(rng, cycle)
        warm, _, _ = pair.cycle()
        staged = get_stager(pair.pc.key, "cpu").stage(warm)
        for name in STAGED_PLANES:
            arr = getattr(warm, name)
            assert np.array_equal(fetch_plane(staged[name], arr), arr), (cycle, name)
            assert fetch_plane(staged[name], arr).dtype == arr.dtype


def test_out_of_order_epoch_packs_one_shot():
    rng = np.random.RandomState(9)
    pair = Pair(_base_cluster(rng, n_jobs=2, gang=2, n_nodes=4))
    pair.cycle()
    consumed = pair.pc._consumed_rev
    assert consumed == pair.jax_pc._consumed_rev

    class StaleEpoch:
        rev = consumed - 1
        topology_rev = 0
        dirty_tasks = set()
        dirty_nodes = set()

    ssn = open_session(pair.port, [Tier(plugins=[PluginOption(name=n) for n in t])
                                   for t in STANDARD], [])
    ordered, jobs, nodes = _inputs(ssn, compute_task_order(ssn))
    snap = pair.pc.pack(ordered, jobs, nodes, StaleEpoch())
    close_session(ssn)
    assert snap.cache_key is None  # one-shot: not cacheable downstream
    assert pair.pc._consumed_rev == consumed  # state untouched


def test_dirty_tracking_granularity():
    """Status-only churn keeps task rows clean; spec changes dirty them;
    binds dirty nodes; node adds bump the topology revision — in both
    caches alike (Pair checks the tracking after every step)."""
    rng = np.random.RandomState(2)
    pair = Pair(_base_cluster(rng, n_jobs=2, gang=2, n_nodes=3))
    task = _pending(pair.jax)
    epoch = pair.port.snapshot().pack_epoch
    pair.port.clear_dirty_through(epoch)
    pair.jax.clear_dirty_through(pair.jax.snapshot().pack_epoch)
    pair.assert_tracking_equal()

    new = copy.deepcopy(task.pod)
    new.status.phase = "Pending"
    pair.update("pod", task.pod, new)
    assert task.uid not in pair.port._dirty_tasks

    stored = pair.jax.jobs[task.job].tasks[task.uid]
    new2 = copy.deepcopy(stored.pod)
    new2.spec.containers[0].resources = {"requests": {"cpu": "7", "memory": "1Gi"}}
    pair.update("pod", stored.pod, new2)
    assert task.uid in pair.port._dirty_tasks

    topo0 = pair.port._topology_rev
    pair.bind(task.job, task.uid, sorted(pair.jax.nodes)[0])
    assert sorted(pair.port.nodes)[0] in pair.port._dirty_nodes
    assert pair.port._topology_rev == topo0

    pair.add("node", build_node("late", {"cpu": "4", "memory": "8Gi"}))
    assert pair.port._topology_rev > topo0


def test_snapshot_clone_reuse_equivalence():
    """A snapshot_reuse=True cache gives snapshots equal to a cloning
    cache's across cycles with binds and churn, and to the JAX package's
    pooled cache's; it does hand back untouched clones."""
    rng = np.random.RandomState(4)
    cluster = _base_cluster(rng, n_jobs=5, gang=3, n_nodes=6)
    pooled = Pair(cluster, snapshot_reuse=True)
    plain = Pair(cluster)
    action, jax_action = GpuAllocateAction(device="cpu"), JaxAllocateAction()
    port_tiers = [Tier(plugins=[PluginOption(name=n) for n in t]) for t in STANDARD]
    reused = 0
    for cycle in range(4):
        states = []
        for pair in (pooled, plain):
            ssn = open_session(pair.port, port_tiers, [])
            jssn = jax_open_session(pair.jax, jax_tiers(*STANDARD), [])
            states += [_snapshot_state(ssn), _snapshot_state(jssn)]
            action.execute(ssn)
            close_session(ssn)
            jax_action.execute(jssn)
            jax_close_session(jssn)
            pair.assert_tracking_equal()
        reused += sum(pooled.port.last_pool_reuse)
        assert all(st == states[0] for st in states), f"cycle {cycle}"
        assert pooled.port.binder.binds == plain.port.binder.binds
        pg = build_pod_group("ns", f"late{cycle}", 1, queue="q")
        pod = build_pod("ns", f"late{cycle}-t0", "", {"cpu": "1", "memory": "1Gi"},
                        group=f"late{cycle}")
        for pair in (pooled, plain):
            pair.add("pod_group", pg)
            pair.add("pod", pod)
    assert reused > 0


def test_kernels_identical_with_staged_planes():
    """The session wrapper on CPU tensors: with the stager's planes and
    without (a full put of its own), the same assignment as
    run_packed's."""
    rng = np.random.RandomState(13)
    pair = Pair(_base_cluster(rng, n_jobs=6, gang=3, n_nodes=8))
    warm, _, _ = pair.cycle()
    plain = run_packed(warm, device="cpu")
    assert np.array_equal(run_packed_cuda(warm, device="cpu"), plain)
    warm.device_planes = get_stager(pair.pc.key, "cpu").stage(warm)
    assert np.array_equal(run_packed_cuda(warm, device="cpu"), plain)


def test_new_label_pair_back_patches_clean_nodes():
    rng = np.random.RandomState(0)
    pair = Pair(_base_cluster(rng, n_jobs=2, gang=2, n_nodes=8))
    pair.cycle()
    assert ("disk", "ssd") not in pair.pc.label_reg.index
    pair.add("pod_group", build_pod_group("ns", "ssdjob", 1, queue="q"))
    pair.add("pod", build_pod("ns", "ssdjob-t0", "", {"cpu": "1", "memory": "1Gi"},
                              group="ssdjob", selector={"disk": "ssd"}))
    warm, _, _ = pair.cycle("label back-patch")
    assert pair.pc.last_stats["mode"] == "warm"
    idx = pair.pc.label_reg.index[("disk", "ssd")]
    word, bit = idx // 32, np.uint32(1 << (idx % 32))
    ssd_rows = [i for i, _ in enumerate(warm.node_names) if i % 4 == 0]
    assert ssd_rows and all(warm.node_label_bits[i, word] & bit for i in ssd_rows)
    assert warm.delta is not None
    rows = warm.delta.planes.get("node_label_bits")
    assert rows is None or set(ssd_rows) <= set(rows.tolist())


def test_new_taint_reresolves_clean_exists_tolerations():
    rng = np.random.RandomState(0)
    pair = Pair(_base_cluster(rng, n_jobs=4, gang=2, n_nodes=6))
    pair.cycle()
    node = pair.jax.nodes[sorted(pair.jax.nodes)[1]].node
    new = copy.deepcopy(node)
    new.spec.taints = [jax_core.Taint(key="dedicated", value="fresh", effect="NoSchedule")]
    pair.update("node", node, new)
    warm, _, _ = pair.cycle("taint re-resolve")
    assert pair.pc.last_stats["mode"] == "warm"
    idx = pair.pc.taint_reg.index[("dedicated", "fresh", "NoSchedule")]
    word, bit = idx // 32, np.uint32(1 << (idx % 32))
    exists_rows = [i for i, uid in enumerate(warm.task_uids) if uid in pair.pc._exists_uids]
    assert exists_rows and all(warm.task_tol_bits[i, word] & bit for i in exists_rows)


def test_registry_overflow_recovers_via_cold_rebuild():
    rng = np.random.RandomState(17)
    pair = Pair(_base_cluster(rng, n_jobs=2, gang=2, n_nodes=4))
    warm, _, _ = pair.cycle()
    assert not warm.needs_host_validation
    for pc in (pair.pc, pair.jax_pc):
        for i in range(pc.label_reg.words * 32 + 5):
            pc.label_reg.bit(("ghost", str(i)))
        assert pc.label_reg.overflow
    warm, _, _ = pair.cycle("post-overflow rebuild")
    assert pair.pc.last_stats["mode"] == "cold"
    assert not pair.pc.label_reg.overflow
    assert not warm.needs_host_validation


def test_micro_pack_on_task_bucket_change():
    rng = np.random.RandomState(11)
    pair = Pair(_base_cluster(rng, n_jobs=8, gang=4))  # 32 pending
    pair.cycle()
    assert pair.pc.last_stats["mode"] == "cold"
    assert pair.pc.last_stats["cold_cause"] == "first-pack"
    for k in range(20):
        pair.add("pod_group", build_pod_group("ns", f"burst{k}", 2, queue="q"))
        sel = {"disk": "ssd"} if k % 3 == 0 else None
        for i in range(2):
            pair.add("pod", build_pod("ns", f"burst{k}-t{i}", "",
                                      {"cpu": "1", "memory": "1Gi"},
                                      group=f"burst{k}", selector=sel))
    micro, cold, _ = pair.cycle("bucket grow (micro)")
    assert pair.pc.last_stats["mode"] == "micro"
    assert micro.task_resreq.shape[0] == 128
    assert np.array_equal(run_packed(micro, device="cpu"), run_packed(cold, device="cpu"))
    burst_pods = [t.pod for j in list(pair.jax.jobs.values()) for t in list(j.tasks.values())
                  if t.name.startswith("burst") and t.pod is not None]
    for pod in burst_pods:
        pair.delete("pod", pod)
    micro2, _, _ = pair.cycle("bucket shrink (micro)")
    assert pair.pc.last_stats["mode"] == "micro"
    assert micro2.task_resreq.shape[0] == 64
    pair.cycle("steady (warm over micro base)")
    assert pair.pc.last_stats["mode"] == "warm"


def test_micro_pack_device_stager_consistency():
    """Staged planes equal the numpy planes across a micro pack (task
    planes restaged wholesale at the new bucket, node planes copied in
    by index)."""
    rng = np.random.RandomState(13)
    pair = Pair(_base_cluster(rng, n_jobs=6, gang=4))
    warm, _, _ = pair.cycle()
    stager = get_stager(pair.pc.key, "cpu")
    stager.stage(warm)
    for k in range(24):
        pair.add("pod_group", build_pod_group("ns", f"m{k}", 2, queue="q"))
        for i in range(2):
            pair.add("pod", build_pod("ns", f"m{k}-t{i}", "", {"cpu": "1", "memory": "1Gi"},
                                      group=f"m{k}"))
    micro, _, _ = pair.cycle()
    assert pair.pc.last_stats["mode"] == "micro"
    planes = stager.stage(micro)
    for name in STAGED_PLANES:
        arr = getattr(micro, name)
        assert np.array_equal(fetch_plane(planes[name], arr), arr), name


def test_cold_cause_recorded():
    rng = np.random.RandomState(17)
    pair = Pair(_base_cluster(rng, n_jobs=4, gang=3, n_nodes=6))
    pair.cycle()
    assert pair.pc.last_stats["cold_cause"] == "first-pack"
    pair.pc.label_reg.overflow = pair.jax_pc.label_reg.overflow = True
    pair.cycle("overflow recovery")
    assert pair.pc.last_stats["mode"] == "cold"
    assert pair.pc.last_stats["cold_cause"] == "registry-overflow"
    pair.add("node", build_node("fresh-node", {"cpu": "8", "memory": "16Gi"}))
    pair.cycle("topology rebuild")
    assert pair.pc.last_stats["mode"] == "cold"
    assert pair.pc.last_stats["cold_cause"] == "topology"


# ---- the port's own: resident node operands and index_copy_ deltas ----


def _churned_pair(seed: int, cycles: int = 4):
    """A pair whose warm packs went through ``cycles`` rounds of the
    mutation script, with each pack staged on CPU tensors; yields each
    staged warm pack."""
    rng = np.random.RandomState(seed)
    pair = Pair(_base_cluster(rng, n_jobs=6, gang=3, n_nodes=9))
    stager = get_stager(pair.pc.key, "cpu")
    for cycle in range(cycles):
        if cycle:
            for _ in range(int(rng.randint(1, 4))):
                pair.mutate(rng, cycle * 10 + int(rng.randint(10)))
        warm, _, _ = pair.cycle(f"cycle {cycle}")
        warm.device_planes = stager.stage(warm)
        yield warm


@pytest.mark.parametrize("seed", [1, 7, 21])
def test_device_node_operands_equal_host_arrays(seed):
    """``device_node_operands`` on the staged planes (CPU tensors) gives
    ``prepare_session_arrays``' nd, cf_u8, cls_off and cls_nodes bit for
    bit, on every warm pack of a churned cache."""
    for warm in _churned_pair(seed):
        host, _, NK = prepare_session_arrays(warm)
        _, class_sel, class_tol = _feasibility_classes(warm)
        built = device_node_operands(warm.device_planes, warm.n_nodes, class_sel, class_tol)
        assert set(built) == {"nd", "cf_u8", "cls_off", "cls_nodes"}
        for name, arr in built.items():
            want = host[name]
            got = arr.numpy()
            assert got.dtype == want.dtype and got.shape == want.shape, name
            want_bytes = np.ascontiguousarray(want).view(np.uint8)
            assert np.array_equal(got.view(np.uint8), want_bytes), name


def test_device_node_operands_past_the_snapshot_rows():
    """NK wider than the snapshot's node pad (129 nodes → NK 256, pad
    256) and narrower (60 nodes, pad 64 → NK 128): the zero columns and
    the class lists agree with the host's."""
    from volcano_tpu_torch.ops.synthetic import generate_snapshot

    for n_nodes in (60, 129):
        snap = generate_snapshot(n_tasks=40, n_nodes=n_nodes, gang_size=4, seed=3,
                                 label_classes=3, taint_fraction=0.2)
        stager = DeviceStager("snap", "cpu")
        snap.rev = 1
        snap.device_planes = stager.stage(snap)
        host, _, _ = prepare_session_arrays(snap)
        _, class_sel, class_tol = _feasibility_classes(snap)
        built = device_node_operands(snap.device_planes, snap.n_nodes, class_sel, class_tol)
        for name, arr in built.items():
            want = np.ascontiguousarray(host[name])
            assert np.array_equal(arr.numpy().view(np.uint8), want.view(np.uint8)), name


def test_index_copy_deltas_equal_a_full_put():
    """A stager brought up to each revision by ``index_copy_`` deltas
    holds what a fresh stager's full put of the same pack holds, and
    ships fewer bytes once warm."""
    scattered = False
    for warm in _churned_pair(5, cycles=5):
        fresh = DeviceStager("fresh", "cpu").stage(warm)
        for name in STAGED_PLANES:
            assert torch.equal(warm.device_planes[name], fresh[name]), name
        if warm.delta is not None and any(
                rows is not None and rows.size for rows in warm.delta.planes.values()):
            scattered = True
    assert scattered
    # one bind between two packs: the warm pack's delta is a few node rows
    rng = np.random.RandomState(3)
    pair = Pair(_base_cluster(rng, n_jobs=4, gang=3, n_nodes=6))
    stager = DeviceStager("probe", "cpu")
    stager.stage(pair.cycle()[0])
    full_bytes = stager.take_bytes()
    t = _pending(pair.jax)
    pair.bind(t.job, t.uid, sorted(pair.jax.nodes)[0])
    warm = pair.cycle()[0]
    assert pair.pc.last_stats["mode"] == "warm"
    planes = stager.stage(warm)
    delta_bytes = stager.take_bytes()
    assert 0 < delta_bytes < full_bytes
    for name in STAGED_PLANES:
        assert np.array_equal(fetch_plane(planes[name], getattr(warm, name)),
                              getattr(warm, name)), name


def test_prestage_then_stage_equals_numpy():
    """The node-plane prestage (the dynamic planes from begin_nodes,
    before ORDER), then stage(): every staged plane equals the pack's."""
    rng = np.random.RandomState(3)
    pair = Pair(_base_cluster(rng, n_jobs=4, gang=3, n_nodes=7))
    warm, _, _ = pair.cycle()
    stager = get_stager(pair.pc.key, "cpu")
    stager.stage(warm)
    for step in range(3):
        t = next((t for job in pair.jax.jobs.values() for t in job.tasks.values()
                  if not t.node_name), None)
        if t is not None:
            pair.bind(t.job, t.uid, sorted(pair.jax.nodes)[step % 7])
        ssn = open_session(pair.port, [Tier(plugins=[PluginOption(name=n) for n in tt])
                                       for tt in STANDARD], [])
        nodes = [ssn.nodes[name] for name in sorted(ssn.nodes)]
        pending = pair.pc.begin_nodes(nodes, ssn.pack_epoch, True)
        assert pending is not None
        stager.prestage(pending["planes"], pending["dirty_pos"], pair.pc.rev + 1)
        for name in PRESTAGE_PLANES:
            assert stager.plane_rev[name] == pair.pc.rev + 1
        ordered, jobs, nodes = _inputs(ssn, compute_task_order(ssn))
        warm = pair.pc.pack(ordered, jobs, nodes, ssn.pack_epoch, enforce_pod_count=True)
        close_session(ssn)
        planes = stager.stage(warm)
        for name in STAGED_PLANES:
            arr = getattr(warm, name)
            assert np.array_equal(fetch_plane(planes[name], arr), arr), (step, name)
        # keep the JAX packer on the same revision
        jssn = jax_open_session(pair.jax, jax_tiers(*STANDARD), [])
        pair.jax_pc.pack(*_inputs(jssn, jax_compute_task_order(jssn)), jssn.pack_epoch)
        jax_close_session(jssn)
