"""The port's commit path through its store against the JAX package's,
on the CPU: the in-process cases of ``tests/test_commit_plane.py``, the
resync and quarantine cases of ``tests/test_faults.py``, and the audit
Events of ``tests/test_e2e.py`` and ``tests/test_explain.py``.

With ``SchedulerCache(pipelined_commit=True)`` the binds, Scheduled,
Evict and Unschedulable Events, pod conditions and PodGroup statuses
land on background bind workers as coalesced commit frames, and the
store that results equals the synchronous path's and the JAX package's,
every user-visible field of it (``store_digest``: without resource
versions, timestamps and a condition's transition id).  Each case runs
on both packages (``pkg``): the port's ``Scheduler`` with ``gpu-allocate``
(or the host ``allocate``) on the CPU, the JAX package's with
``jax-allocate``.  The bus cases of the reference file wait for the port's
bus client.  Every commit plane is stopped in a ``finally``, and every
wait is bounded.
"""

from __future__ import annotations

import time
import types

import pytest

import chip_smoke
import volcano_tpu.actions  # noqa: F401 — registers the JAX package's actions
import volcano_tpu.plugins  # noqa: F401 — registers its plugin builders
from volcano_tpu import faults as jax_faults
from volcano_tpu.cache import commit_plane as jax_commit_plane
from volcano_tpu.api import new_task_info as jax_new_task_info
from volcano_tpu.incremental import subgraph as jax_subgraph
from volcano_tpu.metrics import metrics as jax_metrics
from volcano_tpu.metrics.metrics import registry as jax_registry
from volcano_tpu.scheduler.scheduler import Scheduler as JaxScheduler
from volcano_tpu_torch import faults, metrics
from volcano_tpu_torch.actions import gpu_allocate, gpu_preempt
from volcano_tpu_torch.api import new_task_info
from volcano_tpu_torch.cache import commit_plane
from volcano_tpu_torch.framework import get_action, register_action
from volcano_tpu_torch.incremental import subgraph
from volcano_tpu_torch.scheduler.scheduler import Scheduler

from tests.builders import build_node, build_pod, build_pod_group, build_queue
from tests.fakes import FakeBinder, FakeEvictor, FakeStatusUpdater
from tests.test_torch_client import conv, JAX, named, one_torch_thread, PORT  # noqa: F401

JAX_EXTRA = dict(Scheduler=JaxScheduler, faults=jax_faults, new_task_info=jax_new_task_info,
                 allocate="jax-allocate", preempt="jax-preempt")
PORT_EXTRA = dict(Scheduler=Scheduler, faults=faults, new_task_info=new_task_info,
                  allocate="gpu-allocate", preempt="gpu-preempt")
JAXP = types.SimpleNamespace(**vars(JAX), **JAX_EXTRA)
PORTP = types.SimpleNamespace(**vars(PORT), **PORT_EXTRA)
PKGS = [pytest.param(JAXP, id="jax"), pytest.param(PORTP, id="port")]

CONF = """
actions: "enqueue, {allocate}"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
  - name: binpack
"""

PREEMPT_CONF = """
actions: "enqueue, {allocate}, {preempt}"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
"""


@pytest.fixture(autouse=True)
def cpu_actions_and_clean_faults():
    """The port's device actions on the CPU, both packages' fault planes
    off, for each test; the registry's instances restored after."""
    saved = [get_action(n) for n in ("gpu-allocate", "gpu-preempt")]
    register_action(gpu_allocate.GpuAllocateAction(device="cpu"))
    register_action(gpu_preempt.GpuPreemptAction(device="cpu"))
    faults.configure(None)
    jax_faults.configure(None)
    yield
    faults.configure(None)
    jax_faults.configure(None)
    for action in saved:
        register_action(action)


def counter(pkg, name, **labels) -> float:
    if pkg.port:
        return metrics.registry.counter(name, **labels)
    return jax_registry._counters.get((name, tuple(sorted(labels.items()))), 0.0)


def gauge(pkg, name) -> float:
    if pkg.port:
        return metrics.registry.gauge(name)
    return jax_registry._gauges[(name, ())]


def histogram_count(pkg, name) -> int:
    if pkg.port:
        return metrics.registry.histogram(name)[0]
    h = jax_registry._histograms.get((name, ()))
    return 0 if h is None else h.total


def render(pkg) -> str:
    return (metrics.registry if pkg.port else jax_registry).render()


def wait_for(pred, timeout=20.0, interval=0.02) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


class MiniCluster:
    """One package's scheduler loop over a seeded in-process store, with
    a store-truth rebind audit (``tests/test_commit_plane.py``'s, without
    the bus backend)."""

    def __init__(self, pkg, tmp_path, name, pipelined=False, host=False, conf=CONF):
        self.pkg = pkg
        self.api = pkg.api.APIServer()
        self.kube = pkg.clients.KubeClient(self.api)
        self.vc = pkg.clients.VolcanoClient(self.api)
        self.vc.create_queue(conv(pkg, named(build_queue("default"))))
        for i in range(4):
            self.kube.create_node(conv(pkg, named(build_node(
                f"n{i}", {"cpu": "4", "memory": "16Gi"}))))
        self.bound, self.rebinds = {}, []
        self.api.watch("Pod", self._audit, send_initial=False)
        self.client = pkg.clients.SchedulerClient(self.api)
        self.cache = pkg.Cache(client=self.client, pipelined_commit=pipelined)
        allocate = "allocate" if host else pkg.allocate
        path = tmp_path / f"{name}-{'port' if pkg.port else 'jax'}.conf"
        path.write_text(conf.format(allocate=allocate, preempt=pkg.preempt))
        self.scheduler = pkg.Scheduler(self.cache, scheduler_conf_path=str(path))
        self.cache.run()

    def _audit(self, event, old, new):
        if event not in ("ADDED", "MODIFIED") or new is None or not new.spec.node_name:
            return
        key = f"{new.metadata.namespace}/{new.metadata.name}"
        prev = self.bound.setdefault(key, new.spec.node_name)
        if prev != new.spec.node_name:
            self.rebinds.append((key, prev, new.spec.node_name))

    def create(self, obj):
        return self.api.create(conv(self.pkg, named(obj)))

    def submit_workload(self):
        """Three gang jobs and one that can never fit, so a cycle binds,
        records Scheduled Events and writes back Unschedulable Events,
        pod conditions and a PodGroup condition."""
        for jname, replicas, cpu in (("g0", 3, "1"), ("g1", 2, "1"), ("big", 1, "100")):
            self.create(build_pod_group("ns", jname, replicas))
            for i in range(replicas):
                self.create(build_pod("ns", f"{jname}-t{i}", "", {"cpu": cpu, "memory": "1Gi"},
                                      group=jname))

    def cycle(self):
        self.scheduler.run_once()

    def placed(self):
        return {f"{p.metadata.namespace}/{p.metadata.name}": p.spec.node_name
                for p in self.kube.list_pods("ns") if p.spec.node_name}

    def close(self):
        self.cache.stop_commit_plane()


def store_digest(api, counts=True):
    """Every user-visible field of the commit path's output — without
    resource versions, timestamps and the per-session transition id."""
    pods = {f"{p.metadata.namespace}/{p.metadata.name}": (
        p.spec.node_name, p.status.phase,
        tuple(sorted((c.type, c.status, c.reason, c.message) for c in p.status.conditions)))
        for p in api.list("Pod")}
    events = {(e.involved_object.get("name"), e.type, e.reason):
              (e.count if counts else None, e.message) for e in api.list("Event")}
    pgs = {f"{g.metadata.namespace}/{g.metadata.name}": (
        g.status.phase, g.status.running, g.status.succeeded, g.status.failed,
        tuple(sorted((c.type, c.status, c.reason, c.message) for c in g.status.conditions)))
        for g in api.list("PodGroup")}
    return {"pods": pods, "events": events, "pod_groups": pgs}


@pytest.mark.parametrize("host", [False, True], ids=["device-allocate", "host-allocate"])
def test_pipelined_matches_sync_and_the_jax_store(tmp_path, host):
    """Synchronous and pipelined, in both packages: the stores after
    three cycles are equal field for field, Event counts included."""
    digests = {}
    for pkg in (JAXP, PORTP):
        for mode, pipelined in (("sync", False), ("pipe", True)):
            cluster = MiniCluster(pkg, tmp_path, f"{mode}-{host}", pipelined=pipelined,
                                  host=host)
            try:
                cluster.submit_workload()
                for _ in range(3):
                    cluster.cycle()
                cluster.cache.flush()
                assert cluster.rebinds == []
                digests[(pkg.port, mode)] = store_digest(cluster.api)
            finally:
                cluster.close()
    first = digests[(False, "sync")]
    assert all(dg == first for dg in digests.values())
    assert sum(1 for v in first["pods"].values() if v[0]) == 5
    assert ("big-t0", "Warning", "Unschedulable") in first["events"]
    assert any(c and c[0][0] == "PodScheduled" for _n, _p, c in first["pods"].values())


@pytest.mark.parametrize("pkg", PKGS)
def test_cycle_binds_coalesce_into_one_frame(tmp_path, pkg):
    """A cycle's 5 binds travel as one commit frame, and the per-job
    status writebacks as one or two."""
    cluster = MiniCluster(pkg, tmp_path, "coalesce", pipelined=True)
    frames = []
    orig = cluster.client.commit_batch

    def counting(binds=(), evicts=(), events=(), conditions=(), pod_groups=()):
        frames.append({"binds": len(binds), "evicts": len(evicts), "events": len(events),
                       "conditions": len(conditions), "pod_groups": len(pod_groups)})
        return orig(binds=binds, evicts=evicts, events=events, conditions=conditions,
                    pod_groups=pod_groups)

    cluster.client.commit_batch = counting
    try:
        before = histogram_count(pkg, "volcano_bind_coalesce_size")
        cluster.submit_workload()
        cluster.cycle()
        cluster.cache.flush()
        assert max(f["binds"] for f in frames) == 5, frames
        status_frames = [f for f in frames if f["pod_groups"]]
        assert status_frames and len(status_frames) <= 2, frames
        assert histogram_count(pkg, "volcano_bind_coalesce_size") - before >= 1
    finally:
        cluster.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_commit_barrier_at_next_snapshot(tmp_path, pkg):
    """commit.delay keeps the queue non-empty after the cycle returns;
    the next snapshot's barrier drains it before new state is read."""
    cluster = MiniCluster(pkg, tmp_path, "barrier", pipelined=True)
    try:
        cluster.submit_workload()
        pkg.faults.configure("seed=3;commit.delay=1:ms=150")
        cluster.cycle()
        plane = cluster.cache._commit_plane
        cluster.cache.snapshot()  # the barrier
        pkg.faults.configure(None)
        assert plane.depth == 0
        assert len(cluster.placed()) == 5
        assert plane.last_barrier["busy_ms"] > 0
    finally:
        cluster.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_commit_fail_takes_resync_path_no_duplicates(tmp_path, pkg):
    """Doomed items (commit.fail) take the FailedScheduling Event and the
    resync path; the loop converges with no pod bound twice."""
    cluster = MiniCluster(pkg, tmp_path, "fail", pipelined=True)
    try:
        cluster.submit_workload()
        failures = counter(pkg, "volcano_commit_failures_total", kind="bind")
        pkg.faults.configure("seed=9;commit.fail=1:count=3")
        cluster.cycle()
        pkg.faults.configure(None)
        assert wait_for(lambda: (cluster.cycle() or True) and len(cluster.placed()) == 5,
                        timeout=30.0, interval=0.05)
        cluster.cache.flush()
        assert cluster.rebinds == []
        failed = [e for e in cluster.api.list("Event", "ns") if e.reason == "FailedScheduling"
                  and "fault-injected commit failure" in e.message]
        assert failed
        assert counter(pkg, "volcano_commit_failures_total", kind="bind") > failures
        assert not cluster.cache.err_tasks and not cluster.cache.quarantined_tasks
    finally:
        cluster.close()


def test_evict_through_commit_plane():
    """Evictions ride the plane too: the pod deleted from the store and
    the Evict Event recorded, as the synchronous path and the JAX
    package do."""
    results = []
    for pkg in (JAXP, PORTP):
        for pipelined in (False, True):
            api = pkg.api.APIServer()
            kube, vc = pkg.clients.KubeClient(api), pkg.clients.VolcanoClient(api)
            vc.create_queue(conv(pkg, named(build_queue("default"))))
            kube.create_node(conv(pkg, named(build_node("n0", {"cpu": "4", "memory": "16Gi"}))))
            vc.create_pod_group(conv(pkg, named(build_pod_group("ns", "v0", 1))))
            kube.create_pod(conv(pkg, named(build_pod(
                "ns", "v0-t0", "n0", {"cpu": "1", "memory": "1Gi"}, phase="Running",
                group="v0"))))
            cache = pkg.Cache(client=pkg.clients.SchedulerClient(api),
                              pipelined_commit=pipelined)
            try:
                cache.run()
                job = next(iter(cache.jobs.values()))
                cache.evict(next(iter(job.tasks.values())), "preempt")
                cache.flush()
                results.append((kube.get_pod("ns", "v0-t0") is None,
                                [(e.reason, e.message) for e in api.list("Event", "ns")]))
            finally:
                cache.stop_commit_plane()
    assert all(r == results[0] for r in results)
    assert results[0][0] is True
    assert ("Evict", "Evicted ns/v0-t0: preempt") in results[0][1]


@pytest.mark.parametrize("pkg", PKGS)
def test_overlap_metrics_exported(tmp_path, pkg):
    """The plane's series after a pipelined cycle: the queue depth, the
    coalesce histogram and the overlap ratio."""
    cluster = MiniCluster(pkg, tmp_path, "metrics", pipelined=True)
    try:
        cluster.submit_workload()
        cluster.cycle()
        cluster.cache.snapshot()
        rendered = render(pkg)
        assert "volcano_commit_queue_depth 0" in rendered
        assert "volcano_bind_coalesce_size_count" in rendered
        assert "volcano_commit_overlap_ratio" in rendered
    finally:
        cluster.close()


def test_plane_series_render_as_the_jax_registry():
    """The commit plane's and the resync's series, each written once in
    both registries, render line for line alike (buckets included)."""
    def written(reg, mod):
        mod.update_commit_queue_depth(3)
        mod.observe_bind_coalesce(4096)
        mod.observe_bind_coalesce(5)
        mod.update_commit_overlap_ratio(0.25)
        mod.observe_submit_to_bind(0.0421)
        mod.update_resync_quarantined(2)
        mod.register_commit_failure("status")
        names = ("commit_queue_depth", "bind_coalesce_size", "commit_overlap_ratio",
                 "submit_to_bind_latency", "resync_quarantined", "commit_failures")
        return [line for line in reg.render().splitlines() if any(n in line for n in names)]

    regs = (jax_registry._counters, jax_registry._gauges, jax_registry._histograms,
            metrics.registry._counters, metrics.registry._gauges, metrics.registry._hists)
    saved = [dict(r) for r in regs]
    try:
        for r in regs:
            r.clear()
        jax_lines = written(jax_registry, jax_metrics)
        port_lines = written(metrics.registry, metrics)
    finally:
        for r, kept in zip(regs, saved):
            r.clear()
            r.update(kept)
    assert port_lines == jax_lines
    assert 'volcano_bind_coalesce_size_bucket{le="4096"} 2' in port_lines


@pytest.mark.parametrize("pkg", PKGS)
def test_failed_status_writeback_counts_error_schedule_attempt(pkg):
    """With the plane on, a failed status writeback counts one
    ``schedule_attempts_total{result="error"}`` a job: on the frame path
    (two payloads, only the second's Event rows refused by the store),
    on the per-object path (an updater that fails) and for a doomed
    payload."""
    class DenyGhostEvents(pkg.api.APIServer):
        def create(self, obj):
            if obj.kind == "Event" and obj.involved_object.get("name") == "missing":
                raise pkg.api.AdmissionError("audit quota exceeded")
            return super().create(obj)

    def attempts():
        return counter(pkg, "volcano_schedule_attempts_total", result="error")

    def status_failures():
        return counter(pkg, "volcano_commit_failures_total", kind="status")

    live = pkg.new_task_info(conv(pkg, build_pod("ns", "present", "", {"cpu": "100m"},
                                                 group="pg-a")))
    ghost = pkg.new_task_info(conv(pkg, build_pod("ns", "missing", "", {"cpu": "100m"},
                                                  group="pg-b")))
    api = DenyGhostEvents()
    api.create(conv(pkg, build_pod("ns", "present", "", {"cpu": "100m"}, group="pg-a")))
    ok_payload = {"events": [(live, "Warning", "Unschedulable", "no fit")],
                  "conditions": [(live, "Unschedulable", "no fit")], "pod_group": None}
    bad_payload = {"events": [(ghost, "Warning", "Unschedulable", "no fit"),
                              (ghost, "Warning", "Unschedulable", "still none")],
                   "conditions": [(ghost, "Unschedulable", "no fit")], "pod_group": None}
    cache = pkg.Cache(client=pkg.clients.SchedulerClient(api), pipelined_commit=True)
    try:
        assert cache._fast_status
        err0, cf0 = attempts(), status_failures()
        cache._run_status_items([(ok_payload, None), (bad_payload, None)])
        assert status_failures() == cf0 + 2
        assert attempts() == err0 + 1
    finally:
        cache.stop_commit_plane()

    class FailingUpdater:
        def update_pod_condition(self, task, reason, message):
            raise RuntimeError("writeback rejected")

        def update_pod_group(self, pg):
            raise RuntimeError("writeback rejected")

    cache = pkg.Cache(status_updater=FailingUpdater(), pipelined_commit=True)
    try:
        assert not cache._fast_status
        err0 = attempts()
        cache._run_status_items([(dict(ok_payload), None)])
        assert attempts() == err0 + 1
        err0 = attempts()
        cache._run_status_items([(dict(ok_payload), RuntimeError("fault-injected"))])
        assert attempts() == err0 + 1
    finally:
        cache.stop_commit_plane()


# ---- resync and quarantine (tests/test_faults.py) ----


class FlakyClient:
    """get_pod fails ``fail_times`` times, then serves ``pod``."""

    def __init__(self, pod=None, fail_times=10**9):
        self.pod = pod
        self.fail_times = fail_times
        self.calls = 0

    def get_pod(self, namespace, name):
        self.calls += 1
        if self.calls <= self.fail_times:
            raise ConnectionError("apiserver unreachable")
        return self.pod

    def watch(self, cache):
        pass


def cache_with_bound_pod(pkg, client):
    pod = conv(pkg, build_pod("ns", "p0", "", {"cpu": "1", "memory": "1Gi"}, group="pg"))
    cache = pkg.Cache(binder=FakeBinder(), evictor=FakeEvictor(),
                      status_updater=FakeStatusUpdater())
    cache.add_node(conv(pkg, build_node("n0", {"cpu": "8", "memory": "16Gi"})))
    cache.add_pod(pod)
    cache.add_pod_group(conv(pkg, build_pod_group("ns", "pg", 1)))
    cache.add_queue(conv(pkg, build_queue("default")))
    cache.client = client
    task = next(iter(cache.jobs.values())).tasks[pod.metadata.uid]
    return cache, task, pod


def flaky_pod(pkg):
    return conv(pkg, build_pod("ns", "p0", "n0", {"cpu": "1", "memory": "1Gi"}, group="pg"))


@pytest.mark.parametrize("pkg", PKGS)
def test_resync_dedupe(pkg):
    cache, task, _ = cache_with_bound_pod(pkg, FlakyClient())
    cache._RESYNC_BACKOFF_BASE = 0.0
    cache.resync_task(task)
    cache.resync_task(task)
    assert len(cache.err_tasks) + (task.uid in cache.quarantined_tasks) == 1


@pytest.mark.parametrize("pkg", PKGS)
def test_resync_bounded_retries_then_quarantine(pkg):
    client = FlakyClient()
    cache, task, _ = cache_with_bound_pod(pkg, client)
    cache._RESYNC_BACKOFF_BASE = 0.0
    cache.resync_task(task)
    for _ in range(10):
        cache.process_due_resyncs()
    assert client.calls == cache._RESYNC_MAX_RETRIES
    assert task.uid in cache.quarantined_tasks and cache.err_tasks == []
    assert gauge(pkg, "volcano_resync_quarantined_tasks") >= 1.0
    cache.resync_task(task)
    assert cache.err_tasks == []


@pytest.mark.parametrize("pkg", PKGS)
def test_resync_fresh_truth_clears_quarantine(pkg):
    cache, task, pod = cache_with_bound_pod(pkg, FlakyClient())
    cache._RESYNC_BACKOFF_BASE = 0.0
    cache.resync_task(task)
    for _ in range(10):
        cache.process_due_resyncs()
    assert task.uid in cache.quarantined_tasks
    cache.update_pod(pod, pod)
    assert task.uid not in cache.quarantined_tasks
    assert gauge(pkg, "volcano_resync_quarantined_tasks") == 0.0


@pytest.mark.parametrize("pkg", PKGS)
def test_resync_quarantine_cooldown_reenters_the_queue(pkg):
    client = FlakyClient(pod=flaky_pod(pkg), fail_times=5)
    cache, task, _ = cache_with_bound_pod(pkg, client)
    cache._RESYNC_BACKOFF_BASE = 0.0
    cache._QUARANTINE_COOLDOWN = 0.05
    cache.resync_task(task)
    for _ in range(10):
        cache.process_due_resyncs()
    assert task.uid in cache.quarantined_tasks
    time.sleep(0.06)
    for _ in range(3):
        cache.process_due_resyncs()
    assert task.uid not in cache.quarantined_tasks
    assert cache.err_tasks == [] and client.calls == 6


@pytest.mark.parametrize("pkg", PKGS)
def test_resync_transient_failure_recovers_before_quarantine(pkg):
    client = FlakyClient(pod=flaky_pod(pkg), fail_times=2)
    cache, task, _ = cache_with_bound_pod(pkg, client)
    cache._RESYNC_BACKOFF_BASE = 0.0
    cache.resync_task(task)
    for _ in range(5):
        cache.process_due_resyncs()
    assert task.uid not in cache.quarantined_tasks
    assert cache.err_tasks == [] and client.calls == 3


@pytest.mark.parametrize("pkg", PKGS)
def test_injected_bind_failure_feeds_resync(pkg):
    cache, task, _ = cache_with_bound_pod(pkg, FlakyClient())
    cache.client = None  # keep the resync queued, not processed
    pkg.faults.configure("seed=1;cache.bind_fail=1:count=1")
    cache.bind(task, "n0")
    cache.flush()
    assert cache.binder.binds == {}
    assert len(cache.err_tasks) == 1


@pytest.mark.parametrize("pkg", PKGS)
def test_resync_marks_row_dirty_on_success(pkg):
    client = FlakyClient(pod=conv(pkg, build_pod("ns", "p0", "", {"cpu": "1", "memory": "1Gi"},
                                                 group="pg")), fail_times=0)
    cache, task, _ = cache_with_bound_pod(pkg, client)
    cache.resync_task(task)
    assert task.uid in cache._dirty_tasks


@pytest.mark.parametrize("pkg", PKGS)
def test_resync_emits_a_task_change(pkg):
    """The 19th change site: a resync that recovers API truth tells the
    listeners ``task`` (the unwound task is schedulable again)."""
    client = FlakyClient(pod=conv(pkg, build_pod("ns", "p0", "", {"cpu": "1", "memory": "1Gi"},
                                                 group="pg")), fail_times=0)
    cache, task, _ = cache_with_bound_pod(pkg, client)
    seen = []
    cache.add_change_listener(seen.append)
    cache.resync_task(task)
    assert seen == ["task"]


# ---- audit Events (tests/test_e2e.py, tests/test_explain.py) ----


def event_cluster(pkg, tmp_path, name, conf=CONF, node_cpu="8", nodes=3):
    cluster = MiniCluster.__new__(MiniCluster)
    cluster.pkg = pkg
    cluster.api = pkg.api.APIServer()
    cluster.kube = pkg.clients.KubeClient(cluster.api)
    cluster.vc = pkg.clients.VolcanoClient(cluster.api)
    cluster.vc.create_queue(conv(pkg, named(build_queue("default"))))
    for i in range(nodes):
        cluster.kube.create_node(conv(pkg, named(build_node(
            f"node-{i}", {"cpu": node_cpu, "memory": "16Gi"}))))
    cluster.bound, cluster.rebinds = {}, []
    cluster.client = pkg.clients.SchedulerClient(cluster.api)
    cluster.cache = pkg.Cache(client=cluster.client)
    path = tmp_path / f"{name}-{'port' if pkg.port else 'jax'}.conf"
    path.write_text(conf.format(allocate=pkg.allocate, preempt=pkg.preempt))
    cluster.scheduler = pkg.Scheduler(cluster.cache, scheduler_conf_path=str(path))
    cluster.cache.run()
    return cluster


def job(cluster, name, replicas, min_member, cpu="1", node="", phase="Pending",
        priority_class=""):
    group = build_pod_group("default", name, min_member, priority_class_name=priority_class)
    cluster.create(group)
    for i in range(replicas):
        cluster.create(build_pod("default", f"{name}-{i}", node, {"cpu": cpu, "memory": "1Gi"},
                                 phase=phase, group=name))


def events(cluster, reason):
    return [e for e in cluster.api.list("Event", "default") if e.reason == reason]


@pytest.mark.parametrize("pkg", PKGS)
def test_bind_records_scheduled_events(tmp_path, pkg):
    cluster = event_cluster(pkg, tmp_path, "scheduled")
    job(cluster, "e2e-job", 3, 3)
    cluster.cycle()
    scheduled = events(cluster, "Scheduled")
    assert len(scheduled) == 3
    assert all("Successfully assigned" in e.message and e.count == 1 for e in scheduled)
    assert {e.involved_object["name"] for e in scheduled} == {f"e2e-job-{i}" for i in range(3)}


@pytest.mark.parametrize("pkg", PKGS)
def test_gang_discard_records_unschedulable_events(tmp_path, pkg):
    cluster = event_cluster(pkg, tmp_path, "discard", node_cpu="2", nodes=1)
    job(cluster, "e2e-job", 4, 4)
    cluster.cycle()
    unsched = events(cluster, "Unschedulable")
    assert unsched and all(e.type == "Warning" for e in unsched)
    assert not events(cluster, "Scheduled")


@pytest.mark.parametrize("pkg", PKGS)
def test_preemption_records_evict_events(tmp_path, pkg):
    cluster = event_cluster(pkg, tmp_path, "preempt", conf=PREEMPT_CONF, node_cpu="2", nodes=1)
    cluster.api.create(pkg.core.PriorityClass(metadata=pkg.core.ObjectMeta(name="high"),
                                              value=1000))
    job(cluster, "low-job", 2, 1, node="node-0", phase="Running")
    job(cluster, "high-job", 1, 1, priority_class="high")
    for _ in range(3):
        cluster.cycle()
    evicts = events(cluster, "Evict")
    assert evicts and any("preempt" in e.message for e in evicts)
    assert all(e.involved_object["name"].startswith("low-job-") for e in evicts)


def test_evict_and_unschedulable_events_equal_the_jax_packages(tmp_path):
    """The preempting store cluster's Events and pods after three cycles:
    the port's equal the JAX package's."""
    digests = []
    for pkg in (JAXP, PORTP):
        cluster = event_cluster(pkg, tmp_path, "preempt-eq", conf=PREEMPT_CONF, node_cpu="2",
                                nodes=1)
        cluster.api.create(pkg.core.PriorityClass(metadata=pkg.core.ObjectMeta(name="high"),
                                                  value=1000))
        job(cluster, "low-job", 2, 1, node="node-0", phase="Running")
        job(cluster, "high-job", 1, 1, priority_class="high")
        for _ in range(3):
            cluster.cycle()
        digests.append(store_digest(cluster.api))
    assert digests[0] == digests[1]


@pytest.mark.parametrize("allocate", ["allocate", "device"])
@pytest.mark.parametrize("pkg", PKGS)
def test_one_unschedulable_event_and_condition_per_cycle(tmp_path, pkg, allocate):
    """A stuck task's writeback records one Unschedulable Event and one
    PodScheduled condition; a second identical cycle duplicates
    neither (``tests/test_explain.py``)."""
    name = pkg.allocate if allocate == "device" else "allocate"
    cluster = event_cluster(pkg, tmp_path, f"stuck-{allocate}",
                            conf=CONF.replace("enqueue, {allocate}", name), nodes=0)
    cluster.kube.create_node(conv(pkg, named(build_node(
        "n1", {"cpu": "8", "memory": "8Gi"},
        taints=[pkg.core.Taint(key="dedicated", value="x", effect="NoSchedule")]))))
    job(cluster, "pg1", 1, 1)
    for _ in range(2):
        cluster.cycle()
        unsched = events(cluster, "Unschedulable")
        assert len(unsched) == 1 and unsched[0].count == 1 and unsched[0].type == "Warning"
        pod = cluster.api.get("Pod", "default", "pg1-0")
        conds = [c for c in pod.status.conditions if c.type == "PodScheduled"]
        assert len(conds) == 1 and conds[0].status == "False"
        assert conds[0].reason == "Unschedulable" and conds[0].message == unsched[0].message


@pytest.mark.parametrize("pkg", PKGS)
def test_shadow_session_writes_nothing_to_the_store(tmp_path, pkg, monkeypatch):
    """A restricted micro-cycle through the store with its shadow full
    session: while the shadow runs, the store notifies no write of any
    kind, and the restricted session's binds land once each."""
    mod = subgraph if pkg.port else jax_subgraph
    cluster = MiniCluster(pkg, tmp_path, "shadow")
    cluster.scheduler = pkg.Scheduler(
        cluster.cache, scheduler_conf_path=cluster.scheduler.scheduler_conf_path,
        micro_cycles=True, restricted_sessions=True, shadow_every=1, shadow_strict=True)
    writes, in_shadow = [], [False]
    for kind in ("Pod", "Event", "PodGroup", "Queue", "Node", "PersistentVolumeClaim"):
        cluster.api.watch(kind, lambda ev, old, new, kind=kind: writes.append(
            (kind, ev)) if in_shadow[0] else None, send_initial=False)
    orig = mod.run_shadow_session

    def shadow(*args, **kwargs):
        in_shadow[0] = True
        try:
            return orig(*args, **kwargs)
        finally:
            in_shadow[0] = False

    monkeypatch.setattr(mod, "run_shadow_session", shadow)
    register = (metrics if pkg.port else jax_metrics).register_full_cycle_fallback
    try:
        cluster.submit_workload()
        # the gangs' arrival routes the first wake to a full cycle
        assert chip_smoke.micro_window(cluster.scheduler, register) == "full"
        cluster.create(build_pod_group("ns", "late", 1))
        cluster.create(build_pod("ns", "late-t0", "", {"cpu": "1", "memory": "1Gi"},
                                 group="late"))
        route = chip_smoke.micro_window(cluster.scheduler, register)
        assert route not in (None, "full")
        assert cluster.scheduler.shadow_checks_run == 1
        assert cluster.scheduler.shadow_divergences == 0
        assert writes == []
        assert cluster.placed().get("ns/late-t0") and cluster.rebinds == []
        scheduled = [e for e in cluster.api.list("Event", "ns") if e.reason == "Scheduled"]
        assert len(scheduled) == 6 and all(e.count == 1 for e in scheduled)
    finally:
        cluster.close()


def test_change_categories_through_the_store_equal_the_jax_caches(tmp_path):
    """The categories each cache tells its listeners while it fills from
    the store's watch, commits a cycle through it (its own bind echoes
    and status writebacks silent) and takes a late arrival, in both
    commit modes: the port's equal the JAX package's, in order."""
    seen = {}
    for pkg in (JAXP, PORTP):
        for pipelined in (False, True):
            cluster = MiniCluster(pkg, tmp_path, f"categories-{pipelined}", pipelined=pipelined)
            got = []
            cluster.cache.add_change_listener(got.append)
            try:
                cluster.submit_workload()
                cluster.cycle()
                cluster.cache.flush()
                echoes = len(got)
                cluster.create(build_pod_group("ns", "late", 1))
                cluster.create(build_pod("ns", "late-t0", "", {"cpu": "1", "memory": "1Gi"},
                                         group="late"))
            finally:
                cluster.close()
            seen[(pkg.port, pipelined)] = (got, echoes)
    first = seen[(False, False)]
    assert all(v == first for v in seen.values())
    got, echoes = first
    assert got[echoes:] == ["group", "task"] and "task" in got[:echoes]


class FrameRecorder:
    """A cache stand-in for a bare commit plane: records the size of each
    bind frame a worker lands."""

    def __init__(self):
        self.frames = []

    def _run_bind_items(self, items, inject=True):
        self.frames.append(len(items))


@pytest.mark.parametrize("pkg", PKGS)
def test_frames_are_capped_at_max_coalesce(pkg):
    """Binds queued in one submit drain as frames of at most
    ``_MAX_COALESCE`` (4,096) items, in both packages: 5,000 binds land
    as one full frame and the remainder."""
    module = commit_plane if pkg.port else jax_commit_plane
    assert module._MAX_COALESCE == 4096
    cache = FrameRecorder()
    plane = module.CommitPlane(cache)
    try:
        plane.submit_binds([(i, "n0") for i in range(5000)])
        assert plane.barrier(timeout=10.0)
    finally:
        plane.stop()
    assert sorted(cache.frames) == [904, 4096] and plane.depth == 0
