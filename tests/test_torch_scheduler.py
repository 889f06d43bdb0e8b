"""The port's scheduler loop against the JAX package's, on the CPU.

Both packages' ``Scheduler`` read the same policy document (the
allocate action named ``gpu-allocate`` for the port, ``jax-allocate``
for the JAX package) and run cycle after cycle on one cache each, in the
fixed-period mode, over the same churn script at the shapes of
``tests/test_micro_cycle.py``'s ``MicroCluster`` (6 nodes of 8 cpu,
labelled by slot): gangs arrive, finish, a node is relabelled and a
burst crosses the 64-row task bucket.  The store's events cross
packages as dicts.  Every comparison is exact: the binds in order, cycle
by cycle, and the warm packer's verdict (mode, cold cause, rows reused,
nodes repacked).

Beside them: ``run(cycles=)``, ``stop()`` interrupting the period's
wait, a failing ``post_cycle`` hook, the policy's reload by mtime, the
default policy against the reference's parse, ``gc_quiesce_period``,
and a cycle whose kernel fails or whose deadline runs out: the session
closes, nothing is bound, the exception leaves ``run_once``, and the
next cycle on the same cache binds what the JAX loop binds.

Then ``chip_smoke.py``'s revert and preempt loop cells through the
port's loop at 10k pods x 1k nodes: the cycle digests of
``chip_smoke.CYCLE_DIGESTS`` and ``PREEMPT_CYCLE_DIGESTS``.

The port's loop runs its device actions on the CPU the way a caller
asks for it: the ``cpu_actions`` fixture registers
``GpuAllocateAction(device="cpu")`` and ``GpuPreemptAction(device="cpu")``
under their names for the test and restores the registry's instances
after.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time

import pytest
import torch
import yaml

import chip_smoke
import volcano_tpu.actions  # noqa: F401 — registers the JAX package's actions
import volcano_tpu.plugins  # noqa: F401 — registers its plugin builders
from volcano_tpu import conf as jax_conf
from volcano_tpu.actions import jax_allocate
from volcano_tpu.apis import serde as jax_serde
from volcano_tpu.cache import SchedulerCache as JaxCache
from volcano_tpu.ops import executor as jax_executor
from volcano_tpu.scheduler.scheduler import Scheduler as JaxScheduler
from volcano_tpu_torch import conf, faults, metrics
from volcano_tpu_torch.actions import gpu_allocate, gpu_preempt
from volcano_tpu_torch.cache import feed_events, SchedulerCache
from volcano_tpu_torch.faults import watchdog
from volcano_tpu_torch.faults.watchdog import CycleDeadlineExceeded
from volcano_tpu_torch.framework import get_action, register_action
from volcano_tpu_torch.ops import dispatch
from volcano_tpu_torch.ops.dispatch import ExecutorFailed
from volcano_tpu_torch.scheduler import scheduler as port_scheduler
from volcano_tpu_torch.scheduler.scheduler import Scheduler

from tests.builders import build_node, build_pod, build_pod_group, build_queue
from tests.fakes import FakeStatusUpdater
from tests.test_torch_pack_cache import jax_feed_events


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: one intra-op thread is as fast, and keeps
    the suite's parallel workers from contending for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def cpu_actions():
    """The port's device actions on the CPU for this test: registered
    under their names, the registry's instances restored after."""
    saved = [get_action(n) for n in ("gpu-allocate", "gpu-preempt")]
    register_action(gpu_allocate.GpuAllocateAction(device="cpu"))
    register_action(gpu_preempt.GpuPreemptAction(device="cpu"))
    yield
    for action in saved:
        register_action(action)


#: the policy both loops read; {allocate} is each package's action name
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


class ListBinder:
    """Records ``(ns/name, hostname)`` in the order binds arrive."""

    def __init__(self):
        self.binds = []

    def bind(self, task, hostname):
        self.binds.append((f"{task.namespace}/{task.name}", hostname))


def _d(obj) -> dict:
    return jax_serde.to_dict(obj)


class Store:
    """The store both loops watch: its objects as dicts and the events
    of each step, built with the JAX package's builders."""

    def __init__(self):
        self.pods = {}
        self.nodes = {}

    def start(self) -> list:
        events = [{"op": "add", "kind": "queue", "object": _d(build_queue("default"))}]
        for i in range(6):
            node = _d(build_node(f"n{i}", {"cpu": "8", "memory": "64Gi"},
                                 labels={"slot": f"s{i}"}))
            self.nodes[f"n{i}"] = node
            events.append({"op": "add", "kind": "node", "object": node})
        return events

    def submit(self, name, replicas=1, cpu="1", gang=False, selector=None) -> list:
        events = [{"op": "add", "kind": "pod_group", "object": _d(build_pod_group(
            "ns", name, replicas if gang else 1, queue="default"))}]
        for i in range(replicas):
            pod = _d(build_pod("ns", f"{name}-t{i}", "", {"cpu": cpu, "memory": "1Gi"},
                               group=name, selector=selector))
            self.pods[f"ns/{name}-t{i}"] = pod
            events.append({"op": "add", "kind": "pod", "object": pod})
        return events

    def bound(self, binds) -> None:
        for name, host in binds:
            self.pods[name]["spec"]["nodeName"] = host
            self.pods[name].setdefault("status", {})["phase"] = "Running"

    def finish(self, *names) -> list:
        return [{"op": "delete", "kind": "pod", "object": self.pods.pop(f"ns/{n}")}
                for n in names]

    def relabel(self, node: str, key: str, value: str) -> list:
        old = self.nodes[node]
        new = json.loads(json.dumps(old))
        new["metadata"].setdefault("labels", {})[key] = value
        self.nodes[node] = new
        return [{"op": "update", "kind": "node", "old": old, "object": new}]


def churn_script(store: Store):
    """The events before each cycle: a generator, so each step can
    depend on the binds recorded in the store."""
    yield store.start() + store.submit("a", 3, "1") + store.submit("b", 2, "2")
    yield store.submit("c", 4, "1") + store.submit("d", 1, "500m")
    yield (store.finish("a-t0", "a-t1") + store.relabel("n2", "rack", "r1")
           + store.submit("e", 3, "2", gang=True, selector={"rack": "r1"}))
    burst = []
    for k in range(35):
        burst += store.submit(f"m{k}", 2, "250m")
    yield burst
    yield store.submit("f", 2, "4", gang=True)
    yield []


class Loop:
    """One package's loop over a cache fed from dicts."""

    def __init__(self, port: bool, tmp_path, snapshot_reuse=False, **kwargs):
        self.port = port
        name = "gpu-allocate" if port else "jax-allocate"
        path = tmp_path / f"{name}.conf"
        path.write_text(CONF.format(allocate=name))
        if port:
            self.cache = SchedulerCache(binder=ListBinder(), status_updater=FakeStatusUpdater(),
                                        snapshot_reuse=snapshot_reuse)
            self.scheduler = Scheduler(self.cache, scheduler_conf_path=str(path), **kwargs)
        else:
            self.cache = JaxCache(binder=ListBinder(), status_updater=FakeStatusUpdater(),
                                  snapshot_reuse=snapshot_reuse)
            self.scheduler = JaxScheduler(self.cache, scheduler_conf_path=str(path), **kwargs)

    def feed(self, events) -> None:
        (feed_events if self.port else jax_feed_events)(self.cache, events)

    def cycle(self):
        """One run_once; (the cycle's binds, the warm packer's verdict)."""
        n = len(self.cache.binder.binds)
        self.scheduler.run_once()
        stats = (get_action("gpu-allocate").last_phase_stats if self.port
                 else jax_allocate.last_phase_stats)
        return self.cache.binder.binds[n:], {k: stats.get(k) for k in (
            "mode", "cold_cause", "reused_tasks", "repacked_nodes", "repacked_tasks")}


@pytest.mark.parametrize("snapshot_reuse", [False, True])
def test_loop_binds_match_jax(tmp_path, snapshot_reuse):
    """Cycle by cycle, the port's loop binds what the JAX package's binds,
    in order, with the same warm-pack verdicts; with snapshot reuse the
    pool hands sessions clones, and the binds do not change."""
    port = Loop(True, tmp_path, snapshot_reuse)
    ref = Loop(False, tmp_path, snapshot_reuse)
    store = Store()
    modes, reused = [], 0
    for k, events in enumerate(churn_script(store)):
        port.feed(events)
        ref.feed(events)
        binds, stats = port.cycle()
        want, want_stats = ref.cycle()
        assert binds == want, f"cycle {k}"
        assert stats == want_stats, f"cycle {k}"
        store.bound(binds)
        modes.append(stats["mode"])
        reused += sum(port.cache.last_pool_reuse)
    assert modes == ["cold", "warm", "warm", "micro", "micro", "warm"]
    assert (reused > 0) == snapshot_reuse
    assert len(port.cache.binder.binds) > 20


def test_snapshot_reuse_binds_equal_plain_cloning(tmp_path):
    """The same script on two port caches, one with the clone pool and
    one cloning every object: equal binds every cycle."""
    pooled, plain = Loop(True, tmp_path, True), Loop(True, tmp_path, False)
    store = Store()
    for k, events in enumerate(churn_script(store)):
        pooled.feed(events)
        plain.feed(events)
        binds, _ = pooled.cycle()
        assert plain.cycle()[0] == binds, f"cycle {k}"
        store.bound(binds)


def _fail_executor(monkeypatch):
    """The kernel fails (an injected lowering failure on the cuda
    executor): ExecutorFailed."""
    monkeypatch.setattr(dispatch, "select_executor",
                        lambda snap, weights=None, device=None: "cuda")
    faults.configure("seed=1;device.lowering=1:count=1")


def _expire_deadline(monkeypatch):
    """A 1 ms cycle deadline, spent before the device phase starts."""
    watchdog.configure_deadline(1.0)
    real = gpu_allocate.compute_task_order

    def slow_order(ssn):
        time.sleep(0.01)
        return real(ssn)

    monkeypatch.setattr(gpu_allocate, "compute_task_order", slow_order)


@pytest.mark.parametrize("failure,exc", [(_fail_executor, ExecutorFailed),
                                         (_expire_deadline, CycleDeadlineExceeded)])
def test_failed_cycle_binds_nothing_and_the_next_matches(tmp_path, monkeypatch, failure, exc):
    """Cycle 2 fails in gpu-allocate (its kernel, or its deadline): the
    exception leaves run_once, the session is closed (its clones are
    back in the pool), nothing is bound; the JAX loop's cycle 2 fails
    too (its executor raises).  Cycle 3 on the same caches binds alike,
    with the same warm-pack verdict."""
    port = Loop(True, tmp_path, snapshot_reuse=True)
    ref = Loop(False, tmp_path, snapshot_reuse=True)
    store = Store()
    script = churn_script(store)
    for k in range(2):
        events = next(script)
        port.feed(events)
        ref.feed(events)
        binds, _ = port.cycle()
        assert binds == ref.cycle()[0]
        store.bound(binds)
    events = next(script)
    port.feed(events)
    ref.feed(events)
    bound = len(port.cache.binder.binds)
    with monkeypatch.context() as m:
        failure(m)
        try:
            with pytest.raises(exc):
                port.scheduler.run_once()
        finally:
            faults.configure(None)
            faults.reset_breakers()
            watchdog.configure_deadline(None)

        def refuse(*args, **kwargs):
            raise RuntimeError("the executor failed")

        m.setattr(jax_executor, "execute_allocate", refuse)
        with pytest.raises(RuntimeError, match="executor failed"):
            ref.scheduler.run_once()
    for loop in (port, ref):
        assert loop.cache._pool_open is False  # close_session released the clones
        assert len(loop.cache.binder.binds) == bound
    binds, stats = port.cycle()
    want, want_stats = ref.cycle()
    assert binds == want and binds
    assert stats == want_stats


def test_run_counts_cycles_and_stop_interrupts_the_wait(tmp_path):
    loop = Loop(True, tmp_path, period=0.0)
    loop.feed(next(churn_script(Store())))
    loop.scheduler.run(cycles=3)
    assert loop.scheduler.full_cycles_run == 3
    assert loop.scheduler.sessions_opened == 3
    assert len(loop.cache.binder.binds) == 5

    slow = Loop(True, tmp_path, period=30.0)
    thread = threading.Thread(target=slow.scheduler.run, daemon=True)
    t0 = time.monotonic()
    thread.start()
    deadline = time.monotonic() + 30
    while slow.scheduler.full_cycles_run < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    slow.scheduler.stop()
    thread.join(timeout=10)
    assert not thread.is_alive()
    assert time.monotonic() - t0 < 15
    assert slow.scheduler.full_cycles_run == 1


def test_post_cycle_exception_is_logged_and_the_loop_goes_on(tmp_path, caplog):
    loop = Loop(True, tmp_path, period=0.0)
    calls = []

    def hook():
        calls.append(1)
        raise ValueError("hook broke")

    loop.scheduler.post_cycle = hook
    with caplog.at_level(logging.ERROR):
        loop.scheduler.run(cycles=3)
    assert len(calls) == 3 and loop.scheduler.full_cycles_run == 3
    assert "post-cycle hook failed: hook broke" in caplog.text


def test_conf_reloads_by_mtime(tmp_path):
    path = tmp_path / "policy.conf"
    path.write_text(CONF.format(allocate="gpu-allocate"))
    cache = SchedulerCache(binder=ListBinder())
    sched = Scheduler(cache, scheduler_conf_path=str(path))
    first = sched._load_conf()
    assert first.actions == ["enqueue", "gpu-allocate"]
    assert sched._load_conf() is first  # unchanged file: no parse
    path.write_text(CONF.format(allocate="allocate"))
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000_000))
    second = sched._load_conf()
    assert second is not first and second.actions == ["enqueue", "allocate"]
    # a policy that does not parse, or is gone, raises out of the cycle
    # (the reference switches to its default policy there)
    path.write_text("actions: [unclosed")
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 2_000_000_000))
    with pytest.raises(yaml.YAMLError):
        sched._load_conf()
    with pytest.raises(yaml.YAMLError):
        sched.run_once()
    assert sched.sessions_opened == 0 and cache.binder.binds == []
    path.unlink()
    with pytest.raises(FileNotFoundError):
        sched._load_conf()
    # no path: the port's default policy, on the device action
    assert Scheduler(SchedulerCache())._load_conf().actions == \
        ["enqueue", "gpu-allocate", "backfill"]


#: the reference's action names → the port's
PORT_ACTION = {"allocate": "gpu-allocate", "jax-allocate": "gpu-allocate",
               "preempt": "gpu-preempt", "jax-preempt": "gpu-preempt"}


def test_default_conf_equals_the_references_parse():
    want = dataclasses.asdict(jax_conf.default_scheduler_conf())
    want["actions"] = [PORT_ACTION.get(a, a) for a in want["actions"]]
    assert dataclasses.asdict(conf.default_scheduler_conf()) == want
    assert want["actions"] == ["enqueue", "gpu-allocate", "backfill"]
    text = """
actions: "enqueue, allocate, preempt"
tiers:
- plugins:
  - name: priority
    enableJobOrder: false
  - name: drf
    arguments:
      drf.weight: 2
configurations:
- name: enqueue
  arguments:
    overcommit-factor: "1.5"
"""
    assert dataclasses.asdict(conf.load_scheduler_conf(text)) == \
        dataclasses.asdict(jax_conf.load_scheduler_conf(text))


def test_gc_quiesce_period_and_cycle_metrics(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(port_scheduler, "gc_quiesce", lambda: calls.append(1))
    loop = Loop(True, tmp_path, period=0.0, gc_quiesce_period=2)
    e2e0 = metrics.registry.histogram("volcano_e2e_scheduling_latency_milliseconds")[0]
    full0 = metrics.registry.counter("volcano_session_scope_total", mode="full")
    act0 = metrics.registry.histogram("volcano_action_scheduling_latency_microseconds",
                                      action="gpu-allocate")[0]
    loop.scheduler.run(cycles=5)
    assert len(calls) == 2
    assert metrics.registry.histogram("volcano_e2e_scheduling_latency_milliseconds")[0] \
        == e2e0 + 5
    assert metrics.registry.counter("volcano_session_scope_total", mode="full") == full0 + 5
    assert metrics.registry.histogram("volcano_action_scheduling_latency_microseconds",
                                      action="gpu-allocate")[0] == act0 + 5
    assert set(loop.scheduler.last_cycle) == {"actions_s", "open_s", "close_s", "e2e_s"}
    assert list(loop.scheduler.last_cycle["actions_s"]) == ["enqueue", "gpu-allocate"]


# ---- chip_smoke.py's other loop cells, on the CPU ----


def test_port_revert_loop_on_cpu():
    """The revert cell's events at 10k pods x 1k nodes on the CPU: every
    cycle binds every pod with the cycle digest, and every cycle after
    the first packs warm with every task row reused."""
    config = chip_smoke.SECOND_CONFIG
    spec = chip_smoke.LOOP_CELLS[chip_smoke.LOOP_A]
    recs = list(chip_smoke.loop_cycles(chip_smoke.loop_objects(config), spec["tiers"],
                                       spec["actions"], 3, "revert"))
    for rec in recs:
        assert chip_smoke.cycle_digest(rec["binds"]) == chip_smoke.CYCLE_DIGESTS[config]
    for rec in recs[1:]:
        ph = rec["phases"]
        assert ph["mode"] == "warm" and ph["reused_tasks"] == 10_000 and "cold_cause" not in ph


def test_port_preempt_loop_on_cpu():
    """The preempt cell through the loop on the CPU: the preempting
    cycle's digest of (evictions, pipelined)."""
    name = chip_smoke.LOOP_C
    spec = chip_smoke.LOOP_CELLS[name]
    (rec,) = chip_smoke.loop_cycles(chip_smoke.loop_objects(spec["config"]), spec["tiers"],
                                    spec["actions"], spec["cycles"], spec["between"])
    assert get_action("gpu-preempt").last_route == "device"
    digest = chip_smoke.preempt_cycle_digest(rec["evicted"], rec["pipelined"])
    assert digest == chip_smoke.PREEMPT_CYCLE_DIGESTS[spec["config"]]
