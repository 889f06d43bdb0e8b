"""The port's event-driven loop against the JAX package's, on the CPU.

The cache's change categories: for every event handler, the categories
the port's ``SchedulerCache`` tells its listeners equal, in order, the
ones the JAX package's cache tells its own for the same objects (carried
across as dicts), each emitted with the cache mutex released; and the
classification table of ``_classify_pod_update``.

The cases of ``tests/test_micro_cycle.py`` that run in-process: a
micro-cycle binds what a full cycle binds over the same store states
(and what the JAX package's micro-cycle binds); a recorded micro-cycle
replays with zero diff; the event wake binds long before the period
ends; the debounce coalesces an event storm; the plain-mode sleep is
interruptible; gang arrival and a node-set change route to full cycles
with their cause counted; a registry overflow during a micro-cycle is
attributed to its cold cause.  Beside them: the new series render as
the JAX registry renders them, and ``micro_cycles=True`` on a cache
without change listeners raises ``TypeError`` (the reference leaves
such a loop periodic).

The port's loop runs gpu-allocate on the CPU (``cpu_actions``).  Every
thread a test starts is stopped and joined with a timeout, and every
wait is bounded.
"""

from __future__ import annotations

import threading
import time

import pytest

import chip_smoke
import volcano_tpu.actions  # noqa: F401 — registers the JAX package's actions
import volcano_tpu.plugins  # noqa: F401 — registers its plugin builders
from volcano_tpu.api import new_task_info as jax_new_task_info
from volcano_tpu.apis import core as jax_core, scheduling as jax_scheduling
from volcano_tpu.cache import SchedulerCache as JaxCache
from volcano_tpu.metrics import metrics as jax_metrics
from volcano_tpu_torch import metrics, trace
from volcano_tpu_torch.api import new_task_info
from volcano_tpu_torch.apis import core, scheduling
from volcano_tpu_torch.cache import feed_events, SchedulerCache
from volcano_tpu_torch.cache.cache import _task_pack_relevant_changed
from volcano_tpu_torch.scheduler.scheduler import Scheduler

from tests.builders import (
    build_node,
    build_pod,
    build_pod_group,
    build_priority_class,
    build_queue,
)
from tests.test_torch_incremental import (  # noqa: F401 — fixtures
    _copy,
    _d,
    Cluster,
    cpu_actions,
    one_torch_thread,
    Store,
    wait_for,
)
from tests.test_torch_pack_cache import jax_feed_events


@pytest.fixture(autouse=True)
def _no_trace():
    yield
    trace.disable()


# ---- change categories, handler by handler ----

#: handler suffix → (the port's API type, the JAX package's)
KINDS = {
    "pod": (core.Pod, jax_core.Pod),
    "node": (core.Node, jax_core.Node),
    "pod_group": (scheduling.PodGroup, jax_scheduling.PodGroup),
    "queue": (scheduling.Queue, jax_scheduling.Queue),
    "priority_class": (core.PriorityClass, jax_core.PriorityClass),
    "pvc": (core.PersistentVolumeClaim, jax_core.PersistentVolumeClaim),
}


def deliver(cache, port: bool, op: tuple) -> None:
    """One handler call: ``(handler, dict)``, ``(handler, old | None,
    new)`` for an update, or a resource-quota handler's arguments."""
    handler, *args = op
    if handler.endswith("resource_quota"):
        getattr(cache, handler)(*args)
        return
    cls = KINDS[handler.split("_", 1)[1]][0 if port else 1]
    getattr(cache, handler)(*(None if a is None else cls.from_dict(a) for a in args))


def new_cache(port: bool):
    """A cache of the port or of the JAX package, binding into a list."""
    return (SchedulerCache if port else JaxCache)(binder=chip_smoke.ListBinder())


def pod(name="p", node="", phase="Pending", cpu="1", group="g", labels=None) -> dict:
    return _d(build_pod("ns", name, node, {"cpu": cpu, "memory": "1Gi"}, phase=phase,
                        group=group, labels=labels))


def edited(d: dict, **paths) -> dict:
    """A copy of ``d`` with ``a__b=v`` setting ``d[a][b] = v``."""
    out = _copy(d)
    for path, value in paths.items():
        *keys, last = path.split("__")
        node = out
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = value
    return out


def pvc(name="c", phase="Pending", rv=0) -> dict:
    return {"metadata": {"name": name, "namespace": "ns", "resourceVersion": rv},
            "spec": {"storageClassName": "fast"}, "status": {"phase": phase}}


NODE = _d(build_node("n0", {"cpu": "8", "memory": "64Gi"}))
PENDING = pod()
BOUND = edited(PENDING, spec__nodeName="n0", status__phase="Running")
GROUP = _d(build_pod_group("ns", "g", 1))
GANG = _d(build_pod_group("ns", "gang", 3))
QUEUE = _d(build_queue("default"))
PC = _d(build_priority_class("high", 100))
BASE = [("add_queue", QUEUE), ("add_node", NODE), ("add_pod_group", GROUP)]

#: (setup ops, recorded ops, the categories both caches emit)
HANDLER_CASES = {
    "add_pod-pending": ([], [("add_pod", PENDING)], ["task"]),
    "add_pod-bound": ([], [("add_pod", BOUND)], []),
    "add_pod-succeeded": ([], [("add_pod", pod(phase="Succeeded"))], []),
    "update_pod-bind-echo": ([("add_pod", PENDING)], [("update_pod", PENDING, BOUND)], []),
    "update_pod-spec": ([("add_pod", PENDING)],
                        [("update_pod", PENDING, pod(cpu="2"))], ["task"]),
    "update_pod-labels": ([("add_pod", PENDING)],
                          [("update_pod", PENDING, pod(labels={"a": "b"}))], ["task"]),
    "update_pod-finished": ([("add_pod", BOUND)],
                            [("update_pod", BOUND, edited(BOUND, status__phase="Succeeded"))],
                            ["node"]),
    "update_pod-back-to-pending": ([("add_pod", BOUND)], [("update_pod", BOUND, PENDING)],
                                   ["task"]),
    "update_pod-status-only": ([("add_pod", PENDING)],
                               [("update_pod", PENDING, edited(PENDING,
                                                               metadata__resourceVersion=7))],
                               []),
    "delete_pod-bound": ([("add_pod", BOUND)], [("delete_pod", BOUND)], ["node"]),
    "delete_pod-pending": ([("add_pod", PENDING)], [("delete_pod", PENDING)], []),
    "add_node-fresh": ([], [("add_node", _d(build_node("n9", {"cpu": "8"})))], ["topology"]),
    "add_node-known": ([], [("add_node", NODE)], ["node"]),
    "update_node-known": ([], [("update_node", NODE, edited(NODE, metadata__labels={"x": "y"}))],
                          ["node"]),
    "update_node-fresh": ([], [("update_node", None, _d(build_node("n8", {"cpu": "8"})))],
                          ["topology"]),
    "delete_node-known": ([], [("delete_node", NODE)], ["topology"]),
    "delete_node-unknown": ([], [("delete_node", _d(build_node("n7", {"cpu": "8"})))], []),
    "add_pod_group-gang": ([], [("add_pod_group", GANG)], ["gang"]),
    "add_pod_group-single": ([], [("add_pod_group", _d(build_pod_group("ns", "s", 1)))],
                             ["group"]),
    "update_pod_group-spec": ([], [("update_pod_group", GROUP, edited(GROUP, spec__minMember=2))],
                              ["group"]),
    "update_pod_group-status-echo": ([], [("update_pod_group", GROUP,
                                           edited(GROUP, status__phase="Running"))], []),
    "update_pod_group-no-old": ([], [("update_pod_group", None, GROUP)], ["group"]),
    "delete_pod_group": ([("add_pod", PENDING)], [("delete_pod_group", GROUP)], ["group"]),
    "add_queue": ([], [("add_queue", _d(build_queue("q2")))], ["group"]),
    "update_queue-spec": ([], [("update_queue", QUEUE, edited(QUEUE, spec__weight=3))],
                          ["group"]),
    "update_queue-status-echo": ([], [("update_queue", QUEUE,
                                       edited(QUEUE, status__state="Open"))], []),
    "update_queue-no-old": ([], [("update_queue", None, QUEUE)], ["group"]),
    "delete_queue": ([], [("delete_queue", QUEUE)], ["group"]),
    "add_priority_class": ([], [("add_priority_class", PC)], ["group"]),
    "delete_priority_class": ([("add_priority_class", PC)], [("delete_priority_class", PC)],
                              ["group"]),
    "add_pvc": ([], [("add_pvc", pvc())], ["group"]),
    "update_pvc-echo": ([("add_pvc", pvc(phase="Bound"))],
                        [("update_pvc", pvc(phase="Bound"), pvc(phase="Bound", rv=9))], []),
    "update_pvc-change": ([("add_pvc", pvc())], [("update_pvc", pvc(), pvc(phase="Bound"))],
                          ["group"]),
    "delete_pvc": ([("add_pvc", pvc())], [("delete_pvc", pvc())], ["group"]),
    "add_resource_quota": ([], [("add_resource_quota", "ns", "rq", 3)], ["group"]),
    "delete_resource_quota": ([("add_resource_quota", "ns", "rq", 3)],
                              [("delete_resource_quota", "ns", "rq")], ["group"]),
}


def categories(port: bool, setup, ops) -> list:
    """The categories a fresh cache tells its listener for ``ops``,
    after ``setup``; the port's listener also checks the cache mutex is
    not held while it runs."""
    cache = new_cache(port)
    for op in BASE + list(setup):
        deliver(cache, port, op)
    seen = []

    def listener(category):
        if port:
            assert not cache._mutex._is_owned(), "listener called under the cache mutex"
        seen.append(category)

    cache.add_change_listener(listener)
    cache.add_change_listener(listener)  # registered once
    for op in ops:
        deliver(cache, port, op)
    cache.remove_change_listener(listener)
    deliver(cache, port, ("add_resource_quota", "ns", "after", 1))
    return seen


@pytest.mark.parametrize("case", sorted(HANDLER_CASES))
def test_handler_categories_equal_the_jax_caches(case):
    setup, ops, want = HANDLER_CASES[case]
    got = categories(True, setup, ops)
    assert got == categories(False, setup, ops)
    assert got == want


def test_a_stream_of_handlers_emits_the_jax_sequence():
    """Every case's setup and ops in one stream on one cache of each
    package: the same categories in the same order."""
    ops = [op for name in sorted(HANDLER_CASES) for op in
           HANDLER_CASES[name][0] + HANDLER_CASES[name][1]]
    got = categories(True, [], ops)
    assert got == categories(False, [], ops)
    assert len(got) > 30 and set(got) == {"task", "node", "topology", "gang", "group"}


def test_a_failing_listener_does_not_break_delivery(caplog):
    cache = SchedulerCache(binder=chip_smoke.ListBinder())
    seen = []

    def broken(category):
        raise RuntimeError("listener broke")

    cache.add_change_listener(broken)
    cache.add_change_listener(seen.append)
    deliver(cache, True, ("add_queue", QUEUE))
    assert seen == ["group"] and "cache change listener failed" in caplog.text
    assert "default" in cache.queues


#: (old pod, new pod, spec changed) → the category of the update
CLASSIFY = [
    (PENDING, BOUND, False, None),
    (PENDING, BOUND, True, "task"),
    (BOUND, edited(BOUND, status__phase="Succeeded"), False, "node"),
    (BOUND, edited(BOUND, status__phase="Failed"), False, "node"),
    (edited(BOUND, status__phase="Succeeded"), edited(BOUND, status__phase="Failed"), False,
     None),
    (BOUND, PENDING, False, "task"),
    (PENDING, PENDING, False, None),
    (BOUND, BOUND, False, None),
    (PENDING, edited(PENDING, status__phase="Running"), False, None),
    (edited(PENDING, status__phase="Succeeded"), PENDING, False, "task"),
]


@pytest.mark.parametrize("row", range(len(CLASSIFY)))
def test_classify_pod_update_table(row):
    old, new, spec_changed, want = CLASSIFY[row]
    got = SchedulerCache._classify_pod_update(
        new_task_info(core.Pod.from_dict(old)), new_task_info(core.Pod.from_dict(new)),
        spec_changed)
    assert got == JaxCache._classify_pod_update(
        jax_new_task_info(jax_core.Pod.from_dict(old)),
        jax_new_task_info(jax_core.Pod.from_dict(new)), spec_changed)
    assert got == want
    if not spec_changed:
        assert _task_pack_relevant_changed(core.Pod.from_dict(old),
                                           core.Pod.from_dict(new)) is False


def test_ledger_counts_equal_the_jax_caches():
    store = Store()
    events = store.start() + store.submit("a", 3, gang=True) + store.submit("b", 1)
    events += store.echo([("ns/a-t0", "n0")])
    views = []
    for port in (True, False):
        cache = new_cache(port)
        (feed_events if port else jax_feed_events)(cache, events)
        views.append((cache.ledger_counts(), cache.has_schedulable_pending()))
    assert views[0] == views[1] == ((2, 2), True)


# ---- micro-cycles (tests/test_micro_cycle.py, in-process) ----

WORKLOAD_ROUNDS = (
    # (name, replicas, cpu) batches — round 2 crosses the 64-row task
    # bucket when stacked on round 1's leftovers, so the fresh-task
    # micro pack path runs, not just the gather-warm path
    [("a", 3, "1"), ("b", 2, "2")],
    [("c", 4, "1"), ("d", 1, "500m")],
)


@pytest.mark.parametrize("restricted", [False, True])
def test_micro_equals_full_over_same_store_states(tmp_path, restricted):
    """Two port loops and the JAX package's through the same (submit
    batch, one cycle) steps — one cycling micro, one full, the JAX one
    micro: the binds are equal every round."""
    micro = Cluster(True, tmp_path, "mi", restricted_sessions=restricted, shadow_every=1)
    full = Cluster(True, tmp_path, "fu")
    ref = Cluster(False, tmp_path, "jx", restricted_sessions=restricted, shadow_every=1)
    store = Store()
    start = store.start(node_cpu="8")
    for c in (micro, full, ref):
        c.feed(start)
    for round_i, batch in enumerate(WORKLOAD_ROUNDS):
        events = [e for name, replicas, cpu in batch
                  for e in store.submit(name, replicas=replicas, cpu=cpu)]
        for c in (micro, full, ref):
            c.feed(events)
        binds = micro.cycle(trigger="task")
        assert binds and full.cycle() == binds, f"round {round_i}"
        assert ref.cycle(trigger="task") == binds, f"round {round_i}"
        echo = store.echo(binds)
        for c in (micro, full, ref):
            c.feed(echo)
            assert c.pending() == 0
    assert micro.scheduler.micro_cycles_run == len(WORKLOAD_ROUNDS)
    assert full.scheduler.micro_cycles_run == 0
    assert micro.scheduler.restricted_cycles_run == (len(WORKLOAD_ROUNDS) if restricted else 0)


def test_micro_cycle_replay_verifies(tmp_path):
    """A recorded micro-cycle replays through the port's own verify
    (``torch-scan`` on the CPU) with the recorded binds."""
    jdir = str(tmp_path / "journal")
    trace.enable(jdir, snapshot_every=1)
    c = Cluster(True, tmp_path, "replay")
    store = Store()
    c.feed(store.start(node_cpu="8") + store.submit("r0", replicas=3))
    c.cycle()  # full, warms the pack cache
    c.feed(store.submit("r1", replicas=2))
    assert len(c.cycle(trigger="task")) == 2  # the micro-cycle
    trace.disable()
    result = trace.replay.verify(jdir, executor="torch-scan", device="cpu")
    assert result.match, result.summary()


def test_event_wake_binds_long_before_period(tmp_path):
    """period=30 s; a submitted pod binds within seconds because the
    change wakes the loop, and shutdown does not wait out the period."""
    c = Cluster(True, tmp_path, "wake", period=30.0)
    store = Store()
    c.feed(store.start(node_cpu="8"))
    c.start()
    try:
        micro = metrics.registry.counter("volcano_micro_cycles_total", trigger="mixed") + \
            metrics.registry.counter("volcano_micro_cycles_total", trigger="task")
        lat = metrics.registry.histogram("volcano_micro_cycle_latency_milliseconds")[0]
        t0 = time.monotonic()
        c.feed(store.submit("w0", replicas=2))
        assert wait_for(lambda: len(c.cache.binder.binds) == 2, timeout=10.0)
        assert time.monotonic() - t0 < 10.0
        assert wait_for(lambda: c.scheduler.micro_cycles_run >= 1)
        assert metrics.registry.counter("volcano_micro_cycles_total", trigger="mixed") + \
            metrics.registry.counter("volcano_micro_cycles_total", trigger="task") > micro
        assert metrics.registry.histogram(
            "volcano_micro_cycle_latency_milliseconds")[0] > lat
    finally:
        t0 = time.monotonic()
        c.close()
        assert time.monotonic() - t0 < 10.0


def test_debounce_coalesces_event_storm(tmp_path):
    """20 jobs land inside the debounce window(s): far fewer micro-cycles
    than events."""
    c = Cluster(True, tmp_path, "storm", period=30.0, micro_debounce_ms=150.0)
    store = Store()
    c.feed(store.start(node_cpu="64"))
    c.start()
    try:
        for i in range(20):
            c.feed(store.submit(f"s{i}", replicas=1, cpu="100m"))
        assert wait_for(lambda: len(c.cache.binder.binds) == 20
                        and c.scheduler.micro_cycles_run >= 1)
        ran = c.scheduler.micro_cycles_run
        assert ran <= 6, f"a storm of 20 arrivals should coalesce, ran {ran} cycles"
    finally:
        c.close()


def test_plain_mode_sleep_is_interruptible(tmp_path):
    """The fixed-period loop: stop() returns at once instead of sleeping
    out the period."""
    c = Cluster(True, tmp_path, "plain", micro_cycles=False, period=60.0)
    c.start()
    t0 = time.monotonic()
    c.close()
    assert time.monotonic() - t0 < 5.0
    assert c.scheduler.full_cycles_run == 1 and c.scheduler.micro_cycles_run == 0


def _fallbacks(cause: str) -> float:
    return metrics.registry.counter("volcano_full_cycle_fallbacks_total", cause=cause)


def test_gang_arrival_routes_to_full_cycle(tmp_path):
    before = _fallbacks("gang-arrival")
    c = Cluster(True, tmp_path, "gang", period=30.0)
    store = Store()
    c.feed(store.start(node_cpu="8"))
    c.start()
    try:
        fulls = c.scheduler.full_cycles_run
        c.feed(store.submit("g0", replicas=3, gang=True))
        assert wait_for(lambda: len(c.cache.binder.binds) == 3, timeout=15.0)
        assert wait_for(lambda: _fallbacks("gang-arrival") > before)
        assert wait_for(lambda: c.scheduler.full_cycles_run > fulls)
        assert c.scheduler.micro_cycles_run == 0
    finally:
        c.close()


def test_topology_change_routes_to_full_cycle(tmp_path):
    before = _fallbacks("topology")
    c = Cluster(True, tmp_path, "topo", period=30.0)
    store = Store()
    c.feed(store.start(node_cpu="8"))
    c.start()
    try:
        c.feed([{"op": "add", "kind": "node", "object": _d(build_node(
            "late-node", {"cpu": "8", "memory": "64Gi"}))}])
        assert wait_for(lambda: _fallbacks("topology") > before, timeout=10.0)
        assert wait_for(lambda: c.scheduler.full_cycles_run >= 2)
    finally:
        c.close()


def test_registry_overflow_attributed_during_micro_cycle(tmp_path):
    """A micro-triggered cycle whose warm pack had to go cold (registry
    overflow) counts the pack-level cause; a full cycle would not."""
    before = _fallbacks("registry-overflow")
    c = Cluster(True, tmp_path, "overflow")
    store = Store()
    c.feed(store.start(node_cpu="8") + store.submit("o0", replicas=2))
    c.cycle()  # warm the pack cache
    c.cache.pack_cache.label_reg.overflow = True
    c.feed(store.submit("o1", replicas=2))
    assert len(c.cycle(trigger="task")) == 2
    assert _fallbacks("registry-overflow") == before + 1
    assert not c.cache.pack_cache.label_reg.overflow  # the cold rebuild recovered it
    assert c.cache.in_micro_cycle is False
    c.cache.pack_cache.label_reg.overflow = True
    c.feed(store.submit("o2", replicas=1))
    assert len(c.cycle()) == 1
    assert _fallbacks("registry-overflow") == before + 1


def test_run_cycles_in_micro_mode(tmp_path):
    """``run(cycles=1)`` in micro mode runs the window's full cycle and
    returns."""
    c = Cluster(True, tmp_path, "cycles", period=30.0)
    store = Store()
    c.feed(store.start(node_cpu="8") + store.submit("c0", replicas=2))
    c.scheduler.run(cycles=1)
    assert c.scheduler.full_cycles_run == 1 and len(c.cache.binder.binds) == 2


# ---- metrics and the cache surface ----


def test_render_of_the_micro_series_is_the_jax_registrys():
    metrics.registry.reset()
    jax_metrics.registry.reset()
    try:
        for m in (metrics, jax_metrics):
            m.register_micro_cycle("task")
            m.register_micro_cycle("mixed")
            m.register_micro_cycle("task")
            for s in (0.001, 0.02, 0.3, 7.0):
                m.update_micro_cycle_duration(s)
            m.register_full_cycle_fallback("gang-arrival")
            m.register_full_cycle_fallback("registry-overflow")
            m.update_resident_jobs(12500)
            m.update_schedulable_jobs(64)
            m.register_share_ledger_drift_check("ok")
        out = metrics.registry.render()
        assert out == jax_metrics.registry.render()
        assert 'volcano_micro_cycles_total{trigger="task"} 2.0' in out
        assert 'volcano_micro_cycle_latency_milliseconds_bucket{le="+Inf"} 4' in out
    finally:
        metrics.registry.reset()
        jax_metrics.registry.reset()


class NoListeners:
    """A cache without the change-listener surface."""

    def run(self):
        pass

    def wait_for_cache_sync(self):
        return True


def test_micro_cycles_on_a_cache_without_listeners_raises():
    with pytest.raises(TypeError, match="add_change_listener"):
        Scheduler(NoListeners(), micro_cycles=True)
    sched = Scheduler(NoListeners())  # the fixed-period loop needs none
    assert not sched.micro_cycles
    sched.micro_cycles = True
    with pytest.raises(TypeError):
        sched.run(cycles=1)


def test_notify_event_routes_and_labels():
    """The listener's bookkeeping: gang and topology set the full cause
    (the first one wins), the drained triggers count each category, and
    the label is the one category or ``mixed``."""
    sched = Scheduler(SchedulerCache(), micro_cycles=True)
    for cat in ("task", "task", "node", "gang", "topology"):
        sched.notify_event(cat)
    assert sched._full_due() and sched._take_full_cause() == "gang-arrival"
    assert sched._take_full_cause() is None
    pending = sched._drain_triggers()
    assert pending == {"task": 2, "node": 1, "gang": 1, "topology": 1}
    assert sched._trigger_label(pending) == "mixed"
    assert sched._trigger_label({"task": 3, "gang": 1}) == "task"
    assert sched._trigger_label({"topology": 1}) == "topology"
    assert sched._drain_triggers() == {}
    assert sched._wait_wake(0.0, for_events=True) is False
    sched.notify_event("group")
    assert sched._wait_wake(5.0, for_events=True) is True
    assert not sched._has_pending_work()


def test_stop_wakes_a_parked_wait():
    sched = Scheduler(SchedulerCache(), micro_cycles=True)
    done = threading.Event()

    def park():
        sched._wait_wake(60.0, for_events=True)
        done.set()

    t = threading.Thread(target=park, daemon=True)
    t.start()
    t0 = time.monotonic()
    sched.stop()
    assert done.wait(timeout=10.0) and time.monotonic() - t0 < 5.0
    t.join(timeout=10.0)
    assert not t.is_alive()
