"""The port's share ledger and restricted sessions against the JAX
package's, on the CPU.

The same seeded event streams (dicts built with the JAX package's
builders, numpy ``RandomState``) go through both packages' cache
handlers, batch by batch, with binds applied to both caches alike.
After every batch the ledgers agree exactly: each queue's allocated and
request totals, each namespace's allocated total, the schedulable set and
``ledger_counts`` equal the JAX cache's, and equal a from-scratch sweep of
the resident jobs.

The cases of ``tests/test_incremental.py`` that need no API server run on
both packages' event-driven ``Scheduler``: randomized churn with
restricted sessions cross-checked by a shadow full session every cycle
(``shadow_every=1``) binds what a full-session loop binds and what the
JAX package's restricted loop (``jax-allocate``) binds, round by round;
the planted divergences (``drop-schedulable``, ``inflate-allocated``) are
flagged and heal; strict mode raises ``ShadowDivergence`` with the
session still closed; an idle wake opens no session; the metrics.  And
the resource-quota handlers: the namespace weights reach drf's namespace
order as they do in the JAX package.

The port's loop runs gpu-allocate on the CPU: ``cpu_actions`` registers
``GpuAllocateAction(device="cpu")`` for each test.  Every thread a test
starts is stopped and joined with a timeout, and every wait is bounded.
"""

from __future__ import annotations

import json
import random
import threading
import time

import numpy as np
import pytest
import torch

import chip_smoke
import volcano_tpu.actions  # noqa: F401 — registers the JAX package's actions
import volcano_tpu.plugins  # noqa: F401 — registers its plugin builders
from volcano_tpu.apis import serde as jax_serde
from volcano_tpu.cache import SchedulerCache as JaxCache
from volcano_tpu.conf import PluginOption as JaxPluginOption, Tier as JaxTier
from volcano_tpu.framework import (
    close_session as jax_close_session,
    open_session as jax_open_session,
)
from volcano_tpu.metrics import metrics as jax_metrics
from volcano_tpu.scheduler.scheduler import Scheduler as JaxScheduler
from volcano_tpu_torch import metrics
from volcano_tpu_torch.actions import gpu_allocate
from volcano_tpu_torch.api import TaskStatus
from volcano_tpu_torch.api.resource import empty_resource
from volcano_tpu_torch.cache import feed_events, SchedulerCache
from volcano_tpu_torch.conf import PluginOption, Tier
from volcano_tpu_torch.framework import (
    close_session,
    get_action,
    open_session,
    register_action,
)
from volcano_tpu_torch.incremental import subgraph
from volcano_tpu_torch.incremental.shares import (
    PLANT_DROP_SCHEDULABLE,
    PLANT_INFLATE_ALLOCATED,
)
from volcano_tpu_torch.ops import device_stage
from volcano_tpu_torch.ops.device_stage import get_stager
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
    """The port's gpu-allocate on the CPU for this test: registered under
    its name, the registry's instance restored after."""
    saved = get_action("gpu-allocate")
    register_action(gpu_allocate.GpuAllocateAction(device="cpu"))
    yield
    register_action(saved)


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


def wait_for(pred, timeout=30.0, interval=0.01) -> bool:
    """Poll ``pred`` until it holds or ``timeout`` seconds pass."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def _d(obj) -> dict:
    return jax_serde.to_dict(obj)


class Store:
    """The store both packages' caches watch: its objects as dicts, and
    the events of each step, built with the JAX package's builders."""

    def __init__(self):
        self.pods = {}
        self.nodes = {}

    def start(self, n_nodes=6, node_cpu="32", queues=("default",)) -> list:
        events = [{"op": "add", "kind": "queue", "object": _d(build_queue(q))} for q in queues]
        for i in range(n_nodes):
            node = _d(build_node(f"n{i}", {"cpu": node_cpu, "memory": "64Gi"},
                                 labels={"slot": f"s{i}"}))
            self.nodes[f"n{i}"] = node
            events.append({"op": "add", "kind": "node", "object": node})
        return events

    def submit(self, name, replicas=1, cpu="1", gang=False, ns="ns", queue="default") -> list:
        events = [{"op": "add", "kind": "pod_group", "object": _d(build_pod_group(
            ns, name, replicas if gang else 1, queue=queue))}]
        for i in range(replicas):
            pod = _d(build_pod(ns, f"{name}-t{i}", "", {"cpu": cpu, "memory": "1Gi"},
                               group=name))
            self.pods[f"{ns}/{name}-t{i}"] = pod
            events.append({"op": "add", "kind": "pod", "object": pod})
        return events

    def echo(self, binds) -> list:
        """The watch echo of binds: each pod Running on its node (an
        update that wakes no cycle)."""
        events = []
        for name, host in binds:
            old = self.pods[name]
            new = _copy(old)
            new["spec"]["nodeName"] = host
            new.setdefault("status", {})["phase"] = "Running"
            self.pods[name] = new
            events.append({"op": "update", "kind": "pod", "old": old, "object": new})
        return events

    def complete(self, name, replicas, ns="ns") -> list:
        """A job's departure: its pods, then its PodGroup."""
        events = [{"op": "delete", "kind": "pod", "object": self.pods.pop(f"{ns}/{name}-t{i}")}
                  for i in range(replicas)]
        events.append({"op": "delete", "kind": "pod_group",
                       "object": _d(build_pod_group(ns, name, 1))})
        return events


def _copy(d: dict) -> dict:
    return json.loads(json.dumps(d))


class Cluster:
    """One package's event-driven scheduler over a cache fed event dicts
    (the ``IncCluster`` of ``tests/test_incremental.py`` without the API
    server: binds land in the cache and echo back through ``Store.echo``)."""

    def __init__(self, port: bool, tmp_path, name: str, snapshot_reuse=False, **options):
        self.port = port
        allocate = "gpu-allocate" if port else "jax-allocate"
        path = tmp_path / f"{name}-{allocate}.conf"
        path.write_text(CONF.format(allocate=allocate))
        cache_cls, sched_cls = (SchedulerCache, Scheduler) if port else (JaxCache, JaxScheduler)
        self.cache = cache_cls(binder=chip_smoke.ListBinder(), status_updater=FakeStatusUpdater(),
                               snapshot_reuse=snapshot_reuse)
        options.setdefault("micro_cycles", True)
        options.setdefault("micro_debounce_ms", 5.0)
        self.scheduler = sched_cls(self.cache, scheduler_conf_path=str(path), **options)
        self._thread = None

    def feed(self, events) -> None:
        (feed_events if self.port else jax_feed_events)(self.cache, events)

    def cycle(self, trigger="full") -> list:
        n = len(self.cache.binder.binds)
        self.scheduler.run_once(trigger=trigger)
        return self.cache.binder.binds[n:]

    def start(self) -> "Cluster":
        self._thread = threading.Thread(target=self.scheduler.run, name="torch-inc-loop",
                                        daemon=True)
        self._thread.start()
        assert wait_for(lambda: self.scheduler.full_cycles_run >= 1)
        return self

    def close(self) -> None:
        self.scheduler.stop()
        if self._thread is not None:
            self._thread.join(timeout=30)
            assert not self._thread.is_alive(), "scheduler.run did not exit after stop()"

    def pending(self) -> int:
        with self.cache._mutex:
            return sum(len(j.task_status_index.get(TaskStatus.Pending, {}))
                       for j in self.cache.jobs.values())


# ---- the ledger, batch by batch ----


def _res(r) -> tuple:
    return r.milli_cpu, r.memory, tuple(sorted(r.scalars.items()))


def ledger_view(cache) -> tuple:
    """(queue → (allocated, request), namespace → allocated, the
    schedulable uids, ledger_counts) as plain values."""
    with cache._mutex:
        seed = cache.share_ledger.seed()
        return ({q: (_res(a), _res(r)) for q, (a, r) in seed.queues.items()},
                {ns: _res(a) for ns, a in seed.namespaces.items()},
                cache.share_ledger.schedulable_uids(), cache.ledger_counts())


def swept_view(cache) -> tuple:
    """The same totals swept from the resident jobs, the way the plugins
    sweep them in a full session."""
    with cache._mutex:
        want_q, want_ns, schedulable = {}, {}, set()
        resident = 0
        for job in cache.jobs.values():
            if job.pod_group is None:
                continue
            resident += 1
            alloc = job.allocated.clone()
            req = job.allocated.clone()
            pending = job.task_status_index.get(TaskStatus.Pending)
            for t in (pending or {}).values():
                req.add(t.resreq)
            if pending:
                schedulable.add(job.uid)
            qa, qr = want_q.setdefault(job.queue, (empty_resource(), empty_resource()))
            qa.add(alloc)
            qr.add(req)
            want_ns.setdefault(job.namespace, empty_resource()).add(alloc)
        return ({q: (_res(a), _res(r)) for q, (a, r) in want_q.items()},
                {ns: _res(a) for ns, a in want_ns.items()},
                schedulable, (resident, len(schedulable)))


def bind_both(caches, rng, store) -> list:
    """Bind a seeded choice of pending tasks on every cache alike (the
    first cache's pending tasks, by uid), round-robin over the nodes;
    the ``(ns/name, host)`` pairs."""
    first = caches[0]
    with first._mutex:
        pending = sorted((t.uid, t.job, f"{t.namespace}/{t.name}")
                         for j in first.jobs.values()
                         for t in j.task_status_index.get(TaskStatus.Pending, {}).values())
    if not pending:
        return []
    picks = sorted(rng.choice(len(pending), min(len(pending), rng.randint(1, 5)),
                              replace=False))
    binds = []
    for k, i in enumerate(picks):
        uid, job, name = pending[i]
        host = f"n{(k + i) % len(store.nodes)}"
        for cache in caches:
            cache.bind(cache.jobs[job].tasks[uid], host)
        binds.append((name, host))
    return binds


def ledger_script(seed: int):
    """Batches of store events, each after an optional bind step: jobs
    arrive in two namespaces and two queues (gangs and singles), binds
    echo Running, bound jobs finish, pending pods vanish, pods succeed,
    PodGroups go before their pods, a queue leaves."""
    rng = np.random.RandomState(seed)
    store = Store()
    yield store, store.start(queues=("default", "q2")), False
    live = []
    for k in range(12):
        events = []
        for _ in range(rng.randint(1, 4)):
            name = f"j{k}-{len(live)}"
            replicas = int(rng.randint(1, 4))
            ns, queue = ("ns", "ns2")[rng.randint(2)], ("default", "q2")[rng.randint(2)]
            events += store.submit(name, replicas, str(rng.choice(["500m", "1", "2"])),
                                   gang=bool(rng.rand() < 0.4), ns=ns, queue=queue)
            live.append((name, replicas, ns))
        op = rng.randint(4)
        if op == 0 and len(live) > 2:
            name, replicas, ns = live.pop(rng.randint(len(live)))
            events += store.complete(name, replicas, ns=ns)
        elif op == 1:
            pod = sorted(store.pods)[rng.randint(len(store.pods))]
            old = store.pods[pod]
            new = _copy(old)
            new.setdefault("status", {})["phase"] = "Succeeded"
            store.pods[pod] = new
            events.append({"op": "update", "kind": "pod", "old": old, "object": new})
        elif op == 2 and len(live) > 2:
            name, replicas, ns = live.pop(rng.randint(len(live)))
            events.append({"op": "delete", "kind": "pod_group",
                           "object": _d(build_pod_group(ns, name, 1))})
            events.append({"op": "delete", "kind": "pod",
                           "object": store.pods.pop(f"{ns}/{name}-t0")})
        if k == 9:
            events.append({"op": "delete", "kind": "queue", "object": _d(build_queue("q2"))})
        yield store, events, True


@pytest.mark.parametrize("seed", [3, 17, 101])
def test_ledger_equals_the_jax_ledger_and_the_sweep_batch_by_batch(seed):
    port = SchedulerCache(binder=chip_smoke.ListBinder())
    ref = JaxCache(binder=chip_smoke.ListBinder())
    rng = np.random.RandomState(seed + 1)
    binds_seen = 0
    for k, (store, events, bind) in enumerate(ledger_script(seed)):
        feed_events(port, events)
        jax_feed_events(ref, events)
        if bind:
            binds = bind_both([port, ref], rng, store)
            binds_seen += len(binds)
            echo = store.echo(binds[: len(binds) // 2])
            feed_events(port, echo)
            jax_feed_events(ref, echo)
        got = ledger_view(port)
        assert got == ledger_view(ref), f"batch {k}"
        assert got == swept_view(port), f"batch {k}"
        assert swept_view(ref) == got, f"batch {k}"
    assert binds_seen > 10 and got[3][0] > 5


# ---- restricted sessions (tests/test_incremental.py without the API server) ----


@pytest.mark.parametrize("seed", [11, 29, 47])
def test_randomized_churn_binding_identical(tmp_path, seed):
    """The same randomized op sequence — joins (gang and non-gang), a
    cycle a round, completions of bound jobs — through the port's
    restricted loop (every cycle shadow cross-checked, strict), the
    port's full-session loop and the JAX package's restricted loop: the
    binds are equal round by round, with zero divergences."""
    restricted = Cluster(True, tmp_path, f"re-{seed}", restricted_sessions=True,
                         shadow_every=1, shadow_strict=True)
    full = Cluster(True, tmp_path, f"fu-{seed}", restricted_sessions=False)
    ref = Cluster(False, tmp_path, f"jx-{seed}", restricted_sessions=True, shadow_every=1,
                  shadow_strict=True)
    clusters = (restricted, full, ref)
    store = Store()
    for c in clusters:
        c.feed(store.start())
    rng = random.Random(seed)
    live = []
    for round_i in range(6):
        events = []
        for _ in range(rng.randint(1, 3)):
            name = f"j{round_i}-{rng.randrange(1 << 16):04x}"
            replicas = rng.randint(1, 3)
            gang = rng.random() < 0.4
            cpu = rng.choice(["500m", "1", "2"])
            events += store.submit(name, replicas=replicas, cpu=cpu, gang=gang)
            live.append((name, replicas))
        if len(live) > 2 and rng.random() < 0.6:
            name, replicas = live.pop(rng.randrange(len(live)))
            events += store.complete(name, replicas)
        for c in clusters:
            c.feed(events)
        binds = restricted.cycle(trigger="task")
        assert full.cycle() == binds, f"round {round_i}"
        assert ref.cycle(trigger="task") == binds, f"round {round_i}"
        echo = store.echo(binds)
        for c in clusters:
            c.feed(echo)
            assert c.pending() == 0, f"round {round_i}"
    for c in (restricted, ref):
        s = c.scheduler
        assert s.restricted_cycles_run == 6
        assert s.shadow_checks_run == s.restricted_cycles_run
        assert s.shadow_divergences == 0
    assert restricted.cache.ledger_counts() == (len(live), 0)
    assert len(restricted.cache.binder.binds) > 6


def test_restricted_session_binds_equal_the_shadow_full_sessions(tmp_path):
    """The restricted session opens over the pending jobs only, its
    shadow over every job of the same snapshot; each binds the same
    pairs, and the JAX package's restricted session binds them too."""
    port = Cluster(True, tmp_path, "shadow", restricted_sessions=True, shadow_every=1,
                   shadow_strict=True, snapshot_reuse=True)
    ref = Cluster(False, tmp_path, "shadow", restricted_sessions=True, shadow_every=1,
                  shadow_strict=True, snapshot_reuse=True)
    store = Store()
    events = store.start()
    for i in range(5):
        events += store.submit(f"r{i}", replicas=2, cpu="2")
    for c in (port, ref):
        c.feed(events)
    first = port.cycle()
    assert ref.cycle() == first
    for c in (port, ref):
        c.feed(store.echo(first) + store.submit("late", replicas=3, cpu="1", gang=True)
               + store.submit("single", replicas=1, cpu="500m"))
    snaps = []
    take = port.cache.snapshot
    port.cache.snapshot = lambda scope="full": snaps.append(take(scope)) or snaps[-1]
    seen = {}
    shadow = subgraph.run_shadow_session
    stager = get_stager(port.cache.pack_cache.key, "cpu")

    def recording_shadow(cache, snap, *args):
        # the shadow packs cold: the warm packer and the live cache's
        # staged planes stay as they were
        rev, planes = port.cache.pack_cache.rev, dict(stager.plane_rev)
        stagers = set(device_stage._stagers)
        seen["binds"], seen["evicts"] = out = shadow(cache, snap, *args)
        assert (port.cache.pack_cache.rev, stager.plane_rev) == (rev, planes)
        assert set(device_stage._stagers) == stagers
        seen["shadowed"] = True
        return out

    subgraph.run_shadow_session = recording_shadow
    try:
        binds = port.cycle(trigger="task")
    finally:
        subgraph.run_shadow_session = shadow
    (snap,) = snaps
    assert snap.restricted_uids == {"ns/late", "ns/single"} and len(snap.jobs) == 7
    by_uid = {f"{t.namespace}/{t.name}": uid for j in port.cache.jobs.values()
              for uid, t in j.tasks.items()}
    assert seen["shadowed"] and stager.plane_rev
    assert {by_uid[n]: h for n, h in binds} == seen["binds"] and not seen["evicts"]
    assert len(binds) == 4
    assert ref.cycle(trigger="task") == binds
    assert port.scheduler.shadow_divergences == ref.scheduler.shadow_divergences == 0
    assert port.cache._pool_open is False


def test_clone_pool_after_restricted_cycles_equals_the_jax_caches(tmp_path):
    """With snapshot reuse, a restricted snapshot hands out only the
    pending jobs' clones, so only those (untouched) go back to the pool;
    full and shadow snapshots hand out every job.  After every cycle the
    port's pool holds the JAX cache's jobs and nodes at its revision."""
    port = Cluster(True, tmp_path, "pool", restricted_sessions=True, shadow_every=2,
                   snapshot_reuse=True)
    ref = Cluster(False, tmp_path, "pool", restricted_sessions=True, shadow_every=2,
                  snapshot_reuse=True)
    store = Store()
    for c in (port, ref):
        c.feed(store.start())
    pools = []
    for k in range(6):
        events = store.submit(f"p{k}", replicas=2, cpu="1") + \
            store.submit(f"q{k}", replicas=1, cpu="500m", ns="ns2")
        for c in (port, ref):
            c.feed(events)
        trigger = "full" if k == 3 else "task"
        binds = port.cycle(trigger=trigger)
        assert ref.cycle(trigger=trigger) == binds, f"cycle {k}"
        pool = [(set(c.cache._pool_jobs), set(c.cache._pool_nodes), c.cache._pool_rev,
                 c.cache._handed_jobs) for c in (port, ref)]
        assert pool[0] == pool[1], f"cycle {k}"
        pools.append(pool[0])
        echo = store.echo(binds)
        for c in (port, ref):
            c.feed(echo)
    assert port.scheduler.restricted_cycles_run == 5 and port.scheduler.shadow_checks_run == 2
    # cycles 0, 2 and 5 are restricted: handed only the pending jobs, all
    # of which they bound (touched), they pool none; the shadow-checked
    # (1, 4) and full (3) cycles pool every job they left untouched
    assert [len(pool_jobs) for pool_jobs, *_ in pools] == [0, 2, 0, 6, 8, 0]


def test_ledger_totals_match_full_sweep_after_churn(tmp_path):
    """After cycles and completions, the port's per-queue and
    per-namespace totals equal a sweep of the resident jobs and the JAX
    cache's ledger — equality, not tolerance."""
    port = Cluster(True, tmp_path, "sweep", restricted_sessions=True, shadow_every=1)
    ref = Cluster(False, tmp_path, "sweep", restricted_sessions=True, shadow_every=1)
    store = Store()
    for c in (port, ref):
        c.feed(store.start())
    rng = random.Random(7)
    live = []
    for round_i in range(5):
        name = f"s{round_i}"
        replicas = rng.randint(1, 4)
        events = store.submit(name, replicas=replicas, cpu=rng.choice(["1", "2"]),
                              gang=rng.random() < 0.5)
        live.append((name, replicas))
        for c in (port, ref):
            c.feed(events)
        binds = port.cycle(trigger="task")
        assert ref.cycle(trigger="task") == binds
        events = store.echo(binds)
        if rng.random() < 0.5 and len(live) > 1:
            gone, n = live.pop(0)
            events += store.complete(gone, n)
        for c in (port, ref):
            c.feed(events)
    got = ledger_view(port.cache)
    assert got == swept_view(port.cache) == ledger_view(ref.cache)
    assert set(got[0]) == {"default"} and set(got[1]) == {"ns"}


# ---- the divergence plants ----


def test_planted_ledger_corruption_is_flagged_and_heals(tmp_path):
    """A ledger that under-reports schedulable work (the plant drops one
    uid at read time) makes the restricted session skip a job the shadow
    full session binds: the cross-check flags it.  Clearing the plant
    heals the plane: the next cycle binds the skipped job, green."""
    c = Cluster(True, tmp_path, "plant", restricted_sessions=True, shadow_every=1)
    store = Store()
    c.feed(store.start() + store.submit("p0", replicas=2))
    div = metrics.registry.counter("volcano_share_ledger_drift_checks_total",
                                   result="divergence")
    ok = metrics.registry.counter("volcano_share_ledger_drift_checks_total", result="ok")
    c.cache.share_ledger.plant_divergence(PLANT_DROP_SCHEDULABLE)
    assert c.cycle(trigger="task") == []
    assert c.scheduler.shadow_divergences == 1
    assert metrics.registry.counter("volcano_share_ledger_drift_checks_total",
                                    result="divergence") == div + 1
    c.cache.share_ledger.clear_plant()
    assert len(c.cycle(trigger="task")) == 2
    assert c.scheduler.shadow_divergences == 1
    assert metrics.registry.counter("volcano_share_ledger_drift_checks_total",
                                    result="ok") == ok + 1


def test_strict_mode_raises_on_divergence_and_still_closes(tmp_path):
    c = Cluster(True, tmp_path, "strict", restricted_sessions=True, shadow_every=1,
                shadow_strict=True, snapshot_reuse=True)
    store = Store()
    c.feed(store.start() + store.submit("x0", replicas=1))
    c.cache.share_ledger.plant_divergence(PLANT_DROP_SCHEDULABLE)
    closed = []
    release = c.cache.release_session_clones

    def spy(*args):
        closed.append(args)
        return release(*args)

    c.cache.release_session_clones = spy
    with pytest.raises(subgraph.ShadowDivergence) as info:
        c.scheduler.run_once(trigger="task")
    assert info.value.diffs and "restricted=UNBOUND" in info.value.diffs[0]
    assert len(closed) == 1 and c.cache._pool_open is False
    assert c.cache.binder.binds == []


def test_inflated_allocated_plant_corrupts_only_the_seed(tmp_path):
    """The other plant kind: an inflated per-queue allocated total shows
    in the seed the sessions consume, and only there (the stored ledger
    stays exact, so clearing heals it) — as in the JAX package's ledger."""
    views = []
    for port in (True, False):
        c = Cluster(port, tmp_path, "inflate", restricted_sessions=True, shadow_every=1)
        store = Store()
        c.feed(store.start() + store.submit("q0", replicas=1))
        c.cycle(trigger="task")
        ledger = c.cache.share_ledger
        clean = ledger.seed()
        ledger.plant_divergence(PLANT_INFLATE_ALLOCATED)
        planted = ledger.seed()
        q = sorted(clean.queues)[0]
        assert planted.queues[q][0] != clean.queues[q][0]
        ledger.clear_plant()
        healed = ledger.seed()
        assert healed.queues[q][0] == clean.queues[q][0]
        views.append([_res(s.queues[q][0]) for s in (clean, planted, healed)])
    assert views[0] == views[1]
    with pytest.raises(ValueError):
        ledger.plant_divergence("no-such-plant")


# ---- the wake gate ----


def test_idle_wake_opens_no_session(tmp_path):
    """A capacity-freed wake with nothing schedulable costs no session:
    the loop answers ``has_schedulable_pending`` from the ledger's
    counter.  A real arrival afterwards binds through the event wake, in
    one session."""
    # a period no run of this test reaches: its full cycle would open a
    # session of its own
    c = Cluster(True, tmp_path, "wake", restricted_sessions=True, period=600.0)
    store = Store()
    c.feed(store.start())
    c.start()
    try:
        c.feed(store.submit("w0", replicas=2))
        assert wait_for(lambda: len(c.cache.binder.binds) == 2 and c.pending() == 0)
        assert wait_for(lambda: c.scheduler.micro_cycles_run >= 1
                        and not c.scheduler._pending_triggers)
        c.feed(store.echo(c.cache.binder.binds))
        assert not c.cache.has_schedulable_pending()
        opened = c.scheduler.sessions_opened
        # a bound pod departs: capacity freed, a "node" wake, nothing pending
        c.feed([{"op": "delete", "kind": "pod", "object": store.pods.pop("ns/w0-t1")}])
        assert wait_for(lambda: not c.scheduler._pending_triggers)
        # the arrival's wake runs exactly one session: had the idle wake
        # opened one, two would have opened since
        c.feed(store.submit("w1", replicas=1))
        assert wait_for(lambda: len(c.cache.binder.binds) == 3 and c.pending() == 0)
        assert wait_for(lambda: c.scheduler.sessions_opened > opened
                        and not c.scheduler._pending_triggers)
        assert wait_for(lambda: c.scheduler.micro_cycles_run >= 2)
        assert c.scheduler.sessions_opened == opened + 1
        assert c.scheduler.restricted_cycles_run >= 2
    finally:
        c.close()


# ---- metrics ----


def test_export_shapes_and_label_vocabularies():
    """The incremental plane's series render as the JAX registry renders
    them."""
    metrics.registry.reset()
    jax_metrics.registry.reset()
    try:
        for m in (metrics, jax_metrics):
            m.update_resident_jobs(1000000)
            m.update_schedulable_jobs(42)
            m.register_session_scope("full")
            m.register_session_scope("restricted")
            m.register_session_scope("restricted")
            m.register_share_ledger_drift_check("ok")
            m.register_share_ledger_drift_check("divergence")
        out = metrics.registry.render()
        assert out == jax_metrics.registry.render()
        assert "volcano_resident_jobs 1000000" in out
        assert "volcano_schedulable_jobs 42" in out
        assert 'volcano_session_scope_total{mode="restricted"} 2.0' in out
        assert 'volcano_share_ledger_drift_checks_total{result="divergence"} 1.0' in out
    finally:
        metrics.registry.reset()
        jax_metrics.registry.reset()


def test_gauges_track_ledger_after_each_cycle(tmp_path):
    c = Cluster(True, tmp_path, "gauge", restricted_sessions=True, shadow_every=1)
    store = Store()
    c.feed(store.start() + store.submit("g0", replicas=2) + store.submit("g1", replicas=1))
    scope = metrics.registry.counter("volcano_session_scope_total", mode="restricted")
    assert len(c.cycle(trigger="task")) == 3
    resident, schedulable = c.cache.ledger_counts()
    assert (resident, schedulable) == (2, 0)
    assert metrics.registry.gauge("volcano_resident_jobs") == resident
    assert metrics.registry.gauge("volcano_schedulable_jobs") == schedulable
    assert metrics.registry.counter("volcano_session_scope_total",
                                    mode="restricted") == scope + 1


def test_policy_outside_the_restrictable_set_opens_full_sessions(tmp_path):
    """A policy naming a victim-selecting action keeps full sessions on
    a micro-cycle, counted under mode="full", as in the reference."""
    c = Cluster(True, tmp_path, "unrestrictable", restricted_sessions=True, shadow_every=1)
    path = tmp_path / "preempting.conf"
    path.write_text(CONF.format(allocate="gpu-allocate, backfill"))
    c.scheduler.scheduler_conf_path = str(path)
    store = Store()
    c.feed(store.start() + store.submit("f0", replicas=2))
    full = metrics.registry.counter("volcano_session_scope_total", mode="full")
    assert len(c.cycle(trigger="task")) == 2
    assert c.scheduler.restricted_cycles_run == 0 and c.scheduler.micro_cycles_run == 1
    assert metrics.registry.counter("volcano_session_scope_total", mode="full") == full + 1
    assert not subgraph.conf_is_restrictable(["enqueue", "gpu-allocate", "backfill"])
    assert subgraph.conf_is_restrictable(["enqueue", "gpu-allocate"])
    assert subgraph.RESTRICTABLE_ACTIONS == {"enqueue", "allocate", "gpu-allocate"}


# ---- resource quotas: drf's namespace weights ----


def _quota_cluster(cache, add, pod_cls, pg_cls, queue_cls, node_cls) -> None:
    """Two namespaces with running work and one pending task each, and
    resource-quota weights 3 (ns-a, the larger of two quotas) and 1."""
    cache.add_resource_quota("ns-a", "q1", 2)
    cache.add_resource_quota("ns-a", "q2", 3)
    cache.add_resource_quota("ns-b", "q1", 1)
    cache.add_resource_quota("ns-c", "gone", 5)
    cache.delete_resource_quota("ns-c", "gone")
    add(cache.add_queue, queue_cls, _d(build_queue("default")))
    for i in range(2):
        add(cache.add_node, node_cls, _d(build_node(f"n{i}", {"cpu": "8", "memory": "64Gi"})))
    for ns, running in (("ns-a", 3), ("ns-b", 2)):
        add(cache.add_pod_group, pg_cls, _d(build_pod_group(ns, "run", running)))
        add(cache.add_pod_group, pg_cls, _d(build_pod_group(ns, "wait", 1)))
        for i in range(running):
            add(cache.add_pod, pod_cls, _d(build_pod(ns, f"run-{i}", "n0",
                                                     {"cpu": "1", "memory": "1Gi"},
                                                     phase="Running", group="run")))
        add(cache.add_pod, pod_cls, _d(build_pod(ns, "wait-0", "", {"cpu": "1", "memory": "1Gi"},
                                                 group="wait")))


def test_resource_quota_weights_reach_drfs_namespace_order():
    from volcano_tpu.apis import core as jax_core, scheduling as jax_scheduling
    from volcano_tpu_torch.apis import core, scheduling

    def add(handler, cls, d):
        handler(cls.from_dict(d))

    names = (("priority", "gang"), ("drf", "predicates", "proportion"))
    port = SchedulerCache(binder=chip_smoke.ListBinder())
    ref = JaxCache(binder=chip_smoke.ListBinder())
    _quota_cluster(port, add, core.Pod, scheduling.PodGroup, scheduling.Queue, core.Node)
    _quota_cluster(ref, add, jax_core.Pod, jax_scheduling.PodGroup, jax_scheduling.Queue,
                   jax_core.Node)
    ssn = open_session(port, [Tier(plugins=[PluginOption(name=n) for n in t]) for t in names],
                       [])
    jssn = jax_open_session(ref, [JaxTier(plugins=[JaxPluginOption(name=n) for n in t])
                                  for t in names], [])
    try:
        weights = {ns: info.get_weight() for ns, info in ssn.namespace_info.items()}
        assert weights == {ns: info.get_weight() for ns, info in jssn.namespace_info.items()}
        assert weights == {"ns-a": 3, "ns-b": 1, "ns-c": 1}
        order = [ssn.namespace_order_fn(a, b) for a in ("ns-a", "ns-b") for b in ("ns-a", "ns-b")]
        assert order == [jssn.namespace_order_fn(a, b) for a in ("ns-a", "ns-b")
                         for b in ("ns-a", "ns-b")]
        # weighted: ns-a's 3 cpu over weight 3 ranks before ns-b's 2 over 1
        assert order[1] is True
    finally:
        close_session(ssn)
        jax_close_session(jssn)
    # the same order without the quotas' weights ranks ns-b first
    plain = SchedulerCache(binder=chip_smoke.ListBinder())
    _quota_cluster(plain, add, core.Pod, scheduling.PodGroup, scheduling.Queue, core.Node)
    plain.delete_resource_quota("ns-a", "q1")
    plain.delete_resource_quota("ns-a", "q2")
    ssn = open_session(plain, [Tier(plugins=[PluginOption(name=n) for n in t]) for t in names],
                       [])
    try:
        assert ssn.namespace_order_fn("ns-a", "ns-b") is False
    finally:
        close_session(ssn)


# ---- the plugins' seed branches ----


def _plugin_state(ssn) -> tuple:
    """proportion's queue attributes and drf's namespace attributes after
    the session opened, as plain values."""
    prop = ssn.plugins["proportion"].queue_opts
    drf = ssn.plugins["drf"].namespace_opts
    return ({q: (_res(a.allocated), _res(a.request), _res(a.deserved), a.share)
             for q, a in sorted(prop.items())},
            {ns: (_res(a.allocated), a.share) for ns, a in sorted(drf.items())})


def test_seeded_plugins_equal_the_full_sweep():
    """A restricted session's proportion and drf state, seeded from the
    ledger, equals a full session's swept over every job of the same
    snapshot, and the JAX package's restricted session's."""
    store = Store()
    events = store.start(queues=("default", "q2"))
    for i, (ns, queue, n) in enumerate((("ns", "default", 3), ("ns2", "q2", 2),
                                        ("ns", "q2", 2), ("ns2", "default", 1))):
        events += store.submit(f"run{i}", n, "2", gang=True, ns=ns, queue=queue)
    tiers = ((("priority", "gang"), ("drf", "predicates", "proportion")))
    states = []
    for port in (True, False):
        cache = (SchedulerCache if port else JaxCache)(binder=chip_smoke.ListBinder())
        (feed_events if port else jax_feed_events)(cache, events)
        with cache._mutex:
            binds = [(cache.jobs[t.job].tasks[t.uid], f"n{k % 6}") for k, t in enumerate(
                t for j in cache.jobs.values() for t in j.tasks.values())]
        for task, host in binds:
            cache.bind(task, host)
        pending = store.submit("late", 2, "1", ns="ns2", queue="q2") + \
            store.submit("late2", 1, "500m", ns="ns", queue="default")
        (feed_events if port else jax_feed_events)(cache, pending)
        snap = cache.snapshot(scope="shadow")
        if port:
            tier_objs = [Tier(plugins=[PluginOption(name=n) for n in t]) for t in tiers]
            opened = (open_session(cache, tier_objs, [], snapshot=subgraph._shadow_snapshot(snap)),
                      open_session(cache, tier_objs, [], snapshot=snap,
                                   job_uids=snap.restricted_uids))
            closer = close_session
        else:
            from volcano_tpu.incremental import subgraph as jax_subgraph

            tier_objs = [JaxTier(plugins=[JaxPluginOption(name=n) for n in t]) for t in tiers]
            opened = (jax_open_session(cache, tier_objs, [],
                                       snapshot=jax_subgraph._shadow_snapshot(snap)),
                      jax_open_session(cache, tier_objs, [], snapshot=snap,
                                       job_uids=snap.restricted_uids))
            closer = jax_close_session
        full, restricted = opened
        try:
            assert set(restricted.jobs) == {"ns2/late", "ns/late2"}
            assert restricted.share_seed is not None and restricted.pack_epoch is None
            assert full.share_seed is None
            states.append(_plugin_state(full))
            assert _plugin_state(restricted) == states[-1]
        finally:
            for ssn in opened:
                closer(ssn)
    assert states[0] == states[1]
    assert len(states[0][0]) == 2 and len(states[0][1]) == 2
