"""The federation across packages, on the CPU: the cache's two hooks
against the JAX cache's, ``vtctl shards`` against the JAX ``vtctl``,
and a federation of one JAX member and one port member.

* **Cache hooks.**  On one event stream the port's
  ``pending_spill_view`` gives the JAX cache's job ids, minima, ready
  counts and task names, and ``run()`` registers the informer sink (the
  shard filter) with the client in both, the cache itself without one.
* **vtctl shards.**  On the shard map a live port federation wrote, the
  port's text is byte-equal to the JAX ``vtctl``'s, in process and over
  ``--bus`` to either package's bus server.
* **A mixed federation.**  A port member (gpu-allocate on the CPU) and a
  JAX member (jax-allocate) lease the two shards of one store over one
  ``BusServer`` of either package: each reads the other's shard-map
  record and sketch, every pod binds exactly once (a store-truth audit
  watch), both packages' ``verify_federation`` find the final store
  clean, and a crash of either member leaves the survivor holding both
  shards in the shard map within one lease TTL plus the retry period
  (``TAKEOVER_S``), after which it binds new arrivals.
"""

from __future__ import annotations

import io
import time
from types import SimpleNamespace

import pytest

from tests import torch_mirror
from tests.torch_bus_helpers import cpu_actions, pkg, reserved_port, wait  # noqa: F401

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
ALLOCATE = {"port": "gpu-allocate", "jax": "jax-allocate"}
TTL = 1.0
RETRY = 0.1
#: the survivor holds both shards within one TTL plus the retry period
#: at its longest jitter (x1.25), and 0.1 s for its tick in flight at
#: the expiry and its claiming tick, each a read and a CAS over the bus
#: (PERF.md, §6, gives the readings this was set from)
TAKEOVER_S = TTL + 1.25 * RETRY + 0.1


def _builders(name: str):
    """``tests/builders.py`` for package ``name`` (a fresh copy)."""
    if name == "jax":
        import tests.builders as b

        return b
    path = torch_mirror.ROOT / "tests" / "builders.py"
    return torch_mirror._exec(f"tests._fed_builders_{next(torch_mirror._seq)}", path,
                              torch_mirror._port_source(path.read_text()))


_FED = {}


def fed(name: str) -> SimpleNamespace:
    """One package's federation surface by the same names (and its bus
    surface, ``torch_bus_helpers.pkg``)."""
    if name in _FED:
        return _FED[name]
    if name == "port":
        from volcano_tpu_torch import federation
        from volcano_tpu_torch.cache import SchedulerCache
        from volcano_tpu_torch.federation.filter import ShardInformerFilter
    else:
        from volcano_tpu import federation
        from volcano_tpu.cache import SchedulerCache
        from volcano_tpu.federation.filter import ShardInformerFilter
    _FED[name] = SimpleNamespace(**dict(vars(pkg(name)), fed=federation,
                                        SchedulerCache=SchedulerCache,
                                        ShardInformerFilter=ShardInformerFilter,
                                        b=_builders(name)))
    return _FED[name]


# ---- the cache's hooks ----

def _feed(f, cache) -> None:
    """Jobs of 1–4 tasks, minMember 1–3, some tasks bound, on 4 nodes."""
    b = f.b
    cache.add_queue(b.build_queue("default"))
    for i in range(4):
        cache.add_node(b.build_node(f"n{i}", {"cpu": "8", "memory": "64Gi"}))
    for j, (replicas, min_member, bound) in enumerate(
            ((1, 1, 0), (3, 3, 1), (4, 2, 2), (2, 2, 0), (2, 1, 2))):
        cache.add_pod_group(b.build_pod_group("ns", f"job{j}", min_member))
        for t in range(replicas):
            node = f"n{t % 4}" if t < bound else ""
            cache.add_pod(b.build_pod("ns", f"job{j}-t{t}", node,
                                      {"cpu": "1", "memory": "1Gi"}, group=f"job{j}",
                                      phase="Running" if node else "Pending"))
    # a pod without a PodGroup is no job of the view
    cache.add_pod(b.build_pod("ns", "loose", "", {"cpu": "1", "memory": "1Gi"}))


def _view(cache) -> list:
    return sorted((e["job_id"], e["min_member"], e["ready"],
                   sorted(t.name for t in e["tasks"]))
                  for e in cache.pending_spill_view())


def test_pending_spill_view_equal_to_the_jax_caches():
    views = {}
    for name in ("port", "jax"):
        f = fed(name)
        cache = f.SchedulerCache(scheduler_name="volcano-tpu")
        _feed(f, cache)
        views[name] = _view(cache)
    assert views["port"] == views["jax"]
    assert [(j, m, r, len(t)) for j, m, r, t in views["port"]] == [
        ("ns/job0", 1, 0, 1), ("ns/job1", 3, 1, 2), ("ns/job2", 2, 2, 2), ("ns/job3", 2, 0, 2)]


class _RecordingClient:
    """The client surface ``SchedulerCache.run`` registers with."""

    def __init__(self):
        self.registered = []

    def watch(self, handler) -> None:
        self.registered.append(handler)


@pytest.mark.parametrize("name", ["port", "jax"])
def test_run_registers_the_informer_sink(name):
    f = fed(name)
    client = _RecordingClient()
    cache = f.SchedulerCache(client=client, scheduler_name="volcano-tpu")
    sink = f.ShardInformerFilter(cache, f.fed.ShardState(2))
    cache.set_informer_sink(sink)
    cache.run()
    cache.run()  # idempotent: one registration
    assert client.registered == [sink]
    with pytest.raises(RuntimeError, match="before the informers start"):
        cache.set_informer_sink(sink)
    plain_client = _RecordingClient()
    plain = f.SchedulerCache(client=plain_client, scheduler_name="volcano-tpu")
    plain.run()
    assert plain_client.registered == [plain]


# ---- vtctl shards ----

def _conf(tmp_path, name: str) -> str:
    path = tmp_path / f"conf-{name}.yaml"
    path.write_text(CONF.format(allocate=ALLOCATE[name]))
    return str(path)


def _shards_texts(api, urls) -> list:
    """``vtctl shards`` of both packages in process on ``api``, then over
    each of ``urls``."""
    out = []
    for name in ("port", "jax"):
        main = pkg(name).vtctl
        for argv, kw in [(["shards"], {"api": api})] + [
                (["--bus", url, "shards"], {}) for url in urls]:
            buf = io.StringIO()
            assert main(argv, out=buf, **kw) == 0, (name, argv, buf.getvalue())
            out.append(buf.getvalue())
    return out


@pytest.mark.usefixtures("cpu_actions")
def test_vtctl_shards_byte_equal_on_a_port_federations_map(tmp_path):
    """Two port members, one crash-stopped with its lease left in the
    map; the map's text over both packages' vtctls and backends."""
    f = fed("port")
    api = f.APIServer()
    for i in range(6):
        api.create(f.b.build_node(f"n{i:03d}", {"cpu": "4", "memory": "64Gi"}))
    members = [f.fed.FederatedScheduler(api, f"m{i}", 2, scheduler_conf_path=_conf(tmp_path, "port"),
                                        lease_duration=TTL, lease_retry_period=RETRY).start()
               for i in range(2)]
    try:
        assert wait(lambda: all(len(m.state.owned()) == 1 for m in members), 15)
        assert wait(lambda: all("sketch" in s for s in
                                (f.fed.read_shard_map(api) or {}).get("stats", {}).values())
                    and len((f.fed.read_shard_map(api) or {}).get("stats", {})) == 2, 10)
        members[1].crash()
        members[0].stop()
    finally:
        for m in members:
            m.stop()
    jax_store = pkg("jax").APIServer()
    jax_store.create(pkg("jax").core.ConfigMap(
        metadata=pkg("jax").core.ObjectMeta(name=f.fed.SHARD_MAP_NAME, namespace="volcano-system"),
        data=dict(api.get("ConfigMap", "volcano-system", f.fed.SHARD_MAP_NAME).data)))
    servers = [pkg("port").BusServer(api, port=reserved_port()).start(),
               pkg("jax").BusServer(jax_store, port=reserved_port()).start()]
    try:
        texts = _shards_texts(api, [f"tcp://127.0.0.1:{s.port}" for s in servers])
    finally:
        for s in servers:
            s.stop()
    assert len(set(texts)) == 1, texts
    assert "Shards:             2" in texts[0] and "sketch: slots=" in texts[0]


# ---- a mixed federation ----

class Mixed:
    """One port and one JAX member over one bus server of package
    ``server``, eight 4-cpu nodes, a store-truth audit of every bind."""

    def __init__(self, tmp_path, server: str):
        self.s = fed(server)
        self.api = self.s.APIServer()
        self.bus = self.s.BusServer(self.api, port=reserved_port()).start()
        self.url = f"tcp://127.0.0.1:{self.bus.port}"
        self.api.create(self.s.b.build_queue("default"))
        for i in range(8):
            self.api.create(self.s.b.build_node(f"n{i:03d}", {"cpu": "4", "memory": "64Gi"}))
        self.bound, self.rebinds = {}, []
        self.api.watch("Pod", self._audit, send_initial=False)
        self.remotes, self.members = {}, {}
        for name in ("port", "jax"):
            f = fed(name)
            remote = f.RemoteAPIServer(self.url, timeout=5.0)
            assert remote.wait_ready(10.0)
            self.remotes[name] = remote
            self.members[name] = f.fed.FederatedScheduler(
                remote, f"{name}-m", 2, scheduler_conf_path=_conf(tmp_path, name),
                lease_duration=TTL, lease_retry_period=RETRY, spill_after=1,
                gang_assemble_after=1).start()
        self.submitted = 0

    def _audit(self, event, old, new):
        if new is None or not new.spec.node_name:
            return
        key = f"{new.metadata.namespace}/{new.metadata.name}"
        prev = self.bound.setdefault(key, new.spec.node_name)
        if prev != new.spec.node_name:
            self.rebinds.append((key, prev, new.spec.node_name))

    def submit(self, prefix: str, n: int) -> None:
        b = self.s.b
        for i in range(n):
            self.api.create(b.build_pod_group("ns", f"{prefix}{i}", 1))
            self.api.create(b.build_pod("ns", f"{prefix}{i}-t0", "", {"cpu": "1", "memory": "1Gi"},
                                        group=f"{prefix}{i}"))
            self.submitted += 1

    def cycle(self) -> None:
        for m in self.members.values():
            if not m._crashed:
                m.scheduler.run_once()

    def all_bound(self) -> bool:
        self.cycle()
        pods = self.api.list("Pod")
        return len(pods) == self.submitted and all(p.spec.node_name for p in pods)

    def close(self) -> None:
        for m in self.members.values():
            m.stop()
        for r in self.remotes.values():
            r.close()
        self.bus.stop()


@pytest.mark.usefixtures("cpu_actions")
@pytest.mark.parametrize("server", ["port", "jax"])
@pytest.mark.parametrize("victim", ["port", "jax"])
def test_mixed_federation(server, victim, tmp_path):
    cluster = Mixed(tmp_path, server)
    try:
        members = cluster.members
        # one shard each, and no ownership transition of the port member
        # still queued (its slice applied: a queued acquire and release
        # would move its view again)
        assert wait(lambda: all(len(m.state.owned()) == 1 and not getattr(m, "_xfer_pending", 0)
                                for m in members.values()), 15), \
            {n: m.state.owned() for n, m in members.items()}
        # each reads the other's shard-map record: the same record through
        # either package's reader, the other's heartbeat, stats and
        # sketch, and foreign candidates cut from the other's sketch only
        # (a member publishes its slice's sketch on the tick after the
        # one that claimed it, so the reads wait until each member's
        # sketch names nodes of its own shard only)
        def reads(n: str, o: str):
            rec = fed(n).fed.read_shard_map(cluster.remotes[n]) or {}
            theirs = {int(i) for i, e in rec.get("shards", {}).items()
                      if e["holder"] == f"{o}-m"}
            return rec, theirs, members[n].sketches.foreign_entries(rec)

        def published(n: str, o: str) -> bool:
            rec, theirs, _ = reads(n, o)
            top = rec.get("stats", {}).get(f"{o}-m", {}).get("sketch", {}).get("topNodes")
            return bool(top) and all(fed(n).fed.shard_of_node(e["name"], 2) in theirs
                                     for e in top)

        assert wait(lambda: all(published(n, o) for n, o in (("port", "jax"), ("jax", "port"))),
                    10)
        for n, o in (("port", "jax"), ("jax", "port")):
            rec, theirs, entries = reads(n, o)
            assert set(rec["members"]) == {"port-m", "jax-m"}
            assert theirs == members[o].state.owned()
            assert entries and all(
                fed(n).fed.shard_of_node(e[1], 2) in theirs for e in entries), \
                (n, members[n].state.owned(), rec["shards"], rec["stats"])
        cluster.submit("pre", 8)
        assert wait(cluster.all_bound, 60, interval=0.05)
        for n in ("port", "jax"):
            report = fed(n).fed.verify_federation(cluster.remotes[n], 2)
            assert report["ok"], (n, report["violations"])
        # the crash: leases left to expire, the survivor absorbs both
        survivor = members["jax" if victim == "port" else "port"]

        def holds_both() -> bool:
            rec = cluster.s.fed.read_shard_map(cluster.api)
            return all(e["holder"] == survivor.identity for e in rec["shards"].values())

        t0 = time.monotonic()
        members[victim].crash()
        held = wait(holds_both, TAKEOVER_S, interval=0.01)
        print(f"takeover {server}-{victim}: {(time.monotonic() - t0) * 1e3:.1f} ms")
        assert held and time.monotonic() - t0 <= TAKEOVER_S, \
            cluster.s.fed.read_shard_map(cluster.api)["shards"]
        assert wait(lambda: survivor.state.owned() == {0, 1}, 10), survivor.state.owned()
        cluster.submit("post", 6)
        assert wait(cluster.all_bound, 60, interval=0.05)
        assert cluster.rebinds == [] and len(cluster.bound) == cluster.submitted == 14
        for n in ("port", "jax"):
            report = fed(n).fed.verify_federation(cluster.remotes[n], 2)
            assert report["ok"], (n, report["violations"])
            assert report["checked"]["bound"] == 14
    finally:
        cluster.close()


# ---- a spill burst onto one sketch node ----

def _burst(name: str, passes: int = 1, cover: bool = False) -> tuple:
    """Three 3-cpu solo tasks spilled from shard 0 onto shard 1, in one
    pass or one a pass, whose only node (4 cpu) the owner's sketch
    advertises, the sketch never republished: what each spill did, and
    ``verify_federation``'s violations.  ``cover``: then the owner takes
    in the bound pod and republishes, and the third value is the node's
    free cpu and slots as the spiller's solicitor then sees them."""
    import json

    f = fed(name)
    api = f.APIServer()
    node = next(f.b.build_node(f"n{k:03d}", {"cpu": "4", "memory": "64Gi"}) for k in range(64)
                if f.fed.shard_of_node(f"n{k:03d}", 2) == 1)
    api.create(node)
    owner_state = f.fed.ShardState(2)
    owner_state.acquire(1)
    owner = f.ShardInformerFilter(f.SchedulerCache(scheduler_name="volcano-tpu"), owner_state)
    owner.add_node(node)
    rec = {"nShards": 2, "members": {}, "shards": {"1": {"holder": "m1"}},
           "stats": {"m1": {"sketch": owner.capacity_sketch()}}}
    api.create(f.core.ConfigMap(
        metadata=f.core.ObjectMeta(name=f.fed.SHARD_MAP_NAME, namespace="volcano-system"),
        data={f.fed.SHARD_MAP_KEY: json.dumps(rec)}))
    if name == "port":
        from volcano_tpu_torch.api.job_info import new_task_info
        from volcano_tpu_torch.federation.spillover import SpilloverController
    else:
        from volcano_tpu.api.job_info import new_task_info
        from volcano_tpu.federation.spillover import SpilloverController
    state = f.fed.ShardState(2)
    state.acquire(0)
    state.owns_job_id = lambda _jid: True
    cache = f.SchedulerCache(scheduler_name="volcano-tpu")
    view = []
    for i in range(3):
        pod = api.create(f.b.build_pod("ns", f"t{i}", "", {"cpu": "3", "memory": "1Gi"}))
        view.append({"job_id": f"ns/t{i}", "min_member": 1, "ready": 0,
                     "tasks": [new_task_info(pod)]})
    spill = SpilloverController(cache, state, f.ShardInformerFilter(cache, state), api,
                                spill_after=0)
    for k in range(passes):
        spill.run_once(view[k::passes])
    out = (spill.counters(), f.fed.verify_federation(api, 2)["violations"])
    if not cover:
        return out
    for pod in api.list("Pod"):
        if pod.spec.node_name:
            owner.add_pod(pod)
    rec["stats"]["m1"]["sketch"] = owner.capacity_sketch()
    entries = spill.sketches.foreign_entries(rec)
    return out + ([(e[3].get("cpu"), e[4]) for e in entries],)


def test_a_spill_burst_never_overcommits_a_sketch_node():
    """The port keeps each spill as a claim that it debits from its
    node's sketch entry until the holder's sketch covers it: of three
    tasks spilled in one pass one binds, two find no fit, the store stays
    clean.  The reference binds all three onto the 4-cpu node
    (``cas_bind`` checks the pod's resourceVersion, ``verify_node`` only
    that the node exists), which its own ``verify_federation`` flags — a
    fault of the JAX package the port does not copy."""
    assert _burst("port") == ({"bound": 1, "no-fit": 2}, [])
    counters, violations = _burst("jax")
    assert counters == {"bound": 3}
    assert len(violations) == 1 and "overcommitted" in violations[0]


def test_spills_across_passes_never_overcommit_a_sketch_node():
    """The same three tasks, one a pass, the sketch never republished:
    the claims outlive the pass, so the port again binds one; the
    reference binds all three."""
    assert _burst("port", passes=3) == ({"bound": 1, "no-fit": 2}, [])
    counters, violations = _burst("jax", passes=3)
    assert counters == {"bound": 3}
    assert len(violations) == 1 and "overcommitted" in violations[0]


def test_a_claim_is_dropped_once_the_holders_sketch_covers_it():
    """Once the owner has taken the spilled pod into its ledger and
    published a sketch whose ``rv`` covers it, the spiller drops its
    claim: the node shows the owner's 1 cpu and 109 slots left, the
    spill not debited a second time."""
    counters, violations, seen = _burst("port", cover=True)
    assert (counters, violations) == ({"bound": 1, "no-fit": 2}, [])
    assert seen == [(1000.0, 109)]
