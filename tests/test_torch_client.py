"""The port's API store and clients against the JAX package's, on the CPU.

One script of store operations runs through both packages' in-process
``APIServer``: create, update with and without ``expected_rv``,
``update_status``, ``get``, ``list``, ``delete`` with the owner-reference
cascade and the re-created-owner cases, and ``watch``/``unwatch`` with
``send_initial``.  The store dumps (``creation_timestamp`` left out: the
store stamps the wall clock on a zero stamp), the watch event sequences
and the errors (class and message) are equal.  So are ``commit_batch``'s
per-section results (NotFound, the v1alpha1 PodGroup fallback and the
missing-from-both no-op included), the Event names and counts of
``record_event_via``, and ``SchedulerClient.watch``'s dispatch to a
recording cache, call by call.  Then ``tests/test_scheme.py``'s six
cases on the port, held against the JAX package's results: the v1alpha1
conversions, the cache's dual-version handlers, and raw v1alpha1 objects
in the store scheduled through the port's ``Scheduler`` (its
``gpu-allocate`` on the CPU).
"""

from __future__ import annotations

import types

import pytest
import torch

import volcano_tpu.actions  # noqa: F401 — registers the JAX package's actions
import volcano_tpu.plugins  # noqa: F401 — registers its plugin builders
from volcano_tpu.actions.allocate import AllocateAction as JaxAllocateAction
from volcano_tpu.apis import core as jax_core, scheduling as jax_scheduling
from volcano_tpu.apis import scheme as jax_scheme, serde as jax_serde
from volcano_tpu.cache import SchedulerCache as JaxCache
from volcano_tpu.client import apiserver as jax_apiserver
from volcano_tpu.client import clients as jax_clients
from volcano_tpu.conf import PluginOption as JaxPluginOption, Tier as JaxTier
from volcano_tpu.framework import close_session as jax_close, open_session as jax_open
from volcano_tpu_torch.actions import gpu_allocate
from volcano_tpu_torch.actions.allocate import AllocateAction
from volcano_tpu_torch.apis import core, scheduling, scheme
from volcano_tpu_torch.cache import SchedulerCache
from volcano_tpu_torch.client import apiserver, clients
from volcano_tpu_torch.conf import PluginOption, Tier
from volcano_tpu_torch.framework import close_session, get_action, open_session, register_action

from tests.builders import build_node, build_pod, build_pod_group, build_queue
from tests.fakes import FakeBinder, FakeEvictor, FakeStatusUpdater

#: each package's store, clients, API types and cache
JAX = types.SimpleNamespace(port=False, api=jax_apiserver, clients=jax_clients, core=jax_core,
                            scheduling=jax_scheduling, scheme=jax_scheme, Cache=JaxCache)
PORT = types.SimpleNamespace(port=True, api=apiserver, clients=clients, core=core,
                             scheduling=scheduling, scheme=scheme, Cache=SchedulerCache)
PKGS = [pytest.param(JAX, id="jax"), pytest.param(PORT, id="port")]

TIERS = (("priority", "gang", "conformance"),
         ("drf", "predicates", "proportion", "nodeorder", "binpack"))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread keeps the suite's parallel workers from
    contending for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def d(obj) -> dict:
    """An API object of either package as a dict, its creation timestamp
    left out."""
    out = jax_serde.to_dict(obj)
    out.get("metadata", {}).pop("creationTimestamp", None)
    return out


def conv(pkg, obj):
    """A JAX-built API object as ``pkg``'s object of the same kind."""
    name = type(obj).__name__
    for mod in (pkg.core, pkg.scheduling, pkg.scheme):
        cls = getattr(mod, name, None)
        if cls is not None:
            return cls.from_dict(jax_serde.to_dict(obj))
    raise KeyError(name)


def owned(pod, owner_kind: str, owner_name: str, uid: str):
    """``pod`` with a controller ownerReference to (kind, name, uid)."""
    pod.metadata.owner_references = [jax_core.OwnerReference(
        kind=owner_kind, name=owner_name, uid=uid, controller=True)]
    return pod


def pg(name, uid):
    out = build_pod_group("ns", name, 1)
    out.metadata.uid = uid
    return out


def named(obj):
    """``obj`` with a uid made from its kind and name: the builders count
    uids up across calls, and each package's script builds its own."""
    obj.metadata.uid = f"{obj.kind}-{obj.metadata.name}"
    return obj


def pod(name, node="", group="g"):
    return named(build_pod("ns", name, node, {"cpu": "1", "memory": "1Gi"}, group=group))


def node(name="n0"):
    return named(build_node(name, {"cpu": "8", "memory": "16Gi"}))


def queue(name):
    return named(build_queue(name))


def dump(api) -> dict:
    kinds = ("Pod", "Node", "PodGroup", "Queue", "Event", "PodGroupV1alpha1", "QueueV1alpha1",
             "PriorityClass", "PersistentVolumeClaim")
    return {kind: [d(o) for o in api.list(kind)] for kind in kinds}


def run_script(pkg) -> dict:
    """The store script through ``pkg``'s APIServer: what each watcher
    saw, the errors, the reads and the final dump."""
    api = pkg.api.APIServer()
    seen, late, errors, reads = [], [], [], []
    api.watch("Pod", lambda ev, old, new: seen.append(
        ("Pod", ev, old and d(old), new and d(new))), send_initial=False)
    api.watch("PodGroup", lambda ev, old, new: seen.append(
        ("PodGroup", ev, old and d(old), new and d(new))), send_initial=False)

    def attempt(fn, *args, **kw):
        try:
            out = fn(*args, **kw)
        except pkg.api.ApiError as e:
            errors.append((type(e).__name__, str(e)))
            return None
        return out

    def c(obj):
        return attempt(api.create, conv(pkg, obj))

    c(node())
    c(queue("q0"))
    p0, p1 = pod("p0"), pod("p1")
    c(p0)
    c(p1)
    c(p0)  # AlreadyExists
    c(pg("g0", "u-g0"))
    # update without and with expected_rv; a stale rv; a missing object
    upd = api.get("Pod", "ns", "p0")
    upd.metadata.labels["tier"] = "a"
    attempt(api.update, upd)
    upd = api.get("Pod", "ns", "p0")
    upd.metadata.labels["tier"] = "b"
    attempt(api.update, upd, expected_rv=upd.metadata.resource_version)
    attempt(api.update, upd, expected_rv=1)
    attempt(api.compare_and_update, upd, upd.metadata.resource_version)
    attempt(api.update, conv(pkg, pod("ghost")))
    st = api.get("Pod", "ns", "p1")
    st.status.phase = "Running"
    attempt(api.update_status, st)
    attempt(api.update_status, conv(pkg, pod("ghost")))
    reads.append(d(api.get("Pod", "ns", "p0")))
    reads.append(api.get("Pod", "ns", "nope"))
    reads.append([d(o) for o in api.list("Pod", "ns")])
    reads.append([d(o) for o in api.list("Pod", "other")])
    # the owner cascade: deleting g1 takes its two pods, parent first
    c(pg("g1", "u-g1"))
    c(owned(pod("c1a"), "PodGroup", "g1", "u-g1"))
    c(owned(pod("c1b"), "PodGroup", "g1", "u-g1"))
    attempt(api.delete, "PodGroup", "ns", "g1")
    # a stale index entry: the child deleted directly and re-created
    # without an owner must survive its old owner's delete
    c(pg("g2", "u-g2"))
    c(owned(pod("c2"), "PodGroup", "g2", "u-g2"))
    attempt(api.delete, "Pod", "ns", "c2")
    c(pod("c2"))
    attempt(api.delete, "PodGroup", "ns", "g2")
    # the re-created owner: a child owned by an earlier g3 (uid old)
    # survives the delete of the g3 re-created under a new uid
    c(owned(pod("c3"), "PodGroup", "g3", "u-old"))
    c(pg("g3", "u-new"))
    attempt(api.delete, "PodGroup", "ns", "g3")
    attempt(api.delete, "Pod", "ns", "nope")
    # a late watcher gets every object as ADDED; once unwatched, nothing
    handler = lambda ev, old, new: late.append((ev, d(new) if new else d(old)))  # noqa: E731
    api.watch("Pod", handler, send_initial=True)
    c(pod("p2"))
    api.unwatch("Pod", handler)
    c(pod("p3"))
    attempt(api.delete, "Pod", "ns", "p3")
    return dict(seen=seen, late=late, errors=errors, reads=reads, dump=dump(api))


def test_store_script_equals_the_jax_stores():
    jax, port = run_script(JAX), run_script(PORT)
    for key in ("errors", "reads", "late", "seen", "dump"):
        assert port[key] == jax[key], key
    assert [e[0] for e in jax["errors"]] == [
        "AlreadyExistsError", "ConflictError", "NotFoundError", "NotFoundError",
        "NotFoundError"]
    names = [p["metadata"]["name"] for p in jax["dump"]["Pod"]]
    assert names == ["c2", "c3", "p0", "p1", "p2"]
    deleted = [(kind, old["metadata"]["name"]) for kind, ev, old, _ in jax["seen"]
               if ev == "DELETED"]
    # parent first; the survivors c2 (re-created) and c3 (owned by an
    # earlier g3) stay
    assert deleted[0] == ("PodGroup", "g1")
    assert sorted(deleted[1:3]) == [("Pod", "c1a"), ("Pod", "c1b")]
    assert deleted[3:] == [("Pod", "c2"), ("PodGroup", "g2"), ("PodGroup", "g3"), ("Pod", "p3")]


def commit_script(pkg) -> dict:
    """Every commit_batch section, with its failure routes."""
    api = pkg.api.APIServer()
    for obj in (pod("p0"), pod("p1"), pod("p2"), pg("g0", "u-g0")):
        api.create(conv(pkg, obj))
    legacy = pkg.scheme.pod_group_hub_to_v1alpha1(conv(pkg, pg("legacy", "u-l")))
    api.create(legacy)
    hub = api.get("PodGroup", "ns", "g0")
    hub.status.phase = "Running"
    raw = pkg.scheme.pod_group_v1alpha1_to_hub(api.get("PodGroupV1alpha1", "ns", "legacy"))
    raw.status.phase = "Running"
    ghost = conv(pkg, pg("ghost", "u-x"))
    event = {"type": "Normal", "reason": "Scheduled", "message": "m"}
    results = api.commit_batch(
        binds=[{"namespace": "ns", "name": "p0", "hostname": "n0", "event": event},
               {"namespace": "ns", "name": "missing", "hostname": "n0", "event": event}],
        evicts=[{"namespace": "ns", "name": "p1",
                 "event": {"type": "Normal", "reason": "Evict", "message": "e"}},
                {"namespace": "ns", "name": "missing"}],
        events=[{"namespace": "ns", "involved": {"kind": "Pod", "namespace": "ns",
                                                 "name": "p2"},
                 "type": "Warning", "reason": "Unschedulable", "message": "u"}],
        conditions=[{"namespace": "ns", "name": "p2", "reason": "Unschedulable",
                     "message": "u"},
                    {"namespace": "ns", "name": "missing", "reason": "r", "message": "m"}],
        pod_groups=[hub, raw, ghost],
    )
    client = pkg.clients.SchedulerClient(api)
    via_client = client.commit_batch(binds=[{"namespace": "ns", "name": "p2",
                                             "hostname": "n1"}])
    return dict(results=results, via_client=via_client, dump=dump(api))


def test_commit_batch_sections_equal_the_jax_stores():
    jax, port = commit_script(JAX), commit_script(PORT)
    assert port == jax
    assert jax["results"]["binds"][0] is None and "NotFoundError" in jax["results"]["binds"][1]
    assert jax["results"]["evicts"][0] is None and "NotFoundError" in jax["results"]["evicts"][1]
    assert jax["results"]["conditions"] == [None, None]
    assert jax["results"]["pod_groups"] == [None, None, None]
    legacy = jax["dump"]["PodGroupV1alpha1"]
    assert legacy[0]["status"]["phase"] == "Running"


def event_script(pkg) -> list:
    api = pkg.api.APIServer()
    involved = {"kind": "Pod", "namespace": "ns", "name": "p0"}
    for type_, reason, message in (("Warning", "Unschedulable", "first"),
                                   ("Warning", "Unschedulable", "second"),
                                   ("Normal", "Scheduled", "bound"),
                                   ("Warning", "Unschedulable", "third")):
        pkg.clients.record_event_via(api, "ns", involved, type_, reason, message)
    client = pkg.clients.SchedulerClient(api)
    client.record_event("ns", {"kind": "Pod", "namespace": "ns", "name": "p1"}, "Normal",
                        "Evict", "gone")
    return [(e.metadata.name, e.reason, e.count, e.message) for e in api.list("Event")]


def test_record_event_names_and_counts_equal_the_jax_packages():
    jax, port = event_script(JAX), event_script(PORT)
    assert port == jax
    assert sorted((r, n, m) for _, r, n, m in jax) == [
        ("Evict", 1, "gone"), ("Scheduled", 1, "bound"), ("Unschedulable", 3, "third")]


class RecordingCache:
    """Every handler the client's watch calls, with its arguments as
    dicts."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def record(*args):
            self.calls.append((name, [a if a is None else d(a) for a in args]))
        return record


def watch_script(pkg) -> list:
    api = pkg.api.APIServer()
    api.create(conv(pkg, pod("early")))
    cache = RecordingCache()
    pkg.clients.SchedulerClient(api).watch(cache)
    objs = [conv(pkg, node()), conv(pkg, pod("p0")), conv(pkg, pg("g0", "u")), conv(pkg, queue("q0")),
            pkg.scheme.pod_group_hub_to_v1alpha1(conv(pkg, pg("g1", "u1"))),
            pkg.scheme.queue_hub_to_v1alpha1(conv(pkg, queue("q1"))),
            pkg.core.PriorityClass(metadata=pkg.core.ObjectMeta(name="high"), value=10),
            pkg.core.PersistentVolumeClaim(metadata=pkg.core.ObjectMeta(name="c", namespace="ns"),
                                           spec={"storageClassName": "fast"})]
    for obj in objs:
        api.create(obj)
    for obj in objs:
        api.update(api.get(obj.kind, obj.metadata.namespace, obj.metadata.name))
    for obj in objs:
        api.delete(obj.kind, obj.metadata.namespace, obj.metadata.name)
    return cache.calls


def test_scheduler_client_watch_dispatch_equals_the_jax_clients():
    jax, port = watch_script(JAX), watch_script(PORT)
    assert port == jax
    assert [name for name, _ in jax][:9] == [
        "add_pod", "add_node", "add_pod", "add_pod_group", "add_queue",
        "add_pod_group_v1alpha1", "add_queue_v1alpha1", "add_priority_class", "add_pvc"]
    assert {name for name, _ in jax} >= {"update_pod_group_v1alpha1", "delete_queue_v1alpha1",
                                         "delete_priority_class", "update_pvc", "delete_pvc"}


# ---- tests/test_scheme.py's cases ----


@pytest.mark.parametrize("pkg", PKGS)
def test_queue_v1alpha1_roundtrip_defaults_state_open(pkg):
    q1 = pkg.scheme.QueueV1alpha1(
        metadata=pkg.core.ObjectMeta(name="q", namespace=""),
        spec=pkg.scheme.QueueSpecV1alpha1(weight=4, capability={"cpu": "100"}),
    )
    hub = pkg.scheme.queue_v1alpha1_to_hub(q1)
    assert hub.spec.state == pkg.scheduling.QUEUE_STATE_OPEN
    assert hub.spec.weight == 4 and hub.spec.capability == {"cpu": "100"}
    back = pkg.scheme.queue_hub_to_v1alpha1(hub)
    assert back.spec.weight == 4
    assert not hasattr(back.spec, "state")
    assert d(back) == d(JAX.scheme.queue_hub_to_v1alpha1(JAX.scheme.queue_v1alpha1_to_hub(
        JAX.scheme.QueueV1alpha1.from_dict(jax_serde.to_dict(q1)))))


@pytest.mark.parametrize("pkg", PKGS)
def test_pod_group_roundtrip(pkg):
    pg1 = pkg.scheme.PodGroupV1alpha1(
        metadata=pkg.core.ObjectMeta(name="pg", namespace="ns"),
        spec=pkg.scheduling.PodGroupSpec(min_member=3, queue="q"),
    )
    hub = pkg.scheme.pod_group_v1alpha1_to_hub(pg1)
    assert hub.kind == "PodGroup"
    assert hub.spec.min_member == 3
    back = pkg.scheme.pod_group_hub_to_v1alpha1(hub)
    assert back.spec.queue == "q" and back.kind == "PodGroupV1alpha1"
    hub.spec.min_member = 5
    assert pg1.spec.min_member == 3  # the conversion does not alias its input


@pytest.mark.parametrize("pkg", PKGS)
def test_hub_to_v1alpha1_drops_v2_only_status(pkg):
    hub = pkg.scheduling.Queue(
        metadata=pkg.core.ObjectMeta(name="q", namespace=""),
        status=pkg.scheduling.QueueStatus(state="Open", inqueue=7, running=2),
    )
    back = pkg.scheme.queue_hub_to_v1alpha1(hub)
    assert back.status.running == 2
    assert not hasattr(back.status, "inqueue")


def _fed_cache(pkg):
    cache = pkg.Cache(binder=FakeBinder(), evictor=FakeEvictor(),
                      status_updater=FakeStatusUpdater())
    cache.add_node(conv(pkg, build_node("n0", {"cpu": "4", "memory": "8G"})))
    return cache


def test_v1alpha1_objects_schedule_identically():
    """The cache fed through the v1alpha1 handler set: the session sees a
    hub queue and PodGroup and places the pod, in both packages alike."""
    binds = []
    for pkg in (JAX, PORT):
        cache = _fed_cache(pkg)
        cache.add_queue_v1alpha1(pkg.scheme.QueueV1alpha1(
            metadata=pkg.core.ObjectMeta(name="q1", namespace="")))
        cache.add_pod_group_v1alpha1(pkg.scheme.PodGroupV1alpha1(
            metadata=pkg.core.ObjectMeta(name="pg1", namespace="ns"),
            spec=pkg.scheduling.PodGroupSpec(min_member=1, queue="q1"),
            status=pkg.scheduling.PodGroupStatus(phase=pkg.scheduling.POD_GROUP_INQUEUE)))
        cache.add_pod(conv(pkg, build_pod("ns", "p1", "", {"cpu": "1", "memory": "1G"},
                                          group="pg1")))
        if pkg.port:
            ssn = open_session(cache, [Tier(plugins=[PluginOption(name=n) for n in t])
                                       for t in TIERS], [])
            action = AllocateAction()
        else:
            ssn = jax_open(cache, [JaxTier(plugins=[JaxPluginOption(name=n) for n in t])
                                   for t in TIERS], [])
            action = JaxAllocateAction()
        assert "q1" in ssn.queues
        action.execute(ssn)
        (close_session if pkg.port else jax_close)(ssn)
        binds.append(dict(cache.binder.binds))
    assert binds[0] == binds[1] == {"ns/p1": "n0"}


@pytest.mark.parametrize("pkg", PKGS)
def test_v1alpha1_update_delete_handlers(pkg):
    cache = pkg.Cache(binder=FakeBinder())
    q = pkg.scheme.QueueV1alpha1(metadata=pkg.core.ObjectMeta(name="q2", namespace=""))
    cache.add_queue_v1alpha1(q)
    assert "q2" in cache.queues
    q.spec.weight = 9
    cache.update_queue_v1alpha1(None, q)
    assert cache.queues["q2"].weight == 9
    cache.delete_queue_v1alpha1(q)
    assert "q2" not in cache.queues


@pytest.fixture
def cpu_allocate():
    saved = get_action("gpu-allocate")
    register_action(gpu_allocate.GpuAllocateAction(device="cpu"))
    yield
    register_action(saved)


def test_raw_v1alpha1_objects_in_the_store_schedule(cpu_allocate, tmp_path):
    """A legacy writer stores raw v1alpha1 objects: the port's client's
    dual informer set feeds its cache, its Scheduler binds the pod through
    the store (enqueue promotes the PENDING group through the versioned
    kind's status writeback, then gpu-allocate binds), and the status is
    written back to the raw kind."""
    api = apiserver.APIServer()
    kube = clients.KubeClient(api)
    kube.create_node(conv(PORT, node()))
    cache = SchedulerCache(client=clients.SchedulerClient(api))
    cache.run()
    from volcano_tpu_torch.scheduler.scheduler import Scheduler

    path = tmp_path / "scheduler.conf"
    path.write_text('actions: "enqueue, gpu-allocate"\ntiers:\n- plugins:\n'
                    + "".join(f"  - name: {n}\n" for n in TIERS[0]) + "- plugins:\n"
                    + "".join(f"  - name: {n}\n" for n in TIERS[1]))
    scheduler = Scheduler(cache, scheduler_conf_path=str(path))
    api.create(scheme.QueueV1alpha1(metadata=core.ObjectMeta(name="raw-q", namespace="")))
    api.create(scheme.PodGroupV1alpha1(
        metadata=core.ObjectMeta(name="raw-pg", namespace="ns"),
        spec=scheduling.PodGroupSpec(min_member=1, queue="raw-q")))
    kube.create_pod(conv(PORT, build_pod("ns", "raw-pod", "", {"cpu": "1", "memory": "1Gi"},
                                         group="raw-pg")))
    for _ in range(3):
        scheduler.run_once()
        if kube.get_pod("ns", "raw-pod").spec.node_name:
            break
    assert kube.get_pod("ns", "raw-pod").spec.node_name == "n0"
    stored = api.get("PodGroupV1alpha1", "ns", "raw-pg")
    assert stored.status.phase in (scheduling.POD_GROUP_INQUEUE, scheduling.POD_GROUP_RUNNING)
    assert api.get("PodGroup", "ns", "raw-pg") is None
    assert [e.reason for e in api.list("Event", "ns")] == ["Scheduled"]
