"""Bus conformance across packages: the cases of ``tests/test_bus.py``'s
``TestBusConformance`` over every pair {port client, JAX client} ×
{port server, JAX server}.

A ``RemoteAPIServer`` against a ``BusServer`` behaves as the in-process
store: CRUD, list and CAS semantics, watch streams with and without the
initial list, the owner-reference cascade, and the coalesced commit
frame, whichever package is at either end of the wire.  Objects are
compared field for field, tolerance 0.  (The admission case is in
``tests/test_torch_bus_admission.py``.)  Every server binds port 0 and
is stopped, and every client closed, in the ``pair`` fixture.
"""

from __future__ import annotations

import pytest

from tests.torch_bus_helpers import (  # noqa: F401 — fixtures
    cm, one_torch_thread, pair, PAIRS, wait)

pytestmark = pytest.mark.parametrize("pair", PAIRS, indirect=True, ids=lambda p: "-".join(p))


def test_create_get_list_delete_roundtrip(pair):
    c, api = pair.c, pair.client
    api.create(cm(c, "a", data={"k": "v"}))
    api.create(cm(c, "b"))
    api.create(cm(c, "other-ns", ns="ns2"))

    got = api.get("ConfigMap", "ns", "a")
    assert type(got) is c.core.ConfigMap and got.data == {"k": "v"}
    assert got.metadata.resource_version == 1
    assert got.metadata.creation_timestamp > 0
    assert api.get("ConfigMap", "ns", "missing") is None

    assert [o.metadata.name for o in api.list("ConfigMap", "ns")] == ["a", "b"]
    assert len(api.list("ConfigMap")) == 3

    with pytest.raises(c.AlreadyExistsError):
        api.create(cm(c, "a"))

    old = api.delete("ConfigMap", "ns", "a")
    assert old.data == {"k": "v"}
    with pytest.raises(c.NotFoundError):
        api.delete("ConfigMap", "ns", "a")
    # the authoritative store agrees with the client's view
    assert pair.store.get("ConfigMap", "ns", "a") is None
    assert pair.store.get("ConfigMap", "ns", "b").to_dict() == api.get(
        "ConfigMap", "ns", "b").to_dict()


def test_update_cas_semantics(pair):
    c, api = pair.c, pair.client
    api.create(cm(c, "x", data={"n": "0"}))
    got = api.get("ConfigMap", "ns", "x")
    rv0 = got.metadata.resource_version
    got.data = {"n": "1"}
    updated = api.compare_and_update(got, rv0)
    assert updated.metadata.resource_version > rv0

    # stale CAS loses — the invariant leader election rides on
    stale = api.get("ConfigMap", "ns", "x")
    stale.data = {"n": "2"}
    with pytest.raises(c.ConflictError):
        api.compare_and_update(stale, rv0)

    with pytest.raises(c.NotFoundError):
        api.update(cm(c, "never-created"))

    fresh = api.get("ConfigMap", "ns", "x")
    fresh.data = {"n": "3"}
    api.update(fresh)
    fresh = api.get("ConfigMap", "ns", "x")
    api.update_status(fresh)
    assert pair.store.get("ConfigMap", "ns", "x").data == {"n": "3"}


def test_watch_initial_and_live_events(pair):
    c, api = pair.c, pair.client
    api.create(cm(c, "pre"))
    events = []
    api.watch("ConfigMap", lambda e, o, n: events.append((e, (n or o).metadata.name)))
    assert wait(lambda: ("ADDED", "pre") in events)

    api.create(cm(c, "live"))
    got = api.get("ConfigMap", "ns", "live")
    got.data = {"touched": "yes"}
    api.update(got)
    api.delete("ConfigMap", "ns", "live")
    expected = [("ADDED", "pre"), ("ADDED", "live"), ("MODIFIED", "live"), ("DELETED", "live")]
    assert wait(lambda: events == expected), events


def test_watch_without_initial(pair):
    c, api = pair.c, pair.client
    api.create(cm(c, "pre"))
    events = []
    api.watch("ConfigMap", lambda e, o, n: events.append((e, (n or o).metadata.name)),
              send_initial=False)
    api.create(cm(c, "post"))
    assert wait(lambda: ("ADDED", "post") in events)
    assert ("ADDED", "pre") not in events


def test_owner_reference_cascade(pair):
    """Deleting an owner takes controller-owned children with it, with
    DELETED notifications for every casualty (a PodGroup owning its pods
    and a ConfigMap: the port's store has no Job)."""
    c, api = pair.c, pair.client
    core = c.core
    api.create(c.scheduling.PodGroup(metadata=core.ObjectMeta(
        name="own", namespace="ns", uid="uid-own")))
    ref = core.OwnerReference(kind="PodGroup", name="own", uid="uid-own", controller=True)
    api.create(core.Pod(
        metadata=core.ObjectMeta(name="own-p0", namespace="ns", owner_references=[ref]),
        spec=core.PodSpec(containers=[core.Container(image="busybox")])))
    api.create(core.ConfigMap(metadata=core.ObjectMeta(name="own-cm", namespace="ns",
                                                       owner_references=[ref])))
    deleted = []
    for kind in ("Pod", "ConfigMap"):
        api.watch(kind, lambda e, o, n, k=kind: deleted.append((k, o.metadata.name))
                  if e == "DELETED" else None, send_initial=False)

    api.delete("PodGroup", "ns", "own")
    assert wait(lambda: api.get("Pod", "ns", "own-p0") is None
                and api.get("ConfigMap", "ns", "own-cm") is None)
    assert wait(lambda: set(deleted) == {("Pod", "own-p0"), ("ConfigMap", "own-cm")}), deleted


def test_commit_batch_is_one_store_transaction(pair):
    """The coalesced commit frame over the wire: binds with their
    Scheduled Events, a condition, a PodGroup status; per-item results,
    a failed bind reported in its slot."""
    c, api = pair.c, pair.client
    core = c.core
    for name in ("p0", "p1"):
        api.create(core.Pod(metadata=core.ObjectMeta(name=name, namespace="ns"),
                            spec=core.PodSpec(), status=core.PodStatus(phase="Pending")))
    pg = api.create(c.scheduling.PodGroup(metadata=core.ObjectMeta(name="pg", namespace="ns")))
    pg.status.phase = "Running"
    event = {"type": "Normal", "reason": "Scheduled", "message": "bound"}
    results = api.commit_batch(
        binds=[{"namespace": "ns", "name": "p0", "hostname": "n0", "event": event},
               {"namespace": "ns", "name": "gone", "hostname": "n0", "event": event}],
        conditions=[{"namespace": "ns", "name": "p1", "reason": "Unschedulable",
                     "message": "no node"}],
        pod_groups=[pg])
    assert results["binds"][0] is None and "gone" in results["binds"][1]
    assert results["conditions"] == [None] and results["pod_groups"] == [None]
    store = pair.store
    assert store.get("Pod", "ns", "p0").spec.node_name == "n0"
    assert [(e.reason, e.involved_object["name"]) for e in store.list("Event")] == [
        ("Scheduled", "p0")]
    assert store.get("Pod", "ns", "p1").status.conditions[0].reason == "Unschedulable"
    assert store.get("PodGroup", "ns", "pg").status.phase == "Running"
