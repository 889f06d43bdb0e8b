"""Bus resilience across packages: the cases of ``tests/test_bus.py``'s
``TestBusResilience``, ``TestBusReviewHardening`` (unwatch),
``TestWatchBatch`` and the old-server fallbacks, over every pair
{port client, JAX client} × {port server, JAX server}.

What only exists across a network: URL parsing, an unreachable bus
raising ``BusError``, a connection blip resuming its watches without a
relist, a server restart relisting with nothing missed or duplicated, a
backlog overflow relisting, bookmarks advancing the resume point,
unwatch tearing the server's subscription down, a commit burst reaching
a watcher batched and in order, and a client degrading, for its
lifetime, to per-object binds, per-object watch frames or JSON framing
when the server answers ``unknown bus op``; and the port's client
failing a call in flight as soon as its connection drops, not at the
call's timeout.  Every server binds port 0
and is stopped, and every client closed, before its test ends.
"""

from __future__ import annotations

import time

import pytest

from tests.torch_bus_helpers import (  # noqa: F401 — fixtures
    cm, counter, one_torch_thread, pair, Pair, PAIRS, pkg, PKGS, wait)

by_pair = pytest.mark.parametrize("pair", PAIRS, indirect=True, ids=lambda p: "-".join(p))


@pytest.mark.parametrize("name", PKGS)
def test_unreachable_bus_raises_bus_error(name):
    p = pkg(name)
    client = p.RemoteAPIServer("tcp://127.0.0.1:1", timeout=0.3, reconnect_min=0.05)
    try:
        with pytest.raises(p.BusError):
            client.get("ConfigMap", "ns", "x")
    finally:
        client.close()


def test_port_client_takes_one_endpoint():
    """The port's client takes one endpoint at a time: given a
    replicated endpoint list (the reference's failover form) it keeps the
    whole list in ``endpoints``, as the JAX client does, and its
    ``address`` is the one entry of it that it dials now."""
    clients = [pkg(name).RemoteAPIServer("127.0.0.1:1,tcp://127.0.0.1:2", timeout=1)
               for name in ("port", "jax")]
    try:
        assert [c.endpoints for c in clients] == [["tcp://127.0.0.1:1", "tcp://127.0.0.1:2"]] * 2
        assert all("," not in c.address and c.address in c.endpoints for c in clients)
    finally:
        for c in clients:
            c.close()


@pytest.mark.parametrize("server", PKGS)
def test_port_client_fails_a_call_when_its_connection_drops(server):
    """A call whose connection dies before its answer fails as soon as
    the client's reader sees the loss, not at the call's timeout: the
    reader fails the connection's pending calls (the connection thread
    may itself be parked in one, the codec hello or the leader check of
    a fresh dial)."""
    import threading

    pair = Pair("port", server)
    entered, release = threading.Event(), threading.Event()
    get = pair.store.get

    def parked_get(*a, **kw):
        entered.set()
        release.wait(10)
        return get(*a, **kw)

    pair.store.get = parked_get
    out = {}

    def call():
        t0 = time.monotonic()
        try:
            pair.client.get("ConfigMap", "ns", "x")
        except pair.c.ApiError as e:
            out["error"] = e
        out["s"] = time.monotonic() - t0

    caller = threading.Thread(target=call, daemon=True)
    try:
        caller.start()
        assert entered.wait(5), "the server never took the call"
        pair.server.stop()
        caller.join(10)
        assert isinstance(out.get("error"), pair.c.BusError), out
        assert out["s"] < 2.5, f"the call failed after {out['s']:.2f} s (timeout 5 s)"
    finally:
        release.set()
        caller.join(10)
        pair.close()


def _watch(client):
    events = []
    client.watch("ConfigMap", lambda e, o, n: events.append((e, (n or o).metadata.name)))
    return events


@by_pair
def test_reconnect_resumes_watch_without_relist(pair):
    """A connection blip replays the missed suffix from the server
    backlog: no relist, no duplicates, nothing missed."""
    c, client = pair.c, pair.client
    events = _watch(client)
    client.create(cm(c, "a"))
    assert wait(lambda: len(events) == 1)
    relists, reconnects = counter(c, "bus_relists_total"), counter(c, "bus_reconnects_total")
    client._sock.close()  # the blip
    pair.store.create(cm(pair.s, "b"))  # mutation while the client is dark
    assert wait(lambda: ("ADDED", "b") in events, 8), events
    assert events == [("ADDED", "a"), ("ADDED", "b")], events
    assert counter(c, "bus_relists_total") == relists
    assert counter(c, "bus_reconnects_total") > reconnects


@by_pair
def test_server_restart_relists_no_missed_no_duplicated(pair):
    """Kill-and-resume: a new server incarnation (new epoch) on the same
    port answers the resume 410-Gone; the client relists and the handler
    sees exactly the missed deltas."""
    c, s, client = pair.c, pair.s, pair.client
    events = _watch(client)
    client.create(cm(c, "keep"))
    client.create(cm(c, "doomed"))
    assert wait(lambda: len(events) == 2)
    relists = counter(c, "bus_relists_total")
    pair.server.stop()
    pair.store.create(cm(s, "born-in-the-dark"))
    pair.store.delete("ConfigMap", "ns", "doomed")
    pair.restart_server()
    assert wait(lambda: ("ADDED", "born-in-the-dark") in events
                and ("DELETED", "doomed") in events, 15), events
    assert sorted(events) == sorted([("ADDED", "keep"), ("ADDED", "doomed"),
                                     ("ADDED", "born-in-the-dark"), ("DELETED", "doomed")])
    assert counter(c, "bus_relists_total") > relists
    client.create(cm(c, "after"))
    assert wait(lambda: ("ADDED", "after") in events), events


@by_pair
def test_backlog_overflow_forces_relist(pair):
    """A resume older than the backlog window is answered 410-Gone; the
    relist converges with no duplicates."""
    c, s = pair.c, pair.s
    pair.restart_server(backlog_size=3)
    client = pair.new_client()
    events = _watch(client)
    client.create(cm(c, "z0"))
    assert wait(lambda: len(events) == 1)
    relists = counter(c, "bus_relists_total")
    client._sock.close()
    for i in range(1, 8):  # >> backlog_size while disconnected
        pair.store.create(cm(s, f"z{i}"))
    assert wait(lambda: len(events) == 8, 10), events
    assert sorted(events) == sorted(("ADDED", f"z{i}") for i in range(8))
    assert counter(c, "bus_relists_total") > relists


@by_pair
def test_bookmarks_advance_resume_point(pair):
    """Bookmarks carry the bus sequence through quiet periods, so a kind
    with no traffic of its own resumes instead of relisting after churn
    in other kinds."""
    c, s = pair.c, pair.s
    pair.restart_server(backlog_size=4, bookmark_interval=0.05)
    client = pair.new_client()
    events = _watch(client)
    assert wait(lambda: client._watches["ConfigMap"].last_seq is not None, 5)
    for i in range(10):  # another kind, past the backlog depth
        pair.store.create(s.core.PriorityClass(metadata=s.core.ObjectMeta(
            name=f"pc{i}", namespace=""), value=i))
    assert wait(lambda: (client._watches["ConfigMap"].last_seq or 0) >= 10, 5)
    relists = counter(c, "bus_relists_total")
    client._sock.close()
    pair.store.create(cm(s, "fresh"))
    assert wait(lambda: ("ADDED", "fresh") in events, 8), events
    assert counter(c, "bus_relists_total") == relists


@by_pair
def test_unwatch_tears_down_server_subscription(pair):
    """Removing the last handler fully detaches: the server stops
    streaming the kind and the client drops its state; a new watch
    starts from scratch."""
    c, client, server = pair.c, pair.client, pair.server
    events = []

    def handler(e, o, n):
        events.append((n or o).metadata.name)

    client.watch("ConfigMap", handler)
    client.create(cm(c, "seen"))
    assert wait(lambda: "seen" in events)
    assert wait(lambda: sum(len(x) for x in server._subs.values()) == 1)
    client.unwatch("ConfigMap", handler)
    assert wait(lambda: sum(len(x) for x in server._subs.values()) == 0)
    assert wait(lambda: "ConfigMap" not in client._watches)
    client.create(cm(c, "unseen"))
    time.sleep(0.3)
    assert "unseen" not in events
    events2 = []
    client.watch("ConfigMap", lambda e, o, n: events2.append((n or o).metadata.name))
    assert wait(lambda: {"seen", "unseen"} <= set(events2))


@by_pair
def test_commit_burst_delivers_batched_in_order(pair):
    """A commit_batch burst (one store transaction, 40 Events) reaches a
    watching client exactly once each, in store order, through coalesced
    T_WATCH_BATCH frames the server counts."""
    s, client, server = pair.s, pair.client, pair.server
    seen = []
    client.watch("Event", lambda e, o, n: seen.append((n or o).metadata.name),
                 send_initial=False)
    assert wait(lambda: any(conn.batch_watch for conn in server._conns))

    def batches():
        with s.registry._lock:
            hists = s.registry._hists if s.name == "port" else s.registry._histograms
            return sum(h.total for (n, _), h in hists.items()
                       if n.endswith("bus_watch_batch_size"))

    before = batches()
    results = pair.store.commit_batch(events=[
        {"namespace": "ns", "involved": {"kind": "Pod", "namespace": "ns", "name": f"p{i:03d}"},
         "type": "Normal", "reason": f"R{i}", "message": "m"} for i in range(40)])
    assert all(e is None for e in results["events"])
    assert wait(lambda: len(seen) == 40), f"saw {len(seen)}/40"
    assert [n.split(".")[0] for n in seen] == [f"p{i:03d}" for i in range(40)]
    assert len(set(seen)) == 40
    assert batches() > before


def _old_server(monkeypatch, s, ops):
    """Make package ``s``'s server answer ``unknown bus op`` to ``ops``,
    as an older server does."""
    real = s.BusServer._execute

    def old_execute(self, conn, req_id, payload, op):
        if op in ops:
            raise s.ApiError(f"unknown bus op {op!r}")
        return real(self, conn, req_id, payload, op)

    monkeypatch.setattr(s.BusServer, "_execute", old_execute)


@pytest.mark.parametrize("c, s", PAIRS, ids=lambda x: x)
def test_old_server_falls_back_per_object(monkeypatch, c, s):
    """A server without ``commit_batch``, ``watch_batch`` and
    ``bus_hello``: the client binds per object (the same results), keeps
    per-object watch frames and JSON framing, each for its lifetime."""
    _old_server(monkeypatch, pkg(s), {"commit_batch", "watch_batch", "bus_hello"})
    with_pair = Pair(c, s)
    try:
        p, client = with_pair.c, with_pair.client
        core = p.core
        seen = _watch(client)
        client.create(cm(p, "a"))
        client.create(cm(p, "b"))
        assert wait(lambda: len(seen) == 2), seen
        assert seen == [("ADDED", "a"), ("ADDED", "b")]
        client.create(core.Pod(metadata=core.ObjectMeta(name="p0", namespace="ns"),
                               spec=core.PodSpec(), status=core.PodStatus(phase="Pending")))
        results = client.commit_batch(binds=[
            {"namespace": "ns", "name": "p0", "hostname": "n0",
             "event": {"type": "Normal", "reason": "Scheduled", "message": "m"}},
            {"namespace": "ns", "name": "gone", "hostname": "n0"}])
        assert results["binds"][0] is None and "gone" in results["binds"][1]
        assert with_pair.store.get("Pod", "ns", "p0").spec.node_name == "n0"
        assert [e.reason for e in with_pair.store.list("Event")] == ["Scheduled"]
        assert client._no_commit_batch and client._no_watch_batch
        assert client.codec == "json" and not any(
            conn.batch_watch for conn in with_pair.server._conns)
    finally:
        with_pair.close()


@by_pair
def test_codec_negotiation(pair):
    """The hello: binary where both ends have msgpack, the server's
    connection on the same codec."""
    want = "binary" if pair.c.protocol.HAS_BINARY else "json"
    assert wait(lambda: pair.client.codec == want)
    assert wait(lambda: [conn.codec for conn in pair.server._conns] == [want])
