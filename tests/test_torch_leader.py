"""The port's ConfigMap-lock leader election (``serving/leader.py``)
against the JAX package's.

The cases of ``tests/test_serving.py`` (one winner and a takeover after a
crash, the CAS preventing double leadership, the wall-clock renew time)
and ``tests/test_bus.py``'s transient-renew-failure case on the port's
elector; then across packages: a port elector and a JAX elector compete
for one lock on one store through the bus (same ConfigMap, annotation
key and JSON fields), exactly one leads and the other takes over after
a crash; electors on two bus connections across every client × server
pair; and the lease against the store lock: while a test holds
``api.locked()`` for the lease and a second more, each package's leader
stops leading as its renew waits, and leads again once it is released.
"""

from __future__ import annotations

import json
import time

import pytest

from tests.torch_bus_helpers import (  # noqa: F401 — fixtures
    cpu_actions, one_torch_thread, pair, PAIRS, pkg, PKGS, wait)

PORT = pkg("port")


@pytest.fixture(autouse=True)
def _port_identity():
    """A daemon started here stamps the port registry's identity labels;
    clear them for later tests (the JAX registry's are cleared by
    conftest)."""
    yield
    PORT.registry.set_identity()


def test_elector_cas_prevents_double_leadership():
    api = PORT.APIServer()
    e1 = PORT.LeaderElector(api, "lock", "id-1", lease_duration=0.5, retry_period=0.02).start()
    e2 = PORT.LeaderElector(api, "lock", "id-2", lease_duration=0.5, retry_period=0.02).start()
    try:
        assert wait(lambda: e1.is_leader or e2.is_leader)
        for _ in range(20):
            assert not (e1.is_leader and e2.is_leader)
            time.sleep(0.02)
        leader, standby = (e1, e2) if e1.is_leader else (e2, e1)
        leader.stop(release=True)  # graceful release hands over quickly
        assert wait(lambda: standby.is_leader, timeout=5)
    finally:
        e1.stop()
        e2.stop()


def test_leader_renew_time_is_wall_clock():
    """A live lease written by another process, stamped with wall time,
    holds a standby off; an expired one is taken."""
    api = PORT.APIServer()
    api.create(PORT.core.ConfigMap(
        metadata=PORT.core.ObjectMeta(name="lock", namespace="volcano-system"),
        data={PORT.LEASE_KEY: json.dumps({"holderIdentity": "other-process",
                                          "leaseDurationSeconds": 2.0,
                                          "renewTime": time.time()})}))
    e = PORT.LeaderElector(api, "lock", "standby", lease_duration=0.5, retry_period=0.05)
    assert not e._try_acquire_or_renew(), "stole a live foreign lease"
    cm, _ = e._read()
    cm.data = {PORT.LEASE_KEY: json.dumps({"holderIdentity": "other-process",
                                           "leaseDurationSeconds": 0.2,
                                           "renewTime": time.time() - 5.0})}
    api.compare_and_update(cm, cm.metadata.resource_version)
    assert e._try_acquire_or_renew(), "did not take an expired lease"


def test_leader_survives_transient_renew_failure_within_lease():
    """A dropped request does not flap leadership; failures outlasting
    the lease do; the bus back, leadership returns."""
    api = PORT.APIServer()

    class FlakyApi:
        def __init__(self, inner):
            self._inner = inner
            self.down = False

        def __getattr__(self, name):
            attr = getattr(self._inner, name)
            if not callable(attr):
                return attr

            def call(*a, **kw):
                if self.down:
                    raise PORT.ApiError("bus unreachable")
                return attr(*a, **kw)

            return call

    flaky = FlakyApi(api)
    e = PORT.LeaderElector(flaky, "lock", "id-1", lease_duration=1.0, retry_period=0.05).start()
    try:
        assert wait(lambda: e.is_leader, 5)
        flaky.down = True
        time.sleep(0.3)
        assert e.is_leader, "transient renew failure flapped leadership"
        assert wait(lambda: not e.is_leader, 5)
        flaky.down = False
        assert wait(lambda: e.is_leader, 5)
    finally:
        e.stop()


def test_daemons_single_winner_and_takeover(cpu_actions):
    """Two scheduler daemons of the port, one lock: only the leader runs
    cycles; a crashed leader (no release) hands over after expiry."""
    from volcano_tpu_torch.cmd.scheduler import SchedulerDaemon

    api = PORT.APIServer()
    kw = dict(schedule_period=0.05, leader_elect=True, lease_duration=0.5, retry_period=0.05)
    a = SchedulerDaemon(api, identity="sched-a", **kw).start()
    b = None
    try:
        assert wait(lambda: a.elector.is_leader), "first daemon never led"
        b = SchedulerDaemon(api, identity="sched-b", **kw).start()
        time.sleep(0.5)  # time for b to (wrongly) schedule if election were broken
        assert a.elector.is_leader and not b.elector.is_leader
        assert a.cycles > 0 and b.cycles == 0
        a.stop(crash=True)
        assert wait(lambda: b.elector.is_leader, timeout=10)
        before = b.cycles
        assert wait(lambda: b.cycles > before), "new leader never scheduled"
        assert a.last_error is None and b.last_error is None
    finally:
        a.stop()
        if b is not None:
            b.stop()


@pytest.mark.parametrize("server", PKGS)
def test_port_and_jax_electors_share_one_lock(server):
    """A port elector and a JAX elector on one store through the bus:
    exactly one leads; the record is the reference's (one ConfigMap, the
    same annotation key and fields); after a crash of the leader
    (``stop(release=False)``) the other takes over."""
    s = pkg(server)
    store = s.APIServer()
    srv = s.BusServer(store, bookmark_interval=0.1).start()
    url = f"tcp://127.0.0.1:{srv.port}"
    jax = pkg("jax")
    clients = [PORT.RemoteAPIServer(url, timeout=5), jax.RemoteAPIServer(url, timeout=5)]
    electors = []
    try:
        for p, c, ident in ((PORT, clients[0], "port-id"), (jax, clients[1], "jax-id")):
            assert c.wait_ready(5)
            electors.append(p.LeaderElector(c, "lock", ident, lease_duration=0.5,
                                            retry_period=0.05).start())
        assert wait(lambda: any(e.is_leader for e in electors), 10)
        for _ in range(20):
            assert sum(e.is_leader for e in electors) <= 1
            time.sleep(0.02)
        assert PORT.LEASE_KEY == jax.LEASE_KEY
        leader = next(e for e in electors if e.is_leader)
        cms = store.list("ConfigMap")
        assert [(c.metadata.namespace, c.metadata.name) for c in cms] == [
            ("volcano-system", "lock")]
        record = json.loads(cms[0].data[PORT.LEASE_KEY])
        assert set(record) == {"holderIdentity", "leaseDurationSeconds", "renewTime"}
        assert record["holderIdentity"] == leader.identity
        standby = next(e for e in electors if e is not leader)
        leader.stop(release=False)
        assert wait(lambda: standby.is_leader, 10), "standby never took over"
    finally:
        for e in electors:
            e.stop()
        for c in clients:
            c.close()
        srv.stop()


@pytest.mark.parametrize("pair", PAIRS, indirect=True, ids=lambda p: "-".join(p))
def test_election_across_connections_with_crash_takeover(pair):
    """Two electors of the client package on two bus connections: one
    lease winner; a crashed leader is succeeded after expiry."""
    c = pair.c
    e1 = c.LeaderElector(pair.client, "lock", "id-1", lease_duration=0.5,
                         retry_period=0.05).start()
    e2 = c.LeaderElector(pair.new_client(), "lock", "id-2", lease_duration=0.5,
                         retry_period=0.05).start()
    try:
        assert wait(lambda: e1.is_leader or e2.is_leader, 10)
        for _ in range(10):
            assert not (e1.is_leader and e2.is_leader)
            time.sleep(0.02)
        leader, standby = (e1, e2) if e1.is_leader else (e2, e1)
        leader.stop(release=False)
        assert wait(lambda: standby.is_leader, 10), "standby never took over through the bus"
    finally:
        e1.stop()
        e2.stop()


@pytest.mark.parametrize("name", PKGS)
def test_leader_lapses_while_its_renew_waits_on_the_store_lock(name):
    """The lease against the store lock: a commit frame holding the store
    lock past the lease (here the test holds ``api.locked()`` for the
    lease and a second more) makes the renew wait; ``is_leader`` expires
    on the lease clock meanwhile, and once the lock is released the same
    identity, whose lease nobody else took, leads again."""
    p = pkg(name)
    api = p.APIServer()
    lease = 1.0
    e = p.LeaderElector(api, "lock", f"{name}-id", lease_duration=lease,
                        retry_period=0.05).start()
    try:
        assert wait(lambda: e.is_leader, 5)
        with api.locked():
            t0 = time.monotonic()
            lapsed = wait(lambda: not e.is_leader, lease + 0.5, 0.01)
            lapsed_after = time.monotonic() - t0
            time.sleep(max(0.0, lease + 1.0 - (time.monotonic() - t0)))
            assert not e.is_leader
        assert lapsed and lapsed_after <= lease + 0.5
        assert wait(lambda: e.is_leader, 5), "did not lead again after the lock was released"
        cm, rec = e._read()
        assert rec["holderIdentity"] == f"{name}-id"
    finally:
        e.stop()


def test_daemon_counts_the_turns_and_the_renew_gap_the_store_lock_costs():
    """The port's own account of that window: while the lock is held past
    the lease the daemon's loop skips its turns (``skipped_turns``), and
    the elector's longest gap between renews while leading
    (``max_renew_gap``) covers the time the lock was held; the daemon's
    ``status()`` reports both."""
    from volcano_tpu_torch.cmd.daemon import BaseDaemon

    class Idle(BaseDaemon):
        def _work(self):
            pass

    api = PORT.APIServer()
    lease = 1.0
    d = Idle(api, period=0.02, leader_elect=True, identity="idle", lease_duration=lease,
             retry_period=0.05).start()
    try:
        assert wait(lambda: d.elector.is_leader and d.cycles > 0, 5)
        assert d.skipped_turns == 0 and d.elector.renews > 0
        with api.locked():
            time.sleep(lease + 1.0)
        assert wait(lambda: d.elector.is_leader, 5)
        cycles = d.cycles
        assert wait(lambda: d.cycles > cycles, 5)
        status = d.status()
        assert status["skipped_turns"] > 0 and status["failed_cycles"] == 0
        assert status["max_renew_gap_ms"] >= (lease + 0.5) * 1e3
        assert status["leading"] and status["renews"] == d.elector.renews
    finally:
        d.stop()
