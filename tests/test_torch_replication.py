"""The port's log-shipping replication (``bus/replication.py``, the
replicated server and client) against the JAX package's, on the CPU.

Every replication case of ``tests/test_bus_ha.py`` (a leader killed
mid-stream with no lost or duplicated acknowledged write, the follower's
write proxy, a deposed leader's demotion and resync, ``vtctl bus
status`` over both backends, dynamic membership and its guards, a leader
killed mid-change, pre-vote, the leader hint, the degraded /healthz,
and the slow rolling-kill soak over real processes) and
``tests/test_bus_binary.py``'s ``TestMixedReplicationGroup`` runs on the
port; the cases without a group run on both packages with their stores
compared (``torch_ha_helpers.ha_dump``), the group cases' JAX twins are
the reference files' own (their timing differs between any two runs).
Groups bind on port 0 (``torch_ha_helpers``).

Across packages: a three-replica group mixing the two packages
converges to one ``store_digest`` and byte-identical WAL records with
either package leading, through a failover to the other; ``vtctl bus
status`` of the port prints the JAX ``vtctl``'s text byte for byte over
groups of either package; and the port's ``SchedulerDaemon`` over a port
group, the leader replica killed between its cycles, binds as the JAX
package's over a JAX group, with no relist.
"""

from __future__ import annotations

import io

import pytest

import chip_smoke
from tests import torch_ha_helpers as ha
from tests.torch_bus_helpers import (  # noqa: F401 — fixtures
    conf_file,
    counter,
    cpu_actions,
    one_torch_thread,
    pkg,
    scheduler_daemon,
    to_jax,
)

HA = "tests/test_bus_ha.py"
BINARY = "tests/test_bus_binary.py"
GROUP_FREE = {"TestVtctlBusStatus::test_byte_identical_over_both_backends",
              "TestVtctlBusStatus::test_standalone_store_renders",
              "TestDynamicMembership::test_url_less_follower_votes_under_dynamic_config",
              "TestDynamicMembership::test_proxy_budget_covers_membership_ops",
              "TestLeaderHint::test_not_leader_error_round_trips_with_hint",
              "TestHealthzDegradedReplication::test_below_quorum_and_replica_lagging"}
CASES = ha.cases(HA, ("TestReplicationSmoke", "TestVtctlBusStatus", "TestDynamicMembership",
                      "TestMembershipChaos", "TestPreVote", "TestLeaderHint",
                      "TestHealthzDegradedReplication", "TestRollingLeaderKillSoak"))
PAIRED = [(HA, c) for c in CASES if c in GROUP_FREE]
PORT_ONLY = ([(HA, c) for c in CASES if c not in GROUP_FREE]
             + [(BINARY, c) for c in ha.cases(BINARY, ("TestMixedReplicationGroup",))])


def _param(rel, case):
    slow = case.startswith("TestRollingLeaderKillSoak")
    return pytest.param(rel, case, id=f"{rel.split('/')[-1][:-3]}::{case}",
                        marks=[pytest.mark.slow] if slow else [])


@pytest.mark.parametrize("rel,case", [_param(r, c) for r, c in PAIRED])
def test_case_equal_on_both_packages(rel, case, tmp_path):
    ha.run_paired(rel, case, tmp_path)


@pytest.mark.parametrize("rel,case", [_param(r, c) for r, c in PORT_ONLY])
def test_case_on_the_port(rel, case, tmp_path):
    ha.run_port(rel, case, tmp_path)


def test_every_reference_case_is_mirrored():
    """test_bus_ha.py's 23 replication cases (the soak among them) and
    test_bus_binary.py's 2 mixed-group ones."""
    assert len(CASES) == 23 and len(PAIRED) == 6 and len(PORT_ONLY) == 19


def _roles(replicas) -> list:
    return [r.role for r in replicas]


def _leader(replicas, timeout: float = 20.0):
    assert ha.wait(lambda: [r.role for r in replicas if r.alive].count("leader") == 1
                   and "init" not in [r.role for r in replicas if r.alive], timeout), \
        _roles(replicas)
    return next(r for r in replicas if r.alive and r.role == "leader")


def _converged(replicas, timeout: float = 20.0) -> str:
    """The one store digest of the live replicas (both packages'
    ``store_digest`` read each store alike), once their WALs agree."""
    from volcano_tpu.bus import wal as jax_wal
    from volcano_tpu_torch.bus import wal as port_wal

    live = [r for r in replicas if r.alive]

    def same():
        seqs = {r.store.event_seq for r in live}
        digests = {f.store_digest(r.store) for r in live for f in (port_wal, jax_wal)}
        return len(seqs) == 1 and len(digests) == 1

    assert ha.wait(same, timeout), [(r.p.name, r.store.event_seq) for r in live]
    return port_wal.store_digest(live[0].store)


def _write(p, cli, tag: str) -> None:
    """Creates, a ``cas_bind``, a ``txn_commit`` and a delete through
    ``cli`` (retried while the group has no leader to route to)."""
    def retried(fn, *args):
        for _ in range(200):
            try:
                return fn(*args)
            except p.protocol.NotLeaderError:
                ha.wait(lambda: False, 0.05)
        raise AssertionError("no leader took the write")

    for i in range(4):
        retried(cli.create, ha.put_pod(p, f"{tag}{i}"))
    retried(cli.cas_bind, "ns", f"{tag}0", "n0")
    result = retried(cli.txn_commit, [{"namespace": "ns", "name": f"{tag}{i}",
                                       "hostname": f"n{i}"} for i in (1, 2)])
    assert result["committed"], result
    retried(cli.delete, "Pod", "ns", f"{tag}3")


def _wal_prefix_equal(replicas) -> None:
    import os

    wals = [r.p.wal.read_records(os.path.join(r.data_dir, "wal.log"))[0]
            for r in replicas if r.alive]
    common = min(len(w) for w in wals)
    assert common >= 3
    assert all(w[:common] == wals[0][:common] for w in wals)


@pytest.mark.parametrize("packages", [("port", "jax", "jax"), ("jax", "port", "port")],
                         ids=["port-leads", "jax-leads"])
def test_mixed_group_converges_either_package_leading(packages, tmp_path):
    """Replica 0 (the lowest index promotes first) of one package, the
    other two of the other: writes through a client of the follower
    package converge to one digest and one WAL byte stream; the leader
    killed, the other package leads and the group converges again."""
    replicas, endpoints = ha.group(tmp_path, packages)
    cli = None
    try:
        leader = _leader(replicas)
        assert leader.p.name == packages[0]
        other = ha.pkg(packages[1])
        cli = other.RemoteAPIServer(",".join(endpoints), timeout=10)
        assert cli.wait_ready(10)
        _write(other, cli, "a")
        first = _converged(replicas)
        _wal_prefix_equal(replicas)
        leader.kill()
        new = _leader(replicas)
        assert new.p.name == packages[1]
        assert ha.wait(cli.health, 10)
        _write(other, cli, "b")
        second = _converged(replicas)
        assert second != first
        assert ha.pod_names(new.store) == ["a0", "a1", "a2", "b0", "b1", "b2"]
        _wal_prefix_equal(replicas)
    finally:
        ha.stop_all(replicas, cli)


@pytest.mark.parametrize("group_pkg", ["port", "jax"])
def test_vtctl_bus_status_byte_equal(group_pkg, tmp_path):
    """Over a quiescent group of either package, each replica's ``vtctl
    --bus URL bus status`` text from the port's vtctl is the JAX vtctl's,
    byte for byte (one leader, two followers at lag 0)."""
    replicas, endpoints = ha.group(tmp_path, (group_pkg,) * 3)
    cli = None
    try:
        _leader(replicas)
        p = ha.pkg(group_pkg)
        cli = p.RemoteAPIServer(",".join(endpoints), timeout=10)
        assert cli.wait_ready(10)
        _write(p, cli, "v")
        _converged(replicas)
        roles = []
        for url in endpoints:
            texts = []
            for name in ("port", "jax"):
                buf = io.StringIO()
                assert ha.pkg(name).vtctl(["--bus", url, "bus", "status"], out=buf) == 0
                texts.append(buf.getvalue())
            assert texts[0] == texts[1]
            roles.append(texts[0].splitlines()[0].split()[-1])
            if roles[-1] == "leader":
                rows = [line.split() for line in texts[0].splitlines()
                        if line.startswith("  apiserver-")]
                assert len(rows) == 2 and all(row[2] == "0" for row in rows), texts[0]
        assert sorted(roles) == ["follower", "follower", "leader"]
    finally:
        ha.stop_all(replicas, cli)


def _scheduler_over_group(name: str, tmp_path) -> dict:
    """Package ``name``'s SchedulerDaemon over a group of its own
    package: it binds a small cluster, the leader replica is killed
    between its cycles, the arrivals created through the survivors bind;
    the two digests (read from a follower the kill spares, as
    ``phase_ha`` reads them), and the scheduler's relists over the run
    (this process's counter: the audit's client stays on its follower)."""
    from volcano_tpu_torch.ops.synthetic import generate_cluster_objects

    p = pkg(name)
    objects = generate_cluster_objects(n_tasks=200, n_nodes=20, gang_size=4)
    arrivals = chip_smoke.arrival_objects(jobs=20)
    convert = (lambda objs: list(objs)) if name == "port" else to_jax
    replicas, endpoints = ha.group(tmp_path, (name,) * 3)
    cli = audit_cli = survivors = sched_api = daemon = None
    try:
        leader = _leader(replicas)
        cli = p.RemoteAPIServer(",".join(endpoints), timeout=30)
        assert cli.wait_ready(10)
        chip_smoke.seed_store(cli, [convert(objs) for objs in objects])
        spared = [r.url for r in replicas if r is not leader]
        audit_cli = p.RemoteAPIServer(spared[0], timeout=30)
        assert audit_cli.wait_ready(10)
        audit = chip_smoke.StoreAudit(audit_cli)
        assert not hasattr(audit_cli, "wait_synced") or audit_cli.wait_synced(30)
        relists = counter(p, "bus_relists_total")
        sched_api = p.RemoteAPIServer(",".join(endpoints), timeout=30)
        daemon = scheduler_daemon(name)(
            sched_api, identity=f"{name}-ha", scheduler_conf=conf_file(tmp_path, name),
            schedule_period=0.05, snapshot_reuse=True, pipelined_commit=True,
            leader_elect=False, listen_port=0)
        daemon.start()
        n_pods = len(objects[1])
        assert ha.wait(lambda: chip_smoke.store_settled(audit_cli, audit, n_pods), 120, 0.1), (
            len(audit.bound), daemon.last_error)
        first = audit.digest()
        leader.kill()
        _leader(replicas)
        new = convert(arrivals)
        # through the survivors, each create retried while a follower
        # names no leader yet
        survivors = p.RemoteAPIServer(",".join(spared), timeout=30)
        assert survivors.wait_ready(10)
        for obj in new:
            for _ in range(200):
                try:
                    chip_smoke.create_objects(survivors, [obj])
                    break
                except ha.pkg(name).protocol.NotLeaderError:
                    ha.wait(lambda: False, 0.05)
        keys = {f"{o.metadata.namespace}/{o.metadata.name}" for o in new if o.kind == "Pod"}
        assert ha.wait(lambda: len(chip_smoke.arrival_binds(audit, new)) == len(keys), 120,
                       0.1), daemon.last_error
        assert not audit.rebinds
        return dict(first=first, arrivals=chip_smoke.cycle_digest(
            chip_smoke.arrival_binds(audit, new)),
            relists=counter(p, "bus_relists_total") - relists)
    finally:
        if daemon is not None:
            daemon.stop()
            if daemon.cache._commit_plane is not None:
                daemon.cache.stop_commit_plane()
        ha.stop_all(replicas, cli, audit_cli, survivors, sched_api)


def test_scheduler_over_a_port_group_binds_as_the_jax_one(cpu_actions, tmp_path):
    import volcano_tpu.actions  # noqa: F401 — registers the JAX package's actions
    import volcano_tpu.plugins  # noqa: F401 — registers its plugin builders

    port = _scheduler_over_group("port", tmp_path / "port")
    jax = _scheduler_over_group("jax", tmp_path / "jax")
    assert port == jax
    assert port["relists"] == 0


def test_threaded_seed_keeps_the_store_digest(cpu_actions, monkeypatch):
    """``chip_smoke.seed_group`` (the pods and pod groups created from
    16 threads, in whatever order they interleave) seeds the 10k × 1k
    cell to the same first store cycle as ``seed_store``'s order:
    ``STORE_DIGESTS``, the digest ``phase_ha`` holds the card to."""
    from tests.test_torch_store_loop import port_store_cycles

    monkeypatch.setattr(chip_smoke, "seed_store", chip_smoke.seed_group)
    config = chip_smoke.SECOND_CONFIG
    recs, _, _ = port_store_cycles(chip_smoke.loop_objects(config), chip_smoke.CYCLE_TIERS,
                                   ("gpu-allocate",), 1, "sync")
    assert recs[0]["digest"] == chip_smoke.STORE_DIGESTS[config]
