"""The port's durable store (``bus/wal.py``) against the JAX package's,
on the CPU.

Every case of ``tests/test_bus_ha.py``'s WAL classes (framing, CRC,
recovery of the store, the sequence, the epoch and the backlog, one
record a transaction, snapshot rotation, the truncation sweep over every
byte of the last record, the fault points ``wal.write_fail``,
``wal.torn_tail``, ``wal.fsync_delay`` and ``bus.leader_kill``,
membership records, the durability metrics) and of
``tests/test_bus_binary.py``'s ``TestWalCodecTwins`` runs on the port
and on the JAX package, and the stores the two runs built are equal
(``torch_ha_helpers.ha_dump``, tolerance 0).  The restart-resume cases,
whose run time is the client's reconnect timeout, run on the port; their
JAX twins are the reference file's own.

The on-disk format is an interface: a data directory written by one
package (creates, updates, ``cas_bind``, ``commit_batch``,
``txn_commit``, deletes, membership records, snapshot rotations, a torn
tail) recovers in the other with an equal ``store_digest``, event
sequence, epoch, term, CRC chain, membership and backlog, in either
record codec, and the other package's writes on top recover in the
first.
"""

from __future__ import annotations

import os

import pytest

from tests import torch_ha_helpers as ha
from tests.torch_bus_helpers import one_torch_thread  # noqa: F401

HA = "tests/test_bus_ha.py"
BINARY = "tests/test_bus_binary.py"
PAIRED = ([(HA, c) for c in ha.cases(HA, ("TestWalRecovery", "TestWalFaults",
                                           "TestMembershipWal", "TestHaMetrics"))]
          + [(BINARY, c) for c in ha.cases(BINARY, ("TestWalCodecTwins",))])
PORT_ONLY = [(HA, c) for c in ha.cases(HA, ("TestRestartResume",))]


def _ids(cases):
    return [f"{rel.split('/')[-1][:-3]}::{c}" for rel, c in cases]


@pytest.mark.parametrize("rel,case", PAIRED, ids=_ids(PAIRED))
def test_case_equal_on_both_packages(rel, case, tmp_path):
    ha.run_paired(rel, case, tmp_path)


@pytest.mark.parametrize("rel,case", PORT_ONLY, ids=_ids(PORT_ONLY))
def test_case_on_the_port(rel, case, tmp_path):
    ha.run_port(rel, case, tmp_path)


def test_every_reference_case_is_mirrored():
    """The WAL classes hold 16 cases of test_bus_ha.py (the fault sweep
    counted per point) and 3 of test_bus_binary.py."""
    assert len(PAIRED) == 19 and len(PORT_ONLY) == 2


def _workload(p, d: str, codec: str, monkeypatch, first: bool) -> None:
    """Writes of every transaction kind through package ``p``'s store
    at ``d``, snapshot rotation every 5 records included."""
    monkeypatch.setenv("VTPU_WAL_CODEC", codec)
    api = p.wal.PersistentAPIServer(d, snapshot_every=5)
    try:
        tag = "a" if first else "b"
        for i in range(6):
            api.create(ha.put_pod(p, f"{tag}{i}"))
        pod = api.get("Pod", "ns", f"{tag}0")
        api.cas_bind("ns", f"{tag}0", "n0", expected_rv=pod.metadata.resource_version)
        api.commit_batch(binds=[{"namespace": "ns", "name": f"{tag}1", "hostname": "n1"}])
        result = api.txn_commit([{"namespace": "ns", "name": f"{tag}{i}", "hostname": f"n{i}"}
                                 for i in (2, 3)])
        assert result["committed"]
        api.delete("Pod", "ns", f"{tag}5")
        cm = p.core.ConfigMap(metadata=p.core.ObjectMeta(name=f"cm-{tag}", namespace="ns"),
                              data={"k": tag})
        cm.metadata.creation_timestamp = 1.0
        api.create(cm)
        api.log_membership({"epoch": 1 if first else 2, "endpoints": ["tcp://h:1"]})
        api.set_term(3 if first else 4)
    finally:
        api.close()


def _state(p, d: str) -> dict:
    api = p.wal.PersistentAPIServer(d, snapshot_every=5)
    try:
        from volcano_tpu.bus import wal as jax_wal
        from volcano_tpu_torch.bus import wal as port_wal

        digest = port_wal.store_digest(api)
        assert jax_wal.store_digest(api) == digest
        return dict(digest=digest, seq=api.event_seq, epoch=api.epoch, term=api.term,
                    chain=api.chain, membership=api.membership_config(),
                    backlog=[(e["seq"], e["kind"], e["event"]) for e in api.recent_events()],
                    pods=ha.pod_names(api))
    finally:
        api.close()


@pytest.mark.parametrize("codec", ["json", "binary"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_data_dir_crosses_packages(writer, reader, codec, tmp_path, monkeypatch):
    w, r = ha.pkg(writer), ha.pkg(reader)
    d = str(tmp_path / "data")
    _workload(w, d, codec, monkeypatch, first=True)
    assert os.path.exists(os.path.join(d, "snapshot.json"))
    # a torn tail: half of a record reaches disk after the last whole one
    with open(os.path.join(d, "wal.log"), "ab") as f:
        f.write(b"\x40\x00\x00\x00\x01")
    written = _state(w, d)
    recovered = _state(r, d)
    assert recovered == written
    _workload(r, d, codec, monkeypatch, first=False)
    assert _state(w, d) == _state(r, d)
    assert _state(w, d)["pods"] == sorted([f"a{i}" for i in range(5)] +
                                          [f"b{i}" for i in range(5)])


def test_bus_status_payloads_agree(tmp_path, monkeypatch):
    """The two packages' ``bus_status`` of one data directory carry the
    same fields with the same values, the fsync clock readings apart."""
    monkeypatch.setenv("VTPU_WAL_CODEC", "json")
    d = str(tmp_path / "data")
    _workload(ha.pkg("jax"), d, "json", monkeypatch, first=True)
    status = {}
    for name in ("port", "jax"):
        api = ha.pkg(name).wal.PersistentAPIServer(d, snapshot_every=5)
        try:
            s = api.bus_status()
        finally:
            api.close()
        status[name] = {k: v for k, v in s.items() if k not in ("last_fsync_ts", "last_fsync_ms")}
    assert status["port"] == status["jax"]
