"""The port's conditional binds, ``cas_bind`` (VBUS v4) and
``txn_commit`` (v6), against the JAX package's, on the CPU.

Every case of ``tests/test_txn_commit.py`` (atomicity in process, wire
parity, the pre-v6 server's abort, one WAL record a transaction
replayed whole, a WAL failure rolling every bind back, the op registry)
and of ``tests/test_bus.py``'s ``TestCasBind`` (the bind over the wire,
a stale resourceVersion, the pre-v4 server's get + CAS-update fallback)
runs on the port and on the JAX package, and the stores the two runs
built are equal (``torch_ha_helpers.ha_dump``, tolerance 0).  The
replicated case (a gang through a follower lands as one record on every
replica) runs on the port; its replicas' membership names their ports,
which differ between two runs.

Across packages: a client of either package against a server of either
gives the same binds, the same typed conflicts and the same per-item
abort results, and each client's old-peer path (per-object CAS for
``cas_bind``, an abort for ``txn_commit``) against the other package's
server without the op.
"""

from __future__ import annotations

import pytest

from tests import torch_ha_helpers as ha
from tests.torch_bus_helpers import PAIRS, Pair, one_torch_thread, pair  # noqa: F401

TXN = "tests/test_txn_commit.py"
BUS = "tests/test_bus.py"
PAIRED = ([(TXN, c) for c in ha.cases(TXN, ("TestTxnCommitInProcess", "TestTxnCommitOverBus",
                                             "TestTxnCommitDurability", "TestOpRegistry"))]
          + [(BUS, c) for c in ha.cases(BUS, ("TestCasBind",))])
PORT_ONLY = [(TXN, c) for c in ha.cases(TXN, ("TestTxnCommitReplication",))]


def _ids(cases):
    return [f"{rel.split('/')[-1][:-3]}::{c}" for rel, c in cases]


@pytest.mark.parametrize("rel,case", PAIRED, ids=_ids(PAIRED))
def test_case_equal_on_both_packages(rel, case, tmp_path):
    ha.run_paired(rel, case, tmp_path)


@pytest.mark.parametrize("rel,case", PORT_ONLY, ids=_ids(PORT_ONLY))
def test_case_on_the_port(rel, case, tmp_path):
    ha.run_port(rel, case, tmp_path)


def test_every_reference_case_is_mirrored():
    """test_txn_commit.py's 14 cases and test_bus.py's 3 cas_bind ones."""
    assert len(PAIRED) + len(PORT_ONLY) == 17


def _binds(api, names, rv=True):
    out = []
    for i, name in enumerate(names):
        item = {"namespace": "ns", "name": name, "hostname": f"n{i}"}
        if rv:
            item["expected_rv"] = api.get("Pod", "ns", name).metadata.resource_version
        out.append(item)
    return out


def _drive(pair: Pair) -> dict:
    """cas_bind and txn_commit through ``pair``'s client: what came back
    and what the server's store holds after."""
    p, cli, store = ha.pkg(pair.c.name), pair.client, pair.store
    for name in ("a", "b", "c", "d", "e"):
        cli.create(ha.put_pod(p, name))
    out = {"bound": cli.cas_bind("ns", "a", "n9",
                                 expected_rv=cli.get("Pod", "ns", "a").metadata.resource_version)
           .spec.node_name}
    for args in (("ns", "a", "n8"), ("ns", "zz", "n1")):
        with pytest.raises(pair.c.ApiError) as err:
            cli.cas_bind(*args)
        out.setdefault("errors", []).append(type(err.value).__name__)
    committed = cli.txn_commit(_binds(cli, ["b", "c"]))
    out["commit"] = (committed["committed"], committed["results"],
                     [o.spec.node_name for o in committed["objects"]])
    stale = _binds(cli, ["d", "e"])
    store.cas_bind("ns", "e", "raced")
    aborted = cli.txn_commit(stale)
    out["abort"] = (aborted["committed"], aborted["results"][0],
                    aborted["results"][1].split(":")[0], aborted["objects"])
    out["store"] = {o.metadata.name: o.spec.node_name for o in store.list("Pod")}
    return out


@pytest.mark.parametrize("pair", PAIRS, indirect=True, ids=[f"{c}-client-{s}-server"
                                                           for c, s in PAIRS])
def test_conditional_binds_across_packages(pair):
    assert _drive(pair) == {
        "bound": "n9", "errors": ["ConflictError", "NotFoundError"],
        "commit": (True, [None, None], ["n0", "n1"]),
        "abort": (False, None, "ConflictError", []),
        "store": {"a": "n9", "b": "n0", "c": "n1", "d": "", "e": "raced"}}


@pytest.mark.parametrize("client,server", [("port", "jax"), ("jax", "port")])
def test_old_peer_paths_across_packages(client, server, monkeypatch):
    """The server of one package without the two ops (they answer
    ``unknown bus op``, as a pre-v4 server does): the other package's
    client binds through get + CAS update and aborts a transaction,
    binding nothing."""
    s = ha.pkg(server)
    real = s.BusServer._execute

    def old_execute(self, conn, req_id, payload, op):
        if op in ("cas_bind", "txn_commit"):
            raise s.protocol.ApiError(f"unknown bus op {op!r}")
        return real(self, conn, req_id, payload, op)

    monkeypatch.setattr(s.BusServer, "_execute", old_execute)
    pair = Pair(client, server)
    try:
        p, cli = ha.pkg(client), pair.client
        for name in ("a", "b", "c"):
            cli.create(ha.put_pod(p, name))
        assert cli.cas_bind("ns", "a", "n1").spec.node_name == "n1"
        assert cli._no_cas_bind is True
        result = cli.txn_commit(_binds(cli, ["b", "c"]))
        assert (result["committed"], result["reason"]) == (False, "unsupported")
        assert cli._no_txn_commit is True
        assert {o.metadata.name: o.spec.node_name for o in pair.store.list("Pod")} == {
            "a": "n1", "b": "", "c": ""}
    finally:
        pair.close()
