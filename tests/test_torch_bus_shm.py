"""The port's same-host shm transport (``bus/shm.py``) against the JAX
package's, on the CPU.

Both cases of ``tests/test_bus_binary.py``'s ``TestShmTransport`` (the
conformance pass over the rings with a 64 KiB ring wrapped several
times, and the silent TCP fallback when no listener rendezvouses) run on
the port and on the JAX package, and the stores the two runs built are
equal (``torch_ha_helpers.ha_dump``, tolerance 0).  Across packages a
client of either attaches the rings of a server of either (the ring
layout and the attach handshake are the same) and passes the same
conformance, watch events included; a client with an endpoint list
attaches the rings of the endpoint it dials.  ``chip_smoke.shm_rings``,
which the card run reads to prove the scheduler child's connection is on
the rings, finds the two ring files this process mapped.
"""

from __future__ import annotations

import os

import pytest

import chip_smoke
from tests import torch_ha_helpers as ha
from tests.torch_bus_helpers import one_torch_thread  # noqa: F401

BINARY = "tests/test_bus_binary.py"
PAIRED = ha.cases(BINARY, ("TestShmTransport",))
needs_shm = pytest.mark.skipif(not ha.pkg("port").shm._HAS_EVENTFD,
                               reason="no eventfd/fd-passing on this platform")


@pytest.mark.parametrize("case", PAIRED)
def test_case_equal_on_both_packages(case, tmp_path):
    ha.run_paired(BINARY, case, tmp_path)


def test_every_reference_case_is_mirrored():
    assert len(PAIRED) == 2


def _conformance(p, client, store) -> list:
    seen = []
    client.watch("ConfigMap", lambda e, o, n: seen.append((e, (n or o).metadata.name)),
                 send_initial=False)
    blob = "x" * 8192
    for i in range(12):
        cm = p.core.ConfigMap(metadata=p.core.ObjectMeta(name=f"c{i:02d}", namespace="ns"),
                              data={"blob": blob})
        client.create(cm)
    got = client.get("ConfigMap", "ns", "c11")
    assert got.data["blob"] == blob
    client.delete("ConfigMap", "ns", "c00")
    assert store.get("ConfigMap", "ns", "c00") is None
    assert ha.wait(lambda: len(seen) == 13), seen
    return seen


@needs_shm
@pytest.mark.parametrize("client,server", [("port", "jax"), ("jax", "port"), ("port", "port")])
def test_rings_across_packages(client, server, tmp_path, monkeypatch):
    monkeypatch.setenv("VTPU_BUS_SHM", "1")
    monkeypatch.setenv("VTPU_BUS_SHM_DIR", str(tmp_path / "shm"))
    c, s = ha.pkg(client), ha.pkg(server)
    monkeypatch.setattr(c.shm, "DEFAULT_RING_BYTES", 64 * 1024)
    store = s.APIServer()
    srv = s.BusServer(store, bookmark_interval=0.1).start()
    cli = c.RemoteAPIServer(f"tcp://127.0.0.1:{srv.port}", timeout=5)
    try:
        assert srv._shm_listener is not None
        assert cli.wait_ready(5)
        assert ha.wait(lambda: isinstance(cli._sock, c.shm.ShmSocket))
        seen = _conformance(c, cli, store)
        assert seen[-1] == ("DELETED", "c00")
        # both ends live in this process: each ring file mapped twice
        rings = chip_smoke.shm_rings(os.getpid(), str(tmp_path / "shm"))
        assert [r.split("-")[0] for r in rings] == ["c2s", "c2s", "s2c", "s2c"]
    finally:
        cli.close()
        srv.stop()


@needs_shm
def test_endpoint_list_attaches_the_dialed_endpoint(tmp_path, monkeypatch):
    """A client given two endpoints, the first dead: it rotates to the
    second and attaches that server's rings."""
    monkeypatch.setenv("VTPU_BUS_SHM", "1")
    monkeypatch.setenv("VTPU_BUS_SHM_DIR", str(tmp_path / "shm"))
    p = ha.pkg("port")
    store = p.APIServer()
    srv = p.BusServer(store, bookmark_interval=0.1).start()
    dead = ha.reserved_port()
    cli = p.RemoteAPIServer(f"tcp://127.0.0.1:{dead},tcp://127.0.0.1:{srv.port}", timeout=5,
                            reconnect_min=0.01)
    try:
        assert cli.wait_ready(10)
        assert cli.address == f"tcp://127.0.0.1:{srv.port}"
        assert isinstance(cli._sock, p.shm.ShmSocket)
        _conformance(p, cli, store)
    finally:
        cli.close()
        srv.stop()
