"""Shared pieces of the port's durable-store, replication, ``txn_commit``
and shm tests.

:func:`load` is ``torch_mirror.load`` with a test file's port helpers
replaced in its copy, for either package: ``_spawn_group`` binds each
replica's bus before any manager starts and reads the endpoint list
back, and ``_free_port`` (for the cases that must know a port before
they bind it: a restart on the same port, a joiner named in its own
``--replicas`` list) is ``tests.torch_bus_helpers.reserved_port``: a
port below the kernel's ephemeral range, of a block per pytest worker,
which no port-0 bind of another test can take between the reservation
and the bind.  The listeners here bind such ports too, so they take no
port of the ephemeral range, where the JAX package's own HA tests
reserve theirs.

:func:`run_port` runs a case on the port's copy; :func:`run_paired`
runs it on both copies and compares every store the two runs built
(:func:`ha_dump`, tolerance 0).  :func:`group` starts an in-process
replication group whose replicas may come from either package;
:func:`put_pod` and :func:`pod_names` build and read the objects the
cross-package cases write; ``pkg`` and ``wait`` are
``tests.torch_bus_helpers``'.
"""

from __future__ import annotations

from tests import torch_mirror
from tests.torch_bus_helpers import pkg, reserved_port, wait  # noqa: F401 — the tests' shared names


def _reserved_spawn_group(mod):
    def _spawn_group(tmp_path, n=3, lease_ttl=1.0):
        stores = [mod.PersistentAPIServer(str(tmp_path / f"r{i}")) for i in range(n)]
        buses = [mod.BusServer(store, port=reserved_port()).start() for store in stores]
        endpoints = [f"tcp://127.0.0.1:{bus.port}" for bus in buses]
        replicas = []
        for i, (store, bus) in enumerate(zip(stores, buses)):
            replica = mod._Replica.__new__(mod._Replica)
            replica.store, replica.bus = store, bus
            replica.mgr = mod.ReplicaManager(store, endpoints, i, lease_ttl=lease_ttl)
            bus.replica = replica.mgr
            replica.mgr.start()
            replicas.append(replica)
        return replicas, endpoints

    return _spawn_group


def load(rel: str, pkg: str, port_edits=()):
    """A fresh copy of ``rel`` for ``pkg`` with the port helpers above
    (and ``torch_mirror.load``'s ``port_edits`` in the port's copy)."""
    mod = torch_mirror.load(rel, pkg, port_edits)
    if hasattr(mod, "_free_port"):
        mod._free_port = reserved_port
    if hasattr(mod, "_spawn_group"):
        mod._spawn_group = _reserved_spawn_group(mod)
    return mod


def cases(rel: str, classes) -> list:
    """The ids of ``rel``'s cases in ``classes`` (class names)."""
    return [c for c, _ in torch_mirror.cases(load(rel, "jax")) if c.split("::")[0] in classes]


def run_port(rel: str, case: str, tmp_path):
    mod = load(rel, "port")
    torch_mirror.run_case(mod, case, tmp_path / "port")
    return mod


def ha_dump(api) -> dict:
    """``torch_mirror.store_dump`` with every object's resourceVersion
    by kind, each ConfigMap's data, and a persistent store's event
    sequence, term, membership and what its recovery found."""
    from volcano_tpu_torch.bus import protocol

    out = torch_mirror.store_dump(api)
    out["rvs"] = {kind: sorted((f"{o.metadata.namespace}/{o.metadata.name}",
                                o.metadata.resource_version) for o in api.list(kind))
                  for kind in protocol.KINDS}
    out["configmaps"] = sorted((f"{o.metadata.namespace}/{o.metadata.name}",
                                tuple(sorted((o.data or {}).items())))
                               for o in api.list("ConfigMap"))
    if hasattr(api, "event_seq"):
        out["wal"] = (api.event_seq, api.term, api.membership, dict(api.recovered))
    return out


def run_paired(rel: str, case: str, tmp_path) -> None:
    """``case`` on the port's copy, then on the JAX package's; the
    stores the two runs built are equal, store for store."""
    port = run_port(rel, case, tmp_path)
    ref = load(rel, "jax")
    torch_mirror.run_case(ref, case, tmp_path / "jax")
    assert len(port.STORES) == len(ref.STORES)
    for mine, theirs in zip(port.STORES, ref.STORES):
        assert ha_dump(mine) == ha_dump(theirs)


def put_pod(p, name: str, ns: str = "ns"):
    """A pending Pod of package ``p`` with its one clock-stamped field
    pinned, so two packages' stores of it digest alike."""
    pod = p.core.Pod(metadata=p.core.ObjectMeta(name=name, namespace=ns),
                     spec=p.core.PodSpec(), status=p.core.PodStatus(phase="Pending"))
    pod.metadata.creation_timestamp = 1.0
    return pod


def pod_names(api) -> list:
    return sorted(o.metadata.name for o in api.list("Pod"))


class Replica:
    """One in-process replica of package ``p``: its durable store, its
    manager and its bus server (on a reserved port unless ``port`` is
    given)."""

    def __init__(self, p, data_dir: str, port: int = 0):
        port = port or reserved_port()
        self.p = p
        self.data_dir = data_dir
        self.store = p.wal.PersistentAPIServer(data_dir)
        self.bus = p.BusServer(self.store, port=port).start()
        self.url = f"tcp://127.0.0.1:{self.bus.port}"
        self.mgr = None
        self.alive = True

    def join(self, endpoints, index: int, lease_ttl: float) -> "Replica":
        self.mgr = self.p.replication.ReplicaManager(self.store, endpoints, index,
                                                     lease_ttl=lease_ttl)
        self.bus.replica = self.mgr
        self.mgr.start()
        return self

    @property
    def role(self) -> str:
        return self.mgr.role if self.mgr is not None else "down"

    def kill(self) -> None:
        """Crash-stop: the manager first (its coordinator releases any
        commit parked on the quorum), then the server and the store."""
        if self.mgr is not None:
            self.mgr.stop()
        self.bus.stop()
        self.store.close()
        self.mgr = None
        self.alive = False


def group(tmp_path, packages, lease_ttl: float = 1.0) -> tuple:
    """Replicas of ``packages`` ("port" / "jax", in index order) joined
    into one group; returns ``(replicas, endpoints)``."""
    replicas = [Replica(pkg(name), str(tmp_path / f"r{i}-{name}"))
                for i, name in enumerate(packages)]
    endpoints = [r.url for r in replicas]
    for i, r in enumerate(replicas):
        r.join(endpoints, i, lease_ttl)
    return replicas, endpoints


def stop_all(replicas, *clients) -> None:
    for c in clients:
        if c is not None:
            c.close()
    for r in replicas:
        if r.alive:
            try:
                r.kill()
            except Exception:  # noqa: BLE001 — teardown is best-effort
                pass
