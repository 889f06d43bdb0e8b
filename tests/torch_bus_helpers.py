"""Shared pieces of the port's bus, elector and daemon tests.

``PKGS`` names the two packages; :func:`pkg` gives one package's API
types, store, bus server and client, durable store, replication, shm
transport, vtctl, elector and metrics registry under the same names, so a test runs the same steps against either, and
:class:`Pair` joins a client of one package to a bus server of the
other over TCP (a reserved port, every socket closed in ``close``).
"""

from __future__ import annotations

import itertools
import os
import shutil
import socket
import tempfile
import time
from types import SimpleNamespace

import pytest

PKGS = ("port", "jax")
PAIRS = [(c, s) for c in PKGS for s in PKGS]

#: the kernel hands out ephemeral ports from 32768 up; reserved ports
#: come from below it, 1,500 for each pytest worker
_RESERVED_BASE = 20_000
_RESERVED_BLOCK = 1_500
_reserved = itertools.count()


def _worker_index() -> int:
    name = os.environ.get("PYTEST_XDIST_WORKER", "")
    return int(name[2:]) % 8 if name.startswith("gw") else 7


def reserved_port() -> int:
    """A free port of this worker's block (bound and closed to check).
    A test's listener binds one instead of port 0, so it takes no port
    of the ephemeral range: the JAX package's HA tests reserve theirs
    there by bind-and-close, and a port-0 bind of another worker between
    their reservation and their bind made them fail (address in use)."""
    base = _RESERVED_BASE + _worker_index() * _RESERVED_BLOCK
    for _ in range(_RESERVED_BLOCK):
        port = base + next(_reserved) % _RESERVED_BLOCK
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port
    raise RuntimeError("no reserved port left in this worker's block")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread keeps the suite's parallel workers from
    contending for every core (imported by each bus and leader test
    module, where it is autouse)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def shm_env():
    """For a test that switches the shm transport on in this process
    (``local_up --multiproc`` and the apiserver's ``--shm`` set
    ``VTPU_BUS_SHM=1`` here): its ring directories go under a temporary
    directory of its own (short: a unix socket's path is limited), and
    both variables are restored after it, so later tests on the worker
    stay on TCP."""
    names = ("VTPU_BUS_SHM", "VTPU_BUS_SHM_DIR")
    saved = {k: os.environ.get(k) for k in names}
    d = tempfile.mkdtemp(prefix="vshm")
    os.environ.pop("VTPU_BUS_SHM", None)
    os.environ["VTPU_BUS_SHM_DIR"] = d
    try:
        yield d
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(d, ignore_errors=True)


def pkg(name: str) -> SimpleNamespace:
    """One package's bus surface by the same names."""
    if name == "port":
        from volcano_tpu_torch import metrics
        from volcano_tpu_torch.apis import core, scheduling
        from volcano_tpu_torch.bus import protocol, server
        from volcano_tpu_torch.bus import BusError, BusServer, RemoteAPIServer
        from volcano_tpu_torch.bus import replication, shm, wal
        from volcano_tpu_torch.cli.vtctl import main as vtctl
        from volcano_tpu_torch.client import apiserver
        from volcano_tpu_torch.serving import leader
        registry = metrics.registry
    else:
        from volcano_tpu.apis import core, scheduling
        from volcano_tpu.bus import protocol, server
        from volcano_tpu.bus import BusError, BusServer, RemoteAPIServer
        from volcano_tpu.bus import replication, shm, wal
        from volcano_tpu.cli.vtctl import main as vtctl
        from volcano_tpu.client import apiserver
        from volcano_tpu.metrics import metrics
        from volcano_tpu.serving import leader
        registry = metrics.registry
    return SimpleNamespace(
        name=name, core=core, scheduling=scheduling, protocol=protocol, server=server,
        wal=wal, replication=replication, shm=shm, vtctl=vtctl,
        BusError=BusError, BusServer=BusServer, RemoteAPIServer=RemoteAPIServer,
        APIServer=apiserver.APIServer, ApiError=apiserver.ApiError,
        NotFoundError=apiserver.NotFoundError, ConflictError=apiserver.ConflictError,
        AlreadyExistsError=apiserver.AlreadyExistsError, AdmissionError=apiserver.AdmissionError,
        LeaderElector=leader.LeaderElector, LEASE_KEY=leader.LEASE_KEY, registry=registry)


def wait(pred, timeout: float = 10.0, interval: float = 0.02) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


def cm(p, name: str, ns: str = "ns", data=None):
    """A ConfigMap of package ``p``."""
    return p.core.ConfigMap(metadata=p.core.ObjectMeta(name=name, namespace=ns),
                            data=data or {})


def counter(p, suffix: str) -> float:
    """The sum of package ``p``'s counters whose name ends in ``suffix``."""
    with p.registry._lock:
        return sum(v for (name, _labels), v in p.registry._counters.items()
                   if name.endswith(suffix))


class Pair:
    """A bus server of package ``server`` on its own store, and clients
    of package ``client`` connected to it; ``close`` closes them all."""

    def __init__(self, client: str, server: str, **server_kw):
        self.c, self.s = pkg(client), pkg(server)
        self.store = self.s.APIServer()
        server_kw.setdefault("bookmark_interval", 0.1)
        self.server = self.s.BusServer(self.store, host="127.0.0.1", port=reserved_port(),
                                       **server_kw).start()
        self.port = self.server.port
        self._clients = []
        self.client = self.new_client()

    @property
    def url(self) -> str:
        return f"tcp://127.0.0.1:{self.port}"

    def new_client(self, **kw):
        kw.setdefault("timeout", 5)
        kw.setdefault("reconnect_min", 0.02)
        client = self.c.RemoteAPIServer(self.url, **kw)
        self._clients.append(client)
        assert client.wait_ready(5)
        return client

    def restart_server(self, **server_kw):
        """Stop the server and start a new incarnation on the same port
        and store."""
        self.server.stop()
        server_kw.setdefault("bookmark_interval", 0.1)
        self.server = self.s.BusServer(self.store, host="127.0.0.1", port=self.port,
                                       **server_kw).start()

    def close(self) -> None:
        for client in self._clients:
            client.close()
        self.server.stop()


@pytest.fixture
def pair(request):
    """A ``Pair`` for ``request.param`` = (client package, server
    package), closed after the test."""
    p = Pair(*request.param)
    yield p
    p.close()


def to_jax(objs) -> list:
    """The port's API objects as the JAX package's, through dicts."""
    from volcano_tpu.apis import core, scheduling

    classes = {"Node": core.Node, "Pod": core.Pod, "PodGroup": scheduling.PodGroup,
               "Queue": scheduling.Queue, "PriorityClass": core.PriorityClass}
    return [classes[o.kind].from_dict(o.to_dict()) for o in objs]


def scheduler_daemon(name: str):
    """Package ``name``'s SchedulerDaemon class."""
    if name == "port":
        from volcano_tpu_torch.cmd.scheduler import SchedulerDaemon
    else:
        from volcano_tpu.cmd.scheduler import SchedulerDaemon
    return SchedulerDaemon


def conf_file(tmp_path, name: str) -> str:
    """The headline policy file with package ``name``'s allocate action
    (gpu-allocate for the port, jax-allocate for the JAX package)."""
    import chip_smoke

    action = "gpu-allocate" if name == "port" else "jax-allocate"
    path = tmp_path / f"{name}.conf"
    path.write_text(chip_smoke.loop_conf_text(chip_smoke.CYCLE_TIERS, (action,)))
    return str(path)


def settle(daemon, api, audit, n_pods: int, timeout: float = 120.0) -> None:
    """Wait until every pod is bound with its Scheduled Event and every
    PodGroup Running at store truth, and the daemon's commit plane is
    empty; the daemon's cycles must not have raised."""
    import chip_smoke

    assert wait(lambda: chip_smoke.store_settled(api, audit, n_pods), timeout, 0.1), (
        f"{len(audit.bound)}/{n_pods} bound; last error {daemon.last_error}")
    plane = daemon.cache._commit_plane
    if plane is not None:
        assert plane.barrier(timeout)
    assert daemon.last_error is None, daemon.last_error


def daemon_run(name: str, objects, tmp_path, api=None, takeover: bool = False,
               arrivals=None, lease: float = 0.5, pipelined: bool = True,
               timeout: float = 120.0) -> dict:
    """Package ``name``'s SchedulerDaemon A on a store seeded with the
    port's ``objects`` (converted for the JAX package): A binds them
    (``settle``).  With ``takeover``: B starts on the same store; the
    daemon that has held the lease alone for a lease period crash-stops
    (A, unless B took A's lease while A's renews waited behind B's
    informer sync under the store lock, as the reference's elector
    allows), ``arrivals`` (``chip_smoke.arrival_objects``) are created
    and the other, the standby, binds them.  ``api``, if given, is the daemons' store
    (a ``RemoteAPIServer``, say), seeded by the caller; the audit then
    watches it too.  Returns the store digests, the audit and the store
    (``store``) — every daemon stopped and its commit plane too."""
    import chip_smoke

    cls = scheduler_daemon(name)
    convert = (lambda objs: list(objs)) if name == "port" else to_jax
    if api is None:
        api = pkg(name).APIServer()
        audit = chip_smoke.StoreAudit(api)
        chip_smoke.seed_store(api, [convert(objs) for objs in objects])
    else:
        audit = chip_smoke.StoreAudit(api)
        if hasattr(api, "wait_synced"):
            assert api.wait_synced(30)
    n_pods = len(objects[1])
    conf = conf_file(tmp_path, name)
    kw = dict(scheduler_conf=conf, schedule_period=0.05, snapshot_reuse=True,
              pipelined_commit=pipelined, leader_elect=takeover, lease_duration=lease,
              retry_period=0.05, listen_port=0)
    daemons = []
    try:
        a = cls(api, identity=f"{name}-a", **kw)
        daemons.append(a)
        a.start()
        settle(a, api, audit, n_pods, timeout)
        out = dict(first=audit.digest(), audit=audit, store=api)
        if takeover:
            b = cls(api, identity=f"{name}-b", **kw)
            daemons.append(b)
            b.start()
            leader = chip_smoke.steady_leader((a, b), lease + kw["retry_period"], timeout,
                                              "a steady leader after B's start")
            standby = b if leader is a else a
            leader.stop(crash=True)
            cycles = standby.cycles
            new = convert(arrivals)
            chip_smoke.create_objects(api, new)
            keys = {f"{o.metadata.namespace}/{o.metadata.name}" for o in new if o.kind == "Pod"}
            assert wait(lambda: len(chip_smoke.arrival_binds(audit, new)) == len(keys),
                        timeout, 0.1), standby.last_error
            settle(standby, api, audit, n_pods + len(keys), timeout)
            assert leader.last_error is None and standby.cycles > cycles
            out.update(arrivals=chip_smoke.cycle_digest(chip_smoke.arrival_binds(audit, new)))
        assert not audit.rebinds
        return out
    finally:
        for d in daemons:
            d.stop()
            if d.cache._commit_plane is not None:
                d.cache.stop_commit_plane()


@pytest.fixture
def cpu_actions():
    """The port's device actions on the CPU for one test (what the
    scheduler binary's ``--device cpu`` registers), the registry's
    instances restored after."""
    from volcano_tpu_torch.cmd.scheduler import use_device
    from volcano_tpu_torch.framework import get_action, register_action

    saved = [get_action(n) for n in ("gpu-allocate", "gpu-preempt", "gpu-reclaim")]
    use_device("cpu")
    yield
    for action in saved:
        register_action(action)
