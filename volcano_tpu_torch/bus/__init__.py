"""Out-of-process API-server bus: the port of ``volcano_tpu/bus``.

The reference system is independently deployed binaries meeting at a
network API server; this package is that meeting point, on the
reference's VBUS wire, so its peers may be the JAX package's:

* ``BusServer`` serves an in-process ``APIServer`` store over TCP with
  CRUD, list, the coalesced commit frame, the conditional binds and
  watch streams (resume, bookmarks, 410-Gone relist, coalesced watch
  batches).
* ``RemoteAPIServer`` is the drop-in client: the same interface as the
  in-process store, plus reconnect/backoff, informer-grade watch resync
  and failover across an endpoint list.
* ``PersistentAPIServer`` (``wal.py``) is the store with a write-ahead
  log and snapshots; ``replication.py`` ships its log from a leader to
  followers with leader failover; ``shm.py`` is the same-host ring
  transport.
* ``connect_bus`` resolves a ``--bus tcp://host:port`` flag into a
  backend: remote when given, fresh in-process store otherwise.

Run the server with ``python -m volcano_tpu_torch.cmd.apiserver``.
"""

from volcano_tpu_torch.bus.protocol import (
    BusError,
    BusTimeoutError,
    parse_bus_endpoints,
    parse_bus_url,
)
from volcano_tpu_torch.bus.remote import RemoteAPIServer
from volcano_tpu_torch.bus.server import BusServer
from volcano_tpu_torch.bus.wal import PersistentAPIServer


def connect_bus(bus: str = "", timeout: float = 10.0, wait: float = 30.0):
    """``--bus`` flag resolution shared by the binaries: an address
    returns a ``RemoteAPIServer`` that is already reachable — or raises
    ``BusError`` after ``wait`` seconds, so misconfiguration fails
    loudly at startup instead of as an endless reconnect loop behind a
    green healthz.  The address may be a comma-separated endpoint list
    (``tcp://a,tcp://b`` — replicated apiservers); the client dials
    across the list and fails over on replica death.  Empty returns a
    standalone in-process
    ``APIServer``."""
    if bus:
        api = RemoteAPIServer(bus, timeout=timeout)
        if not api.wait_ready(wait):
            api.close()
            raise BusError(f"bus {bus} unreachable after {wait:.0f}s")
        return api
    from volcano_tpu_torch.client.apiserver import APIServer

    return APIServer()


__all__ = [
    "BusError",
    "BusServer",
    "BusTimeoutError",
    "PersistentAPIServer",
    "RemoteAPIServer",
    "connect_bus",
    "parse_bus_endpoints",
    "parse_bus_url",
]
