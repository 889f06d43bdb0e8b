"""vtpu-apiserver — the standalone API-server daemon.

The port of ``volcano_tpu/cmd/apiserver.py`` on the volatile in-memory
store.  The reference deploys Kubernetes' API server as the bus all
binaries meet at; this is the standalone build's equivalent: the
in-process object store (client/apiserver.py) served over TCP by
``bus.BusServer``, plus the standard serving surface (healthz +
/metrics) every other daemon carries.

With this daemon up, a scheduler connects with ``--bus tcp://host:port``
(the port's, or the JAX package's: the wire is the same), and the
system runs as the reference's multi-process deployment topology,
including cross-process leader election (the scheduler's ConfigMap
lease lives on this store).

Usage: python -m volcano_tpu_torch.cmd.apiserver [--port 7180]
       [--listen-port 8083] [--seed-nodes N] [--flight-recorder]
       [--watchdog] [--incident-dir DIR]

``--port 0`` binds a free port; the daemon logs the ports it bound
(``apiserver up: bus on :P, metrics on :M``).  SIGTERM and SIGINT stop
it.  The store advertises the /metrics address on ``bus_status`` (how
``vtctl top`` finds it).  ``--flight-recorder`` records the server side
of every traced request (the ``bus:<op>`` span adopted from the
client's context) into the store's telemetry segments; ``--watchdog``
evaluates the SLOs over this daemon's own metrics, degrading /healthz
and writing incident bundles under ``--incident-dir`` at a breach.  Not
present in the port yet: the durable and replicated store
(``--data-dir``, ``--snapshot-every``, ``--replicas``,
``--replica-index``, ``--repl-lease-ttl``: WAL and replication) and the
shm listener (``--shm``); the parser refuses them.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

from volcano_tpu_torch import obs
from volcano_tpu_torch.apis import core, scheduling
from volcano_tpu_torch.bus.server import BusServer
from volcano_tpu_torch.client.apiserver import AlreadyExistsError, APIServer
from volcano_tpu_torch.client.clients import KubeClient, VolcanoClient
from volcano_tpu_torch.faults.breaker import degraded_reasons
from volcano_tpu_torch.serving import ServingServer
from volcano_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

DEFAULT_BUS_PORT = 7180
#: the standalone store's identity on the recorder's segments and the
#: incident bundles (the reference names replica i ``apiserver-<i>``)
IDENTITY = "apiserver-0"


def _build_node(name: str, cpu: str, mem: str):
    alloc = {"cpu": cpu, "memory": mem, "pods": "110"}
    return core.Node(
        metadata=core.ObjectMeta(name=name, namespace=""),
        spec=core.NodeSpec(),
        status=core.NodeStatus(allocatable=dict(alloc), capacity=dict(alloc)),
    )


def seed_cluster(api, nodes: int, node_cpu: str, node_mem: str) -> None:
    """Create the synthetic node pool + default queue (idempotent, so a
    re-run against a live external bus is safe).  A copy of
    ``volcano_tpu/cmd/local_up.seed_cluster``."""
    kube = KubeClient(api)
    vc = VolcanoClient(api)
    for i in range(nodes):
        try:
            kube.create_node(_build_node(f"node-{i}", node_cpu, node_mem))
        except AlreadyExistsError:
            pass
    try:
        vc.create_queue(
            scheduling.Queue(metadata=core.ObjectMeta(name="default", namespace=""))
        )
    except AlreadyExistsError:
        pass


class ApiServerDaemon:
    """The apiserver binary: store + bus listener + serving surface."""

    def __init__(
        self,
        api: Optional[APIServer] = None,
        listen_host: str = "127.0.0.1",
        bus_port: int = DEFAULT_BUS_PORT,
        listen_port: int = 0,
        backlog_size: int = 4096,
        bookmark_interval: float = 2.0,
        debug_enabled: bool = False,
        seed_nodes: int = 0,
        seed_node_cpu: str = "8",
        seed_node_mem: str = "32Gi",
        flight_recorder: Optional[bool] = None,
        watchdog: Optional[bool] = None,
        incident_dir: Optional[str] = None,
    ):
        from volcano_tpu_torch.cmd.daemon import env_on, watchdog_pair

        if flight_recorder is None:
            flight_recorder = env_on("VTPU_FLIGHT_RECORDER")
        self.flight_recorder = flight_recorder
        self._obs_exporter = None
        if watchdog is None:
            watchdog = env_on("VTPU_WATCHDOG")
        if incident_dir is None:
            incident_dir = os.environ.get("VTPU_INCIDENT_DIR", "")
        self.watchdog_enabled = watchdog
        self.incident_dir = incident_dir
        self.watchdog = None
        self.incidents = None
        self.api = api if api is not None else APIServer()
        if self.watchdog_enabled:
            self.incidents, self.watchdog = watchdog_pair(self.api, IDENTITY,
                                                          self.incident_dir)
        self.bus = BusServer(
            self.api, host=listen_host, port=bus_port,
            backlog_size=backlog_size, bookmark_interval=bookmark_interval,
        )
        self.serving = ServingServer(
            host=listen_host, port=listen_port,
            health_check=lambda: self.bus.running,
            debug_enabled=debug_enabled,
            degraded_source=self._degraded,
        )
        #: synthetic node pool + default queue on startup (idempotent).
        #: A real cluster's nodes arrive from kubelets; the standalone
        #: build's arrive from whoever owns the store.
        self.seed_nodes = seed_nodes
        self.seed_node_cpu = seed_node_cpu
        self.seed_node_mem = seed_node_mem

    def _degraded(self) -> Optional[str]:
        """``/healthz`` degraded body: the breaker registry's reasons,
        then the watchdog's active ``slo-burn:<name>`` breaches."""
        reasons = list(degraded_reasons())
        if self.watchdog is not None:
            reasons.extend(self.watchdog.degraded_reasons())
        return ", ".join(reasons) if reasons else None

    def start(self) -> "ApiServerDaemon":
        from volcano_tpu_torch import metrics

        metrics.set_identity(daemon="apiserver", replica_index="0", role="standalone")
        if self.seed_nodes > 0:
            seed_cluster(self.api, self.seed_nodes, self.seed_node_cpu, self.seed_node_mem)
        self.bus.start()
        self.serving.start()
        # advertised on bus_status so `vtctl top` can discover this
        # daemon's /metrics by dialing the bus
        self.api.metrics_address = f"{self.serving.host}:{self.serving.port}"
        if self.flight_recorder:
            self._obs_exporter = obs.enable(self.api, identity=IDENTITY)
        if self.watchdog is not None:
            self.watchdog.start()
        log.info("apiserver up: bus on :%d, metrics on :%d", self.bus.port, self.serving.port)
        return self

    def stop(self) -> None:
        if self.watchdog is not None:
            self.watchdog.stop()
        self.bus.stop()
        if self._obs_exporter is not None:
            # after the bus, which adds server spans until it stops
            from volcano_tpu_torch.cmd.daemon import stop_recorder

            stop_recorder(self._obs_exporter)
            self._obs_exporter = None
        self.serving.stop()


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="vtpu-apiserver")
    parser.add_argument("--listen-host", default="127.0.0.1")
    parser.add_argument(
        "--port", type=int, default=DEFAULT_BUS_PORT,
        help="bus TCP port the daemons connect to (0 = a free port, logged)",
    )
    parser.add_argument(
        "--listen-port", type=int, default=8083,
        help="healthz/metrics HTTP port",
    )
    parser.add_argument(
        "--backlog-size", type=int, default=4096,
        help="watch-event backlog depth; resumes older than this relist",
    )
    parser.add_argument("--bookmark-interval", type=float, default=2.0)
    parser.add_argument("--enable-debug-stacks", action="store_true")
    parser.add_argument(
        "--seed-nodes", type=int, default=0,
        help="create a synthetic node pool + default queue on startup "
        "(the standalone cluster's kubelet substitute; 0 = off)",
    )
    parser.add_argument("--seed-node-cpu", default="8")
    parser.add_argument("--seed-node-mem", default="32Gi")
    parser.add_argument(
        "--faults", default="",
        help="deterministic fault-injection schedule (bus.* points fire "
        "server-side here; same grammar as VTPU_FAULTS)",
    )
    parser.add_argument(
        "--flight-recorder", action="store_true",
        help="record bus-op spans for traced requests and export them as "
        "telemetry segments (volcano_tpu_torch/obs; also "
        "VTPU_FLIGHT_RECORDER=1)",
    )
    parser.add_argument(
        "--watchdog", action="store_true",
        help="SLO burn-rate watchdog over this daemon's own metrics "
        "(commit failures, breaker state); breaches degrade /healthz and "
        "write incident bundles (also VTPU_WATCHDOG=1)",
    )
    parser.add_argument(
        "--incident-dir", default=None,
        help="incident-bundle ring directory (also VTPU_INCIDENT_DIR)",
    )
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from volcano_tpu_torch.cmd.daemon import apply_faults, serve_forever

    apply_faults(args.faults)
    return serve_forever(ApiServerDaemon(
        listen_host=args.listen_host,
        bus_port=args.port,
        listen_port=args.listen_port,
        backlog_size=args.backlog_size,
        bookmark_interval=args.bookmark_interval,
        debug_enabled=args.enable_debug_stacks,
        seed_nodes=args.seed_nodes,
        seed_node_cpu=args.seed_node_cpu,
        seed_node_mem=args.seed_node_mem,
        flight_recorder=True if args.flight_recorder else None,
        watchdog=True if args.watchdog else None,
        incident_dir=args.incident_dir,
    ))


if __name__ == "__main__":
    raise SystemExit(main())
