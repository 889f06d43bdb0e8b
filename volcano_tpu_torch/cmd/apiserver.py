"""vtpu-apiserver — the standalone API-server daemon.

The port of ``volcano_tpu/cmd/apiserver.py``.  The reference deploys Kubernetes' API server as the bus all
binaries meet at; this is the standalone build's equivalent: the
in-process object store (client/apiserver.py) served over TCP by
``bus.BusServer``, plus the standard serving surface (healthz +
/metrics) every other daemon carries.

With this daemon up, a scheduler connects with ``--bus tcp://host:port``
(the port's, or the JAX package's: the wire is the same), and the
system runs as the reference's multi-process deployment topology,
including cross-process leader election (the scheduler's ConfigMap
lease lives on this store).

Durability and HA:

* ``--data-dir DIR`` swaps the volatile store for
  ``bus.PersistentAPIServer`` — every store transaction is WAL'd and
  fsynced before acking, snapshots rotate the log every
  ``--snapshot-every`` records, and a restart with the same dir resumes
  watch cursors instead of forcing a relist.
* ``--replicas tcp://a,tcp://b,... --replica-index I`` joins this
  daemon to a replication group (requires ``--data-dir``): one leader
  takes writes, followers replicate its WAL and serve reads and
  watches, and a SIGKILLed leader is replaced by the most advanced
  survivor within one lease TTL (``--repl-lease-ttl``).  Point clients
  at the whole list: ``--bus tcp://a,tcp://b,...``.
* ``--shm`` (or ``VTPU_BUS_SHM=1``) also listens on the same-host shm
  rings (bus/shm.py) next to TCP.

Usage: python -m volcano_tpu_torch.cmd.apiserver [--port 7180]
       [--listen-port 8083] [--seed-nodes N] [--data-dir DIR]
       [--snapshot-every N] [--replicas LIST --replica-index I]
       [--repl-lease-ttl S] [--shm] [--flight-recorder]
       [--watchdog] [--incident-dir DIR]

``--port 0`` binds a free port; the daemon logs the ports it bound
(``apiserver up: bus on :P, metrics on :M``).  SIGTERM and SIGINT stop
it.  The store advertises the /metrics address on ``bus_status`` (how
``vtctl top`` finds it).  ``--flight-recorder`` records the server side
of every traced request (the ``bus:<op>`` span adopted from the
client's context) into the store's telemetry segments; ``--watchdog``
evaluates the SLOs over this daemon's own metrics, degrading /healthz
and writing incident bundles under ``--incident-dir`` at a breach.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional

from volcano_tpu_torch import obs
from volcano_tpu_torch.apis import core, scheduling
from volcano_tpu_torch.bus.server import BusServer
from volcano_tpu_torch.bus.wal import PersistentAPIServer
from volcano_tpu_torch.client.apiserver import AlreadyExistsError, ApiError, APIServer
from volcano_tpu_torch.client.clients import KubeClient, VolcanoClient
from volcano_tpu_torch.faults.breaker import degraded_reasons
from volcano_tpu_torch.serving import ServingServer
from volcano_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

DEFAULT_BUS_PORT = 7180
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
    """The apiserver binary: store + bus listener + serving surface,
    optionally durable (``data_dir``) and replicated (``replicas``)."""

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
        data_dir: str = "",
        snapshot_every: int = 256,
        replicas: Optional[List[str]] = None,
        replica_index: int = 0,
        repl_lease_ttl: float = 2.0,
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
        self.replica_index = replica_index
        #: the identity on the recorder's segments and the incident
        #: bundles: replica i is ``apiserver-<i>``
        self.identity = f"apiserver-{replica_index}"
        self.replica = None
        if api is not None:
            self.api = api
        elif data_dir:
            t0 = time.perf_counter()
            self.api = PersistentAPIServer(data_dir, snapshot_every=snapshot_every,
                                           backlog_keep=backlog_size)
            rec = self.api.recovered
            log.info("store recovered from %s in %.1f ms: snapshot %s, %d WAL records, "
                     "torn tail %s, seq %d", data_dir, (time.perf_counter() - t0) * 1e3,
                     rec["snapshot"], rec["wal_records"], rec["torn"], self.api.event_seq)
            # the SIGKILL-mid-commit chaos point (bus.leader_kill)
            self.api.kill_hook = lambda: os._exit(137)
        else:
            self.api = APIServer()
        if replicas and len(replicas) > 1:
            if not isinstance(self.api, PersistentAPIServer):
                raise ValueError("--replicas requires --data-dir (replication ships "
                                 "WAL records; a volatile store has none)")
            from volcano_tpu_torch.bus.replication import ReplicaManager

            # the identity `role` label follows the replication role in
            # both directions via metrics.update_repl_role
            self.replica = ReplicaManager(self.api, replicas, replica_index,
                                          lease_ttl=repl_lease_ttl,
                                          on_became_leader=self._seed_if_configured)
        if self.watchdog_enabled:
            self.incidents, self.watchdog = watchdog_pair(self.api, self.identity,
                                                          self.incident_dir)
        self.bus = BusServer(
            self.api, host=listen_host, port=bus_port,
            backlog_size=backlog_size, bookmark_interval=bookmark_interval,
            replica=self.replica,
        )
        self.serving = ServingServer(
            host=listen_host, port=listen_port,
            health_check=lambda: self.bus.running,
            debug_enabled=debug_enabled,
            degraded_source=self._degraded,
        )
        #: synthetic node pool + default queue on startup (idempotent).
        #: A real cluster's nodes arrive from kubelets; the standalone
        #: build's arrive from whoever owns the store.  In a replication
        #: group only the leader may write, so seeding runs from the
        #: became-leader hook instead of start().
        self.seed_nodes = seed_nodes
        self.seed_node_cpu = seed_node_cpu
        self.seed_node_mem = seed_node_mem

    #: a live voter lagging more than this many entries degrades the
    #: leader's /healthz (still 200 — the daemon serves; the body flags
    #: that a failover now would pay a snapshot resync)
    REPL_LAG_DEGRADED = 512

    def _degraded(self) -> Optional[str]:
        """``/healthz`` degraded body: replication state first, then the
        breaker registry's reasons, then the watchdog's active
        ``slo-burn:<name>`` breaches.

        * ``below-quorum`` — a leader that could not commit a write now
          (live voters < quorum), or a follower that cannot name a
          leader (mid-election or partitioned).
        * ``replica-lagging`` — quorum holds but the worst live voter
          trails by more than REPL_LAG_DEGRADED entries.
        """
        rep = self.replica
        if rep is not None:
            with rep._lock:  # noqa: SLF001 — same-package status read
                role = rep.role
                coord = rep.coordinator
                leader = rep.leader_url
            if role == "leader" and coord is not None:
                health = coord.quorum_health(rep.lease_ttl)
                if health["live"] < health["quorum"]:
                    return "below-quorum"
                if health["max_lag"] > self.REPL_LAG_DEGRADED:
                    return "replica-lagging"
            elif role in ("follower", "init") and leader is None:
                return "below-quorum"
        reasons = list(degraded_reasons())
        if self.watchdog is not None:
            reasons.extend(self.watchdog.degraded_reasons())
        return ", ".join(reasons) if reasons else None

    def _seed_if_configured(self) -> None:
        if self.seed_nodes <= 0:
            return
        # quorum forms as followers attach: retry until the writes land
        # (idempotent — AlreadyExists is a no-op in seed_cluster), loud
        # about persistent failure; a leader that lost leadership stands
        # down, the new leader seeds
        attempt = 0
        while True:
            if self.replica is not None and not self.replica.is_leader:
                log.info("seed attempt stands down: no longer the leader")
                return
            try:
                seed_cluster(self.api, self.seed_nodes, self.seed_node_cpu, self.seed_node_mem)
                return
            except ApiError as e:
                attempt += 1
                level = log.error if attempt % 10 == 0 else log.warning
                level("cluster seeding failing (attempt %d): %s", attempt, e)
                time.sleep(min(0.5 * attempt, 5.0))

    def start(self) -> "ApiServerDaemon":
        from volcano_tpu_torch import metrics

        metrics.set_identity(daemon="apiserver", replica_index=str(self.replica_index),
                             role="standalone" if self.replica is None else "follower")
        if self.seed_nodes > 0 and self.replica is None:
            self._seed_if_configured()
        self.bus.start()
        self.serving.start()
        # advertised on bus_status so `vtctl top` can discover this
        # daemon's /metrics by dialing the bus
        self.api.metrics_address = f"{self.serving.host}:{self.serving.port}"
        if self.flight_recorder:
            self._obs_exporter = obs.enable(self.api, identity=self.identity)
        if self.watchdog is not None:
            self.watchdog.start()
        if self.replica is not None:
            self.replica.start()
        log.info("apiserver up: bus on :%d, metrics on :%d%s", self.bus.port, self.serving.port,
                 f", replica {self.replica.identity} of {self.replica.replica_count}"
                 if self.replica else "")
        return self

    def stop(self) -> None:
        if self.watchdog is not None:
            self.watchdog.stop()
        if self.replica is not None:
            self.replica.stop()
        self.bus.stop()
        if self._obs_exporter is not None:
            # after the bus, which adds server spans until it stops
            from volcano_tpu_torch.cmd.daemon import stop_recorder

            stop_recorder(self._obs_exporter)
            self._obs_exporter = None
        self.serving.stop()
        close = getattr(self.api, "close", None)
        if close is not None:
            close()


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
        "(the standalone cluster's kubelet substitute; 0 = off; in a "
        "replication group the leader seeds after election)",
    )
    parser.add_argument("--seed-node-cpu", default="8")
    parser.add_argument("--seed-node-mem", default="32Gi")
    parser.add_argument(
        "--data-dir", default="",
        help="WAL + snapshot directory: store transactions are fsynced "
        "before acking and a restart resumes watch cursors (empty = "
        "volatile in-memory store)",
    )
    parser.add_argument(
        "--snapshot-every", type=int, default=256,
        help="rotate the WAL into a full snapshot every N records",
    )
    parser.add_argument(
        "--replicas", default="",
        help="comma-separated endpoint list of the whole replication "
        "group (this replica included), e.g. tcp://a:7180,tcp://b:7180; "
        "requires --data-dir",
    )
    parser.add_argument(
        "--replica-index", type=int, default=0,
        help="this daemon's position in the --replicas list",
    )
    parser.add_argument(
        "--repl-lease-ttl", type=float, default=2.0,
        help="leader-liveness lease: a follower that cannot reach the "
        "leader for this long triggers an election",
    )
    parser.add_argument(
        "--faults", default="",
        help="deterministic fault-injection schedule (bus.* / wal.* / "
        "repl.* points fire server-side here; same grammar as "
        "VTPU_FAULTS)",
    )
    parser.add_argument(
        "--flight-recorder", action="store_true",
        help="record bus-op / WAL-fsync / quorum-wait spans for traced "
        "requests and export them as telemetry segments "
        "(volcano_tpu_torch/obs; also VTPU_FLIGHT_RECORDER=1)",
    )
    parser.add_argument(
        "--watchdog", action="store_true",
        help="SLO burn-rate watchdog over this replica's own metrics "
        "(repl lag, commit failures, breaker state); breaches degrade "
        "/healthz and write incident bundles (also VTPU_WATCHDOG=1)",
    )
    parser.add_argument(
        "--incident-dir", default=None,
        help="incident-bundle ring directory (also VTPU_INCIDENT_DIR)",
    )
    parser.add_argument(
        "--shm", action="store_true",
        help="also listen on the same-host shared-memory ring transport "
        "(bus/shm.py; also VTPU_BUS_SHM=1 — what local_up --multiproc "
        "sets); clients fall back to TCP on attach failure",
    )
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from volcano_tpu_torch.cmd.daemon import apply_faults, serve_forever

    apply_faults(args.faults)
    if args.shm:
        os.environ["VTPU_BUS_SHM"] = "1"
    replicas = [u.strip() for u in args.replicas.split(",") if u.strip()]
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
        data_dir=args.data_dir,
        snapshot_every=args.snapshot_every,
        replicas=replicas,
        replica_index=args.replica_index,
        repl_lease_ttl=args.repl_lease_ttl,
    ))


if __name__ == "__main__":
    raise SystemExit(main())
