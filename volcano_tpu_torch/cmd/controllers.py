"""vtpu-controllers — the controller-manager daemon.

A copy of ``volcano_tpu/cmd/controllers.py``.

Usage: python -m volcano_tpu_torch.cmd.controllers [--bus tcp://host:port]
       [--period S] [--leader-elect --leader-elect-id ID] [--listen-port N]

Reference: cmd/controllers/app/server.go:78-149 — leader-elected
``startControllers`` launching job/queue/garbage/podgroup controllers,
plus the healthz/metrics serving surface.
"""

from __future__ import annotations

import argparse

from volcano_tpu_torch.client import APIServer  # noqa: F401 — the in-process default
from volcano_tpu_torch.cmd.daemon import BaseDaemon, serve_forever
from volcano_tpu_torch.cmd.daemon import apply_faults
from volcano_tpu_torch.cmd.scheduler import add_common_args, resolve_bus
from volcano_tpu_torch.controllers import (
    GarbageCollector,
    JobController,
    PodGroupController,
    QueueController,
)


class ControllersDaemon(BaseDaemon):
    """The controller-manager binary: all controllers on one drain loop."""

    LOCK_NAME = "vtpu-controllers"
    NAME = "vtpu-controllers"

    def __init__(self, api: APIServer, period: float = 0.2, **daemon_kw):
        super().__init__(api, period=period, **daemon_kw)
        self.job_controller = JobController(api)
        self.queue_controller = QueueController(api)
        self.podgroup_controller = PodGroupController(api)
        self.gc = GarbageCollector(api)

    def drain(self) -> None:
        """One pass over every controller's work queue."""
        self.job_controller.drain()
        self.podgroup_controller.drain()
        self.queue_controller.drain()
        self.gc.process_expired()

    def _work(self) -> None:
        self.drain()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="vtpu-controllers")
    parser.add_argument("--period", type=float, default=0.2)
    add_common_args(parser)
    args = parser.parse_args(argv)
    apply_faults(args.faults)
    return serve_forever(
        ControllersDaemon(
            resolve_bus(args.bus),
            period=args.period,
            listen_host=args.listen_host,
            listen_port=args.listen_port,
            leader_elect=args.leader_elect,
            identity=args.leader_elect_id,
            debug_enabled=args.enable_debug_stacks,
            flight_recorder=True if args.flight_recorder else None,
            watchdog=True if args.watchdog else None,
            incident_dir=args.incident_dir,
        )
    )


if __name__ == "__main__":
    raise SystemExit(main())
