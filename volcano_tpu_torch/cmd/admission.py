"""vtpu-admission — the admission-webhook daemon.

A copy of ``volcano_tpu/cmd/admission.py``.  As the port's other
binaries, it stops on SIGTERM or SIGINT with exit 0
(``serve_forever``); the reference stops on SIGINT only.

Usage: python -m volcano_tpu_torch.cmd.admission [--bus tcp://host:port]
       [--gate-pods] [--listen-port N] [--flight-recorder]

Reference: cmd/admission/app/server.go:37-99 — registers the webhook
configurations (validate/mutate jobs, validate pods) and serves; here
registration targets the in-process API server's admission chain and
the serving surface carries healthz + metrics.
"""

from __future__ import annotations

import argparse
import os

from volcano_tpu_torch.admission import register_webhooks
from volcano_tpu_torch.client import APIServer
from volcano_tpu_torch.cmd.daemon import apply_faults, env_on, serve_forever, stop_recorder
from volcano_tpu_torch.cmd.scheduler import add_common_args, resolve_bus
from volcano_tpu_torch.serving import ServingServer
from volcano_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


class AdmissionDaemon:
    """The admission binary: webhook registration + serving surface."""

    def __init__(
        self,
        api: APIServer,
        gate_pods: bool = False,
        listen_host: str = "127.0.0.1",
        listen_port: int = 0,
        debug_enabled: bool = False,
        flight_recorder: bool = None,
    ):
        self.api = api
        register_webhooks(api, gate_pods=gate_pods)
        self.serving = ServingServer(
            host=listen_host, port=listen_port, debug_enabled=debug_enabled
        )
        if flight_recorder is None:
            flight_recorder = env_on("VTPU_FLIGHT_RECORDER")
        self.flight_recorder = flight_recorder
        self._obs_exporter = None

    def start(self) -> "AdmissionDaemon":
        from volcano_tpu_torch import metrics

        metrics.set_identity(daemon="admission", role="admission")
        if self.flight_recorder:
            from volcano_tpu_torch import obs

            self._obs_exporter = obs.enable(
                self.api, identity=f"admission-{os.getpid()}"
            )
        self.serving.start()
        log.info("admission daemon serving on :%d", self.serving.port)
        return self

    def stop(self) -> None:
        if self._obs_exporter is not None:
            stop_recorder(self._obs_exporter)
            self._obs_exporter = None
        self.serving.stop()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="vtpu-admission")
    parser.add_argument("--gate-pods", action="store_true")
    add_common_args(parser)
    args = parser.parse_args(argv)
    apply_faults(args.faults)
    return serve_forever(AdmissionDaemon(
        resolve_bus(args.bus),
        gate_pods=args.gate_pods,
        listen_host=args.listen_host,
        listen_port=args.listen_port,
        debug_enabled=args.enable_debug_stacks,
        flight_recorder=True if args.flight_recorder else None,
        # --watchdog is a no-op here: the webhook daemon runs no work
        # loop and owns none of the declared SLO signals
    ))


if __name__ == "__main__":
    raise SystemExit(main())
