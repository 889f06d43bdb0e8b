"""Compute-plane sidecar entry point.

The port of ``volcano_tpu/cmd/compute_plane.py``.  The scheduler
process runs the control plane; this process owns the GPU and serves
the CUDA session and preempt kernels over the versioned socket protocol
(serving/compute_plane.py).  Colocate it with the card and point the
scheduler at it with ``VTPU_COMPUTE_PLANE=<socket>`` (or
``ops.executor.configure``); if it dies, the scheduler's executors run
in-process (counted, logged) and re-probe.

Usage: python -m volcano_tpu_torch.cmd.compute_plane --socket /run/vtpu.sock
       [--warmup] [--faults SPEC] [--device cuda|cpu]

``--device`` defaults to ``cuda`` and the process exits at start when
there is no GPU.  SIGUSR1 logs one line, ``compute plane status:``
and a JSON object: the kernel launches since start (``session`` and
``session_wide`` of csrc/session_kernel.cu, ``preempt`` of
csrc/preempt_kernel.cu), the bytes of device memory this process
holds (``memory_reserved``) and the timings of its latest requests
(``requests``, serving/compute_plane.recent_requests).  SIGTERM and
SIGINT stop the server.
"""

from __future__ import annotations

import argparse
import json
import signal
import threading

from volcano_tpu_torch.cmd.daemon import apply_faults, kernel_status
from volcano_tpu_torch.serving.compute_plane import (
    ComputePlaneServer,
    recent_requests,
    serving_device,
)
from volcano_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def status() -> dict:
    """Kernel launches made in this process, the device memory it
    holds, and its latest requests' timings."""
    return dict(kernel_status(), requests=list(recent_requests))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="vtpu-compute-plane")
    parser.add_argument("--socket", default="/tmp/vtpu-compute-plane.sock")
    parser.add_argument(
        "--warmup", action="store_true",
        help="build the kernel library and launch the session kernel once "
        "before serving",
    )
    parser.add_argument(
        "--faults", default="",
        help="deterministic fault-injection schedule (compute.* and "
        "device.* points fire in this process; same grammar as "
        "VTPU_FAULTS)",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="where the kernels run: cuda (the default; no GPU is an error) "
        "or cpu (the plain PyTorch versions)",
    )
    args = parser.parse_args(argv)
    apply_faults(args.faults)

    device = serving_device(args.device)  # no GPU → exit before any work
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    signal.signal(signal.SIGUSR1,
                  lambda *_: log.info("compute plane status: %s", json.dumps(status())))
    if args.warmup:
        # the first real session then pays neither the build nor the
        # first launch
        from volcano_tpu_torch.ops.dispatch import warmup_kernels

        warmup_kernels(device=device)  # times and logs itself
    server = ComputePlaneServer(args.socket, device=device).start()
    try:
        while not stop.wait(3600):
            pass
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
