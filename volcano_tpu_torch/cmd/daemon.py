"""Shared daemon scaffolding: serving surface + leader election + the
guarded work loop, and the flag helpers the binaries share.

A copy of ``volcano_tpu/cmd/daemon.py`` without the flight recorder, the
SLO watchdog and the incident bundles (they wait for ``obs``): a daemon
of the port takes none of their parameters, and its /healthz reads
degraded on open breakers, the serving default.
"""

from __future__ import annotations

import signal
import threading
import uuid
from typing import Optional

from volcano_tpu_torch import faults
from volcano_tpu_torch.client import APIServer
from volcano_tpu_torch.serving import LeaderElector, ServingServer
from volcano_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


class BaseDaemon:
    """Work loop + serving + optional leader election.

    Subclasses set ``LOCK_NAME``/``NAME`` and implement ``_work()`` (one
    cycle).  The loop is exception-guarded — a failing cycle is logged
    and retried, never silently killing the thread — and ``/healthz``
    reflects actual loop liveness, not just process liveness.  Beyond
    the reference, the daemon counts the cycles that raised
    (``failed_cycles``; ``last_error`` clears at the next good cycle)
    and the loop turns skipped for want of the lease after it first led
    (``skipped_turns``), and ``status()`` reports them."""

    LOCK_NAME = "vtpu-daemon"
    NAME = "daemon"

    def __init__(
        self,
        api: APIServer,
        period: float = 0.2,
        listen_host: str = "127.0.0.1",
        listen_port: int = 0,
        leader_elect: bool = False,
        identity: Optional[str] = None,
        lease_duration: float = 2.0,
        retry_period: float = 0.2,
        debug_enabled: bool = False,
        explain_source=None,
    ):
        self.api = api
        self.period = period
        self.identity = identity or f"{self.NAME}-{uuid.uuid4().hex[:8]}"
        #: uniform identity labels merged into every /metrics series;
        #: subclasses refine
        self.identity_labels = {
            "daemon": self.NAME.replace("vtpu-", ""),
            "role": self.NAME.replace("vtpu-", ""),
        }
        self.serving = ServingServer(
            host=listen_host, port=listen_port, health_check=self.healthy,
            debug_enabled=debug_enabled, explain_source=explain_source,
        )
        self.elector: Optional[LeaderElector] = None
        if leader_elect:
            self.elector = LeaderElector(
                api,
                self.LOCK_NAME,
                self.identity,
                lease_duration=lease_duration,
                retry_period=retry_period,
            )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: cycles this instance actually ran (leadership observability)
        self.cycles = 0
        self.last_error: Optional[str] = None
        #: cycles that raised, and loop turns skipped for want of the
        #: lease after this daemon first led
        self.failed_cycles = 0
        self.skipped_turns = 0

    # ---- subclass API ----

    def _work(self) -> None:
        raise NotImplementedError

    def _on_start(self) -> None:
        """Hook before the loop thread starts (e.g. cache informers)."""

    # ---- loop ----

    def _loop(self) -> None:
        led = False
        while not self._stop.is_set():
            if self.elector is None or self.elector.is_leader:
                led = True
                try:
                    self._work()
                    self.cycles += 1
                    self.last_error = None
                except Exception as e:  # noqa: BLE001 — keep the loop alive
                    self.failed_cycles += 1
                    self.last_error = str(e)
                    log.error("%s cycle failed: %s", self.NAME, e)
            elif led:
                self.skipped_turns += 1
            self._stop.wait(self.period)

    def status(self) -> dict:
        """The loop's counters and the lease as this daemon holds it
        (``renews`` and the longest gap between them while it led)."""
        out = dict(cycles=self.cycles, failed_cycles=self.failed_cycles,
                   skipped_turns=self.skipped_turns, last_error=self.last_error)
        if self.elector is not None:
            out.update(leading=self.elector.is_leader, renews=self.elector.renews,
                       max_renew_gap_ms=self.elector.max_renew_gap * 1e3)
        return out

    def healthy(self) -> bool:
        """Liveness for /healthz: the loop thread must be running (or
        not yet started)."""
        return self._thread is None or self._thread.is_alive()

    def start(self):
        from volcano_tpu_torch import metrics

        metrics.set_identity(**self.identity_labels)
        self.serving.start()
        self._on_start()
        if self.elector is not None:
            self.elector.start()
        self._thread = threading.Thread(
            target=self._loop, name=f"{self.NAME}-{self.identity}", daemon=True
        )
        self._thread.start()
        log.info("%s %s serving on :%d", self.NAME, self.identity, self.serving.port)
        return self

    def stop(self, crash: bool = False) -> None:
        """Stop the daemon.  ``crash=True`` skips the graceful lease
        release, leaving standbys to take over after expiry."""
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=10)
        if self.elector is not None:
            self.elector.stop(release=not crash)
        self.serving.stop()


def apply_faults(spec: str) -> None:
    """``--faults`` → the process-global fault plane (a parse error is
    a clean exit: a typo'd schedule must not run a different chaos
    plan).  An empty flag leaves VTPU_FAULTS env resolution intact."""
    if not spec:
        return
    try:
        faults.configure(spec)
    except ValueError as e:
        raise SystemExit(f"--faults: {e}") from e


def kernel_status() -> dict:
    """The kernel launches made in this process (``session`` and
    ``session_wide`` of csrc/session_kernel.cu, ``preempt`` of
    csrc/preempt_kernel.cu) and the bytes of device memory it holds: the
    binaries' SIGUSR1 status lines."""
    import torch

    from volcano_tpu_torch.ops import preempt_kernel, session_kernel

    return dict(session=session_kernel.LAUNCHES, session_wide=session_kernel.WIDE_LAUNCHES,
                preempt=preempt_kernel.LAUNCHES,
                memory_reserved=(torch.cuda.memory_reserved()
                                 if torch.cuda.is_initialized() else 0))


def serve_forever(daemon) -> int:
    """Blocking main body shared by the binaries: start ``daemon``, wait
    for SIGTERM or SIGINT, stop it (gracefully: a leader releases its
    lease) and return 0.  (The reference stops on SIGINT only and dies
    of SIGTERM's default action.)"""
    done = threading.Event()
    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, lambda *_: done.set())
        signal.signal(signal.SIGINT, lambda *_: done.set())
    daemon.start()
    try:
        while not done.wait(3600):
            pass
    except KeyboardInterrupt:
        pass
    daemon.stop()
    return 0
