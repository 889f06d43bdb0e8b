"""Shared daemon scaffolding: serving surface + leader election + the
guarded work loop, and the flag helpers the binaries share.

A copy of ``volcano_tpu/cmd/daemon.py``.  A daemon can run the cluster
flight recorder (``flight_recorder``, or ``VTPU_FLIGHT_RECORDER=1``: its
spans export to the bus as telemetry segments), the SLO burn-rate
watchdog (``watchdog``, or ``VTPU_WATCHDOG=1``) and the incident bundles
it writes at a breach (``incident_dir``, or ``VTPU_INCIDENT_DIR``; the
watchdog's windows, period, cooldown, boost TTL and journal come from
``VTPU_SLO_FAST_WINDOW``, ``VTPU_SLO_SLOW_WINDOW``,
``VTPU_WATCHDOG_PERIOD``, ``VTPU_INCIDENT_COOLDOWN``, ``VTPU_BOOST_TTL``
and ``VTPU_TRACE_JOURNAL``).  Its /healthz reads degraded on open
breakers and on each active ``slo-burn:<name>`` breach.
"""

from __future__ import annotations

import os
import signal
import threading
import uuid
from typing import Optional

from volcano_tpu_torch import faults, obs
from volcano_tpu_torch.client import APIServer
from volcano_tpu_torch.serving import LeaderElector, ServingServer
from volcano_tpu_torch.serving.http import _degraded as _default_degraded
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
        flight_recorder: Optional[bool] = None,
        watchdog: Optional[bool] = None,
        incident_dir: Optional[str] = None,
    ):
        self.api = api
        self.period = period
        self.identity = identity or f"{self.NAME}-{uuid.uuid4().hex[:8]}"
        #: cluster-wide flight recorder (obs/): span batches export to
        #: the bus as telemetry segments.  None = follow
        #: VTPU_FLIGHT_RECORDER
        if flight_recorder is None:
            flight_recorder = env_on("VTPU_FLIGHT_RECORDER")
        self.flight_recorder = flight_recorder
        self._obs_exporter = None
        #: SLO burn-rate watchdog (obs/slo.py) + incident bundles
        #: (obs/incident.py).  None = follow VTPU_WATCHDOG /
        #: VTPU_INCIDENT_DIR, the same shape as the flight recorder flag
        if watchdog is None:
            watchdog = env_on("VTPU_WATCHDOG")
        if incident_dir is None:
            incident_dir = os.environ.get("VTPU_INCIDENT_DIR", "")
        self.watchdog_enabled = watchdog
        self.incident_dir = incident_dir
        self.watchdog = None
        self.incidents = None
        #: uniform identity labels merged into every /metrics series;
        #: subclasses refine
        self.identity_labels = {
            "daemon": self.NAME.replace("vtpu-", ""),
            "role": self.NAME.replace("vtpu-", ""),
        }
        if self.watchdog_enabled:
            # the bundle's explain.json: every job's explanation (the
            # serving source answers (namespace, job); "" is all of them)
            self.incidents, self.watchdog = watchdog_pair(
                api, self.identity, self.incident_dir,
                journal_dir=os.environ.get("VTPU_TRACE_JOURNAL", ""),
                explain_source=(lambda: explain_source("", "")) if explain_source else None,
            )
        self.serving = ServingServer(
            host=listen_host, port=listen_port, health_check=self.healthy,
            debug_enabled=debug_enabled, explain_source=explain_source,
            degraded_source=self._degraded,
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

    def _degraded(self) -> Optional[str]:
        """/healthz degraded body: open breakers (the serving default)
        plus the watchdog's active ``slo-burn:<name>`` breaches."""
        reasons = []
        breakers = _default_degraded()
        if breakers:
            reasons.append(breakers)
        if self.watchdog is not None:
            reasons.extend(self.watchdog.degraded_reasons())
        return "; ".join(reasons) if reasons else None

    def healthy(self) -> bool:
        """Liveness for /healthz: the loop thread must be running (or
        not yet started)."""
        return self._thread is None or self._thread.is_alive()

    def start(self):
        from volcano_tpu_torch import metrics

        metrics.set_identity(**self.identity_labels)
        if self.flight_recorder:
            self._obs_exporter = obs.enable(self.api, identity=self.identity)
        if self.watchdog is not None:
            self.watchdog.start()
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
        release, leaving standbys to take over after expiry, and leaves
        the flight recorder as it is: the exporter is the process's, and
        a daemon that crashes takes it down only with its process (a
        later graceful ``stop`` flushes and uninstalls it)."""
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=10)
        if self.elector is not None:
            self.elector.stop(release=not crash)
        if self.watchdog is not None:
            self.watchdog.stop()
        if not crash and self._obs_exporter is not None:
            stop_recorder(self._obs_exporter)
            self._obs_exporter = None
        self.serving.stop()


def env_on(name: str) -> bool:
    """A ``VTPU_*`` switch of the daemons: on unless unset, "" or "0"."""
    return os.environ.get(name, "") not in ("", "0")


def stop_recorder(exporter) -> None:
    """Stop a daemon's exporter after its final flush; the process-global
    recorder is uninstalled only if it is still that one (a later
    ``obs.enable`` replaced and stopped it)."""
    if obs.get_exporter() is exporter:
        obs.disable()  # the final flush rides the exporter stop
    else:
        exporter.stop()


def watchdog_pair(api, identity: str, incident_dir: str, journal_dir: str = "",
                  explain_source=None):
    """The incident manager and the burn-rate watchdog that feeds it, on
    one metrics ring, configured from the ``VTPU_*`` environment as the
    reference daemons configure theirs; the bundles go to
    ``incident_dir`` (``<tmp>/vtpu-incidents-<identity>`` where empty)."""
    import tempfile

    from volcano_tpu_torch.metrics.timeseries import TimeSeriesRing
    from volcano_tpu_torch.obs.incident import IncidentManager
    from volcano_tpu_torch.obs.slo import BurnRateWatchdog

    ring = TimeSeriesRing()
    incidents = IncidentManager(
        api, identity,
        incident_dir or os.path.join(tempfile.gettempdir(), f"vtpu-incidents-{identity}"),
        cooldown_s=float(os.environ.get("VTPU_INCIDENT_COOLDOWN", "60")),
        boost_ttl_s=float(os.environ.get("VTPU_BOOST_TTL", "30")),
        metrics_ring=ring,
        journal_dir=journal_dir,
        explain_source=explain_source,
    )
    watchdog = BurnRateWatchdog(
        ring=ring,
        fast_window_s=float(os.environ.get("VTPU_SLO_FAST_WINDOW", "60")),
        slow_window_s=float(os.environ.get("VTPU_SLO_SLOW_WINDOW", "300")),
        period=float(os.environ.get("VTPU_WATCHDOG_PERIOD", "5")),
        on_breach=incidents.on_alert,
    )
    return incidents, watchdog


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
