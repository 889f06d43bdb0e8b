"""SLO burn-rate watchdog — the cluster notices its own regressions.

A copy of ``volcano_tpu/obs/slo.py``.  The raw signals (submit→bind
histograms, micro-cycle latency, commit failures, replication lag,
drift-check divergences, breaker state) are only visible to an operator
running ``vtctl top`` at the right moment unless something *watches*
them.  This module runs the classic multi-window burn-rate evaluation (the SRE-
workbook shape, scaled to this codebase's second-granularity windows)
over declared SLOs, continuously, in every daemon:

* a :class:`~volcano_tpu_torch.metrics.timeseries.TimeSeriesRing` samples
  the process's own registry — the same bytes a remote scraper sees;
* each :class:`SLODef` is evaluated over a **fast** and a **slow**
  window; the burn rate is "consumption ÷ objective" (a windowed p99
  against a latency objective, a counter rate against an error budget
  rate, a gauge against a threshold);
* a breach = burn ≥ threshold in BOTH windows (fast alone is noise, a
  still-elevated slow window confirms it's sustained), surfaced three
  ways: a typed :class:`Alert`, ``volcano_slo_burn{slo,window}``
  gauges (the ``vtctl top`` BURN column), and
  ``degraded: slo-burn:<name>`` on ``/healthz``;
* breach transitions are edge-triggered into ``on_breach`` — the
  incident manager's capture hook — so one breach episode produces
  one bundle, not a storm.

Objectives are deployment-shaped; ``VTPU_SLO_OBJECTIVES``
(``name=value,...``) overrides the defaults without code, which is how
a drill provokes a deterministic breach.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from volcano_tpu_torch import metrics
from volcano_tpu_torch.metrics import scrape as _scrape
from volcano_tpu_torch.metrics.timeseries import TimeSeriesRing
from volcano_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

#: evaluation kinds — how a windowed Scrape turns into a burn rate
KIND_LATENCY_P99 = "latency_p99"
KIND_COUNTER_RATE = "counter_rate"
KIND_GAUGE_MAX = "gauge_max"


class SLODef:
    """One declared objective.  ``objective`` is the budget the burn
    rate divides by: ms for ``latency_p99``, events/second for
    ``counter_rate``, a plain threshold for ``gauge_max``."""

    __slots__ = ("name", "kind", "metric", "objective", "labels",
                 "description")

    def __init__(self, name: str, kind: str, metric: str,
                 objective: float, labels: Optional[Dict[str, str]] = None,
                 description: str = ""):
        self.name = name
        self.kind = kind
        self.metric = metric
        self.objective = float(objective)
        self.labels = dict(labels or {})
        self.description = description


class Alert:
    """One active breach — stored fields only, so every rendering of
    it (healthz, vtctl, bundle meta) is derived state."""

    __slots__ = ("name", "burn_fast", "burn_slow", "value", "objective",
                 "since")

    def __init__(self, name: str, burn_fast: float, burn_slow: float,
                 value: float, objective: float, since: float):
        self.name = name
        self.burn_fast = burn_fast
        self.burn_slow = burn_slow
        self.value = value
        self.objective = objective
        self.since = since

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "burnFast": round(self.burn_fast, 4),
            "burnSlow": round(self.burn_slow, 4),
            "value": round(self.value, 4),
            "objective": self.objective,
            "since": self.since,
        }


#: the declared SLO catalog — every signal the motivation names.
#: breaker-open and drift-divergence double as the non-watchdog
#: incident triggers: a tripped breaker or a shadow divergence IS an
#: SLO breach here, so the incident plane needs no extra coupling into
#: faults/ or incremental/.
DEFAULT_SLOS: Tuple[SLODef, ...] = (
    SLODef(
        "submit-bind-p99", KIND_LATENCY_P99,
        "volcano_submit_to_bind_latency_milliseconds", 1000.0,
        description="windowed p99 of pod submit→bind latency",
    ),
    SLODef(
        "micro-cycle-p99", KIND_LATENCY_P99,
        "volcano_micro_cycle_latency_milliseconds", 250.0,
        description="windowed p99 of event-driven micro-cycle latency",
    ),
    SLODef(
        "commit-failures", KIND_COUNTER_RATE,
        "volcano_commit_failures_total", 0.2,
        description="commit-plane item failures per second",
    ),
    SLODef(
        "repl-lag", KIND_GAUGE_MAX,
        "volcano_repl_lag_entries", 1024.0,
        description="follower replication lag in log entries",
    ),
    SLODef(
        "drift-divergence", KIND_COUNTER_RATE,
        "volcano_share_ledger_drift_checks_total", 0.02,
        labels={"result": "divergence"},
        description="share-ledger shadow cross-check divergences "
                    "per second",
    ),
    SLODef(
        "breaker-open", KIND_GAUGE_MAX,
        "volcano_circuit_breaker_open", 1.0,
        description="any circuit breaker open",
    ),
)


def resolve_slos(
    spec: Optional[str] = None,
    base: Sequence[SLODef] = DEFAULT_SLOS,
) -> Tuple[SLODef, ...]:
    """Apply ``name=objective`` overrides (``VTPU_SLO_OBJECTIVES`` by
    default) to the catalog.  Unknown names and bad numbers are
    ignored — a typo'd override must not change *which* SLOs exist,
    only how tight a known one is."""
    if spec is None:
        spec = os.environ.get("VTPU_SLO_OBJECTIVES", "")
    overrides: Dict[str, float] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        name, _, value = part.partition("=")
        try:
            overrides[name.strip()] = float(value)
        except ValueError:
            continue
    out = []
    for slo in base:
        if slo.name in overrides:
            slo = SLODef(slo.name, slo.kind, slo.metric,
                         overrides[slo.name], slo.labels, slo.description)
        out.append(slo)
    return tuple(out)


def _gauge_max(window: _scrape.Scrape, metric: str,
               labels: Dict[str, str]) -> float:
    """Max over matching gauge series (Scrape.value SUMS, which would
    let two half-open breakers fake a trip)."""
    want = set(labels.items())
    values = [
        v for (n, ls), v in window.series.items()
        if n == metric and want <= set(ls)
    ]
    return max(values) if values else 0.0


class BurnRateWatchdog:
    """Evaluate the declared SLOs over fast/slow windows of this
    process's own metrics.

    The thread is optional: tests drive
    :meth:`run_once` with injected clocks."""

    def __init__(
        self,
        ring: Optional[TimeSeriesRing] = None,
        slos: Optional[Sequence[SLODef]] = None,
        fast_window_s: float = 60.0,
        slow_window_s: float = 300.0,
        burn_threshold: float = 1.0,
        period: float = 5.0,
        on_breach: Optional[Callable[[Alert], None]] = None,
    ):
        self.ring = ring if ring is not None else TimeSeriesRing()
        self.slos = tuple(slos if slos is not None else resolve_slos())
        self.fast_window_s = fast_window_s
        self.slow_window_s = slow_window_s
        self.burn_threshold = burn_threshold
        self.period = period
        self.on_breach = on_breach
        self._lock = threading.Lock()
        with self._lock:
            #: name → Alert for currently-breaching SLOs
            self._active: Dict[str, Alert] = {}  # guarded-by: self._lock
            self.evaluations = 0  # guarded-by: self._lock
            self.breaches = 0  # guarded-by: self._lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- evaluation ----

    def _burn(self, slo: SLODef, window: Optional[_scrape.Scrape],
              seconds: float) -> Tuple[float, float]:
        """→ (burn, raw value) for one SLO over one windowed delta."""
        if window is None:
            return 0.0, 0.0
        if slo.kind == KIND_LATENCY_P99:
            hist = window.histogram(slo.metric, **slo.labels)
            if not hist or hist.get("count", 0) <= 0:
                return 0.0, 0.0
            p99 = _scrape.histogram_quantile(hist, 0.99)
            return p99 / slo.objective, p99
        if slo.kind == KIND_COUNTER_RATE:
            rate = window.value(slo.metric, **slo.labels) / max(seconds, 1e-9)
            return rate / slo.objective, rate
        if slo.kind == KIND_GAUGE_MAX:
            value = _gauge_max(window, slo.metric, slo.labels)
            return value / slo.objective, value
        return 0.0, 0.0

    def run_once(self, now: Optional[float] = None) -> List[Alert]:
        """One watchdog beat: sample the registry, evaluate every SLO
        over both windows, publish the burn gauges, edge-trigger breach
        transitions.  Returns the currently-active alerts."""
        self.ring.tick(now=now)
        return self.evaluate(now=now)

    def evaluate(self, now: Optional[float] = None) -> List[Alert]:
        ts = time.time() if now is None else now
        fast = self.ring.window(self.fast_window_s, now=now)
        slow = self.ring.window(self.slow_window_s, now=now)
        burns = [
            (slo,
             self._burn(slo, fast, self.fast_window_s),
             self._burn(slo, slow, self.slow_window_s))
            for slo in self.slos
        ]
        # gauges published outside the state lock (the channel's
        # count-after-release idiom)
        for slo, (burn_fast, _), (burn_slow, _) in burns:
            metrics.update_slo_burn(slo.name, "fast", burn_fast)
            metrics.update_slo_burn(slo.name, "slow", burn_slow)
        fired: List[Alert] = []
        with self._lock:
            self.evaluations += 1
            for slo, (burn_fast, value), (burn_slow, _) in burns:
                breaching = (
                    burn_fast >= self.burn_threshold
                    and burn_slow >= self.burn_threshold
                )
                active = self._active.get(slo.name)
                if breaching and active is None:
                    alert = Alert(slo.name, burn_fast, burn_slow, value,
                                  slo.objective, ts)
                    self._active[slo.name] = alert
                    self.breaches += 1
                    fired.append(alert)
                elif breaching and active is not None:
                    # refresh magnitudes; `since` keeps the episode start
                    active.burn_fast = burn_fast
                    active.burn_slow = burn_slow
                    active.value = value
                elif not breaching and active is not None:
                    del self._active[slo.name]
            out = list(self._active.values())
        # edge-triggered capture hook, outside the lock (the incident
        # manager writes files and CASes the boost record)
        if self.on_breach is not None:
            for alert in fired:
                try:
                    self.on_breach(alert)
                except Exception as e:  # noqa: BLE001 — a capture
                    # failure must not kill the watchdog
                    log.error("on_breach(%s) failed: %s", alert.name, e)
        return out

    # ---- read surfaces ----

    def active_alerts(self) -> List[Alert]:
        with self._lock:
            return list(self._active.values())

    def degraded_reasons(self) -> List[str]:
        """``slo-burn:<name>`` per active breach — /healthz's degraded
        body, alongside the breaker reasons."""
        with self._lock:
            return [f"slo-burn:{name}" for name in sorted(self._active)]

    # ---- lifecycle ----

    def _loop(self) -> None:
        while not self._stop.wait(self.period):
            try:
                self.run_once()
            except Exception as e:  # noqa: BLE001 — keep watching
                log.error("watchdog evaluation failed: %s", e)

    def start(self) -> "BurnRateWatchdog":
        self._thread = threading.Thread(
            target=self._loop, name="vtpu-slo-watchdog", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
