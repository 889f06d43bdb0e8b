"""Bounded in-process metrics time-series — the watchdog's memory.

A copy of ``volcano_tpu/metrics/timeseries.py``.

``vtctl top --interval`` proved the shape: two scrapes bound a window
and :func:`volcano_tpu_torch.metrics.scrape.delta` turns cumulative counters
and histogram buckets into windowed rates/percentiles.  The SLO
burn-rate watchdog (obs/slo.py) needs the same view *continuously and
in-process*: every tick parses the registry's own text exposition —
the exact bytes a remote scraper would see, so the watchdog can never
disagree with ``vtctl top`` about what the metrics said — and appends
it to a bounded ring.  ``window(seconds)`` answers the newest-vs-
oldest-inside-the-window delta that burn rates are computed over, and
``dump()`` hands the raw samples to incident bundles so the bundle
carries the minutes *before* the breach, not just the moment of it.

The ring is forensics, not control state: ticks are cheap (one render
+ one parse, no I/O) but they happen on the watchdog's thread, never
on a scheduling path.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Optional, Tuple

from volcano_tpu_torch import metrics as _metrics
from volcano_tpu_torch.metrics import scrape as _scrape


class TimeSeriesRing:
    """Bounded ring of (wall-ts, raw exposition text, parsed Scrape)
    samples of one process's metrics registry."""

    def __init__(self, registry=None, capacity: int = 64):
        self.registry = registry if registry is not None else _metrics.registry
        self.capacity = max(2, capacity)
        self._lock = threading.Lock()
        with self._lock:
            #: (ts, text, Scrape) newest-last
            self._ring: deque = deque(maxlen=self.capacity)  # guarded-by: self._lock

    def tick(self, now: Optional[float] = None) -> None:
        """Sample the registry.  ``now`` injectable for tests (wall
        seconds — the same clock scrape timestamps would carry)."""
        ts = time.time() if now is None else now
        text = self.registry.render()
        parsed = _scrape.parse_metrics(text)
        with self._lock:
            self._ring.append((ts, text, parsed))

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def window(
        self, seconds: float, now: Optional[float] = None
    ) -> Optional[_scrape.Scrape]:
        """Windowed delta: newest sample minus the oldest sample still
        inside ``seconds`` of it (None until two samples qualify).
        Counter/bucket deltas, gauges keep the newest value — exactly
        ``vtctl top --interval`` math, via the same scrape.delta."""
        with self._lock:
            samples = list(self._ring)
        if len(samples) < 2:
            return None
        newest_ts, _, newest = samples[-1]
        anchor = (newest_ts if now is None else now) - seconds
        base = None
        for ts, _, parsed in samples[:-1]:
            if ts >= anchor:
                base = parsed
                break
        if base is None:
            return None
        return _scrape.delta(newest, base)

    def span_seconds(self) -> float:
        """Wall span the ring currently covers (0 when < 2 samples)."""
        with self._lock:
            if len(self._ring) < 2:
                return 0.0
            return self._ring[-1][0] - self._ring[0][0]

    def dump(self) -> List[Tuple[float, str]]:
        """Every held sample as (ts, raw exposition text) — the
        incident bundle's ``metrics.jsonl`` body."""
        with self._lock:
            return [(ts, text) for ts, text, _ in self._ring]
