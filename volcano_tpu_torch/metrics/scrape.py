"""Prometheus text-exposition scraping + parsing — the read side of
/metrics, shared by ``vtctl top`` and the SLO watchdog.  A copy of
``volcano_tpu/metrics/scrape.py``.

The registry renders the text format (metrics/__init__.py); this module is its
inverse: fetch an endpoint, parse counters/gauges/histograms back into
numbers, merge histograms across members, and answer quantiles from
bucket counts — everything federated aggregation needs, with no
third-party client library (the serving-side rule, mirrored)."""

from __future__ import annotations

import re
import urllib.request
from typing import Dict, List, Optional, Tuple

#: (name, ((label, value), ...)) — the registry's series key shape
SeriesKey = Tuple[str, Tuple[Tuple[str, str], ...]]

_LINE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>[^\s]+)$"
)
_LABEL_RE = re.compile(r'(\w+)="([^"]*)"')


def fetch_metrics(addr: str, timeout: float = 2.0) -> str:
    """GET ``http://<addr>/metrics`` (addr is host:port)."""
    url = addr if "://" in addr else f"http://{addr}/metrics"
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode()


class Scrape:
    """One parsed exposition: plain series (counters + gauges) and
    reassembled histograms."""

    def __init__(self):
        #: (name, labels) → value for counters/gauges
        self.series: Dict[SeriesKey, float] = {}
        #: (name, labels-without-le) → {"buckets": [(le, cumulative)],
        #: "sum": float, "count": float}
        self.histograms: Dict[SeriesKey, dict] = {}

    def value(self, name: str, **labels: str) -> float:
        """Sum of every series of ``name`` whose labels include the
        given ones (partial match — identity labels make exact keys
        member-specific by design)."""
        want = set(labels.items())
        return sum(
            v for (n, ls), v in self.series.items()
            if n == name and want <= set(ls)
        )

    def histogram(self, name: str, **labels: str) -> Optional[dict]:
        """Merged histogram over every matching series."""
        want = set(labels.items())
        found = [
            h for (n, ls), h in self.histograms.items()
            if n == name and want <= set(ls)
        ]
        return merge_histograms(found) if found else None


def parse_metrics(text: str) -> Scrape:
    out = Scrape()
    raw_hist: Dict[SeriesKey, dict] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _LINE_RE.match(line)
        if not m:
            continue
        name = m.group("name")
        try:
            value = float(m.group("value"))
        except ValueError:
            continue
        labels = tuple(sorted(_LABEL_RE.findall(m.group("labels") or "")))
        if name.endswith("_bucket"):
            base = name[: -len("_bucket")]
            le = dict(labels).get("le", "+Inf")
            rest = tuple(kv for kv in labels if kv[0] != "le")
            h = raw_hist.setdefault((base, rest),
                                    {"buckets": [], "sum": 0.0, "count": 0.0})
            h["buckets"].append((le, value))
        elif name.endswith("_sum") and (name[:-4], labels) in raw_hist:
            raw_hist[(name[:-4], labels)]["sum"] = value
        elif name.endswith("_count") and (name[:-6], labels) in raw_hist:
            raw_hist[(name[:-6], labels)]["count"] = value
        else:
            out.series[(name, labels)] = value
    for key, h in raw_hist.items():
        h["buckets"].sort(
            key=lambda b: float("inf") if b[0] == "+Inf" else float(b[0])
        )
        out.histograms[key] = h
    return out


def merge_histograms(hists: List[dict]) -> dict:
    """Pointwise sum of same-shaped histograms (cross-member federation
    — bucket bounds are shared constants in metrics/__init__.py, so shapes
    match; stray extra buckets merge by bound)."""
    buckets: Dict[str, float] = {}
    total_sum = 0.0
    total_count = 0.0
    for h in hists:
        for le, cum in h.get("buckets", ()):
            buckets[le] = buckets.get(le, 0.0) + cum
        total_sum += h.get("sum", 0.0)
        total_count += h.get("count", 0.0)
    merged = sorted(
        buckets.items(),
        key=lambda b: float("inf") if b[0] == "+Inf" else float(b[0]),
    )
    return {"buckets": merged, "sum": total_sum, "count": total_count}


def histogram_quantile(hist: Optional[dict], q: float) -> float:
    """Prometheus-style quantile from cumulative bucket counts (linear
    interpolation within the winning bucket; the +Inf bucket answers
    its lower bound).  0.0 for empty/missing histograms."""
    if not hist or hist.get("count", 0) <= 0:
        return 0.0
    target = q * hist["count"]
    prev_bound = 0.0
    prev_cum = 0.0
    for le, cum in hist["buckets"]:
        bound = float("inf") if le == "+Inf" else float(le)
        if cum >= target:
            if bound == float("inf") or cum == prev_cum:
                return prev_bound
            return prev_bound + (bound - prev_bound) * (
                (target - prev_cum) / (cum - prev_cum)
            )
        prev_bound, prev_cum = bound, cum
    return prev_bound


def delta(later: Scrape, earlier: Scrape) -> Scrape:
    """Windowed view between two scrapes: counter/bucket deltas (gauges
    keep the later value — deltas of a gauge are meaningless)."""
    out = Scrape()
    for key, v in later.series.items():
        name = key[0]
        if name.endswith("_total") or name.endswith("_counts"):
            before = earlier.series.get(key, 0.0)
            # counters are monotonic; a smaller value means the process
            # restarted — treat the later value as the whole window
            out.series[key] = v - before if v >= before else v
        else:
            out.series[key] = v  # gauge: the later value stands
    for key, h in later.histograms.items():
        eh = earlier.histograms.get(key, {"buckets": [], "sum": 0.0,
                                          "count": 0.0})
        ebuckets = dict(eh["buckets"])
        out.histograms[key] = {
            "buckets": [(le, max(cum - ebuckets.get(le, 0.0), 0.0))
                        for le, cum in h["buckets"]],
            "sum": max(h["sum"] - eh["sum"], 0.0),
            "count": max(h["count"] - eh["count"], 0.0),
        }
    return out
