"""Chrome ``trace_event`` export — view recorded cycles in
chrome://tracing / Perfetto.  A copy of ``volcano_tpu/trace/export.py``.

The recorder already emits Chrome-shaped events (ph "X" complete spans
with ts/dur in microseconds, ph "i" instants); this module wraps them in
the JSON object format and renders decisions as instant events on a
dedicated "decisions" track so bind/evict activity lines up with the
spans that produced it.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

#: synthetic track (tid) for decision instants, kept clear of real thread ids
_DECISIONS_TID = 0


def _record_events(
    record: Dict[str, Any], pid: int, ts_offset_us: float = 0.0
) -> List[Dict[str, Any]]:
    """One cycle record's events+decisions as Chrome events under one
    pid row, timestamps shifted by ``ts_offset_us`` (the per-process
    clock-alignment correction the merged export computes)."""
    events = []
    for e in record.get("events", []):
        ev = {
            "name": e.get("name", ""),
            "cat": e.get("cat", "event"),
            "ph": e.get("ph", "i"),
            "ts": e.get("ts", 0.0) + ts_offset_us,
            "pid": pid,
            "tid": e.get("tid", 1),
        }
        if ev["ph"] == "X":
            ev["dur"] = e.get("dur", 0.0)
        if ev["ph"] == "i":
            ev["s"] = "t"  # thread-scoped instant
        if e.get("args"):
            ev["args"] = e["args"]
        events.append(ev)
    ts0 = record.get("start_us", 0.0)
    for d in record.get("decisions", []):
        events.append(
            {
                "name": f"{d.get('kind', 'bind')}:{d.get('task', '')}",
                "cat": "decision",
                "ph": "i",
                # pre-ts journals (no "ts" on decisions) fall back to
                # the cycle start
                "ts": d.get("ts", ts0) + ts_offset_us,
                "pid": pid,
                "tid": _DECISIONS_TID,
                "s": "t",
                "args": {k: v for k, v in d.items() if k != "ts"},
            }
        )
    return events


def chrome_trace(record: Dict[str, Any]) -> Dict[str, Any]:
    """One recorder cycle record → Chrome trace JSON object."""
    return {
        "traceEvents": _record_events(record, pid=1),
        "displayTimeUnit": "ms",
        "metadata": {
            "cycle": record.get("cycle", -1),
            "duration_ms": record.get("duration_ms", 0.0),
            "wall_time": record.get("wall_time", 0.0),
            "n_decisions": len(record.get("decisions", [])),
            # >0 means the per-cycle cap truncated the capture: the
            # timeline below is incomplete, not a full record
            "n_dropped": record.get("n_dropped", 0),
        },
    }


def _wall_start_us(record: Dict[str, Any]) -> float:
    """Wall-clock µs of the cycle's start: end-of-cycle wall stamp
    minus the measured duration.  The recorder's event timestamps are
    perf-counter µs relative to a process-local epoch — useless across
    processes — but every record also carries ``wall_time``, which
    anchors the local timeline to the shared wall clock."""
    return (
        record.get("wall_time", 0.0) * 1e6
        - record.get("duration_ms", 0.0) * 1e3
    )


def merge_chrome_traces(
    records: List[Dict[str, Any]],
    labels: Optional[List[str]] = None,
) -> Dict[str, Any]:
    """N per-process cycle records → ONE Chrome trace with a distinct
    pid row (and process_name metadata) per record, all shifted onto
    the shared wall-clock origin, so the multiproc drills produce a
    readable combined timeline instead of N overlapping pid-1 rows.
    Cross-host clock skew shifts whole rows, never widths."""
    events: List[Dict[str, Any]] = []
    if not records:
        return {"traceEvents": events, "displayTimeUnit": "ms"}
    wall_starts = [_wall_start_us(r) for r in records]
    origin = min(w for w in wall_starts) if wall_starts else 0.0
    for i, (record, wall) in enumerate(zip(records, wall_starts)):
        pid = i + 1
        name = (labels[i] if labels and i < len(labels)
                else f"process-{i}")
        events.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": f"{name} (cycle {record.get('cycle', -1)})"},
        })
        offset = (wall - origin) - record.get("start_us", 0.0)
        events.extend(_record_events(record, pid=pid, ts_offset_us=offset))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {
            "processes": len(records),
            "clock_origin_wall_us": origin,
        },
    }


def export_chrome_trace(
    journal, cycle: Optional[int] = None, path: Optional[str] = None
) -> str:
    """Render a journaled cycle to a Chrome trace JSON file; returns the
    rendered JSON string (and writes it when ``path`` is given)."""
    from volcano_tpu_torch.trace.journal import Journal

    if isinstance(journal, str):
        journal = Journal(journal)
    if cycle is None:
        cycle = journal.last_cycle()
        if cycle is None:
            raise FileNotFoundError(f"journal {journal.root!r} has no cycles")
    text = json.dumps(chrome_trace(journal.read_cycle(cycle)), indent=1)
    if path:
        with open(path, "w") as f:
            f.write(text)
    return text


def export_merged_chrome_trace(
    dirs: List[str], cycle: Optional[int] = None, path: Optional[str] = None
) -> str:
    """Merge one cycle from EACH per-process journal into a single
    multi-pid Chrome trace (``vtctl trace export -d a -d b ...``).
    ``cycle=None`` takes each journal's last cycle — the common case
    after a multiproc drill, where per-process cycle ids don't align."""
    from volcano_tpu_torch.trace.journal import Journal

    records = []
    labels = []
    for d in dirs:
        journal = Journal(d) if isinstance(d, str) else d
        c = cycle if cycle is not None else journal.last_cycle()
        if c is None:
            raise FileNotFoundError(f"journal {journal.root!r} has no cycles")
        records.append(journal.read_cycle(c))
        labels.append(str(getattr(journal, "root", d)))
    text = json.dumps(merge_chrome_traces(records, labels=labels), indent=1)
    if path:
        with open(path, "w") as f:
            f.write(text)
    return text
