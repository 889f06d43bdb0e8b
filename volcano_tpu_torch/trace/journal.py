"""On-disk cycle journal — JSONL event log + sampled npz snapshots, kept
as a bounded ring.  A copy of ``volcano_tpu/trace/journal.py``: the same
files, so each package reads the other's journals.

Layout under the journal root::

    cycle-00000012.jsonl   header line, then one JSON line per event and
                           per decision (``{"rec": "event"|"decision", ...}``)
    cycle-00000012.npz     optional PackedSnapshot + kernel assignment
                           (ops/packing.py save_snapshot format)

``keep`` bounds the ring: after each write the oldest cycles beyond it
are deleted (events and snapshot together), so a long-running scheduler
journals indefinitely in constant disk.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

_CYCLE_RE = re.compile(r"^cycle-(\d+)\.jsonl$")
_SNAP_RE = re.compile(r"^cycle-(\d+)\.npz$")


class Journal:
    def __init__(self, root: str, keep: int = 64):
        if keep < 1:
            # keep=0 would delete each cycle right after writing it —
            # never what anyone means (unlike snapshot_every, where 0
            # reads as "never capture")
            raise ValueError(f"journal keep must be >= 1, got {keep}")
        self.root = root
        self.keep = keep

    def _listdir(self) -> List[str]:
        # read-only consumers (replay/diff/export) must not create the
        # directory as a side effect; a missing (or unreadable, or
        # not-a-directory) journal just has no cycles.  Writes create it
        # (write_cycle / write_snapshot) and surface their own errors.
        try:
            return os.listdir(self.root)
        except OSError:
            return []

    # ---- paths ----

    def _events_path(self, cycle: int) -> str:
        return os.path.join(self.root, f"cycle-{cycle:08d}.jsonl")

    def _snap_path(self, cycle: int) -> str:
        return os.path.join(self.root, f"cycle-{cycle:08d}.npz")

    # ---- write ----

    def write_cycle(self, record: Dict[str, Any]) -> str:
        """Persist one assembled cycle record (recorder.end_cycle)."""
        cycle = record["cycle"]
        os.makedirs(self.root, exist_ok=True)
        path = self._events_path(cycle)
        header = {
            "rec": "cycle",
            "cycle": cycle,
            "start_us": record.get("start_us", 0.0),
            "duration_ms": record.get("duration_ms", 0.0),
            "wall_time": record.get("wall_time", 0.0),
            "n_events": len(record.get("events", [])),
            "n_decisions": len(record.get("decisions", [])),
            "snapshot": os.path.exists(self._snap_path(cycle)),
        }
        if record.get("n_dropped"):
            # a capped cycle must journal as incomplete, not complete
            header["n_dropped"] = record["n_dropped"]
        with open(path, "w") as f:
            f.write(json.dumps(header) + "\n")
            for e in record.get("events", []):
                f.write(json.dumps({"rec": "event", **e}) + "\n")
            for d in record.get("decisions", []):
                f.write(json.dumps({"rec": "decision", **d}) + "\n")
        self._prune()
        return path

    def write_snapshot(
        self, cycle: int, snap, assignment, executor: str = "",
        weights=None, gang_rounds=None,
    ) -> str:
        from volcano_tpu_torch.ops.packing import save_snapshot

        import numpy as np

        os.makedirs(self.root, exist_ok=True)
        path = self._snap_path(cycle)
        extras = {
            "assignment": np.asarray(assignment, dtype=np.int32),
            "executor": np.array(executor),
            "cycle": np.array(cycle, dtype=np.int64),
        }
        if weights is not None:
            # ScoreWeights NamedTuple → float lanes (bool lanes included)
            extras["weights"] = np.asarray(tuple(weights), dtype=np.float64)
        if gang_rounds is not None:
            extras["gang_rounds"] = np.array(gang_rounds, dtype=np.int64)
        save_snapshot(snap, path, **extras)
        return path

    def _prune(self) -> None:
        # union of event-log and snapshot cycles, so an orphan .npz from
        # a cycle whose event log never landed still ages out of the ring
        cycles = sorted(set(self.cycles()) | set(self.snapshot_cycles()))
        for cycle in cycles[: max(0, len(cycles) - self.keep)]:
            for path in (self._events_path(cycle), self._snap_path(cycle)):
                try:
                    os.unlink(path)
                except FileNotFoundError:
                    pass

    # ---- read ----

    def cycles(self) -> List[int]:
        out = []
        for name in self._listdir():
            m = _CYCLE_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def snapshot_cycles(self) -> List[int]:
        # strict match like cycles(): a foreign file (cycle-keep.npz, a
        # user-renamed backup) must be ignored, not crash every caller
        return sorted(
            int(m.group(1))
            for m in map(_SNAP_RE.match, self._listdir())
            if m
        )

    def last_cycle(self) -> Optional[int]:
        cycles = self.cycles()
        return cycles[-1] if cycles else None

    def read_cycle(self, cycle: int) -> Dict[str, Any]:
        """Inverse of write_cycle: {header, events, decisions} dict in the
        recorder's in-memory record shape."""
        path = self._events_path(cycle)
        header: Dict[str, Any] = {}
        events: List[Dict[str, Any]] = []
        decisions: List[Dict[str, str]] = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                obj = json.loads(line)
                kind = obj.pop("rec", "event")
                if kind == "cycle":
                    header = obj
                elif kind == "decision":
                    decisions.append(obj)
                else:
                    events.append(obj)
        record = {
            "cycle": header.get("cycle", cycle),
            "start_us": header.get("start_us", 0.0),
            "duration_ms": header.get("duration_ms", 0.0),
            "wall_time": header.get("wall_time", 0.0),
            "events": events,
            "decisions": decisions,
        }
        if header.get("n_dropped"):
            record["n_dropped"] = header["n_dropped"]
        return record

    def read_snapshot(self, cycle: int) -> Tuple[object, Dict[str, Any]]:
        """(PackedSnapshot, extras) — extras carry ``assignment`` (int32
        array), ``executor`` (str) and ``cycle``."""
        from volcano_tpu_torch.ops.packing import load_snapshot

        snap, extras = load_snapshot(self._snap_path(cycle))
        if "executor" in extras:
            extras["executor"] = str(extras["executor"])
        if "cycle" in extras:
            extras["cycle"] = int(extras["cycle"])
        return snap, extras
