"""volcano_tpu_torch.trace — cycle record/replay journal.

The port of ``volcano_tpu/trace/``.  Three pieces:

  * **recorder** — thread-safe span/event capture per scheduling cycle
    (recorder.py), zero-cost when disabled.
  * **journal**  — JSONL event log + sampled npz PackedSnapshot captures
    in a bounded on-disk ring (journal.py), in the JAX package's format:
    each package reads the other's journals.
  * **replayer** — deterministic re-execution of a captured snapshot
    through any of the port's executors, diffed against the recorded
    bindings (replay.py ``verify()``), plus Chrome trace_event timeline
    export (export.py).

Usage::

    from volcano_tpu_torch import trace

    trace.enable("/var/log/vtpu-trace", snapshot_every=10)
    ...  # scheduler cycles record themselves
    result = trace.replay.verify("/var/log/vtpu-trace", executor="cuda")
    assert result.match

Instrumented code always goes through :func:`get_recorder`; with tracing
off that returns the shared ``NullRecorder`` whose calls are no-ops.
This package imports nothing of the framework, so every layer may
import it.
"""

from __future__ import annotations

from typing import Optional

from volcano_tpu_torch.trace import export, journal, replay  # noqa: F401
from volcano_tpu_torch.trace.export import (
    chrome_trace,
    export_chrome_trace,
    export_merged_chrome_trace,
    merge_chrome_traces,
)
from volcano_tpu_torch.trace.journal import Journal
from volcano_tpu_torch.trace.recorder import NullRecorder, TraceRecorder
from volcano_tpu_torch.trace.replay import ReplayResult, run_snapshot, verify

_NULL = NullRecorder()
_recorder = _NULL

#: correlation id of the scheduling cycle currently executing in this
#: process (-1 outside a cycle), set by the scheduler loop every
#: run_once whether or not a recorder is installed; the explain summary
#: of a cycle (``actions/gpu_allocate._publish_explain``) carries it to
#: ``GET /explain``
_current_cycle: int = -1


def set_current_cycle(cycle_id: int) -> None:
    global _current_cycle
    _current_cycle = cycle_id


def current_cycle() -> int:
    return _current_cycle


def get_recorder():
    """The active recorder — NullRecorder unless :func:`enable` (or
    :func:`set_recorder`) installed a live one."""
    return _recorder


def set_recorder(rec: Optional[TraceRecorder]) -> None:
    global _recorder
    _recorder = rec if rec is not None else _NULL


def enable(
    journal_dir: Optional[str] = None,
    snapshot_every: int = 0,
    keep: int = 64,
) -> TraceRecorder:
    """Install a live recorder.  With ``journal_dir`` set, completed
    cycles append to the bounded on-disk ring there; ``snapshot_every=N``
    additionally captures the packed session + kernel assignment every
    Nth cycle for replay."""
    jr = Journal(journal_dir, keep=keep) if journal_dir else None
    rec = TraceRecorder(journal=jr, snapshot_every=snapshot_every)
    set_recorder(rec)
    return rec


def disable() -> None:
    set_recorder(None)


__all__ = [
    "Journal",
    "NullRecorder",
    "ReplayResult",
    "TraceRecorder",
    "chrome_trace",
    "current_cycle",
    "set_current_cycle",
    "disable",
    "enable",
    "export_chrome_trace",
    "export_merged_chrome_trace",
    "get_recorder",
    "merge_chrome_traces",
    "replay",
    "run_snapshot",
    "set_recorder",
    "verify",
]
