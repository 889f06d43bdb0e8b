"""Cycle journal entry point: record, replay, diff, export.

The port of ``vtctl trace record|replay|diff|export``
(``volcano_tpu/cli/vtctl.py``), with the same flags plus ``--device``:

  record  synthetic sessions (ops/synthetic.generate_snapshot) run
          through ``--executor`` into a journal, with sampled snapshots
  replay  re-run a captured cycle through ``--executor`` and diff it
          against the recorded assignment (exit 0 on match, 1 on diff)
  diff    the same, printing the per-task diff and the cycle's recorded
          ``explain-summary`` / ``explain-no-victim`` events
  export  a journaled cycle as Chrome trace_event JSON (``-d`` repeated
          merges several journals under distinct pid rows)

Executors: ``cuda`` (the session kernel), ``torch-scan``, ``blocked``,
``native`` (the C++ host baseline) and ``auto``.  Everything but
``native`` runs on the card unless ``--device`` names another device.

Usage: python -m volcano_tpu_torch.cmd.trace replay --dir D [--executor cuda]

The port's ``vtctl`` (``cli/vtctl.py``) carries the same four commands
under ``vtctl trace``, beside the flight recorder's ``trace pod|gang``.
"""

from __future__ import annotations

import argparse
import sys
import time

from volcano_tpu_torch import trace
from volcano_tpu_torch.trace.replay import EXECUTORS


def _record(args, out) -> int:
    """Record synthetic scheduling cycles into a journal: per cycle, the
    event timeline plus (sampled) the packed session + kernel assignment
    that trace replay re-executes."""
    from volcano_tpu_torch.ops.kernels import DEFAULT_WEIGHTS
    from volcano_tpu_torch.ops.synthetic import generate_snapshot
    from volcano_tpu_torch.trace.replay import run_snapshot

    rec = trace.TraceRecorder(
        journal=trace.Journal(args.dir, keep=args.keep),
        snapshot_every=args.snapshot_every,
    )
    # install globally so the dispatch/executor-layer instrumentation
    # (dispatch:allocate naming the executor auto picked) lands in the
    # journal too
    prev = trace.get_recorder()
    trace.set_recorder(rec)
    try:
        for i in range(args.cycles):
            snap = generate_snapshot(
                n_tasks=args.tasks,
                n_nodes=args.nodes,
                gang_size=args.gang_size,
                seed=args.seed + i,
            )
            # the journal cycle id, NOT i — the recorder resumes after a
            # non-empty journal's newest cycle
            cid = rec.begin_cycle()
            t0 = time.perf_counter()
            with rec.span("kernel:execute", "kernel", executor=args.executor):
                assignment = run_snapshot(snap, executor=args.executor,
                                          device=args.device)
            rec.capture(
                snap, assignment, executor=args.executor,
                weights=DEFAULT_WEIGHTS, gang_rounds=3,
            )
            placed = int((assignment[: snap.n_tasks] >= 0).sum())
            rec.event("cycle-summary", "scheduler", placed=placed)
            rec.end_cycle(duration_s=time.perf_counter() - t0)
            print(
                f"cycle {cid}: {placed}/{snap.n_tasks} placed"
                + (" [snapshot]" if cid in rec.journal.snapshot_cycles() else ""),
                file=out,
            )
    finally:
        trace.set_recorder(prev)
    print(
        f"recorded {args.cycles} cycle(s) to {args.dir} "
        f"(snapshots every {args.snapshot_every or 'never'})",
        file=out,
    )
    return 0


def _replay(args, out) -> int:
    result = trace.verify(args.dir, cycle=args.cycle, executor=args.executor,
                          device=args.device)
    print(result.summary(), file=out)
    return 0 if result.match else 1


def _diff(args, out) -> int:
    """Replay and print the per-task binding diff (empty when identical),
    plus the cycle's recorded explain summary — a diff in which tasks
    simply went unplaced reads very differently when the journal shows
    the device proved them unschedulable (reason histogram) than when
    scoring genuinely diverged."""
    result = trace.verify(args.dir, cycle=args.cycle, executor=args.executor,
                          device=args.device)
    print(result.summary(), file=out)
    for task_idx, rec_node, rep_node in result.diffs[: args.limit]:
        print(
            f"  task[{task_idx}]: recorded node {rec_node} != "
            f"replayed node {rep_node}",
            file=out,
        )
    if len(result.diffs) > args.limit:
        print(f"  ... {len(result.diffs) - args.limit} more", file=out)
    try:
        record = trace.Journal(args.dir).read_cycle(result.cycle)
    except OSError:  # the event log may be pruned; the diff stands
        record = {}
    for e in record.get("events", []):
        if e.get("name") in ("explain-summary", "explain-no-victim"):
            a = e.get("args", {})
            print(
                f"  explain[{e['name']}]: {a.get('tasks', 0)} task(s) "
                f"unschedulable, reasons: {a.get('reasons', {})}",
                file=out,
            )
    return 0 if result.match else 1


def _export(args, out) -> int:
    dirs = list(args.dir)
    if len(dirs) > 1:
        # per-process journals merge under distinct pid rows on a shared
        # wall-clock origin
        text = trace.export_merged_chrome_trace(dirs, cycle=args.cycle,
                                                path=args.out or None)
    else:
        text = trace.export_chrome_trace(dirs[0], cycle=args.cycle, path=args.out or None)
    if args.out:
        print(f"wrote Chrome trace to {args.out}", file=out)
    else:
        print(text, file=out)
    return 0


#: the journal commands by name, for this entry point and vtctl's
COMMANDS = {"record": _record, "replay": _replay, "diff": _diff, "export": _export}


def add_commands(sub) -> None:
    """Add the journal commands' parsers to the subparsers ``sub``."""
    tr = sub.add_parser("record", description="record synthetic cycles")
    tr.add_argument("--dir", "-d", required=True, help="journal directory")
    tr.add_argument("--tasks", type=int, default=1024)
    tr.add_argument("--nodes", type=int, default=256)
    tr.add_argument("--gang-size", dest="gang_size", type=int, default=8)
    tr.add_argument("--cycles", type=int, default=1)
    tr.add_argument("--seed", type=int, default=0)
    tr.add_argument(
        "--snapshot-every", dest="snapshot_every", type=int, default=1,
        help="capture a replayable snapshot every Nth cycle (0 = never)",
    )
    tr.add_argument("--keep", type=int, default=64, help="journal ring size")
    tr.add_argument("--executor", default="cuda", choices=EXECUTORS)
    tr.add_argument("--device", default=None,
                    help="torch device of the executor (default: the card)")

    for name in ("replay", "diff"):
        tp = sub.add_parser(name)
        tp.add_argument("--dir", "-d", required=True)
        tp.add_argument("--cycle", type=int, default=None)
        tp.add_argument("--executor", default="cuda", choices=EXECUTORS)
        tp.add_argument("--device", default=None,
                        help="torch device of the executor (default: the card)")
        if name == "diff":
            tp.add_argument("--limit", type=int, default=20)

    te = sub.add_parser("export")
    te.add_argument(
        "--dir", "-d", required=True, action="append",
        help="journal directory; repeat to merge several per-process "
        "journals into one Chrome trace with distinct pid rows on a "
        "shared clock origin",
    )
    te.add_argument("--cycle", type=int, default=None)
    te.add_argument("--out", "-o", default="", help="output file (default stdout)")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vtpu-trace", description="cycle journal: record, replay, diff, export")
    add_commands(p.add_subparsers(dest="cmd", required=True))
    return p


def main(argv=None, out=None) -> int:
    args = parser().parse_args(argv)
    return COMMANDS[args.cmd](args, out if out is not None else sys.stdout)


if __name__ == "__main__":
    raise SystemExit(main())
