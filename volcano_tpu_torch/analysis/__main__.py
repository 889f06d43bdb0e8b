"""``python -m volcano_tpu_torch.analysis`` — run the lint suite over
the port (a copy of ``volcano_tpu/analysis/__main__.py``).

Exit status: 0 when every finding is suppressed by the checked-in
baseline (or the tree is clean), 1 on any unsuppressed finding, 2 on
stale baseline entries with ``--strict-baseline`` (the default in CI:
a suppression whose finding no longer exists must be deleted, or the
baseline rots into a list nobody can audit).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from volcano_tpu_torch.analysis import PASSES
from volcano_tpu_torch.analysis.core import Baseline, run_passes

DEFAULT_BASELINE = "volcano_tpu_torch/analysis/baseline.json"


def find_root(start: Optional[str] = None) -> str:
    """Walk up from ``start`` (default: this package) to the directory
    holding the ``volcano_tpu_torch`` package — the analysis root."""
    d = os.path.abspath(start or os.path.join(os.path.dirname(__file__)))
    while True:
        if os.path.isdir(os.path.join(d, "volcano_tpu_torch")):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            raise SystemExit("cannot locate the volcano_tpu_torch package root")
        d = parent


def main(argv: Optional[List[str]] = None, out=None) -> int:
    out = out or sys.stdout
    parser = argparse.ArgumentParser(
        prog="python -m volcano_tpu_torch.analysis",
        description="project-invariant static analysis of the port "
                    "(lock discipline / determinism / VBUS serde drift / "
                    "metric hygiene)",
    )
    parser.add_argument("--root", default=None,
                        help="repo root (default: auto-detected)")
    parser.add_argument("--baseline", default=None,
                        help=f"suppression file (default: {DEFAULT_BASELINE})")
    parser.add_argument("--pass", dest="passes", action="append",
                        choices=PASSES,
                        help="run only this pass (repeatable)")
    parser.add_argument("--report", default=None,
                        help="write a JSON findings report here")
    parser.add_argument("--write-baseline", action="store_true",
                        help="write every current finding to the baseline "
                             "(then edit the TODO reasons)")
    parser.add_argument("--no-strict-baseline", action="store_true",
                        help="tolerate stale baseline entries")
    args = parser.parse_args(argv)

    root = args.root or find_root()
    baseline_path = args.baseline or os.path.join(root, DEFAULT_BASELINE)

    findings = run_passes(root, passes=args.passes)

    if args.write_baseline:
        Baseline.write(baseline_path, findings)
        print(f"wrote {len(findings)} suppression(s) to {baseline_path}",
              file=out)
        return 0

    baseline = Baseline.load(baseline_path)
    unsuppressed, suppressed, stale = baseline.split(findings)
    # a partial run (--pass) must not judge the other passes' entries
    if args.passes:
        stale = [e for e in stale if e["pass"] in set(args.passes)]

    if args.report:
        with open(args.report, "w", encoding="utf-8") as f:
            json.dump({
                "findings": [f_.__dict__ for f_ in unsuppressed],
                "suppressed": [f_.__dict__ for f_ in suppressed],
                "stale_baseline_entries": stale,
            }, f, indent=2)
            f.write("\n")

    for f_ in unsuppressed:
        print(f_.render(), file=out)
    if stale and not args.no_strict_baseline:
        for e in stale:
            print(
                f"stale baseline entry (finding no longer exists): "
                f"{e['pass']}/{e['code']} {e['file']} {e['symbol']}",
                file=out,
            )
    print(
        f"analysis: {len(unsuppressed)} finding(s), "
        f"{len(suppressed)} suppressed, {len(stale)} stale baseline "
        f"entr{'y' if len(stale) == 1 else 'ies'}",
        file=out,
    )
    if unsuppressed:
        return 1
    if stale and not args.no_strict_baseline:
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
