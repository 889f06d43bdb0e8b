"""Shared machinery for the analysis passes: parsed source files with
comment markers, the Finding model, and the suppression baseline.

A copy of ``volcano_tpu/analysis/core.py`` for the port's passes, less
the jit pass's marker (the port has no jit).

Findings are keyed by ``(pass, code, file, symbol)`` — deliberately NOT
by line number, so a baseline entry survives unrelated edits above it.
``symbol`` is the nearest stable anchor: ``Class.attr`` for a guarded
attribute, ``Class.method`` / ``function`` for code findings, the kind
or op name for serde findings.
"""

from __future__ import annotations

import ast
import io
import json
import os
import tokenize
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

#: inline waiver markers, one per pass: a trailing comment
#: ``# <marker>: <reason>`` on the offending line waives the finding
#: (the reason is mandatory — a bare marker does not count).
MARKERS = {
    "lock": "unlocked-ok",
    "det": "det",
    "serde": "serde-ok",
    "mtr": "mtr",
}


@dataclass(frozen=True)
class Finding:
    pass_id: str
    code: str
    file: str  # repo-relative posix path
    line: int
    symbol: str
    message: str

    @property
    def key(self) -> Tuple[str, str, str, str]:
        return (self.pass_id, self.code, self.file, self.symbol)

    def render(self) -> str:
        return (
            f"{self.file}:{self.line}: {self.code} [{self.pass_id}] "
            f"{self.symbol}: {self.message}"
        )


class SourceFile:
    """One parsed module: AST + per-line comments (via tokenize, so
    markers survive any formatting) + marker helpers."""

    def __init__(self, path: str, rel: str, text: str):
        self.path = path
        self.rel = rel
        self.text = text
        self.tree = ast.parse(text, filename=rel)
        self._lines = text.splitlines()
        #: line → comment text without the leading ``#``
        self.comments: Dict[int, str] = {}
        try:
            for tok in tokenize.generate_tokens(io.StringIO(text).readline):
                if tok.type == tokenize.COMMENT:
                    self.comments[tok.start[0]] = tok.string.lstrip("#").strip()
        except tokenize.TokenError:
            pass

    def marker(self, line: int, name: str) -> Optional[str]:
        """Return the reason of an inline ``# <name>: reason`` marker on
        ``line`` (or the directly preceding ``#:`` doc-comment block for
        declaration markers), else None."""
        for ln in (line, line - 1):
            comment = self.comments.get(ln)
            if comment is None:
                continue
            if ln != line and not self._comment_only(ln):
                # a TRAILING comment on the previous line annotates that
                # line, not this one — only a standalone comment line
                # above counts as a declaration marker
                continue
            body = comment.lstrip(":").strip()
            if body.startswith(name + ":"):
                reason = body[len(name) + 1 :].strip()
                if reason:
                    return reason
        return None

    def _comment_only(self, line: int) -> bool:
        if 1 <= line <= len(self._lines):
            return self._lines[line - 1].lstrip().startswith("#")
        return False

    def func_marker(self, node: ast.AST, name: str) -> Optional[str]:
        """Return the value of a ``# <name>: value`` comment anywhere
        inside a function's line span (function-scoped annotations like
        ``requires-lock``)."""
        end = getattr(node, "end_lineno", node.lineno)
        for ln in range(node.lineno, end + 1):
            comment = self.comments.get(ln)
            if comment is None:
                continue
            body = comment.lstrip(":").strip()
            if body.startswith(name + ":"):
                value = body[len(name) + 1 :].strip()
                if value:
                    return value
        return None


def iter_source_files(
    root: str, subdirs: Optional[Iterable[str]] = None
) -> Iterator[SourceFile]:
    """Yield parsed SourceFiles under ``root`` (repo root).  With
    ``subdirs``, only files whose repo-relative path starts with one of
    them."""
    prefixes = tuple(subdirs) if subdirs else None
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(
            d for d in dirnames
            if d not in ("__pycache__", ".git", ".ruff_cache")
        )
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            if prefixes and not rel.startswith(prefixes):
                continue
            try:
                with open(path, encoding="utf-8") as f:
                    text = f.read()
                yield SourceFile(path, rel, text)
            except (OSError, SyntaxError):
                continue


@dataclass
class Baseline:
    """Checked-in suppression list.  Every entry needs a reason — the
    baseline records findings we chose to live with, not findings we
    forgot."""

    path: Optional[str] = None
    entries: List[dict] = field(default_factory=list)

    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not os.path.exists(path):
            return cls(path=path)
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        entries = data.get("suppressions", [])
        for e in entries:
            for k in ("pass", "code", "file", "symbol", "reason"):
                if not e.get(k):
                    raise ValueError(
                        f"baseline entry missing {k!r}: {e!r} "
                        f"(every suppression needs a reason)"
                    )
        return cls(path=path, entries=entries)

    def _keys(self) -> set:
        return {
            (e["pass"], e["code"], e["file"], e["symbol"])
            for e in self.entries
        }

    def split(
        self, findings: List[Finding]
    ) -> Tuple[List[Finding], List[Finding], List[dict]]:
        """→ (unsuppressed, suppressed, stale-baseline-entries)."""
        keys = self._keys()
        found_keys = {f.key for f in findings}
        unsuppressed = [f for f in findings if f.key not in keys]
        suppressed = [f for f in findings if f.key in keys]
        stale = [
            e for e in self.entries
            if (e["pass"], e["code"], e["file"], e["symbol"]) not in found_keys
        ]
        return unsuppressed, suppressed, stale

    @staticmethod
    def write(path: str, findings: List[Finding]) -> None:
        entries = [
            {
                "pass": f.pass_id,
                "code": f.code,
                "file": f.file,
                "symbol": f.symbol,
                "reason": "TODO: justify or fix",
            }
            for f in sorted(findings, key=lambda f: f.key)
        ]
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"suppressions": entries}, f, indent=2, sort_keys=False)
            f.write("\n")


def run_passes(
    root: str, passes: Optional[Iterable[str]] = None
) -> List[Finding]:
    """Run the selected passes (default: all) over the tree at ``root``
    and return the raw findings, stably sorted."""
    from volcano_tpu_torch.analysis import determinism, lock_discipline
    from volcano_tpu_torch.analysis import metric_hygiene, serde_drift

    selected = set(passes) if passes else {"lock", "det", "serde", "mtr"}
    findings: List[Finding] = []
    if "lock" in selected:
        findings.extend(lock_discipline.run(root))
    if "det" in selected:
        findings.extend(determinism.run(root))
    if "serde" in selected:
        findings.extend(serde_drift.run(root))
    if "mtr" in selected:
        findings.extend(metric_hygiene.run(root))
    findings.sort(key=lambda f: (f.file, f.line, f.code, f.symbol))
    return findings
