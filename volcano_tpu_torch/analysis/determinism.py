"""Determinism pass — replay-critical modules must not reach wall-clock
time, unseeded RNG, or order-escaping ``set`` iteration.

A copy of ``volcano_tpu/analysis/determinism.py`` over the port's
replay-critical subtrees.

This is the contract that makes seeded chaos schedules
(``faults/plane.py``) and ``trace.replay.verify()`` bit-identity
trustworthy: a fault decision or a binding order that consults
``time.time()`` / global ``random`` / ``set`` iteration order cannot be
reproduced from a journal.

Scope: ``volcano_tpu_torch/{trace,faults,ops,actions,cache}/``.  Flagged:

* ``time.time()`` / ``time.time_ns()`` / ``datetime.now()`` /
  ``datetime.utcnow()`` — wall clock.  (``perf_counter`` / ``monotonic``
  are allowed: they time and back off, they never *decide*.)
* module-level ``random.<fn>()`` and ``np.random.<fn>()`` — global,
  unseeded RNG state.  Seeded constructors (``random.Random(seed)``,
  ``np.random.RandomState(seed)``, ``np.random.default_rng(seed)``)
  are allowed — the seed is the determinism.
* ``uuid.uuid1()`` / ``uuid.uuid4()`` — entropy.
* iterating a ``set`` where order escapes: ``for x in {…}`` /
  ``set(...)`` / a set comprehension, and ``list()`` / ``tuple()`` /
  ``enumerate()`` over the same.  (``sorted(set(...))`` is the fix and
  is not flagged.)

Allowlist: a trailing ``# det: <reason>`` comment on the line (journal
timestamps and cache-identity uuids are the two legitimate uses today),
or a baseline entry.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from volcano_tpu_torch.analysis.core import Finding, iter_source_files, SourceFile

PASS = "det"
CODE_WALLCLOCK = "DET001"
CODE_RNG = "DET002"
CODE_SET_ORDER = "DET003"
CODE_ENTROPY = "DET004"

#: replay-critical subtrees (the trace.replay contract)
REPLAY_CRITICAL = (
    "volcano_tpu_torch/trace/",
    "volcano_tpu_torch/faults/",
    "volcano_tpu_torch/ops/",
    "volcano_tpu_torch/actions/",
    "volcano_tpu_torch/cache/",
)

_WALLCLOCK = {
    ("time", "time"), ("time", "time_ns"),
    ("datetime", "now"), ("datetime", "utcnow"), ("datetime", "today"),
    ("date", "today"),
}
_SEEDED_CTORS = {"Random", "RandomState", "Generator", "default_rng",
                 "SystemRandom", "PRNGKey", "key"}
_RANDOM_MODULES = {"random"}
_ENTROPY = {("uuid", "uuid1"), ("uuid", "uuid4")}
_ORDER_ESCAPES = {"list", "tuple", "enumerate", "iter", "next"}


def _dotted(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Name)
        and node.func.id == "set"
    ):
        return True
    return False


class _Checker(ast.NodeVisitor):
    def __init__(self, src: SourceFile):
        self.src = src
        self.findings: List[Finding] = []
        self._func_stack: List[str] = []

    def _owner(self) -> str:
        return ".".join(self._func_stack) or "<module>"

    def _emit(self, code: str, node: ast.AST, message: str, what: str) -> None:
        if self.src.marker(node.lineno, "det"):
            return
        self.findings.append(Finding(
            PASS, code, self.src.rel, node.lineno,
            f"{self._owner()}:{what}", message,
        ))

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._func_stack.append(node.name)
        self.generic_visit(node)
        self._func_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._func_stack.append(node.name)
        self.generic_visit(node)
        self._func_stack.pop()

    def visit_Call(self, node: ast.Call) -> None:
        dotted = _dotted(node.func)
        if dotted:
            parts = tuple(dotted.split("."))
            tail2 = parts[-2:] if len(parts) >= 2 else None
            if tail2 in _WALLCLOCK:
                self._emit(
                    CODE_WALLCLOCK, node,
                    f"wall-clock `{dotted}()` in a replay-critical module "
                    f"(use perf_counter/monotonic, or `# det:` if this is "
                    f"a journal timestamp)", dotted,
                )
            elif tail2 in _ENTROPY:
                self._emit(
                    CODE_ENTROPY, node,
                    f"`{dotted}()` draws entropy in a replay-critical "
                    f"module", dotted,
                )
            elif (
                len(parts) >= 2
                and (parts[0] in _RANDOM_MODULES
                     or parts[-2] == "random")
                and parts[-1] not in _SEEDED_CTORS
            ):
                # module-level random.* / np.random.* — global RNG state
                self._emit(
                    CODE_RNG, node,
                    f"unseeded global RNG `{dotted}()` in a "
                    f"replay-critical module (seed an explicit "
                    f"Random/Generator instead)", dotted,
                )
            elif (
                isinstance(node.func, ast.Name)
                and node.func.id in _ORDER_ESCAPES
                and node.args
                and _is_set_expr(node.args[0])
            ):
                self._emit(
                    CODE_SET_ORDER, node,
                    f"`{node.func.id}()` over a set leaks iteration order "
                    f"(wrap in sorted())", f"{node.func.id}(set)",
                )
        self.generic_visit(node)

    def visit_For(self, node: ast.For) -> None:
        if _is_set_expr(node.iter):
            self._emit(
                CODE_SET_ORDER, node,
                "iterating a set leaks its order into a replay-critical "
                "path (wrap in sorted())", "for-in-set",
            )
        self.generic_visit(node)


def check_file(src: SourceFile) -> List[Finding]:
    checker = _Checker(src)
    checker.visit(src.tree)
    return checker.findings


def run(root: str) -> List[Finding]:
    findings: List[Finding] = []
    for src in iter_source_files(root, subdirs=REPLAY_CRITICAL):
        findings.extend(check_file(src))
    return findings
