"""Lock-discipline pass — the staticcheck-style analog of Go's race
detector for this codebase's annotation convention.

A copy of ``volcano_tpu/analysis/lock_discipline.py`` over
``volcano_tpu_torch/``.

An attribute assignment in a class body carrying (on its line, or in
the ``#:`` doc-comment block directly above)::

    self._items = deque()   # guarded-by: self._cv

declares that every read or write of ``self._items`` anywhere in the
class must happen lexically inside ``with self._cv:`` — with two
escapes:

* a function whose body carries ``# requires-lock: self._cv`` is a
  helper documented as "caller holds the lock"; its accesses are
  trusted (the call sites are checked, because they either hold the
  lock or are findings themselves);
* an access line carrying ``# unlocked-ok: <reason>`` is an explicit,
  reviewed waiver (e.g. a benign monotonic-flag read).

Module-level globals work the same way with a bare lock name::

    _breakers = {}   # guarded-by: _registry_lock

``__init__``/``__new__`` are exempt (construction precedes
publication).  A nested ``def`` RESETS the held-lock scope — closures
execute later, when the enclosing ``with`` has long exited — which is
exactly the bug class that motivates the reset.

Lock expressions are matched on their unparsed source text, so
``with self.api.locked():`` guards attributes declared
``# guarded-by: self.api.locked()``.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from volcano_tpu_torch.analysis.core import Finding, iter_source_files, SourceFile

PASS = "lock"
#: guarded attribute touched outside its lock scope
CODE_UNLOCKED = "LCK001"
#: guarded-by annotation names a lock never taken anywhere in the class
CODE_DEAD_LOCK = "LCK002"

_EXEMPT_FUNCS = {"__init__", "__new__", "__del__"}


def _lock_exprs(with_node: ast.With) -> Set[str]:
    return {ast.unparse(item.context_expr) for item in with_node.items}


def _guarded_decls(src: SourceFile, body: List[ast.stmt]) -> Dict[str, str]:
    """``self.X = ...`` statements annotated ``# guarded-by: <lock>``
    → {attr: lock_expr}.  Scans every function in the class (attributes
    are overwhelmingly declared in ``__init__``, but lazily-initialized
    ones appear elsewhere)."""
    guarded: Dict[str, str] = {}

    def scan(stmts):
        for stmt in stmts:
            if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                lock = src.marker(stmt.lineno, "guarded-by")
                if lock:
                    targets = (
                        stmt.targets if isinstance(stmt, ast.Assign)
                        else [stmt.target]
                    )
                    for t in targets:
                        if (
                            isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"
                        ):
                            guarded[t.attr] = lock
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scan(stmt.body)
            elif isinstance(stmt, (ast.If, ast.For, ast.While, ast.With, ast.Try)):
                for sub in ast.iter_child_nodes(stmt):
                    if isinstance(sub, ast.stmt):
                        scan([sub])
                    elif isinstance(sub, (ast.excepthandler,)):
                        scan(sub.body)

    scan(body)
    return guarded


def _module_guarded(src: SourceFile) -> Dict[str, str]:
    """Module-level ``NAME = ...  # guarded-by: <lock>`` declarations."""
    guarded: Dict[str, str] = {}
    for stmt in src.tree.body:
        if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            lock = src.marker(stmt.lineno, "guarded-by")
            if lock:
                targets = (
                    stmt.targets if isinstance(stmt, ast.Assign)
                    else [stmt.target]
                )
                for t in targets:
                    if isinstance(t, ast.Name):
                        guarded[t.id] = lock
    return guarded


class _AccessChecker(ast.NodeVisitor):
    """Walk one function body tracking the lexically-held lock set."""

    def __init__(
        self,
        src: SourceFile,
        owner: str,
        guarded_attrs: Dict[str, str],
        guarded_globals: Dict[str, str],
        findings: List[Finding],
        held: Optional[Set[str]] = None,
    ):
        self.src = src
        self.owner = owner  # "Class.method" or "function"
        self.guarded_attrs = guarded_attrs
        self.guarded_globals = guarded_globals
        self.findings = findings
        self.held: Set[str] = set(held or ())
        #: names locally bound in this scope shadow guarded globals
        self.local_names: Set[str] = set()
        #: names declared ``global`` — stores hit the module binding
        self.global_decls: Set[str] = set()

    # ---- lock scopes ----

    def visit_With(self, node: ast.With) -> None:
        prev = set(self.held)
        self.held |= _lock_exprs(node)
        for stmt in node.body:
            self.visit(stmt)
        self.held = prev
        # the with-items themselves (lock attribute reads) are exempt:
        # taking self._cv is how you GET into the guarded scope

    visit_AsyncWith = visit_With

    # ---- nested functions: closures run later, outside the lock ----

    def _visit_nested(self, node) -> None:
        req = self.src.func_marker(node, "requires-lock")
        held = {req} if req else set()
        sub = _AccessChecker(
            self.src, f"{self.owner}.{node.name}", self.guarded_attrs,
            self.guarded_globals, self.findings, held=held,
        )
        for stmt in node.body:
            sub.visit(stmt)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._visit_nested(node)

    def visit_AsyncFunctionDef(self, node) -> None:
        self._visit_nested(node)

    def visit_Lambda(self, node: ast.Lambda) -> None:
        # a lambda is a closure too — reset the held set
        sub = _AccessChecker(
            self.src, f"{self.owner}.<lambda>", self.guarded_attrs,
            self.guarded_globals, self.findings, held=set(),
        )
        sub.visit(node.body)

    # ---- accesses ----

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if (
            isinstance(node.value, ast.Name)
            and node.value.id == "self"
            and node.attr in self.guarded_attrs
        ):
            lock = self.guarded_attrs[node.attr]
            if lock not in self.held and not self.src.marker(
                node.lineno, "unlocked-ok"
            ):
                self.findings.append(Finding(
                    PASS, CODE_UNLOCKED, self.src.rel, node.lineno,
                    f"{self.owner}:{node.attr}",
                    f"`self.{node.attr}` is guarded-by `{lock}` but "
                    f"touched outside a `with {lock}` scope",
                ))
        self.generic_visit(node)

    def visit_Global(self, node: ast.Global) -> None:
        self.global_decls.update(node.names)

    def visit_Name(self, node: ast.Name) -> None:
        if isinstance(node.ctx, ast.Store) and node.id not in self.global_decls:
            self.local_names.add(node.id)
            return
        if (
            node.id in self.guarded_globals
            and node.id not in self.local_names
        ):
            lock = self.guarded_globals[node.id]
            if lock not in self.held and not self.src.marker(
                node.lineno, "unlocked-ok"
            ):
                self.findings.append(Finding(
                    PASS, CODE_UNLOCKED, self.src.rel, node.lineno,
                    f"{self.owner}:{node.id}",
                    f"global `{node.id}` is guarded-by `{lock}` but "
                    f"touched outside a `with {lock}` scope",
                ))


def _check_class(
    src: SourceFile, cls: ast.ClassDef, guarded_globals: Dict[str, str],
    findings: List[Finding],
) -> None:
    guarded = _guarded_decls(src, cls.body)
    if not guarded:
        return
    locks_taken: Set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            locks_taken |= _lock_exprs(node)
    for fn in cls.body:
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if fn.name in _EXEMPT_FUNCS:
            continue
        req = src.func_marker(fn, "requires-lock")
        if req:
            locks_taken.add(req)
        held = {req} if req else set()
        checker = _AccessChecker(
            src, f"{cls.name}.{fn.name}", guarded, guarded_globals,
            findings, held=held,
        )
        for stmt in fn.body:
            checker.visit(stmt)
    for attr, lock in sorted(guarded.items()):
        if lock not in locks_taken:
            findings.append(Finding(
                PASS, CODE_DEAD_LOCK, src.rel, cls.lineno,
                f"{cls.name}.{attr}",
                f"guarded-by `{lock}` but `with {lock}` never appears in "
                f"class {cls.name} — stale annotation or missing locking",
            ))


def check_file(src: SourceFile) -> List[Finding]:
    findings: List[Finding] = []
    guarded_globals = _module_guarded(src)
    for node in src.tree.body:
        if isinstance(node, ast.ClassDef):
            _check_class(src, node, guarded_globals, findings)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if guarded_globals and node.name not in _EXEMPT_FUNCS:
                req = src.func_marker(node, "requires-lock")
                checker = _AccessChecker(
                    src, node.name, {}, guarded_globals, findings,
                    held={req} if req else set(),
                )
                for stmt in node.body:
                    checker.visit(stmt)
    return findings


def run(root: str) -> List[Finding]:
    findings: List[Finding] = []
    for src in iter_source_files(root, subdirs=("volcano_tpu_torch/",)):
        findings.extend(check_file(src))
    return findings
