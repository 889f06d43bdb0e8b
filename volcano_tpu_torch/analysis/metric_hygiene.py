"""Metric hygiene pass (MTR) — bounded label vocabularies and no
orphaned catalog entries.

A copy of ``volcano_tpu/analysis/metric_hygiene.py`` over
``volcano_tpu_torch/``, whose catalog is ``metrics/__init__.py``.

Prometheus label values are series keys: an unbounded vocabulary
(job names, pod names, error strings) mints one series per distinct
value forever — the classic cardinality explosion every scrape then
pays for.  And a metric helper nobody calls is a catalog entry that
dashboards reference and operators trust while it silently exports
nothing.  Two codes:

* **MTR001 (unbounded label)** — every ``registry.inc`` /
  ``set_gauge`` / ``histogram`` call whose label dict carries a
  NON-LITERAL value must declare the vocabulary's bound: either the
  enclosing function's docstring names it (``result ∈ {scheduled,
  unschedulable, error}`` — the catalog's existing idiom) or a
  ``# label-vocab: <label> — <what bounds it>`` comment inside the
  function does.  The declaration is checked per label key; an
  undeclared dynamic label is a finding.  Routing a value through
  :func:`metrics.bounded_label` (the cardinality cap) and saying so in
  the declaration is the canonical fix for genuinely-operator-shaped
  input.
* **MTR002 (orphaned metric)** — a helper defined in
  ``volcano_tpu_torch/metrics/__init__.py`` (``update_*`` / ``register_*`` /
  ``observe_*``) that no product module ever calls.  Tests don't
  count: a metric only a test observes is still dead in production.

Inline waiver: ``# mtr: <reason>`` on the offending line (the shared
marker discipline, reason mandatory).
"""

from __future__ import annotations

import ast
import re
from typing import List, Optional

from volcano_tpu_torch.analysis.core import Finding, SourceFile, iter_source_files

PASS_ID = "mtr"
METRICS_FILE = "volcano_tpu_torch/metrics/__init__.py"
_EMIT_METHODS = {"inc", "set_gauge", "histogram"}
_HELPER_PREFIXES = ("update_", "register_", "observe_")


def _is_registry(node: ast.AST) -> bool:
    """The emission receiver: a name/attribute chain ending in
    ``registry`` (module-level ``registry`` or ``metrics.registry``)."""
    if isinstance(node, ast.Name):
        return node.id == "registry"
    if isinstance(node, ast.Attribute):
        return node.attr == "registry"
    return False


def _vocab_declarations(src: SourceFile, func: ast.AST) -> str:
    """Every ``label-vocab:`` comment value inside the function span,
    joined — one declaration may bound several labels ("from, to —
    the executor rung names")."""
    end = getattr(func, "end_lineno", func.lineno)
    parts: List[str] = []
    for ln in range(func.lineno, end + 1):
        comment = src.comments.get(ln)
        if comment is None:
            continue
        body = comment.lstrip(":").strip()
        if body.startswith("label-vocab:"):
            parts.append(body[len("label-vocab:"):].strip())
    return " ".join(parts)


def _declares(label: str, docstring: str, vocab: str) -> bool:
    if f"{label} ∈" in docstring:
        return True
    return bool(re.search(rf"\b{re.escape(label)}\b", vocab))


def _check_call(
    src: SourceFile, func: Optional[ast.AST], call: ast.Call,
    findings: List[Finding],
) -> None:
    if not (isinstance(call.func, ast.Attribute)
            and call.func.attr in _EMIT_METHODS
            and _is_registry(call.func.value)):
        return
    if len(call.args) < 2:
        return
    if src.marker(call.lineno, "mtr"):
        return
    symbol = getattr(func, "name", "<module>")
    docstring = (ast.get_docstring(func) or "") if isinstance(
        func, (ast.FunctionDef, ast.AsyncFunctionDef)
    ) else ""
    vocab = _vocab_declarations(src, func) if func is not None else ""
    labels = call.args[1]
    if not isinstance(labels, ast.Dict):
        # a whole dict built elsewhere — undeclarable statically;
        # require the declaration comment naming what bounds it
        if not (docstring and "∈" in docstring) and not vocab:
            findings.append(Finding(
                PASS_ID, "MTR001", src.rel, call.lineno, symbol,
                "label dict is not a literal and no vocabulary is "
                "declared (docstring '∈' or '# label-vocab:')",
            ))
        return
    for key_node, value_node in zip(labels.keys, labels.values):
        if not isinstance(key_node, ast.Constant):
            continue
        if isinstance(value_node, ast.Constant):
            continue  # literal value — bounded by construction
        label = str(key_node.value)
        if not _declares(label, docstring, vocab):
            findings.append(Finding(
                PASS_ID, "MTR001", src.rel, call.lineno,
                f"{symbol}.{label}",
                f"label {label!r} takes a non-literal value with no "
                f"declared vocabulary — document the bound "
                f"('{label} ∈ {{...}}' in the docstring or a "
                f"'# label-vocab: {label} — ...' comment), or route "
                f"through metrics.bounded_label",
            ))


def _walk_with_scope(
    src: SourceFile, node: ast.AST, func: Optional[ast.AST],
    findings: List[Finding],
) -> None:
    for child in ast.iter_child_nodes(node):
        scope = func
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scope = child
        if isinstance(child, ast.Call):
            _check_call(src, func, child, findings)
        _walk_with_scope(src, child, scope, findings)


def _helpers(src: SourceFile) -> List[ast.FunctionDef]:
    """Metric helpers: module-level defs with an emitting prefix whose
    body actually touches the registry."""
    out = []
    for node in src.tree.body:
        if not isinstance(node, ast.FunctionDef):
            continue
        if not node.name.startswith(_HELPER_PREFIXES):
            continue
        emits = any(
            isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute)
            and sub.func.attr in _EMIT_METHODS | {"observe"}
            for sub in ast.walk(node)
        )
        if emits:
            out.append(node)
    return out


def run(root: str) -> List[Finding]:
    findings: List[Finding] = []
    metrics_src: Optional[SourceFile] = None
    product_texts: List[str] = []
    for src in iter_source_files(root, subdirs=("volcano_tpu_torch/",)):
        _walk_with_scope(src, src.tree, None, findings)
        if src.rel == METRICS_FILE:
            metrics_src = src
        elif not src.rel.startswith("volcano_tpu_torch/metrics/"):
            product_texts.append(src.text)
    if metrics_src is not None:
        blob = "\n".join(product_texts)
        for helper in _helpers(metrics_src):
            if metrics_src.marker(helper.lineno, "mtr"):
                continue
            if not re.search(rf"\b{re.escape(helper.name)}\b", blob):
                findings.append(Finding(
                    PASS_ID, "MTR002", METRICS_FILE, helper.lineno,
                    helper.name,
                    f"metric helper {helper.name!r} is never called from "
                    f"any product module — wire it where the reference "
                    f"observes it, or delete the catalog entry",
                ))
    return findings
