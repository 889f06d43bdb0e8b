"""VBUS serde/version-drift pass: the version-stamping rule made
machine-checked.

A copy of ``volcano_tpu/analysis/serde_drift.py`` over the port's bus
(``volcano_tpu_torch/bus/``), its exemplars and its README ladder.  Six
invariants over the bus protocol surface:

* ``SRD001`` — every object kind registered in
  ``bus/protocol.py::KINDS`` has a serde round-trip exemplar: a branch
  of ``exemplar(p, kind)`` in ``tests/test_torch_bus_wire.py`` (the
  port's round-trip test is parameterized over ``KINDS`` and builds each
  object there, so a kind added to the registry without a fixture fails
  the lint before it fails in production).
* ``SRD002`` — every op the server dispatches
  (``bus/server.py::_execute``) is version-registered in
  ``protocol.OP_VERSIONS``.  An unregistered op has no declared
  compatibility story.
* ``SRD003`` — every op introduced after ``MIN_VERSION`` must be
  version-gated on the client: the ``bus/remote.py`` method that sends
  it must carry the old-peer fallback (textually, it handles the
  ``unknown bus op`` typed error).  Version skew costs throughput,
  never correctness.
* ``SRD004`` — an op the client sends that the server does not handle
  (or vice versa: a registered op nobody dispatches) is drift between
  the two halves of the protocol.
* ``SRD005`` — the port's VBUS version-ladder paragraph in the README
  (the one that opens "The port speaks **VBUS version N** on the
  wire"; the reference's own ladder opens otherwise) must declare the CURRENT protocol version
  (``max(OP_VERSIONS.values())``) and name every registered op.
  Judged only when README.md exists (a repo checkout), like SRD001.
* ``SRD006`` — the exemplar corpus must round-trip through BOTH wire
  codecs: some test in the exemplars' module must drive ``exemplar``
  objects through the binary framing (``"binary"`` or
  ``CODEC_BINARY``), not just JSON.  A kind whose encoded form survives
  JSON but not msgpack (bytes values, non-string map keys) would
  otherwise ship undetected the day a binary peer connects.

This pass imports ``volcano_tpu_torch.bus.protocol`` (our own package —
the registries are the source of truth) and parses ``server.py`` /
``remote.py`` / the test module as AST.
"""

from __future__ import annotations

import ast
import os
from typing import List, Optional, Set

from volcano_tpu_torch.analysis.core import Finding, SourceFile

PASS = "serde"
CODE_NO_ROUNDTRIP = "SRD001"
CODE_UNREGISTERED_OP = "SRD002"
CODE_UNGATED_OP = "SRD003"
CODE_OP_DRIFT = "SRD004"
CODE_DOC_DRIFT = "SRD005"
CODE_NO_BINARY_ROUNDTRIP = "SRD006"

_PROTO = "volcano_tpu_torch/bus/protocol.py"
_SERVER = "volcano_tpu_torch/bus/server.py"
_REMOTE = "volcano_tpu_torch/bus/remote.py"
_TESTS = "tests/test_torch_bus_wire.py"
_README = "README.md"

#: the port's README version-ladder paragraph opens with this phrase
_LADDER_RE = r"port speaks \*\*VBUS version (\d+)\*\* on the wire"

#: the exemplar builder in ``_TESTS``: ``exemplar(p, kind)``, one
#: ``if kind == "<Kind>":`` branch a kind
_EXEMPLAR_FN = "exemplar"


def _load(root: str, rel: str) -> Optional[SourceFile]:
    path = os.path.join(root, rel)
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as f:
        return SourceFile(path, rel, f.read())


def _server_ops(src: SourceFile) -> Set[str]:
    """String constants compared against ``op`` in ``_execute``."""
    ops: Set[str] = set()
    for node in ast.walk(src.tree):
        if not (isinstance(node, ast.FunctionDef) and node.name == "_execute"):
            continue
        for sub in ast.walk(node):
            if isinstance(sub, ast.Compare) and len(sub.comparators) == 1:
                left, right = sub.left, sub.comparators[0]
                for a, b in ((left, right), (right, left)):
                    if (
                        isinstance(a, ast.Name) and a.id == "op"
                        and isinstance(b, ast.Constant)
                        and isinstance(b.value, str)
                    ):
                        ops.add(b.value)
    return ops


def _client_ops(src: SourceFile) -> dict:
    """op name → enclosing function source text, for every
    ``{"op": "<name>", ...}`` payload literal in remote.py."""
    ops = {}
    for node in ast.walk(src.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        fn_src = ast.get_source_segment(src.text, node) or ""
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Dict):
                continue
            for k, v in zip(sub.keys, sub.values):
                if (
                    isinstance(k, ast.Constant) and k.value == "op"
                    and isinstance(v, ast.Constant)
                    and isinstance(v.value, str)
                ):
                    # outermost enclosing function wins (first visit)
                    ops.setdefault(v.value, fn_src)
    return ops


def _has_binary_roundtrip(src: SourceFile) -> bool:
    """True when some test function drives the exemplar corpus through
    the binary framing — textually, its source calls ``exemplar(`` and
    names the binary codec."""
    for node in ast.walk(src.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not node.name.startswith("test"):
            continue
        fn_src = ast.get_source_segment(src.text, node) or ""
        if f"{_EXEMPLAR_FN}(" in fn_src and (
            "CODEC_BINARY" in fn_src or '"binary"' in fn_src
        ):
            return True
    return False


def _exemplar_kinds(src: SourceFile) -> Optional[Set[str]]:
    """Kinds the module-level ``exemplar`` builder has a branch for (the
    string constants compared with its ``kind`` argument), or None when
    the builder does not exist at all."""
    for node in src.tree.body:
        if not (isinstance(node, ast.FunctionDef) and node.name == _EXEMPLAR_FN):
            continue
        keys: Set[str] = set()
        for sub in ast.walk(node):
            if isinstance(sub, ast.Compare) and len(sub.comparators) == 1:
                left, right = sub.left, sub.comparators[0]
                if (
                    isinstance(left, ast.Name) and left.id == "kind"
                    and isinstance(right, ast.Constant)
                    and isinstance(right.value, str)
                ):
                    keys.add(right.value)
        return keys
    return None


def run(root: str) -> List[Finding]:
    from volcano_tpu_torch.bus import protocol

    findings: List[Finding] = []

    # ---- SRD001: round-trip exemplar per registered kind ----
    # Judged only when the tests tree is present (a repo checkout).  An
    # installed package has no tests/ directory — flagging every kind
    # there would make `vtctl lint` unusable outside the repo.
    tests = _load(root, _TESTS)
    if tests is not None:
        exemplars = _exemplar_kinds(tests)
        for kind in sorted(protocol.KINDS):
            if exemplars is None or kind not in exemplars:
                findings.append(Finding(
                    PASS, CODE_NO_ROUNDTRIP, _TESTS, 1, kind,
                    f"kind `{kind}` is registered in bus/protocol.py "
                    f"KINDS but has no serde round-trip exemplar in "
                    f"{_TESTS}::{_EXEMPLAR_FN}",
                ))
        # SRD006: the same corpus must survive the binary framing too
        if exemplars is not None and not _has_binary_roundtrip(tests):
            findings.append(Finding(
                PASS, CODE_NO_BINARY_ROUNDTRIP, _TESTS, 1,
                "binary-roundtrip",
                f"{_TESTS} round-trips its exemplars through JSON "
                f"only — no test drives the corpus through the binary "
                f"framing (protocol.CODEC_BINARY), so a kind whose "
                f"encoding survives JSON but not msgpack would ship "
                f"undetected",
            ))

    # ---- op registries ----
    op_versions = getattr(protocol, "OP_VERSIONS", None)
    server = _load(root, _SERVER)
    remote = _load(root, _REMOTE)
    server_ops = _server_ops(server) if server is not None else set()
    client_ops = _client_ops(remote) if remote is not None else {}

    if op_versions is None:
        for op in sorted(server_ops):
            findings.append(Finding(
                PASS, CODE_UNREGISTERED_OP, _PROTO, 1, op,
                "bus/protocol.py declares no OP_VERSIONS registry — every "
                "op needs a declared protocol version",
            ))
        return findings

    # SRD002: server dispatches an op with no declared version
    for op in sorted(server_ops - set(op_versions)):
        findings.append(Finding(
            PASS, CODE_UNREGISTERED_OP, _SERVER, 1, op,
            f"server dispatches op `{op}` but protocol.OP_VERSIONS does "
            f"not declare its introduction version",
        ))

    # SRD003: post-v1 ops must carry the old-peer fallback client-side
    for op, version in sorted(op_versions.items()):
        if version <= protocol.MIN_VERSION:
            continue
        fn_src = client_ops.get(op)
        if fn_src is not None and "unknown bus op" not in fn_src:
            findings.append(Finding(
                PASS, CODE_UNGATED_OP, _REMOTE, 1, op,
                f"op `{op}` was introduced at protocol v{version} > "
                f"MIN_VERSION={protocol.MIN_VERSION} but the client "
                f"method sending it has no old-peer fallback (must "
                f"handle the `unknown bus op` typed error)",
            ))

    # SRD004: drift between the two halves
    for op in sorted(set(client_ops) - server_ops):
        findings.append(Finding(
            PASS, CODE_OP_DRIFT, _REMOTE, 1, op,
            f"client sends op `{op}` that bus/server.py _execute never "
            f"dispatches",
        ))
    for op in sorted(set(op_versions) - server_ops):
        findings.append(Finding(
            PASS, CODE_OP_DRIFT, _PROTO, 1, op,
            f"protocol.OP_VERSIONS declares op `{op}` that bus/server.py "
            f"_execute never dispatches",
        ))

    # ---- SRD005: README version ladder tracks OP_VERSIONS ----
    readme_path = os.path.join(root, _README)
    if os.path.exists(readme_path):
        with open(readme_path, encoding="utf-8") as f:
            readme = f.read()
        findings.extend(_check_ladder(readme, op_versions))
    return findings


def _check_ladder(readme: str, op_versions) -> List[Finding]:
    """The port's VBUS version-ladder paragraph (located by its "port
    speaks **VBUS version N** on the wire" opener, ending at the next
    heading) must declare ``max(OP_VERSIONS.values())`` and mention
    every registered op as a backticked token."""
    import re

    findings: List[Finding] = []
    current = max(op_versions.values())
    m = re.search(_LADDER_RE, readme)
    if m is None:
        return [Finding(
            PASS, CODE_DOC_DRIFT, _README, 1, "version-ladder",
            "README has no port VBUS version-ladder paragraph (expected "
            "'port speaks **VBUS version N** on the wire') — the "
            "protocol surface must be documented",
        )]
    lineno = readme.count("\n", 0, m.start()) + 1
    declared = int(m.group(1))
    if declared != current:
        findings.append(Finding(
            PASS, CODE_DOC_DRIFT, _README, lineno, "version-ladder",
            f"README declares VBUS version {declared} but "
            f"protocol.OP_VERSIONS tops out at v{current} — the stale "
            f"ladder paragraph again",
        ))
    # the section runs to the next markdown HEADING ("# " .. "###### ")
    # outside a code fence — a bare "\n#" search would truncate at a
    # `# comment` line inside a fenced shell example
    section_end = None
    in_fence = False
    pos = m.end()
    for line_m in re.finditer(r"^(.*)$", readme[pos:], re.MULTILINE):
        line = line_m.group(1)
        if line.lstrip().startswith("```"):
            in_fence = not in_fence
        elif not in_fence and re.match(r"#{1,6} ", line):
            section_end = pos + line_m.start()
            break
    section = readme[m.start(): section_end]
    mentioned = set(re.findall(r"`([a-z0-9_]+)`", section))
    for op in sorted(set(op_versions) - mentioned):
        findings.append(Finding(
            PASS, CODE_DOC_DRIFT, _README, lineno, op,
            f"op `{op}` (v{op_versions[op]}) is registered in "
            f"protocol.OP_VERSIONS but the README version-ladder "
            f"paragraph never names it",
        ))
    return findings
