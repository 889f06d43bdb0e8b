"""Every case of a test file of the JAX package, on the port and on the
JAX package, with the stores of the two runs compared.

:func:`load` executes a fresh copy of a test file's source: for the port
with every import of ``volcano_tpu`` pointed at ``volcano_tpu_torch``,
for the JAX package as it is; each copy gets a fresh copy of
``tests/builders.py`` (its uid and timestamp counters start at 1 in
both runs).  In each copy the ``APIServer`` (and ``PersistentAPIServer``)
the file builds its stores with records every store made, and ``vtctl``
records every command's argv, exit code and text.  The port has no
``metrics.metrics`` module: its copy reads ``from volcano_tpu_torch
import metrics``, whose registry has the reference's names.
:func:`cases` lists a file's test functions and methods, ``parametrize``
marks expanded, as ids; :func:`run_case` runs one of them on one copy,
with the file's own fixtures (its autouse ones around the case) and
``tmp_path`` and ``monkeypatch`` resolved by hand, and a ``skipif``
mark of the case honoured.

:func:`store_dump` extends ``tests.test_torch_store_loop.store_dump``
(pods, Events, PodGroups, and the Job path's kinds) with the specs the
controllers write.
"""

from __future__ import annotations

import inspect
import io
import itertools
import re
import sys
import types
from pathlib import Path

import pytest

from tests.test_torch_store_loop import store_dump as _pod_dump

ROOT = Path(__file__).resolve().parent.parent
_seq = itertools.count()

#: vtctl commands that only read the store: the port's text for them is
#: held byte for byte against the JAX vtctl's on the same store
READ_ONLY = {("job", "list"), ("job", "view"), ("queue", "get"), ("queue", "list"),
             ("describe", "job"), ("describe", "podgroup"), ("bus", "status")}


def _port_source(text: str) -> str:
    text = re.sub(r"\bvolcano_tpu\b(?!_torch)", "volcano_tpu_torch", text)
    return text.replace("from volcano_tpu_torch.metrics import metrics",
                        "from volcano_tpu_torch import metrics")


def _exec(name: str, path: Path, source: str) -> types.ModuleType:
    mod = types.ModuleType(name)
    mod.__file__ = str(path)
    sys.modules[name] = mod
    exec(compile(source, str(path), "exec"), mod.__dict__)
    return mod


def load(rel: str, pkg: str, port_edits=()) -> types.ModuleType:
    """A fresh copy of the test file ``rel`` (relative to the repo) for
    ``pkg`` ("port" or "jax"), its stores and vtctl calls recorded in
    ``mod.STORES`` and ``mod.VTCTL``.  ``port_edits`` are (old, new)
    text replacements made in the port's copy after its imports are
    pointed at the port, each of which must match: the names the port
    gives what the JAX package calls otherwise (an action, a replay
    executor, a binary's flag)."""
    n = next(_seq)
    path = ROOT / rel
    source = path.read_text()
    if "tests.builders" in source:
        bpath = ROOT / "tests" / "builders.py"
        btext = bpath.read_text()
        _exec(f"tests._mirror_builders_{n}", bpath,
              _port_source(btext) if pkg == "port" else btext)
        source = source.replace("tests.builders", f"tests._mirror_builders_{n}")
    if pkg == "port":
        source = _port_source(source)
        for old, new in port_edits:
            assert old in source, f"{rel} no longer holds {old!r}"
            source = source.replace(old, new)
    mod = _exec(f"tests._mirror_{n}", path, source)
    if pkg == "port":
        leaked = [k for k, v in vars(mod).items()
                  if (getattr(v, "__name__", "") if isinstance(v, types.ModuleType)
                      else getattr(v, "__module__", "") or "").split(".")[0] == "volcano_tpu"]
        assert not leaked, f"the port's copy of {rel} holds the JAX package's {leaked}"
    mod.PKG = pkg
    mod.TMP = None
    mod.STORES = []
    mod.VTCTL = []
    for name in ("APIServer", "PersistentAPIServer"):
        if hasattr(mod, name):
            setattr(mod, name, _recording(mod, getattr(mod, name)))
    if hasattr(mod, "vtctl"):
        mod.vtctl = _recording_vtctl(mod, mod.vtctl)
    return mod


def _recording(mod, base):
    """``base`` whose every instance is appended to ``mod.STORES``."""
    class Recording(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            mod.STORES.append(self)

    Recording.__name__ = Recording.__qualname__ = base.__name__
    return Recording


def _recording_vtctl(mod, main):
    """``vtctl`` that records (argv, rc, text) of each call; on the port,
    a read-only command is also run by the JAX vtctl on the same store
    and its text recorded beside the port's."""
    def vtctl(argv, api=None, out=None):
        out = out if out is not None else io.StringIO()
        start = len(out.getvalue())
        rc = main(argv, api, out)
        text = out.getvalue()[start:]
        twin = None
        if mod.PKG == "port" and tuple(argv[:2]) in READ_ONLY:
            from volcano_tpu.cli.vtctl import main as jax_main

            buf = io.StringIO()
            twin = (jax_main(list(argv), api=api, out=buf), buf.getvalue())
        # a path under the run's tmp_path reads "<tmp>"
        argv = [a.replace(str(mod.TMP), "<tmp>") for a in argv]
        mod.VTCTL.append(dict(argv=argv, rc=rc, text=text, twin=twin))
        return rc

    return vtctl


def _marks(obj):
    return getattr(obj, "pytestmark", [])


def cases(mod) -> list:
    """(id, marks) of every test of ``mod``: ``Class::method`` or
    ``function``, with ``[i]`` for the i-th parameter set of a
    parametrized one; ``marks`` holds the names of its other marks."""
    out = []
    for name, obj in vars(mod).items():
        if name.startswith("Test") and inspect.isclass(obj):
            tests = [(f"{name}::{m}", getattr(obj, m)) for m in vars(obj) if m.startswith("test_")]
        elif name.startswith("test_") and inspect.isfunction(obj):
            tests = [(name, obj)]
        else:
            continue
        for tid, fn in tests:
            marks = _marks(fn)
            others = tuple(m.name for m in marks if m.name != "parametrize")
            params = [m for m in marks if m.name == "parametrize"]
            if params:
                for i in range(len(params[0].args[1])):
                    out.append((f"{tid}[{i}]", others))
            else:
                out.append((tid, others))
    return out


def _resolve(mod, case: str):
    """The function of ``case`` in ``mod`` (bound to a fresh instance for
    a method) and its parameter values."""
    m = re.fullmatch(r"([^\[]+)(?:\[(\d+)\])?", case)
    qual, index = m.group(1), m.group(2)
    if "::" in qual:
        cls_name, meth = qual.split("::")
        raw = getattr(getattr(mod, cls_name), meth)
        fn = getattr(getattr(mod, cls_name)(), meth)
    else:
        raw = fn = getattr(mod, qual)
    values = {}
    if index is not None:
        mark = next(x for x in _marks(raw) if x.name == "parametrize")
        names = [s.strip() for s in mark.args[0].split(",")]
        row = mark.args[1][int(index)]
        row = row.values if hasattr(row, "values") else row
        values = dict(zip(names, row if len(names) > 1 else (row,)))
    return fn, values


def run_case(mod, case: str, tmp_path: Path) -> None:
    """Run ``case`` of ``mod``: the file's fixtures (plain or generator
    functions) are called by hand, ``tmp_path`` is ``tmp_path`` and
    ``monkeypatch`` a fresh one undone after the run."""
    fn, values = _resolve(mod, case)
    for mark in _marks(getattr(fn, "__func__", fn)):
        if mark.name == "skipif" and mark.args and mark.args[0]:
            pytest.skip(mark.kwargs.get("reason", "skipif"))
    mod.TMP = tmp_path
    finalizers = []
    patch = pytest.MonkeyPatch()
    try:
        for value in vars(mod).values():
            marker = getattr(value, "_fixture_function_marker", None)
            if marker is not None and marker.autouse:
                gen = value._get_wrapped_function()()
                if inspect.isgenerator(gen):
                    next(gen)
                    finalizers.append(gen)
        kwargs = dict(values)
        for name in inspect.signature(fn).parameters:
            if name in kwargs:
                continue
            if name == "tmp_path":
                tmp_path.mkdir(parents=True, exist_ok=True)
                kwargs[name] = tmp_path
            elif name == "monkeypatch":
                kwargs[name] = patch
            else:
                fixture = getattr(mod, name)
                raw = fixture._get_wrapped_function()
                value = raw()
                if inspect.isgenerator(value):
                    gen, value = value, next(value)
                    finalizers.append(gen)
                kwargs[name] = value
        fn(**kwargs)
    finally:
        for gen in reversed(finalizers):
            next(gen, None)
        patch.undo()


def store_dump(api) -> dict:
    """``test_torch_store_loop.store_dump`` with the scheduling objects'
    specs the controllers write: each Queue's weight and status, each
    pod's scheduler name, annotations and labels, each PodGroup's spec,
    where the store holds any."""
    out = _pod_dump(api)

    def key(o):
        return f"{o.metadata.namespace}/{o.metadata.name}"

    queues = {key(q): (q.spec.weight, q.status.state, q.status.pending, q.status.running,
                       q.status.inqueue, q.status.unknown) for q in api.list("Queue")}
    pod_specs = {key(p): (p.spec.scheduler_name, tuple(sorted(p.metadata.annotations.items())),
                          tuple(sorted(p.metadata.labels.items()))) for p in api.list("Pod")}
    pod_group_specs = {key(g): (g.spec.min_member, g.spec.queue,
                                tuple(sorted(g.spec.min_resources.items())))
                       for g in api.list("PodGroup")}
    for name, section in (("queues", queues), ("pod_specs", pod_specs),
                          ("pod_group_specs", pod_group_specs)):
        if section:
            out[name] = section
    return out
