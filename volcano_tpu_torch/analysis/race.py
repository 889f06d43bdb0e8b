"""Happens-before race detector — the enforcement layer over the
``# guarded-by:`` declarations.

The lexical lock-discipline pass (LCK001) proves that every *spelled*
access of a guarded attribute sits inside a ``with <lock>`` block — but
an access through an alias (``st = self._points; st[...] = ...`` from
another module) or a cross-module touch never spells ``self.<attr>``
and escapes the pass entirely.  This module (a copy of
``volcano_tpu/analysis/race.py`` for the port) finds the races the text
cannot show, at runtime, with vector clocks:

* Every thread carries a vector clock.  Sync edges come from the SAME
  instrumented-lock proxies the lock-order verifier installs
  (``lock_order.set_listener``), plus ``threading.Thread`` start/join,
  ``queue.Queue`` put/get, and ``threading.Event`` set/wait —
  ``Condition`` wait/notify is ordered through its lock's clock via the
  proxies' ``_release_save``/``_acquire_restore`` protocol, which is
  the actual happens-before a condition variable provides.
* Every attribute declared ``# guarded-by: <lock>`` anywhere under
  ``volcano_tpu_torch/`` is wrapped in a data descriptor
  (:func:`instrument_package`): each read/write from volcano_tpu_torch code
  is checked against the variable's last-access epochs (a FastTrack-
  style write epoch + per-thread read epochs).  Two accesses, at least
  one a write, with no happens-before path between them, is a data
  race — regardless of which module, alias, or closure performed it.
* The lexical pass stays the *declaration* layer (what state is
  shared, which lock owns it); this detector is the *enforcement*
  layer (the declared discipline actually orders every access).

A declaration line may carry ``# race-ok: <reason>`` to waive runtime
tracking for one attribute (e.g. a benign monotonic flag read) — the
reason is mandatory, mirroring ``# unlocked-ok:``.

Wire-up mirrors ``lock_order``: nothing reads an environment variable
here.  The port's tests :func:`install` the detector in a fixture,
:func:`instrument_package`, drive the threaded code, read
:func:`races` and :func:`uninstall`, which also takes the tracking
descriptors off the classes again.  Only objects and locks created
while it is installed are tracked.  :func:`install` refuses while
another detector's patches (the JAX package's) are in place.
"""

from __future__ import annotations

import itertools
import json
import os
import queue as _queue_mod
import sys
import threading
from typing import Dict, List, Optional, Tuple

from volcano_tpu_torch.analysis import lock_order
from volcano_tpu_torch.analysis.core import SourceFile, iter_source_files

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT_DIR = os.path.dirname(_PKG_DIR)

#: reports kept; past this the detector stops recording (a broken
#: build would otherwise fill memory with one cascading race)
_MAX_REPORTS = 200

#: stack frames remembered per access (file:line strings — cheap
#: ``sys._getframe`` walk, not a full traceback render)
_SITE_DEPTH = 4


def _short(path: str) -> str:
    if path.startswith(_ROOT_DIR):
        return os.path.relpath(path, _ROOT_DIR)
    return path


def _fmt_site(site) -> List[str]:
    """Render the raw ``(filename, lineno)`` pairs a site captures —
    lazily, at report time, never on the per-access hot path."""
    return [f"{_short(fn)}:{lineno}" for fn, lineno in site]


class RaceReport:
    """One detected race: two accesses to ``symbol`` (at least one a
    write) with no happens-before edge between them."""

    def __init__(self, symbol: str, kind: str,
                 prev_thread: str, prev_site: List[Tuple[str, int]],
                 cur_thread: str, cur_site: List[Tuple[str, int]]):
        self.symbol = symbol
        self.kind = kind  # "write-write" | "read-write" | "write-read"
        self.prev_thread = prev_thread
        self.prev_site = prev_site  # raw (filename, lineno) pairs
        self.cur_thread = cur_thread
        self.cur_site = cur_site

    @property
    def key(self) -> Tuple:
        first = lambda s: s[0] if s else None  # noqa: E731
        return (self.symbol, self.kind, first(self.prev_site),
                first(self.cur_site))

    def render(self) -> str:
        prev = "\n    ".join(_fmt_site(self.prev_site)) or "?"
        cur = "\n    ".join(_fmt_site(self.cur_site)) or "?"
        return (
            f"data race ({self.kind}) on {self.symbol}\n"
            f"  earlier access by {self.prev_thread} at:\n    {prev}\n"
            f"  racing access by {self.cur_thread} at:\n    {cur}"
        )

    def to_dict(self) -> dict:
        return {
            "symbol": self.symbol, "kind": self.kind,
            "prev_thread": self.prev_thread,
            "prev_site": _fmt_site(self.prev_site),
            "cur_thread": self.cur_thread,
            "cur_site": _fmt_site(self.cur_site),
        }


class _ThreadState:
    __slots__ = ("idx", "vc", "name", "busy")

    def __init__(self, idx: int, name: str):
        self.idx = idx
        #: vector clock: thread idx → logical time
        self.vc: Dict[int, int] = {idx: 1}
        self.name = name
        #: re-entrancy latch: a GC pass triggered by the detector's own
        #: allocations can run a ``__del__`` that releases an
        #: instrumented lock, re-entering the detector while its mutex
        #: is held — those nested events are skipped (a destructor is
        #: not a synchronization point), which is what keeps the
        #: non-reentrant mutex deadlock-free
        self.busy = False


class _VarState:
    """FastTrack-style shadow state for one (instance, attribute)."""

    __slots__ = ("write", "write_site", "write_thread", "reads")

    def __init__(self):
        #: last write epoch (thread idx, clock) or None
        self.write: Optional[Tuple[int, int]] = None
        self.write_site: List[str] = []
        self.write_thread = ""
        #: thread idx → (clock, site, thread name) for reads since the
        #: last ordered write
        self.reads: Dict[int, Tuple[int, List[str], str]] = {}


_det_ids = itertools.count()


class Detector:
    """The vector-clock engine.  One instance is installed globally by
    :func:`install`; tests may drive a private instance directly."""

    def __init__(self, restrict_to_pkg: bool = True):
        # raw primitives — the detector must never run through the
        # instrumented proxies it listens to
        self._mutex = lock_order._real_lock()
        self._tids = itertools.count(1)
        self._tls = threading.local()
        #: namespaces this detector's entries in the `_race_vc0` /
        #: `_race_vcf` thread attributes: thread indices are a
        #: PER-DETECTOR numbering, so a private test detector adopting
        #: a clock the globally installed one stamped on the thread
        #: would fabricate happens-before edges (colliding indices) and
        #: mask real races
        self._det_id = next(_det_ids)
        #: sync-object id → vector clock (locks by proxy id, queues and
        #: events by object id)
        self._sync: Dict[int, Dict[int, int]] = {}
        #: queues/events pinned alive while their clock exists — locks
        #: are already pinned by lock_order's registry, but a gc'd
        #: Queue's recycled id would hand its stale clock to an
        #: unrelated object and fabricate happens-before edges (false
        #: negatives).  Only send() creates _sync entries, so pinning
        #: at send time closes the hazard.
        self._keep_sync: Dict[int, object] = {}
        #: (id(instance), attr-symbol) → shadow state; instances are
        #: kept alive by the strong key holder so a recycled id cannot
        #: inherit a dead object's epochs (the lock_order._keep rule)
        self._vars: Dict[Tuple[int, str], _VarState] = {}
        self._keep: List[object] = []
        self.reports: List[RaceReport] = []
        self._seen_keys: set = set()
        self.restrict_to_pkg = restrict_to_pkg
        #: accesses checked (observability for tests / the report)
        self.n_accesses = 0

    # ---- per-thread clocks ----

    def _state(self) -> _ThreadState:
        st = getattr(self._tls, "st", None)
        if st is None:
            # NEVER threading.current_thread() here: during
            # _bootstrap_inner the thread sets its started Event BEFORE
            # registering in _active, and current_thread() would mint a
            # _DummyThread whose __init__ sets ITS started Event —
            # infinite recursion through the patched Event.set.  A
            # non-creating _active lookup is enough; threads started
            # through the patched Thread.start refine name + parent
            # clock in child_started().
            ident = threading.get_ident()
            cur = threading._active.get(ident)
            idx = next(self._tids)
            st = _ThreadState(
                idx, cur.name if cur is not None else f"thread-{ident}"
            )
            forked = getattr(cur, "_race_vc0", None) if cur else None
            parent = forked.get(self._det_id) if forked else None
            if parent:
                self._join(st.vc, parent)
            self._tls.st = st
        return st

    def child_started(self, thread: threading.Thread) -> None:
        """First call on a child thread started through the patched
        ``Thread.start``: adopt the parent's forked clock (idempotent —
        joins are monotone) and the thread's real name."""
        st = self._state()
        st.name = thread.name
        forked = getattr(thread, "_race_vc0", None)
        parent = forked.get(self._det_id) if forked else None
        if parent:
            self._join(st.vc, parent)

    @staticmethod
    def _join(into: Dict[int, int], other: Dict[int, int]) -> None:
        for k, v in other.items():
            if v > into.get(k, 0):
                into[k] = v

    # ---- sync edges ----

    def send(self, obj_id: int, pin: Optional[object] = None) -> None:
        """Publish the calling thread's clock onto a sync object
        (lock release, queue put, event set, thread fork).  ``pin``
        keeps an un-registered sync object (queue, event) alive so its
        id cannot be recycled while its clock is live."""
        st = self._state()
        if st.busy:
            return
        st.busy = True
        try:
            with self._mutex:
                if pin is not None and obj_id not in self._keep_sync:
                    self._keep_sync[obj_id] = pin
                vc = self._sync.setdefault(obj_id, {})
                self._join(vc, st.vc)
            st.vc[st.idx] = st.vc.get(st.idx, 0) + 1
        finally:
            st.busy = False

    def recv(self, obj_id: int) -> None:
        """Adopt a sync object's clock (lock acquire, queue get, event
        wait, thread join)."""
        st = self._state()
        if st.busy:
            return
        st.busy = True
        try:
            with self._mutex:
                vc = self._sync.get(obj_id)
                if vc:
                    self._join(st.vc, vc)
        finally:
            st.busy = False

    # the lock_order listener protocol
    def lock_released(self, lock_id: int) -> None:
        self.send(lock_id)

    def lock_acquired(self, lock_id: int) -> None:
        self.recv(lock_id)

    # thread lifecycle (patched Thread.start/join call these)
    def fork(self, thread: threading.Thread) -> None:
        st = self._state()
        forked = getattr(thread, "_race_vc0", None)
        if forked is None:
            forked = {}
            thread._race_vc0 = forked
        forked[self._det_id] = dict(st.vc)
        st.vc[st.idx] = st.vc.get(st.idx, 0) + 1

    def joined(self, thread: threading.Thread) -> None:
        finals = getattr(thread, "_race_vcf", None)
        final = finals.get(self._det_id) if finals else None
        if final:
            st = self._state()
            self._join(st.vc, final)

    def thread_exit(self, thread: threading.Thread) -> None:
        st = getattr(self._tls, "st", None)
        if st is not None:
            finals = getattr(thread, "_race_vcf", None)
            if finals is None:
                finals = {}
                thread._race_vcf = finals
            finals[self._det_id] = dict(st.vc)

    # ---- tracked accesses ----

    def _site(self, frame) -> List[Tuple[str, int]]:
        """Raw ``(filename, lineno)`` pairs — the walk must happen at
        access time (frames mutate as execution continues), but the
        path-shortening/string formatting is deferred to report
        rendering: this runs on EVERY tracked read inside the global
        detector mutex, and the strings are discarded unless a race is
        later reported against this epoch."""
        out: List[Tuple[str, int]] = []
        f = frame
        while f is not None and len(out) < _SITE_DEPTH:
            fn = f.f_code.co_filename
            if not fn.startswith("<"):
                out.append((fn, f.f_lineno))
            f = f.f_back
        return out

    def record(self, obj, symbol: str, is_write: bool, frame) -> None:
        """One read/write of a tracked attribute.  ``frame`` is the
        accessing frame (the descriptor passes its caller)."""
        if self.restrict_to_pkg:
            fn = frame.f_code.co_filename
            if not fn.startswith(_PKG_DIR + os.sep):
                return  # tests/bench poking at internals: not product
        st = self._state()
        if st.busy:
            return
        st.busy = True
        try:
            self._record_locked(obj, symbol, is_write, frame, st)
        finally:
            st.busy = False

    def _record_locked(self, obj, symbol: str, is_write: bool, frame,
                       st: _ThreadState) -> None:
        my = st.vc
        clk = my.get(st.idx, 0)
        key = (id(obj), symbol)
        with self._mutex:
            self.n_accesses += 1
            var = self._vars.get(key)
            if var is None:
                var = self._vars[key] = _VarState()
                self._keep.append(obj)
            races: List[Tuple[str, str, list]] = []
            w = var.write
            if w is not None and my.get(w[0], 0) < w[1]:
                races.append((
                    "write-write" if is_write else "write-read",
                    var.write_thread, var.write_site,
                ))
            if is_write:
                for ridx, (rclk, rsite, rname) in var.reads.items():
                    if ridx != st.idx and my.get(ridx, 0) < rclk:
                        races.append(("read-write", rname, rsite))
            site = None
            if races and len(self.reports) < _MAX_REPORTS:
                site = self._site(frame)
                for kind, pname, psite in races:
                    rep = RaceReport(symbol, kind, pname, psite,
                                     st.name, site)
                    if rep.key not in self._seen_keys:
                        self._seen_keys.add(rep.key)
                        self.reports.append(rep)
            if is_write:
                var.write = (st.idx, clk)
                var.write_site = site if site is not None else \
                    self._site(frame)
                var.write_thread = st.name
                # a write ordered after (or racing — reported once)
                # every read resets the read set: FastTrack's
                # read-clear, which also stops cascade reports
                var.reads.clear()
            else:
                var.reads[st.idx] = (clk, self._site(frame), st.name)

    # ---- reporting ----

    def report(self) -> dict:
        with self._mutex:
            return {
                "accesses": self.n_accesses,
                "tracked_vars": len(self._vars),
                "races": [r.to_dict() for r in self.reports],
            }


_detector: Optional[Detector] = None

_orig_thread_start = threading.Thread.start
_orig_thread_join = threading.Thread.join
#: the clock transfer hooks `_put`/`_get`, not `put`/`get`: those run
#: while the queue's own mutex is held, so the channel-clock merge is
#: atomic with the item transfer AND only happens on success — hooking
#: around `put` would either fabricate a producer→consumer edge when a
#: bounded put raises Full (send-before-put), or open a window where a
#: consumer gets the item before the producer's clock lands
#: (send-after-put → false positive).  Each class defines its own
#: `_put`/`_get` (Lifo/Priority override), so all three are patched.
_QUEUE_CLASSES = (
    _queue_mod.Queue, _queue_mod.LifoQueue, _queue_mod.PriorityQueue,
)
_orig_queue_internals = {
    cls: (cls._put, cls._get) for cls in _QUEUE_CLASSES
}
_orig_event_set = threading.Event.set
_orig_event_wait = threading.Event.wait


def _patched_start(self):
    det = _detector
    if det is not None:
        det.fork(self)
        orig_run = self.run

        def _run_capturing_final_clock():
            d0 = _detector
            if d0 is not None:
                d0.child_started(self)
            try:
                orig_run()
            finally:
                # published BEFORE _bootstrap_inner wakes joiners, so
                # a join that returns always sees the final clock
                d = _detector
                if d is not None:
                    d.thread_exit(self)

        self.run = _run_capturing_final_clock
    return _orig_thread_start(self)


def _patched_join(self, timeout=None):
    _orig_thread_join(self, timeout)
    det = _detector
    # the edge is recorded only when the thread is observed dead — and
    # in CPython that observation IS a synchronization: both a
    # completed join and is_alive() itself acquire the dying thread's
    # tstate lock, which _bootstrap_inner releases AFTER our wrapped
    # run published the final clock.  Residual corner: a timed-out
    # join whose thread dies in the gap AND whose tstate lock was
    # already reaped by a THIRD thread's is_alive() — this thread then
    # adopts the clock off a flag read it never synchronized on.  No
    # product path does that (timed-join shutdown sites don't share a
    # corpse across observers); accepting it avoids the alternative —
    # treating every timed join as non-synchronizing — which would
    # false-positive every join(timeout)-then-cleanup shutdown path.
    if det is not None and not self.is_alive():
        det.joined(self)


def _make_patched_put(orig):
    def _patched_put(self, item):
        orig(self, item)
        # under self.mutex (queue.put holds it around _put): atomic
        # with the insertion, unreachable when a bounded put raises
        det = _detector
        if det is not None:
            det.send(id(self), pin=self)
    return _patched_put


def _make_patched_get(orig):
    def _patched_get(self):
        # under self.mutex: every completed _put's clock is already on
        # the channel, including the popped item's producer
        det = _detector
        if det is not None:
            det.recv(id(self))
        return orig(self)
    return _patched_get


def _patched_event_set(self):
    det = _detector
    if det is not None:
        det.send(id(self), pin=self)
    return _orig_event_set(self)


def _patched_event_wait(self, timeout=None):
    got = _orig_event_wait(self, timeout)
    det = _detector
    if det is not None and got:
        det.recv(id(self))
    return got


# ---- guarded-state discovery + descriptor instrumentation ----

class GuardedAttr:
    """One ``# guarded-by:`` declaration found in the tree."""

    __slots__ = ("module", "cls", "attr", "lock", "waived")

    def __init__(self, module: str, cls: str, attr: str, lock: str,
                 waived: Optional[str]):
        self.module = module
        self.cls = cls
        self.attr = attr
        self.lock = lock
        self.waived = waived

    @property
    def symbol(self) -> str:
        return f"{self.module}:{self.cls}.{self.attr}"


def scan_guarded(root: Optional[str] = None) -> List[GuardedAttr]:
    """Every class-attribute ``# guarded-by:`` declaration under
    ``volcano_tpu_torch/`` with its ``# race-ok:`` waiver, if any.  Module
    globals stay lexical-only (there is no portable runtime hook for a
    module binding) — the LCK pass keeps covering those."""
    import ast

    root = root or _ROOT_DIR
    out: List[GuardedAttr] = []
    for src in iter_source_files(root, subdirs=("volcano_tpu_torch/",)):
        module = src.rel[:-3].replace("/", ".")
        if module.endswith(".__init__"):
            module = module[: -len(".__init__")]
        for node in src.tree.body:
            if not isinstance(node, ast.ClassDef):
                continue
            for attr, lock, lineno in _class_guarded(src, node):
                out.append(GuardedAttr(
                    module, node.name, attr, lock,
                    src.marker(lineno, "race-ok"),
                ))
    return out


def _class_guarded(src: SourceFile, cls) -> List[Tuple[str, str, int]]:
    import ast

    found: Dict[str, Tuple[str, int]] = {}
    for node in ast.walk(cls):
        if not isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            continue
        lock = src.marker(node.lineno, "guarded-by")
        if not lock:
            continue
        targets = (
            node.targets if isinstance(node, ast.Assign) else [node.target]
        )
        for t in targets:
            if (
                isinstance(t, ast.Attribute)
                and isinstance(t.value, ast.Name)
                and t.value.id == "self"
            ):
                found.setdefault(t.attr, (lock, node.lineno))
    return [(a, lk, ln) for a, (lk, ln) in sorted(found.items())]


class _TrackedAttr:
    """Data descriptor interposed on a guarded class attribute.  Values
    live under the SAME name in the instance ``__dict__`` (a data
    descriptor wins the lookup either way, and instances constructed
    before instrumentation keep working) or delegate to the original
    slot descriptor for ``__slots__`` classes — semantics, including
    ``hasattr`` and ``vars()``, are unchanged."""

    def __init__(self, det: Detector, name: str, symbol: str,
                 slot=None, class_default=None, has_default: bool = False):
        self.det = det
        self.name = name
        self.symbol = symbol
        self.slot = slot
        self.storage = name
        self.class_default = class_default
        self.has_default = has_default

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        self.det.record(obj, self.symbol, False, sys._getframe(1))
        if self.slot is not None:
            return self.slot.__get__(obj, objtype)
        try:
            return obj.__dict__[self.storage]
        except KeyError:
            if self.has_default:
                return self.class_default
            raise AttributeError(self.name) from None

    def __set__(self, obj, value):
        self.det.record(obj, self.symbol, True, sys._getframe(1))
        if self.slot is not None:
            self.slot.__set__(obj, value)
        else:
            obj.__dict__[self.storage] = value

    def __delete__(self, obj):
        self.det.record(obj, self.symbol, True, sys._getframe(1))
        if self.slot is not None:
            self.slot.__delete__(obj)
        else:
            try:
                del obj.__dict__[self.storage]
            except KeyError:
                raise AttributeError(self.name) from None


#: (class, attribute, what its ``__dict__`` held, or _ABSENT) for each
#: descriptor installed, so :func:`uninstall` can take them off again
_instrumented: List[Tuple[type, str, object]] = []
_ABSENT = object()


def instrument_class(det: Detector, cls: type, attrs, prefix: str) -> int:
    """Install tracked descriptors for ``attrs`` on ``cls``; returns
    how many were installed."""
    n = 0
    for attr in attrs:
        existing = cls.__dict__.get(attr)
        if isinstance(existing, _TrackedAttr):
            continue
        _instrumented.append((cls, attr, cls.__dict__.get(attr, _ABSENT)))
        slot = None
        class_default = None
        has_default = False
        if existing is not None:
            if hasattr(type(existing), "__set__") and hasattr(
                type(existing), "__get__"
            ):
                slot = existing  # member_descriptor from __slots__
            else:
                class_default = existing  # plain class-level default
                has_default = True
        setattr(cls, attr, _TrackedAttr(
            det, attr, f"{prefix}.{attr}",
            slot=slot, class_default=class_default,
            has_default=has_default,
        ))
        n += 1
    return n


def instrument_package(root: Optional[str] = None) -> dict:
    """Import every module carrying guarded declarations and wrap the
    declared attributes.  Returns a summary dict (counts + skips) for
    the report.  Must run after :func:`install` and before the system
    under test constructs instances (the port's tests call it in the
    fixture that installs the detector); :func:`uninstall` takes the
    descriptors off again."""
    import importlib

    det = _detector
    assert det is not None, "race.install() first"
    decls = scan_guarded(root)
    by_class: Dict[Tuple[str, str], List[GuardedAttr]] = {}
    for d in decls:
        by_class.setdefault((d.module, d.cls), []).append(d)
    installed = 0
    waived: List[str] = []
    skipped: List[str] = []
    for (module, cls_name), ds in sorted(by_class.items()):
        try:
            mod = importlib.import_module(module)
            cls = getattr(mod, cls_name, None)
        except Exception as e:  # noqa: BLE001 — a module that cannot
            # import under the test env is skipped, named in the report
            skipped.append(f"{module}: {e}")
            continue
        if cls is None or not isinstance(cls, type):
            skipped.append(f"{module}.{cls_name}: not importable as a class")
            continue
        live = [d.attr for d in ds if not d.waived]
        waived.extend(d.symbol for d in ds if d.waived)
        installed += instrument_class(
            det, cls, live, f"{module}.{cls_name}"
        )
    return {
        "instrumented_attrs": installed,
        "waived": sorted(waived),
        "skipped": sorted(skipped),
    }


#: the thread, event and queue patches this module has in place
_ours: set = set()


def _patched_by_another() -> List[str]:
    """The thread, queue and event methods another detector patched."""
    current = [("Thread.start", threading.Thread.start), ("Thread.join", threading.Thread.join),
               ("Event.set", threading.Event.set), ("Event.wait", threading.Event.wait)]
    for cls in _QUEUE_CLASSES:
        current += [(f"{cls.__name__}._put", cls._put), (f"{cls.__name__}._get", cls._get)]
    return [name for name, fn in current if fn not in _ours and not lock_order._is_stdlib(fn)]


def install(restrict_to_pkg: bool = True) -> Detector:
    """Install the global detector: lock-proxy listener + thread/queue/
    event patches.  Idempotent.  Only locks constructed after it runs go
    through the instrumented factory.  Refuses, raising RuntimeError,
    while another detector's patches are in place."""
    global _detector
    if _detector is not None:
        return _detector
    foreign = _patched_by_another() + lock_order.foreign_wrappers()
    if foreign:
        raise RuntimeError(
            f"another race detector is installed ({', '.join(foreign)}); "
            f"uninstall it before the port's"
        )
    lock_order.install()
    _detector = Detector(restrict_to_pkg=restrict_to_pkg)
    lock_order.set_listener(_detector)
    threading.Thread.start = _patched_start
    threading.Thread.join = _patched_join
    for cls, (oput, oget) in _orig_queue_internals.items():
        cls._put = _make_patched_put(oput)
        cls._get = _make_patched_get(oget)
        _ours.update((cls._put, cls._get))
    threading.Event.set = _patched_event_set
    threading.Event.wait = _patched_event_wait
    _ours.update((_patched_start, _patched_join, _patched_event_set, _patched_event_wait))
    return _detector


def uninstall() -> None:
    """Undo :func:`install`, the lock-order verifier it installed and
    every tracking descriptor installed since."""
    global _detector
    if _detector is None:
        return
    lock_order.set_listener(None)
    lock_order.uninstall()
    threading.Thread.start = _orig_thread_start
    threading.Thread.join = _orig_thread_join
    for cls, (oput, oget) in _orig_queue_internals.items():
        cls._put = oput
        cls._get = oget
    threading.Event.set = _orig_event_set
    threading.Event.wait = _orig_event_wait
    _ours.clear()
    while _instrumented:
        cls, attr, before = _instrumented.pop()
        if before is _ABSENT:
            delattr(cls, attr)
        else:
            setattr(cls, attr, before)
    _detector = None


def enabled() -> bool:
    return _detector is not None


def get_detector() -> Optional[Detector]:
    return _detector


def races() -> List[RaceReport]:
    return list(_detector.reports) if _detector is not None else []


def report() -> dict:
    if _detector is None:
        return {"accesses": 0, "tracked_vars": 0, "races": []}
    return _detector.report()


def dump_report(path: str, extra: Optional[dict] = None) -> None:
    data = report()
    if extra:
        data.update(extra)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2)
        f.write("\n")


def check_clean() -> None:
    """Raise AssertionError naming every recorded race."""
    rs = races()
    if rs:
        raise AssertionError(
            "happens-before race detector recorded %d race(s):\n%s"
            % (len(rs), "\n".join(r.render() for r in rs))
        )
