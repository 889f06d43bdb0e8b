"""Runtime lock-order verifier — the deadlock-class detector.

A copy of ``volcano_tpu/analysis/lock_order.py`` for the port.  A
deadlock such as an admission review forwarded back to the submitting
connection, parking a reader on a lock its own thread had to release, is
invisible to unit tests until the exact interleave fires.  This module
makes it *systematically* detectable: once :func:`install` runs, every
``threading.Lock`` / ``RLock`` / ``Condition`` **created by
volcano_tpu_torch code** is wrapped in an instrumented proxy that
records, per thread, the stack of locks held, and adds an edge ``A → B``
to a global acquisition graph whenever a thread acquires ``B`` while
holding ``A``.  A cycle in that graph is a lock-order inversion — two
threads can deadlock under the right interleave even if this run got
lucky.

* Detection is immediate: the edge insert runs a reachability check and
  records a violation the moment an inversion appears (the report names
  both creation sites and both acquisition stacks).
* RLock re-entry is not an edge (same instance, same thread).
* ``Condition.wait`` is handled through the ``_release_save`` /
  ``_acquire_restore`` protocol, so the held-stack stays truthful
  across waits.
* Locks created outside ``volcano_tpu_torch/`` are left untouched — the
  verifier watches the system under test, not pytest internals.

Wire-up: nothing reads an environment variable here.  The port's tests
install the verifier in a fixture, drive the threaded code, assert
:func:`check_acyclic` and :func:`uninstall` it; only locks created while
it is installed are watched.  :func:`install` refuses while another
wrapper (the JAX package's verifier) holds ``threading``'s factories, so
no lock is wrapped twice.
"""

from __future__ import annotations

import _thread
import os
import threading
import traceback
from typing import Dict, List, Optional, Set, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the modules ``threading``'s own factories and sync methods live in: a
#: factory or method from any other module is someone's wrapper
_STDLIB = ("_thread", "threading", "queue")


def _is_stdlib(fn) -> bool:
    return getattr(fn, "__module__", None) in _STDLIB


# the real factories even where another wrapper was installed before
# this module was imported
_real_lock = threading.Lock if _is_stdlib(threading.Lock) else _thread.allocate_lock
_real_rlock = threading.RLock if _is_stdlib(threading.RLock) else (
    threading._CRLock or threading._PyRLock)


class LockOrderViolation:
    """One recorded inversion: acquiring ``to_site`` while holding
    ``from_site`` after the opposite order was already observed."""

    def __init__(self, cycle_sites: List[str], stack: str, thread: str):
        self.cycle_sites = cycle_sites
        self.stack = stack
        self.thread = thread

    def render(self) -> str:
        chain = " -> ".join(self.cycle_sites + [self.cycle_sites[0]])
        return (
            f"lock-order cycle {chain}\n  closed by thread {self.thread}"
            f" at:\n{self.stack}"
        )


class _Graph:
    """The cross-thread acquisition graph.  Nodes are lock *instances*
    (two locks born at one site are distinct — ABBA between two
    instances of the same class is a real deadlock); reports aggregate
    to creation sites for readability."""

    def __init__(self):
        self.mutex = _real_lock()
        #: lock id → creation site "file:line"
        self.sites: Dict[int, str] = {}
        #: edge (a, b): thread acquired b while holding a
        self.edges: Dict[int, Set[int]] = {}
        self.violations: List[LockOrderViolation] = []
        #: strong refs to every registered proxy — the graph is keyed by
        #: id(), so a GC'd proxy whose memory CPython reuses for a new
        #: lock would otherwise inherit the dead lock's edges and
        #: fabricate phantom cycles.  Bounded by the session's lock
        #: count (a few thousand across the whole suite).
        self._keep: List[object] = []
        self._tls = threading.local()

    # ---- per-thread held stack ----

    def held(self) -> List[Tuple[int, int]]:
        """[(lock_id, recursion_count)] for the calling thread."""
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    # ---- events ----

    def register(self, lock, site: str) -> None:
        """Accepts the proxy object itself (kept alive so its id stays
        unique for the graph's lifetime) or, in unit tests driving the
        graph directly, a bare int id."""
        with self.mutex:
            if isinstance(lock, int):
                self.sites[lock] = site
            else:
                self._keep.append(lock)
                self.sites[id(lock)] = site

    def acquired(self, lock_id: int, count: int = 1) -> None:
        stack = self.held()
        for i, (lid, n) in enumerate(stack):
            if lid == lock_id:
                stack[i] = (lid, n + count)
                return  # re-entry: no new edge
        new_edges = [(lid, lock_id) for lid, _n in stack]
        stack.append((lock_id, count))
        if not new_edges:
            return
        with self.mutex:
            for a, b in new_edges:
                peers = self.edges.setdefault(a, set())
                if b in peers:
                    continue
                peers.add(b)
                cycle = self._find_path(b, a)
                if cycle is not None:
                    # cycle is the path b → … → a; render() closes it
                    # back to b
                    self.violations.append(LockOrderViolation(
                        [self.sites.get(x, f"lock-{x}") for x in cycle],
                        "".join(traceback.format_stack(limit=12)[:-2]),
                        threading.current_thread().name,
                    ))

    def released(self, lock_id: int) -> int:
        """Drop one recursion level; returns remaining count.  A full
        release (``_release_save``) calls :meth:`released_all`."""
        stack = self.held()
        for i in range(len(stack) - 1, -1, -1):
            lid, n = stack[i]
            if lid == lock_id:
                if n <= 1:
                    del stack[i]
                    return 0
                stack[i] = (lid, n - 1)
                return n - 1
        return 0

    def released_all(self, lock_id: int) -> int:
        stack = self.held()
        for i in range(len(stack) - 1, -1, -1):
            lid, n = stack[i]
            if lid == lock_id:
                del stack[i]
                return n
        return 0

    def _find_path(self, start: int, goal: int) -> Optional[List[int]]:
        """DFS path start→goal (caller holds ``self.mutex``)."""
        seen = {start}
        path = [start]

        def dfs(node: int) -> bool:
            if node == goal:
                return True
            for nxt in self.edges.get(node, ()):
                if nxt in seen:
                    continue
                seen.add(nxt)
                path.append(nxt)
                if dfs(nxt):
                    return True
                path.pop()
            return False

        return path if dfs(start) else None

    def report(self) -> dict:
        with self.mutex:
            return {
                "locks": len(self.sites),
                "edges": sorted(
                    (self.sites.get(a, str(a)), self.sites.get(b, str(b)))
                    for a, peers in self.edges.items() for b in peers
                ),
                "violations": [v.render() for v in self.violations],
            }


_graph: Optional[_Graph] = None

#: optional sync-event listener (the happens-before race detector in
#: :mod:`~volcano_tpu_torch.analysis.race` registers here): notified on every
#: acquire/release of an instrumented lock so vector clocks can ride
#: the SAME proxies the lock-order verifier installs.  ``released`` is
#: called BEFORE the inner lock is released (the lock's clock must be
#: published while the releasing thread still holds it) and
#: ``acquired`` after the inner acquire returns (the thread joins the
#: clock only once it owns the lock).
_listener = None


def set_listener(listener) -> None:
    global _listener
    _listener = listener


class _InstrumentedLock:
    """Proxy over a real Lock/RLock recording acquire/release order.
    Forwards the ``_release_save`` / ``_acquire_restore`` / ``_is_owned``
    protocol so ``threading.Condition`` (and its ``wait``) work
    unchanged on top of an instrumented RLock."""

    __slots__ = ("_inner", "_id", "_site")

    def __init__(self, inner, site: str):
        self._inner = inner
        self._id = id(self)
        self._site = site
        if _graph is not None:
            _graph.register(self, site)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            if _graph is not None:
                _graph.acquired(self._id)
            if _listener is not None:
                _listener.lock_acquired(self._id)
        return got

    def release(self) -> None:
        if _listener is not None:
            # before the inner release: the clock must be on the lock
            # while this thread still owns it
            _listener.lock_released(self._id)
        self._inner.release()
        if _graph is not None:
            _graph.released(self._id)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def locked(self) -> bool:
        return self._inner.locked()

    # ---- Condition protocol ----

    def _release_save(self):
        if _listener is not None:
            _listener.lock_released(self._id)
        state = self._inner._release_save() if hasattr(
            self._inner, "_release_save"
        ) else (self._inner.release() or None)
        if _graph is not None:
            count = _graph.released_all(self._id)
            return (state, count)
        return (state, 1)

    def _acquire_restore(self, saved) -> None:
        state, count = saved
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(state)
        else:
            self._inner.acquire()
        if _graph is not None:
            _graph.acquired(self._id, count=count)
        if _listener is not None:
            _listener.lock_acquired(self._id)

    def _is_owned(self) -> bool:
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        # plain Lock fallback (threading.Condition's own trick)
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def __repr__(self) -> str:
        return f"<InstrumentedLock {self._site} over {self._inner!r}>"


def _creation_site() -> Optional[str]:
    """First stack frame inside volcano_tpu_torch/ but outside this module;
    None when the lock is created by foreign code (left raw)."""
    for frame in traceback.extract_stack()[-8:][::-1]:
        fn = frame.filename
        if fn == __file__ or os.sep + "threading.py" in fn:
            continue
        if fn.startswith(_PKG_DIR + os.sep):
            return f"{os.path.relpath(fn, os.path.dirname(_PKG_DIR))}:{frame.lineno}"
        return None
    return None


def _make_lock():
    site = _creation_site()
    inner = _real_lock()
    return _InstrumentedLock(inner, site) if site else inner


def _make_rlock():
    site = _creation_site()
    inner = _real_rlock()
    return _InstrumentedLock(inner, site) if site else inner


def foreign_wrappers() -> List[str]:
    """The ``threading`` factories another instrumentation has replaced
    (``[]`` when ``threading`` holds its own, or ours)."""
    ours = (_make_lock, _make_rlock)
    return [
        f"threading.{name}" for name in ("Lock", "RLock")
        if getattr(threading, name) not in ours
        and not _is_stdlib(getattr(threading, name))
    ]


def install() -> None:
    """Patch the ``threading`` lock factories.  ``Condition()`` with no
    explicit lock picks up the instrumented RLock automatically (it
    resolves ``RLock`` through the module global).  Refuses, raising
    RuntimeError, while another wrapper holds the factories: a lock
    wrapped twice would be recorded by both."""
    global _graph
    if _graph is not None:
        return
    foreign = foreign_wrappers()
    if foreign:
        raise RuntimeError(
            f"another lock-order wrapper is installed ({', '.join(foreign)}); "
            f"uninstall it before the port's"
        )
    _graph = _Graph()
    threading.Lock = _make_lock
    threading.RLock = _make_rlock


def uninstall() -> None:
    """Put ``threading``'s own factories back where ours are in place
    (another wrapper's are left alone).  Locks already wrapped keep
    working, without recording."""
    global _graph
    if threading.Lock is _make_lock:
        threading.Lock = _real_lock
    if threading.RLock is _make_rlock:
        threading.RLock = _real_rlock
    _graph = None


def enabled() -> bool:
    return _graph is not None


def report() -> dict:
    """Acquisition-graph summary (empty when not installed)."""
    return _graph.report() if _graph is not None else {
        "locks": 0, "edges": [], "violations": [],
    }


def violations() -> List[LockOrderViolation]:
    return list(_graph.violations) if _graph is not None else []


def check_acyclic() -> None:
    """Raise AssertionError naming every recorded inversion."""
    vs = violations()
    if vs:
        raise AssertionError(
            "lock-order verifier recorded %d inversion(s):\n%s"
            % (len(vs), "\n".join(v.render() for v in vs))
        )
