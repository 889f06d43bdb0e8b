"""Flight-recorder spans — cross-process request tracing.

A copy of ``volcano_tpu/obs/spans.py``: the same trace ids, span-id
shape and wire form, so spans of the port and of the JAX package join
in one waterfall.  The cycle-correlation id answers "which cycle caused
this bus op"; it cannot answer "where did this pod's 80 ms go", because
a pod's submit→bind path crosses scheduler processes, the apiserver and
the commit plane's worker threads — and each process only journals its
own slice.  This module is the Dapper
shape (Sigelman et al., 2010) over the existing seams: every
instrumented region becomes a **span** carrying

    (trace_id, span_id, parent_id)

where ``trace_id`` derives from the *pod or gang identity* (a stable
crc of ``namespace/name``), ``span_id`` is process-unique, and
``parent_id`` stitches the tree together — across threads via a
thread-local context stack, across processes via the VBUS request
payload (bus/remote.py stamps the current context next to the
``cycle`` field; old peers ignore the key — no new op, no version
bump).

Timestamps are wall-clock microseconds (``time.time()``), the shared
clock origin that lets per-process timelines merge; durations are
``perf_counter`` so they stay monotonic.  Cross-host clock skew is
estimated and corrected at render time: every traced rpc emits a
paired client/server ``bus:<op>`` span, and obs/collect.py's
:func:`~volcano_tpu_torch.obs.collect.estimate_skew` turns their RTT
midpoints into per-process offsets (median per hop, propagated from a
deterministic anchor) — so waterfalls re-anchor onto one clock
instead of showing raw misalignment.

Zero-cost when disabled: every emission checks the module-level
exporter first, and :func:`span` returns a shared null context manager
— instrumented hot paths cost one attribute read with the flight
recorder off.
"""

from __future__ import annotations

import os
import threading
import time
import zlib
from typing import Any, Dict, Optional

#: spans of pods/gangs are keyed by this stable identity hash — 8 hex
#: chars of crc32 over "namespace/name", cheap enough to compute at
#: every emission site and identical in every process
def trace_id_for(namespace: str, name: str) -> str:
    return format(zlib.crc32(f"{namespace}/{name}".encode()), "08x")


def trace_id_for_pod(namespace: str, name: str) -> str:
    return trace_id_for(namespace, name)


def trace_id_for_gang(namespace: str, podgroup: str) -> str:
    """Gangs trace under their PodGroup identity; member-pod spans link
    back via the ``gang`` span arg (obs/collect.py joins both)."""
    return trace_id_for(namespace, podgroup)


class _Local(threading.local):
    def __init__(self):
        self.stack = []       # [(trace_id, span_id), ...]
        self.suppress = False  # exporter re-entrancy guard


_local = _Local()

_id_lock = threading.Lock()
_id_seq = 0  # guarded-by: _id_lock


def _next_span_id(token: str) -> str:
    global _id_seq
    with _id_lock:
        _id_seq += 1
        n = _id_seq
    return f"{token}-{n:x}"


class _NullSpan:
    __slots__ = ()
    span_id = ""

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class _DroppedSpan:
    """A sampled-out span: records NOTHING, but still pushes its
    (dropped) trace context so the whole subtree drops coherently —
    descendants inherit the dropped trace id (and are themselves
    sampled out), and the wire stamp carries it so the SERVER side
    drops its bus spans too.  Without this, children
    would fall back to the enclosing process-scope context and the
    dropped trace's heaviest spans would leak into every other
    waterfall of the cycle (keep-or-drop-whole-traces, the Dapper
    contract)."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, token: str, trace_id: str):
        self.trace_id = trace_id
        self.span_id = _next_span_id(token)

    def __enter__(self) -> "_DroppedSpan":
        _local.stack.append((self.trace_id, self.span_id))
        return self

    def __exit__(self, *exc) -> bool:
        stack = _local.stack
        if stack and stack[-1][1] == self.span_id:
            stack.pop()
        return False


class Span:
    """Context manager emitting one completed span at exit.  ``ts`` is
    wall-clock µs at entry; ``dur`` perf-measured µs."""

    __slots__ = ("exporter", "name", "cat", "trace_id", "span_id",
                 "parent_id", "args", "rooted", "_t0", "_wall0")

    def __init__(self, exporter, name: str, cat: str, trace_id: str,
                 parent_id: str, args: Optional[Dict[str, Any]],
                 rooted: bool = False):
        self.exporter = exporter
        self.name = name
        self.cat = cat
        self.trace_id = trace_id
        self.span_id = _next_span_id(exporter.token)
        self.parent_id = parent_id
        self.args = args
        #: an explicit trace_id re-rooted this span under a pod/gang
        #: identity — the tail sampler's trace-completion signal (the
        #: transient "_root" record key; stripped before export)
        self.rooted = rooted

    def __enter__(self) -> "Span":
        self._wall0 = time.time()
        self._t0 = time.perf_counter()
        _local.stack.append((self.trace_id, self.span_id))
        return self

    def __exit__(self, exc_type, *exc) -> bool:
        stack = _local.stack
        if stack and stack[-1][1] == self.span_id:
            stack.pop()
        args = self.args
        if exc_type is not None:
            args = dict(args or {})
            args["error"] = exc_type.__name__
        self.exporter.emit({
            "t": self.trace_id,
            "s": self.span_id,
            "p": self.parent_id,
            "name": self.name,
            "cat": self.cat,
            "ts": self._wall0 * 1e6,
            "dur": (time.perf_counter() - self._t0) * 1e6,
            "tid": threading.get_ident(),
            **({"args": args} if args else {}),
            **({"_root": True} if self.rooted else {}),
        })
        return False


# ---- module-level surface (the exporter is installed by obs/channel) ----

_exporter = None  # the active SpanExporter, or None (disabled)


def _set_exporter(exporter) -> None:
    global _exporter
    _exporter = exporter


def get_exporter():
    return _exporter


def enabled() -> bool:
    return _exporter is not None and not _local.suppress


def current() -> Optional[tuple]:
    """(trace_id, span_id) of the innermost open span on this thread,
    or None."""
    stack = _local.stack
    return stack[-1] if stack else None


def current_wire() -> Optional[Dict[str, str]]:
    """The compact span context stamped on outbound VBUS request
    payloads (``payload["span"]``) — None when the flight recorder is
    off or no span is open, so the stamp costs nothing by default."""
    if _exporter is None or _local.suppress:
        return None
    stack = _local.stack
    if not stack:
        return None
    t, s = stack[-1]
    return {"t": t, "s": s}


def span(name: str, cat: str = "span", trace_id: Optional[str] = None,
         args: Optional[Dict[str, Any]] = None):
    """Open a span.  ``trace_id=None`` inherits the innermost open
    span's trace (or "" — a process-scope span); an explicit trace_id
    re-roots the subtree under a pod/gang identity while still
    parenting to the enclosing span."""
    exp = _exporter
    if exp is None or _local.suppress:
        return _NULL_SPAN
    parent = ""
    inherited = ""
    stack = _local.stack
    if stack:
        inherited, parent = stack[-1]
    tid = trace_id if trace_id is not None else inherited
    if not exp.keep(tid):
        return _DroppedSpan(exp.token, tid)
    return Span(exp, name, cat, tid, parent, args,
                rooted=bool(tid) and tid != inherited)


def adopt(wire: Optional[Dict[str, str]], name: str, cat: str = "span",
          args: Optional[Dict[str, Any]] = None):
    """Server-side half of the VBUS propagation: open a span whose
    parent is the *remote* caller's span context (``payload["span"]``).
    A missing/garbled context degrades to a plain local span."""
    exp = _exporter
    if exp is None or _local.suppress:
        return _NULL_SPAN
    if not isinstance(wire, dict):
        return span(name, cat=cat, args=args)
    tid = str(wire.get("t", ""))
    parent = str(wire.get("s", ""))
    if not exp.keep(tid):
        # context still established: nested server-side emissions
        # inherit the dropped trace id and drop with it
        return _DroppedSpan(exp.token, tid)
    s = Span(exp, name, cat, tid, parent, args)
    return s


def complete(name: str, seconds: float, cat: str = "span",
             trace_id: Optional[str] = None,
             args: Optional[Dict[str, Any]] = None) -> None:
    """Emit an already-timed region that ended *now* — lets call sites
    reuse a duration they already measured for metrics (the
    ``update_kernel_duration`` pattern: one measurement, two sinks)."""
    exp = _exporter
    if exp is None or _local.suppress:
        return
    parent = ""
    inherited = ""
    stack = _local.stack
    if stack:
        inherited, parent = stack[-1]
    tid = trace_id if trace_id is not None else inherited
    if not exp.keep(tid):
        return
    exp.emit({
        "t": tid,
        "s": _next_span_id(exp.token),
        "p": parent,
        "name": name,
        "cat": cat,
        "ts": (time.time() - seconds) * 1e6,
        "dur": seconds * 1e6,
        "tid": threading.get_ident(),
        **({"args": args} if args else {}),
        **({"_root": True} if bool(tid) and tid != inherited else {}),
    })


def suppressed():
    """Context manager marking this thread's work as telemetry-internal
    (the exporter's own bus writes must not record spans about
    themselves — infinite regress otherwise)."""
    return _Suppress()


class _Suppress:
    __slots__ = ("_prev",)

    def __enter__(self):
        self._prev = _local.suppress
        _local.suppress = True
        return self

    def __exit__(self, *exc) -> bool:
        _local.suppress = self._prev
        return False


def _proc_token(identity: str) -> str:
    """Short process-unique span-id prefix: identity crc + pid, so two
    daemons (or a restarted one) can never mint colliding span ids."""
    return f"{zlib.crc32(identity.encode()) & 0xFFFF:04x}{os.getpid():x}"
