"""``RemoteAPIServer`` — the drop-in swap for the in-process store.

A copy of ``volcano_tpu/bus/remote.py`` for one endpoint: the surface of
``client.apiserver.APIServer`` the scheduler and its elector use (CRUD,
list, optimistic-concurrency update, status subresource, the coalesced
commit frame, watch with initial sync) over one TCP connection to a
``vtpu-apiserver`` — the port's or the JAX package's, whose wire is the
same.  ``KubeClient``/``VolcanoClient``/``SchedulerClient``, the
scheduler cache's informers and the leader elector run unchanged against
either backend.

Resilience model (the client-go informer contract):

* **Reconnect**: a lost connection is re-dialed forever with
  exponential backoff plus jitter; in-flight calls fail fast with
  ``BusError`` (an ``ApiError``, so daemon work loops retry next cycle).
* **Watch re-establishment**: after reconnect every watch resumes from
  its last-delivered bus sequence number.  When the server still holds
  that suffix, the missed events replay — no relist, no duplicates.
* **Relist fallback**: when the server answers 410-Gone (backlog
  outgrown, or a restarted server with a new epoch), the client
  re-lists and reconciles against its shadow cache, synthesizing
  exactly the ADDED/MODIFIED/DELETED deltas the handlers missed.
  Every such resync increments ``volcano_bus_relists_total``.
* **Bookmarks** advance the resume point through quiet periods.
* **Old peers**: a server that answers ``unknown bus op`` to
  ``commit_batch``, ``watch_batch`` or ``bus_hello`` degrades the
  client, for the connection's lifetime, to per-object binds, per-object
  watch frames or JSON framing.

With the flight recorder on (``obs``), a request issued inside an open
span carries the span context (``payload["span"]``) and is recorded as a
client ``bus:<op>`` span, the parent of the server's adopted one.
``bus_status`` asks the server for its status (role, persistence, its
/metrics address); an old server's ``unknown bus op`` degrades it, for
the connection's lifetime, to ``{"role": "unknown"}``.

Not present in the port yet, each waiting for its caller: the same-host
shm transport (replication/shm), ``cas_bind`` and ``txn_commit``
(federation), ``register_admission`` and its review loop (admission),
the membership calls, endpoint lists and the leader-redirect and
failover paths (replication).
"""

from __future__ import annotations

import queue
import random
import socket
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from volcano_tpu_torch import metrics, obs, trace
from volcano_tpu_torch.bus import protocol
from volcano_tpu_torch.bus.protocol import BusError, BusTimeoutError
from volcano_tpu_torch.client.apiserver import (
    ADDED,
    ApiError,
    DELETED,
    MODIFIED,
)
from volcano_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

WatchHandler = Callable[[str, Optional[object], Optional[object]], None]


def _obj_key(data: dict) -> str:
    meta = data.get("metadata", {})
    return f"{meta.get('namespace', 'default')}/{meta.get('name', '')}"


class _WatchState:
    """Client-side informer state for one kind: the shadow cache the
    relist reconcile diffs against, the resume cursor, and the local
    handler fan-out."""

    def __init__(self, kind: str, watch_id: int):
        self.kind = kind
        self.watch_id = watch_id
        #: (handler, wants_initial) — wants_initial governs whether the
        #: FIRST sync's snapshot is delivered (the in-process
        #: ``send_initial`` contract); later relist deltas go to all
        self.handlers: List[Tuple[WatchHandler, bool]] = []
        #: key → wire dict of the last object version delivered
        self.shadow: Dict[str, dict] = {}
        self.epoch: Optional[str] = None
        self.last_seq: Optional[int] = None
        #: torn down after the last handler left; a handler added to a
        #: defunct state is re-routed through a fresh watch
        self.defunct = False
        #: set once the first list has been delivered to the handlers
        #: (the informer's HasSynced; :meth:`RemoteAPIServer.wait_synced`):
        #: a later reconcile is a relist, whose deltas go to every handler
        self.listed = threading.Event()


class RemoteAPIServer:
    """Network client to a ``vtpu-apiserver`` bus.

    ``address`` is ``tcp://host:port`` (or a bare ``host:port``); an
    endpoint list, the reference's replicated form, raises ValueError.
    Construction does not block on the dial — the connection manager
    establishes it in the background; use ``wait_ready()`` to gate
    startup on bus availability."""

    def __init__(
        self,
        address: str,
        timeout: float = 10.0,
        reconnect_min: float = 0.05,
        reconnect_max: float = 2.0,
    ):
        if "," in address:
            raise ValueError(f"the port's bus client dials one endpoint, got {address!r}")
        self.host, self.tcp_port = protocol.parse_bus_url(address)
        self.address = f"tcp://{self.host}:{self.tcp_port}"
        self.timeout = timeout
        self.reconnect_min = reconnect_min
        self.reconnect_max = reconnect_max

        self._sock: Optional[socket.socket] = None
        self._send_lock = threading.Lock()
        self._closed = False
        self._connected = threading.Event()
        self._ever_connected = False

        self._req_id = 0  # guarded-by: self._id_lock
        self._watch_id = 0  # guarded-by: self._id_lock
        self._id_lock = threading.Lock()
        #: req_id → {"event", "result", "error"}
        self._pending: Dict[int, dict] = {}  # guarded-by: self._pending_lock
        self._pending_lock = threading.Lock()

        self._watch_lock = threading.Lock()
        self._watches: Dict[str, _WatchState] = {}  # guarded-by: self._watch_lock
        self._by_watch_id: Dict[int, _WatchState] = {}  # guarded-by: self._watch_lock

        #: set once a server rejects the v2 ``commit_batch`` op — the
        #: old-peer fallback (per-object binds) for skewed apiservers
        self._no_commit_batch = False
        #: set once a server rejects the v3 ``watch_batch`` op — watches
        #: then (re-)establish via plain ``watch`` and receive one
        #: T_WATCH_EVENT frame per object, exactly the old behavior
        self._no_watch_batch = False
        #: set once a server rejects the v8 ``bus_hello`` op — the
        #: connection (and every reconnect after it) then stays on JSON
        #: framing, exactly the pre-v8 wire format
        self._no_bus_hello = False
        #: set once a server rejects the v5 ``bus_status`` op — status
        #: then reads ``role: unknown`` (observability, never correctness)
        self._no_bus_status = False
        #: negotiated body codec for the CURRENT connection — reset to
        #: JSON on every (re)dial, flipped to binary only when the
        #: server's hello answer says so.  Frames are stamped per frame,
        #: so a stale value can never misdecode anything.
        self.codec = protocol.CODEC_JSON

        self._ctl: "queue.Queue[tuple]" = queue.Queue()
        self._dispatch_q: "queue.Queue[Optional[tuple]]" = queue.Queue()

        self._conn_thread = threading.Thread(
            target=self._conn_loop, name="vtpu-bus-conn", daemon=True
        )
        self._dispatch_thread = threading.Thread(
            target=self._dispatch_loop, name="vtpu-bus-dispatch", daemon=True
        )
        self._conn_thread.start()
        self._dispatch_thread.start()

    # ---- connection management ----

    def wait_ready(self, timeout: float = 30.0) -> bool:
        """Block until the bus is reachable (daemon startup gate)."""
        return self._connected.wait(timeout)

    def wait_synced(self, timeout: Optional[float] = None) -> bool:
        """Block until every watch registered so far has delivered its
        first list to its handlers (the informer's HasSynced), or
        ``timeout`` seconds pass; True when synced.  The port's
        ``SchedulerCache.wait_for_cache_sync`` waits here, so that a
        scheduler's first cycle over the bus sees the whole store, not
        the part of the initial lists dispatched so far."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._watch_lock:
            states = list(self._watches.values())
        for state in states:
            left = None if deadline is None else max(0.0, deadline - time.monotonic())
            if not state.listed.wait(left):
                return False
        return True

    def _conn_loop(self) -> None:
        backoff = self.reconnect_min
        while not self._closed:
            try:
                sock = socket.create_connection((self.host, self.tcp_port),
                                                timeout=self.timeout)
            except OSError:
                jitter = random.uniform(0, backoff * 0.25)
                time.sleep(backoff + jitter)
                backoff = min(backoff * 2, self.reconnect_max)
                continue
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            backoff = self.reconnect_min
            self.codec = protocol.CODEC_JSON  # until the hello says otherwise
            self._sock = sock
            reader = threading.Thread(
                target=self._read_loop, args=(sock,),
                name="vtpu-bus-reader", daemon=True,
            )
            reader.start()
            if self._ever_connected:
                metrics.register_bus_reconnect()
                log.info("bus %s reconnected", self.address)
            self._ever_connected = True
            self._connected.set()
            try:
                self._negotiate_codec()
            except (ApiError, OSError):
                # negotiation must never cost the connection: any
                # failure here leaves the codec on JSON and the session
                # proceeds (a true transport loss surfaces through the
                # reader thread's disconnect signal regardless)
                self.codec = protocol.CODEC_JSON
            self._resync_session()
            # serve control messages until the reader reports loss
            while not self._closed:
                item = self._ctl.get()
                if item[0] == "disconnect":
                    break
                if item[0] == "resync":
                    self._resync_session()
                if item[0] == "unsubscribe":
                    try:
                        self._call({"op": "unwatch", "watch_id": item[1]})
                    except (ApiError, OSError):
                        pass  # a dead connection drops the sub anyway
                if item[0] == "stop":
                    return
            self._connected.clear()
            self._teardown_socket(sock)
            self._fail_pending(BusError("bus connection lost"))

    def _negotiate_codec(self) -> None:
        """VBUS v8 codec negotiation — the FIRST exchange on every
        fresh connection, before the session resync, so the watches
        ride the negotiated codec.  The hello itself always goes as a
        JSON frame; the reply is decoded by its frame stamp, so there is
        no ordering race with the server's codec flip.  Degrades to
        JSON — never errors — on ANY non-binary answer: a pre-v8 server
        answers ``unknown bus op`` (degrade for the client's lifetime),
        a msgpack-less build never offers binary at all, and an explicit
        ``codec: json`` answer is honored as-is.  Every degradation
        increments ``volcano_bus_codec_fallbacks_total``."""
        if self._no_bus_hello or not protocol.HAS_BINARY:
            return
        try:
            resp = self._call({
                "op": "bus_hello",
                "codecs": [protocol.CODEC_BINARY, protocol.CODEC_JSON],
            })
        except BusError:
            raise  # transport failure — NOT a capability signal
        except ApiError as e:
            if "unknown bus op" not in str(e):
                raise
            log.warning(
                "bus %s does not speak bus_hello (old peer); JSON framing",
                self.address,
            )
            self._no_bus_hello = True
            metrics.register_bus_codec_fallback()
            return
        if resp.get("codec") == protocol.CODEC_BINARY:
            self.codec = protocol.CODEC_BINARY
        else:
            self.codec = protocol.CODEC_JSON
            metrics.register_bus_codec_fallback()

    def _resync_session(self) -> None:
        """After (re)connect: re-establish every watch with
        resume-or-relist.  Each watch is attempted independently, and
        ANY failure schedules a full retry — the resync is idempotent (a
        re-established watch resumes from last_seq and replayed events
        dedup by sequence number), and a watch left un-established
        would freeze its informer cache silently."""
        failed = False
        with self._watch_lock:
            states = list(self._watches.values())
        for state in states:
            try:
                self._establish_watch(state)
            except (ApiError, OSError) as e:
                log.error("bus watch %s re-establish failed: %s",
                          state.kind, e)
                failed = True
        if failed and not self._closed:
            def _retry():
                time.sleep(min(self.reconnect_max, 0.5))
                if not self._closed and self._connected.is_set():
                    self._ctl.put(("resync",))

            threading.Thread(target=_retry, name="vtpu-bus-resync-retry",
                             daemon=True).start()

    def _teardown_socket(self, sock: socket.socket) -> None:
        if self._sock is sock:
            self._sock = None
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            sock.close()
        except OSError:
            pass

    def _fail_pending(self, error: Exception) -> None:
        with self._pending_lock:
            pending = list(self._pending.values())
            self._pending.clear()
        for waiter in pending:
            waiter["error"] = error
            waiter["event"].set()

    def _read_loop(self, sock: socket.socket) -> None:
        while not self._closed:
            try:
                mtype, corr_id, payload = protocol.recv_frame(sock)
            except (ConnectionError, OSError, ValueError):
                if self._sock is sock:
                    self._ctl.put(("disconnect",))
                return
            if mtype in (protocol.T_RESP, protocol.T_PONG):
                self._resolve(corr_id, payload, None)
            elif mtype == protocol.T_ERROR:
                self._resolve(corr_id, None, payload)
            elif mtype == protocol.T_WATCH_EVENT:
                state = self._watch_state(corr_id)
                if state is not None:
                    self._dispatch_q.put(("event", state, payload))
            elif mtype == protocol.T_WATCH_BATCH:
                # coalesced frame (protocol v3): unbatch in wire order —
                # each entry carries its own watch id, and the dispatch
                # queue preserves ordering exactly as per-object frames
                # would have
                for entry in payload.get("events", ()):
                    state = self._watch_state(int(entry.get("watch_id", -1)))
                    if state is not None:
                        self._dispatch_q.put(("event", state, entry))
            elif mtype == protocol.T_BOOKMARK:
                state = self._watch_state(corr_id)
                if state is not None:
                    self._dispatch_q.put(("bookmark", state, payload))

    def _watch_state(self, watch_id: int) -> Optional[_WatchState]:
        # the reader thread races watch()/unwatch teardown on other
        # threads
        with self._watch_lock:
            return self._by_watch_id.get(watch_id)

    def _resolve(self, req_id: int, result, error) -> None:
        with self._pending_lock:
            waiter = self._pending.pop(req_id, None)
        if waiter is None:
            return
        on_reply = waiter.get("on_reply")
        if on_reply is not None and result is not None:
            # runs on the READER thread, before any later frame is
            # processed — work enqueued here (a watch snapshot's
            # reconcile) is ordered against subsequent watch events
            # exactly as the wire ordered them
            try:
                on_reply(result)
            except Exception as e:  # noqa: BLE001
                log.error("bus reply hook failed: %s", e)
        waiter["result"] = result
        waiter["error_payload"] = error
        waiter["event"].set()

    # ---- request plumbing ----

    def _next_id(self) -> int:
        with self._id_lock:
            self._req_id += 1
            return self._req_id

    def _call(self, payload: dict, timeout: Optional[float] = None,
              mtype: int = protocol.T_REQ, on_reply=None) -> dict:
        if self._closed:
            raise BusError("bus client closed")
        timeout = timeout if timeout is not None else self.timeout
        method = payload.get("op", "ping")
        client_span = None
        if mtype == protocol.T_REQ:
            # cross-process correlation: stamp the scheduling-cycle id on
            # the request frame so server-side records can be joined
            # back to the cycle that caused them.  Old servers ignore
            # the key.
            cycle = trace.current_cycle()
            if cycle >= 0 and "cycle" not in payload:
                payload["cycle"] = cycle
            # flight-recorder span context rides the same payload slot
            # discipline (obs/spans.py): old servers ignore the key — no
            # new op, no version bump.  None when the recorder is off or
            # no span is open, so the default path stamps nothing.
            span_ctx = obs.current_wire()
            if span_ctx is not None and "span" not in payload:
                # client half of the paired bus span: same name as the
                # server's adopted ``bus:<op>`` span, linked parent →
                # child across the wire — the pair obs/collect.py's
                # clock-skew estimator keys on, and its duration is the
                # rpc time as the client sees it
                client_span = obs.span("bus:" + method, cat="bus",
                                       args={"peer": self.address})
                client_span.__enter__()
                payload["span"] = obs.current_wire() or span_ctx
        try:
            return self._call_framed(payload, timeout, mtype, method, on_reply)
        finally:
            if client_span is not None:
                client_span.__exit__(*sys.exc_info())

    def _call_framed(self, payload: dict, timeout: float, mtype: int, method: str,
                     on_reply) -> dict:
        start = time.perf_counter()
        if not self._connected.wait(timeout):
            metrics.observe_bus_request(method, time.perf_counter() - start,
                                        "disconnected")
            raise BusError(f"bus {self.address} unreachable")
        from volcano_tpu_torch import faults

        fp = faults.get_plane()
        if fp.enabled and mtype == protocol.T_REQ and fp.should("bus.client_drop"):
            # the request frame never reaches the wire: callers see the
            # same BusError a mid-send connection loss produces, and the
            # daemon work loops retry next cycle
            metrics.observe_bus_request(method, time.perf_counter() - start,
                                        "disconnected")
            raise BusError("fault-injected: request frame lost")
        req_id = self._next_id()
        waiter = {"event": threading.Event(), "result": None,
                  "error": None, "error_payload": None, "on_reply": on_reply}
        with self._pending_lock:
            self._pending[req_id] = waiter
        try:
            sock = self._sock
            if sock is None:
                raise BusError("bus connection lost")
            with self._send_lock:
                protocol.send_frame(sock, mtype, req_id, payload,
                                    codec=self.codec)
        except (OSError, BusError) as e:
            with self._pending_lock:
                self._pending.pop(req_id, None)
            metrics.observe_bus_request(method, time.perf_counter() - start,
                                        "disconnected")
            raise BusError(f"bus send failed: {e}") from e
        if not waiter["event"].wait(timeout):
            with self._pending_lock:
                self._pending.pop(req_id, None)
            metrics.observe_bus_request(method, time.perf_counter() - start,
                                        "timeout")
            raise BusTimeoutError(f"bus call {method!r} timed out after {timeout}s")
        if waiter["error"] is not None:
            metrics.observe_bus_request(method, time.perf_counter() - start,
                                        "disconnected")
            raise waiter["error"]
        if waiter["error_payload"] is not None:
            metrics.observe_bus_request(method, time.perf_counter() - start, "error")
            protocol.raise_error(waiter["error_payload"])
        metrics.observe_bus_request(method, time.perf_counter() - start, "ok")
        return waiter["result"]

    # ---- the APIServer surface ----

    def health(self) -> bool:
        try:
            self._call({}, mtype=protocol.T_PING)
            return True
        except (BusError, OSError):
            return False

    def bus_status(self) -> dict:
        """The server's status (protocol v5): the payload ``vtctl top``
        discovers /metrics addresses from and the incident bundle
        records.  A pre-v5 server answers ``unknown bus op``; the client
        then degrades PERMANENTLY (per connection lifetime) to a ``role:
        unknown`` payload — status is observability, never
        correctness."""
        if not self._no_bus_status:
            try:
                return self._call({"op": "bus_status"})
            except BusError:
                raise  # transport failure — NOT a capability signal
            except ApiError as e:
                if "unknown bus op" not in str(e):
                    raise
                log.warning("bus %s does not speak bus_status (old peer)", self.address)
                self._no_bus_status = True
        return {"role": "unknown", "persistent": False}

    def create(self, obj):
        resp = self._call({"op": "create", "object": protocol.encode_obj(obj)})
        return protocol.decode_obj(resp["object"])

    def update(self, obj, expected_rv: Optional[int] = None):
        resp = self._call({
            "op": "update", "object": protocol.encode_obj(obj),
            "expected_rv": expected_rv,
        })
        return protocol.decode_obj(resp["object"])

    def compare_and_update(self, obj, expected_rv: int):
        return self.update(obj, expected_rv=expected_rv)

    def update_status(self, obj):
        resp = self._call({"op": "update_status",
                           "object": protocol.encode_obj(obj)})
        return protocol.decode_obj(resp["object"])

    def get(self, kind: str, namespace: str, name: str):
        resp = self._call({"op": "get", "kind": kind,
                           "namespace": namespace, "name": name})
        return protocol.decode_obj(resp["object"])

    def list(self, kind: str, namespace: Optional[str] = None) -> List:
        resp = self._call({"op": "list", "kind": kind, "namespace": namespace})
        return [protocol.decode_obj(d) for d in resp["objects"]]

    def delete(self, kind: str, namespace: str, name: str):
        resp = self._call({"op": "delete", "kind": kind,
                           "namespace": namespace, "name": name})
        return protocol.decode_obj(resp["object"])

    def commit_batch(self, binds=(), evicts=(), events=(), conditions=(),
                     pod_groups=()):
        """Coalesced commit frame (protocol v2): one VBUS request
        carrying N binds + evictions + audit events + status writebacks,
        applied server-side as a single store transaction.  A v1 server
        answers ``unknown bus op`` — the client then degrades PERMANENTLY
        (per client lifetime) to per-object binds through the shared
        :func:`client.apiserver.apply_commit_batch` semantics, so a
        version-skewed apiserver costs throughput, never correctness."""
        if not self._no_commit_batch:
            try:
                resp = self._call({
                    "op": "commit_batch",
                    "binds": list(binds),
                    "evicts": list(evicts),
                    "events": list(events),
                    "conditions": list(conditions),
                    "pod_groups": [protocol.encode_obj(pg)
                                   for pg in pod_groups],
                })
                return resp["results"]
            except BusError:
                raise  # transport failure — NOT a capability signal
            except ApiError as e:
                if "unknown bus op" not in str(e):
                    raise
                log.warning(
                    "bus %s does not speak commit_batch (old peer); "
                    "falling back to per-object binds", self.address,
                )
                self._no_commit_batch = True
        from volcano_tpu_torch.client.apiserver import apply_commit_batch

        return apply_commit_batch(
            self, binds=binds, evicts=evicts, events=events,
            conditions=conditions, pod_groups=pod_groups,
        )

    def record_event(
        self,
        namespace: str,
        involved: dict,
        type_: str,
        reason: str,
        message: str,
    ):
        """Event recorder over the bus — the same aggregate-by-
        (object, type, reason) correlator the in-process clients use
        (client.clients.record_event_via), so SchedulerCache audit
        Events flow when the cache's client is a bare RemoteAPIServer
        rather than a SchedulerClient wrapper."""
        from volcano_tpu_torch.client.clients import record_event_via

        return record_event_via(self, namespace, involved, type_,
                                reason, message)

    def watch(self, kind: str, handler: WatchHandler,
              send_initial: bool = True) -> None:
        """Same contract as the in-process ``APIServer.watch``: register
        a handler; with ``send_initial`` it first receives ADDED for
        every existing object (served from the shadow cache when the
        stream is already up)."""
        with self._watch_lock:
            state = self._watches.get(kind)
            fresh = state is None
            if fresh:
                with self._id_lock:
                    self._watch_id += 1
                    wid = self._watch_id
                state = _WatchState(kind, wid)
                self._watches[kind] = state
                self._by_watch_id[state.watch_id] = state
        # handler registration goes through the dispatch queue so its
        # initial snapshot and subsequent events form one ordered stream
        self._dispatch_q.put(("add_handler", state, (handler, send_initial)))
        if fresh and self._connected.is_set():
            try:
                self._establish_watch(state)
            except (ApiError, OSError) as e:
                # the connection manager owns recovery: a resync pass
                # re-establishes every watch (idempotent), so a blip
                # here cannot leave this informer silently frozen
                log.error("bus watch %s establish failed: %s", kind, e)
                self._ctl.put(("resync",))
        # when not connected, the connect-time resync establishes it

    def unwatch(self, kind: str, handler: WatchHandler) -> None:
        with self._watch_lock:
            state = self._watches.get(kind)
        if state is not None:
            self._dispatch_q.put(("remove_handler", state, handler))

    def close(self) -> None:
        self._closed = True
        self._connected.clear()
        self._ctl.put(("stop",))
        sock = self._sock
        if sock is not None:
            self._teardown_socket(sock)
        self._fail_pending(BusError("bus client closed"))
        self._dispatch_q.put(None)

    # ---- watch internals ----

    def _establish_watch(self, state: _WatchState) -> None:
        def accept(resp: dict) -> None:
            # Reader-thread hook: the snapshot's reconcile MUST be
            # enqueued before any live event frame that follows the
            # watch response on the wire — enqueueing from the calling
            # thread instead would let a racing DELETED event be
            # overwritten by the older snapshot (a resurrected object
            # in every informer cache, with last_seq regressed).
            if resp.get("resumed"):
                state.epoch = resp["epoch"]
                if "initial" in resp:
                    self._dispatch_q.put(
                        ("reconcile", state, (resp["initial"], resp["seq"]))
                    )

        def establish(base: dict) -> dict:
            """One watch request, preferring the v3 coalesced-delivery
            op.  A server that answers ``unknown bus op`` for
            ``watch_batch`` is an old peer — degrade PERMANENTLY (per
            client lifetime) to the per-object ``watch`` op; skew costs
            fan-out throughput, never correctness."""
            if not self._no_watch_batch:
                try:
                    return self._call(
                        {"op": "watch_batch", **base}, on_reply=accept
                    )
                except BusError:
                    raise  # transport failure — NOT a capability signal
                except ApiError as e:
                    if "unknown bus op" not in str(e):
                        raise
                    log.warning(
                        "bus %s does not speak watch_batch (old peer); "
                        "per-object watch frames", self.address,
                    )
                    self._no_watch_batch = True
            return self._call({"op": "watch", **base}, on_reply=accept)

        base = {"kind": state.kind, "watch_id": state.watch_id}
        if state.epoch is not None and state.last_seq is not None:
            base["epoch"] = state.epoch
            base["resume_seq"] = state.last_seq
        resp = establish(base)
        if not resp.get("resumed"):
            # 410 Gone — relist: fresh watch returns an atomic snapshot
            # the dispatch thread reconciles against the shadow cache
            metrics.register_bus_relist(state.kind)
            log.info("bus watch %s: resume rejected (410); relisting",
                     state.kind)
            establish({"kind": state.kind, "watch_id": state.watch_id})

    def _dispatch_loop(self) -> None:
        while True:
            item = self._dispatch_q.get()
            if item is None:
                return
            op, state, payload = item
            try:
                if op == "event":
                    self._apply_event(state, payload)
                elif op == "bookmark":
                    if state.last_seq is None or payload["seq"] > state.last_seq:
                        state.last_seq = payload["seq"]
                    metrics.update_bus_watch_lag(time.time() - payload["ts"])
                elif op == "reconcile":
                    self._reconcile(state, *payload)
                elif op == "add_handler":
                    handler, send_initial = payload
                    if state.defunct:
                        # raced a teardown of the last handler — register
                        # through the public path so a fresh watch state
                        # (and server subscription) is established
                        self.watch(state.kind, handler, send_initial)
                        continue
                    state.handlers.append((handler, send_initial))
                    if send_initial and state.listed.is_set():
                        for data in list(state.shadow.values()):
                            self._fire(state, [(handler, True)], ADDED, None,
                                       protocol.decode_obj(data))
                elif op == "remove_handler":
                    state.handlers = [
                        (h, init) for h, init in state.handlers if h != payload
                    ]
                    if not state.handlers and not state.defunct:
                        # nobody listens: fully detach, like the
                        # in-process unwatch — drop the client state and
                        # stop the server-side stream
                        state.defunct = True
                        with self._watch_lock:
                            if self._watches.get(state.kind) is state:
                                del self._watches[state.kind]
                            self._by_watch_id.pop(state.watch_id, None)
                        self._ctl.put(("unsubscribe", state.watch_id))
            except Exception as e:  # noqa: BLE001 — keep the stream alive
                log.error("bus dispatch %s/%s failed: %s", op, state.kind, e)

    def _apply_event(self, state: _WatchState, entry: dict) -> None:
        if state.last_seq is not None and entry["seq"] <= state.last_seq:
            return  # replay overlap — already delivered
        event = entry["event"]
        old_d, new_d = entry["old"], entry["new"]
        key = _obj_key(new_d if new_d is not None else old_d)
        if event == DELETED:
            state.shadow.pop(key, None)
        else:
            state.shadow[key] = new_d
        state.last_seq = entry["seq"]
        metrics.register_bus_watch_event(state.kind)
        metrics.update_bus_watch_lag(time.time() - entry["ts"])
        self._fire(state, state.handlers, event,
                   protocol.decode_obj(old_d), protocol.decode_obj(new_d))

    def _reconcile(self, state: _WatchState, initial: List[dict],
                   seq: int) -> None:
        """The informer Replace(): diff the fresh list against the shadow
        cache and synthesize exactly the missed deltas — no duplicates,
        no gaps.  The very first sync is the "initial" snapshot, which
        only ``send_initial`` handlers asked for; every later reconcile
        is a relist whose deltas all handlers need."""
        first_sync = not state.listed.is_set()
        add_targets = (
            [(h, init) for h, init in state.handlers if init]
            if first_sync else state.handlers
        )
        fresh = {_obj_key(d): d for d in initial}
        for key, new_d in fresh.items():
            old_d = state.shadow.get(key)
            if old_d is None:
                self._fire(state, add_targets, ADDED, None,
                           protocol.decode_obj(new_d))
            elif (old_d.get("metadata", {}).get("resourceVersion")
                  != new_d.get("metadata", {}).get("resourceVersion")):
                self._fire(state, state.handlers, MODIFIED,
                           protocol.decode_obj(old_d),
                           protocol.decode_obj(new_d))
        for key, old_d in list(state.shadow.items()):
            if key not in fresh:
                self._fire(state, state.handlers, DELETED,
                           protocol.decode_obj(old_d), None)
        state.shadow = fresh
        state.last_seq = seq
        state.listed.set()

    def _fire(self, state: _WatchState, handlers, event, old, new) -> None:
        for handler, _wants_initial in list(handlers):
            try:
                handler(event, old, new)
            except Exception as e:  # noqa: BLE001 — a bad handler must not
                # kill the shared dispatch thread
                log.error("watch handler for %s failed on %s: %s",
                          state.kind, event, e)
