"""``RemoteAPIServer`` — the drop-in swap for the in-process store.

A copy of ``volcano_tpu/bus/remote.py``: the surface of
``client.apiserver.APIServer`` (CRUD, list, optimistic-concurrency
update, status subresource, the coalesced commit frame, the conditional
binds ``cas_bind`` and ``txn_commit``, watch with initial sync) over one
connection to a ``vtpu-apiserver`` — the port's or the JAX package's, whose wire is the
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

Remote admission: ``register_admission`` makes this connection the
webhook endpoint for (kind, operation).  The server forwards each review
as a T_ADMIT_REQ frame; the hooks run on a thread of their own (never on
the reader, so a hook may call back into this client), inside an
``admission:review`` span adopted from the server's, and the verdict
goes back as T_ADMIT_RESP.  The registration is replayed after every
reconnect.

Replicated apiservers: ``address`` may be an endpoint list
(``tcp://a,tcp://b``).  The client dials the entries in order, rotates
across them on connection loss, follows a ``NotLeaderError``'s leader
hint, and, once it hosts an admission webhook, redials until it sits on
the leader.  ``bus_add_replica`` / ``bus_remove_replica`` change the
group's membership (v7).  On loopback with ``VTPU_BUS_SHM`` set the
client first attaches the same-host shm rings (bus/shm.py) and falls
back to TCP when the attach fails for any reason.
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
from volcano_tpu_torch.bus import protocol, shm
from volcano_tpu_torch.bus.protocol import BusError, BusTimeoutError
from volcano_tpu_torch.client.apiserver import (
    ADDED,
    AdmissionError,
    ApiError,
    ConflictError,
    DELETED,
    MODIFIED,
    NotFoundError,
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

    ``address`` is ``tcp://host:port`` (or a bare ``host:port``), or a
    comma-separated endpoint list of replicated apiservers.
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
        #: ``address`` may be a comma-separated endpoint LIST
        #: (``tcp://a,tcp://b,...``) — the replicated-apiserver form:
        #: the client dials entries in order until one answers and
        #: rotates across them on connection loss, so a dead replica
        #: never strands a daemon.  Reads/watches are served wherever
        #: we land (followers included); writes are proxied server-side
        #: to the leader.
        self.endpoints = [
            f"tcp://{h}:{p}" for h, p in protocol.parse_bus_endpoints(address)
        ]
        self._endpoint_idx = 0
        self.host, self.tcp_port = protocol.parse_bus_url(self.endpoints[0])
        self.address = self.endpoints[0]
        self.timeout = timeout
        self.reconnect_min = reconnect_min
        self.reconnect_max = reconnect_max

        self._sock: Optional[socket.socket] = None
        #: the last connection whose reader saw it die: a request sent on
        #: it after that reader failed the pending calls fails at once
        self._lost_sock: Optional[socket.socket] = None
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
        #: (kind, operation) → local webhook hooks (register_admission)
        self._admission: Dict[Tuple[str, str], List] = {}

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
        #: set once a server rejects the v4 ``cas_bind`` op — spillover
        #: binds then degrade to the get + CAS-update equivalent
        self._no_cas_bind = False
        #: set once a server rejects the v6 ``txn_commit`` op — atomic
        #: multi-object transactions then ABORT (reported unsupported),
        #: never replay per-object: a pre-v6 peer cannot apply half a
        #: gang atomically, so the gang broker degrades to the honest
        #: pre-v6 refusal mode instead
        self._no_txn_commit = False
        #: negotiated body codec for the CURRENT connection — reset to
        #: JSON on every (re)dial, flipped to binary only when the
        #: server's hello answer says so.  Frames are stamped per frame,
        #: so a stale value can never misdecode anything.
        self.codec = protocol.CODEC_JSON

        self._ctl: "queue.Queue[tuple]" = queue.Queue()
        self._dispatch_q: "queue.Queue[Optional[tuple]]" = queue.Queue()
        #: this client must sit on the LEADER (set by
        #: register_admission: webhook reviews are forwarded by the
        #: server that runs the store transaction, which is always the
        #: leader) — on connect to a follower it redials at the
        #: follower-reported leader address
        self._must_lead = False
        #: monotonic stamp of the last leader-hint redial — one hint
        #: mid-election must not turn into a redial storm
        self._last_hint_redial = 0.0

        #: forwarded admission reviews, run off the reader thread (a
        #: hook may call back into this client)
        self._admit_q: "queue.Queue[Optional[tuple]]" = queue.Queue()

        self._conn_thread = threading.Thread(
            target=self._conn_loop, name="vtpu-bus-conn", daemon=True
        )
        self._dispatch_thread = threading.Thread(
            target=self._dispatch_loop, name="vtpu-bus-dispatch", daemon=True
        )
        self._admit_thread = threading.Thread(
            target=self._admit_loop, name="vtpu-bus-admit", daemon=True
        )
        self._conn_thread.start()
        self._dispatch_thread.start()
        self._admit_thread.start()

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

    def _current_endpoint(self) -> Tuple[str, int]:
        url = self.endpoints[self._endpoint_idx % len(self.endpoints)]
        self.address = url
        return protocol.parse_bus_url(url)

    def _dial(self) -> socket.socket:
        """One transport attempt at the current endpoint: the same-host
        shm ring first when enabled (``local_up --multiproc``), TCP
        otherwise — and TCP as the silent fallback whenever the ring
        attach fails for ANY reason (no listener, no directory, no
        fd-passing).  Both return socket-shaped objects carrying the
        identical frame stream."""
        host, port = self._current_endpoint()
        if shm.shm_enabled() and host in ("127.0.0.1", "localhost", "::1"):
            try:
                return shm.connect(port, timeout=self.timeout)
            except (OSError, ValueError, ConnectionError) as e:
                log.debug("bus shm attach failed (%s); dialing TCP", e)
        return socket.create_connection((host, port), timeout=self.timeout)

    def _conn_loop(self) -> None:
        backoff = self.reconnect_min
        while not self._closed:
            try:
                sock = self._dial()
            except OSError:
                # rotate to the next replica before backing off — a
                # dead endpoint must not serialize the whole list
                # behind its own backoff ladder
                self._endpoint_idx += 1
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
            if self._must_lead and not self._leader_check():
                # connected to a follower while this client must sit on
                # the leader (admission endpoint): redial at the leader
                self._connected.clear()
                self._teardown_socket(sock)
                self._fail_pending(BusError("redialing at the bus leader"))
                time.sleep(min(0.2, self.reconnect_max))
                continue
            self._resync_session()
            # serve control messages until the reader reports loss
            while not self._closed:
                item = self._ctl.get()
                if item[0] == "disconnect":
                    break
                if item[0] == "redial":
                    break  # e.g. leader moved — reconnect at the hint
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

    def _leader_check(self) -> bool:
        """True when the connected peer can host this client (leader,
        standalone, or a pre-v5 server).  On a follower: point the
        endpoint cursor at the reported leader and return False."""
        try:
            status = self.bus_status()
        except (ApiError, OSError):
            return True  # can't tell — stay; calls will surface errors
        if status.get("role") != "follower":
            return True
        leader = status.get("leader")
        if not leader:
            return False  # election in progress — retry shortly
        if leader not in self.endpoints:
            self.endpoints.append(leader)
        self._endpoint_idx = self.endpoints.index(leader)
        log.info("bus %s is a follower; redialing at leader %s",
                 self.address, leader)
        return False

    def _resync_session(self) -> None:
        """After (re)connect: re-register admission endpoints, then
        re-establish every watch with resume-or-relist.  Each item is
        attempted independently, and ANY failure schedules a full retry
        — the whole resync is idempotent (re-registration dedups
        server-side; a re-established watch resumes from last_seq and
        replayed events dedup by sequence number), and a watch left
        un-established would freeze its informer cache silently."""
        failed = False
        for kind, operation in list(self._admission):
            try:
                self._call({"op": "register_admission", "kind": kind,
                            "operation": operation})
            except (ApiError, OSError) as e:
                log.error("bus admission re-register %s/%s failed: %s",
                          kind, operation, e)
                if "not leader" in str(e):
                    # this peer became a follower — redial at the leader
                    self._ctl.put(("redial",))
                    return
                failed = True
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
                    # no reply can come on this connection: fail its
                    # calls now, not at their timeout (the connection
                    # thread itself may be parked in one, the codec
                    # hello or the leader check of a fresh dial)
                    self._lost_sock = sock
                    self._fail_pending(BusError("bus connection lost"))
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
            elif mtype == protocol.T_ADMIT_REQ:
                self._admit_q.put((corr_id, payload))

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
            if sock is self._lost_sock:
                raise BusError("bus connection lost")
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
            leader = waiter["error_payload"].get("leader")
            if leader:
                # leader-hint redial: a "not leader" answer NAMES the
                # current leader — steer the endpoint cursor there and
                # reconnect directly instead of rotating the list
                # blindly (each blind rotation costs a dial + probe;
                # the hint collapses the failover/proxy tail to one
                # reconnect).  Debounced: one hint per second at most.
                self._note_leader(leader)
            protocol.raise_error(waiter["error_payload"])
        metrics.observe_bus_request(method, time.perf_counter() - start, "ok")
        return waiter["result"]

    def _note_leader(self, leader: str) -> None:
        """Point the endpoint cursor at a hinted leader so the NEXT
        dial — a reconnect after a failure, or a ``_must_lead``
        leader-chase — goes straight there instead of rotating the
        list blindly.  Mirrors ``_leader_check``'s cursor discipline
        (benign races: worst case the list briefly holds a duplicate
        entry).

        Only a ``_must_lead`` client redials IMMEDIATELY: for everyone
        else the hinted write already failed typed and the caller's
        retry flows through the live connection once the proxy heals.
        Tearing down a healthy follower connection on every hint was
        worse than blind rotation — mid-failover the hint names the
        JUST-DEAD leader (the follower's stale view), and the
        pointless redial both pays a dead dial and forces the watch
        resume onto whatever epoch the reconnect lands on (the
        zero-relist failover pin caught exactly that churn)."""
        if leader not in self.endpoints:
            self.endpoints.append(leader)
        self._endpoint_idx = self.endpoints.index(leader)
        now = time.monotonic()
        if (
            self._must_lead
            and leader != self.address
            and now - self._last_hint_redial >= 1.0
        ):
            self._last_hint_redial = now
            self._ctl.put(("redial",))


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

    def _membership_call(self, op: str, url: str, verb: str) -> dict:
        """Shared driver for the VBUS v7 membership ops.  Routed to the
        leader (a follower proxies).  A pre-v7 server answers ``unknown
        bus op``: dynamic membership then fails with a typed error — no
        fallback CAN exist, an old peer has no membership log to record
        the change in (version skew costs the elastic feature, never
        group safety)."""
        try:
            # the leader may wait for a joiner's catch-up (or probe the
            # shrunk group's reachability) before logging the config
            # record — give it room beyond the default per-call budget
            return self._call({"op": op, "url": url},
                              timeout=max(self.timeout, 30.0))
        except BusError:
            raise  # transport failure — NOT a capability signal
        except ApiError as e:
            if "unknown bus op" not in str(e):
                raise
            raise ApiError(
                "bus does not support dynamic membership (pre-v7 "
                f"peer) — {verb} refused"
            ) from e

    def bus_add_replica(self, url: str) -> dict:
        """Admit one new replica to the replication group (protocol v7;
        ``vtctl bus add-replica``)."""
        return self._membership_call("bus_add_replica", url,
                                     "add-replica")

    def bus_remove_replica(self, url: str) -> dict:
        """Retire one replica from the replication group (protocol v7;
        ``vtctl bus remove-replica``)."""
        return self._membership_call("bus_remove_replica", url,
                                     "remove-replica")

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

    def cas_bind(self, namespace: str, name: str, hostname: str,
                 expected_rv=None):
        """Optimistic binding write (protocol v4): one round trip that
        binds the pod iff it is still unbound and its resourceVersion
        matches — the federation spillover primitive.  A pre-v4 server
        answers ``unknown bus op``; the client then degrades PERMANENTLY
        (per connection lifetime) to the get + CAS ``update``
        equivalent.  The at-most-once-bind invariant survives the skew
        unchanged (the conflict is still detected at the store via the
        expected resourceVersion); the one semantic difference is that
        ``update`` runs the server's UPDATE admission chain, which the
        native op skips like any binding subresource — against an old
        server, a Pod-UPDATE webhook can therefore observe (and reject)
        spillover binds.  A rejected bind counts as a spillover error
        and is retried next cycle, never silently dropped."""
        if not self._no_cas_bind:
            try:
                resp = self._call({
                    "op": "cas_bind", "namespace": namespace,
                    "name": name, "hostname": hostname,
                    "expected_rv": expected_rv,
                })
                return protocol.decode_obj(resp["object"])
            except BusError:
                raise  # transport failure — NOT a capability signal
            except ApiError as e:
                if "unknown bus op" not in str(e):
                    raise
                log.warning(
                    "bus %s does not speak cas_bind (old peer); "
                    "falling back to get + CAS update", self.address,
                )
                self._no_cas_bind = True
        pod = self.get("Pod", namespace, name)
        if pod is None:
            raise NotFoundError(f"Pod {namespace}/{name} not found")
        if pod.spec.node_name:
            raise ConflictError(
                f"pod {namespace}/{name} already bound to "
                f"{pod.spec.node_name}"
            )
        if (
            expected_rv is not None
            and pod.metadata.resource_version != expected_rv
        ):
            raise ConflictError(
                f"Pod {namespace}/{name} resourceVersion "
                f"{pod.metadata.resource_version} != expected {expected_rv}"
            )
        pod.spec.node_name = hostname
        return self.update(pod, expected_rv=pod.metadata.resource_version)

    def txn_commit(self, binds=()):
        """Atomic multi-``cas_bind`` transaction (protocol v6): N
        conditional binds checked and applied all-or-nothing in one
        server-side store lock hold — the cross-shard gang-assembly
        primitive.  Returns the ``{committed, results, objects}`` shape
        of :meth:`client.apiserver.APIServer.txn_commit`.

        A pre-v6 server answers ``unknown bus op``; the client then
        degrades PERMANENTLY (per connection lifetime) to an ABORT —
        ``committed: False`` with every item marked unsupported and
        ``reason: "unsupported"`` — and NEVER to a per-object replay: a
        sequence of single binds against an old peer could crash or
        conflict halfway and strand a partial gang, which is exactly
        the state the transaction exists to forbid.  Version skew costs
        the cross-shard gang feature, never the no-partial-gang
        invariant (the caller stays in the pre-v6 refusal mode)."""
        binds = list(binds)
        if not self._no_txn_commit:
            try:
                resp = self._call({"op": "txn_commit", "binds": binds})
                return {
                    "committed": resp["committed"],
                    "results": resp["results"],
                    "objects": [
                        protocol.decode_obj(d)
                        for d in resp.get("objects", ())
                    ],
                }
            except BusError:
                raise  # transport failure — NOT a capability signal
            except ApiError as e:
                if "unknown bus op" not in str(e):
                    raise
                log.warning(
                    "bus %s does not speak txn_commit (old peer); "
                    "atomic multi-object transactions abort — no "
                    "per-object fallback can be atomic", self.address,
                )
                self._no_txn_commit = True
        return {
            "committed": False,
            "results": [
                "unsupported: pre-v6 bus cannot apply an atomic "
                "multi-object transaction"
            ] * len(binds),
            "objects": [],
            "reason": "unsupported",
        }

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

    def register_admission(self, kind: str, operation: str, hook) -> None:
        """Make this client the webhook endpoint for (kind, operation).
        Hooks run locally when the server forwards a review; the
        registration survives reconnects."""
        key = (kind, operation)
        first = key not in self._admission
        self._admission.setdefault(key, []).append(hook)
        #: reviews are forwarded by the leader — from now on this client
        #: chases the leader across reconnects (replicated apiservers)
        self._must_lead = True
        if first and self._connected.is_set():
            try:
                self._call({"op": "register_admission", "kind": kind,
                            "operation": operation})
            except (ApiError, OSError) as e:
                # the connection may survive the failed call (a stalled
                # server times the request out without dropping TCP), so
                # waiting for the connect-time resync is not enough —
                # an unregistered webhook fails OPEN on the server side
                log.error("bus admission register %s/%s failed: %s",
                          kind, operation, e)
                if "not leader" in str(e):
                    # we sit on a follower: break the connection so the
                    # reconnect (with _must_lead set) lands on the
                    # leader, where the resync replays the registration
                    self._ctl.put(("redial",))
                else:
                    self._ctl.put(("resync",))

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
        self._admit_q.put(None)

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

    # ---- remote admission reviews ----

    def _send_noreply(self, mtype: int, corr_id: int, payload: dict) -> None:
        sock = self._sock
        if sock is None:
            return
        try:
            with self._send_lock:
                protocol.send_frame(sock, mtype, corr_id, payload,
                                    codec=self.codec)
        except OSError:
            pass

    def _admit_loop(self) -> None:
        while True:
            item = self._admit_q.get()
            if item is None:
                return
            review_id, payload = item
            kind, operation = payload["kind"], payload["operation"]
            hooks = list(self._admission.get((kind, operation), []))
            try:
                obj = protocol.decode_obj(payload["object"])
                meta = getattr(obj, "metadata", None)
                with obs.adopt(
                    payload.get("span"), "admission:review", cat="admission",
                    args={
                        "kind": kind, "operation": operation,
                        **({"pod": f"{meta.namespace}/{meta.name}"}
                           if kind == "Pod" and meta is not None else {}),
                    },
                ):
                    for hook in hooks:
                        obj = hook(operation, obj) or obj
                resp = {"allowed": True, "object": protocol.encode_obj(obj)}
            except AdmissionError as e:
                resp = {"allowed": False, "message": str(e)}
            except Exception as e:  # noqa: BLE001 — deny, don't crash
                log.error("admission hook %s/%s crashed: %s", kind, operation, e)
                resp = {"allowed": False, "message": f"webhook error: {e}"}
            self._send_noreply(protocol.T_ADMIT_RESP, review_id, resp)
