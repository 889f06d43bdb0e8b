"""``BusServer`` — the network face of the in-process API server.

A copy of ``volcano_tpu/bus/server.py``: wraps a
``client.apiserver.APIServer`` store (volatile, or the WAL-backed
``bus.PersistentAPIServer``) behind the frame protocol in
``bus.protocol`` over TCP, so a ``RemoteAPIServer`` of the port or of
the JAX package talks to it as to the reference's server.

* **CRUD + list** proxy straight to the wrapped store, so semantics
  (optimistic concurrency, owner-reference cascade) are exactly the
  in-process ones; ``commit_batch`` applies a coalesced commit frame as
  one store transaction.
* **Watch streams**: every store mutation is stamped with a bus
  sequence number and retained in a bounded backlog.  A watch request
  carrying ``(epoch, resume_seq)`` replays the missed suffix when the
  backlog still covers it; otherwise the server answers
  ``resumed: false`` — the 410-Gone "relist required" of the k8s
  watch API — and the client re-lists.  Periodic bookmarks advance the
  client's resume point through quiet periods.  A connection that
  established its watches through ``watch_batch`` receives consecutive
  watch events coalesced into ``T_WATCH_BATCH`` frames.
* **Codec**: ``bus_hello`` negotiates msgpack bodies per connection
  where msgpack imports; JSON otherwise.

Event fan-out happens under the store lock (the store's own ``_notify``
discipline), which gives every subscriber one total order; delivery is
decoupled through per-connection outbound queues so a slow or dead peer
can never stall the store — it overflows its queue and is disconnected,
after which it resyncs via resume-or-relist.

``bus_status`` answers the wrapped store's status (role, persistence,
WAL and replication fields, its daemon's /metrics address).  With the
flight recorder on, a request that carries a span context
(``payload["span"]``) runs inside an adopted ``bus:<op>`` span, the
child of the client's span in the other process.

* **Remote admission**: a connection may register as the webhook for a
  (kind, operation) (``register_admission``); creates and updates of
  that kind are forwarded to it as admission-review frames, and the
  server waits up to ``admission_timeout`` for the verdict before
  touching the store (a reviewer that disconnects mid-review fails
  open).  A closed connection's registrations are dropped.

* **Durability and replication**: over a persistent store the bus
  sequence, epoch and watch backlog are the store's durable ones, so a
  restarted server (or a promoted follower) resumes client cursors
  instead of forcing a relist.  With a ``replica`` (bus/replication.py)
  a follower proxies the write ops to its leader and answers the
  ``repl_*`` log-shipping and membership ops; ``bus_status`` carries the
  replica's role, term, followers and lag.
* **Same-host rings**: with ``VTPU_BUS_SHM`` set the server also
  listens on the shm transport (bus/shm.py) next to TCP; the frames are
  the same.

An op the server does not have is answered with the reference's typed
``unknown bus op`` error, so a client of the reference takes its
old-peer fallback.
"""

from __future__ import annotations

import queue
import socket
import threading
import time
import uuid
from typing import Dict, List, Optional, Tuple

from volcano_tpu_torch import metrics, obs, trace
from volcano_tpu_torch.bus import protocol, shm
from volcano_tpu_torch.bus.protocol import NotLeaderError
from volcano_tpu_torch.bus.wal import bus_status_payload
from volcano_tpu_torch.client.apiserver import AdmissionError, ApiError, APIServer
from volcano_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

#: outbound frames buffered per connection before the peer is declared
#: too slow and disconnected (it will resync via resume-or-relist)
_OUTBOUND_DEPTH = 16384

#: watch events coalesced into one T_WATCH_BATCH frame at most — bounds
#: frame size so a relist-scale replay cannot produce one giant payload
_WATCH_BATCH_MAX = 512


class _CachedPayload:
    """A frame body serialized at most once per EVENT, not once per
    subscriber.  The correlation id lives in the frame header, so the
    cached body bytes are shared verbatim; the watch_batch coalescer
    splices the per-watch id into the cached bytes instead of
    re-encoding (see ``_Conn.write_loop``).  Each codec caches its own
    bytes.  Lazily computed on the first writer that ships it; the
    unsynchronized benign race can at worst serialize twice."""

    __slots__ = ("obj", "_raw", "_raw_bin")

    def __init__(self, obj: dict):
        self.obj = obj
        self._raw: Optional[bytes] = None
        self._raw_bin: Optional[bytes] = None

    def raw(self) -> bytes:
        body = self._raw
        if body is None:
            body = protocol.encode_payload(self.obj)
            self._raw = body
        return body

    def raw_bin(self) -> bytes:
        body = self._raw_bin
        if body is None:
            body = protocol.encode_payload(self.obj, protocol.CODEC_BINARY)
            self._raw_bin = body
        return body

    def raw_for(self, codec: str) -> bytes:
        return self.raw_bin() if codec == protocol.CODEC_BINARY else self.raw()


def _splice_watch_id(body: bytes, watch_id: int) -> bytes:
    """``{"seq":...}`` → ``{"watch_id":N,"seq":...}`` by byte surgery —
    the batch entry a v3 client decodes as ``dict(entry, watch_id=N)``,
    without re-serializing the (shared, cached) entry body."""
    return b'{"watch_id":' + str(watch_id).encode() + b"," + body[1:]


def _splice_watch_id_bin(body: bytes, watch_id: int) -> bytes:
    """The msgpack twin of :func:`_splice_watch_id`: prepend a
    ``watch_id`` key to a cached map body by bumping the map-header
    count and splicing the packed pair in front of the existing
    entries — the entry body itself stays the shared cached bytes."""
    import msgpack

    marker = body[0]
    pair = b"\xa8watch_id" + msgpack.packb(watch_id)
    if 0x80 <= marker < 0x8F:
        # fixmap with room for one more pair
        return bytes((marker + 1,)) + pair + body[1:]
    if marker == 0x8F:
        # fixmap at capacity: promote to map16
        return b"\xde\x00\x10" + pair + body[1:]
    if marker == 0xDE:
        count = int.from_bytes(body[1:3], "big")
        return b"\xde" + (count + 1).to_bytes(2, "big") + pair + body[3:]
    # map32 or a non-map body: fall back to decode/re-encode
    entry = msgpack.unpackb(body, raw=False)
    entry["watch_id"] = watch_id
    return msgpack.packb(entry, use_bin_type=True)


def _batch_body_bin(parts: List[bytes]) -> bytes:
    """Assemble ``{"events": [...]}`` in msgpack from pre-spliced entry
    bodies — the binary equivalent of the JSON join, still zero
    re-encode.  ``len(parts) <= _WATCH_BATCH_MAX < 65536``."""
    n = len(parts)
    head = bytes((0x90 | n,)) if n < 16 else b"\xdc" + n.to_bytes(2, "big")
    return b"\x81\xa6events" + head + b"".join(parts)


class _Conn:
    """One accepted connection: a reader (request handler) thread plus a
    writer thread draining the outbound queue, so watch pushes and
    admission reviews never block the store-side notifier."""

    def __init__(self, sock: socket.socket, peer):
        self.sock = sock
        self.peer = peer
        #: (mtype, corr_id, dict-or-_CachedPayload) frames, None = stop
        self.outbound: "queue.Queue[Optional[Tuple[int, int, object]]]" = queue.Queue(
            maxsize=_OUTBOUND_DEPTH
        )
        self.closed = False
        #: the peer established its watches via the v3 ``watch_batch``
        #: op: consecutive T_WATCH_EVENT frames may coalesce into one
        #: T_WATCH_BATCH frame on the writer thread below.  Set before
        #: the first watch response is pushed, read only by the writer.
        self.batch_watch = False
        #: negotiated body codec (protocol v8 ``bus_hello``).  Every
        #: connection starts JSON and flips to binary only when the
        #: peer asked for it; frames are stamped per frame, so the flip
        #: has no ordering hazard with in-flight responses.
        self.codec = protocol.CODEC_JSON
        #: watch_id → kind, for cleanup on close
        self.watches: Dict[int, str] = {}
        #: review_id → waiter, resolved by T_ADMIT_RESP frames
        self.reviews: Dict[int, dict] = {}
        self._lock = threading.Lock()

    def push(self, mtype: int, corr_id: int, payload) -> bool:
        """Enqueue a frame; returns False (and kills the connection) when
        the peer is too slow to keep up."""
        if self.closed:
            return False
        try:
            self.outbound.put_nowait((mtype, corr_id, payload))
            return True
        except queue.Full:
            log.error("bus peer %s overflowed its outbound queue; disconnecting", self.peer)
            self.kill()
            return False

    def kill(self) -> None:
        with self._lock:
            if self.closed:
                return
            self.closed = True
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        # unblock the writer thread and fail pending admission reviews
        try:
            self.outbound.put_nowait(None)
        except queue.Full:
            pass
        for waiter in list(self.reviews.values()):
            waiter["result"] = None
            waiter["event"].set()
        self.reviews.clear()

    def _send(self, mtype: int, corr_id: int, payload) -> bool:
        """Send one wire frame (with the bus.delay injection point);
        False kills the connection.  ``payload`` is a dict or a
        :class:`_CachedPayload` whose bytes are shared across
        subscribers."""
        from volcano_tpu_torch import faults

        fp = faults.get_plane()
        if fp.enabled and fp.should("bus.delay"):
            # latency injection lives on the writer thread, NOT the
            # store-side notifier — a slow wire must never stall the
            # store (the decoupling this queue exists for)
            time.sleep(fp.param_ms("bus.delay") / 1e3)
        codec = self.codec
        try:
            if isinstance(payload, _CachedPayload):
                body = payload.raw_for(codec)
            else:
                body = protocol.encode_payload(payload, codec)
            protocol.send_frame_raw(self.sock, mtype, corr_id, body, codec)
            metrics.observe_bus_frame_bytes(codec, len(body))
            return True
        except (OSError, ValueError):
            self.kill()
            return False

    def _send_raw(self, mtype: int, corr_id: int, body: bytes) -> bool:
        """Pre-assembled body variant of :meth:`_send` (the watch-batch
        splice path); the body is already in this connection's codec.
        Same delay injection and failure semantics."""
        from volcano_tpu_torch import faults

        fp = faults.get_plane()
        if fp.enabled and fp.should("bus.delay"):
            time.sleep(fp.param_ms("bus.delay") / 1e3)
        try:
            protocol.send_frame_raw(self.sock, mtype, corr_id, body, self.codec)
            metrics.observe_bus_frame_bytes(self.codec, len(body))
            return True
        except (OSError, ValueError):
            self.kill()
            return False

    def write_loop(self) -> None:
        while True:
            item = self.outbound.get()
            if item is None or self.closed:
                return
            mtype, corr_id, payload = item
            if not (self.batch_watch and mtype == protocol.T_WATCH_EVENT):
                if not self._send(mtype, corr_id, payload):
                    return
                continue
            # watch-frame coalescing (protocol v3): a commit_batch
            # transaction lands N notifications on this queue in one
            # burst before this thread wakes — drain the consecutive
            # watch events greedily and ship ONE T_WATCH_BATCH frame.
            # Each entry carries its watch id (the correlation-id slot
            # holds only one), SPLICED into each entry's cached bytes.
            # A non-watch frame (response, bookmark) is an ordering
            # barrier: it flushes the batch and is sent right after, in
            # queue order.
            batch = [(corr_id, payload)]
            tail = None
            drained_stop = False
            while len(batch) < _WATCH_BATCH_MAX:
                try:
                    nxt = self.outbound.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    drained_stop = True
                    break
                if nxt[0] != protocol.T_WATCH_EVENT:
                    tail = nxt
                    break
                batch.append((nxt[1], nxt[2]))
            if len(batch) == 1:
                ok = self._send(mtype, corr_id, payload)
            else:
                metrics.observe_watch_batch(len(batch))
                binary = self.codec == protocol.CODEC_BINARY
                splice = _splice_watch_id_bin if binary else _splice_watch_id
                parts = []
                for wid, p in batch:
                    body = (
                        p.raw_for(self.codec) if isinstance(p, _CachedPayload)
                        else protocol.encode_payload(p, self.codec)
                    )
                    parts.append(splice(body, wid))
                ok = self._send_raw(
                    protocol.T_WATCH_BATCH, 0,
                    _batch_body_bin(parts) if binary
                    else b'{"events":[' + b",".join(parts) + b"]}",
                )
            if not ok:
                return
            if tail is not None and not self._send(*tail):
                return
            if drained_stop or self.closed:
                return


class BusServer:
    """Serve an ``APIServer`` store over TCP.  ``port=0`` binds an
    ephemeral port (read it back from ``.port`` after ``start()``)."""

    def __init__(
        self,
        api: APIServer,
        host: str = "127.0.0.1",
        port: int = 0,
        backlog_size: int = 4096,
        bookmark_interval: float = 2.0,
        admission_timeout: float = 10.0,
        replica=None,
    ):
        self.api = api
        self.host = host
        self._port = port
        self.backlog_size = backlog_size
        self.bookmark_interval = bookmark_interval
        self.admission_timeout = admission_timeout
        #: replication role manager (bus/replication.py): routes write
        #: ops to the leader while this replica follows, and serves the
        #: repl_* log-shipping ops while it leads.  None = standalone.
        self.replica = replica
        #: epoch: identifies the resume-token space.  A volatile store
        #: mints a fresh one per incarnation, so a resume token from
        #: another incarnation can never be judged against our sequence
        #: numbers → relist-required; a persistent store carries its
        #: epoch in the data-dir meta — shared across restarts and
        #: across replicas — so surviving cursors resume instead.
        self._own_epoch = uuid.uuid4().hex
        #: durable stores restore the sequence + backlog at start();
        #: afterwards the central watchers keep _seq in lockstep with
        #: the store's committed event stream (see _make_central_watcher)
        self._persistent = hasattr(api, "current_event_seq")
        self._seq = 0  # guarded-by: self.api.locked()
        #: retained watch entries (cached-payload wrappers, shared with
        #: every subscriber queue)
        self._backlog: List[_CachedPayload] = []  # guarded-by: self.api.locked()
        #: kind → [(conn, watch_id)] live subscriptions
        self._subs: Dict[str, List[Tuple[_Conn, int]]] = {}  # guarded-by: self.api.locked()
        #: (kind, operation) → [conn] remote admission registrations;
        #: guarded by _admission_lock — a reconnecting webhook races its
        #: old connection's cleanup, and an unguarded prune-empty-key
        #: could strand the fresh registration on an orphaned list
        self._admission: Dict[Tuple[str, str], List[_Conn]] = {}  # guarded-by: self._admission_lock
        self._admission_lock = threading.Lock()
        self._review_id = 0  # guarded-by: self._review_lock
        self._review_lock = threading.Lock()
        self._central_watchers: List[Tuple[str, object]] = []
        self._listener: Optional[socket.socket] = None
        self._conns: List[_Conn] = []  # guarded-by: self._conns_lock
        self._conns_lock = threading.Lock()
        #: same-host shared-memory ring listener (bus/shm.py), opened
        #: next to the TCP listener when VTPU_BUS_SHM is set; None when
        #: the transport is off or could not come up (TCP still serves)
        self._shm_listener = None
        self._stop = threading.Event()

    # ---- lifecycle ----

    @property
    def epoch(self) -> str:
        return getattr(self.api, "epoch", "") or self._own_epoch

    @property
    def port(self) -> int:
        assert self._listener is not None, "server not started"
        return self._listener.getsockname()[1]

    def start(self) -> "BusServer":
        # bind first, subscribe after: a failed bind must not leave
        # central watchers attached (a retried start() would then record
        # every store mutation twice, duplicating all watch streams)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # a restarted server re-binding its fixed port can race
        # not-yet-reaped sockets of the previous incarnation — retry
        # briefly instead of crashing
        deadline = time.monotonic() + 5.0
        while True:
            try:
                self._listener.bind((self.host, self._port))
                break
            except OSError:
                if self._port == 0 or time.monotonic() >= deadline:
                    self._listener.close()
                    self._listener = None
                    raise
                time.sleep(0.05)
        self._listener.listen(64)
        if self._persistent:
            # recovery restores the resume surface: the store's durable
            # event seq and recent-event ring become this incarnation's
            # sequence + backlog, so clients whose cursor survived the
            # restart resume instead of relisting
            with self.api.locked():
                self._seq = self.api.event_seq
                self._backlog = [
                    _CachedPayload(e) for e in self.api.recent_events()
                ][-self.backlog_size:]
        for kind in protocol.KINDS:
            handler = self._make_central_watcher(kind)
            self.api.watch(kind, handler, send_initial=False)
            self._central_watchers.append((kind, handler))
        accept = threading.Thread(
            target=self._accept_loop, name="vtpu-bus-accept", daemon=True
        )
        bookmark = threading.Thread(
            target=self._bookmark_loop, name="vtpu-bus-bookmark", daemon=True
        )
        accept.start()
        bookmark.start()
        log.info("bus serving on %s:%d (epoch %s)", self.host, self.port, self.epoch[:8])
        if shm.shm_enabled():
            # same-host ring transport: rendezvous derived from the TCP
            # port, so clients need no extra discovery.  Failure to come
            # up is never fatal — TCP serves regardless.
            try:
                self._shm_listener = shm.ShmListener(self.port).start(self._adopt_conn)
                log.info("bus shm rings at %s", self._shm_listener.dir)
            except Exception as e:  # noqa: BLE001 — transport is optional
                log.warning("bus shm listener unavailable (%s); TCP only", e)
                self._shm_listener = None
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._listener is not None:
            # shutdown first: the accept thread blocked in accept() keeps
            # a closed listener listening, and a client redialing the
            # port (a restart on it, a failover probe) would be accepted
            # by this dead incarnation and wait out its call timeout
            for close in (lambda: self._listener.shutdown(socket.SHUT_RDWR),
                          self._listener.close):
                try:
                    close()
                except OSError:
                    pass
            self._listener = None
        if self._shm_listener is not None:
            try:
                self._shm_listener.stop()
            except OSError:
                pass
            self._shm_listener = None
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            conn.kill()
        # detach the central watchers so a restarted server on the same
        # store does not leave this incarnation's handlers firing forever
        for kind, handler in self._central_watchers:
            self.api.unwatch(kind, handler)
        self._central_watchers = []

    @property
    def running(self) -> bool:
        return self._listener is not None and not self._stop.is_set()

    # ---- event backlog + fan-out (runs under the store lock) ----

    def _make_central_watcher(self, kind: str):
        from volcano_tpu_torch import faults

        def on_event(event, old, new):
            # requires-lock: self.api.locked()
            # (store watchers fire under the store lock — the
            # _notify discipline documented on APIServer.locked)
            encoded = None
            if self._persistent:
                # lockstep with the durable stream: the persistent
                # store stamps each committed event's seq just before
                # flushing its notification (wal.py), so bus sequence
                # numbers survive restarts and match across replicas;
                # the port's store also hands over the event's encoded
                # objects, the ones its WAL record carries
                self._seq = self.api.current_event_seq
                encoded = getattr(self.api, "current_event_encoded", None)
            else:
                self._seq += 1
            old_d, new_d = encoded or (protocol.encode_obj(old), protocol.encode_obj(new))
            entry = _CachedPayload({
                "seq": self._seq,
                "kind": kind,
                "event": event,
                "old": old_d,
                "new": new_d,
                "ts": time.time(),
            })
            self._backlog.append(entry)
            if len(self._backlog) > self.backlog_size:
                del self._backlog[: len(self._backlog) - self.backlog_size]
            fp = faults.get_plane()
            for conn, watch_id in list(self._subs.get(kind, [])):
                if fp.enabled and fp.should("bus.drop_event"):
                    # a watch frame only "drops" when its pipe breaks —
                    # kill the subscriber's connection instead of
                    # silently skipping the push; the reconnect resumes
                    # from last_seq and replays this entry
                    conn.kill()
                    continue
                # the SAME cached payload goes to every subscriber
                conn.push(protocol.T_WATCH_EVENT, watch_id, entry)

        return on_event

    def _bookmark_loop(self) -> None:
        while not self._stop.wait(self.bookmark_interval):
            with self.api.locked():
                payload = _CachedPayload({"seq": self._seq, "ts": time.time()})
                for subs in self._subs.values():
                    for conn, watch_id in subs:
                        conn.push(protocol.T_BOOKMARK, watch_id, payload)

    # ---- connections ----

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            listener = self._listener  # stop() may null it concurrently
            if listener is None:
                return
            try:
                sock, peer = listener.accept()
            except OSError:
                return
            if self._stop.is_set():
                # accepted in the same instant stop() closed the
                # listener — drop it so no client talks to a dead server
                try:
                    sock.close()
                except OSError:
                    pass
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._adopt_conn(sock, peer)

    def _adopt_conn(self, sock, peer) -> None:
        """Register an accepted connection and start its writer and
        handler threads."""
        conn = _Conn(sock, peer)
        with self._conns_lock:
            self._conns.append(conn)
        self._update_codec_gauge()
        threading.Thread(
            target=conn.write_loop, name="vtpu-bus-writer", daemon=True
        ).start()
        threading.Thread(
            target=self._serve_conn, args=(conn,),
            name="vtpu-bus-handler", daemon=True,
        ).start()

    def _serve_conn(self, conn: _Conn) -> None:
        try:
            while not conn.closed:
                try:
                    mtype, corr_id, payload = protocol.recv_frame(conn.sock)
                except (ConnectionError, OSError):
                    return
                except ValueError as e:
                    conn.push(protocol.T_ERROR, 0, protocol.error_payload(
                        protocol.BusError(str(e))))
                    return
                if mtype == protocol.T_PING:
                    conn.push(protocol.T_PONG, corr_id, {})
                elif mtype == protocol.T_ADMIT_RESP:
                    waiter = conn.reviews.pop(corr_id, None)
                    if waiter is not None:
                        waiter["result"] = payload
                        waiter["event"].set()
                elif mtype == protocol.T_REQ:
                    # one thread per request, NOT inline: a create whose
                    # admission reviewer lives on THIS connection blocks
                    # waiting for a T_ADMIT_RESP that only this reader
                    # can receive — and a reviewer's own read-back calls
                    # must be servable while another request is parked
                    # in a review.  Each RemoteAPIServer caller thread is
                    # synchronous, so its requests never overlap
                    threading.Thread(
                        target=self._handle_request,
                        args=(conn, corr_id, payload),
                        name="vtpu-bus-request", daemon=True,
                    ).start()
                # other types are server→client only; ignore
        finally:
            self._cleanup_conn(conn)

    def _cleanup_conn(self, conn: _Conn) -> None:
        conn.kill()
        with self._conns_lock:
            if conn in self._conns:
                self._conns.remove(conn)
        self._update_codec_gauge()
        with self.api.locked():
            for watch_id, kind in conn.watches.items():
                subs = self._subs.get(kind, [])
                if (conn, watch_id) in subs:
                    subs.remove((conn, watch_id))
            conn.watches.clear()
            self._update_watcher_gauge()
        with self._admission_lock:
            for key, conns in list(self._admission.items()):
                if conn in conns:
                    conns.remove(conn)
                if not conns:
                    self._admission.pop(key, None)

    def _update_watcher_gauge(self) -> None:
        # requires-lock: self.api.locked()
        metrics.update_bus_server_watchers(sum(len(s) for s in self._subs.values()))

    def _update_codec_gauge(self) -> None:
        with self._conns_lock:
            counts = {protocol.CODEC_JSON: 0, protocol.CODEC_BINARY: 0}
            for c in self._conns:
                counts[c.codec] = counts.get(c.codec, 0) + 1
        for codec, count in counts.items():
            metrics.update_bus_codec_connections(codec, count)

    # ---- request dispatch ----

    def _handle_request(self, conn: _Conn, req_id: int, payload: dict) -> None:
        from volcano_tpu_torch import faults

        op = payload.get("op", "")
        fp = faults.get_plane()
        if fp.enabled and fp.should("bus.disconnect"):
            # server-side partition: the request dies with the
            # connection; the client fails fast with BusError, redials,
            # and its resync re-establishes every watch resume-or-relist
            conn.kill()
            return
        start = time.perf_counter()
        rec = trace.get_recorder()
        if rec.enabled and "cycle" in payload:
            # cross-process correlation: the client stamped the request
            # with its scheduling-cycle id (bus/remote.py)
            rec.event("bus:" + op, "bus", cycle=payload["cycle"], kind=payload.get("kind"))
        try:
            # server-side half of the cross-process span: parent is the
            # REMOTE caller's span (payload["span"], stamped by
            # bus/remote.py).  Ops without a context — or with the
            # flight recorder off — cost one enabled() check.
            if obs.enabled() and "span" in payload:
                with obs.adopt(
                    payload["span"], "bus:" + op, cat="bus",
                    args={"kind": payload.get("kind")} if payload.get("kind") else None,
                ):
                    result = self._execute(conn, req_id, payload, op)
            else:
                result = self._execute(conn, req_id, payload, op)
            if result is not None:
                conn.push(protocol.T_RESP, req_id, result)
            metrics.observe_bus_server_request(op, time.perf_counter() - start, "ok")
        except ApiError as e:
            conn.push(protocol.T_ERROR, req_id, protocol.error_payload(e))
            metrics.observe_bus_server_request(op, time.perf_counter() - start, "error")
        except Exception as e:  # noqa: BLE001 — report, keep serving
            log.error("bus request %s failed: %s", op, e)
            conn.push(protocol.T_ERROR, req_id, protocol.error_payload(ApiError(str(e))))
            metrics.observe_bus_server_request(op, time.perf_counter() - start, "error")

    #: ops that mutate (or linearizably read) the store — while this
    #: server is a replication FOLLOWER they are proxied to the leader,
    #: so a client connected anywhere keeps working; watches and lists
    #: stay local (informer-grade staleness, the k8s contract).  ``get``
    #: is routed too: read-modify-CAS loops (leader leases, queue
    #: updates) need their read against the write point or every CAS
    #: would spuriously conflict on follower lag.
    _LEADER_OPS = frozenset({
        "create", "update", "update_status", "delete",
        "cas_bind", "commit_batch", "txn_commit", "get",
        "bus_add_replica", "bus_remove_replica",
    })

    def _execute(self, conn: _Conn, req_id: int, payload: dict, op: str):
        api = self.api
        replica = self.replica
        if op == "bus_hello":
            # v8 codec negotiation — the codec is a property of THIS
            # connection.  The reply rides the freshly negotiated codec;
            # frames are self-describing, so the client decodes it
            # either way.
            offered = payload.get("codecs") or ()
            if protocol.HAS_BINARY and protocol.CODEC_BINARY in offered:
                conn.codec = protocol.CODEC_BINARY
            else:
                conn.codec = protocol.CODEC_JSON
            self._update_codec_gauge()
            return {"codec": conn.codec, "version": protocol.VERSION}
        if replica is not None and not replica.is_leader:
            if op in self._LEADER_OPS:
                if payload.get("proxied"):
                    # one-hop cap: our leader view is stale — tell the
                    # proxying peer instead of bouncing frames around;
                    # the hint carries OUR leader view so the caller's
                    # next dial is direct, not a blind rotation
                    raise NotLeaderError(
                        "not leader (proxied write refused)",
                        leader=replica.leader_url,
                    )
                return replica.proxy(payload)
            if op == "register_admission":
                raise NotLeaderError(
                    "not leader — register_admission must run at the "
                    f"leader ({replica.leader_url or 'unknown'})",
                    leader=replica.leader_url,
                )
        if op == "bus_status":
            return bus_status_payload(api, replica)
        if op == "repl_append":
            if replica is None:
                raise ApiError("replication not enabled")
            # the connection's codec decides HOW record payloads ship
            # (raw bytes on binary connections, text/base64 on JSON) —
            # see ReplicationCoordinator.pull for the byte-verbatim rule
            return replica.handle_append(payload, codec=conn.codec)
        if op == "repl_snapshot":
            if replica is None:
                raise ApiError("replication not enabled")
            return replica.handle_snapshot(payload)
        if op == "repl_commit":
            if replica is None:
                raise ApiError("replication not enabled")
            return replica.handle_commit(payload)
        if op == "repl_prevote":
            if replica is None:
                raise ApiError("replication not enabled")
            # served by ANY role: a pre-vote probe asks "would you
            # support my promotion", which followers (and the leader,
            # who always denies) answer locally
            return replica.handle_prevote(payload)
        if op == "bus_add_replica":
            if replica is None:
                raise ApiError("replication not enabled")
            return replica.add_replica(str(payload.get("url", "")))
        if op == "bus_remove_replica":
            if replica is None:
                raise ApiError("replication not enabled")
            return replica.remove_replica(str(payload.get("url", "")))
        if op == "create":
            obj = protocol.decode_obj(payload["object"])
            obj = self._remote_admission(obj.kind, "CREATE", obj)
            return {"object": protocol.encode_obj(api.create(obj))}
        if op == "update":
            obj = protocol.decode_obj(payload["object"])
            obj = self._remote_admission(obj.kind, "UPDATE", obj)
            return {"object": protocol.encode_obj(
                api.update(obj, expected_rv=payload.get("expected_rv")))}
        if op == "update_status":
            obj = protocol.decode_obj(payload["object"])
            return {"object": protocol.encode_obj(api.update_status(obj))}
        if op == "get":
            obj = api.get(payload["kind"], payload["namespace"], payload["name"])
            return {"object": protocol.encode_obj(obj)}
        if op == "list":
            objs = api.list(payload["kind"], payload.get("namespace"))
            return {"objects": [protocol.encode_obj(o) for o in objs]}
        if op == "delete":
            old = api.delete(payload["kind"], payload["namespace"], payload["name"])
            return {"object": protocol.encode_obj(old)}
        if op == "commit_batch":
            # the coalesced bind/commit frame (protocol v2): N binds +
            # evictions + audit events + status writebacks applied as
            # ONE store transaction with one watch-notification flush
            results = api.commit_batch(
                binds=payload.get("binds", ()),
                evicts=payload.get("evicts", ()),
                events=payload.get("events", ()),
                conditions=payload.get("conditions", ()),
                pod_groups=[
                    protocol.decode_obj(d)
                    for d in payload.get("pod_groups", ())
                ],
            )
            return {"results": results}
        if op == "cas_bind":
            # v4: one optimistic binding write — bind iff still unbound
            # and the resourceVersion matches (the federation spillover
            # primitive; conflicts detected at the store, Omega-style)
            obj = api.cas_bind(
                payload["namespace"], payload["name"], payload["hostname"],
                expected_rv=payload.get("expected_rv"),
            )
            return {"object": protocol.encode_obj(obj)}
        if op == "txn_commit":
            # v6: the atomic multi-cas_bind transaction — every
            # precondition checked before any effect, all binds applied
            # under one store lock hold (a persistent store logs them as
            # ONE WAL record), per-item conflict results on abort.  The
            # cross-shard gang-assembly primitive.
            result = api.txn_commit(payload.get("binds", ()))
            return {
                "committed": result["committed"],
                "results": result["results"],
                "objects": [
                    protocol.encode_obj(o) for o in result.get("objects", ())
                ],
            }
        if op == "watch":
            self._handle_watch(conn, req_id, payload)
            return None  # responses pushed inline for ordering
        if op == "watch_batch":
            # v3: identical watch semantics, but the connection opts into
            # coalesced T_WATCH_BATCH delivery.  Flag first: the flip
            # must be visible before the establishment pushes any event.
            conn.batch_watch = True
            self._handle_watch(conn, req_id, payload)
            return None
        if op == "unwatch":
            watch_id = int(payload["watch_id"])
            with self.api.locked():
                kind = conn.watches.pop(watch_id, None)
                if kind is not None:
                    subs = self._subs.get(kind, [])
                    subs[:] = [s for s in subs if s != (conn, watch_id)]
                    self._update_watcher_gauge()
            return {"unwatched": kind is not None}
        if op == "register_admission":
            key = (payload["kind"], payload["operation"])
            with self._admission_lock:
                conns = self._admission.setdefault(key, [])
                if conn not in conns:
                    conns.append(conn)
            return {"registered": True}
        raise ApiError(f"unknown bus op {op!r}")

    # ---- remote admission ----

    def _remote_admission(self, kind: str, operation: str, obj):
        """Run registered remote reviews in order, mutating as we go.
        Runs BEFORE the store transaction (k8s webhook ordering) so a
        webhook that reads back through the bus cannot deadlock."""
        with self._admission_lock:
            conns = list(self._admission.get((kind, operation), ()))
        if not conns:
            return obj
        data = protocol.encode_obj(obj)
        # the review runs in the WEBHOOK daemon's process — forward the
        # span context so its admission:review span parents into this
        # request's trace (old webhook clients ignore the key)
        span_ctx = obs.current_wire()
        for conn in conns:
            if conn.closed:
                continue
            with self._review_lock:
                self._review_id += 1
                review_id = self._review_id
            waiter = {"event": threading.Event(), "result": None}
            conn.reviews[review_id] = waiter
            review = {"kind": kind, "operation": operation, "object": data}
            if span_ctx is not None:
                review["span"] = span_ctx
            if not conn.push(protocol.T_ADMIT_REQ, review_id, review):
                continue
            if not waiter["event"].wait(self.admission_timeout):
                conn.reviews.pop(review_id, None)
                raise AdmissionError(
                    f"admission review for {kind}/{operation} timed out"
                )
            result = waiter["result"]
            if result is None:
                # reviewer died mid-flight — failure-open, like a webhook
                # with failurePolicy: Ignore whose endpoint vanished
                log.error("admission reviewer for %s/%s disconnected mid-review",
                          kind, operation)
                continue
            if not result.get("allowed", False):
                raise AdmissionError(result.get("message") or
                                     "denied by admission webhook")
            if result.get("object") is not None:
                data = result["object"]
        return protocol.decode_obj(data)

    # ---- watch ----

    def _handle_watch(self, conn: _Conn, req_id: int, payload: dict) -> None:
        """Establish a watch.  Everything happens under the store lock so
        the response, any backlog replay, and the live subscription form
        one gapless, duplicate-free sequence."""
        kind = payload["kind"]
        if kind not in protocol.KINDS:
            raise ApiError(f"unknown kind {kind!r}")
        watch_id = int(payload["watch_id"])
        resume_seq = payload.get("resume_seq")
        from volcano_tpu_torch import faults

        fp = faults.get_plane()
        with self.api.locked():
            if resume_seq is not None:
                oldest_covered = self._seq - len(self._backlog)
                force_relist = fp.enabled and fp.should("bus.force_relist")
                if (
                    force_relist
                    or payload.get("epoch") != self.epoch
                    or resume_seq < oldest_covered
                ):
                    # 410 Gone: this incarnation cannot prove the client
                    # missed nothing — a fresh list is required
                    conn.push(protocol.T_RESP, req_id, {
                        "resumed": False, "epoch": self.epoch, "seq": self._seq,
                    })
                    return
                conn.push(protocol.T_RESP, req_id, {
                    "resumed": True, "epoch": self.epoch, "seq": self._seq,
                })
                for entry in self._backlog:
                    if (
                        entry.obj["seq"] > resume_seq
                        and entry.obj["kind"] == kind
                    ):
                        conn.push(protocol.T_WATCH_EVENT, watch_id, entry)
            else:
                initial = [protocol.encode_obj(o) for o in self.api.list(kind)]
                conn.push(protocol.T_RESP, req_id, {
                    "resumed": True, "epoch": self.epoch, "seq": self._seq,
                    "initial": initial,
                })
            # re-establishment on a live connection replaces the old
            # subscription — a watch id is never subscribed twice
            subs = self._subs.setdefault(kind, [])
            subs[:] = [s for s in subs if s != (conn, watch_id)]
            subs.append((conn, watch_id))
            conn.watches[watch_id] = kind
            self._update_watcher_gauge()
