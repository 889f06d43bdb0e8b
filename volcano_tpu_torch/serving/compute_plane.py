"""Compute-plane boundary: a versioned wire protocol + sidecar serving
the device kernels over a Unix socket.

The port of ``volcano_tpu/serving/compute_plane.py``; its frames are
byte for byte the reference's, so either package's client talks to
either package's server.  The control plane (cache, session, actions)
packs a session and ships it; the compute plane (this module's server,
``python -m volcano_tpu_torch.cmd.compute_plane``) owns the GPU and runs
the packed kernels:

  * wire format: length-prefixed frames, ``VTPU`` magic + u16 version +
    u16 message type + u32 payload length.  Payloads are a JSON meta
    header (scalars, flags, field manifest) + raw little-endian array
    bytes in manifest order — deterministic, versioned, and free of
    pickle (untrusted peers cannot execute code).
  * ``ComputePlaneServer``: accepts connections, deserializes a
    PackedSnapshot / PreemptPacked, runs ``run_packed_auto`` /
    ``run_preempt_auto`` on its device (``cuda`` unless named; the CUDA
    session and preempt kernels), returns the assignment /
    (evicted, pipelined).  A snapshot off the wire carries the wire's
    fields only: no stager staged it, so the session kernel puts its
    planes on the card whole (``session_kernel.run_packed_cuda``).
  * ``ComputePlaneClient``: ships a session — a full frame, or a delta
    frame against the revision the server acknowledged — with
    ``health()`` probing and hard timeouts.  Callers (ops/executor.py)
    fall back to the in-process kernel when the sidecar is down, counted
    and logged.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import socket
import socketserver
import struct
import threading
import time
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from volcano_tpu_torch import faults
from volcano_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

MAGIC = b"VTPU"
VERSION = 1

T_ALLOC_REQ = 1
T_ALLOC_RESP = 2
T_PREEMPT_REQ = 3
T_PREEMPT_RESP = 4
T_PING = 5
T_PONG = 6
T_ERROR = 7
#: delta frame: only the rows that changed since the session revision
#: the server already holds (see ops/pack_cache.PackDelta)
T_ALLOC_DELTA_REQ = 8
#: server's "I don't hold your base revision" — client re-sends full
T_NEED_FULL = 9

_HEADER = struct.Struct("<4sHHI")

#: PackedSnapshot array fields shipped across the boundary (uids/names
#: stay host-side — assignments are positional)
_SNAP_ARRAYS = (
    "tolerance", "task_resreq", "task_job", "task_sel_bits",
    "task_tol_bits", "node_idle", "node_used", "node_alloc",
    "node_label_bits", "node_taint_bits", "node_ok", "node_task_count",
    "node_max_tasks", "job_min_available", "job_ready_count",
    "task_has_preferences",
)
#: scalar fields, with the plain Python type each is written as (a numpy
#: scalar would not encode)
_SNAP_META = (("n_tasks", int), ("n_nodes", int), ("n_jobs", int),
              ("needs_host_validation", bool), ("memory_exact", bool))


def _pack_arrays(meta: Dict, arrays: Dict[str, np.ndarray]) -> bytes:
    manifest = []
    blobs = []
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        manifest.append([name, str(arr.dtype), list(arr.shape)])
        blobs.append(arr.tobytes())
    head = json.dumps({"meta": meta, "arrays": manifest}).encode()
    return struct.pack("<I", len(head)) + head + b"".join(blobs)


def _unpack_arrays(payload: bytes) -> Tuple[Dict, Dict[str, np.ndarray]]:
    (hlen,) = struct.unpack_from("<I", payload, 0)
    head = json.loads(payload[4 : 4 + hlen].decode())
    arrays: Dict[str, np.ndarray] = {}
    off = 4 + hlen
    for name, dtype, shape in head["arrays"]:
        dt = np.dtype(dtype)
        n = int(np.prod(shape)) if shape else 1
        nbytes = n * dt.itemsize
        arrays[name] = np.frombuffer(
            payload[off : off + nbytes], dtype=dt
        ).reshape(shape).copy()
        off += nbytes
    return head["meta"], arrays


def _snap_meta(snap) -> Dict:
    meta = {k: kind(getattr(snap, k)) for k, kind in _SNAP_META}
    meta["resource_names"] = list(snap.resource_names)
    return meta


def serialize_snapshot(snap, explain: bool = False) -> bytes:
    meta = _snap_meta(snap)
    # warm-session identity: lets the server retain the snapshot so the
    # NEXT session can ship a delta frame.  Old servers ignore the keys.
    if getattr(snap, "cache_key", None):
        meta["cache_key"] = snap.cache_key
        meta["rev"] = int(snap.rev)
    if explain:
        # ask the server to return reason counts for unplaced tasks
        # alongside the assignment (ignored by pre-explain servers)
        meta["explain"] = True
    arrays = {k: getattr(snap, k) for k in _SNAP_ARRAYS}
    return _pack_arrays(meta, arrays)


def deserialize_snapshot(payload: bytes):
    meta, arrays = _unpack_arrays(payload)
    return _snapshot_from(meta, arrays), meta


def _snapshot_from(meta: Dict, arrays: Dict[str, np.ndarray]):
    from volcano_tpu_torch.ops.packing import PackedSnapshot

    snap = PackedSnapshot()
    for k, _ in _SNAP_META:
        setattr(snap, k, meta[k])
    snap.resource_names = list(meta["resource_names"])
    for k, v in arrays.items():
        setattr(snap, k, v)
    return snap


def serialize_delta(snap, explain: bool = False) -> bytes:
    """Delta frame payload: scalar meta + per-plane changes.  A plane is
    shipped as ``full__<name>`` (replace), or as ``idx__<name>`` +
    ``row__<name>`` (scatter into the server-held copy); planes absent
    from the frame are unchanged since ``base_rev``."""
    delta = snap.delta
    meta = _snap_meta(snap)
    meta["cache_key"] = snap.cache_key
    meta["rev"] = int(snap.rev)
    meta["base_rev"] = int(delta.base_rev)
    if explain:
        meta["explain"] = True
    arrays: Dict[str, np.ndarray] = {}
    for name in _SNAP_ARRAYS:
        if name not in delta.planes:
            continue
        arr = getattr(snap, name)
        rows = delta.planes[name]
        if rows is None:
            arrays["full__" + name] = arr
        elif rows.size:
            arrays["idx__" + name] = rows.astype(np.int64)
            arrays["row__" + name] = np.ascontiguousarray(arr[rows])
    return _pack_arrays(meta, arrays)


def apply_delta(base_snap, meta: Dict, arrays: Dict[str, np.ndarray]):
    """Server-side inverse of serialize_delta: a NEW snapshot sharing
    unchanged planes with ``base_snap`` (never mutated in place, so the
    stored base stays valid if the kernel later fails)."""
    snap = _snapshot_from(meta, {})
    for name in _SNAP_ARRAYS:
        full = arrays.get("full__" + name)
        if full is not None:
            setattr(snap, name, full)
            continue
        arr = getattr(base_snap, name)
        idx = arrays.get("idx__" + name)
        if idx is not None:
            arr = arr.copy()
            arr[idx] = arrays["row__" + name]
        setattr(snap, name, arr)
    return snap


_PK_ARRAYS = (
    "node_fi0", "vic_resreq", "vic_node", "vic_job", "job_prio",
    "job_min_avail", "job_ready0", "job_waiting0", "job_queue",
    "job_ptask_start", "job_ptask_end", "schedule",
    # optional (None outside DRF sessions) — the manifest only lists
    # arrays that are present
    "vic_uid_pos", "vic_evictable", "job_alloc0", "total_res",
    "total_lanes",
)
_PK_META = ("n_victims", "n_jobs")
_PK_FLAGS = ("use_prio", "use_gang", "use_conf", "use_drf")


def serialize_preempt(pk) -> bytes:
    base = serialize_snapshot(pk.base)
    meta = {k: int(getattr(pk, k)) for k in _PK_META}
    for k in _PK_FLAGS:
        meta[k] = bool(getattr(pk, k))
    arrays = {
        k: getattr(pk, k)
        for k in _PK_ARRAYS
        if getattr(pk, k) is not None
    }
    extra = _pack_arrays(meta, arrays)
    return struct.pack("<I", len(base)) + base + extra


def deserialize_preempt(payload: bytes):
    from volcano_tpu_torch.ops.preempt_pack import PreemptPacked

    (blen,) = struct.unpack_from("<I", payload, 0)
    base, _ = deserialize_snapshot(payload[4 : 4 + blen])
    meta, arrays = _unpack_arrays(payload[4 + blen :])
    pk = PreemptPacked(base=base)
    for k in _PK_META:
        setattr(pk, k, meta[k])
    for k in _PK_FLAGS:
        # absent in frames from older peers → dataclass defaults (the
        # classic triple), matching their pack-time guarantees
        if k in meta:
            setattr(pk, k, bool(meta[k]))
    for k, v in arrays.items():
        setattr(pk, k, v)
    # positional aliases the executors index with (uids stay host-side)
    pk.vic_uids = [str(i) for i in range(pk.n_victims)]
    pk.vic_names = list(pk.vic_uids)
    pk.ptask_uids = [str(i) for i in range(base.n_tasks)]
    pk.node_names = [str(i) for i in range(base.n_nodes)]
    pk.job_uids = [str(i) for i in range(pk.n_jobs)]
    return pk


def _send_frame(sock: socket.socket, mtype: int, payload: bytes) -> None:
    sock.sendall(_HEADER.pack(MAGIC, VERSION, mtype, len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        buf.extend(chunk)
    return bytes(buf)


def _recv_frame(sock: socket.socket) -> Tuple[int, bytes]:
    head = _recv_exact(sock, _HEADER.size)
    magic, version, mtype, length = _HEADER.unpack(head)
    if magic != MAGIC:
        raise ValueError("bad magic")
    if version != VERSION:
        raise ValueError(f"unsupported compute-plane version {version}")
    return mtype, _recv_exact(sock, length)


#: snapshots the server holds, one a client cache key (LRU)
_SESSION_STORE_SIZE = 4


class _SessionStore:
    """Server-held snapshots keyed by the client's PackCache identity, so
    steady-state warm sessions ship delta frames instead of full
    snapshots.  Small LRU — one live scheduler per key, a handful of
    keys per sidecar.  The snapshots are numpy planes, as in the
    reference: each session puts them on the device whole."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: "Dict[str, Tuple[int, object]]" = {}  # guarded-by: self._lock

    def put(self, key: str, rev: int, snap) -> None:
        with self._lock:
            self._entries.pop(key, None)
            if len(self._entries) >= _SESSION_STORE_SIZE:
                self._entries.pop(next(iter(self._entries)))
            self._entries[key] = (rev, snap)

    def get(self, key: str):
        with self._lock:
            return self._entries.get(key)


_session_store = _SessionStore()


#: the server's latest requests, oldest first: ``n`` (a sequence number),
#: ``type`` ("full", "delta" or "preempt"), and host-clock ms from the
#: request read off the socket: ``decode_ms`` (deserialize, or the delta
#: applied to the held snapshot), ``put_ms`` (the session kernel's
#: operands ready on the device, its full put included), ``kernel_ms``
#: (the launches and the fetch), ``reply_ms`` (the response built, with
#: any explain reduction).  A request is recorded before its response
#: is sent, so a client that has its answer finds it here.  A preempt
#: request reports its put inside ``kernel_ms`` and no ``put_ms``.
recent_requests: "collections.deque" = collections.deque(maxlen=16)
_request_seq = itertools.count(1)


def _record_request(kind: str, t_read: float, t_decoded: float, t_run: float,
                    t_sent: float) -> None:
    from volcano_tpu_torch.ops import dispatch, session_kernel

    rec = dict(n=next(_request_seq), type=kind, decode_ms=(t_decoded - t_read) * 1e3,
               put_ms=None, kernel_ms=(t_run - t_decoded) * 1e3,
               reply_ms=(t_sent - t_run) * 1e3)
    if kind != "preempt" and dispatch.last_executor() == "cuda":
        rec["put_ms"] = session_kernel.last_session_stats.get("prepare_ms")
        rec["kernel_ms"] -= rec["put_ms"] or 0.0
    recent_requests.append(rec)


def _alloc_response(snap, meta: Dict, assignment: np.ndarray,
                    device: torch.device) -> bytes:
    """T_ALLOC_RESP payload.  When the request asked for an explanation
    (``meta["explain"]``) and a valid task went unplaced, the per-task
    reason-count matrix, reduced on the server's device, rides back
    alongside the assignment — no extra round trip."""
    arrays = {"assignment": assignment}
    if meta.get("explain"):
        unplaced = np.nonzero(assignment[: snap.n_tasks] < 0)[0]
        if unplaced.size:
            from volcano_tpu_torch.ops.explain import run_explain

            arrays["reason_counts"] = run_explain(
                snap, task_rows=unplaced, device=device
            ).counts
    return _pack_arrays({}, arrays)


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):  # one connection, many requests
        device = self.server.device
        while True:
            try:
                mtype, payload = _recv_frame(self.request)
                t_read = time.perf_counter()
            except (ConnectionError, OSError):
                return
            except ValueError as e:
                _send_frame(self.request, T_ERROR, str(e).encode())
                return
            fp = faults.get_plane()
            if fp.enabled and mtype != T_PING:
                # named seams of the sidecar failure modes, evaluated on
                # real requests only (health probes stay honest — a
                # crashed sidecar's probe genuinely fails, an injected
                # one must not fake probe results)
                if fp.should("compute.crash"):
                    # sidecar dies mid-session: the peer sees a closed
                    # socket with its request unanswered
                    try:
                        self.request.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    self.request.close()
                    return
                if fp.should("compute.corrupt"):
                    # garbage on the wire: the client's frame parser
                    # rejects the magic and tears the connection down
                    try:
                        self.request.sendall(b"GARBAGE-NOT-A-VTPU-FRAME")
                    except OSError:
                        return
                    continue
                if mtype == T_ALLOC_DELTA_REQ and fp.should("compute.need_full"):
                    # forced session loss: pretend the base revision is
                    # gone so the client re-handshakes with a full frame
                    _send_frame(self.request, T_NEED_FULL, b"")
                    continue
            try:
                if mtype == T_PING:
                    _send_frame(self.request, T_PONG, b"")
                elif mtype == T_ALLOC_REQ:
                    from volcano_tpu_torch.ops.dispatch import run_packed_auto

                    snap, meta = deserialize_snapshot(payload)
                    t_decoded = time.perf_counter()
                    assignment = run_packed_auto(snap, device=device)
                    t_run = time.perf_counter()
                    if meta.get("cache_key"):
                        _session_store.put(
                            meta["cache_key"], int(meta["rev"]), snap
                        )
                    resp = _alloc_response(snap, meta, assignment, device)
                    _record_request("full", t_read, t_decoded, t_run, time.perf_counter())
                    _send_frame(self.request, T_ALLOC_RESP, resp)
                elif mtype == T_ALLOC_DELTA_REQ:
                    from volcano_tpu_torch.ops.dispatch import run_packed_auto

                    meta, arrays = _unpack_arrays(payload)
                    held = _session_store.get(meta["cache_key"])
                    if held is None or held[0] != int(meta["base_rev"]):
                        _send_frame(self.request, T_NEED_FULL, b"")
                        continue
                    snap = apply_delta(held[1], meta, arrays)
                    t_decoded = time.perf_counter()
                    assignment = run_packed_auto(snap, device=device)
                    t_run = time.perf_counter()
                    _session_store.put(
                        meta["cache_key"], int(meta["rev"]), snap
                    )
                    resp = _alloc_response(snap, meta, assignment, device)
                    _record_request("delta", t_read, t_decoded, t_run, time.perf_counter())
                    _send_frame(self.request, T_ALLOC_RESP, resp)
                elif mtype == T_PREEMPT_REQ:
                    from volcano_tpu_torch.ops.dispatch import run_preempt_auto

                    pk = deserialize_preempt(payload)
                    t_decoded = time.perf_counter()
                    ev, pipe = run_preempt_auto(pk, device=device)
                    t_run = time.perf_counter()
                    resp = _pack_arrays({}, {"evicted": np.asarray(ev),
                                             "pipelined": np.asarray(pipe)})
                    _record_request("preempt", t_read, t_decoded, t_run, time.perf_counter())
                    _send_frame(self.request, T_PREEMPT_RESP, resp)
                else:
                    _send_frame(
                        self.request, T_ERROR, f"unknown type {mtype}".encode()
                    )
            except Exception as e:  # noqa: BLE001 — report, keep serving
                log.error("compute-plane request failed: %s", e)
                try:
                    _send_frame(self.request, T_ERROR, str(e).encode())
                except OSError:
                    return


def serving_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device a compute plane serves on: ``cuda`` unless ``device``
    names another; raises when that is ``cuda`` and no GPU is present."""
    from volcano_tpu_torch.ops.kernels import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the compute plane serves on cuda "
                           "unless given device='cpu'")
    return dev


class ComputePlaneServer:
    """Threaded Unix-socket sidecar serving the device kernels on
    ``device``: ``cuda`` unless the caller names another (``"cpu"``
    runs the plain PyTorch versions).  :meth:`start` raises when no GPU
    is present and none was named, so a sidecar never serves from the
    CPU without being asked to.  Each connection gets a thread; their
    kernel launches go onto the device's default stream."""

    def __init__(self, socket_path: str,
                 device: Optional[Union[str, torch.device]] = None):
        self.socket_path = socket_path
        self.device = device
        self._server: Optional[socketserver.ThreadingUnixStreamServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "ComputePlaneServer":
        dev = serving_device(self.device)
        try:
            os.unlink(self.socket_path)
        except FileNotFoundError:
            pass
        self._server = socketserver.ThreadingUnixStreamServer(
            self.socket_path, _Handler
        )
        self._server.daemon_threads = True
        self._server.device = dev
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="vtpu-compute-plane",
            daemon=True,
        )
        self._thread.start()
        log.info("compute plane serving on %s (%s)", self.socket_path, dev)
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None


class ComputePlaneClient:
    """Client side of the boundary; one persistent connection with
    reconnect-on-error, hard timeouts, and a cheap health probe."""

    def __init__(self, socket_path: str, timeout: float = 120.0):
        # default above a cold sidecar's first session, which builds the
        # kernel library (cmd/compute_plane.py --warmup avoids it)
        self.socket_path = socket_path
        self.timeout = timeout
        self._sock: Optional[socket.socket] = None  # guarded-by: self._lock
        self._lock = threading.RLock()
        #: session revision the SERVER is known to hold, per cache_key —
        #: a delta frame is only worth sending when the server's copy is
        #: exactly the delta's base revision.  Guarded by _state_lock
        #: together with _session_gen: close() bumps the generation, so
        #: an allocate() the cycle watchdog abandoned (which may
        #: complete AFTER a close cleared the acks) cannot re-insert an
        #: ack the restarted sidecar does not hold.
        self._acked: Dict[str, int] = {}  # guarded-by: self._state_lock
        self._session_gen = 0  # guarded-by: self._state_lock
        self._state_lock = threading.Lock()
        #: set after an "unknown type" error — an old sidecar; stop
        #: attempting delta frames until reconnect
        self._delta_unsupported = False
        #: reason counts from the last allocate(explain=True) response —
        #: None when everything placed or the server predates explain
        self.last_reason_counts: Optional[np.ndarray] = None

    def _connect(self) -> socket.socket:
        # requires-lock: self._lock
        if self._sock is None:
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.settimeout(self.timeout)
            try:
                s.connect(self.socket_path)
            except OSError:
                s.close()
                raise
            self._sock = s
        return self._sock

    def _roundtrip(self, mtype: int, payload: bytes) -> Tuple[int, bytes]:
        fp = faults.get_plane()
        with self._lock:
            try:
                if fp.enabled and mtype != T_PING and fp.should("compute.timeout"):
                    # the timeout failure mode without waiting the full
                    # timeout out: same exception type, same recovery
                    raise socket.timeout("fault-injected compute-plane timeout")
                sock = self._connect()
                _send_frame(sock, mtype, payload)
                return _recv_frame(sock)
            except Exception:
                self.close()
                raise

    def health(self) -> bool:
        try:
            mtype, _ = self._roundtrip(T_PING, b"")
            return mtype == T_PONG
        except Exception:  # noqa: BLE001
            return False

    def _ack(self, gen: int, key: str, rev: int) -> None:
        """Record the server-held revision — only while the connection
        generation the round trip ran under is still current (a close()
        in between means the peer that acked is gone)."""
        with self._state_lock:
            if self._session_gen == gen:
                self._acked[key] = rev

    def allocate(self, snap, explain: bool = False) -> np.ndarray:
        key = getattr(snap, "cache_key", None)
        self.last_reason_counts = None
        with self._state_lock:
            gen = self._session_gen
            acked = self._acked.get(key) if key else None
        if (
            key
            and snap.delta is not None
            and not self._delta_unsupported
            and acked == snap.delta.base_rev
        ):
            mtype, payload = self._roundtrip(
                T_ALLOC_DELTA_REQ, serialize_delta(snap, explain=explain)
            )
            if mtype == T_ALLOC_RESP:
                self._ack(gen, key, snap.rev)
                _, arrays = _unpack_arrays(payload)
                self.last_reason_counts = arrays.get("reason_counts")
                return arrays["assignment"]
            if mtype == T_ERROR:
                msg = payload.decode()
                if "unknown type" not in msg:
                    raise RuntimeError(f"compute plane: {msg}")
                # pre-delta sidecar: remember and fall through to full
                self._delta_unsupported = True
                log.info("compute plane %s has no delta support", self.socket_path)
            # T_NEED_FULL (or unsupported) → full frame below re-seeds
        mtype, payload = self._roundtrip(
            T_ALLOC_REQ, serialize_snapshot(snap, explain=explain)
        )
        if mtype == T_ERROR:
            raise RuntimeError(f"compute plane: {payload.decode()}")
        if key:
            self._ack(gen, key, snap.rev)
        _, arrays = _unpack_arrays(payload)
        self.last_reason_counts = arrays.get("reason_counts")
        return arrays["assignment"]

    def preempt(self, pk) -> Tuple[np.ndarray, np.ndarray]:
        mtype, payload = self._roundtrip(T_PREEMPT_REQ, serialize_preempt(pk))
        if mtype == T_ERROR:
            raise RuntimeError(f"compute plane: {payload.decode()}")
        _, arrays = _unpack_arrays(payload)
        return arrays["evicted"].astype(bool), arrays["pipelined"]

    def close(self) -> None:
        # an RLock, so the error path inside _roundtrip (which already
        # holds it) and external callers (the executor's mark_unhealthy)
        # both close safely
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                finally:
                    self._sock = None
                    # the next connection may reach a restarted
                    # (upgraded) sidecar — re-probe delta support
                    self._delta_unsupported = False
        # Session-loss recovery: a closed connection means the next peer
        # may be a RESTARTED sidecar holding no session store.  Forget
        # every acked revision so the re-handshake ships a full frame
        # instead of trusting state that died with the old process.  The
        # generation bump makes the clear stick: a watchdog-abandoned
        # allocate() completing after this close cannot re-insert its
        # (now dead) ack.
        with self._state_lock:
            self._session_gen += 1
            self._acked.clear()
