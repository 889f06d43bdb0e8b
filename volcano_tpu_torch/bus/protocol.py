"""Bus wire protocol: framing, object serde, and error mapping.

A copy of ``volcano_tpu/bus/protocol.py``: the same header, versions,
message types, codecs and error names, so a port peer and a JAX peer
speak to each other byte for byte.  ``KINDS`` holds every kind of the
reference, in its order, and ``OP_VERSIONS`` every op of the reference.

The out-of-process bus generalizes the compute-plane boundary
(serving/compute_plane.py) from "ship one packed snapshot" to "be the
API server": the same length-prefixed, versioned frame discipline, but
carrying JSON-encoded API objects and watch streams over TCP.

Frame layout (little-endian):

    ``VBUS`` magic + u16 version + u16 message type + u32 correlation id
    + u32 payload length, then a JSON payload.

The correlation id demultiplexes one duplex connection: for T_REQ /
T_RESP / T_ERROR it is the client-assigned request id; for watch frames
(T_WATCH_EVENT / T_BOOKMARK) it is the client-assigned watch id; for
admission review frames (T_ADMIT_REQ / T_ADMIT_RESP) it is the
server-assigned review id.  Payloads are pure JSON — like the compute
plane, the wire is free of pickle so an untrusted peer cannot execute
code.

Objects cross the wire via the same dataclass round-trip the in-process
store uses for ``clone()`` (apis/serde), so a remote create/get is
byte-equivalent to an in-process one.  ``KINDS`` is the decode registry:
every K8sObject kind the store can hold.
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Dict, List, Optional, Tuple

try:  # optional: binary framing needs msgpack; JSON framing never does
    import msgpack  # type: ignore[import-not-found]
except ImportError:  # pragma: no cover - environment without msgpack
    msgpack = None

#: whether this build can speak the v8 binary codec at all.  When
#: msgpack is absent the hello negotiation simply never offers binary,
#: so every connection (and the WAL) stays JSON — no feature flag, no
#: error path.
HAS_BINARY = msgpack is not None

from volcano_tpu_torch.apis import batch, core, scheduling, scheme
from volcano_tpu_torch.apis import bus as apis_bus
from volcano_tpu_torch.client.apiserver import (
    AdmissionError,
    AlreadyExistsError,
    ApiError,
    ConflictError,
    NotFoundError,
)

MAGIC = b"VBUS"
#: v2 adds the coalesced ``commit_batch`` request op (one frame carrying
#: N binds + evictions + audit events + status writebacks, applied as a
#: single store transaction).  v3 adds the ``watch_batch`` op: a watch
#: established through it may receive coalesced ``T_WATCH_BATCH``
#: frames (N watch events in one frame, batched on the server's writer
#: thread) instead of one ``T_WATCH_EVENT`` frame per object — the
#: README known-gap on watch fan-out under commit_batch bursts.  v4
#: adds the ``cas_bind`` op: one optimistic-concurrency binding write
#: (bind iff the pod is still unbound and its resourceVersion matches)
#: — the federation spillover primitive, one round trip instead of a
#: get + CAS update.  v5 adds the replicated-bus surface: ``bus_status``
#: (role / leader / term / WAL + replication introspection — the
#: ``vtctl bus status`` op) and the leader/follower log-shipping ops
#: ``repl_append`` / ``repl_snapshot`` / ``repl_commit``
#: (bus/replication.py).  v6 adds ``txn_commit``: an atomic
#: multi-object transaction — N ``cas_bind``s checked and applied
#: all-or-nothing under one store lock hold, logged as ONE WAL record
#: and replicated as a unit — the cross-shard gang-assembly primitive
#: (federation/broker.py).  The frame LAYOUT is unchanged throughout,
#: so frames are STAMPED with MIN_VERSION — a v1 peer accepts every
#: frame at the framing layer, and a newer client talking to an older
#: server detects the unknown op from the typed error and falls back
#: (per-object binds for ``commit_batch``; a plain ``watch`` for
#: ``watch_batch``; get + CAS ``update`` for ``cas_bind``; a degraded
#: ``role: unknown`` payload for ``bus_status`` — bus/remote.py.  An
#: old peer cannot be a replica at all, so the repl ops have no
#: fallback to degrade to: a replica group must be version-homogeneous
#: and a follower simply logs and retries against an old leader.
#: ``txn_commit``'s fallback is an ABORT, never a per-object replay: a
#: v5 peer cannot apply half a gang atomically, so the client reports
#: the whole transaction unsupported and the gang broker stays in the
#: honest pre-v6 refusal mode — version skew costs the cross-shard
#: gang feature, never the no-partial-gang invariant).  v7 adds the
#: elastic-membership surface: ``repl_prevote`` (a candidate probes
#: whether peers would support its promotion BEFORE incrementing the
#: term — a partitioned rejoiner can no longer depose a healthy
#: leader) and the dynamic-membership ops ``bus_add_replica`` /
#: ``bus_remove_replica`` (one replica at a time through a
#: WAL-recorded, replicated membership-config record).  A pre-v7 peer
#: answers ``unknown bus op``: the membership ops then fail with a
#: typed "dynamic membership unsupported" error (no fallback CAN exist
#: — an old peer has no config log to record the change in), and a
#: pre-vote that cannot be asked counts as a denial (safety over
#: liveness; an old peer cannot be a v7 replica anyway).  v8 adds the
#: binary codec: ``bus_hello`` negotiates a per-connection body
#: encoding (msgpack) and is the FIRST version to change what a frame
#: carries — so v8 is also the first version a frame is ever stamped
#: with.  The stamp is per frame, not per connection: JSON bodies ride
#: frames stamped MIN_VERSION exactly as before (a v1 peer accepts
#: them), msgpack bodies ride frames stamped 8, and the receiver
#: decodes by the stamp alone.  That makes the hello race-free — the
#: hello response is decodable whichever codec it arrives in — and
#: keeps the v1-fallback discipline intact: binary frames are sent
#: ONLY after the peer answered the hello with ``binary``, and a
#: pre-v8 peer answers ``unknown bus op`` to the hello itself, which
#: degrades the connection to JSON (never an error).
#: VERSION is the protocol revision this build speaks; receivers
#: accept [MIN_VERSION, VERSION].
VERSION = 8
#: oldest frame version this build still decodes — and the version
#: JSON-body frames carry, since their layout has not changed since v1.
#: Binary-body frames are stamped VERSION: the body encoding IS the
#: layout change, and the stamp is how the receiver tells them apart.
MIN_VERSION = 1

#: per-connection body codecs the hello exchange negotiates
CODEC_JSON = "json"
CODEC_BINARY = "binary"

T_REQ = 1            # client → server: one store operation
T_RESP = 2           # server → client: success payload for a T_REQ
T_ERROR = 3          # server → client: typed failure for a T_REQ
T_WATCH_EVENT = 4    # server → client: one watch event (id = watch id)
T_BOOKMARK = 5       # server → client: watch progress marker
# 6 reserved (was an unused stream-lost signal; 410-Gone is expressed
# as the watch response's ``resumed: false`` instead)
T_PING = 7
T_PONG = 8
T_ADMIT_REQ = 9      # server → client: admission review request
T_ADMIT_RESP = 10    # client → server: admission review verdict
#: server → client: N coalesced watch events in one frame.  Payload is
#: ``{"events": [{"watch_id": w, ...entry}, ...]}`` — each entry is
#: exactly a T_WATCH_EVENT payload plus the watch id it belongs to (one
#: connection multiplexes many watches, and the correlation-id slot can
#: carry only one).  Sent ONLY on watches established via the
#: ``watch_batch`` op, so a v1/v2 peer never sees the type.
T_WATCH_BATCH = 11

_HEADER = struct.Struct("<4sHHII")

#: decode registry — every kind the in-process store can hold.  Kind
#: names are class names (K8sObject.kind), so registration is mechanical.
KINDS: Dict[str, type] = {
    cls.__name__: cls
    for cls in (
        core.Pod, core.Node, core.PriorityClass, core.ConfigMap,
        core.Secret, core.Service, core.PersistentVolumeClaim,
        core.NetworkPolicy, core.Event,
        batch.Job,
        scheduling.PodGroup, scheduling.Queue,
        scheme.PodGroupV1alpha1, scheme.QueueV1alpha1,
        apis_bus.Command,
    )
}

#: request-op → protocol version that introduced it (the reference's
#: numbers).  Every op the server dispatches is declared here, and an op
#: introduced after MIN_VERSION carries the client-side old-peer
#: fallback (the ``unknown bus op`` typed-error path).
OP_VERSIONS: Dict[str, int] = {
    "create": 1,
    "update": 1,
    "update_status": 1,
    "get": 1,
    "list": 1,
    "delete": 1,
    "watch": 1,
    "unwatch": 1,
    "register_admission": 1,
    "commit_batch": 2,
    "watch_batch": 3,
    "cas_bind": 4,
    "bus_status": 5,
    "repl_append": 5,
    "repl_snapshot": 5,
    "repl_commit": 5,
    "txn_commit": 6,
    "repl_prevote": 7,
    "bus_add_replica": 7,
    "bus_remove_replica": 7,
    "bus_hello": 8,
}

#: wire error name → exception class; unknown names fall back to ApiError.
#: NotLeaderError (defined below) registers itself after its definition.
ERRORS: Dict[str, type] = {
    cls.__name__: cls
    for cls in (
        ApiError, NotFoundError, AlreadyExistsError, ConflictError,
        AdmissionError,
    )
}


class BusError(ApiError):
    """Bus transport failure (connection refused/lost, protocol error).

    Subclasses ApiError so existing ``except ApiError`` call sites (CLI,
    electors, controllers) degrade gracefully instead of crashing."""


class BusTimeoutError(BusError):
    """A request did not complete within its per-call timeout."""


class NotLeaderError(ApiError):
    """A write (or leader-only op) landed on a replica that cannot take
    it.  ``leader`` carries the answering replica's current leader view
    (``tcp://host:port``, or None mid-election) so the client can redial
    the leader DIRECTLY instead of rotating the endpoint list blindly —
    the structured form of the ``"not leader"`` message-sniffing the
    failover drill used to pay a full rotation for."""

    def __init__(self, message: str, leader: Optional[str] = None):
        super().__init__(message)
        self.leader = leader


ERRORS[NotLeaderError.__name__] = NotLeaderError


def encode_obj(obj) -> Optional[dict]:
    """API object → wire dict (kind included for the decode registry)."""
    return None if obj is None else obj.to_dict()


def decode_obj(data: Optional[dict]):
    """Wire dict → API object via the kind registry."""
    if data is None:
        return None
    kind = data.get("kind")
    cls = KINDS.get(kind)
    if cls is None:
        raise BusError(f"unknown kind on the wire: {kind!r}")
    return cls.from_dict(data)


def error_payload(exc: Exception) -> dict:
    name = type(exc).__name__
    if name not in ERRORS:
        name = "ApiError"
    out = {"error": name, "message": str(exc)}
    leader = getattr(exc, "leader", None)
    if leader:
        # the leader-hint channel: a follower answering "not leader"
        # names the leader so the client's next dial is direct
        out["leader"] = leader
    return out


def raise_error(payload: dict) -> None:
    cls = ERRORS.get(payload.get("error", ""), ApiError)
    if cls is NotLeaderError:
        raise NotLeaderError(payload.get("message", "remote error"),
                             leader=payload.get("leader"))
    raise cls(payload.get("message", "remote error"))


def parse_bus_url(url: str) -> Tuple[str, int]:
    """``tcp://host:port`` → (host, port).  A bare ``host:port`` is
    accepted for convenience.  ``shm://host:port`` parses identically:
    the address still names the TCP endpoint (the shm ring directory is
    derived from it, and TCP is the attach-failure fallback), the
    scheme just asks the client to try the same-host ring first."""
    if url.startswith("tcp://"):
        url = url[len("tcp://"):]
    elif url.startswith("shm://"):
        url = url[len("shm://"):]
    elif "://" in url:
        raise ValueError(
            f"unsupported bus scheme in {url!r} (use tcp:// or shm://)")
    host, sep, port = url.rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(f"bus address needs host:port, got {url!r}")
    return host or "127.0.0.1", int(port)


def parse_bus_endpoints(urls: str) -> List[Tuple[str, int]]:
    """``tcp://a:1,tcp://b:2,...`` → [(host, port), ...] — the
    replicated-apiserver form of ``--bus``: a client dials the list in
    order until one answers, and redials across it on failure, so a
    dead replica never strands a daemon."""
    out: List[Tuple[str, int]] = []
    for part in urls.split(","):
        part = part.strip()
        if part:
            out.append(parse_bus_url(part))
    if not out:
        raise ValueError(f"bus endpoint list is empty: {urls!r}")
    return out


def encode_payload(payload: dict, codec: str = CODEC_JSON) -> bytes:
    """Serialize one frame body.  Split out of :func:`send_frame` so the
    bus server can serialize a watch event ONCE and fan the cached bytes
    out to every subscriber (the correlation id lives in the frame
    header, so the body bytes are subscriber-independent)."""
    if codec == CODEC_BINARY:
        return msgpack.packb(payload, use_bin_type=True)
    return json.dumps(payload, separators=(",", ":")).encode()


def decode_payload(body: bytes, codec: str = CODEC_JSON) -> dict:
    """Deserialize one frame body (the inverse of encode_payload)."""
    if not body:
        return {}
    if codec == CODEC_BINARY:
        if msgpack is None:
            raise BusError("binary frame received but msgpack is unavailable")
        return msgpack.unpackb(body, raw=False)
    return json.loads(body.decode())


def send_frame_raw(sock: socket.socket, mtype: int, corr_id: int,
                   body: bytes, codec: str = CODEC_JSON) -> None:
    """Send a frame whose body is already serialized in ``codec``."""
    # JSON bodies are stamped MIN_VERSION: their layout is v1's, so
    # version-skewed peers never reject at the framing layer —
    # capability skew surfaces as an op-level typed error instead (the
    # commit_batch fallback path).  Binary bodies are stamped VERSION:
    # the stamp is the per-frame codec marker the receiver decodes by,
    # and a pre-v8 peer (which could not decode the body anyway) rejects
    # at the header — but binary is only ever sent to a peer that asked
    # for it through the bus_hello negotiation.
    version = VERSION if codec == CODEC_BINARY else MIN_VERSION
    sock.sendall(_HEADER.pack(MAGIC, version, mtype, corr_id, len(body)) + body)


def send_frame(sock: socket.socket, mtype: int, corr_id: int, payload: dict,
               codec: str = CODEC_JSON) -> None:
    send_frame_raw(sock, mtype, corr_id, encode_payload(payload, codec), codec)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        buf.extend(chunk)
    return bytes(buf)


def recv_frame(sock: socket.socket) -> Tuple[int, int, dict]:
    head = _recv_exact(sock, _HEADER.size)
    magic, version, mtype, corr_id, length = _HEADER.unpack(head)
    if magic != MAGIC:
        raise ValueError("bad magic")
    if not (MIN_VERSION <= version <= VERSION):
        raise ValueError(f"unsupported bus protocol version {version}")
    body = _recv_exact(sock, length) if length else b""
    # the codec is read off the frame, not off connection state: a v8
    # stamp means a msgpack body, anything older is JSON.  This is what
    # makes the hello exchange race-free — the response decodes
    # correctly whichever codec the server sent it in.
    codec = CODEC_BINARY if version >= 8 else CODEC_JSON
    return mtype, corr_id, decode_payload(body, codec)


# ---- WAL record codec ----------------------------------------------------
#
# WAL records adopt the SAME body encoding as the wire so replication can
# ship record bytes verbatim to followers without a decode/re-encode leg.
# The on-disk codec is sniffed from the first byte on read: a JSON record
# opens with '{' (0x7b), a msgpack map opens with a fixmap/map16/map32
# marker — so old JSON logs recover under a binary-default build and
# vice versa, record by record.

_MSGPACK_MAP_MARKERS = frozenset(
    list(range(0x80, 0x90)) + [0xDE, 0xDF])


def encode_record(record: dict, codec: Optional[str] = None) -> bytes:
    """Serialize one WAL record.  ``codec=None`` picks the build
    default: binary when msgpack is importable, JSON otherwise."""
    if codec is None:
        codec = CODEC_BINARY if HAS_BINARY else CODEC_JSON
    return encode_payload(record, codec)


def decode_record(payload: bytes) -> dict:
    """Deserialize one WAL record, sniffing the codec from its first
    byte (both codecs open a top-level map with a distinct marker)."""
    if payload[:1] == b"{":
        return json.loads(payload.decode())
    if payload and payload[0] in _MSGPACK_MAP_MARKERS:
        return decode_payload(payload, CODEC_BINARY)
    raise ValueError(
        f"unrecognized WAL record codec (first byte {payload[:1]!r})")
