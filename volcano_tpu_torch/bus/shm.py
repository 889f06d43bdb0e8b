"""Same-host shared-memory bus transport: mmap'd SPSC byte rings.

A copy of ``volcano_tpu/bus/shm.py`` (the same ring layout and attach
handshake, so a port client attaches to a JAX server's rings and back).

When the scheduler, apiserver, and compute sidecar are co-resident (the
``local_up --multiproc`` topology), every bus frame still pays the
loopback TCP stack.  This module carries the IDENTICAL frames — same
header, same negotiated codec, same byte stream — through a pair of
mmap'd single-producer/single-consumer rings (one per direction, the
LMAX-Disruptor/Aeron shape) with an eventfd doorbell, so the framing
and serde layers above are completely unchanged: :class:`ShmSocket`
duck-types the five socket methods the bus actually uses (``sendall`` /
``recv`` / ``settimeout`` / ``setsockopt`` / ``close``), and
``send_frame`` / ``recv_frame`` / ``_Conn`` / ``RemoteAPIServer`` run
over it verbatim.

Ring layout (one file per direction, client-created, same uid):

    offset 0    u32 magic ``VRNG`` + u32 data size
    offset 64   u64 write position (producer-owned cache line)
    offset 128  u64 read position  (consumer-owned cache line)
    offset 4096 data[size]

Positions increase monotonically; the byte at stream position ``p``
lives at ``data[p % size]``, so frames wrap mid-frame freely — the
stream above does exact reads and never sees the seam.  The doorbell is
an eventfd the producer rings after advancing ``write_pos``; the
consumer sleeps in ``select`` on (doorbell, control socket) so a peer
death (control-socket EOF) wakes it immediately.  Where ``os.eventfd``
or fd-passing is unavailable the consumer degrades to an adaptive
spin-then-sleep poll — slower wakeups, same bytes.

Connection setup rides a tiny unix control socket in the ring
directory: the client creates both ring files (c2s, s2c) and both
eventfds, passes the eventfds with ``socket.send_fds``, and names the
ring files in a one-line JSON hello; the server mmaps them and answers
one ack byte.  The control socket then stays open purely as a liveness
signal.  Anything failing anywhere in attach — missing directory, dead
listener, no fd-passing — raises, and the caller falls back to TCP.

Deliberate caveats (documented in the README): same host and same uid
only (the rings are plain files under the shm directory), one ring per
direction per connection, and no in-flight resize.
"""

from __future__ import annotations

import json
import mmap
import os
import select
import socket
import struct
import threading
import time
from typing import Optional, Tuple

_RING_MAGIC = 0x56524E47  # "VRNG"
_MAGIC_OFF = 0
_SIZE_OFF = 4
_WRITE_POS_OFF = 64
_READ_POS_OFF = 128
_DATA_OFF = 4096

_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")

#: default data bytes per ring (per direction)
DEFAULT_RING_BYTES = 4 * 1024 * 1024

#: adaptive poll for builds without an eventfd doorbell: spin briefly,
#: then back off to bounded sleeps
_POLL_SPIN = 200
_POLL_SLEEP_S = 0.0005

_HAS_EVENTFD = hasattr(os, "eventfd") and hasattr(socket, "send_fds")


def ring_dir(port: int) -> str:
    """The shm directory a bus endpoint at ``port`` rendezvouses in.

    Derived from the TCP port so the client needs no extra discovery:
    ``$VTPU_BUS_SHM_DIR`` (or ``/dev/shm/vtpu-bus-<uid>``) + the port.
    """
    base = os.environ.get("VTPU_BUS_SHM_DIR") or os.path.join(
        "/dev/shm", f"vtpu-bus-{os.getuid()}")
    return os.path.join(base, str(port))


def shm_enabled() -> bool:
    """Whether the same-host ring transport is switched on at all
    (``VTPU_BUS_SHM=1``, set by ``local_up --multiproc``)."""
    return os.environ.get("VTPU_BUS_SHM", "") not in ("", "0")


def _create_ring_file(path: str, size: int) -> mmap.mmap:
    fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
    try:
        os.ftruncate(fd, _DATA_OFF + size)
        mem = mmap.mmap(fd, _DATA_OFF + size)
    finally:
        os.close(fd)
    _U32.pack_into(mem, _MAGIC_OFF, _RING_MAGIC)
    _U32.pack_into(mem, _SIZE_OFF, size)
    return mem


def _open_ring_file(path: str) -> Tuple[mmap.mmap, int]:
    fd = os.open(path, os.O_RDWR)
    try:
        total = os.fstat(fd).st_size
        mem = mmap.mmap(fd, total)
    finally:
        os.close(fd)
    if _U32.unpack_from(mem, _MAGIC_OFF)[0] != _RING_MAGIC:
        mem.close()
        raise ValueError(f"not a VRNG ring file: {path}")
    size = _U32.unpack_from(mem, _SIZE_OFF)[0]
    if total < _DATA_OFF + size:
        mem.close()
        raise ValueError(f"truncated ring file: {path}")
    return mem, size


class _Ring:
    """One direction of the transport.  Exactly one producer and one
    consumer; each owns its position word and only ever reads the
    other's — the SPSC discipline that keeps this lock-free."""

    def __init__(self, mem: mmap.mmap, size: int, doorbell: Optional[int]):
        self.mem = mem
        self.size = size
        self.doorbell = doorbell  # eventfd, or None → polling

    # -- position words (the mmap is the shared truth) --
    @property
    def write_pos(self) -> int:
        return _U64.unpack_from(self.mem, _WRITE_POS_OFF)[0]

    @write_pos.setter
    def write_pos(self, v: int) -> None:
        _U64.pack_into(self.mem, _WRITE_POS_OFF, v)

    @property
    def read_pos(self) -> int:
        return _U64.unpack_from(self.mem, _READ_POS_OFF)[0]

    @read_pos.setter
    def read_pos(self, v: int) -> None:
        _U64.pack_into(self.mem, _READ_POS_OFF, v)

    def ring(self) -> None:
        if self.doorbell is not None:
            try:
                os.eventfd_write(self.doorbell, 1)
            except OSError:
                pass

    def _copy_in(self, pos: int, data: bytes) -> None:
        """Write ``data`` at stream position ``pos`` (may wrap)."""
        idx = pos % self.size
        first = min(len(data), self.size - idx)
        self.mem[_DATA_OFF + idx:_DATA_OFF + idx + first] = data[:first]
        if first < len(data):
            rest = len(data) - first
            self.mem[_DATA_OFF:_DATA_OFF + rest] = data[first:]

    def _copy_out(self, pos: int, n: int) -> bytes:
        """Read ``n`` bytes at stream position ``pos`` (may wrap)."""
        idx = pos % self.size
        first = min(n, self.size - idx)
        out = self.mem[_DATA_OFF + idx:_DATA_OFF + idx + first]
        if first < n:
            out += self.mem[_DATA_OFF:_DATA_OFF + n - first]
        return out

    def close(self) -> None:
        try:
            self.mem.close()
        except (BufferError, ValueError):
            pass
        if self.doorbell is not None:
            try:
                os.close(self.doorbell)
            except OSError:
                pass
            self.doorbell = None


class ShmSocket:
    """A connected shm transport endpoint, duck-typed as a socket.

    ``tx``/``rx`` are the two rings from this endpoint's perspective;
    ``ctl`` is the control unix socket whose EOF means the peer died.
    The bus layers above only ever call ``sendall`` / ``recv`` /
    ``settimeout`` / ``setsockopt`` / ``shutdown`` / ``close``.
    """

    def __init__(self, tx: _Ring, rx: _Ring, ctl: socket.socket,
                 peer: str = "shm"):
        self._tx = tx
        self._rx = rx
        self._ctl = ctl
        self._ctl.setblocking(False)
        self._peer = peer
        self._timeout: Optional[float] = None
        self._closed = False
        self._peer_dead = False
        # one writer/reader thread each on the bus, but close() can race
        # a blocked recv — guard the teardown only
        self._close_lock = threading.Lock()

    # -- socket surface ----------------------------------------------
    def settimeout(self, t: Optional[float]) -> None:
        self._timeout = t

    def gettimeout(self) -> Optional[float]:
        return self._timeout

    def setsockopt(self, *_a, **_kw) -> None:
        """No-op: TCP_NODELAY and friends have no shm equivalent."""

    def getpeername(self):
        return (self._peer, 0)

    def fileno(self) -> int:
        return self._ctl.fileno() if not self._closed else -1

    def _deadline(self) -> Optional[float]:
        return None if self._timeout is None else (
            time.monotonic() + self._timeout)

    def _peer_alive(self) -> bool:
        """Drain the control socket; EOF means the peer is gone."""
        if self._peer_dead or self._closed:
            return False
        try:
            while True:
                chunk = self._ctl.recv(4096)
                if chunk == b"":
                    self._peer_dead = True
                    return False
                # doorbell bytes in the no-eventfd fallback: just drain
        except (BlockingIOError, InterruptedError):
            return True
        except OSError:
            self._peer_dead = True
            return False

    def _wait(self, ring: _Ring, deadline: Optional[float]) -> None:
        """Sleep until the ring MAY have progressed, the peer dies, or
        the deadline passes (socket.timeout)."""
        if deadline is not None and time.monotonic() >= deadline:
            raise socket.timeout("shm ring timed out")
        fds = [self._ctl.fileno()]
        if ring.doorbell is not None:
            fds.append(ring.doorbell)
            budget = None if deadline is None else max(
                0.0, deadline - time.monotonic())
            try:
                ready, _, _ = select.select(fds, [], [], budget)
            except (OSError, ValueError):
                self._peer_dead = True
                return
            if ring.doorbell in ready:
                try:
                    os.eventfd_read(ring.doorbell)
                except OSError:
                    pass
            if self._ctl.fileno() in ready:
                self._peer_alive()
        else:
            time.sleep(_POLL_SLEEP_S)
            self._peer_alive()

    def sendall(self, data: bytes) -> None:
        try:
            self._sendall(data)
        except ValueError:
            # the mmap was torn down by a concurrent close()
            if self._closed:
                raise ConnectionError("shm socket is closed") from None
            raise

    def _sendall(self, data: bytes) -> None:
        if self._closed:
            raise OSError("shm socket is closed")
        view = memoryview(data)
        deadline = self._deadline()
        ring = self._tx
        while len(view):
            if self._closed:
                raise ConnectionError("shm socket is closed")
            free = ring.size - (ring.write_pos - ring.read_pos)
            if free <= 0:
                # backpressure: the ring is full.  The doorbell fd is
                # the consumer's wait channel, so sharing it here could
                # lose a wakeup — a bounded sleep-poll is the honest
                # SPSC answer for the rare full-ring case.
                if not self._peer_alive():
                    raise ConnectionError("shm peer closed")
                if deadline is not None and time.monotonic() >= deadline:
                    raise socket.timeout("shm ring full")
                time.sleep(_POLL_SLEEP_S)
                continue
            n = min(free, len(view))
            w = ring.write_pos
            ring._copy_in(w, bytes(view[:n]))
            ring.write_pos = w + n
            ring.ring()
            if ring.doorbell is None:
                # no eventfd: nudge the peer's select via the ctl socket
                try:
                    self._ctl.send(b"\x00")
                except OSError:
                    pass
            view = view[n:]

    def recv(self, n: int) -> bytes:
        try:
            return self._recv(n)
        except ValueError:
            # the mmap was torn down by a concurrent close()
            if self._closed:
                return b""
            raise

    def _recv(self, n: int) -> bytes:
        if self._closed:
            return b""
        ring = self._rx
        deadline = self._deadline()
        spins = 0
        while True:
            if self._closed:
                return b""
            avail = ring.write_pos - ring.read_pos
            if avail > 0:
                take = min(avail, n)
                r = ring.read_pos
                out = ring._copy_out(r, take)
                # the position store is the release: a producer polling
                # a full ring sees the space as soon as this lands
                ring.read_pos = r + take
                return out
            if not self._peer_alive():
                return b""
            if ring.doorbell is None and spins < _POLL_SPIN:
                spins += 1
                continue
            self._wait(ring, deadline)

    def shutdown(self, _how: int = socket.SHUT_RDWR) -> None:
        try:
            self._ctl.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass

    def close(self) -> None:
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        # shutdown BEFORE close: a thread blocked in select on this fd
        # pins the open file, so a bare close() would neither wake it
        # nor deliver EOF to the peer until it returned — which it
        # never would.  shutdown() propagates immediately to both.
        try:
            self._ctl.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        # and wake any local waiter parked on a doorbell
        self._tx.ring()
        self._rx.ring()
        try:
            self._ctl.close()
        except OSError:
            pass
        self._tx.close()
        self._rx.close()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<ShmSocket peer={self._peer} closed={self._closed}>"


def _make_doorbell() -> Optional[int]:
    if not _HAS_EVENTFD:
        return None
    try:
        return os.eventfd(0, os.EFD_NONBLOCK | os.EFD_CLOEXEC)
    except OSError:  # pragma: no cover - exotic kernels
        return None


def connect(port: int, timeout: Optional[float] = None,
            ring_bytes: int = DEFAULT_RING_BYTES) -> ShmSocket:
    """Attach to the shm listener rendezvousing at TCP ``port``.

    Raises on ANY failure (no directory, no listener, no fd-passing) —
    the caller's contract is to fall back to TCP silently.
    """
    d = ring_dir(port)
    ctl = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    ctl.settimeout(timeout if timeout else 5.0)
    mems = []
    bells = []
    paths = []
    try:
        ctl.connect(os.path.join(d, "ctl.sock"))
        tag = f"{os.getpid()}-{ctl.fileno()}-{time.monotonic_ns()}"
        c2s_path = os.path.join(d, f"c2s-{tag}.ring")
        s2c_path = os.path.join(d, f"s2c-{tag}.ring")
        c2s = _create_ring_file(c2s_path, ring_bytes)
        paths.append(c2s_path)
        mems.append(c2s)
        s2c = _create_ring_file(s2c_path, ring_bytes)
        paths.append(s2c_path)
        mems.append(s2c)
        c2s_bell = _make_doorbell()
        s2c_bell = _make_doorbell()
        bells = [b for b in (c2s_bell, s2c_bell) if b is not None]
        hello = json.dumps({
            "c2s": os.path.basename(c2s_path),
            "s2c": os.path.basename(s2c_path),
            "bells": len(bells),
            "pid": os.getpid(),
        }).encode() + b"\n"
        if bells and _HAS_EVENTFD:
            socket.send_fds(ctl, [hello], bells)
        else:
            ctl.sendall(hello)
        ack = ctl.recv(1)
        if ack != b"+":
            raise ConnectionError(f"shm attach refused: {ack!r}")
        # ring files are mmap'd on both sides now; unlink so a dead
        # process never leaks them on disk
        for p in paths:
            try:
                os.unlink(p)
            except OSError:
                pass
        return ShmSocket(
            _Ring(c2s, ring_bytes, c2s_bell),
            _Ring(s2c, ring_bytes, s2c_bell),
            ctl, peer=f"shm:{port}")
    except BaseException:
        for m in mems:
            try:
                m.close()
            except (BufferError, ValueError):
                pass
        for b in bells:
            try:
                os.close(b)
            except OSError:
                pass
        for p in paths:
            try:
                os.unlink(p)
            except OSError:
                pass
        try:
            ctl.close()
        except OSError:
            pass
        raise


class ShmListener:
    """The server half: a unix control socket in the ring directory that
    turns each attach into a ShmSocket and hands it to ``on_conn``
    (the same ``_serve_conn`` path TCP connections take)."""

    def __init__(self, port: int):
        self.dir = ring_dir(port)
        os.makedirs(self.dir, mode=0o700, exist_ok=True)
        self.ctl_path = os.path.join(self.dir, "ctl.sock")
        try:
            os.unlink(self.ctl_path)
        except OSError:
            pass
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(self.ctl_path)
        self._sock.listen(64)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def serve(self, on_conn) -> None:
        """Accept attaches until stopped; each successful attach calls
        ``on_conn(shm_socket, peer_string)``."""
        while not self._stop.is_set():
            try:
                ctl, _ = self._sock.accept()
            except OSError:
                return
            try:
                sock, peer = self._attach(ctl)
            except Exception:
                try:
                    ctl.close()
                except OSError:
                    pass
                continue
            on_conn(sock, peer)

    def start(self, on_conn) -> "ShmListener":
        self._thread = threading.Thread(
            target=self.serve, args=(on_conn,),
            name="bus-shm-accept", daemon=True)
        self._thread.start()
        return self

    def _attach(self, ctl: socket.socket) -> Tuple[ShmSocket, str]:
        ctl.settimeout(5.0)
        if _HAS_EVENTFD:
            hello_raw, fds, _flags, _addr = socket.recv_fds(ctl, 4096, 2)
        else:  # pragma: no cover - no fd-passing on this build
            hello_raw, fds = ctl.recv(4096), []
        hello = json.loads(hello_raw.decode().strip())
        if len(fds) != int(hello.get("bells", 0)):
            for fd in fds:
                os.close(fd)
            raise ConnectionError("shm attach lost its doorbells")
        c2s_bell = fds[0] if len(fds) == 2 else None
        s2c_bell = fds[1] if len(fds) == 2 else None
        c2s_mem, c2s_size = _open_ring_file(
            os.path.join(self.dir, os.path.basename(hello["c2s"])))
        s2c_mem, s2c_size = _open_ring_file(
            os.path.join(self.dir, os.path.basename(hello["s2c"])))
        ctl.sendall(b"+")
        peer = f"shm:pid-{hello.get('pid', '?')}"
        # server's tx is s2c, rx is c2s
        return ShmSocket(
            _Ring(s2c_mem, s2c_size, s2c_bell),
            _Ring(c2s_mem, c2s_size, c2s_bell),
            ctl, peer=peer), peer

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        try:
            os.unlink(self.ctl_path)
        except OSError:
            pass
        if self._thread is not None:
            self._thread.join(timeout=5)
