"""Single-leader log shipping between apiserver replicas.

A copy of ``volcano_tpu/bus/replication.py``: the same ops and record
shipping, so a replication group may mix port and JAX replicas, either
leading.

The durability layer (``bus/wal.py``) makes one ``vtpu-apiserver``
crash-safe; this module makes the bus *highly available*: N replicas,
one leader taking every write, followers applying the leader's WAL
records to their own durable stores and serving reads/watches locally.

Protocol (VBUS v5 request ops, follower → leader, pull-based):

* ``repl_append`` — long-poll for records after ``(seq, chain)``.  The
  leader verifies the follower's position against its retained record
  window by comparing the CRC chain value (each record's chain is
  ``crc32(record_bytes, prev_chain)``); a mismatch or an out-of-window
  cursor answers ``snapshot_needed`` instead of shipping a divergent
  suffix.  The request's ``after`` doubles as a cumulative ack.
* ``repl_snapshot`` — full store snapshot for bootstrap or resync.
* ``repl_commit`` — explicit ack after applying a batch: the follower
  reports its applied seq, the leader recomputes the commit point and
  returns it.  This is what makes quorum acks prompt instead of
  waiting for the next poll cycle.

Commit rule: a write is acknowledged only after the leader's WAL fsync
AND, with ``replica_count >= 2``, after a majority of replicas
(leader included) hold the record — ``commit_seq`` is the quorum-th
highest applied seq.  Watch notifications are withheld until the
commit point everywhere (leader and followers), so no watcher —
local or remote — ever observes an event a failover could roll back.
That is exactly what lets a client's watch cursor survive leader death:
committed seqs exist on a majority, the promotion rule picks the
most-advanced reachable survivor, and the epoch is replication-group-
wide, so ``resume_seq`` validates against the new leader and
``bus_relists_total`` stays flat.

Election: membership is the static ``--replicas`` endpoint list.  A
follower that loses its leader (pull failure persisting past the lease
TTL) probes every peer's ``bus_status``; it promotes itself only when
a majority of replicas is reachable and it is the most advanced —
ordered by ``(term, applied seq, -index)`` — otherwise it follows
whoever is.  Promotion bumps the persisted term; a deposed leader
rejoining sees the higher term and demotes.  No partition-tolerant
consensus is claimed (see the README's honest-gaps entry): below a
majority the group refuses promotion and writes stall rather than
risk acknowledged-write loss.

Write routing: a follower's BusServer proxies write ops (create /
update / update_status / delete / cas_bind / commit_batch / get) to
the leader over the manager's client connection — clients connected to
a follower keep working through it, while watches and lists are served
from the follower's local store.

Fault points: ``repl.drop`` (a shipment batch is dropped on the
leader — the follower re-pulls), ``repl.lag`` (injected apply latency
on the follower), ``bus.leader_kill`` (crash-stop the leader mid-
commit — wired through ``PersistentAPIServer.kill_hook``).
"""

from __future__ import annotations

import base64
import socket
import threading
import time
from typing import Dict, List, Optional

from volcano_tpu_torch import faults, metrics, obs
from volcano_tpu_torch.bus import protocol
from volcano_tpu_torch.bus.protocol import BusError, NotLeaderError
from volcano_tpu_torch.bus.wal import PersistentAPIServer
from volcano_tpu_torch.client.apiserver import ApiError
from volcano_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

#: records the leader retains in memory for follower catch-up; a
#: follower further behind than this re-syncs via repl_snapshot
_RETAIN = 4096

#: per-pull shipment cap (frames stay bounded like _WATCH_BATCH_MAX)
_PULL_MAX = 256


def _ship_record(r: dict, codec: str) -> dict:
    """One record of a ``repl_append`` response.  The CRC chain covers
    the canonical payload BYTES, so the follower must store a
    byte-identical copy: binary conns carry the raw bytes verbatim
    (msgpack bin — the zero-copy path); JSON conns carry the exact
    source string for JSON payloads (the v7 wire shape, so old
    followers keep working) and base64 for msgpack payloads, which
    JSON cannot hold losslessly."""
    out = {"seq": r["seq"], "term": r["term"], "chain": r["chain"]}
    payload = r["payload"]
    if codec == protocol.CODEC_BINARY:
        out["payload"] = payload
    elif payload[:1] == b"{":
        out["payload"] = payload.decode()
    else:
        out["payload"] = base64.b64encode(payload).decode()
        out["b64"] = True
    return out


def _shipped_payload(rec: dict) -> bytes:
    """Inverse of :func:`_ship_record` — the exact leader bytes."""
    payload = rec["payload"]
    if isinstance(payload, (bytes, bytearray)):
        return bytes(payload)
    if rec.get("b64"):
        return base64.b64decode(payload)
    return payload.encode()


def quorum_of(replica_count: int) -> int:
    """Majority including the leader; 1 when the group is a singleton."""
    return replica_count // 2 + 1 if replica_count >= 2 else 1


def proxy_timeout(op: str, lease_ttl: float) -> float:
    """Per-hop budget for a follower forwarding ``op`` to the leader.
    Ordinary writes are bounded by the election timescale, not the
    generic client timeout — a wedged leader should surface to the
    caller fast.  The v7 membership ops are the exception: the leader
    legitimately runs them for tens of seconds (learner catch-up wait,
    config-commit quorum wait), and a 4s hop cap made a proxied
    ``vtctl bus add-replica`` time out while the change went on to
    COMMIT at the leader — the operator's retry then read "already in
    flight"/"already a member" as a hard failure.  Matches the remote
    client's own 30s membership budget."""
    if op in ("bus_add_replica", "bus_remove_replica"):
        return 30.0
    return min(max(lease_ttl * 4, 2.0), 15.0)


def candidate_rank(term: int, seq: int, index: int):
    """Election ordering: most advanced by (term, applied seq), lowest
    index on ties.  A named function rather than an inline tuple so the
    interleaving explorer's election model (analysis/explore.py) ranks
    with the PRODUCTION comparator — the model cannot drift from the
    implementation."""
    return (term, seq, -index)


def leader_rank(term: int, commit_seq: int, index: int):
    """Dual-leader resolution ordering: a higher term always wins; an
    EQUAL term resolves by COMMIT seq first (only one same-term leader
    can hold a quorum, and deposing it by mere index would erase
    majority-committed writes — the rolling-kill soak's catch), index
    second.  Shared with the explorer like :func:`candidate_rank`."""
    return (term, commit_seq, -index)


class ReplicationCoordinator:
    """Leader-side record outbox + quorum tracking.

    ``leader_append`` is called by the store's commit path (under the
    store lock); ``pull``/``ack`` are called from bus request-handler
    threads serving followers and touch only this object's condition
    lock — the store lock is never needed here, so a leader parked in
    ``wait_commit`` cannot deadlock the acks that will release it."""

    def __init__(self, replica_count: int, identity: str,
                 base_seq: int, base_chain: int,
                 commit_timeout: float = 10.0):
        self.replica_count = replica_count  # guarded-by: self._cv
        self.identity = identity
        self.commit_timeout = commit_timeout
        self._cv = threading.Condition()
        #: voter endpoint urls, or None for a static group where every
        #: attached follower votes.  With dynamic membership a catching-
        #: up joiner attaches and pulls BEFORE it is admitted — its acks
        #: must not substitute for a voter's in the quorum count, or a
        #: leader + learner could "commit" a record no voting majority
        #: holds (exactly the acked-write loss a failover then realizes)
        self._voters: Optional[set] = None  # guarded-by: self._cv
        #: retained tail: {"seq", "term", "chain", "payload", "ts",
        #: "config"} — seq is the LAST event seq the record produced
        self._records: List[dict] = []  # guarded-by: self._cv
        self._base_seq = base_seq  # guarded-by: self._cv
        self._base_chain = base_chain  # guarded-by: self._cv
        self._last_seq = base_seq  # guarded-by: self._cv
        self._last_ts = 0.0  # guarded-by: self._cv
        self._commit_seq = base_seq  # guarded-by: self._cv
        #: follower id → {"acked": seq, "seen": monotonic ts}
        self._followers: Dict[str, dict] = {}  # guarded-by: self._cv
        #: set by shutdown(): in-flight commit waits abort immediately
        #: (a stopping or deposed leader must not park writers — and
        #: must not park its own store lock — for the full timeout)
        self._dead = False  # guarded-by: self._cv
        #: late-commit notify hook (store.flush_committed).  Invoked
        #: ONLY from the dedicated flusher thread below — never from an
        #: ack request thread: the hook takes the store lock, and an
        #: ack thread starving behind a stream of committers would
        #: stall the follower waiting on its repl_commit response,
        #: which stalls the quorum, which wedges the leader (observed
        #: as a whole-group stall under loadgen before this existed).
        self._on_commit = None
        self._flusher: Optional[threading.Thread] = None

    def start_flusher(self, on_commit) -> None:
        """Install the late-commit flush hook on its own thread.  The
        normal path needs no flush here — a committing writer delivers
        its own notifications after ``wait_commit`` — so this thread
        only picks up commits whose writer timed out (or follower-side
        gaps), and its lock waits block nobody."""
        self._on_commit = on_commit
        self._flusher = threading.Thread(
            target=self._flush_loop,
            name=f"vtpu-repl-flush-{self.identity}", daemon=True,
        )
        self._flusher.start()

    def _flush_loop(self) -> None:
        last = 0
        while True:
            with self._cv:
                while not self._dead and self._commit_seq <= last:
                    self._cv.wait(1.0)
                if self._dead:
                    return
                commit = self._commit_seq
            self._on_commit(commit)
            last = commit

    # ---- leader write path (store lock held by the caller) ----

    def leader_append(self, seq: int, term: int, chain: int,
                      payload: bytes, ts: float,
                      config: bool = False) -> None:
        with self._cv:
            self._records.append({
                "seq": seq, "term": term, "chain": chain,
                "payload": payload, "ts": ts, "config": config,
            })
            if len(self._records) > _RETAIN:
                dropped = self._records.pop(0)
                self._base_seq = dropped["seq"]
                self._base_chain = dropped["chain"]
            self._last_seq = seq
            self._last_ts = ts
            self._recompute_commit()
            self._cv.notify_all()

    def commit_seq(self) -> int:
        """The current quorum commit point (the membership latch's
        resolution read)."""
        with self._cv:
            return self._commit_seq

    def wait_commit(self, seq: int, timeout: Optional[float] = None) -> bool:
        timeout = self.commit_timeout if timeout is None else timeout
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._commit_seq < seq:
                if self._dead:
                    return False
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(remaining)
            return True

    def shutdown(self) -> None:
        """Abort every parked commit wait (leader stopping or deposed)."""
        with self._cv:
            self._dead = True
            self._cv.notify_all()

    def set_group(self, replica_count: int, voter_urls) -> None:
        """Adopt a membership config: the quorum divisor AND the voter
        filter change together, atomically under the condition lock —
        a commit recomputed between the two could count a learner (or
        a just-removed member) against the new divisor."""
        with self._cv:
            self.replica_count = replica_count
            self._voters = set(voter_urls) if voter_urls is not None else None
            self._recompute_commit()
            self._cv.notify_all()

    def _recompute_commit(self) -> None:
        # requires-lock: self._cv
        acked = sorted(
            [self._last_seq]
            + [
                f["acked"] for f in self._followers.values()
                # voter filter: only a follower whose KNOWN url is a
                # known non-member (a learner catching up, a removed
                # member still pulling) is excluded.  A follower that
                # never reported a url — a pre-v7 peer mid rolling
                # upgrade — VOTES: every v7 joiner always sends its
                # url, so url-less can only be old peers, and
                # excluding them would wedge the quorum for the whole
                # upgrade ("version skew costs a feature, never
                # correctness")
                if (
                    self._voters is None
                    or not f.get("url", "")
                    or f["url"] in self._voters
                )
            ],
            reverse=True,
        )
        k = quorum_of(self.replica_count)
        if len(acked) >= k:
            new_commit = acked[k - 1]
            if new_commit > self._commit_seq:
                self._commit_seq = new_commit

    # ---- follower-facing ops (request-handler threads) ----

    def _follower_entry(self, follower_id: str, url: str) -> dict:
        # requires-lock: self._cv
        entry = self._followers.setdefault(
            follower_id,
            {"acked": 0, "seen": 0.0, "url": "",
             "codec": protocol.CODEC_JSON},
        )
        if url:
            entry["url"] = url
        return entry

    def ack(self, follower_id: str, acked_seq: int, url: str = "") -> int:
        """Record a follower's applied seq; returns the commit point."""
        with self._cv:
            entry = self._follower_entry(follower_id, url)
            if acked_seq > entry["acked"]:
                entry["acked"] = acked_seq
            entry["seen"] = time.monotonic()
            self._recompute_commit()
            commit = self._commit_seq
            self._cv.notify_all()  # wakes parked writers AND the flusher
        return commit

    def catch_up_lag(self, url: str) -> Optional[int]:
        """A joiner's replication deficit in entries, or None when no
        attached follower reports that url — the add-replica catch-up
        gate reads it (a new replica bootstraps via ``repl_snapshot``
        and must close the gap BEFORE it counts toward quorum)."""
        with self._cv:
            for f in self._followers.values():
                if f.get("url") == url:
                    return max(0, self._last_seq - f["acked"])
            return None

    def pull(self, follower_id: str, after_seq: int, after_chain: int,
             wait_s: float, max_records: int = _PULL_MAX,
             url: str = "",
             codec: str = protocol.CODEC_JSON) -> dict:
        """One ``repl_append`` long-poll.  The cursor doubles as an ack."""
        deadline = time.monotonic() + max(0.0, min(wait_s, 30.0))
        with self._cv:
            entry = self._follower_entry(follower_id, url)
            entry["codec"] = codec
            if after_seq > entry["acked"]:
                entry["acked"] = after_seq
            entry["seen"] = time.monotonic()
            self._recompute_commit()
            self._cv.notify_all()
            # cursor validation against the retained window + CRC chain:
            # behind the window, AHEAD of the leader (a divergent
            # uncommitted suffix from a dead term), or a chain mismatch
            # all mean the follower's log is not a prefix of ours —
            # re-sync via snapshot instead of shipping a wrong suffix
            if after_seq < self._base_seq or after_seq > self._last_seq:
                return {"snapshot_needed": True}
            expected = self._chain_at(after_seq)
            if expected is None or expected != after_chain:
                return {"snapshot_needed": True}
            while self._last_seq <= after_seq:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(remaining)
            records = [
                r for r in self._records if r["seq"] > after_seq
            ][:max_records]
            commit = self._commit_seq
            last_seq = self._last_seq
        fp = faults.get_plane()
        if fp.enabled and records and fp.should("repl.drop"):
            # the shipment is lost on the wire — the follower's next
            # poll re-requests the same suffix (pure retransmission
            # latency, never a gap: the cursor did not advance)
            records = []
        if (
            fp.enabled and records
            and any(r.get("config") for r in records)
            and fp.should("repl.config_drop")
        ):
            # the membership-change twin of repl.drop: a shipment
            # carrying a CONFIG record is lost — the chaos drills'
            # window for killing a leader whose config change some
            # followers hold and others do not
            records = []
        return {
            "records": [_ship_record(r, codec) for r in records],
            "commit_seq": commit,
            "leader_seq": last_seq,
        }

    def _chain_at(self, seq: int) -> Optional[int]:
        # requires-lock: self._cv
        if seq == self._base_seq:
            return self._base_chain
        for r in self._records:
            if r["seq"] == seq:
                return r["chain"]
        return None

    def commit_seq(self) -> int:
        with self._cv:
            return self._commit_seq

    def follower_lags(self) -> Dict[str, dict]:
        """Per-follower replication lag, entries + ms, derived purely
        from stored state (no call-time clock) so ``vtctl bus status``
        renders byte-identically across backends."""
        with self._cv:
            out = {}
            for fid, f in self._followers.items():
                lag_entries = max(0, self._last_seq - f["acked"])
                lag_ms = 0.0
                if lag_entries:
                    acked_ts = self._base_ts_for(f["acked"])
                    if acked_ts is not None and self._last_ts:
                        lag_ms = round(
                            max(0.0, (self._last_ts - acked_ts) * 1e3), 1
                        )
                out[fid] = {
                    "acked_seq": f["acked"],
                    "lag_entries": lag_entries,
                    "lag_ms": lag_ms,
                    "codec": f.get("codec", protocol.CODEC_JSON),
                }
            return out

    def _base_ts_for(self, acked_seq: int) -> Optional[float]:
        # requires-lock: self._cv
        for r in self._records:
            if r["seq"] > acked_seq:
                return r["ts"]
        return None

    def max_lag_entries(self) -> int:
        with self._cv:
            if not self._followers:
                return 0
            return max(
                max(0, self._last_seq - f["acked"])
                for f in self._followers.values()
            )

    def quorum_health(self, ttl: float) -> dict:
        """Leader-side health for ``/healthz``: live voters (seen within
        2×ttl, leader included), the quorum bar, and the worst live
        voter's lag in entries — the two degraded conditions
        (``below-quorum``, ``replica-lagging``) read straight off it."""
        with self._cv:
            now = time.monotonic()
            live = 1  # self
            max_lag = 0
            for f in self._followers.values():
                # learners/removed are not the quorum's health; an
                # url-less entry is a pre-v7 voter and counts — the
                # commit rule's exact filter
                if (
                    self._voters is not None
                    and f.get("url", "")
                    and f["url"] not in self._voters
                ):
                    continue
                if now - f["seen"] > ttl * 2:
                    continue
                live += 1
                max_lag = max(max_lag, self._last_seq - f["acked"])
            return {
                "live": live,
                "quorum": quorum_of(self.replica_count),
                "max_lag": max(max_lag, 0),
            }


def probe_status(url: str, timeout: float = 1.5) -> Optional[dict]:
    """One-shot ``bus_status`` against a bare endpoint — the election
    probe.  Returns None when the peer is unreachable or too old to
    answer (an ``unknown bus op`` peer cannot be a v5 replica).  The
    timeout is generous relative to the probe's cost (~1 RTT + a
    status render): a loaded-but-alive peer that misses the window
    reads as dead, and an election that keeps seeing phantom deaths
    refuses to promote (below-quorum) or promotes spuriously — both
    worse than a slower probe round."""
    try:
        host, port = protocol.parse_bus_url(url)
        with socket.create_connection((host, port), timeout=timeout) as sock:
            sock.settimeout(timeout)
            protocol.send_frame(sock, protocol.T_REQ, 1, {"op": "bus_status"})
            while True:
                mtype, corr_id, payload = protocol.recv_frame(sock)
                if mtype == protocol.T_RESP and corr_id == 1:
                    return payload
                if mtype == protocol.T_ERROR and corr_id == 1:
                    return None
    except (OSError, ValueError, ConnectionError):
        return None


def request_prevote(url: str, term: int, seq: int, index: int,
                    timeout: float = 1.5) -> bool:
    """One-shot ``repl_prevote`` against a peer: would it support this
    candidate's promotion?  ANY failure — unreachable, timeout, typed
    error, or a pre-v7 peer answering ``unknown bus op`` — counts as a
    DENIAL: pre-vote exists to stop spurious term bumps, so the safe
    degradation is fewer promotions, never more."""
    try:
        host, port = protocol.parse_bus_url(url)
        with socket.create_connection((host, port), timeout=timeout) as sock:
            sock.settimeout(timeout)
            protocol.send_frame(sock, protocol.T_REQ, 1, {
                "op": "repl_prevote",
                "term": term, "seq": seq, "index": index,
            })
            while True:
                mtype, corr_id, payload = protocol.recv_frame(sock)
                if mtype == protocol.T_RESP and corr_id == 1:
                    return bool(payload.get("granted"))
                if mtype == protocol.T_ERROR and corr_id == 1:
                    return False
    except (OSError, ValueError, ConnectionError):
        return False


class _UncommittedChange(ApiError):
    """A membership record was appended but its commit wait timed out.
    Carries the record's seq so the single-change latch stays held
    (tagged) instead of clearing — the record is in the log and will
    commit or be superseded; a second change must not stack on it."""

    def __init__(self, seq: int, message: str):
        super().__init__(message)
        self.seq = seq


class _RawClient:
    """Sequential request/response client for the pull loop — one
    in-flight call at a time, no reconnect magic (the manager owns
    failure handling and redials)."""

    def __init__(self, url: str, timeout: float = 10.0):
        host, port = protocol.parse_bus_url(url)
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.timeout = timeout
        self._req_id = 0
        self.codec = protocol.CODEC_JSON
        self._negotiate_codec()

    def _negotiate_codec(self) -> None:
        """Same ladder discipline as ``RemoteAPIServer``: offer binary,
        and on ANY non-binary answer — a v7 leader rejecting the op, a
        JSON-pinned leader, a connection blip mid-hello — degrade to
        JSON rather than error.  A blip leaves the socket for the pull
        loop's failure budget to judge."""
        if not protocol.HAS_BINARY:
            return
        try:
            resp = self.call({
                "op": "bus_hello",
                "codecs": [protocol.CODEC_BINARY, protocol.CODEC_JSON],
            })
        except ApiError as e:
            if not isinstance(e, BusError) and "unknown bus op" in str(e):
                metrics.register_bus_codec_fallback()
            return
        except OSError:
            return
        if resp.get("codec") == protocol.CODEC_BINARY:
            self.codec = protocol.CODEC_BINARY
        else:
            metrics.register_bus_codec_fallback()

    def call(self, payload: dict, timeout: Optional[float] = None) -> dict:
        self._req_id += 1
        self.sock.settimeout(timeout if timeout is not None else self.timeout)
        protocol.send_frame(self.sock, protocol.T_REQ, self._req_id, payload,
                            codec=self.codec)
        while True:
            mtype, corr_id, resp = protocol.recv_frame(self.sock)
            if corr_id != self._req_id:
                continue  # stray push frame (bookmark etc.) — not ours
            if mtype == protocol.T_RESP:
                return resp
            if mtype == protocol.T_ERROR:
                protocol.raise_error(resp)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class ReplicaManager:
    """Role state machine for one apiserver replica.

    Owns the election loop, the follower pull/apply loop, and the
    leader-side coordinator; the BusServer consults ``is_leader`` to
    route writes and delegates the ``repl_*``/proxy ops here."""

    def __init__(
        self,
        store: PersistentAPIServer,
        endpoints: List[str],
        index: int,
        lease_ttl: float = 2.0,
        identity: Optional[str] = None,
        on_became_leader=None,
    ):
        if not (0 <= index < len(endpoints)):
            raise ValueError(
                f"replica index {index} outside endpoint list "
                f"({len(endpoints)} entries)"
            )
        self.store = store
        self.endpoints = list(endpoints)
        self.index = index
        self.lease_ttl = lease_ttl
        self.identity = identity or f"apiserver-{index}"
        #: this replica's own bus endpoint — the STABLE identity under
        #: dynamic membership (index is just the position in the current
        #: config and moves as members come and go)
        self.url = self.endpoints[index]
        self.replica_count = len(endpoints)
        self.on_became_leader = on_became_leader

        self._lock = threading.Lock()
        self.role = "init"  # guarded-by: self._lock
        self.leader_url: Optional[str] = None  # guarded-by: self._lock
        self.coordinator: Optional[ReplicationCoordinator] = None  # guarded-by: self._lock
        self._proxy_client = None  # guarded-by: self._lock
        #: peers this replica cannot reach — the deterministic partition
        #: seam (tests call block_peer/unblock_peer; the chaos drills'
        #: seeded ``bus.partition`` fault point drops calls on top)
        self._blocked: set = set()  # guarded-by: self._lock
        #: monotonic stamp of the last PROVEN leader contact (a pull or
        #: commit round-trip that succeeded) — what a pre-vote grant is
        #: judged against: a peer that heard its leader within the TTL
        #: denies, so a partitioned rejoiner cannot scare up a term bump
        #: while the group is healthy
        self._leader_heard = 0.0  # guarded-by: self._lock
        #: single-change discipline: an in-flight add/remove refuses a
        #: second change until its config record commits
        self._change_inflight: Optional[str] = None  # guarded-by: self._lock
        #: seq of a change whose record was APPENDED but whose commit
        #: wait timed out — the latch stays held past the request (the
        #: record is in the log and WILL commit or be superseded by an
        #: elected log; a second change stacked on the uncommitted base
        #: is exactly what single-change membership forbids).  A later
        #: _begin_change resolves it against the commit point.
        self._change_pending_seq: Optional[int] = None  # guarded-by: self._lock
        #: epoch of the last membership config this manager adopted
        self._adopted_epoch = -1  # guarded-by: self._lock
        #: True once a config CONTAINING this replica was adopted —
        #: distinguishes "removed from the group" (stand down) from
        #: "never admitted yet" (keep following as a learner: that IS
        #: the add-replica catch-up phase)
        self._was_member = False  # guarded-by: self._lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        metrics.update_repl_role("init")

    # ---- public surface ----

    @property
    def is_leader(self) -> bool:
        with self._lock:
            return self.role == "leader"

    # ---- the partition seam ----

    def block_peer(self, url: str) -> None:
        """Deterministically partition this replica from ``url`` (every
        probe / pre-vote / pull toward it fails like a dropped link).
        The test seam behind the pre-vote partition-and-rejoin pin; the
        seeded ``bus.partition`` fault point layers probabilistic drops
        on top for chaos drills."""
        with self._lock:
            self._blocked.add(url)

    def unblock_peer(self, url: str) -> None:
        with self._lock:
            self._blocked.discard(url)

    def _link_ok(self, url: str) -> bool:
        with self._lock:
            if url in self._blocked:
                return False
        fp = faults.get_plane()
        return not (fp.enabled and fp.should("bus.partition"))

    def _probe(self, url: str) -> Optional[dict]:
        """``probe_status`` through the partition seam."""
        if not self._link_ok(url):
            return None
        return probe_status(url)

    def start(self) -> "ReplicaManager":
        self._thread = threading.Thread(
            target=self._run, name=f"vtpu-repl-{self.identity}", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            client = self._proxy_client
            self._proxy_client = None
            coord = self.coordinator
        if coord is not None:
            coord.shutdown()  # release writers parked on the quorum
        if client is not None:
            client.close()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def proxy(self, payload: dict) -> dict:
        """Forward a write op from this follower to the leader; the
        response payload is relayed verbatim.  The ``proxied`` marker
        caps forwarding at one hop — a stale leader view answers with a
        typed error instead of bouncing the frame around the group."""
        with self._lock:
            client = self._proxy_client
            leader = self.leader_url
            role = self.role
        if client is None or leader is None:
            raise NotLeaderError(
                "no leader elected — write cannot be routed "
                f"(replica {self.identity} is {role})"
            )
        if not client.wait_ready(0.0):
            # the leader link is down (death/election in progress):
            # FAIL FAST instead of parking the caller for the client's
            # full reconnect timeout — the caller's retry lands after
            # promotion replaces this proxy (loadgen's failover drill
            # caught the parked variant blowing the submit budget).
            # The hint names the leader WE know: the caller may well
            # reach it even though this follower's link is down.
            raise NotLeaderError(
                f"leader {leader} unreachable from {self.identity} — "
                "retry after the election settles, or dial the leader",
                leader=leader,
            )
        fwd = dict(payload)
        fwd["proxied"] = True
        return client._call(  # noqa: SLF001 — same-package passthrough
            fwd, timeout=proxy_timeout(str(payload.get("op", "")),
                                       self.lease_ttl)
        )

    def status(self) -> dict:
        """Replication fields merged into ``bus_status`` payloads."""
        with self._lock:
            out = {
                "role": self.role,
                "identity": self.identity,
                "index": self.index,
                "replicas": self.replica_count,
                "endpoints": list(self.endpoints),
                # a leader IS the group's leader — report its own
                # endpoint, not the (None) url it follows
                "leader": (
                    self.endpoints[self.index] if self.role == "leader"
                    else self.leader_url
                ),
                "quorum": quorum_of(self.replica_count),
            }
            coord = self.coordinator
        if coord is not None:
            out["followers"] = coord.follower_lags()
            out["commit_seq"] = coord.commit_seq()
        return out

    # ---- leader-side op handlers (BusServer delegates here) ----

    def _coordinator_or_raise(self) -> ReplicationCoordinator:
        with self._lock:
            coord = self.coordinator
            if coord is None or self.role != "leader":
                raise ApiError(f"not leader ({self.role})")
            return coord

    def handle_append(self, payload: dict,
                      codec: str = protocol.CODEC_JSON) -> dict:
        coord = self._coordinator_or_raise()
        resp = coord.pull(
            str(payload.get("id", "")),
            int(payload.get("after", 0)),
            int(payload.get("chain", 0)),
            float(payload.get("wait_s", 0.0)),
            int(payload.get("max", _PULL_MAX)),
            url=str(payload.get("url", "")),
            codec=codec,
        )
        resp["term"] = self.store.term
        resp["epoch"] = self.store.epoch
        return resp

    def handle_snapshot(self, payload: dict) -> dict:
        coord = self._coordinator_or_raise()
        snap = self.store.dump_snapshot()
        return {"snapshot": snap, "commit_seq": coord.commit_seq()}

    def handle_commit(self, payload: dict) -> dict:
        coord = self._coordinator_or_raise()
        commit = coord.ack(
            str(payload.get("id", "")), int(payload.get("applied", 0)),
            url=str(payload.get("url", "")),
        )
        return {"commit_seq": commit, "leader_seq": self.store.event_seq}

    def handle_prevote(self, payload: dict) -> dict:
        """Answer a candidate's pre-vote probe (VBUS v7).  Granted only
        when (a) this replica is not itself the leader, (b) it has NOT
        proven leader contact within the lease TTL, and (c) the
        candidate's log is at least as advanced — so a healthy group
        denies a partitioned rejoiner unanimously and the stable
        leader's term never moves.  Grants are stateless probes (no
        persisted vote): pre-vote prevents spurious term bumps, the
        real election's rank ordering still decides the winner."""
        with self._lock:
            role = self.role
            heard = (
                time.monotonic() - self._leader_heard
            ) < self.lease_ttl
        cand = candidate_rank(
            int(payload.get("term", 0)), int(payload.get("seq", 0)),
            int(payload.get("index", 0)),
        )
        mine = candidate_rank(self.store.term, self.store.event_seq,
                              self.index)
        granted = role != "leader" and not heard and cand >= mine
        return {"granted": granted, "term": self.store.term, "role": role}

    # ---- dynamic membership (leader-side ops, request threads) ----

    def _begin_change(self, what: str) -> None:
        with self._lock:
            if (
                self._change_inflight is not None
                and self._change_pending_seq is not None
            ):
                # a previous change appended its record but its commit
                # wait timed out — resolve against the commit point
                # now: committed since ⇒ the latch clears and this
                # change proceeds on the new base; still uncommitted ⇒
                # refuse (stacking a second change on an uncommitted
                # config is what single-change membership forbids)
                coord = self.coordinator
                if (
                    coord is not None
                    and coord.commit_seq() >= self._change_pending_seq
                ):
                    self._change_inflight = None
                    self._change_pending_seq = None
            if self._change_inflight is not None:
                raise ApiError(
                    f"membership change already in flight "
                    f"({self._change_inflight}) — one change at a time "
                    "(the single-server degenerate case of joint "
                    "consensus; a second change is refused until the "
                    "first commits)"
                )
            self._change_inflight = what

    def _end_change(self, pending_seq: Optional[int] = None) -> None:
        """Release the latch — unless ``pending_seq`` names a record
        still awaiting its commit, in which case the latch stays held
        (tagged with the seq) until a later ``_begin_change`` proves
        the commit point passed it."""
        with self._lock:
            if pending_seq is not None:
                self._change_pending_seq = pending_seq
                return
            self._change_inflight = None
            self._change_pending_seq = None

    def add_replica(self, url: str, catch_up_timeout: float = 10.0,
                    max_lag: int = 16) -> dict:
        """Admit ONE new replica.  The joiner must already be running
        (started with ``--replicas <old list>,<itself>``): it attaches
        as a non-voting learner, bootstraps through the existing
        ``repl_snapshot`` path, and only once its replication lag has
        closed to ``max_lag`` entries is the membership record logged —
        so a slow bootstrap can never stall the write quorum it is
        about to join."""
        url = url.strip()
        protocol.parse_bus_url(url)  # validate before touching state
        coord = self._coordinator_or_raise()
        self._begin_change(f"add {url}")
        try:
            cfg = self.store.membership_config() or {
                "epoch": 0, "endpoints": list(self.endpoints),
            }
            endpoints = [str(u) for u in cfg.get("endpoints", ())]
            if url in endpoints:
                raise ApiError(f"{url} is already a member")
            deadline = time.monotonic() + catch_up_timeout
            while True:
                lag = coord.catch_up_lag(url)
                if lag is not None and lag <= max_lag:
                    break
                if time.monotonic() >= deadline or self._stop.is_set():
                    raise ApiError(
                        f"new replica {url} never caught up "
                        f"(lag: {'not attached' if lag is None else lag})"
                        " — start it with --replicas listing the whole "
                        "new group (itself last) and retry"
                    )
                time.sleep(0.1)
            new_cfg = {
                "epoch": int(cfg.get("epoch", 0)) + 1,
                "endpoints": endpoints + [url],
            }
            result = self._commit_config(coord, new_cfg, f"add {url}")
        except _UncommittedChange as e:
            # appended but not committed: the latch stays HELD, tagged
            # with the record's seq — a later change request resolves
            # it against the commit point instead of stacking
            self._end_change(pending_seq=e.seq)
            raise
        except BaseException:
            self._end_change()
            raise
        self._end_change()
        return result

    def remove_replica(self, url: str) -> dict:
        """Retire ONE replica.  Refused when the remaining group could
        not commit (a reachable majority of the NEW config is required
        up front — shrinking must never wedge the quorum), and refused
        for the leader itself (kill it and let the group elect first;
        leadership transfer is honestly not implemented)."""
        url = url.strip()
        coord = self._coordinator_or_raise()
        if url == self.url:
            raise ApiError(
                "cannot remove the current leader — remove a follower, "
                "or kill this leader and remove it after the election"
            )
        self._begin_change(f"remove {url}")
        try:
            cfg = self.store.membership_config() or {
                "epoch": 0, "endpoints": list(self.endpoints),
            }
            endpoints = [str(u) for u in cfg.get("endpoints", ())]
            if url not in endpoints:
                raise ApiError(f"{url} is not a member")
            remaining = [u for u in endpoints if u != url]
            reachable = 1  # self
            for u in remaining:
                if u != self.url and self._probe(u) is not None:
                    reachable += 1
            if reachable < quorum_of(len(remaining)):
                raise ApiError(
                    f"removal refused: only {reachable}/{len(remaining)} "
                    "of the remaining group reachable — the shrunk "
                    "group could not commit a write (grow reachability "
                    "first, never the other way)"
                )
            new_cfg = {
                "epoch": int(cfg.get("epoch", 0)) + 1,
                "endpoints": remaining,
            }
            result = self._commit_config(coord, new_cfg, f"remove {url}")
        except _UncommittedChange as e:
            # same latch discipline as add_replica: appended-but-
            # uncommitted keeps the latch held, tagged with the seq
            self._end_change(pending_seq=e.seq)
            raise
        except BaseException:
            self._end_change()
            raise
        self._end_change()
        return result

    def _commit_config(self, coord: ReplicationCoordinator, cfg: dict,
                       what: str) -> dict:
        """Log one membership record and wait for its commit.  The
        config takes effect at APPEND (coordinator re-counts quorum
        under the new membership immediately), which is what keeps the
        one-change-at-a-time case safe: old and new majorities overlap,
        so two leaders of adjacent configs can never both commit."""
        if obs.enabled():
            with obs.span("repl:membership", cat="repl",
                          args={"change": what,
                                "epoch": int(cfg.get("epoch", 0))}):
                return self._commit_config_inner(coord, cfg, what)
        return self._commit_config_inner(coord, cfg, what)

    def _commit_config_inner(self, coord: ReplicationCoordinator,
                             cfg: dict, what: str) -> dict:
        seq = self.store.log_membership(cfg)
        self._adopt_config(cfg)
        coord.set_group(len(cfg["endpoints"]), cfg["endpoints"])
        committed = coord.wait_commit(seq)
        if not committed:
            raise _UncommittedChange(
                seq,
                f"membership change ({what}) appended at seq {seq} but "
                "not yet committed — it completes when a quorum of the "
                "new config acks, or a newer elected log supersedes it; "
                "further changes are refused until it does",
            )
        log.info("replica %s: membership %s committed (epoch %d: %s)",
                 self.identity, what, cfg["epoch"], cfg["endpoints"])
        return {
            "committed": True, "seq": seq,
            "epoch": cfg["epoch"], "endpoints": list(cfg["endpoints"]),
        }

    def _adopt_config(self, cfg: dict) -> None:
        """Point this manager at a membership config (endpoints, own
        index, replica count).  Caller has verified self.url ∈ cfg."""
        with self._lock:
            self.endpoints = [str(u) for u in cfg["endpoints"]]
            self.index = self.endpoints.index(self.url)
            self.replica_count = len(self.endpoints)
            self._adopted_epoch = int(cfg.get("epoch", 0))

    def _adopt_membership(self) -> None:
        """Role-loop half of membership adoption: reconcile with the
        store's config (authoritative once seeded; ``--replicas`` only
        bootstraps).  A replica finding itself dropped from a config it
        was once part of stands down to ``removed``; one that was NEVER
        admitted keeps following as a learner (that is the catch-up
        phase ``add_replica`` gates on)."""
        cfg = self.store.membership_config()
        if cfg is None:
            return
        epoch = int(cfg.get("epoch", 0))
        with self._lock:
            if epoch <= self._adopted_epoch:
                return
            was_member = self._was_member
        endpoints = [str(u) for u in cfg.get("endpoints", ())]
        if not endpoints:
            return
        if self.url not in endpoints:
            with self._lock:
                self._adopted_epoch = epoch
            metrics.update_membership_epoch(epoch)
            if was_member:
                log.warning(
                    "replica %s (%s) removed at membership epoch %d — "
                    "standing down (restart the daemon to re-admit it)",
                    self.identity, self.url, epoch,
                )
                self._become_follower(None)
                with self._lock:
                    self.role = "removed"
                metrics.update_repl_role("removed")
            return
        self._adopt_config(cfg)
        with self._lock:
            self._was_member = True
            coord = self.coordinator
            if self.role == "removed":
                self.role = "init"  # re-admitted: rejoin via election
        metrics.update_membership_epoch(epoch)
        if coord is not None:
            coord.set_group(len(endpoints), endpoints)

    def _note_shipped_config(self) -> bool:
        """Reconcile membership after applying shipped state — WAL
        records or an installed snapshot, the same rule either way.
        A config listing this replica marks it admitted (recorded here,
        not just in ``_run``'s between-episode adoption pass: a
        follower that never leaves its first episode could otherwise
        not tell "removed" from "never admitted").  Returns True when a
        config dropped this replica from a group it was once part of —
        the caller ends the follow episode and ``_run``'s adoption pass
        stands it down to role ``removed``."""
        cfg = self.store.membership_config()
        if cfg is None:
            return False
        if self.url in cfg.get("endpoints", ()):
            with self._lock:
                self._was_member = True
            return False
        with self._lock:
            was_member = self._was_member
        if was_member:
            log.warning(
                "replica %s: shipped membership config no longer "
                "lists %s — leaving the follow loop",
                self.identity, self.url,
            )
            return True
        return False

    # ---- the role loop ----

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self._adopt_membership()
            except Exception as e:  # noqa: BLE001 — the loop must survive
                log.error("replica %s membership adoption error: %s",
                          self.identity, e)
            with self._lock:
                role = self.role
            try:
                if role == "removed":
                    # stood down: stay alive for reads/status, never
                    # pull or elect (a restart re-enters as a learner)
                    self._stop.wait(self.lease_ttl)
                elif role == "leader":
                    self._lead_tick()
                    self._stop.wait(self.lease_ttl / 2)
                else:
                    self._follow()
            except Exception as e:  # noqa: BLE001 — the loop must survive
                log.error("replica %s loop error: %s", self.identity, e)
                self._stop.wait(0.2)

    def _lead_tick(self) -> None:
        """Leader heartbeat: watch for a competing leader.  A higher
        term always wins (a deposed incarnation rejoining must step
        down, not split the brain).  An EQUAL term — two candidates
        that raced the same election — resolves by COMMIT seq first,
        index second: with three replicas only one same-term leader can
        hold a commit quorum, so the higher-commit leader is the one
        whose acknowledgements a majority actually stores — deposing it
        by mere index would erase majority-committed writes (the
        rolling-kill soak caught exactly that).  The loser's own writes
        are stalled-unacked (its quorum is gone), so ITS stepdown is
        loss-free."""
        with self._lock:
            coord = self.coordinator
        my_commit = coord.commit_seq() if coord is not None else 0
        mine = leader_rank(self.store.term, my_commit, self.index)
        for i, url in enumerate(self.endpoints):
            if i == self.index:
                continue
            st = self._probe(url)
            if st is None or st.get("role") != "leader":
                continue
            peer = leader_rank(
                int(st.get("term", 0)),
                int(st.get("commit_seq", 0)),
                int(st.get("index", len(self.endpoints))),
            )
            if peer > mine:
                log.error(
                    "replica %s: peer %s leads at (term,commit)=%s over "
                    "ours %s — stepping down",
                    self.identity, url, peer[:2], mine[:2],
                )
                self._become_follower(url)
                return
        with self._lock:
            coord = self.coordinator
        metrics.update_repl_lag(
            coord.max_lag_entries() if coord is not None else 0
        )

    def _become_follower(self, leader_url: Optional[str]) -> None:
        self.store.set_replication(None, read_only=True)
        with self._lock:
            self.role = "follower"
            coord = self.coordinator
            self.coordinator = None
            self._set_leader_locked(leader_url)
        if coord is not None:
            coord.shutdown()  # a deposed leader's parked writers abort
        metrics.update_repl_role("follower")

    def _set_leader_locked(self, leader_url: Optional[str]) -> None:
        # requires-lock: self._lock
        if leader_url == self.leader_url and self._proxy_client is not None:
            return
        old = self._proxy_client
        self._proxy_client = None
        self.leader_url = leader_url
        if old is not None:
            old.close()
        if leader_url is not None:
            from volcano_tpu_torch.bus.remote import RemoteAPIServer

            self._proxy_client = RemoteAPIServer(leader_url, timeout=15.0)

    def _promote(self, term: int) -> None:
        self.store.set_term(term)
        coord = ReplicationCoordinator(
            self.replica_count, self.identity,
            base_seq=self.store.event_seq, base_chain=self.store.chain,
        )
        coord.start_flusher(self.store.flush_committed)
        # order matters: the store must see the coordinator before the
        # role flips to leader (the instant ``is_leader`` goes true the
        # BusServer routes writes locally, and an un-replicated write
        # acked without quorum would be exactly the loss this exists to
        # prevent); the store-lock-atomic install also serializes the
        # transition against in-flight transactions
        if self.store.membership_config() is not None:
            # a dynamic group: quorum counts VOTERS (the adopted
            # config), not whatever happens to be pulling
            coord.set_group(self.replica_count, list(self.endpoints))
        self.store.set_replication(coord, read_only=False)
        with self._lock:
            self.coordinator = coord
            self.role = "leader"
            self._was_member = True
            self._set_leader_locked(None)
        metrics.update_repl_role("leader")
        log.info("replica %s promoted to leader (term %d, seq %d)",
                 self.identity, term, self.store.event_seq)
        if self.store.membership_config() is None:
            # the group's FIRST leader seeds the membership config into
            # the log (one record, epoch 1, the static --replicas list)
            # so every later change is a replicated delta against a
            # recorded base — no quorum wait here: followers may not
            # have attached yet, and the record commits when they do
            try:
                self.store.log_membership({
                    "epoch": 1, "endpoints": list(self.endpoints),
                })
                coord.set_group(self.replica_count, list(self.endpoints))
                with self._lock:
                    self._adopted_epoch = 1
            except ApiError as e:
                log.error("membership seed failed (will stay static "
                          "until a change is requested): %s", e)
        if self.on_became_leader is not None:
            threading.Thread(
                target=self.on_became_leader,
                name=f"vtpu-repl-onlead-{self.identity}", daemon=True,
            ).start()

    def _elect(self) -> Optional[str]:
        """Probe the group; return the leader url to follow, or None
        after promoting ourselves.  Promotion requires a reachable
        majority and being the most advanced — ``(term, seq, -index)``
        — among it."""
        cfg = self.store.membership_config()
        if cfg is not None and self.url not in cfg.get("endpoints", ()):
            # this replica's own log says it is NOT a voting member
            # (a learner awaiting admission, or a removed replica
            # restarted with its stale --replicas list).  It must
            # never promote: a non-member winning an election — its
            # stale endpoint list can still see a probe majority —
            # would be a zombie leader outside the committed config.
            # Keep following; add-replica is the only way back in.
            log.info(
                "replica %s (%s): not in membership epoch %s — "
                "following only, never electing",
                self.identity, self.url, cfg.get("epoch"),
            )
            return None
        statuses: Dict[str, dict] = {}
        for i, url in enumerate(self.endpoints):
            if i == self.index:
                continue
            st = self._probe(url)
            if st is not None:
                statuses[url] = st
        # an existing leader wins immediately (highest (term, commit)
        # first, lowest index on ties — _lead_tick's exact tie-break,
        # so a racing dual-leadership resolves to the same winner from
        # every observer's seat)
        leaders = [
            leader_rank(
                int(st.get("term", 0)), int(st.get("commit_seq", 0)),
                int(st.get("index", len(self.endpoints))),
            ) + (url,)
            for url, st in statuses.items() if st.get("role") == "leader"
        ]
        if leaders:
            leaders.sort(reverse=True)
            return leaders[0][3]
        reachable = len(statuses) + 1  # + self
        if reachable < quorum_of(self.replica_count):
            log.warning(
                "replica %s: only %d/%d replicas reachable — refusing "
                "promotion below quorum", self.identity, reachable,
                self.replica_count,
            )
            return None
        mine = candidate_rank(self.store.term, self.store.event_seq,
                              self.index)
        best_peer = max(
            (
                candidate_rank(
                    int(st.get("term", 0)), int(st.get("seq", 0)),
                    int(st.get("index", len(self.endpoints))),
                )
                for st in statuses.values()
            ),
            default=None,
        )
        if best_peer is None or mine >= best_peer:
            if self.index > 0:
                # deterministic stagger: tied candidates promote
                # lowest-index first.  A probe snapshot can miss a peer
                # mid-promotion (two candidates racing the same
                # election), so the better-ranked replica gets a head
                # start proportional to rank, and we re-check for a
                # winner before claiming the term ourselves.
                self._stop.wait(min(self.lease_ttl * 0.25, 0.3) * self.index)
                if self._stop.is_set():
                    return None
                for i, url in enumerate(self.endpoints):
                    if i == self.index:
                        continue
                    st = self._probe(url)
                    if st is not None and st.get("role") == "leader":
                        return url
            # PRE-VOTE (the Raft §9.6 discipline): before touching the
            # term, ask every reachable peer whether it would support
            # this promotion.  A peer that heard from a live leader
            # within its TTL denies — so a rejoiner partitioned from
            # the leader but not from the followers (the asymmetric
            # case the majority floor above cannot catch) probes,
            # collects denials, and goes back to retrying WITHOUT
            # incrementing the term or deposing anyone.  Grants must
            # reach a majority counting ourselves; denials and
            # unreachable peers are equivalent (safety over liveness).
            grants = 1  # self
            for url in statuses:
                if not self._link_ok(url):
                    continue
                if request_prevote(
                    url, self.store.term, self.store.event_seq, self.index
                ):
                    grants += 1
            if grants < quorum_of(self.replica_count):
                log.warning(
                    "replica %s: pre-vote denied (%d/%d grants) — a live "
                    "leader is visible to the group; not promoting",
                    self.identity, grants, quorum_of(self.replica_count),
                )
                return None
            max_term = max(
                [self.store.term]
                + [int(st.get("term", 0)) for st in statuses.values()]
            )
            self._promote(max_term + 1)
            return None
        return None  # a more advanced peer exists; let it promote

    def _follow(self) -> None:
        """One follower episode: find the leader, attach, pull until
        the stream breaks, then re-elect.  Leader death is detected by
        pull failure persisting past the lease TTL."""
        self.store.set_replication(None, read_only=True)
        metrics.update_repl_role("follower")
        leader = self._elect()
        if leader is None:
            if self.is_leader:
                return
            self._stop.wait(min(0.2, self.lease_ttl / 4))
            return
        self._become_follower(leader)
        raw: Optional[_RawClient] = None
        failing_since: Optional[float] = None
        try:
            while not self._stop.is_set():
                # every leader interaction shares the same failure
                # budget: transient blips redial inside the TTL window,
                # persistent failure past the TTL declares the leader
                # dead and re-elects.  (An early build let a failed
                # repl_commit crash the episode straight into an
                # election — a slow-but-alive leader then got deposed
                # by its own followers under load.)
                try:
                    if raw is None:
                        # the first dial shares the failure budget too: a
                        # leader that died between the election's probe
                        # and this dial must not leave its url recorded
                        raw = _RawClient(leader, timeout=max(10.0, self.lease_ttl * 3))
                    if not self._link_ok(leader):
                        # the partition seam: the link to the leader is
                        # down — burn the same failure budget a dropped
                        # TCP connection would
                        raise BusError("partitioned from leader")
                    resp = raw.call({
                        "op": "repl_append", "id": self.identity,
                        "url": self.url,
                        "after": self.store.event_seq,
                        "chain": self.store.chain,
                        "wait_s": self.lease_ttl / 2, "max": _PULL_MAX,
                    })
                    with self._lock:
                        # proven leader contact — what pre-vote denials
                        # are judged against
                        self._leader_heard = time.monotonic()
                    if resp.get("snapshot_needed"):
                        snap = raw.call(
                            {"op": "repl_snapshot"},
                            timeout=max(30.0, self.lease_ttl * 10),
                        )["snapshot"]
                        self.store.adopt_epoch(snap.get("epoch", ""))
                        self.store.install_snapshot(snap)
                        metrics.register_bus_recovery("snapshot")
                        failing_since = None
                        if self._note_shipped_config():
                            # a removal can arrive VIA SNAPSHOT too (a
                            # down member removed while its log
                            # diverged): on a write-idle group the
                            # records branch would never run again, so
                            # the stand-down must happen here
                            return
                        continue
                    records = resp.get("records", ())
                    commit = int(resp.get("commit_seq", 0))
                    if records:
                        self._apply_records(records)
                        ack = raw.call({
                            "op": "repl_commit", "id": self.identity,
                            "url": self.url,
                            "applied": self.store.event_seq,
                        })
                        commit = max(commit, int(ack.get("commit_seq", 0)))
                        if self._note_shipped_config():
                            return
                    failing_since = None
                except (BusError, ApiError, OSError, ConnectionError) as e:
                    now = time.monotonic()
                    if failing_since is None:
                        failing_since = now
                    if now - failing_since >= self.lease_ttl:
                        log.error(
                            "replica %s: leader %s unreachable past the "
                            "lease TTL (%s) — re-electing",
                            self.identity, leader, e,
                        )
                        # the leader is PROVABLY lost: clear the
                        # recorded view so proxies answer "no leader
                        # elected" and /healthz degrades to
                        # below-quorum while the election runs —
                        # keeping the dead url made the follower
                        # answer "ok" while every write stalled
                        with self._lock:
                            self._set_leader_locked(None)
                        return
                    # redial inside the TTL window (transient blip)
                    try:
                        if raw is not None:
                            raw.close()
                        raw = _RawClient(
                            leader, timeout=max(10.0, self.lease_ttl * 3)
                        )
                    except OSError:
                        raw = None
                        self._stop.wait(min(0.1, self.lease_ttl / 8))
                    continue
                self.store.adopt_epoch(resp.get("epoch", ""))
                if int(resp.get("term", 0)) > self.store.term:
                    self.store.set_term(int(resp["term"]))
                self.store.flush_committed(commit)
                metrics.update_repl_lag(
                    max(0, int(resp.get("leader_seq", 0))
                        - self.store.event_seq)
                )
        finally:
            if raw is not None:
                raw.close()

    def _apply_records(self, records) -> None:
        fp = faults.get_plane()
        last = len(records) - 1
        for i, rec in enumerate(records):
            if fp.enabled and fp.should("repl.lag"):
                time.sleep(fp.param_ms("repl.lag") / 1e3)
            # one fsync per shipped batch, not per record — the leader
            # already holds every record durable, so batch-tail fsync
            # loses nothing a leader failure wouldn't re-ship
            self.store.apply_replica_record(
                _shipped_payload(rec), sync=(i == last)
            )
