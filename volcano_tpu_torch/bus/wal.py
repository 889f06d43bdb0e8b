"""WAL + snapshot durability for the API-server store.

A copy of ``volcano_tpu/bus/wal.py``; its on-disk format is the
reference's, so a data directory written by either package recovers in
the other with an equal :func:`store_digest`.  Volcano leans on etcd for
bus durability; this module is the standalone build's equivalent: a :class:`PersistentAPIServer` whose
every store *transaction* — one ``create``/``update``/``delete``, one
coalesced ``commit_batch``, one ``cas_bind`` — appends exactly one
length-prefixed, CRC-checksummed record to a write-ahead log and
fsyncs it **before** any observer (the requesting client's ack, or any
watch subscriber) sees the effect.

Write-ahead discipline
----------------------

The in-process ``APIServer`` fires watch notifications inline, mid-
transaction, under the store lock.  Here they are *buffered* per
transaction and flushed only after the WAL record is durable (and,
under replication, committed by the follower quorum — see
``bus/replication.py``).  Consequences:

* an acknowledged write can never be lost by a crash — the record hit
  disk before the T_RESP frame left the server;
* a watch subscriber can never observe an event that recovery would
  roll back — notifications trail durability;
* recovery is **physical**: each record carries the encoded watch
  events the transaction produced (old/new object dicts with their
  final resourceVersions), so replay is deterministic re-application
  of state — no admission re-runs, no re-minted timestamps.

Recovery loads the latest snapshot, replays the WAL tail, tolerates a
torn/partial trailing record (truncated to the last whole record), and
— critically — restores the **global bus sequence and watch backlog**:
the snapshot persists the epoch and recent-event ring, so a restarted
``vtpu-apiserver`` hands resuming clients their missed suffix instead
of a cluster-wide 410 relist storm (``bus_relists_total`` is the
canary).

Fault points: ``wal.write_fail`` (append raises, op not acked),
``wal.torn_tail`` (a partial record reaches disk, then the op fails —
the crash-mid-write shape), ``wal.fsync_delay`` (latency injection on
the fsync).
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import json
import os
import struct
import threading
import time
import uuid
import zlib
from typing import Dict, List, Optional, Tuple

from volcano_tpu_torch import faults, metrics, obs
from volcano_tpu_torch.bus import protocol
from volcano_tpu_torch.client.apiserver import ADDED, ApiError, APIServer, DELETED
from volcano_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

#: per-record framing: u32 payload length + u32 crc32(payload)
_REC_HEADER = struct.Struct("<II")

WAL_FILE = "wal.log"
SNAPSHOT_FILE = "snapshot.json"
META_FILE = "meta.json"


class WalError(ApiError):
    """A WAL append could not be made durable — the op is NOT acked."""


def append_record(f, payload: bytes) -> None:
    """Write one framed record (no fsync — the caller owns durability)."""
    f.write(_REC_HEADER.pack(len(payload), zlib.crc32(payload)) + payload)


def read_records(path: str) -> Tuple[List[bytes], int, bool]:
    """Read every whole, checksum-valid record from a WAL file.

    Returns ``(payloads, valid_prefix_len, torn)``: a torn or corrupt
    tail — short header, short payload, or CRC mismatch — ends the scan
    at the last good record instead of raising (the crash-mid-write
    recovery contract).  ``valid_prefix_len`` is the byte offset the
    file should be truncated to before appending resumes."""
    payloads: List[bytes] = []
    offset = 0
    torn = False
    if not os.path.exists(path):
        return payloads, 0, False
    with open(path, "rb") as f:
        data = f.read()
    n = len(data)
    while offset + _REC_HEADER.size <= n:
        length, crc = _REC_HEADER.unpack_from(data, offset)
        start = offset + _REC_HEADER.size
        end = start + length
        if end > n:
            torn = True
            break
        payload = data[start:end]
        if zlib.crc32(payload) != crc:
            torn = True
            break
        payloads.append(payload)
        offset = end
    if offset != n:
        torn = True
    return payloads, offset, torn


def record_codec() -> Optional[str]:
    """Body codec for NEW WAL records (recovery sniffs per record, so
    reads never need this).  ``VTPU_WAL_CODEC=json`` pins JSON — the
    escape hatch for replicating to a follower too old to decode
    msgpack record bytes; the default (``None``) lets
    ``protocol.encode_record`` pick binary when msgpack is available."""
    forced = os.environ.get("VTPU_WAL_CODEC", "").strip().lower()
    if forced in (protocol.CODEC_JSON, protocol.CODEC_BINARY):
        return forced
    return None


def store_digest(api: APIServer) -> str:
    """Canonical content digest of a store: every object of every kind,
    keyed and resourceVersion-stamped — the equality the crash-recovery
    tests pin (recovered store == acknowledged-write prefix)."""
    state: Dict[str, Dict[str, dict]] = {}
    with api.locked():
        for kind in sorted(protocol.KINDS):
            objs = api.list(kind)
            if objs:
                state[kind] = {
                    f"{o.metadata.namespace}/{o.metadata.name}": o.to_dict()
                    for o in objs
                }
    blob = json.dumps(state, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def bus_status_payload(api, replica=None) -> dict:
    """The ``bus_status`` op's payload, shared by the in-process and
    ``--bus`` backends so ``vtctl bus status`` renders byte-identically
    over both (the ``vtctl shards`` discipline).  Every field is stored
    or derived state — no call-time clocks — so two calls against the
    same quiescent store produce the same bytes."""
    status = (
        api.bus_status() if hasattr(api, "bus_status")
        else {"role": "standalone", "persistent": False}
    )
    if replica is not None:
        status.update(replica.status())
    return status


class PersistentAPIServer(APIServer):
    """The in-process store with WAL + snapshot durability.

    Drop-in for ``APIServer`` everywhere (BusServer, clients, daemons);
    the only behavioral difference is the write-ahead discipline
    documented in the module docstring.  ``data_dir`` holds three
    files: ``meta.json`` (epoch + term, atomic rewrite), ``wal.log``
    (the record stream since the last snapshot), ``snapshot.json``
    (full store + recent-event ring, atomic rewrite, rotated every
    ``snapshot_every`` records)."""

    def __init__(
        self,
        data_dir: str,
        snapshot_every: int = 256,
        backlog_keep: int = 1024,
        fsync: bool = True,
    ):
        super().__init__()
        self.data_dir = data_dir
        self.snapshot_every = snapshot_every
        self.backlog_keep = backlog_keep
        self.fsync = fsync
        os.makedirs(data_dir, exist_ok=True)

        self.epoch = ""  # guarded-by: self._lock
        self.term = 0  # guarded-by: self._lock
        self.event_seq = 0  # guarded-by: self._lock
        #: the seq of the event currently being flushed to watchers —
        #: the bus server's central watcher reads it (under the same
        #: store lock the notification fires under) so bus sequence
        #: numbers stay in lockstep with the durable event stream
        self.current_event_seq = 0  # guarded-by: self._lock
        #: the encoded (old, new) dicts of that event, the ones its WAL
        #: record carries: the bus server's central watcher ships them as
        #: they are instead of encoding the objects a second time
        self.current_event_encoded: Optional[tuple] = None  # guarded-by: self._lock
        #: the seq of the last event whose notification was delivered;
        #: written under the lock, read without it by flush_committed
        #: (it only grows, and the writer's notifications are delivered
        #: before it moves past them)
        self._flushed_seq = 0
        self.chain = 0  # guarded-by: self._lock
        #: rolling ring of recent encoded events ({seq, kind, event,
        #: old, new, ts}) — persisted into snapshots so a restarted
        #: server still covers resuming clients' cursors
        self._recent: List[dict] = []  # guarded-by: self._lock
        self._txn_depth = 0  # guarded-by: self._lock
        self._txn_events: List[tuple] = []  # guarded-by: self._lock
        #: events applied + logged but not yet quorum-committed (each
        #: item: (seq, kind, event, old, new, old_d, new_d)); flushed in
        #: order by flush_committed()
        self._pending_notify: collections.deque = collections.deque()  # guarded-by: self._lock
        self._records_since_snapshot = 0  # guarded-by: self._lock
        self._snapshot_seq = 0  # guarded-by: self._lock
        self._wal_f = None  # guarded-by: self._lock
        self._wal_size = 0  # guarded-by: self._lock
        self.last_fsync_ts = 0.0  # guarded-by: self._lock
        self.last_fsync_ms = 0.0  # guarded-by: self._lock
        #: replication-group membership config, or None before the
        #: group's first leader seeded it: ``{"epoch": int,
        #: "endpoints": [url, ...]}``.  Lives in the LOG (one
        #: membership record per change, replicated and recovered like
        #: any transaction) so after any crash/partition exactly one
        #: config survives — the one on the most advanced elected log.
        self.membership: Optional[dict] = None  # guarded-by: self._lock
        #: follower guard: public mutating ops are refused while this
        #: store replicates from a leader (writes arrive only through
        #: apply_replica_record / install_snapshot)
        self.read_only = False
        #: leader-side replication coordinator (bus/replication.py);
        #: None = standalone durability, commit == fsync
        self.replicator = None
        #: ``bus.leader_kill`` crash hook (daemon: os._exit(137))
        self.kill_hook = None
        self.recovered = {"snapshot": False, "wal_records": 0, "torn": False}

        with self._lock:
            self._load_meta()
            self._recover()

    # ---- meta (epoch + term) ----

    def _meta_path(self) -> str:
        return os.path.join(self.data_dir, META_FILE)

    def _load_meta(self) -> None:
        # requires-lock: self._lock
        path = self._meta_path()
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                meta = json.load(f)
            self.epoch = meta.get("epoch", "")
            self.term = int(meta.get("term", 0))
        if not self.epoch:
            self.epoch = uuid.uuid4().hex
            self._write_meta()

    def _write_meta(self) -> None:
        # requires-lock: self._lock
        tmp = self._meta_path() + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"epoch": self.epoch, "term": self.term}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._meta_path())

    def set_term(self, term: int) -> None:
        """Persist a new replication term (promotion / leader adoption)."""
        with self._lock:
            if term != self.term:
                self.term = term
                self._write_meta()

    def adopt_epoch(self, epoch: str) -> None:
        """A follower bootstrapping from a leader joins the leader's
        resume-token space (epoch is replication-group-wide, so watch
        cursors survive failover between replicas)."""
        with self._lock:
            if epoch and epoch != self.epoch:
                self.epoch = epoch
                self._write_meta()

    # ---- recovery ----

    def _wal_path(self) -> str:
        return os.path.join(self.data_dir, WAL_FILE)

    def _snapshot_path(self) -> str:
        return os.path.join(self.data_dir, SNAPSHOT_FILE)

    def _recover(self) -> None:
        # requires-lock: self._lock
        snap_path = self._snapshot_path()
        if os.path.exists(snap_path):
            with open(snap_path, encoding="utf-8") as f:
                snap = json.load(f)
            self._install_state(snap)
            self.recovered["snapshot"] = True
            metrics.register_bus_recovery("snapshot")

        payloads, valid_len, torn = read_records(self._wal_path())
        self.recovered["torn"] = torn
        for payload in payloads:
            # codec sniffed per record: a log written by a JSON build
            # recovers under a binary-default one and vice versa
            rec = protocol.decode_record(payload)
            if rec.get("term", 0) > self.term:
                self.term = rec["term"]
            self._ingest_record(rec, payload, pend_notify=False)
        self.recovered["wal_records"] = len(payloads)
        if payloads:
            metrics.register_bus_recovery("wal_tail")
        if torn:
            log.warning(
                "wal %s had a torn tail; truncated to %d bytes "
                "(%d whole records kept)",
                self._wal_path(), valid_len, len(payloads),
            )
        if self.term:
            self._write_meta()

        # reopen for appends, truncated to the valid prefix so the next
        # record does not land after torn garbage
        self._wal_f = open(self._wal_path(), "ab")
        self._wal_f.truncate(valid_len)
        self._wal_f.seek(valid_len)
        self._wal_size = valid_len
        metrics.update_wal_size(self._wal_size)

    def _install_state(self, snap: dict) -> None:
        # requires-lock: self._lock
        self._store.clear()
        self._owned.clear()
        for kind, objs in snap.get("objects", {}).items():
            bucket = self._store.setdefault(kind, {})
            for key, data in objs.items():
                obj = protocol.decode_obj(data)
                bucket[key] = obj
                self._register_owners(obj, key)
        self._rv = int(snap.get("rv", 0))
        self.event_seq = int(snap.get("seq", 0))
        self._snapshot_seq = self.event_seq
        self.chain = int(snap.get("chain", 0))
        if snap.get("epoch"):
            self.epoch = snap["epoch"]
        if int(snap.get("term", 0)) > self.term:
            self.term = int(snap["term"])
        if snap.get("membership") is not None:
            self.membership = dict(snap["membership"])
        self._recent = list(snap.get("backlog", []))

    def _ingest_record(self, rec: dict, payload: bytes,
                       pend_notify: bool) -> None:
        """Apply one logged record's events to the store: the ONE copy
        of the per-record bookkeeping (physical apply, recent ring,
        CRC chain, snapshot counter) shared by recovery replay and the
        follower replication path — the two must never drift or
        recovered and replicated stores diverge."""
        # requires-lock: self._lock
        ts = rec.get("ts", 0.0)
        if "membership" in rec:
            # a membership-config record: no store events, ONE synthetic
            # slot in the event-seq space (so replication cursors move
            # past it and the CRC chain covers it), config applied at
            # APPEND time — the Raft latest-config-in-log rule, which is
            # what makes "exactly one surviving config" hold when a
            # leader dies mid-change: the elected most-advanced log
            # decides, and every replica replays the same record
            self.event_seq += 1
            self.membership = dict(rec["membership"])
            self.chain = zlib.crc32(payload, self.chain)
            self._records_since_snapshot += 1
            metrics.update_membership_epoch(
                int(self.membership.get("epoch", 0))
            )
            return
        for kind, event, old_d, new_d in rec["events"]:
            self.event_seq += 1
            prev = self._apply_event_physical(kind, event, old_d, new_d)
            self._recent.append({
                "seq": self.event_seq, "kind": kind, "event": event,
                "old": old_d, "new": new_d, "ts": ts,
            })
            if pend_notify:
                # the object the event replaced or removed leaves the
                # store here, so it serves as the notification's old
                # state as it is; only the new state is decoded again
                old = prev if prev is not None else self._decode_clone(old_d)
                self._pending_notify.append((
                    self.event_seq, kind, event, old, self._decode_clone(new_d),
                    old_d, new_d,
                ))
        del self._recent[: max(0, len(self._recent) - self.backlog_keep)]
        self.chain = zlib.crc32(payload, self.chain)
        self._records_since_snapshot += 1

    def _apply_event_physical(self, kind, event, old_d, new_d):
        """Apply one logged event; the object it replaced or removed
        (None for a create)."""
        # requires-lock: self._lock
        bucket = self._store.setdefault(kind, {})
        if event == DELETED:
            obj = protocol.decode_obj(old_d)
            key = self._key(obj)
            prev = bucket.pop(key, None)
            if prev is not None:
                self._unregister_owners(prev, key)
        else:
            obj = protocol.decode_obj(new_d)
            key = self._key(obj)
            prev = bucket.get(key)
            if prev is not None:
                self._unregister_owners(prev, key)
            bucket[key] = obj
            self._register_owners(obj, key)
            rv = obj.metadata.resource_version or 0
            if rv > self._rv:
                self._rv = rv
        return prev

    # ---- the write-ahead transaction wrapper ----

    @contextlib.contextmanager
    def _txn(self):
        """One store transaction: buffer the watch notifications the op
        produces, then (outermost level only) append one WAL record and
        fsync, wait for the replication commit, and flush the buffered
        notifications — in that order, so durability precedes every
        observer.

        The quorum wait happens OUTSIDE the store lock: application +
        WAL append are locked (sequencing), but parking the lock until
        followers ack would block every read, watch establishment, and
        — fatally — the ``bus_status`` probes a not-yet-attached
        follower needs to FIND this leader, wedging a fresh-promoted
        leader into a quorum-stall spiral (the loadgen failover drill
        caught it).  The cost is a wider read-uncommitted window on the
        leader, already documented in the known-gaps entry."""
        last_seq = 0
        replicator = None
        demoted = False
        error: Optional[BaseException] = None
        with self._lock:
            self._txn_depth += 1
            try:
                yield
            except BaseException as e:  # noqa: BLE001 — re-raised below,
                # AFTER the commit/flush bookkeeping: an op that raised
                # after earlier nested mutations (defensive — current
                # ops never do) must not strand buffered notifications
                error = e
            finally:
                self._txn_depth -= 1
                if self._txn_depth == 0 and self._txn_events:
                    events = self._txn_events
                    self._txn_events = []
                    last_seq = self._commit_txn(events)
                    # captured UNDER the lock, alongside the append:
                    # role transitions (set_replication) synchronize on
                    # the same lock, so this snapshot is exactly the
                    # regime the record was logged in — reading
                    # self.replicator after release could see a
                    # just-deposed leader's None and ack without quorum
                    replicator = self.replicator
                    demoted = self.read_only
        if last_seq:
            if replicator is not None:
                _q0 = time.perf_counter()
                if obs.enabled() and obs.current() is not None:
                    # quorum wait parks OUTSIDE the store lock (see
                    # above) — the span shows replication, not fsync,
                    # as the write's tail latency when followers lag
                    with obs.span("repl:quorum_wait", cat="repl",
                                  args={"seq": last_seq}):
                        committed = replicator.wait_commit(last_seq)
                else:
                    committed = replicator.wait_commit(last_seq)
                metrics.observe_repl_quorum_wait(
                    time.perf_counter() - _q0
                )
                self.flush_committed(last_seq if committed
                                     else replicator.commit_seq())
                if error is None and not committed:
                    # durable locally, may commit later (the
                    # coordinator's flusher delivers the parked
                    # notifications then) — but the CALLER is not acked
                    raise ApiError(
                        "replication quorum timeout — write not "
                        "acknowledged"
                    )
            elif demoted:
                # deposed mid-write: the record exists only locally and
                # the follower resync will reconcile it away — nothing
                # is flushed, nothing is acked
                if error is None:
                    raise ApiError(
                        "store demoted to follower mid-write — not "
                        "acknowledged"
                    )
            else:
                self.flush_committed(last_seq)
        if error is not None:
            raise error

    def _notify(self, kind: str, event: str, old, new) -> None:
        # requires-lock: self._lock
        if self._txn_depth > 0:
            self._txn_events.append((kind, event, old, new))
        else:
            super()._notify(kind, event, old, new)

    def _check_writable(self) -> None:
        if self.read_only:
            raise ApiError(
                "store is a replication follower — writes go to the leader"
            )

    def create(self, obj):
        self._check_writable()
        with self._txn():
            return super().create(obj)

    def update(self, obj, expected_rv: Optional[int] = None):
        self._check_writable()
        with self._txn():
            return super().update(obj, expected_rv=expected_rv)

    def update_status(self, obj):
        self._check_writable()
        with self._txn():
            return super().update_status(obj)

    def delete(self, kind: str, namespace: str, name: str):
        self._check_writable()
        with self._txn():
            return super().delete(kind, namespace, name)

    def cas_bind(self, namespace: str, name: str, hostname: str,
                 expected_rv: Optional[int] = None):
        self._check_writable()
        with self._txn():
            return super().cas_bind(namespace, name, hostname,
                                    expected_rv=expected_rv)

    def commit_batch(self, binds=(), evicts=(), events=(), conditions=(),
                     pod_groups=()):
        self._check_writable()
        with self._txn():
            return super().commit_batch(
                binds=binds, evicts=evicts, events=events,
                conditions=conditions, pod_groups=pod_groups,
            )

    def txn_commit(self, binds=()):
        """The atomic multi-``cas_bind`` transaction as ONE WAL record:
        all N bind events buffer through ``_txn`` and land in a single
        fsynced record (the exact atomic ``commit_batch`` path), so
        replication ships the gang as a unit and recovery replays it
        whole or not at all — a crash can never resurrect half a gang.
        An aborted transaction mutates nothing and therefore logs
        nothing."""
        self._check_writable()
        with self._txn():
            return super().txn_commit(binds=binds)

    # ---- membership-config records (bus/replication.py) ----

    def membership_config(self) -> Optional[dict]:
        """The latest membership config applied to this log (None until
        the group's first leader seeds one)."""
        with self._lock:
            return dict(self.membership) if self.membership else None

    def log_membership(self, membership: dict) -> int:
        """Append ONE membership-config WAL record and hand it to the
        replication outbox.  Returns the record's event seq; the CALLER
        (the ReplicaManager, which owns the single-change discipline)
        re-counts the quorum under the new config and waits for the
        commit — appending and waiting are split exactly so the config
        can take effect at append time (``_ingest_record``'s rule).  A
        failed append (``wal.write_fail``) applies nothing."""
        with self._lock:
            fp = faults.get_plane()
            record = {
                "membership": dict(membership),
                "seq0": self.event_seq,
                "term": self.term,
                "ts": time.time(),
            }
            payload = protocol.encode_record(record, codec=record_codec())
            self._append_wal(payload, fp)  # raises WalError → no change
            self.chain = zlib.crc32(payload, self.chain)
            self.event_seq += 1
            self.membership = dict(membership)
            self._records_since_snapshot += 1
            if self.replicator is not None:
                self.replicator.leader_append(
                    self.event_seq, self.term, self.chain, payload,
                    record["ts"], config=True,
                )
            seq = self.event_seq
            if self._records_since_snapshot >= self.snapshot_every:
                self._write_snapshot()
        metrics.update_membership_epoch(int(membership.get("epoch", 0)))
        return seq

    # ---- commit path ----

    def _commit_txn(self, events: List[tuple]) -> int:
        """Append one WAL record for the buffered events and hand it to
        the replication outbox.  Returns the transaction's last event
        seq; the CALLER (outside the lock) waits for the quorum and
        flushes the notifications."""
        # requires-lock: self._lock
        fp = faults.get_plane()
        if fp.enabled and self.kill_hook is not None and fp.should("bus.leader_kill"):
            # the SIGKILL-mid-commit-burst chaos point: the record may
            # or may not have hit disk — exactly the window the
            # recovery contract covers
            log.error("bus.leader_kill fired: apiserver going down hard")
            self.kill_hook()
        ts = time.time()
        encoded = [
            (kind, event, protocol.encode_obj(old), protocol.encode_obj(new))
            for kind, event, old, new in events
        ]
        seq0 = self.event_seq
        record = {
            "events": encoded,
            "rv": self._rv,
            "seq0": seq0,
            "term": self.term,
            "ts": ts,
        }
        payload = protocol.encode_record(record, codec=record_codec())
        try:
            self._append_wal(payload, fp)
        except WalError:
            # the record never became durable, so the op will not be
            # acked — ROLL BACK the in-memory mutations too, or reads
            # (and AlreadyExists-based retries) would observe a write
            # that a restart erases
            self._rollback_events(events)
            raise
        self.chain = zlib.crc32(payload, self.chain)
        last_seq = seq0 + len(encoded)
        self.event_seq = last_seq
        for i, (kind, event, old_d, new_d) in enumerate(encoded):
            seq = seq0 + i + 1
            self._recent.append({
                "seq": seq, "kind": kind, "event": event,
                "old": old_d, "new": new_d, "ts": ts,
            })
            self._pending_notify.append(
                (seq, kind, event, events[i][2], events[i][3], old_d, new_d)
            )
        del self._recent[: max(0, len(self._recent) - self.backlog_keep)]
        # hand the record to the replication outbox (no-op standalone);
        # the quorum wait happens outside the store lock, in _txn
        if self.replicator is not None:
            self.replicator.leader_append(last_seq, self.term, self.chain,
                                          payload, ts)
        self._records_since_snapshot += 1
        if self._records_since_snapshot >= self.snapshot_every:
            self._write_snapshot()
        return last_seq

    def _rollback_events(self, events: List[tuple]) -> None:
        """Undo a failed transaction's in-memory mutations from its
        buffered events, newest first (the clones carry the exact prior
        state, cascade deletions included)."""
        # requires-lock: self._lock
        for kind, event, old, new in reversed(events):
            bucket = self._store.setdefault(kind, {})
            if event == DELETED:
                key = self._key(old)
                bucket[key] = old
                self._register_owners(old, key)
            elif event == ADDED:
                key = self._key(new)
                cur = bucket.pop(key, None)
                if cur is not None:
                    self._unregister_owners(cur, key)
            else:  # MODIFIED
                key = self._key(new)
                cur = bucket.get(key)
                if cur is not None:
                    self._unregister_owners(cur, key)
                bucket[key] = old
                self._register_owners(old, key)

    def _append_wal(self, payload: bytes, fp) -> None:
        # requires-lock: self._lock
        if fp.enabled and fp.should("wal.write_fail"):
            raise WalError("fault-injected: wal append failed")
        if fp.enabled and fp.should("wal.torn_tail"):
            # crash-mid-write: a partial record reaches disk, the op
            # dies unacked; recovery must truncate this torn tail
            framed = _REC_HEADER.pack(len(payload), zlib.crc32(payload)) + payload
            torn = framed[: max(1, len(framed) // 2)]
            self._wal_f.write(torn)
            self._wal_f.flush()
            os.fsync(self._wal_f.fileno())
            self._wal_size += len(torn)
            raise WalError("fault-injected: torn wal write")
        append_record(self._wal_f, payload)
        self._wal_f.flush()
        if fp.enabled and fp.should("wal.fsync_delay"):
            time.sleep(fp.param_ms("wal.fsync_delay") / 1e3)
        t0 = time.perf_counter()
        if self.fsync:
            os.fsync(self._wal_f.fileno())
        dt = time.perf_counter() - t0
        self.last_fsync_ts = time.time()
        self.last_fsync_ms = round(dt * 1e3, 3)
        metrics.observe_wal_fsync(dt)
        if obs.enabled() and obs.current() is not None:
            # flight recorder: the durability cost lands in the traced
            # request's waterfall.  Context-gated (and emission is a
            # bounded ring append — obs/channel.py) so telemetry never
            # extends this store-lock hold with I/O.
            obs.complete("wal:fsync", dt, cat="wal",
                         args={"bytes": len(payload)})
        self._wal_size += _REC_HEADER.size + len(payload)
        metrics.update_wal_size(self._wal_size)

    def _flush_pending_locked(self, commit_seq: int) -> None:
        # requires-lock: self._lock
        while self._pending_notify and self._pending_notify[0][0] <= commit_seq:
            seq, kind, event, old, new, old_d, new_d = self._pending_notify.popleft()
            self.current_event_seq = seq
            self.current_event_encoded = (old_d, new_d)
            try:
                super()._notify(kind, event, old, new)
            finally:
                self.current_event_encoded = None
            self._flushed_seq = seq

    def flush_committed(self, commit_seq: int) -> None:
        """Deliver parked notifications up to ``commit_seq`` — the late
        path for transactions whose quorum ack arrived after their
        request timed out, and the follower's apply→commit gap.  A
        commit another writer's flush already covered takes no lock:
        under concurrent writers each would otherwise queue on the store
        lock once more only to find nothing left to deliver."""
        if self._flushed_seq >= commit_seq:
            return
        with self._lock:
            self._flush_pending_locked(commit_seq)

    # ---- snapshot ----

    def _snapshot_state(self) -> dict:
        """The full-state snapshot dict — the ONE shape shared by disk
        rotation and follower bootstrap (``repl_snapshot``), so the two
        recovery sources can never drift field-by-field."""
        # requires-lock: self._lock
        return {
            "epoch": self.epoch,
            "term": self.term,
            "rv": self._rv,
            "seq": self.event_seq,
            "chain": self.chain,
            "membership": (
                dict(self.membership) if self.membership else None
            ),
            "objects": {
                kind: {key: obj.to_dict() for key, obj in bucket.items()}
                for kind, bucket in self._store.items() if bucket
            },
            "backlog": self._recent[-self.backlog_keep:],
        }

    def _write_snapshot(self) -> None:
        # requires-lock: self._lock
        snap = self._snapshot_state()
        tmp = self._snapshot_path() + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(snap, f, separators=(",", ":"))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._snapshot_path())
        # rotate the WAL: records up to here live in the snapshot now
        self._wal_f.close()
        self._wal_f = open(self._wal_path(), "wb")
        self._wal_size = 0
        self._snapshot_seq = self.event_seq
        self._records_since_snapshot = 0
        metrics.update_wal_size(0)

    def snapshot_now(self) -> None:
        """Force a snapshot rotation (tests, graceful shutdown)."""
        with self._lock:
            self._write_snapshot()

    # ---- replication surface (called by bus/replication.py) ----

    def set_replication(self, replicator, read_only: bool) -> None:
        """Atomically install a replication regime.  Runs under the
        store lock so a role transition serializes against in-flight
        transactions: a transaction observes either the old regime
        (its coordinator, later shutdown, refuses the ack) or the new
        one — never a half-applied mix that acks without quorum."""
        with self._lock:
            self.replicator = replicator
            self.read_only = read_only

    def apply_replica_record(self, payload: bytes, sync: bool = True) -> int:
        """Follower path: append the leader's record to the local WAL,
        apply it physically, park its notifications until the commit
        point covers them.  Returns the new applied seq.  ``sync=False``
        defers the fsync to the batch tail (the leader already holds
        the record durable, so a follower crash between appends loses
        nothing a re-pull would not re-ship)."""
        with self._lock:
            rec = protocol.decode_record(payload)
            fp = faults.get_plane()
            if fp.enabled and fp.should("wal.write_fail"):
                raise WalError("fault-injected: wal append failed")
            append_record(self._wal_f, payload)
            self._wal_f.flush()
            if self.fsync and sync:
                t0 = time.perf_counter()
                os.fsync(self._wal_f.fileno())
                dt = time.perf_counter() - t0
                self.last_fsync_ts = time.time()
                self.last_fsync_ms = round(dt * 1e3, 3)
                metrics.observe_wal_fsync(dt)
            self._wal_size += _REC_HEADER.size + len(payload)
            metrics.update_wal_size(self._wal_size)
            if rec.get("term", 0) > self.term:
                self.term = rec["term"]
                self._write_meta()
            self._ingest_record(rec, payload, pend_notify=True)
            if self._records_since_snapshot >= self.snapshot_every:
                self._write_snapshot()
            return self.event_seq

    def _decode_clone(self, data):
        # requires-lock: self._lock
        return protocol.decode_obj(data)

    def dump_snapshot(self) -> dict:
        """Full-state snapshot for a (re)joining follower."""
        with self._lock:
            return self._snapshot_state()

    def install_snapshot(self, snap: dict) -> None:
        """Follower resync: replace the whole store with the leader's
        snapshot (bootstrap, or a divergent/lagging log that the
        leader's retained window no longer covers)."""
        with self._lock:
            self._install_state(snap)
            self._pending_notify.clear()
            self._flushed_seq = self.event_seq
            self._write_meta()
            self._write_snapshot()

    # ---- status + introspection ----

    def recent_events(self) -> List[dict]:
        """The recovered/live recent-event ring — the bus server seeds
        its watch backlog from this at start so resuming clients get
        their missed suffix from a restarted process."""
        with self._lock:
            return list(self._recent)

    def bus_status(self) -> dict:
        with self._lock:
            try:
                snap_size = os.path.getsize(self._snapshot_path())
            except OSError:
                snap_size = 0
            return {
                "role": "leader" if self.replicator is not None
                else ("follower" if self.read_only else "standalone"),
                "persistent": True,
                "epoch": self.epoch,
                "term": self.term,
                "seq": self.event_seq,
                "rv": self._rv,
                "wal_size_bytes": self._wal_size,
                "wal_records": self._records_since_snapshot,
                "snapshot_size_bytes": snap_size,
                "snapshot_seq": self._snapshot_seq,
                "last_fsync_ts": self.last_fsync_ts,
                "last_fsync_ms": self.last_fsync_ms,
                "wal_codec": record_codec() or (
                    protocol.CODEC_BINARY if protocol.HAS_BINARY
                    else protocol.CODEC_JSON
                ),
                **({
                    "membership_epoch": int(self.membership.get("epoch", 0)),
                    "membership": sorted(
                        self.membership.get("endpoints", ())
                    ),
                } if self.membership else {}),
                **({"metrics_address": self.metrics_address}
                   if getattr(self, "metrics_address", "") else {}),
            }

    def close(self) -> None:
        with self._lock:
            if self._wal_f is not None:
                self._wal_f.close()
                self._wal_f = None

