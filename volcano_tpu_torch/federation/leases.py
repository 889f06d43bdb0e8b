"""Shard-assignment leases — ``serving/leader.py`` generalized to a map.

A copy of ``volcano_tpu/federation/leases.py``: the same record, so a
port member and a JAX member lease slices of one map.

One ConfigMap on the bus (``volcano-system/vtpu-shard-map``) holds the
whole federation's control state under a single JSON key:

* ``shards``: per-shard lease records ``{holder, renewTime,
  leaseDurationSeconds}`` — exactly the leader-lease record shape, one
  per slice instead of one per binary;
* ``members``: per-scheduler heartbeats, so fair share is computed from
  the *live* membership (a dead member must fall out of the divisor or
  its orphaned shard would look fairly assigned forever);
* ``stats``: per-holder observability (nodes owned, spillover
  counters) published piggyback on the renew write — what ``vtctl
  shards`` renders, identically over both backends, because it reads
  only this object.

Every transition goes through the store's resourceVersion CAS (the same
optimistic concurrency the leader lock uses), so two schedulers can
never both win a shard for overlapping terms.  The claim policy:

* **renew** everything we hold, every tick;
* **absorb on expiry**: an expired or empty shard is claimed when we
  are below fair share — ceil(N / live members) — so survivors of a
  crash split the orphaned slices instead of one grabbing all; a shard
  nobody claimed for a further full lease duration is claimed
  unconditionally (the availability backstop);
* **release on join**: when a live member holds nothing and no shard is
  free, over-fair holders release their highest slices down to fair
  share, which the newcomer then claims.

Like the leader elector, ownership self-expires: when renewal cannot be
proven within the lease duration (bus outage, CAS storms), the manager
steps down from every shard locally — by the time another scheduler can
legally claim them, this one has already stopped scheduling them.
"""

from __future__ import annotations

import json
import math
import random
import threading
import time  # explore-seam: the interleaving explorer swaps THIS
# module attribute for a controlled clock and drives _tick() directly —
# keep clock reads module-qualified (`time.time()`/`time.monotonic()`),
# never `from time import ...`, and keep _tick free of real sleeps or
# spawned threads, or the lease machine's schedules stop replaying
import zlib
from typing import Callable, Dict, List, Optional

from volcano_tpu_torch.apis import core
from volcano_tpu_torch.client.apiserver import (
    AlreadyExistsError,
    ApiError,
    APIServer,
    ConflictError,
    NotFoundError,
)
from volcano_tpu_torch import metrics
from volcano_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

SHARD_MAP_NAME = "vtpu-shard-map"
SHARD_MAP_KEY = "shards.volcano.tpu/map"
NAMESPACE = "volcano-system"


def read_shard_map(api: APIServer, namespace: str = NAMESPACE) -> Optional[dict]:
    """The parsed shard-map record, or None when federation never ran.
    Shared by ``vtctl shards``, ``vtctl top``, incident bundles and tests — all
    observability reads go through the API surface only, so they render
    identically over the in-process and ``--bus`` backends."""
    cm = api.get("ConfigMap", namespace, SHARD_MAP_NAME)
    if cm is None:
        return None
    try:
        return json.loads(cm.data.get(SHARD_MAP_KEY, ""))
    except (ValueError, AttributeError):
        return None


class ShardLeaseManager:
    """Claim/renew/rebalance loop for one federation member.

    ``on_acquire(shard)`` / ``on_release(shard)`` fire on the manager
    thread after the CAS write that made the transition authoritative —
    the filter's relist-on-acquire and drop-on-release hang off them.
    ``stats`` (optional) is called each tick and its dict is published
    under ``stats[identity]`` in the map object.
    """

    def __init__(
        self,
        api: APIServer,
        identity: str,
        n_shards: int,
        namespace: str = NAMESPACE,
        lease_duration: float = 2.0,
        retry_period: float = 0.2,
        on_acquire: Optional[Callable[[int], None]] = None,
        on_release: Optional[Callable[[int], None]] = None,
        stats: Optional[Callable[[], dict]] = None,
        elastic: bool = False,
        on_resize: Optional[Callable[[int], None]] = None,
    ):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.api = api
        self.identity = identity
        self.n_shards = n_shards
        #: elastic mode (the shard autoscaler): the MAP's nShards is
        #: authoritative and --shards is only the bootstrap value — a
        #: count mismatch is adopted (release everything, resize via
        #: on_resize, re-enter the claim loop under the new count)
        #: instead of refused.  Off = the static semantics: a mismatched
        #: member refuses to participate, pinned by tests.
        self.elastic = elastic
        self.on_resize = on_resize
        self.namespace = namespace
        self.lease_duration = lease_duration
        self.retry_period = retry_period
        self.on_acquire = on_acquire
        self.on_release = on_release
        self.stats = stats
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._release_on_stop = True
        #: shards whose ownership has been applied through the callbacks
        #: — manager-thread state, compared against each tick's CAS
        #: outcome to derive the acquire/release deltas
        self._applied: set = set()
        #: monotonic stamp of the last attempt whose CAS write landed;
        #: ownership self-expires against it (leader-elector semantics)
        self._last_renew = 0.0
        #: jitter source — seeded per identity so the schedule is
        #: process-stable while distinct members still desynchronize
        self._jitter = random.Random(zlib.crc32(identity.encode()))
        #: observability for tests/vtctl
        self.rebalances = 0

    # ---- record helpers ----

    def _read(self):
        cm = self.api.get("ConfigMap", self.namespace, SHARD_MAP_NAME)
        if cm is None:
            return None, self._fresh_record()
        try:
            rec = json.loads(cm.data.get(SHARD_MAP_KEY, "{}"))
        except (ValueError, AttributeError):
            rec = {}
        if not isinstance(rec, dict) or "shards" not in rec:
            rec = self._fresh_record()
        return cm, rec

    def _fresh_record(self) -> dict:
        return {
            "nShards": self.n_shards,
            "members": {},
            "shards": {
                str(i): {"holder": "", "renewTime": 0.0,
                         "leaseDurationSeconds": self.lease_duration}
                for i in range(self.n_shards)
            },
            "stats": {},
        }

    def _write(self, cm, rec) -> bool:
        payload = {SHARD_MAP_KEY: json.dumps(rec, sort_keys=True)}
        try:
            if cm is None:
                self.api.create(core.ConfigMap(
                    metadata=core.ObjectMeta(
                        name=SHARD_MAP_NAME, namespace=self.namespace
                    ),
                    data=payload,
                ))
            else:
                cm.data = payload
                self.api.compare_and_update(
                    cm, cm.metadata.resource_version
                )
            return True
        except (AlreadyExistsError, ConflictError, NotFoundError):
            return False  # another member won this tick's CAS; re-read

    @staticmethod
    def _expired(entry: dict, now: float) -> bool:
        return now - float(entry.get("renewTime", 0.0)) > float(
            entry.get("leaseDurationSeconds", 0.0) or 0.0
        )

    # ---- one tick ----

    def _tick(self) -> None:
        now = time.time()  # wall clock — cross-process lease comparison,
        # exactly the leader.py rationale (monotonic epochs are local)
        attempt_started = time.monotonic()
        cm, rec = self._read()
        map_n = int(rec.get("nShards", self.n_shards))
        if map_n != self.n_shards:
            if self.elastic and map_n >= 1:
                # the autoscaler moved the target: adopt it.  Release
                # EVERYTHING first (the callbacks see a clean shutdown
                # of the old partition), resize the runtime's view,
                # then re-enter the claim loop next tick — absorb deals
                # us back in under the new count within a lease TTL.
                log.warning(
                    "shard map resized %d -> %d; %s re-keying its slice",
                    self.n_shards, map_n, self.identity,
                )
                self._apply(set())
                if self.on_resize is not None:
                    self.on_resize(map_n)
                self.n_shards = map_n
                return
            # a static federation must agree on its shard count —
            # refusing to touch the map beats silently running a
            # different partition
            log.error(
                "shard map declares nShards=%s but this scheduler runs "
                "--shards %d; refusing to participate",
                rec.get("nShards"), self.n_shards,
            )
            self._step_down()
            return

        # membership heartbeat + prune: a member whose heartbeat aged
        # past its own advertised lease duration is dead weight in the
        # fair-share divisor
        members = {
            ident: m for ident, m in rec.get("members", {}).items()
            if not self._expired(
                {"renewTime": m.get("heartbeat", 0.0),
                 "leaseDurationSeconds": m.get("leaseDurationSeconds",
                                               self.lease_duration)},
                now,
            ) or ident == self.identity
        }
        members[self.identity] = {
            "heartbeat": now,
            "leaseDurationSeconds": self.lease_duration,
        }
        rec["members"] = members

        shards: Dict[str, dict] = rec["shards"]
        mine: List[int] = []
        free: List[int] = []
        held_by: Dict[str, List[int]] = {}
        for i in range(self.n_shards):
            entry = shards.setdefault(str(i), {
                "holder": "", "renewTime": 0.0,
                "leaseDurationSeconds": self.lease_duration,
            })
            holder = entry.get("holder") or ""
            if holder == self.identity:
                mine.append(i)
            elif not holder or self._expired(entry, now):
                free.append(i)
            else:
                held_by.setdefault(holder, []).append(i)

        fair = math.ceil(self.n_shards / max(len(members), 1))
        claims: List[int] = []
        causes: List[str] = []
        for i in free:
            entry = shards[str(i)]
            had_holder = bool(entry.get("holder"))
            # below fair share: absorb; at/above: only the availability
            # backstop — a slice orphaned for a further full lease
            # duration is claimed regardless (coverage beats balance)
            expired_for = now - (
                float(entry.get("renewTime", 0.0))
                + float(entry.get("leaseDurationSeconds", 0.0) or 0.0)
            )
            if len(mine) + len(claims) < fair or (
                expired_for > self.lease_duration
            ):
                claims.append(i)
                causes.append("expiry" if had_holder else "join")

        releases: List[int] = []
        if not free and not claims:
            starved = [
                ident for ident in members
                if ident != self.identity and not held_by.get(ident)
            ]
            if starved and len(mine) > fair:
                # a live joiner holds nothing and every slice is held:
                # shed our highest slices down to fair share so it can
                # claim them next tick
                releases = sorted(mine)[fair:]

        for i in mine:
            if i in releases:
                # renewTime stamped NOW, not zeroed: the availability
                # backstop claims slices orphaned for a further TTL, and
                # an epoch-zero timestamp reads as infinitely orphaned —
                # the releaser itself would backstop-reclaim the slice
                # on its next tick and flap ownership forever instead of
                # leaving the below-fair joiner to claim it.  (The
                # graceful-shutdown release keeps renewTime 0.0: there
                # the immediate takeover IS the point.)
                shards[str(i)] = {
                    "holder": "", "renewTime": now,
                    "leaseDurationSeconds": self.lease_duration,
                }
            else:
                shards[str(i)] = {
                    "holder": self.identity, "renewTime": now,
                    "leaseDurationSeconds": self.lease_duration,
                }
        for i, cause in zip(claims, causes):
            shards[str(i)] = {
                "holder": self.identity, "renewTime": now,
                "leaseDurationSeconds": self.lease_duration,
            }
        if self.stats is not None:
            try:
                rec.setdefault("stats", {})[self.identity] = self.stats()
            except Exception as e:  # noqa: BLE001 — stats must never
                # block renewal
                log.error("shard stats publish failed: %s", e)

        if not self._write(cm, rec):
            # CAS lost — apply nothing; validity of already-owned shards
            # is judged below against the last SUCCESSFUL renew
            self._maybe_expire()
            return
        self._last_renew = attempt_started
        metrics.observe_shard_lease_renew(
            time.monotonic() - attempt_started
        )

        owned_now = set(mine) - set(releases) | set(claims)
        for i, cause in zip(claims, causes):
            metrics.register_shard_rebalance(cause)
            self.rebalances += 1
            log.info("shard lease: %s claimed shard %d (%s)",
                     self.identity, i, cause)
        for i in releases:
            metrics.register_shard_rebalance("release")
            self.rebalances += 1
            log.info("shard lease: %s released shard %d for a joining "
                     "member", self.identity, i)
        self._apply(owned_now)

    def _apply(self, owned_now: set) -> None:
        """Fire acquire/release callbacks for the delta vs what has been
        applied — always release-first so a slice is never observable as
        double-scheduled by this process."""
        for i in sorted(self._applied - owned_now):
            self._applied.discard(i)
            if self.on_release is not None:
                self.on_release(i)
        for i in sorted(owned_now - self._applied):
            self._applied.add(i)
            if self.on_acquire is not None:
                self.on_acquire(i)

    def _maybe_expire(self) -> None:
        """Self-expiry: past the lease duration without a provable
        renewal, stop owning everything locally — a healthy peer may
        legally hold our shards by now."""
        if self._applied and (
            time.monotonic() - self._last_renew > self.lease_duration
        ):
            log.error(
                "shard lease: %s could not renew within the lease "
                "duration; stepping down from shards %s",
                self.identity, sorted(self._applied),
            )
            self._apply(set())

    def _step_down(self) -> None:
        self._apply(set())

    # ---- loop / lifecycle ----

    def run(self) -> None:
        while not self._stop.is_set():
            try:
                self._tick()
            except ApiError as e:
                # bus outage: keep the thread alive; ownership expires
                # via _maybe_expire when renewal stays unprovable
                log.error("shard lease tick failed for %s: %s",
                          self.identity, e)
                self._maybe_expire()
            # jittered cadence: N members CAS-updating one object on a
            # synchronized clock would conflict every tick
            self._stop.wait(
                self.retry_period * (0.75 + 0.5 * self._jitter.random())
            )
        if self._release_on_stop:
            try:
                cm, rec = self._read()
                if cm is not None:
                    changed = False
                    for i, entry in rec.get("shards", {}).items():
                        if entry.get("holder") == self.identity:
                            rec["shards"][i] = {
                                "holder": "", "renewTime": 0.0,
                                "leaseDurationSeconds": self.lease_duration,
                            }
                            changed = True
                    if rec.get("members", {}).pop(self.identity, None):
                        changed = True
                    if changed:
                        self._write(cm, rec)
            except ApiError as e:
                log.error("shard lease release failed for %s: %s",
                          self.identity, e)
        self._apply(set())

    def owned(self) -> set:
        """Shards currently applied through the callbacks (manager-
        thread authoritative view; consumers needing cross-thread truth
        read the ShardState the callbacks maintain)."""
        return set(self._applied)

    def start(self) -> "ShardLeaseManager":
        self._thread = threading.Thread(
            target=self.run, name=f"shard-lease-{self.identity}",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self, release: bool = True) -> None:
        """``release=False`` simulates a crash: leases are left to
        expire, exercising absorb-on-expiry in the survivors."""
        self._release_on_stop = release
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if not release:
            self._applied.clear()
