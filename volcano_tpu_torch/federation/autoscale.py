"""SLO-driven shard autoscaling — the federation operates itself.

A copy of ``volcano_tpu/federation/autoscale.py``.

The shard count was an operator constant (``--shards N`` on every
member); this module turns it into a *target* a small controller moves
from sustained load signals: the federation goes from "survives kills"
to "operates itself under changing load".

Controller placement — "the lease-holding member"
-------------------------------------------------

Every member constructs a :class:`ShardAutoscaler`, but only the one
currently **holding shard 0's lease** evaluates and writes.  That rule
is deterministic (exactly one holder per lease term), already elected
(no new coordination plane), and self-healing (the controller moves
with the lease when its host dies — absorb-on-expiry re-homes shard 0
within one TTL, and the controller with it).

Signals
-------

Members already piggyback per-member stats on the lease-map heartbeats;
two fields are added there by ``FederatedScheduler._stats``:

* ``pendingTasks`` — the member's schedulable-pending queue depth,
  refreshed each post-cycle pass from the same O(jobs) view spillover
  and the gang broker share;
* ``latency`` — the member's CUMULATIVE ``submit_to_bind`` histogram
  buckets (the scrape shape).  The controller diffs successive
  snapshots per member and merges the deltas, so its p99 is **windowed**
  — one old latency spike can never hold the fleet scaled up forever.

Decision discipline
-------------------

One step at a time (the shard-count sibling of single-change
membership), with three dampers:

* **hysteresis** — the scale-up bar (``up_p99_ms`` / ``up_pending``)
  sits well above the scale-down bar (``down_p99_ms`` /
  ``down_pending``); between them the controller holds;
* **sustain** — a breach must persist for ``sustain`` consecutive
  evaluations before acting (one debounced spike is not load);
* **cooldown** — ``cooldown_s`` must elapse after a committed change
  before the next (judged from the wall-clock stamp *in the map*, so a
  controller migrating to another member keeps the cooldown).

A decision is one CAS on the shard-map ConfigMap — ``nShards`` moves,
grown slices appear unheld (members absorb them within a lease TTL via
the existing expiry backstop), shrunk slices disappear (their holders
release at the next tick), and an ``autoscale`` blob records
target/stamp/reason for ``vtctl shards`` and the drill gates.  Members
ADOPT the map's count (``ShardLeaseManager`` elastic mode) by releasing
everything and re-entering the claim loop — the same absorb/shed
machinery every other rebalance uses.  NOTE the honest cost:
node→shard is a mod hash, so a *count* change re-keys most
of the map (each member pays one relist); steady-state rebalances
(member join/death) still move slices whole.

What the controller does NOT do: spawn scheduler processes.  It moves
the *target*; the member fleet follows it — the deploy layer (or an
operator) scales the scheduler fleet to ``targetShards``.
"""

from __future__ import annotations

import random
import threading
import time
import zlib
from typing import Dict, Optional

from volcano_tpu_torch.client.apiserver import ApiError
from volcano_tpu_torch.federation.leases import (
    NAMESPACE,
    SHARD_MAP_KEY,
    SHARD_MAP_NAME,
)
from volcano_tpu_torch import metrics
from volcano_tpu_torch.metrics.scrape import histogram_quantile, merge_histograms
from volcano_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

_LATENCY_METRIC = "volcano_submit_to_bind_latency_milliseconds"


def owned_pending(view, owned, n_shards: int) -> int:
    """A member's pending-depth signal: tasks of jobs whose HOME shard
    this member currently owns.  NOT the raw ``pending_spill_view``
    total — at ``n_shards == 1`` the filter forwards every job to every
    member's cache, so a pre-provisioned standby's raw view equals the
    whole fleet's backlog and summing per-member reports would count it
    once per member (spurious scale-ups, blocked scale-downs).  Scoping
    to owned home shards makes the per-member reports a PARTITION of
    the true backlog at every shard count."""
    from volcano_tpu_torch.federation.sharding import home_shard

    total = 0
    for entry in view:
        ns, _, name = str(entry.get("job_id", "")).partition("/")
        if home_shard(ns, name, n_shards) in owned:
            total += len(entry.get("tasks", ()))
    return total


def latency_snapshot() -> Optional[dict]:
    """This process's cumulative submit→bind histogram in the scrape
    shape — what ``FederatedScheduler._stats`` publishes on the lease
    heartbeat for the controller to window."""
    return metrics.registry.histogram_snapshot(_LATENCY_METRIC)


def delta_histogram(prev: Optional[dict], cur: Optional[dict]) -> Optional[dict]:
    """Windowed histogram: pointwise difference of two cumulative
    snapshots of the SAME series (monotone, so every delta is >= 0; a
    member restart resets its counters — detected by a shrinking count
    and treated as a fresh window)."""
    if not cur:
        return None
    if not prev or prev.get("count", 0) > cur.get("count", 0):
        return cur  # first sight, or the member restarted: full window
    prev_by_le = {le: c for le, c in prev.get("buckets", ())}
    return {
        "buckets": [
            (le, max(0.0, c - prev_by_le.get(le, 0.0)))
            for le, c in cur.get("buckets", ())
        ],
        "sum": max(0.0, cur.get("sum", 0.0) - prev.get("sum", 0.0)),
        "count": max(0.0, cur.get("count", 0.0) - prev.get("count", 0.0)),
    }


class AutoscalePolicy:
    """Thresholds + dampers.  Defaults are deliberately conservative
    for production cadences; the CI drill passes tighter ones."""

    def __init__(
        self,
        min_shards: int = 1,
        max_shards: int = 8,
        up_p99_ms: float = 500.0,
        up_pending: int = 64,
        down_p99_ms: float = 50.0,
        down_pending: int = 8,
        sustain: int = 3,
        cooldown_s: float = 30.0,
        eval_period_s: float = 2.0,
    ):
        if min_shards < 1 or max_shards < min_shards:
            raise ValueError(
                f"need 1 <= min_shards <= max_shards, got "
                f"[{min_shards}, {max_shards}]"
            )
        self.min_shards = min_shards
        self.max_shards = max_shards
        self.up_p99_ms = up_p99_ms
        self.up_pending = up_pending
        self.down_p99_ms = down_p99_ms
        self.down_pending = down_pending
        self.sustain = sustain
        self.cooldown_s = cooldown_s
        self.eval_period_s = eval_period_s


def decide(policy: AutoscalePolicy, n_shards: int, p99_ms: float,
           pending: int, had_latency: bool) -> Optional[str]:
    """One evaluation's raw verdict — ``"up"`` / ``"down"`` / None —
    BEFORE sustain/cooldown damping (pure, pinned by unit tests).

    Scale up on EITHER signal breaching (queue depth catches the
    saturated-but-not-yet-slow ramp; p99 catches slow-without-backlog).
    Scale down only when BOTH sit under the low bar — and only when a
    latency window was actually observed (``had_latency``): an idle
    fleet with no samples reads p99 == 0, which must mean "nothing to
    judge", not "fast"...  except that zero pending AND zero traffic is
    precisely the idle case scale-down exists for, so idleness counts
    as under-bar when pending is also under."""
    per_shard_pending = pending / max(n_shards, 1)
    if (
        (had_latency and p99_ms > policy.up_p99_ms)
        or per_shard_pending > policy.up_pending
    ) and n_shards < policy.max_shards:
        return "up"
    if (
        n_shards > policy.min_shards
        and per_shard_pending < policy.down_pending
        and (not had_latency or p99_ms < policy.down_p99_ms)
    ):
        return "down"
    return None


class ShardAutoscaler:
    """The controller loop for one federation member.

    Constructed (and started) by every member; inert except on the
    member holding shard 0.  All decisions go through the shard map's
    resourceVersion CAS like every other federation transition — a
    conflicting lease renewal simply costs one retry tick.
    """

    def __init__(
        self,
        api,
        state,
        identity: str,
        policy: Optional[AutoscalePolicy] = None,
        namespace: str = NAMESPACE,
    ):
        self.api = api
        self.state = state
        self.identity = identity
        self.policy = policy or AutoscalePolicy()
        self.namespace = namespace
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: controller-thread state (single-threaded evaluator):
        #: per-member cumulative latency snapshots from the last tick
        self._prev_latency: Dict[str, dict] = {}
        #: consecutive same-direction raw verdicts
        self._streak_dir: Optional[str] = None
        self._streak = 0
        #: jittered cadence, seeded per identity like the lease manager
        self._jitter = random.Random(zlib.crc32(identity.encode()) ^ 0x5CA1E)
        self._ctr_lock = threading.Lock()
        #: observability mirror of the committed decisions (the drill
        #: and tests read it; the map blob is the cross-process truth)
        self._decisions: Dict[str, int] = {}  # guarded-by: self._ctr_lock

    # ---- observability ----

    def counters(self) -> Dict[str, int]:
        with self._ctr_lock:
            return dict(self._decisions)

    # ---- the evaluation tick ----

    def _read_map(self):
        cm = self.api.get("ConfigMap", self.namespace, SHARD_MAP_NAME)
        if cm is None:
            return None, None
        import json

        try:
            rec = json.loads(cm.data.get(SHARD_MAP_KEY, ""))
        except (ValueError, AttributeError):
            return None, None
        if not isinstance(rec, dict) or "shards" not in rec:
            return None, None
        return cm, rec

    def _signals(self, rec: dict) -> dict:
        """Windowed fleet signals from the map's member stats."""
        stats = rec.get("stats", {})
        members = set(rec.get("members", {}))
        pending = 0
        windows = []
        for ident, blob in stats.items():
            if ident not in members:
                continue  # a dead member's last stats are not load
            pending += int(blob.get("pendingTasks", 0) or 0)
            window = delta_histogram(
                self._prev_latency.get(ident), blob.get("latency")
            )
            if blob.get("latency"):
                self._prev_latency[ident] = blob["latency"]
            if window is not None:
                windows.append(window)
        # drop snapshots of departed members so a rejoin with the same
        # identity is treated as a fresh window
        for ident in list(self._prev_latency):
            if ident not in members:
                del self._prev_latency[ident]
        merged = merge_histograms(windows) if windows else None
        had_latency = bool(merged and merged.get("count", 0) > 0)
        return {
            "pending": pending,
            "p99_ms": histogram_quantile(merged, 0.99) if had_latency else 0.0,
            "had_latency": had_latency,
            "live_members": len(members),
        }

    def _tick(self) -> None:
        if not self.state.owns_shard(0):
            # not the lease-holding member: stay inert but DROP streak
            # state — a controller that just migrated here must earn a
            # fresh sustain window, not inherit a half-counted one
            self._streak = 0
            self._streak_dir = None
            return
        cm, rec = self._read_map()
        if rec is None:
            return
        n_shards = int(rec.get("nShards", 0) or 0)
        if n_shards < 1:
            return
        sig = self._signals(rec)
        verdict = decide(self.policy, n_shards, sig["p99_ms"],
                         sig["pending"], sig["had_latency"])
        if verdict != self._streak_dir:
            self._streak_dir = verdict
            self._streak = 0
        if verdict is None:
            return
        self._streak += 1
        if self._streak < self.policy.sustain:
            return
        blob = rec.get("autoscale", {}) or {}
        now = time.time()  # wall clock: cross-process like the leases
        if now - float(blob.get("lastChange", 0.0)) < self.policy.cooldown_s:
            return
        target = n_shards + 1 if verdict == "up" else n_shards - 1
        self._commit(cm, rec, n_shards, target, verdict, sig, now)

    def _commit(self, cm, rec, n_shards: int, target: int, verdict: str,
                sig: dict, now: float) -> None:
        from volcano_tpu_torch import obs

        if obs.enabled():
            with obs.span("autoscale:commit", cat="federation",
                          args={"from": n_shards, "target": target,
                                "direction": verdict}):
                self._commit_inner(cm, rec, n_shards, target, verdict,
                                   sig, now)
            return
        self._commit_inner(cm, rec, n_shards, target, verdict, sig, now)

    def _commit_inner(self, cm, rec, n_shards: int, target: int,
                      verdict: str, sig: dict, now: float) -> None:
        import json

        reason = (
            f"p99={sig['p99_ms']:.0f}ms pending={sig['pending']} "
            f"members={sig['live_members']}"
        )
        rec["nShards"] = target
        shards = rec.get("shards", {})
        for i in range(n_shards, target):
            # grown slices start unheld at renewTime 0: infinitely
            # orphaned by the expiry math, so the availability backstop
            # deals them out within ONE further lease TTL
            shards[str(i)] = {
                "holder": "", "renewTime": 0.0,
                "leaseDurationSeconds": 0.0,
            }
        for i in range(target, n_shards):
            shards.pop(str(i), None)
        rec["autoscale"] = {
            "enabled": True,
            "target": target,
            "lastChange": now,
            "direction": verdict,
            "reason": reason,
            "decisions": int((rec.get("autoscale") or {})
                             .get("decisions", 0)) + 1,
        }
        payload = {SHARD_MAP_KEY: json.dumps(rec, sort_keys=True)}
        from volcano_tpu_torch.client.apiserver import (
            AlreadyExistsError,
            ConflictError,
            NotFoundError,
        )

        try:
            cm.data = payload
            self.api.compare_and_update(cm, cm.metadata.resource_version)
        except (AlreadyExistsError, ConflictError, NotFoundError):
            return  # lost the CAS to a lease renewal — retry next tick
        self._streak = 0
        self._streak_dir = None
        metrics.register_autoscale_decision(verdict)
        with self._ctr_lock:
            self._decisions[verdict] = self._decisions.get(verdict, 0) + 1
        log.warning(
            "shard autoscale: %s -> %d shards (%s; %s)",
            n_shards, target, verdict, reason,
        )

    # ---- lifecycle ----

    def run(self) -> None:
        while not self._stop.is_set():
            try:
                self._tick()
            except ApiError as e:
                log.error("shard autoscale tick failed (%s): %s",
                          self.identity, e)
            self._stop.wait(
                self.policy.eval_period_s
                * (0.75 + 0.5 * self._jitter.random())
            )

    def start(self) -> "ShardAutoscaler":
        self._thread = threading.Thread(
            target=self.run, name=f"shard-autoscale-{self.identity}",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
