"""``FederatedScheduler`` — one federation member, fully assembled.

A copy of ``volcano_tpu/federation/runtime.py``.  Its ``Scheduler`` is
the port's, so a member's binding cycles run gpu-allocate on the
session kernel (``csrc/session_kernel.cu``) unless the caller registered
the action's CPU instance.

Composition (all existing machinery, re-pointed at a slice):

    informer feed ─▶ ShardInformerFilter ─▶ SchedulerCache ─▶ Scheduler
                          ▲      │ledger                        │post_cycle
    ShardLeaseManager ────┘      ├──────────▶ SpilloverController
                                 └──────────▶ GangBroker (txn_commit)

The scheduler loop itself is untouched: micro-cycles, the pipelined
commit plane, snapshot reuse, pack caching all run exactly as in the
single-process build, just over the owned subset.  ``--shards 1`` is
therefore bit-identical to the non-federated scheduler by construction
(the filter passes everything, spillover is a no-op) — and the tests
pin it through ``trace.replay.verify``.

One difference from the reference: the lease thread only hands an
ownership transition over, to the member's transition thread, which
applies them in order (``ShardState`` and the filter's replay or drop),
and a cycle waits while one is queued or applied.  The reference relists
the whole store on the lease thread when it acquires a shard, renewing
nothing meanwhile (13,501 objects over the wire outlast the binary's
2.0 s TTL, and two members then take each other's shards in turn), and a
cycle that runs while that relist has sent a slice's nodes but not yet
their pods places pods into room that is already taken.

The ``shard.kill`` fault point makes shard-loss chaos deterministic:
when the seeded plane fires it at the post-cycle seam, an in-process
member crash-stops (leases left to expire — the SIGKILL-observable
behavior) and a daemon-hosted member hard-exits the OS process.
"""

from __future__ import annotations

import contextlib
import threading
from collections import deque
from typing import Optional

from volcano_tpu_torch.cache import SchedulerCache
from volcano_tpu_torch.client import SchedulerClient
from volcano_tpu_torch.federation.broker import GangBroker
from volcano_tpu_torch.federation.filter import ShardInformerFilter
from volcano_tpu_torch.federation.leases import ShardLeaseManager
from volcano_tpu_torch.federation.sharding import ShardState
from volcano_tpu_torch.federation.sketches import SketchSolicitor
from volcano_tpu_torch.federation.spillover import SpilloverController
from volcano_tpu_torch.scheduler.scheduler import Scheduler
from volcano_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


class FederatedScheduler:
    """Cache + filter + leases + spillover + scheduler for one member.

    ``api`` is any APIServer surface (in-process or RemoteAPIServer);
    ``kill_mode`` governs the ``shard.kill`` fault point: ``"crash"``
    (in-process harnesses: stop without releasing leases) or
    ``"exit"`` (daemon processes: ``os._exit`` — the real SIGKILL
    twin).
    """

    def __init__(
        self,
        api,
        identity: str,
        n_shards: int,
        scheduler_conf_path: str = "",
        period: float = 1.0,
        micro_cycles: bool = False,
        micro_debounce_ms: float = 5.0,
        lease_duration: float = 2.0,
        lease_retry_period: float = 0.2,
        pipelined_commit: bool = False,
        snapshot_reuse: bool = False,
        scheduler_name: str = "volcano-tpu",
        spill_after: int = 2,
        gang_broker: bool = True,
        gang_assemble_after: int = 2,
        kill_mode: str = "crash",
        autoscale=None,
        restricted_sessions: bool = False,
        shadow_every: int = 16,
        shadow_strict: bool = False,
    ):
        self.api = api
        self.identity = identity
        self.kill_mode = kill_mode
        self.client = SchedulerClient(api)
        self.cache = SchedulerCache(
            client=self.client,
            scheduler_name=scheduler_name,
            pipelined_commit=pipelined_commit,
            snapshot_reuse=snapshot_reuse,
        )
        self.state = ShardState(n_shards)
        self.filter = ShardInformerFilter(self.cache, self.state, lister=api)
        self.cache.set_informer_sink(self.filter)
        #: ONE solicitor shared by both cross-shard bind paths, so the
        #: verified/stale counters published on the stats blob (and
        #: rendered by ``vtctl shards``) aggregate the whole member
        self.sketches = SketchSolicitor(api, self.state)
        self.spillover = SpilloverController(
            self.cache, self.state, self.filter, api,
            spill_after=spill_after,
            sketches=self.sketches,
        )
        #: cross-shard gang assembly (txn_commit); ``--gang-broker off``
        #: keeps the refusal semantics — a below-minMember gang
        #: stays Pending at home, honestly
        self.broker = GangBroker(
            self.cache, self.state, self.filter, api,
            assemble_after=gang_assemble_after,
            kill_hook=self._hard_kill,
            sketches=self.sketches,
        ) if gang_broker else None
        #: SLO-driven shard autoscaling (federation/autoscale.py):
        #: ``autoscale`` is an AutoscalePolicy (or True for defaults).
        #: Every member runs the controller object; only the one
        #: holding shard 0's lease evaluates — and every member's
        #: lease manager runs ELASTIC (adopts the map's count) so the
        #: controller's decisions actually move the fleet.
        self.autoscaler = None
        if autoscale:
            from volcano_tpu_torch.federation.autoscale import (
                AutoscalePolicy,
                ShardAutoscaler,
            )

            policy = (
                autoscale if isinstance(autoscale, AutoscalePolicy)
                else AutoscalePolicy()
            )
            self.autoscaler = ShardAutoscaler(
                api, self.state, identity, policy=policy,
            )
        self.leases = ShardLeaseManager(
            api, identity, n_shards,
            lease_duration=lease_duration,
            retry_period=lease_retry_period,
            on_acquire=self._on_acquire,
            on_release=self._on_release,
            stats=self._stats,
            elastic=self.autoscaler is not None,
            on_resize=self._on_resize,
        )
        self.scheduler = Scheduler(
            self.cache,
            scheduler_conf_path=scheduler_conf_path,
            period=period,
            micro_cycles=micro_cycles,
            micro_debounce_ms=micro_debounce_ms,
            restricted_sessions=restricted_sessions,
            shadow_every=shadow_every,
            shadow_strict=shadow_strict,
        )
        self.scheduler.post_cycle = self._post_cycle
        self.scheduler.cycle_guard = self._cycle_guard
        #: ownership transitions handed over by the lease thread, each
        #: ``(apply, arg)``, applied in order on the transition thread
        self._xfer = threading.Condition()
        self._xfer_queue: deque = deque()  # guarded-by: self._xfer
        #: transitions queued or being applied; a cycle waits for 0
        self._xfer_pending = 0  # guarded-by: self._xfer
        #: a cycle is running; a transition waits for its end
        self._cycling = False  # guarded-by: self._xfer
        self._xfer_stop = False  # guarded-by: self._xfer
        #: None until start(): transitions apply inline on the calling
        #: thread (harnesses that drive the lease machine by hand)
        self._xfer_thread: Optional[threading.Thread] = None
        #: the capacity sketch last cut with no transition queued or
        #: being applied (lease-thread state)
        self._sketch: Optional[dict] = None
        self._owned_event = threading.Event()
        self._crashed = False
        #: schedulable-pending depth from the last post-cycle view —
        #: the autoscaler's queue-depth signal, published on the lease
        #: heartbeat.  Written on the scheduler thread, read on the
        #: lease-manager thread: a plain int (GIL-atomic), staleness of
        #: one cycle is exactly what a load signal tolerates.
        self._last_pending = 0
        #: this member's /metrics address, published on the lease-map
        #: stats blob so `vtctl top` discovers the whole federation's
        #: scrape targets from the shard map alone (set by the daemon
        #: once its serving port is bound; empty = not serving)
        self.metrics_addr = ""

    # ---- lease callbacks (lease-manager thread) ----

    def _on_acquire(self, shard: int) -> None:
        self._transition(self._apply_acquire, shard)

    def _on_release(self, shard: int) -> None:
        self._transition(self._apply_release, shard)

    def _on_resize(self, n_shards: int) -> None:
        self._transition(self._apply_resize, n_shards)

    def _transition(self, apply, arg, once: bool = False) -> None:
        """Hand one ownership transition to the transition thread (or
        apply it inline when that thread is not running); ``once`` skips
        it while the same one is still queued."""
        with self._xfer:
            if self._xfer_thread is not None and not self._xfer_stop:
                if not (once and (apply, arg) in self._xfer_queue):
                    self._xfer_queue.append((apply, arg))
                    self._xfer_pending += 1
                    self._xfer.notify_all()
                return
        apply(arg)

    def _transitions(self) -> None:
        """The transition thread: apply queued transitions in order,
        each between cycles, the queue drained before it exits."""
        while True:
            with self._xfer:
                while not (self._xfer_stop or (
                    self._xfer_queue and not self._cycling
                )):
                    self._xfer.wait()
                if not self._xfer_queue:
                    return
                apply, arg = self._xfer_queue.popleft()
            try:
                apply(arg)
            except Exception as e:  # noqa: BLE001 — one failed replay
                # must not strand the transitions queued behind it
                log.error("shard transition %s(%s) failed for %s: %s",
                          apply.__name__, arg, self.identity, e)
            finally:
                with self._xfer:
                    self._xfer_pending -= 1
                    self._xfer.notify_all()

    @contextlib.contextmanager
    def _cycle_guard(self):
        """``Scheduler.cycle_guard``: a cycle starts only once every
        handed-over transition is applied, and none is applied while it
        runs (a relist half done would show a slice's nodes without the
        pods that fill them)."""
        with self._xfer:
            while self._xfer_pending and not self._xfer_stop:
                self._xfer.wait()
            self._cycling = True
        try:
            yield
        finally:
            with self._xfer:
                self._cycling = False
                self._xfer.notify_all()

    # ---- ownership transitions (transition thread) ----

    def _apply_acquire(self, shard: int) -> None:
        self.state.acquire(shard)
        self.filter.on_acquire(shard)
        self._owned_event.set()
        # new nodes routed a "topology" wake already; jobs relisted via
        # add_pod woke "task" — nothing further needed here

    def _apply_release(self, shard: int) -> None:
        self.state.release(shard)
        self.filter.on_release(shard)
        if not self.state.owned():
            self._owned_event.clear()

    def _apply_resize(self, n_shards: int) -> None:
        """Elastic re-key: the autoscaler moved the map's shard count.
        Every applied shard was already released through the callbacks
        above; adopt the new partition and let the claim loop deal us
        back in."""
        self.state.set_n_shards(n_shards)
        self._owned_event.clear()

    def _retry_relists(self, _arg) -> None:
        self.filter.retry_pending_relists()

    def _stats(self) -> dict:
        # piggybacks on the renew tick: hand any failed relist to the
        # transition thread for a retry, then publish this member's
        # observability blob into the map object.  The free-capacity
        # sketch rides here too — what foreign gang brokers read instead
        # of walking an O(cluster) ledger for shards that plainly have
        # no room.
        if self.filter.has_pending_relists():
            self._transition(self._retry_relists, None, once=True)
        # a sketch cut while a transition is applied could show a
        # slice's nodes without the pods that fill them: the last one
        # cut between transitions is published instead (only this
        # thread queues a transition, so none starts meanwhile)
        with self._xfer:
            settled = not self._xfer_pending
        if settled or self._sketch is None:
            self._sketch = self.filter.capacity_sketch()
        out = {
            "nodesOwned": self.filter.owned_node_count(),
            "spillover": self.spillover.counters(),
            "rebalances": self.leases.rebalances,
            "sketch": self._sketch,
            "sketchChecks": self.sketches.counters(),
        }
        if self.metrics_addr:
            out["metricsAddr"] = self.metrics_addr
        # an active incident capture boost is echoed on the heartbeat
        # so `vtctl shards` shows which members are recording at full
        # fidelity, and why (the record itself lives in the telemetry
        # namespace — this is pure observability)
        from volcano_tpu_torch import obs

        exporter = obs.get_exporter()
        if exporter is not None:
            boost = exporter.boost_record()
            if boost is not None:
                out["captureBoost"] = boost
        if self.broker is not None:
            out["gangAssembly"] = self.broker.counters()
        if self.autoscaler is not None:
            # the autoscaler's two load signals ride the heartbeat the
            # members already pay for: schedulable-pending depth and
            # the cumulative submit→bind buckets the controller windows
            from volcano_tpu_torch.federation.autoscale import latency_snapshot

            out["pendingTasks"] = self._last_pending
            lat = latency_snapshot()
            if lat is not None:
                out["latency"] = lat
            out["autoscale"] = self.autoscaler.counters()
        return out

    # ---- scheduler hook ----

    def _post_cycle(self) -> None:
        from volcano_tpu_torch import faults

        fp = faults.get_plane()
        if fp.enabled and fp.should("shard.kill"):
            log.error("shard.kill fired: %s going down hard", self.identity)
            self._hard_kill()
            return
        # one O(jobs) pending scan shared by all three consumers —
        # spillover and broker eligibility sets are disjoint
        # (spillover: satisfied/solo gangs only; broker: below-
        # minMember gangs only; the broker re-verifies every claim
        # against store truth anyway), and the autoscaler only counts
        view = (
            self.cache.pending_spill_view()
            if self.state.n_shards > 1 or self.autoscaler is not None
            else []
        )
        if self.autoscaler is not None:
            from volcano_tpu_torch.federation.autoscale import owned_pending

            # scoped to OWNED home shards: per-member reports must
            # partition the fleet backlog, not multiply it (at one
            # shard every member's raw view IS the whole backlog)
            self._last_pending = owned_pending(
                view, self.state.owned(), self.state.n_shards
            )
        self.spillover.run_once(view)
        if self.broker is not None and not self._crashed:
            self.broker.run_once(view)

    def _hard_kill(self) -> None:
        """SIGKILL semantics shared by ``shard.kill`` and the broker's
        ``gang.kill_mid_assembly`` chaos point: hard-exit for daemon
        processes, crash-stop (leases left to expire) in-process."""
        if self.kill_mode == "exit":
            import os

            os._exit(137)  # SIGKILL's exit code — no cleanup, no
            # lease release; survivors absorb after expiry
        self.crash()

    # ---- lifecycle ----

    def start(self) -> "FederatedScheduler":
        """Informers + transition thread + lease loop.  The scheduler
        loop itself is the caller's (daemon ``_work`` / ``run()`` below
        / a test driving ``run_once`` by hand)."""
        self.cache.run()
        with self._xfer:
            self._xfer_thread = threading.Thread(
                target=self._transitions,
                name=f"shard-transitions-{self.identity}", daemon=True,
            )
        self._xfer_thread.start()
        self.leases.start()
        if self.autoscaler is not None:
            self.autoscaler.start()
        return self

    def wait_owned(self, timeout: float = 10.0) -> bool:
        """Gate for harnesses: block until this member owns ≥1 shard."""
        return self._owned_event.wait(timeout)

    def run(self, cycles: Optional[int] = None) -> None:
        self.scheduler.run(cycles=cycles)

    def stop(self) -> None:
        """Graceful: release shards so peers take over immediately."""
        self.scheduler.stop()
        if self.autoscaler is not None:
            self.autoscaler.stop()
        self.leases.stop(release=True)
        self._stop_transitions()
        self.cache.stop_commit_plane()

    def _stop_transitions(self) -> None:
        """Apply what the lease loop handed over last (its final
        release of every shard), then end the transition thread."""
        with self._xfer:
            self._xfer_stop = True
            self._xfer.notify_all()
            thread = self._xfer_thread
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=5)

    def crash(self) -> None:
        """SIGKILL semantics for in-process members: stop scheduling
        and renewing but leave every lease to EXPIRE — the takeover
        path the chaos tests exercise."""
        self._crashed = True
        self.scheduler.stop()
        if self.autoscaler is not None:
            self.autoscaler.stop()
        self.leases.stop(release=False)
        self._stop_transitions()
        self.cache.stop_commit_plane()
