"""Scheduler loop — load conf, open session, run actions, close session.

The port of ``volcano_tpu/scheduler/scheduler.py``.  Reference:
pkg/scheduler/scheduler.go (a fixed-period wait.Until loop).  Every
cycle opens a session on the cache's snapshot, runs the policy's actions
in order and closes the session, cycle after cycle on one long-lived
cache: with ``gpu-allocate`` in the policy, the cache's change tracking
makes every full cycle after the first pack warm (ops/pack_cache.py)
onto planes resident on the card (ops/device_stage.py), and a cache
with ``snapshot_reuse`` hands each session the previous session's
untouched clones.

The event-driven mode (``micro_cycles=True``): the cache's event
handlers classify every change and tell the loop through a change
listener, so instead of a freshly submitted pod waiting out the next
fixed-period cycle, the loop sleeps on a condition variable and wakes
when the cache reports schedulable change.  A debounce window
(``micro_debounce_ms``) coalesces event storms into one micro-cycle;
full cycles still run every ``period`` for fair-share and gang
re-equilibration, and events whose class makes incremental treatment
pointless (a gang's PodGroup arriving — its members land as a storm
right behind it — or a node-set change, which invalidates the packed
planes wholesale) route straight to a full cycle, counted in
``volcano_full_cycle_fallbacks_total{cause}``.  A micro-cycle runs the
same session machinery over the same full snapshot as a full cycle, so
its binds equal a full cycle's over the same cache state.  Unlike the
reference, which leaves the loop periodic when the cache has no change
listeners, ``micro_cycles=True`` on such a cache raises ``TypeError``.

With ``restricted_sessions=True`` a micro-cycle whose policy lies
within ``incremental.subgraph.RESTRICTABLE_ACTIONS`` opens over only the
jobs with pending work, the share ledger's seed standing in for the
others' fair-share totals (O(pending) clones instead of O(resident)).
Such a session carries no pack epoch, so gpu-allocate packs it cold and
the kernel puts its planes on the card whole.  Every ``shadow_every``-th
restricted cycle also runs a store-inert full session over the same
snapshot and compares the binds (``volcano_share_ledger_drift_checks_total``);
a divergence is logged at error level, and raises ``ShadowDivergence``
with ``shadow_strict``.  A policy outside the restrictable set opens full
sessions.

An action's exception ends the cycle: ``close_session`` still runs, and
the exception propagates out of :meth:`Scheduler.run_once`.  That holds
for ``ExecutorFailed`` and ``CycleDeadlineExceeded`` from gpu-allocate,
which bind nothing — no cycle is finished on the host.  The next cycle
on the same cache starts clean: the failed cycle's pack, if it ran,
consumed its change epoch, and nothing changed since but what the new
epoch records.

The policy comes from ``scheduler_conf_path``, or from the port's
default policy (``enqueue, gpu-allocate, backfill``) when no path is
given.  Unlike the reference, a policy file that is missing or does not
parse raises out of ``run_once`` instead of switching the cycle to the
default policy.

Every cycle is a cycle of the trace recorder (``trace.get_recorder()``:
the shared null recorder unless tracing is enabled), with one
``action:<name>`` span per action; the record is journaled after the
cycle's elapsed time is stamped, also for a cycle whose session open
raised.

Either mode, the inter-cycle sleep is a condition wait: :meth:`stop`
(and, in event mode, an event) ends it at once.

With the flight recorder on (``obs.enable``), each cycle is a
``cycle:<trigger|full>`` span, the parent of the cycle's kernel phases,
commit flushes and bus requests.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional

from volcano_tpu_torch import actions as _actions  # noqa: F401 — registers actions
from volcano_tpu_torch import metrics
from volcano_tpu_torch import obs
from volcano_tpu_torch import plugins as _plugins  # noqa: F401 — registers plugin builders
from volcano_tpu_torch import trace
from volcano_tpu_torch.cache.interface import Cache
from volcano_tpu_torch.conf import (
    default_scheduler_conf,
    load_scheduler_conf,
    SchedulerConf,
)
from volcano_tpu_torch.faults import watchdog
from volcano_tpu_torch.framework import close_session, get_action, open_session
from volcano_tpu_torch.framework.interface import Action
from volcano_tpu_torch.incremental import subgraph
from volcano_tpu_torch.utils.gcutil import gc_quiesce
from volcano_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

DEFAULT_SCHEDULE_PERIOD = 1.0  # options.go:28


class Scheduler:
    """scheduler.go:45-106."""

    #: event categories that route to an immediate full cycle instead of
    #: a micro-cycle, with the fallback-counter cause they record
    _FULL_CAUSES = {"gang": "gang-arrival", "topology": "topology"}

    def __init__(
        self,
        cache: Cache,
        scheduler_conf_path: str = "",
        period: float = DEFAULT_SCHEDULE_PERIOD,
        gc_quiesce_period: int = 0,
        cycle_deadline_ms: Optional[float] = None,
        micro_cycles: bool = False,
        micro_debounce_ms: float = 5.0,
        restricted_sessions: bool = False,
        shadow_every: int = 16,
        shadow_strict: bool = False,
    ):
        self.cache = cache
        #: cycle watchdog: arms a process-global wall-clock budget; the
        #: device phase (ops/executor) runs under the remaining budget and
        #: an overrun raises CycleDeadlineExceeded out of the cycle.  None
        #: leaves the global watchdog untouched (so auxiliary Scheduler
        #: instances can't disarm a configured deadline).
        if cycle_deadline_ms is not None:
            watchdog.configure_deadline(cycle_deadline_ms)
        self.scheduler_conf_path = scheduler_conf_path
        self.period = period
        #: every N cycles, collect + freeze gen-2 survivors so steady-state
        #: sessions stop re-traversing the long-lived cache graph (at 50k
        #: pods the cache holds millions of objects; a gen-2 collection
        #: mid-session costs hundreds of ms).  0 = off.  Each quiesce
        #: thaws first, so cyclic garbage frozen earlier is reclaimed —
        #: delayed by at most N cycles, never leaked.
        self.gc_quiesce_period = gc_quiesce_period
        self._cycles_since_quiesce = 0
        self._stopped = False

        # ---- event-driven micro-cycles ----
        self.micro_cycles = micro_cycles
        self.micro_debounce_s = max(micro_debounce_ms, 0.0) / 1e3
        #: wake condition the inter-cycle sleep parks on; cache change
        #: listeners (and stop()) notify it
        self._wake = threading.Condition()
        #: category → events seen since the last cycle consumed them
        self._pending_triggers: Dict[str, int] = {}  # guarded-by: self._wake
        #: fallback cause pending a full cycle (gang arrival / topology
        #: change), or None
        self._full_cause: Optional[str] = None  # guarded-by: self._wake
        self._listener_attached = False
        #: post-cycle hook, invoked after every run_once outside the
        #: session (work that must see the cycle's outcome but never run
        #: concurrently with a session).  Exceptions are logged, never
        #: kill the loop.
        self.post_cycle: Optional[Callable[[], None]] = None
        # ---- restricted-subgraph sessions (incremental/subgraph.py) ----
        #: opt-in: micro-cycles whose conf is entirely within
        #: RESTRICTABLE_ACTIONS open over only the jobs with schedulable
        #: work plus the share ledger's seed — O(pending) instead of
        #: O(resident).  Periodic full cycles are untouched.
        self.restricted_sessions = restricted_sessions
        #: shadow cross-check sampling: every Nth restricted cycle also
        #: runs a store-inert FULL session over the same snapshot and
        #: fails on ANY binding divergence.  1 = every restricted cycle
        #: (the test setting), 0 = never.
        self.shadow_every = shadow_every
        #: strict mode raises ShadowDivergence instead of only counting
        #: it in volcano_share_ledger_drift_checks_total{result}
        self.shadow_strict = shadow_strict
        self._restricted_since_shadow = 0
        #: cycles run by kind, and the cross-checks' verdicts
        self.micro_cycles_run = 0
        self.full_cycles_run = 0
        self.restricted_cycles_run = 0
        self.shadow_checks_run = 0
        self.shadow_divergences = 0
        #: the cycle correlation id's sequence (trace.current_cycle)
        self._cycle_seq = 0
        #: cumulative wall time spent opening sessions (snapshot + plugin
        #: on_session_open; sampled shadow cross-checks excluded) and the
        #: count behind the mean
        self.session_open_seconds = 0.0
        self.sessions_opened = 0
        #: the restricted-only slice of the above, shadow-audited cycles
        #: excluded (they pay an O(resident) shadow snapshot), and its
        #: per-cycle samples (bounded) for a median
        self.restricted_open_seconds = 0.0
        self.restricted_open_cycles = 0
        self.restricted_open_samples: List[float] = []
        #: host-clock seconds of the last cycle's steps: open_s, each
        #: action's (actions_s, by name), close_s and e2e_s (the cycle,
        #: gc quiesce excluded)
        self.last_cycle: dict = {}
        #: conf hot-reload cache: (mtime_ns, size) of the last parse
        self._conf_key = None
        self._conf_cached: Optional[SchedulerConf] = None
        self._default_conf: Optional[SchedulerConf] = None
        if micro_cycles:
            self.attach_cache_events()

    # ---- event wake plumbing ----

    def attach_cache_events(self) -> None:
        """Register this scheduler as the cache's change listener
        (idempotent).  A cache without the listener surface raises
        ``TypeError``: the reference leaves such a loop periodic without
        a word, which would run an event-driven deployment on the period
        alone."""
        if self._listener_attached:
            return
        add = getattr(self.cache, "add_change_listener", None)
        if add is None:
            raise TypeError(
                f"micro_cycles needs a cache with change listeners; "
                f"{type(self.cache).__name__} has no add_change_listener"
            )
        add(self.notify_event)
        self._listener_attached = True

    def notify_event(self, category: str) -> None:
        """Cache change listener: record the trigger and wake the loop.
        Runs on whatever thread delivered the event — must stay cheap
        and lock only the wake condition."""
        with self._wake:
            cause = self._FULL_CAUSES.get(category)
            if cause is not None and self._full_cause is None:
                self._full_cause = cause
            self._pending_triggers[category] = (
                self._pending_triggers.get(category, 0) + 1
            )
            self._wake.notify_all()

    def _drain_triggers(self) -> Dict[str, int]:
        """Capture-and-clear the pending trigger set.  Called at cycle
        START, so events landing while the cycle runs re-arm the wake
        instead of being silently consumed by a snapshot that predates
        them."""
        with self._wake:
            pending, self._pending_triggers = self._pending_triggers, {}
            return pending

    def _take_full_cause(self) -> Optional[str]:
        with self._wake:
            cause, self._full_cause = self._full_cause, None
            return cause

    def _full_due(self) -> bool:
        with self._wake:
            return self._full_cause is not None

    def _wait_wake(self, timeout: float, for_events: bool) -> bool:
        """Park until ``timeout`` elapses — or, with ``for_events``,
        until a trigger arrives — always waking immediately on stop().
        Returns True when an event (or pending full cause) is waiting."""
        deadline = time.monotonic() + timeout
        with self._wake:
            while not self._stopped:
                if for_events and (
                    self._pending_triggers or self._full_cause is not None
                ):
                    return True
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._wake.wait(remaining)
            return bool(self._pending_triggers) or self._full_cause is not None

    @staticmethod
    def _trigger_label(pending: Dict[str, int]) -> str:
        """Metric label for a coalesced wake: the single category, or
        ``mixed`` when the debounce window batched several kinds."""
        cats = [c for c in pending if c not in ("gang", "topology")] or list(
            pending
        )
        return cats[0] if len(cats) == 1 else "mixed"

    def _load_conf(self) -> SchedulerConf:
        """Hot-reload every cycle (scheduler.go:77,89-106) — but parse
        only when the file actually changed (the mtime and size of the
        last parse).  With no path, the default policy.  A policy file
        that is missing or does not parse raises, and the cycle with it:
        the reference falls back to its default policy there, which
        would run the cycle on other actions than the file names."""
        if not self.scheduler_conf_path:
            if self._default_conf is None:
                self._default_conf = default_scheduler_conf()
            return self._default_conf
        st = os.stat(self.scheduler_conf_path)
        key = (st.st_mtime_ns, st.st_size)
        if self._conf_key == key and self._conf_cached is not None:
            return self._conf_cached
        with open(self.scheduler_conf_path) as f:
            conf = load_scheduler_conf(f.read())
        self._conf_key, self._conf_cached = key, conf
        return conf

    def _resolve_actions(self, conf: SchedulerConf) -> List[Action]:
        out = []
        for name in conf.actions:
            action = get_action(name)
            if action is None:
                log.error("Failed to find action %s", name)
                continue
            out.append(action)
        return out

    def run_once(self, trigger: str = "full") -> None:
        """scheduler.go:71-87: one cycle — open a session, run the
        actions, close the session (also when an action raises, whose
        exception then propagates).  ``trigger`` is "full" for periodic
        or forced full cycles, else the coalesced change category that
        woke an event-driven micro-cycle (the
        ``volcano_micro_cycles_total`` label).  A micro-cycle opens a
        restricted session when ``restricted_sessions`` is on and the
        policy is restrictable, else the same full session a full cycle
        opens."""
        micro = trigger != "full"
        # consumed by gpu-allocate to attribute pack-level cold fallbacks
        # (registry overflow etc.) during a micro-triggered cycle; plain
        # attribute, single-threaded cycle-loop discipline
        self.cache.in_micro_cycle = micro
        watchdog.begin_cycle()  # stamp the cycle-deadline budget
        rec = trace.get_recorder()
        cid = rec.begin_cycle()
        # cycle correlation id: the recorder's cycle id when tracing,
        # else a local sequence
        self._cycle_seq += 1
        cycle_no = cid if cid >= 0 else self._cycle_seq
        trace.set_current_cycle(cycle_no)
        # flight-recorder cycle span: a process-scope span that per-pod
        # bind/commit spans parent to, and the ambient context every
        # bus request this cycle issues propagates.  Entered by hand so
        # the try/finally below stays as it is; with the recorder off
        # this is the shared null span
        obs_span = obs.span(f"cycle:{trigger if micro else 'full'}", cat="scheduler",
                            args={"cycle": cycle_no})
        obs_span.__enter__()
        start = time.perf_counter()
        ssn = None
        rec_cache = None
        shadow_outcome = None
        self.last_cycle = record = {"actions_s": {}}
        try:
            conf = self._load_conf()
            actions = self._resolve_actions(conf)

            restricted = (
                micro
                and self.restricted_sessions
                and subgraph.conf_is_restrictable(conf.actions)
                and getattr(self.cache, "share_ledger", None) is not None
            )
            if restricted:
                shadow = self.shadow_every > 0 and (
                    self._restricted_since_shadow + 1 >= self.shadow_every
                )
                # one atomic snapshot feeds BOTH the restricted session
                # and (when sampled) its shadow full-session cross-check
                # — the restricted job set is computed inside the cache
                # mutex, so churn between two snapshots can never read
                # as a false divergence
                t_open = time.perf_counter()
                snap = self.cache.snapshot(
                    scope="shadow" if shadow else "restricted"
                )
                open_s = time.perf_counter() - t_open
                if shadow:
                    self._restricted_since_shadow = 0
                    shadow_outcome = subgraph.run_shadow_session(
                        self.cache, snap, conf.tiers,
                        conf.configurations, actions,
                    )
                else:
                    self._restricted_since_shadow += 1
                t_open = time.perf_counter()
                rec_cache = subgraph.RecordingCache(self.cache)
                ssn = open_session(
                    rec_cache, conf.tiers, conf.configurations,
                    snapshot=snap, job_uids=snap.restricted_uids,
                )
                # the sampled shadow run between the two stamps is
                # soundness auditing, not steady-state open cost
                open_s += time.perf_counter() - t_open
                if not shadow:
                    self.restricted_open_seconds += open_s
                    self.restricted_open_cycles += 1
                    if len(self.restricted_open_samples) < 65536:
                        self.restricted_open_samples.append(open_s)
                self.restricted_cycles_run += 1
                metrics.register_session_scope("restricted")
            else:
                t_open = time.perf_counter()
                ssn = open_session(self.cache, conf.tiers, conf.configurations)
                open_s = time.perf_counter() - t_open
                metrics.register_session_scope("full")
            record["open_s"] = open_s
            self.session_open_seconds += open_s
            self.sessions_opened += 1
            for action in actions:
                action_start = time.perf_counter()
                action.execute(ssn)
                action_s = time.perf_counter() - action_start
                record["actions_s"][action.name()] = action_s
                metrics.update_action_duration(action.name(), action_s)
                if rec.enabled:
                    rec.complete(
                        f"action:{action.name()}", "action",
                        action_start, action_s,
                    )
            if shadow_outcome is not None:
                self.shadow_checks_run += 1
                shadow_binds, shadow_evicts = shadow_outcome
                diffs = subgraph.compare_outcomes(
                    rec_cache.binds, rec_cache.evicts,
                    shadow_binds, shadow_evicts,
                )
                if diffs is None:
                    metrics.register_share_ledger_drift_check("ok")
                else:
                    self.shadow_divergences += 1
                    metrics.register_share_ledger_drift_check("divergence")
                    log.error(
                        "restricted session diverged from shadow full "
                        "session (%d diffs): %s",
                        len(diffs), "; ".join(diffs),
                    )
                    if self.shadow_strict:
                        # raised inside the try so close_session still
                        # runs for the (real) restricted session
                        raise subgraph.ShadowDivergence(diffs)
        finally:
            try:
                # ssn is None when open_session itself crashed (a plugin
                # on_session_open is the likeliest site) — that cycle's
                # spans still get journaled below
                if ssn is not None:
                    t_close = time.perf_counter()
                    close_session(ssn)
                    record["close_s"] = time.perf_counter() - t_close
            finally:
                # stamp e2e BEFORE the quiesce: the collection pause is
                # maintenance, not scheduling latency
                record["e2e_s"] = elapsed = time.perf_counter() - start
                # in a finally so persistently-failing cycles still
                # thaw+collect previously frozen dead objects
                if self.gc_quiesce_period > 0:
                    self._cycles_since_quiesce += 1
                    if self._cycles_since_quiesce >= self.gc_quiesce_period:
                        self._cycles_since_quiesce = 0
                        gc_quiesce()
                # journal flush sits outside the e2e latency stamp for
                # the same reason the gc quiesce does (maintenance I/O),
                # but in the innermost finally: a cycle that crashes in
                # session open, an action, OR session close is exactly
                # the one the forensics journal must not drop
                rec.end_cycle(duration_s=elapsed)
                obs_span.__exit__(None, None, None)
                self.cache.in_micro_cycle = False
        metrics.update_e2e_duration(elapsed)
        counts = getattr(self.cache, "ledger_counts", None)
        if counts is not None:
            resident, schedulable = counts()
            metrics.update_resident_jobs(resident)
            metrics.update_schedulable_jobs(schedulable)
        if micro:
            self.micro_cycles_run += 1
            metrics.register_micro_cycle(trigger)
            metrics.update_micro_cycle_duration(elapsed)
        else:
            self.full_cycles_run += 1
        if self.post_cycle is not None:
            try:
                self.post_cycle()
            except Exception as e:  # noqa: BLE001 — a hook failure must
                # not take the scheduling loop down with it
                log.error("post-cycle hook failed: %s", e)

    def run_cycle_window(self, max_cycles: Optional[int] = None) -> int:
        """One full-cycle period of the event-driven loop: a full cycle
        now (counting the fallback cause when an event class forced it),
        then debounced micro-cycles on change arrival until the next
        full cycle is due.  Returns the number of cycles run."""
        window_start = time.monotonic()
        cause = self._take_full_cause()
        if cause is not None:
            metrics.register_full_cycle_fallback(cause)
        self._drain_triggers()  # the full cycle serves everything pending
        self.run_once()
        ran = 1
        deadline = window_start + self.period
        while not self._stopped and (max_cycles is None or ran < max_cycles):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            if not self._wait_wake(remaining, for_events=True):
                break  # period elapsed quietly — window ends
            if self._full_due():
                break  # gang/topology event: next window's full cycle
            if self.micro_debounce_s > 0:
                # debounce: let the rest of the storm land, then one
                # micro-cycle serves the whole coalesced batch
                self._wait_wake(self.micro_debounce_s, for_events=False)
                if self._stopped:
                    break
                if self._full_due():
                    break
            pending = self._drain_triggers()
            if not pending:
                continue
            if "task" not in pending and not self._has_pending_work():
                # capacity-freed / object churn woke us but nothing is
                # pending — a session would bind nothing.  The next
                # event (or the periodic full cycle) re-checks.
                continue
            self.run_once(trigger=self._trigger_label(pending))
            ran += 1
        return ran

    def _has_pending_work(self) -> bool:
        check = getattr(self.cache, "has_schedulable_pending", None)
        return True if check is None else bool(check())

    def run(self, cycles: Optional[int] = None) -> None:
        """scheduler.go:63-69 — wait.Until(runOnce, period): ``cycles``
        cycles (forever when None, until :meth:`stop`), one a period; in
        micro mode, the event-driven window loop instead."""
        self.cache.run()
        self.cache.wait_for_cache_sync()
        if self.micro_cycles:
            self.attach_cache_events()
        n = 0
        while not self._stopped:
            if self.micro_cycles:
                n += self.run_cycle_window(
                    max_cycles=None if cycles is None else cycles - n
                )
                if cycles is not None and n >= cycles:
                    break
                continue
            cycle_start = time.monotonic()
            self.run_once()
            n += 1
            if cycles is not None and n >= cycles:
                break
            # interruptible: shutdown does not wait out the period
            self._wait_wake(
                self.period - (time.monotonic() - cycle_start),
                for_events=False,
            )

    def stop(self) -> None:
        self._stopped = True
        with self._wake:
            self._wake.notify_all()
