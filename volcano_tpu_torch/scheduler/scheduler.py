"""Scheduler loop — load conf, open session, run actions, close session.

The port of ``volcano_tpu/scheduler/scheduler.py`` in its fixed-period
mode.  Reference: pkg/scheduler/scheduler.go (a fixed-period wait.Until
loop).  Every cycle opens a session on the cache's snapshot, runs the
policy's actions in order and closes the session, cycle after cycle on
one long-lived cache: with ``gpu-allocate`` in the policy, the cache's
change tracking makes every cycle after the first pack warm
(ops/pack_cache.py) onto planes resident on the card
(ops/device_stage.py), and a cache with ``snapshot_reuse`` hands each
session the previous session's untouched clones.

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

Not present in the port yet: the event-driven micro-cycles with their
debounced wake (``micro_cycles``, ``attach_cache_events``,
``run_cycle_window``), which need the cache's change listeners;
restricted and shadow sessions; and the flight recorder's spans around
the cycle (``volcano_tpu/obs``, which needs the bus).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, List, Optional

from volcano_tpu_torch import actions as _actions  # noqa: F401 — registers actions
from volcano_tpu_torch import metrics
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
from volcano_tpu_torch.utils.gcutil import gc_quiesce
from volcano_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

DEFAULT_SCHEDULE_PERIOD = 1.0  # options.go:28


class Scheduler:
    """scheduler.go:45-106."""

    def __init__(
        self,
        cache: Cache,
        scheduler_conf_path: str = "",
        period: float = DEFAULT_SCHEDULE_PERIOD,
        gc_quiesce_period: int = 0,
        cycle_deadline_ms: Optional[float] = None,
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
        #: the inter-cycle sleep parks here; stop() notifies it
        self._wake = threading.Condition()
        #: post-cycle hook, invoked after every run_once outside the
        #: session (work that must see the cycle's outcome but never run
        #: concurrently with a session).  Exceptions are logged, never
        #: kill the loop.
        self.post_cycle: Optional[Callable[[], None]] = None
        #: cycles run, and the cumulative wall time spent opening sessions
        #: (snapshot + plugin on_session_open) with its count
        self.full_cycles_run = 0
        #: the cycle correlation id's sequence (trace.current_cycle)
        self._cycle_seq = 0
        self.session_open_seconds = 0.0
        self.sessions_opened = 0
        #: host-clock seconds of the last cycle's steps: open_s, each
        #: action's (actions_s, by name), close_s and e2e_s (the cycle,
        #: gc quiesce excluded)
        self.last_cycle: dict = {}
        #: conf hot-reload cache: (mtime_ns, size) of the last parse
        self._conf_key = None
        self._conf_cached: Optional[SchedulerConf] = None
        self._default_conf: Optional[SchedulerConf] = None

    def _wait(self, timeout: float) -> None:
        """Park until ``timeout`` elapses, waking at once on stop()."""
        deadline = time.monotonic() + timeout
        with self._wake:
            while not self._stopped:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._wake.wait(remaining)

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

    def run_once(self) -> None:
        """scheduler.go:71-87: one cycle — open a session, run the
        actions, close the session (also when an action raises, whose
        exception then propagates)."""
        watchdog.begin_cycle()  # stamp the cycle-deadline budget
        rec = trace.get_recorder()
        cid = rec.begin_cycle()
        # cycle correlation id: the recorder's cycle id when tracing,
        # else a local sequence
        self._cycle_seq += 1
        trace.set_current_cycle(cid if cid >= 0 else self._cycle_seq)
        start = time.perf_counter()
        ssn = None
        self.last_cycle = record = {"actions_s": {}}
        try:
            conf = self._load_conf()
            actions = self._resolve_actions(conf)
            t_open = time.perf_counter()
            ssn = open_session(self.cache, conf.tiers, conf.configurations)
            record["open_s"] = open_s = time.perf_counter() - t_open
            self.session_open_seconds += open_s
            self.sessions_opened += 1
            metrics.register_session_scope("full")
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
        metrics.update_e2e_duration(elapsed)
        self.full_cycles_run += 1
        if self.post_cycle is not None:
            try:
                self.post_cycle()
            except Exception as e:  # noqa: BLE001 — a hook failure must
                # not take the scheduling loop down with it
                log.error("post-cycle hook failed: %s", e)

    def run(self, cycles: Optional[int] = None) -> None:
        """scheduler.go:63-69 — wait.Until(runOnce, period): ``cycles``
        cycles (forever when None, until :meth:`stop`), one a period."""
        self.cache.run()
        self.cache.wait_for_cache_sync()
        n = 0
        while not self._stopped:
            cycle_start = time.monotonic()
            self.run_once()
            n += 1
            if cycles is not None and n >= cycles:
                break
            # interruptible: shutdown does not wait out the period
            self._wait(self.period - (time.monotonic() - cycle_start))

    def stop(self) -> None:
        self._stopped = True
        with self._wake:
            self._wake.notify_all()
