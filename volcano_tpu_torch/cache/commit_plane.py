"""Pipelined commit plane — the device→host result queue drained by
bind workers.

A copy of ``volcano_tpu/cache/commit_plane.py``.  After the kernel has
finished, a cycle's own commit path remains: binder/evictor round trips,
Scheduled/Evict audit events, and the per-job status writeback — O(pods)
store writes issued synchronously.  This module takes that work off the
cycle's critical path:

* ``gpu-allocate``/``gpu-preempt`` (and the host actions — everything
  routes through ``SchedulerCache.bind/bind_batch/evict``) hand their
  commit effects to this queue and RETURN; a small pool of bind workers
  drains it in the background, so the store traffic of cycle N overlaps
  cycle N+1's ORDER/pack/device phase.
* Workers COALESCE queued items into batched commit frames
  (``client.apiserver.commit_batch`` — one store transaction, one
  watch-notification flush) instead of per-object round trips.  ``volcano_bind_coalesce_size`` records the
  achieved batching.
* A **commit barrier** at the next session's snapshot
  (``SchedulerCache.snapshot`` → :meth:`barrier`) guarantees every
  in-flight effect has landed before new cluster state is read, so
  cache/store coherence and ``trace.replay.verify`` bit-identity are
  exactly the synchronous path's.  ``volcano_commit_overlap_ratio``
  reports how much of the commit work actually hid behind host work.

Failure semantics are unchanged: a failed bind/evict takes the same
FailedScheduling-event + ``resync_task`` path the synchronous effects
take — just later, and always before the next snapshot.

Fault points: ``commit.fail`` dooms a queued item (evaluated at SUBMIT
time on the scheduling thread, so chaos schedules stay deterministic),
``commit.delay`` sleeps a worker before it lands a batch (keeping the
queue observably non-empty while faults fire).

Not present in the port yet: the flight recorder's handoff (the
reference's ``_obs_meta`` and the worker-side ``commit:flush`` span, from
``volcano_tpu/obs``, which needs the bus).  Items carry no recorder
context.  The worker count and the frame cap are constants: nothing in
the port sets them (the reference's ``commit_workers=`` and
``max_coalesce=`` come with the daemon that passes them).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from volcano_tpu_torch import faults, metrics
from volcano_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

#: binds per coalesced frame — bounds frame size (JSON payload) while
#: keeping a 50k-bind cycle to ~a dozen frames instead of 50k
_MAX_COALESCE = 4096
#: bind workers draining the queue, the reference daemon's setting
_WORKERS = 2


class CommitPlane:
    """Queue + worker pool for a :class:`SchedulerCache`'s async commit
    effects.  The cache owns execution (``_run_bind_items`` /
    ``_run_evict_items`` / ``_run_status_items``); this class owns
    ordering, coalescing, the barrier, and the metrics."""

    def __init__(self, cache):
        self.cache = cache
        self._cv = threading.Condition()
        #: ("bind", task, hostname, doomed) | ("evict", task, reason,
        #: doomed) | ("status", payload, None, doomed)
        self._items: deque = deque()  # guarded-by: self._cv
        self._inflight = 0  # guarded-by: self._cv
        self._stopped = False  # guarded-by: self._cv
        #: WALL-CLOCK time the plane was active (≥1 worker draining)
        #: since the last barrier — summed per-worker busy time would
        #: overstate overlap whenever workers drain concurrently
        self._busy_s = 0.0  # guarded-by: self._cv
        self._active_since: Optional[float] = None  # guarded-by: self._cv
        #: read by the smoke run and observability after a barrier
        self.last_barrier: Dict[str, float] = {}
        self._threads = [
            threading.Thread(
                target=self._worker_loop, name=f"vtpu-bind-worker-{i}",
                daemon=True,
            )
            for i in range(_WORKERS)
        ]
        for t in self._threads:
            t.start()

    # ---- submission (scheduling thread) ----
    #
    # Fault points are evaluated at SUBMIT time, on the scheduling
    # thread: items are evaluated in deterministic order (a seeded chaos
    # schedule dooms the same items regardless of worker interleave) and
    # the firing journals inside the cycle that caused it — on a worker
    # the firing could land between cycles, outside any journal window.
    # The doomed item carries its exception and fails in the worker,
    # through the exact failure path a real rejection takes.

    def _doom(self, extra_point: Optional[str] = None):
        fp = faults.get_plane()
        if not fp.enabled:
            return None
        doom = None
        if fp.should("commit.fail"):
            doom = RuntimeError("fault-injected commit failure")
        if extra_point is not None and fp.should(extra_point):
            # both streams always advance — exhausting one rule must not
            # shift the other's decisions (faults/plane.py discipline)
            doom = doom or RuntimeError("fault-injected bind failure")
        return doom

    def submit_binds(self, pairs: List[Tuple[object, str]]) -> None:
        with self._cv:
            for task, hostname in pairs:
                self._items.append(
                    ("bind", task, hostname, self._doom("cache.bind_fail"))
                )
            self._cv.notify_all()
            self._update_depth()

    def submit_evicts(self, pairs: List[Tuple[object, str]]) -> None:
        with self._cv:
            for task, reason in pairs:
                self._items.append(("evict", task, reason, self._doom()))
            self._cv.notify_all()
            self._update_depth()

    def submit_status(self, payload: dict) -> None:
        with self._cv:
            self._items.append(("status", payload, None, self._doom()))
            self._cv.notify_all()
            self._update_depth()

    def _update_depth(self) -> None:
        # requires-lock: self._cv
        metrics.update_commit_queue_depth(len(self._items) + self._inflight)

    @property
    def depth(self) -> int:
        with self._cv:
            return len(self._items) + self._inflight

    # ---- drain (bind workers) ----

    def _worker_loop(self) -> None:
        while True:
            with self._cv:
                while not self._items and not self._stopped:
                    self._cv.wait()
                if not self._items and self._stopped:
                    return
                batch = []
                while self._items and len(batch) < _MAX_COALESCE:
                    batch.append(self._items.popleft())
                self._inflight += 1
                if self._active_since is None:
                    self._active_since = time.perf_counter()
                self._update_depth()
            try:
                self._execute(batch)
            except Exception as e:  # noqa: BLE001 — a worker must survive
                # anything; per-item failures were already routed to the
                # resync path inside _execute
                log.error("commit-plane batch failed unexpectedly: %s", e)
            finally:
                with self._cv:
                    self._inflight -= 1
                    if self._inflight == 0 and self._active_since is not None:
                        self._busy_s += (
                            time.perf_counter() - self._active_since
                        )
                        self._active_since = None
                    self._update_depth()
                    self._cv.notify_all()

    def _execute(self, batch) -> None:
        fp = faults.get_plane()
        if fp.enabled and fp.should("commit.delay"):
            # a slow bus/binder leg — on the WORKER, never the
            # scheduling thread, which is the whole point of the plane
            time.sleep(fp.param_ms("commit.delay") / 1e3)
        # execute as CONSECUTIVE same-kind runs in submission order —
        # grouping all binds before all evicts would invert the
        # evict-then-bind ordering Statement.commit emits, and watchers
        # (controllers, audit tooling) would transiently observe a node
        # holding both the victim and its replacement.  Each run still
        # coalesces into one frame.  (inject=False on binds: the fault
        # points were already evaluated at submit time — the worker
        # must not draw a second decision.)
        i = 0
        while i < len(batch):
            kind = batch[i][0]
            j = i
            while j < len(batch) and batch[j][0] == kind:
                j += 1
            run = batch[i:j]
            i = j
            if kind == "bind":
                self.cache._run_bind_items(
                    [(t, h, doom) for _k, t, h, doom in run], inject=False,
                )
            elif kind == "evict":
                self.cache._run_evict_items(
                    [(t, r, doom) for _k, t, r, doom in run]
                )
            else:
                self.cache._run_status_items(
                    [(p, doom) for _k, p, _x, doom in run]
                )

    # ---- the commit barrier ----

    def barrier(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted effect has landed — called at the
        next session's snapshot.  Returns False on timeout (items still
        in flight).  Also computes the cycle's overlap ratio: of the
        plane's busy time since the last barrier, the fraction that ran
        while the scheduler was doing OTHER work instead of waiting
        here."""
        deadline = None if timeout is None else time.monotonic() + timeout
        t0 = time.perf_counter()
        with self._cv:
            while self._items or self._inflight:
                if deadline is not None and time.monotonic() >= deadline:
                    return False
                self._cv.wait(0.05)
            wait_s = time.perf_counter() - t0
            busy_s = self._busy_s
            self._busy_s = 0.0
        if busy_s > 0:
            ratio = max(0.0, min(1.0, 1.0 - wait_s / busy_s))
        else:
            ratio = 1.0
        self.last_barrier = {
            "wait_ms": wait_s * 1e3,
            "busy_ms": busy_s * 1e3,
            "overlap_ratio": ratio,
        }
        if busy_s > 0 or wait_s > 0:
            metrics.update_commit_overlap_ratio(ratio)
        return True

    def stop(self) -> None:
        """Drain and stop the workers (test/shutdown aid)."""
        self.barrier()
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=5.0)
