"""ConfigMap-lock leader election.

A copy of ``volcano_tpu/serving/leader.py``: the same lock (a ConfigMap,
its record in the ``LEASE_KEY`` annotation as JSON with the same
fields), so an elector of the port and one of the JAX package compete
for one lease on one store.

Reference: the scheduler/controllers binaries wrap their run loop in
``leaderelection.RunOrDie`` over a ConfigMap resource lock
(cmd/scheduler/app/server.go:110-156): candidates try to acquire or
renew a lease record {holderIdentity, leaseDurationSeconds, renewTime}
stored in a ConfigMap annotation; whoever wins runs the component, and
a crashed leader's lease expires so a standby takes over and rebuilds
state from watches.

The standalone equivalent stores the lease in a ConfigMap on the bus —
the in-process API server, or a remote ``vtpu-apiserver`` through
``bus.RemoteAPIServer`` (the same interface) — and uses its
resourceVersion compare-and-update (the same optimistic concurrency the
k8s lock uses) so two candidates can never both win a term.  Over the
remote bus the lease arbitrates OS *processes*: SIGKILL the active
scheduler and a standby in another process takes over after expiry.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Callable, Optional

from volcano_tpu_torch.apis import core
from volcano_tpu_torch.client.apiserver import (
    AlreadyExistsError,
    ApiError,
    APIServer,
    ConflictError,
    NotFoundError,
)
from volcano_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

LEASE_KEY = "control-plane.volcano.tpu/leader"


class LeaderElector:
    """Acquire/renew loop over a ConfigMap lease.

    ``on_started_leading`` runs on the elector thread once leadership is
    acquired; ``on_stopped_leading`` fires if renewal is lost.  Use
    ``is_leader`` from component loops to gate work per cycle (the
    pattern the daemons use), or block in ``on_started_leading``.
    """

    def __init__(
        self,
        api: APIServer,
        lock_name: str,
        identity: str,
        namespace: str = "volcano-system",
        lease_duration: float = 2.0,
        retry_period: float = 0.2,
        on_started_leading: Optional[Callable[[], None]] = None,
        on_stopped_leading: Optional[Callable[[], None]] = None,
    ):
        self.api = api
        self.lock_name = lock_name
        self.identity = identity
        self.namespace = namespace
        self.lease_duration = lease_duration
        self.retry_period = retry_period
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading
        self._leader = threading.Event()
        self._stop = threading.Event()
        self._release_on_stop = True
        self._thread: Optional[threading.Thread] = None
        #: monotonic stamp of the last attempt that successfully renewed
        #: — is_leader expires against it, see the property
        self._last_renew = 0.0
        #: successful acquires and renews, and the longest gap between
        #: two of them while leading (seconds; the port's, for the lease
        #: against the store lock)
        self.renews = 0
        self.max_renew_gap = 0.0

    # ---- lease record ----

    def _read(self):
        cm = self.api.get("ConfigMap", self.namespace, self.lock_name)
        if cm is None:
            return None, None
        try:
            rec = json.loads(cm.data.get(LEASE_KEY, "{}"))
        except (ValueError, AttributeError):
            rec = {}
        return cm, rec

    def _write(self, cm, rec) -> bool:
        payload = {LEASE_KEY: json.dumps(rec)}
        try:
            if cm is None:
                obj = core.ConfigMap(
                    metadata=core.ObjectMeta(
                        name=self.lock_name, namespace=self.namespace
                    ),
                    data=payload,
                )
                self.api.create(obj)
            else:
                cm.data = payload
                self.api.compare_and_update(cm, cm.metadata.resource_version)
            return True
        except (AlreadyExistsError, ConflictError, NotFoundError):
            return False

    def _try_acquire_or_renew(self) -> bool:
        # Wall clock, NOT time.monotonic(): renewTime is written by one
        # candidate and compared by others, and monotonic clocks have
        # process-local epochs — a standby reading a leader's monotonic
        # timestamp judges expiry against garbage.  Wall time matches the
        # reference's leaderelection RenewTime semantics (clock-skew
        # bounded by leaseDuration, as upstream documents).
        now = time.time()
        cm, rec = self._read()
        holder = rec.get("holderIdentity") if rec else None
        renew = float(rec.get("renewTime", 0.0)) if rec else 0.0
        # Expiry is judged by the HOLDER's advertised duration (stored in
        # the record), not the reader's own config — otherwise a standby
        # configured with a shorter lease could steal a live lease.
        held_duration = (
            float(rec.get("leaseDurationSeconds", self.lease_duration))
            if rec
            else self.lease_duration
        )
        expired = now - renew > held_duration

        if cm is not None and holder not in (None, "", self.identity) and not expired:
            return False  # someone else holds a live lease
        new_rec = {
            "holderIdentity": self.identity,
            "leaseDurationSeconds": self.lease_duration,
            "renewTime": now,
        }
        return self._write(cm, new_rec)

    # ---- public API ----

    @property
    def is_leader(self) -> bool:
        """Leadership, self-expiring against the lease clock.

        The event alone is not enough over a network bus: a renew RPC
        can block for multiples of the lease duration (degraded link),
        during which a healthy standby legally acquires the expired
        lease.  Gating on lease validity here means the old leader's
        consumers (the daemon work loops check this every cycle) stop
        acting at the moment the lease lapses — not when the blocked
        RPC finally returns — so two candidates can never both act as
        leader."""
        return (
            self._leader.is_set()
            and time.monotonic() - self._last_renew <= self.lease_duration
        )

    def run(self) -> None:
        """Blocking acquire/renew loop (the RunOrDie analogue)."""
        became_leader = False
        while not self._stop.is_set():
            # stamp BEFORE the round-trip (client-go semantics): the
            # lease record's renewTime is written with the pre-call
            # clock, so judging our own validity from a post-call stamp
            # would overstate it by the RPC duration — on a congested
            # bus that is a dual-leadership window
            attempt_started = time.monotonic()
            try:
                ok = self._try_acquire_or_renew()
                if ok:
                    if became_leader:
                        self.max_renew_gap = max(self.max_renew_gap,
                                                 attempt_started - self._last_renew)
                    self.renews += 1
                    self._last_renew = attempt_started
            except ApiError as e:
                # A bus outage must not crash the elector thread — and a
                # single dropped request must not flap leadership: while
                # the last successful renew is younger than the lease
                # duration, the lease is still provably ours (no standby
                # can acquire it), so keep leading and retry.  Only when
                # renewal keeps failing past the lease's validity do we
                # step down (client-go leaderelection semantics).
                log.error("leader election: renew failed for %s: %s",
                          self.identity, e)
                ok = (
                    became_leader
                    and time.monotonic() - self._last_renew
                    <= self.lease_duration
                )
            if ok and not became_leader:
                became_leader = True
                self._leader.set()
                log.info("leader election: %s became leader of %s", self.identity, self.lock_name)
                if self.on_started_leading:
                    self.on_started_leading()
            elif not ok and became_leader:
                became_leader = False
                self._leader.clear()
                log.error("leader election: %s LOST %s", self.identity, self.lock_name)
                if self.on_stopped_leading:
                    self.on_stopped_leading()
            self._stop.wait(self.retry_period)
        # graceful release: zero the lease so a standby takes over fast
        if became_leader and self._release_on_stop:
            try:
                cm, rec = self._read()
                if cm is not None and rec.get("holderIdentity") == self.identity:
                    self._write(cm, {"holderIdentity": "", "renewTime": 0.0})
            except ApiError as e:
                # bus down at shutdown: the lease simply expires
                log.error("leader election: release failed for %s: %s",
                          self.identity, e)
            self._leader.clear()

    def start(self) -> "LeaderElector":
        """Run the loop on a daemon thread."""
        self._thread = threading.Thread(
            target=self.run, name=f"leader-{self.identity}", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, release: bool = True) -> None:
        """Stop renewing.  ``release=False`` simulates a crash: the lease
        is left to expire, exercising standby takeover."""
        self._release_on_stop = release
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        if not release:
            self._leader.clear()
