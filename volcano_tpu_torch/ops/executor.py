"""The entry points of the allocate session and the preempt pass: the
in-process kernels, or the compute-plane sidecar when one is configured.

The port of ``volcano_tpu/ops/executor.py``.  PackedSnapshot in,
assignment out, and PreemptPacked in, (evicted, pipelined) out.

``VTPU_COMPUTE_PLANE=<socket path>`` (or ``configure(path)``) routes
default-weight sessions over the serialized boundary
(serving/compute_plane.py) to a sidecar process that owns the GPU
(``python -m volcano_tpu_torch.cmd.compute_plane``).  A remote failure —
sidecar down, timeout, protocol error — marks the sidecar unhealthy
(the ``compute-plane`` breaker opens, so ``/healthz`` reads degraded),
counts ``volcano_executor_fallbacks_total{from="remote", to="local",
cause="error"}``, logs at error level, and runs the session on the
in-process route: the same CUDA kernel on the same kind of card, which
still raises ``ExecutorFailed`` where it fails and still raises where
there is no GPU and no device is named.  The next session after the
5 s re-probe period probes the sidecar again.

The in-process route runs under the cycle deadline
(``faults/watchdog.py``), as the reference's does: with no deadline
armed (the default) it runs inline, and an overrun is counted as a
failure of the executor (cause ``deadline``) and raises
``CycleDeadlineExceeded``.  A deadline that runs out mid-RPC drops the
connection, and the in-process route then raises at once on the
exhausted budget.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Tuple, Union

import numpy as np
import torch

from volcano_tpu_torch import faults, metrics, trace
from volcano_tpu_torch.faults import watchdog
from volcano_tpu_torch.ops import dispatch
from volcano_tpu_torch.ops.kernels import DEFAULT_WEIGHTS, ScoreWeights
from volcano_tpu_torch.ops.packing import PackedSnapshot
from volcano_tpu_torch.ops.preempt_pack import PreemptPacked
from volcano_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

#: seconds to wait before re-probing an unhealthy sidecar
_RETRY_PERIOD = 5.0


class _Remote:
    def __init__(self, path: str):
        from volcano_tpu_torch.serving.compute_plane import ComputePlaneClient

        self.client = ComputePlaneClient(path)
        self.path = path
        self.healthy = True
        self.last_probe = 0.0
        #: threshold 1: one failed session is enough — the in-process
        #: route runs the same kernel, so there is no reason to pay a
        #: second failure latency before demoting.  The breaker mirrors
        #: the probe state into /healthz (degraded) and the breaker gauge.
        self.breaker = faults.get_breaker(
            "compute-plane", failure_threshold=1, cooldown_s=_RETRY_PERIOD
        )

    def usable(self) -> bool:
        if self.healthy:
            return True
        now = time.monotonic()
        if now - self.last_probe < _RETRY_PERIOD:
            return False
        self.last_probe = now
        self.healthy = self.client.health()
        if self.healthy:
            self.breaker.record_success()
            log.info("compute plane %s back up", self.path)
        return self.healthy

    def mark_unhealthy(self, error: str) -> None:
        """Session-loss handling: demote the route AND drop the
        connection — a restarted (or abandoned mid-read) sidecar shares
        no session state with us, so the delta handshake must restart
        from a full frame (ComputePlaneClient.close clears the acked
        revisions)."""
        self.healthy = False
        self.last_probe = time.monotonic()
        self.breaker.record_failure(error)
        self.client.close()


_UNSET = object()  # env-derived default; distinct from "explicitly off"
_remote: object = _UNSET


def configure(socket_path: Optional[str]) -> None:
    """Point the executors at a sidecar.  ``None`` explicitly DISABLES
    the remote path — including a VTPU_COMPUTE_PLANE env setting."""
    global _remote
    old = _remote
    _remote = _Remote(socket_path) if socket_path else None
    if isinstance(old, _Remote):
        # the replaced route's connection closes now, not at gc
        old.client.close()


def _get_remote() -> Optional[_Remote]:
    global _remote
    if _remote is _UNSET:
        path = os.environ.get("VTPU_COMPUTE_PLANE", "")
        _remote = _Remote(path) if path else None
    return _remote


#: did the last execute_allocate / execute_preempt run in-process
#: ("local") or on the sidecar ("remote")?
_last_route = "local"
_last_preempt_route = "local"

#: reason counts of the last execute_allocate(explain=True) — [T, P]
#: int32 aligned with the snapshot's ordered tasks, or None when the
#: session needed no explanation (everything placed) or explain was
#: off.  Read right after the call, same thread.
_last_explain_counts = None

#: wall-clock ms of the reduction behind _last_explain_counts, part of
#: the caller's time of execute_allocate; None when the counts were
#: reduced on the sidecar (inside the round trip) or none were reduced
_last_explain_ms = None


def last_explain_counts():
    return _last_explain_counts


def last_explain_ms():
    return _last_explain_ms


def _maybe_explain(snap, assignment, device) -> None:
    """Lazy explain: the reason-count reduction runs only when a valid
    task went unplaced — fully-placed cycles pay nothing — and only over
    the unplaced rows, on ``device``."""
    global _last_explain_counts, _last_explain_ms
    _last_explain_counts = None
    _last_explain_ms = None
    unplaced = np.nonzero(np.asarray(assignment)[: snap.n_tasks] < 0)[0]
    if unplaced.size:
        from volcano_tpu_torch.ops import explain as _explain

        _last_explain_counts = _explain.run_explain(
            snap, task_rows=unplaced, device=device
        ).counts
        _last_explain_ms = _explain.last_run_ms


def last_allocate_executor() -> str:
    """Name of what the most recent execute_allocate ran: 'auto' when
    the assignment came from the sidecar (its dispatch picks against ITS
    hardware), else the in-process executor ('cuda' or 'torch-scan').
    Read it right after the call, same thread."""
    if _last_route == "remote":
        return "auto"
    return dispatch.last_executor()


def execute_allocate(
    snap: PackedSnapshot,
    weights: Optional[ScoreWeights] = None,
    gang_rounds: int = 3,
    device: Optional[Union[str, torch.device]] = None,
    explain: bool = False,
) -> np.ndarray:
    """PackedSnapshot → assignment[n_tasks] (node index or -1), via the
    sidecar when one is configured and the session has the default
    weights and gang rounds (the wire carries neither).  The in-process
    route runs on ``cuda`` unless ``device`` names another device;
    raises when no GPU is present and no device is named, and raises
    ``CycleDeadlineExceeded`` when an armed cycle deadline runs out.

    ``explain=True`` additionally reduces the per-task reason-count
    matrix when a valid task went unplaced (read it back with
    :func:`last_explain_counts`): on the sidecar, against the snapshot
    it holds, in the same round trip; in-process, on ``device``."""
    global _last_route, _last_explain_counts, _last_explain_ms
    rec = trace.get_recorder()
    weights = weights or DEFAULT_WEIGHTS
    remote = _get_remote()
    # cleared up front: an aborted call must not leave a previous
    # session's counts readable as this session's
    _last_explain_counts = None
    _last_explain_ms = None
    if (
        remote is not None
        and weights == DEFAULT_WEIGHTS
        and gang_rounds == 3
        and remote.usable()
    ):
        try:
            with rec.span("executor:remote-allocate", "kernel"):
                out = watchdog.run_with_deadline(
                    lambda: remote.client.allocate(snap, explain=explain),
                    watchdog.remaining_s(),
                    "remote-allocate",
                )
            _last_route = "remote"
            if explain:
                # the sidecar sends counts whenever a row went unplaced
                _last_explain_counts = remote.client.last_reason_counts
            return out
        except watchdog.CycleDeadlineExceeded as e:
            # budget gone mid-RPC: the abandoned read desynced the
            # connection — drop it (full-frame re-handshake later); the
            # in-process route below raises at once on the exhausted
            # budget, counted there as the executor's deadline failure
            remote.mark_unhealthy(str(e))
            if rec.enabled:
                rec.event("executor:remote-fallback", "kernel", error=str(e))
            log.error("compute plane allocate overran the cycle deadline")
        except Exception as e:  # noqa: BLE001 — counted, logged, run in-process
            remote.mark_unhealthy(str(e))
            metrics.register_executor_fallback("remote", "local", "error")
            if rec.enabled:
                rec.event("executor:remote-fallback", "kernel", error=str(e))
            log.error("compute plane allocate failed (%s); in-process kernel", e)
    _last_route = "local"
    try:
        out = watchdog.run_with_deadline(
            lambda: dispatch.run_packed_auto(
                snap, weights=weights, gang_rounds=gang_rounds, device=device),
            watchdog.remaining_s(),
            "local-allocate",
        )
    except watchdog.CycleDeadlineExceeded:
        metrics.register_executor_failure(dispatch.select_executor(snap, device=device),
                                          "deadline")
        raise
    if explain:
        _maybe_explain(snap, out, device)
    return out


def execute_preempt(
    pk: PreemptPacked,
    weights: Optional[ScoreWeights] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """PreemptPacked → (evicted[V] bool, pipelined[P] i32, -1 = none),
    via the sidecar when one is configured and the weights are the
    default ones.  The in-process route runs on ``cuda`` unless
    ``device`` names another device; raises when no GPU is present and
    no device is named.  The cycle watchdog does not bound this phase,
    as in the reference."""
    global _last_preempt_route
    rec = trace.get_recorder()
    weights = weights or DEFAULT_WEIGHTS
    remote = _get_remote()
    if remote is not None and weights == DEFAULT_WEIGHTS and remote.usable():
        try:
            with rec.span("executor:remote-preempt", "kernel"):
                out = remote.client.preempt(pk)
            _last_preempt_route = "remote"
            return out
        except Exception as e:  # noqa: BLE001 — counted, logged, run in-process
            remote.mark_unhealthy(str(e))
            metrics.register_executor_fallback("remote", "local", "error")
            if rec.enabled:
                rec.event("executor:remote-fallback", "kernel", error=str(e))
            log.error("compute plane preempt failed (%s); in-process kernel", e)
    _last_preempt_route = "local"
    return dispatch.run_preempt_auto(pk, weights=weights, device=device)


def last_preempt_executor() -> str:
    """Name of the executor the most recent execute_preempt ran: 'auto'
    when the sidecar ran it, else 'cuda' or 'dense'; read it right after
    the call, same thread."""
    if _last_preempt_route == "remote":
        return "auto"
    return dispatch.last_preempt_executor()
