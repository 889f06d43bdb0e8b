"""Executor selection, validity gates and circuit breakers for the
allocate session and the preempt pass.

The counterpart of ``volcano_tpu/ops/dispatch.py`` over the port's
executors.  The allocate session has two:

  * ``cuda`` — the CUDA greedy-scan kernel with its on-device gang
    fixpoint (ops/session_kernel.py): every session on a GPU.  The
    kernel's shared-memory layout takes node state that fits one block
    and at most ``MAX_LANES`` resource lanes; its wide instance takes
    the rest (node state in global memory, any lane count).
    Least-requested runs in f32 inside the floor-division envelope and
    in exact int32 outside it; ``gang_discard_unstable()`` runs the gang
    fixpoint to its end;
  * ``torch-scan`` — the PyTorch specification (ops/kernels.py), where
    the caller asks for ``device="cpu"``.

The choice depends only on the device's type.  The preempt pass has two:
``cuda`` (the CUDA preempt kernel, ops/preempt_kernel.py, for a
classic-tier session inside the f32 envelope, on a GPU) and ``dense``
(``preempt_dense`` on the same device, for the CPU and for the sessions
the reference also sends to dense).

No executor stands in for another.  Where the reference degrades a
failing Pallas kernel to ``blocked``, the port raises: a kernel call
that fails — a launch error, an output the validity gate refuses, or an
injected fault (``device.lowering``, ``device.nan``) — raises
:class:`ExecutorFailed`, and the plain version never runs in the
kernel's place.  Each failure is counted in
``volcano_executor_failures_total{executor,cause}``, logged at error
level and recorded by the executor's circuit breaker (``cuda``,
``preempt-cuda``: 3 consecutive failures open it, a half-open probe
after 30 s closes it on success).  While a breaker is open, calls raise
:class:`ExecutorFailed` without launching (cause ``circuit-open``), and
``faults.degraded_reasons()`` names the breaker.  The kernel library is
built before the breaker is asked: a failed build raises and counts
nothing.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Optional, Union

import numpy as np
import torch

from volcano_tpu_torch import faults, metrics
from volcano_tpu_torch.faults import watchdog
from volcano_tpu_torch.ops import preempt_kernel, session_kernel
from volcano_tpu_torch.ops.kernels import (
    DEFAULT_WEIGHTS,
    resolve_device,
    run_packed,
    ScoreWeights,
)
from volcano_tpu_torch.ops.packing import PackedSnapshot
from volcano_tpu_torch.ops.preempt_kernel import preempt_f32_exact
from volcano_tpu_torch.ops.preempt_pack import preempt_dense, PreemptPacked

_log = logging.getLogger(__name__)


class ExecutorFailed(RuntimeError):
    """A kernel executor failed, or its breaker is open; nothing ran in
    its place.  ``cause`` ∈ {error, corrupt-output, circuit-open}."""

    def __init__(self, executor: str, cause: str, detail: str):
        super().__init__(f"{executor} {cause}: {detail}")
        self.executor = executor
        self.cause = cause


class ApplyDiverged(ExecutorFailed):
    """A device result failed the host's validation while it was being
    applied (a victim or preemptor vanished, a plugin predicate vetoed,
    the fit diverged): the statement was discarded, nothing was evicted,
    and nothing ran in the executor's place.  ``cause`` is
    ``diverged``."""

    def __init__(self, executor: str, detail: str):
        super().__init__(executor, "diverged", detail)


def _breaker(name: str) -> faults.CircuitBreaker:
    """Executor breaker: 3 consecutive failures open it, a half-open
    re-probe after 30 s closes it again on success."""
    return faults.get_breaker(name, failure_threshold=3, cooldown_s=30.0)


def gang_discard_unstable() -> bool:
    """Opt-in reference Statement semantics for an unsettled gang
    cascade: ``VTPU_GANG_DISCARD_UNSTABLE=1`` makes the gang loops
    discard until stable instead of shipping the last bounded round's
    commits (the kernel's session runs its rounds to the fixpoint)."""
    return os.environ.get("VTPU_GANG_DISCARD_UNSTABLE", "").lower() in ("1", "true", "yes")


def _assignment_valid(snap: PackedSnapshot, out) -> bool:
    """Sanity gate on an executor's output: the right length and every
    value a real node index or -1.  A kernel that silently produced
    garbage fails like one that raised."""
    arr = np.asarray(out)
    if arr.ndim != 1 or arr.shape[0] < snap.n_tasks:
        return False
    head = arr[: snap.n_tasks]
    return bool(((head >= -1) & (head < snap.n_nodes)).all())


class _CorruptOutput(RuntimeError):
    """A kernel returned an invalid output."""


class _PhaseAbandoned(RuntimeError):
    """This dispatch runs on a watchdog worker whose caller already gave
    up on it: unwind without touching breakers, failure counters or
    last-executor notes."""


def _guarded(executor: str, run: Callable, valid: Callable,
             corrupt: Optional[Callable] = None):
    """``run()`` under the breaker named ``executor``, through the fault
    points and the validity gate ``valid(out)``; ``corrupt(out)`` is what
    an injected ``device.nan`` makes of the output (no such point where
    None).  A failure is recorded, counted, logged and raised as
    :class:`ExecutorFailed`."""
    br = _breaker(executor)
    if not br.allow():
        metrics.register_executor_failure(executor, "circuit-open")
        _log.error("%s breaker open: %s", executor, br.reason())
        raise ExecutorFailed(executor, "circuit-open", br.reason())
    fp = faults.get_plane()
    try:
        if fp.enabled and fp.should("device.lowering"):
            raise RuntimeError("fault-injected lowering failure")
        out = run()
        if watchdog.abandoned():
            # the caller gave up on this worker mid-run: its (late) result
            # is garbage, and a verdict now would race the next cycle's
            raise _PhaseAbandoned(executor)
        if corrupt is not None and fp.enabled and fp.should("device.nan"):
            out = corrupt(out)
        if not valid(out):
            raise _CorruptOutput(f"{executor} returned an invalid output")
    except _PhaseAbandoned:
        raise
    except Exception as e:  # noqa: BLE001 — recorded, counted and raised
        if watchdog.abandoned():
            raise _PhaseAbandoned(executor) from e
        cause = "corrupt-output" if isinstance(e, _CorruptOutput) else "error"
        br.record_failure(str(e))
        metrics.register_executor_failure(executor, cause)
        _log.error("%s failed (%s): %s", executor, cause, e)
        raise ExecutorFailed(executor, cause, str(e)) from e
    br.record_success()
    return out


def select_executor(
    snap: PackedSnapshot,
    weights: ScoreWeights = DEFAULT_WEIGHTS,
    device: Optional[Union[str, torch.device]] = None,
) -> str:
    """Which executor run_packed_auto uses: 'cuda' | 'torch-scan'.
    Decided by the device's type alone, so it may be asked for
    ``device="cuda"`` without a GPU.  Neither the sizes nor ``weights``
    change it: the kernel takes every lane count and node count (in the
    shared-memory layout or the wide instance, ``session_kernel.
    shared_layout``) and runs either least-requested mode."""
    return "torch-scan" if resolve_device(device).type == "cpu" else "cuda"


#: executor run_packed_auto last ran (read right after the call, same thread)
_last_executor = ""


def last_executor() -> str:
    return _last_executor


def _checked(snap: PackedSnapshot, executor: str, out) -> np.ndarray:
    """The torch-scan output, through the validity gate."""
    if not _assignment_valid(snap, out):
        raise RuntimeError(f"{executor} returned an invalid assignment")
    return out


def run_packed_auto(
    snap: PackedSnapshot,
    weights: ScoreWeights = DEFAULT_WEIGHTS,
    gang_rounds: int = 3,
    device: Optional[Union[str, torch.device]] = None,
) -> np.ndarray:
    """PackedSnapshot → assignment[n_tasks] through the executor
    :func:`select_executor` picks; ``cuda`` under its breaker, raising
    :class:`ExecutorFailed` where it fails."""
    global _last_executor
    dev = resolve_device(device)
    executor = _last_executor = select_executor(snap, weights, dev)
    discard = gang_discard_unstable()
    if executor == "torch-scan":
        return _checked(snap, executor, run_packed(
            snap, weights=weights, gang_rounds=gang_rounds, discard_unstable=discard,
            device=dev))
    if dev.type == "cuda":
        session_kernel.load_library()  # a failed build raises here, before the breaker
    fp = faults.get_plane()
    if fp.enabled and fp.should("device.slow"):
        time.sleep(fp.param_ms("device.slow") / 1e3)
    return _guarded(
        executor,
        lambda: session_kernel.run_packed_cuda(
            snap, weights=weights, gang_rounds=gang_rounds, device=dev,
            discard_unstable=discard),
        lambda out: _assignment_valid(snap, out),
        lambda out: np.full(np.asarray(out).shape, np.iinfo(np.int32).max, dtype=np.int32),
    )


# ---- the preempt pass ----

def select_preempt_executor(
    pk: PreemptPacked,
    device: Optional[Union[str, torch.device]] = None,
    weights: ScoreWeights = DEFAULT_WEIGHTS,
) -> str:
    """Which executor run_preempt_auto uses: 'cuda' | 'dense'."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "dense"
    # the kernel models the classic {priority, gang, conformance}
    # preemptable tier only; drf-preemptable (and weakened-filter)
    # sessions run the dense formulation
    if not (pk.use_prio and pk.use_gang and pk.use_conf) or pk.use_drf:
        return "dense"
    # the kernel scores least-requested in f32 only: int-exact weights and
    # sessions outside the f32 envelope run dense, as in the reference
    if weights.lr_int_exact or not preempt_f32_exact(pk):
        return "dense"
    return "cuda"


#: executor run_preempt_auto last ran (read right after the call, same thread)
_last_preempt_executor = ""


def last_preempt_executor() -> str:
    return _last_preempt_executor


def _preempt_valid(pk: PreemptPacked, evicted, pipelined) -> bool:
    """Sanity gate on a preempt executor's output: the right lengths and
    every pipelined value a real node index or -1."""
    ev, pipe = np.asarray(evicted), np.asarray(pipelined)
    if ev.shape != (pk.n_victims,) or pipe.shape != (pk.base.n_tasks,):
        return False
    return bool(((pipe >= -1) & (pipe < pk.base.n_nodes)).all())


def run_preempt_auto(
    pk: PreemptPacked,
    weights: ScoreWeights = DEFAULT_WEIGHTS,
    device: Optional[Union[str, torch.device]] = None,
):
    """PreemptPacked → (evicted[V] bool, pipelined[P] i32) through the
    executor :func:`select_preempt_executor` picks; ``cuda`` under its
    breaker (``preempt-cuda``), raising :class:`ExecutorFailed` where it
    fails."""
    global _last_preempt_executor
    dev = resolve_device(device)
    executor = _last_preempt_executor = select_preempt_executor(pk, dev, weights)
    if executor == "dense":
        evicted, pipelined = preempt_dense(pk, weights=weights, device=dev)
        if not _preempt_valid(pk, evicted, pipelined):
            raise RuntimeError("dense returned an invalid preempt result")
        return evicted, pipelined
    if dev.type == "cuda":
        session_kernel.load_library()  # a failed build raises here, before the breaker
    return _guarded(
        "preempt-cuda",
        lambda: preempt_kernel.run_preempt_cuda(pk, weights=weights, device=dev),
        lambda out: _preempt_valid(pk, *out),
    )


def warmup_kernels(n_tasks: int = 4096, n_nodes: int = 1024, gang_size: int = 8,
                   device: Optional[Union[str, torch.device]] = None) -> str:
    """Build the kernel library and run one generated session through
    run_packed_auto on ``device`` (``cuda`` unless named), so the first
    real session pays neither the build nor the first launch; logs the
    duration.  Returns the executor that ran.  (The JAX package also
    compiles a small task bucket here; PyTorch compiles nothing per
    shape.)"""
    from volcano_tpu_torch.ops.synthetic import generate_snapshot

    dev = resolve_device(device)
    snap = generate_snapshot(n_tasks=n_tasks, n_nodes=n_nodes, gang_size=gang_size)
    executor = select_executor(snap, device=dev)
    t0 = time.monotonic()
    run_packed_auto(snap, device=dev)
    _log.info("warmup (%s) done in %.1fs", executor, time.monotonic() - t0)
    return executor
