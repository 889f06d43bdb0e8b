"""Executor selection for the allocate session and the preempt pass.

The counterpart of ``select_executor``/``run_packed_auto`` in
``volcano_tpu/ops/dispatch.py``, reduced to the two executors the port
has:

  * ``cuda`` — the CUDA greedy-scan kernel with its on-device gang
    fixpoint (ops/session_kernel.py), when the session runs on a GPU,
    sits inside the f32 floor-division envelope and its node state fits
    one block's shared memory (whether the masked-score plane of the
    repeated-row fast path fits beside it is the kernel wrapper's choice,
    by size, and never turns a session away);
  * ``torch-scan`` — the PyTorch specification (ops/kernels.py), when
    the caller asks for ``device="cpu"``.

A GPU session outside the kernel's envelope raises ``ValueError``: the
int-exact and wide-session rungs are still to be ported, and the plain
version is not run in their place.  Every output passes the validity
gate before it is returned.

The preempt pass (``select_preempt_executor``/``run_preempt_auto``, the
counterpart of the JAX package's) has two executors as well:

  * ``cuda`` — the CUDA preempt kernel (ops/preempt_kernel.py) for a
    classic-tier session ({priority, gang, conformance}, no DRF) inside
    the f32 envelope, on a GPU;
  * ``dense`` — the PyTorch specification ``preempt_dense`` on the same
    device, for ``device="cpu"`` and for the reference's own reasons: a
    DRF or weakened preemptable tier, or a session outside the f32
    envelope.

A session the kernel cannot take raises; nothing degrades to ``dense``.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from volcano_tpu_torch.ops.kernels import (
    DEFAULT_WEIGHTS,
    f32_lr_exact,
    resolve_device,
    run_packed,
    ScoreWeights,
)
from volcano_tpu_torch.ops.packing import PackedSnapshot
from volcano_tpu_torch.ops.preempt_kernel import preempt_f32_exact, run_preempt_cuda
from volcano_tpu_torch.ops.preempt_pack import preempt_dense, PreemptPacked
from volcano_tpu_torch.ops.session_kernel import (
    fits_shared_memory,
    node_width,
    run_packed_cuda,
)


def _assignment_valid(snap: PackedSnapshot, out) -> bool:
    """Sanity gate on an executor's output: the right length and every
    value a real node index or -1."""
    arr = np.asarray(out)
    if arr.ndim != 1 or arr.shape[0] < snap.n_tasks:
        return False
    head = arr[: snap.n_tasks]
    return bool(((head >= -1) & (head < snap.n_nodes)).all())


def select_executor(
    snap: PackedSnapshot,
    weights: ScoreWeights = DEFAULT_WEIGHTS,
    device: Optional[Union[str, torch.device]] = None,
) -> str:
    """Which executor run_packed_auto uses: 'cuda' | 'torch-scan'."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "torch-scan"
    if weights.lr_int_exact or not f32_lr_exact(snap):
        raise ValueError(
            "node capacity outside the f32-exact envelope: the int-exact GPU rung "
            "is still to be ported"
        )
    R = snap.task_resreq.shape[1]
    NK = node_width(snap.n_nodes)
    if not fits_shared_memory(R, NK):
        raise ValueError(
            f"{snap.n_nodes} nodes x {R} lanes exceed one block's shared memory: the "
            "multi-SM session kernel is still to be ported"
        )
    return "cuda"


#: executor run_packed_auto last ran (read right after the call, same thread)
_last_executor = ""


def last_executor() -> str:
    return _last_executor


def run_packed_auto(
    snap: PackedSnapshot,
    weights: ScoreWeights = DEFAULT_WEIGHTS,
    gang_rounds: int = 3,
    device: Optional[Union[str, torch.device]] = None,
) -> np.ndarray:
    """PackedSnapshot → assignment[n_tasks] through the executor
    :func:`select_executor` picks."""
    global _last_executor
    dev = resolve_device(device)
    executor = select_executor(snap, weights, dev)
    _last_executor = executor
    if executor == "cuda":
        out = run_packed_cuda(snap, weights=weights, gang_rounds=gang_rounds, device=dev)
    else:
        out = run_packed(snap, weights=weights, gang_rounds=gang_rounds, device=dev)
    if not _assignment_valid(snap, out):
        raise RuntimeError(f"{executor} returned an invalid assignment")
    return out


# ---- the preempt pass ----

def select_preempt_executor(
    pk: PreemptPacked, device: Optional[Union[str, torch.device]] = None
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
    if not preempt_f32_exact(pk):
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
    executor :func:`select_preempt_executor` picks."""
    global _last_preempt_executor
    dev = resolve_device(device)
    executor = select_preempt_executor(pk, dev)
    _last_preempt_executor = executor
    if executor == "cuda":
        evicted, pipelined = run_preempt_cuda(pk, weights=weights, device=dev)
    else:
        evicted, pipelined = preempt_dense(pk, weights=weights, device=dev)
    if not _preempt_valid(pk, evicted, pipelined):
        raise RuntimeError(f"{executor} returned an invalid preempt result")
    return evicted, pipelined
