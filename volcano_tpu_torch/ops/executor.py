"""The entry points of the allocate session and the preempt pass.

The local route of ``volcano_tpu/ops/executor.py``: PackedSnapshot in,
assignment out, and PreemptPacked in, (evicted, pipelined) out, through
the dispatcher.  The allocate session runs under the cycle deadline
(``faults/watchdog.py``), as the reference's local route does: with no
deadline armed (the default) it runs inline, and an overrun is counted
as a failure of the executor (cause ``deadline``) and raises
``CycleDeadlineExceeded``.  The compute-plane sidecar route is not part
of this package yet.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from volcano_tpu_torch import metrics
from volcano_tpu_torch.faults import watchdog
from volcano_tpu_torch.ops import dispatch
from volcano_tpu_torch.ops.kernels import DEFAULT_WEIGHTS, ScoreWeights
from volcano_tpu_torch.ops.packing import PackedSnapshot
from volcano_tpu_torch.ops.preempt_pack import PreemptPacked


def execute_allocate(
    snap: PackedSnapshot,
    weights: Optional[ScoreWeights] = None,
    gang_rounds: int = 3,
    device: Optional[Union[str, torch.device]] = None,
) -> np.ndarray:
    """PackedSnapshot → assignment[n_tasks] (node index or -1).  Runs on
    ``cuda`` unless ``device`` names another device; raises when no GPU
    is present and no device is named, and raises
    ``CycleDeadlineExceeded`` when an armed cycle deadline runs out."""
    try:
        return watchdog.run_with_deadline(
            lambda: dispatch.run_packed_auto(
                snap, weights=weights or DEFAULT_WEIGHTS, gang_rounds=gang_rounds,
                device=device),
            watchdog.remaining_s(),
            "local-allocate",
        )
    except watchdog.CycleDeadlineExceeded:
        metrics.register_executor_failure(dispatch.select_executor(snap, device=device),
                                          "deadline")
        raise


def last_allocate_executor() -> str:
    """Name of the executor the most recent execute_allocate ran
    ('cuda' or 'torch-scan'); read it right after the call, same
    thread."""
    return dispatch.last_executor()


def execute_preempt(
    pk: PreemptPacked,
    weights: Optional[ScoreWeights] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """PreemptPacked → (evicted[V] bool, pipelined[P] i32, -1 = none).
    Runs on ``cuda`` unless ``device`` names another device; raises when
    no GPU is present and no device is named."""
    return dispatch.run_preempt_auto(pk, weights=weights or DEFAULT_WEIGHTS, device=device)


def last_preempt_executor() -> str:
    """Name of the executor the most recent execute_preempt ran ('cuda'
    or 'dense'); read it right after the call, same thread."""
    return dispatch.last_preempt_executor()
