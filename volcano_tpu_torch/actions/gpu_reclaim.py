"""gpu-reclaim — the reclaim action over the packed reclaim session.

The port of ``volcano_tpu/actions/jax_reclaim.py``.  Reference behavior:
pkg/scheduler/actions/reclaim/reclaim.go:42-202.  The host packs the
session (ops/reclaim_pack.pack_reclaim_session), the dense replay
(``reclaim_dense``, numpy on the host) decides the whole pass, and the
result applies through a real Statement so plugin event handlers and
cache eviction stay intact.

This action runs no kernel: the reference decides reclaim in numpy on
the host and has no device program for it, so the port has none to
port.  ``device`` is where the no-victim explanation's reason counts are
reduced (ops/explain), ``cuda`` unless named.

Routes (``last_route``) as in gpu-preempt: ``host`` where the pack
refuses the session or flags ``needs_host_validation`` (decided before
the replay runs; the host ``ReclaimAction`` runs, as in the reference),
``dense`` where the dense replay ran (on the host: no device program
runs), ``none`` where nothing starves.  The result applies through
gpu-preempt's ``apply_evictions``: a replay result that fails
validation while it is applied raises ``ApplyDiverged`` with nothing
evicted, counted in ``volcano_executor_failures_total{executor=
"reclaim-dense", cause="diverged"}``; the host action does not stand in
for it.  (Unlike preempt, reclaim never checks node resource fit — only
the predicate set — so apply validates predicates alone,
reclaim.go:123-126.)
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Union

import torch

from volcano_tpu_torch.actions.gpu_preempt import apply_evictions
from volcano_tpu_torch.actions.reclaim import ReclaimAction
from volcano_tpu_torch.framework.interface import Action
from volcano_tpu_torch.framework.session import Session
from volcano_tpu_torch.ops.explain import synthesize_no_victim_explanations
from volcano_tpu_torch.ops.kernels import resolve_device
from volcano_tpu_torch.ops.reclaim_pack import pack_reclaim_session, reclaim_dense
from volcano_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

#: the label reclaim's replay is counted under when its result diverges
RECLAIM_EXECUTOR = "reclaim-dense"


class GpuReclaimAction(Action):
    def __init__(self, device: Optional[Union[str, torch.device]] = None):
        """``device`` is where the no-victim reason counts are reduced:
        ``cuda`` when None (raising where there is no GPU), ``"cpu"``
        for the PyTorch specification."""
        self.device = device
        #: "dense", "host" or "none" — see the module docstring
        self.last_route = ""
        #: why the last execute() took the host action ("" otherwise)
        self.last_host_reason = ""
        #: phase timings (ms) of the last execute(): pack, execute, apply
        self.last_phase_stats: Dict[str, float] = {}

    def name(self) -> str:
        return "gpu-reclaim"

    def _host(self, ssn: Session, reason: str) -> None:
        log.info("gpu-reclaim takes the host action: %s", reason)
        self.last_route, self.last_host_reason = "host", reason
        ReclaimAction().execute(ssn)

    def execute(self, ssn: Session) -> None:
        self.last_route = self.last_host_reason = ""
        self.last_phase_stats = {}
        device = resolve_device(self.device)

        t0 = time.perf_counter()
        try:
            pk = pack_reclaim_session(ssn)
        except ValueError as e:
            self._host(ssn, f"pack refused: {e}")
            return
        self.last_phase_stats["pack_ms"] = (time.perf_counter() - t0) * 1e3
        if pk.base.n_tasks == 0:
            self.last_route = "none"
            return
        if pk.base.needs_host_validation:
            self._host(ssn, "needs host validation")
            return

        t0 = time.perf_counter()
        evicted, pipelined = reclaim_dense(pk)
        self.last_phase_stats["execute_ms"] = (time.perf_counter() - t0) * 1e3
        self.last_route = "dense"

        t0 = time.perf_counter()
        if not evicted.any() and not (pipelined >= 0).any():
            # no reclaimable victims — explain the provably-unplaceable
            # reclaimers (the same no-victim discipline as gpu-preempt)
            synthesize_no_victim_explanations(ssn, pk, device=device)
            self.last_phase_stats["apply_ms"] = (time.perf_counter() - t0) * 1e3
            return

        apply_evictions(ssn, pk, evicted, pipelined, "reclaim", RECLAIM_EXECUTOR,
                        check_fit=False).commit()
        self.last_phase_stats["apply_ms"] = (time.perf_counter() - t0) * 1e3


def new() -> GpuReclaimAction:
    return GpuReclaimAction()
