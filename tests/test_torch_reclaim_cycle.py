"""The port's reclaim actions against the JAX package's on the CPU.

The sessions of ``tests/test_reclaim_kernel.py`` and the reclaim cases
of ``tests/test_actions.py``, captured and carried across as
``tests/test_torch_preempt_cycle.py`` does: ``pack_reclaim_session``
array for array, the port's host ``reclaim`` against the JAX package's,
and ``gpu-reclaim(device="cpu")`` against ``jax-reclaim`` — evictions in
order, pipelined placements, fit errors and the close-time writeback
equal, with the JAX action's host route taken exactly where the port's
is.  Reclaim runs no kernel in either package (``reclaim_dense`` is
numpy on the host).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import tests.test_actions as ref_actions
import tests.test_reclaim_kernel as ref_reclaim
from tests.test_torch_preempt_cycle import (
    assert_same_cycle,
    assert_same_pack,
    captured,
    Case,
    CONFORMANCE_GANG,
    HostRoute,
    run_jax,
    run_port,
)
from volcano_tpu.actions import jax_reclaim as jax_reclaim_module
from volcano_tpu.actions.jax_reclaim import JaxReclaimAction
from volcano_tpu.framework import close_session as jax_close, open_session as jax_open
from volcano_tpu.ops.reclaim_pack import (
    pack_reclaim_session as jax_pack_reclaim,
    reclaim_dense as jax_reclaim_dense,
)
from volcano_tpu_torch import metrics
from volcano_tpu_torch.actions import gpu_reclaim
from volcano_tpu_torch.actions.gpu_reclaim import GpuReclaimAction
from volcano_tpu_torch.api import TaskStatus
from volcano_tpu_torch.framework import close_session, open_session
from volcano_tpu_torch.ops.dispatch import ApplyDiverged
from volcano_tpu_torch.ops.reclaim_pack import pack_reclaim_session, reclaim_dense


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread keeps the suite's parallel workers from
    contending for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


R = ref_reclaim
RECLAIM_CASES = {
    **{f"two-queues-{s}": (lambda s=s: Case(captured(R, R._two_queue_case, seed=s)))
       for s in range(3)},
    "same-queue-untouchable": lambda: Case(
        captured(R, R.test_dense_matches_host_same_queue_untouchable)),
    "gang-guard": lambda: Case(captured(R, R.test_dense_matches_host_gang_guard)),
    "overused-queue-skipped": lambda: Case(
        captured(R, R.test_dense_matches_host_overused_queue_skipped)),
    "multi-queue-rotation": lambda: Case(
        captured(R, R.test_dense_matches_host_multi_queue_rotation)),
    "no-proportion": lambda: Case(captured(R, R._two_queue_case, seed=0),
                                  tiers=(("gang", "conformance"),)),
    "both-roles-multi-job-queue": lambda: Case(
        captured(R, R.test_both_roles_multi_job_queue_refused_and_falls_back)),
    "actions-overusing-queue": lambda: Case(captured(
        ref_actions, ref_actions.test_reclaim_from_overusing_queue), tiers=CONFORMANCE_GANG),
    "actions-same-queue": lambda: Case(captured(
        ref_actions, ref_actions.test_reclaim_skips_same_queue_victims), tiers=CONFORMANCE_GANG),
    "actions-not-enough-victims": lambda: Case(captured(
        ref_actions, ref_actions.test_reclaim_requires_enough_victim_resources),
        tiers=CONFORMANCE_GANG),
}


@pytest.mark.parametrize("name", sorted(RECLAIM_CASES))
def test_pack_reclaim_session_matches(name):
    """``pack_reclaim_session`` against the JAX package's, field for
    field, or the same refusal; ``reclaim_dense`` on the two packs gives
    the same (evicted, pipelined)."""
    case = RECLAIM_CASES[name]()
    got = assert_same_pack(case, jax_pack_reclaim, pack_reclaim_session)
    if got is not None:
        jax_ssn = jax_open(case.jax_cache(), *case.jax_conf())
        try:
            want = jax_reclaim_dense(jax_pack_reclaim(jax_ssn))
        finally:
            jax_close(jax_ssn)
        for g, w in zip(reclaim_dense(got), want, strict=True):
            assert np.array_equal(g, w)


@pytest.mark.parametrize("name", sorted(RECLAIM_CASES))
def test_host_reclaim_matches(name):
    """The port's host ``reclaim`` against the JAX package's."""
    assert_same_cycle(RECLAIM_CASES[name](), ["reclaim"])


@pytest.mark.parametrize("name", sorted(RECLAIM_CASES))
def test_gpu_reclaim_matches_jax_reclaim(name, monkeypatch):
    """``gpu-reclaim`` on the CPU against ``jax-reclaim``: equal
    outcomes, the JAX action's host route taken exactly where the
    port's is."""
    host = HostRoute(monkeypatch, jax_reclaim_module, "ReclaimAction")
    case = RECLAIM_CASES[name]()
    want = run_jax(case, [JaxReclaimAction()])
    action = GpuReclaimAction(device="cpu")
    assert run_port(case, [action]) == want
    assert action.last_route in ("dense", "host", "none")
    assert host.calls == (action.last_route == "host")


def test_the_cases_reach_every_route():
    routes = set()
    for make in RECLAIM_CASES.values():
        action = GpuReclaimAction(device="cpu")
        got = run_port(make(), [action])
        routes.add((action.last_route, bool(got["evicts"])))
    assert {("dense", True), ("dense", False), ("host", True)} <= routes


def test_diverged_result_raises_and_evicts_nothing(monkeypatch):
    """A replay result that fails validation while applied raises
    ApplyDiverged with nothing evicted, counted once under
    ``reclaim-dense``; the host action does not run in its place."""
    ran = []

    def diverging(pk):
        evicted = np.ones(pk.n_victims, dtype=bool)
        pipelined = np.full(pk.base.n_tasks, -1, dtype=np.int32)
        pipelined[0] = 0
        return evicted, pipelined

    monkeypatch.setattr(gpu_reclaim, "reclaim_dense", diverging)
    monkeypatch.setattr(gpu_reclaim, "ReclaimAction", lambda: ran.append("host"))
    # the reclaimer asks for a node whose taint it does not tolerate
    case = RECLAIM_CASES["two-queues-0"]()
    case.dicts["nodes"][0]["spec"]["taints"] = [
        {"key": "dedicated", "value": "x", "effect": "NoSchedule"}]
    cache = case.port_cache()
    ssn = open_session(cache, *case.port_conf())
    labels = dict(executor="reclaim-dense", cause="diverged")
    before = metrics.registry.counter("volcano_executor_failures_total", **labels)
    try:
        with pytest.raises(ApplyDiverged):
            GpuReclaimAction(device="cpu").execute(ssn)
        assert not any(job.task_status_index.get(TaskStatus.Releasing)
                       for job in ssn.jobs.values())
    finally:
        close_session(ssn)
    assert cache.evictor.evicts == [] and ran == []
    assert metrics.registry.counter("volcano_executor_failures_total", **labels) == before + 1
