"""The port's session executor (volcano_tpu_torch/ops/session_kernel.py,
dispatch.py, executor.py) against the JAX package on the CPU.

On CPU tensors the kernel wrapper runs its plain version, so these
cases hold the plain pass, the gang fixpoint around it, the host
packing and the entry point against ``run_packed_pallas`` (interpret
mode) and ``run_packed``, with tolerance 0.  The CUDA kernel itself is
held against the same plain version on the card by chip_smoke.py."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from volcano_tpu.ops.kernels import run_packed as jax_run_packed
from volcano_tpu.ops.pallas_session import (
    prepare_pallas_arrays,
    run_packed_pallas,
    schedule_pass_pallas,
)
from volcano_tpu.ops.synthetic import generate_snapshot as jax_generate_snapshot
from volcano_tpu_torch.ops import session_kernel
from volcano_tpu_torch.ops.dispatch import select_executor
from volcano_tpu_torch.ops.executor import execute_allocate, last_allocate_executor
from volcano_tpu_torch.ops.packing import load_snapshot
from volcano_tpu_torch.ops.session_kernel import (
    prepare_session_arrays,
    run_packed_cuda,
    session_pass_cuda,
    session_pass_reference,
)
from volcano_tpu_torch.ops.synthetic import BASELINE_CONFIGS, generate_snapshot
from tests.test_kernels import _cascade_snapshot
from tests.test_torch_kernels import one_torch_thread, to_port  # noqa: F401

#: the shapes of tests/test_pallas.py
PALLAS_CASES = {
    "random-0": dict(n_tasks=300, n_nodes=150, gang_size=4, seed=0),
    "random-1": dict(n_tasks=300, n_nodes=150, gang_size=4, seed=1),
    "random-2": dict(n_tasks=300, n_nodes=150, gang_size=4, seed=2),
    "predicates": dict(n_tasks=256, n_nodes=130, gang_size=8, seed=3,
                       label_classes=4, taint_fraction=0.25),
    "capacity-pressure": dict(n_tasks=400, n_nodes=16, gang_size=5, seed=4,
                              node_cpu_milli=16_000, node_mem_mib=32_768),
    "single-node": dict(n_tasks=64, n_nodes=1, gang_size=2, seed=5),
}


def pass_inputs(arrays):
    """One pass's operands on the CPU, every task active."""
    taskrow = torch.from_numpy(arrays["taskrow"].copy())
    R = taskrow.shape[1] - 2
    taskrow[:, R + 1] = 1.0
    return (taskrow, torch.from_numpy(arrays["cf_u8"]), torch.from_numpy(arrays["nd"]),
            torch.from_numpy(arrays["tol"]), torch.from_numpy(arrays["cls_off"]),
            torch.from_numpy(arrays["cls_nodes"]))


@pytest.mark.parametrize("case", ["random-0", "predicates", "capacity-pressure", "single-node"])
def test_prepare_session_arrays_match_pallas_layout(case):
    """Byte-equal to prepare_pallas_arrays after the stated reshape:
    node planes flat ([C, NK], [3R+2, NK] for [C|3R+2, NS, 128]),
    taskrow cut to the valid tasks, tol as [R]."""
    kwargs = PALLAS_CASES[case]
    want, _, NK_p = prepare_pallas_arrays(jax_generate_snapshot(**kwargs), block_size=128)
    got, T_act, NK = prepare_session_arrays(generate_snapshot(**kwargs))
    assert (T_act, NK) == (kwargs["n_tasks"], NK_p)
    assert got["taskrow"].tobytes() == want["taskrow"][:T_act].tobytes()
    assert got["cf_u8"].tobytes() == want["cf_u8"].reshape(-1, NK).tobytes()
    assert got["nd"].tobytes() == want["nd"].reshape(-1, NK).tobytes()
    assert got["tol"].tobytes() == want["tol"].reshape(-1).tobytes()


@pytest.mark.parametrize("case", list(PALLAS_CASES), ids=list(PALLAS_CASES))
def test_session_pass_reference_matches_pallas_pass(case):
    kwargs = PALLAS_CASES[case]
    pallas_arrays, _, _ = prepare_pallas_arrays(jax_generate_snapshot(**kwargs), block_size=128)
    taskrow = pallas_arrays["taskrow"].copy()
    taskrow[: kwargs["n_tasks"], -1] = 1.0
    want = np.asarray(schedule_pass_pallas(
        taskrow, pallas_arrays["cf_u8"], pallas_arrays["nd"], pallas_arrays["tol"],
        block_size=128, interpret=True,
    ))
    arrays, T_act, _ = prepare_session_arrays(generate_snapshot(**kwargs))
    got = session_pass_reference(*pass_inputs(arrays))
    assert got.dtype == torch.int32
    assert np.array_equal(want[:T_act], got.numpy())


@pytest.mark.parametrize("case", list(PALLAS_CASES), ids=list(PALLAS_CASES))
def test_run_packed_cuda_on_cpu_matches_pallas_and_spec(case):
    kwargs = PALLAS_CASES[case]
    jax_snap = jax_generate_snapshot(**kwargs)
    got = run_packed_cuda(generate_snapshot(**kwargs), device="cpu")
    assert np.array_equal(run_packed_pallas(jax_snap, block_size=128, interpret=True), got)
    assert np.array_equal(jax_run_packed(jax_snap), got)


@pytest.mark.parametrize("gang_rounds,expected", [(1, [-1, -1, 1]), (3, [-1, -1, 0])])
def test_gang_fixpoint_cascade_matches_pallas(gang_rounds, expected):
    """The two-round cascade: round 2 moves a0 onto the node job B's
    discard freed, and the fixpoint stops when the active set is
    stable."""
    want = run_packed_pallas(_cascade_snapshot(), gang_rounds=gang_rounds, block_size=128,
                             interpret=True)
    got = run_packed_cuda(to_port(_cascade_snapshot()), gang_rounds=gang_rounds, device="cpu")
    assert np.array_equal(want, got)
    np.testing.assert_array_equal(got, expected)


def test_beyond_f32_envelope_runs_int_mode():
    """Outside the f32 floor-division envelope nothing raises any more:
    the kernel's wrapper scores least-requested in int32 and equals the
    JAX package's run_packed, and a GPU session goes to the kernel."""
    kwargs = dict(n_tasks=16, n_nodes=4, gang_size=2, seed=6, node_cpu_milli=2_000_000,
                  node_mem_mib=4_000_000)
    snap = generate_snapshot(**kwargs)
    got = run_packed_cuda(snap, device="cpu")
    assert np.array_equal(jax_run_packed(jax_generate_snapshot(**kwargs)), got)
    assert (got >= 0).any()
    assert select_executor(snap, device="cuda") == "cuda"
    assert select_executor(snap, device="cpu") == "torch-scan"


def test_execute_allocate_cpu_matches_jax_execute_allocate():
    from volcano_tpu.ops.executor import execute_allocate as jax_execute_allocate

    kwargs = BASELINE_CONFIGS["1k_pods_100_nodes_binpack"]
    want = jax_execute_allocate(jax_generate_snapshot(**kwargs))
    got = execute_allocate(generate_snapshot(**kwargs), device="cpu")
    assert last_allocate_executor() == "torch-scan"
    assert np.array_equal(want, got)


def test_load_snapshot_written_by_jax_package(tmp_path):
    from volcano_tpu.ops.packing import save_snapshot as jax_save_snapshot

    jax_snap = jax_generate_snapshot(n_tasks=120, n_nodes=40, gang_size=4, seed=9,
                                     label_classes=2, taint_fraction=0.2)
    path = jax_save_snapshot(jax_snap, str(tmp_path / "session.npz"),
                             assignment=np.arange(3), executor="pallas")
    snap, extras = load_snapshot(path)
    for name in ("task_resreq", "task_job", "task_sel_bits", "task_tol_bits", "node_idle",
                 "node_used", "node_alloc", "node_label_bits", "node_taint_bits", "node_ok",
                 "node_task_count", "node_max_tasks", "job_min_available", "job_ready_count",
                 "tolerance", "task_has_preferences"):
        want, got = getattr(jax_snap, name), getattr(snap, name)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), name
    assert (snap.n_tasks, snap.n_nodes, snap.n_jobs) == (120, 40, 30)
    assert snap.task_uids == jax_snap.task_uids
    assert str(extras["executor"]) == "pallas"
    assert np.array_equal(jax_run_packed(jax_snap), execute_allocate(snap, device="cpu"))


def test_execute_allocate_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    snap = generate_snapshot(n_tasks=16, n_nodes=4, gang_size=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        execute_allocate(snap)


def test_wrapper_runs_plain_version_on_cpu_without_launching():
    arrays, _, _ = prepare_session_arrays(generate_snapshot(**PALLAS_CASES["predicates"]))
    inputs = pass_inputs(arrays)
    before = session_kernel.LAUNCHES
    got = session_pass_cuda(*inputs)
    assert session_kernel.LAUNCHES == before
    assert torch.equal(got, session_pass_reference(*inputs))
    # a set done flag places nothing
    done = torch.ones(1, dtype=torch.int32)
    assert (session_pass_cuda(*inputs, done=done) == -1).all()


def test_wrapper_rejects_bad_operands():
    arrays, _, _ = prepare_session_arrays(generate_snapshot(**PALLAS_CASES["random-0"]))
    taskrow, cf, nd, tol, cls_off, cls_nodes = pass_inputs(arrays)
    lists = (cls_off, cls_nodes)
    with pytest.raises(ValueError, match="cf"):
        session_pass_cuda(taskrow, cf.to(torch.float32), nd, tol, *lists)
    with pytest.raises(ValueError, match="nd"):
        session_pass_cuda(taskrow, cf, nd[:, :-1], tol, *lists)
    with pytest.raises(ValueError, match="contiguous"):
        session_pass_cuda(taskrow, cf, nd.t().contiguous().t(), tol, *lists)
    # node state beyond one block's shared memory is taken (the wide
    # instance's layout); a lane count whose task rows alone overflow
    # shared memory is refused before launch
    NK = 20_480  # 3 x 20,480 x 4 bytes > 227 KB
    wide = session_pass_cuda(taskrow, torch.zeros(cf.shape[0], NK, dtype=torch.uint8),
                             torch.zeros(8, NK), tol, *lists)
    assert (wide == -1).all()
    R = 20_000
    with pytest.raises(ValueError, match="shared memory"):
        session_pass_cuda(
            torch.zeros(taskrow.shape[0], R + 2), cf, torch.zeros(3 * R + 2, cf.shape[1]),
            torch.zeros(R), *lists,
        )
