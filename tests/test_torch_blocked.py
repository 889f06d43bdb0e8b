"""The port's blocked formulation (volcano_tpu_torch/ops/blocked.py)
against the JAX package on the CPU.

``run_packed_blocked(device="cpu")`` runs the same torch ops it runs on a
GPU, without the CUDA graphs; its bindings are held bit for bit against
``volcano_tpu.ops.blocked.run_packed_blocked`` and against the port's
``run_packed`` on the cases of tests/test_blocked.py, a DGX-sized
(int-exact) session, sessions with scalar resource lanes (R = 5, R = 9),
the discard-until-stable gang loop, and block and candidate sizes small
enough that the stop and full-width step run many times."""

from __future__ import annotations

import numpy as np
import pytest

from volcano_tpu.ops.blocked import run_packed_blocked as jax_run_packed_blocked
from volcano_tpu.ops.kernels import run_packed as jax_run_packed
from volcano_tpu.ops.kernels import ScoreWeights as JaxWeights
from volcano_tpu.ops.synthetic import generate_snapshot as jax_generate_snapshot
from volcano_tpu_torch.ops.blocked import prepare_blocked_arrays, run_packed_blocked
from volcano_tpu_torch.ops.kernels import f32_lr_exact, run_packed, ScoreWeights
from volcano_tpu_torch.ops.synthetic import add_scalar_lanes
from tests.test_torch_kernels import one_torch_thread, to_port  # noqa: F401

#: tests/test_blocked.py's sessions, with its block and candidate sizes
BLOCKED_CASES = {
    "random-0": (dict(n_tasks=300, n_nodes=50, gang_size=4, seed=0), 16, 4),
    "random-1": (dict(n_tasks=300, n_nodes=50, gang_size=4, seed=1), 16, 4),
    "random-2": (dict(n_tasks=300, n_nodes=50, gang_size=4, seed=2), 16, 4),
    "predicates": (dict(n_tasks=256, n_nodes=64, gang_size=8, seed=3, label_classes=4,
                        taint_fraction=0.25), 32, 4),
    "capacity-pressure": (dict(n_tasks=400, n_nodes=16, gang_size=5, seed=4,
                               node_cpu_milli=16_000, node_mem_mib=32_768), 32, 2),
    "single-node": (dict(n_tasks=64, n_nodes=1, gang_size=2, seed=5), 8, 2),
    # DGX H100 nodes (224 threads, 2 TB): outside the f32 envelope
    "dgx": (dict(n_tasks=400, n_nodes=60, gang_size=8, seed=3, label_classes=4,
                 taint_fraction=0.1, node_cpu_milli=224_000, node_mem_mib=2_097_152), 16, 4),
}


def _both(jax_snap, block_size: int, top_k: int, weights=None, stats=None, **kwargs):
    """(port blocked on the CPU, JAX blocked, port run_packed) on one
    session, with the same weights; ``stats`` gets the port's counts."""
    snap = to_port(jax_snap)
    w = weights or ScoreWeights()
    got = run_packed_blocked(snap, weights=w, block_size=block_size, top_k=top_k,
                             device="cpu", stats=stats, **kwargs)
    want = np.asarray(jax_run_packed_blocked(jax_snap, weights=JaxWeights(*w),
                                             block_size=block_size, top_k=top_k, **kwargs))
    spec = run_packed(snap, weights=w, device="cpu", **kwargs)
    return got, want, spec


@pytest.mark.parametrize("case", list(BLOCKED_CASES), ids=list(BLOCKED_CASES))
def test_blocked_matches_jax_blocked_and_run_packed(case):
    kwargs, B, K = BLOCKED_CASES[case]
    got, want, spec = _both(jax_generate_snapshot(**kwargs), B, K)
    np.testing.assert_array_equal(want, got)
    np.testing.assert_array_equal(spec, got)
    assert (got >= 0).any()
    if case == "capacity-pressure":
        assert (got == -1).any()  # pressure discards gangs
    if case == "dgx":
        assert not f32_lr_exact(to_port(jax_generate_snapshot(**kwargs)))


@pytest.mark.parametrize("weights", [ScoreWeights(), ScoreWeights(binpack_scalar=1.0)],
                         ids=["default", "binpack-scalar"])
@pytest.mark.parametrize("R", [5, 9])
def test_blocked_with_scalar_lanes(R, weights):
    """R = 5 (cpu, memory and three device plugins) and R = 9, more lanes
    than the session kernel's shared-memory layout takes."""
    jax_snap = add_scalar_lanes(
        jax_generate_snapshot(n_tasks=240, n_nodes=48, gang_size=4, seed=10 + R), R - 2, R)
    got, want, spec = _both(jax_snap, 16, 4, weights)
    assert got.shape == (240,) and to_port(jax_snap).task_resreq.shape[1] == R
    np.testing.assert_array_equal(want, got)
    np.testing.assert_array_equal(spec, got)
    assert (got >= 0).any() and (got == -1).any()


def test_blocked_discard_unstable():
    """The discard-until-stable gang loop over a cascade the bounded loop
    leaves unsettled at one round."""
    kwargs = dict(n_tasks=400, n_nodes=16, gang_size=5, seed=4, node_cpu_milli=16_000,
                  node_mem_mib=32_768)
    jax_snap = jax_generate_snapshot(**kwargs)
    got, want, spec = _both(jax_snap, 32, 2, gang_rounds=1, discard_unstable=True)
    np.testing.assert_array_equal(want, got)
    np.testing.assert_array_equal(spec, got)
    bounded = run_packed_blocked(to_port(jax_snap), gang_rounds=1, block_size=32, top_k=2,
                                 device="cpu")
    np.testing.assert_array_equal(np.asarray(jax_run_packed(jax_snap, gang_rounds=1)), bounded)
    assert (bounded != got).any()


@pytest.mark.parametrize("block_size,top_k", [(4, 1), (8, 2), (5, 3)])
def test_blocked_small_blocks_stop_often(block_size, top_k):
    """Blocks of a few tasks over one to three candidates: blocks stop,
    and each stop resolves its task at full width."""
    jax_snap = jax_generate_snapshot(n_tasks=160, n_nodes=40, gang_size=4, seed=7,
                                     label_classes=2, taint_fraction=0.2)
    stats = {}
    got, want, spec = _both(jax_snap, block_size, top_k, stats=stats)
    np.testing.assert_array_equal(want, got)
    np.testing.assert_array_equal(spec, got)
    assert 4 <= stats["stops"] <= stats["blocks"] and stats["passes"] >= 1


def test_prepare_blocked_arrays_pads_one_block_and_a_dummy_node():
    from volcano_tpu.ops.blocked import prepare_blocked_arrays as jax_prepare

    jax_snap = jax_generate_snapshot(n_tasks=100, n_nodes=30, gang_size=4, seed=2)
    arrays, T_blk = prepare_blocked_arrays(to_port(jax_snap), 16)
    want, want_T = jax_prepare(jax_snap, 16)
    assert T_blk == want_T
    assert sorted(arrays) == sorted(want)
    for name, value in want.items():
        assert arrays[name].tobytes() == np.asarray(value).tobytes(), name
    assert not arrays["node_ok"][-1]
