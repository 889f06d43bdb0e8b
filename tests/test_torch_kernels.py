"""The PyTorch specification (volcano_tpu_torch/ops/kernels.py) against
the JAX package's kernels (volcano_tpu/ops/kernels.py) on the CPU.

Tolerance 0: the port's contract is bit-identical bindings, so every
mask and score plane is compared bit for bit and every assignment with
``np.array_equal``.  Inputs are generated once with numpy and handed to
both packages."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from volcano_tpu.ops import kernels as jax_kernels
from volcano_tpu.ops.synthetic import generate_snapshot as jax_generate_snapshot
from volcano_tpu_torch.ops import kernels as torch_kernels
from volcano_tpu_torch.ops.packing import (
    _SNAPSHOT_ARRAYS,
    _SNAPSHOT_META,
    snapshot_from_arrays,
)
from volcano_tpu_torch.ops.synthetic import BASELINE_CONFIGS, generate_snapshot
from tests.test_kernels import _cascade_snapshot

#: the equivalence shapes of tests/test_pallas.py, plus a session beyond
#: the f32 floor-division envelope (least-requested in int32)
RUN_PACKED_CASES = {
    "random-0": dict(n_tasks=300, n_nodes=150, gang_size=4, seed=0),
    "random-1": dict(n_tasks=300, n_nodes=150, gang_size=4, seed=1),
    "random-2": dict(n_tasks=300, n_nodes=150, gang_size=4, seed=2),
    "predicates": dict(n_tasks=256, n_nodes=130, gang_size=8, seed=3,
                       label_classes=4, taint_fraction=0.25),
    "capacity-pressure": dict(n_tasks=400, n_nodes=16, gang_size=5, seed=4,
                              node_cpu_milli=16_000, node_mem_mib=32_768),
    "single-node": dict(n_tasks=64, n_nodes=1, gang_size=2, seed=5),
    "lr-int-exact": dict(n_tasks=64, n_nodes=8, gang_size=2, seed=6,
                         node_cpu_milli=2_000_000, node_mem_mib=4_000_000),
}

WEIGHTS = {
    "default": torch_kernels.DEFAULT_WEIGHTS,
    "custom": torch_kernels.ScoreWeights(
        binpack_weight=2.0, least_requested_weight=0.5, balanced_resource_weight=3.0
    ),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: one intra-op thread is as fast, and keeps
    the suite's parallel workers from contending for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_port(jax_snap):
    """The JAX package's PackedSnapshot as the port's, field for field."""
    arrays = {k: getattr(jax_snap, k) for k in _SNAPSHOT_ARRAYS
              if getattr(jax_snap, k) is not None}
    meta = {k: getattr(jax_snap, k) for k in _SNAPSHOT_META}
    return snapshot_from_arrays(arrays, meta)


def assert_bits_equal(want, got):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert want.dtype == got.dtype and want.shape == got.shape
    if want.dtype == np.float32:
        want, got = want.view(np.uint32), got.view(np.uint32)
    assert np.array_equal(want, got)


def loaded_planes(seed: int, node_cpu_milli: int = 64_000, node_mem_mib: int = 262_144):
    """Task and node planes with nodes part-loaded: random integer used
    lanes (some beyond capacity), pod counts around the limit, and a few
    nodes with no memory allocatable — every branch of the masks and
    scores gets exercised."""
    snap = generate_snapshot(
        n_tasks=96, n_nodes=70, gang_size=4, seed=seed, label_classes=3,
        taint_fraction=0.3, node_cpu_milli=node_cpu_milli, node_mem_mib=node_mem_mib,
    )
    rng = np.random.RandomState(100 + seed)
    N = snap.node_alloc.shape[0]
    alloc = snap.node_alloc.copy()
    alloc[rng.rand(N) < 0.1, 1] = 0.0
    used = np.floor(rng.rand(N, 2) * 1.1 * np.maximum(alloc, 1.0)).astype(np.float32)
    idle = (alloc - used).astype(np.float32)
    count = rng.randint(0, 120, size=N).astype(np.int32)
    return dict(
        task_resreq=snap.task_resreq, task_sel_bits=snap.task_sel_bits,
        task_tol_bits=snap.task_tol_bits, node_idle=idle, node_used=used,
        node_alloc=alloc, node_label_bits=snap.node_label_bits,
        node_taint_bits=snap.node_taint_bits, node_ok=snap.node_ok,
        node_task_count=count, node_max_tasks=snap.node_max_tasks,
        tolerance=snap.tolerance,
    )


def as_torch(planes):
    return {k: torch_kernels.as_tensor(v, torch.device("cpu")) for k, v in planes.items()}


@pytest.mark.parametrize("seed", [0, 1])
def test_predicate_mask_matches_reference(seed):
    p = loaded_planes(seed)
    order = ("task_resreq", "task_sel_bits", "task_tol_bits", "node_idle",
             "node_label_bits", "node_taint_bits", "node_ok", "node_task_count",
             "node_max_tasks", "tolerance")
    want = jax_kernels.predicate_mask(*(p[k] for k in order))
    t = as_torch(p)
    got = torch_kernels.predicate_mask(*(t[k] for k in order))
    assert_bits_equal(want, got)
    assert 0 < int(got.sum()) < got.numel()  # both outcomes occur


@pytest.mark.parametrize("weights", list(WEIGHTS), ids=list(WEIGHTS))
@pytest.mark.parametrize(
    "plane", ["binpack", "least_requested", "least_requested_int", "balanced", "node_scores"]
)
def test_score_planes_match_reference(plane, weights):
    w = WEIGHTS[weights]
    big = plane == "least_requested_int"
    p = loaded_planes(2, *((2_000_000, 4_000_000) if big else ()))
    args = (p["task_resreq"], p["node_used"], p["node_alloc"])
    t = as_torch(p)
    targs = (t["task_resreq"], t["node_used"], t["node_alloc"])
    jw = jax_kernels.ScoreWeights(**w._asdict())
    if plane == "binpack":
        want = jax_kernels.binpack_score(*args, jw)
        got = torch_kernels.binpack_score(*targs, w)
    elif plane.startswith("least_requested"):
        want = jax_kernels.least_requested_score(*args, int_exact=big)
        got = torch_kernels.least_requested_score(*targs, int_exact=big)
    elif plane == "balanced":
        want = jax_kernels.balanced_resource_score(*args)
        got = torch_kernels.balanced_resource_score(*targs)
    else:
        want = jax_kernels.node_scores(*args, jw)
        got = torch_kernels.node_scores(*targs, w)
    assert_bits_equal(want, got)
    assert len(np.unique(got.numpy())) > 2  # not a degenerate plane


@pytest.mark.parametrize("case", list(RUN_PACKED_CASES), ids=list(RUN_PACKED_CASES))
def test_run_packed_matches_reference(case):
    kwargs = RUN_PACKED_CASES[case]
    jax_snap = jax_generate_snapshot(**kwargs)
    snap = generate_snapshot(**kwargs)
    for name in _SNAPSHOT_ARRAYS:  # same seed → byte-identical session
        assert getattr(snap, name).tobytes() == getattr(jax_snap, name).tobytes(), name
    want = jax_kernels.run_packed(jax_snap)
    got = torch_kernels.run_packed(snap, device="cpu")
    assert got.dtype == np.asarray(want).dtype
    assert np.array_equal(want, got)
    if case == "capacity-pressure":
        assert (got == -1).any()  # pressure actually discards gangs


@pytest.mark.parametrize(
    "gang_rounds,discard_unstable,expected",
    [(1, False, [-1, -1, 1]), (3, False, [-1, -1, 0]), (1, True, [-1, -1, 0])],
    ids=["bounded-1", "rounds-3", "discard-until-stable"],
)
def test_gang_cascade_matches_reference(gang_rounds, discard_unstable, expected):
    want = jax_kernels.run_packed(
        _cascade_snapshot(), gang_rounds=gang_rounds, discard_unstable=discard_unstable
    )
    got = torch_kernels.run_packed(
        to_port(_cascade_snapshot()), gang_rounds=gang_rounds,
        discard_unstable=discard_unstable, device="cpu",
    )
    assert np.array_equal(want, got)
    np.testing.assert_array_equal(got, expected)


def test_baseline_configs_match_reference():
    from volcano_tpu.ops.synthetic import BASELINE_CONFIGS as JAX_CONFIGS

    for name, kwargs in BASELINE_CONFIGS.items():
        assert JAX_CONFIGS[name] == kwargs


def test_run_packed_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_kernels.run_packed(generate_snapshot(n_tasks=8, n_nodes=4, gang_size=2))
