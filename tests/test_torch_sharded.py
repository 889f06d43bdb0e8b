"""The port's node-sharded session (volcano_tpu_torch/ops/sharded.py)
against the JAX package on the CPU.

The reference runs ``run_packed_sharded`` on a mesh of the first ``n`` of
the 8 host devices tests/conftest.py forces; the port runs the same
session with ``devices=["cpu"] * n`` (every shard in this process, on the
CPU, without the CUDA graphs).  Bindings are compared with
``np.array_equal`` at n = 1, 2, 4 and 8 on tests/test_sharded.py's
sessions, synthetic sessions with label classes and taints, a DGX-sized
(int-exact) session, a gang session whose fixpoint takes several rounds
(with and without ``discard_unstable``) and a session whose blocks stop
on ties across shards; each also against the port's ``run_packed`` and
``run_packed_blocked``."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from volcano_tpu.ops.sharded import run_packed_sharded as jax_run_packed_sharded
from volcano_tpu.ops.synthetic import generate_snapshot as jax_generate_snapshot
from volcano_tpu_torch.ops.blocked import run_packed_blocked
from volcano_tpu_torch.ops.dispatch import select_executor
from volcano_tpu_torch.ops.kernels import f32_lr_exact, run_packed
from volcano_tpu_torch.ops.sharded import resolve_devices, run_packed_sharded
from volcano_tpu_torch.trace.replay import EXECUTORS, run_snapshot
from tests.test_sharded import _snap as sharded_test_snap
from tests.test_torch_kernels import one_torch_thread, to_port  # noqa: F401

SHARDS = [1, 2, 4, 8]

#: (JAX snapshot builder, block size, candidates a shard)
CASES = {
    # tests/test_sharded.py's three sessions through the cache and packer
    "matches-single-chip": (lambda: sharded_test_snap(), 64, 8),
    "with-taints": (lambda: sharded_test_snap(taint_some=True), 64, 8),
    "gang-discard": (lambda: sharded_test_snap(n_nodes=4, n_jobs=6, tasks_per_job=4,
                                               cpu="4"), 64, 8),
    # its dispatch sessions: the port reaches sharded by name only
    "dispatch-large": (lambda: jax_generate_snapshot(
        n_tasks=1_024, n_nodes=2_048, gang_size=4, seed=3, label_classes=4), 64, 8),
    "dispatch-small": (lambda: jax_generate_snapshot(
        n_tasks=128, n_nodes=64, gang_size=4, seed=1), 64, 8),
    "labels-taints": (lambda: jax_generate_snapshot(
        n_tasks=256, n_nodes=64, gang_size=8, seed=3, label_classes=4,
        taint_fraction=0.25), 32, 4),
    # DGX H100 nodes (224 threads, 2 TB): outside the f32 envelope
    "dgx-int-exact": (lambda: jax_generate_snapshot(
        n_tasks=400, n_nodes=60, gang_size=8, seed=3, label_classes=4, taint_fraction=0.1,
        node_cpu_milli=224_000, node_mem_mib=2_097_152), 16, 4),
    # uniform nodes and small candidate lists: blocks stop on ties that
    # span the shards
    "stops-ties": (lambda: jax_generate_snapshot(
        n_tasks=300, n_nodes=50, gang_size=4, seed=0), 16, 4),
}

#: gangs over capacity: the fixpoint discards and re-runs
GANG_CASE = dict(n_tasks=400, n_nodes=16, gang_size=5, seed=4, node_cpu_milli=16_000,
                 node_mem_mib=32_768)


def _mesh(n: int) -> Mesh:
    devices = jax.devices()
    assert len(devices) >= 8  # conftest forces the 8-device host mesh
    return Mesh(np.array(devices[:n]), ("nodes",))


#: (case, kwargs) → the port's run_packed and run_packed_blocked on it,
#: which do not depend on the shard count
_SINGLE: dict = {}


def _all(key, jax_snap, n: int, block_size: int, top_k: int, **kwargs):
    """(port sharded, JAX sharded, port run_packed, port blocked, the
    port's stats) on one session."""
    snap = to_port(jax_snap)
    stats = {}
    got = run_packed_sharded(snap, devices=["cpu"] * n, block_size=block_size, top_k=top_k,
                             stats=stats, **kwargs)
    want = np.asarray(jax_run_packed_sharded(jax_snap, _mesh(n), block_size=block_size,
                                             top_k=top_k, **kwargs))
    key = (key, tuple(sorted(kwargs.items())))
    if key not in _SINGLE:
        _SINGLE[key] = (run_packed(snap, device="cpu", **kwargs),
                        run_packed_blocked(snap, block_size=block_size, top_k=top_k,
                                           device="cpu", **kwargs))
    return (got, want, *_SINGLE[key], stats)


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_sharded_matches_jax_sharded(case, n):
    build, B, K = CASES[case]
    jax_snap = build()
    got, want, spec, blocked, stats = _all(case, jax_snap, n, B, K)
    assert got.dtype == np.int32 and got.shape == (jax_snap.n_tasks,)
    assert np.array_equal(want, got)
    assert np.array_equal(spec, got)
    assert np.array_equal(blocked, got)
    assert (got >= 0).any()
    assert stats["passes"] >= 1 and stats["blocks"] >= 1
    if case == "gang-discard":
        assert (got == -1).any()  # the scenario discards gangs
    if case == "dgx-int-exact":
        assert not f32_lr_exact(to_port(jax_snap))
    if case == "stops-ties" and n > 1:
        assert stats["stops"] > 0  # the cross-shard full-width step ran


@pytest.mark.parametrize("discard_unstable", [False, True], ids=["bounded", "discard-unstable"])
@pytest.mark.parametrize("n", SHARDS)
def test_sharded_gang_fixpoint(n, discard_unstable):
    jax_snap = jax_generate_snapshot(**GANG_CASE)
    got, want, spec, blocked, stats = _all("gang", jax_snap, n, 32, 2,
                                           discard_unstable=discard_unstable)
    assert np.array_equal(want, got)
    assert np.array_equal(spec, got)
    assert np.array_equal(blocked, got)
    assert stats["passes"] > 1  # more than one fixpoint round
    assert (got == -1).any() and (got >= 0).any()


@pytest.mark.parametrize("case", ["stops-ties", "labels-taints"])
def test_shards_on_other_devices_gather_and_mirror(case):
    """Shards on a device other than ``devices[0]`` (``cpu:0`` is another
    device than ``cpu``) send their packs and bests through the gather
    copies and take the writeback slots and the winner from the mirrors,
    as shards on other GPUs do: the bindings do not change."""
    build, B, K = CASES[case]
    jax_snap = build()
    stats = {}
    got = run_packed_sharded(to_port(jax_snap), devices=["cpu", "cpu:0", "cpu:0", "cpu"],
                             block_size=B, top_k=K, stats=stats)
    want = np.asarray(jax_run_packed_sharded(jax_snap, _mesh(4), block_size=B, top_k=K))
    assert np.array_equal(want, got)
    assert stats["stops"] > 0 or case != "stops-ties"


def test_indivisible_padding_raises_in_both():
    jax_snap = jax_generate_snapshot(n_tasks=64, n_nodes=50, gang_size=4, seed=0)
    with pytest.raises(ValueError, match="not divisible"):
        jax_run_packed_sharded(jax_snap, _mesh(3))
    with pytest.raises(ValueError, match="not divisible"):
        run_packed_sharded(to_port(jax_snap), devices=["cpu"] * 3)


def test_shard_counts_and_gather_bytes():
    """Shards smaller than the candidate count track what they own, and
    the gathered pack is n rows of ids, used, base, alloc, max tasks, the
    class columns and the outside pairs."""
    snap = to_port(jax_generate_snapshot(n_tasks=64, n_nodes=16, gang_size=4, seed=2))
    stats = {}
    out = run_packed_sharded(snap, devices=["cpu"] * 8, block_size=16, top_k=16, stats=stats)
    assert np.array_equal(out, run_packed(snap, device="cpu"))
    B, K, R, n = 16, 9, 2, 8  # 64 padded nodes over 8 shards: K = 8 rows + the dummy
    M = B * K
    assert stats["gather_bytes_per_block"] == n * 4 * (M * (3 * R + 3) + B * M + 2 * B)


def test_no_gpu_and_no_devices_raises():
    """No quiet CPU route: with no GPU the default device list raises."""
    snap = to_port(jax_generate_snapshot(n_tasks=64, n_nodes=16, gang_size=4, seed=2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_packed_sharded(snap)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_devices()
    assert [d.type for d in resolve_devices(["cpu", "cpu"])] == ["cpu", "cpu"]


def test_replay_executor_and_dispatch():
    """``sharded`` is reached by name as a replay executor; the
    dispatcher keeps choosing the session kernel on a GPU."""
    assert "sharded" in EXECUTORS
    jax_snap = jax_generate_snapshot(n_tasks=1_024, n_nodes=2_048, gang_size=4, seed=3,
                                     label_classes=4)
    snap = to_port(jax_snap)
    out = run_snapshot(snap, executor="sharded", device="cpu")
    assert np.array_equal(out, run_packed(snap, device="cpu"))
    assert select_executor(snap, device="cuda") == "cuda"
