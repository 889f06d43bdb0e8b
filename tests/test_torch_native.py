"""The port's native host baseline against the JAX package's, on the CPU.

``volcano_tpu_torch.native.baseline_allocate`` and ``baseline_preempt``
(the port's copy of ``volcano_tpu/native/baseline.cpp`` over ctypes)
against the JAX package's ``volcano_tpu.native`` on the same inputs and
against the port's PyTorch specifications (``ops/kernels.run_packed``,
``ops/preempt_pack.preempt_dense``) on ``device="cpu"``, over several
seeds of the synthetic generators: equal bit for bit.  The library
builds into the gitignored ``volcano_tpu_torch/csrc/_build/``, never
next to its source; a missing g++ or a failed build raises, and the
dispatcher never selects the rung.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from volcano_tpu import native as jax_native
from volcano_tpu_torch import native
from volcano_tpu_torch.ops import dispatch
from volcano_tpu_torch.ops.kernels import run_packed
from volcano_tpu_torch.ops.preempt_pack import preempt_dense
from volcano_tpu_torch.ops.synthetic import generate_preempt_packed, generate_snapshot


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread keeps the suite's parallel workers from
    contending for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ALLOCATE_CASES = {
    "plain": dict(n_tasks=96, n_nodes=24, gang_size=4),
    "predicates": dict(n_tasks=128, n_nodes=32, gang_size=8, label_classes=4,
                       taint_fraction=0.25),
    "tight": dict(n_tasks=160, n_nodes=12, gang_size=4, node_cpu_milli=8_000,
                  node_mem_mib=16_384),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", sorted(ALLOCATE_CASES))
def test_baseline_allocate_matches_reference_and_spec(case, seed):
    snap = generate_snapshot(seed=seed, **ALLOCATE_CASES[case])
    got = native.baseline_allocate(snap)
    assert got.dtype == np.int32 and got.shape == (snap.n_tasks,)
    np.testing.assert_array_equal(got, jax_native.baseline_allocate(snap))
    np.testing.assert_array_equal(got, run_packed(snap, device="cpu")[: snap.n_tasks])
    assert (got >= 0).any()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_baseline_preempt_matches_reference_and_dense(seed):
    pk = generate_preempt_packed(n_victims=180, n_nodes=20, n_preemptors=32, gang_size=4,
                                 victim_job_size=4, seed=seed)
    evicted, pipelined = native.baseline_preempt(pk)
    want_ev, want_pipe = jax_native.baseline_preempt(pk)
    np.testing.assert_array_equal(evicted, want_ev)
    np.testing.assert_array_equal(pipelined, want_pipe)
    dense_ev, dense_pipe = preempt_dense(pk, device="cpu")
    np.testing.assert_array_equal(evicted, np.asarray(dense_ev))
    np.testing.assert_array_equal(pipelined, np.asarray(dense_pipe))
    assert evicted.any()


def test_library_builds_outside_the_source_directory():
    """The library lies in the gitignored build directory under a name
    keyed by the source's hash; nothing is written next to the source."""
    native.load()
    path = native.library_path()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(path).startswith("libbaseline_") and os.path.exists(path)
    assert native.BUILD_DIR.endswith(os.path.join("volcano_tpu_torch", "csrc", "_build"))
    here = os.path.dirname(native.__file__)
    assert sorted(f for f in os.listdir(here) if not f.startswith("__")) == ["baseline.cpp"]


def test_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    bad = tmp_path / "baseline.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        native.build()
    assert "error" in str(err.value)
    assert not os.path.exists(native.library_path())


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build()


def test_dispatch_never_selects_native():
    """Where the JAX dispatcher sends a small default-weight session to
    its native rung, the port's picks by device type alone."""
    snap = generate_snapshot(n_tasks=32, n_nodes=8, gang_size=4)
    from volcano_tpu.ops.dispatch import select_executor as jax_select

    assert jax_select(snap) == "native"
    assert dispatch.select_executor(snap, device="cpu") == "torch-scan"
    assert dispatch.select_executor(snap, device="cuda") == "cuda"
