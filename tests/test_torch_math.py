"""The CUDA kernel's own per-node arithmetic, run on this machine.

``volcano_tpu_torch/csrc/session_math.cuh`` holds the fit, the three
scores and the masked value as ``__host__ __device__`` functions; here
g++ compiles that header (no FMA contraction, IEEE division — the
flags the kernel is built with mean the same for nvcc) into a small
ctypes library, and its masked score for every node is held bit for bit
against the port's plain version, ``masked_score_plane``."""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from volcano_tpu_torch.ops.kernels import DEFAULT_WEIGHTS, ScoreWeights
from volcano_tpu_torch.ops.session_kernel import (
    masked_score_plane,
    prepare_session_arrays,
    score_planes,
)
from volcano_tpu_torch.ops.synthetic import generate_snapshot
from tests.test_torch_kernels import one_torch_thread  # noqa: F401

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "volcano_tpu_torch", "csrc")

SHIM = r"""
#include "session_math.cuh"

extern "C" void masked_scores(int R, int N, const float* rr, const float* tol, float act,
                              const unsigned char* cls_ok, const float* base,
                              const float* alloc, const float* used, const float* cnt,
                              const float* maxt, const float* w6, int lr_int, float* out) {
  const vt::Weights w{w6[0], w6[1], w6[2], w6[3], w6[4], w6[5]};
  for (int n = 0; n < N; ++n) {
    out[n] = lr_int ? vt::masked_score<true>(R, rr, tol, act, cls_ok[n] != 0, base + n,
                                             alloc + n, used + n, N, cnt[n], maxt[n], w)
                    : vt::masked_score<false>(R, rr, tol, act, cls_ok[n] != 0, base + n,
                                              alloc + n, used + n, N, cnt[n], maxt[n], w);
  }
}

extern "C" void node_scores(int R, int N, const float* rr, const float* alloc,
                            const float* used, const float* w6, int lr_int, float* out) {
  const vt::Weights w{w6[0], w6[1], w6[2], w6[3], w6[4], w6[5]};
  for (int n = 0; n < N; ++n) {
    out[n] = lr_int ? vt::node_score<true>(R, rr, alloc + n, used + n, N, w)
                    : vt::node_score<false>(R, rr, alloc + n, used + n, N, w);
  }
}
"""

SNAPSHOTS = {
    "predicates": dict(n_tasks=64, n_nodes=300, gang_size=4, seed=11, label_classes=4,
                       taint_fraction=0.25),
    "tight-nodes": dict(n_tasks=64, n_nodes=200, gang_size=2, seed=12,
                        node_cpu_milli=8_000, node_mem_mib=16_384),
}
WEIGHTS = {
    "default": DEFAULT_WEIGHTS,
    "custom": ScoreWeights(binpack_weight=2.0, binpack_memory=0.75,
                           least_requested_weight=0.5, balanced_resource_weight=3.0),
}


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available")
    d = tmp_path_factory.mktemp("session_math")
    src, lib = d / "shim.cpp", d / "libshim.so"
    src.write_text(SHIM)
    subprocess.run(
        [gxx, "-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC", "-I", CSRC,
         str(src), "-o", str(lib)],
        check=True, capture_output=True,
    )
    so = ctypes.CDLL(str(lib))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    so.masked_scores.argtypes = [i, i, p, p, f, p, p, p, p, p, p, p, i, p]
    so.masked_scores.restype = None
    so.node_scores.argtypes = [i, i, p, p, p, p, i, p]
    so.node_scores.restype = None
    return so


def _ptr(a: np.ndarray) -> int:
    assert a.flags["C_CONTIGUOUS"]
    return a.ctypes.data


def _held_against_plain(shim, case: str, w: ScoreWeights, snapshots=SNAPSHOTS):
    """Every task's masked scores from the shim (in w's least-requested
    mode) equal masked_score_plane's, bit for bit, over random node
    states."""
    arrays, T, NK = prepare_session_arrays(generate_snapshot(**snapshots[case]))
    R = arrays["taskrow"].shape[1] - 2
    nd = arrays["nd"]
    base, alloc = nd[:R], nd[R : 2 * R]
    maxt = np.ascontiguousarray(nd[3 * R + 1])
    tol = arrays["tol"]
    w6 = np.array(w[:6], dtype=np.float32)
    rng = np.random.RandomState(snapshots[case]["seed"])
    seen = set()
    for t in range(T):
        # a fresh node state per task: integer loads, some past capacity
        used = np.floor(rng.rand(R, NK) * 1.05 * np.maximum(alloc, 1.0)).astype(np.float32)
        cnt = rng.randint(100, 115, size=NK).astype(np.float32)
        row = arrays["taskrow"][t]
        rr = np.ascontiguousarray(row[:R])
        # some nodes sit exactly on the fit boundary: idle + tol == rr
        edge = rng.rand(NK) < 0.2
        lane = rng.randint(0, R)
        used[lane, edge] = base[lane, edge] - rr[lane] + tol[lane]
        act = float(t % 7 != 0)  # every seventh task inactive
        cls_ok = np.ascontiguousarray(arrays["cf_u8"][int(row[R])])
        out = np.empty(NK, dtype=np.float32)
        shim.masked_scores(R, NK, _ptr(rr), _ptr(tol), act, _ptr(cls_ok), _ptr(base),
                           _ptr(alloc), _ptr(used), _ptr(cnt), _ptr(maxt), _ptr(w6),
                           int(w.lr_int_exact), _ptr(out))
        want = masked_score_plane(
            rr.tolist(), tol.tolist(), act, torch.from_numpy(cls_ok != 0),
            torch.from_numpy(base), torch.from_numpy(alloc), torch.from_numpy(used),
            torch.from_numpy(cnt), torch.from_numpy(maxt), w,
        ).numpy()
        assert np.array_equal(want.view(np.uint32), out.view(np.uint32)), f"task {t}"
        seen.update(np.unique(out[np.isfinite(out)]).tolist())
    assert len(seen) > 10  # many distinct scores, not a degenerate plane


@pytest.mark.parametrize("weights", list(WEIGHTS), ids=list(WEIGHTS))
@pytest.mark.parametrize("case", list(SNAPSHOTS), ids=list(SNAPSHOTS))
def test_kernel_math_matches_plain_version(shim, case, weights):
    _held_against_plain(shim, case, WEIGHTS[weights])


#: DGX H100 nodes (2 x 56-core Xeon 8480C, 2 TB): memory x 10 >= 2^24,
#: outside the f32 floor-division envelope
DGX_NODES = dict(node_cpu_milli=224_000, node_mem_mib=2_097_152)
INT_SNAPSHOTS = {
    "dgx-predicates": dict(SNAPSHOTS["predicates"], **DGX_NODES),
    "dgx-tight-nodes": dict(SNAPSHOTS["tight-nodes"], node_cpu_milli=224_000,
                            node_mem_mib=4_000_003),
    "predicates": SNAPSHOTS["predicates"],
}


@pytest.mark.parametrize("weights", list(WEIGHTS), ids=list(WEIGHTS))
@pytest.mark.parametrize("case", list(INT_SNAPSHOTS), ids=list(INT_SNAPSHOTS))
def test_kernel_math_int_mode_matches_plain_version(shim, case, weights):
    """The int-exact least-requested mode (vt::Weights::lr_int), inside
    the envelope and outside it."""
    _held_against_plain(shim, case, WEIGHTS[weights]._replace(lr_int_exact=True),
                        INT_SNAPSHOTS)


def test_int_mode_edges_match_jax(shim):
    """Values where C++ and XLA part ways, scored by the shim, the plain
    version, the port's torch spec and the JAX package alike: f32 values
    at and past 2^31 (XLA's convert saturates), a negative load whose
    capacity - request wraps past 2^31, products that wrap, and a
    request past capacity."""
    import jax.numpy as jnp

    from volcano_tpu.ops.kernels import node_scores as jax_node_scores
    from volcano_tpu.ops.kernels import ScoreWeights as JaxWeights
    from volcano_tpu_torch.ops.kernels import node_scores as torch_node_scores

    rr = np.array([1_000.0, 4_096.0], dtype=np.float32)
    alloc = np.array([
        [2.0**31, 3e9, 2e9, 224_000.0, 3e8, 224_000.0, 5e9, 1.0],
        [2_097_152.0, 2_097_152.0, 2e9, 2e9, 2_000_000.0, 2_097_152.0, 2.0**31, 0.0],
    ], dtype=np.float32)
    used = np.array([
        [0.0, 1e9, -2e9, 300_000.0, 1e7, 5_000.0, 2.0**31, 0.0],
        [100.0, 2.5e9, -1.5e9, 1e9, 0.0, 1_000_000.0, 0.0, 0.0],
    ], dtype=np.float32)
    N = alloc.shape[1]
    for w in WEIGHTS.values():
        w = w._replace(lr_int_exact=True)
        out = np.empty(N, dtype=np.float32)
        shim.node_scores(2, N, _ptr(rr), _ptr(alloc), _ptr(used),
                         _ptr(np.array(w[:6], dtype=np.float32)), 1, _ptr(out))
        plain = score_planes(rr.tolist(), [float(rr[r]) + torch.from_numpy(used[r])
                                           for r in range(2)], torch.from_numpy(alloc), w)
        spec = torch_node_scores(torch.from_numpy(rr[None]), torch.from_numpy(used.T.copy()),
                                 torch.from_numpy(alloc.T.copy()), w)[0]
        ref = np.asarray(jax_node_scores(jnp.asarray(rr[None]), jnp.asarray(used.T),
                                         jnp.asarray(alloc.T), JaxWeights(*w)))[0]
        assert np.isfinite(ref).all()
        for got in (out, plain.numpy(), spec.numpy()):
            assert np.array_equal(ref.view(np.uint32), got.view(np.uint32)), (got, ref)
