"""The session kernel's step logic, run on this machine, and the host
packing and shared-memory planning around it.

``volcano_tpu_torch/csrc/session_step.cuh`` holds the control logic of
a step over a class-compacted node list (which list a task sweeps, one
thread's share of a full or a fast repeated-row step, the update at the
pick) as ``__host__ __device__`` functions.  Here g++ compiles it (no
FMA contraction, IEEE division) with a host loop that plays the
kernel's block: every thread's share in turn, each thread's best kept
between steps, only the previous pick's owner rescoring on a fast step,
then the block argmax over (value, key).  Its ``chosen`` is held bit for
bit against the plain version ``session_pass_reference`` and, through
the gang fixpoint, against ``run_packed_pallas(..., interpret=True)``,
with the masked-score plane on and off."""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from volcano_tpu.ops.pallas_session import run_packed_pallas
from volcano_tpu.ops.synthetic import generate_snapshot as jax_generate_snapshot
from volcano_tpu_torch.ops import session_kernel
from volcano_tpu_torch.ops.kernels import DEFAULT_WEIGHTS
from volcano_tpu_torch.ops.session_kernel import (
    _STATIC_SMEM,
    class_lists,
    fits_shared_memory,
    MAX_LANES,
    plan_shared_memory,
    prepare_session_arrays,
    repeated_rows,
    run_packed_cuda,
    session_pass_cuda,
    session_pass_reference,
    SMEM_LIMIT,
)
from volcano_tpu_torch.ops.synthetic import generate_snapshot
from tests.test_torch_kernels import one_torch_thread  # noqa: F401
from tests.test_torch_session import PALLAS_CASES, pass_inputs

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "volcano_tpu_torch", "csrc")

SHIM = r"""
#include <math.h>
#include <vector>

#include "session_step.cuh"

template <int R>
static void pass(int T, const float* taskrow, int C, const int* cls_off, const int* cls_nodes,
                 const float* lnd, int LT, const float* nd, const float* tol, int NK,
                 const float* w6, int threads, int plane_len, int* chosen, int* stats) {
  constexpr int RC = R + 2;
  const vt::Weights w{w6[0], w6[1], w6[2], w6[3], w6[4], w6[5]};
  std::vector<float> used(nd + 2 * R * NK, nd + 3 * R * NK);
  std::vector<float> cnt(nd + 3 * R * NK, nd + (3 * R + 1) * NK);
  std::vector<float> plane(plane_len > 0 ? plane_len : 1);
  float* pl = plane_len > 0 ? plane.data() : nullptr;
  const vt::NodeState ns{cls_nodes, lnd, LT, used.data(), cnt.data(), NK};
  std::vector<float> tv(threads, -INFINITY);  // each thread's best, kept between steps
  std::vector<int> tk(threads, vt::kNoPick);
  int pick = vt::kNoPick, n_full = 0, n_fast = 0;
  for (int t = 0; t < T; ++t) {
    const float* row = taskrow + t * RC;
    const float act = row[R + 1];
    int start, len;
    vt::task_list(row[R], C, cls_off, start, len);
    if (pl == nullptr || t == 0 || !vt::same_row(row, row - RC, RC)) {
      ++n_full;
      for (int th = 0; th < threads; ++th) {
        if (act > 0.0f && len > 0) {
          vt::sweep_list<R>(ns, start, len, th, threads, -1, 0, pl, row, tol, act, w, tv[th],
                            tk[th]);
        } else {
          tv[th] = -INFINITY;
          tk[th] = vt::kNoPick;
        }
      }
    } else {
      ++n_fast;
      if (pick != vt::kNoPick) {
        const int th = vt::key_pos(pick) % threads;
        vt::sweep_list<R>(ns, start, len, th, threads, vt::key_pos(pick), vt::key_node(pick),
                          pl, row, tol, act, w, tv[th], tk[th]);
      }
    }
    float bv = -INFINITY;
    int bk = vt::kNoPick;
    for (int th = 0; th < threads; ++th) {
      if (tv[th] > bv || (tv[th] == bv && tk[th] < bk)) {
        bv = tv[th];
        bk = tk[th];
      }
    }
    if (bv > -INFINITY) {
      const int n = vt::key_node(bk);
      vt::apply_pick<R>(used.data(), cnt.data(), NK, row, n);
      chosen[t] = n;
      pick = bk;
    } else {
      chosen[t] = -1;
      pick = vt::kNoPick;
    }
  }
  stats[0] = n_full;
  stats[1] = n_fast;
}

extern "C" void session_pass_host(int R, int T, const float* taskrow, int C, const int* cls_off,
                                  const int* cls_nodes, const float* lnd, int LT,
                                  const float* nd, const float* tol, int NK, const float* w6,
                                  int threads, int plane_len, int* chosen, int* stats) {
  if (R == 2) {
    pass<2>(T, taskrow, C, cls_off, cls_nodes, lnd, LT, nd, tol, NK, w6, threads, plane_len,
            chosen, stats);
  } else {
    pass<3>(T, taskrow, C, cls_off, cls_nodes, lnd, LT, nd, tol, NK, w6, threads, plane_len,
            chosen, stats);
  }
}
"""


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available")
    d = tmp_path_factory.mktemp("session_step")
    src, lib = d / "shim.cpp", d / "libshim.so"
    src.write_text(SHIM)
    subprocess.run(
        [gxx, "-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC", "-I", CSRC,
         str(src), "-o", str(lib)],
        check=True, capture_output=True,
    )
    so = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    so.session_pass_host.argtypes = [i, i, p, i, p, p, p, i, p, p, i, p, i, i, p, p]
    so.session_pass_host.restype = None
    return so


def _ptr(a: np.ndarray) -> int:
    assert a.flags["C_CONTIGUOUS"]
    return a.ctypes.data


def host_pass(shim, inputs, plane: bool, threads: int = 1024, weights=DEFAULT_WEIGHTS):
    """(chosen tensor, [full, fast]) of the host loop over one pass's
    operands; ``plane`` sizes the plane for the longest list, or leaves
    it out."""
    taskrow, cf, nd, tol, cls_off, cls_nodes = (np.ascontiguousarray(x.numpy()) for x in inputs)
    T, RC = taskrow.shape
    lens = np.diff(cls_off)
    plane_len = int(lens.max(initial=0)) if plane else 0
    w6 = np.array(weights[:6], dtype=np.float32)
    chosen = np.empty(T, dtype=np.int32)
    stats = np.zeros(2, dtype=np.int32)
    nodes = cls_nodes if cls_nodes.size else np.zeros(1, dtype=np.int32)
    lnd = np.ascontiguousarray(nd[:, nodes])  # the launcher's gather: planes in list order
    shim.session_pass_host(RC - 2, T, _ptr(taskrow), cf.shape[0], _ptr(cls_off), _ptr(nodes),
                           _ptr(lnd), nodes.shape[0], _ptr(nd), _ptr(tol), cf.shape[1],
                           _ptr(w6), threads, plane_len, _ptr(chosen), _ptr(stats))
    return torch.from_numpy(chosen), stats.tolist()


def _inputs(case: str):
    arrays, _, _ = prepare_session_arrays(generate_snapshot(**PALLAS_CASES[case]))
    return pass_inputs(arrays)


def _check(shim, inputs, plane: bool, threads: int = 1024):
    """Host loop == plain version; its step counts follow the plane."""
    got, stats = host_pass(shim, inputs, plane, threads)
    want = session_pass_reference(*inputs)
    assert torch.equal(got, want)
    T = inputs[0].shape[0]
    fast = repeated_rows(inputs[0]) if plane else 0
    assert stats == [T - fast, fast]
    return got


# ---- the host loop against the plain version and the Pallas kernel ----

@pytest.mark.parametrize("threads", [1024, 16])
@pytest.mark.parametrize("plane", [True, False], ids=["plane", "no-plane"])
@pytest.mark.parametrize("case", list(PALLAS_CASES), ids=list(PALLAS_CASES))
def test_host_loop_matches_plain_version(shim, case, plane, threads):
    got = _check(shim, _inputs(case), plane, threads)
    assert (got >= 0).any()


@functools.lru_cache(maxsize=None)
def _pallas_assignment(case: str) -> np.ndarray:
    return run_packed_pallas(jax_generate_snapshot(**PALLAS_CASES[case]), block_size=128,
                             interpret=True)


@pytest.mark.parametrize("plane", [True, False], ids=["plane", "no-plane"])
@pytest.mark.parametrize("case", list(PALLAS_CASES), ids=list(PALLAS_CASES))
def test_host_loop_session_matches_pallas(shim, monkeypatch, case, plane):
    """The gang fixpoint of run_packed_cuda with every pass run by the
    host loop."""
    def host(taskrow, cf, nd, tol, cls_off, cls_nodes, weights, done, stats, plan):
        if int(done[0]):
            return torch.full((taskrow.shape[0],), -1, dtype=torch.int32)
        return host_pass(shim, (taskrow, cf, nd, tol, cls_off, cls_nodes), plane,
                         weights=weights)[0]

    monkeypatch.setattr(session_kernel, "_pass", host)
    got = run_packed_cuda(generate_snapshot(**PALLAS_CASES[case]), device="cpu")
    assert np.array_equal(_pallas_assignment(case), got)


@pytest.mark.parametrize("case", list(PALLAS_CASES), ids=list(PALLAS_CASES))
def test_fast_steps_count_repeated_rows(shim, case):
    """With the plane, the fast steps are exactly the rows equal to the
    row before; gangs make them most of the pass."""
    inputs = _inputs(case)
    taskrow = inputs[0].numpy()
    want = int(sum(taskrow[t].tobytes() == taskrow[t - 1].tobytes()
                   for t in range(1, taskrow.shape[0])))
    _, stats = host_pass(shim, inputs, plane=True)
    assert stats == [taskrow.shape[0] - want, want]
    assert repeated_rows(inputs[0]) == want
    gang = PALLAS_CASES[case]["gang_size"]
    assert want >= taskrow.shape[0] * (gang - 1) // gang // 2


# ---- edge cases of the lists and the fast path ----

def _edit_empty_list(inputs):
    """Class 1's list is empty: its tasks place nothing."""
    taskrow, cf, nd, tol, _, _ = inputs
    cf = cf.clone()
    cf[1] = 0
    off, nodes = class_lists(cf.numpy())
    assert (taskrow[:, 2] == 1).any()
    return taskrow, cf, nd, tol, torch.from_numpy(off), torch.from_numpy(nodes)


def _edit_class_out_of_range(inputs):
    """Classes C, -3 and 7.5 place nothing; -0.5 truncates to class 0."""
    taskrow = inputs[0].clone()
    C = inputs[1].shape[0]
    taskrow[0:8, 2] = float(C)
    taskrow[8:16, 2] = -3.0
    taskrow[16:24, 2] = -0.5
    taskrow[24:32, 2] = C + 0.5
    return (taskrow,) + tuple(inputs[1:])


def _edit_repeat_after_miss(inputs):
    """A gang asking more than any node has: its repeated rows each follow
    a -1 pick; the gang after it asks for little."""
    taskrow = inputs[0].clone()
    taskrow[40:48, 0] = 1e7
    taskrow[48:56, 0] = 250.0
    return (taskrow,) + tuple(inputs[1:])


def _edit_inactive_in_gang(inputs):
    """Every third row inactive: repeated rows broken, and an inactive
    row repeated."""
    taskrow = inputs[0].clone()
    taskrow[::3, 3] = 0.0
    taskrow[100:104, 3] = 0.0
    return (taskrow,) + tuple(inputs[1:])


EDITS = {
    "empty-list": ("predicates", _edit_empty_list),
    "class-out-of-range": ("predicates", _edit_class_out_of_range),
    "repeat-after-miss": ("random-0", _edit_repeat_after_miss),
    "inactive-in-gang": ("predicates", _edit_inactive_in_gang),
}


@pytest.mark.parametrize("threads", [1024, 16])
@pytest.mark.parametrize("plane", [True, False], ids=["plane", "no-plane"])
@pytest.mark.parametrize("edit", list(EDITS), ids=list(EDITS))
def test_host_loop_edge_cases(shim, edit, plane, threads):
    case, fn = EDITS[edit]
    inputs = fn(_inputs(case))
    got = _check(shim, inputs, plane, threads)
    taskrow = inputs[0]
    if edit == "empty-list":
        assert (got[taskrow[:, 2] == 1] == -1).all()
    elif edit == "class-out-of-range":
        assert (got[:16] == -1).all() and (got[24:32] == -1).all() and (got[16:24] >= 0).all()
    elif edit == "repeat-after-miss":
        assert (got[40:48] == -1).all() and (got[48:56] >= 0).all()
    else:
        assert (got[::3] == -1).all() and (got[1::3] >= 0).any()


@pytest.mark.parametrize("plane", [True, False], ids=["plane", "no-plane"])
def test_tie_goes_to_lowest_list_position(shim, plane):
    """Every node equal: each score ties across all list positions, held by
    different threads; the lowest node of the list wins, and then the
    next lowest once the first is loaded."""
    arrays, _, _ = prepare_session_arrays(generate_snapshot(n_tasks=8, n_nodes=40, gang_size=8,
                                                            seed=3, label_classes=2))
    inputs = pass_inputs(arrays)
    off, nodes = arrays["cls_off"], arrays["cls_nodes"]
    got = _check(shim, inputs, plane, threads=4)
    c = int(arrays["taskrow"][0, 2])
    first = nodes[off[c]]
    assert int(got[0]) == first
    assert np.isin(got.numpy(), nodes[off[c] : off[c + 1]]).all()


# ---- host packing and shared-memory planning ----

@pytest.mark.parametrize("case", list(PALLAS_CASES), ids=list(PALLAS_CASES))
def test_class_lists_match_flatnonzero(case):
    arrays, _, NK = prepare_session_arrays(generate_snapshot(**PALLAS_CASES[case]))
    cf, off, nodes = arrays["cf_u8"], arrays["cls_off"], arrays["cls_nodes"]
    assert off.dtype == np.int32 and nodes.dtype == np.int32
    assert off.shape == (cf.shape[0] + 1,) and off[0] == 0 and off[-1] == nodes.shape[0]
    for c in range(cf.shape[0]):
        assert np.array_equal(nodes[off[c] : off[c + 1]], np.flatnonzero(cf[c]))


@pytest.mark.parametrize("R", range(2, MAX_LANES + 1))
def test_planner_keeps_every_session_the_gate_took(R):
    """Every (R, NK) the node-state gate of the first kernel accepted
    (static shared memory then 328 bytes) is still accepted, and the
    plane is on exactly where it fits beside the node state."""
    first_gate_static = 328
    NK = 128
    while (R + 1) * NK * 4 + first_gate_static <= SMEM_LIMIT:
        assert fits_shared_memory(R, NK)
        for max_len in {0, 1, NK // 2, NK}:
            fits = (R + 1) * NK * 4 + max_len * 4 + _STATIC_SMEM <= SMEM_LIMIT
            assert plan_shared_memory(R, NK, max_len) == (max_len if fits else 0)
        NK += 128
    assert not fits_shared_memory(R, NK)
    with pytest.raises(ValueError, match="shared memory"):
        plan_shared_memory(R, NK, 0)


def test_planner_sizes_of_the_main_path():
    """50k x 10k (lists of ~1,200) keeps its plane; 16,384 nodes at R = 2
    with one class of every node does not."""
    assert plan_shared_memory(2, 10_240, 1_250) == 1_250
    assert plan_shared_memory(2, 10_240, 10_000) == 10_000
    assert plan_shared_memory(2, 16_384, 16_384) == 0
    assert fits_shared_memory(2, 16_384)


def test_wrapper_counts_steps_on_cpu():
    """On CPU tensors the wrapper runs the plain version and launches
    nothing; the step counts are the kernel's, so a CPU pass has none to
    give and refuses ``stats``."""
    inputs = _inputs("random-0")
    before = session_kernel.LAUNCHES
    got = session_pass_cuda(*inputs)
    assert session_kernel.LAUNCHES == before
    assert torch.equal(got, session_pass_reference(*inputs))
    for done in (None, torch.ones(1, dtype=torch.int32)):
        with pytest.raises(ValueError, match="stats"):
            session_pass_cuda(*inputs, done=done, stats=torch.zeros(2, dtype=torch.int32))
    assert session_kernel.LAUNCHES == before


def test_session_plans_its_launches_once(monkeypatch):
    """The gang fixpoint plans its launches (plane, list-order gather,
    scratch) once for all its rounds; on CPU operands there is no plan."""
    calls = []
    real = session_kernel.launch_plan

    def counted(*args):
        calls.append(real(*args))
        return calls[-1]

    monkeypatch.setattr(session_kernel, "launch_plan", counted)
    snap = generate_snapshot(**PALLAS_CASES["predicates"])
    got = run_packed_cuda(snap, device="cpu", gang_rounds=3)
    assert calls == [None]
    assert np.array_equal(got, _pallas_assignment("predicates"))


def test_wrapper_rejects_bad_lists():
    taskrow, cf, nd, tol, off, nodes = _inputs("predicates")
    NK = cf.shape[1]
    falling = nodes.clone()
    falling[[1, 2]] = falling[[2, 1]]
    beyond = nodes.clone()
    beyond[-1] = NK
    short = off.clone()
    short[-1] -= 1
    for lists in ((off, falling), (off, beyond), (short, nodes)):
        with pytest.raises(ValueError, match="class lists"):
            session_pass_cuda(taskrow, cf, nd, tol, *lists)
    with pytest.raises(ValueError, match="cls_off"):
        session_pass_cuda(taskrow, cf, nd, tol, off[:-1], nodes)
