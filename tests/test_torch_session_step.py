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
with the masked-score plane on and off.  The wide instance's step
(``R = vt::kWide``: lanes counted at run time, used lanes by node id,
keys that are list positions) runs through the same loop."""

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

template <int R, bool LrInt>
static void pass(int nR, int T, const float* taskrow, int C, const int* cls_off,
                 const int* cls_nodes, const float* lnd, int LT, const float* nd,
                 const float* tol, int NK, const vt::Weights& w, int threads, int plane_len,
                 int* chosen, int* stats) {
  const int lanes = R == vt::kWide ? nR : R;
  const int RC = lanes + 2;
  std::vector<float> used(nd + 2 * lanes * NK, nd + 3 * lanes * NK);
  std::vector<float> cnt(nd + 3 * lanes * NK, nd + (3 * lanes + 1) * NK);
  std::vector<float> plane(plane_len > 0 ? plane_len : 1);
  float* pl = plane_len > 0 ? plane.data() : nullptr;
  const vt::NodeState ns{cls_nodes, lnd, LT, used.data(), cnt.data(), NK, lanes};
  std::vector<float> tv(threads, -INFINITY);  // each thread's best, kept between steps
  std::vector<int> tk(threads, vt::kNoPick);
  int pick = vt::kNoPick, n_full = 0, n_fast = 0;
  for (int t = 0; t < T; ++t) {
    const float* row = taskrow + t * RC;
    const float act = row[lanes + 1];
    int start, len;
    vt::task_list(row[lanes], C, cls_off, start, len);
    if (pl == nullptr || t == 0 || !vt::same_row(row, row - RC, RC)) {
      ++n_full;
      for (int th = 0; th < threads; ++th) {
        if (act > 0.0f && len > 0) {
          vt::sweep_list<R, LrInt>(ns, start, len, th, threads, -1, 0, pl, row, tol, act, w,
                                   tv[th], tk[th]);
        } else {
          tv[th] = -INFINITY;
          tk[th] = vt::kNoPick;
        }
      }
    } else {
      ++n_fast;
      if (pick != vt::kNoPick) {
        const int th = vt::key_pos_of<R>(pick) % threads;
        vt::sweep_list<R, LrInt>(ns, start, len, th, threads, vt::key_pos_of<R>(pick),
                                 vt::key_node_of<R>(pick, cls_nodes + start), pl, row, tol, act,
                                 w, tv[th], tk[th]);
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
      const int n = vt::key_node_of<R>(bk, cls_nodes + start);
      vt::apply_pick<R>(used.data(), cnt.data(), NK, row, n, lanes);
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

// wide: the wide instance's step, any R; else R = 2 or 3
extern "C" void session_pass_host(int R, int wide, int T, const float* taskrow, int C,
                                  const int* cls_off, const int* cls_nodes, const float* lnd,
                                  int LT, const float* nd, const float* tol, int NK,
                                  const float* w6, int lr_int, int threads, int plane_len,
                                  int* chosen, int* stats) {
  const vt::Weights w{w6[0], w6[1], w6[2], w6[3], w6[4], w6[5]};
  auto run = wide ? (lr_int ? pass<vt::kWide, true> : pass<vt::kWide, false>)
             : R == 2 ? (lr_int ? pass<2, true> : pass<2, false>)
                      : (lr_int ? pass<3, true> : pass<3, false>);
  run(R, T, taskrow, C, cls_off, cls_nodes, lnd, LT, nd, tol, NK, w, threads, plane_len,
      chosen, stats);
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
    so.session_pass_host.argtypes = [i, i, i, p, i, p, p, p, i, p, p, i, p, i, i, i, p, p]
    so.session_pass_host.restype = None
    return so


def _ptr(a: np.ndarray) -> int:
    assert a.flags["C_CONTIGUOUS"]
    return a.ctypes.data


def host_pass(shim, inputs, plane: bool, threads: int = 1024, weights=DEFAULT_WEIGHTS,
              wide: bool = False):
    """(chosen tensor, [full, fast]) of the host loop over one pass's
    operands; ``plane`` sizes the plane for the longest list, or leaves
    it out; ``wide`` runs the wide instance's step."""
    taskrow, cf, nd, tol, cls_off, cls_nodes = (np.ascontiguousarray(x.numpy()) for x in inputs)
    T, RC = taskrow.shape
    lens = np.diff(cls_off)
    plane_len = int(lens.max(initial=0)) if plane else 0
    w6 = np.array(weights[:6], dtype=np.float32)
    chosen = np.empty(T, dtype=np.int32)
    stats = np.zeros(2, dtype=np.int32)
    nodes = cls_nodes if cls_nodes.size else np.zeros(1, dtype=np.int32)
    lnd = np.ascontiguousarray(nd[:, nodes])  # the launcher's gather: planes in list order
    shim.session_pass_host(RC - 2, int(wide), T, _ptr(taskrow), cf.shape[0], _ptr(cls_off), _ptr(nodes),
                           _ptr(lnd), nodes.shape[0], _ptr(nd), _ptr(tol), cf.shape[1],
                           _ptr(w6), int(weights.lr_int_exact), threads, plane_len,
                           _ptr(chosen), _ptr(stats))
    return torch.from_numpy(chosen), stats.tolist()


def _inputs(case: str, cases=PALLAS_CASES):
    arrays, _, _ = prepare_session_arrays(generate_snapshot(**cases[case]))
    return pass_inputs(arrays)


def _check(shim, inputs, plane: bool, threads: int = 1024, weights=DEFAULT_WEIGHTS,
           wide: bool = False):
    """Host loop == plain version; its step counts follow the plane."""
    got, stats = host_pass(shim, inputs, plane, threads, weights, wide)
    want = session_pass_reference(*inputs, weights=weights)
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


# ---- the int-exact least-requested mode ----

#: DGX H100 nodes (2 x 56-core Xeon 8480C, 2 TB): memory x 10 >= 2^24,
#: outside the f32 floor-division envelope
DGX_NODES = dict(node_cpu_milli=224_000, node_mem_mib=2_097_152)
INT_CASES = {
    "dgx-random-0": dict(PALLAS_CASES["random-0"], **DGX_NODES),
    "dgx-predicates": dict(PALLAS_CASES["predicates"], **DGX_NODES),
    "dgx-single-node": dict(PALLAS_CASES["single-node"], **DGX_NODES),
    "pressure-4m-mib": dict(PALLAS_CASES["capacity-pressure"], node_mem_mib=4_000_003),
}
INT_WEIGHTS = DEFAULT_WEIGHTS._replace(lr_int_exact=True)


def to_jax(snap):
    """The JAX package's PackedSnapshot holding copies of ``snap``'s arrays."""
    from volcano_tpu.ops.packing import PackedSnapshot as JaxSnapshot

    out = JaxSnapshot()
    for name, value in vars(snap).items():
        if not name.startswith("_"):
            setattr(out, name, value.copy() if isinstance(value, np.ndarray) else value)
    return out


@pytest.mark.parametrize("threads", [1024, 16])
@pytest.mark.parametrize("plane", [True, False], ids=["plane", "no-plane"])
@pytest.mark.parametrize("case", list(INT_CASES), ids=list(INT_CASES))
def test_host_loop_int_mode_matches_plain_version(shim, case, plane, threads):
    got = _check(shim, _inputs(case, INT_CASES), plane, threads, INT_WEIGHTS)
    assert (got >= 0).any()


@pytest.mark.parametrize("plane", [True, False], ids=["plane", "no-plane"])
@pytest.mark.parametrize("case", list(INT_CASES), ids=list(INT_CASES))
def test_host_loop_int_session_matches_jax(shim, monkeypatch, case, plane):
    """Outside the envelope the wrapper switches to int32 least-requested
    by itself, as the JAX package's run_packed and run_packed_blocked do
    (its Pallas kernel has no int path)."""
    from volcano_tpu.ops.blocked import run_packed_blocked as jax_run_packed_blocked
    from volcano_tpu.ops.kernels import run_packed as jax_run_packed

    def host(taskrow, cf, nd, tol, cls_off, cls_nodes, weights, done, stats, plan):
        assert weights.lr_int_exact
        if int(done[0]):
            return torch.full((taskrow.shape[0],), -1, dtype=torch.int32)
        return host_pass(shim, (taskrow, cf, nd, tol, cls_off, cls_nodes), plane,
                         weights=weights)[0]

    monkeypatch.setattr(session_kernel, "_pass", host)
    snap = generate_snapshot(**INT_CASES[case])
    got = run_packed_cuda(snap, device="cpu")
    jax_snap = jax_generate_snapshot(**INT_CASES[case])
    np.testing.assert_array_equal(np.asarray(jax_run_packed(jax_snap)), got)
    if plane:
        np.testing.assert_array_equal(
            np.asarray(jax_run_packed_blocked(jax_snap, block_size=32, top_k=4)), got)


def test_lr_modes_pick_differently_outside_the_envelope(shim):
    """One session outside the envelope where f32 least-requested picks
    node 0 and int32 node 1: the host loop in each mode equals the plain
    version in that mode and the JAX package's pass in that mode."""
    import jax.numpy as jnp

    from volcano_tpu.ops.kernels import _feasibility_classes as jax_classes
    from volcano_tpu.ops.kernels import run_packed as jax_run_packed
    from volcano_tpu.ops.kernels import schedule_pass as jax_schedule_pass
    from volcano_tpu.ops.kernels import ScoreWeights as JaxWeights
    from volcano_tpu_torch.ops.synthetic import generate_lr_mode_split

    snap = generate_lr_mode_split()
    inputs = pass_inputs(prepare_session_arrays(snap)[0])
    picks = {}
    for plane in (True, False):
        picks[plane] = (int(_check(shim, inputs, plane, weights=DEFAULT_WEIGHTS)[0]),
                        int(_check(shim, inputs, plane, weights=INT_WEIGHTS)[0]))
    assert picks == {True: (0, 1), False: (0, 1)}
    js = to_jax(snap)
    cls, sel, tol = jax_classes(js)
    active = np.zeros(js.task_resreq.shape[0], dtype=bool)
    active[: js.n_tasks] = True
    f32_pass, _ = jax_schedule_pass(
        js.task_resreq, js.task_job, cls, sel, tol, js.node_idle, js.node_used, js.node_alloc,
        js.node_label_bits, js.node_taint_bits, js.node_ok, js.node_task_count,
        js.node_max_tasks, js.job_min_available, js.tolerance, jnp.asarray(active),
        weights=JaxWeights())
    assert int(np.asarray(f32_pass)[0]) == 0
    # the session switches to int32 by itself, in both packages
    np.testing.assert_array_equal(np.asarray(jax_run_packed(js)), [1])
    np.testing.assert_array_equal(run_packed_cuda(snap, device="cpu"), [1])


def test_explicit_int_weights_follow_run_packed():
    """Inside the envelope the JAX package's Pallas kernel ignores
    ``weights.lr_int_exact``, while its run_packed and run_packed_blocked
    honour it; the two differ only where lanes are not whole numbers.
    The port follows the weights, as run_packed does."""
    from volcano_tpu.ops.blocked import run_packed_blocked as jax_run_packed_blocked
    from volcano_tpu.ops.kernels import run_packed as jax_run_packed
    from volcano_tpu.ops.kernels import ScoreWeights as JaxWeights

    snap = generate_snapshot(n_tasks=200, n_nodes=40, gang_size=4, seed=1)
    for plane in (snap.task_resreq, snap.node_alloc, snap.node_idle, snap.node_used):
        plane[:, 1] /= 1024.0  # memory in GiB: fractional lanes
    snap.tolerance[1] /= 1024.0
    js = to_jax(snap)
    got = run_packed_cuda(snap, weights=INT_WEIGHTS, device="cpu")
    np.testing.assert_array_equal(np.asarray(jax_run_packed(js, weights=JaxWeights(
        lr_int_exact=True))), got)
    np.testing.assert_array_equal(np.asarray(jax_run_packed_blocked(js, weights=JaxWeights(
        lr_int_exact=True), block_size=32, top_k=4)), got)
    f32 = run_packed_pallas(js, weights=JaxWeights(lr_int_exact=True), block_size=128,
                            interpret=True)
    np.testing.assert_array_equal(run_packed_cuda(snap, device="cpu"), f32)
    assert (f32 != got).sum() > 0


# ---- the wide instance's step ----

@pytest.mark.parametrize("threads", [1024, 16])
@pytest.mark.parametrize("plane", [True, False], ids=["plane", "no-plane"])
@pytest.mark.parametrize("case", list(PALLAS_CASES), ids=list(PALLAS_CASES))
def test_wide_host_loop_matches_plain_version(shim, case, plane, threads):
    got = _check(shim, _inputs(case), plane, threads, wide=True)
    assert (got >= 0).any()


@pytest.mark.parametrize("plane", [True, False], ids=["plane", "no-plane"])
@pytest.mark.parametrize("edit", list(EDITS), ids=list(EDITS))
def test_wide_host_loop_edge_cases(shim, edit, plane):
    case, fn = EDITS[edit]
    _check(shim, fn(_inputs(case)), plane, threads=16, wide=True)


@pytest.mark.parametrize("plane", [True, False], ids=["plane", "no-plane"])
@pytest.mark.parametrize("case", list(INT_CASES), ids=list(INT_CASES))
def test_wide_host_loop_int_mode(shim, case, plane):
    got = _check(shim, _inputs(case, INT_CASES), plane, 64, INT_WEIGHTS, wide=True)
    assert (got >= 0).any()


def _lane_snapshot(R: int):
    """A session with R - 2 scalar lanes beside cpu and memory."""
    from volcano_tpu_torch.ops.synthetic import add_scalar_lanes

    snap = generate_snapshot(n_tasks=240, n_nodes=48, gang_size=4, seed=10 + R)
    return add_scalar_lanes(snap, R - 2, R) if R > 2 else snap


LANE_WEIGHTS = {
    "default": DEFAULT_WEIGHTS,
    "int": INT_WEIGHTS,
    "binpack-scalar": DEFAULT_WEIGHTS._replace(binpack_scalar=1.0),
}


@pytest.mark.parametrize("weights", list(LANE_WEIGHTS), ids=list(LANE_WEIGHTS))
@pytest.mark.parametrize("plane", [True, False], ids=["plane", "no-plane"])
@pytest.mark.parametrize("R", [2, 5, 9, 12])
def test_wide_host_loop_any_lane_count(shim, R, plane, weights):
    """The wide step reads its lane count at run time: more lanes than
    the shared-memory layout has instances for."""
    inputs = pass_inputs(prepare_session_arrays(_lane_snapshot(R))[0])
    assert inputs[0].shape[1] == R + 2
    got = _check(shim, inputs, plane, 64, LANE_WEIGHTS[weights], wide=True)
    assert (got >= 0).any() and (got == -1).any() == (R > 2)


@pytest.mark.parametrize("case", ["9-lanes", "dgx-predicates", "predicates"])
def test_wide_host_loop_session_matches_jax(shim, monkeypatch, case):
    """The gang fixpoint of run_packed_cuda with every pass run by the
    wide step, against the JAX package's run_packed on the same arrays."""
    from volcano_tpu.ops.kernels import run_packed as jax_run_packed

    def host(taskrow, cf, nd, tol, cls_off, cls_nodes, weights, done, stats, plan):
        if int(done[0]):
            return torch.full((taskrow.shape[0],), -1, dtype=torch.int32)
        return host_pass(shim, (taskrow, cf, nd, tol, cls_off, cls_nodes), True,
                         weights=weights, wide=True)[0]

    monkeypatch.setattr(session_kernel, "_pass", host)
    cases = dict(PALLAS_CASES, **INT_CASES)
    snap = _lane_snapshot(9) if case == "9-lanes" else generate_snapshot(**cases[case])
    got = run_packed_cuda(snap, device="cpu")
    np.testing.assert_array_equal(np.asarray(jax_run_packed(to_jax(snap))), got)
    assert (got >= 0).any()


@pytest.mark.parametrize("plane", [True, False], ids=["plane", "no-plane"])
def test_wide_keys_reach_past_2_15_positions(shim, plane):
    """A list of 40,000 nodes whose first 35,000 are full: every pick
    sits past list position 2^15, where the shared layout's packed keys
    would overflow; the wide step's keys are plain positions."""
    arrays, _, NK = prepare_session_arrays(generate_snapshot(n_tasks=24, n_nodes=40_000,
                                                             gang_size=8, seed=2))
    R = arrays["taskrow"].shape[1] - 2
    nd = arrays["nd"]
    nd[2 * R : 3 * R, :35_000] = nd[:R, :35_000]  # used = base: nothing fits
    inputs = pass_inputs(arrays)
    assert int(torch.diff(inputs[4]).max()) > 2**15
    got = _check(shim, inputs, plane, 1024, wide=True)
    assert (got >= 35_000).all()


@pytest.mark.parametrize("wide", [False, True], ids=["shared", "wide"])
def test_discard_unstable_runs_the_fixpoint_to_its_end(shim, monkeypatch, wide):
    """``discard_unstable`` runs the kernel's gang rounds until the active
    set is stable, past ``gang_rounds``: equal to the JAX package's
    run_packed with the same option, and different from the bounded
    loop on a cascade one round leaves unsettled."""
    from volcano_tpu.ops.kernels import run_packed as jax_run_packed

    def host(taskrow, cf, nd, tol, cls_off, cls_nodes, weights, done, stats, plan):
        if int(done[0]):
            return torch.full((taskrow.shape[0],), -1, dtype=torch.int32)
        return host_pass(shim, (taskrow, cf, nd, tol, cls_off, cls_nodes), True,
                         weights=weights, wide=wide)[0]

    monkeypatch.setattr(session_kernel, "_pass", host)
    kwargs = dict(n_tasks=400, n_nodes=16, gang_size=5, seed=4, node_cpu_milli=16_000,
                  node_mem_mib=32_768)
    snap = generate_snapshot(**kwargs)
    js = jax_generate_snapshot(**kwargs)
    got = run_packed_cuda(snap, gang_rounds=1, device="cpu", discard_unstable=True)
    np.testing.assert_array_equal(
        np.asarray(jax_run_packed(js, gang_rounds=1, discard_unstable=True)), got)
    bounded = run_packed_cuda(snap, gang_rounds=1, device="cpu")
    np.testing.assert_array_equal(np.asarray(jax_run_packed(js, gang_rounds=1)), bounded)
    assert (bounded != got).any()


def test_layouts_by_size():
    """The shared-memory layout where R <= MAX_LANES and the node state
    fits one block; else the wide instance, its plane in shared memory
    where it fits beside the task rows; a lane count whose rows alone do
    not fit is refused."""
    assert session_kernel.shared_layout(2, 10_240)
    assert session_kernel.shared_layout(8, 4_096)
    assert not session_kernel.shared_layout(2, 20_096)  # the 20k-node cell
    assert not session_kernel.shared_layout(5, 10_112)  # 10k nodes, 5 lanes
    assert not session_kernel.shared_layout(9, 128)
    assert session_kernel.plan_wide(2, 20_000)
    assert session_kernel.plan_wide(9, 50_000)
    assert not session_kernel.plan_wide(2, 60_000)
    with pytest.raises(ValueError, match="shared memory"):
        session_kernel.plan_wide(20_000, 0)
