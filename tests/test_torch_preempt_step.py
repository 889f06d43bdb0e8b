"""The preempt kernel's control logic, run on this machine, and the
victim lists its wrapper derives.

``volcano_tpu_torch/csrc/preempt_step.cuh`` holds the control logic of
the preempt pass over queue-compacted slot lists (the schedule walk, the
key of the repeated-attempt fast path, one thread's share of a full or a
fast sweep, the drain with its dirty set, the rollback) as
``__host__ __device__`` functions.  Here g++ compiles it (no FMA
contraction, IEEE division) with a host loop that plays the kernel's
block: every thread's share in turn, each thread's best kept between
attempts, only the dirty positions' owners rescoring on a fast attempt,
then the block argmax over (value, list position) and the drain.  Its
``evicted`` and ``pipelined`` are held bit for bit (tolerance 0: every
value is an integer-valued f32) against the plain version
``preempt_pass_reference`` and ``run_preempt_pallas(..., interpret=True)``,
with the plane on and off, and its fast attempts against the count the
host makes from the plain pass's fired attempts and rollbacks."""

from __future__ import annotations

import ctypes
import functools
import shutil
import subprocess

import numpy as np
import pytest
import torch

from volcano_tpu.ops.preempt_pack import preempt_dense as jax_preempt_dense
from volcano_tpu.ops.preempt_pallas import run_preempt_pallas
from volcano_tpu_torch.ops import preempt_kernel
from volcano_tpu_torch.ops.kernels import DEFAULT_WEIGHTS
from volcano_tpu_torch.ops.preempt_kernel import (
    _STATIC_SMEM,
    fast_attempts,
    KERNEL_STATS,
    OPERANDS,
    plan_plane,
    prepare_preempt_arrays,
    preempt_pass_cuda,
    preempt_pass_reference,
    ship_arrays,
    STATS,
    victim_lists,
)
from volcano_tpu_torch.ops.session_kernel import SMEM_LIMIT
from volcano_tpu_torch.ops.synthetic import generate_preempt_packed

import chip_smoke
from tests.test_torch_kernels import one_torch_thread  # noqa: F401
from tests.test_torch_math import CSRC
from tests.test_torch_preempt import GENERATED, to_jax

#: the victim lists the kernel takes beside the operands
LISTS = ("qoff", "qnode", "qslot", "jlo", "jlist")

SHIM = r"""
#include <math.h>
#include <algorithm>
#include <vector>

#include "preempt_step.cuh"

template <int R>
static void pass(const vt::PreemptIn& in, int threads, int plane_on, int* evicted,
                 int* pipelined, int* stats) {
  const int NK = in.NK, K = in.K, J = in.J, P = in.P, SC = in.SC, KQ = in.KQ;
  std::vector<float> fi(in.nd + 2 * R * NK, in.nd + 3 * R * NK);
  std::vector<float> ncnt(in.nd + 3 * R * NK, in.nd + (3 * R + 1) * NK);
  std::vector<float> ready(in.jobf, in.jobf + J), wait(in.jobf + J, in.jobf + 2 * J);
  std::vector<int> cursor(in.jobi, in.jobi + J);
  std::vector<float> spre(std::max(SC, 1) * NK);
  for (int c = 0; c < SC; ++c)
    for (int n = 0; n < NK; ++n)
      spre[c * NK + n] = vt::node_score(R, in.screq + c * R, in.nd + R * NK + n, in.nd + n, NK,
                                        in.w);
  const int KL = std::max(KQ * in.LQ, 1);
  std::vector<int> lvj(KL), lprio(KL), lqueue(KL), jnode(std::max(P, 1));
  std::vector<int> jevict(std::max(P * K, 1)), jpipe(std::max(P, 1)), dirty(2 * KQ);
  std::vector<float> lmin(KL), lvr(R * KL), jvals(std::max(P, 1) * (R + 1));
  for (int i = 0; i < K * NK; ++i) evicted[i] = 0;
  for (int i = 0; i < P; ++i) pipelined[i] = -1;
  for (int i = 0; i < 5; ++i) stats[i] = 0;
  const vt::PreemptState st{fi.data(),    ncnt.data(),  ready.data(),  wait.data(),
                            cursor.data(), spre.data(), lvj.data(),    lprio.data(),
                            lqueue.data(), lmin.data(), lvr.data(),    jnode.data(),
                            jvals.data(),  jevict.data(), jpipe.data(), dirty.data(),
                            evicted,       pipelined,   stats};
  for (int i = 0; i < KQ * in.LQ; ++i) vt::list_planes<R>(in, st, i);
  int longest = 0;
  for (int q = 0; q < in.Q; ++q) longest = std::max(longest, in.qoff[q + 1] - in.qoff[q]);
  std::vector<float> plane(std::max(longest, 1));
  float* pl = plane_on ? plane.data() : nullptr;
  std::vector<float> tv(threads, -INFINITY);  // each thread's best, kept between attempts
  std::vector<int> ti(threads, vt::kNoPos);
  vt::Journal jr;
  vt::PlaneKey key;
  vt::Dirty d = vt::clean();
  vt::Walk w;
  vt::load_slot(in, w);
  float row[R + 2];
  for (;;) {
    int j = 0;
    const int p = vt::walk<R>(in, st, jr, key, w, j);
    if (p < 0) break;
    for (int r = 0; r < R + 2; ++r) row[r] = in.ptask[p * (R + 2) + r];
    const vt::Attempt a = vt::attempt_of<R>(in, p, j, row);
    const bool fast = pl != nullptr && SC > 0 && vt::same_key(key, a);
    key = vt::key_of(a);
    stats[0] += 1;
    if (fast) stats[4] += 1;
    for (int th = 0; th < threads; ++th) {
      if (fast) {
        vt::sweep_dirty<R>(in, st, a, row, in.tol, th, threads, pl, d, tv[th], ti[th]);
      } else {
        vt::sweep_full<R>(in, st, a, row, in.tol, th, threads, pl, tv[th], ti[th]);
      }
    }
    float bv = -INFINITY;
    int bi = vt::kNoPos;
    for (int th = 0; th < threads; ++th) {
      if (tv[th] > bv || (tv[th] == bv && ti[th] < bi)) {
        bv = tv[th];
        bi = ti[th];
      }
    }
    d = vt::clean();
    if (bv > -INFINITY) {
      stats[1] += 1;
      vt::drain_and_pipeline<R>(in, st, jr, a, row, in.tol, a.start + bi, pl, d);
    }
  }
}

extern "C" void preempt_pass_host(
    int R, const int* sched, int S, const float* ptask, int P, const float* screq, int SC,
    const unsigned char* cf, int C, const float* nd, const float* vr, const int* vjob, int K,
    const int* jobi, const float* jobf, int J, const float* tol, int NK, const int* qoff, int Q,
    const int* qnode, int LQ, const int* qslot, int KQ, const int* jlo, const int* jlist,
    const float* w6, int threads, int plane_on, int* evicted, int* pipelined, int* stats) {
  const vt::PreemptIn in{sched, S,     ptask, P,    screq, SC,    cf,
                         C,     nd,    vr,    vjob, K,     jobi,  jobf,
                         J,     tol,   NK,    qoff, Q,     qnode, LQ,
                         qslot, KQ,    jlo,   jlist,
                         vt::Weights{w6[0], w6[1], w6[2], w6[3], w6[4], w6[5]}};
  if (R == 2) {
    pass<2>(in, threads, plane_on, evicted, pipelined, stats);
  } else {
    pass<3>(in, threads, plane_on, evicted, pipelined, stats);
  }
}
"""


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available")
    d = tmp_path_factory.mktemp("preempt_step")
    src, lib = d / "shim.cpp", d / "libshim.so"
    src.write_text(SHIM)
    subprocess.run(
        [gxx, "-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC", "-I", CSRC,
         str(src), "-o", str(lib)],
        check=True, capture_output=True,
    )
    so = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    so.preempt_pass_host.argtypes = [
        i, p, i, p, i, p, i, p, i, p, p, p, i, p, p, i, p, i,  # R .. NK
        p, i, p, i, p, i, p, p,  # qoff, Q, qnode, LQ, qslot, KQ, jlo, jlist
        p, i, i, p, p, p,  # w6, threads, plane_on, evicted, pipelined, stats
    ]
    so.preempt_pass_host.restype = None
    return so


def _ptr(a: np.ndarray) -> int:
    assert a.flags["C_CONTIGUOUS"]
    return a.ctypes.data


def lists_of(arrays: dict) -> dict:
    """The wrapper's victim lists of one pass's operands, as numpy."""
    lists = victim_lists(torch.from_numpy(arrays["vjob"]), torch.from_numpy(arrays["jobi"][1]))
    return {k: lists[k].numpy() for k in LISTS}


def host_pass(shim, arrays: dict, plane: bool, threads: int = 1024, weights=DEFAULT_WEIGHTS):
    """(evicted [K, NK], pipelined [P], KERNEL_STATS counts) of the host loop
    over one pass's operands and their victim lists, with the plane over the
    longest queue list or without it."""
    a = {k: np.ascontiguousarray(arrays[k]) for k in OPERANDS}
    a.update(lists_of(arrays))
    P, RC = a["ptask"].shape
    K, NK = a["vjob"].shape
    J = a["jobi"].shape[1]
    w6 = np.array(weights[:6], dtype=np.float32)
    evicted = np.empty((K, NK), dtype=np.int32)
    pipelined = np.empty(max(P, 1), dtype=np.int32)
    stats = np.zeros(len(KERNEL_STATS), dtype=np.int32)

    def nonempty(x):  # a pointer to at least one element
        return x if x.size else np.zeros(1, dtype=x.dtype)

    shim.preempt_pass_host(
        RC - 2, _ptr(a["sched"]), a["sched"].shape[0], _ptr(a["ptask"]), P, _ptr(nonempty(a["screq"])),
        a["screq"].shape[0], _ptr(a["cf"]), a["cf"].shape[0], _ptr(a["nd"]), _ptr(a["vr"]),
        _ptr(a["vjob"]), K, _ptr(a["jobi"]), _ptr(a["jobf"]), J, _ptr(a["tol"]), NK,
        _ptr(a["qoff"]), a["qoff"].shape[0] - 1, _ptr(nonempty(a["qnode"])), a["qnode"].shape[0],
        _ptr(nonempty(a["qslot"])), a["qslot"].shape[0], _ptr(a["jlo"]),
        _ptr(nonempty(a["jlist"])), _ptr(w6), threads, int(plane), _ptr(evicted),
        _ptr(pipelined), _ptr(stats),
    )
    return evicted, pipelined[:P], stats.tolist()


def _edited(name: str):
    _, case, edit = next(e for e in chip_smoke.PREEMPT_EDITS if e[0] == name)
    pk = generate_preempt_packed(**case)
    edit(pk)
    return pk


#: every chip_smoke.py preempt session: generated, then edited
SESSIONS = {f"generated-{i}": (lambda i=i: generate_preempt_packed(**case))
            for i, case in enumerate(chip_smoke.PREEMPT_CASES)}
SESSIONS.update({name: functools.partial(_edited, name) for name, _, _ in chip_smoke.PREEMPT_EDITS})


@functools.lru_cache(maxsize=None)
def _session(name: str):
    """(PreemptPacked, arrays, plain evicted, plain pipelined, plain counts,
    fast attempts counted on the host)."""
    pk = SESSIONS[name]()
    arrays, dims, _ = prepare_preempt_arrays(pk)
    inputs = ship_arrays(arrays, torch.device("cpu"))
    stats = torch.zeros(len(STATS), dtype=torch.int32)
    events = []
    ev, pipe = preempt_pass_reference(*inputs, stats=stats, events=events)
    fast = sum(fast_attempts(events, inputs[1], inputs[7], inputs[6], dims["SC"]))
    return pk, arrays, ev.numpy(), pipe.numpy(), stats.tolist(), fast


def _check(shim, name: str, plane: bool, threads: int = 1024):
    """Host loop == plain version, counts and all; its fast attempts are the
    host's count with the plane, none without."""
    _, arrays, ev, pipe, counts, fast = _session(name)
    got_ev, got_pipe, stats = host_pass(shim, arrays, plane, threads)
    assert np.array_equal(got_ev, ev) and np.array_equal(got_pipe, pipe)
    assert stats == counts + [fast if plane else 0]
    return stats


# ---- the host loop against the plain version and the Pallas kernel ----

@pytest.mark.parametrize("threads", [1024, 7])
@pytest.mark.parametrize("plane", [True, False], ids=["plane", "no-plane"])
@pytest.mark.parametrize("name", list(SESSIONS), ids=list(SESSIONS))
def test_host_loop_matches_plain_version(shim, name, plane, threads):
    stats = _check(shim, name, plane, threads)
    if name == "equal-priority":
        assert stats[1] == 0
    else:
        assert stats[1] > 0 and stats[2] > 0


@functools.lru_cache(maxsize=None)
def _pallas(name: str):
    return run_preempt_pallas(to_jax(SESSIONS[name]()), interpret=True)


#: sessions held against the Pallas kernel too: victim jobs are never
#: preemptors in them (the Pallas kernel's drain relies on it)
PALLAS_SESSIONS = ["generated-0", "generated-1", "sensitive-gang", "rollback",
                   "feasibility-classes", "mixed-priority"]


@pytest.mark.parametrize("plane", [True, False], ids=["plane", "no-plane"])
@pytest.mark.parametrize("name", PALLAS_SESSIONS)
def test_host_loop_matches_pallas(shim, name, plane):
    pk, arrays, _, _, _, _ = _session(name)
    ev, pipe, _ = host_pass(shim, arrays, plane)
    vic_slot = prepare_preempt_arrays(pk)[2]
    V = pk.n_victims
    want_ev, want_pipe = _pallas(name)
    assert np.array_equal(want_ev, ev[vic_slot[:V], pk.vic_node[:V]] > 0)
    assert np.array_equal(want_pipe, pipe)


@pytest.mark.parametrize("name", ["owns-victims", "mixed-priority"])
def test_new_edits_match_spec(name):
    """The two sessions added for the wide key: the plain pass ≡ the JAX
    package's preempt_dense, and each reaches what it was made for."""
    pk, arrays, ev, pipe, counts, fast = _session(name)
    want_ev, want_pipe = jax_preempt_dense(to_jax(pk))
    vic_slot = prepare_preempt_arrays(pk)[2]
    V = pk.n_victims
    assert np.array_equal(want_ev, ev[vic_slot[:V], pk.vic_node[:V]] > 0)
    assert np.array_equal(want_pipe, pipe)
    jlo = lists_of(arrays)["jlo"]
    pjobs = np.flatnonzero(pk.job_ptask_end > pk.job_ptask_start)
    owners = pjobs[jlo[pjobs + 1] > jlo[pjobs]]
    # the wide key would make every attempt but each queue's first fast
    assert fast < counts[0] - len(set(pk.job_queue[pjobs].tolist()))
    if name == "owns-victims":
        assert len(owners) > 0
    else:
        assert len(owners) == 0 and len(set(pk.job_prio[pjobs].tolist())) > 1


def test_fast_attempts_at_full_size_structure(shim):
    """A small session of the full-size config's structure (9 victims a
    node; victim jobs of 8 round robin, with nodes / 8 = 2 mod 4 as at
    10,000 nodes, so each node holds 5 victims of one queue and 4 of
    another; gangs of 8 with min_available 5, 4 queues, one request row, no
    selectors): each job fires 5 attempts, all pick, none rolls back, and
    with the wide key only each queue's first attempt is full."""
    pk = generate_preempt_packed(n_victims=2_160, n_nodes=240, n_preemptors=2_000, seed=9)
    arrays, dims, _ = prepare_preempt_arrays(pk)
    inputs = ship_arrays(arrays, torch.device("cpu"))
    stats = torch.zeros(len(STATS), dtype=torch.int32)
    events = []
    ev, pipe = preempt_pass_reference(*inputs, stats=stats, events=events)
    n_jobs = 2_000 // 8
    fired, picks, _, rollbacks = stats.tolist()
    assert (fired, picks, rollbacks) == (5 * n_jobs, 5 * n_jobs, 0)
    lists = lists_of(arrays)
    assert (dims["SC"], dims["C"]) == (1, 1)
    assert (lists["qoff"].shape[0] - 1, lists["qslot"].shape, lists["qnode"].shape[0]) == (
        4, (5, 480), 480)
    fast = sum(fast_attempts(events, inputs[1], inputs[7], inputs[6], dims["SC"]))
    assert fast == fired - 4
    got_ev, got_pipe, got = host_pass(shim, arrays, plane=True)
    assert np.array_equal(got_ev, ev.numpy()) and np.array_equal(got_pipe, pipe.numpy())
    assert got == stats.tolist() + [fast]


# ---- the victim lists ----

def direct_lists(vjob: np.ndarray, job_queue: np.ndarray) -> dict:
    """victim_lists built node by node, slot by slot."""
    K, NK = vjob.shape
    J = job_queue.shape[0]
    occupied = [(k, n) for n in range(NK) for k in range(K) if vjob[k, n] >= 0]
    Q = max((int(job_queue[vjob[k, n]]) for k, n in occupied), default=-1) + 1
    qnode, columns, qoff = [], [], [0]
    where = {}
    for q in range(Q):
        for n in range(NK):
            ks = [k for k in range(K) if vjob[k, n] >= 0 and job_queue[vjob[k, n]] == q]
            if ks:
                where[(q, n)] = len(qnode)
                qnode.append(n)
                columns.append(ks)
        qoff.append(len(qnode))
    KQ = max((len(c) for c in columns), default=1)
    qslot = np.full((KQ, len(qnode)), -1, dtype=np.int32)
    for g, ks in enumerate(columns):
        qslot[: len(ks), g] = ks
    jlist, jlo = [], [0]
    for j in range(J):
        nodes = sorted({n for k, n in occupied if vjob[k, n] == j})
        jlist += [where[(int(job_queue[j]), n)] for n in nodes]
        jlo.append(len(jlist))
    return dict(qoff=np.array(qoff, dtype=np.int32), qnode=np.array(qnode, dtype=np.int32),
                qslot=qslot, jlo=np.array(jlo, dtype=np.int32),
                jlist=np.array(jlist, dtype=np.int32))


@pytest.mark.parametrize("name", [*GENERATED, "sensitive-gang", "owns-victims",
                                  "feasibility-classes", "rollback"])
def test_victim_lists_match_direct_construction(name):
    """The wrapper's lists, on CPU tensors, against a direct construction;
    the per-job owns-victims flag the kernel reads from jlo against vjob."""
    pk = generate_preempt_packed(**GENERATED[name]) if name in GENERATED else _edited(name)
    arrays, _, _ = prepare_preempt_arrays(pk)
    vjob, job_queue = arrays["vjob"], arrays["jobi"][1]
    got = victim_lists(torch.from_numpy(vjob), torch.from_numpy(job_queue))
    want = direct_lists(vjob, job_queue)
    for key, w in want.items():
        g = got[key]
        assert g.dtype == torch.int32 and tuple(g.shape) == w.shape, key
        assert np.array_equal(g.numpy(), w), key
    assert got["longest"] == int(np.diff(want["qoff"]).max())
    owns = np.zeros(job_queue.shape[0], dtype=bool)
    owns[np.unique(vjob[vjob >= 0])] = True
    assert np.array_equal(np.diff(want["jlo"]) > 0, owns)


def test_victim_lists_of_an_empty_cluster_and_a_negative_queue():
    vjob = torch.full((1, 128), -1, dtype=torch.int32)
    lists = victim_lists(vjob, torch.zeros(3, dtype=torch.int32))
    assert lists["qoff"].tolist() == [0] and lists["qnode"].numel() == 0
    assert tuple(lists["qslot"].shape) == (1, 0) and lists["jlo"].tolist() == [0, 0, 0, 0]
    assert lists["longest"] == 0 and plan_plane(lists["longest"]) == 0
    vjob[0, 5] = 1
    with pytest.raises(ValueError, match="negative queue"):
        victim_lists(vjob, torch.tensor([0, -1, 0], dtype=torch.int32))


def test_wrapper_refuses_kernel_stats_on_cpu():
    """The fast count is the kernel's: a CPU pass runs the plain version and
    has none to give."""
    inputs = ship_arrays(_session("generated-0")[1], torch.device("cpu"))
    before = preempt_kernel.LAUNCHES
    with pytest.raises(ValueError, match="stats"):
        preempt_pass_cuda(*inputs, stats=torch.zeros(len(KERNEL_STATS), dtype=torch.int32))
    assert preempt_kernel.LAUNCHES == before


# ---- shared-memory planning ----

def test_plane_planner():
    """The plane is on where it fits beside the static state, whatever the
    node count: the full-size lists (5,000 positions) keep it; every
    session the first kernel ran still runs, with it or without."""
    assert plan_plane(5_000) == 5_000
    assert plan_plane(0) == 0
    top = (SMEM_LIMIT - _STATIC_SMEM) // 4
    assert plan_plane(top) == top
    assert plan_plane(top + 1) == 0
    assert plan_plane(10**6) == 0
