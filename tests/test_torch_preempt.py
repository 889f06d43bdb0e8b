"""The port's preempt pass (volcano_tpu_torch/ops/preempt_pack.py,
preempt_kernel.py, dispatch.py, executor.py) against the JAX package on
the CPU.

Tolerance 0: inside the f32 envelope every value is an integer-valued
f32 and the ops run in the reference's order, so ``evicted`` and
``pipelined`` are compared with ``np.array_equal``.  Sessions are made
once — by the generators from a seed, or by the JAX package's packer
from the host-built caches of tests/test_preempt_kernel.py — and carried
across to the port with ``preempt_packed_from_arrays``.  On CPU tensors
the kernel wrapper runs its plain version; the CUDA kernel itself is
held against that plain version on the card by chip_smoke.py."""

from __future__ import annotations

import ctypes
import dataclasses
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from volcano_tpu.framework.framework import close_session, open_session
from volcano_tpu.ops import dispatch as jax_dispatch
from volcano_tpu.ops.packing import PackedSnapshot as JaxPackedSnapshot
from volcano_tpu.ops.preempt_pack import pack_preempt_session
from volcano_tpu.ops.preempt_pack import preempt_dense as jax_preempt_dense
from volcano_tpu.ops.preempt_pack import PreemptPacked as JaxPreemptPacked
from volcano_tpu.ops.preempt_pallas import build_schedule_slots as jax_build_schedule_slots
from volcano_tpu.ops.preempt_pallas import prepare_preempt_arrays as jax_prepare_preempt_arrays
from volcano_tpu.ops.preempt_pallas import run_preempt_pallas
from volcano_tpu.ops.synthetic import generate_preempt_packed as jax_generate_preempt_packed
from volcano_tpu_torch.ops import preempt_kernel
from volcano_tpu_torch.ops.dispatch import preempt_f32_exact, select_preempt_executor
from volcano_tpu_torch.ops.executor import execute_preempt, last_preempt_executor
from volcano_tpu_torch.ops.packing import _SNAPSHOT_ARRAYS, _SNAPSHOT_META
from volcano_tpu_torch.ops.preempt_kernel import (
    build_schedule_slots,
    eligible_slots,
    prepare_preempt_arrays,
    preempt_pass_cuda,
    preempt_pass_reference,
    run_preempt_cuda,
    ship_arrays,
    validation_plane,
)
from volcano_tpu_torch.ops.preempt_pack import (
    _fit,
    preempt_dense,
    preempt_packed_from_arrays,
    PreemptPacked,
)
from volcano_tpu_torch.ops.synthetic import generate_preempt_packed

import chip_smoke
from tests.builders import (
    build_node,
    build_pod,
    build_pod_group,
    build_priority_class,
    build_queue,
)
from tests.scheduler_helpers import make_cache
from tests.test_preempt_kernel import (
    _case_drf_imbalance,
    _case_saturated,
    DRF_TIERS,
    FULL_TIERS,
)
from tests.test_torch_kernels import one_torch_thread  # noqa: F401
from tests.test_torch_math import CSRC

#: generated sessions: generator arguments (uneven K, two queue counts,
#: a gang size that does not divide the preemptors)
GENERATED = {
    "small": dict(n_victims=300, n_nodes=64, n_preemptors=64),
    "uneven-k": dict(n_victims=905, n_nodes=100, n_preemptors=120, seed=3),
    "two-queues": dict(n_victims=2_503, n_nodes=300, n_preemptors=402, gang_size=4,
                       n_queues=2, seed=5),
    "tight-nodes": dict(n_victims=700, n_nodes=120, n_preemptors=150, seed=8,
                        node_cpu_milli=32_000, node_mem_mib=131_072),
}


# ---- carrying sessions across ----

def to_port(jpk: JaxPreemptPacked) -> PreemptPacked:
    """The JAX package's PreemptPacked as the port's, field for field."""
    base = jpk.base
    arrays = {k: getattr(base, k) for k in _SNAPSHOT_ARRAYS if getattr(base, k) is not None}
    meta = {k: getattr(base, k) for k in _SNAPSHOT_META}
    rest = {f.name: getattr(jpk, f.name) for f in dataclasses.fields(jpk) if f.name != "base"}
    return preempt_packed_from_arrays(arrays, meta, **rest)


def to_jax(pk: PreemptPacked) -> JaxPreemptPacked:
    """The port's PreemptPacked as the JAX package's, field for field."""
    base = JaxPackedSnapshot()
    for name in (*_SNAPSHOT_ARRAYS, *_SNAPSHOT_META):
        setattr(base, name, getattr(pk.base, name))
    rest = {f.name: getattr(pk, f.name) for f in dataclasses.fields(pk) if f.name != "base"}
    return JaxPreemptPacked(base=base, **rest)


def packed(cache, tier_conf=FULL_TIERS) -> JaxPreemptPacked:
    """The JAX package's packing of a host-built session."""
    ssn = open_session(cache, tier_conf, [])
    try:
        return pack_preempt_session(ssn)
    finally:
        close_session(ssn)


def _one_queue(pods, groups, nodes, queues=("q1",)):
    return make_cache(
        nodes=nodes, pods=pods, pod_groups=groups,
        queues=[build_queue(q, weight=1) for q in queues],
        priority_classes=[build_priority_class("high", 100)],
    )


def _case_two_queues():
    """In-queue only: victims in another queue are untouchable."""
    return _one_queue(
        [build_pod("ns", "r1", "n000", {"cpu": "2", "memory": "2G"}, phase="Running",
                   group="pg1", priority=0),
         build_pod("ns", "h1", "", {"cpu": "1", "memory": "1G"}, group="pg2", priority=100)],
        [build_pod_group("ns", "pg1", 1, queue="q1"),
         build_pod_group("ns", "pg2", 1, queue="q2", priority_class_name="high")],
        [build_node("n000", {"cpu": "2", "memory": "2G"})], queues=("q1", "q2"),
    )


def _case_mixed_priorities():
    """The chosen node's lowest-priority victim goes first."""
    pods = [build_pod("ns", name, "n000", {"cpu": "1", "memory": "1G"}, phase="Running",
                      group="pg1", priority=prio)
            for name, prio in (("lo", 0), ("mid", 10), ("mid2", 10))]
    pods.append(build_pod("ns", "h1", "", {"cpu": "1", "memory": "1G"}, group="pg2",
                          priority=100))
    return _one_queue(
        pods,
        [build_pod_group("ns", "pg1", 1, queue="q1"),
         build_pod_group("ns", "pg2", 1, queue="q1", priority_class_name="high")],
        [build_node("n000", {"cpu": "3", "memory": "3G"})],
    )


def _case_equal_priority_tie():
    """Equal-priority victims: the youngest goes first."""
    pods = [build_pod("ns", name, "n000", {"cpu": "1", "memory": "1G"}, phase="Running",
                      group="pg1", priority=0) for name in ("va", "vb")]
    pods.append(build_pod("ns", "h1", "", {"cpu": "1", "memory": "1G"}, group="pg2",
                          priority=100))
    return _one_queue(
        pods,
        [build_pod_group("ns", "pg1", 1, queue="q1"),
         build_pod_group("ns", "pg2", 1, queue="q1", priority_class_name="high")],
        [build_node("n000", {"cpu": "2", "memory": "2G"})],
    )


def _case_pod_count_limit():
    """A node at its pod-count limit is rejected even where resources fit."""
    node = build_node("n000", {"cpu": "4", "memory": "4G"})
    node.status.allocatable["pods"] = "1"
    node.status.capacity["pods"] = "1"
    return _one_queue(
        [build_pod("ns", "v1", "n000", {"cpu": "1", "memory": "1G"}, phase="Running",
                   group="pg1", priority=0),
         build_pod("ns", "h1", "", {"cpu": "1", "memory": "1G"}, group="pg2", priority=100)],
        [build_pod_group("ns", "pg1", 1, queue="q1"),
         build_pod_group("ns", "pg2", 1, queue="q1", priority_class_name="high")],
        [node],
    )


def _case_sensitive_gang():
    """A victim job with 1 < minAvailable < running count: two victims go,
    then the gang floor protects the other two mid-pass."""
    pods = [build_pod("ns", f"vic-r{i}", f"n{i:03d}", {"cpu": "3", "memory": "3G"},
                      phase="Running", group="vic", priority=0) for i in range(4)]
    pods += [build_pod("ns", f"pre-{i}", "", {"cpu": "2", "memory": "2G"}, group="pre",
                       priority=100) for i in range(4)]
    return _one_queue(
        pods,
        [build_pod_group("ns", "vic", 2, queue="q1"),
         build_pod_group("ns", "pre", 2, queue="q1", priority_class_name="high")],
        [build_node(f"n{i:03d}", {"cpu": "4", "memory": "8G"}) for i in range(4)],
    )


#: host-built sessions of tests/test_preempt_kernel.py
HOST_CASES = {
    "saturated-0": lambda: _case_saturated(seed=0),
    "saturated-1": lambda: _case_saturated(seed=1),
    "saturated-2": lambda: _case_saturated(seed=2),
    "two-queues": _case_two_queues,
    "mixed-priorities": _case_mixed_priorities,
    "equal-priority-tie": _case_equal_priority_tie,
    "pod-count-limit": _case_pod_count_limit,
    "sensitive-gang": _case_sensitive_gang,
}


def _case_drf_critical():
    """A critical victim the DRF subtraction still counts."""
    pods = [build_pod("ns", "fat-a-crit", "n000", {"cpu": "4", "memory": "4G"},
                      phase="Running", group="fat", priority=0, labels={})]
    pods[-1].metadata.annotations["scheduler.alpha.kubernetes.io/critical-pod"] = ""
    pods.append(build_pod("ns", "fat-b", "n000", {"cpu": "4", "memory": "4G"},
                          phase="Running", group="fat", priority=0))
    pods.append(build_pod("ns", "skin-0", "", {"cpu": "2", "memory": "2G"}, group="skinny",
                          priority=0))
    return make_cache(
        nodes=[build_node("n000", {"cpu": "8", "memory": "16G"})], pods=pods,
        pod_groups=[build_pod_group("ns", "fat", 1, queue="q1"),
                    build_pod_group("ns", "skinny", 1, queue="q1")],
        queues=[build_queue("q1", weight=1)],
    )


DRF_CASES = {
    "drf-imbalance": (lambda: _case_drf_imbalance(), DRF_TIERS),
    "drf-critical-victim": (_case_drf_critical, DRF_TIERS),
}


def assert_same(want, got):
    (ev_w, pipe_w), (ev_g, pipe_g) = want, got
    assert np.asarray(ev_g).dtype == np.bool_ and np.asarray(pipe_g).dtype == np.int32
    assert np.array_equal(ev_w, ev_g)
    assert np.array_equal(pipe_w, pipe_g)


# ---- generator and packing ----

@pytest.mark.parametrize("case", list(GENERATED), ids=list(GENERATED))
def test_generate_preempt_packed_is_byte_identical(case):
    want = jax_generate_preempt_packed(**GENERATED[case])
    got = generate_preempt_packed(**GENERATED[case])
    for name in (*_SNAPSHOT_ARRAYS, *_SNAPSHOT_META):
        w, g = getattr(want.base, name), getattr(got.base, name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), name
        else:
            assert g == w, name
    for f in dataclasses.fields(want):
        if f.name == "base":
            continue
        w, g = getattr(want, f.name), getattr(got, f.name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes(), f.name
        else:
            assert g == w, f.name


@pytest.mark.parametrize("case", [*GENERATED, *HOST_CASES])
def test_build_schedule_slots_matches_reference(case):
    if case in GENERATED:
        jpk = jax_generate_preempt_packed(**GENERATED[case])
    else:
        jpk = packed(HOST_CASES[case]())
    want = jax_build_schedule_slots(jpk)
    got = build_schedule_slots(to_port(jpk))
    assert got.dtype == want.dtype and np.array_equal(want, got)


@pytest.mark.parametrize("case", list(GENERATED), ids=list(GENERATED))
def test_prepare_preempt_arrays_match_pallas_layout(case):
    """The kernel's operands are the Pallas planes' bytes with nodes flat
    ([rows, NK] for [rows, NS, 128]), and the same victim slots."""
    jpk = jax_generate_preempt_packed(**GENERATED[case])
    want, wdims, want_slot = jax_prepare_preempt_arrays(jpk)
    got, dims, got_slot = prepare_preempt_arrays(to_port(jpk))
    R, K, NK, C = dims["R"], dims["K"], dims["NK"], dims["C"]
    assert (K, NK, C) == (wdims["K"], wdims["NS"] * 128, wdims["C"])
    assert np.array_equal(want_slot, got_slot)
    fstack = want["fstack"].reshape(-1, NK)
    assert got["cf"].astype(np.float32).tobytes() == fstack[:C].tobytes()
    assert got["nd"][: 3 * R].tobytes() == fstack[C : C + 3 * R].tobytes()  # used|alloc|fi0
    assert got["nd"][3 * R :].tobytes() == fstack[C + 3 * R : C + 3 * R + 2].tobytes()
    assert got["vr"].tobytes() == fstack[C + 3 * R + 2 :].tobytes()
    assert got["vjob"].tobytes() == want["istack"].reshape(K, NK).tobytes()
    P = jpk.base.n_tasks
    assert got["ptask"].tobytes() == want["ptask"][:P].tobytes()
    assert got["sched"].tobytes() == jax_build_schedule_slots(jpk).tobytes()


# ---- the specification and the plain pass against the reference ----

@pytest.mark.parametrize("case", list(GENERATED), ids=list(GENERATED))
def test_preempt_dense_matches_reference_on_generated(case):
    jpk = jax_generate_preempt_packed(**GENERATED[case])
    want = jax_preempt_dense(jpk)
    got = preempt_dense(generate_preempt_packed(**GENERATED[case]), device="cpu")
    assert_same(want, got)
    assert want[0].any() and (want[1] >= 0).any()  # the session really preempts


@pytest.mark.parametrize("case", list(HOST_CASES), ids=list(HOST_CASES))
def test_dense_and_plain_pass_match_reference_on_host_sessions(case):
    """The port's preempt_dense ≡ the JAX preempt_dense, and the plain
    pass ≡ run_preempt_pallas (interpret mode), on sessions the JAX
    package packed from a host-built cache."""
    jpk = packed(HOST_CASES[case]())
    pk = to_port(jpk)
    want = jax_preempt_dense(jpk)
    assert_same(want, preempt_dense(pk, device="cpu"))
    assert_same(run_preempt_pallas(jpk, interpret=True), run_preempt_cuda(pk, device="cpu"))
    assert_same(want, run_preempt_cuda(pk, device="cpu"))
    if case == "sensitive-gang":
        assert want[0].sum() == 2  # the gang floor protects the other two


def test_plain_pass_matches_pallas_on_generated():
    jpk = jax_generate_preempt_packed(**GENERATED["small"])
    want = run_preempt_pallas(jpk, interpret=True)
    got = run_preempt_cuda(generate_preempt_packed(**GENERATED["small"]), device="cpu")
    assert_same(want, got)
    assert want[0].any()


@pytest.mark.parametrize("case", list(GENERATED)[1:], ids=list(GENERATED)[1:])
def test_plain_pass_matches_spec_on_generated(case):
    pk = generate_preempt_packed(**GENERATED[case])
    assert_same(jax_preempt_dense(jax_generate_preempt_packed(**GENERATED[case])),
                run_preempt_cuda(pk, device="cpu"))


@pytest.mark.parametrize("name", [name for name, _, _ in chip_smoke.PREEMPT_EDITS])
def test_plain_pass_matches_spec_on_edited_sessions(name):
    """The sessions chip_smoke.py edits to reach each branch of the
    kernel: the plain pass ≡ the port's preempt_dense ≡ the JAX one."""
    _, case, edit = next(e for e in chip_smoke.PREEMPT_EDITS if e[0] == name)
    pk = generate_preempt_packed(**case)
    edit(pk)
    want = jax_preempt_dense(to_jax(pk))
    assert_same(want, preempt_dense(pk, device="cpu"))
    stats = torch.zeros(4, dtype=torch.int32)
    inputs = ship_arrays(prepare_preempt_arrays(pk)[0], torch.device("cpu"))
    preempt_pass_reference(*inputs, stats=stats)
    fired, picks, evictions, rollbacks = stats.tolist()
    assert_same(want, run_preempt_cuda(pk, device="cpu"))
    if name == "equal-priority":
        assert picks == 0 and not want[0].any()
    elif name == "rollback":
        assert rollbacks > 0 and evictions > int(want[0].sum())
    else:
        assert picks > 0 and want[0].any()


@pytest.mark.parametrize("case", list(DRF_CASES), ids=list(DRF_CASES))
def test_drf_sessions_run_dense(case):
    build, tier_conf = DRF_CASES[case]
    jpk = packed(build(), tier_conf)
    pk = to_port(jpk)
    assert pk.use_drf
    assert_same(jax_preempt_dense(jpk), preempt_dense(pk, device="cpu"))
    assert select_preempt_executor(pk, device="cuda") == "dense"
    assert_same(jax_preempt_dense(jpk), execute_preempt(pk, device="cpu"))
    assert last_preempt_executor() == "dense"


# ---- dispatch and entry point ----

def test_preempt_f32_exact_matches_reference():
    """The gate covers the base planes, the victims' requests and
    future-idle, as the JAX gate does (tests/test_preempt_kernel.py)."""
    kwargs = dict(n_victims=100, n_nodes=10, n_preemptors=10)
    jpk, pk = jax_generate_preempt_packed(**kwargs), generate_preempt_packed(**kwargs)
    assert preempt_f32_exact(pk) and jax_dispatch.preempt_f32_exact(jpk)
    big = 2**24  # beyond the f32 floor-division envelope
    for name, i, r in (("vic_resreq", 0, 0), ("node_fi0", 0, 0), ("vic_resreq", 5, 1)):
        saved = getattr(pk, name)[i, r]
        for obj in (jpk, pk):
            getattr(obj, name)[i, r] = big
        assert not preempt_f32_exact(pk) and not jax_dispatch.preempt_f32_exact(jpk)
        assert select_preempt_executor(pk, device="cuda") == "dense"
        with pytest.raises(ValueError, match="f32-exact"):
            run_preempt_cuda(pk, device="cpu")
        for obj in (jpk, pk):
            getattr(obj, name)[i, r] = saved
        assert preempt_f32_exact(pk) and jax_dispatch.preempt_f32_exact(jpk)
    assert select_preempt_executor(pk, device="cuda") == "cuda"


def test_select_preempt_executor_routes():
    pk = generate_preempt_packed(**GENERATED["small"])
    assert select_preempt_executor(pk, device="cpu") == "dense"
    assert select_preempt_executor(pk, device="cuda") == "cuda"
    pk.use_conf = False  # a weakened preemptable tier
    assert select_preempt_executor(pk, device="cuda") == "dense"


def test_execute_preempt_cpu_matches_reference():
    want = jax_preempt_dense(jax_generate_preempt_packed(**GENERATED["uneven-k"]))
    got = execute_preempt(generate_preempt_packed(**GENERATED["uneven-k"]), device="cpu")
    assert last_preempt_executor() == "dense"
    assert_same(want, got)


def test_execute_preempt_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        execute_preempt(generate_preempt_packed(n_victims=40, n_nodes=8, n_preemptors=8))


def test_preempt_packed_from_arrays_refuses_unknown_fields():
    jpk = jax_generate_preempt_packed(n_victims=40, n_nodes=8, n_preemptors=8)
    pk = to_port(jpk)
    assert pk.n_victims == 40 and pk.vic_names == jpk.vic_names
    with pytest.raises(ValueError, match="not PreemptPacked fields"):
        preempt_packed_from_arrays({}, {}, victims=1)
    with pytest.raises(ValueError, match="not PackedSnapshot fields"):
        preempt_packed_from_arrays({"nodes": np.zeros(1)}, {})


def test_empty_session_returns_nothing():
    pk = generate_preempt_packed(n_victims=40, n_nodes=8, n_preemptors=8)
    pk.schedule = np.zeros((0, 2), np.int32)
    ev, pipe = run_preempt_cuda(pk, device="cpu")
    assert ev.shape == (40,) and not ev.any()
    assert pipe.shape == (8,) and (pipe == -1).all()


# ---- the wrapper ----

def _inputs(case="small"):
    return ship_arrays(prepare_preempt_arrays(generate_preempt_packed(**GENERATED[case]))[0],
                       torch.device("cpu"))


def test_wrapper_runs_plain_version_on_cpu_without_launching():
    inputs = _inputs()
    before = preempt_kernel.LAUNCHES
    ev, pipe = preempt_pass_cuda(*inputs)
    assert preempt_kernel.LAUNCHES == before
    ev_ref, pipe_ref = preempt_pass_reference(*inputs)
    assert torch.equal(ev, ev_ref) and torch.equal(pipe, pipe_ref)
    assert ev.dtype == torch.int32 and pipe.dtype == torch.int32


def test_wrapper_rejects_bad_operands():
    sched, ptask, screq, cf, nd, vr, vjob, jobi, jobf, tol = _inputs()
    with pytest.raises(ValueError, match="vjob"):
        preempt_pass_cuda(sched, ptask, screq, cf, nd, vr, vjob.to(torch.int64), jobi, jobf, tol)
    with pytest.raises(ValueError, match="nd"):
        preempt_pass_cuda(sched, ptask, screq, cf, nd[:-1], vr, vjob, jobi, jobf, tol)
    with pytest.raises(ValueError, match="contiguous"):
        preempt_pass_cuda(sched, ptask, screq, cf, nd, vr.t().contiguous().t(), vjob, jobi,
                          jobf, tol)
    with pytest.raises(ValueError, match="ptask"):
        preempt_pass_cuda(sched, torch.zeros(4, 12), screq, cf, nd, vr, vjob, jobi, jobf, tol)
    bad_vjob = vjob.clone()
    bad_vjob[0, 0] = jobi.shape[1]
    with pytest.raises(ValueError, match="vjob outside"):
        preempt_pass_cuda(sched, ptask, screq, cf, nd, vr, bad_vjob, jobi, jobf, tol)
    bad_ptask = ptask.clone()
    bad_ptask[0, -1] = screq.shape[0]
    with pytest.raises(ValueError, match="score class"):
        preempt_pass_cuda(sched, bad_ptask, screq, cf, nd, vr, vjob, jobi, jobf, tol)
    with pytest.raises(ValueError, match="meta"):
        m = [x.to("meta") for x in (sched, ptask, screq, cf, nd, vr, vjob, jobi, jobf, tol)]
        preempt_pass_cuda(*m)


# ---- the kernel's own arithmetic, compiled with g++ ----

SHIM = r"""
#include "preempt_math.cuh"

extern "C" void eligible(int n, const int* vjob, const unsigned char* ev, const int* vprio,
                         const int* vq, const float* vmin, const float* vready, int pjob,
                         int pprio, int pq, unsigned char* out) {
  for (int i = 0; i < n; ++i)
    out[i] = vt::victim_eligible(vjob[i], ev[i] != 0, vprio[i], vq[i], vmin[i], vready[i],
                                 pjob, pprio, pq);
}

template <int R>
void validate(int N, const float* rr, const float* tol, const float* fi, const float* vsum,
              const int* vcnt, const float* ncnt, const float* nmax, const unsigned char* cls,
              unsigned char* valid, unsigned char* notfit) {
  for (int n = 0; n < N; ++n) {
    float vs[R];
    for (int r = 0; r < R; ++r) vs[r] = vsum[r * N + n];
    valid[n] = vt::node_validates<R>(rr, tol, fi + n, N, vs, vcnt[n], ncnt[n], nmax[n],
                                     cls[n] != 0);
    notfit[n] = vt::drain_not_fit<R>(rr, tol, fi + n, N, vs);
  }
}

extern "C" void validate2(int N, const float* rr, const float* tol, const float* fi,
                          const float* vsum, const int* vcnt, const float* ncnt,
                          const float* nmax, const unsigned char* cls, unsigned char* valid,
                          unsigned char* notfit) {
  validate<2>(N, rr, tol, fi, vsum, vcnt, ncnt, nmax, cls, valid, notfit);
}

extern "C" void validate3(int N, const float* rr, const float* tol, const float* fi,
                          const float* vsum, const int* vcnt, const float* ncnt,
                          const float* nmax, const unsigned char* cls, unsigned char* valid,
                          unsigned char* notfit) {
  validate<3>(N, rr, tol, fi, vsum, vcnt, ncnt, nmax, cls, valid, notfit);
}
"""


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available")
    d = tmp_path_factory.mktemp("preempt_math")
    src, lib = d / "shim.cpp", d / "libshim.so"
    src.write_text(SHIM)
    subprocess.run(
        [gxx, "-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC", "-I", CSRC,
         str(src), "-o", str(lib)],
        check=True, capture_output=True,
    )
    so = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    so.eligible.argtypes = [i, p, p, p, p, p, p, i, i, i, p]
    for fn in (so.validate2, so.validate3):
        fn.argtypes = [i] + [p] * 10
    return so


def _ptr(a: np.ndarray) -> int:
    assert a.flags["C_CONTIGUOUS"]
    return a.ctypes.data


def test_victim_eligible_matches_plain_version(shim):
    rng = np.random.RandomState(21)
    n = 4_000
    vjob = rng.randint(-1, 6, size=n).astype(np.int32)
    ev = (rng.rand(n) < 0.2).astype(np.uint8)
    vprio = rng.randint(0, 3, size=n).astype(np.int32)
    vq = rng.randint(0, 2, size=n).astype(np.int32)
    vmin = rng.randint(1, 5, size=n).astype(np.float32)
    vready = rng.randint(0, 6, size=n).astype(np.float32)
    out = np.empty(n, dtype=np.uint8)
    shim.eligible(n, _ptr(vjob), _ptr(ev), _ptr(vprio), _ptr(vq), _ptr(vmin), _ptr(vready),
                  2, 1, 0, _ptr(out))
    want = eligible_slots(*(torch.from_numpy(a) for a in (vjob, ev.astype(np.int32), vprio, vq,
                                                           vmin, vready)), 2, 1, 0).numpy()
    assert np.array_equal(want, out != 0)
    assert 0 < out.sum() < n // 4  # both outcomes, most slots filtered


@pytest.mark.parametrize("R", [2, 3])
def test_node_validation_and_drain_test_match_plain_version(shim, R):
    rng = np.random.RandomState(30 + R)
    N = 3_000
    tol = np.array([10.0, 10.0, 10.0][:R], dtype=np.float32)
    fi = np.floor(rng.rand(R, N) * 4_000 - 1_000).astype(np.float32)
    vsum = np.floor(rng.rand(R, N) * 3_000).astype(np.float32)
    vcnt = rng.randint(0, 3, size=N).astype(np.int32)
    ncnt = rng.randint(100, 112, size=N).astype(np.float32)
    nmax = np.full(N, 110.0, dtype=np.float32)
    cls = (rng.rand(N) < 0.9).astype(np.uint8)
    seen = set()
    for t in range(20):
        rr = np.floor(rng.rand(R) * 3_000).astype(np.float32)
        if R > 2 and t % 2:
            rr[2] = 5.0  # a scalar lane below tolerance passes
        edge = rng.rand(N) < 0.2  # some nodes exactly on the fit boundary
        fi[0, edge] = rr[0] - vsum[0, edge] - tol[0]
        valid = np.empty(N, dtype=np.uint8)
        notfit = np.empty(N, dtype=np.uint8)
        fn = shim.validate2 if R == 2 else shim.validate3
        fn(N, _ptr(rr), _ptr(tol), _ptr(fi), _ptr(vsum), _ptr(vcnt), _ptr(ncnt), _ptr(nmax),
           _ptr(cls), _ptr(valid), _ptr(notfit))
        want = validation_plane(
            rr.tolist(), tol.tolist(), torch.from_numpy(fi),
            [torch.from_numpy(vsum[r]) for r in range(R)], torch.from_numpy(vcnt),
            torch.from_numpy(ncnt), torch.from_numpy(nmax), torch.from_numpy(cls != 0),
        ).numpy()
        assert np.array_equal(want, valid != 0), f"row {t}"
        drain = np.array([not _fit(rr, fi[:, n] + vsum[:, n], tol) for n in range(N)])
        assert np.array_equal(drain, notfit != 0), f"row {t}"
        seen.update(zip(valid.tolist(), notfit.tolist()))
    assert {(0, 0), (0, 1), (1, 0)} <= seen


# ---- the build ----

def test_library_key_covers_every_source_and_header(tmp_path, monkeypatch):
    """An edit to any .cu source or .cuh header gives the library a new
    name, so the next launch rebuilds it."""
    from volcano_tpu_torch.ops import _build

    for fn in (*_build.sources(), *_build.sources(".cuh")):
        shutil.copy(os.path.join(_build.CSRC, fn), tmp_path / fn)
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    assert set(_build.sources()) == {"preempt_kernel.cu", "session_kernel.cu"}
    assert {"block_argmax.cuh", "preempt_math.cuh", "session_math.cuh"} <= set(
        _build.sources(".cuh"))
    seen = {_build.library_path()}
    for fn in (*_build.sources(), *_build.sources(".cuh")):
        with open(tmp_path / fn, "a") as f:
            f.write("\n// edited\n")
        seen.add(_build.library_path())
    assert len(seen) == 1 + len(_build.sources()) + len(_build.sources(".cuh"))
