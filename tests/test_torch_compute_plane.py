"""The port's compute-plane sidecar against the JAX package's, on the CPU.

The wire first: the same seeded session serializes to the same bytes in
both packages (full, delta and preempt request frames), and each
package's server answers the same request frame with the same response
bytes (allocate with and without reason counts, delta, preempt, ping,
need-full, unknown type).  Then the two directions across packages — a
port client against a JAX ``ComputePlaneServer`` and a JAX client
against the port's (served on ``device="cpu"``) — give assignments,
(evicted, pipelined) and reason counts equal to both packages' local
results; every case of ``tests/test_compute_plane.py`` and
``TestComputePlaneRecovery`` (``tests/test_faults.py``) runs on the
port, each injected failure running in-process with the fallback
counted; ``tests/test_explain.py``'s reason-count cases run over the
port's sidecar; and ``gpu-allocate(device="cpu")`` through a sidecar
binds what ``jax-allocate`` binds.  Every comparison is exact.

Socket paths live under a short ``tempfile.mkdtemp()`` (an AF_UNIX path
holds at most 107 bytes); every server is stopped, and every client
closed, in a fixture's ``finally``.
"""

from __future__ import annotations

import copy
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

import volcano_tpu.actions  # noqa: F401 — registers the JAX package's actions
import volcano_tpu_torch.actions  # noqa: F401 — registers the port's actions
from volcano_tpu.actions.jax_allocate import JaxAllocateAction
from volcano_tpu.ops import executor as jax_executor
from volcano_tpu.ops.dispatch import run_packed_auto as jax_run_packed_auto
from volcano_tpu.ops.explain import run_explain as jax_run_explain
from volcano_tpu.ops.preempt_pack import preempt_dense as jax_preempt_dense
from volcano_tpu.ops.synthetic import (
    generate_preempt_packed as jax_generate_preempt_packed,
    generate_snapshot as jax_generate_snapshot,
)
from volcano_tpu.serving import compute_plane as jcp
from volcano_tpu_torch import faults, metrics
from volcano_tpu_torch.actions.gpu_allocate import GpuAllocateAction
from volcano_tpu_torch.ops import executor
from volcano_tpu_torch.ops.dispatch import run_packed_auto
from volcano_tpu_torch.ops.explain import run_explain
from volcano_tpu_torch.ops.pack_cache import PackDelta
from volcano_tpu_torch.ops.preempt_pack import preempt_dense
from volcano_tpu_torch.ops.synthetic import generate_preempt_packed, generate_snapshot
from volcano_tpu_torch.serving import compute_plane as cp

from tests.builders import build_node, build_pod, build_pod_group, build_queue
from tests.test_torch_pack_cache import Pair
from tests.test_torch_explain import _capture
from tests.test_torch_preempt_cycle import Case
from tests.test_pack_cache import _base_cluster


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread keeps the suite's parallel workers from
    contending for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reset():
    """Both packages' session stores and executors, and the port's fault
    plane and breakers, as they were."""
    yield
    executor.configure(None)
    jax_executor.configure(None)
    cp._session_store = cp._SessionStore()
    jcp._session_store = jcp._SessionStore()
    faults.configure(None)
    faults.reset_breakers()


@pytest.fixture
def sock_dir():
    path = tempfile.mkdtemp(prefix="vcp")
    if len(path) > 80:  # a long TMPDIR would overflow the socket path
        os.rmdir(path)
        path = tempfile.mkdtemp(prefix="vcp", dir="/tmp")
    try:
        yield path
    finally:
        shutil.rmtree(path, ignore_errors=True)


@pytest.fixture
def servers(sock_dir):
    """{"port": path, "jax": path}: the port's server on the CPU and the
    JAX package's, each on its own socket."""
    paths = {"port": os.path.join(sock_dir, "p.sock"), "jax": os.path.join(sock_dir, "j.sock")}
    started = []
    try:
        started.append(cp.ComputePlaneServer(paths["port"], device="cpu").start())
        started.append(jcp.ComputePlaneServer(paths["jax"]).start())
        yield paths
    finally:
        for server in started:
            server.stop()


@pytest.fixture
def clients():
    """A factory of clients of either package, each closed at the end."""
    made = []

    def make(module, path, **kwargs):
        made.append(module.ComputePlaneClient(path, **kwargs))
        return made[-1]

    try:
        yield make
    finally:
        for client in made:
            client.close()


SNAP = dict(n_tasks=200, n_nodes=50, gang_size=4, seed=1, label_classes=3, taint_fraction=0.2)
PREEMPT = dict(n_victims=400, n_nodes=40, n_preemptors=60)


def _snaps(stuck: bool = False, **kwargs):
    """The same generated snapshot from each package (port, JAX); with
    ``stuck`` every fifth task asks for more than any node has."""
    kwargs = {**SNAP, **kwargs}
    pair = generate_snapshot(**kwargs), jax_generate_snapshot(**kwargs)
    if stuck:
        for snap in pair:
            snap.task_resreq[: snap.n_tasks : 5, 0] = 1e9
    return pair


def _raw(path: str, mtype: int, payload: bytes, frames=()):
    """Send ``frames`` and then (mtype, payload) on one connection; the
    last response frame, raw."""
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(60)
    try:
        s.connect(path)
        for t, p in frames:
            cp._send_frame(s, t, p)
            cp._recv_frame(s)
        cp._send_frame(s, mtype, payload)
        return cp._recv_frame(s)
    finally:
        s.close()


def _fallbacks() -> float:
    return metrics.registry.counter("volcano_executor_fallbacks_total",
                                    **{"from": "remote", "to": "local", "cause": "error"})


# ---- the wire: byte for byte ----


def test_wire_constants_are_the_references():
    assert (cp.MAGIC, cp.VERSION, cp._HEADER.format) == (jcp.MAGIC, jcp.VERSION,
                                                         jcp._HEADER.format)
    for name in ("T_ALLOC_REQ", "T_ALLOC_RESP", "T_PREEMPT_REQ", "T_PREEMPT_RESP", "T_PING",
                 "T_PONG", "T_ERROR", "T_ALLOC_DELTA_REQ", "T_NEED_FULL"):
        assert getattr(cp, name) == getattr(jcp, name), name
    assert cp._SNAP_ARRAYS == jcp._SNAP_ARRAYS
    assert tuple(k for k, _ in cp._SNAP_META) == jcp._SNAP_META
    assert (cp._PK_ARRAYS, cp._PK_META, cp._PK_FLAGS) == (jcp._PK_ARRAYS, jcp._PK_META,
                                                          jcp._PK_FLAGS)


@pytest.mark.parametrize("explain", [False, True])
@pytest.mark.parametrize("seed", [1, 4])
def test_full_frame_byte_equal(seed, explain):
    port, ref = _snaps(seed=seed)
    for snap in (port, ref):
        snap.cache_key, snap.rev = "key", 3
    assert cp.serialize_snapshot(port, explain) == jcp.serialize_snapshot(ref, explain)
    port.cache_key = ref.cache_key = None
    assert cp.serialize_snapshot(port, explain) == jcp.serialize_snapshot(ref, explain)


@pytest.mark.parametrize("seed", [0, 3])
def test_preempt_frame_byte_equal(seed):
    port = generate_preempt_packed(**PREEMPT, seed=seed)
    ref = jax_generate_preempt_packed(**PREEMPT, seed=seed)
    assert cp.serialize_preempt(port) == jcp.serialize_preempt(ref)


def _delta_pair(seed: int):
    """Two warm cycles of one cluster on both packages' caches (a bind
    between them): (port cold, port warm, JAX cold, JAX warm), each with
    the cache key ``k``."""
    rng = np.random.RandomState(seed)
    pair = Pair(_base_cluster(rng, n_jobs=5, gang=3, n_nodes=6))
    first, _, jfirst = pair.cycle("cycle 0")
    job = next(j for j in pair.jax.jobs.values()
               if any(not t.node_name for t in j.tasks.values()))
    task = next(t for t in job.tasks.values() if not t.node_name)
    pair.bind(job.uid, task.uid, sorted(pair.jax.nodes)[1])
    second, _, jsecond = pair.cycle("cycle 1")
    for snap in (first, jfirst, second, jsecond):
        snap.cache_key = "k"
    assert second.delta is not None and second.delta.base_rev == first.rev
    return first, second, jfirst, jsecond


@pytest.mark.parametrize("seed", [21, 22])
def test_delta_frame_byte_equal(seed):
    _, second, _, jsecond = _delta_pair(seed)
    for explain in (False, True):
        assert cp.serialize_delta(second, explain) == jcp.serialize_delta(jsecond, explain)


def test_response_frames_byte_equal(servers):
    """The same request frame, answered by each package's server: the
    same response bytes, for every message type."""
    port, _ = _snaps(stuck=True)
    pk = generate_preempt_packed(**PREEMPT)
    requests = [
        ("ping", cp.T_PING, b""),
        ("allocate", cp.T_ALLOC_REQ, cp.serialize_snapshot(port)),
        ("allocate+explain", cp.T_ALLOC_REQ, cp.serialize_snapshot(port, explain=True)),
        ("preempt", cp.T_PREEMPT_REQ, cp.serialize_preempt(pk)),
        ("unknown", 42, b""),
    ]
    for what, mtype, payload in requests:
        got = _raw(servers["port"], mtype, payload)
        want = _raw(servers["jax"], mtype, payload)
        assert got == want, what
    assert _raw(servers["port"], cp.T_PING, b"")[0] == cp.T_PONG


@pytest.mark.parametrize("seed", [21, 22])
def test_delta_response_byte_equal(servers, seed):
    """A full frame seeds each server's session store, then the delta
    frame of the next cycle: the same response; a delta against a
    revision the server does not hold answers T_NEED_FULL in both."""
    first, second, _, _ = _delta_pair(seed)
    seed_frame = [(cp.T_ALLOC_REQ, cp.serialize_snapshot(first, explain=True))]
    delta = cp.serialize_delta(second, explain=True)
    got = _raw(servers["port"], cp.T_ALLOC_DELTA_REQ, delta, seed_frame)
    want = _raw(servers["jax"], cp.T_ALLOC_DELTA_REQ, delta, seed_frame)
    assert got == want and got[0] == cp.T_ALLOC_RESP
    _, arrays = cp._unpack_arrays(got[1])
    assert np.array_equal(arrays["assignment"], run_packed_auto(second, device="cpu"))
    second.cache_key = "other"
    stale = cp.serialize_delta(second)
    assert _raw(servers["port"], cp.T_ALLOC_DELTA_REQ, stale) == \
        _raw(servers["jax"], cp.T_ALLOC_DELTA_REQ, stale) == (cp.T_NEED_FULL, b"")


# ---- across packages ----


@pytest.mark.parametrize("direction", ["port-client-jax-server", "jax-client-port-server"])
@pytest.mark.parametrize("seed", [1, 2])
def test_cross_package_allocate_and_preempt(servers, clients, direction, seed):
    """Each direction: the assignment and the reason counts equal both
    packages' local results; (evicted, pipelined) equal both packages'
    dense pass."""
    port, ref = _snaps(stuck=True, seed=seed)
    module, path = ((cp, servers["jax"]) if direction.startswith("port")
                    else (jcp, servers["port"]))
    client = clients(module, path)
    assert client.health()
    snap = port if module is cp else ref
    out = client.allocate(snap, explain=True)
    local = run_packed_auto(port, device="cpu")
    assert np.array_equal(out, local) and np.array_equal(out, np.asarray(jax_run_packed_auto(ref)))
    assert (out[: port.n_tasks] < 0).any()
    unplaced = np.nonzero(local[: port.n_tasks] < 0)[0]
    counts = client.last_reason_counts
    assert np.array_equal(counts, run_explain(port, task_rows=unplaced, device="cpu").counts)
    assert np.array_equal(counts, jax_run_explain(ref, task_rows=unplaced).counts)
    client.allocate(snap, explain=False)
    assert client.last_reason_counts is None

    pk = generate_preempt_packed(**PREEMPT, seed=seed)
    jpk = jax_generate_preempt_packed(**PREEMPT, seed=seed)
    ev, pipe = client.preempt(pk if module is cp else jpk)
    for want_ev, want_pipe in (preempt_dense(pk, device="cpu"), jax_preempt_dense(jpk)):
        assert np.array_equal(ev, np.asarray(want_ev))
        assert np.array_equal(pipe, np.asarray(want_pipe))


# ---- tests/test_compute_plane.py, on the port ----


def test_snapshot_serialization_roundtrip():
    snap = generate_snapshot(n_tasks=200, n_nodes=50, gang_size=4, seed=1,
                             label_classes=3, taint_fraction=0.2)
    back, _ = cp.deserialize_snapshot(cp.serialize_snapshot(snap))
    assert back.n_tasks == snap.n_tasks and back.n_jobs == snap.n_jobs
    assert back.resource_names == snap.resource_names
    np.testing.assert_array_equal(back.task_resreq, snap.task_resreq)
    np.testing.assert_array_equal(back.node_taint_bits, snap.node_taint_bits)
    assert (run_packed_auto(back, device="cpu") == run_packed_auto(snap, device="cpu")).all()


def test_preempt_serialization_roundtrip():
    pk = generate_preempt_packed(n_victims=400, n_nodes=40, n_preemptors=60)
    back = cp.deserialize_preempt(cp.serialize_preempt(pk))
    ev_a, pipe_a = preempt_dense(pk, device="cpu")
    ev_b, pipe_b = preempt_dense(back, device="cpu")
    np.testing.assert_array_equal(ev_a, ev_b)
    np.testing.assert_array_equal(pipe_a, pipe_b)


def test_sidecar_allocate_identical(servers, clients):
    client = clients(cp, servers["port"])
    assert client.health()
    snap = generate_snapshot(n_tasks=300, n_nodes=60, gang_size=4, seed=2)
    np.testing.assert_array_equal(client.allocate(snap), run_packed_auto(snap, device="cpu"))


def test_sidecar_preempt_identical(servers, clients):
    client = clients(cp, servers["port"])
    pk = generate_preempt_packed(n_victims=300, n_nodes=30, n_preemptors=50)
    ev_r, pipe_r = client.preempt(pk)
    ev_l, pipe_l = preempt_dense(pk, device="cpu")
    np.testing.assert_array_equal(ev_r, ev_l)
    np.testing.assert_array_equal(pipe_r, pipe_l)


def test_executor_uses_sidecar_then_falls_back(servers):
    """Sessions flow through the sidecar while it lives; after it stops
    the results stay identical and no error escapes."""
    executor.configure(servers["port"])
    snap = generate_snapshot(n_tasks=256, n_nodes=40, gang_size=4, seed=3)
    local = run_packed_auto(snap, device="cpu")
    np.testing.assert_array_equal(executor.execute_allocate(snap, device="cpu"), local)
    assert executor.last_allocate_executor() == "auto"
    before = _fallbacks()
    executor._get_remote().client.close()  # the sidecar's connection goes with it
    os.unlink(servers["port"])  # ...and it no longer answers
    np.testing.assert_array_equal(executor.execute_allocate(snap, device="cpu"), local)
    assert executor.last_allocate_executor() == "torch-scan"
    assert _fallbacks() == before + 1
    assert any("compute-plane" in r for r in faults.degraded_reasons())


def test_executor_preempt_through_sidecar(servers):
    executor.configure(servers["jax"])
    pk = generate_preempt_packed(n_victims=300, n_nodes=30, n_preemptors=50, seed=4)
    ev, pipe = executor.execute_preempt(pk, device="cpu")
    assert executor.last_preempt_executor() == "auto"
    ev_l, pipe_l = preempt_dense(pk, device="cpu")
    assert np.array_equal(ev, ev_l) and np.array_equal(pipe, pipe_l)


def _bind_cluster():
    nodes = [build_node(f"n{i}", {"cpu": "8", "memory": "32Gi"}) for i in range(4)]
    pods, pgs = [], []
    for j in range(5):
        pgs.append(build_pod_group("ns", f"pg{j}", 3, queue="q"))
        for i in range(3):
            pods.append(build_pod("ns", f"j{j}-t{i}", "", {"cpu": "1", "memory": "2Gi"},
                                  group=f"pg{j}"))
    return Case(dict(nodes=nodes, pods=pods, pod_groups=pgs, queues=[build_queue("q")]),
                tiers=(("priority", "gang"),
                       ("drf", "predicates", "proportion", "nodeorder", "binpack")))


def _binds(case, action, jax: bool):
    return _capture(case, [action], jax)[1].binder.binds


@pytest.mark.parametrize("server", ["port", "jax"])
def test_gpu_allocate_through_sidecar_binds_as_jax_allocate(servers, server):
    """gpu-allocate(device="cpu") with its kernel on a sidecar (the
    port's, or the JAX package's) binds what jax-allocate binds
    in-process; jax-allocate through the port's sidecar too."""
    case = _bind_cluster()
    want = _binds(case, JaxAllocateAction(), jax=True)
    assert len(want) == 15
    executor.configure(servers[server])
    action = GpuAllocateAction(device="cpu")
    before = _fallbacks()
    assert _binds(case, action, jax=False) == want
    assert executor.last_allocate_executor() == "auto" and _fallbacks() == before
    executor.configure(None)
    jax_executor.configure(servers["port"])
    assert _binds(case, JaxAllocateAction(), jax=True) == want
    assert jax_executor._last_route == "remote"


def test_delta_serialize_apply_roundtrip():
    """serialize_delta → apply_delta reproduces the new snapshot from the
    server-held base, plane by plane (no socket involved)."""
    first, second, _, _ = _delta_pair(21)
    base = copy.deepcopy(first)
    meta, arrays = cp._unpack_arrays(cp.serialize_delta(second))
    rebuilt = cp.apply_delta(base, meta, arrays)
    for name in cp._SNAP_ARRAYS:
        np.testing.assert_array_equal(getattr(rebuilt, name), getattr(second, name),
                                      err_msg=name)
    assert rebuilt.needs_host_validation == second.needs_host_validation
    assert rebuilt.memory_exact == second.memory_exact


def test_sidecar_delta_frames_identical(servers, clients):
    """Warm sessions ship delta frames: the sidecar applies the scatter
    to its held snapshot and returns assignments identical to the local
    run; a revision mismatch degrades to a full frame (T_NEED_FULL),
    never a wrong answer."""
    first, second, _, _ = _delta_pair(22)
    client = clients(cp, servers["port"])
    sent = []
    real = cp.serialize_delta
    try:
        cp.serialize_delta = lambda *a, **k: sent.append(1) or real(*a, **k)
        np.testing.assert_array_equal(client.allocate(first),
                                      run_packed_auto(first, device="cpu"))
        assert client._acked["k"] == first.rev  # server seeded
        np.testing.assert_array_equal(client.allocate(second),
                                      run_packed_auto(second, device="cpu"))
        assert client._acked["k"] == second.rev and sent == [1]
        # the server holds another revision than the client believes
        client._acked["k"] = second.delta.base_rev
        cp._session_store.put("k", second.delta.base_rev - 1, first)
        np.testing.assert_array_equal(client.allocate(second),
                                      run_packed_auto(second, device="cpu"))
        assert client._acked["k"] == second.rev and sent == [1, 1]
    finally:
        cp.serialize_delta = real


def test_server_records_request_timings(servers, clients):
    """Each full, delta and preempt request the server answers leaves
    its timings in ``recent_requests``; on the CPU no session kernel
    ran, so no put is reported apart from the rest."""
    first, second, _, _ = _delta_pair(23)
    client = clients(cp, servers["port"])
    seen = max((r["n"] for r in cp.recent_requests), default=0)
    client.allocate(first)
    client.allocate(second)
    client.preempt(generate_preempt_packed(**PREEMPT, seed=0))
    got = [r for r in cp.recent_requests if r["n"] > seen]
    assert [r["type"] for r in got] == ["full", "delta", "preempt"]
    assert [r["n"] for r in got] == list(range(seen + 1, seen + 4))
    for r in got:
        assert r["put_ms"] is None
        assert min(r["decode_ms"], r["kernel_ms"], r["reply_ms"]) >= 0


# ---- tests/test_faults.py's TestComputePlaneRecovery, on the port ----


class TestComputePlaneRecovery:
    @pytest.fixture()
    def plane(self, servers):
        executor.configure(servers["port"])
        yield servers["port"]

    def _small(self):
        return generate_snapshot(n_tasks=64, n_nodes=16, gang_size=4, seed=0)

    @pytest.mark.parametrize("point", ["crash", "corrupt", "timeout"])
    def test_failure_falls_back_and_recovers(self, plane, point):
        """One injected failure: the session runs in-process with the
        same answer, the fallback counted, the breaker open and /healthz
        degraded; after the probe window the sidecar serves again."""
        snap = self._small()
        reference = executor.execute_allocate(snap, device="cpu")
        assert executor._last_route == "remote"
        before = _fallbacks()
        faults.configure(f"seed=1;compute.{point}=1:count=1")
        out = executor.execute_allocate(snap, device="cpu")
        np.testing.assert_array_equal(out, reference)
        assert executor._last_route == "local"
        assert executor.last_allocate_executor() == "torch-scan"
        assert _fallbacks() == before + 1
        br = faults.get_breaker("compute-plane")
        assert br.state == "open" and faults.degraded_reasons()
        # inside the probe window the route stays local, counting nothing
        executor.execute_allocate(snap, device="cpu")
        assert executor._last_route == "local" and _fallbacks() == before + 1

        faults.configure(None)
        executor._get_remote().last_probe = 0.0
        np.testing.assert_array_equal(executor.execute_allocate(snap, device="cpu"), reference)
        assert executor._last_route == "remote"
        assert br.state == "closed" and not faults.degraded_reasons()

    def test_preempt_failure_falls_back(self, plane):
        pk = generate_preempt_packed(n_victims=120, n_nodes=12, n_preemptors=20, seed=5)
        want = preempt_dense(pk, device="cpu")
        before = _fallbacks()
        faults.configure("seed=1;compute.crash=1:count=1")
        ev, pipe = executor.execute_preempt(pk, device="cpu")
        assert np.array_equal(ev, want[0]) and np.array_equal(pipe, want[1])
        assert executor.last_preempt_executor() == "dense" and _fallbacks() == before + 1

    def test_session_loss_clears_acked_revisions(self, plane):
        remote = executor._get_remote()
        remote.client._acked["some-key"] = 7
        remote.mark_unhealthy("test")
        assert remote.client._acked == {}

    def test_stale_ack_after_close_is_discarded(self, plane):
        client = executor._get_remote().client
        gen = client._session_gen
        client.close()
        client._ack(gen, "k", 5)  # the abandoned worker's late write
        assert client._acked == {}
        client._ack(client._session_gen, "k", 5)
        assert client._acked == {"k": 5}

    def test_forced_need_full_reseeds(self, plane):
        """compute.need_full answers a delta frame with T_NEED_FULL; the
        client re-sends the full snapshot — same assignment, session
        store re-seeded, nothing counted."""
        snap = self._small()
        snap.cache_key, snap.rev, snap.delta = "chaos-key", 1, None
        first = executor.execute_allocate(snap, device="cpu")
        assert executor._last_route == "remote"
        snap2 = self._small()
        snap2.cache_key, snap2.rev = "chaos-key", 2
        snap2.delta = PackDelta(base_rev=1, planes={})
        before = _fallbacks()
        faults.configure("seed=1;compute.need_full=1:count=1")
        out = executor.execute_allocate(snap2, device="cpu")
        np.testing.assert_array_equal(out, first)
        assert executor._last_route == "remote" and _fallbacks() == before
        assert cp._session_store.get("chaos-key")[0] == 2


# ---- tests/test_explain.py's reason-count cases, over the port ----


def _stuck_snapshot():
    snap = generate_snapshot(n_tasks=32, n_nodes=8, gang_size=4, seed=5)
    snap.task_resreq[:, 0] = 1e9  # nothing fits anywhere
    return snap


def test_executor_counts_lazy():
    placed = generate_snapshot(n_tasks=16, n_nodes=8, gang_size=4, seed=0)
    executor.execute_allocate(placed, device="cpu", explain=True)
    assert executor.last_explain_counts() is None  # everything placed
    snap = _stuck_snapshot()
    executor.execute_allocate(snap, device="cpu", explain=True)
    counts = executor.last_explain_counts()
    assert counts is not None and counts.shape == (snap.n_tasks, 5)
    assert (counts.sum(axis=1) == snap.n_nodes).all()
    assert executor.last_explain_ms() is not None
    executor.execute_allocate(snap, device="cpu")
    assert executor.last_explain_counts() is None


def test_compute_plane_returns_reason_counts(servers, clients):
    client = clients(cp, servers["port"], timeout=60)
    snap = _stuck_snapshot()
    assignment = client.allocate(snap, explain=True)
    assert (assignment[: snap.n_tasks] < 0).all()
    local = run_explain(snap, task_rows=np.arange(snap.n_tasks), device="cpu").counts
    assert np.array_equal(client.last_reason_counts, local)
    client.allocate(snap, explain=False)
    assert client.last_reason_counts is None


def test_executor_takes_counts_from_the_sidecar(servers):
    """Over the sidecar the counts are the wire's: no local reduction."""
    executor.configure(servers["port"])
    snap = _stuck_snapshot()
    executor.execute_allocate(snap, device="cpu", explain=True)
    assert executor.last_allocate_executor() == "auto"
    assert executor.last_explain_ms() is None
    want = run_explain(snap, task_rows=np.arange(snap.n_tasks), device="cpu").counts
    assert np.array_equal(executor.last_explain_counts(), want)


# ---- the server's device ----


def test_server_refuses_to_start_without_a_gpu(sock_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cp.ComputePlaneServer(os.path.join(sock_dir, "x.sock"), device=device).start()
    assert not os.path.exists(os.path.join(sock_dir, "x.sock"))


# ---- the entry point ----


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cmd(*args):
    return [sys.executable, "-m", "volcano_tpu_torch.cmd.compute_plane", *args]


def _env(**extra):
    return dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1", **extra)


def test_cmd_exits_at_start_without_a_gpu(sock_dir):
    """No --device and no GPU: the sidecar exits before it serves."""
    path = os.path.join(sock_dir, "cp.sock")
    proc = subprocess.run(_cmd("--socket", path), cwd=ROOT, capture_output=True, text=True,
                          timeout=120, env=_env(CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert not os.path.exists(path)


def test_cmd_serves_on_the_cpu_when_asked(sock_dir, clients):
    """--device cpu --faults …: the child answers the port's client with
    the local result, logs its status on SIGUSR1 and stops on SIGTERM."""
    path = os.path.join(sock_dir, "cp.sock")
    log = os.path.join(sock_dir, "cp.log")
    with open(log, "w") as out:
        proc = subprocess.Popen(_cmd("--socket", path, "--device", "cpu", "--faults",
                                     "seed=1;compute.need_full=1:count=1"),
                                cwd=ROOT, stdout=out, stderr=subprocess.STDOUT, env=_env())
    try:
        client = clients(cp, path, timeout=60)
        deadline = time.monotonic() + 120
        while not client.health():
            assert proc.poll() is None and time.monotonic() < deadline, open(log).read()
            time.sleep(0.1)
        snap = generate_snapshot(n_tasks=64, n_nodes=16, gang_size=4, seed=0)
        assert np.array_equal(client.allocate(snap), run_packed_auto(snap, device="cpu"))
        proc.send_signal(signal.SIGUSR1)
        while "compute plane status: " not in open(log).read():
            assert time.monotonic() < deadline
            time.sleep(0.05)
        status = json.loads(open(log).read().split("compute plane status: ")[1].splitlines()[0])
        requests = status.pop("requests")
        assert status == dict(session=0, session_wide=0, preempt=0, memory_reserved=0)
        # the need_full fault answered no request; the one full frame did
        assert [(r["n"], r["type"], r["put_ms"]) for r in requests] == [(1, "full", None)]
        assert min(requests[0][k] for k in ("decode_ms", "kernel_ms", "reply_ms")) >= 0
        client.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)


def test_cmd_rejects_a_bad_fault_schedule(sock_dir):
    proc = subprocess.run(_cmd("--socket", os.path.join(sock_dir, "cp.sock"), "--device", "cpu",
                               "--faults", "no-such-grammar"),
                          cwd=ROOT, capture_output=True, text=True, timeout=120, env=_env())
    assert proc.returncode != 0 and "--faults" in proc.stderr
