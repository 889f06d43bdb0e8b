"""The port's cycle trace against the JAX package's, on the CPU.

``volcano_tpu_torch.trace``: the recorder, the journal, replay and the
Chrome export, mirrored from ``tests/test_trace.py`` (the null recorder,
cycle assembly, the ring, foreign files, resuming past the newest cycle
and past an orphan snapshot, a failing write, the event cap, a crashed
``open_session`` journaled, the recorded kernel parameters).  Then across
packages, bit for bit:

  * a journal the port's ``Scheduler`` recorded with ``gpu-allocate`` on
    ``device="cpu"`` replays with zero diff through the JAX package's
    ``volcano_tpu.trace.replay.verify`` (``jax``, ``native``);
  * a journal the JAX ``Scheduler`` recorded with ``jax-allocate``
    replays with zero diff through the port's ``verify`` (``torch-scan``,
    ``native``, ``blocked`` and ``cuda``, the last two on CPU tensors);
  * both loops over one churn script journal equal decision sequences
    ``(kind, task, node)``, and equal event names under the map
    ``jax-allocate:*`` → ``gpu-allocate:*`` and the JAX dispatcher's CPU
    executors (``xla-scan``, ``native``) → ``torch-scan``;
  * ``chrome_trace``/``merge_chrome_traces`` of one record give equal
    JSON, and the npz extras have the same keys and dtypes;
  * ``/trace/last`` answers 404 before a recorded cycle and the port's
    Chrome JSON after one;
  * ``python -m volcano_tpu_torch.cmd.trace`` record/replay/diff/export
    through ``main(argv)``, ``diff`` exiting 1 on a perturbed capture;
  * through a compute-plane sidecar, the capture is labelled ``auto``
    and the executor's remote spans and fallback event are recorded.

The port's device actions run on the CPU as a caller asks for it: the
``cpu_actions`` fixture registers ``GpuAllocateAction(device="cpu")``
under its name and restores the registry's instance after.
"""

from __future__ import annotations

import io
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import volcano_tpu.actions  # noqa: F401 — registers the JAX package's actions
from volcano_tpu import trace as jax_trace
from volcano_tpu.trace import export as jax_export
from volcano_tpu.trace.journal import Journal as JaxJournal
from volcano_tpu.trace.replay import verify as jax_verify
from volcano_tpu_torch import trace
from volcano_tpu_torch.actions import gpu_allocate
from volcano_tpu_torch.cmd import trace as cmd_trace
from volcano_tpu_torch.framework import get_action, register_action
from volcano_tpu_torch.ops.kernels import DEFAULT_WEIGHTS, run_packed, ScoreWeights
from volcano_tpu_torch.ops.packing import load_snapshot, save_snapshot
from volcano_tpu_torch.ops.synthetic import generate_snapshot
from volcano_tpu_torch.scheduler import scheduler as port_scheduler
from volcano_tpu_torch.serving.http import ServingServer
from volcano_tpu_torch.trace.journal import Journal
from volcano_tpu_torch.trace.recorder import NullRecorder, TraceRecorder
from volcano_tpu_torch.trace.replay import EXECUTORS, run_snapshot, verify

from tests.test_torch_scheduler import churn_script, Loop, Store


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: one intra-op thread is as fast, and keeps
    the suite's parallel workers from contending for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def cpu_actions():
    """gpu-allocate on the CPU for this test, the registry's instance
    restored after; both packages' recorders off again after."""
    saved = get_action("gpu-allocate")
    register_action(gpu_allocate.GpuAllocateAction(device="cpu"))
    yield
    register_action(saved)
    trace.disable()
    jax_trace.disable()


# ---- recorder (tests/test_trace.py) ----


def test_default_recorder_is_null():
    rec = trace.get_recorder()
    assert isinstance(rec, NullRecorder)
    assert not rec.enabled
    assert rec.begin_cycle() == -1
    with rec.span("x", "y"):
        pass
    rec.event("x")
    rec.decision("bind", "t0", "n0")
    rec.capture(None, None)
    assert not rec.should_capture()
    rec.end_cycle()
    assert rec.last_cycle() is None


def test_null_recorder_overhead_is_negligible():
    rec = NullRecorder()
    t0 = time.perf_counter()
    for _ in range(100_000):
        if rec.enabled:
            rec.event("never")
    assert time.perf_counter() - t0 < 1.0


def test_recorder_cycle_assembly():
    rec = TraceRecorder()
    assert rec.begin_cycle() == 0
    rec.event("hello", "cat", answer=42)
    with rec.span("work", "action"):
        pass
    rec.decision("bind", "task-1", "node-1")
    rec.end_cycle(duration_s=0.5)

    record = rec.last_cycle()
    assert record["cycle"] == 0
    assert record["duration_ms"] == pytest.approx(500.0)
    assert [e["name"] for e in record["events"]] == ["hello", "work"]
    span = record["events"][1]
    assert span["ph"] == "X" and span["dur"] >= 0
    (decision,) = record["decisions"]
    assert (decision["kind"], decision["task"], decision["node"]) == ("bind", "task-1", "node-1")
    assert decision["ts"] >= record["start_us"]
    assert rec.begin_cycle() == 1
    rec.end_cycle()
    assert rec.last_cycle()["events"] == []


def test_enable_and_disable_swap_the_global_recorder(tmp_path):
    rec = trace.enable(str(tmp_path), snapshot_every=3, keep=5)
    assert trace.get_recorder() is rec and rec.enabled
    assert rec.journal.keep == 5 and rec.snapshot_every == 3
    trace.disable()
    assert isinstance(trace.get_recorder(), NullRecorder)
    mine = TraceRecorder()
    trace.set_recorder(mine)
    assert trace.get_recorder() is mine
    trace.set_recorder(None)
    assert not trace.get_recorder().enabled


def test_event_cap_bounds_buffer_and_counts_decisions():
    """Events and decisions past max_events_per_cycle are dropped and
    counted in the record's n_dropped."""
    rec = TraceRecorder()
    rec.max_events_per_cycle = 5
    rec.begin_cycle()
    for i in range(7):
        rec.event(f"e{i}")
    for i in range(8):
        rec.decision("bind", f"t{i}", "n0")
    rec.end_cycle()
    record = rec.last_cycle()
    assert len(record["events"]) == 5 and len(record["decisions"]) == 5
    assert record["n_dropped"] == 5


# ---- journal ----


def test_journal_roundtrip_and_ring(tmp_path):
    journal = Journal(str(tmp_path), keep=3)
    rec = TraceRecorder(journal=journal)
    for i in range(5):
        rec.begin_cycle()
        rec.event("e", "c", i=i)
        rec.decision("bind", f"t{i}", f"n{i}")
        rec.end_cycle(duration_s=0.001 * (i + 1))
    assert journal.cycles() == [2, 3, 4]
    record = journal.read_cycle(4)
    assert record["cycle"] == 4
    assert record["events"][0]["args"] == {"i": 4}
    (decision,) = record["decisions"]
    assert (decision["kind"], decision["task"], decision["node"]) == ("bind", "t4", "n4")
    assert record["duration_ms"] == pytest.approx(5.0)


def test_journal_keep_must_be_positive(tmp_path):
    with pytest.raises(ValueError, match="keep"):
        Journal(str(tmp_path), keep=0)


def test_journal_ignores_foreign_files(tmp_path):
    (tmp_path / "cycle-keep.npz").write_bytes(b"")
    (tmp_path / "cycle-00000002.npz").write_bytes(b"")
    journal = Journal(str(tmp_path))
    assert journal.snapshot_cycles() == [2]
    rec = TraceRecorder(journal=journal)
    rec.begin_cycle()
    rec.end_cycle()
    assert rec.last_cycle()["cycle"] == 3


def test_recorder_resumes_cycle_ids_from_journal(tmp_path):
    journal = Journal(str(tmp_path))
    rec = TraceRecorder(journal=journal)
    for _ in range(3):
        rec.begin_cycle()
        rec.end_cycle()
    assert journal.cycles() == [0, 1, 2]
    rec2 = TraceRecorder(journal=Journal(str(tmp_path)))
    assert rec2.begin_cycle() == 3
    rec2.end_cycle()
    assert journal.cycles() == [0, 1, 2, 3]


def test_recorder_resumes_past_orphan_snapshot(tmp_path):
    journal = Journal(str(tmp_path))
    snap = generate_snapshot(n_tasks=8, n_nodes=4, seed=0)
    journal.write_snapshot(5, snap, np.zeros(8, dtype=np.int32))
    assert journal.last_cycle() is None
    assert TraceRecorder(journal=journal).begin_cycle() == 6


def test_journal_write_failure_does_not_raise(tmp_path):
    blocked = tmp_path / "not-a-dir"
    blocked.write_text("")
    rec = TraceRecorder(journal=Journal(str(blocked)), snapshot_every=1)
    rec.begin_cycle()
    rec.event("x")
    snap = generate_snapshot(n_tasks=8, n_nodes=4, seed=0)
    rec.capture(snap, np.zeros(8, dtype=np.int32))
    rec.end_cycle(0.01)
    assert rec.last_cycle()["cycle"] == 0


def test_read_only_journal_calls_create_nothing(tmp_path):
    missing = tmp_path / "absent"
    journal = Journal(str(missing))
    assert journal.cycles() == [] and journal.snapshot_cycles() == []
    assert journal.last_cycle() is None
    assert not missing.exists()


def test_snapshot_npz_roundtrip(tmp_path):
    snap = generate_snapshot(n_tasks=64, n_nodes=16, gang_size=4, seed=3)
    path = str(tmp_path / "snap.npz")
    save_snapshot(snap, path, assignment=np.arange(64, dtype=np.int32))
    loaded, extras = load_snapshot(path)
    for name in ("n_tasks", "n_nodes", "n_jobs", "resource_names", "task_uids",
                 "node_names", "memory_exact"):
        assert getattr(loaded, name) == getattr(snap, name), name
    for name in ("task_resreq", "node_idle", "job_min_available"):
        np.testing.assert_array_equal(getattr(loaded, name), getattr(snap, name))
    np.testing.assert_array_equal(extras["assignment"], np.arange(64))


# ---- replay ----


def _record_one_cycle(tmp_path, weights=None, gang_rounds=3, seed=7):
    journal = Journal(str(tmp_path))
    rec = TraceRecorder(journal=journal, snapshot_every=1)
    snap = generate_snapshot(n_tasks=128, n_nodes=32, gang_size=4, seed=seed)
    rec.begin_cycle()
    assignment = run_snapshot(snap, "torch-scan", weights=weights, gang_rounds=gang_rounds,
                              device="cpu")
    rec.capture(snap, assignment, executor="torch-scan", weights=weights or DEFAULT_WEIGHTS,
                gang_rounds=gang_rounds)
    rec.end_cycle(duration_s=0.01)
    return journal, snap, assignment


@pytest.mark.parametrize("executor", ["torch-scan", "cuda", "blocked", "auto", "native"])
def test_replay_verify_identical(tmp_path, executor):
    """Every executor replays a torch-scan capture with zero diff
    (``cuda`` on CPU tensors runs the kernel's plain version)."""
    journal, _, _ = _record_one_cycle(tmp_path)
    result = verify(journal, executor=executor, device="cpu")
    assert result.match and result.n_diffs == 0, result.diffs[:5]
    assert result.n_tasks == 128 and result.recorded_executor == "torch-scan"
    assert "IDENTICAL" in result.summary()


def test_replay_flags_perturbed_snapshot(tmp_path):
    journal, snap, assignment = _record_one_cycle(tmp_path)
    tampered = np.asarray(assignment, dtype=np.int32).copy()
    idx = int(np.nonzero(tampered[: snap.n_tasks] >= 0)[0][0])
    tampered[idx] = (tampered[idx] + 1) % snap.n_nodes
    journal.write_snapshot(0, snap, tampered, executor="torch-scan")
    result = verify(journal, executor="torch-scan", device="cpu")
    assert not result.match and result.n_diffs == 1
    task_idx, recorded_node, replayed_node = result.diffs[0]
    assert task_idx == idx and recorded_node != replayed_node
    assert "DIFF" in result.summary()


def test_replay_uses_recorded_kernel_params(tmp_path):
    weights = ScoreWeights(binpack_weight=3.0, least_requested_weight=0.25)
    journal, snap, _ = _record_one_cycle(tmp_path, weights=weights, gang_rounds=5, seed=11)
    _, extras = journal.read_snapshot(0)
    lanes = [float(v) for v in np.asarray(extras["weights"]).ravel()]
    assert lanes[:-1] == [float(v) for v in tuple(weights)[:-1]]
    assert int(extras["gang_rounds"]) == 5
    assert verify(journal, executor="torch-scan", device="cpu").match
    # native scores with the default weights only: it refuses, loudly
    with pytest.raises(RuntimeError, match="DEFAULT_WEIGHTS"):
        verify(journal, executor="native")


def test_replay_warns_on_foreign_weight_lanes(tmp_path):
    journal = Journal(str(tmp_path))
    snap = generate_snapshot(n_tasks=64, n_nodes=16, gang_size=4, seed=2)
    out = run_packed(snap, device="cpu")
    journal.write_snapshot(0, snap, out, executor="torch-scan",
                           weights=np.ones(5, dtype=np.float64), gang_rounds=3)
    with pytest.warns(RuntimeWarning, match="weight lanes"):
        result = verify(journal, executor="torch-scan", device="cpu")
    assert result.match


def test_replay_accepts_directory_path_and_needs_a_snapshot(tmp_path):
    with pytest.raises(FileNotFoundError):
        verify(str(tmp_path), device="cpu")
    _record_one_cycle(tmp_path)
    assert verify(str(tmp_path), executor="torch-scan", device="cpu").match
    with pytest.raises(ValueError, match="unknown executor"):
        verify(str(tmp_path), executor="pallas", device="cpu")


def test_capture_label_replays_by_its_own_name(tmp_path):
    # every name ops/executor.last_allocate_executor reports is a replay
    # executor, so a capture's label needs no translation
    assert {"cuda", "torch-scan", "auto"} <= set(EXECUTORS)
    trace.enable(str(tmp_path), snapshot_every=1)
    loop = Loop(True, tmp_path)
    loop.feed(next(churn_script(Store())))
    loop.cycle()
    _, extras = Journal(str(tmp_path)).read_snapshot(0)
    result = verify(str(tmp_path), executor=str(extras["executor"]), device="cpu")
    assert result.match and result.executor == result.recorded_executor == "torch-scan"


# ---- the port's loop ----


def test_scheduler_cycle_records_decisions_and_captures(tmp_path):
    rec = trace.enable(str(tmp_path), snapshot_every=1)
    loop = Loop(True, tmp_path)
    store = Store()
    loop.feed(next(churn_script(store)))
    binds, _ = loop.cycle()
    record = rec.last_cycle()
    assert record is not None and record["cycle"] == 0 and "n_dropped" not in record
    names = [e["name"] for e in record["events"]]
    for name in ("open_session", "close_session", "action:gpu-allocate", "action:enqueue",
                 "kernel:pack", "kernel:execute", "gpu-allocate:order", "snapshot-capture"):
        assert name in names, name
    assert any(n.startswith("plugin:") and n.endswith(".open") for n in names)
    (dispatch,) = [e for e in record["events"] if e["name"] == "dispatch:allocate"]
    assert dispatch["args"]["executor"] == "torch-scan"
    decisions = [(d["kind"], d["task"], d["node"]) for d in record["decisions"]
                 if d["kind"] == "bind"]
    uid = {f"{t.namespace}/{t.name}": t.uid for j in loop.cache.jobs.values()
           for t in j.tasks.values()}
    assert decisions == [("bind", uid[name], host) for name, host in binds]
    journal = Journal(str(tmp_path))
    assert journal.read_cycle(0)["decisions"] == record["decisions"]
    _, extras = journal.read_snapshot(0)
    assert extras["executor"] == "torch-scan"
    assert verify(journal, executor="torch-scan", device="cpu").match


def test_disabled_recording_changes_nothing(tmp_path):
    loop = Loop(True, tmp_path)
    loop.feed(next(churn_script(Store())))
    binds, _ = loop.cycle()
    assert len(binds) == 5
    assert trace.get_recorder().last_cycle() is None
    assert list(tmp_path.glob("cycle-*")) == []


def test_crashed_open_session_cycle_is_journaled(tmp_path, monkeypatch):
    trace.enable(str(tmp_path / "journal"))

    def boom(*args, **kwargs):
        raise RuntimeError("plugin open crashed")

    loop = Loop(True, tmp_path)
    monkeypatch.setattr(port_scheduler, "open_session", boom)
    with pytest.raises(RuntimeError, match="plugin open crashed"):
        loop.scheduler.run_once()
    assert Journal(str(tmp_path / "journal")).cycles() == [0]


def test_cycle_id_is_the_recorders_when_tracing(tmp_path):
    loop = Loop(True, tmp_path)
    loop.scheduler.run_once()
    assert trace.current_cycle() == 1  # the local sequence
    trace.enable(str(tmp_path / "journal"))
    loop.scheduler.run_once()
    assert trace.current_cycle() == 0  # the recorder's cycle id


def test_deadline_event_is_journaled_before_the_action_raises(tmp_path, monkeypatch):
    from volcano_tpu_torch.faults import watchdog
    from volcano_tpu_torch.faults.watchdog import CycleDeadlineExceeded

    rec = trace.enable(str(tmp_path / "journal"))
    loop = Loop(True, tmp_path)
    loop.feed(next(churn_script(Store())))
    watchdog.configure_deadline(1.0)
    real = gpu_allocate.compute_task_order

    def slow_order(ssn):
        time.sleep(0.01)
        return real(ssn)

    monkeypatch.setattr(gpu_allocate, "compute_task_order", slow_order)
    try:
        with pytest.raises(CycleDeadlineExceeded):
            loop.scheduler.run_once()
    finally:
        watchdog.configure_deadline(None)
    record = rec.last_cycle()
    names = [e["name"] for e in record["events"]]
    assert "watchdog:device-phase-abandoned" in names
    assert not [d for d in record["decisions"] if d["kind"] == "bind"]


def test_breaker_and_fault_events_are_recorded():
    from volcano_tpu_torch import faults

    rec = trace.enable()
    rec.begin_cycle()
    try:
        faults.configure("seed=1;device.lowering=1:count=1")
        assert faults.get_plane().should("device.lowering")
        br = faults.get_breaker("trace-test", failure_threshold=1, cooldown_s=30.0)
        br.record_failure("boom")
    finally:
        faults.configure(None)
        faults.reset_breakers()
    rec.end_cycle()
    events = {e["name"]: e.get("args", {}) for e in rec.last_cycle()["events"]}
    assert events["fault:device.lowering"] == {"n": 1}
    assert events["breaker:trace-test:open"] == {"prev": "closed", "error": "boom"}


# ---- across packages ----


def _jax_loop(tmp_path, jdir):
    jax_trace.enable(str(jdir), snapshot_every=1)
    return Loop(False, tmp_path)


def _port_loop(tmp_path, pdir):
    trace.enable(str(pdir), snapshot_every=1)
    return Loop(True, tmp_path)


def _run_script(loop, recorder):
    """Every cycle of the churn script; (the recorder's records, each
    cycle's decisions as (kind, ns/name, node): a pod's uid is its
    package's own)."""
    store = Store()
    records, decisions = [], []
    for events in churn_script(store):
        loop.feed(events)
        binds, _ = loop.cycle()
        store.bound(binds)
        record = recorder.get_recorder().last_cycle()
        names = {t.uid: f"{t.namespace}/{t.name}" for j in loop.cache.jobs.values()
                 for t in j.tasks.values()}
        records.append(record)
        decisions.append([(d["kind"], names[d["task"]], d["node"])
                          for d in record["decisions"]])
    return records, decisions


@pytest.mark.parametrize("executor", ["jax", "native"])
def test_port_journal_replays_through_the_jax_package(tmp_path, executor):
    pdir = tmp_path / "port"
    _run_script(_port_loop(tmp_path, pdir), trace)
    journal = JaxJournal(str(pdir))
    cycles = journal.snapshot_cycles()
    assert len(cycles) >= 5
    placed = 0
    for c in cycles:
        result = jax_verify(journal, cycle=c, executor=executor)
        assert result.recorded_executor == "torch-scan"
        assert result.n_diffs == 0, (c, result.diffs[:5])
        placed += result.n_placed_recorded
    assert placed > 20


@pytest.mark.parametrize("executor", ["torch-scan", "native", "blocked", "cuda"])
def test_jax_journal_replays_through_the_port(tmp_path, executor):
    jdir = tmp_path / "jax"
    _run_script(_jax_loop(tmp_path, jdir), jax_trace)
    journal = Journal(str(jdir))
    cycles = journal.snapshot_cycles()
    assert len(cycles) >= 5
    placed = 0
    for c in cycles:
        result = verify(journal, cycle=c, executor=executor, device="cpu")
        assert result.n_diffs == 0, (c, result.diffs[:5])
        placed += result.n_placed_recorded
    assert placed > 20


#: the JAX loop's event names and dispatch labels in the port's words
_JAX_NAMES = {"jax-allocate:order": "gpu-allocate:order", "action:jax-allocate":
              "action:gpu-allocate"}
_JAX_EXECUTORS = {"xla-scan": "torch-scan", "native": "torch-scan"}


def _normalized(record, jax: bool):
    """(event names, dispatch:allocate labels, explain-summary args) in
    the port's words."""
    names, executors, explained = [], [], []
    for e in record["events"]:
        name = _JAX_NAMES.get(e["name"], e["name"]) if jax else e["name"]
        names.append(name)
        if name == "dispatch:allocate":
            ex = e["args"]["executor"]
            executors.append(_JAX_EXECUTORS.get(ex, ex) if jax else ex)
        elif name == "explain-summary":
            explained.append(e["args"])
    return names, executors, explained


def test_loops_journal_equal_decisions_and_events(tmp_path):
    """The same cluster objects through both loops: equal decision
    sequences (kind, task, node) cycle by cycle, and equal event names
    and dispatch labels under the stated map."""
    port, port_decisions = _run_script(_port_loop(tmp_path, tmp_path / "port"), trace)
    ref, ref_decisions = _run_script(_jax_loop(tmp_path, tmp_path / "jax"), jax_trace)
    assert len(port) == len(ref) == 6
    assert port_decisions == ref_decisions
    for k, (p, r) in enumerate(zip(port, ref)):
        assert _normalized(p, False) == _normalized(r, True), f"cycle {k}"
    assert sum(map(len, port_decisions)) > 20
    # the last two cycles leave a gang unplaced: explained alike
    assert [len(_normalized(p, False)[2]) for p in port] == [0, 0, 0, 0, 1, 1]


def _sample_records():
    rec = TraceRecorder()
    out = []
    for k in range(2):
        rec.begin_cycle()
        with rec.span("action:gpu-allocate", "action", k=k):
            rec.event("dispatch:allocate", "kernel", executor="cuda", tasks=4, nodes=2)
        rec.decision("bind", f"t{k}", "n1")
        rec.decision("evict", f"v{k}", "n0", reason="preempted")
        rec.end_cycle(duration_s=0.002 * (k + 1))
        out.append(rec.last_cycle())
    return out


def test_chrome_export_equals_the_jax_packages():
    records = _sample_records()
    for record in records:
        assert json.dumps(trace.chrome_trace(record)) == json.dumps(
            jax_export.chrome_trace(record))
    labels = ["a", "b"]
    assert json.dumps(trace.merge_chrome_traces(records, labels=labels)) == json.dumps(
        jax_export.merge_chrome_traces(records, labels=labels))
    assert trace.merge_chrome_traces([]) == jax_export.merge_chrome_traces([])


def test_journal_files_equal_the_jax_packages(tmp_path):
    """A cycle record and a capture written by each package's journal:
    the same event-log lines, and npz extras with the same keys and
    dtypes; each package reads the other's files."""
    record = _sample_records()[1]
    snap = generate_snapshot(n_tasks=32, n_nodes=8, gang_size=4, seed=4)
    assignment = run_packed(snap, device="cpu")
    port_j, jax_j = Journal(str(tmp_path / "p")), JaxJournal(str(tmp_path / "j"))
    for j in (port_j, jax_j):
        j.write_snapshot(1, snap, assignment, executor="cuda",
                         weights=DEFAULT_WEIGHTS, gang_rounds=3)
        j.write_cycle(record)
    lines = [(tmp_path / d / "cycle-00000001.jsonl").read_text().splitlines()
             for d in ("p", "j")]
    assert [json.loads(x) for x in lines[0]] == [json.loads(x) for x in lines[1]]
    extras = []
    for d in ("p", "j"):
        with np.load(str(tmp_path / d / "cycle-00000001.npz")) as z:
            extras.append({k: (z[k].dtype.str, z[k].shape) for k in z.files})
    assert extras[0] == extras[1]
    assert {k for k in extras[0] if k.startswith("__extra__")} == {
        "__extra__assignment", "__extra__executor", "__extra__cycle", "__extra__weights",
        "__extra__gang_rounds"}
    assert extras[0]["__extra__assignment"][0] == np.dtype(np.int32).str
    assert extras[0]["__extra__weights"] == (np.dtype(np.float64).str, (7,))
    for reader in (port_j, jax_j):
        for d in ("p", "j"):
            snap2, ex = type(reader)(str(tmp_path / d)).read_snapshot(1)
            assert ex["executor"] == "cuda" and ex["cycle"] == 1
            np.testing.assert_array_equal(snap2.task_resreq, snap.task_resreq)
        assert reader.read_cycle(1) == jax_j.read_cycle(1)


# ---- /trace/last ----


def _get(port: int, path: str):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        try:
            return e.code, e.headers["Content-Type"], e.read()
        finally:
            e.close()


def test_trace_last_endpoint(tmp_path):
    server = ServingServer(port=0, debug_enabled=True).start()
    try:
        status, _, body = _get(server.port, "/trace/last")
        assert (status, body) == (404, b"no recorded cycle (is tracing enabled?)")

        rec = trace.enable(str(tmp_path / "journal"))
        loop = Loop(True, tmp_path)
        loop.feed(next(churn_script(Store())))
        loop.cycle()
        status, ctype, body = _get(server.port, "/trace/last")
        assert (status, ctype) == (200, "application/json")
        obj = json.loads(body)
        assert obj == json.loads(json.dumps(trace.chrome_trace(rec.last_cycle())))
        assert obj["metadata"]["cycle"] == 0 and obj["metadata"]["n_decisions"] == 5
        assert any(e["ph"] == "X" and e["name"] == "action:gpu-allocate"
                   for e in obj["traceEvents"])
        assert sum(e["cat"] == "decision" for e in obj["traceEvents"]) == 5
    finally:
        server.stop()


def test_trace_last_reads_the_recorder_installed_at_request_time():
    server = ServingServer(port=0).start()
    try:
        rec = TraceRecorder()
        trace.set_recorder(rec)
        assert _get(server.port, "/trace/last")[0] == 404
        rec.begin_cycle()
        rec.decision("bind", "t0", "n0")
        rec.end_cycle(0.001)
        status, _, body = _get(server.port, "/trace/last")
        assert status == 200
        assert json.loads(body)["metadata"]["n_decisions"] == 1
        trace.set_recorder(None)
        assert _get(server.port, "/trace/last")[0] == 404
    finally:
        server.stop()


# ---- the entry point ----


def _cmd(args):
    out = io.StringIO()
    return cmd_trace.main(args, out=out), out.getvalue()


def test_cmd_trace_end_to_end(tmp_path):
    d = str(tmp_path / "journal")
    rc, text = _cmd(["record", "--dir", d, "--tasks", "64", "--nodes", "16", "--cycles", "2",
                     "--snapshot-every", "1", "--executor", "auto", "--device", "cpu"])
    assert rc == 0, text
    assert "recorded 2 cycle(s)" in text and "[snapshot]" in text
    assert trace.get_recorder().enabled is False  # the previous recorder is back

    for executor in ("torch-scan", "native", "cuda"):
        rc, text = _cmd(["replay", "--dir", d, "--executor", executor, "--device", "cpu"])
        assert rc == 0 and "IDENTICAL" in text, text

    rc, text = _cmd(["diff", "--dir", d, "--cycle", "0", "--executor", "native"])
    assert rc == 0, text

    out_file = str(tmp_path / "chrome.json")
    rc, text = _cmd(["export", "--dir", d, "--out", out_file])
    assert rc == 0 and "wrote Chrome trace" in text
    obj = json.loads(open(out_file).read())
    assert obj["metadata"]["cycle"] == 1
    assert {"kernel:execute", "dispatch:allocate", "cycle-summary"} <= {
        e["name"] for e in obj["traceEvents"]}

    rc, text = _cmd(["export", "--dir", d, "--dir", d])
    assert rc == 0 and json.loads(text)["metadata"]["processes"] == 2


def test_cmd_trace_diff_reports_perturbation_and_explain(tmp_path):
    d = str(tmp_path / "journal")
    rc, _ = _cmd(["record", "--dir", d, "--tasks", "64", "--nodes", "16",
                  "--executor", "native"])
    assert rc == 0
    journal = Journal(d)
    snap, extras = journal.read_snapshot(0)
    tampered = np.asarray(extras["assignment"], dtype=np.int32).copy()
    tampered[0] = (tampered[0] + 1) % snap.n_nodes
    journal.write_snapshot(0, snap, tampered, executor="native")
    record = journal.read_cycle(0)
    record["events"].append({"name": "explain-summary", "cat": "action", "ph": "i", "ts": 0.0,
                             "args": {"tasks": 2, "reasons": {"Insufficient cpu": 2}}})
    journal.write_cycle(record)

    rc, text = _cmd(["diff", "--dir", d, "--executor", "torch-scan", "--device", "cpu"])
    assert rc == 1
    assert "task[0]: recorded node" in text and "1 DIFFS" in text
    assert "explain[explain-summary]: 2 task(s) unschedulable" in text
    rc, text = _cmd(["replay", "--dir", d, "--executor", "torch-scan", "--device", "cpu"])
    assert rc == 1


# ---- the sidecar route ----


@pytest.fixture
def sidecar():
    """The port's compute-plane server on the CPU, its socket under a
    short temporary directory; the executor pointed at it, all undone
    after."""
    import os
    import shutil
    import tempfile

    from volcano_tpu_torch import faults
    from volcano_tpu_torch.ops import executor
    from volcano_tpu_torch.serving import compute_plane as cp

    d = tempfile.mkdtemp(prefix="vtr", dir="/tmp")
    path = os.path.join(d, "cp.sock")
    server = cp.ComputePlaneServer(path, device="cpu").start()
    try:
        executor.configure(path)
        yield path
    finally:
        executor.configure(None)
        server.stop()
        cp._session_store = cp._SessionStore()
        faults.reset_breakers()
        shutil.rmtree(d, ignore_errors=True)


def test_sidecar_cycle_is_captured_as_auto_and_spans_recorded(tmp_path, sidecar):
    """gpu-allocate through a sidecar: the capture is labelled ``auto``
    (the executor that really ran) and replays with zero diff; the
    executor's remote span is recorded; a dead sidecar records the
    fallback event and the compute-plane breaker opening."""
    import os

    from volcano_tpu_torch.ops import executor
    from volcano_tpu_torch.ops.synthetic import generate_preempt_packed

    rec = trace.enable(str(tmp_path / "journal"), snapshot_every=1)
    loop = Loop(True, tmp_path)
    loop.feed(next(churn_script(Store())))
    binds, _ = loop.cycle()
    assert len(binds) == 5
    record = rec.last_cycle()
    names = [e["name"] for e in record["events"]]
    # the server runs in this process, so its dispatch records here too
    assert names.index("dispatch:allocate") < names.index("executor:remote-allocate")
    _, extras = Journal(str(tmp_path / "journal")).read_snapshot(record["cycle"])
    assert extras["executor"] == "auto"
    assert verify(str(tmp_path / "journal"), executor="auto", device="cpu").match

    rec.begin_cycle()
    executor.execute_preempt(generate_preempt_packed(n_victims=90, n_nodes=10,
                                                     n_preemptors=16, seed=2), device="cpu")
    executor._get_remote().client.close()
    os.unlink(sidecar)  # the sidecar no longer answers
    executor.execute_allocate(generate_snapshot(n_tasks=32, n_nodes=8, gang_size=4),
                              device="cpu")
    rec.end_cycle()
    events = [(e["name"], e["ph"]) for e in rec.last_cycle()["events"]]
    assert ("executor:remote-preempt", "X") in events
    assert ("executor:remote-fallback", "i") in events
    assert ("breaker:compute-plane:open", "i") in events
    # the session after the fallback ran on the in-process route
    assert events.index(("dispatch:allocate", "i")) > events.index(
        ("executor:remote-fallback", "i"))
