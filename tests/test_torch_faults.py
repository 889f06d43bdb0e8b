"""The port's fault plane, circuit breakers, cycle watchdog and the
dispatcher's failure handling (volcano_tpu_torch/faults, ops/dispatch.py),
on the CPU: ports of tests/test_faults.py's TestFaultSpec,
TestCircuitBreaker and TestWatchdog; its TestDispatchDegradation as the
port's failure tests (where the reference demotes a failing kernel to a
lower rung, the port raises ``ExecutorFailed`` and runs nothing in its
place); the preempt breaker; and the executor choice for GPU sessions,
asked with ``device="cuda"`` (the choice reads only the device's type).

The failure tests force the ``cuda`` executor by monkeypatching
``select_executor``; on the CPU ``run_packed_cuda`` runs the kernel's
plain version, so a session that succeeds is held bit for bit against
the JAX package's ``run_packed``."""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from volcano_tpu.ops.kernels import run_packed as jax_run_packed
from volcano_tpu.ops.synthetic import generate_snapshot as jax_generate_snapshot
from volcano_tpu_torch import faults, metrics
from volcano_tpu_torch.faults.breaker import CircuitBreaker, CLOSED, HALF_OPEN, OPEN
from volcano_tpu_torch.faults.watchdog import CycleDeadlineExceeded
from volcano_tpu_torch.ops import dispatch, kernels, preempt_kernel, preempt_pack, session_kernel
from volcano_tpu_torch.ops.dispatch import ExecutorFailed
from volcano_tpu_torch.ops.synthetic import (
    add_scalar_lanes,
    generate_preempt_packed,
    generate_snapshot,
)
from tests.test_torch_kernels import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _clean_faults():
    """Every test starts and ends with the plane disabled and the breaker
    registry empty: faults are process-global state."""
    faults.configure(None)
    faults.reset_breakers()
    faults.configure_deadline(None)
    yield
    faults.configure(None)
    faults.reset_breakers()
    faults.configure_deadline(None)


def _counter(name, **labels):
    return metrics.registry.counter(f"volcano_{name}", **labels)


def _failures(executor="cuda", cause="error"):
    return _counter("executor_failures_total", executor=executor, cause=cause)


# ---- spec parser ----


class TestFaultSpec:
    def test_round_trip(self):
        spec = faults.parse_faults(
            "seed=42;bus.disconnect=0.05;compute.crash=0.1:count=2;"
            "device.slow=1:ms=50:after=3"
        )
        assert spec.seed == 42
        assert spec.rules["bus.disconnect"].probability == 0.05
        assert spec.rules["compute.crash"].count == 2
        assert spec.rules["device.slow"].ms == 50.0
        assert spec.rules["device.slow"].after == 3
        assert faults.parse_faults(spec.format()) == spec

    def test_round_trip_is_fixpoint(self):
        spec = faults.parse_faults("seed=7;cache.bind_fail=0.25:count=10")
        assert faults.parse_faults(spec.format()).format() == spec.format()

    def test_empty_spec(self):
        spec = faults.parse_faults("")
        assert spec.seed == 0 and not spec.rules

    @pytest.mark.parametrize("bad", [
        "bogus",
        "p=1.5",
        "p=-0.1",
        "p=0.5:count=-1",
        "p=0.5:unknown=3",
        "p=0.5:count",
        "seed=x",
        "seed=42:count=2",
        "seed=42:bus.disconnect=0.05",
        "a=0.5;a=0.6",
    ])
    def test_malformed_rejected(self, bad):
        with pytest.raises(ValueError):
            faults.parse_faults(bad)

    def test_deterministic_across_planes(self):
        spec = "seed=99;x.y=0.3;a.b=0.7"
        p1 = faults.FaultPlane(faults.parse_faults(spec))
        p2 = faults.FaultPlane(faults.parse_faults(spec))
        s1 = [p1.should("x.y") for _ in range(50)]
        # interleave another point's evaluations on the second plane:
        # per-point streams are independent, so x.y must not shift
        s2 = []
        for _ in range(50):
            p2.should("a.b")
            s2.append(p2.should("x.y"))
        assert s1 == s2
        assert any(s1) and not all(s1)

    def test_streams_equal_the_jax_package(self):
        """The same spec fires at the same evaluations in both packages."""
        from volcano_tpu import faults as jax_faults

        spec = "seed=5;device.lowering=0.4;device.nan=0.2:after=3:count=4"
        ours = faults.FaultPlane(faults.parse_faults(spec))
        theirs = jax_faults.FaultPlane(jax_faults.parse_faults(spec))
        for point in ("device.lowering", "device.nan", "device.lowering", "device.slow") * 20:
            assert ours.should(point) == theirs.should(point)
        assert ours.fired() == theirs.fired()

    def test_count_and_after(self):
        plane = faults.FaultPlane(faults.parse_faults("seed=1;p.q=1:count=2:after=3"))
        fires = [plane.should("p.q") for _ in range(10)]
        assert fires == [False] * 3 + [True, True] + [False] * 5
        assert plane.fired() == {"p.q": 2}

    def test_unknown_point_never_fires(self):
        plane = faults.FaultPlane(faults.parse_faults("seed=1;p.q=1"))
        assert plane.should("other.point") is False

    def test_configure_installs_and_clears(self):
        faults.configure("seed=3;x.x=1")
        assert faults.get_plane().enabled
        assert faults.get_plane().should("x.x")
        faults.configure(None)
        assert not faults.get_plane().enabled

    def test_firing_counts_metric(self):
        before = _counter("faults_injected_total", point="m.n")
        faults.configure("seed=1;m.n=1")
        faults.get_plane().should("m.n")
        assert _counter("faults_injected_total", point="m.n") == before + 1


# ---- circuit breaker ----


class TestCircuitBreaker:
    def test_trips_after_threshold(self):
        br = CircuitBreaker("t", failure_threshold=3, cooldown_s=60)
        assert br.state == CLOSED
        br.record_failure("e1")
        br.record_failure("e2")
        assert br.state == CLOSED and br.allow()
        br.record_failure("e3")
        assert br.state == OPEN
        assert not br.allow()

    def test_success_resets_failure_count(self):
        br = CircuitBreaker("t", failure_threshold=2, cooldown_s=60)
        br.record_failure("e")
        br.record_success()
        br.record_failure("e")
        assert br.state == CLOSED  # the streak was broken

    def test_half_open_single_probe_then_promote(self):
        br = CircuitBreaker("t", failure_threshold=1, cooldown_s=0.05)
        br.record_failure("down")
        assert not br.allow()
        time.sleep(0.06)
        assert br.allow()  # the one half-open probe
        assert br.state == HALF_OPEN
        assert not br.allow()  # everyone else keeps falling back
        br.record_success()
        assert br.state == CLOSED and br.allow()

    def test_half_open_failure_reopens(self):
        br = CircuitBreaker("t", failure_threshold=1, cooldown_s=0.05)
        br.record_failure("down")
        time.sleep(0.06)
        assert br.allow()
        br.record_failure("still down")
        assert br.state == OPEN
        assert not br.allow()  # cooldown restarted

    def test_registry_and_degraded_reasons(self):
        br = faults.get_breaker("exec-a", failure_threshold=1)
        assert faults.get_breaker("exec-a") is br
        assert faults.degraded_reasons() == []
        br.record_failure("kaboom")
        reasons = faults.degraded_reasons()
        assert len(reasons) == 1
        assert "exec-a" in reasons[0] and "kaboom" in reasons[0]

    def test_degraded_reasons_show_a_streak_below_the_threshold(self):
        """A failure that demoted its executor shows until a success,
        though the breaker is still closed."""
        br = faults.get_breaker("exec-s", failure_threshold=3)
        br.record_failure("launch failed")
        assert br.state == CLOSED
        (reason,) = faults.degraded_reasons()
        assert "exec-s closed after 1" in reason and "launch failed" in reason
        br.record_success()
        assert faults.degraded_reasons() == []

    def test_state_gauge(self):
        br = faults.get_breaker("exec-g", failure_threshold=1)
        br.record_failure("x")
        assert metrics.registry.gauge("volcano_circuit_breaker_open", executor="exec-g") == 1.0
        br.record_success()
        assert metrics.registry.gauge("volcano_circuit_breaker_open", executor="exec-g") == 0.0


# ---- cycle watchdog ----


class TestWatchdog:
    def test_disabled_runs_inline(self):
        tid = {}
        out = faults.run_with_deadline(
            lambda: tid.setdefault("t", threading.get_ident()) and 41 + 1, None, "test",
        )
        assert out == 42 and tid["t"] == threading.get_ident()

    def test_result_and_exception_passthrough(self):
        assert faults.run_with_deadline(lambda: "ok", 5.0, "t") == "ok"
        with pytest.raises(KeyError):
            faults.run_with_deadline(lambda: (_ for _ in ()).throw(KeyError("boom")), 5.0, "t")

    def test_overrun_raises(self):
        with pytest.raises(CycleDeadlineExceeded):
            faults.run_with_deadline(lambda: time.sleep(1.0), 0.05, "t")

    def test_exhausted_budget_raises_immediately(self):
        with pytest.raises(CycleDeadlineExceeded):
            faults.run_with_deadline(lambda: "never", 0.0, "t")

    def test_cycle_budget_accounting(self):
        faults.configure_deadline(100.0)  # 100 ms
        faults.begin_cycle()
        r1 = faults.remaining_s()
        assert r1 is not None and 0 < r1 <= 0.1
        time.sleep(0.03)
        r2 = faults.remaining_s()
        assert r2 < r1
        faults.configure_deadline(None)
        assert faults.remaining_s() is None


# ---- the dispatcher's failure handling ----

SMALL = dict(n_tasks=48, n_nodes=12, gang_size=4, seed=1)


def _reference():
    return np.asarray(jax_run_packed(jax_generate_snapshot(**SMALL)))


def _nothing_else_runs(monkeypatch):
    """Record any call of a formulation that could stand in for the
    kernel: none may run."""
    ran = []
    for mod, name in ((kernels, "run_packed"), (dispatch, "run_packed"),
                      (preempt_pack, "preempt_dense"), (dispatch, "preempt_dense")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **k: ran.append(_n))
    return ran


class TestDispatchFailures:
    def _force_cuda(self, monkeypatch):
        monkeypatch.setattr(dispatch, "select_executor",
                            lambda snap, weights=None, device=None: "cuda")

    def test_injected_lowering_failure_raises_and_counts(self, monkeypatch):
        snap = generate_snapshot(**SMALL)
        self._force_cuda(monkeypatch)
        faults.configure("seed=1;device.lowering=1:count=1")
        before = _failures()
        with pytest.raises(ExecutorFailed, match="lowering") as e:
            dispatch.run_packed_auto(snap, device="cpu")
        assert (e.value.executor, e.value.cause) == ("cuda", "error")
        assert dispatch.last_executor() == "cuda"
        assert _failures() == before + 1
        assert faults.get_breaker("cuda").state == CLOSED  # 1 < threshold
        assert any("cuda" in r for r in faults.degraded_reasons())
        # the next session succeeds on the kernel and clears the streak
        np.testing.assert_array_equal(dispatch.run_packed_auto(snap, device="cpu"),
                                      _reference())
        assert dispatch.last_executor() == "cuda" and faults.degraded_reasons() == []

    def test_breaker_trips_and_refuses_without_launching(self, monkeypatch):
        snap = generate_snapshot(**SMALL)
        self._force_cuda(monkeypatch)
        faults.configure("seed=1;device.lowering=1:count=3")
        for _ in range(3):
            with pytest.raises(ExecutorFailed):
                dispatch.run_packed_auto(snap, device="cpu")
        assert faults.get_breaker("cuda").state == OPEN
        # 4th call: refused WITHOUT an attempt (the injection budget is
        # spent, so an attempt would succeed), and nothing else runs
        attempts = []
        monkeypatch.setattr(session_kernel, "run_packed_cuda",
                            lambda *a, **k: attempts.append(1))
        ran = _nothing_else_runs(monkeypatch)
        before = _failures(cause="circuit-open")
        with pytest.raises(ExecutorFailed, match="circuit-open") as e:
            dispatch.run_packed_auto(snap, device="cpu")
        assert e.value.cause == "circuit-open"
        assert _failures(cause="circuit-open") == before + 1
        assert attempts == [] and ran == []
        assert faults.degraded_reasons()

    def test_half_open_probe_closes_the_breaker(self, monkeypatch):
        """Past the cooldown one probe is let through; its success closes
        the breaker and the session is the kernel's."""
        snap = generate_snapshot(**SMALL)
        self._force_cuda(monkeypatch)
        br = faults.get_breaker("cuda", failure_threshold=3, cooldown_s=0.05)
        faults.configure("seed=1;device.lowering=1:count=3")
        for _ in range(3):
            with pytest.raises(ExecutorFailed):
                dispatch.run_packed_auto(snap, device="cpu")
        assert br.state == OPEN
        time.sleep(0.06)
        np.testing.assert_array_equal(dispatch.run_packed_auto(snap, device="cpu"),
                                      _reference())
        assert br.state == CLOSED and faults.degraded_reasons() == []

    def test_corrupt_output_caught_by_validity_gate(self, monkeypatch):
        snap = generate_snapshot(**SMALL)
        self._force_cuda(monkeypatch)
        # the kernel "succeeds" but its output is garbage
        monkeypatch.setattr(
            session_kernel, "run_packed_cuda",
            lambda s, weights=None, gang_rounds=3, device=None, discard_unstable=False:
            np.full(s.n_tasks, s.n_nodes, dtype=np.int32),
        )
        ran = _nothing_else_runs(monkeypatch)
        before = _failures(cause="corrupt-output")
        with pytest.raises(ExecutorFailed, match="corrupt-output"):
            dispatch.run_packed_auto(snap, device="cpu")
        assert _failures(cause="corrupt-output") == before + 1 and ran == []

    def test_injected_nan_caught_by_validity_gate(self, monkeypatch):
        snap = generate_snapshot(**SMALL)
        self._force_cuda(monkeypatch)
        faults.configure("seed=1;device.nan=1:count=1")
        before = _failures(cause="corrupt-output")
        with pytest.raises(ExecutorFailed, match="corrupt-output"):
            dispatch.run_packed_auto(snap, device="cpu")
        assert _failures(cause="corrupt-output") == before + 1
        assert dispatch.last_executor() == "cuda"

    def test_assignment_validity_gate(self):
        snap = generate_snapshot(**SMALL)
        good = np.full(snap.task_resreq.shape[0], -1, dtype=np.int32)
        assert dispatch._assignment_valid(snap, good)
        bad = good.copy()
        bad[0] = snap.n_nodes  # out of range
        assert not dispatch._assignment_valid(snap, bad)
        assert not dispatch._assignment_valid(snap, good[:2])  # truncated
        assert not dispatch._assignment_valid(snap, np.zeros((4, 4)))  # wrong rank

    def test_abandoned_worker_skips_state_writes(self, monkeypatch):
        """A session the watchdog abandoned must not, when it finally
        fails, record a breaker verdict or count a failure."""
        snap = generate_snapshot(**SMALL)
        self._force_cuda(monkeypatch)

        def slow_then_fail(s, weights=None, gang_rounds=3, device=None, discard_unstable=False):
            time.sleep(0.2)
            raise RuntimeError("late launch failure")

        monkeypatch.setattr(session_kernel, "run_packed_cuda", slow_then_fail)
        ran = _nothing_else_runs(monkeypatch)
        before = _failures()
        with pytest.raises(CycleDeadlineExceeded):
            faults.run_with_deadline(lambda: dispatch.run_packed_auto(snap, device="cpu"),
                                     0.05, "t")
        time.sleep(0.3)  # let the abandoned worker hit its failure
        assert ran == []
        assert faults.get_breaker("cuda").state == CLOSED
        assert _failures() == before

    def test_device_slow_injects_latency(self, monkeypatch):
        snap = generate_snapshot(**SMALL)
        self._force_cuda(monkeypatch)
        baseline = dispatch.run_packed_auto(snap, device="cpu")
        faults.configure("seed=1;device.slow=1:count=1:ms=120")
        t0 = time.monotonic()
        out = dispatch.run_packed_auto(snap, device="cpu")
        assert time.monotonic() - t0 >= 0.12
        np.testing.assert_array_equal(out, baseline)

    def test_gang_discard_unstable_runs_on_the_kernel(self, monkeypatch):
        """``VTPU_GANG_DISCARD_UNSTABLE=1`` keeps the session on the
        kernel, whose gang rounds run to the fixpoint: equal to the JAX
        package's run_packed with the same option."""
        kwargs = dict(n_tasks=400, n_nodes=16, gang_size=5, seed=4, node_cpu_milli=16_000,
                      node_mem_mib=32_768)
        snap = generate_snapshot(**kwargs)
        self._force_cuda(monkeypatch)
        monkeypatch.setenv("VTPU_GANG_DISCARD_UNSTABLE", "1")
        assert dispatch.gang_discard_unstable()
        out = dispatch.run_packed_auto(snap, gang_rounds=1, device="cpu")
        assert dispatch.last_executor() == "cuda"
        np.testing.assert_array_equal(out, np.asarray(jax_run_packed(
            jax_generate_snapshot(**kwargs), gang_rounds=1, discard_unstable=True)))
        assert faults.degraded_reasons() == []
        monkeypatch.setenv("VTPU_GANG_DISCARD_UNSTABLE", "off")
        assert not dispatch.gang_discard_unstable()
        np.testing.assert_array_equal(
            dispatch.run_packed_auto(snap, gang_rounds=1, device="cpu"),
            np.asarray(jax_run_packed(jax_generate_snapshot(**kwargs), gang_rounds=1)))

    def test_failed_build_raises_and_counts_nothing(self, monkeypatch):
        """A kernel library that does not build fails the session before
        the breaker is asked: nothing is counted, nothing runs."""
        def broken_build():
            raise RuntimeError("nvcc failed (exit 1)")

        monkeypatch.setattr(session_kernel, "load_library", broken_build)
        monkeypatch.setattr(session_kernel, "run_packed_cuda", lambda *a, **k: ran.append(1))
        ran = _nothing_else_runs(monkeypatch)
        snap = generate_snapshot(**SMALL)
        before = _failures(), _failures("preempt-cuda")
        with pytest.raises(RuntimeError, match="nvcc failed"):
            dispatch.run_packed_auto(snap, device="cuda")
        with pytest.raises(RuntimeError, match="nvcc failed"):
            dispatch.run_preempt_auto(generate_preempt_packed(
                n_victims=90, n_nodes=10, n_preemptors=16, seed=2), device="cuda")
        assert ran == [] and faults.degraded_reasons() == []
        assert (_failures(), _failures("preempt-cuda")) == before

    def test_failure_on_the_card_runs_nothing_in_its_place(self, monkeypatch):
        """A kernel failure on a ``cuda`` session raises: no formulation
        runs in the kernel's place, on the card or on the CPU."""
        monkeypatch.setattr(session_kernel, "load_library", lambda: None)
        ran = _nothing_else_runs(monkeypatch)
        faults.configure("seed=1;device.lowering=1:count=2")
        with pytest.raises(ExecutorFailed):
            dispatch.run_packed_auto(generate_snapshot(**SMALL), device="cuda")
        with pytest.raises(ExecutorFailed):
            dispatch.run_preempt_auto(generate_preempt_packed(**PREEMPT), device="cuda")
        assert ran == [] and dispatch.last_executor() == "cuda"
        assert dispatch.last_preempt_executor() == "cuda"


def test_warmup_runs_one_session_on_the_callers_device(monkeypatch):
    assert dispatch.warmup_kernels(n_tasks=64, n_nodes=16, device="cpu") == "torch-scan"
    assert dispatch.last_executor() == "torch-scan"
    monkeypatch.setattr(dispatch, "select_executor",
                        lambda snap, weights=None, device=None: "cuda")
    assert dispatch.warmup_kernels(n_tasks=64, n_nodes=16, device="cpu") == "cuda"
    assert dispatch.last_executor() == "cuda"


# ---- the preempt breaker ----

PREEMPT = dict(n_victims=300, n_nodes=64, n_preemptors=64, seed=0)


class TestPreemptFailures:
    def _force_cuda(self, monkeypatch):
        monkeypatch.setattr(dispatch, "select_preempt_executor",
                            lambda pk, device=None, weights=None: "cuda")

    def _reference(self):
        from volcano_tpu.ops.preempt_pack import preempt_dense as jax_preempt_dense
        from volcano_tpu.ops.synthetic import generate_preempt_packed as jax_generate

        return tuple(np.asarray(x) for x in jax_preempt_dense(jax_generate(**PREEMPT)))

    def test_injected_failure_raises_and_counts(self, monkeypatch):
        self._force_cuda(monkeypatch)
        faults.configure("seed=1;device.lowering=1:count=1")
        before = _failures("preempt-cuda")
        with pytest.raises(ExecutorFailed, match="lowering") as e:
            dispatch.run_preempt_auto(generate_preempt_packed(**PREEMPT), device="cpu")
        assert (e.value.executor, e.value.cause) == ("preempt-cuda", "error")
        assert dispatch.last_preempt_executor() == "cuda"
        assert _failures("preempt-cuda") == before + 1
        # without a fault the kernel's plain pass runs and agrees
        ev, pipe = dispatch.run_preempt_auto(generate_preempt_packed(**PREEMPT), device="cpu")
        want_ev, want_pipe = self._reference()
        assert dispatch.last_preempt_executor() == "cuda"
        np.testing.assert_array_equal(ev, want_ev)
        np.testing.assert_array_equal(pipe, want_pipe)

    def test_breaker_opens_after_three_failures(self, monkeypatch):
        self._force_cuda(monkeypatch)
        pk = generate_preempt_packed(**PREEMPT)
        faults.configure("seed=1;device.lowering=1:count=3")
        errors = _failures("preempt-cuda")
        opened = _failures("preempt-cuda", "circuit-open")
        for _ in range(3):
            with pytest.raises(ExecutorFailed):
                dispatch.run_preempt_auto(pk, device="cpu")
        assert faults.get_breaker("preempt-cuda").state == OPEN
        attempts = []
        monkeypatch.setattr(preempt_kernel, "run_preempt_cuda",
                            lambda *a, **k: attempts.append(1))
        ran = _nothing_else_runs(monkeypatch)
        with pytest.raises(ExecutorFailed, match="circuit-open"):
            dispatch.run_preempt_auto(pk, device="cpu")
        assert attempts == [] and ran == []
        assert _failures("preempt-cuda", "circuit-open") == opened + 1
        assert _failures("preempt-cuda") == errors + 3

    def test_corrupt_preempt_output_raises(self, monkeypatch):
        self._force_cuda(monkeypatch)
        pk = generate_preempt_packed(**PREEMPT)
        monkeypatch.setattr(preempt_kernel, "run_preempt_cuda", lambda p, weights=None,
                            device=None: (np.zeros(p.n_victims, dtype=bool),
                                          np.full(p.base.n_tasks, p.base.n_nodes, np.int32)))
        ran = _nothing_else_runs(monkeypatch)
        before = _failures("preempt-cuda", "corrupt-output")
        with pytest.raises(ExecutorFailed, match="corrupt-output"):
            dispatch.run_preempt_auto(pk, device="cpu")
        assert _failures("preempt-cuda", "corrupt-output") == before + 1 and ran == []

    def test_int_exact_weights_run_dense(self):
        from volcano_tpu_torch.ops.kernels import ScoreWeights

        pk = generate_preempt_packed(**PREEMPT)
        assert dispatch.select_preempt_executor(pk, device="cuda") == "cuda"
        assert dispatch.select_preempt_executor(
            pk, device="cuda", weights=ScoreWeights(lr_int_exact=True)) == "dense"


# ---- which executor, and which kernel layout, a GPU session gets ----

def _sized(n_nodes: int, lanes: int = 2, **kwargs):
    snap = generate_snapshot(n_tasks=32, n_nodes=n_nodes, gang_size=8, seed=3, **kwargs)
    return add_scalar_lanes(snap, lanes - 2, lanes) if lanes > 2 else snap


@pytest.mark.parametrize("name,snap_args,shared", [
    ("dgx-h100", (10_000, 2, dict(node_cpu_milli=224_000, node_mem_mib=2_097_152)), True),
    ("main", (10_000, 2, {}), True),
    ("20k-nodes", (20_000, 2, {}), False),
    ("10k-nodes-5-lanes", (10_000, 5, {}), False),
    ("9-lanes", (1_000, 9, {}), False),
    ("8-lanes", (1_000, 8, {}), True),
])
def test_select_executor_for_gpu_sessions(name, snap_args, shared):
    """Every GPU session goes to the kernel: its shared-memory layout, or
    the wide instance where the node state or the lane count is beyond
    it."""
    n_nodes, lanes, kwargs = snap_args
    snap = _sized(n_nodes, lanes, **kwargs)
    assert dispatch.select_executor(snap, device="cuda") == "cuda"
    assert dispatch.select_executor(snap, device="cpu") == "torch-scan"
    R = snap.task_resreq.shape[1]
    assert session_kernel.shared_layout(R, session_kernel.node_width(snap.n_nodes)) == shared


@pytest.mark.parametrize("lanes", [5, 9])
def test_many_lane_session_through_the_kernel_wrapper(lanes):
    """A session with scalar lanes through run_packed_cuda (the plain
    version on the CPU) equals the JAX package's run_packed."""
    from tests.test_torch_session_step import to_jax

    snap = _sized(40, lanes)
    got = session_kernel.run_packed_cuda(snap, device="cpu")
    np.testing.assert_array_equal(np.asarray(jax_run_packed(to_jax(snap))), got)
