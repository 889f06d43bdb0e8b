"""The port's serving port against the JAX package's, on the CPU.

``serving/http.ServingServer``: /healthz (ok, 503 from ``health_check``,
"degraded: …" while a breaker is open), the /metrics scrape after a
scheduler cycle, /debug/stacks and the loopback/``debug_enabled`` gate
of the forensics endpoints, /trace/last answering 404 with tracing off
(the recorded cycle: ``tests/test_torch_trace.py``) — ``tests/test_serving.py``'s surface without leader
election.  ``metrics.Registry.render()`` prints the JAX package's text
for the same calls.  After the same cycle on ``tests/test_explain.py``'s
sessions, ``explain_jobs`` and the /explain JSON are the JAX package's,
byte for byte, with and without plane retention; the cache's
``unschedulable_digest`` equals the JAX cache's after
``close_session``; and ``explain=False`` / ``VTPU_NO_EXPLAIN`` turn the
device explanations off as in the JAX package.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request

import pytest
import torch

import tests.test_explain as ref_explain
import volcano_tpu.actions  # noqa: F401 — registers the JAX package's actions
import volcano_tpu_torch.actions  # noqa: F401 — registers the port's actions
from volcano_tpu import trace as jax_trace
from volcano_tpu.actions.jax_allocate import JaxAllocateAction
from volcano_tpu.metrics import metrics as jax_metrics
from volcano_tpu.ops import explain as jax_explain
from volcano_tpu.serving.explain import explain_jobs as jax_explain_jobs
from volcano_tpu.serving.http import ServingServer as JaxServingServer
from volcano_tpu_torch import faults, metrics, trace
from volcano_tpu_torch.actions.gpu_allocate import GpuAllocateAction
from volcano_tpu_torch.framework import get_action, register_action
from volcano_tpu_torch.ops import explain
from volcano_tpu_torch.scheduler.scheduler import Scheduler
from volcano_tpu_torch.serving import ServingServer
from volcano_tpu_torch.serving.explain import explain_jobs
from volcano_tpu_torch.serving.http import debug_allowed

from tests.builders import build_node, build_pod, build_pod_group, build_queue
from tests.test_torch_explain import _capture, _writeback, EXPLAIN_CASES
from tests.test_torch_preempt_cycle import Case, KINDS


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
    """The port's breakers and both packages' explain surfaces and cycle
    ids as they were."""
    cycle = jax_trace.current_cycle()
    yield
    faults.reset_breakers()
    explain.set_last_explain(None)
    jax_explain.set_last_explain(None)
    jax_trace.set_current_cycle(cycle)
    trace.set_current_cycle(-1)


@pytest.fixture
def serve():
    """A factory of started servers of either package, each stopped at
    the end."""
    started = []

    def make(cls=ServingServer, **kwargs):
        started.append(cls(port=0, **kwargs).start())
        return started[-1]

    try:
        yield make
    finally:
        for server in started:
            server.stop()


def _get(port: int, path: str):
    """(status, body) of GET ``path``."""
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        try:
            return e.code, e.read()
        finally:
            e.close()


# ---- /healthz, /metrics, /debug/stacks (tests/test_serving.py) ----


def test_healthz_ok_unhealthy_and_degraded(serve):
    srv = serve()
    assert _get(srv.port, "/healthz") == (200, b"ok")
    for _ in range(3):
        faults.get_breaker("cuda", failure_threshold=3).record_failure("launch failed")
    status, body = _get(srv.port, "/healthz")
    assert status == 200 and body.startswith(b"degraded: ")
    assert b"cuda" in body and b"launch failed" in body
    faults.get_breaker("cuda").record_success()
    assert _get(srv.port, "/healthz") == (200, b"ok")
    sick = serve(health_check=lambda: False)
    assert _get(sick.port, "/healthz") == (503, b"unhealthy")
    assert _get(srv.port, "/nothing-here")[0] == 404


def test_metrics_scrape_after_a_cycle(serve):
    """A scheduler cycle of the port, then a real counter scraped over
    HTTP."""
    kept = get_action("gpu-allocate")
    register_action(GpuAllocateAction(device="cpu"))
    try:
        Scheduler(_writeback().port_cache()).run_once()
    finally:
        register_action(kept)
    srv = serve()
    status, body = _get(srv.port, "/metrics")
    assert status == 200
    lines = body.decode().splitlines()
    count = [ln for ln in lines
             if ln.startswith("volcano_e2e_scheduling_latency_milliseconds_count")]
    assert count and float(count[0].split()[-1]) > 0
    assert any(ln.startswith("volcano_session_scope_total") for ln in lines)


def test_debug_stacks_endpoint(serve):
    srv = serve()
    status, body = _get(srv.port, "/debug/stacks")
    assert status == 200 and b"MainThread" in body and b"---" in body


def test_debug_stacks_gating():
    assert debug_allowed(False, "127.0.0.1")
    assert debug_allowed(False, "::1")
    assert not debug_allowed(False, "10.1.2.3")
    assert debug_allowed(True, "10.1.2.3")


def test_trace_last_answers_404_as_the_reference_with_tracing_off(serve):
    got = _get(serve().port, "/trace/last")
    want = _get(serve(JaxServingServer).port, "/trace/last")
    assert got == want == (404, b"no recorded cycle (is tracing enabled?)")


def test_explain_404_without_source(serve):
    assert _get(serve().port, "/explain")[0] == 404


# ---- render() (the /metrics text) ----


def _same_calls(m) -> None:
    """One sequence of calls of the families both packages register."""
    m.update_kernel_duration("pack", 0.012)
    m.update_kernel_duration("execute", 0.3)
    m.update_kernel_duration("execute", 7.5)
    m.update_action_duration("gpu-allocate" if m is metrics else "jax-allocate", 0.2)
    m.update_action_duration("enqueue", 0.00004)
    m.update_e2e_duration(1.5)
    m.update_plugin_duration("drf", 0.000013)
    m.update_task_schedule_duration(0.0001)
    m.update_job_schedule_duration(3.0)
    m.register_session_scope("full")
    m.register_schedule_attempt("scheduled")
    m.register_schedule_attempt("unschedulable")
    m.update_pod_schedule_status("successes", 12)
    m.update_preemption_victims_count(3)
    m.register_preemption_attempts()
    m.update_explain_duration(0.004)
    m.register_commit_failure("bind")
    m.update_unschedule_task_count("ns/pg1", 2)
    m.update_unschedule_job_count(1)
    m.register_job_retries("ns/pg1")
    m.register_unschedulable_reason("node(s) were unschedulable", 2)
    m.register_unschedulable_reason("pvc ns/x not found")
    m.update_circuit_breaker_state("compute-plane", 1.0)
    m.register_fault_injected("compute.crash")
    m.register_executor_fallback("remote", "local", "error")
    m.register_executor_fallback("remote", "local", "error")


def test_render_is_the_references(monkeypatch):
    monkeypatch.setattr(metrics, "registry", metrics.Registry())
    monkeypatch.setattr(jax_metrics, "registry", jax_metrics._Registry())
    _same_calls(metrics)
    _same_calls(jax_metrics)
    got = metrics.registry.render()
    want = jax_metrics.registry.render()
    # the action label names each package's action; the rest is equal
    assert got == want.replace("jax-allocate", "gpu-allocate")
    assert 'volcano_executor_fallbacks_total{cause="error",from="remote",to="local"} 2.0' \
        in got.splitlines()
    assert metrics.registry.histogram("volcano_tpu_kernel_latency_milliseconds",
                                      phase="execute") == (2, 7800.0)


def test_render_empty_registry():
    assert metrics.Registry().render() == jax_metrics._Registry().render() == "\n"


# ---- /explain after the same cycle in both packages ----


def _cycle(case, action, jax: bool):
    """One cycle with ``action`` on a fresh cache of the case; the cache."""
    return _capture(case, [action], jax)[1]


def _mixed():
    return Case(dict(zip(KINDS, ref_explain._mixed_reason_objects())))


@pytest.mark.parametrize("planes", [False, True])
@pytest.mark.parametrize("make", [_writeback, _mixed], ids=["writeback", "mixed-reasons"])
def test_explain_json_is_the_references(serve, make, planes):
    """explain_jobs and GET /explain (the whole body, and narrowed to a
    namespace and a job) equal the JAX package's after the same cycle;
    with plane retention the per-node attribution rides along."""
    case = make()
    jax_trace.set_current_cycle(7)
    trace.set_current_cycle(7)
    jax_cache = _cycle(case, JaxAllocateAction(explain=True, explain_planes=planes), jax=True)
    cache = _cycle(case, GpuAllocateAction(device="cpu", explain_planes=planes), jax=False)
    want = jax_explain_jobs(jax_cache)
    got = explain_jobs(cache)
    assert got == want and got["jobs"] and got["last_cycle"]["cycle"] == 7
    task = got["jobs"][0]["unschedulable"][0]
    assert ("nodes" in task) == planes
    assert explain.last_explain() == jax_explain.last_explain()

    port_srv = serve(explain_source=lambda ns, job: explain_jobs(cache, ns, job))
    jax_srv = serve(JaxServingServer,
                    explain_source=lambda ns, job: jax_explain_jobs(jax_cache, ns, job))
    name = got["jobs"][0]["name"]
    for path in ("/explain", f"/explain?namespace=ns&job={name}", "/explain?job=missing",
                 "/explain?namespace=other"):
        assert _get(port_srv.port, path) == _get(jax_srv.port, path), path
    status, body = _get(port_srv.port, "/explain")
    assert status == 200 and json.loads(body) == got
    assert _get(port_srv.port, "/explain?job=missing")[0] == 404


def test_explain_surface_cleared_by_a_placed_cycle():
    """A cycle that explains nothing clears the surface, as in the JAX
    package — also one with nothing pending."""
    _cycle(_writeback(), GpuAllocateAction(device="cpu"), jax=False)
    assert explain.last_explain() is not None
    easy = Case(dict(
        nodes=[build_node("n1", {"cpu": "8", "memory": "8Gi"})],
        pods=[build_pod("ns", "easy-0", "", {"cpu": "1", "memory": "1Gi"}, group="pg1")],
        pod_groups=[build_pod_group("ns", "pg1", 1, queue="q1")],
        queues=[build_queue("q1", weight=1)]))
    cache = _cycle(easy, GpuAllocateAction(device="cpu"), jax=False)
    assert explain.last_explain() is None and cache.binder.binds
    _cycle(_writeback(), GpuAllocateAction(device="cpu"), jax=False)
    _cycle(Case(dict(nodes=[build_node("n1", {"cpu": "8", "memory": "8Gi"})],
                     queues=[build_queue("q1", weight=1)])),
           GpuAllocateAction(device="cpu"), jax=False)
    assert explain.last_explain() is None


@pytest.mark.parametrize("name", sorted(EXPLAIN_CASES))
def test_unschedulable_digest_is_the_references(name):
    """After close_session the cache's digest equals the JAX cache's,
    job for job and task for task."""
    case = EXPLAIN_CASES[name][0]()
    jax_cache = _cycle(case, JaxAllocateAction(explain=True), jax=True)
    cache = _cycle(case, GpuAllocateAction(device="cpu"), jax=False)
    assert cache.unschedulable_digest and \
        cache.unschedulable_digest == jax_cache.unschedulable_digest


def test_digest_dropped_when_the_job_goes():
    case = _writeback()
    cache = _cycle(case, GpuAllocateAction(device="cpu"), jax=False)
    assert set(cache.unschedulable_digest) == {"ns/pg1"}
    job = cache.jobs["ns/pg1"]
    for task in list(job.tasks.values()):
        cache.delete_pod(task.pod)
    cache.delete_pod_group(job.pod_group)
    assert cache.unschedulable_digest == {}


# ---- the explain switches ----


def _fit_errors(case, action, jax: bool):
    """(namespace/name → (message, synthesized from device counts))."""
    return _capture(case, [action], jax)[0]


@pytest.mark.parametrize("how", ["argument", "environment"])
def test_explain_off(monkeypatch, how):
    """explain=False or VTPU_NO_EXPLAIN: the host sweep records the
    messages, nothing is synthesized or published, as in the JAX
    package; the argument overrides the variable."""
    if how == "environment":
        monkeypatch.setenv("VTPU_NO_EXPLAIN", "1")
        action, jax_action = GpuAllocateAction(device="cpu"), JaxAllocateAction()
        assert not action.explain and GpuAllocateAction(device="cpu", explain=True).explain
    else:
        action = GpuAllocateAction(device="cpu", explain=False)
        jax_action = JaxAllocateAction(explain=False)
    case = _mixed()
    got = _fit_errors(case, action, jax=False)
    assert got == _fit_errors(case, jax_action, jax=True)
    assert got and not any(synth for _, synth in got.values())
    assert action.last_phase_stats["explained"] == 0 and "explain_ms" not in \
        action.last_phase_stats
    assert explain.last_explain() is None


def test_explain_planes_from_the_environment(monkeypatch):
    monkeypatch.setenv("VTPU_EXPLAIN_PLANES", "1")
    assert GpuAllocateAction(device="cpu").explain_planes
    assert not GpuAllocateAction(device="cpu", explain_planes=False).explain_planes
    monkeypatch.delenv("VTPU_EXPLAIN_PLANES")
    assert not GpuAllocateAction(device="cpu").explain_planes


def test_no_victim_synthesis_honours_no_explain(monkeypatch):
    from tests.test_torch_preempt_cycle import PREEMPT_CASES
    from volcano_tpu_torch.actions.gpu_preempt import GpuPreemptAction

    monkeypatch.setenv("VTPU_NO_EXPLAIN", "1")
    got = _fit_errors(PREEMPT_CASES["explain-no-victim"](), GpuPreemptAction(device="cpu"),
                      jax=False)
    assert not any(synth for _, synth in got.values())
