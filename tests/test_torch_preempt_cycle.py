"""The port's preempting actions against the JAX package's on the CPU.

Every case is a session of the JAX package's own tests: the cluster
objects its case hands ``make_cache`` are captured (the case stops
there), carried across as dicts, and fed to a fresh cache of each
package.  Each cycle (open_session → actions → close_session) is held
against its counterpart for equality, never closeness: the evictions in
the order the evictor received them, the binds in order, the pipelined
placements read from the session before close, the fit-error messages,
the PodGroup statuses and pod conditions written at close, and the
preemption counters.  ``pack_preempt_session`` is held array for array.
``gpu-preempt`` runs with ``device="cpu"`` (the dense PyTorch
specification of the pass) against ``jax-preempt``; the JAX action's
host route is recorded, and must be taken exactly where the port's
gpu-preempt takes its own (pack refused, or relational predicates) —
never as a fallback from a diverging device result.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import fields

import numpy as np
import pytest
import torch

import chip_smoke
import tests.test_actions as ref_actions
import tests.test_explain as ref_explain
import tests.test_preempt_kernel as ref_preempt
import volcano_tpu.actions  # noqa: F401 — registers the JAX package's actions
import volcano_tpu.plugins  # noqa: F401 — registers its plugin builders
import volcano_tpu_torch.actions  # noqa: F401 — registers the port's actions
import volcano_tpu_torch.plugins  # noqa: F401 — registers its plugin builders
from volcano_tpu.actions import jax_preempt as jax_preempt_module
from volcano_tpu.actions.allocate import AllocateAction as JaxAllocate
from volcano_tpu.actions.backfill import BackfillAction as JaxBackfill
from volcano_tpu.actions.enqueue import EnqueueAction as JaxEnqueue
from volcano_tpu.actions.jax_allocate import JaxAllocateAction
from volcano_tpu.actions.jax_preempt import JaxPreemptAction
from volcano_tpu.actions.preempt import PreemptAction as JaxPreempt
from volcano_tpu.actions.reclaim import ReclaimAction as JaxReclaim
from volcano_tpu.api import TaskStatus as JaxTaskStatus
from volcano_tpu.apis import core as jax_core, scheduling as jax_scheduling, serde as jax_serde
from volcano_tpu.cache import SchedulerCache as JaxCache
from volcano_tpu.conf import (
    Configuration as JaxConfiguration,
    PluginOption as JaxPluginOption,
    Tier as JaxTier,
)
from volcano_tpu.framework import close_session as jax_close, open_session as jax_open
from volcano_tpu.framework.arguments import Arguments as JaxArguments
from volcano_tpu.metrics import metrics as jax_metrics
from volcano_tpu.ops.preempt_pack import pack_preempt_session as jax_pack_preempt
from volcano_tpu_torch import faults, metrics
from volcano_tpu_torch.actions import gpu_preempt
from volcano_tpu_torch.actions.allocate import AllocateAction
from volcano_tpu_torch.actions.backfill import BackfillAction
from volcano_tpu_torch.actions.enqueue import EnqueueAction
from volcano_tpu_torch.actions.gpu_allocate import GpuAllocateAction
from volcano_tpu_torch.actions.gpu_preempt import GpuPreemptAction
from volcano_tpu_torch.actions.preempt import PreemptAction
from volcano_tpu_torch.actions.reclaim import ReclaimAction
from volcano_tpu_torch.api import TaskStatus
from volcano_tpu_torch.cache import feed_from_dicts, SchedulerCache
from volcano_tpu_torch.conf import Configuration, PluginOption, Tier
from volcano_tpu_torch.framework import close_session, open_session
from volcano_tpu_torch.framework.arguments import Arguments
from volcano_tpu_torch.ops import dispatch
from volcano_tpu_torch.ops.dispatch import ApplyDiverged, ExecutorFailed
from volcano_tpu_torch.ops.packing import _SNAPSHOT_ARRAYS, _SNAPSHOT_META
from volcano_tpu_torch.ops.preempt_pack import pack_preempt_session
from volcano_tpu_torch.ops.synthetic import generate_preempt_cluster_objects


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: one intra-op thread is as fast, and keeps
    the suite's parallel workers from contending for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: the order in which a cache is fed (the JAX package's make_cache)
KINDS = ("nodes", "pods", "pod_groups", "queues", "priority_classes")
#: tests/test_preempt_kernel.py's FULL_TIERS (also test_explain's and
#: test_reclaim_kernel's)
FULL = (("priority", "gang", "conformance"),
        ("drf", "predicates", "proportion", "nodeorder", "binpack"))
DRF = (("drf", "gang", "conformance"),
       ("priority", "predicates", "proportion", "nodeorder", "binpack"))
DRF_AND_PRIORITY = (("priority", "drf", "gang", "conformance"),
                    ("predicates", "proportion", "nodeorder", "binpack"))
CONFORMANCE_GANG = (("conformance", "gang"),)

#: host action name → (the JAX package's action, the port's action)
ACTIONS = {
    "enqueue": (JaxEnqueue, EnqueueAction),
    "allocate": (JaxAllocate, AllocateAction),
    "backfill": (JaxBackfill, BackfillAction),
    "preempt": (JaxPreempt, PreemptAction),
    "reclaim": (JaxReclaim, ReclaimAction),
}
_JAX_CLASSES = dict(zip(KINDS, (jax_core.Node, jax_core.Pod, jax_scheduling.PodGroup,
                                jax_scheduling.Queue, jax_core.PriorityClass)))


class _Captured(Exception):
    pass


def captured(module, fn, *args, **kwargs) -> dict:
    """The cluster objects that ``fn`` — a case builder or a test of the
    JAX package — hands ``module.make_cache`` first; ``fn`` stops there."""
    got = {}

    def capture(*objects, **named):
        got.update(zip(KINDS, objects), **named)
        raise _Captured

    real = module.make_cache
    module.make_cache = capture
    try:
        fn(*args, **kwargs)
    except _Captured:
        pass
    finally:
        module.make_cache = real
    assert got, f"{fn.__name__} built no cache"
    return got


class StatusLog:
    """Counts the close-time writeback, call by call: PodGroup statuses
    and pod conditions (the job updater writes from a thread pool, so
    they are counted, not ordered).  Session-unique fields (transition
    id, time) are left out."""

    def __init__(self):
        self.pod_groups = Counter()
        self.conditions = Counter()

    def update_pod_condition(self, task, reason, message):
        self.conditions[(f"{task.namespace}/{task.name}", reason, message)] += 1

    def update_pod_group(self, pg):
        st = pg.status
        self.pod_groups[(pg.key(), st.phase, st.running, st.succeeded, st.failed, tuple(
            (c.type, c.status, c.reason, c.message) for c in st.conditions))] += 1
        return pg


class Case:
    """One cluster as dicts, with the tiers and the per-action
    arguments its cycle runs under.  A tier entry is a plugin name or
    (name, arguments)."""

    def __init__(self, objects, tiers=FULL, configurations=()):
        self.dicts = {k: [jax_serde.to_dict(o) for o in objects.get(k, ())] for k in KINDS}
        self.tiers = tiers
        self.configurations = configurations

    def _cache(self, cls):
        return cls(binder=chip_smoke.ListBinder(), evictor=chip_smoke.ListEvictor(),
                   status_updater=StatusLog())

    def jax_cache(self) -> JaxCache:
        cache = self._cache(JaxCache)
        adds = (cache.add_node, cache.add_pod, cache.add_pod_group, cache.add_queue,
                cache.add_priority_class)
        for kind, add in zip(KINDS, adds):
            for d in self.dicts[kind]:
                add(_JAX_CLASSES[kind].from_dict(d))
        return cache

    def port_cache(self) -> SchedulerCache:
        return feed_from_dicts(self._cache(SchedulerCache), **self.dicts)

    def _conf(self, tier_cls, option_cls, conf_cls, args_cls):
        def option(entry):
            name, args = (entry, {}) if isinstance(entry, str) else entry
            return option_cls(name=name, arguments=args_cls(args))

        tiers = [tier_cls(plugins=[option(e) for e in group]) for group in self.tiers]
        confs = [conf_cls(name=n, arguments=args_cls(a)) for n, a in self.configurations]
        return tiers, confs

    def jax_conf(self):
        return self._conf(JaxTier, JaxPluginOption, JaxConfiguration, JaxArguments)

    def port_conf(self):
        return self._conf(Tier, PluginOption, Configuration, Arguments)


PREEMPTION_COUNTERS = ("volcano_total_preemption_victims", "volcano_total_preemption_attempts")


def _jax_counters():
    return [jax_metrics.registry._counters.get((n, ()), 0.0) for n in PREEMPTION_COUNTERS]


def _port_counters():
    return [metrics.registry.counter(n) for n in PREEMPTION_COUNTERS]


def _run(cache, conf, open_, close, pipelined_status, actions, counters):
    """One cycle → what it left behind."""
    before = counters()
    ssn = open_(cache, *conf)
    try:
        for action in actions:
            action.execute(ssn)
        pipelined = sorted(
            (f"{t.namespace}/{t.name}", t.node_name) for job in ssn.jobs.values()
            for t in job.task_status_index.get(pipelined_status, {}).values())
        fit_errors = {
            f"{job.tasks[uid].namespace}/{job.tasks[uid].name}": fe.error()
            for job in ssn.jobs.values() for uid, fe in job.nodes_fit_errors.items()}
    finally:
        close(ssn)
    st = cache.status_updater
    return dict(evicts=cache.evictor.evicts, binds=cache.binder.binds, pipelined=pipelined,
                fit_errors=fit_errors, pod_groups=st.pod_groups, conditions=st.conditions,
                counters=[a - b for a, b in zip(counters(), before)])


def run_jax(case: Case, actions):
    return _run(case.jax_cache(), case.jax_conf(), jax_open, jax_close, JaxTaskStatus.Pipelined,
                actions, _jax_counters)


def run_port(case: Case, actions):
    return _run(case.port_cache(), case.port_conf(), open_session, close_session,
                TaskStatus.Pipelined, actions, _port_counters)


def assert_same_cycle(case: Case, names):
    """The named actions of each package on the case: equal outcomes."""
    want = run_jax(case, [ACTIONS[n][0]() for n in names])
    got = run_port(case, [ACTIONS[n][1]() for n in names])
    assert got == want
    return got


class HostRoute:
    """Counts the JAX action's host-action runs (monkeypatched in for
    the host action class it calls)."""

    def __init__(self, monkeypatch, module, name):
        self.calls = 0
        real = getattr(module, name)

        class Recording(real):
            def execute(inner, ssn):  # noqa: N805 — the recorder is ``self``
                self.calls += 1
                return real.execute(inner, ssn)

        monkeypatch.setattr(module, name, Recording)


def assert_equal_packs(got, want):
    """Two packed preempt or reclaim sessions, field for field."""
    for f in fields(want):
        if f.name == "base":
            continue
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w), f.name
        else:
            assert g == w, f.name
    for name in (*_SNAPSHOT_ARRAYS, "task_needs_host"):
        g, w = getattr(got.base, name), getattr(want.base, name)
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    for name in (*_SNAPSHOT_META, "registry_overflow"):
        assert getattr(got.base, name) == getattr(want.base, name), name


def assert_same_pack(case: Case, jax_pack, port_pack):
    """The port's packer against the JAX package's on one session:
    equal arrays, or the same refusal."""
    jax_ssn = jax_open(case.jax_cache(), *case.jax_conf())
    ssn = open_session(case.port_cache(), *case.port_conf())
    try:
        try:
            want = jax_pack(jax_ssn)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                port_pack(ssn)
            assert str(got.value) == str(e)
            return None
        got = port_pack(ssn)
        assert_equal_packs(got, want)
        return got
    finally:
        jax_close(jax_ssn)
        close_session(ssn)


# ---- the cases ----

P = ref_preempt
PREEMPT_CASES = {
    **{f"saturated-{s}": (lambda s=s: Case(captured(P, P._case_saturated, seed=s)))
       for s in range(3)},
    "idle-sufficient": lambda: Case(captured(P, P.test_dense_matches_host_idle_sufficient)),
    "gang-guard": lambda: Case(captured(P, P.test_dense_matches_host_gang_guard)),
    "two-queues": lambda: Case(captured(P, P.test_dense_matches_host_two_queues)),
    "mixed-priorities": lambda: Case(captured(P, P.test_dense_matches_host_mixed_priorities)),
    "equal-priority-tie": lambda: Case(
        captured(P, P.test_dense_matches_host_equal_priority_tie)),
    "pod-count-limit": lambda: Case(captured(P, P.test_dense_matches_host_pod_count_limit)),
    "nothing-starves": lambda: Case(
        captured(P, P.test_jax_preempt_action_noop_when_nothing_starves)),
    "tier-with-drf": lambda: Case(captured(P, P._case_saturated, seed=0),
                                  tiers=(("priority", "gang", "conformance", "drf"), ())),
    "starving-victim-source": lambda: Case(captured(P, P._case_starving_victim_source)),
    "sensitive-gang": lambda: Case(
        captured(P, P.test_sensitive_gang_allowance_flips_mid_pass)),
    "drf-imbalance": lambda: Case(captured(P, P._case_drf_imbalance), tiers=DRF),
    "drf-mixed-priority": lambda: Case(captured(P, P._case_drf_imbalance, seed=2),
                                       tiers=DRF_AND_PRIORITY),
    "drf-critical-victims": lambda: Case(
        captured(P, P.test_drf_critical_victims_participate_in_subtraction), tiers=DRF),
    "actions-idle-suffices": lambda: Case(captured(
        ref_actions, ref_actions.test_preempt_no_eviction_when_idle_suffices),
        tiers=CONFORMANCE_GANG),
    "actions-jobs-pipelined": lambda: Case(captured(
        ref_actions, ref_actions.test_preempt_no_eviction_when_jobs_pipelined),
        tiers=CONFORMANCE_GANG),
    "actions-one-task-other-job": lambda: Case(captured(
        ref_actions, ref_actions.test_preempt_one_task_of_other_job), tiers=CONFORMANCE_GANG),
    "actions-enough-victims": lambda: Case(captured(
        ref_actions, ref_actions.test_preempt_enough_victims_for_large_task),
        tiers=CONFORMANCE_GANG),
    "explain-no-victim": lambda: Case(captured(
        ref_explain, ref_explain.TestNoVictimExplain().test_jax_preempt_no_victim_synthesizes)),
}


@pytest.mark.parametrize("name", sorted(PREEMPT_CASES))
def test_pack_preempt_session_matches(name):
    """``pack_preempt_session`` against the JAX package's, field for
    field (the DRF tables in float64 bit for bit), or the same refusal."""
    assert_same_pack(PREEMPT_CASES[name](), jax_pack_preempt, pack_preempt_session)


@pytest.mark.parametrize("name", sorted(PREEMPT_CASES))
def test_host_preempt_matches(name):
    """The port's host ``preempt`` against the JAX package's."""
    assert_same_cycle(PREEMPT_CASES[name](), ["preempt"])


@pytest.mark.parametrize("name", sorted(PREEMPT_CASES))
def test_gpu_preempt_matches_jax_preempt(name, monkeypatch):
    """``gpu-preempt`` on the CPU against ``jax-preempt``: equal
    outcomes, and the JAX action ran its host action exactly where the
    port took the host route (so never to recover a diverging result)."""
    host = HostRoute(monkeypatch, jax_preempt_module, "PreemptAction")
    case = PREEMPT_CASES[name]()
    want = run_jax(case, [JaxPreemptAction()])
    action = GpuPreemptAction(device="cpu")
    assert run_port(case, [action]) == want
    assert action.last_route in ("device", "host", "none")
    assert host.calls == (action.last_route == "host")
    if action.last_route == "device":
        assert action.last_executor == "dense"


def test_the_cases_reach_every_route():
    """The table above reaches each of gpu-preempt's routes, and the
    device route both with evictions and with none."""
    routes = Counter()
    for name, make in PREEMPT_CASES.items():
        action = GpuPreemptAction(device="cpu")
        got = run_port(make(), [action])
        routes[(action.last_route, bool(got["evicts"]))] += 1
    assert routes[("device", True)] and routes[("device", False)]
    assert routes[("host", True)] and routes[("none", False)]


ENQUEUE_BACKFILL = {
    "enqueue-within-headroom": (ref_actions.test_enqueue_flips_pending_group_within_headroom,
                                (("proportion",),), (), ["enqueue"]),
    "enqueue-beyond-headroom": (ref_actions.test_enqueue_keeps_pending_beyond_headroom,
                                (("proportion",),), (), ["enqueue"]),
    "enqueue-overcommit-default": (ref_actions.test_enqueue_overcommit_factor_argument,
                                   (("proportion",),), (), ["enqueue"]),
    "enqueue-overcommit-2.0": (ref_actions.test_enqueue_overcommit_factor_argument,
                               (("proportion",),),
                               (("enqueue", {"overcommit-factor": "2.0"}),), ["enqueue"]),
    "backfill-besteffort-on-full-node": (ref_actions.test_backfill_places_besteffort_on_full_node,
                                         (("gang",),), (), ["backfill"]),
    "backfill-ignores-resourced": (ref_actions.test_backfill_ignores_resourced_tasks,
                                   (("gang",),), (), ["backfill"]),
    "backfill-after-allocate": (ref_actions.test_backfill_after_allocate_fills_leftovers,
                                (("gang",), ("drf", "proportion")), (),
                                ["allocate", "backfill"]),
}


@pytest.mark.parametrize("name", sorted(ENQUEUE_BACKFILL))
def test_enqueue_and_backfill_match(name):
    """tests/test_actions.py's enqueue and backfill sessions through the
    port's ``enqueue`` and ``backfill`` against the JAX package's."""
    fn, tiers, confs, names = ENQUEUE_BACKFILL[name]
    got = assert_same_cycle(Case(captured(ref_actions, fn), tiers, confs), names)
    if name.startswith("enqueue"):
        assert got["pod_groups"]  # the phase was written back


def _preempt_cluster(seed: int):
    """A saturated cluster as generate_preempt_cluster_objects makes the
    chip's preempt cells, at 450 victims x 50 nodes x 64 preemptors."""
    return Case(dict(zip(KINDS, generate_preempt_cluster_objects(
        n_victims=450, n_nodes=50, n_preemptors=64, seed=seed))))


@pytest.mark.parametrize("seed", range(3))
def test_preempting_cycle_matches(seed):
    """The whole preempting cycle — enqueue, gpu-allocate (explain on),
    gpu-preempt, backfill — against enqueue, jax-allocate, jax-preempt,
    backfill on the same objects, and the host cycle against the JAX
    package's host cycle: equal outcomes.  gpu-allocate binds nothing,
    sweeps the host chooser for no task and explains every task it
    tries; gpu-preempt takes the device route and preempts."""
    case = _preempt_cluster(seed)
    allocate = GpuAllocateAction(device="cpu")
    preempt = GpuPreemptAction(device="cpu")
    want = run_jax(case, [JaxEnqueue(), JaxAllocateAction(), JaxPreemptAction(), JaxBackfill()])
    got = run_port(case, [EnqueueAction(), allocate, preempt, BackfillAction()])
    assert got == want
    assert got["evicts"] and got["pipelined"] and not got["binds"]
    assert allocate.last_phase_stats["host_sweeps"] == 0
    assert allocate.last_phase_stats["explained"] >= 1
    assert preempt.last_route == "device" and preempt.last_executor == "dense"
    assert_same_cycle(case, ["enqueue", "allocate", "preempt", "backfill"])


# ---- failures ----


def _diverging(pk):
    """A result no host would accept: every victim of node 0 evicted and
    the first preemptor pipelined on a node it does not fit."""
    evicted = pk.vic_node[: pk.n_victims] == 0
    pipelined = np.full(pk.base.n_tasks, -1, dtype=np.int32)
    pipelined[0] = 1
    return evicted, pipelined


def test_diverged_result_raises_and_evicts_nothing(monkeypatch):
    """A device result that fails validation while applied: the
    statement is discarded, ApplyDiverged (an ExecutorFailed) raises,
    nothing is evicted or pipelined, the host action does not run in its
    place, and the divergence is counted once."""
    ran = []
    monkeypatch.setattr(gpu_preempt, "execute_preempt", lambda pk, device=None: _diverging(pk))
    monkeypatch.setattr(gpu_preempt, "last_preempt_executor", lambda: "cuda")
    monkeypatch.setattr(gpu_preempt, "PreemptAction", lambda: ran.append("host"))
    case = PREEMPT_CASES["saturated-0"]()
    cache = case.port_cache()
    ssn = open_session(cache, *case.port_conf())
    labels = dict(executor="preempt-cuda", cause="diverged")
    before = metrics.registry.counter("volcano_executor_failures_total", **labels)
    try:
        with pytest.raises(ApplyDiverged) as err:
            GpuPreemptAction(device="cpu").execute(ssn)
        assert isinstance(err.value, ExecutorFailed) and err.value.cause == "diverged"
        assert not any(job.task_status_index.get(TaskStatus.Pipelined)
                       or job.task_status_index.get(TaskStatus.Releasing)
                       for job in ssn.jobs.values())
    finally:
        close_session(ssn)
    assert cache.evictor.evicts == [] and ran == []
    assert metrics.registry.counter("volcano_executor_failures_total", **labels) == before + 1


def test_executor_failed_propagates_before_any_eviction(monkeypatch):
    """A failing preempt kernel raises ExecutorFailed out of execute()
    before anything is evicted; neither the dense pass nor the host
    action runs in its place."""
    monkeypatch.setattr(dispatch, "select_preempt_executor",
                        lambda pk, device=None, weights=None: "cuda")
    ran = []
    monkeypatch.setattr(dispatch, "preempt_dense", lambda *a, **k: ran.append("dense"))
    monkeypatch.setattr(gpu_preempt, "PreemptAction", lambda: ran.append("host"))
    case = PREEMPT_CASES["saturated-0"]()
    cache = case.port_cache()
    ssn = open_session(cache, *case.port_conf())
    faults.configure("seed=1;device.lowering=1:count=1")
    try:
        with pytest.raises(ExecutorFailed, match="lowering"):
            GpuPreemptAction(device="cpu").execute(ssn)
    finally:
        faults.configure(None)
        faults.reset_breakers()
        close_session(ssn)
    assert cache.evictor.evicts == [] and ran == []


def test_no_device_raises_without_a_gpu():
    """GpuPreemptAction() names no device: it runs on cuda, and raises
    where there is none rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    case = PREEMPT_CASES["saturated-0"]()
    ssn = open_session(case.port_cache(), *case.port_conf())
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GpuPreemptAction().execute(ssn)
    finally:
        close_session(ssn)
