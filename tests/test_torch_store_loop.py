"""The scheduler through its store, in both packages, on the CPU.

Each package's cluster is created in its own in-process ``APIServer``
(priority classes, nodes, pods, pod groups, queues, in the generator's
order; ``chip_smoke.seed_store``), a ``SchedulerCache(client=
SchedulerClient(api), snapshot_reuse=True)`` fills from its watch, and
``Scheduler.run_once`` runs from a policy file, its binds, evictions,
Events, pod conditions and PodGroup statuses landing in the store as
commit frames.  The JAX package's ``Scheduler`` with ``jax-*`` actions
through its own store gives ``chip_smoke.STORE_DIGESTS``,
``STORE_LOOP_DIGESTS`` and ``STORE_PREEMPT_DIGESTS``; the port's
``Scheduler`` with ``gpu-*`` actions on ``device="cpu"`` gives the same,
synchronously and through the pipelined commit plane
(``chip_smoke.store_cycles``), with a store equal to the JAX package's,
pod for pod, Event for Event and PodGroup for PodGroup (``store_dump``).
The port's churn cell, whose first cycle is the second config's store
cycle, runs in ``tests/test_torch_store_churn.py``, a file of its own so
that it runs beside this one.  The JAX package's 50k x 10k store cycle
is marked ``slow``.

A store-fed cycle does not give ``CYCLE_DIGESTS``: the store stamps the
wall clock on an object created with a zero creation timestamp, so the
generator's first PodGroup becomes the newest job; the stamps are all
later than the generator's ordinals, so the order is deterministic.
Every commit plane a test makes is stopped before the test ends.
"""

from __future__ import annotations

import hashlib

import pytest
import torch

import chip_smoke
import volcano_tpu.actions  # noqa: F401 — registers the JAX package's actions
import volcano_tpu.plugins  # noqa: F401 — registers its plugin builders
from volcano_tpu.api import TaskStatus as JaxTaskStatus
from volcano_tpu.apis import core as jax_core, scheduling as jax_scheduling
from volcano_tpu.cache import SchedulerCache as JaxCache
from volcano_tpu.client import APIServer as JaxAPIServer, SchedulerClient as JaxClient
from volcano_tpu.framework import register_action as jax_register_action
from volcano_tpu.scheduler.scheduler import Scheduler as JaxScheduler
from volcano_tpu_torch.actions import gpu_allocate, gpu_preempt
from volcano_tpu_torch.framework import get_action, register_action
from volcano_tpu_torch.ops.synthetic import generate_loop_events, loop_world, record_binds

JAX_CLASSES = {"node": jax_core.Node, "pod": jax_core.Pod, "pod_group": jax_scheduling.PodGroup,
               "queue": jax_scheduling.Queue, "priority_class": jax_core.PriorityClass}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread keeps the suite's parallel workers from
    contending for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cpu_actions():
    """The port's device actions on the CPU for one test: registered
    under their names, the registry's instances restored after."""
    saved = [get_action(n) for n in ("gpu-allocate", "gpu-preempt")]
    register_action(gpu_allocate.GpuAllocateAction(device="cpu"))
    register_action(gpu_preempt.GpuPreemptAction(device="cpu"))
    yield
    for action in saved:
        register_action(action)


def jax_objects(objects) -> list:
    """The port generator's objects as the JAX package's, through dicts."""
    kinds = ("node", "pod", "pod_group", "queue", "priority_class")
    return [[JAX_CLASSES[kind].from_dict(o.to_dict()) for o in objs]
            for kind, objs in zip(kinds, objects)]


class JaxRecordPipelined:
    """``chip_smoke.RecordPipelined`` for the JAX package's sessions."""

    def __init__(self):
        self.pipelined = []

    def name(self) -> str:
        return "record-pipelined"

    def execute(self, ssn) -> None:
        self.pipelined = [
            (f"{t.namespace}/{t.name}", t.node_name) for job in ssn.jobs.values()
            for t in job.task_status_index.get(JaxTaskStatus.Pipelined, {}).values()]


def pack_mode(cache):
    """The warm packer's last pack mode (``cold``, ``warm``, ...), or
    None before its first pack."""
    return None if cache._pack_cache is None else cache._pack_cache.last_stats.get("mode")


def jax_store_cycles(objects, tiers, actions, cycles, between, tmp_path):
    """The JAX package's twin of ``chip_smoke.store_cycles`` in its
    synchronous mode, its actions renamed ``jax-*``: one record a cycle
    (the store's digest, the pipelined pairs, the pods deleted from the
    store, the warm packer's mode), then the audit (whose ``api`` is the
    store) and the cache."""
    api = JaxAPIServer()
    audit = chip_smoke.StoreAudit(api)
    chip_smoke.seed_store(api, jax_objects(objects))
    cache = JaxCache(client=JaxClient(api), snapshot_reuse=True)
    cache.run()
    world = loop_world(objects[:4]) if between == "churn" else None
    recorder = JaxRecordPipelined()
    jax_register_action(recorder)
    names = [a.replace("gpu-", "jax-") for a in actions] + [recorder.name()]
    path = tmp_path / "scheduler.conf"
    path.write_text(chip_smoke.loop_conf_text(tiers, names))
    scheduler = JaxScheduler(cache, scheduler_conf_path=str(path))
    before, recs = set(), []
    for k in range(cycles):
        if k and between == "churn":
            record_binds(world, [b for b in audit.binds() if b[0] not in before])
            chip_smoke.apply_store_events(api, generate_loop_events(world, k, seed=0),
                                          JAX_CLASSES)
        before = {name for name, _ in audit.binds()}
        scheduler.run_once()
        recs.append(dict(digest=audit.digest(), pipelined=recorder.pipelined,
                         deleted=list(audit.deleted), mode=pack_mode(cache)))
    return recs, audit, cache


def port_store_cycles(objects, tiers, actions, cycles, mode, between=None):
    """``chip_smoke.store_cycles`` on the CPU, flushed after every cycle:
    the same records as ``jax_store_cycles``, then the audit (whose
    ``api`` is the store) and the cache, its commit plane stopped."""
    recs, last = [], None
    try:
        for rec in chip_smoke.store_cycles(objects, tiers, actions, cycles, mode, between):
            last = rec
            rec["cache"].flush()
            recs.append(dict(digest=rec["audit"].digest(), pipelined=rec["pipelined"],
                             deleted=list(rec["audit"].deleted), mode=pack_mode(rec["cache"])))
    finally:
        if last is not None:
            last["cache"].stop_commit_plane()
    return recs, last["audit"], last["cache"]


def store_dump(api) -> dict:
    """Every user-visible field the commit path and the controllers
    write: each pod's node, phase and conditions, each Event's count and
    message by (object, type, reason), each PodGroup's status, and,
    where the store holds any, each Job's phase and counters, each
    Service's, Secret's and NetworkPolicy's content and each Command's
    action and target — without resource versions, timestamps, a
    condition's transition id and the names the CLI stamps with the wall
    clock, which differ between any two runs."""
    def key(o):
        return f"{o.metadata.namespace}/{o.metadata.name}"

    pods = {key(p): (
        p.spec.node_name, p.status.phase,
        tuple(sorted((c.type, c.status, c.reason, c.message) for c in p.status.conditions)))
        for p in api.list("Pod")}
    events = {(e.metadata.namespace, e.involved_object.get("name"), e.type, e.reason):
              (e.count, e.message) for e in api.list("Event")}
    pod_groups = {key(g): (
        g.status.phase, g.status.running, g.status.succeeded, g.status.failed,
        tuple(sorted((c.type, c.status, c.reason, c.message) for c in g.status.conditions)))
        for g in api.list("PodGroup")}
    out = {"pods": pods, "events": events, "pod_groups": pod_groups}
    jobs = {key(j): (
        j.status.state.phase, j.status.state.reason, j.status.state.message,
        j.status.min_available, j.status.pending, j.status.running, j.status.succeeded,
        j.status.failed, j.status.terminating, j.status.unknown, j.status.version,
        j.status.retry_count, tuple(sorted(j.status.controlled_resources.items())))
        for j in api.list("Job")}
    services = {key(s): repr(s.spec) for s in api.list("Service")}
    secrets = {key(s): (s.type, tuple(sorted(s.data.items()))) for s in api.list("Secret")}
    policies = {key(n): repr(n.spec) for n in api.list("NetworkPolicy")}
    commands = {(c.metadata.namespace, c.action, c.target_object.kind, c.target_object.name):
                c.reason for c in api.list("Command")}
    for name, section in (("jobs", jobs), ("services", services), ("secrets", secrets),
                          ("network_policies", policies), ("commands", commands)):
        if section:  # absent from the stores of the scheduler's cells
            out[name] = section
    return out


def dump_digest(dump: dict) -> str:
    """sha256 of a store dump, its sections sorted."""
    return hashlib.sha256(repr({k: sorted(v.items()) for k, v in dump.items()}).encode()
                          ).hexdigest()


#: dump_digest of the JAX package's store after the churn cell's cycles;
#: tests/test_torch_store_churn.py holds the port's to it in each mode
STORE_CHURN_DUMP = "35a0c22aaae980325285354e13fbb2f81b7b557cc990033788f300657616f71b"


@pytest.fixture(scope="module")
def jax_churn(tmp_path_factory):
    """The JAX package's churn cell through its store: the records, the
    audit and the final store's dump."""
    spec = chip_smoke.STORE_CELLS[chip_smoke.STORE_CHURN]
    recs, audit, _ = jax_store_cycles(
        chip_smoke.loop_objects(spec["config"]), spec["tiers"], spec["actions"],
        spec["cycles"], spec["between"], tmp_path_factory.mktemp("jax-churn"))
    return dict(recs=recs, audit=audit, dump=store_dump(audit.api))


def test_jax_store_digests_are_chip_smokes(jax_churn):
    """The JAX package's churn cell through its store gives
    STORE_LOOP_DIGESTS cycle by cycle, its first cycle (the second
    config's cluster) STORE_DIGESTS' — not CYCLE_DIGESTS', since the
    store stamps the wall clock on the objects created with a zero
    creation timestamp."""
    name, config = chip_smoke.STORE_CHURN, chip_smoke.SECOND_CONFIG
    digests = [r["digest"] for r in jax_churn["recs"]]
    assert digests == chip_smoke.STORE_LOOP_DIGESTS[name]
    assert digests[0] == chip_smoke.STORE_DIGESTS[config]
    assert chip_smoke.STORE_DIGESTS[config] != chip_smoke.CYCLE_DIGESTS[config]
    assert [r["mode"] for r in jax_churn["recs"]] == ["cold", "micro", "warm", "warm", "warm"]
    assert dump_digest(jax_churn["dump"]) == STORE_CHURN_DUMP
    assert not jax_churn["audit"].rebinds


@pytest.fixture(scope="module")
def jax_preempt(tmp_path_factory):
    spec = chip_smoke.STORE_CELLS[chip_smoke.STORE_PREEMPT]
    recs, audit, _ = jax_store_cycles(
        chip_smoke.loop_objects(spec["config"]), spec["tiers"], spec["actions"],
        spec["cycles"], None, tmp_path_factory.mktemp("jax-preempt"))
    return dict(rec=recs[0], audit=audit, dump=store_dump(audit.api))


def test_jax_store_preempt_digest_is_chip_smokes(jax_preempt):
    """The JAX package's preempting cycle through its store: its
    evictions deleted from the store, each with an Evict Event, and the
    digest of (deleted pods, pipelined pairs) STORE_PREEMPT_DIGESTS'."""
    rec, audit = jax_preempt["rec"], jax_preempt["audit"]
    digest = chip_smoke.preempt_cycle_digest(rec["deleted"], rec["pipelined"])
    assert digest == chip_smoke.STORE_PREEMPT_DIGESTS[chip_smoke.PREEMPT_CYCLE_SECOND]
    assert rec["deleted"] and audit.evict_events == set(rec["deleted"])


@pytest.mark.parametrize("mode", sorted(chip_smoke.STORE_MODES))
def test_port_store_preempt_equals_the_jax_store(cpu_actions, jax_preempt, mode):
    """The port's preempting cycle through its store, in each commit
    mode: the evictions land as store deletes through the evict frame,
    each with an Evict Event, the digest is STORE_PREEMPT_DIGESTS', and
    the store equals the JAX package's.  Synchronously the deletes land
    in the statement's order, as the JAX package's do; pipelined, two
    bind workers land their frames concurrently, so the order between
    frames is not fixed (as in the reference) and the deletes are held
    as a set, each pod once."""
    spec = chip_smoke.STORE_CELLS[chip_smoke.STORE_PREEMPT]
    recs, audit, cache = port_store_cycles(
        chip_smoke.loop_objects(spec["config"]), spec["tiers"], spec["actions"], 1, mode)
    digest = chip_smoke.preempt_cycle_digest(recs[0]["deleted"], recs[0]["pipelined"])
    assert digest == chip_smoke.STORE_PREEMPT_DIGESTS[spec["config"]]
    deleted, expected = recs[0]["deleted"], jax_preempt["rec"]["deleted"]
    if mode == "sync":
        assert deleted == expected
    else:
        assert sorted(deleted) == sorted(expected)
    assert audit.evict_events == set(recs[0]["deleted"])
    assert store_dump(audit.api) == jax_preempt["dump"]
    assert not cache.err_tasks and not cache.quarantined_tasks


@pytest.mark.slow
def test_jax_store_main_digest_is_chip_smokes(tmp_path):
    """The JAX package's 50k x 10k cycle through its store: two cycles
    (the second binds nothing), STORE_DIGESTS' digest after both, one
    Scheduled Event of count 1 a pod, every PodGroup Running."""
    config = chip_smoke.MAIN_CONFIG
    objects = chip_smoke.loop_objects(config)
    recs, audit, cache = jax_store_cycles(objects, chip_smoke.CYCLE_TIERS, ("gpu-allocate",),
                                          2, None, tmp_path)
    assert [r["digest"] for r in recs] == [chip_smoke.STORE_DIGESTS[config]] * 2
    assert audit.events["Scheduled"] == [len(objects[1]), 0]
    assert {g.status.phase for g in audit.api.list("PodGroup")} == {
        jax_scheduling.POD_GROUP_RUNNING}
