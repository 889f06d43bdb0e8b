"""The port's sharded scheduler federation (``volcano_tpu_torch/
federation/``) against the JAX package's, on the CPU.

Every case of ``tests/test_federation.py`` and ``tests/test_autoscale.py``
runs on the port: the reference file's own source with its imports
pointed at ``volcano_tpu_torch`` (``tests/torch_mirror.py``), the
port's gpu-allocate on the CPU in place of jax-allocate and the
``torch-scan`` replay executor in place of ``jax``.

* The deterministic classes run *paired*: the case on the port, then on
  the JAX package, and every store the two runs built compared
  (tolerance 0) — by ``torch_ha_helpers.ha_dump`` with the shard map's
  wall-clock stamps zeroed and the flight recorder's segments left out,
  or, where a lease loop ran (``TestSingleShardEquivalence``), by
  ``torch_mirror.store_dump``: the number of lease ticks, and so every
  resourceVersion, follows the clock.
* The timer-driven classes (leases, spillover and gang assembly across
  live members, the chaos drills, elastic adoption) run on the port
  alone, with the reference's own assertions; the soak is ``slow`` as
  it is in the reference.

A test fails when a reference case is mirrored in neither way.
"""

from __future__ import annotations

import json

import pytest

from tests import torch_ha_helpers as ha
from tests import torch_mirror
from tests.torch_bus_helpers import cpu_actions  # noqa: F401 — fixture

FED = "tests/test_federation.py"
AUTO = "tests/test_autoscale.py"

#: the port's names for what the reference's copy calls otherwise
EDITS = {
    FED: (('actions: "enqueue, jax-allocate"', 'actions: "enqueue, gpu-allocate"'),
          ('trace.replay.verify(jdir, executor="jax")',
           'trace.replay.verify(jdir, executor="torch-scan", device="cpu")')),
    AUTO: (),
}

#: paired classes whose runs start no lease loop: every store compared
#: with its resourceVersions
EXACT = {
    FED: ("TestSharding", "TestShardFilter", "TestCasBind", "TestGangBroker",
          "TestVtctlShards", "TestPolicyChecker", "TestSketchSpillCandidates"),
    AUTO: ("TestDecide", "TestWindowedLatency", "TestOwnedPending", "TestAutoscalerTick",
           "TestVtctlAutoscaleLine"),
}
#: paired classes whose members lease shards on the wall clock
LEASED = {FED: ("TestSingleShardEquivalence",), AUTO: ()}
#: timer-driven classes, on the port alone
PORT_ONLY = {
    FED: ("TestShardLeases", "TestSpillover", "TestFederationChaosSmoke",
          "TestGangAssemblyChaos", "TestFederationSoak"),
    AUTO: ("TestElasticAdoption", "TestElasticRekeyUnderChurn"),
}

_CLOCK_KEYS = ("renewTime", "heartbeat", "lastChange")


def _unclock(x):
    """The shard-map record with every wall-clock stamp zeroed (a stamp
    a test wrote by hand, below 10^6, is kept)."""
    if isinstance(x, dict):
        return {k: (0.0 if k in _CLOCK_KEYS and float(v) > 1e6 else _unclock(v))
                for k, v in x.items()}
    if isinstance(x, list):
        return [_unclock(v) for v in x]
    return x


def map_dump(api) -> dict:
    """``ha_dump`` with the shard map's stamps zeroed and the telemetry
    namespace's segments (span ids and clocks) left out."""
    from volcano_tpu_torch import obs
    from volcano_tpu_torch.federation.leases import SHARD_MAP_KEY

    out = ha.ha_dump(api)
    prefix = f"{obs.NAMESPACE}/"
    out["configmaps"] = [
        (key, tuple((k, json.dumps(_unclock(json.loads(v)), sort_keys=True)
                     if k == SHARD_MAP_KEY else v) for k, v in data))
        for key, data in out["configmaps"] if not key.startswith(prefix)]
    out["rvs"]["ConfigMap"] = [(k, rv) for k, rv in out["rvs"]["ConfigMap"]
                               if not k.startswith(prefix)]
    return out


def _cases(groups) -> list:
    out = []
    for rel, classes in groups.items():
        mod = ha.load(rel, "jax")
        for case, case_marks in torch_mirror.cases(mod):
            cls = case.split("::")[0]
            if cls in classes:
                # the soak's mark is on its class
                slow = "slow" in case_marks or any(
                    m.name == "slow" for m in getattr(getattr(mod, cls), "pytestmark", []))
                out.append(pytest.param(rel, case, id=f"{rel.split('/')[-1][:-3]}::{case}",
                                        marks=[pytest.mark.slow] if slow else []))
    return out


PAIRED_EXACT = _cases(EXACT)
PAIRED_LEASED = _cases(LEASED)
ON_THE_PORT = _cases(PORT_ONLY)


def _run(rel: str, case: str, pkg: str, tmp_path):
    mod = ha.load(rel, pkg, EDITS[rel])
    torch_mirror.run_case(mod, case, tmp_path / pkg)
    return mod


def _paired(rel: str, case: str, tmp_path, dump) -> None:
    port = _run(rel, case, "port", tmp_path)
    ref = _run(rel, case, "jax", tmp_path)
    assert len(port.STORES) == len(ref.STORES)
    for mine, theirs in zip(port.STORES, ref.STORES):
        assert dump(mine) == dump(theirs)


@pytest.mark.usefixtures("cpu_actions")
@pytest.mark.parametrize("rel,case", PAIRED_EXACT)
def test_case_equal_on_both_packages(rel, case, tmp_path):
    _paired(rel, case, tmp_path, map_dump)


@pytest.mark.usefixtures("cpu_actions")
@pytest.mark.parametrize("rel,case", PAIRED_LEASED)
def test_leased_case_equal_on_both_packages(rel, case, tmp_path):
    _paired(rel, case, tmp_path, torch_mirror.store_dump)


@pytest.mark.usefixtures("cpu_actions")
@pytest.mark.parametrize("rel,case", ON_THE_PORT)
def test_case_on_the_port(rel, case, tmp_path):
    _run(rel, case, "port", tmp_path)


def test_every_reference_case_is_mirrored():
    """test_federation.py's 38 cases (37 tier-1 and the slow soak) and
    test_autoscale.py's 24, each in exactly one of the three groups."""
    groups = (EXACT, LEASED, PORT_ONLY)
    for rel in (FED, AUTO):
        classes = {c.split("::")[0] for c, _ in torch_mirror.cases(ha.load(rel, "jax"))}
        named = [c for g in groups for c in g[rel]]
        assert sorted(named) == sorted(classes), rel
    ids = [p.values[:2] for p in PAIRED_EXACT + PAIRED_LEASED + ON_THE_PORT]
    assert len(ids) == len(set(ids)) == 38 + 24
    assert sum(1 for p in ON_THE_PORT if p.marks) == 1


@pytest.mark.usefixtures("cpu_actions")
def test_a_relist_holds_back_no_renewal_and_no_cycle():
    """Two faults of the reference the port does not copy (ROADMAP Queue
    C): a shard's relist, held here for over three TTLs, runs on the
    member's transition thread while the lease thread goes on renewing,
    and a cycle started meanwhile waits for it to be applied."""
    import threading
    import time

    from volcano_tpu_torch.apis import core
    from volcano_tpu_torch.client import APIServer
    from volcano_tpu_torch.federation import FederatedScheduler, read_shard_map

    gate = threading.Event()

    class HeldRelist(APIServer):
        def list(self, kind, namespace=None):
            # a relist's pod list, on whichever thread the member runs it
            if kind == "Pod" and threading.current_thread() is not threading.main_thread():
                assert gate.wait(30)
            return super().list(kind, namespace)

    api = HeldRelist()
    api.create(core.Node(metadata=core.ObjectMeta(name="n000", namespace=""),
                         status=core.NodeStatus(allocatable={"cpu": "4", "memory": "8Gi",
                                                             "pods": "110"})))
    ttl = 0.5
    member = FederatedScheduler(api, "m0", 1, lease_duration=ttl,
                                lease_retry_period=0.05).start()
    cycle = threading.Thread(target=member.scheduler.run_once)
    try:
        deadline = time.monotonic() + 10
        while member.state.owned() != {0} and time.monotonic() < deadline:
            time.sleep(0.01)
        assert member.state.owned() == {0} and not member.wait_owned(0)
        first = read_shard_map(api)["shards"]["0"]["renewTime"]
        cycle.start()
        time.sleep(3.5 * ttl)
        rec = read_shard_map(api)["shards"]["0"]
        assert rec["holder"] == "m0" and rec["renewTime"] - first >= 2.5 * ttl
        assert cycle.is_alive() and member.scheduler.full_cycles_run == 0
        gate.set()
        cycle.join(30)
        assert not cycle.is_alive() and member.scheduler.full_cycles_run == 1
        assert member.wait_owned(0) and set(member.cache.nodes) == {"n000"}
    finally:
        gate.set()
        member.stop()
