"""The port's churn cell through its store on the CPU, in each commit
mode: ``generate_loop_events``' churn (seed 0) applied between cycles
through the store's API, each cycle's store digest
``chip_smoke.STORE_LOOP_DIGESTS``' (which the JAX package's twin gives in
``tests/test_torch_store_loop.py``) — the first, the second config's
store cycle, ``STORE_DIGESTS[SECOND_CONFIG]`` — the warm packer's modes
the JAX package's, every Scheduled Event of count 1, and the final store
equal to the JAX package's (``STORE_CHURN_DUMP``, the digest of its
``store_dump``).  Every commit plane is stopped before the test ends."""

from __future__ import annotations

import pytest

import chip_smoke

from tests.test_torch_store_loop import (  # noqa: F401 — fixtures
    cpu_actions,
    dump_digest,
    one_torch_thread,
    port_store_cycles,
    store_dump,
    STORE_CHURN_DUMP,
)


@pytest.mark.parametrize("mode", sorted(chip_smoke.STORE_MODES))
def test_port_store_churn_digests_on_cpu(cpu_actions, mode):
    name = chip_smoke.STORE_CHURN
    spec = chip_smoke.STORE_CELLS[name]
    recs, audit, cache = port_store_cycles(
        chip_smoke.loop_objects(spec["config"]), spec["tiers"], spec["actions"],
        spec["cycles"], mode, spec["between"])
    assert [r["digest"] for r in recs] == chip_smoke.STORE_LOOP_DIGESTS[name]
    assert recs[0]["digest"] == chip_smoke.STORE_DIGESTS[chip_smoke.SECOND_CONFIG]
    assert audit.events["Scheduled"][1] == 0
    assert [r["mode"] for r in recs] == ["cold", "micro", "warm", "warm", "warm"]
    assert dump_digest(store_dump(audit.api)) == STORE_CHURN_DUMP
    assert not cache.err_tasks and not cache.quarantined_tasks and not audit.rebinds
