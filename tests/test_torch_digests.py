"""The full-width cycle digests that ``chip_smoke.py`` holds the card's
binds against, recomputed from the JAX package.

For each cycle cell, the JAX package's ``jax-allocate`` runs one cycle
on the config's cluster objects (``generate_cluster_objects``) under the
headline tiers, and the sha256 of its sorted binds must be the constant
in ``chip_smoke.CYCLE_DIGESTS``.  The port's cycle at 10k pods x 1k
nodes runs here too, through ``chip_smoke.run_cycle`` with
``device="cpu"`` (the PyTorch specification in the KERNEL phase), and
must give the same digest with every task through the bulk commit.
"""

from __future__ import annotations

import pytest
import torch

import chip_smoke
import volcano_tpu.actions  # noqa: F401 — registers the JAX package's actions
import volcano_tpu.plugins  # noqa: F401 — registers its plugin builders
from volcano_tpu.actions.jax_allocate import JaxAllocateAction
from volcano_tpu.cache import SchedulerCache as JaxCache
from volcano_tpu.conf import PluginOption as JaxPluginOption, Tier as JaxTier
from volcano_tpu.framework import close_session, open_session
from volcano_tpu.ops.synthetic import (
    BASELINE_CONFIGS as JAX_CONFIGS,
    generate_cluster_objects as jax_generate_cluster_objects,
)
from volcano_tpu_torch.ops.synthetic import BASELINE_CONFIGS, generate_cluster_objects


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread keeps the suite's parallel workers from
    contending for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(chip_smoke.CYCLE_DIGESTS))
def test_jax_allocate_digest_is_chip_smokes(name):
    nodes, pods, pod_groups, queues = jax_generate_cluster_objects(**JAX_CONFIGS[name])
    cache = JaxCache(binder=chip_smoke.ListBinder())
    for add, objs in ((cache.add_node, nodes), (cache.add_pod, pods),
                      (cache.add_pod_group, pod_groups), (cache.add_queue, queues)):
        for obj in objs:
            add(obj)
    tiers = [JaxTier(plugins=[JaxPluginOption(name=n) for n in tier])
             for tier in chip_smoke.CYCLE_TIERS]
    ssn = open_session(cache, tiers, [])
    try:
        JaxAllocateAction().execute(ssn)
    finally:
        close_session(ssn)
    assert len(cache.binder.binds) == len(pods)
    assert chip_smoke.cycle_digest(cache.binder.binds) == chip_smoke.CYCLE_DIGESTS[name]


def test_port_cycle_digest_on_cpu():
    name = chip_smoke.SECOND_CONFIG
    rec = chip_smoke.run_cycle(generate_cluster_objects(**BASELINE_CONFIGS[name]),
                               device="cpu")
    assert len(rec["binds"]) == BASELINE_CONFIGS[name]["n_tasks"]
    assert rec["route"] == "fast"
    assert chip_smoke.cycle_digest(rec["binds"]) == chip_smoke.CYCLE_DIGESTS[name]
