"""The digests ``chip_smoke.py``'s daemon and bus phases hold the card to,
recomputed from the JAX package.

``ARRIVAL_DIGESTS``: the JAX package's leader-elected ``SchedulerDaemon``
pair on its store — the cell's cluster seeded, daemon A binding it,
standby B started, A crash-stopped, ``chip_smoke.arrival_objects()``
created, B binding them — gives the arrivals' digest; its first digest
is ``STORE_DIGESTS``'.  The bus cell's first cycle through the wire
(the JAX package's scheduler, on a ``RemoteAPIServer`` of the JAX
package to the port's ``BusServer``) gives the same digest as the
in-process store: the wire changes no field.  And the port's own pair
at 10k × 1k on the CPU gives the JAX pair's digests.  The 50k × 10k JAX
pair (~2 min here) is ``slow``.
"""

from __future__ import annotations

import pytest
import torch

import chip_smoke
import volcano_tpu.actions  # noqa: F401 — registers the JAX package's actions
import volcano_tpu.plugins  # noqa: F401 — registers its plugin builders
from tests.torch_bus_helpers import cpu_actions, daemon_run, pkg, wait  # noqa: F401 — fixture


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _port_identity():
    yield
    pkg("port").registry.set_identity()


def _pair(name: str, config: str, tmp_path) -> dict:
    return daemon_run(name, chip_smoke.loop_objects(config), tmp_path, takeover=True,
                      arrivals=chip_smoke.arrival_objects(), timeout=1800)


def test_jax_pair_gives_the_bus_cells_digests(tmp_path):
    config = chip_smoke.DAEMON_CELLS[chip_smoke.BUS_CELL]
    out = _pair("jax", config, tmp_path)
    assert out["first"] == chip_smoke.STORE_DIGESTS[config]
    assert out["arrivals"] == chip_smoke.ARRIVAL_DIGESTS[config]


def test_port_pair_gives_the_bus_cells_digests(cpu_actions, tmp_path):
    config = chip_smoke.DAEMON_CELLS[chip_smoke.BUS_CELL]
    out = _pair("port", config, tmp_path)
    assert out["first"] == chip_smoke.STORE_DIGESTS[config]
    assert out["arrivals"] == chip_smoke.ARRIVAL_DIGESTS[config]


def test_bus_cells_first_cycle_through_the_wire():
    """The JAX package's scheduler on the wire (its informers and its
    commit frames through a JAX client to the port's server), once its
    informers have the whole store, binds the bus cell with the
    in-process store's digest."""
    from volcano_tpu.cache import SchedulerCache as JaxCache
    from volcano_tpu.client import SchedulerClient as JaxClient
    from volcano_tpu.scheduler.scheduler import Scheduler as JaxScheduler
    from volcano_tpu_torch.bus import BusServer
    from volcano_tpu_torch.client import APIServer

    config = chip_smoke.DAEMON_CELLS[chip_smoke.BUS_CELL]
    objects = chip_smoke.loop_objects(config)
    store = APIServer()
    srv = BusServer(store, bookmark_interval=0.5).start()
    jax = pkg("jax")
    client = jax.RemoteAPIServer(f"tcp://127.0.0.1:{srv.port}", timeout=60)
    cache = None
    try:
        assert client.wait_ready(10)
        chip_smoke.seed_store(store, objects)
        audit = chip_smoke.StoreAudit(store)
        cache = JaxCache(client=JaxClient(client), snapshot_reuse=True)
        cache.run()
        n_pods = len(objects[1])
        assert wait(lambda: sum(len(j.tasks) for j in list(cache.jobs.values())) == n_pods
                    and len(cache.queues) == 1, 120)
        conf = chip_smoke.loop_conf_text(chip_smoke.CYCLE_TIERS, ("jax-allocate",))
        with chip_smoke.policy_file(chip_smoke.CYCLE_TIERS, ("jax-allocate",)) as path:
            assert open(path).read() == conf
            JaxScheduler(cache, scheduler_conf_path=path).run_once()
        cache.flush()
        assert wait(lambda: len(audit.bound) == n_pods, 120)
        assert audit.digest() == chip_smoke.STORE_DIGESTS[config]
    finally:
        if cache is not None:
            cache.stop_commit_plane()
        client.close()
        srv.stop()


@pytest.mark.slow
def test_jax_pair_gives_the_daemon_cells_digests(tmp_path):
    config = chip_smoke.DAEMON_CELLS[chip_smoke.DAEMON_CELL]
    out = _pair("jax", config, tmp_path)
    assert out["first"] == chip_smoke.STORE_DIGESTS[config]
    assert out["arrivals"] == chip_smoke.ARRIVAL_DIGESTS[config]
