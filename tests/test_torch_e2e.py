"""The Job path end to end, the port against the JAX package, on the CPU.

Part one: every case of ``tests/test_e2e.py`` (admission, the job,
podgroup and queue controllers, the scheduler, a fake kubelet, lifecycle
policies, the GC, ``vtctl``) runs on the port's cluster, whose default
policy names gpu-allocate (its CPU instance), and on the JAX package's
with ``jax-allocate`` in place of the host allocate of its default
policy (``tests.torch_mirror``).  The stores the two runs built are
equal, object for object, and the ``vtctl`` commands agree as in
``tests/test_torch_admission.py``.  A case that names its own policy
file runs it in both.

Part two: ``chip_smoke.phase_jobs``' cell at a tenth of its jobs (20 +
10 Jobs × 50 tasks on 100 nodes, ``chip_smoke.JOB_SMALL``): the port's
``ControllersDaemon`` and ``SchedulerDaemon`` (gpu-allocate on the CPU)
and the JAX package's (jax-allocate), stepped in one fixed order with a
kubelet, through both waves and the lifecycle; every job's phase is the
expected one, and the two stores are equal.
"""

from __future__ import annotations

import pytest

import chip_smoke
from tests import torch_mirror
from tests.test_torch_admission import vtctl_checked
from tests.torch_bus_helpers import cpu_actions, one_torch_thread, shm_env  # noqa: F401

REL = "tests/test_e2e.py"
CASES = [case for case, _ in torch_mirror.cases(torch_mirror.load(REL, "jax"))]


def jax_allocate_default(mod) -> None:
    """The JAX copy's ``Scheduler`` with jax-allocate in its default
    policy."""
    from volcano_tpu.conf import DEFAULT_SCHEDULER_CONF, load_scheduler_conf

    text = DEFAULT_SCHEDULER_CONF.replace('"enqueue, allocate, backfill"',
                                          '"enqueue, jax-allocate, backfill"')
    assert text != DEFAULT_SCHEDULER_CONF
    base = mod.Scheduler

    class JaxAllocateScheduler(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self._default_conf = load_scheduler_conf(text)

    mod.Scheduler = JaxAllocateScheduler


@pytest.mark.parametrize("case", CASES)
def test_case_equal_on_both_packages(case, tmp_path, cpu_actions):  # noqa: F811
    port = torch_mirror.load(REL, "port")
    torch_mirror.run_case(port, case, tmp_path / "port")
    ref = torch_mirror.load(REL, "jax")
    jax_allocate_default(ref)
    torch_mirror.run_case(ref, case, tmp_path / "jax")
    assert len(port.STORES) == len(ref.STORES)
    for mine, theirs in zip(port.STORES, ref.STORES):
        assert torch_mirror.store_dump(mine) == torch_mirror.store_dump(theirs)
    vtctl_checked(port, ref)


def test_every_reference_case_is_mirrored():
    assert len(CASES) == 30


# ---- part two: phase_jobs' cell at a tenth ----

def jax_job_pkg():
    """The JAX package's pieces of the Job path by the names
    ``chip_smoke.JobCell`` uses, with jax-allocate."""
    from types import SimpleNamespace

    from volcano_tpu.admission import register_webhooks
    from volcano_tpu.apis import batch, core, scheduling
    from volcano_tpu.cli.vtctl import main as vtctl
    from volcano_tpu.client import (
        ADDED,
        MODIFIED,
        AdmissionError,
        APIServer,
        KubeClient,
        VolcanoClient,
    )
    from volcano_tpu.cmd.controllers import ControllersDaemon
    from volcano_tpu.cmd.scheduler import SchedulerDaemon

    return SimpleNamespace(
        batch=batch, core=core, scheduling=scheduling, APIServer=APIServer,
        KubeClient=KubeClient, VolcanoClient=VolcanoClient, ADDED=ADDED, MODIFIED=MODIFIED,
        AdmissionError=AdmissionError, register_webhooks=register_webhooks, vtctl=vtctl, ControllersDaemon=ControllersDaemon,
        SchedulerDaemon=SchedulerDaemon, allocate="jax-allocate")


def job_cell(pkg: str, cfg: dict, tmp_path) -> dict:
    """``chip_smoke.run_job_cell`` on package ``pkg`` ("port" with
    gpu-allocate's CPU instance registered by the caller, "jax" with
    jax-allocate)."""
    m = chip_smoke.port_job_pkg() if pkg == "port" else jax_job_pkg()
    actions = [a.replace("gpu-allocate", m.allocate) for a in chip_smoke.JOB_ACTIONS]
    path = tmp_path / f"{pkg}.conf"
    path.write_text(chip_smoke.loop_conf_text(chip_smoke.CYCLE_TIERS, actions))
    return chip_smoke.run_job_cell(m, cfg, str(path))


def test_small_job_cell_equal_on_both_packages(tmp_path, cpu_actions):  # noqa: F811
    """20 + 10 Jobs × 50 tasks on 100 nodes through the lifecycle: every
    expected phase on both packages (``run_job_cell`` checks them), and
    the stores equal."""
    port = job_cell("port", chip_smoke.JOB_SMALL, tmp_path)
    ref = job_cell("jax", chip_smoke.JOB_SMALL, tmp_path)
    assert port["pods"] == ref["pods"] == 50 * (chip_smoke.JOB_SMALL["wave1"] // 2
                                                + chip_smoke.JOB_SMALL["wave2"])
    assert torch_mirror.store_dump(port["api"]) == torch_mirror.store_dump(ref["api"])
    assert port["digest"] == ref["digest"]
    assert [t["binds"] for t in port["ticks"]] == [t["binds"] for t in ref["ticks"]]


# ---- part three: vtpu-local-up on the port ----

def test_local_up_demo_in_process(cpu_actions, capsys):  # noqa: F811
    """``local_up --demo``: admission, controllers and the scheduler as
    daemon threads on one in-process store bind the demo gang job."""
    from volcano_tpu_torch.cmd.local_up import main

    assert main(["--demo", "--device", "cpu"]) == 0
    assert "demo job bound" in capsys.readouterr().out


def test_local_up_multiproc_demo(capsys, shm_env):  # noqa: F811
    """``local_up --multiproc --demo``: the port's apiserver, admission,
    controllers and scheduler binaries as children bind the demo job
    after the admission child answers reviews."""
    from volcano_tpu_torch.cmd.local_up import main

    assert main(["--multiproc", "--demo", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "4 daemons" in out and "demo job bound" in out


def test_local_up_without_gpu_exits_at_start(monkeypatch, capsys):
    import torch

    from volcano_tpu_torch.cmd import local_up

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(local_up, "local_up", lambda *a, **k: pytest.fail("started"))
    assert local_up.main(["--demo"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
