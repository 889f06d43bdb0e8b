"""The port's admission webhooks and ``vtctl job|queue|describe`` against
the JAX package's, on the CPU.

Every case of ``tests/test_admission_cli.py`` (job validation and
mutation, the pod gate, the registered webhook chain, ``vtctl job`` and
``queue``, the task-template checks) runs on the port and on the JAX
package (``tests.torch_mirror``): the stores the two runs built are
equal, each ``vtctl`` command exits with the same code in both, a
command that writes prints the same text in both, and a command that
only reads prints, on the port's store, the JAX ``vtctl``'s text for
that store byte for byte.  Tolerance 0.
"""

from __future__ import annotations

import io

import pytest

from tests import torch_mirror
from tests.torch_bus_helpers import one_torch_thread  # noqa: F401

REL = "tests/test_admission_cli.py"
CASES = [case for case, _ in torch_mirror.cases(torch_mirror.load(REL, "jax"))]


def vtctl_checked(port, ref) -> None:
    """The two runs' vtctl calls agree: argv and exit codes; the text of
    the writing commands; the port's read-only texts equal the JAX
    vtctl's on the same store (its run's creation stamps differ from the
    other run's)."""
    assert [(c["argv"], c["rc"]) for c in port.VTCTL] == [(c["argv"], c["rc"]) for c in ref.VTCTL]
    for mine, theirs in zip(port.VTCTL, ref.VTCTL):
        if mine["twin"] is None:
            assert mine["text"] == theirs["text"]
        else:
            assert mine["twin"] == (mine["rc"], mine["text"])


@pytest.mark.parametrize("case", CASES)
def test_case_equal_on_both_packages(case, tmp_path):
    port = torch_mirror.load(REL, "port")
    torch_mirror.run_case(port, case, tmp_path / "port")
    ref = torch_mirror.load(REL, "jax")
    torch_mirror.run_case(ref, case, tmp_path / "jax")
    assert len(port.STORES) == len(ref.STORES)
    for mine, theirs in zip(port.STORES, ref.STORES):
        assert torch_mirror.store_dump(mine) == torch_mirror.store_dump(theirs)
    vtctl_checked(port, ref)


def test_every_reference_case_is_mirrored():
    assert len(CASES) == 41


def _store_with_jobs():
    """A port store after a job's run, its Events, a Command and a second
    queue: what ``job list|view``, ``queue get|list`` and ``describe``
    read."""
    from volcano_tpu_torch.admission import register_webhooks
    from volcano_tpu_torch.apis import core, scheduling
    from volcano_tpu_torch.cli import main as vtctl
    from volcano_tpu_torch.client import APIServer, KubeClient, VolcanoClient
    from volcano_tpu_torch.client.clients import record_event_via
    from volcano_tpu_torch.controllers import JobController, PodGroupController

    api = APIServer()
    register_webhooks(api)
    vc = VolcanoClient(api)
    vc.create_queue(scheduling.Queue(metadata=core.ObjectMeta(name="default", namespace="")))
    out = io.StringIO()
    assert vtctl(["job", "run", "-N", "j1", "-r", "3", "--min", "2"], api, out) == 0
    assert vtctl(["queue", "create", "-N", "q2", "-w", "4"], api, out) == 0
    JobController(api).drain()
    PodGroupController(api).drain()
    kube = KubeClient(api)
    pod = kube.get_pod("default", "j1-task-0")
    record_event_via(api, "default", {"kind": "Pod", "name": pod.metadata.name}, "Warning",
                     "Unschedulable", "0/3 nodes are available: 3 Insufficient cpu.")
    assert vtctl(["job", "suspend", "-N", "j1"], api, out) == 0
    return api


@pytest.mark.parametrize("argv", [
    ["job", "list"], ["job", "list", "-n", "default"], ["job", "view", "-N", "j1"],
    ["job", "view", "-N", "missing"], ["queue", "list"], ["queue", "get", "-N", "q2"],
    ["queue", "get", "-N", "missing"], ["describe", "job", "-N", "j1"],
    ["describe", "podgroup", "-N", "j1"], ["describe", "job", "-N", "missing"],
], ids=lambda a: "-".join(a))
def test_vtctl_reads_print_the_jax_text(argv):
    """Each read-only command of the port prints the JAX vtctl's text,
    byte for byte, on one store."""
    from volcano_tpu.cli.vtctl import main as jax_main
    from volcano_tpu_torch.cli.vtctl import main as port_main

    api = _store_with_jobs()
    texts = []
    for main in (port_main, jax_main):
        buf = io.StringIO()
        texts.append((main(list(argv), api=api, out=buf), buf.getvalue()))
    assert texts[0] == texts[1]
    assert texts[0][1]
