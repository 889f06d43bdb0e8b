"""The port's controllers against the JAX package's, on the CPU.

Every case of ``tests/test_job_controller.py`` (the job controller's
reconcile loop, lifecycle policies, plugins, the queue controller and
the garbage collector), ``tests/test_job_state_machine.py`` (the 8-state
table), ``tests/test_queue_state_machine.py`` and
``tests/test_controller_cache.py`` runs on the port (the file's own
source with its imports pointed at ``volcano_tpu_torch``) and on the
JAX package, and the stores the two runs built are equal, object for
object (``tests.torch_mirror.store_dump``), tolerance 0.
"""

from __future__ import annotations

import pytest

from tests import torch_mirror
from tests.torch_bus_helpers import one_torch_thread  # noqa: F401

FILES = ("tests/test_job_controller.py", "tests/test_job_state_machine.py",
         "tests/test_queue_state_machine.py", "tests/test_controller_cache.py")
CASES = [(f, case) for f in FILES for case, _ in torch_mirror.cases(torch_mirror.load(f, "jax"))]


def run_both(rel: str, case: str, tmp_path) -> tuple:
    """``case`` of ``rel`` on the port, then on the JAX package: the two
    copies of the file, after their runs."""
    port = torch_mirror.load(rel, "port")
    torch_mirror.run_case(port, case, tmp_path / "port")
    ref = torch_mirror.load(rel, "jax")
    torch_mirror.run_case(ref, case, tmp_path / "jax")
    return port, ref


@pytest.mark.parametrize("rel,case", CASES, ids=[f"{f.split('/')[-1][:-3]}::{c}"
                                                  for f, c in CASES])
def test_case_equal_on_both_packages(rel, case, tmp_path):
    port, ref = run_both(rel, case, tmp_path)
    assert len(port.STORES) == len(ref.STORES)
    for mine, theirs in zip(port.STORES, ref.STORES):
        assert torch_mirror.store_dump(mine) == torch_mirror.store_dump(theirs)


def test_every_reference_case_is_mirrored():
    """The four files hold the reference's 29 tests (the state table's
    parametrized one counted once)."""
    tests = {rel: {c.split("[")[0] for c, _ in torch_mirror.cases(torch_mirror.load(rel, "jax"))}
             for rel in FILES}
    assert [len(tests[rel]) for rel in FILES] == [11, 4, 3, 11]
