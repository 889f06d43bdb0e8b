"""The federation's observability on the port, on the CPU: ``vtctl top``
discovering a federation's members from the shard map, and the
cross-shard gang's waterfall across processes.

``tests/test_obs.py``'s ``TestVtctlTop`` and
``TestFederatedGangWaterfall`` run on the port from the reference
file's own source (``tests/torch_mirror.py``).  In ``TestVtctlTop`` the
two fake members are the JAX package's registries behind its serving
port (the port's serves the process's one registry): they stand for two
scheduler processes, and what runs on the port is its ``vtctl top``
and the shard map it reads.  The waterfall starts two port apiserver
replicas, the port's controllers and two ``python -m
volcano_tpu_torch.cmd.scheduler --shards 2`` children with ``--device
cpu``; a gang no shard can host alone binds through the broker's
``txn_commit``, and its trace carries gang:txn_commit → bus:txn_commit →
wal:fsync and repl:quorum_wait across at least three processes.  Its
first write waits, bounded, for the replica group's first election.
"""

from __future__ import annotations

import pytest

from tests import torch_ha_helpers as ha
from tests import torch_mirror

OBS = "tests/test_obs.py"
CLASSES = ("TestVtctlTop", "TestFederatedGangWaterfall")
EDITS = (
    ("from volcano_tpu_torch.metrics.metrics import _Registry",
     "from volcano_tpu.metrics.metrics import _Registry"),
    ("from volcano_tpu_torch.serving.http import ServingServer",
     "from volcano_tpu.serving.http import ServingServer"),
    ('"--gang-broker", "on", "--flight-recorder",',
     '"--gang-broker", "on", "--flight-recorder", "--device", "cpu",'),
    # the group's first write waits, bounded, for its first election (the
    # reference writes at once and fails when the replicas are slow to
    # elect, as they are on a loaded runner)
    ('            vc.create_queue(build_queue("default"))\n',
     '            def _queue_created():\n'
     '                from volcano_tpu_torch.bus.protocol import NotLeaderError\n'
     '                try:\n'
     '                    vc.create_queue(build_queue("default"))\n'
     '                except NotLeaderError:\n'
     '                    return False\n'
     '                return True\n\n'
     '            assert _wait(_queue_created, timeout=60.0, interval=0.1)\n'),
)
CASES = ha.cases(OBS, CLASSES)


@pytest.mark.parametrize("case", CASES)
def test_case_on_the_port(case, tmp_path):
    mod = ha.load(OBS, "port", EDITS)
    torch_mirror.run_case(mod, case, tmp_path / "port")


def test_every_reference_case_is_mirrored():
    """TestVtctlTop's 2 cases and TestFederatedGangWaterfall's 1."""
    assert sorted(c.split("::")[0] for c in CASES) == [
        "TestFederatedGangWaterfall", "TestVtctlTop", "TestVtctlTop"]
