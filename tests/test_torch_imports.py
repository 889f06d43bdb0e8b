"""The port stands alone: it imports no JAX and nothing of volcano_tpu.

A fresh interpreter with ``jax`` blocked and a meta-path finder that
refuses ``volcano_tpu`` and its submodules (but not
``volcano_tpu_torch``) imports every module of the port and runs an
allocate session (also through the blocked executor), a preempt pass,
a scheduling cycle (cache → session → gpu-allocate → binds) and a
preempting cycle (enqueue → gpu-allocate → gpu-preempt → backfill) on
the CPU."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import importlib, importlib.abc, sys

sys.modules["jax"] = None


class RefuseReference(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "volcano_tpu" or name.startswith("volcano_tpu."):
            raise ImportError(f"the port imported {name}")
        return None


sys.meta_path.insert(0, RefuseReference())
for name in [m for m in sys.modules if m == "volcano_tpu" or m.startswith("volcano_tpu.")]:
    del sys.modules[name]

import pkgutil
import volcano_tpu_torch

modules = [m.name for m in pkgutil.walk_packages(volcano_tpu_torch.__path__, "volcano_tpu_torch.")]
for mod in modules:
    importlib.import_module(mod)
assert len(modules) > 50 and "volcano_tpu_torch.actions.gpu_allocate" in modules
for mod in ("actions.enqueue", "actions.backfill", "actions.preempt", "actions.reclaim",
            "actions.gpu_preempt", "actions.gpu_reclaim", "ops.explain", "ops.reclaim_pack"):
    assert "volcano_tpu_torch." + mod in modules, mod

from volcano_tpu_torch.ops.executor import (
    execute_allocate, execute_preempt, last_allocate_executor, last_preempt_executor,
)
from volcano_tpu_torch.ops.synthetic import generate_preempt_packed, generate_snapshot

out = execute_allocate(generate_snapshot(n_tasks=48, n_nodes=12, gang_size=4, seed=1),
                       device="cpu")
assert last_allocate_executor() == "torch-scan"
from volcano_tpu_torch.ops.blocked import run_packed_blocked
assert (run_packed_blocked(generate_snapshot(n_tasks=48, n_nodes=12, gang_size=4, seed=1),
                           block_size=8, top_k=2, device="cpu") == out).all()
evicted, pipelined = execute_preempt(
    generate_preempt_packed(n_victims=90, n_nodes=10, n_preemptors=16, seed=2), device="cpu")
assert last_preempt_executor() == "dense"
import chip_smoke
from volcano_tpu_torch.ops.synthetic import generate_cluster_objects

cycle = chip_smoke.run_cycle(generate_cluster_objects(n_tasks=48, n_nodes=12, gang_size=4,
                                                      seed=1), device="cpu")
from volcano_tpu_torch.ops.synthetic import generate_preempt_cluster_objects

preempting = chip_smoke.run_preempt_cycle(generate_preempt_cluster_objects(
    n_victims=90, n_nodes=10, n_preemptors=16, seed=2), device="cpu")
assert "jax" not in {m.split(".")[0] for m in sys.modules if sys.modules[m] is not None}
print("placed", int((out >= 0).sum()), "of", len(out))
print("evicted", int(evicted.sum()), "pipelined", int((pipelined >= 0).sum()))
print("bound", len(cycle["binds"]), "route", cycle["route"])
print("preempt cycle evicted", len(preempting["evicted"]), "pipelined",
      len(preempting["pipelined"]), "route", preempting["preempt_route"], "host sweeps",
      preempting["allocate_phases"]["host_sweeps"])
"""


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread here and in the child keeps the suite's
    parallel workers from contending for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_port_imports_and_runs_without_jax_or_reference():
    proc = subprocess.run(
        [sys.executable, "-c", CHILD], cwd=ROOT, capture_output=True, text=True,
        timeout=120, env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1"),
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines() == [
        "placed 48 of 48", "evicted 10 pipelined 10", "bound 48 route fast",
        "preempt cycle evicted 10 pipelined 10 route device host sweeps 0"]


def test_port_sources_import_neither_jax_nor_reference():
    """Static twin of the subprocess check: no import statement in the
    port or in chip_smoke.py names jax or volcano_tpu."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, filenames in os.walk(os.path.join(ROOT, "volcano_tpu_torch")):
        files += [os.path.join(dirpath, f) for f in filenames if f.endswith(".py")]
    assert len(files) > 5
    for path in files:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "volcano_tpu"), (path, name)
