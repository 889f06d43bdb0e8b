"""Synthetic packed-snapshot generators for the allocate configs of
BASELINE.json.

A copy of ``generate_snapshot`` from ``volcano_tpu/ops/synthetic.py``:
generation is numpy ``RandomState(seed)`` in the same call order, so the
same arguments give byte-identical arrays in both packages.
"""

from __future__ import annotations

import numpy as np

from volcano_tpu_torch.api.resource import MIN_MEMORY, MIN_MILLI_CPU
from volcano_tpu_torch.ops.packing import _bucket, MIB, PackedSnapshot


def generate_snapshot(
    n_tasks: int,
    n_nodes: int,
    gang_size: int = 8,
    seed: int = 0,
    label_classes: int = 0,
    taint_fraction: float = 0.0,
    node_cpu_milli: int = 64_000,
    node_mem_mib: int = 262_144,  # 256 GiB
    pad: bool = True,
) -> PackedSnapshot:
    """BASELINE-config style cluster: gang jobs of ``gang_size`` tasks with
    heterogeneous cpu/mem requests over uniform nodes; optional label
    classes (selector predicate pressure) and tainted node fraction."""
    rng = np.random.RandomState(seed)
    R, W = 2, 2

    n_jobs = max(1, n_tasks // gang_size)

    T_pad = _bucket(n_tasks) if pad else n_tasks
    N_pad = _bucket(n_nodes) if pad else n_nodes
    J_pad = _bucket(n_jobs, minimum=16) if pad else n_jobs

    snap = PackedSnapshot()
    snap.resource_names = ["cpu", "memory"]
    snap.tolerance = np.array([MIN_MILLI_CPU, MIN_MEMORY / MIB], dtype=np.float32)
    snap.n_tasks, snap.n_nodes, snap.n_jobs = n_tasks, n_nodes, n_jobs

    # Tasks: cpu 250m-4000m, memory 256MiB-8GiB, MiB-aligned.  Gang
    # replicas share ONE resreq per job — the reference's gangs stamp all
    # replicas of a task group from a single PodTemplate
    # (pkg/apis/batch/v1alpha1/job.go:43-60).
    job_cpu = rng.choice([250, 500, 1000, 2000, 4000], size=n_jobs).astype(np.float32)
    job_mem = rng.choice([256, 512, 1024, 2048, 4096, 8192], size=n_jobs).astype(np.float32)
    task_of_job = np.minimum(np.arange(n_tasks) // gang_size, n_jobs - 1)
    cpu = job_cpu[task_of_job]
    mem = job_mem[task_of_job]
    snap.task_resreq = np.zeros((T_pad, R), dtype=np.float32)
    snap.task_resreq[:n_tasks, 0] = cpu
    snap.task_resreq[:n_tasks, 1] = mem
    snap.task_job = np.zeros(T_pad, dtype=np.int32)
    snap.task_job[:n_tasks] = task_of_job

    snap.task_sel_bits = np.zeros((T_pad, W), dtype=np.uint32)
    snap.task_tol_bits = np.zeros((T_pad, W), dtype=np.uint32)
    snap.node_label_bits = np.zeros((N_pad, W), dtype=np.uint32)
    snap.node_taint_bits = np.zeros((N_pad, W), dtype=np.uint32)

    if label_classes > 0:
        # Each job requires one of ``label_classes`` zones; nodes spread
        # uniformly across zones (predicate-pressure config).
        job_zone = rng.randint(0, label_classes, size=n_jobs)
        node_zone = np.arange(n_nodes) % label_classes
        for t in range(n_tasks):
            z = job_zone[snap.task_job[t]]
            snap.task_sel_bits[t, z // 32] |= np.uint32(1 << (z % 32))
        for n in range(n_nodes):
            z = node_zone[n]
            snap.node_label_bits[n, z // 32] |= np.uint32(1 << (z % 32))

    if taint_fraction > 0:
        tainted = rng.rand(n_nodes) < taint_fraction
        snap.node_taint_bits[:n_nodes][tainted, 1] |= np.uint32(1 << 31)
        # A third of tasks tolerate the taint.
        tolerant = rng.rand(n_tasks) < 0.33
        snap.task_tol_bits[:n_tasks][tolerant, 1] |= np.uint32(1 << 31)

    snap.node_idle = np.zeros((N_pad, R), dtype=np.float32)
    snap.node_idle[:n_nodes, 0] = node_cpu_milli
    snap.node_idle[:n_nodes, 1] = node_mem_mib
    snap.node_used = np.zeros((N_pad, R), dtype=np.float32)
    snap.node_alloc = snap.node_idle.copy()
    snap.node_ok = np.zeros(N_pad, dtype=bool)
    snap.node_ok[:n_nodes] = True
    snap.node_task_count = np.zeros(N_pad, dtype=np.int32)
    snap.node_max_tasks = np.zeros(N_pad, dtype=np.int32)
    snap.node_max_tasks[:n_nodes] = 110

    snap.job_min_available = np.zeros(J_pad, dtype=np.int32)
    snap.job_min_available[:n_jobs] = gang_size
    snap.job_min_available[n_jobs:] = np.iinfo(np.int32).max
    snap.job_ready_count = np.zeros(J_pad, dtype=np.int32)
    snap.task_has_preferences = np.zeros(T_pad, dtype=bool)

    snap.task_uids = [f"t{i}" for i in range(n_tasks)]
    snap.node_names = [f"n{i}" for i in range(n_nodes)]
    snap.job_uids = [f"j{i}" for i in range(n_jobs)]
    return snap


#: The allocate configs of BASELINE.json (name → generator kwargs).
BASELINE_CONFIGS = {
    "1k_pods_100_nodes_binpack": dict(n_tasks=1_000, n_nodes=100, gang_size=1),
    "10k_pods_1k_nodes_fairshare": dict(n_tasks=10_000, n_nodes=1_000, gang_size=4),
    "50k_pods_10k_nodes_gang_predicates": dict(
        n_tasks=50_000, n_nodes=10_000, gang_size=8, label_classes=8, taint_fraction=0.1
    ),
}
