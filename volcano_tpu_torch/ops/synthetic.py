"""Synthetic packed-session generators for the configs of BASELINE.json.

Copies of ``generate_snapshot``, ``generate_cluster_objects`` and
``generate_preempt_packed`` from ``volcano_tpu/ops/synthetic.py``:
generation is numpy ``RandomState(seed)`` in the same call order, so the
same arguments give byte-identical arrays (and API objects whose dicts
are equal) in both packages.  ``generate_lr_mode_split`` and
``add_scalar_lanes`` are the port's own.
"""

from __future__ import annotations

import numpy as np

from volcano_tpu_torch.api.resource import MIN_MEMORY, MIN_MILLI_CPU
from volcano_tpu_torch.ops.packing import _bucket, MIB, PackedSnapshot
from volcano_tpu_torch.ops.preempt_pack import PreemptPacked


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


def generate_lr_mode_split() -> PackedSnapshot:
    """A session outside the f32 floor-division envelope whose one task
    the f32 least-requested path and the exact int32 path place on
    different nodes (the port's own generator, not a copy).

    Node 0's memory lane is ((5,000,003 - 1,500,001) * 10) // 5,000,003
    = 6 in int32 and 7 in f32: the correction's product 7 * 5,000,003
    rounds to 35,000,020, which no longer exceeds p.  With its cpu lane
    at 5, node 0 scores 18.0 in f32 and 17.0 in int32, around node 1's
    17.526417 in both, so f32 picks node 0 and int32 node 1."""
    snap = generate_snapshot(n_tasks=1, n_nodes=2, gang_size=1)
    snap.task_resreq[0] = (1_000.0, 4_096.0)
    snap.node_alloc[:2] = (224_000.0, 5_000_003.0)
    snap.node_used[:2] = ((111_000.0, 1_495_905.0), (0.0, 500_000.0))
    snap.node_idle[:2] = snap.node_alloc[:2] - snap.node_used[:2]
    return snap


def add_scalar_lanes(snap, n_lanes: int, seed: int):
    """Append ``n_lanes`` scalar resource lanes (device-plugin counts in
    milli-units: GPUs, RDMA devices, hugepages) to a packed snapshot's
    arrays, in place, and return it: a fifth of the nodes have none of a
    lane, and each gang asks for 0 to 2 units of each lane (the port's
    own generator; numpy only, so it serves either package's
    snapshot)."""
    rng = np.random.RandomState(seed)
    N = snap.node_idle.shape[0]
    cap = rng.choice([0.0, 4_000.0, 8_000.0], size=(N, n_lanes), p=[0.2, 0.4, 0.4])
    used = np.minimum(cap, rng.randint(0, 3, size=(N, n_lanes)) * 1_000.0)
    job_req = rng.randint(0, 3, size=(snap.job_min_available.shape[0], n_lanes)) * 1_000.0
    req = job_req[snap.task_job]
    req[snap.n_tasks:] = 0.0

    def grow(a, extra):
        return np.ascontiguousarray(np.concatenate([a, extra.astype(a.dtype)], axis=1))

    snap.task_resreq = grow(snap.task_resreq, req)
    snap.node_alloc = grow(snap.node_alloc, cap)
    snap.node_used = grow(snap.node_used, used)
    snap.node_idle = grow(snap.node_idle, cap - used)
    snap.tolerance = np.concatenate([snap.tolerance, np.full(n_lanes, 10.0, np.float32)])
    snap.resource_names = list(snap.resource_names) + [f"scalar-{i}" for i in range(n_lanes)]
    return snap


def generate_cluster_objects(
    n_tasks: int,
    n_nodes: int,
    gang_size: int = 8,
    seed: int = 0,
    label_classes: int = 0,
    taint_fraction: float = 0.0,
    node_cpu_milli: int = 64_000,
    node_mem_mib: int = 262_144,
):
    """The same cluster shape as :func:`generate_snapshot`, but as API
    objects (nodes/pods/pod groups/queues) for driving the REAL framework
    path: cache feed → session open → gpu-allocate action → bindings.
    Resource values are MiB-aligned so the packed session stays inside
    the exactness envelope (the bulk-apply fast path refuses otherwise).

    Returns (nodes, pods, pod_groups, queues)."""
    from volcano_tpu_torch.apis import core, scheduling

    rng = np.random.RandomState(seed)
    n_jobs = max(1, n_tasks // gang_size)

    job_cpu = rng.choice([250, 500, 1000, 2000, 4000], size=n_jobs)
    job_mem = rng.choice([256, 512, 1024, 2048, 4096, 8192], size=n_jobs)
    job_zone = (
        rng.randint(0, label_classes, size=n_jobs) if label_classes > 0 else None
    )
    tainted = (
        rng.rand(n_nodes) < taint_fraction if taint_fraction > 0 else None
    )
    tolerant = (
        rng.rand(n_tasks) < 0.33 if taint_fraction > 0 else None
    )

    nodes = []
    for i in range(n_nodes):
        labels = {}
        if label_classes > 0:
            labels["zone"] = f"z{i % label_classes}"
        taints = (
            [core.Taint(key="dedicated", value="special", effect="NoSchedule")]
            if tainted is not None and tainted[i]
            else []
        )
        alloc = {
            "cpu": f"{node_cpu_milli}m",
            "memory": f"{node_mem_mib}Mi",
            "pods": 110,
        }
        nodes.append(
            core.Node(
                metadata=core.ObjectMeta(
                    name=f"n{i:05d}", namespace="", uid=f"node-{i}",
                    labels=labels, creation_timestamp=float(i),
                ),
                spec=core.NodeSpec(taints=taints, unschedulable=False),
                status=core.NodeStatus(allocatable=alloc, capacity=dict(alloc)),
            )
        )

    queues = [
        scheduling.Queue(
            metadata=core.ObjectMeta(
                name="default", namespace="", uid="q-default",
                creation_timestamp=0.0,
            ),
            spec=scheduling.QueueSpec(weight=1, capability={}),
        )
    ]

    pod_groups, pods = [], []
    for j in range(n_jobs):
        pod_groups.append(
            scheduling.PodGroup(
                metadata=core.ObjectMeta(
                    name=f"pg{j:05d}", namespace="bench", uid=f"pg-{j}",
                    creation_timestamp=float(j),
                ),
                spec=scheduling.PodGroupSpec(
                    min_member=gang_size, queue="default", min_resources={},
                ),
                status=scheduling.PodGroupStatus(
                    phase=scheduling.POD_GROUP_INQUEUE
                ),
            )
        )
    for i in range(n_tasks):
        j = min(i // gang_size, n_jobs - 1)
        selector = (
            {"zone": f"z{job_zone[j]}"} if job_zone is not None else {}
        )
        tols = (
            [core.Toleration(key="dedicated", operator="Equal",
                             value="special", effect="NoSchedule")]
            if tolerant is not None and tolerant[i]
            else []
        )
        container = core.Container(
            name="main",
            resources={
                "requests": {
                    "cpu": f"{int(job_cpu[j])}m",
                    "memory": f"{int(job_mem[j])}Mi",
                }
            },
        )
        pods.append(
            core.Pod(
                metadata=core.ObjectMeta(
                    name=f"p{i:06d}", namespace="bench", uid=f"pod-{i}",
                    annotations={
                        scheduling.GROUP_NAME_ANNOTATION_KEY: f"pg{j:05d}"
                    },
                    creation_timestamp=float(i),
                ),
                spec=core.PodSpec(
                    containers=[container], node_name="",
                    node_selector=selector, tolerations=tols, affinity={},
                ),
                status=core.PodStatus(phase="Pending"),
            )
        )
    return nodes, pods, pod_groups, queues


#: The configs of BASELINE.json (name → generator kwargs).
BASELINE_CONFIGS = {
    "1k_pods_100_nodes_binpack": dict(n_tasks=1_000, n_nodes=100, gang_size=1),
    "10k_pods_1k_nodes_fairshare": dict(n_tasks=10_000, n_nodes=1_000, gang_size=4),
    "50k_pods_10k_nodes_gang_predicates": dict(
        n_tasks=50_000, n_nodes=10_000, gang_size=8, label_classes=8, taint_fraction=0.1
    ),
    "100k_pods_10k_nodes_preempt": dict(
        # 90k Running victims saturating node cpu + 10k pending
        # high-priority gang preemptors, 4 queues, measured through the
        # preempt pass (generator: generate_preempt_packed; the
        # ``preempt`` marker routes it)
        preempt=True,
        n_victims=90_000,
        n_nodes=10_000,
        n_preemptors=10_000,
    ),
}


def generate_preempt_packed(
    n_victims: int,
    n_nodes: int,
    n_preemptors: int,
    gang_size: int = 8,
    victim_job_size: int = 8,
    n_queues: int = 4,
    blocked_job_fraction: float = 0.2,
    seed: int = 0,
    node_cpu_milli: int = 64_000,
    node_mem_mib: int = 262_144,
) -> PreemptPacked:
    """BASELINE config 5: a preemption-pressure cluster for the preempt
    pass (100k pods = Running victims + pending high-priority gangs over
    10k nodes, 2-level queue hierarchy root-{a,b}/q{0,1}).

    Victims saturate node cpu (``victims_per_node`` × 7000m of 64000m →
    1000m idle), preemptors ask 6000m each, so nearly every placement
    must evict one victim — the pass is real preemption, not allocation
    through idle headroom.  ``blocked_job_fraction`` of victim jobs sit
    at their minAvailable floor, so the gang plugin vetoes their
    eviction (gang.go:75-94) and eligibility filtering is exercised.
    In-queue semantics: victim/preemptor jobs spread across ``n_queues``
    queues and preemptors may only evict same-queue victims
    (preempt.go:86-143).

    Returns a PreemptPacked — the packed form IS the session input for
    preempt_dense and the CUDA preempt kernel."""
    rng = np.random.RandomState(seed)
    R, W = 2, 2
    P = n_preemptors

    n_pjobs = max(1, P // gang_size)
    n_vjobs = max(1, n_victims // victim_job_size)
    J = n_vjobs + n_pjobs

    # ---- base snapshot: preemptor tasks + nodes ----
    T_pad = _bucket(P)
    N_pad = _bucket(n_nodes)
    base = PackedSnapshot()
    base.resource_names = ["cpu", "memory"]
    base.tolerance = np.array([MIN_MILLI_CPU, MIN_MEMORY / MIB], dtype=np.float32)
    base.n_tasks, base.n_nodes, base.n_jobs = P, n_nodes, J

    base.task_resreq = np.zeros((T_pad, R), dtype=np.float32)
    base.task_resreq[:P, 0] = 6000
    base.task_resreq[:P, 1] = 8192
    base.task_job = np.zeros(T_pad, dtype=np.int32)
    base.task_job[:P] = n_vjobs + np.minimum(np.arange(P) // gang_size, n_pjobs - 1)
    base.task_sel_bits = np.zeros((T_pad, W), dtype=np.uint32)
    base.task_tol_bits = np.zeros((T_pad, W), dtype=np.uint32)
    base.task_has_preferences = np.zeros(T_pad, dtype=bool)

    # victims: spread round-robin over nodes; per-node list order IS the
    # eviction order (inverse task order — youngest first)
    vic_node_of = np.arange(n_victims) % n_nodes
    vic_job_of = np.minimum(np.arange(n_victims) // victim_job_size, n_vjobs - 1)
    vic_cpu = np.full(n_victims, 7000.0, dtype=np.float32)
    vic_mem = np.full(n_victims, 16384.0, dtype=np.float32)

    used = np.zeros((N_pad, R), dtype=np.float32)
    np.add.at(used[:, 0], vic_node_of, vic_cpu)
    np.add.at(used[:, 1], vic_node_of, vic_mem)

    base.node_alloc = np.zeros((N_pad, R), dtype=np.float32)
    base.node_alloc[:n_nodes, 0] = node_cpu_milli
    base.node_alloc[:n_nodes, 1] = node_mem_mib
    base.node_used = used
    base.node_idle = base.node_alloc - used
    base.node_idle[n_nodes:] = 0
    base.node_label_bits = np.zeros((N_pad, W), dtype=np.uint32)
    base.node_taint_bits = np.zeros((N_pad, W), dtype=np.uint32)
    base.node_ok = np.zeros(N_pad, dtype=bool)
    base.node_ok[:n_nodes] = True
    base.node_task_count = np.zeros(N_pad, dtype=np.int32)
    counts = np.bincount(vic_node_of, minlength=n_nodes).astype(np.int32)
    base.node_task_count[:n_nodes] = counts
    base.node_max_tasks = np.zeros(N_pad, dtype=np.int32)
    base.node_max_tasks[:n_nodes] = 110

    J_pad = _bucket(J, minimum=16)
    base.job_min_available = np.zeros(J_pad, dtype=np.int32)
    base.job_ready_count = np.zeros(J_pad, dtype=np.int32)
    base.task_uids = [f"p{i}" for i in range(P)]
    base.node_names = [f"n{i}" for i in range(n_nodes)]
    base.job_uids = [f"vj{i}" for i in range(n_vjobs)] + [
        f"pj{i}" for i in range(n_pjobs)
    ]

    pk = PreemptPacked(base=base)
    pk.ptask_uids = list(base.task_uids)
    pk.node_names = list(base.node_names)
    pk.node_fi0 = base.node_idle.copy()  # no releasing/pipelined at open

    # victims sorted node-major (per-node order = eviction order)
    order = np.argsort(vic_node_of, kind="stable")
    pk.n_victims = n_victims
    pk.vic_resreq = np.stack([vic_cpu[order], vic_mem[order]], axis=1)
    pk.vic_node = vic_node_of[order].astype(np.int32)
    pk.vic_job = vic_job_of[order].astype(np.int32)
    pk.vic_uids = [f"v{i}" for i in order]
    pk.vic_names = [f"ns/victim-{i}" for i in order]

    # job tables: victim jobs (rows 0..n_vjobs-1) then preemptor jobs
    pk.n_jobs = J
    pk.job_prio = np.concatenate(
        [np.zeros(n_vjobs, dtype=np.int64), np.full(n_pjobs, 100, dtype=np.int64)]
    )
    vj_sizes = np.bincount(vic_job_of, minlength=n_vjobs).astype(np.int32)
    blocked = rng.rand(n_vjobs) < blocked_job_fraction
    vj_min = np.where(blocked, vj_sizes, 1).astype(np.int32)
    # The host's phase-2 sweep iterates the GLOBAL under-request list
    # inside the per-queue loop (preempt.go:146-175), consuming one task
    # of every still-starving job per earlier queue — so a gang in queue
    # q has only gang_size - q tasks left for its own phase 1.  Keep
    # minAvailable low enough that later queues' gangs can still commit.
    p_min = max(1, gang_size - (n_queues - 1))
    pk.job_min_avail = np.concatenate(
        [vj_min, np.full(n_pjobs, p_min, dtype=np.int32)]
    )
    pk.job_ready0 = np.concatenate(
        [vj_sizes, np.zeros(n_pjobs, dtype=np.int32)]
    )
    pk.job_waiting0 = np.zeros(J, dtype=np.int32)
    # 2-level hierarchy root-{a,b}/q{0,1} flattened to queue rows
    pk.job_queue = (np.arange(J) % n_queues).astype(np.int32)
    pk.job_uids = list(base.job_uids)

    pk.job_ptask_start = np.zeros(J, dtype=np.int32)
    pk.job_ptask_end = np.zeros(J, dtype=np.int32)
    for pj in range(n_pjobs):
        j = n_vjobs + pj
        pk.job_ptask_start[j] = pj * gang_size
        # the last job absorbs any remainder tasks (task_job clamps to
        # n_pjobs-1 above), so its range must extend to P
        pk.job_ptask_end[j] = P if pj == n_pjobs - 1 else (pj + 1) * gang_size

    # schedule: per queue, starving (preemptor) jobs in job order, then
    # the global under-request sweep (preempt.go:86-143, :146-175)
    pjob_rows = [n_vjobs + pj for pj in range(n_pjobs)]
    sched = []
    for q in range(n_queues):
        for j in pjob_rows:
            if pk.job_queue[j] == q:
                sched.append((1, j))
        for j in pjob_rows:
            sched.append((2, j))
    pk.schedule = np.array(sched, dtype=np.int32)
    return pk
