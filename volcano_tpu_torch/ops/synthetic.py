"""Synthetic packed-session generators for the configs of BASELINE.json.

Copies of ``generate_snapshot``, ``generate_cluster_objects`` and
``generate_preempt_packed`` from ``volcano_tpu/ops/synthetic.py``:
generation is numpy ``RandomState(seed)`` in the same call order, so the
same arguments give byte-identical arrays (and API objects whose dicts
are equal) in both packages.  ``generate_lr_mode_split``,
``add_scalar_lanes``, ``generate_preempt_cluster_objects`` (the
preempt config as API objects) and the scheduler loop's churn
(``loop_world``, ``record_binds``, ``generate_loop_events``) are the
port's own.
"""

from __future__ import annotations

import json

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


def generate_preempt_cluster_objects(
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
):
    """The cluster of :func:`generate_preempt_packed` as API objects, for
    driving a whole preempting cycle (cache feed → session → enqueue,
    gpu-allocate, gpu-preempt, backfill).

    Nodes of ``node_cpu_milli`` / ``node_mem_mib`` MiB (MiB-aligned, so
    the packed sessions stay exact and the preempt kernel's f32 envelope
    holds); victims placed round-robin over the nodes, ``Running`` at
    7000m / 16 GiB with priority 0, in jobs of ``victim_job_size``, of
    which ``blocked_job_fraction`` (seeded) sit at minAvailable = their
    size and the rest at 1; preemptors ``Pending`` at 6000m / 8 GiB in
    gangs of ``gang_size`` with minAvailable ``max(1, gang_size -
    (n_queues - 1))``, under the priority class ``high`` (100).  Job row
    j (victim jobs first, then preemptor jobs) sits in queue ``j %
    n_queues`` (weight 1 each), so preemption stays in-queue; every
    PodGroup is ``Inqueue``.

    Returns (nodes, pods, pod_groups, queues, priority_classes)."""
    from volcano_tpu_torch.apis import core, scheduling

    rng = np.random.RandomState(seed)
    P = n_preemptors
    n_pjobs = max(1, P // gang_size)
    n_vjobs = max(1, n_victims // victim_job_size)

    alloc = {"cpu": f"{node_cpu_milli}m", "memory": f"{node_mem_mib}Mi", "pods": 110}
    nodes = [
        core.Node(
            metadata=core.ObjectMeta(name=f"n{i:05d}", namespace="", uid=f"node-{i}",
                                     creation_timestamp=float(i)),
            spec=core.NodeSpec(taints=[], unschedulable=False),
            status=core.NodeStatus(allocatable=dict(alloc), capacity=dict(alloc)),
        )
        for i in range(n_nodes)
    ]
    queues = [
        scheduling.Queue(
            metadata=core.ObjectMeta(name=f"q{k}", namespace="", uid=f"q-{k}",
                                     creation_timestamp=float(k)),
            spec=scheduling.QueueSpec(weight=1, capability={}),
        )
        for k in range(n_queues)
    ]
    priority_classes = [
        core.PriorityClass(metadata=core.ObjectMeta(name="high", namespace="", uid="pc-high"),
                           value=100)
    ]

    vic_job_of = np.minimum(np.arange(n_victims) // victim_job_size, n_vjobs - 1)
    vj_sizes = np.bincount(vic_job_of, minlength=n_vjobs)
    blocked = rng.rand(n_vjobs) < blocked_job_fraction
    vj_min = np.where(blocked, vj_sizes, 1)
    p_min = max(1, gang_size - (n_queues - 1))

    def pod_group(name: str, j: int, min_member: int, priority_class: str):
        return scheduling.PodGroup(
            metadata=core.ObjectMeta(name=name, namespace="bench", uid=f"pg-{name}",
                                     creation_timestamp=float(j)),
            spec=scheduling.PodGroupSpec(
                min_member=int(min_member), queue=f"q{j % n_queues}", min_resources={},
                priority_class_name=priority_class,
            ),
            status=scheduling.PodGroupStatus(phase=scheduling.POD_GROUP_INQUEUE),
        )

    pod_groups = [pod_group(f"vj{j:05d}", j, vj_min[j], "") for j in range(n_vjobs)]
    pod_groups += [pod_group(f"pj{k:05d}", n_vjobs + k, p_min, "high")
                   for k in range(n_pjobs)]

    def pod(name: str, ts: float, group: str, cpu_milli: int, mem_mib: int, node: str,
            phase: str, priority: int, priority_class: str):
        container = core.Container(
            name="main",
            resources={"requests": {"cpu": f"{cpu_milli}m", "memory": f"{mem_mib}Mi"}},
        )
        return core.Pod(
            metadata=core.ObjectMeta(
                name=name, namespace="bench", uid=f"pod-{name}", creation_timestamp=ts,
                annotations={scheduling.GROUP_NAME_ANNOTATION_KEY: group},
            ),
            spec=core.PodSpec(containers=[container], node_name=node, node_selector={},
                              tolerations=[], affinity={}, priority=priority,
                              priority_class_name=priority_class),
            status=core.PodStatus(phase=phase),
        )

    pods = [
        pod(f"victim-{i:06d}", float(i), f"vj{int(vic_job_of[i]):05d}", 7000, 16_384,
            f"n{i % n_nodes:05d}", "Running", 0, "")
        for i in range(n_victims)
    ]
    pods += [
        pod(f"pre-{i:06d}", float(n_victims + i), f"pj{min(i // gang_size, n_pjobs - 1):05d}",
            6000, 8192, "", "Pending", 100, "high")
        for i in range(P)
    ]
    return nodes, pods, pod_groups, queues, priority_classes


# ---- the scheduler loop's churn (chip_smoke.py's loop cells) ----

#: request shapes of generate_cluster_objects' jobs (cpu milli, memory MiB)
LOOP_CPU = (250, 500, 1000, 2000, 4000)
LOOP_MEM = (256, 512, 1024, 2048, 4096, 8192)
#: the share of fully bound gangs that finish before each loop cycle
LOOP_FINISH_FRACTION = 0.1
#: nodes relabelled before each loop cycle (1% of the churn cell's)
LOOP_RELABELLED = 10
#: cpu the gangs that select the relabelled nodes ask for, as a multiple
#: of those nodes' free cpu
LOOP_BACKLOG = 1.25


def loop_world(objects) -> dict:
    """The store a loop cell starts from: ``generate_cluster_objects``'
    (nodes, pods, pod_groups, queues) as dicts (``apis.serde.to_dict``),
    keyed by name (nodes, queues) and ``ns/name`` (pods, pod groups),
    with the config's gang size.  :func:`record_binds` and
    :func:`generate_loop_events` keep it equal to what the store would
    hold."""
    from volcano_tpu_torch.apis import serde

    nodes, pods, pod_groups, queues = objects

    def key(d):
        m = d["metadata"]
        return f"{m['namespace']}/{m['name']}" if m.get("namespace") else m["name"]

    world = {kind: {key(d): d for d in map(serde.to_dict, objs)}
             for kind, objs in (("nodes", nodes), ("pods", pods),
                                ("pod_groups", pod_groups), ("queues", queues))}
    world["gang_size"] = max(d["spec"]["minMember"] for d in world["pod_groups"].values())
    return world


def record_binds(world: dict, binds) -> None:
    """Bound pods (``(ns/name, hostname)`` pairs, a binder's record) are
    Running on their nodes in the store."""
    for name, host in binds:
        pod = world["pods"][name]
        pod["spec"]["nodeName"] = host
        pod["status"]["phase"] = "Running"


def generate_loop_events(world: dict, cycle: int, seed: int = 0) -> list:
    """The store's events between cycle ``cycle - 1`` and ``cycle`` of a
    loop cell, applied to ``world``; each is a dict ``{"op": "add" |
    "update" | "delete", "kind": "node" | "pod" | "pod_group", "object":
    dict}`` (an update also carries ``"old"``), for ``cache.feed_events``
    (or the same handlers of the JAX package's cache).  Seeded by
    ``(seed, cycle)``:

      * ``LOOP_FINISH_FRACTION`` of the gangs whose pods are all bound
        finish: their pods are deleted, then their PodGroups;
      * ``LOOP_RELABELLED`` nodes get a new label pair ``loop-rack:
        c<cycle>`` (``update_node``);
      * new gangs of the config's gang size and request shapes arrive:
        one gang more than the finished ones, and gangs selecting the new
        label pair, as many as ask for ``LOOP_BACKLOG`` times the free
        cpu of the relabelled nodes, so some of them stay pending across
        cycles (the whole cluster has room to spare: at 10k pods x 1k
        nodes the config's pods fill about a quarter of its cpu).
    """
    from volcano_tpu_torch.apis.quantity import milli_value
    from volcano_tpu_torch.apis.scheduling import GROUP_NAME_ANNOTATION_KEY as GROUP

    rng = np.random.RandomState([seed, cycle])
    gang = world["gang_size"]
    pods, groups, nodes = world["pods"], world["pod_groups"], world["nodes"]
    members = {}
    for name, pod in pods.items():
        group = pod["metadata"]["annotations"][GROUP]
        members.setdefault(f"{pod['metadata']['namespace']}/{group}", []).append(name)
    events = []

    bound = sorted(g for g in groups
                   if members.get(g) and all(pods[p]["spec"].get("nodeName")
                                             for p in members[g]))
    n_finish = int(round(LOOP_FINISH_FRACTION * len(bound)))
    finished = [bound[i] for i in sorted(rng.choice(len(bound), n_finish, replace=False))]
    for g in finished:
        for p in members[g]:
            events.append({"op": "delete", "kind": "pod", "object": pods.pop(p)})
    for g in finished:
        events.append({"op": "delete", "kind": "pod_group", "object": groups.pop(g)})

    pair = ("loop-rack", f"c{cycle}")
    names = sorted(nodes)
    relabelled = [names[i] for i in sorted(rng.choice(len(names), LOOP_RELABELLED,
                                                      replace=False))]
    for name in relabelled:
        old = nodes[name]
        new = json.loads(json.dumps(old))
        new["metadata"].setdefault("labels", {})[pair[0]] = pair[1]
        nodes[name] = new
        events.append({"op": "update", "kind": "node", "old": old, "object": new})

    used = dict.fromkeys(relabelled, 0.0)
    for pod in pods.values():
        host = pod["spec"].get("nodeName")
        if host in used:
            used[host] += milli_value(pod["spec"]["containers"][0]["resources"]
                                      ["requests"]["cpu"])
    free = sum(milli_value(nodes[n]["status"]["allocatable"]["cpu"]) - used[n]
               for n in relabelled)

    def arrive(j: int, selector) -> float:
        """One arriving gang; returns its cpu request."""
        cpu, mem = int(rng.choice(LOOP_CPU)), int(rng.choice(LOOP_MEM))
        name = f"loop{cycle:02d}-{j:05d}"
        stamp = float(1_000_000 * cycle + j)
        groups[f"bench/{name}"] = pg = {
            "metadata": {"name": name, "namespace": "bench", "uid": f"pg-{name}",
                         "creationTimestamp": stamp},
            "spec": {"minMember": gang, "queue": "default"},
            "status": {"phase": "Inqueue"},
        }
        events.append({"op": "add", "kind": "pod_group", "object": pg})
        for i in range(gang):
            pod_name = f"{name}-{i}"
            spec = {"containers": [{"name": "main", "resources": {
                "requests": {"cpu": f"{cpu}m", "memory": f"{mem}Mi"}}}],
                "nodeName": ""}
            if selector:
                spec["nodeSelector"] = dict([selector])
            pods[f"bench/{pod_name}"] = pod = {
                "metadata": {"name": pod_name, "namespace": "bench",
                             "uid": f"pod-{pod_name}",
                             "annotations": {GROUP: name},
                             "creationTimestamp": stamp},
                "spec": spec,
                "status": {"phase": "Pending"},
            }
            events.append({"op": "add", "kind": "pod", "object": pod})
        return cpu * gang

    j = 0
    for j in range(len(finished) + 1):
        arrive(j, None)
    asked = 0.0
    while asked < LOOP_BACKLOG * free:
        j += 1
        asked += arrive(j, pair)
    return events
