#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py        (from the repository root)

Phases, each of which fails the run:
  1. device  — the card's name and power limit; build the CUDA kernels
     from this checkout's sources;
  2. kernel  — each kernel against its plain PyTorch version on the card:
     the session kernel (``chosen`` equal; its fast steps equal to the
     repeated rows counted on the host) on small generated sessions and
     on LIST_CASES (no predicates at
     10,000 nodes, 16,384 nodes where the masked-score plane does not
     fit, inactive rows inside gangs, repeated rows after a -1 pick),
     each with the plane the wrapper picks and again with the plane off;
     the preempt kernel (``evicted``, ``pipelined`` and its counts equal;
     its fast attempts equal to the count the host makes from the plain
     pass's fired attempts and rollbacks) on small generated sessions and
     on copies edited to reach each of its branches (PREEMPT_EDITS), each
     with the plane the wrapper picks and again with the plane off;
  3. main paths — ``execute_allocate(snap)`` with no device at full width
     (50k pods x 10k nodes, then 10k x 1k), and ``execute_preempt(pk)``
     with no device on 100k pods (90k victims + 10k preemptors) x 10k
     nodes: each must run through its kernel (launch count > 0, executor
     ``cuda``) and equal the port's PyTorch specification (and, for
     preempt, the plain pass) on the same session; the session kernel's
     fast steps must equal the repeated rows counted on the host, the
     preempt kernel's fast attempts the host's count, and each kernel
     with its plane off must equal the pass with it; latency, kernel time
     (plane on and off), bounds, latency floors and the probes are printed
     beside the card's name and power limit;
  4. int mode and wide instance — the session kernel's int-exact
     least-requested mode against its plain version on the phase 2
     shapes at DGX H100 node sizes, plane on and off, and on a session
     where the f32 and the int32 path pick different nodes; its wide
     instance (node state in global memory, lanes counted at run time)
     against its plain version on WIDE_CASES (20k nodes, f32 and int
     mode; 9 and 5 lanes; 60k nodes in one list, the plane in global
     memory and picks past list position 2^15), plane on and off;
  5. this slice's cells — the DGX H100 cell (50k pods x 10k nodes of 224
     threads and 2 TB) through ``execute_allocate`` on the kernel in int
     mode, equal to the torch spec; the wide cell (50k x 20k nodes, node
     state over one block's shared memory) through ``execute_allocate`` on
     the wide instance, equal to the torch spec and, at full width, to
     its plain version; a 9-lane session at 10k x 1k on the wide
     instance, equal to the torch spec; ``run_packed_blocked`` (torch
     ops, on no dispatch path) at 50k x 10k and on the wide cell, equal
     to the kernel;
  6. the cycle — the port's scheduling cycle, a scheduler's entry
     point: cluster objects (``generate_cluster_objects``) fed to a fresh
     ``SchedulerCache``, ``open_session`` with the headline tiers,
     ``GpuAllocateAction().execute`` (ORDER, pack, the session kernel,
     the bulk commit), ``close_session``; CYCLE_RUNS cycles at 50k x 10k
     and again at 10k x 1k, each placing every pod through the kernel
     (executor ``cuda``, launches > 0) with the bulk commit taking every
     task, no kernel failure, and binds whose sha256 is the JAX
     package's jax-allocate's on the same objects (CYCLE_DIGESTS); the
     median and max of each step and of the action's phases are printed,
     and a ``{"cycle": ...}`` line for each config; then the preempting
     cycle (``phase_preempt_cycle``): the preempt config's cluster as
     objects (``generate_preempt_cluster_objects``: 90k Running victims
     saturating 10k nodes, 10k pending high-priority preemptors in gangs
     of 8, 4 queues; and the same at 9k x 1k), ``enqueue``,
     ``gpu-allocate`` (every preemptor unplaceable, explained from the
     device's reason counts with no host-chooser sweep), ``gpu-preempt``
     (the preempt kernel, one launch, executor ``cuda``, route
     ``device``; evictions and pipelines applied through a statement),
     ``backfill``; PREEMPT_CYCLE_RUNS cycles a cell on fresh caches, each
     with the JAX package's digest of (evictions, pipelined placements)
     (PREEMPT_CYCLE_DIGESTS) and a ``{"preempt_cycle": ...}`` line a
     cell.  No kernel failure may be counted on any main path;
  7. failures — the fault plane drives the breakers on the card: an
     injected lowering failure or corrupt output raises ``ExecutorFailed``
     and is counted, three open the breaker, the fourth call is refused
     without a launch, the same for preempt-cuda; nothing runs in the
     kernel's place; then the plane and the breakers are reset and a
     clean session runs on the kernel again.
Then one JSON line with the blocked formulation's times (torch ops, not
a kernel), one JSON line listing each kernel with its launches, its match with
the plain version, its time, the plain version's time, its bound by
bytes and operations and its latency floor (the serial chain, timed link
by link by the step probe), and as the last line the device record.

Exits non-zero, printing no result, when no GPU is present.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and f32 operations/s
#: outside the tensor cores at one operation per instruction — the sheet's
#: 67 TFLOP/s counts a fused multiply-add as two, and the kernel is built
#: with --fmad=false, so it issues none
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 33.5e12


def mask_ops(R: int) -> int:
    """f32 operations one step needs on every node, counted from
    vt::masked_score (session_math.cuh): the fit, 3 per lane (sub, add,
    compare) and 2 more per scalar lane; pod count 1; class 1; the -inf
    select 1; the argmax compare 1."""
    return 3 * R + 2 * max(R - 2, 0) + 4


def score_ops(R: int) -> int:
    """f32 operations of vt::node_score on one node, needed only where the
    task's class may go: binpack 7 per lane (add, two compares, max, mul,
    div, select) and 1 per further lane to sum them, then 2 (divide by the
    weight sum, scale); least-requested 33 over its two lanes; its floor 2;
    balanced 8; the weighted total 4.  Terms fixed per task (lane
    weights, their sum) are left out, and a division counts as one
    operation though it takes several instructions: the count is a floor."""
    return 8 * R + 48


def score_ops_int(R: int) -> int:
    """score_ops(R) with least-requested in int32 (vt::lr_lane_int): per
    lane two saturating converts (3 each), the guard (3), subtract,
    multiply, divide and the floor fix (2), the select: 15, 30 over two
    lanes; the sum, its floor division by 2 (2) and the convert back: 34
    in place of the f32 path's 35.  Counted at the f32 rate (the card's
    int32 rate is not above it), so the count stays a floor."""
    return score_ops(R) - 35 + 34


#: f32 operations per occupied victim slot of one fired preempt attempt,
#: counted from vt::victim_eligible (preempt_math.cuh): the evicted test,
#: the gang allowance (compare, subtract, compare, or), priority, queue
#: and job compares, and three ands; the sum over eligible slots is left
#: out, so the count is a floor
ELIG_OPS = 11


def validate_ops(R: int) -> int:
    """f32 operations of vt::node_validates on one node, plus the masked
    select and the argmax compare: the fit, 3 per lane (add, add,
    compare) and 2 more per scalar lane; class, pod count, victim count."""
    return 3 * R + 2 * max(R - 2, 0) + 5


#: dependent global loads in the serial chain of the preempt kernel
#: before its redesign, the latency floor as first defined: every slot
#: thread 0 walks reads its schedule row, then the job's cursor/ready/waiting/
#: min_available (2); a fired attempt adds the task row, the sweep of one
#: node (victim job, then its job-table row) and the drain (the node's
#: column, then its victims' job rows): 5 more, beside 2 block barriers,
#: 2 shared round trips and the two argmax halves
SLOT_LOADS = 2
FIRED_LOADS = 5

#: the same for the redesigned kernel's chain, counted from
#: csrc/preempt_step.cuh: a slot's row is loaded a slot ahead, so a slot
#: is the job's cursor and counts, loaded together (1); a fired attempt
#: adds the task row with the job's priority, queue and victim flag (1),
#: its queue's list bounds (1) and the drain, which loads before it stores
#: and keeps the node's state in registers: per chunk of PREEMPT_CHUNK
#: listed slots, the slot planes, then the eviction flags and ready
#: counts (2; the node's id and state load beside the first chunk's) —
#: beside the same barriers, round trips and argmax halves
CHAIN_SLOT_LOADS = 1
PREEMPT_CHUNK = 4  # vt::kChunk


def chain_fired_loads(KQ: int) -> int:
    """Dependent loads a fired attempt adds to the chain (see above)."""
    return 2 + 2 * -(-KQ // PREEMPT_CHUNK)


#: NVIDIA DGX H100 nodes (2 x 56-core Xeon 8480C, 224 threads; 2 TB =
#: 2,097,152 MiB of memory, whose x 10 is past 2^24: the int-exact mode)
DGX_NODES = dict(node_cpu_milli=224_000, node_mem_mib=2_097_152)
#: the DGX H100 cell: the main config's shape on DGX H100 nodes, nothing cut
DGX_CONFIG = dict(n_tasks=50_000, n_nodes=10_000, gang_size=8, label_classes=8,
                  taint_fraction=0.1, **DGX_NODES)
#: the wide cell: 20,000 nodes, a large managed-Kubernetes cluster; at R = 2
#: its node state, 3 x 20,096 x 4 = 241,152 bytes, is over one block's
#: 232,448, so it runs on the session kernel's wide instance
WIDE_CONFIG = dict(n_tasks=50_000, n_nodes=20_000, gang_size=8, label_classes=8,
                   taint_fraction=0.1)
#: the 9-lane session: the second config with 7 scalar lanes (device
#: plugins) beside cpu and memory, more lanes than the shared layout takes
LANES_SESSION = 9
#: candidates a task tracks in the blocked formulation's runs here: its
#: inner step is launch-bound, so 32 slots cost what 8 do and stop no
#: block of the cells (8, the reference's default, stops most of them)
BLOCKED_TOP_K = 32
MAIN_CONFIG = "50k_pods_10k_nodes_gang_predicates"
SECOND_CONFIG = "10k_pods_1k_nodes_fairshare"
PREEMPT_CONFIG = "100k_pods_10k_nodes_preempt"
WARM_RUNS = 5

#: the scheduling cycle's tiers (the JAX package's bench/_profsetup.py)
CYCLE_TIERS = (("priority", "gang"), ("drf", "predicates", "proportion", "nodeorder", "binpack"))
#: sha256 of repr(sorted(binds)) that the JAX package's jax-allocate gives
#: for each config's cluster objects (generate_cluster_objects, seed 0)
#: under CYCLE_TIERS; tests/test_torch_digests.py recomputes them
CYCLE_DIGESTS = {
    MAIN_CONFIG: "c5ccf48727093b88dd6634c8eb317b91cf968f30e419d920f5d637d389b374ca",
    SECOND_CONFIG: "9853688e576b441a556020ec00bb36671927f220ec2514ed5e728276f2e4859a",
}
#: cycles a cycle cell runs, each on a fresh cache
CYCLE_RUNS = 5

#: the preempting cycle: its tiers (tests/test_preempt_kernel.py's), its
#: actions, and its cells (generate_preempt_cluster_objects, seed 0) with
#: the cycles each runs on fresh caches
PREEMPT_CYCLE_TIERS = (("priority", "gang", "conformance"),
                       ("drf", "predicates", "proportion", "nodeorder", "binpack"))
PREEMPT_CYCLE_ACTIONS = ("enqueue", "gpu-allocate", "gpu-preempt", "backfill")
PREEMPT_CYCLE_MAIN = "100k_pods_10k_nodes_preempt"
PREEMPT_CYCLE_SECOND = "10k_pods_1k_nodes_preempt"
PREEMPT_CYCLE_CELLS = {
    PREEMPT_CYCLE_MAIN: dict(n_victims=90_000, n_nodes=10_000, n_preemptors=10_000),
    PREEMPT_CYCLE_SECOND: dict(n_victims=9_000, n_nodes=1_000, n_preemptors=1_000),
}
PREEMPT_CYCLE_RUNS = {PREEMPT_CYCLE_MAIN: 5, PREEMPT_CYCLE_SECOND: 3}
#: sha256 of repr((sorted evicted names, sorted (name, node) pipelined
#: pairs)) that the JAX package's enqueue, jax-allocate, jax-preempt,
#: backfill give on each cell's objects under PREEMPT_CYCLE_TIERS;
#: tests/test_torch_digests.py recomputes them
PREEMPT_CYCLE_DIGESTS = {
    PREEMPT_CYCLE_MAIN: "6c98d6e0cbff4d587fd0b4a2eb10f03dc12138bc306754617907b701b04148a9",
    PREEMPT_CYCLE_SECOND: "8bad40bf659689c3508a934dc810f6213a868194a3f6f81e10d0eaeaa792317d",
}

#: phase 2 sessions: the equivalence shapes of the JAX package's Pallas
#: tests, plus one gang session with predicates at 2,000 x 1,000
KERNEL_CASES = [
    dict(n_tasks=300, n_nodes=150, gang_size=4, seed=0),
    dict(n_tasks=300, n_nodes=150, gang_size=4, seed=1),
    dict(n_tasks=300, n_nodes=150, gang_size=4, seed=2),
    dict(n_tasks=256, n_nodes=130, gang_size=8, seed=3, label_classes=4, taint_fraction=0.25),
    dict(n_tasks=400, n_nodes=16, gang_size=5, seed=4, node_cpu_milli=16_000,
         node_mem_mib=32_768),
    dict(n_tasks=64, n_nodes=1, gang_size=2, seed=5),
    dict(n_tasks=2_000, n_nodes=1_000, gang_size=8, seed=7, label_classes=8,
         taint_fraction=0.1),
]


def _edit_inactive_in_gangs(taskrow):
    """Every third row inactive, inside the gangs."""
    taskrow[::3, -1] = 0.0


def _edit_repeat_after_miss(taskrow):
    """Every fifth gang of 8 asks more cpu than any node has: its repeated
    rows each follow a -1 pick."""
    import torch

    rows = (torch.arange(taskrow.shape[0], device=taskrow.device) // 8) % 5 == 0
    taskrow[rows, 0] = 1e7


#: phase 2 sessions that reach the list kernel's own paths: (name,
#: generate_snapshot arguments, edit of the task rows or None)
LIST_CASES = [
    # no predicates: one list of every node, ~10 positions a thread, so
    # the fast path rescores one of them
    ("no-predicates", dict(n_tasks=400, n_nodes=10_000, gang_size=8, seed=21), None),
    # 16,384 nodes at R = 2: the plane does not fit beside the node state
    ("plane-off", dict(n_tasks=300, n_nodes=16_384, gang_size=4, seed=22), None),
    ("inactive-in-gangs", dict(n_tasks=600, n_nodes=1_000, gang_size=8, seed=23,
                               label_classes=4, taint_fraction=0.1), _edit_inactive_in_gangs),
    ("repeat-after-miss", dict(n_tasks=600, n_nodes=1_000, gang_size=8, seed=24,
                               label_classes=4), _edit_repeat_after_miss),
]


#: phase 4 sessions of the wide instance: (name, generate_snapshot
#: arguments, lanes, int mode)
WIDE_CASES = [
    ("20k nodes", dict(n_tasks=2_000, n_nodes=20_000, gang_size=8, seed=31, label_classes=8,
                       taint_fraction=0.1), 2, False),
    ("20k DGX nodes, int mode", dict(n_tasks=2_000, n_nodes=20_000, gang_size=8, seed=32,
                                     label_classes=8, taint_fraction=0.1, **DGX_NODES), 2, True),
    ("9 lanes", dict(n_tasks=4_000, n_nodes=1_000, gang_size=4, seed=33), 9, False),
    ("10k nodes, 5 lanes", dict(n_tasks=2_000, n_nodes=10_000, gang_size=8, seed=34,
                                label_classes=8), 5, False),
    ("60k nodes, one list: plane in global memory",
     dict(n_tasks=400, n_nodes=60_000, gang_size=4, seed=35), 2, False),
]


#: phase 2 preempt sessions: generate_preempt_packed arguments, with uneven
#: K (victims not a multiple of nodes) and two queue counts
PREEMPT_CASES = [
    dict(n_victims=300, n_nodes=64, n_preemptors=64, seed=0),
    dict(n_victims=905, n_nodes=100, n_preemptors=120, seed=3),
    dict(n_victims=2_503, n_nodes=300, n_preemptors=400, gang_size=4, n_queues=2, seed=5),
    dict(n_victims=9_000, n_nodes=1_000, n_preemptors=1_000, seed=7),
]


def _edit_sensitive(pk):
    """Victim jobs with 1 < min_available < size: a gang allowance flips
    mid-pass once a job is down to its floor."""
    n_vjobs = int(pk.vic_job.max()) + 1
    pk.job_min_avail[:n_vjobs] = np.maximum(pk.job_ready0[:n_vjobs] - 1, 2)


def _edit_equal_priority(pk):
    """Every job at one priority: no victim is ever eligible."""
    pk.job_prio[:] = 100


def _edit_pod_limit(pk):
    """Half the nodes at their pod-count limit."""
    N = pk.base.n_nodes
    full = np.arange(N) % 2 == 0
    pk.base.node_max_tasks[:N][full] = pk.base.node_task_count[:N][full]


def _edit_request_rows(pk, n_rows: int):
    """``n_rows`` distinct preemptor request rows (n_rows > 64: the kernel
    scores inline), each a whole-millicore and whole-MiB request."""
    P = pk.base.n_tasks
    i = np.arange(P) % n_rows
    pk.base.task_resreq[:P, 0] = 2_000 + 40 * i
    pk.base.task_resreq[:P, 1] = 1_024 + 256 * (i % 7)


def _edit_labels(pk):
    """Label zones and a tainted fifth of the nodes: several feasibility
    classes."""
    N, P = pk.base.n_nodes, pk.base.n_tasks
    pk.base.node_label_bits[:N, 0] = np.uint32(1) << (np.arange(N) % 3).astype(np.uint32)
    pk.base.task_sel_bits[:P, 0] = np.uint32(1) << (np.arange(P) // 8 % 3).astype(np.uint32)
    pk.base.node_taint_bits[:N, 1] = np.where(np.arange(N) % 5 == 0, 1 << 31, 0)
    pk.base.task_tol_bits[:P, 1] = np.where(np.arange(P) // 8 % 2 == 0, 1 << 31, 0)


def _edit_rollback(pk):
    """Every third preemptor job needs more tasks than it has: its phase 1
    evicts and pipelines, then is discarded and rolled back."""
    rows = np.flatnonzero(pk.job_ptask_end > pk.job_ptask_start)[::3]
    pk.job_min_avail[rows] = pk.job_ptask_end[rows] - pk.job_ptask_start[rows] + 1


def _edit_owns_victims(pk):
    """Every third preemptor job owns the victims of one victim job of its
    queue, as running tasks (its ready count and min_available raised by
    their number, so it still fires five attempts): the wide key must not
    carry the plane to or from those jobs."""
    pjobs = np.flatnonzero(pk.job_ptask_end > pk.job_ptask_start)
    vic_job = pk.vic_job[: pk.n_victims]
    n_vjobs = int(vic_job.max()) + 1
    for i, j in enumerate(pjobs[::3]):
        same = np.flatnonzero(pk.job_queue[:n_vjobs] == pk.job_queue[j])
        mine = vic_job == same[i % len(same)]
        vic_job[mine] = j
        pk.job_ready0[j] += int(mine.sum())
        pk.job_min_avail[j] += int(mine.sum())


def _edit_mixed_priority(pk):
    """Consecutive preemptor jobs of each queue alternate between priority
    100 and 150: the wide key must not carry the plane across them."""
    pjobs = np.flatnonzero(pk.job_ptask_end > pk.job_ptask_start)
    for q in np.unique(pk.job_queue[pjobs]):
        pk.job_prio[pjobs[pk.job_queue[pjobs] == q][1::2]] = 150


#: phase 2 edited sessions: (name, base arguments, edit)
PREEMPT_EDITS = [
    ("sensitive-gang", dict(n_victims=2_400, n_nodes=300, n_preemptors=400, seed=11),
     _edit_sensitive),
    ("equal-priority", dict(n_victims=905, n_nodes=100, n_preemptors=120, seed=12),
     _edit_equal_priority),
    ("pod-count-limit", dict(n_victims=905, n_nodes=100, n_preemptors=120, seed=13),
     _edit_pod_limit),
    ("score-classes", dict(n_victims=2_400, n_nodes=300, n_preemptors=400, seed=14),
     lambda pk: _edit_request_rows(pk, 5)),
    ("inline-score", dict(n_victims=2_400, n_nodes=300, n_preemptors=400, seed=15),
     lambda pk: _edit_request_rows(pk, 100)),
    ("feasibility-classes", dict(n_victims=2_400, n_nodes=300, n_preemptors=400, seed=16),
     _edit_labels),
    ("rollback", dict(n_victims=2_400, n_nodes=300, n_preemptors=400, seed=17),
     _edit_rollback),
    ("owns-victims", dict(n_victims=2_400, n_nodes=300, n_preemptors=400, seed=18),
     _edit_owns_victims),
    ("mixed-priority", dict(n_victims=2_400, n_nodes=300, n_preemptors=400, seed=19),
     _edit_mixed_priority),
]


def preempt_sessions():
    """(name, PreemptPacked) of every phase 2 preempt session."""
    from volcano_tpu_torch.ops.synthetic import generate_preempt_packed

    out = [(f"generated {case}", generate_preempt_packed(**case)) for case in PREEMPT_CASES]
    for name, case, edit in PREEMPT_EDITS:
        pk = generate_preempt_packed(**case)
        edit(pk)
        out.append((name, pk))
    return out


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def pass_inputs(snap, device):
    """One pass's kernel operands on ``device``, every task active."""
    import torch

    from volcano_tpu_torch.ops.session_kernel import prepare_session_arrays

    arrays, _, _ = prepare_session_arrays(snap)
    taskrow = torch.from_numpy(arrays["taskrow"]).to(device)
    taskrow[:, -1] = 1.0
    return (taskrow,) + tuple(
        torch.from_numpy(arrays[k]).to(device)
        for k in ("cf_u8", "nd", "tol", "cls_off", "cls_nodes")
    )


def plane_len(inputs) -> int:
    """The wrapper's plane for these operands (0: the plane is off); the
    wide instance always keeps one."""
    from volcano_tpu_torch.ops.session_kernel import plan_shared_memory, shared_layout

    taskrow, cf, _, _, cls_off, _ = inputs
    R, NK = taskrow.shape[1] - 2, cf.shape[1]
    max_len = int((cls_off[1:] - cls_off[:-1]).max())
    return plan_shared_memory(R, NK, max_len) if shared_layout(R, NK) else max_len


def plane_off_launch(inputs, weights=None):
    """``fn(stats=None)`` launching one pass of the session kernel on
    ``inputs`` with the plane off (every step sweeps its list), planned
    once as the wrapper plans its launches."""
    from volcano_tpu_torch.ops.kernels import DEFAULT_WEIGHTS
    from volcano_tpu_torch.ops.session_kernel import _launch, launch_plan

    taskrow, cf, nd, _, _, cls_nodes = inputs
    plan = launch_plan(taskrow, cf, nd, cls_nodes, 0)._replace(plane_len=0)
    w = weights or DEFAULT_WEIGHTS
    return lambda stats=None: _launch(*inputs, w, None, stats, plan)


def run_session_pass(inputs, plane_off: bool = False, weights=None):
    """(chosen, [full, fast]) of one kernel pass: through the wrapper,
    with the plane it picks, or with the plane off."""
    import torch

    from volcano_tpu_torch.ops.kernels import DEFAULT_WEIGHTS
    from volcano_tpu_torch.ops.session_kernel import session_pass_cuda

    stats = torch.zeros(2, dtype=torch.int32, device=inputs[0].device)
    if plane_off:
        chosen = plane_off_launch(inputs, weights)(stats)
    else:
        chosen = session_pass_cuda(*inputs, weights=weights or DEFAULT_WEIGHTS, stats=stats)
    torch.cuda.synchronize()
    return chosen, stats.cpu().tolist()


def kernel_ms(fn, reps: int) -> float:
    """Mean device ms of ``fn()`` over ``reps`` launches (CUDA events),
    after one warm-up launch."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def pass_bound_ms(inputs, chosen, n_nodes: int, int_mode: bool = False) -> tuple:
    """(ms by bytes, ms by operations, listed share) of one pass on these
    inputs.

    Bytes: each operand the pass reads once — task rows, node planes,
    tolerance, class lists; not ``cf``, which the lists replace — and
    ``chosen`` written once, over HBM.  Operations, counted from what this
    run's data needs: a task sweeps only its class's list, so each listed
    node costs the mask without the class test (mask_ops(R) - 1) and the
    score; a task whose row equals the row before changes nothing but the
    previous pick, so it needs that node rescored (where there was a pick)
    and one argmax compare per listed node.  The share is that of the
    ``n_nodes`` real nodes listed for the active tasks."""
    import torch

    taskrow, cf, nd, tol, cls_off, cls_nodes = inputs
    R = taskrow.shape[1] - 2
    n_bytes = sum(x.numel() * x.element_size()
                  for x in (taskrow, nd, tol, cls_off, cls_nodes, chosen))
    cls = taskrow[:, R].long()  # truncated toward zero, as the kernel's class is
    live = (taskrow[:, R + 1] > 0) & (cls >= 0) & (cls < cf.shape[0])
    lens = (cls_off[1:] - cls_off[:-1]).long()
    listed = torch.where(live, lens[cls.clamp(0, cf.shape[0] - 1)], 0)
    bits = taskrow.contiguous().view(torch.int32)
    repeat = torch.zeros_like(live)
    repeat[1:] = (bits[1:] == bits[:-1]).all(1)
    picked = torch.zeros_like(live)
    picked[1:] = chosen[:-1] >= 0
    node_ops = mask_ops(R) - 1 + (score_ops_int(R) if int_mode else score_ops(R))
    ops = (int(listed[~repeat].sum()) * node_ops
           + int(listed[repeat].sum()) + int((repeat & live & picked).sum()) * node_ops)
    share = int(listed.sum()) / max(int(live.sum()) * n_nodes, 1)
    return n_bytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3, share


def latency_floor_ms(taskrow) -> tuple:
    """(ms, probe) — the pass's latency floor as first defined: T steps,
    each the serial chain of the first session kernel that no node count
    removes (the two warp_argmax halves, two block barriers, two
    shared-memory round trips, the next-row load), with each link timed
    by the step probe on the card (second of two probe runs, caches
    warm).  ``chain_ms`` in the probe is the list kernel's own chain: the
    same links without the row load, which it makes a step ahead."""
    from volcano_tpu_torch.ops.session_kernel import step_latency_probe

    step_latency_probe(taskrow)
    p = step_latency_probe(taskrow)
    chain = (p["argmax_all"] + p["argmax_one"] + 2 * p["barrier"]
             + 2 * p["smem_round_trip"])
    cycles = chain + p["row_stage"]
    to_ms = taskrow.shape[0] * p["ns_per_cycle"] / 1e6
    return cycles * to_ms, dict(p, step_cycles=cycles, chain_cycles=chain,
                                chain_ms=chain * to_ms)


def phase_build() -> None:
    from volcano_tpu_torch.ops import _build
    from volcano_tpu_torch.ops.dispatch import last_executor, warmup_kernels

    t0 = time.perf_counter()
    path = _build.build()
    print(f"build: {time.perf_counter() - t0:.3f} s for {path}")
    if _build.BUILD_LOG is not None:
        seconds, log = _build.BUILD_LOG
        print(f"build: nvcc {seconds:.3f} s")
        for line in log.splitlines():
            if "ptxas info" in line or "spill" in line:
                print(f"  {line.strip()}")
    t0 = time.perf_counter()
    executor = warmup_kernels()
    check(executor == last_executor() == "cuda", f"warmup ran on {last_executor()!r}")
    print(f"warmup_kernels: {executor}, {time.perf_counter() - t0:.3f} s")


def phase_kernel_vs_plain() -> None:
    import torch

    from volcano_tpu_torch.ops.session_kernel import repeated_rows, session_pass_reference
    from volcano_tpu_torch.ops.synthetic import generate_snapshot

    sessions = [(f"generated {case}", case, None) for case in KERNEL_CASES] + LIST_CASES
    for name, case, edit in sessions:
        inputs = pass_inputs(generate_snapshot(**case), "cuda")
        if edit is not None:
            edit(inputs[0])
        T = inputs[0].shape[0]
        plane = plane_len(inputs)
        check((plane == 0) == (name == "plane-off"), f"{name}: plane of {plane} scores")
        want = session_pass_reference(*inputs)
        # with the plane, the fast steps are the rows equal to the row before
        fast = repeated_rows(inputs[0]) if plane else 0
        got, stats = run_session_pass(inputs)
        check(torch.equal(got, want), f"session kernel != plain version on {name}")
        check(stats == [T - fast, fast], f"{name}: kernel counts {stats}, {fast} repeated rows")
        if plane:  # the same kernel with the plane off
            off, off_stats = run_session_pass(inputs, plane_off=True)
            check(torch.equal(off, want), f"session kernel, plane off, != plain on {name}")
            check(off_stats == [T, 0], f"{name}: plane-off counts {off_stats}")
        print(f"kernel == plain: {name} ({int((got >= 0).sum())} placed; plane "
              f"{plane}{' and off' if plane else ''}; full {stats[0]}, fast {stats[1]})")


def preempt_inputs(pk, device):
    """One preempt pass's kernel operands on ``device``, and its dims."""
    from volcano_tpu_torch.ops.preempt_kernel import prepare_preempt_arrays, ship_arrays

    arrays, dims, _ = prepare_preempt_arrays(pk)
    return ship_arrays(arrays, device), dims


def preempt_launch(inputs, plane: bool):
    """``fn(stats=None)`` launching one pass of the preempt kernel on
    ``inputs``, with the plane the wrapper picks or with the plane off
    (every attempt sweeps its queue's list); the operands checked and the
    victim lists derived once, as the wrapper does at each call."""
    from volcano_tpu_torch.ops.kernels import DEFAULT_WEIGHTS
    from volcano_tpu_torch.ops.preempt_kernel import (
        _check_pass_args,
        _launch,
        KERNEL_STATS,
        plan_plane,
        victim_lists,
    )

    _check_pass_args(*inputs, DEFAULT_WEIGHTS, None, len(KERNEL_STATS))
    lists = victim_lists(inputs[6], inputs[7][1])
    plane_len = plan_plane(lists["longest"]) if plane else 0
    return lambda stats=None: _launch(inputs, lists, DEFAULT_WEIGHTS, stats, plane_len)


def run_preempt_kernel(inputs, plane_off: bool = False):
    """(evicted, pipelined, KERNEL_STATS counts) of one kernel pass:
    through the wrapper, with the plane it picks, or with the plane off."""
    import torch

    from volcano_tpu_torch.ops.preempt_kernel import KERNEL_STATS, preempt_pass_cuda

    stats = torch.zeros(len(KERNEL_STATS), dtype=torch.int32, device=inputs[0].device)
    if plane_off:
        ev, pipe = preempt_launch(inputs, plane=False)(stats)
    else:
        ev, pipe = preempt_pass_cuda(*inputs, stats=stats)
    torch.cuda.synchronize()
    return ev, pipe, stats.cpu().tolist()


def run_preempt_plain(inputs, dims):
    """(evicted, pipelined, STATS counts, events, fast-path flags) of the
    plain pass: its fired attempts, picks and rollbacks in order, and for
    each fired attempt whether the kernel with its plane takes the fast
    path, counted on the host."""
    import torch

    from volcano_tpu_torch.ops.preempt_kernel import (
        fast_attempts,
        preempt_pass_reference,
        STATS,
    )

    stats = torch.zeros(len(STATS), dtype=torch.int32, device=inputs[0].device)
    events = []
    ev, pipe = preempt_pass_reference(*inputs, stats=stats, events=events)
    torch.cuda.synchronize()
    fast = fast_attempts(events, inputs[1], inputs[7], inputs[6], dims["SC"])
    return ev, pipe, stats.cpu().tolist(), events, fast


def check_preempt_kernel(inputs, dims, name: str, plain=None):
    """The kernel with its plane and with the plane off against the plain
    pass (``plain``: run_preempt_plain's result, made here if None):
    ``evicted``, ``pipelined``, the four shared counts, and the fast
    attempts against the host's count (none with the plane off).  Returns
    (evicted, pipelined, kernel counts with the plane)."""
    import torch

    ev_ref, pipe_ref, stats_ref, _, fast = plain or run_preempt_plain(inputs, dims)
    out = None
    for plane_off in (False, True):
        ev, pipe, stats = run_preempt_kernel(inputs, plane_off)
        what = f"{name}, plane {'off' if plane_off else 'on'}"
        check(torch.equal(ev, ev_ref) and torch.equal(pipe, pipe_ref),
              f"preempt kernel != plain version on {what}")
        want = stats_ref + [0 if plane_off else sum(fast)]
        check(stats == want, f"preempt kernel counts {stats} != {want} (plain, host) on {what}")
        out = out or (ev, pipe, stats)
    return out


def list_dims(inputs) -> str:
    """The victim lists' sizes the wrapper derives for ``inputs``."""
    from volcano_tpu_torch.ops.preempt_kernel import plan_plane, victim_lists

    lists = victim_lists(inputs[6], inputs[7][1])
    KQ, LQ = lists["qslot"].shape
    return (f"Q {lists['qoff'].numel() - 1}, KQ {KQ}, LQ {LQ}, longest list "
            f"{lists['longest']} (plane {plan_plane(lists['longest'])})")


def phase_preempt_kernel_vs_plain() -> None:
    from volcano_tpu_torch.ops.preempt_kernel import KERNEL_STATS

    for name, pk in preempt_sessions():
        inputs, dims = preempt_inputs(pk, "cuda")
        _, pipe, stats = check_preempt_kernel(inputs, dims, name)
        counts = ", ".join(f"{k} {v}" for k, v in zip(KERNEL_STATS, stats))
        print(f"preempt kernel == plain, plane on and off: {name} (K {dims['K']}, "
              f"{list_dims(inputs)}, SC {dims['SC']}, C {dims['C']}; {counts}; pipelined "
              f"{int((pipe >= 0).sum())})")


def phase_preempt_main_path(card: str) -> dict:
    import torch

    from volcano_tpu_torch.ops import preempt_kernel
    from volcano_tpu_torch.ops.executor import execute_preempt, last_preempt_executor
    from volcano_tpu_torch.ops.preempt_kernel import (
        KERNEL_STATS,
        prepare_preempt_arrays,
        preempt_pass_cuda,
        victim_lists,
    )
    from volcano_tpu_torch.ops.preempt_pack import preempt_dense
    from volcano_tpu_torch.ops.synthetic import BASELINE_CONFIGS, generate_preempt_packed

    name = PREEMPT_CONFIG
    kwargs = {k: v for k, v in BASELINE_CONFIGS[name].items() if k != "preempt"}
    pk = generate_preempt_packed(**kwargs)
    P, V = pk.base.n_tasks, pk.n_victims

    # the main path, with the launch count read just before and after
    torch.cuda.synchronize()
    preempt_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    evicted, pipelined = execute_preempt(pk)
    first_s = time.perf_counter() - t0
    launches = preempt_kernel.LAUNCHES
    executor = last_preempt_executor()
    check(launches > 0, f"{name}: the preempt kernel was not launched")
    check(executor == "cuda", f"{name}: executor {executor!r}, expected 'cuda'")
    check(evicted.shape == (V,) and pipelined.shape == (P,), f"{name}: output shapes")

    t0 = time.perf_counter()
    spec_ev, spec_pipe = preempt_dense(pk, device="cuda")
    spec_s = time.perf_counter() - t0
    check(np.array_equal(evicted, spec_ev) and np.array_equal(pipelined, spec_pipe),
          f"{name}: execute_preempt != torch spec preempt_dense")
    n_ev, n_pipe = int(evicted.sum()), int((pipelined >= 0).sum())
    check(n_ev > 0 and n_pipe > 0, f"{name}: the pass preempted nothing")
    print(f"{name}: (evicted, pipelined) == torch spec preempt_dense ({spec_s:.3f} s to "
          f"compute the spec); evicted {n_ev}/{V}, pipelined {n_pipe}/{P}; first session "
          f"{first_s * 1e3:.3f} ms; launches {launches}")

    # warm sessions, each paying its full host prepare
    def drop_caches():
        pk.base.__dict__.pop("_feas_classes_cache", None)
        pk.__dict__.pop("_score_class_cache", None)

    lat, prep = [], []
    for _ in range(WARM_RUNS):
        drop_caches()
        t0 = time.perf_counter()
        prepare_preempt_arrays(pk)
        prep.append(time.perf_counter() - t0)
        drop_caches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = execute_preempt(pk)
        lat.append(time.perf_counter() - t0)
        check(np.array_equal(again[0], evicted) and np.array_equal(again[1], pipelined),
              f"{name}: warm session differs from the first")
    med_ms = statistics.median(lat) * 1e3
    prep_ms = statistics.median(prep) * 1e3

    inputs, dims = preempt_inputs(pk, "cuda")
    pass_ms = kernel_ms(lambda: preempt_pass_cuda(*inputs), reps=5)
    launch_ms = kernel_ms(preempt_launch(inputs, plane=True), reps=5)
    print(f"{name}: session median {med_ms:.3f} ms, max {max(lat) * 1e3:.3f} ms over "
          f"{WARM_RUNS} warm runs (host prepare {prep_ms:.3f} ms); kernel {pass_ms:.3f} ms "
          f"per pass through the wrapper ({launch_ms:.3f} ms the launch alone, the rest the "
          f"victim lists); {launches} launch per session; card {card}")

    # the plain version on the same operands, the counts of the pass, the
    # fast attempts against the host's count, and the plane-off pass
    t0 = time.perf_counter()
    plain = run_preempt_plain(inputs, dims)
    plain_ms = (time.perf_counter() - t0) * 1e3
    ev_ref, pipe_ref, _, events, fast = plain
    ev, pipe, stats = check_preempt_kernel(inputs, dims, name, plain)
    err = max(int((ev.long() - ev_ref.long()).abs().max()),
              int((pipe.long() - pipe_ref.long()).abs().max()))
    vic_slot = prepare_preempt_arrays(pk)[2]
    check(np.array_equal(ev.cpu().numpy()[vic_slot[:V], pk.vic_node[:V]] > 0, evicted),
          f"{name}: plain pass != execute_preempt")
    off_ms = kernel_ms(preempt_launch(inputs, plane=False), reps=3)
    counts = dict(zip(KERNEL_STATS, stats))
    share = counts["fast"] / max(counts["fired"], 1)

    lists = victim_lists(inputs[6], inputs[7][1])
    by_bytes, by_ops, by_ops_first = preempt_bound_ms(inputs, lists, (ev, pipe), events, fast,
                                                      pk.base.n_nodes, dims)
    bound_ms, bound_by = max((by_bytes, "bytes"), (by_ops, "operations"))
    floor = preempt_latency_floor_ms(inputs, counts["fired"], lists["qslot"].shape[0])
    binding = max((floor["chain_ms"], "chain floor"), (by_ops, "operations"),
                  (by_bytes, "bytes"))[1]
    S = inputs[0].shape[0]
    n_fast, n_full = counts["fast"], counts["fired"] - counts["fast"]
    print(f"{name}: {S} slots; " + ", ".join(f"{k} {v}" for k, v in counts.items())
          + f" (fast == the host's count from the plain pass); K {dims['K']}, "
          f"{list_dims(inputs)}, NK {dims['NK']}, J {dims['J']}, C {dims['C']}, SC "
          f"{dims['SC']}")
    print(f"{name}: fast attempts {n_fast}/{counts['fired']} ({share:.5f}); plane off "
          f"{off_ms:.3f} ms per pass ({off_ms * 1e6 / max(counts['fired'], 1):.1f} ns per "
          f"attempt, every one full), plane on {pass_ms:.3f} ms "
          f"({pass_ms * 1e6 / max(counts['fired'], 1):.1f} ns per attempt); {n_full} full "
          f"attempts; card {card}")
    print(f"{name}: plain version {plain_ms:.3f} ms per pass; bound {by_bytes:.6f} ms by "
          f"bytes, {by_ops:.6f} ms by operations (every attempt full over every node, as "
          f"first counted: {by_ops_first:.6f}); chain floor {floor['chain_ms']:.3f} ms "
          f"({floor['chain_fired']:.1f} cycles per fired attempt, {floor['chain_slot']:.1f} "
          f"per slot); latency floor as first defined {floor['first_ms']:.3f} ms "
          f"({floor['first_fired']:.1f}, {floor['first_slot']:.1f}) at "
          f"{floor['ns_per_cycle']:.4f} ns per cycle; binding: {binding}; card {card}")
    return dict(launches=launches, ms=pass_ms, max_abs_err=err, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, latency_floor_ms=floor["first_ms"],
                chain_floor_ms=floor["chain_ms"], fast_attempt_share=share,
                plane_off_ms=off_ms)


def preempt_bound_ms(inputs, lists, outputs, events, fast, n_nodes: int, dims) -> tuple:
    """(ms by bytes, ms by operations, ms by operations as first counted)
    of one preempt pass on these inputs.

    Bytes: each operand the kernel reads once and each output written once
    over HBM (the victim lists ``lists`` are derived from them).
    Operations, counted attempt by attempt from what this run's
    data needs (the plain pass's ``events``, and ``fast``, the host's
    fast-path flag of each fired attempt): a full attempt needs
    eligibility on every slot its queue's list holds and validation on
    every listed node; a fast attempt needs them only on its dirty nodes
    (the last pick, and the nodes of an evicted victim's job whose
    min_available is not 1) and one argmax compare per listed node; the
    static score once per score class on every node some list holds (per
    attempt on its listed nodes when scored inline).  As first counted:
    every fired attempt full over every real node."""
    R, SC = dims["R"], dims["SC"]
    n_bytes = sum(x.numel() * x.element_size() for x in (*inputs, *outputs))
    vjob, jobi, jobf = (x.cpu().numpy() for x in (inputs[6], inputs[7], inputs[8]))
    qoff, qnode, qslot, jlo, jlist = (
        lists[k].cpu().numpy() for k in ("qoff", "qnode", "qslot", "jlo", "jlist"))
    per_pos = (qslot >= 0).sum(0)  # the listed slots at each list position
    cum = np.concatenate([[0], np.cumsum(per_pos)])
    Q = qoff.shape[0] - 1
    node_ops = validate_ops(R)
    flags = iter(fast)
    ops, dirty, start, L = 0, [], 0, 0
    for event in events:
        if event[0] == "fire":
            q = int(jobi[1][event[2]])
            start, end = (int(qoff[q]), int(qoff[q + 1])) if 0 <= q < Q else (0, 0)
            L = end - start
            if next(flags):
                ops += L + sum(int(per_pos[g]) * ELIG_OPS + node_ops for g in dirty)
            else:
                ops += int(cum[end] - cum[start]) * ELIG_OPS + L * node_ops
            if SC == 0:
                ops += L * score_ops(R)
            dirty = []
        elif event[0] == "pick":
            n, jobs = event[1], event[2]
            dirty = [start + int(np.searchsorted(qnode[start:start + L], n))]
            for v in set(jobs):
                if jobf[2][v] != 1.0:
                    dirty += jlist[jlo[v]:jlo[v + 1]].tolist()
    ops += SC * np.unique(qnode).shape[0] * score_ops(R)
    fired = len(fast)
    occupied = int((vjob[:, :n_nodes] >= 0).sum())
    first = (fired * (occupied * ELIG_OPS + n_nodes * validate_ops(R))
             + (SC if SC > 0 else fired) * n_nodes * score_ops(R))
    return (n_bytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3,
            first / F32_OPS_PER_S * 1e3)


def preempt_latency_floor_ms(inputs, fired: int, KQ: int) -> dict:
    """The preempt pass's latency floors, each link timed by the step
    probe on the card (a dependent load is its row stage, over the pass's
    task rows; second of two probe runs, caches warm): ``chain_ms``, the
    redesigned kernel's chain — every slot's walk (CHAIN_SLOT_LOADS
    dependent loads) plus, per fired attempt, chain_fired_loads(KQ) more
    (KQ: the most listed slots of a position), two block barriers, two
    shared round trips and the two argmax halves; and
    ``first_ms``, the floor as first defined, with SLOT_LOADS and
    FIRED_LOADS.  Cycles per slot and per fired attempt beside them."""
    from volcano_tpu_torch.ops.session_kernel import step_latency_probe

    ptask = inputs[1]
    step_latency_probe(ptask)
    p = step_latency_probe(ptask)
    sync = 2 * p["barrier"] + 2 * p["smem_round_trip"] + p["argmax_all"] + p["argmax_one"]
    out = dict(ns_per_cycle=p["ns_per_cycle"])
    for name, slot_loads, fired_loads in (("chain", CHAIN_SLOT_LOADS, chain_fired_loads(KQ)),
                                          ("first", SLOT_LOADS, FIRED_LOADS)):
        per_slot = slot_loads * p["row_stage"]
        per_fired = fired_loads * p["row_stage"] + sync
        cycles = inputs[0].shape[0] * per_slot + fired * per_fired
        out.update({f"{name}_ms": cycles * p["ns_per_cycle"] / 1e6, f"{name}_slot": per_slot,
                    f"{name}_fired": per_fired})
    return out


def phase_main_path(name: str, card: str, compare_plain: bool) -> dict:
    import torch

    from volcano_tpu_torch.ops import session_kernel
    from volcano_tpu_torch.ops.executor import execute_allocate, last_allocate_executor
    from volcano_tpu_torch.ops.kernels import run_packed
    from volcano_tpu_torch.ops.session_kernel import (
        prepare_session_arrays,
        repeated_rows,
        score_latency_probe,
        session_pass_cuda,
        session_pass_reference,
    )
    from volcano_tpu_torch.ops.synthetic import BASELINE_CONFIGS, generate_snapshot

    snap = generate_snapshot(**BASELINE_CONFIGS[name])

    # the main path, with the launch count read just before and after
    torch.cuda.synchronize()
    session_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    out = execute_allocate(snap)
    first_s = time.perf_counter() - t0
    launches = session_kernel.LAUNCHES
    executor = last_allocate_executor()
    check(launches > 0, f"{name}: the session kernel was not launched")
    check(executor == "cuda", f"{name}: executor {executor!r}, expected 'cuda'")
    check(out.shape == (snap.n_tasks,), f"{name}: assignment shape {out.shape}")

    t0 = time.perf_counter()
    spec = run_packed(snap, device="cuda")
    spec_s = time.perf_counter() - t0
    check(np.array_equal(out, spec), f"{name}: assignment != torch spec run_packed")
    placed = int((out >= 0).sum())
    print(f"{name}: assignment == torch spec ({spec_s:.3f} s to compute the spec); "
          f"placed {placed}/{snap.n_tasks}; first session {first_s * 1e3:.3f} ms; "
          f"launches {launches}")

    # warm sessions, each paying its full host prepare
    lat, prep = [], []
    for _ in range(WARM_RUNS):
        snap.__dict__.pop("_feas_classes_cache", None)
        t0 = time.perf_counter()
        prepare_session_arrays(snap)
        prep.append(time.perf_counter() - t0)
        snap.__dict__.pop("_feas_classes_cache", None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = execute_allocate(snap)
        lat.append(time.perf_counter() - t0)
        check(np.array_equal(again, out), f"{name}: warm session differs from the first")
    med_ms = statistics.median(lat) * 1e3
    prep_ms = statistics.median(prep) * 1e3

    inputs = pass_inputs(snap, "cuda")
    pass_ms = kernel_ms(lambda: session_pass_cuda(*inputs), reps=3)
    print(f"{name}: session median {med_ms:.3f} ms, max {max(lat) * 1e3:.3f} ms over "
          f"{WARM_RUNS} warm runs (host prepare {prep_ms:.3f} ms); kernel {pass_ms:.3f} ms "
          f"per pass; {snap.n_tasks / (med_ms / 1e3):.1f} pods/s; card {card}")

    # the fast path's share, against the repeated rows counted on the host,
    # and the same kernel with the plane off (every step sweeps its list)
    plane = plane_len(inputs)
    chosen, stats = run_session_pass(inputs)
    repeats = repeated_rows(inputs[0])
    check(plane > 0 and stats == [snap.n_tasks - repeats, repeats],
          f"{name}: kernel counts {stats}, plane {plane}, {repeats} repeated rows")
    off, off_stats = run_session_pass(inputs, plane_off=True)
    check(torch.equal(off, chosen) and off_stats == [snap.n_tasks, 0],
          f"{name}: plane-off pass differs from the pass with the plane ({off_stats})")
    off_ms = kernel_ms(plane_off_launch(inputs), reps=3)
    lens = (inputs[4][1:] - inputs[4][:-1]).float()
    print(f"{name}: fast steps {stats[1]}/{snap.n_tasks} ({stats[1] / snap.n_tasks:.4f}) == "
          f"repeated rows on the host; class lists {inputs[4].numel() - 1}, mean "
          f"{float(lens.mean()):.1f} nodes, longest {int(lens.max())} (plane {plane}); "
          f"plane off {off_ms:.3f} ms per pass, plane on {pass_ms:.3f}; card {card}")

    record = dict(launches=launches, ms=pass_ms, session_ms=med_ms, assignment=out)
    if compare_plain:
        t0 = time.perf_counter()
        plain = session_pass_reference(*inputs)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = int((chosen.long() - plain.long()).abs().max())
        check(err == 0, f"{name}: kernel != plain version at full width")
        by_bytes, by_ops, share = pass_bound_ms(inputs, chosen, snap.n_nodes)
        bound_ms, bound_by = max((by_bytes, "bytes"), (by_ops, "operations"))
        floor_ms, probe = latency_floor_ms(inputs[0])
        record.update(max_abs_err=err, plain_ms=plain_ms, bound_ms=bound_ms,
                      bound_by=bound_by, latency_floor_ms=floor_ms,
                      chain_floor_ms=probe["chain_ms"], fast_step_share=stats[1] / snap.n_tasks)
        # the check on the derived floor: every task inactive, so each step
        # is only the block-wide argmax, two barriers and the repeated-row
        # test (the row itself is copied a step ahead)
        idle = (inputs[0].clone(),) + inputs[1:]
        idle[0][:, -1] = 0.0
        idle_ms = kernel_ms(lambda: session_pass_cuda(*idle), reps=3)
        # one node per thread: the same tasks over 1,024 nodes
        narrow = dict(BASELINE_CONFIGS[name], n_nodes=1_000)
        narrow_inputs = pass_inputs(generate_snapshot(**narrow), "cuda")
        narrow_ms = kernel_ms(lambda: session_pass_cuda(*narrow_inputs), reps=3)
        steps = snap.n_tasks
        print(f"{name}: plain version {plain_ms:.3f} ms per pass; bound {by_bytes:.6f} ms "
              f"by bytes, {by_ops:.6f} ms by operations ({share:.4f} of the real nodes "
              f"listed), latency floor {floor_ms:.3f} ms ({floor_ms * 1e6 / steps:.1f} ns "
              f"per step); card {card}")
        print(f"{name}: step probe, SM cycles: warp_argmax all warps "
              f"{probe['argmax_all']:.1f}, warp 0 alone {probe['argmax_one']:.1f}; barrier "
              f"{probe['barrier']:.1f}; shared round trip {probe['smem_round_trip']:.1f}; "
              f"row stage {probe['row_stage']:.1f}; step {probe['step_cycles']:.1f} at "
              f"{probe['ns_per_cycle']:.4f} ns per cycle; the list kernel's own chain "
              f"(row load a step ahead) {probe['chain_cycles']:.1f} cycles, "
              f"{probe['chain_ms']:.3f} ms per pass")
        sp = score_latency_probe(inputs[2], inputs[0], inputs[3])
        sp = score_latency_probe(inputs[2], inputs[0], inputs[3])
        print(f"{name}: score probe, SM cycles per node on one thread: planes from L2 "
              f"{sp['l2']:.1f}, from L1 {sp['l1']:.1f}, in registers {sp['score']:.1f}; all "
              f"1024 threads at once from registers {sp['block']:.1f}")
        print(f"{name}: idle pass (every task inactive) {idle_ms:.3f} ms "
              f"({idle_ms * 1e6 / steps:.1f} ns per step); same tasks over 1,024 nodes "
              f"{narrow_ms:.3f} ms per pass ({narrow_ms * 1e6 / steps:.1f} ns per step); "
              f"full width {pass_ms * 1e6 / steps:.1f} ns per step; card {card}")
    return record


def int_weights():
    """The default weights with least-requested in exact int32."""
    from volcano_tpu_torch.ops.kernels import DEFAULT_WEIGHTS

    return DEFAULT_WEIGHTS._replace(lr_int_exact=True)


def phase_int_kernel_vs_plain() -> None:
    """The session kernel's int-exact least-requested mode against its
    plain version: every KERNEL_CASES shape at DGX H100 node sizes, with
    the plane the wrapper picks and with it off; then the session where
    the f32 path and the int path pick different nodes, in each mode."""
    import torch

    from volcano_tpu_torch.ops.executor import execute_allocate, last_allocate_executor
    from volcano_tpu_torch.ops.kernels import DEFAULT_WEIGHTS
    from volcano_tpu_torch.ops.session_kernel import repeated_rows, session_pass_reference
    from volcano_tpu_torch.ops.synthetic import generate_lr_mode_split, generate_snapshot

    w = int_weights()
    for case in KERNEL_CASES:
        name = f"generated {dict(case, **DGX_NODES)}"
        inputs = pass_inputs(generate_snapshot(**dict(case, **DGX_NODES)), "cuda")
        T = inputs[0].shape[0]
        plane = plane_len(inputs)
        want = session_pass_reference(*inputs, weights=w)
        fast = repeated_rows(inputs[0]) if plane else 0
        got, stats = run_session_pass(inputs, weights=w)
        check(torch.equal(got, want), f"int mode: session kernel != plain version on {name}")
        check(stats == [T - fast, fast], f"int mode, {name}: kernel counts {stats}")
        off, off_stats = run_session_pass(inputs, plane_off=True, weights=w)
        check(torch.equal(off, want) and off_stats == [T, 0],
              f"int mode: session kernel, plane off, != plain version on {name}")
        print(f"int mode: kernel == plain, plane {plane} and off: {name} "
              f"({int((got >= 0).sum())} placed; full {stats[0]}, fast {stats[1]})")
    inputs = pass_inputs(generate_lr_mode_split(), "cuda")
    picks = []
    for weights in (DEFAULT_WEIGHTS, w):
        want = session_pass_reference(*inputs, weights=weights)
        for plane_off in (False, True):
            got, _ = run_session_pass(inputs, plane_off, weights)
            check(torch.equal(got, want), f"lr-mode split: kernel != plain version "
                                          f"(int {weights.lr_int_exact}, plane off {plane_off})")
        picks.append(int(want[0]))
    check(picks == [0, 1], f"lr-mode split: picks {picks}, expected node 0 in f32, 1 in int32")
    # the entry point switches the kernel to int32 by itself outside the envelope
    out = execute_allocate(generate_lr_mode_split())
    check(out.tolist() == [1] and last_allocate_executor() == "cuda",
          f"lr-mode split: execute_allocate gave {out.tolist()} on {last_allocate_executor()!r}")
    print("int mode: lr-mode split session (2 nodes, outside the f32 envelope): kernel == "
          "plain in each mode, plane on and off; f32 picks node 0, int32 node 1; "
          "execute_allocate picks node 1 on cuda")


def phase_wide_kernel_vs_plain() -> None:
    """The session kernel's wide instance against its plain version on
    WIDE_CASES, with its plane and with it off; every pass must launch
    the wide instance."""
    import torch

    from volcano_tpu_torch.ops import session_kernel
    from volcano_tpu_torch.ops.kernels import DEFAULT_WEIGHTS
    from volcano_tpu_torch.ops.session_kernel import (
        plan_wide,
        repeated_rows,
        session_pass_reference,
        shared_layout,
    )
    from volcano_tpu_torch.ops.synthetic import add_scalar_lanes, generate_snapshot

    for name, case, lanes, int_mode in WIDE_CASES:
        snap = generate_snapshot(**case)
        if lanes > 2:
            add_scalar_lanes(snap, lanes - 2, case["seed"])
        inputs = pass_inputs(snap, "cuda")
        R, NK = lanes, inputs[1].shape[1]
        check(not shared_layout(R, NK), f"wide {name}: the shared layout takes it")
        w = int_weights() if int_mode else DEFAULT_WEIGHTS
        T = inputs[0].shape[0]
        plane = plane_len(inputs)
        want = session_pass_reference(*inputs, weights=w)
        fast = repeated_rows(inputs[0])
        before = session_kernel.WIDE_LAUNCHES
        got, stats = run_session_pass(inputs, weights=w)
        check(session_kernel.WIDE_LAUNCHES == before + 1, f"wide {name}: not the wide instance")
        check(torch.equal(got, want), f"wide instance != plain version on {name}")
        check(stats == [T - fast, fast], f"wide {name}: kernel counts {stats}")
        off, off_stats = run_session_pass(inputs, plane_off=True, weights=w)
        check(torch.equal(off, want) and off_stats == [T, 0],
              f"wide instance, plane off, != plain version on {name}")
        where = "shared" if plan_wide(R, plane) else "global"
        print(f"wide instance == plain, plane {plane} ({where} memory) and off: {name} "
              f"(R {R}, NK {NK}, {int((got >= 0).sum())} placed, longest list "
              f"{int((inputs[4][1:] - inputs[4][:-1]).max())}, highest pick {int(got.max())}; "
              f"full {stats[0]}, fast {stats[1]})")


def warm_sessions(snap, n: int, want) -> list:
    """Host-clock seconds of ``n`` sessions through execute_allocate, each
    paying its full host prepare and each equal to ``want``."""
    import torch

    from volcano_tpu_torch.ops.executor import execute_allocate

    lat = []
    for _ in range(n):
        snap.__dict__.pop("_feas_classes_cache", None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = execute_allocate(snap)
        lat.append(time.perf_counter() - t0)
        check(np.array_equal(again, want), "warm session differs from the first")
    return lat


def phase_dgx_cell(card: str, f32_cell_ms: float) -> dict:
    """The DGX H100 cell through execute_allocate: the kernel in its int
    mode, equal to the torch spec on the card; its pass in int mode and,
    on the same data, in f32 mode, beside the f32 cell's pass."""
    import torch

    from volcano_tpu_torch.ops import session_kernel
    from volcano_tpu_torch.ops.executor import execute_allocate, last_allocate_executor
    from volcano_tpu_torch.ops.kernels import f32_lr_exact, run_packed
    from volcano_tpu_torch.ops.session_kernel import repeated_rows, session_pass_cuda
    from volcano_tpu_torch.ops.synthetic import generate_snapshot

    name = "dgx_h100_50k_pods_10k_nodes"
    snap = generate_snapshot(**DGX_CONFIG)
    check(not f32_lr_exact(snap), f"{name}: inside the f32 envelope")
    torch.cuda.synchronize()
    session_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    out = execute_allocate(snap)
    first_s = time.perf_counter() - t0
    launches = session_kernel.LAUNCHES
    executor = last_allocate_executor()
    check(launches > 0, f"{name}: the session kernel was not launched")
    check(executor == "cuda", f"{name}: executor {executor!r}, expected 'cuda'")
    t0 = time.perf_counter()
    spec = run_packed(snap, device="cuda")
    spec_s = time.perf_counter() - t0
    check(np.array_equal(out, spec), f"{name}: assignment != torch spec run_packed (int32)")
    lat = warm_sessions(snap, WARM_RUNS, out)
    med_ms = statistics.median(lat) * 1e3

    w = int_weights()
    inputs = pass_inputs(snap, "cuda")
    int_ms = kernel_ms(lambda: session_pass_cuda(*inputs, weights=w), reps=3)
    f32_ms = kernel_ms(lambda: session_pass_cuda(*inputs), reps=3)
    chosen, stats = run_session_pass(inputs, weights=w)
    chosen_f32, _ = run_session_pass(inputs)
    repeats = repeated_rows(inputs[0])
    check(stats == [snap.n_tasks - repeats, repeats], f"{name}: kernel counts {stats}")
    by_bytes, by_ops, _ = pass_bound_ms(inputs, chosen, snap.n_nodes, int_mode=True)
    bound_ms, bound_by = max((by_bytes, "bytes"), (by_ops, "operations"))
    print(f"{name}: assignment == torch spec run_packed in int32 ({spec_s:.3f} s to compute "
          f"the spec); placed {int((out >= 0).sum())}/{snap.n_tasks}; first session "
          f"{first_s * 1e3:.3f} ms; launches {launches}; executor {executor}")
    print(f"{name}: session median {med_ms:.3f} ms, max {max(lat) * 1e3:.3f} ms over "
          f"{WARM_RUNS} warm runs; kernel {int_ms:.3f} ms per pass in int mode, "
          f"{f32_ms:.3f} ms in f32 mode on the same data (chosen "
          f"{'equal' if torch.equal(chosen, chosen_f32) else 'different'}); the f32 cell's "
          f"pass {f32_cell_ms:.3f} ms; fast steps {stats[1]}/{snap.n_tasks} "
          f"({stats[1] / snap.n_tasks:.5f}); bound {bound_ms:.6f} ms by {bound_by}; card {card}")
    return dict(launches=launches, int_ms=int_ms, f32_ms=f32_ms, int_bound_ms=bound_ms,
                int_bound_by=bound_by, session_ms=med_ms, session_max_ms=max(lat) * 1e3)


def blocked_pass_ms(snap) -> tuple:
    """(ms, stats) of one blocked pass over every task of ``snap`` on the
    card, host clock to a synchronize, the planes already there."""
    import torch

    from volcano_tpu_torch.ops.blocked import (
        _PASS_ARRAYS,
        prepare_blocked_arrays,
        schedule_pass_blocked,
    )
    from volcano_tpu_torch.ops.kernels import as_tensor

    arrays, T_blk = prepare_blocked_arrays(snap)
    planes = [as_tensor(arrays[k], "cuda") for k in _PASS_ARRAYS]
    active = torch.zeros(T_blk, dtype=torch.bool, device="cuda")
    active[: snap.n_tasks] = True
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    schedule_pass_blocked(*planes, active, top_k=BLOCKED_TOP_K, stats=stats)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, stats


def phase_wide_cell(card: str) -> dict:
    """The wide cell through execute_allocate: the session kernel's wide
    instance, equal to the torch spec on the card and, at full width, to
    its plain version; one blocked session beside it."""
    import torch

    from volcano_tpu_torch.ops import session_kernel
    from volcano_tpu_torch.ops.blocked import run_packed_blocked
    from volcano_tpu_torch.ops.executor import execute_allocate, last_allocate_executor
    from volcano_tpu_torch.ops.kernels import run_packed
    from volcano_tpu_torch.ops.session_kernel import (
        repeated_rows,
        session_pass_cuda,
        session_pass_reference,
    )
    from volcano_tpu_torch.ops.synthetic import generate_snapshot

    name = "50k_pods_20k_nodes_gang_predicates"
    snap = generate_snapshot(**WIDE_CONFIG)
    R, NK = snap.task_resreq.shape[1], session_kernel.node_width(snap.n_nodes)
    check(not session_kernel.fits_shared_memory(R, NK), f"{name}: node state fits one block")
    # the main path, with the launch counts read just before and after
    torch.cuda.synchronize()
    session_kernel.LAUNCHES = session_kernel.WIDE_LAUNCHES = 0
    t0 = time.perf_counter()
    out = execute_allocate(snap)
    first_s = time.perf_counter() - t0
    launches = session_kernel.WIDE_LAUNCHES
    executor = last_allocate_executor()
    check(executor == "cuda", f"{name}: executor {executor!r}, expected 'cuda'")
    check(launches > 0 and session_kernel.LAUNCHES == 0,
          f"{name}: wide launches {launches}, shared-layout launches {session_kernel.LAUNCHES}")
    t0 = time.perf_counter()
    spec = run_packed(snap, device="cuda")
    spec_s = time.perf_counter() - t0
    check(np.array_equal(out, spec), f"{name}: assignment != torch spec run_packed")
    lat = warm_sessions(snap, WARM_RUNS, out)
    med_ms = statistics.median(lat) * 1e3

    inputs = pass_inputs(snap, "cuda")
    pass_ms = kernel_ms(lambda: session_pass_cuda(*inputs), reps=3)
    chosen, stats = run_session_pass(inputs)
    repeats = repeated_rows(inputs[0])
    check(stats == [snap.n_tasks - repeats, repeats], f"{name}: kernel counts {stats}")
    off_ms = kernel_ms(plane_off_launch(inputs), reps=1)
    t0 = time.perf_counter()
    plain = session_pass_reference(*inputs)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = int((chosen.long() - plain.long()).abs().max())
    check(err == 0, f"{name}: wide instance != plain version at full width")
    by_bytes, by_ops, share = pass_bound_ms(inputs, chosen, snap.n_nodes)
    bound_ms, bound_by = max((by_bytes, "bytes"), (by_ops, "operations"))
    lens = (inputs[4][1:] - inputs[4][:-1]).float()
    print(f"{name}: assignment == torch spec run_packed ({spec_s:.3f} s to compute the "
          f"spec); placed {int((out >= 0).sum())}/{snap.n_tasks}; first session "
          f"{first_s * 1e3:.3f} ms; executor {executor}, wide launches {launches}; node state "
          f"{(R + 1) * NK * 4} bytes in global memory")
    print(f"{name}: session median {med_ms:.3f} ms, max {max(lat) * 1e3:.3f} ms over "
          f"{WARM_RUNS} warm runs; wide instance {pass_ms:.3f} ms per pass, plane off "
          f"{off_ms:.3f}; fast steps {stats[1]}/{snap.n_tasks} ({stats[1] / snap.n_tasks:.5f}); "
          f"class lists {inputs[4].numel() - 1}, mean {float(lens.mean()):.1f} nodes, longest "
          f"{int(lens.max())}; plain version {plain_ms:.3f} ms; bound {by_bytes:.6f} ms by "
          f"bytes, {by_ops:.6f} ms by operations ({share:.4f} listed); card {card}")

    bstats = {}
    t0 = time.perf_counter()
    bout = run_packed_blocked(snap, top_k=BLOCKED_TOP_K, stats=bstats)
    blocked_ms = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(bout, out), f"{name}: run_packed_blocked differs from the kernel")
    print(f"{name}: run_packed_blocked == the kernel's bindings; session {blocked_ms:.3f} ms; "
          f"blocks {bstats['blocks']}, stops {bstats['stops']} (each one full-width step), "
          f"passes {bstats['passes']}; card {card}")
    return dict(launches=launches, ms=pass_ms, plane_off_ms=off_ms, plain_ms=plain_ms,
                max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by,
                fast_step_share=stats[1] / snap.n_tasks, session_ms=med_ms,
                session_max_ms=max(lat) * 1e3, blocked_session_ms=blocked_ms,
                blocked_blocks=bstats["blocks"], blocked_stops=bstats["stops"])


def phase_lanes_session(card: str) -> None:
    """A session with LANES_SESSION resource lanes at 10k x 1k through
    execute_allocate: the wide instance, equal to the torch spec."""
    import torch

    from volcano_tpu_torch.ops import session_kernel
    from volcano_tpu_torch.ops.executor import execute_allocate, last_allocate_executor
    from volcano_tpu_torch.ops.kernels import run_packed
    from volcano_tpu_torch.ops.synthetic import (
        add_scalar_lanes,
        BASELINE_CONFIGS,
        generate_snapshot,
    )

    name = f"{SECOND_CONFIG}_{LANES_SESSION}_lanes"
    snap = add_scalar_lanes(generate_snapshot(**BASELINE_CONFIGS[SECOND_CONFIG]),
                            LANES_SESSION - 2, LANES_SESSION)
    torch.cuda.synchronize()
    session_kernel.LAUNCHES = session_kernel.WIDE_LAUNCHES = 0
    t0 = time.perf_counter()
    out = execute_allocate(snap)
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = session_kernel.WIDE_LAUNCHES
    check(last_allocate_executor() == "cuda" and launches > 0
          and session_kernel.LAUNCHES == 0,
          f"{name}: executor {last_allocate_executor()!r}, wide launches {launches}")
    check(np.array_equal(out, run_packed(snap, device="cuda")),
          f"{name}: assignment != torch spec run_packed")
    lat = warm_sessions(snap, WARM_RUNS, out)
    print(f"{name}: assignment == torch spec run_packed; placed {int((out >= 0).sum())}/"
          f"{snap.n_tasks}; first session {first_ms:.3f} ms, median "
          f"{statistics.median(lat) * 1e3:.3f} ms over {WARM_RUNS} warm runs; wide launches "
          f"{launches}; card {card}")


def phase_blocked_vs_kernel(card: str, main_rec: dict) -> dict:
    """run_packed_blocked at the main config on the card: its bindings
    equal the kernel's, its session and pass times beside the kernel's."""
    from volcano_tpu_torch.ops.blocked import run_packed_blocked
    from volcano_tpu_torch.ops.synthetic import BASELINE_CONFIGS, generate_snapshot

    snap = generate_snapshot(**BASELINE_CONFIGS[MAIN_CONFIG])
    t0 = time.perf_counter()
    out = run_packed_blocked(snap, top_k=BLOCKED_TOP_K)
    first_ms = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(out, main_rec["assignment"]),
          f"{MAIN_CONFIG}: run_packed_blocked != the kernel's execute_allocate")
    t0 = time.perf_counter()
    run_packed_blocked(snap, top_k=BLOCKED_TOP_K)
    again_ms = (time.perf_counter() - t0) * 1e3
    graph_ms, graph_stats = blocked_pass_ms(snap)
    print(f"{MAIN_CONFIG}: run_packed_blocked == the kernel's bindings; session "
          f"{first_ms:.3f} ms, again {again_ms:.3f} ms (kernel session "
          f"{main_rec['session_ms']:.3f} ms, pass {main_rec['ms']:.3f} ms); one blocked pass "
          f"{graph_ms:.3f} ms from CUDA graphs; blocks {graph_stats['blocks']}, stops "
          f"{graph_stats['stops']}; card {card}")
    return dict(main_session_ms=again_ms, main_first_session_ms=first_ms,
                main_pass_ms=graph_ms, main_blocks=graph_stats["blocks"],
                main_stops=graph_stats["stops"])


class ListBinder:
    """Records ``(ns/name, hostname)`` in the order binds arrive."""

    def __init__(self):
        self.binds = []

    def bind(self, task, hostname):
        self.binds.append((f"{task.namespace}/{task.name}", hostname))


def cycle_digest(binds) -> str:
    import hashlib

    return hashlib.sha256(repr(sorted(binds)).encode()).hexdigest()


def run_cycle(objects, device=None) -> dict:
    """One scheduling cycle of the port on a fresh cache: feed the
    cluster objects, open_session, gpu-allocate, close_session; the
    binds, each step's seconds, the action's phases and its apply
    route."""
    import volcano_tpu_torch.actions  # noqa: F401 — registers the actions
    import volcano_tpu_torch.plugins  # noqa: F401 — registers the plugins
    from volcano_tpu_torch.actions import gpu_allocate
    from volcano_tpu_torch.cache import SchedulerCache
    from volcano_tpu_torch.conf import PluginOption, Tier
    from volcano_tpu_torch.framework import close_session, open_session

    nodes, pods, pod_groups, queues = objects
    t0 = time.perf_counter()
    cache = SchedulerCache(binder=ListBinder())
    for node in nodes:
        cache.add_node(node)
    for pod in pods:
        cache.add_pod(pod)
    for pg in pod_groups:
        cache.add_pod_group(pg)
    for queue in queues:
        cache.add_queue(queue)
    t1 = time.perf_counter()
    ssn = open_session(cache, [Tier(plugins=[PluginOption(name=n) for n in tier])
                               for tier in CYCLE_TIERS], [])
    action = gpu_allocate.GpuAllocateAction(device=device)
    t2 = time.perf_counter()
    action.execute(ssn)
    t3 = time.perf_counter()
    close_session(ssn)
    t4 = time.perf_counter()
    return dict(binds=cache.binder.binds, feed_s=t1 - t0, open_s=t2 - t1, execute_s=t3 - t2,
                close_s=t4 - t3, phases=action.last_phase_stats,
                route=action.last_apply_route)


class ListEvictor:
    """Records ``ns/name`` in the order evictions arrive."""

    def __init__(self):
        self.evicts = []

    def evict(self, task):
        self.evicts.append(f"{task.namespace}/{task.name}")


def preempt_cycle_digest(evicted, pipelined) -> str:
    import hashlib

    return hashlib.sha256(repr((sorted(evicted), sorted(pipelined))).encode()).hexdigest()


def run_preempt_cycle(objects, device=None) -> dict:
    """One preempting scheduling cycle of the port on a fresh cache:
    feed the cluster objects, open_session, enqueue, gpu-allocate,
    gpu-preempt, backfill, close_session.  The evictions (in order), the
    pipelined (name, node) pairs read from the session before close, the
    binds, each step's and each action's seconds, and the device
    actions' phases and routes."""
    import volcano_tpu_torch.actions  # noqa: F401 — registers the actions
    import volcano_tpu_torch.plugins  # noqa: F401 — registers the plugins
    from volcano_tpu_torch.actions import backfill, enqueue, gpu_allocate, gpu_preempt
    from volcano_tpu_torch.api import TaskStatus
    from volcano_tpu_torch.cache import SchedulerCache
    from volcano_tpu_torch.conf import PluginOption, Tier
    from volcano_tpu_torch.framework import close_session, open_session

    nodes, pods, pod_groups, queues, priority_classes = objects
    t0 = time.perf_counter()
    cache = SchedulerCache(binder=ListBinder(), evictor=ListEvictor())
    for pc in priority_classes:
        cache.add_priority_class(pc)
    for node in nodes:
        cache.add_node(node)
    for pod in pods:
        cache.add_pod(pod)
    for pg in pod_groups:
        cache.add_pod_group(pg)
    for queue in queues:
        cache.add_queue(queue)
    t1 = time.perf_counter()
    ssn = open_session(cache, [Tier(plugins=[PluginOption(name=n) for n in tier])
                               for tier in PREEMPT_CYCLE_TIERS], [])
    t2 = time.perf_counter()
    allocate = gpu_allocate.GpuAllocateAction(device=device)
    preempt = gpu_preempt.GpuPreemptAction(device=device)
    actions = dict(zip(PREEMPT_CYCLE_ACTIONS, (enqueue.EnqueueAction(), allocate, preempt,
                                               backfill.BackfillAction())))
    action_s = {}
    for name, action in actions.items():
        ta = time.perf_counter()
        action.execute(ssn)
        action_s[name] = time.perf_counter() - ta
    pipelined = [(f"{t.namespace}/{t.name}", t.node_name) for job in ssn.jobs.values()
                 for t in job.task_status_index.get(TaskStatus.Pipelined, {}).values()]
    t3 = time.perf_counter()
    close_session(ssn)
    t4 = time.perf_counter()
    return dict(evicted=cache.evictor.evicts, pipelined=pipelined, binds=cache.binder.binds,
                feed_s=t1 - t0, open_s=t2 - t1, close_s=t4 - t3, action_s=action_s,
                allocate_phases=allocate.last_phase_stats,
                preempt_phases=preempt.last_phase_stats, preempt_route=preempt.last_route,
                preempt_executor=preempt.last_executor)


def phase_cycle(name: str, card: str) -> dict:
    """CYCLE_RUNS scheduling cycles of the config's cluster objects on
    fresh caches through gpu-allocate on the card (the port's entry
    point a scheduler calls): each places every pod, through the session
    kernel (launch counts set to 0 before the cycle, read after), with
    the bulk commit taking every task, no kernel failure (a deadline
    overrun counts as one), and binds whose digest is the JAX package's."""
    import torch

    from volcano_tpu_torch.ops import session_kernel
    from volcano_tpu_torch.ops.executor import last_allocate_executor
    from volcano_tpu_torch.ops.synthetic import BASELINE_CONFIGS, generate_cluster_objects

    t0 = time.perf_counter()
    objects = generate_cluster_objects(**BASELINE_CONFIGS[name])
    build_s = time.perf_counter() - t0
    n_pods = len(objects[1])
    runs = []
    for i in range(CYCLE_RUNS):
        failures = kernel_failures()
        torch.cuda.synchronize()
        session_kernel.LAUNCHES = session_kernel.WIDE_LAUNCHES = 0
        rec = run_cycle(objects)
        launches, wide = session_kernel.LAUNCHES, session_kernel.WIDE_LAUNCHES
        what = f"{name} cycle {i + 1}"
        check(len(rec["binds"]) == n_pods, f"{what}: {len(rec['binds'])} binds, not {n_pods}")
        check(last_allocate_executor() == "cuda",
              f"{what}: executor {last_allocate_executor()!r}, expected 'cuda'")
        check(launches + wide > 0, f"{what}: the session kernel was not launched")
        check(rec["route"] == "fast", f"{what}: apply route {rec['route']!r}, not the bulk commit")
        check(kernel_failures() == failures, f"{what}: kernel failures counted")
        digest = cycle_digest(rec["binds"])
        check(digest == CYCLE_DIGESTS[name],
              f"{what}: binds digest {digest} != the JAX package's {CYCLE_DIGESTS[name]}")
        rec.update(launches=launches, wide_launches=wide)
        runs.append(rec)

    def stat(key, scale=1e3):
        vals = [r[key] * scale for r in runs]
        return statistics.median(vals), max(vals)

    def phase(key):
        vals = [r["phases"].get(key, 0.0) for r in runs]
        return statistics.median(vals), max(vals)

    out = dict(config=name, cycles=CYCLE_RUNS, binds=n_pods, digest=CYCLE_DIGESTS[name],
               build_objects_ms=build_s * 1e3, launches_per_cycle=runs[-1]["launches"],
               wide_launches_per_cycle=runs[-1]["wide_launches"], card=card)
    for key in ("feed_s", "open_s", "execute_s", "close_s"):
        med, mx = stat(key)
        out[f"{key[:-2]}_ms_median"], out[f"{key[:-2]}_ms_max"] = med, mx
    for key in ("order_ms", "pack_ms", "execute_ms", "apply_ms", "commit_ms"):
        med, mx = phase(key)
        out[f"phase_{key[:-3]}_ms_median"], out[f"phase_{key[:-3]}_ms_max"] = med, mx
    out["pods_per_s"] = n_pods / (out["execute_ms_median"] / 1e3)
    print(f"{name}: {CYCLE_RUNS} cycles through gpu-allocate, each {n_pods} binds with the "
          f"JAX package's digest, executor cuda, bulk commit, {out['launches_per_cycle']} "
          f"launches; execute() median {out['execute_ms_median']:.3f} ms, max "
          f"{out['execute_ms_max']:.3f} (order {out['phase_order_ms_median']:.3f}, pack "
          f"{out['phase_pack_ms_median']:.3f}, device {out['phase_execute_ms_median']:.3f}, "
          f"apply {out['phase_apply_ms_median']:.3f} of which commit "
          f"{out['phase_commit_ms_median']:.3f}); open_session "
          f"{out['open_ms_median']:.3f}, close_session {out['close_ms_median']:.3f}; "
          f"{out['pods_per_s']:.1f} pods/s; card {card}")
    print(json.dumps({"cycle": out}))
    return out


def phase_preempt_cycle(name: str, card: str) -> dict:
    """PREEMPT_CYCLE_RUNS preempting scheduling cycles of the cell's
    cluster objects on fresh caches through enqueue, gpu-allocate,
    gpu-preempt and backfill on the card (a scheduler's entry point
    under the conf ``enqueue, allocate, preempt, backfill``).  Each
    cycle: gpu-preempt ran the preempt kernel (executor ``cuda``, one
    launch, launch counts set to 0 before the cycle and read after) on
    the device route; gpu-allocate bound nothing, explained at least one
    task from the device's reason counts and swept the host chooser for
    none; no kernel failure; and the sha256 of (sorted evictions, sorted
    pipelined (name, node) pairs) is the JAX package's on the same
    objects."""
    import torch

    from volcano_tpu_torch.ops import preempt_kernel, session_kernel
    from volcano_tpu_torch.ops.synthetic import generate_preempt_cluster_objects

    t0 = time.perf_counter()
    objects = generate_preempt_cluster_objects(**PREEMPT_CYCLE_CELLS[name])
    build_s = time.perf_counter() - t0
    cycles = PREEMPT_CYCLE_RUNS[name]
    runs = []
    for i in range(cycles):
        failures = kernel_failures()
        torch.cuda.synchronize()
        preempt_kernel.LAUNCHES = 0
        session_kernel.LAUNCHES = session_kernel.WIDE_LAUNCHES = 0
        rec = run_preempt_cycle(objects)
        launches = preempt_kernel.LAUNCHES
        alloc_launches = session_kernel.LAUNCHES + session_kernel.WIDE_LAUNCHES
        what = f"{name} preempt cycle {i + 1}"
        alloc = rec["allocate_phases"]
        check(rec["preempt_executor"] == "cuda",
              f"{what}: preempt executor {rec['preempt_executor']!r}, expected 'cuda'")
        check(launches == 1, f"{what}: the preempt kernel launched {launches} times, not once")
        check(rec["preempt_route"] == "device",
              f"{what}: gpu-preempt route {rec['preempt_route']!r}, expected 'device'")
        check(alloc_launches > 0, f"{what}: gpu-allocate did not launch the session kernel")
        check(not rec["binds"], f"{what}: gpu-allocate bound {len(rec['binds'])} pods")
        check(alloc.get("explained", 0) >= 1,
              f"{what}: gpu-allocate explained no task from the device counts")
        check(alloc.get("host_sweeps", -1) == 0,
              f"{what}: gpu-allocate swept the host chooser {alloc.get('host_sweeps')} times")
        check(kernel_failures() == failures, f"{what}: kernel failures counted")
        check(rec["evicted"] and rec["pipelined"], f"{what}: the cycle preempted nothing")
        digest = preempt_cycle_digest(rec["evicted"], rec["pipelined"])
        check(digest == PREEMPT_CYCLE_DIGESTS[name],
              f"{what}: digest {digest} != the JAX package's {PREEMPT_CYCLE_DIGESTS[name]}")
        rec.update(launches=launches, alloc_launches=alloc_launches)
        runs.append(rec)

    def med_max(vals):
        return statistics.median(vals), max(vals)

    out = dict(config=name, cycles=cycles, pods=len(objects[1]), nodes=len(objects[0]),
               digest=PREEMPT_CYCLE_DIGESTS[name], build_objects_ms=build_s * 1e3,
               evicted=len(runs[-1]["evicted"]), pipelined=len(runs[-1]["pipelined"]),
               explained=runs[-1]["allocate_phases"]["explained"],
               host_sweeps=runs[-1]["allocate_phases"]["host_sweeps"],
               explain_rows=runs[-1]["allocate_phases"].get("explain_rows", 0),
               preempt_launches_per_cycle=runs[-1]["launches"],
               allocate_launches_per_cycle=runs[-1]["alloc_launches"], card=card)
    for key in ("feed_s", "open_s", "close_s"):
        out[f"{key[:-2]}_ms_median"], out[f"{key[:-2]}_ms_max"] = med_max(
            [r[key] * 1e3 for r in runs])
    for action in PREEMPT_CYCLE_ACTIONS:
        out[f"{action}_ms_median"], out[f"{action}_ms_max"] = med_max(
            [r["action_s"][action] * 1e3 for r in runs])
    for prefix, phases, keys in (
            ("allocate", "allocate_phases", ("order", "pack", "execute", "explain",
                                             "explain_pack", "explain_reduce", "apply")),
            ("preempt", "preempt_phases", ("pack", "execute", "apply"))):
        for key in keys:
            out[f"{prefix}_{key}_ms_median"], out[f"{prefix}_{key}_ms_max"] = med_max(
                [r[phases].get(f"{key}_ms", 0.0) for r in runs])
    print(f"{name}: {cycles} preempting cycles (enqueue, gpu-allocate, gpu-preempt, "
          f"backfill), each {out['evicted']} evictions and {out['pipelined']} pipelined with "
          f"the JAX package's digest, preempt executor cuda, {out['preempt_launches_per_cycle']} "
          f"preempt launch, route device; gpu-allocate explained {out['explained']} tasks, "
          f"{out['host_sweeps']} host sweeps; gpu-allocate median "
          f"{out['gpu-allocate_ms_median']:.3f} ms (explain {out['allocate_explain_ms_median']:.3f}"
          f" over {out['explain_rows']} rows: pack {out['allocate_explain_pack_ms_median']:.3f},"
          f" reduce {out['allocate_explain_reduce_ms_median']:.3f}),"
          f" gpu-preempt median {out['gpu-preempt_ms_median']:.3f} ms (pack "
          f"{out['preempt_pack_ms_median']:.3f}, device {out['preempt_execute_ms_median']:.3f}, "
          f"apply {out['preempt_apply_ms_median']:.3f}); open_session {out['open_ms_median']:.3f}, "
          f"close_session {out['close_ms_median']:.3f}; card {card}")
    print(json.dumps({"preempt_cycle": out}))
    return out


def kernel_failures() -> float:
    """Every failed or refused kernel call counted in this process."""
    from volcano_tpu_torch import metrics

    return sum(metrics.registry.counters("volcano_executor_failures_total").values())


def phase_failures(card: str) -> None:
    """The breakers on the card at 10k x 1k, driven by the fault plane:
    an injected lowering failure raises ExecutorFailed and is counted;
    three open the breaker and the fourth call is refused without a
    launch; an injected corrupt output is caught by the gate; the same
    for the preempt kernel; nothing runs in the kernel's place.  The
    plane and the breakers are reset after, and a clean session runs on
    the kernel with the bindings it had."""
    from volcano_tpu_torch import faults, metrics
    from volcano_tpu_torch.ops import dispatch, preempt_kernel, session_kernel
    from volcano_tpu_torch.ops.dispatch import ExecutorFailed, last_executor
    from volcano_tpu_torch.ops.executor import execute_allocate, execute_preempt
    from volcano_tpu_torch.ops.synthetic import (
        BASELINE_CONFIGS,
        generate_preempt_packed,
        generate_snapshot,
    )

    def failures(executor: str, cause: str) -> float:
        return metrics.registry.counter("volcano_executor_failures_total",
                                        executor=executor, cause=cause)

    ran = []
    real = dispatch.run_packed, dispatch.preempt_dense

    def fails(call, executor: str, cause: str, what: str) -> None:
        """``call()`` raises ExecutorFailed with ``cause``, counted once."""
        before = failures(executor, cause)
        try:
            call()
        except ExecutorFailed as e:
            check(e.cause == cause, f"failures: {what}: cause {e.cause!r}, expected {cause!r}")
        else:
            raise RuntimeError(f"chip_smoke: failures: {what}: no ExecutorFailed raised")
        check(failures(executor, cause) == before + 1, f"failures: {what}: not counted")

    snap = generate_snapshot(**BASELINE_CONFIGS[SECOND_CONFIG])
    clean = execute_allocate(snap)
    check(last_executor() == "cuda", "failures: the clean session did not run on cuda")
    pk = generate_preempt_packed(**PREEMPT_CASES[-1])
    ev0, pipe0 = execute_preempt(pk)
    # any formulation that could stand in for a kernel records its call
    dispatch.run_packed = lambda *a, **k: ran.append("run_packed")
    dispatch.preempt_dense = lambda *a, **k: ran.append("preempt_dense")
    try:
        faults.configure("seed=1;device.lowering=1:count=1")
        fails(lambda: execute_allocate(snap), "cuda", "error", "injected lowering failure")
        check(faults.get_breaker("cuda").state == "closed" and faults.degraded_reasons(),
              "failures: one failure must leave the breaker closed and show as degraded")

        faults.reset_breakers()
        faults.configure("seed=1;device.lowering=1:count=3")
        for i in range(3):
            fails(lambda: execute_allocate(snap), "cuda", "error", f"lowering {i + 1} of 3")
        check(faults.get_breaker("cuda").state == "open", "failures: breaker not open after 3")
        launches = session_kernel.LAUNCHES
        fails(lambda: execute_allocate(snap), "cuda", "circuit-open", "open breaker")
        check(session_kernel.LAUNCHES == launches, "failures: the open breaker launched")

        faults.reset_breakers()
        faults.configure("seed=1;device.nan=1:count=1")
        fails(lambda: execute_allocate(snap), "cuda", "corrupt-output", "injected corrupt output")

        faults.reset_breakers()
        faults.configure("seed=1;device.lowering=1:count=3")
        for i in range(3):
            fails(lambda: execute_preempt(pk), "preempt-cuda", "error",
                  f"preempt lowering {i + 1} of 3")
        check(faults.get_breaker("preempt-cuda").state == "open",
              "failures: preempt breaker not open after 3")
        launches = preempt_kernel.LAUNCHES
        fails(lambda: execute_preempt(pk), "preempt-cuda", "circuit-open", "open preempt breaker")
        check(preempt_kernel.LAUNCHES == launches, "failures: the open preempt breaker launched")
    finally:
        dispatch.run_packed, dispatch.preempt_dense = real
        faults.configure(None)
        faults.reset_breakers()
    check(ran == [], f"failures: {ran} ran in a kernel's place")
    check(not faults.degraded_reasons(), "failures: breakers not reset")
    check(np.array_equal(execute_allocate(snap), clean) and last_executor() == "cuda",
          "failures: the clean session after the reset differs or left the kernel")
    ev, pipe = execute_preempt(pk)
    check(np.array_equal(ev, ev0) and np.array_equal(pipe, pipe0),
          "failures: the clean preempt pass after the reset differs")
    print(f"failures: a lowering failure raises ExecutorFailed (counted), 3 open the breaker, "
          f"the 4th call circuit-open without a launch, device.nan caught by the gate; the same "
          f"for preempt-cuda; nothing ran in a kernel's place; plane and breakers reset, the "
          f"kernels' results as before; {kernel_failures():.0f} failures counted in all; "
          f"card {card}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU", file=sys.stderr)
        return 1
    import volcano_tpu_torch  # noqa: F401 — without the checkout, fail before any output

    card = card_line()
    print(f"card: {card}")
    phase_build()
    phase_kernel_vs_plain()
    phase_preempt_kernel_vs_plain()
    phase_int_kernel_vs_plain()
    phase_wide_kernel_vs_plain()
    main_rec = phase_main_path(MAIN_CONFIG, card, compare_plain=True)
    phase_main_path(SECOND_CONFIG, card, compare_plain=False)
    pre_rec = phase_preempt_main_path(card)
    dgx_rec = phase_dgx_cell(card, main_rec["ms"])
    wide_rec = phase_wide_cell(card)
    phase_lanes_session(card)
    blocked_rec = phase_blocked_vs_kernel(card, main_rec)
    cycle_rec = phase_cycle(MAIN_CONFIG, card)
    phase_cycle(SECOND_CONFIG, card)
    preempt_cycle_rec = phase_preempt_cycle(PREEMPT_CYCLE_MAIN, card)
    phase_preempt_cycle(PREEMPT_CYCLE_SECOND, card)
    from volcano_tpu_torch import faults

    check(kernel_failures() == 0 and not faults.degraded_reasons(),
          f"the main paths counted {kernel_failures():.0f} kernel failures: "
          f"{faults.degraded_reasons()}")
    phase_failures(card)

    kernels = [
        {
            "name": "session_pass",
            "route": "cuda",
            "source": "volcano_tpu_torch/csrc/session_kernel.cu",
            "replaces": "volcano_tpu/ops/pallas_session.py:123",
            "launches": main_rec["launches"],
            "max_abs_err": main_rec["max_abs_err"],
            "ms": main_rec["ms"],
            "plain_ms": main_rec["plain_ms"],
            "bound_ms": main_rec["bound_ms"],
            "bound_by": main_rec["bound_by"],
            "latency_floor_ms": main_rec["latency_floor_ms"],
            "chain_floor_ms": main_rec["chain_floor_ms"],
            "fast_step_share": main_rec["fast_step_share"],
            "int_ms": dgx_rec["int_ms"],
            "int_bound_ms": dgx_rec["int_bound_ms"],
            "int_bound_by": dgx_rec["int_bound_by"],
            "int_launches": dgx_rec["launches"],
            "cycle_launches": cycle_rec["launches_per_cycle"],
            "library_ms": None,
        },
        {
            "name": "session_pass_wide",
            "route": "cuda",
            "source": "volcano_tpu_torch/csrc/session_kernel.cu",
            "replaces": "volcano_tpu/ops/pallas_session.py:123",
            "launches": wide_rec["launches"],
            "max_abs_err": wide_rec["max_abs_err"],
            "ms": wide_rec["ms"],
            "plain_ms": wide_rec["plain_ms"],
            "bound_ms": wide_rec["bound_ms"],
            "bound_by": wide_rec["bound_by"],
            "fast_step_share": wide_rec["fast_step_share"],
            "plane_off_ms": wide_rec["plane_off_ms"],
            "session_ms": wide_rec["session_ms"],
            "library_ms": None,
        },
        {
            "name": "preempt_pass",
            "route": "cuda",
            "source": "volcano_tpu_torch/csrc/preempt_kernel.cu",
            "replaces": "volcano_tpu/ops/preempt_pallas.py:95",
            "launches": pre_rec["launches"],
            "max_abs_err": pre_rec["max_abs_err"],
            "ms": pre_rec["ms"],
            "plain_ms": pre_rec["plain_ms"],
            "bound_ms": pre_rec["bound_ms"],
            "bound_by": pre_rec["bound_by"],
            "latency_floor_ms": pre_rec["latency_floor_ms"],
            "chain_floor_ms": pre_rec["chain_floor_ms"],
            "fast_attempt_share": pre_rec["fast_attempt_share"],
            "plane_off_ms": pre_rec["plane_off_ms"],
            "cycle_launches": preempt_cycle_rec["preempt_launches_per_cycle"],
            "library_ms": None,
        },
    ]
    # the blocked formulation is torch ops, not a kernel: its times on a
    # line of their own
    print(json.dumps({"blocked": dict(
        route="torch ops", source="volcano_tpu_torch/ops/blocked.py",
        replaces="volcano_tpu/ops/blocked.py:168", top_k=BLOCKED_TOP_K,
        wide_session_ms=wide_rec["blocked_session_ms"], wide_blocks=wide_rec["blocked_blocks"],
        wide_stops=wide_rec["blocked_stops"], **blocked_rec)}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
