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
     preempt, the plain pass) on the same session (allocate's, with
     phase 5's, computed on the CPU beside phases 2-6 and the loop by
     ``SpecPool`` and held after them); at 50k x 10k the kernel pass equal to its plain
     version at full width (computed on the CPU by ``SpecPool`` too) and
     on its first PLAIN_CARD_ROWS rows on the card, where the plain
     version is timed; the session kernel's
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
     the wide instance, equal to the torch spec and to its plain version
     (at full width on the CPU, on PLAIN_CARD_ROWS rows on the card); a
     9-lane session at 10k x 1k on the wide
     instance, equal to the torch spec; ``run_packed_blocked`` (torch
     ops, on no dispatch path) at 50k x 10k and on the wide cell, equal
     to the kernel; ``run_packed_sharded`` (torch ops, reached by name)
     over 4 shards at 50k x 10k and 8 at 10k x 1k, every shard on
     cuda:0, and on a small cell whose blocks stop (the cross-shard
     full-width step), each equal to the kernel;
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
     then the scheduler loop (``phase_loop``): ``Scheduler.run_once``
     cycle after cycle on one cache with snapshot reuse, from a policy
     file, for each of LOOP_CELLS — 3 cycles at 50k x 10k with every
     bound pod returned to Pending between cycles (``update_pod``, spec
     unchanged; every cycle the JAX package's cycle digest, every cycle
     after the first a warm pack reusing all 50,000 task rows), 5 at
     10k x 1k with ``generate_loop_events``' churn between cycles (gangs
     finish, gangs arrive, 10 nodes relabelled; each cycle's binds with
     LOOP_DIGESTS' digest, task rows reused from the third cycle on),
     and one preempting cycle at 10k x 1k (PREEMPT_CYCLE_DIGESTS, one
     preempt launch).  Every cycle runs the session kernel with node
     operands built on the card from the resident planes; each warm
     pack is held against a seeded cold pack, the staged planes against
     the numpy planes and the node operands against the host's, bit for
     bit; a ``{"loop": ...}`` line a cell; then the event-driven loop
     (``phase_micro``): ``Scheduler(micro_cycles=True)`` over MICRO_CARD_CELLS
     (a full cycle binding every pod, then 6 windows of arrivals, each
     wake routed as the loop routes it), the 10k x 1k cell over full
     sessions and the 50k x 10k cell with restricted sessions and a
     strict shadow cross-check every other micro-cycle, every window's
     binds with the JAX package's digest (MICRO_DIGESTS), the gang's window a full cycle counted under its
     cause, every session on the session kernel; then MICRO_STREAM, 1,000
     single-pod jobs at 100/s into ``Scheduler.run()`` in a thread, every
     pod bound, submit -> bind p50/p99/max printed; a ``{"micro": ...}``
     line a cell; then the store (``phase_store``): the port's in-process
     ``APIServer`` seeded with the cluster, a ``SchedulerCache(client=
     SchedulerClient(api), snapshot_reuse=True)`` filled from its watch,
     and ``Scheduler.run_once`` from a policy file, every bind, eviction,
     Event, pod condition and PodGroup status landing in the store as a
     commit frame, through the pipelined commit plane and, for the 10k
     cells, again on the scheduling thread (STORE_MODES, each on a fresh
     store): 2 cycles at 50k x 10k (the store's digest STORE_DIGESTS,
     50,000 Scheduled Events, every PodGroup Running, the cache on store
     truth), the stream
     (1,000 single-pod jobs at 100/s through ``api.create`` into
     ``Scheduler.run()`` on the pipelined store, every pod bound, submit ->
     bind p50/p99/max at store truth and from the histogram's
     observations), 3 churn cycles at 10k x 1k with
     ``generate_loop_events`` applied through the store's API
     (STORE_LOOP_DIGESTS), and one preempting cycle whose evictions land
     as store deletes (STORE_PREEMPT_DIGESTS); no commit failure, resync
     entry or quarantined task; a ``{"store": ...}`` line a cell; then the
     scheduler daemon (``phase_daemon``): ``cmd/scheduler.SchedulerDaemon``
     leader-elected on the in-process store at 50k x 10k, binding it with
     STORE_DIGESTS' digest, /healthz and /metrics with the identity
     labels, its lease's longest renew gap; a second daemon as standby,
     the leader crash-stopped, 1,000 arrivals bound by the standby with
     ARRIVAL_DIGESTS' digest, a ``{"daemon": ...}`` line; then the bus
     (``phase_bus``): the apiserver binary and two leader-elected
     scheduler binaries as child processes on the card at 10k x 1k, the
     cluster seeded over the wire (``seed_wire``), the leader binding it with
     STORE_DIGESTS' digest read back through the wire, SIGKILLed, the
     standby binding the arrivals with ARRIVAL_DIGESTS', each scheduler
     child's cycles, commits and launches read through its SIGUSR1 status
     line and /metrics (no cycle that raised, no commit or executor
     failure, the session kernel launched in its cycles past its
     warmup's), the children exiting 0 on SIGTERM, a ``{"bus": ...}``
     line; then the replicated store (``phase_ha``, HA_CELL): three
     apiserver binaries, each on its own data directory, electing a
     leader; the same cluster seeded through the group, one scheduler
     child on the card binding it with STORE_DIGESTS' digest read from a
     follower, the replicas' store digests equal; the leader replica
     SIGKILLed and a survivor leading within the lease TTL plus a probe
     round, the arrivals bound with ARRIVAL_DIGESTS' digest and no
     relist; the killed replica recovered from its data directory and
     rejoined as a follower at lag 0 (``vtctl bus status``), a
     ``{"ha": ...}`` line; then the sharded scheduler federation
     (``phase_federation``): (a) ``FederatedScheduler(api, "fed-solo", 1)``
     over an in-process store holding the 50k x 10k cluster, its first
     cycle on the session kernel (3 launches, ``cuda``) leaving the store
     at STORE_DIGESTS' digest; (b) two members over one in-process
     ``BusServer`` at 10k x 1k, each on its own ``RemoteAPIServer``:
     disjoint slices covering every node, each member's binding cycle on
     the session kernel, every pod bound once, a gang no shard hosts
     alone committed through ``txn_commit``, a burst spilled through
     ``cas_bind``, ``verify_federation`` clean, then ``shard.kill`` in one
     member and the survivor holding both shards within FED_TAKEOVER_S
     of its last renew (both members started at once, no cycle held
     back for a relist but by the member itself) and binding the
     arrivals; a ``{"federation": ...}`` line; then the
     Job path in process (``phase_jobs``, JOB_CELL): the
     port's admission with the pod gate, ``ControllersDaemon`` (job,
     podgroup and queue controllers, the GC on an injected clock) and
     ``SchedulerDaemon`` (enqueue and gpu-allocate on the card), stepped
     with a fake kubelet through 100 Jobs x 50 tasks on 1,000 nodes, the
     lifecycle (50 jobs succeed and are reaped, one restarts after a
     pod fails with exit code 137, one is suspended and resumed with
     ``vtctl``) and 50 more jobs; every expected phase, every pod within
     its node's allocatable, 3 launches in each cycle that binds, no host
     sweep, kernel failure or fallback, the store's digest JOB_DIGESTS;
     a ``{"jobs_tick": ...}`` line a tick and a ``{"jobs": ...}`` line;
     then the Job path over the wire (``phase_local_up``): the port's
     apiserver, admission, controllers and scheduler (on the card)
     binaries as children (``cmd.local_up.multiproc_up``), a gang job of
     three run by ``vtctl --bus`` bound with its PodGroup Running and 3
     launches in the scheduler child, an invalid job refused by the
     admission child, ``vtctl`` reads, every child exiting 0 on SIGTERM,
     the children on the shm rings (the scheduler child's ring pair
     mapped in the phase's directory), a ``{"local_up": ...}`` line;
  7. the sidecar (``phase_sidecar``) — the compute-plane sidecar as a
     child process (``python -m volcano_tpu_torch.cmd.compute_plane
     --socket PATH --warmup``, serving on the card; its pid holds memory
     in ``nvidia-smi``), this process its scheduler through
     ``executor.configure``: LOOP_A's SIDECAR_CYCLES cycles through it (a
     full frame, then a delta frame; each cycle LOOP_A's digest, executor ``auto``,
     no fallback, no kernel launched here and the session kernel
     launched in the child, read through its SIGUSR1 status line), one
     preempting cycle at 100k pods x 10k nodes (its digest, one preempt
     launch in the child), a ``ServingServer`` (/healthz, /metrics,
     /explain = the cache's unschedulable digest), then the child
     SIGKILLed and a 10k x 1k cycle on the in-process kernel with its
     digest, exactly one fallback counted and /healthz degraded; a
     ``{"sidecar": ...}`` line with the frames' bytes and round trips;
  8. replay (``phase_replay``) — the trace recorder on: LOOP_A's first
     2 cycles, LOOP_C's preempting cycle and LOOP_B's first 2 churn
     cycles with ``trace.enable(dir, snapshot_every=1)``, LOOP_A's third
     with ``snapshot_every=0`` (events only), each cycle with its digest
     and a journal record holding a bind decision per bind and the
     loop's, the framework's, gpu-allocate's and the dispatcher's spans
     and events; every captured cycle replayed through the session
     kernel (``trace.verify(..., executor="cuda")``) with zero diff and
     kernel launches, the recorded churn cycles through the native host
     baseline with zero diff; ``/trace/last`` serving
     the last recorded cycle; ``python -m volcano_tpu_torch.cmd.trace
     replay`` exiting 0 in a child; a ``{"replay": ...}`` line (the
     recorder's cost on interleaved warm 50k x 10k cycles, ``recorder_cost``,
     runs by hand);
  9. failures — the fault plane drives the breakers on the card: an
     injected lowering failure or corrupt output raises ``ExecutorFailed``
     and is counted, three open the breaker, the fourth call is refused
     without a launch, the same for preempt-cuda; nothing runs in the
     kernel's place; then the plane and the breakers are reset and a
     clean session runs on the kernel again.
Then one JSON line each with the blocked and the sharded formulations'
times (torch ops, not kernels), one JSON line listing each kernel with its launches, its match with
the plain version, its time, the plain version's time, its bound by
bytes and operations and its latency floor (the serial chain, timed link
by link by the step probe), and as the last line the device record.

Exits non-zero, printing no result, when no GPU is present.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Optional

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
DGX_CELL = "dgx_h100_50k_pods_10k_nodes"
WIDE_CELL = "50k_pods_20k_nodes_gang_predicates"
#: the 9-lane session: the second config with 7 scalar lanes (device
#: plugins) beside cpu and memory, more lanes than the shared layout takes
LANES_SESSION = 9
LANES_CELL = f"10k_pods_1k_nodes_fairshare_{LANES_SESSION}_lanes"
#: candidates a task tracks in the blocked formulation's runs here: its
#: inner step is launch-bound, so 32 slots cost what 8 do and stop no
#: block of the cells (8, the reference's default, stops most of them)
BLOCKED_TOP_K = 32
MAIN_CONFIG = "50k_pods_10k_nodes_gang_predicates"
SECOND_CONFIG = "10k_pods_1k_nodes_fairshare"
PREEMPT_CONFIG = "100k_pods_10k_nodes_preempt"
#: the packed-session cells whose assignment is held against the torch
#: spec (``run_packed``) at full width, longest first.  The spec is a
#: sequential scan, about a minute a cell on the card, so ``SpecPool``
#: computes it on the CPU (the spec tier-1 holds against the JAX
#: package), in child processes beside phases 2-6 and the loop
SPEC_CELLS = (WIDE_CELL, MAIN_CONFIG, DGX_CELL, SECOND_CONFIG, LANES_CELL)
#: the cells whose kernel pass is held against the plain PyTorch version
#: (``session_pass_reference``) at full width.  The plain version is a
#: sequential scan, 50-75 s a cell on the card, so ``SpecPool`` computes
#: it on the CPU too; on the card the plain version is timed, and held
#: against the kernel, on the cell's first PLAIN_CARD_ROWS task rows
PLAIN_CELLS = (MAIN_CONFIG, WIDE_CELL)
PLAIN_CARD_ROWS = 4096
#: the children's jobs, longest first (their seconds on the card host:
#: 212, 137, 119, 94, 58, 14 and 8; 286, 174, 163, 104, 68, 16 and 8 beside
#: the Job path's phases), over three children, so they are done about
#: when the loop phases are
SPEC_ORDER = (("spec", WIDE_CELL), ("spec", DGX_CELL), ("spec", MAIN_CONFIG),
              ("plain", WIDE_CELL), ("plain", MAIN_CONFIG), ("spec", LANES_CELL),
              ("spec", SECOND_CONFIG))
SPEC_WORKERS = 3
#: warm sessions timed a packed-session cell: 3 give a median and keep the
#: whole run inside its time limit
WARM_RUNS = 3

#: the scheduling cycle's tiers (the JAX package's bench/_profsetup.py)
CYCLE_TIERS = (("priority", "gang"), ("drf", "predicates", "proportion", "nodeorder", "binpack"))
#: sha256 of repr(sorted(binds)) that the JAX package's jax-allocate gives
#: for each config's cluster objects (generate_cluster_objects, seed 0)
#: under CYCLE_TIERS; tests/test_torch_digests.py recomputes them
CYCLE_DIGESTS = {
    MAIN_CONFIG: "c5ccf48727093b88dd6634c8eb317b91cf968f30e419d920f5d637d389b374ca",
    SECOND_CONFIG: "9853688e576b441a556020ec00bb36671927f220ec2514ed5e728276f2e4859a",
}
#: cycles a cycle cell runs, each on a fresh cache and held to its
#: digest (3 until the replicated store's phase needed the room, 2 until
#: the federation's did: the fresh-cache cycles repeat one path)
CYCLE_RUNS = 1

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
#: (3 each until the replicated store's phase needed the room, 2 until
#: the federation's did)
PREEMPT_CYCLE_RUNS = {PREEMPT_CYCLE_MAIN: 1, PREEMPT_CYCLE_SECOND: 1}
#: sha256 of repr((sorted evicted names, sorted (name, node) pipelined
#: pairs)) that the JAX package's enqueue, jax-allocate, jax-preempt,
#: backfill give on each cell's objects under PREEMPT_CYCLE_TIERS;
#: tests/test_torch_digests.py recomputes them
PREEMPT_CYCLE_DIGESTS = {
    PREEMPT_CYCLE_MAIN: "6c98d6e0cbff4d587fd0b4a2eb10f03dc12138bc306754617907b701b04148a9",
    PREEMPT_CYCLE_SECOND: "8bad40bf659689c3508a934dc810f6213a868194a3f6f81e10d0eaeaa792317d",
}

#: the scheduler loop's cells: ``Scheduler.run_once`` cycle after cycle
#: on one cache (``snapshot_reuse=True``), from a policy file (the revert
#: cell's cycles, a cold one and then warm ones, keep the whole run
#: inside its time limit).  A cell names its cluster (a cycle config, or the
#: preempt cell), its tiers and actions, its cycles, and what happens in
#: the store between cycles:
#: ``revert`` (every bound pod back to Pending through ``update_pod``
#: with its spec unchanged) or ``churn`` (``generate_loop_events``, seed 0)
#: and, where the card runs fewer than tier-1 holds on the CPU, its
#: ``card_cycles`` (the revert cell's 3 on the card since the replicated
#: store's phase needed the room)
LOOP_A = "loop_50k_pods_10k_nodes_revert"
LOOP_B = "loop_10k_pods_1k_nodes_churn"
LOOP_C = "loop_10k_pods_1k_nodes_preempt"
LOOP_CELLS = {
    LOOP_A: dict(config=MAIN_CONFIG, tiers=CYCLE_TIERS, actions=("gpu-allocate",),
                 cycles=4, card_cycles=3, between="revert"),
    LOOP_B: dict(config=SECOND_CONFIG, tiers=CYCLE_TIERS, actions=("gpu-allocate",),
                 cycles=5, between="churn"),
    LOOP_C: dict(config=PREEMPT_CYCLE_SECOND, tiers=PREEMPT_CYCLE_TIERS,
                 actions=PREEMPT_CYCLE_ACTIONS, cycles=1, between=None),
}
#: sha256 of each cycle's sorted binds that the JAX package's Scheduler
#: with jax-allocate gives over the churn cell's events;
#: tests/test_torch_digests.py recomputes them
LOOP_DIGESTS = {
    LOOP_B: [
        "9853688e576b441a556020ec00bb36671927f220ec2514ed5e728276f2e4859a",
        "9c7888c53346c71caae5289517965d899f89b636170c749bf5bb96c8703f25fc",
        "317423345ce8ce3bf4085ccefb26e62d0d96f50bcb920b7a08210a3f99e5620a",
        "f836ae89bcdbcf5a6821cd731654c471529f812ffa6159f154d6c1e61ee21f95",
        "e1fee391f5372f8a30d170d2ff4a7087aba9e05ccbaf75772f77dbac681e1eb0",
    ],
}

#: the event-driven loop's cells: a fresh ``SchedulerCache(snapshot_reuse=
#: True)`` fed a cycle config's cluster, ``Scheduler(micro_cycles=True)``
#: on it from a policy file naming gpu-allocate under CYCLE_TIERS; window
#: 0 a full cycle binding every pod, then ``windows`` windows of
#: ``generate_micro_events`` (seed 0, ``jobs`` jobs of 4 pods a window,
#: the gang of 8 in window 3), each routed as the loop routes a wake
#: (``micro_window``).  Every cell runs in each of MICRO_MODES on a fresh
#: cache.  The card runs each cell of MICRO_CARD_CELLS in the modes it
#: names: MICRO_A restricted and MICRO_B over full sessions.  MICRO_A over
#: full sessions took ~51 s beside an NVIDIA H100 80GB HBM3 (700 W) even
#: through the gang's window only (its 50k objects built and fed again,
#: window 1's 50k bind echoes) and gave way to the Job path's phases;
#: MICRO_B restricted gave way to the daemon and bus phases (the cell
#: took ~29 s in both modes).  Tier-1 holds both cells in both modes on
#: the CPU in both packages
MICRO_A = "micro_50k_pods_10k_nodes_arrivals"
MICRO_B = "micro_10k_pods_1k_nodes_arrivals"
MICRO_CELLS = {
    MICRO_A: dict(config=MAIN_CONFIG, jobs=64, windows=6),
    MICRO_B: dict(config=SECOND_CONFIG, jobs=13, windows=6),
}
MICRO_CARD_CELLS = {MICRO_A: ("restricted",), MICRO_B: ("full-session",)}
#: the Scheduler options of each mode: micro-cycles over full sessions,
#: and restricted sessions with a strict shadow cross-check every other
#: restricted cycle
MICRO_MODES = {
    "full-session": dict(restricted_sessions=False),
    "restricted": dict(restricted_sessions=True, shadow_every=2, shadow_strict=True),
}
#: sha256 of each window's sorted binds that the JAX package's Scheduler
#: with jax-allocate gives over each micro cell's events, restricted or
#: not; tests/test_torch_digests.py recomputes them
MICRO_DIGESTS = {
    MICRO_A: [
        "c5ccf48727093b88dd6634c8eb317b91cf968f30e419d920f5d637d389b374ca",
        "20339ec73a4ab609a5bc0d3ed72f0d6c3fc567dd2273fc15f747bfa2662888b4",
        "76446b9464df13123dab7002915e45ca2571bf3fe99bac98f42dc85249e0c647",
        "bf42a2dfe9225fbc7731c3a413d4d84dd38d01b801d3b28a0fa1c010974ea3a8",
        "7bb338c8fbff532532983b1e7258b90ae0678cb7d4a76d224c3abdfd12ef6f52",
        "d287cde75d903ae54ee2346e629d9720cb06c7a3f148dadc6fc93a3c192c1464",
        "a8061372e58d6d1691cf236f1ed6a99520f7c6e95418e3234c1c6aa028402333",
    ],
    MICRO_B: [
        "9853688e576b441a556020ec00bb36671927f220ec2514ed5e728276f2e4859a",
        "7c1eb71ebdac17968cc661452c59acc0cd48589c749b907352aaa7e15821dcf6",
        "9bfb095a982b8577159786005f06c40861b3a36f66d2f65eedd1360186efa591",
        "aab8657a711e9af6da5c1a1f5a417d721ddc74508b829616a026b7a774d5e0a8",
        "845dddfc634f8d567698f4c5822ed9d5235db8574f16193d9dad0b461f6c9d46",
        "9d043b59ef676ec59d8ac3f68db8d653b978dc4deedd9169282a0878cd8af446",
        "fe5034d2ab3ffa8c90f69f86f7f2ddac8214dd5b600f2635ef6e6b80d6494026",
    ],
}
#: the stream cell: the same cluster as MICRO_A after its window 0, then
#: ``Scheduler.run()`` in a thread (restricted sessions, the reference's
#: shadow sampling, 5 ms debounce) while single-pod jobs arrive at
#: ``rate`` pods/s for ``seconds`` (the defaults of the reference's SLO
#: harness, bench/loadgen.py).  Its period is 10 s, not the reference's
#: 1 s: a full cycle at 50k x 10k takes ~4 s, and run_cycle_window runs
#: micro-cycles only until its period ends, so a 1 s period would run no
#: micro-cycle at all
MICRO_S = "micro_50k_pods_10k_nodes_stream"
MICRO_STREAM = dict(config=MAIN_CONFIG, rate=100, seconds=10.0, drain_s=30.0, period=10.0,
                    shadow_every=16, debounce_ms=5.0)

#: the store cells (``phase_store``): the cluster created in the port's
#: in-process ``APIServer`` (priority classes, nodes, pods, pod groups,
#: queues, in the generator's order), a ``SchedulerCache(client=
#: SchedulerClient(api), snapshot_reuse=True)`` filled from its watch, and
#: ``Scheduler.run_once`` from a policy file; binds, evictions, Events,
#: pod conditions and PodGroup statuses land in the store as commit frames,
#: on the scheduling thread (``sync``) or through the pipelined commit plane
#: with the reference daemon's two bind workers (``pipelined``), each mode
#: on a fresh store.  A cell names its cluster, tiers, actions, cycles,
#: what happens between cycles (``churn``: ``generate_loop_events``, seed 0,
#: applied through the store's API), its modes and, where the card runs
#: fewer than tier-1 holds on the CPU, its ``card_cycles``.  To make room
#: for the daemon and bus phases the 50k cycle runs pipelined only, the
#: reference daemon's mode, as ``phase_daemon`` does (its synchronous
#: mode took 35-50 s; the synchronous commit stays on the 10k cells), and
#: the churn cell runs its first 3 cycles (the last two took ~25 s)
STORE_MODES = {
    "sync": dict(pipelined_commit=False),
    "pipelined": dict(pipelined_commit=True),
}
STORE_CYCLE = "store_50k_pods_10k_nodes_cycle"
STORE_CHURN = "store_10k_pods_1k_nodes_churn"
STORE_PREEMPT = "store_10k_pods_1k_nodes_preempt"
STORE_STREAM = "store_50k_pods_10k_nodes_stream"
STORE_CELLS = {
    STORE_CYCLE: dict(config=MAIN_CONFIG, tiers=CYCLE_TIERS, actions=("gpu-allocate",),
                      cycles=2, between=None, modes=("pipelined",)),
    STORE_CHURN: dict(config=SECOND_CONFIG, tiers=CYCLE_TIERS, actions=("gpu-allocate",),
                      cycles=5, card_cycles=3, between="churn", modes=tuple(STORE_MODES)),
    STORE_PREEMPT: dict(config=PREEMPT_CYCLE_SECOND, tiers=PREEMPT_CYCLE_TIERS,
                        actions=PREEMPT_CYCLE_ACTIONS, cycles=1, between=None,
                        modes=tuple(STORE_MODES)),
}
#: sha256 of the store's sorted (ns/name, spec.node_name) pairs after a
#: cycle config's first cycle through the store, as the JAX package's
#: Scheduler with jax-allocate gives it through its own APIServer and
#: SchedulerClient (tests/test_torch_store_loop.py recomputes them).  They
#: differ from CYCLE_DIGESTS: the store stamps the wall clock on an object
#: created with a zero creation timestamp, as an API server does, which
#: makes the generator's first PodGroup the newest job
STORE_DIGESTS = {
    MAIN_CONFIG: "c4918e79d782eff31dd394afcc81f816f4ef2b52eb4c919856c4c3d9fb5cbb7a",
    SECOND_CONFIG: "587433fafbf4f761d59ba6cc580e28089fe7b2e3da357c509967c0974854a175",
}
#: the same digest after each cycle of the churn cell
STORE_LOOP_DIGESTS = {
    STORE_CHURN: [
        "587433fafbf4f761d59ba6cc580e28089fe7b2e3da357c509967c0974854a175",
        "05364eee13d054b7cd9c49da9382b52b8f2c15002b12fdabfa1a5f46a57d9437",
        "d5a0718bdd8aebab31448211406806832bf7d644cafe5c86a6e79560def10e41",
        "9f580afe4e0cbd878821b5120ab0e66bf4a992f107116876ca839159ba2088c8",
        "a2e5c3afada34793aaf2bbf0d3aa68894c8801f191771702bbba624ac31ee5b0",
    ],
}
#: sha256 of repr((sorted pods deleted from the store, sorted pipelined
#: (name, node) pairs)) of the preempt cell's cycle through the JAX
#: package's store (the preempt cell binds nothing, and its digest is the
#: cycle's without the store, PREEMPT_CYCLE_DIGESTS')
STORE_PREEMPT_DIGESTS = {
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


def phase_main_path(name: str, card: str, compare_plain: bool, specs: SpecPool) -> dict:
    import torch

    from volcano_tpu_torch.ops import session_kernel
    from volcano_tpu_torch.ops.executor import execute_allocate, last_allocate_executor
    from volcano_tpu_torch.ops.session_kernel import (
        prepare_session_arrays,
        repeated_rows,
        score_latency_probe,
        session_pass_cuda,
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

    specs.hold(name, out)
    placed = int((out >= 0).sum())
    print(f"{name}: placed {placed}/{snap.n_tasks}; first session {first_s * 1e3:.3f} ms; "
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
        # full width on the CPU (SpecPool), the timing on the card over
        # the first PLAIN_CARD_ROWS rows
        specs.hold_plain(name, chosen)
        plain_rec = card_plain(inputs, chosen, name)
        by_bytes, by_ops, share = pass_bound_ms(inputs, chosen, snap.n_nodes)
        bound_ms, bound_by = max((by_bytes, "bytes"), (by_ops, "operations"))
        floor_ms, probe = latency_floor_ms(inputs[0])
        plain_ms = plain_rec["plain_ms"]
        record.update(bound_ms=bound_ms, bound_by=bound_by, latency_floor_ms=floor_ms,
                      chain_floor_ms=probe["chain_ms"], fast_step_share=stats[1] / snap.n_tasks,
                      **plain_rec)
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
        print(f"{name}: plain version {plain_ms:.3f} ms on the first {PLAIN_CARD_ROWS} rows "
              f"(the kernel {plain_rec['plain_kernel_ms']:.3f}); bound {by_bytes:.6f} ms "
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


def card_plain(inputs, chosen, name: str) -> dict:
    """The plain version on the card over a pass's first PLAIN_CARD_ROWS
    task rows (a prefix of a sequential pass is the pass of the prefix):
    its ms, the kernel's ms on the same rows, and their max abs error,
    which must be 0, as must the prefix of the full pass's ``chosen``."""
    import torch

    from volcano_tpu_torch.ops.session_kernel import session_pass_cuda, session_pass_reference

    part = (inputs[0][:PLAIN_CARD_ROWS].contiguous(),) + tuple(inputs[1:])
    part_chosen, _ = run_session_pass(part)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = session_pass_reference(*part)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = int((part_chosen.long() - plain.long()).abs().max())
    check(err == 0 and torch.equal(part_chosen, chosen[:PLAIN_CARD_ROWS]),
          f"{name}: kernel != plain version on the first {PLAIN_CARD_ROWS} rows")
    return dict(plain_ms=plain_ms, max_abs_err=err, plain_rows=PLAIN_CARD_ROWS,
                plain_kernel_ms=kernel_ms(lambda: session_pass_cuda(*part), reps=3))


def cpu_plain(name: str) -> tuple:
    """The plain version's pass (``session_pass_reference``) of a
    PLAIN_CELLS cell's snapshot on the CPU, every task active, and the
    seconds it took."""
    from volcano_tpu_torch.ops.session_kernel import session_pass_reference

    t0 = time.perf_counter()
    out = session_pass_reference(*pass_inputs(spec_snapshot(name), "cpu")).numpy()
    return out, time.perf_counter() - t0


def spec_snapshot(name: str):
    """A SPEC_CELLS cell's snapshot (``generate_snapshot``)."""
    from volcano_tpu_torch.ops.synthetic import (
        add_scalar_lanes,
        BASELINE_CONFIGS,
        generate_snapshot,
    )

    if name == LANES_CELL:
        return add_scalar_lanes(generate_snapshot(**BASELINE_CONFIGS[SECOND_CONFIG]),
                                LANES_SESSION - 2, LANES_SESSION)
    config = {DGX_CELL: DGX_CONFIG, WIDE_CELL: WIDE_CONFIG}.get(name) or BASELINE_CONFIGS[name]
    return generate_snapshot(**config)


def cpu_spec(name: str) -> tuple:
    """The torch spec's assignment of a cell's snapshot on the CPU, and
    the seconds it took."""
    from volcano_tpu_torch.ops.kernels import run_packed

    t0 = time.perf_counter()
    out = run_packed(spec_snapshot(name), device="cpu")
    return out, time.perf_counter() - t0


def one_intra_op_thread() -> None:
    import torch

    torch.set_num_threads(1)


class SpecPool:
    """``cpu_spec`` of every SPEC_CELLS cell and ``cpu_plain`` of every
    PLAIN_CELLS cell, in SPEC_WORKERS spawned child processes (no CUDA
    context; one intra-op thread each), longest first (SPEC_ORDER),
    started before the build.  A phase ``hold``s its cell's assignment and
    ``hold_plain``s its kernel pass's ``chosen``; ``check_all`` holds
    each against its spec or plain pass after the loop phases (the wide
    cell's spec, the longest child job, ends about then; before the loop
    phases the script waited on it ~80 s) and returns the plain passes'
    max abs errors, and ``close`` stops the children, before the
    event-driven and store phases run."""

    def __init__(self):
        import multiprocessing

        self.pool = multiprocessing.get_context("spawn").Pool(
            SPEC_WORKERS, initializer=one_intra_op_thread)
        self.specs, self.plains = {}, {}
        for kind, name in SPEC_ORDER:
            table, fn = (self.specs, cpu_spec) if kind == "spec" else (self.plains, cpu_plain)
            table[name] = self.pool.apply_async(fn, (name,))
        self.held, self.held_plain = {}, {}

    def hold(self, name: str, out) -> None:
        self.held[name] = out

    def hold_plain(self, name: str, chosen) -> None:
        self.held_plain[name] = chosen.cpu().numpy()

    def check_all(self) -> dict:
        check(set(self.held) == set(SPEC_CELLS), f"spec cells held: {sorted(self.held)}")
        check(set(self.held_plain) == set(PLAIN_CELLS),
              f"plain cells held: {sorted(self.held_plain)}")
        for name in SPEC_CELLS:
            spec, spec_s = self.specs[name].get(timeout=600)
            check(np.array_equal(self.held[name], spec),
                  f"{name}: assignment != torch spec run_packed on the CPU")
            print(f"{name}: assignment == torch spec run_packed on the CPU ({spec_s:.3f} s in "
                  f"a child process beside the card's phases)")
        errs = {}
        for name in PLAIN_CELLS:
            plain, plain_s = self.plains[name].get(timeout=600)
            chosen = self.held_plain[name]
            errs[name] = int(np.abs(chosen.astype(np.int64) - plain.astype(np.int64)).max())
            check(errs[name] == 0, f"{name}: kernel != plain version at full width (on the CPU)")
            print(f"{name}: kernel pass == plain version at full width on the CPU "
                  f"({plain_s:.3f} s in a child process beside the card's phases)")
        return errs

    def close(self) -> None:
        if self.pool is not None:
            self.pool.terminate()
            self.pool.join()
            self.pool = None


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


def phase_dgx_cell(card: str, f32_cell_ms: float, specs: SpecPool) -> dict:
    """The DGX H100 cell through execute_allocate: the kernel in its int
    mode, equal to the torch spec on the card; its pass in int mode and,
    on the same data, in f32 mode, beside the f32 cell's pass."""
    import torch

    from volcano_tpu_torch.ops import session_kernel
    from volcano_tpu_torch.ops.executor import execute_allocate, last_allocate_executor
    from volcano_tpu_torch.ops.kernels import f32_lr_exact
    from volcano_tpu_torch.ops.session_kernel import repeated_rows, session_pass_cuda
    from volcano_tpu_torch.ops.synthetic import generate_snapshot

    name = DGX_CELL
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
    specs.hold(name, out)
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
    print(f"{name}: int mode; placed {int((out >= 0).sum())}/{snap.n_tasks}; first session "
          f"{first_s * 1e3:.3f} ms; launches {launches}; executor {executor}")
    print(f"{name}: session median {med_ms:.3f} ms, max {max(lat) * 1e3:.3f} ms over "
          f"{WARM_RUNS} warm runs; kernel {int_ms:.3f} ms per pass in int mode, "
          f"{f32_ms:.3f} ms in f32 mode on the same data (chosen "
          f"{'equal' if torch.equal(chosen, chosen_f32) else 'different'}); the f32 cell's "
          f"pass {f32_cell_ms:.3f} ms; fast steps {stats[1]}/{snap.n_tasks} "
          f"({stats[1] / snap.n_tasks:.5f}); bound {bound_ms:.6f} ms by {bound_by}; card {card}")
    return dict(launches=launches, int_ms=int_ms, f32_ms=f32_ms, int_bound_ms=bound_ms,
                int_bound_by=bound_by, session_ms=med_ms, session_max_ms=max(lat) * 1e3)


def phase_wide_cell(card: str, specs: SpecPool) -> dict:
    """The wide cell through execute_allocate: the session kernel's wide
    instance, equal to the torch spec on the card and to its plain version
    (``card_plain``; at full width in ``SpecPool``); one blocked session
    beside it."""
    import torch

    from volcano_tpu_torch.ops import session_kernel
    from volcano_tpu_torch.ops.blocked import run_packed_blocked
    from volcano_tpu_torch.ops.executor import execute_allocate, last_allocate_executor
    from volcano_tpu_torch.ops.session_kernel import (
        repeated_rows,
        session_pass_cuda,
    )
    from volcano_tpu_torch.ops.synthetic import generate_snapshot

    name = WIDE_CELL
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
    specs.hold(name, out)
    lat = warm_sessions(snap, WARM_RUNS, out)
    med_ms = statistics.median(lat) * 1e3

    inputs = pass_inputs(snap, "cuda")
    pass_ms = kernel_ms(lambda: session_pass_cuda(*inputs), reps=3)
    chosen, stats = run_session_pass(inputs)
    repeats = repeated_rows(inputs[0])
    check(stats == [snap.n_tasks - repeats, repeats], f"{name}: kernel counts {stats}")
    off_ms = kernel_ms(plane_off_launch(inputs), reps=1)
    specs.hold_plain(name, chosen)
    plain_rec = card_plain(inputs, chosen, name)
    plain_ms = plain_rec["plain_ms"]
    by_bytes, by_ops, share = pass_bound_ms(inputs, chosen, snap.n_nodes)
    bound_ms, bound_by = max((by_bytes, "bytes"), (by_ops, "operations"))
    lens = (inputs[4][1:] - inputs[4][:-1]).float()
    print(f"{name}: placed {int((out >= 0).sum())}/{snap.n_tasks}; first session "
          f"{first_s * 1e3:.3f} ms; executor {executor}, wide launches {launches}; node state "
          f"{(R + 1) * NK * 4} bytes in global memory")
    print(f"{name}: session median {med_ms:.3f} ms, max {max(lat) * 1e3:.3f} ms over "
          f"{WARM_RUNS} warm runs; wide instance {pass_ms:.3f} ms per pass, plane off "
          f"{off_ms:.3f}; fast steps {stats[1]}/{snap.n_tasks} ({stats[1] / snap.n_tasks:.5f}); "
          f"class lists {inputs[4].numel() - 1}, mean {float(lens.mean()):.1f} nodes, longest "
          f"{int(lens.max())}; plain version {plain_ms:.3f} ms on the first {PLAIN_CARD_ROWS} "
          f"rows (the wide instance {plain_rec['plain_kernel_ms']:.3f}); bound {by_bytes:.6f} ms by "
          f"bytes, {by_ops:.6f} ms by operations ({share:.4f} listed); card {card}")

    bstats = {}
    t0 = time.perf_counter()
    bout = run_packed_blocked(snap, top_k=BLOCKED_TOP_K, stats=bstats)
    blocked_ms = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(bout, out), f"{name}: run_packed_blocked differs from the kernel")
    print(f"{name}: run_packed_blocked == the kernel's bindings; session {blocked_ms:.3f} ms; "
          f"blocks {bstats['blocks']}, stops {bstats['stops']} (each one full-width step), "
          f"passes {bstats['passes']}; card {card}")
    return dict(launches=launches, ms=pass_ms, plane_off_ms=off_ms, **plain_rec,
                bound_ms=bound_ms, bound_by=bound_by,
                fast_step_share=stats[1] / snap.n_tasks, session_ms=med_ms,
                session_max_ms=max(lat) * 1e3, blocked_session_ms=blocked_ms,
                blocked_blocks=bstats["blocks"], blocked_stops=bstats["stops"])


def phase_lanes_session(card: str, specs: SpecPool) -> None:
    """A session with LANES_SESSION resource lanes at 10k x 1k through
    execute_allocate: the wide instance, equal to the torch spec."""
    import torch

    from volcano_tpu_torch.ops import session_kernel
    from volcano_tpu_torch.ops.executor import execute_allocate, last_allocate_executor

    name = LANES_CELL
    snap = spec_snapshot(name)
    torch.cuda.synchronize()
    session_kernel.LAUNCHES = session_kernel.WIDE_LAUNCHES = 0
    t0 = time.perf_counter()
    out = execute_allocate(snap)
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = session_kernel.WIDE_LAUNCHES
    check(last_allocate_executor() == "cuda" and launches > 0
          and session_kernel.LAUNCHES == 0,
          f"{name}: executor {last_allocate_executor()!r}, wide launches {launches}")
    specs.hold(name, out)
    lat = warm_sessions(snap, WARM_RUNS, out)
    print(f"{name}: placed {int((out >= 0).sum())}/"
          f"{snap.n_tasks}; first session {first_ms:.3f} ms, median "
          f"{statistics.median(lat) * 1e3:.3f} ms over {WARM_RUNS} warm runs; wide launches "
          f"{launches}; card {card}")


def phase_blocked_vs_kernel(card: str, main_rec: dict) -> dict:
    """run_packed_blocked at the main config on the card: its bindings
    equal the kernel's, its session time beside the kernel's (one
    session, a single pass: its second session and a separate timing of
    the pass gave their time to the sharded phase)."""
    from volcano_tpu_torch.ops.blocked import run_packed_blocked
    from volcano_tpu_torch.ops.synthetic import BASELINE_CONFIGS, generate_snapshot

    snap = generate_snapshot(**BASELINE_CONFIGS[MAIN_CONFIG])
    stats = {}
    t0 = time.perf_counter()
    out = run_packed_blocked(snap, top_k=BLOCKED_TOP_K, stats=stats)
    session_ms = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(out, main_rec["assignment"]),
          f"{MAIN_CONFIG}: run_packed_blocked != the kernel's execute_allocate")
    print(f"{MAIN_CONFIG}: run_packed_blocked == the kernel's bindings; session "
          f"{session_ms:.3f} ms (kernel session {main_rec['session_ms']:.3f} ms, pass "
          f"{main_rec['ms']:.3f} ms); passes {stats['passes']}, blocks {stats['blocks']}, "
          f"stops {stats['stops']}; card {card}")
    return dict(main_session_ms=session_ms, main_passes=stats["passes"],
                main_blocks=stats["blocks"], main_stops=stats["stops"])


#: the sharded phase's cells: (config, shards), every shard on cuda:0 (the
#: card machine has one GPU); each shard tracks BLOCKED_TOP_K candidates
SHARDED_CELLS = ((MAIN_CONFIG, 4), (SECOND_CONFIG, 8))
#: a small cell whose blocks stop, so the cross-shard full-width step runs:
#: 4 shards of 16 nodes, uniform nodes (ties across shards), 4 candidates
SHARDED_STOPS = dict(snap=dict(n_tasks=300, n_nodes=50, gang_size=4, seed=0), shards=4,
                     block_size=16, top_k=4)


def phase_sharded_vs_kernel(card: str, recs: Optional[dict] = None) -> dict:
    """run_packed_sharded on cuda:0 (torch ops, no kernel of its own): its
    bindings equal the session kernel's at the main config over 4 shards,
    at the second over 8, and on a small cell whose blocks stop.  ``recs``
    holds the main path's records by config; without them the kernel's
    bindings are computed here."""
    from volcano_tpu_torch.ops.executor import execute_allocate
    from volcano_tpu_torch.ops.sharded import run_packed_sharded
    from volcano_tpu_torch.ops.synthetic import BASELINE_CONFIGS, generate_snapshot

    def session(snap, shards, **kwargs):
        stats = {}
        t0 = time.perf_counter()
        out = run_packed_sharded(snap, devices=["cuda:0"] * shards, stats=stats, **kwargs)
        return out, (time.perf_counter() - t0) * 1e3, stats

    record = {}
    for name, shards in SHARDED_CELLS:
        snap = generate_snapshot(**BASELINE_CONFIGS[name])
        want = recs[name]["assignment"] if recs else execute_allocate(snap)
        got, ms, stats = session(snap, shards, top_k=BLOCKED_TOP_K)
        check(np.array_equal(got, want),
              f"{name}: run_packed_sharded over {shards} shards != the kernel's bindings")
        print(f"{name}: run_packed_sharded over {shards} shards on cuda:0 == the kernel's "
              f"bindings; session {ms:.3f} ms; passes {stats['passes']}, blocks "
              f"{stats['blocks']}, stops {stats['stops']}; gathered "
              f"{stats['gather_bytes_per_block']} bytes a block; card {card}")
        record[name] = dict(shards=shards, session_ms=ms, passes=stats["passes"],
                            blocks=stats["blocks"], stops=stats["stops"],
                            gather_bytes_per_block=stats["gather_bytes_per_block"])
    cell = SHARDED_STOPS
    snap = generate_snapshot(**cell["snap"])
    want = execute_allocate(snap)
    got, ms, stats = session(snap, cell["shards"], block_size=cell["block_size"],
                             top_k=cell["top_k"])
    check(np.array_equal(got, want), "the stops cell: run_packed_sharded != the kernel's bindings")
    check(stats["stops"] > 0, f"the stops cell stopped no block ({stats})")
    print(f"stops cell: run_packed_sharded over {cell['shards']} shards == the kernel's bindings; "
          f"blocks {stats['blocks']}, stops {stats['stops']} (each a cross-shard full-width "
          f"step); session {ms:.3f} ms; card {card}")
    record["stops_cell"] = dict(shards=cell["shards"], session_ms=ms, blocks=stats["blocks"],
                                stops=stats["stops"])
    return record


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


class ListStatusUpdater:
    """Counts the close-time writeback: pod conditions and PodGroup
    statuses."""

    def __init__(self):
        self.conditions = 0
        self.pod_groups = 0

    def update_pod_condition(self, task, reason, message):
        self.conditions += 1

    def update_pod_group(self, pg):
        self.pod_groups += 1
        return pg


def run_preempt_cycle(objects, device=None, status_updater=None) -> dict:
    """One preempting scheduling cycle of the port on a fresh cache:
    feed the cluster objects, open_session, enqueue, gpu-allocate,
    gpu-preempt, backfill, close_session.  The evictions (in order), the
    pipelined (name, node) pairs read from the session before close, the
    binds, each step's and each action's seconds, the device actions'
    phases and routes, and the cache (whose ``status_updater`` is the
    one given)."""
    import volcano_tpu_torch.actions  # noqa: F401 — registers the actions
    import volcano_tpu_torch.plugins  # noqa: F401 — registers the plugins
    from volcano_tpu_torch.actions import backfill, enqueue, gpu_allocate, gpu_preempt
    from volcano_tpu_torch.api import TaskStatus
    from volcano_tpu_torch.cache import SchedulerCache
    from volcano_tpu_torch.conf import PluginOption, Tier
    from volcano_tpu_torch.framework import close_session, open_session

    nodes, pods, pod_groups, queues, priority_classes = objects
    t0 = time.perf_counter()
    cache = SchedulerCache(binder=ListBinder(), evictor=ListEvictor(),
                           status_updater=status_updater)
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
                preempt_executor=preempt.last_executor, cache=cache)


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
        del rec["cache"]  # five caches of this size are not kept alive
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
                                             "explain_pack", "explain_reduce",
                                             "explain_kernel_rows", "apply")),
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
          f" reduce {out['allocate_explain_reduce_ms_median']:.3f}; the kernel rows' reduction"
          f" {out['allocate_explain_kernel_rows_ms_median']:.3f} inside execute),"
          f" gpu-preempt median {out['gpu-preempt_ms_median']:.3f} ms (pack "
          f"{out['preempt_pack_ms_median']:.3f}, device {out['preempt_execute_ms_median']:.3f}, "
          f"apply {out['preempt_apply_ms_median']:.3f}); open_session {out['open_ms_median']:.3f}, "
          f"close_session {out['close_ms_median']:.3f}; card {card}")
    print(json.dumps({"preempt_cycle": out}))
    return out


class RecordPipelined:
    """An observer action for the loop's preempt cell: the session's
    pipelined ``(ns/name, node)`` pairs, read before the session closes
    (the cache never sees a pipelined task).  Registered by
    :func:`loop_cycles` under ``record-pipelined`` and listed last in
    that cell's policy; it changes nothing."""

    def __init__(self):
        self.pipelined = []

    def name(self) -> str:
        return "record-pipelined"

    def execute(self, ssn) -> None:
        from volcano_tpu_torch.api import TaskStatus

        self.pipelined = [
            (f"{t.namespace}/{t.name}", t.node_name) for job in ssn.jobs.values()
            for t in job.task_status_index.get(TaskStatus.Pipelined, {}).values()]


def loop_conf_text(tiers, actions) -> str:
    """The scheduler's policy document for a loop cell (YAML)."""
    lines = [f'actions: "{", ".join(actions)}"', "tiers:"]
    for tier in tiers:
        lines.append("- plugins:")
        lines.extend(f"  - name: {name}" for name in tier)
    return "\n".join(lines) + "\n"


def revert_binds(cache, pods, binds) -> None:
    """Every bound pod back to Pending through the cache's public
    ``update_pod(old, new)``: old is the pod Running on its node, new
    the pod as first submitted (its spec unchanged) — last cycle's pods
    finished and an identical batch arrived."""
    import copy

    for name, host in binds:
        pod = pods[name]
        old = copy.copy(pod)
        old.spec = copy.copy(pod.spec)
        old.spec.node_name = host
        old.status = copy.copy(pod.status)
        old.status.phase = "Running"
        cache.update_pod(old, pod)


def loop_objects(config: str):
    """A loop cell's cluster objects: a cycle config's
    (``generate_cluster_objects``) or a preempt cell's
    (``generate_preempt_cluster_objects``)."""
    from volcano_tpu_torch.ops.synthetic import (
        BASELINE_CONFIGS,
        generate_cluster_objects,
        generate_preempt_cluster_objects,
    )

    if config in PREEMPT_CYCLE_CELLS:
        return generate_preempt_cluster_objects(**PREEMPT_CYCLE_CELLS[config])
    return generate_cluster_objects(**BASELINE_CONFIGS[config])


def loop_cache(objects, binder=None):
    """A ``SchedulerCache(snapshot_reuse=True)`` with ``binder`` (a
    ``ListBinder`` where None) and a ``ListEvictor``, fed ``objects``
    (nodes, pods, pod groups, queues[, priority classes]) through its
    handlers; (cache, seconds)."""
    from volcano_tpu_torch.cache import SchedulerCache

    nodes, pods, pod_groups, queues, *rest = objects
    t0 = time.perf_counter()
    cache = SchedulerCache(binder=binder or ListBinder(), evictor=ListEvictor(),
                           snapshot_reuse=True)
    for pc in (rest[0] if rest else ()):
        cache.add_priority_class(pc)
    for add, objs in ((cache.add_node, nodes), (cache.add_pod, pods),
                      (cache.add_pod_group, pod_groups), (cache.add_queue, queues)):
        for obj in objs:
            add(obj)
    return cache, time.perf_counter() - t0


@contextlib.contextmanager
def policy_file(tiers, actions):
    """The path of a policy document (``loop_conf_text``) written to a
    temporary directory, removed after."""
    import os
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="vtpu-loop-")
    try:
        path = os.path.join(tmp, "scheduler.conf")
        with open(path, "w") as f:
            f.write(loop_conf_text(tiers, actions))
        yield path
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def loop_cycles(objects, tiers, actions, cycles: int, between=None, cache_hook=None,
                cycle_window=contextlib.nullcontext):
    """The port's scheduler loop on one cache: feed ``objects`` (nodes,
    pods, pod groups, queues[, priority classes]) to a
    ``SchedulerCache(snapshot_reuse=True)``, write the policy (``tiers``,
    ``actions``) to a file in a temporary directory, and run
    ``Scheduler(cache, scheduler_conf_path=...).run_once()`` ``cycles``
    times, with ``between`` ("revert", "churn" or None) applied to the
    store before every cycle but the first.  Yields one record a cycle:
    its binds, evictions and pipelined pairs, the store events' and the
    cycle's steps' seconds (``Scheduler.last_cycle``), gpu-allocate's
    phases, and the clones the pool handed the session.
    ``cache_hook(cache)`` runs once, after the feed, and each
    ``run_once`` runs inside ``cycle_window()``.  The actions run as
    registered (``framework.get_action``)."""
    from volcano_tpu_torch.cache import feed_events
    from volcano_tpu_torch.framework import get_action, register_action
    from volcano_tpu_torch.ops.synthetic import (
        generate_loop_events,
        loop_world,
        record_binds,
    )
    from volcano_tpu_torch.scheduler.scheduler import Scheduler

    nodes, pods, pod_groups, queues, *rest = objects
    cache, feed_s = loop_cache(objects)
    if cache_hook is not None:
        cache_hook(cache)
    world = loop_world((nodes, pods, pod_groups, queues)) if between == "churn" else None
    by_name = {f"{p.metadata.namespace}/{p.metadata.name}": p for p in pods}
    recorder = RecordPipelined()
    register_action(recorder)
    with policy_file(tiers, tuple(actions) + (recorder.name(),)) as path:
        scheduler = Scheduler(cache, scheduler_conf_path=path)
        binds = []
        for k in range(cycles):
            if k and between == "revert":
                t0 = time.perf_counter()
                revert_binds(cache, by_name, binds)
                feed_s = time.perf_counter() - t0
            elif k and between == "churn":
                record_binds(world, binds)
                t0 = time.perf_counter()
                feed_events(cache, generate_loop_events(world, k, seed=0))
                feed_s = time.perf_counter() - t0
            n_binds, n_evicts = len(cache.binder.binds), len(cache.evictor.evicts)
            with cycle_window():
                scheduler.run_once()
            binds = cache.binder.binds[n_binds:]
            allocate = get_action("gpu-allocate")
            yield dict(cycle=k, binds=binds, evicted=cache.evictor.evicts[n_evicts:],
                       pipelined=recorder.pipelined, feed_s=feed_s,
                       pool_nodes=cache.last_pool_reuse[0], pool_jobs=cache.last_pool_reuse[1],
                       phases=dict(allocate.last_phase_stats), **scheduler.last_cycle)


def packs_equal(warm, cold) -> list:
    """The planes and fields where two PackedSnapshots differ (none: [])."""
    from volcano_tpu_torch.ops.pack_cache import (
        JOB_PLANES,
        NODE_DYNAMIC_PLANES,
        NODE_STATIC_PLANES,
        TASK_PLANES,
    )

    planes = TASK_PLANES + NODE_DYNAMIC_PLANES + NODE_STATIC_PLANES + JOB_PLANES + ("tolerance",)
    fields = ("n_tasks", "n_nodes", "n_jobs", "task_uids", "node_names", "job_uids",
              "resource_names", "needs_host_validation", "memory_exact")
    return ([n for n in planes if not np.array_equal(getattr(warm, n), getattr(cold, n))]
            + [f for f in fields if getattr(warm, f) != getattr(cold, f)])


def operands_equal(snap) -> list:
    """Where the staged planes of ``snap`` differ from its numpy planes,
    and the node operands the session kernel builds from them
    (``device_node_operands``) from ``prepare_session_arrays``' host
    arrays, bit for bit (none: [])."""
    import torch

    from volcano_tpu_torch.ops.device_stage import fetch_plane, STAGED_PLANES
    from volcano_tpu_torch.ops.kernels import _feasibility_classes
    from volcano_tpu_torch.ops.session_kernel import (
        device_node_operands,
        prepare_session_arrays,
    )

    planes = snap.device_planes
    bad = [n for n in STAGED_PLANES
           if not np.array_equal(fetch_plane(planes[n], getattr(snap, n)), getattr(snap, n))]
    host, _, _ = prepare_session_arrays(snap)
    _, class_sel, class_tol = _feasibility_classes(snap)
    built = device_node_operands(planes, snap.n_nodes, class_sel, class_tol)
    for name, arr in built.items():
        got = arr.cpu()
        want = torch.from_numpy(np.ascontiguousarray(host[name]))
        if got.dtype == torch.float32:
            got, want = got.view(torch.int32), want.view(torch.int32)
        if got.shape != want.shape or not torch.equal(got, want):
            bad.append(name)
    return bad


class LoopChecks:
    """The host-only checks of every loop cycle on the card, hooked
    where their inputs live and timed apart so the cycle's numbers can
    leave them out: each warm pack against a cold ``pack_session``
    seeded with copies of the PackCache's registries (a wrapper around
    the cache's ``pack_cache.pack``), and, before each session-kernel
    session, the staged planes against the numpy planes and the
    device-built node operands against the host's (a wrapper around
    ``session_kernel.run_packed_cuda``).  ``gc_clock``'s pauses inside
    the hooks count apart from the cycle's."""

    def __init__(self, gc_clock=None):
        self.gc_clock = gc_clock
        self.failures = []
        self.pack_s = self.kernel_s = 0.0
        self.packs = self.sessions = 0
        self._orig_run = None
        #: the last session's operands both ways, timed apart (ms): the
        #: host reference, prepare_session_arrays (host_prepare_ms), with
        #: the copy of its nine arrays (host_h2d_ms, host_h2d_bytes), and
        #: the session's build from the staged planes (resident_build_ms)
        self.split = {}

    def _gc_check(self):
        return self.gc_clock.check() if self.gc_clock else contextlib.nullcontext()

    def time_split(self, snap) -> None:
        """The operands of ``snap`` from the host reference and from the
        staged planes, each timed on its own with the device
        synchronized around it."""
        import torch

        from volcano_tpu_torch.ops.kernels import _feasibility_classes
        from volcano_tpu_torch.ops.session_kernel import (
            device_node_operands,
            prepare_session_arrays,
        )

        dev = snap.device_planes["node_idle"].device
        snap.__dict__.pop("_feas_classes_cache", None)  # time the classes too
        t0 = time.perf_counter()
        arrays, T_act, _ = prepare_session_arrays(snap)
        host = list(arrays.values()) + [snap.task_job[:T_act].astype(np.int64),
                                        snap.job_min_available.astype(np.int32),
                                        snap.job_ready_count.astype(np.int32)]
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for arr in host:
            torch.from_numpy(arr).to(dev)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        _, class_sel, class_tol = _feasibility_classes(snap)
        device_node_operands(snap.device_planes, snap.n_nodes, class_sel, class_tol)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        self.split = dict(host_prepare_ms=(t1 - t0) * 1e3, host_h2d_ms=(t3 - t2) * 1e3,
                          host_h2d_bytes=sum(a.nbytes for a in host),
                          resident_build_ms=(t4 - t3) * 1e3)

    def hook_cache(self, cache) -> None:
        from volcano_tpu_torch.ops.packing import BitRegistry, pack_session

        pc = cache.pack_cache
        orig = pc.pack

        def copy_reg(reg):
            out = BitRegistry(reg.words)
            out.index, out.overflow = dict(reg.index), reg.overflow
            return out

        def pack(tasks, jobs, nodes, epoch, enforce_pod_count=True):
            snap = orig(tasks, jobs, nodes, epoch, enforce_pod_count=enforce_pod_count)
            t0 = time.perf_counter()
            with self._gc_check():
                cold = pack_session(tasks, jobs, nodes, enforce_pod_count=enforce_pod_count,
                                    label_registry=copy_reg(pc.label_reg),
                                    taint_registry=copy_reg(pc.taint_reg))
                bad = packs_equal(snap, cold)
                del cold
            if bad:
                self.failures.append(f"pack {pc.last_stats.get('mode')} differs: {bad}")
            self.packs += 1
            self.pack_s += time.perf_counter() - t0
            return snap

        pc.pack = pack

    def __enter__(self):
        from volcano_tpu_torch.ops import session_kernel

        self._orig_run = orig = session_kernel.run_packed_cuda

        def run(snap, *args, **kwargs):
            t0 = time.perf_counter()
            if snap.device_planes is None:
                self.failures.append("a session reached the kernel without staged planes")
            else:
                with self._gc_check():
                    bad = operands_equal(snap)
                    self.time_split(snap)
                if bad:
                    self.failures.append(f"device operands differ: {bad}")
                # the checks computed the feasibility classes; the session
                # computes its own, as it would unchecked
                snap.__dict__.pop("_feas_classes_cache", None)
            self.sessions += 1
            self.kernel_s += time.perf_counter() - t0
            return orig(snap, *args, **kwargs)

        session_kernel.run_packed_cuda = run
        return self

    def __exit__(self, *exc):
        from volcano_tpu_torch.ops import session_kernel

        session_kernel.run_packed_cuda = self._orig_run
        return False

    def take(self) -> tuple:
        """(pack check seconds, kernel check seconds) since the last take."""
        out, self.pack_s, self.kernel_s = (self.pack_s, self.kernel_s), 0.0, 0.0
        return out


class GcClock:
    """Time spent in the garbage collector, by generation, from
    ``gc.callbacks``: only pauses inside a ``cycle()`` window count, and
    of those, pauses inside a ``check()`` window (the LoopChecks hooks)
    count apart."""

    def __init__(self):
        self.ms = [0.0, 0.0, 0.0]
        self.counts = [0, 0, 0]
        self.check_ms = 0.0
        self._where = None
        self._t0 = None

    def _cb(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            ms = (time.perf_counter() - self._t0) * 1e3
            if self._where == "cycle":
                gen = info["generation"]
                self.ms[gen] += ms
                self.counts[gen] += 1
            elif self._where == "check":
                self.check_ms += ms
            self._t0 = None

    @contextlib.contextmanager
    def cycle(self):
        """One ``run_once``: the heap collected first (outside the
        window), so the pauses counted are those the cycle's own
        allocations bring on."""
        import gc

        gc.collect()
        self._where = "cycle"
        try:
            yield
        finally:
            self._where = None

    @contextlib.contextmanager
    def check(self):
        """A LoopChecks hook inside the cycle."""
        where, self._where = self._where, "check" if self._where else None
        try:
            yield
        finally:
            self._where = where

    def __enter__(self):
        import gc

        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self._cb)
        return False

    def take(self) -> dict:
        """{gc_ms, gc_gen2_ms, gc_gen2, gc_check_ms} since the last take."""
        out = dict(gc_ms=sum(self.ms), gc_gen2_ms=self.ms[2], gc_gen2=self.counts[2],
                   gc_check_ms=self.check_ms)
        self.ms, self.counts, self.check_ms = [0.0, 0.0, 0.0], [0, 0, 0], 0.0
        return out


def phase_loop(name: str, card: str) -> dict:
    """A loop cell on the card: ``Scheduler.run_once`` cycle after cycle
    on one cache with snapshot reuse (``loop_cycles``).  Every cycle: the
    session kernel launched (counts set to 0 before run_once, read
    after; executor ``cuda``), no kernel failure, the binds' digest the
    JAX package's (the cycle config's for the revert cell, LOOP_DIGESTS'
    for the churn cell, PREEMPT_CYCLE_DIGESTS' of (evictions, pipelined)
    for the preempt cell, whose cycle launches the preempt kernel once),
    and LoopChecks clean.  Revert cell: every cycle after the first packs
    warm and reuses every task row.  Churn cell: from the second cycle
    after the first on, some task rows reused and fewer than all nodes
    repacked.  The collector's pauses are counted inside each
    ``run_once`` only, after a ``gc.collect()``, and those inside the
    checks' hooks apart (``GcClock``).  One ``{"loop": ...}`` line, a
    record a cycle, and the phase's own wall time (``phase_ms``)."""
    import torch

    from volcano_tpu_torch.framework import get_action
    from volcano_tpu_torch.ops import preempt_kernel, session_kernel
    from volcano_tpu_torch.ops.executor import last_allocate_executor

    spec = LOOP_CELLS[name]
    t_phase = t0 = time.perf_counter()
    objects = loop_objects(spec["config"])
    build_s = time.perf_counter() - t0
    n_pods, n_nodes = len(objects[1]), len(objects[0])
    cycles = []
    with GcClock() as gc_clock, LoopChecks(gc_clock) as checks:
        loop = loop_cycles(objects, spec["tiers"], spec["actions"],
                           spec.get("card_cycles", spec["cycles"]),
                           spec["between"], cache_hook=checks.hook_cache,
                           cycle_window=gc_clock.cycle)
        while True:
            failures = kernel_failures()
            torch.cuda.synchronize()
            session_kernel.LAUNCHES = session_kernel.WIDE_LAUNCHES = 0
            preempt_kernel.LAUNCHES = 0
            gc_clock.take()
            rec = next(loop, None)
            if rec is None:
                break
            launches = session_kernel.LAUNCHES + session_kernel.WIDE_LAUNCHES
            preempt_launches = preempt_kernel.LAUNCHES
            k, ph = rec["cycle"], rec["phases"]
            what = f"{name} cycle {k}"
            check_pack_s, check_kernel_s = checks.take()
            check(not checks.failures, f"{what}: {checks.failures}")
            check(last_allocate_executor() == "cuda",
                  f"{what}: executor {last_allocate_executor()!r}, expected 'cuda'")
            check(launches > 0, f"{what}: the session kernel was not launched")
            check(kernel_failures() == failures, f"{what}: kernel failures counted")
            if spec["between"] == "revert":
                digest = cycle_digest(rec["binds"])
                want = CYCLE_DIGESTS[spec["config"]]
                check(len(rec["binds"]) == n_pods, f"{what}: {len(rec['binds'])} binds")
                if k:
                    check(ph.get("mode") == "warm" and ph.get("reused_tasks") == n_pods
                          and "cold_cause" not in ph,
                          f"{what}: pack {ph.get('mode')}, {ph.get('reused_tasks')} rows "
                          f"reused, cold cause {ph.get('cold_cause')}")
            elif spec["between"] == "churn":
                digest = cycle_digest(rec["binds"])
                want = LOOP_DIGESTS[name][k]
                if k >= 2:
                    check(ph.get("reused_tasks", 0) > 0 and ph.get("repacked_nodes", n_nodes)
                          < n_nodes, f"{what}: {ph.get('reused_tasks')} rows reused, "
                          f"{ph.get('repacked_nodes')} nodes repacked")
            else:
                digest = preempt_cycle_digest(rec["evicted"], rec["pipelined"])
                want = PREEMPT_CYCLE_DIGESTS[spec["config"]]
                preempt = get_action("gpu-preempt")
                check(preempt.last_executor == "cuda" and preempt_launches == 1,
                      f"{what}: preempt executor {preempt.last_executor!r}, "
                      f"{preempt_launches} launches")
            check(digest == want, f"{what}: digest {digest} != the JAX package's {want}")
            actions_s = dict(rec["actions_s"])
            actions_s["gpu-allocate"] -= check_pack_s + check_kernel_s
            cycles.append(dict(
                cycle=k, binds=len(rec["binds"]), evicted=len(rec["evicted"]),
                pipelined=len(rec["pipelined"]), launches=launches,
                preempt_launches=preempt_launches,
                run_once_ms=(rec["e2e_s"] - check_pack_s - check_kernel_s) * 1e3,
                open_ms=rec["open_s"] * 1e3, close_ms=rec["close_s"] * 1e3,
                execute_ms={a: v * 1e3 for a, v in actions_s.items()},
                events_ms=rec["feed_s"] * 1e3,
                pool_nodes=rec["pool_nodes"], pool_jobs=rec["pool_jobs"],
                check_pack_ms=check_pack_s * 1e3, check_kernel_ms=check_kernel_s * 1e3,
                **checks.split, **gc_clock.take(),
                **{key: ph.get(key) for key in (
                    "order_ms", "node_prepack_ms", "relay_overlap_ms", "stage_ms",
                    "stage_bytes", "prepare_ms", "h2d_bytes", "apply_ms", "commit_ms",
                    "mode", "cold_cause", "reused_tasks", "repacked_nodes")},
                pack_ms=ph.get("pack_ms", 0.0) - check_pack_s * 1e3,
                device_ms=ph.get("execute_ms", 0.0) - check_kernel_s * 1e3))
    check(checks.packs == checks.sessions == len(cycles),
          f"{name}: {checks.packs} packs and {checks.sessions} sessions checked "
          f"over {len(cycles)} cycles")
    out = dict(cell=name, config=spec["config"], pods=n_pods, nodes=n_nodes,
               build_objects_ms=build_s * 1e3, phase_ms=(time.perf_counter() - t_phase) * 1e3,
               card=card, cycles=cycles)
    print(f"{name}: {len(cycles)} cycles of Scheduler.run_once on one cache, each with the "
          f"JAX package's digest, executor cuda, node operands from the resident planes "
          f"equal to the host's; run_once ms "
          f"{[round(c['run_once_ms'], 3) for c in cycles]}, pack ms "
          f"{[round(c['pack_ms'], 3) for c in cycles]} ({[c['mode'] for c in cycles]}), "
          f"h2d bytes {[c['h2d_bytes'] for c in cycles]}; card {card}")
    print(json.dumps({"loop": out}))
    return out


def pack_routes(card: str, name: str = MAIN_CONFIG, reps: int = 5) -> dict:
    """The two cold packs of a fresh cache's first gpu-allocate session
    of a cycle config, on one host: ``pack_session`` (a cache without
    change tracking) and a first ``PackCache.pack`` (a SchedulerCache's,
    whose every snapshot carries a PackEpoch).  In turns, ``reps`` times
    each, on one session, each after a ``gc.collect()``, with the
    collector's pauses inside it (``gc_ms``) and, for the PackCache's,
    the ``pack_session`` call it makes (``inner_ms``); freeing a pack's
    result is timed apart (``free_ms``).  Host work only; not part of
    the smoke run.  One ``{"pack_routes": ...}`` line."""
    import volcano_tpu_torch.actions  # noqa: F401 — registers the actions
    import volcano_tpu_torch.plugins  # noqa: F401 — registers the plugins
    from volcano_tpu_torch.actions.gpu_allocate import compute_task_order
    from volcano_tpu_torch.cache import SchedulerCache
    from volcano_tpu_torch.conf import PluginOption, Tier
    from volcano_tpu_torch.framework import close_session, open_session
    from volcano_tpu_torch.ops import pack_cache
    from volcano_tpu_torch.ops.packing import pack_session
    from volcano_tpu_torch.ops.synthetic import BASELINE_CONFIGS, generate_cluster_objects

    nodes, pods, pod_groups, queues = generate_cluster_objects(**BASELINE_CONFIGS[name])
    cache = SchedulerCache(binder=ListBinder())
    for add, objs in ((cache.add_node, nodes), (cache.add_pod, pods),
                      (cache.add_pod_group, pod_groups), (cache.add_queue, queues)):
        for obj in objs:
            add(obj)
    ssn = open_session(cache, [Tier(plugins=[PluginOption(name=n) for n in tier])
                               for tier in CYCLE_TIERS], [])
    ordered = compute_task_order(ssn)
    nodes = [ssn.nodes[k] for k in sorted(ssn.nodes)]
    jobs = list({t.job: ssn.jobs[t.job] for t in ordered}.values())
    inner = []

    def timed_pack_session(*args, **kwargs):
        t0 = time.perf_counter()
        out = pack_session(*args, **kwargs)
        inner.append((time.perf_counter() - t0) * 1e3)
        return out

    def cold():
        pc = pack_cache.PackCache(cache)
        return pc, pc.pack(ordered, jobs, nodes, ssn.pack_epoch, enforce_pod_count=True)

    routes = {"pack_session": lambda: pack_session(ordered, jobs, nodes, enforce_pod_count=True),
              "pack_cache_cold": cold}
    ms, gc_ms, free_ms = ({r: [] for r in routes} for _ in range(3))
    pack_cache.pack_session = timed_pack_session
    try:
        with GcClock() as clock:
            for i in range(reps):
                for route in (list(routes) if i % 2 == 0 else list(routes)[::-1]):
                    with clock.cycle():
                        t0 = time.perf_counter()
                        result = routes[route]()
                        t1 = time.perf_counter()
                        del result
                        t2 = time.perf_counter()
                    ms[route].append((t1 - t0) * 1e3)
                    free_ms[route].append((t2 - t1) * 1e3)
                    gc_ms[route].append(clock.take()["gc_ms"])
    finally:
        pack_cache.pack_session = pack_session
    close_session(ssn)
    out = dict(config=name, tasks=len(ordered), nodes=len(nodes), reps=reps, card=card,
               ms=ms, gc_ms=gc_ms, free_ms=free_ms, inner_ms=inner,
               median_ms={r: statistics.median(v) for r, v in ms.items()})
    print(json.dumps({"pack_routes": out}))
    return out


# ---- the event-driven loop (phase_micro) ----


def micro_window(scheduler, register_fallback) -> Optional[str]:
    """One wake of the event-driven loop after a window's events went
    through the cache's handlers, routed as ``run_cycle_window`` routes
    it, without its clock: a pending full cause (a gang arrived, the node
    set changed) runs a full cycle, counted by ``register_fallback(cause)``;
    else the drained triggers run one micro-cycle labelled by them, unless
    no "task" trigger came and nothing is pending.  Returns "full", the
    micro-cycle's trigger, or None when no session opened.  It drives the
    JAX package's Scheduler the same way (its metrics' counter given)."""
    cause = scheduler._take_full_cause()
    if cause is not None:
        register_fallback(cause)
        scheduler._drain_triggers()
        scheduler.run_once()
        return "full"
    pending = scheduler._drain_triggers()
    if not pending or ("task" not in pending and not scheduler._has_pending_work()):
        return None
    trigger = scheduler._trigger_label(pending)
    scheduler.run_once(trigger=trigger)
    return trigger


class LedgerClock:
    """Calls and seconds inside one cache's ``share_ledger.observe`` (the
    diff every job mutation pays under the mutex), its timer's own cost
    included."""

    def __init__(self):
        self.calls = 0
        self.s = 0.0

    def hook(self, cache) -> None:
        orig = cache.share_ledger.observe

        def observe(job, uid):
            t0 = time.perf_counter()
            try:
                return orig(job, uid)
            finally:
                self.s += time.perf_counter() - t0
                self.calls += 1

        cache.share_ledger.observe = observe

    def take(self) -> dict:
        out = dict(ledger_ms=self.s * 1e3, ledger_observes=self.calls)
        self.calls, self.s = 0, 0.0
        return out


def micro_windows(objects, tiers, actions, windows: int, jobs: int, cache_hook=None,
                  cycle_window=contextlib.nullcontext, **options):
    """The port's event-driven loop on one cache, window by window: feed
    ``objects`` (``loop_cache``), then ``Scheduler(cache,
    scheduler_conf_path=..., micro_cycles=True, **options)``; window 0
    is ``run_once()``, a full cycle, and each window after it feeds
    ``generate_micro_events`` (seed 0, the last window's binds echoed)
    through ``cache.feed_events`` and routes the wake (``micro_window``).
    Yields one record a window: its route, binds, the events' seconds,
    every snapshot the cache took (scope, jobs cloned, jobs in the
    session), and for a window that opened a session gpu-allocate's
    phases and ``Scheduler.last_cycle``; ``scheduler`` and ``cache``
    ride along.  ``cache_hook(cache)`` runs once after the feed, and each
    window's cycle inside ``cycle_window()``."""
    from volcano_tpu_torch import metrics
    from volcano_tpu_torch.cache import feed_events
    from volcano_tpu_torch.framework import get_action
    from volcano_tpu_torch.ops.synthetic import generate_micro_events, loop_world
    from volcano_tpu_torch.scheduler.scheduler import Scheduler

    cache, feed_s = loop_cache(objects)
    world = loop_world(objects[:4])
    snapshots = []
    take = cache.snapshot

    def snapshot(scope="full"):
        snap = take(scope)
        snapshots.append(dict(scope=scope, jobs=len(snap.jobs), session_jobs=len(
            getattr(snap, "restricted_uids", snap.jobs))))
        return snap

    cache.snapshot = snapshot
    if cache_hook is not None:
        cache_hook(cache)
    with policy_file(tiers, actions) as path:
        scheduler = Scheduler(cache, scheduler_conf_path=path, micro_cycles=True, **options)
        binds = []
        for w in range(windows + 1):
            if w:
                t0 = time.perf_counter()
                feed_events(cache, generate_micro_events(world, w, seed=0, binds=binds,
                                                         jobs=jobs))
                feed_s = time.perf_counter() - t0
            n = len(cache.binder.binds)
            snapshots.clear()
            with cycle_window():
                if w:
                    route = micro_window(scheduler, metrics.register_full_cycle_fallback)
                else:
                    scheduler.run_once()
                    route = "full"
            binds = cache.binder.binds[n:]
            rec = dict(window=w, route=route, binds=binds, feed_s=feed_s,
                       snapshots=list(snapshots), scheduler=scheduler, cache=cache)
            if route is not None:
                rec.update(phases=dict(get_action("gpu-allocate").last_phase_stats),
                           **scheduler.last_cycle)
            yield rec


def stager_state() -> dict:
    """Every device stager's plane revisions, by registry key: what a
    shadow session must leave as it found."""
    from volcano_tpu_torch.ops import device_stage

    return {key: dict(st.plane_rev) for key, st in device_stage._stagers.items()}


class ShadowTally:
    """Around ``incremental.subgraph.run_shadow_session`` (what the
    scheduler calls for a shadow cross-check): its seconds, the session
    kernel's launches inside it, the executor each shadow session ran on,
    and whether any device stager's planes moved during it, since the
    last take."""

    def __init__(self):
        self.ms, self.launches, self.executors, self.stager_moved = 0.0, 0, [], False
        self._orig = None

    def __enter__(self):
        from volcano_tpu_torch.incremental import subgraph
        from volcano_tpu_torch.ops import session_kernel
        from volcano_tpu_torch.ops.executor import last_allocate_executor

        self._orig = orig = subgraph.run_shadow_session

        def run(*args, **kwargs):
            launches = session_kernel.LAUNCHES + session_kernel.WIDE_LAUNCHES
            stagers = stager_state()
            t0 = time.perf_counter()
            try:
                return orig(*args, **kwargs)
            finally:
                self.ms += (time.perf_counter() - t0) * 1e3
                self.launches += (session_kernel.LAUNCHES + session_kernel.WIDE_LAUNCHES
                                  - launches)
                self.executors.append(last_allocate_executor())
                self.stager_moved |= stager_state() != stagers

        subgraph.run_shadow_session = run
        return self

    def __exit__(self, *exc):
        from volcano_tpu_torch.incremental import subgraph

        subgraph.run_shadow_session = self._orig
        return False

    def take(self) -> dict:
        out = dict(shadow_ms=self.ms, shadow_launches=self.launches,
                   shadow_executors=self.executors, shadow_stager_moved=self.stager_moved)
        self.ms, self.launches, self.executors, self.stager_moved = 0.0, 0, [], False
        return out


def phase_micro_cell(name: str, card: str) -> dict:
    """A micro cell on the card, in each of its MICRO_CARD_CELLS modes on
    a fresh cache (``micro_windows``).  Every window: the binds' digest
    MICRO_DIGESTS'
    (window 0 binding every pod), no kernel failure; every window but
    the gang's opens a micro-cycle, the gang's window a full cycle
    counted under ``cause="gang-arrival"`` (by ``micro_window``, the
    loop's routing copied without its clock); every session on executor
    ``cuda`` with session-kernel launches (counts set to 0 before each
    window, read after); in the restricted mode every micro-cycle opens a
    restricted snapshot ("restricted", or "shadow" when cross-checked,
    the shadow session on ``cuda`` with launches of its own and every
    device stager's planes as it found them), and no shadow divergence.
    The collector's pauses are counted inside each window's cycle
    (``GcClock``), and the share ledger's observe time (``LedgerClock``).
    One ``{"micro": ...}`` line."""
    import torch

    from volcano_tpu_torch import metrics
    from volcano_tpu_torch.ops import session_kernel
    from volcano_tpu_torch.ops.executor import last_allocate_executor
    from volcano_tpu_torch.ops.synthetic import MICRO_GANG_WINDOW

    spec = MICRO_CELLS[name]
    t_phase = time.perf_counter()
    modes = {}
    for mode in MICRO_CARD_CELLS[name]:
        options = MICRO_MODES[mode]
        t0 = time.perf_counter()
        objects = loop_objects(spec["config"])
        build_s = time.perf_counter() - t0
        n_pods = len(objects[1])
        ledger = LedgerClock()
        windows = []
        with GcClock() as gc_clock, ShadowTally() as shadow:
            it = micro_windows(objects, CYCLE_TIERS, ("gpu-allocate",), spec["windows"],
                               spec["jobs"], cache_hook=ledger.hook,
                               cycle_window=gc_clock.cycle, **options)
            while True:
                failures = kernel_failures()
                gang = metrics.registry.counter("volcano_full_cycle_fallbacks_total",
                                                cause="gang-arrival")
                torch.cuda.synchronize()
                session_kernel.LAUNCHES = session_kernel.WIDE_LAUNCHES = 0
                gc_clock.take()
                ledger.take()
                shadow.take()
                rec = next(it, None)
                if rec is None:
                    break
                launches = session_kernel.LAUNCHES + session_kernel.WIDE_LAUNCHES
                w, route, scheduler = rec["window"], rec["route"], rec["scheduler"]
                what = f"{name} {mode} window {w}"
                digest = cycle_digest(rec["binds"])
                check(digest == MICRO_DIGESTS[name][w],
                      f"{what}: digest {digest} != the JAX package's {MICRO_DIGESTS[name][w]}")
                check(kernel_failures() == failures, f"{what}: kernel failures counted")
                if w == 0:
                    check(len(rec["binds"]) == n_pods, f"{what}: {len(rec['binds'])} binds")
                gang_counted = metrics.registry.counter(
                    "volcano_full_cycle_fallbacks_total", cause="gang-arrival") - gang
                if w == MICRO_GANG_WINDOW:
                    check(route == "full" and gang_counted == 1,
                          f"{what}: the gang's window routed {route!r}, "
                          f"{gang_counted} gang-arrival fallbacks counted")
                elif w:
                    check(route not in (None, "full") and gang_counted == 0,
                          f"{what}: routed {route!r}, expected a micro-cycle")
                scopes = [s["scope"] for s in rec["snapshots"]]
                micro = route not in (None, "full")
                want = (("restricted",), ("shadow",)) if micro and options[
                    "restricted_sessions"] else (("full",),)
                check(tuple(scopes) in want, f"{what}: snapshots {scopes}, expected {want}")
                sh = shadow.take()
                check(last_allocate_executor() == "cuda" and launches > 0,
                      f"{what}: executor {last_allocate_executor()!r}, {launches} launches")
                if scopes == ["shadow"]:
                    check(sh["shadow_executors"] == ["cuda"] and sh["shadow_launches"] > 0
                          and not sh["shadow_stager_moved"],
                          f"{what}: shadow session on {sh['shadow_executors']}, "
                          f"{sh['shadow_launches']} launches, the live stager's planes "
                          f"moved: {sh['shadow_stager_moved']}")
                check(scheduler.shadow_divergences == 0, f"{what}: shadow divergence")
                ph = rec["phases"]
                snap = rec["snapshots"][0]
                windows.append(dict(
                    window=w, route=route, scope=scopes[0], snapshot_jobs=snap["jobs"],
                    session_jobs=snap["session_jobs"], binds=len(rec["binds"]),
                    launches=launches, run_once_ms=rec["e2e_s"] * 1e3,
                    open_ms=rec["open_s"] * 1e3, close_ms=rec["close_s"] * 1e3,
                    events_ms=rec["feed_s"] * 1e3,
                    pack_route=ph.get("mode", "pack_session"),
                    device_ms=ph.get("execute_ms"),
                    **{key: ph.get(key) for key in (
                        "order_ms", "pack_ms", "stage_bytes", "prepare_ms", "h2d_bytes",
                        "apply_ms", "commit_ms", "cold_cause")},
                    **sh, **ledger.take(), **gc_clock.take()))
        check(scheduler.restricted_cycles_run == (
            spec["windows"] - 1 if options["restricted_sessions"] else 0),
            f"{name} {mode}: {scheduler.restricted_cycles_run} restricted cycles")
        modes[mode] = dict(
            build_objects_ms=build_s * 1e3, micro_cycles_run=scheduler.micro_cycles_run,
            full_cycles_run=scheduler.full_cycles_run,
            restricted_cycles_run=scheduler.restricted_cycles_run,
            shadow_checks_run=scheduler.shadow_checks_run,
            shadow_divergences=scheduler.shadow_divergences, windows=windows)
        print(f"{name} {mode}: {len(windows)} windows, each with the JAX package's digest, "
              f"executor cuda; routes {[x['route'] for x in windows]}, scopes "
              f"{[x['scope'] for x in windows]}, run_once ms "
              f"{[round(x['run_once_ms'], 3) for x in windows]}, open ms "
              f"{[round(x['open_ms'], 3) for x in windows]}, pack ms "
              f"{[round(x['pack_ms'] or 0.0, 3) for x in windows]} "
              f"({[x['pack_route'] for x in windows]}), launches "
              f"{[x['launches'] for x in windows]}; card {card}")
    out = dict(cell=name, config=spec["config"], jobs=spec["jobs"], card=card,
               phase_ms=(time.perf_counter() - t_phase) * 1e3, modes=modes)
    print(json.dumps({"micro": out}))
    return out


class StampBinder(ListBinder):
    """A ``ListBinder`` that also stamps each bind's ``time.monotonic()``
    by ``ns/name``."""

    def __init__(self):
        super().__init__()
        self.at = {}

    def bind(self, task, hostname):
        super().bind(task, hostname)
        self.at[f"{task.namespace}/{task.name}"] = time.monotonic()


def stream_jobs(n: int, seed: int = 0) -> list:
    """``n`` single-pod jobs, each (PodGroup with minMember 1, its pod),
    made by the micro cells' job generator, as the port's API objects."""
    from volcano_tpu_torch.apis import core, scheduling
    from volcano_tpu_torch.ops.synthetic import micro_job

    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        pg, (pod,) = micro_job(f"stream-{i:05d}", float(i), 1, 1, rng)
        out.append((scheduling.PodGroup.from_dict(pg), core.Pod.from_dict(pod)))
    return out


def phase_micro_stream(card: str) -> dict:
    """The stream cell on the card: MICRO_STREAM's cluster on a fresh
    cache, window 0 (``run_once``, every pod bound with MICRO_A's window-0
    digest), then ``Scheduler.run()`` in a thread while a feeder thread
    submits ``rate`` single-pod jobs a second for ``seconds``, once the
    loop's first window has run its full cycle.  Every streamed pod must
    bind within ``drain_s`` after the last submit, exactly once, with the
    session kernel launched, executor ``cuda``, no kernel failure and no
    shadow divergence; the loop is stopped and joined.  Prints submit →
    bind p50, p99 and max (the binder's stamps), the cycles by kind, the
    median restricted open and the windows that ran a micro-cycle; one
    ``{"micro": ...}`` line."""
    import threading

    import torch

    from volcano_tpu_torch.ops import session_kernel
    from volcano_tpu_torch.ops.executor import last_allocate_executor
    from volcano_tpu_torch.scheduler.scheduler import Scheduler

    spec = MICRO_STREAM
    t_phase = time.perf_counter()
    cache, _ = loop_cache(loop_objects(spec["config"]), binder=StampBinder())
    jobs = stream_jobs(int(spec["rate"] * spec["seconds"]))
    names = {f"{pod.metadata.namespace}/{pod.metadata.name}" for _, pod in jobs}
    failures = kernel_failures()
    with policy_file(CYCLE_TIERS, ("gpu-allocate",)) as path:
        scheduler = Scheduler(cache, scheduler_conf_path=path, period=spec["period"],
                              micro_cycles=True, micro_debounce_ms=spec["debounce_ms"],
                              restricted_sessions=True, shadow_every=spec["shadow_every"])
        scheduler.run_once()
        digest = cycle_digest(cache.binder.binds)
        check(digest == MICRO_DIGESTS[MICRO_A][0], f"{MICRO_S}: window 0 digest {digest}")
        n0 = len(cache.binder.binds)
        windows = []
        run_window = scheduler.run_cycle_window

        def counted(max_cycles=None):
            ran = run_window(max_cycles)
            windows.append(ran)
            return ran

        scheduler.run_cycle_window = counted
        errors = []

        def guarded(fn):
            def run():
                try:
                    fn()
                except BaseException as e:  # noqa: BLE001 — reported by the main thread
                    errors.append(e)
            return run

        submitted = {}

        def feed():
            t0 = time.monotonic()
            for i, (pg, pod) in enumerate(jobs):
                delay = t0 + i / spec["rate"] - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                submitted[f"{pod.metadata.namespace}/{pod.metadata.name}"] = time.monotonic()
                cache.add_pod_group(pg)
                cache.add_pod(pod)

        torch.cuda.synchronize()
        session_kernel.LAUNCHES = session_kernel.WIDE_LAUNCHES = 0
        loop = threading.Thread(target=guarded(scheduler.run), name="micro-stream-loop",
                                daemon=True)
        feeder = threading.Thread(target=guarded(feed), name="micro-stream-feeder", daemon=True)
        loop.start()
        try:
            deadline = time.monotonic() + 120
            while scheduler.full_cycles_run < 2 and not errors and time.monotonic() < deadline:
                time.sleep(0.01)
            check(scheduler.full_cycles_run >= 2 and not errors,
                  f"{MICRO_S}: the loop's first full cycle did not run: {errors}")
            t_feed = time.monotonic()
            feeder.start()
            feeder.join(timeout=spec["seconds"] + 60)
            check(not feeder.is_alive() and not errors, f"{MICRO_S}: feeder: {errors}")
            feed_s = time.monotonic() - t_feed
            deadline = time.monotonic() + spec["drain_s"]
            while (not errors and time.monotonic() < deadline
                   and not names <= cache.binder.at.keys()):
                time.sleep(0.01)
            drained_s = time.monotonic() - t_feed - feed_s
        finally:
            scheduler.stop()
            loop.join(timeout=120)
        check(not loop.is_alive(), f"{MICRO_S}: Scheduler.run did not stop")
        check(not errors, f"{MICRO_S}: {errors}")
    launches = session_kernel.LAUNCHES + session_kernel.WIDE_LAUNCHES
    stream_binds = cache.binder.binds[n0:]
    missing = names - cache.binder.at.keys()
    check(not missing, f"{MICRO_S}: {len(missing)} of {len(names)} pods unbound after "
                       f"{spec['drain_s']} s")
    check(len(stream_binds) == len(names) and {b[0] for b in stream_binds} == names,
          f"{MICRO_S}: {len(stream_binds)} binds for {len(names)} pods")
    check(launches > 0 and last_allocate_executor() == "cuda",
          f"{MICRO_S}: {launches} launches, executor {last_allocate_executor()!r}")
    check(kernel_failures() == failures, f"{MICRO_S}: kernel failures counted")
    check(scheduler.shadow_divergences == 0, f"{MICRO_S}: shadow divergence")
    lat = np.array([cache.binder.at[n] - submitted[n] for n in sorted(names)]) * 1e3
    samples = scheduler.restricted_open_samples
    out = dict(
        cell=MICRO_S, config=spec["config"], card=card, pods=len(names), rate=spec["rate"],
        period_s=spec["period"], feed_s=feed_s, drain_s=drained_s,
        submit_to_bind_ms=dict(p50=float(np.percentile(lat, 50)),
                               p99=float(np.percentile(lat, 99)), max=float(lat.max())),
        launches=launches, micro_cycles_run=scheduler.micro_cycles_run,
        full_cycles_run=scheduler.full_cycles_run,
        restricted_cycles_run=scheduler.restricted_cycles_run,
        shadow_checks_run=scheduler.shadow_checks_run,
        shadow_divergences=scheduler.shadow_divergences,
        restricted_open_ms_median=statistics.median(samples) * 1e3 if samples else None,
        windows=len(windows), windows_with_micro=sum(1 for n in windows if n > 1),
        phase_ms=(time.perf_counter() - t_phase) * 1e3)
    print(f"{MICRO_S}: {len(names)} pods at {spec['rate']}/s all bound, submit->bind ms p50 "
          f"{out['submit_to_bind_ms']['p50']:.3f} p99 {out['submit_to_bind_ms']['p99']:.3f} "
          f"max {out['submit_to_bind_ms']['max']:.3f}; {scheduler.micro_cycles_run} micro "
          f"({scheduler.restricted_cycles_run} restricted, {scheduler.shadow_checks_run} "
          f"shadow-checked), {scheduler.full_cycles_run} full cycles, "
          f"{out['windows_with_micro']} of {len(windows)} windows ran a micro-cycle; "
          f"card {card}")
    print(json.dumps({"micro": out}))
    return out


def phase_micro(card: str) -> dict:
    """The event-driven loop's cells on the card (MICRO_CARD_CELLS), then
    the stream cell; each phase's record by cell name."""
    recs = {cell: phase_micro_cell(cell, card) for cell in MICRO_CARD_CELLS}
    recs[MICRO_S] = phase_micro_stream(card)
    return recs


# ---- the store: the API server, the scheduler's client and the commit plane ----


class StoreAudit:
    """A watch on an API server's Pods and Events (either package's
    ``APIServer``), registered before the store is seeded: store truth as
    the store's watch delivers it, under the store's lock.  ``bound`` maps
    ``ns/name`` to the node its pod is bound to and ``bound_at`` to the
    ``time.monotonic()`` of the notification that set it; ``rebinds``
    lists every pod whose node changed, ``deleted`` the pods deleted, in
    order; ``events`` counts, by reason, the Events created and the
    updates that aggregated a repeat into one; ``evict_events`` holds the
    ``ns/name`` of every pod with an Evict Event.  The store may be a
    ``RemoteAPIServer``: its notifications come on the client's dispatch
    thread, and ``lock`` orders them against ``binds()``."""

    def __init__(self, api):
        import threading

        self.api = api
        self.lock = threading.Lock()
        self.bound, self.bound_at, self.rebinds, self.deleted = {}, {}, [], []
        self.events, self.evict_events = {}, set()
        api.watch("Pod", self._pod, send_initial=False)
        api.watch("Event", self._event, send_initial=False)

    def _pod(self, event, old, new):
        with self.lock:
            self._pod_locked(event, old, new)

    def _pod_locked(self, event, old, new):
        if event == "DELETED":
            key = f"{old.metadata.namespace}/{old.metadata.name}"
            self.bound.pop(key, None)
            self.deleted.append(key)
            return
        node = new.spec.node_name
        if not node:
            return
        key = f"{new.metadata.namespace}/{new.metadata.name}"
        prev = self.bound.get(key)
        if prev is None:
            self.bound[key] = node
            self.bound_at[key] = time.monotonic()
        elif prev != node:
            self.rebinds.append((key, prev, node))

    def _event(self, event, old, new):
        if new is None:
            return
        with self.lock:
            self.events.setdefault(new.reason, [0, 0])[event == "MODIFIED"] += 1
            if new.reason == "Evict":
                obj = new.involved_object
                self.evict_events.add(f"{obj.get('namespace')}/{obj.get('name')}")

    def binds(self) -> list:
        """The store's (ns/name, node) pairs of bound pods."""
        with self.lock:
            return list(self.bound.items())

    def digest(self) -> str:
        return cycle_digest(self.binds())


def seed_store(api, objects) -> None:
    """Create a cell's objects (nodes, pods, pod groups, queues[, priority
    classes]) in the store, priority classes first, each kind in the
    generator's order.  Each is created from a copy with its own metadata,
    since the store stamps its resource version and, where it is zero, its
    creation timestamp on the object it is given."""
    import copy

    nodes, pods, pod_groups, queues, *rest = objects
    for objs in ((rest[0] if rest else ()), nodes, pods, pod_groups, queues):
        for obj in objs:
            obj = copy.copy(obj)
            obj.metadata = copy.copy(obj.metadata)
            api.create(obj)


def apply_store_events(api, events, classes=None) -> None:
    """``generate_loop_events``' events through the store's API: ``add``
    is ``api.create``, ``update`` ``api.update`` and ``delete``
    ``api.delete``; ``classes`` maps an event's kind to the API type its
    object is built as (the port's where None)."""
    if classes is None:
        from volcano_tpu_torch.apis import core, scheduling

        classes = {"node": core.Node, "pod": core.Pod, "pod_group": scheduling.PodGroup}
    for ev in events:
        cls = classes[ev["kind"]]
        obj = cls.from_dict(ev["object"])
        if ev["op"] == "add":
            api.create(obj)
        elif ev["op"] == "update":
            api.update(obj)
        elif ev["op"] == "delete":
            api.delete(cls.__name__, obj.metadata.namespace, obj.metadata.name)
        else:
            raise ValueError(f"unknown event op {ev['op']!r}")


class FrameTally:
    """The commit frames a client sends: one ``(binds, evicts, events,
    conditions, pod_groups)`` tuple of section sizes a
    ``client.commit_batch`` call, from whichever thread sends it."""

    def __init__(self, client):
        self.frames = []
        orig = client.commit_batch

        def commit_batch(binds=(), evicts=(), events=(), conditions=(), pod_groups=()):
            self.frames.append(tuple(len(x) for x in (binds, evicts, events, conditions,
                                                      pod_groups)))
            return orig(binds=binds, evicts=evicts, events=events, conditions=conditions,
                        pod_groups=pod_groups)

        client.commit_batch = commit_batch

    def take(self) -> dict:
        """The frames since the last take: their count and each
        section's sizes (binds: the coalesce sizes)."""
        frames, self.frames = self.frames, []
        out = dict(frames=len(frames))
        for i, name in enumerate(("binds", "evicts", "events", "conditions", "pod_groups")):
            out[f"frame_{name}"] = [f[i] for f in frames if f[i]]
        return out


def commit_failures() -> float:
    """Every failed commit effect counted in this process."""
    from volcano_tpu_torch import metrics

    return sum(metrics.registry.counters("volcano_commit_failures_total").values())


def store_cycles(objects, tiers, actions, cycles: int, mode: str, between=None,
                 cycle_window=contextlib.nullcontext):
    """The port's scheduler loop against its store: ``seed_store`` into a
    fresh ``APIServer`` (watched by a ``StoreAudit``), a
    ``SchedulerCache(client=SchedulerClient(api), snapshot_reuse=True)``
    in ``STORE_MODES[mode]`` filled by ``cache.run()`` (the informer
    sync), the policy (``tiers``, ``actions``) written to a file, and
    ``Scheduler(cache, scheduler_conf_path=...).run_once()`` ``cycles``
    times.  With ``between="churn"``, before every cycle but the first
    the cache is flushed, the last cycle's binds are read from the store
    into the world (``record_binds``) and ``generate_loop_events``' churn
    goes through the store's API.  Yields one record a cycle, just after
    ``run_once`` (the pipelined commit may still be in flight): the
    store's and each step's seconds, the cycle's ``Scheduler.last_cycle``,
    gpu-allocate's phases, the pipelined pairs, the commit plane's last
    barrier, the bind echoes so far, and ``api``, ``audit``, ``cache``,
    ``frames`` (a ``FrameTally``) and ``scheduler``.  Each ``run_once``
    runs inside ``cycle_window()``.  The caller stops the commit plane
    (``cache.stop_commit_plane()``)."""
    from volcano_tpu_torch.cache import SchedulerCache
    from volcano_tpu_torch.client import APIServer, SchedulerClient
    from volcano_tpu_torch.framework import get_action, register_action
    from volcano_tpu_torch.ops.synthetic import generate_loop_events, loop_world, record_binds
    from volcano_tpu_torch.scheduler.scheduler import Scheduler

    api = APIServer()
    audit = StoreAudit(api)
    t0 = time.perf_counter()
    seed_store(api, objects)
    seed_s = time.perf_counter() - t0
    client = SchedulerClient(api)
    frames = FrameTally(client)
    cache = SchedulerCache(client=client, snapshot_reuse=True, **STORE_MODES[mode])
    echoes = [0]
    update_pod = cache.update_pod

    def counted(old, new):
        echoes[0] += 1
        update_pod(old, new)

    cache.update_pod = counted
    t0 = time.perf_counter()
    cache.run()
    sync_s = time.perf_counter() - t0
    world = loop_world(objects[:4]) if between == "churn" else None
    recorder = RecordPipelined()
    register_action(recorder)
    with policy_file(tiers, tuple(actions) + (recorder.name(),)) as path:
        scheduler = Scheduler(cache, scheduler_conf_path=path)
        before = set()
        for k in range(cycles):
            events_s = 0.0
            if k and between == "churn":
                cache.flush()
                record_binds(world, [b for b in audit.binds() if b[0] not in before])
                t0 = time.perf_counter()
                apply_store_events(api, generate_loop_events(world, k, seed=0))
                events_s = time.perf_counter() - t0
            before = {name for name, _ in audit.binds()}
            with cycle_window():
                scheduler.run_once()
            plane = cache._commit_plane
            yield dict(cycle=k, seed_s=seed_s, sync_s=sync_s, events_s=events_s,
                       pipelined=recorder.pipelined, echoes=echoes[0],
                       barrier=dict(plane.last_barrier) if plane is not None else None,
                       phases=dict(get_action("gpu-allocate").last_phase_stats),
                       api=api, audit=audit, cache=cache, frames=frames,
                       scheduler=scheduler, **scheduler.last_cycle)


def phase_store_cell(name: str, card: str) -> tuple:
    """A store cell on the card, in each of its modes (STORE_MODES) on a
    fresh store (``store_cycles``).  Every cycle that has pending work: the session
    kernel launched (counts set to 0 before run_once, read after; 3 in
    the cycle cell's cycle 0), executor ``cuda``; no kernel failure.  After the cell's
    cycles (the cache flushed): no commit failure, resync entry,
    quarantined task or rebind.  The cycle cell: the store's digest
    STORE_DIGESTS' after cycle 1 (which, every pod bound,
    launches nothing; in the pipelined mode its snapshot's barrier lands
    cycle 0's frames), 50,000 Scheduled Events each of count 1, one bind
    echo a pod, every PodGroup Running, every cache task on its store
    pod's node; the churn cell: every cycle's store digest
    STORE_LOOP_DIGESTS' (flushed after each cycle), the third cycle on
    packing warm with task rows reused; the preempt cell: the
    digest of (pods deleted from the store, pipelined pairs)
    STORE_PREEMPT_DIGESTS', one preempt launch, an Evict Event for every
    deleted pod.  The collector's pauses count inside each run_once only
    (``GcClock``).  One ``{"store": ...}`` line; returns (the record, the
    pipelined mode's ``(api, audit, cache)`` for the stream)."""
    import gc

    import torch

    from volcano_tpu_torch.apis import scheduling
    from volcano_tpu_torch.framework import get_action
    from volcano_tpu_torch.ops import preempt_kernel, session_kernel
    from volcano_tpu_torch.ops.executor import last_allocate_executor

    spec = STORE_CELLS[name]
    t_phase = time.perf_counter()
    modes, handoff = {}, None
    # one set of objects for both modes: the store keeps a clone of each,
    # and the seed a copy of its metadata, so no mode changes them
    objects = loop_objects(spec["config"])
    build_s = time.perf_counter() - t_phase
    n_pods = len(objects[1])
    for mode in spec["modes"]:
        cycles = []
        commit0 = commit_failures()
        with GcClock() as gc_clock:
            n_cycles = spec.get("card_cycles", spec["cycles"])
            it = store_cycles(objects, spec["tiers"], spec["actions"], n_cycles, mode,
                              spec["between"], cycle_window=gc_clock.cycle)
            while True:
                failures = kernel_failures()
                torch.cuda.synchronize()
                session_kernel.LAUNCHES = session_kernel.WIDE_LAUNCHES = 0
                preempt_kernel.LAUNCHES = 0
                gc_clock.take()
                rec = next(it, None)
                if rec is None:
                    break
                launches = session_kernel.LAUNCHES + session_kernel.WIDE_LAUNCHES
                preempt_launches = preempt_kernel.LAUNCHES
                k, ph, cache, audit = rec["cycle"], rec["phases"], rec["cache"], rec["audit"]
                what = f"{name} {mode} cycle {k}"
                gc_ms = gc_clock.take()
                check(kernel_failures() == failures, f"{what}: kernel failures counted")
                if name != STORE_CYCLE or k == 0:
                    check(last_allocate_executor() == "cuda" and launches > 0,
                          f"{what}: executor {last_allocate_executor()!r}, {launches} launches")
                t0 = time.perf_counter()
                if spec["between"] == "churn" or k == n_cycles - 1:
                    cache.flush()
                flush_ms = (time.perf_counter() - t0) * 1e3
                digest = want = None
                if spec["between"] == "churn":
                    digest, want = audit.digest(), STORE_LOOP_DIGESTS[name][k]
                    if k >= 2:
                        check(ph.get("mode") == "warm" and ph.get("reused_tasks", 0) > 0,
                              f"{what}: pack {ph.get('mode')}, {ph.get('reused_tasks')} rows "
                              f"reused")
                elif name == STORE_PREEMPT:
                    digest = preempt_cycle_digest(audit.deleted, rec["pipelined"])
                    want = STORE_PREEMPT_DIGESTS[spec["config"]]
                    preempt = get_action("gpu-preempt")
                    check(preempt.last_executor == "cuda" and preempt_launches == 1,
                          f"{what}: preempt executor {preempt.last_executor!r}, "
                          f"{preempt_launches} launches")
                    check(audit.deleted and audit.evict_events == set(audit.deleted),
                          f"{what}: {len(audit.deleted)} pods deleted, "
                          f"{len(audit.evict_events)} Evict Events")
                elif k == 0:
                    check(launches == 3, f"{what}: {launches} launches, expected 3")
                else:
                    # every pod is bound: the cycle has nothing to pack
                    check(launches == 0, f"{what}: {launches} launches with nothing pending")
                    digest, want = audit.digest(), STORE_DIGESTS[spec["config"]]
                if want is not None:
                    check(digest == want, f"{what}: store digest {digest} != the JAX "
                                          f"package's {want}")
                barrier = rec["barrier"] or {}
                cycles.append(dict(
                    cycle=k, launches=launches, preempt_launches=preempt_launches,
                    run_once_ms=rec["e2e_s"] * 1e3, open_ms=rec["open_s"] * 1e3,
                    close_ms=rec["close_s"] * 1e3,
                    execute_ms={a: v * 1e3 for a, v in rec["actions_s"].items()},
                    events_ms=rec["events_s"] * 1e3, flush_ms=flush_ms,
                    barrier_ms=barrier.get("wait_ms"), barrier_busy_ms=barrier.get("busy_ms"),
                    overlap_ratio=barrier.get("overlap_ratio"), echoes=rec["echoes"],
                    binds_in_store=len(audit.bound), device_ms=ph.get("execute_ms"),
                    **rec["frames"].take(), **gc_ms,
                    **{key: ph.get(key) for key in (
                        "order_ms", "pack_ms", "apply_ms", "commit_ms", "mode", "cold_cause")}))
                last = rec
        cache, audit, api = last["cache"], last["audit"], last["api"]
        what = f"{name} {mode}"
        check(commit_failures() == commit0 and not cache.err_tasks
              and not cache.quarantined_tasks and not audit.rebinds,
              f"{what}: {commit_failures() - commit0:.0f} commit failures, "
              f"{len(cache.err_tasks)} resync entries, {len(cache.quarantined_tasks)} "
              f"quarantined, {len(audit.rebinds)} rebinds")
        if name == STORE_CYCLE:
            scheduled = audit.events.get("Scheduled", [0, 0])
            check(scheduled == [n_pods, 0], f"{what}: Scheduled Events created, aggregated: "
                                            f"{scheduled}, expected [{n_pods}, 0]")
            phases = {pg.status.phase for pg in api.list("PodGroup")}
            check(phases == {scheduling.POD_GROUP_RUNNING}, f"{what}: PodGroup phases {phases}")
            with api.locked():
                off = [t.uid for job in cache.jobs.values() for t in job.tasks.values()
                       if audit.bound.get(f"{t.namespace}/{t.name}", "") != t.node_name]
            check(not off, f"{what}: {len(off)} cache tasks off their store pod's node")
            check(last["echoes"] == n_pods, f"{what}: {last['echoes']} bind echoes")
        modes[mode] = dict(seed_ms=last["seed_s"] * 1e3,
                           sync_ms=last["sync_s"] * 1e3, events=dict(audit.events),
                           deleted=len(audit.deleted), cycles=cycles)
        if name == STORE_CYCLE and mode == "pipelined":
            handoff = (api, audit, cache)
        else:
            cache.stop_commit_plane()
        del it, last, rec, cache, audit, api
        gc.collect()
        print(f"{name} {mode}: {len(cycles)} cycles through the store, seed "
              f"{modes[mode]['seed_ms']:.3f} ms, informer sync {modes[mode]['sync_ms']:.3f} ms; "
              f"run_once ms {[round(c['run_once_ms'], 3) for c in cycles]}, close ms "
              f"{[round(c['close_ms'], 3) for c in cycles]}, commit ms "
              f"{[round(c['commit_ms'] or 0.0, 3) for c in cycles]}, barrier ms "
              f"{[c['barrier_ms'] and round(c['barrier_ms'], 3) for c in cycles]}, frames "
              f"{[c['frames'] for c in cycles]}, gc ms {[round(c['gc_ms'], 3) for c in cycles]}; "
              f"card {card}")
    out = dict(cell=name, config=spec["config"], card=card, build_objects_ms=build_s * 1e3,
               phase_ms=(time.perf_counter() - t_phase) * 1e3, modes=modes)
    print(json.dumps({"store": out}))
    return out, handoff


def phase_store_stream(card: str, api, audit, cache) -> dict:
    """The store stream on the card: the pipelined cycle cell's store and
    cache after its cycles, ``Scheduler.run()`` in a thread with
    MICRO_STREAM's settings (micro-cycles, restricted sessions, shadow
    sampling, debounce, period) while a feeder thread creates ``rate``
    single-pod jobs a second for ``seconds`` through ``api.create``
    (PodGroup, then Pod), each with a zero creation timestamp, so the
    store stamps the wall clock.  Every pod must bind within ``drain_s``
    after the last submit, once, with the session kernel launched,
    executor ``cuda``, no kernel or commit failure, no resync entry and
    no shadow divergence; the loop is stopped and joined and the commit
    plane stopped.  Submit → bind is read at store truth (the
    ``StoreAudit`` stamps the notification that set ``nodeName``) and
    from the ``volcano_submit_to_bind_latency_milliseconds`` observations
    (the store's creation stamp → the bind landed); p50, p99 and max of
    both are printed with the cycles by kind; one ``{"store": ...}``
    line."""
    import threading

    import torch

    from volcano_tpu_torch import metrics
    from volcano_tpu_torch.ops import session_kernel
    from volcano_tpu_torch.ops.executor import last_allocate_executor
    from volcano_tpu_torch.scheduler.scheduler import Scheduler

    spec = MICRO_STREAM
    t_phase = time.perf_counter()
    jobs = stream_jobs(int(spec["rate"] * spec["seconds"]))
    for pg, pod in jobs:
        pg.metadata.creation_timestamp = pod.metadata.creation_timestamp = 0.0
    names = {f"{pod.metadata.namespace}/{pod.metadata.name}" for _, pod in jobs}
    failures, commit0 = kernel_failures(), commit_failures()
    observed = []
    observe = metrics.observe_submit_to_bind

    def observe_and_keep(seconds):
        observed.append(seconds * 1e3)
        observe(seconds)

    metrics.observe_submit_to_bind = observe_and_keep
    errors, submitted = [], {}

    def guarded(fn):
        def run():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 — reported by the main thread
                errors.append(e)
        return run

    def feed():
        t0 = time.monotonic()
        for i, (pg, pod) in enumerate(jobs):
            delay = t0 + i / spec["rate"] - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            submitted[f"{pod.metadata.namespace}/{pod.metadata.name}"] = time.monotonic()
            api.create(pg)
            api.create(pod)

    def all_bound():
        with api.locked():
            return names <= audit.bound_at.keys()

    try:
        with policy_file(CYCLE_TIERS, ("gpu-allocate",)) as path:
            scheduler = Scheduler(cache, scheduler_conf_path=path, period=spec["period"],
                                  micro_cycles=True, micro_debounce_ms=spec["debounce_ms"],
                                  restricted_sessions=True, shadow_every=spec["shadow_every"])
            torch.cuda.synchronize()
            session_kernel.LAUNCHES = session_kernel.WIDE_LAUNCHES = 0
            loop = threading.Thread(target=guarded(scheduler.run), name="store-stream-loop",
                                    daemon=True)
            feeder = threading.Thread(target=guarded(feed), name="store-stream-feeder",
                                      daemon=True)
            loop.start()
            try:
                deadline = time.monotonic() + 120
                while (scheduler.full_cycles_run < 1 and not errors
                       and time.monotonic() < deadline):
                    time.sleep(0.01)
                check(scheduler.full_cycles_run >= 1 and not errors,
                      f"{STORE_STREAM}: the loop's first full cycle did not run: {errors}")
                t_feed = time.monotonic()
                feeder.start()
                feeder.join(timeout=spec["seconds"] + 60)
                check(not feeder.is_alive() and not errors, f"{STORE_STREAM}: feeder: {errors}")
                feed_s = time.monotonic() - t_feed
                deadline = time.monotonic() + spec["drain_s"]
                while not errors and time.monotonic() < deadline and not all_bound():
                    time.sleep(0.01)
                drained_s = time.monotonic() - t_feed - feed_s
            finally:
                scheduler.stop()
                loop.join(timeout=120)
            check(not loop.is_alive(), f"{STORE_STREAM}: Scheduler.run did not stop")
            check(not errors, f"{STORE_STREAM}: {errors}")
            cache.flush()
    finally:
        metrics.observe_submit_to_bind = observe
        cache.stop_commit_plane()
    launches = session_kernel.LAUNCHES + session_kernel.WIDE_LAUNCHES
    missing = names - audit.bound_at.keys()
    check(not missing, f"{STORE_STREAM}: {len(missing)} of {len(names)} pods unbound after "
                       f"{spec['drain_s']} s")
    check(not audit.rebinds and len(observed) == len(names),
          f"{STORE_STREAM}: {len(audit.rebinds)} rebinds, {len(observed)} submit-to-bind "
          f"observations for {len(names)} pods")
    check(launches > 0 and last_allocate_executor() == "cuda",
          f"{STORE_STREAM}: {launches} launches, executor {last_allocate_executor()!r}")
    check(kernel_failures() == failures, f"{STORE_STREAM}: kernel failures counted")
    check(commit_failures() == commit0 and not cache.err_tasks and not cache.quarantined_tasks,
          f"{STORE_STREAM}: {commit_failures() - commit0:.0f} commit failures, "
          f"{len(cache.err_tasks)} resync entries, {len(cache.quarantined_tasks)} quarantined")
    check(scheduler.shadow_divergences == 0, f"{STORE_STREAM}: shadow divergence")

    def pcts(ms):
        ms = np.asarray(ms)
        return dict(p50=float(np.percentile(ms, 50)), p99=float(np.percentile(ms, 99)),
                    max=float(ms.max()))

    store_ms = pcts([(audit.bound_at[n] - submitted[n]) * 1e3 for n in sorted(names)])
    hist_ms = pcts(observed)
    out = dict(cell=STORE_STREAM, config=spec["config"], card=card, pods=len(names),
               rate=spec["rate"], period_s=spec["period"], feed_s=feed_s, drain_s=drained_s,
               submit_to_bind_ms=store_ms, submit_to_bind_histogram_ms=hist_ms,
               launches=launches, micro_cycles_run=scheduler.micro_cycles_run,
               full_cycles_run=scheduler.full_cycles_run,
               restricted_cycles_run=scheduler.restricted_cycles_run,
               shadow_checks_run=scheduler.shadow_checks_run,
               shadow_divergences=scheduler.shadow_divergences,
               phase_ms=(time.perf_counter() - t_phase) * 1e3)
    print(f"{STORE_STREAM}: {len(names)} pods at {spec['rate']}/s through the store all bound; "
          f"submit->bind ms at store truth p50 {store_ms['p50']:.3f} p99 {store_ms['p99']:.3f} "
          f"max {store_ms['max']:.3f}, by the histogram's observations p50 "
          f"{hist_ms['p50']:.3f} p99 {hist_ms['p99']:.3f} max {hist_ms['max']:.3f}; "
          f"{scheduler.micro_cycles_run} micro ({scheduler.restricted_cycles_run} restricted, "
          f"{scheduler.shadow_checks_run} shadow-checked), {scheduler.full_cycles_run} full "
          f"cycles; card {card}")
    print(json.dumps({"store": out}))
    return out


def phase_store(card: str) -> dict:
    """The store cells: the 50k x 10k cycle in both modes, the stream on
    its pipelined store, then the churn and preempt cells; each record by
    cell name."""
    import gc

    recs = {}
    recs[STORE_CYCLE], handoff = phase_store_cell(STORE_CYCLE, card)
    recs[STORE_STREAM] = phase_store_stream(card, *handoff)
    del handoff
    gc.collect()  # the 50k store, before the next cell's seed is timed
    for name in (STORE_CHURN, STORE_PREEMPT):
        recs[name] = phase_store_cell(name, card)[0]
    return recs


#: the daemon phase (``phase_daemon``): the scheduler binary's daemon in
#: this process on the port's in-process store at full width, then a
#: standby taking over from the crash-stopped leader; and the bus phase
#: (``phase_bus``): the apiserver binary and two scheduler binaries as
#: child processes on the reference's wire.  After the takeover,
#: ARRIVALS["jobs"] single-pod jobs (``arrival_objects``) arrive, their
#: PodGroups naming a queue created after them, so one cycle sees all of
#: them or none
DAEMON_CELL = "daemon_50k_pods_10k_nodes_takeover"
BUS_CELL = "bus_10k_pods_1k_nodes_takeover"
DAEMON_CELLS = {DAEMON_CELL: MAIN_CONFIG, BUS_CELL: SECOND_CONFIG}
ARRIVALS = dict(jobs=1000, seed=13, queue="arrivals")
#: sha256 (``cycle_digest``) of the arrivals' (ns/name, node) pairs at
#: store truth once the standby has bound them, as the JAX package's
#: SchedulerDaemon pair gives them on its store
#: (tests/test_torch_daemon_digests.py).  The cell's first cycle gives
#: STORE_DIGESTS' digest, through the wire as in-process
ARRIVAL_DIGESTS = {
    MAIN_CONFIG: "2755bd0fc6903b5e858f71314ba32f5b58bd618d0586a7a08a768f7631b24bd3",
    SECOND_CONFIG: "2f2acfc86621fefe9d59842f08e5f6091cf27249db03ea707539a521a3d8877c",
}
#: seconds a phase waits for the leader's binds, or for the arrivals, to
#: land at store truth; and for a child binary to log that it is up (the
#: scheduler's warmup and informer sync included)
SETTLE_S = 300.0
CHILD_START_S = 300.0


def arrival_objects(jobs: int = ARRIVALS["jobs"], seed: int = ARRIVALS["seed"]) -> list:
    """The arrivals as the port's API objects, in the order they are
    created: the pods, their PodGroups (queue ARRIVALS["queue"], minMember
    1, made by the micro cells' job generator), then the queue."""
    from volcano_tpu_torch.apis import core, scheduling
    from volcano_tpu_torch.ops.synthetic import micro_job

    rng = np.random.RandomState(seed)
    pods, pod_groups = [], []
    for i in range(jobs):
        pg, (pod,) = micro_job(f"arrival-{i:05d}", float(i + 1), 1, 1, rng)
        pg["spec"]["queue"] = ARRIVALS["queue"]
        pod_groups.append(scheduling.PodGroup.from_dict(pg))
        pods.append(core.Pod.from_dict(pod))
    queue = scheduling.Queue(metadata=core.ObjectMeta(name=ARRIVALS["queue"], namespace="",
                                                      uid=f"q-{ARRIVALS['queue']}"),
                             spec=scheduling.QueueSpec(weight=1, capability={}))
    return pods + pod_groups + [queue]


def create_objects(api, objects) -> float:
    """Create ``objects`` in order, each from a copy with its own metadata
    (as ``seed_store``); the seconds it took."""
    import copy

    t0 = time.perf_counter()
    for obj in objects:
        obj = copy.copy(obj)
        obj.metadata = copy.copy(obj.metadata)
        api.create(obj)
    return time.perf_counter() - t0


def arrival_binds(audit, arrivals) -> list:
    """The arrivals' (ns/name, node) pairs bound at store truth."""
    keys = {f"{o.metadata.namespace}/{o.metadata.name}" for o in arrivals if o.kind == "Pod"}
    return [(k, n) for k, n in audit.binds() if k in keys]


def wait_for(pred, timeout: float, what: str, failed=None, interval: float = 0.05) -> float:
    """Seconds until ``pred()`` holds; the run fails when ``timeout``
    passes first, or at once when ``failed()`` returns a reason."""
    t0 = time.monotonic()
    while not pred():
        reason = failed() if failed is not None else None
        check(reason is None, f"{what}: {reason}")
        check(time.monotonic() - t0 < timeout, f"{what}: not within {timeout} s")
        time.sleep(interval)
    return time.monotonic() - t0


def store_settled(api, audit, n_pods: int) -> bool:
    """Every pod bound with one Scheduled Event, and every PodGroup
    Running, at store truth."""
    from volcano_tpu_torch.apis import scheduling

    with audit.lock:
        if len(audit.bound) < n_pods or audit.events.get("Scheduled", [0, 0])[0] < n_pods:
            return False
    return {pg.status.phase for pg in api.list("PodGroup")} == {scheduling.POD_GROUP_RUNNING}


def steady_leader(daemons, hold_s: float, timeout: float, what: str):
    """The one of ``daemons`` whose elector has led alone for ``hold_s``
    seconds; the run fails when none has within ``timeout``."""
    t0 = time.monotonic()
    holder, since = None, t0
    while True:
        leading = [d for d in daemons if d.elector.is_leader]
        now = time.monotonic()
        current = leading[0] if len(leading) == 1 else None
        if current is not holder:
            holder, since = current, now
        elif holder is not None and now - since >= hold_s:
            return holder
        check(now - t0 < timeout, f"{what}: none within {timeout} s")
        time.sleep(0.01)


def cycle_failure(daemon) -> Optional[str]:
    """What a daemon's cycles that raised left (its ``failed_cycles``
    count and ``last_error``; the guarded loop logs them and goes on),
    None while there is none; the run fails on any."""
    if daemon.failed_cycles == 0:
        return None
    return f"{daemon.identity}: {daemon.failed_cycles} cycles raised, the last {daemon.last_error}"


def identity_checked(body: str, what: str) -> int:
    """The series of a daemon's /metrics text, each carrying
    ``daemon="scheduler"`` and ``role="scheduler"``, with
    ``volcano_build_info`` among them; their count."""
    series = [ln for ln in body.splitlines() if ln and not ln.startswith("#")]
    bare = [ln for ln in series if 'daemon="scheduler"' not in ln or 'role="scheduler"' not in ln]
    check(series and not bare, f"{what}: {len(bare)} of {len(series)} series without the "
                               f"identity labels, e.g. {bare[:2]}")
    check(any(ln.startswith("volcano_build_info{") for ln in series),
          f"{what}: no volcano_build_info")
    return len(series)


class SegmentTap:
    """A watch on an API server's ConfigMaps (the port's store or a
    ``RemoteAPIServer``), registered before any recorder exports: every
    version of every telemetry segment (``vtpu-spans-*``) the store held,
    in the order written.  The store itself keeps each recorder's last 16
    flushes, about 4 s of history while binds land and 16 s of idle
    cycles after; ``obs.collect_spans(tap)`` reads every span any
    recorder exported, the store's watch being the collector, while
    ``obs.collect_spans(api)`` reads what the store still holds."""

    def __init__(self, api):
        import threading

        from volcano_tpu_torch import obs

        self.api, self.lock, self.versions = api, threading.Lock(), []
        self._ns, self._prefix = obs.NAMESPACE, obs.SEGMENT_PREFIX
        api.watch("ConfigMap", self._cm, send_initial=False)

    def _cm(self, event, old, new):
        from types import SimpleNamespace

        if event == "DELETED" or new.metadata.namespace != self._ns \
                or not (new.metadata.name or "").startswith(self._prefix):
            return
        with self.lock:
            self.versions.append(SimpleNamespace(
                metadata=SimpleNamespace(name=new.metadata.name), data=dict(new.data or {})))

    def list(self, kind: str, namespace: Optional[str] = None) -> list:
        with self.lock:
            return list(self.versions)

    def close(self) -> None:
        self.api.unwatch("ConfigMap", self._cm)


class LaunchClock:
    """CUDA events around each launch of the session kernel (the wrapper
    ``ops/session_kernel._launch``, wrapped from construction to
    ``close``; the launch and its count are the wrapper's own): the
    device time of each launch, in launch order."""

    def __init__(self):
        import torch

        from volcano_tpu_torch.ops import session_kernel

        self._sk, self._real, self.events = session_kernel, session_kernel._launch, []

        def launch(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = self._real(*args, **kwargs)
            end.record()
            self.events.append((start, end))
            return out

        session_kernel._launch = launch

    def ms(self, first: int, n: int) -> list:
        """The device ms of launches ``first`` .. ``first + n - 1``."""
        import torch

        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events[first:first + n]]

    def close(self) -> None:
        self._sk._launch = self._real


#: the share of pod traces ``phase_daemon``'s recorders keep
#: (``VTPU_TELEMETRY_SAMPLE``; cycles, kernel phases and commit flushes
#: are process-scope spans, always kept).  At 1.0 a 4,096-bind frame puts
#: 4,096 ``bind:landed`` spans into the 8,192-span ring at once from each
#: of two workers, faster than the flusher's 2,048 a quarter second
#: drains them, and the overflow drops cycle and flush spans with them
DAEMON_TRACE_SAMPLE = 0.1

#: how far the flight recorder's ``kernel:execute`` span (host clock
#: around ``execute_allocate``: the task rows' put, the operands built on
#: the card, the launches, the fetch) may run past the kernel's own
#: launches (CUDA events): host work under the interpreter lock, which the
#: recorder's flusher and the elector share; 21.1–45.9 ms apart at 50k x
#: 10k on an NVIDIA H100 80GB HBM3 at 700 W
EXECUTE_GAP_MS = 100.0


def span_chain(span: dict, by_id: dict) -> list:
    """``span``'s ancestors by parent id, nearest first."""
    chain = []
    while span.get("p") in by_id and len(chain) < 64:
        span = by_id[span["p"]]
        chain.append(span)
    return chain


def tree_depth(spans: list) -> int:
    """The depth of the deepest span of ``obs.build_tree(spans)`` (a root
    is depth 1)."""
    from volcano_tpu_torch import obs

    roots, children = obs.build_tree(spans)
    depth, frontier = 0, list(roots)
    while frontier:
        depth += 1
        frontier = [c for s in frontier for c in children.get(s.get("s"), [])]
    return depth


def waterfall(spans: list, namespace: str, name: str, api=None) -> tuple:
    """(spans, text) of one pod's waterfall, as ``vtctl trace pod`` selects
    and renders it (its identities from ``api`` where given)."""
    import io

    from volcano_tpu_torch import obs

    idents = obs.related_identities(api, namespace, name) if api is not None \
        else [(namespace, name)]
    sel = obs.select_union(spans, idents)
    buf = io.StringIO()
    obs.render_waterfall(sel, buf)
    return sel, buf.getvalue()


def bus_pairs(spans: list, server: str) -> list:
    """The (client, server) ``bus:<op>`` span pairs of ``spans`` whose
    server half the process ``server`` recorded: same name, linked parent
    → child, two processes."""
    by_id = {s["s"]: s for s in spans}
    return [(by_id[s["p"]], s) for s in spans
            if s.get("daemon") == server and s.get("cat") == "bus" and s.get("p") in by_id
            and by_id[s["p"]].get("name") == s.get("name")
            and by_id[s["p"]].get("daemon") != server]


def cycle_with_kernels(spans: list, cycle: dict) -> dict:
    """The names and durations of ``cycle``'s kernel-phase children."""
    return {s["name"]: s["dur"] / 1e3 for s in spans
            if s.get("p") == cycle["s"] and s["name"].startswith("kernel:")}


def phase_daemon(card: str) -> dict:
    """The scheduler daemon (``cmd/scheduler.SchedulerDaemon``) at full
    width on the port's in-process store, as the binary builds it with
    ``--leader-elect --snapshot-reuse --pipelined-commit --scheduler-conf``
    and the elector's defaults (lease 2.0 s, retry 0.2 s, period 1 s).
    MAIN_CONFIG's cluster seeded as ``store_cycles`` seeds it; daemon A
    leads and binds it: every pod bound at store truth with
    STORE_DIGESTS' digest, one Scheduled Event each, every PodGroup
    Running, no commit failure, resync entry, quarantined task or
    rebind, no cycle that raised, no kernel failure, the session kernel
    launched in A's cycles.  A's /healthz 200, its /metrics with the
    identity labels on every series.  A's longest gap between renews and
    its loop turns skipped for want of the lease, printed.  Then daemon
    B (started after A's frames landed, so no takeover falls inside A's
    commit) builds its cache from the store's watch; the daemon that has
    held the lease alone for a lease period (A, unless B took a lapsed
    lease) crash-stops (``stop(crash=True)`` and its bind workers; the
    heap is collected and frozen from B's start to the phase's end, since
    the collector's pauses over this process's two caches and store are
    not a standby process's); the standby must lead within lease + retry
    + period of the crash; then the arrivals are created (after it
    leads: their creates, back to back under the store lock, would
    starve its elector) and it must bind every arrival once, with
    ARRIVAL_DIGESTS' digest, no pod bound before the crash changing
    node, the session kernel launched in its cycles.  Both daemons run
    the flight recorder (``flight_recorder=True``; one exporter a
    process, so B's start replaces A's and the spans after it carry B's
    identity, and a crash-stop leaves it running): A's first binding
    cycle, from every segment its exporter shipped (``SegmentTap``), is a
    ``cycle:full`` span with ``kernel:pack`` and ``kernel:execute``
    children, the execute span at most ``EXECUTE_GAP_MS`` past the
    kernel's own launches (``LaunchClock``), ``commit:flush`` spans
    adopted into it and a ``bind:landed`` span for the last pod bound
    whose trace is sampled, under one of those flushes, the store digest
    unchanged; no ``export-error`` drop (the
    ring-full drops are counted and printed); and the waterfall of the
    last arrival bound whose trace is sampled (``DAEMON_TRACE_SAMPLE``),
    from the store as ``vtctl trace pod`` reads it, holds the
    standby's cycle after the crash with its kernel phases and the
    arrival's bind.  One ``{"daemon": ...}`` line, with the recorder's
    numbers under ``obs``."""
    import gc
    import os
    import threading

    import torch

    from volcano_tpu_torch import metrics, obs
    from volcano_tpu_torch.client import APIServer
    from volcano_tpu_torch.cmd.scheduler import SchedulerDaemon
    from volcano_tpu_torch.ops import session_kernel

    name, config = DAEMON_CELL, DAEMON_CELLS[DAEMON_CELL]
    t_phase = time.perf_counter()
    objects = loop_objects(config)
    n_pods = len(objects[1])
    api = APIServer()
    audit = StoreAudit(api)
    t0 = time.perf_counter()
    seed_store(api, objects)
    seed_s = time.perf_counter() - t0
    failures0, commit0 = kernel_failures(), commit_failures()
    errors0 = metrics.registry.counter("volcano_telemetry_dropped_total", reason="export-error")
    out = dict(cell=name, config=config, card=card, seed_ms=seed_s * 1e3)
    daemons, frozen, tap, clock = [], False, SegmentTap(api), LaunchClock()
    rec = {"trace_sample": DAEMON_TRACE_SAMPLE}
    sample0 = os.environ.get("VTPU_TELEMETRY_SAMPLE")
    os.environ["VTPU_TELEMETRY_SAMPLE"] = str(DAEMON_TRACE_SAMPLE)
    with policy_file(CYCLE_TIERS, ("gpu-allocate",)) as path:
        def daemon(identity):
            d = SchedulerDaemon(api, scheduler_conf=path, snapshot_reuse=True,
                                pipelined_commit=True, leader_elect=True, listen_port=0,
                                identity=identity, flight_recorder=True)
            daemons.append(d)
            return d

        try:
            torch.cuda.synchronize()
            session_kernel.LAUNCHES = session_kernel.WIDE_LAUNCHES = 0
            a = daemon("daemon-a")
            t0 = time.perf_counter()
            a.start()
            out["a_start_ms"] = (time.perf_counter() - t0) * 1e3
            exporters = {"daemon-a": a._obs_exporter}
            t_settle = wait_for(lambda: store_settled(api, audit, n_pods), SETTLE_S,
                                f"{name}: daemon A's binds", failed=lambda: cycle_failure(a),
                                interval=0.5)
            wait_for(lambda: a.cache._commit_plane.depth == 0, SETTLE_S,
                     f"{name}: daemon A's commit plane", failed=lambda: cycle_failure(a))
            a_launches = session_kernel.LAUNCHES + session_kernel.WIDE_LAUNCHES
            digest = audit.digest()
            check(digest == STORE_DIGESTS[config],
                  f"{name}: store digest {digest} != the JAX package's {STORE_DIGESTS[config]}")
            check(audit.events.get("Scheduled") == [n_pods, 0],
                  f"{name}: Scheduled Events {audit.events.get('Scheduled')}")
            # A's lease can lapse behind the store lock while its frames
            # land (ROADMAP open work 8); with no other candidate it
            # renews within a retry period of the lock coming free
            wait_for(lambda: a.elector.is_leader, a.elector.lease_duration,
                     f"{name}: A leading again after its frames landed",
                     failed=lambda: cycle_failure(a))
            check(a_launches > 0 and a.elector.is_leader,
                  f"{name}: A launched {a_launches}, leads {a.elector.is_leader}")
            status, _ = http_get(a.serving.port, "/healthz")
            check(status == 200, f"{name}: A's /healthz {status}")
            status, body = http_get(a.serving.port, "/metrics")
            n_series = identity_checked(body.decode(), f"{name}: A's /metrics")
            out.update(a_settle_s=t_settle, a_launches=a_launches, a_cycles=a.cycles,
                       a_renews=a.elector.renews, a_skipped_turns=a.skipped_turns,
                       a_metrics_series=n_series, a_store_digest=digest)
            print(f"{name}: daemon A bound {n_pods} pods in {t_settle:.3f} s of its start "
                  f"({a.cycles} cycles, {a_launches} session kernel launches), digest == "
                  f"STORE_DIGESTS; lease: longest gap between renews "
                  f"{a.elector.max_renew_gap * 1e3:.3f} ms over {a.elector.renews} renews, "
                  f"{a.skipped_turns} loop turns skipped for want of the lease; /healthz 200, "
                  f"{n_series} series with the identity labels; card {card}")

            # the flight recorder: A's first binding cycle as its exporter
            # shipped it, every segment version the store held (the last
            # frame's spans flushed now, not at the flusher's next beat)
            exporters["daemon-a"].flush_all()
            t0 = time.perf_counter()
            spans = [s for s in obs.collect_spans(tap) if s.get("daemon") == "daemon-a"]
            rec["collect_ms"] = (time.perf_counter() - t0) * 1e3
            by_id = {s["s"]: s for s in spans}
            cycles = [s for s in spans if s["name"] == "cycle:full"]
            binding = next((c for c in cycles
                            if "kernel:execute" in cycle_with_kernels(spans, c)), None)
            check(binding is not None, f"{name}: no cycle:full span of A with a kernel:execute "
                                       f"child among {len(cycles)} cycles, {len(spans)} spans")
            kernels = cycle_with_kernels(spans, binding)
            check(set(kernels) == {"kernel:pack", "kernel:execute"},
                  f"{name}: A's binding cycle's kernel children {kernels}")
            check(len(clock.events) == a_launches, f"{name}: {len(clock.events)} launches timed, "
                                                   f"{a_launches} counted")
            launch_ms = clock.ms(0, a_launches)
            gap_ms = kernels["kernel:execute"] - sum(launch_ms)
            check(0.0 <= gap_ms <= EXECUTE_GAP_MS,
                  f"{name}: kernel:execute {kernels['kernel:execute']:.3f} ms against the "
                  f"kernel's {a_launches} launches {sum(launch_ms):.3f} ms")
            flushes = [s for s in spans if s["name"] == "commit:flush" and s["p"] == binding["s"]]
            check(flushes, f"{name}: no commit:flush span adopted into A's binding cycle")
            landed = {s["args"]["pod"]: s for s in spans if s["name"] == "bind:landed"}
            # the latest bound pod whose trace the sampling coin keeps
            late_pod = next(k for k in sorted(audit.bound_at, key=audit.bound_at.get,
                                              reverse=True)
                            if exporters["daemon-a"].keep(obs.trace_id_for_pod(*k.split("/"))))
            check(late_pod in landed, f"{name}: no bind:landed span for {late_pod}, the last pod "
                                      f"bound whose trace is sampled ({len(landed)} bind spans)")
            chain = span_chain(landed[late_pod], by_id)
            check([s["name"] for s in chain] == ["commit:flush", "cycle:full"]
                  and chain[-1]["s"] == binding["s"],
                  f"{name}: {late_pod}'s bind under {[s['name'] for s in chain]}, not a flush "
                  f"of A's binding cycle")
            check(audit.digest() == digest, f"{name}: the store digest moved under the recorder")
            sel, text = waterfall(spans, *late_pod.split("/"), api)
            print(f"{name}: A's waterfall of {late_pod} (every segment A shipped):\n"
                  + "\n".join(text.splitlines()[:40]))
            rec.update(a_spans=len(spans), a_cycles=len(cycles), binding_cycle=binding["args"],
                       binding_cycle_ms=binding["dur"] / 1e3, kernel_spans_ms=kernels,
                       launch_ms=launch_ms, execute_gap_ms=gap_ms,
                       adopted_flushes=len(flushes),
                       adopted_items=sum(f["args"]["items"] for f in flushes),
                       queue_wait_ms=max(f["args"].get("queue_wait_ms", 0.0) for f in flushes),
                       bind_spans=len(landed), late_pod=late_pod,
                       late_chain=[s["name"] for s in chain], late_depth=tree_depth(sel),
                       a_live_spans=sum(s.get("daemon") == "daemon-a"
                                        for s in obs.collect_spans(api)))
            print(f"{name}: the recorder: A's binding cycle {binding['args']} "
                  f"{rec['binding_cycle_ms']:.3f} ms with kernel:pack "
                  f"{kernels['kernel:pack']:.3f} ms and kernel:execute "
                  f"{kernels['kernel:execute']:.3f} ms against its {a_launches} launches' "
                  f"{sum(launch_ms):.3f} ms on the card ({gap_ms:.3f} ms apart); {len(flushes)} "
                  f"commit:flush spans adopted into it ({rec['adopted_items']} items); "
                  f"{len(landed)} bind:landed spans of {n_pods} binds, {late_pod} bound late "
                  f"under {rec['late_chain']}; {len(spans)} spans of A shipped, "
                  f"{rec['a_live_spans']} still in the store; card {card}")

            # the standby, after A's frames landed.  Its informer sync (the
            # store's initial lists, ~66k objects under the store lock) and
            # the collector's pauses over this process's heap can outlast
            # the lease: A's lease lapses and B may take it.  So the heap is
            # collected and frozen around B's start, and the leader is the
            # daemon that has held the lease alone for a lease period; it
            # is crash-stopped, and the other, the standby, must take over
            gc.collect()
            gc.freeze()
            frozen = True
            b = daemon("daemon-b")
            gap_before_b = a.elector.max_renew_gap
            t0 = time.perf_counter()
            b.start()
            out["b_start_ms"] = (time.perf_counter() - t0) * 1e3
            exporters["daemon-b"] = b._obs_exporter
            gc.collect()
            gc.freeze()
            lease_s = a.elector.lease_duration
            leader = steady_leader((a, b), lease_s + a.elector.retry_period, SETTLE_S,
                                   f"{name}: a steady leader after B's start")
            standby = b if leader is a else a
            out.update(a_renew_max_gap_ms=gap_before_b * 1e3,
                       b_start_renew_max_gap_ms=a.elector.max_renew_gap * 1e3,
                       moved_at_b_start=leader is b, leader=leader.identity,
                       standby=standby.identity)
            arrivals = arrival_objects()
            stamps = {}
            standby_cycles = standby.cycles

            def watch_standby():
                while "bound" not in stamps:
                    now = time.monotonic()
                    if "lead" not in stamps and standby.elector.is_leader:
                        stamps["lead"] = now
                    if "cycle" not in stamps and standby.cycles > standby_cycles:
                        stamps["cycle"] = now
                    time.sleep(0.005)

            torch.cuda.synchronize()
            session_kernel.LAUNCHES = session_kernel.WIDE_LAUNCHES = 0
            # the crash: the leader's loop and elector stopped without
            # releasing the lease, and its bind workers with them (their
            # queued frames land first: in process they cannot die with it)
            t0 = time.perf_counter()
            leader.stop(crash=True)
            leader.cache.stop_commit_plane()
            out["crash_stop_ms"] = (time.perf_counter() - t0) * 1e3
            t_crash, wall_crash = time.monotonic(), time.time() * 1e6
            watcher = threading.Thread(target=watch_standby, daemon=True)
            watcher.start()
            # the arrivals once the standby leads: 2,001 creates under the
            # store lock, back to back, would starve its elector's get
            limit = lease_s + a.elector.retry_period + a.period
            wait_for(lambda: "lead" in stamps, 2 * limit, f"{name}: the standby leading")
            lead_s = stamps["lead"] - t_crash
            check(lead_s <= limit, f"{name}: the standby led {lead_s:.3f} s after the crash, "
                                   f"limit {limit} s")
            out["arrivals_create_ms"] = create_objects(api, arrivals) * 1e3
            n_new = ARRIVALS["jobs"]
            wait_for(lambda: len(arrival_binds(audit, arrivals)) == n_new, SETTLE_S,
                     f"{name}: the standby binding the arrivals",
                     failed=lambda: cycle_failure(standby))
            stamps["bound"] = time.monotonic()
            watcher.join(timeout=10)
            b_launches = session_kernel.LAUNCHES + session_kernel.WIDE_LAUNCHES
            digest = cycle_digest(arrival_binds(audit, arrivals))
            check(digest == ARRIVAL_DIGESTS[config],
                  f"{name}: arrivals digest {digest} != the JAX package's "
                  f"{ARRIVAL_DIGESTS[config]}")
            check(audit.events.get("Scheduled") == [n_pods + n_new, 0] and not audit.rebinds,
                  f"{name}: Scheduled Events {audit.events.get('Scheduled')}, rebinds "
                  f"{audit.rebinds[:3]}")
            check(b_launches > 0, f"{name}: no session kernel launch in the standby's cycles")
            # the waterfall of the last arrival bound whose trace is sampled,
            # as `vtctl trace pod` reads it from the store: the standby's
            # cycle after the crash
            last = max((k for k, _n in arrival_binds(audit, arrivals)
                        if exporters["daemon-b"].keep(obs.trace_id_for_pod(*k.split("/")))),
                       key=audit.bound_at.get)
            view = {}

            def arrival_traced() -> bool:
                sel, text = waterfall(obs.collect_spans(api), *last.split("/"), api)
                by_id = {s["s"]: s for s in sel}
                cyc = [c for s in sel if s["name"] == "bind:landed"
                       for c in span_chain(s, by_id)
                       if c["name"].startswith("cycle:") and c["ts"] >= wall_crash]
                view.update(sel=sel, text=text, cycles=cyc)
                return bool(cyc)

            wait_for(arrival_traced, 10.0, f"{name}: {last}'s waterfall with the standby's "
                                           f"cycle", interval=0.25)
            kernels = cycle_with_kernels(view["sel"], view["cycles"][0])
            check(set(kernels) == {"kernel:pack", "kernel:execute"},
                  f"{name}: the standby's cycle's kernel children {kernels}")
            print(f"{name}: {last}'s waterfall (the store):\n" + view["text"])
            errors = metrics.registry.counter("volcano_telemetry_dropped_total",
                                              reason="export-error") - errors0
            check(errors == 0, f"{name}: {errors:.0f} spans dropped on export errors")
            rec.update(arrival=last, arrival_spans=len(view["sel"]),
                       arrival_depth=tree_depth(view["sel"]),
                       arrival_cycle=view["cycles"][0]["args"],
                       arrival_kernel_spans_ms=kernels,
                       exported={k: e.exported for k, e in exporters.items()},
                       dropped={k: e.dropped for k, e in exporters.items()},
                       dropped_by_reason={dict(k)["reason"]: v for k, v in metrics.registry.counters(
                           "volcano_telemetry_dropped_total").items()},
                       segments_live={k: sum(1 for cm in api.list("ConfigMap", obs.NAMESPACE)
                                             if cm.metadata.name.startswith(
                                                 f"{obs.SEGMENT_PREFIX}{k}-"))
                                      for k in exporters},
                       segment_versions=len(tap.versions),
                       spans_live=len(obs.collect_spans(api)),
                       spans_shipped=len(obs.collect_spans(tap)))
            for d in (a, b):
                check(cycle_failure(d) is None and d.last_error is None,
                      f"{name}: {cycle_failure(d)}")
                check(not d.cache.err_tasks and not d.cache.quarantined_tasks,
                      f"{name}: {d.identity}: {len(d.cache.err_tasks)} resync entries, "
                      f"{len(d.cache.quarantined_tasks)} quarantined")
            check(kernel_failures() == failures0 and commit_failures() == commit0,
                  f"{name}: {kernel_failures() - failures0:.0f} kernel failures, "
                  f"{commit_failures() - commit0:.0f} commit failures")
            out.update(b_launches=b_launches, standby_cycles=standby.cycles - standby_cycles,
                       lead_ms=lead_s * 1e3,
                       first_cycle_ms=(stamps.get("cycle", stamps["bound"]) - t_crash) * 1e3,
                       arrivals_bound_ms=(stamps["bound"] - t_crash) * 1e3,
                       arrival_digest=digest, lease_limit_ms=limit * 1e3)
            print(f"{name}: B started in {out['b_start_ms']:.3f} ms (A's longest renew gap "
                  f"{out['b_start_renew_max_gap_ms']:.3f} ms by then; the lease "
                  f"{'moved to B' if leader is b else 'stayed with A'}); {leader.identity} "
                  f"crash-stopped, {standby.identity} led after {out['lead_ms']:.3f} ms (limit "
                  f"{limit * 1e3:.0f}), its first cycle after the crash ended "
                  f"{out['first_cycle_ms']:.3f} ms and the last of {n_new} arrivals was bound at "
                  f"store truth {out['arrivals_bound_ms']:.3f} ms after the crash (the arrivals "
                  f"created in {out['arrivals_create_ms']:.3f} ms); arrivals digest == "
                  f"ARRIVAL_DIGESTS, no rebind, {b_launches} session kernel launches in the "
                  f"standby's cycles; card {card}")
        finally:
            clock.close()
            for d in daemons:
                d.stop()
                d.cache.stop_commit_plane()
            tap.close()
            if sample0 is None:
                os.environ.pop("VTPU_TELEMETRY_SAMPLE", None)
            else:
                os.environ["VTPU_TELEMETRY_SAMPLE"] = sample0
            metrics.registry.set_identity()
            if frozen:
                gc.unfreeze()
    out["phase_ms"] = (time.perf_counter() - t_phase) * 1e3
    out["obs"] = rec
    del api, audit, daemons, tap
    gc.collect()
    print(json.dumps({"daemon": out}))
    return out


class Binary:
    """A binary of the port as a child process, ``python -m MODULE
    ARGS``, from this checkout, its output in a log file in
    ``directory`` (a fresh temporary directory where None), removed on
    ``close``; ``env`` adds to this process's environment."""

    def __init__(self, module: str, args, directory: Optional[str] = None,
                 env: Optional[dict] = None):
        import os
        import tempfile

        root = os.path.dirname(os.path.abspath(__file__))
        self.dir = directory or tempfile.mkdtemp(prefix="vbin")
        self.log_path = os.path.join(self.dir, "out.log")
        self._log = open(self.log_path, "w")
        self.name = f"{module.rsplit('.', 1)[-1]} {' '.join(args)}"
        self.proc = subprocess.Popen([sys.executable, "-m", module, *args], cwd=root,
                                     env={**os.environ, "PYTHONPATH": root, **(env or {})},
                                     stdout=self._log, stderr=subprocess.STDOUT)

    def text(self) -> str:
        with open(self.log_path) as f:
            return f.read()

    def tail(self, n: int = 20) -> str:
        return "".join(self.text().splitlines(True)[-n:])

    def alive(self) -> bool:
        return self.proc.poll() is None

    def wait_log(self, pattern: str, timeout: float = CHILD_START_S, after: int = 0):
        """The first match of the regex ``pattern`` in the log past byte
        ``after``; a child that exits, or logs no match in ``timeout``
        seconds, fails the run."""
        import re

        t0 = time.monotonic()
        while True:
            m = re.search(pattern, self.text()[after:])
            if m:
                return m
            check(self.alive(), f"{self.name}: exited with {self.proc.returncode}:\n{self.tail()}")
            check(time.monotonic() - t0 < timeout,
                  f"{self.name}: no {pattern!r} in {timeout} s:\n{self.tail()}")
            time.sleep(0.05)

    def status(self, marker: str = "scheduler status: ") -> dict:
        """The binary's kernel launches and device memory: SIGUSR1, then
        the JSON of its ``marker`` line."""
        import re
        import signal

        n = len(self.text())
        self.proc.send_signal(signal.SIGUSR1)
        return json.loads(self.wait_log(re.escape(marker) + r"(\{.*\})", 30.0, after=n).group(1))

    def terminate(self) -> int:
        """SIGTERM; the exit code (a child that does not exit in 60 s
        fails the run)."""
        import signal

        self.proc.send_signal(signal.SIGTERM)
        try:
            return self.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            check(False, f"{self.name}: still running 60 s after SIGTERM:\n{self.tail()}")

    def close(self) -> None:
        import shutil
        import signal

        if self.alive():
            self.proc.send_signal(signal.SIGKILL)
            self.proc.wait(timeout=60)
        self._log.close()
        shutil.rmtree(self.dir, ignore_errors=True)


def metric_sum(body: str, name: str, **labels: str) -> float:
    """The sum of the /metrics series ``name`` whose labels include
    ``labels``."""
    total = 0.0
    for line in body.splitlines():
        head, _, value = line.rpartition(" ")
        if head.split("{", 1)[0] == name and all(f'{k}="{v}"' in head
                                                  for k, v in labels.items()):
            total += float(value)
    return total


def child_checked(child: "Binary", port: int, what: str):
    """A scheduler child's SIGUSR1 status and /metrics text, once it is
    checked: no cycle that raised (its ``failed_cycles`` and no ``cycle
    failed`` in its log: the guarded loop logs it and goes on), no resync
    entry or quarantined task, no commit or executor failure."""
    status = child.status()
    _, body = http_get(port, "/metrics")
    body = body.decode()
    failures = {m: metric_sum(body, m) for m in ("volcano_commit_failures_total",
                                                  "volcano_executor_failures_total")}
    check(status["failed_cycles"] == 0 and "cycle failed" not in child.text()
          and status["resync"] == 0 and status["quarantined"] == 0 and not any(failures.values()),
          f"{what}: status {status}, {failures}:\n{child.tail()}")
    return status, body


def cycle_launches(status: dict) -> int:
    """The session kernel's launches in a scheduler child's status line
    less those its ``--warmup`` made before the daemon started."""
    return (status["session"] + status["session_wide"]
            - status["warmup"]["session"] - status["warmup"]["session_wide"])


class HealthProbe:
    """GET /healthz on a serving port every 0.25 s on a thread until
    ``stop()``: the answers that were not 200."""

    def __init__(self, port: int):
        import threading

        self.port, self.bad, self.n = port, [], 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.wait(0.25):
            try:
                status, body = http_get(self.port, "/healthz")
            except OSError as e:
                status, body = None, repr(e).encode()
            self.n += 1
            if status != 200:
                self.bad.append((status, body[:200]))

    def stop(self) -> list:
        self._stop.set()
        self._thread.join(timeout=30)
        return self.bad


def lease_holder(api) -> str:
    """The scheduler lease's holder in the store ("" when none)."""
    from volcano_tpu_torch.serving.leader import LEASE_KEY

    cm = api.get("ConfigMap", "volcano-system", "vtpu-scheduler")
    return "" if cm is None else json.loads(cm.data.get(LEASE_KEY, "{}")).get("holderIdentity", "")


#: the scheduler children's watchdog period (``VTPU_WATCHDOG_PERIOD``, 5 s
#: in the binaries by default), so that a breach shows within the phase
WATCHDOG_PERIOD_S = 1.0


def recorder_metrics(body: str) -> dict:
    """A daemon's recorder counters from its /metrics text: spans
    exported (the batch-size histogram's sum) and dropped, by reason."""
    return dict(exported=metric_sum(body, "volcano_telemetry_batch_size_sum"),
                ring_full=metric_sum(body, "volcano_telemetry_dropped_total", reason="ring-full"),
                export_error=metric_sum(body, "volcano_telemetry_dropped_total",
                                        reason="export-error"))


def watchdog_report(port: int, directory: str, timeout: float) -> dict:
    """What a scheduler child's watchdog raised: its /healthz body once an
    ``slo-burn:`` reason shows (or after ``timeout``), its burn gauges,
    and each bundle in its incident directory (reason, files, errors,
    bytes; a breach's bundle waited for up to 30 s)."""
    import os

    from volcano_tpu_torch.metrics import scrape

    deadline = time.monotonic() + timeout
    while True:
        _, body = http_get(port, "/healthz")
        healthz = body.decode()
        if "slo-burn:" in healthz or time.monotonic() > deadline:
            break
        time.sleep(0.1)
    _, body = http_get(port, "/metrics")
    burns = {f"{dict(k[1])['slo']}/{dict(k[1])['window']}": v
             for k, v in scrape.parse_metrics(body.decode()).series.items()
             if k[0] == "volcano_slo_burn"}
    deadline = time.monotonic() + 30.0
    while not incident_bundles(directory) and "slo-burn:" in healthz \
            and time.monotonic() < deadline:
        time.sleep(0.25)
    return dict(healthz=healthz, burns=burns, bundles=incident_bundles(directory))


def incident_bundles(directory: str) -> dict:
    """Each incident bundle in ``directory``: its reason, alerts, files as
    its ``meta.json`` lists them, errors, spans and each file's bytes."""
    import os

    out = {}
    names = sorted(d for d in os.listdir(directory) if d.startswith("incident-")) \
        if os.path.isdir(directory) else []
    for d in names:
        path = os.path.join(directory, d)
        meta = json.load(open(os.path.join(path, "meta.json")))
        out[d] = dict(reason=meta["reason"], alerts=meta["alerts"], files=meta["files"],
                      errors=meta["errors"], spans=meta["spanCount"],
                      bytes={f: os.path.getsize(os.path.join(path, f))
                             for f in sorted(os.listdir(path))})
    return out


def bus_recorder(name: str, url: str, client, tap, leader_id: str, standby_id: str,
                 standby_port: int, arrivals, audit, wall_kill: float) -> dict:
    """The flight recorder over the wire, after the standby bound the
    arrivals: the last arrival's waterfall from the store holds the
    standby's cycle after the kill with its kernel phases, the arrival's
    bind and ``bus:<op>`` client spans linked to the apiserver's adopted
    server spans, two processes or more; ``python -m
    volcano_tpu_torch.cli.vtctl --bus URL trace pod`` prints it; a pod
    the SIGKILLed leader bound has a waterfall with the leader's cycle,
    from every segment shipped (``SegmentTap``); ``vtctl incidents
    capture`` writes a complete bundle, ``incidents list`` shows it and
    ``top`` prints a row for each target."""
    import io
    import os
    import re
    import shutil
    import tempfile

    from volcano_tpu_torch import obs
    from volcano_tpu_torch.cli import vtctl

    rec = {}
    last = max((k for k, _n in arrival_binds(audit, arrivals)), key=audit.bound_at.get)
    ns, pod = last.split("/")
    view = {}

    def traced() -> bool:
        sel, text = waterfall(obs.collect_spans(client), ns, pod, client)
        by_id = {s["s"]: s for s in sel}
        view.update(sel=sel, text=text, pairs=bus_pairs(sel, "apiserver-0"), cycles=[
            c for s in sel if s["name"] == "bind:landed" for c in span_chain(s, by_id)
            if c["name"].startswith("cycle:") and c.get("daemon") == standby_id
            and c["ts"] >= wall_kill])
        return bool(view["cycles"] and view["pairs"])

    wait_for(traced, 10.0, f"{name}: {last}'s waterfall with {standby_id}'s cycle and the "
                           f"bus spans", interval=0.25)
    kernels = cycle_with_kernels(view["sel"], view["cycles"][0])
    check(set(kernels) == {"kernel:pack", "kernel:execute"},
          f"{name}: {standby_id}'s cycle's kernel children {kernels}")
    procs = sorted({(s.get("daemon"), s.get("pid")) for s in view["sel"]})
    check(len(procs) >= 2, f"{name}: {last}'s waterfall from {procs}")
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "volcano_tpu_torch.cli.vtctl", "--bus", url,
                          "trace", "pod", "-n", ns, "-N", pod], cwd=root, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, PYTHONPATH=root))
    rec["vtctl_trace_ms"] = (time.perf_counter() - t0) * 1e3
    m = re.search(r"(\d+) span\(s\) across (\d+) daemon\(s\) / (\d+) process\(es\)",
                  run.stdout)
    check(run.returncode == 0 and m is not None and int(m.group(3)) >= 2
          and all(x in run.stdout for x in ("cycle:", "kernel:execute", "bus:", "bind:landed")),
          f"{name}: vtctl trace pod {last}: rc {run.returncode}\n{run.stdout}\n{run.stderr}")
    print(f"{name}: python -m volcano_tpu_torch.cli.vtctl --bus {url} trace pod -n {ns} -N "
          f"{pod}:\n{run.stdout}")
    rec.update(arrival=last, arrival_spans=len(view["sel"]), arrival_processes=procs,
               arrival_depth=tree_depth(view["sel"]), arrival_kernel_spans_ms=kernels,
               arrival_bus_pairs=sorted({c["name"] for c, _s in view["pairs"]}),
               vtctl_spans=int(m.group(1)), vtctl_processes=int(m.group(3)))

    # the SIGKILLed leader's spans up to its last flush
    shipped = obs.collect_spans(tap)
    lead = [s for s in shipped if s.get("daemon") == leader_id]
    by_id = {s["s"]: s for s in lead}
    hit = next((s for s in lead if s["name"] == "bind:landed"
                and any(c["name"].startswith("cycle:") for c in span_chain(s, by_id))), None)
    check(hit is not None, f"{name}: no bind of {leader_id} under one of its cycles among "
                           f"{len(lead)} spans it shipped")
    sel, text = waterfall(shipped, *hit["args"]["pod"].split("/"), client)
    check(any(s["name"].startswith("cycle:") and s.get("daemon") == leader_id for s in sel),
          f"{name}: {hit['args']['pod']}'s waterfall without {leader_id}'s cycle")
    print(f"{name}: {hit['args']['pod']}, bound by the SIGKILLed {leader_id} (every segment "
          f"shipped):\n" + "\n".join(text.splitlines()[:40]))
    rec.update(leader_pod=hit["args"]["pod"], leader_spans_shipped=len(lead),
               leader_spans_live=sum(s.get("daemon") == leader_id
                                     for s in obs.collect_spans(client)),
               leader_depth=tree_depth(sel),
               leader_chain=[s["name"] for s in span_chain(hit, by_id)])

    inc_dir = tempfile.mkdtemp(prefix="vcap")
    try:
        buf = io.StringIO()
        t0 = time.perf_counter()
        rc = vtctl.main(["--bus", url, "incidents", "capture", "--dir", inc_dir,
                         "--settle", "0.5"], out=buf)
        rec["capture_ms"] = (time.perf_counter() - t0) * 1e3
        check(rc == 0 and buf.getvalue().startswith("bundle: "),
              f"{name}: vtctl incidents capture: rc {rc}: {buf.getvalue()}")
        path = buf.getvalue().split("bundle: ", 1)[1].strip()
        meta = json.load(open(os.path.join(path, "meta.json")))
        files = sorted(os.listdir(path))
        check(sorted(meta["files"]) == files and not meta["errors"] and meta["spanCount"] > 0,
              f"{name}: the captured bundle {files}: {meta}")
        rec["capture"] = dict(files=meta["files"], spans=meta["spanCount"],
                              bytes={f: os.path.getsize(os.path.join(path, f)) for f in files})
    finally:
        shutil.rmtree(inc_dir, ignore_errors=True)
    buf = io.StringIO()
    rc = vtctl.main(["--bus", url, "incidents", "list"], out=buf)
    check(rc == 0 and "manual" in buf.getvalue(), f"{name}: vtctl incidents list: rc {rc}:\n"
                                                   f"{buf.getvalue()}")
    print(f"{name}: vtctl incidents list:\n{buf.getvalue()}")
    rec["incidents_listed"] = len(buf.getvalue().splitlines()) - 1
    target = f"127.0.0.1:{standby_port}"
    buf = io.StringIO()
    rc = vtctl.main(["--bus", url, "top", "--metrics", target], out=buf)
    rows = {ln.split()[0] for ln in buf.getvalue().splitlines()[2:] if ln.startswith("  ")}
    check(rc == 0 and {"apiserver-0", target, "CLUSTER"} <= rows,
          f"{name}: vtctl top: rc {rc}:\n{buf.getvalue()}")
    print(f"{name}: vtctl top:\n{buf.getvalue()}")
    rec["top_rows"] = sorted(rows)
    return rec


#: the bus cell's seed: its first BUS_SEED_TIMED creates one at a time
#: over the wire (the wire's µs a create), the rest from HA_SEED_THREADS
#: threads (all 13,501 one at a time, 31-37 s, until the federation's
#: phase needed the room)
BUS_SEED_TIMED = 2_000


def seed_wire(api, objects) -> tuple:
    """``seed_store`` over the wire: priority classes, nodes, pods and pod
    groups in the generator's order, the first BUS_SEED_TIMED one at a
    time, the rest from HA_SEED_THREADS threads, then the queues.
    (seconds of the timed creates, their count, seconds of all)."""
    nodes, pods, pod_groups, queues, *rest = objects
    ordered = list(rest[0] if rest else ()) + list(nodes) + list(pods) + list(pod_groups)
    t0 = time.perf_counter()
    timed_s = create_objects(api, ordered[:BUS_SEED_TIMED])
    create_through_failover(api, ordered[BUS_SEED_TIMED:], HA_SEED_THREADS)
    create_objects(api, queues)
    return timed_s, min(BUS_SEED_TIMED, len(ordered)), time.perf_counter() - t0


def phase_bus(card: str) -> dict:
    """The deployed topology on the card: ``python -m
    volcano_tpu_torch.cmd.apiserver --port 0 --listen-port 0`` as a child,
    this process seeding SECOND_CONFIG's cluster (``seed_wire``) through the port's own
    ``RemoteAPIServer``, then two ``python -m
    volcano_tpu_torch.cmd.scheduler --bus tcp://... --leader-elect
    --snapshot-reuse --pipelined-commit --warmup --scheduler-conf ...``
    children: A leads and binds the cluster over the wire, read back from
    the store through the wire with STORE_DIGESTS' digest, one Scheduled
    Event a pod, every PodGroup Running; A is on the card (nvidia-smi lists
    its pid with memory, or the listing rose when it started and it holds
    device memory and launched the session kernel by its own SIGUSR1
    status), the session kernel launched in its cycles (its status line's
    count less its warmup's), its /metrics with kernel execute
    observations and the identity labels.  Each scheduler child is held
    clean by its SIGUSR1 status and /metrics (``child_checked``) after
    A's binds, before the SIGKILL and after the arrivals: no cycle that
    raised (counted, and no ``cycle failed`` in its log), no resync entry
    or quarantined task, no commit or executor failure.  B starts after
    A's binds landed;
    the lease's steady holder (A, unless B took a lapsed lease) is
    SIGKILLed, the standby must take the lease within lease + retry +
    period, and then, the arrivals created, bind them with
    ARRIVAL_DIGESTS' digest, no rebind, the session kernel launched in
    it.  The apiserver's /healthz answers 200 throughout; B and the
    apiserver exit 0 on SIGTERM.  A child that dies fails the run.  The
    apiserver runs with ``--flight-recorder``, the schedulers with
    ``--flight-recorder --watchdog --incident-dir DIR`` (the watchdog
    every ``WATCHDOG_PERIOD_S``): after the arrivals, ``bus_recorder``'s
    checks; no child drops a span on an export error; what the standby's
    watchdog raised is printed, and a ``submit-bind-p99`` breach must
    read ``degraded: slo-burn:submit-bind-p99`` on its /healthz and leave
    a complete bundle in its directory.  One ``{"bus": ...}`` line with
    the codec, the seed's µs a create, the commit's ms a bind over the
    wire, the informer syncs, the takeover and the recorder's numbers
    under ``obs``."""
    import gc
    import os
    import shutil
    import tempfile

    import torch

    from volcano_tpu_torch.bus import protocol, RemoteAPIServer

    name, config = BUS_CELL, DAEMON_CELLS[BUS_CELL]
    t_phase = time.perf_counter()
    objects = loop_objects(config)
    n_pods, n_objects = len(objects[1]), sum(len(objs) for objs in objects)
    out = dict(cell=name, config=config, card=card)
    children, client, probe, tap = [], None, None, None
    incident_dirs = {i: tempfile.mkdtemp(prefix=f"vinc-{i}-") for i in ("bus-a", "bus-b")}
    torch.zeros(1, device="cuda")  # this process's context before the listing is read
    try:
        apiserver = Binary("volcano_tpu_torch.cmd.apiserver",
                           ["--port", "0", "--listen-port", "0", "--flight-recorder"])
        children.append(apiserver)
        m = apiserver.wait_log(r"apiserver up: bus on :(\d+), metrics on :(\d+)")
        bus_port, api_http = int(m.group(1)), int(m.group(2))
        url = f"tcp://127.0.0.1:{bus_port}"
        probe = HealthProbe(api_http)
        client = RemoteAPIServer(url, timeout=60.0)
        check(client.wait_ready(30), f"{name}: the apiserver's bus did not answer")
        tap = SegmentTap(client)
        timed_s, timed_n, seed_s = seed_wire(client, objects)
        audit = StoreAudit(client)  # binds only: registered before any scheduler starts
        check(client.wait_synced(60), f"{name}: the audit's watch did not sync")
        out.update(codec=client.codec, msgpack=protocol.HAS_BINARY, seed_ms=seed_s * 1e3,
                   seed_us_per_create=timed_s / timed_n * 1e6, seed_timed_creates=timed_n,
                   seed_threads=HA_SEED_THREADS)
        with policy_file(CYCLE_TIERS, ("gpu-allocate",)) as path:
            args = ["--bus", url, "--leader-elect", "--snapshot-reuse", "--pipelined-commit",
                    "--warmup", "--scheduler-conf", path, "--listen-port", "0",
                    "--flight-recorder", "--watchdog"]
            env = {"VTPU_WATCHDOG_PERIOD": str(WATCHDOG_PERIOD_S)}
            apps0 = gpu_apps()
            t0 = time.perf_counter()
            a = Binary("volcano_tpu_torch.cmd.scheduler",
                       args + ["--leader-elect-id", "bus-a",
                               "--incident-dir", incident_dirs["bus-a"]], env=env)
            children.append(a)
            a_port = int(a.wait_log(r"bus-a serving on :(\d+)").group(1))
            a.wait_log(r"bus-a became leader")
            out["a_sync_ms"] = float(a.wait_log(r"bus-a: informers synced in ([\d.]+) ms")
                                     .group(1))
            t_settle = wait_for(lambda: store_settled(client, audit, n_pods), SETTLE_S,
                                f"{name}: A's binds at store truth",
                                failed=lambda: None if a.alive() else a.tail(), interval=0.5)
            out["a_ready_to_bound_s"] = time.perf_counter() - t0
            digest = audit.digest()
            check(digest == STORE_DIGESTS[config],
                  f"{name}: store digest {digest} != the JAX package's {STORE_DIGESTS[config]}")
            check(audit.events.get("Scheduled") == [n_pods, 0],
                  f"{name}: Scheduled Events {audit.events.get('Scheduled')}")
            a_status, body = child_checked(a, a_port, f"{name}: A after its binds")
            a_launches = cycle_launches(a_status)
            check(a_launches > 0, f"{name}: no session kernel launch in A's cycles ({a_status})")
            apps = gpu_apps()
            rise = sum(apps.values()) - sum(apps0.values())
            if a.proc.pid in apps:
                check(apps[a.proc.pid] > 0, f"{name}: A's pid holds no memory ({apps})")
            else:
                # the card machine may list every process under one pid (see
                # phase_sidecar): the rise of the listing and A's own account
                check(not any(pid in apps for pid in (os.getpid(), a.proc.pid))
                      and rise >= 100 and a_status["memory_reserved"] > 0
                      and a_launches > 0,
                      f"{name}: A is not on the card: nvidia-smi {apps0} before, {apps} "
                      f"after; A reports {a_status}")
            n_series = identity_checked(body, f"{name}: A's /metrics")
            executes = metric_sum(body, "volcano_tpu_kernel_latency_milliseconds_count",
                                  phase="execute")
            check(executes > 0, f"{name}: A's kernel execute observations {executes}")
            commit_ms = metric_sum(body, "volcano_bus_request_latency_milliseconds_sum",
                                   method="commit_batch")
            frame_binds = metric_sum(body, "volcano_bind_coalesce_size_sum")
            out.update(a_bound_s=t_settle, a_status=a_status, a_launches=a_launches,
                       a_executes=executes,
                       a_metrics_series=n_series, smi_rise_mib=rise, store_digest=digest,
                       commit_batch_ms=commit_ms, commit_frames=metric_sum(
                           body, "volcano_bus_request_latency_milliseconds_count",
                           method="commit_batch"),
                       commit_ms_per_bind=commit_ms / max(frame_binds, 1.0))
            print(f"{name}: seeded {n_objects} objects over the wire in {seed_s * 1e3:.3f} ms "
                  f"({out['seed_us_per_create']:.1f} µs a create over the first "
                  f"{out['seed_timed_creates']} one at a time, the rest from "
                  f"{HA_SEED_THREADS} threads; codec {client.codec}); A "
                  f"synced its informers in {out['a_sync_ms']:.1f} ms and bound {n_pods} pods "
                  f"at store truth {t_settle:.3f} s later, digest == STORE_DIGESTS; commit "
                  f"frames {out['commit_frames']:.0f}, {out['commit_ms_per_bind']:.4f} ms a "
                  f"bind over the wire; {a_launches} session kernel launches in A's cycles "
                  f"(its status {a_status}); card {card}")

            b = Binary("volcano_tpu_torch.cmd.scheduler",
                       args + ["--leader-elect-id", "bus-b",
                               "--incident-dir", incident_dirs["bus-b"]], env=env)
            children.append(b)
            b_port = int(b.wait_log(r"bus-b serving on :(\d+)").group(1))
            out["b_sync_ms"] = float(b.wait_log(r"bus-b: informers synced in ([\d.]+) ms")
                                     .group(1))
            # the lease's holder once it has held it for a lease period
            # (see phase_daemon) is SIGKILLed; the other is the standby
            limit = 2.0 + 0.2 + 1.0  # the binary's lease, retry and period
            held = {"holder": None, "since": time.monotonic()}

            def steady() -> bool:
                holder, now = lease_holder(client), time.monotonic()
                if holder != held["holder"]:
                    held.update(holder=holder, since=now)
                return holder in ("bus-a", "bus-b") and now - held["since"] >= 2.2

            wait_for(steady, SETTLE_S, f"{name}: a steady lease holder", interval=0.02)
            procs = {"bus-a": (a, a_port), "bus-b": (b, b_port)}
            leader_id = held["holder"]
            standby_id = "bus-b" if leader_id == "bus-a" else "bus-a"
            (leader, leader_port), (standby, standby_port) = procs[leader_id], procs[standby_id]
            # both children clean before the kill: the leader's cycles
            # and commits up to here, and the standby's count to start from
            leader_status, leader_body = child_checked(leader, leader_port,
                                                       f"{name}: {leader_id} before its SIGKILL")
            standby_status0, _ = child_checked(standby, standby_port, f"{name}: {standby_id} "
                                                                      f"before the takeover")
            arrivals = arrival_objects()
            leader.proc.kill()
            leader.proc.wait(timeout=60)
            t_kill, wall_kill = time.monotonic(), time.time() * 1e6
            # the arrivals once the standby holds the lease (see phase_daemon)
            wait_for(lambda: lease_holder(client) == standby_id, 2 * limit,
                     f"{name}: {standby_id} taking the lease", interval=0.02)
            lead_s = time.monotonic() - t_kill
            check(lead_s <= limit, f"{name}: {standby_id} took the lease {lead_s:.3f} s after "
                                   f"{leader_id}'s SIGKILL, limit {limit} s")
            out["arrivals_create_ms"] = create_objects(client, arrivals) * 1e3
            n_new = ARRIVALS["jobs"]
            wait_for(lambda: len(arrival_binds(audit, arrivals)) == n_new, SETTLE_S,
                     f"{name}: {standby_id} binding the arrivals",
                     failed=lambda: None if standby.alive() else standby.tail())
            t_bound = time.monotonic()
            digest = cycle_digest(arrival_binds(audit, arrivals))
            check(digest == ARRIVAL_DIGESTS[config],
                  f"{name}: arrivals digest {digest} != the JAX package's "
                  f"{ARRIVAL_DIGESTS[config]}")
            check(audit.events.get("Scheduled") == [n_pods + n_new, 0] and not audit.rebinds,
                  f"{name}: Scheduled Events {audit.events.get('Scheduled')}, rebinds "
                  f"{audit.rebinds[:3]}")
            standby_status, _ = child_checked(standby, standby_port,
                                              f"{name}: {standby_id} after the arrivals")
            b_launches = cycle_launches(standby_status) - cycle_launches(standby_status0)
            check(b_launches > 0, f"{name}: no session kernel launch in {standby_id}'s cycles "
                                  f"after the takeover")
            rec = bus_recorder(name, url, client, tap, leader_id, standby_id, standby_port,
                               arrivals, audit, wall_kill)
            watch = watchdog_report(standby_port, incident_dirs[standby_id],
                                    2 * WATCHDOG_PERIOD_S + 1.0)
            print(f"{name}: {standby_id}'s watchdog: /healthz {watch['healthz']!r}, burns "
                  f"{watch['burns']}, bundles {watch['bundles']}")
            if "slo-burn:submit-bind-p99" in watch["healthz"]:
                check(watch["healthz"].startswith("degraded: ") and any(
                    b["reason"] == "slo-burn:submit-bind-p99" and not b["errors"]
                    and sorted(b["files"]) == sorted(b["bytes"])
                    for b in watch["bundles"].values()),
                    f"{name}: {standby_id} breached submit-bind-p99 without its bundle: {watch}")
            _, standby_body = http_get(standby_port, "/metrics")
            _, api_body = http_get(api_http, "/metrics")
            counts = {leader_id: recorder_metrics(leader_body),
                      standby_id: recorder_metrics(standby_body.decode()),
                      "apiserver-0": recorder_metrics(api_body.decode())}
            check(not any(c["export_error"] for c in counts.values()),
                  f"{name}: spans dropped on export errors: {counts}")
            segments = {}
            for cm in client.list("ConfigMap", "volcano-telemetry"):
                if cm.metadata.name.startswith("vtpu-spans-"):
                    who = cm.metadata.name[len("vtpu-spans-"):].rsplit("-", 1)[0]
                    segments[who] = segments.get(who, 0) + 1
            from volcano_tpu_torch import obs

            rec.update(recorder=counts, segments_live=segments,
                       segment_versions=len(tap.versions), standby_watchdog=watch,
                       leader_bundles=incident_bundles(incident_dirs[leader_id]),
                       published_incidents=[(r["meta"]["identity"], r["meta"]["reason"],
                                             [a["name"] for a in r["meta"]["alerts"]])
                                            for r in obs.list_incidents(client)])
            print(f"{name}: {leader_id}'s incident bundles {rec['leader_bundles']}; published "
                  f"{rec['published_incidents']}")
            bad = probe.stop()
            check(not bad and probe.n > 0,
                  f"{name}: the apiserver's /healthz answered {bad[:3]} of {probe.n}")
            rcs = {standby_id: standby.terminate(), "apiserver": apiserver.terminate()}
            check(all(rc == 0 for rc in rcs.values()), f"{name}: exit codes on SIGTERM {rcs}")
            out.update(leader=leader_id, standby=standby_id, b_launches=b_launches,
                       leader_status=leader_status, standby_status=standby_status,
                       lead_ms=lead_s * 1e3, arrivals_bound_ms=(t_bound - t_kill) * 1e3,
                       arrival_digest=digest, healthz_probes=probe.n, sigterm_rcs=rcs, obs=rec)
            print(f"{name}: {leader_id} SIGKILLed; {standby_id} took the lease after "
                  f"{out['lead_ms']:.3f} ms (limit {limit * 1e3:.0f}) and bound the {n_new} "
                  f"arrivals at store truth {out['arrivals_bound_ms']:.3f} ms after the kill "
                  f"(created in {out['arrivals_create_ms']:.3f} ms), digest == ARRIVAL_DIGESTS, "
                  f"{b_launches} session kernel launches in {standby_id}; the apiserver's /healthz "
                  f"200 {probe.n} times; {standby_id} and the apiserver exited {rcs} on SIGTERM; "
                  f"card {card}")
    finally:
        if probe is not None:
            probe.stop()
        if tap is not None:
            tap.close()
        if client is not None:
            client.close()
        for c in children:
            c.close()
        for d in incident_dirs.values():
            shutil.rmtree(d, ignore_errors=True)
    out["phase_ms"] = (time.perf_counter() - t_phase) * 1e3
    gc.collect()
    print(json.dumps({"bus": out}))
    return out


# ---- the durable, replicated store: three apiserver replicas, a leader kill ----

#: the replicated store's cell (``phase_ha``): SECOND_CONFIG's cluster,
#: the bus cell's size, in three apiserver replicas on data directories
#: of their own, one scheduler child binding it over the endpoint list;
#: the leader replica SIGKILLed, the arrivals bound, the replica restarted
HA_CELL = "ha_10k_pods_1k_nodes_leader_kill"
HA_REPLICAS = 3
#: the replicas' ``--repl-lease-ttl`` (the binary's default)
HA_LEASE_S = 2.0
#: one probe round of an election: ``bus/replication.probe_status``'s
#: timeout, what one unanswered probe of a peer can take
HA_PROBE_ROUND_S = 1.5
#: the replicas' ``--snapshot-every``: at the binary's 256 every replica
#: rewrites its whole store every 256 records (a rotation of the seeded
#: cell, 13,501 objects, took 1,931.9 ms beside an NVIDIA H100 80GB HBM3
#: at 700 W, ``wal_costs``), 52 times over while the cell is seeded
HA_SNAPSHOT_EVERY = 4096
#: client threads creating the pods and pod groups: creates through the
#: group wait on the quorum one at a time, and concurrent ones share a
#: follower's pull, apply and fsync.  Their order is free: the store's
#: digest does not depend on it (tests/test_torch_replication.py); the
#: priority classes, nodes and queues go in order
HA_SEED_THREADS = 16


def free_ports(n: int) -> list:
    """``n`` free ports below the kernel's ephemeral range (each bound
    and closed to check): a replica restarted on its port must find it
    free, and a port of the ephemeral range may meanwhile have become
    the local end of one of the many connections the run opens."""
    import random
    import socket

    with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
        low = int(f.read().split()[0])
    candidates = list(range(10_000, low))
    random.Random(os.getpid()).shuffle(candidates)
    out = []
    for port in candidates:
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        out.append(port)
        if len(out) == n:
            return out
    check(False, f"no {n} free ports below {low}")


def shm_rings(pid: int, directory: str) -> list:
    """The shm ring files (``c2s-*.ring``, ``s2c-*.ring``) under
    ``directory`` that process ``pid`` has mapped, by basename, one entry
    a mapping: ``bus/shm.py`` unlinks a pair once both ends have mapped
    it, so a process's maps are where its rings show."""
    root = os.path.realpath(directory) + os.sep
    out = []
    with open(f"/proc/{pid}/maps") as f:
        for line in f:
            parts = line.split(None, 5)
            path = parts[5].strip() if len(parts) == 6 else ""
            path = path[:-len(" (deleted)")] if path.endswith(" (deleted)") else path
            if path.startswith(root) and path.endswith(".ring"):
                out.append(os.path.basename(path))
    return sorted(out)


def fsync_probe(directory: str, n: int = 200, nbytes: int = 1024) -> dict:
    """The host's fsync cost where the replicas keep their WALs: ``n``
    appends of ``nbytes`` to a file in ``directory``, each flushed and
    fsynced as ``bus/wal.py`` does a record; p50, p99 and max ms."""
    import tempfile

    fd, path = tempfile.mkstemp(dir=directory, suffix=".probe")
    times = []
    try:
        with os.fdopen(fd, "wb") as f:
            for _ in range(n):
                f.write(b"x" * nbytes)
                f.flush()
                t0 = time.perf_counter()
                os.fsync(f.fileno())
                times.append((time.perf_counter() - t0) * 1e3)
    finally:
        os.unlink(path)
    times.sort()
    return dict(n=n, bytes=nbytes, p50_ms=times[n // 2], p99_ms=times[int(n * 0.99)],
                max_ms=times[-1])


def wal_costs(card: str) -> dict:
    """The durable store's host costs beside the card, by hand (not part
    of the run): the fsync probe, SECOND_CONFIG seeded into one
    in-process ``PersistentAPIServer`` (no snapshot rotation), one
    4,096-bind ``commit_batch`` on it (the leader's half of a commit
    frame), a second store applying that record as a follower does, and
    one snapshot of the whole store.  A ``{"wal_costs": ...}`` line."""
    import shutil
    import tempfile

    from volcano_tpu_torch.bus.wal import WAL_FILE, PersistentAPIServer, read_records

    base = tempfile.mkdtemp(prefix="vtpu-wal-")
    try:
        objects = loop_objects(SECOND_CONFIG)
        out = dict(card=card, fsync_1k=fsync_probe(base),
                   fsync_4m=fsync_probe(base, n=20, nbytes=4 << 20))
        leader = PersistentAPIServer(os.path.join(base, "leader"), snapshot_every=1 << 30)
        t0 = time.perf_counter()
        seed_store(leader, objects)
        out["seed_ms_per_create"] = (time.perf_counter() - t0) / sum(map(len, objects)) * 1e3
        binds = [{"namespace": p.metadata.namespace, "name": p.metadata.name,
                  "hostname": "node-1"} for p in objects[1][:4096]]
        t0 = time.perf_counter()
        leader.commit_batch(binds=binds)
        out["leader_frame_ms"] = (time.perf_counter() - t0) * 1e3
        records = read_records(os.path.join(leader.data_dir, WAL_FILE))[0]
        follower = PersistentAPIServer(os.path.join(base, "follower"), snapshot_every=1 << 30)
        for rec in records[:-1]:
            follower.apply_replica_record(rec, sync=False)
        t0 = time.perf_counter()
        follower.apply_replica_record(records[-1])
        out.update(follower_apply_ms=(time.perf_counter() - t0) * 1e3,
                   frame_record_bytes=len(records[-1]))
        t0 = time.perf_counter()
        follower.snapshot_now()
        out.update(snapshot_ms=(time.perf_counter() - t0) * 1e3,
                   snapshot_objects=sum(map(len, objects)),
                   snapshot_bytes=os.path.getsize(os.path.join(follower.data_dir,
                                                               "snapshot.json")))
        leader.close()
        follower.close()
    finally:
        shutil.rmtree(base, ignore_errors=True)
    print(json.dumps({"wal_costs": out}))
    return out


class _Listing:
    """A store read over the wire as ``bus.wal.store_digest`` reads a
    store: its lists (a replica serves them from its own store)."""

    def __init__(self, client):
        self.client = client

    def locked(self):
        return contextlib.nullcontext()

    def list(self, kind: str):
        return self.client.list(kind)


def replica_digests(endpoints, timeout: float = 120.0) -> dict:
    """Each replica's ``store_digest`` over its own lists, once every
    replica reports the same applied sequence and while it stays so (a
    quiescent group: the caller has stopped the writers); the run fails
    when they do not agree within ``timeout``."""
    import threading

    from volcano_tpu_torch.bus import RemoteAPIServer
    from volcano_tpu_torch.bus.replication import probe_status
    from volcano_tpu_torch.bus.wal import store_digest

    t0 = time.monotonic()
    while True:
        seqs = [(probe_status(u) or {}).get("seq") for u in endpoints]
        digests = {}
        if None not in seqs and len(set(seqs)) == 1:
            def read(url: str) -> None:
                client = RemoteAPIServer(url, timeout=60.0)
                try:
                    if client.wait_ready(30):
                        digests[url] = store_digest(_Listing(client))
                finally:
                    client.close()

            readers = [threading.Thread(target=read, args=(u,)) for u in endpoints]
            for r in readers:
                r.start()
            for r in readers:
                r.join()
            after = [(probe_status(u) or {}).get("seq") for u in endpoints]
            if after == seqs and len(digests) == len(endpoints) and len(set(digests.values())) == 1:
                return dict(seq=seqs[0], digests=digests)
        check(time.monotonic() - t0 < timeout,
              f"replicas not converged in {timeout} s: seqs {seqs}, digests {digests}")
        time.sleep(0.5)


def create_through_failover(api, objects, threads: int = 1, timeout: float = 120.0) -> tuple:
    """``create_objects`` through a replicated group's client from
    ``threads`` threads (thread i the objects i, i + threads, ...).  A
    create is retried while the group answers ``NotLeaderError`` (a write
    refused before it reached a store: no leader known yet, or the
    follower's link to the new one not up) or the client's connection to
    a killed replica fails under it (``BusError``); an ``AlreadyExists``
    on a retry is the earlier attempt's write, which landed (the
    reference soak's at-least-once rule).  (seconds, retries)."""
    import copy
    import threading

    from volcano_tpu_torch.bus.protocol import BusError, NotLeaderError
    from volcano_tpu_torch.client.apiserver import AlreadyExistsError

    t0, retries, errors = time.perf_counter(), [0] * threads, []

    def run(i: int) -> None:
        try:
            for obj in objects[i::threads]:
                obj = copy.copy(obj)
                obj.metadata = copy.copy(obj.metadata)
                tried = False
                while True:
                    try:
                        api.create(obj)
                        break
                    except AlreadyExistsError:
                        if not tried:
                            raise
                        break
                    except (NotLeaderError, BusError):
                        tried = True
                        retries[i] += 1
                        if time.perf_counter() - t0 > timeout:
                            raise
                        time.sleep(0.05)
        except Exception as e:  # noqa: BLE001 — reported by the caller's check
            errors.append(repr(e))

    workers = [threading.Thread(target=run, args=(i,)) for i in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    check(not errors, f"creates through the group failed: {errors[:3]}")
    return time.perf_counter() - t0, sum(retries)


def seed_group(api, objects, threads: int = HA_SEED_THREADS) -> float:
    """``seed_store`` through a replicated group: priority classes and
    nodes in order, the pods and pod groups from ``threads`` threads,
    then the queues; the seconds it took."""
    nodes, pods, pod_groups, queues, *rest = objects
    t0 = time.perf_counter()
    create_objects(api, list(rest[0] if rest else ()) + list(nodes))
    create_through_failover(api, list(pods) + list(pod_groups), threads)
    create_objects(api, queues)
    return time.perf_counter() - t0


def repl_metrics(body: str) -> dict:
    """A replica's durability series from its /metrics text: fsyncs and
    quorum waits (count, mean ms), lag, WAL bytes."""
    out = {}
    for key, series in (("fsync", "volcano_wal_fsync_latency_milliseconds"),
                        ("quorum_wait", "volcano_repl_quorum_wait_milliseconds")):
        n = metric_sum(body, series + "_count")
        out[key] = dict(n=n, mean_ms=metric_sum(body, series + "_sum") / max(n, 1.0))
    out.update(lag_entries=metric_sum(body, "volcano_repl_lag_entries"),
               wal_bytes=metric_sum(body, "volcano_wal_size_bytes"))
    return out


def failover_checked(child: "Binary", port: int, what: str, paused=(0, 0)):
    """``child_checked`` across a store failover: a PodGroup status
    writeback the group refused while it had no reachable leader (its
    frame answered ``NotLeaderError``), or whose connection to the killed
    leader failed under it (the send, or the connection before the
    answer), is allowed and counted (the next cycle writes it again), and
    so is one that timed out at the end of the pause ``paused`` (the
    child's log between those offsets: a call in flight when the child
    was stopped finds its deadline gone when it resumes); any other
    commit failure is not."""
    status = child.status()
    _, body = http_get(port, "/metrics")
    body = body.decode()
    failures = {m: metric_sum(body, m) for m in ("volcano_executor_failures_total",)}
    failures.update({k: metric_sum(body, "volcano_commit_failures_total", kind=k)
                     for k in ("bind", "evict")})
    text = child.text()
    pause = text[paused[0]:paused[1]]
    refused = [line for line in text.splitlines() if "writeback" in line and "failed" in line]
    check(status["failed_cycles"] == 0 and "cycle failed" not in text
          and status["resync"] == 0 and status["quarantined"] == 0 and not any(failures.values())
          and all(any(why in line for why in ("leader", "connection lost", "send failed"))
                  or ("timed out" in line and line in pause) for line in refused)
          and len(refused) == metric_sum(body, "volcano_commit_failures_total", kind="status"),
          f"{what}: status {status}, {failures}, refused writebacks {refused[:5]}:\n"
          f"{child.tail()}")
    return status, body


def phase_ha(card: str) -> dict:
    """The durable, replicated store on the card (``HA_CELL``): three
    ``python -m volcano_tpu_torch.cmd.apiserver --data-dir D_i --replicas
    E --replica-index i --repl-lease-ttl 2.0 --snapshot-every 4096``
    children elect one leader; this process seeds SECOND_CONFIG's cluster
    through the port's ``RemoteAPIServer`` given all three endpoints
    (``seed_group``: every create fsynced and quorum-committed, the pods
    and pod groups from HA_SEED_THREADS threads); one ``python -m volcano_tpu_torch.cmd.scheduler
    --bus E --snapshot-reuse --pipelined-commit --warmup`` child on the
    card binds it, read back from a follower with STORE_DIGESTS' digest,
    the three replicas' ``store_digest`` equal.  The leader replica is
    SIGKILLed: a survivor must lead within the lease TTL plus one probe
    round; the arrivals, created through the group, bind with
    ARRIVAL_DIGESTS' digest while the scheduler's ``bus_relists_total``
    stays flat (a PodGroup status writeback refused for want of a leader,
    lost with the killed leader's connection, or timed out by the pause
    of the digest reads, is counted and allowed: the next cycle writes
    it again), and
    the scheduler exits 0 on SIGTERM.  The killed replica restarts from its data directory,
    recovers and rejoins as a follower; the three digests are equal again
    and ``vtctl --bus ... bus status`` shows one leader and two followers
    at lag 0.  The session kernel launched in the scheduler child's
    cycles (its count less its warmup's, 3 a cycle that binds), no child
    dies, every child exits 0 on SIGTERM.  The fsync and quorum waits are
    printed, not bound.  One ``{"ha": ...}`` line."""
    import gc
    import io
    import re
    import shutil
    import signal
    import tempfile

    from volcano_tpu_torch.bus import RemoteAPIServer
    from volcano_tpu_torch.bus.replication import probe_status
    from volcano_tpu_torch.cli.vtctl import main as vtctl

    name, config = HA_CELL, SECOND_CONFIG
    t_phase = time.perf_counter()
    objects = loop_objects(config)
    n_pods, n_objects = len(objects[1]), sum(len(objs) for objs in objects)
    base = tempfile.mkdtemp(prefix="vtpu-ha-")
    ports = free_ports(HA_REPLICAS)
    endpoints = [f"tcp://127.0.0.1:{p}" for p in ports]
    bus = ",".join(endpoints)
    out = dict(cell=name, config=config, card=card, replicas=HA_REPLICAS, lease_s=HA_LEASE_S)
    children, clients = [], []
    reps, metrics_ports = {}, {}

    def start_replica(i: int):
        b = Binary("volcano_tpu_torch.cmd.apiserver",
                   ["--port", str(ports[i]), "--listen-port", "0",
                    "--data-dir", os.path.join(base, f"replica-{i}"), "--replicas", bus,
                    "--replica-index", str(i), "--repl-lease-ttl", str(HA_LEASE_S),
                    "--snapshot-every", str(HA_SNAPSHOT_EVERY)])
        children.append(b)
        reps[i] = b
        return b

    def roles(indices) -> dict:
        return {i: (probe_status(endpoints[i]) or {}).get("role", "down") for i in indices}

    def dead():
        return [c.name for c in children if c in reps.values() and not c.alive()] or None

    def client_of(address: str):
        c = RemoteAPIServer(address, timeout=60.0)
        clients.append(c)
        check(c.wait_ready(30), f"{name}: {address} did not answer")
        return c

    try:
        for i in range(HA_REPLICAS):
            start_replica(i)
        for i in range(HA_REPLICAS):
            metrics_ports[i] = int(reps[i].wait_log(r"metrics on :(\d+), replica").group(1))
        elect_s = wait_for(lambda: sorted(roles(range(HA_REPLICAS)).values())
                           == ["follower", "follower", "leader"], CHILD_START_S,
                           f"{name}: one leader and two followers", failed=dead, interval=0.1)
        leader_i = next(i for i, r in roles(range(HA_REPLICAS)).items() if r == "leader")
        client = client_of(bus)
        seed_s = seed_group(client, objects)
        out.update(elect_s=elect_s, seed_s=seed_s, creates_per_s=n_objects / seed_s,
                   seed_threads=HA_SEED_THREADS, codec=client.codec,
                   fsync_probe=fsync_probe(base))
        print(f"{name}: {HA_REPLICAS} replicas elected apiserver-{leader_i} in {elect_s:.3f} s; "
              f"seeded {n_objects} objects through the group in {seed_s:.3f} s "
              f"({out['creates_per_s']:.1f} creates/s under the quorum, {HA_SEED_THREADS} "
              f"threads); fsync of 1 KiB in the data directories' file system "
              f"{out['fsync_probe']}; card {card}")
        # the audit reads a follower that the kill spares
        audit_i = next(i for i in range(HA_REPLICAS) if i != leader_i)
        audit_client = client_of(endpoints[audit_i])
        audit = StoreAudit(audit_client)
        check(audit_client.wait_synced(60), f"{name}: the audit's watch did not sync")
        with policy_file(CYCLE_TIERS, ("gpu-allocate",)) as path:
            sched = Binary("volcano_tpu_torch.cmd.scheduler",
                           ["--bus", bus, "--snapshot-reuse", "--pipelined-commit", "--warmup",
                            "--scheduler-conf", path, "--listen-port", "0"])
            children.append(sched)
            s_port = int(sched.wait_log(r"serving on :(\d+)").group(1))
            t0 = time.perf_counter()
            t_settle = wait_for(lambda: store_settled(audit_client, audit, n_pods), SETTLE_S,
                                f"{name}: the cluster bound, read from a follower",
                                failed=lambda: None if sched.alive() else sched.tail(),
                                interval=0.5)
            digest = audit.digest()
            check(digest == STORE_DIGESTS[config],
                  f"{name}: store digest {digest} != the JAX package's {STORE_DIGESTS[config]}")
            status0, body = child_checked(sched, s_port, f"{name}: the scheduler after its binds")
            launches0 = cycle_launches(status0)
            check(launches0 > 0 and launches0 % 3 == 0,
                  f"{name}: session kernel launches in the scheduler's cycles {launches0}")
            relists0 = metric_sum(body, "volcano_bus_relists_total")
            commit_ms = metric_sum(body, "volcano_bus_request_latency_milliseconds_sum",
                                   method="commit_batch")
            frame_binds = metric_sum(body, "volcano_bind_coalesce_size_sum")
            # the scheduler rewrites every PodGroup's status each cycle (the
            # reference's JobUpdater: a Running group has no recorded status
            # to compare with), so it is paused while the replicas are read
            pause_from = len(sched.text())
            sched.proc.send_signal(signal.SIGSTOP)
            try:
                converged = replica_digests(endpoints)
            finally:
                sched.proc.send_signal(signal.SIGCONT)
            time.sleep(1.0)
            paused = (pause_from, len(sched.text()))
            _, lbody = http_get(metrics_ports[leader_i], "/metrics")
            out.update(bound_s=t_settle, store_digest=digest, launches=launches0,
                       commit_frames=metric_sum(
                           body, "volcano_bus_request_latency_milliseconds_count",
                           method="commit_batch"),
                       commit_ms_per_bind=commit_ms / max(frame_binds, 1.0),
                       replica_digest=converged, leader_metrics=repl_metrics(lbody.decode()))
            print(f"{name}: the scheduler bound {n_pods} pods in {t_settle:.3f} s, read from "
                  f"apiserver-{audit_i} (a follower) with digest == STORE_DIGESTS, "
                  f"{out['commit_ms_per_bind']:.4f} ms a bind in {out['commit_frames']:.0f} "
                  f"commit frames, {launches0} session kernel launches; the three replicas' "
                  f"store_digest equal at seq {converged['seq']}; the leader's fsync and quorum "
                  f"wait {out['leader_metrics']}; card {card}")

            survivors = [i for i in range(HA_REPLICAS) if i != leader_i]
            reps[leader_i].proc.kill()
            reps[leader_i].proc.wait(timeout=60)
            t_kill = time.monotonic()
            wait_for(lambda: "leader" in roles(survivors).values(), 30.0,
                     f"{name}: a survivor leading after apiserver-{leader_i}'s SIGKILL",
                     interval=0.01)
            lead_s = time.monotonic() - t_kill
            limit = HA_LEASE_S + HA_PROBE_ROUND_S
            new_i = next(i for i, r in roles(survivors).items() if r == "leader")
            check(lead_s <= limit, f"{name}: apiserver-{new_i} led {lead_s:.3f} s after the "
                                   f"SIGKILL, limit {limit} s")
            arrivals = arrival_objects()
            # the pods and pod groups from the seed's threads, the queue
            # that admits them last
            create_s, retries = create_through_failover(client, arrivals[:-1], HA_SEED_THREADS)
            create_objects(client, arrivals[-1:])
            n_new = ARRIVALS["jobs"]
            wait_for(lambda: len(arrival_binds(audit, arrivals)) == n_new, SETTLE_S,
                     f"{name}: the arrivals bound after the failover",
                     failed=lambda: None if sched.alive() else sched.tail())
            bound_ms = (time.monotonic() - t_kill) * 1e3
            digest = cycle_digest(arrival_binds(audit, arrivals))
            check(digest == ARRIVAL_DIGESTS[config],
                  f"{name}: arrivals digest {digest} != the JAX package's "
                  f"{ARRIVAL_DIGESTS[config]}")
            check(audit.events.get("Scheduled") == [n_pods + n_new, 0] and not audit.rebinds,
                  f"{name}: Scheduled Events {audit.events.get('Scheduled')}, rebinds "
                  f"{audit.rebinds[:3]}")
            wait_for(lambda: store_settled(audit_client, audit, n_pods + n_new), SETTLE_S,
                     f"{name}: every PodGroup Running after the failover",
                     failed=lambda: None if sched.alive() else sched.tail(), interval=0.5)
            status1, body = failover_checked(sched, s_port, f"{name}: the scheduler after the "
                                                            f"arrivals", paused)
            launches1 = cycle_launches(status1) - launches0
            check(launches1 > 0 and launches1 % 3 == 0,
                  f"{name}: session kernel launches after the failover {launches1}")
            relists1 = metric_sum(body, "volcano_bus_relists_total")
            check(relists1 == relists0, f"{name}: the scheduler relisted across the failover: "
                                        f"bus_relists_total {relists0} -> {relists1}")
            _, nbody = http_get(metrics_ports[new_i], "/metrics")
            reconnects = metric_sum(body, "volcano_bus_reconnects_total")
            rcs = {"scheduler": sched.terminate()}
            out.update(killed=leader_i, new_leader=new_i, takeover_ms=lead_s * 1e3,
                       scheduler_reconnects=reconnects,
                       status_writebacks_refused=metric_sum(
                           body, "volcano_commit_failures_total", kind="status"),
                       takeover_limit_ms=limit * 1e3, arrivals_create_ms=create_s * 1e3,
                       arrivals_retries=retries, arrivals_bound_ms=bound_ms,
                       arrival_digest=digest, launches_after=launches1, relists=relists1,
                       new_leader_metrics=repl_metrics(nbody.decode()))
            print(f"{name}: apiserver-{leader_i} SIGKILLed; apiserver-{new_i} led after "
                  f"{lead_s * 1e3:.1f} ms (limit {limit * 1e3:.0f}); the {n_new} arrivals created "
                  f"through the group in {create_s * 1e3:.1f} ms ({retries} NotLeaderError "
                  f"retries) and bound {bound_ms:.1f} ms after the kill, digest == "
                  f"ARRIVAL_DIGESTS, {launches1} launches, bus_relists_total flat at {relists1}; "
                  f"card {card}")

            t0 = time.perf_counter()
            reborn = start_replica(leader_i)
            m = reborn.wait_log(r"store recovered from \S+ in ([\d.]+) ms: snapshot (\w+), "
                                r"(\d+) WAL records, torn tail (\w+), seq (\d+)")
            metrics_ports[leader_i] = int(reborn.wait_log(r"metrics on :(\d+), replica").group(1))
            wait_for(lambda: roles([leader_i])[leader_i] == "follower", CHILD_START_S,
                     f"{name}: apiserver-{leader_i} rejoining as a follower", failed=dead)
            converged = replica_digests(endpoints)
            rejoin_s = time.perf_counter() - t0
            texts = {}
            for i in range(HA_REPLICAS):
                buf = io.StringIO()
                check(vtctl(["--bus", endpoints[i], "bus", "status"], out=buf) == 0,
                      f"{name}: vtctl bus status on apiserver-{i}")
                texts[i] = buf.getvalue()
            shown = {i: re.search(r"^Role:\s+(\S+)", t, re.M).group(1) for i, t in texts.items()}
            rows = re.findall(r"^  (apiserver-\d+)\s+(\d+)\s+(\d+)\s", texts[new_i], re.M)
            check(sorted(shown.values()) == ["follower", "follower", "leader"]
                  and shown[new_i] == "leader" and len(rows) == 2
                  and all(lag == "0" for _fid, _acked, lag in rows),
                  f"{name}: vtctl bus status: {shown}, followers {rows}:\n{texts[new_i]}")
            print(texts[new_i], end="")
            out.update(recovery_ms=float(m.group(1)), recovery_snapshot=m.group(2) == "True",
                       records_replayed=int(m.group(3)), recovery_torn=m.group(4) == "True",
                       recovered_seq=int(m.group(5)), rejoin_s=rejoin_s,
                       replica_digest_after=converged, vtctl_roles=shown, vtctl_followers=rows)
            print(f"{name}: apiserver-{leader_i} recovered {out['records_replayed']} WAL records "
                  f"(snapshot {out['recovery_snapshot']}, torn tail {out['recovery_torn']}) to "
                  f"seq {out['recovered_seq']} in {out['recovery_ms']:.1f} ms and rejoined as a "
                  f"follower; the three store_digests equal at seq {converged['seq']} "
                  f"{rejoin_s:.3f} s after its restart; card {card}")
            check(not dead(), f"{name}: a replica died: {dead()}")
            rcs.update({f"apiserver-{i}": reps[i].terminate() for i in range(HA_REPLICAS)})
            check(all(rc == 0 for rc in rcs.values()), f"{name}: exit codes on SIGTERM {rcs}")
            out["sigterm_rcs"] = rcs
    finally:
        for c in clients:
            c.close()
        for c in children:
            c.close()
        shutil.rmtree(base, ignore_errors=True)
    out["phase_ms"] = (time.perf_counter() - t_phase) * 1e3
    gc.collect()
    print(json.dumps({"ha": out}))
    return out


# ---- the Job path: admission, the controllers, the scheduler, a kubelet ----

FED_ONE_CELL = "federation_50k_pods_10k_nodes_one_shard"
FED_TWO_CELL = "federation_10k_pods_1k_nodes_two_shards"
#: the one-shard member's lease TTL: the scheduler binary's
#: ``--shard-lease-duration`` default (a renew the store lock holds back
#: behind the 50k-bind frames lands late, and there is no peer)
FED_ONE_LEASE_S = 2.0
#: the two members' lease TTL and retry period.  The members, their
#: relists and bind frames and the bus server share one process and one
#: store lock: at 2.0 s both members stepped down turn after turn with
#: the relist off the lease thread too (a renew's read of the shard map
#: waited up to 1.6 s behind a relist's lists at half the cell on the
#: CPU; the store lock past the lease is ROADMAP open work 8)
FED_LEASE_S = 10.0
FED_RETRY_S = 0.2
#: the survivor holds both shards in the shard map within one TTL plus
#: one retry period of member 1's last renew: the period at its longest
#: jitter (x1.25), and FED_TICK_S for the survivor's tick in flight at
#: the expiry and its claiming tick, each a read and a CAS over the wire
#: (the phase prints the renew latencies this was set against)
FED_TICK_S = 0.1
FED_TAKEOVER_S = FED_LEASE_S + 1.25 * FED_RETRY_S + FED_TICK_S
#: a gang task and a burst pod ask for just over half a node's cpu, so
#: at most one fits a node; the gang's minMember is the larger shard's
#: fitting nodes plus FED_GANG_FOREIGN, each foreign claim from the
#: other member's sketch (its 8 freest nodes)
FED_TASK_CPU_MILLI = 33_000
FED_GANG_FOREIGN = 4
FED_BURST = 4
#: rounds (each member's ``run_once`` in turn) a step may take
FED_ROUNDS = 8


def fed_conf(path: str):
    """``FederatedScheduler`` of the port with the cycle cells' policy."""
    from volcano_tpu_torch.federation import FederatedScheduler

    return lambda api, ident, n, **kw: FederatedScheduler(api, ident, n,
                                                          scheduler_conf_path=path, **kw)


def fed_cycle(member) -> dict:
    """One ``run_once`` of a federation member, its session kernel
    launches counted (set to 0 just before, read just after) and
    gpu-allocate's executor."""
    import torch

    from volcano_tpu_torch.ops import session_kernel
    from volcano_tpu_torch.ops.executor import last_allocate_executor

    torch.cuda.synchronize()
    session_kernel.LAUNCHES = session_kernel.WIDE_LAUNCHES = 0
    t0 = time.perf_counter()
    member.scheduler.run_once()
    ms = (time.perf_counter() - t0) * 1e3
    return dict(launches=session_kernel.LAUNCHES + session_kernel.WIDE_LAUNCHES,
                executor=last_allocate_executor(), run_once_ms=ms)


def fed_cached(member, names) -> bool:
    """Are all of ``names`` (pod names) pending tasks in ``member``'s
    cache, each in a job with its PodGroup (what its next cycle places)?"""
    want = set(names)
    seen = {t.name for e in member.cache.pending_spill_view() for t in e["tasks"]}
    return want <= seen


def fed_free(api) -> dict:
    """node → free cpu milli and pod slots, from the store's pods."""
    from volcano_tpu_torch.api.job_info import pod_request_resource
    from volcano_tpu_torch.api.resource import Resource

    free = {}
    for n in api.list("Node"):
        alloc = Resource.from_resource_list(n.status.allocatable)
        free[n.metadata.name] = [alloc.get("cpu"), alloc.max_task_num]
    for p in api.list("Pod"):
        if p.spec.node_name and p.status.phase not in ("Succeeded", "Failed"):
            f = free[p.spec.node_name]
            f[0] -= pod_request_resource(p).get("cpu")
            f[1] -= 1
    return free


def fed_job(name: str, replicas: int, min_member: int) -> list:
    """A gang of ``replicas`` FED_TASK_CPU_MILLI pods in namespace bench,
    queue default, its PodGroup Inqueue (the cycle cells' policy has no
    enqueue): the PodGroup, then the pods."""
    from volcano_tpu_torch.apis import core, scheduling

    pg = scheduling.PodGroup(
        metadata=core.ObjectMeta(name=name, namespace="bench", uid=f"pg-{name}"),
        spec=scheduling.PodGroupSpec(min_member=min_member, queue="default", min_resources={}),
        status=scheduling.PodGroupStatus(phase=scheduling.POD_GROUP_INQUEUE))
    pods = [core.Pod(
        metadata=core.ObjectMeta(name=f"{name}-t{i}", namespace="bench", uid=f"pod-{name}-{i}",
                                 annotations={scheduling.GROUP_NAME_ANNOTATION_KEY: name}),
        spec=core.PodSpec(containers=[core.Container(name="main", resources={"requests": {
            "cpu": f"{FED_TASK_CPU_MILLI}m", "memory": "1024Mi"}})], node_name=""),
        status=core.PodStatus(phase="Pending")) for i in range(replicas)]
    return [pg] + pods


def fed_rounds(members, done, what: str) -> list:
    """Rounds of every live member's ``fed_cycle`` until ``done()``; the
    rounds' records (FED_ROUNDS at most, else the run fails), each
    printed."""
    rounds = []
    for k in range(FED_ROUNDS):
        rounds.append({m.identity: fed_cycle(m) for m in members if not m._crashed})
        print(f"{what}: round {k}: " + "; ".join(
            f"{ident} run_once {r['run_once_ms']:.1f} ms, {r['launches']} launches"
            for ident, r in rounds[-1].items()))
        if done():
            return rounds
    check(False, f"{what}: not done in {FED_ROUNDS} rounds")
    return rounds


def phase_federation_one_shard(card: str) -> dict:
    """(a) ``FederatedScheduler(api, "fed-solo", 1)`` over an in-process
    ``APIServer`` holding MAIN_CONFIG's cluster (50k pods x 10k nodes),
    the store cell's policy, pipelined commit: its first cycle launches
    the session kernel 3 times on ``cuda`` and leaves the store at
    STORE_DIGESTS' digest (a one-shard federation is the plain
    scheduler), no rebind, no commit failure, no resync."""
    import gc

    from volcano_tpu_torch.client import APIServer

    t_phase = time.perf_counter()
    objects = loop_objects(MAIN_CONFIG)
    n_pods = len(objects[1])
    api = APIServer()
    audit = StoreAudit(api)
    t0 = time.perf_counter()
    seed_store(api, objects)
    seed_s = time.perf_counter() - t0
    del objects
    commit0, failures0 = commit_failures(), kernel_failures()
    with policy_file(CYCLE_TIERS, ("gpu-allocate",)) as path:
        member = fed_conf(path)(api, "fed-solo", 1, lease_duration=FED_ONE_LEASE_S,
                                lease_retry_period=FED_RETRY_S, pipelined_commit=True,
                                snapshot_reuse=True)
        try:
            t0 = time.perf_counter()
            member.start()
            check(member.wait_owned(60.0), f"{FED_ONE_CELL}: the member owns no shard")
            sync_s = time.perf_counter() - t0
            check(len(member.cache.nodes) == 10_000,
                  f"{FED_ONE_CELL}: {len(member.cache.nodes)} nodes in the member's cache")
            rec = fed_cycle(member)
            t0 = time.perf_counter()
            member.cache.flush()
            flush_s = time.perf_counter() - t0
            digest = audit.digest()
            what = f"{FED_ONE_CELL}: the member's first cycle"
            check(rec["executor"] == "cuda" and rec["launches"] == 3,
                  f"{what}: executor {rec['executor']!r}, {rec['launches']} launches")
            check(len(audit.bound) == n_pods and digest == STORE_DIGESTS[MAIN_CONFIG],
                  f"{what}: {len(audit.bound)} bound, store digest {digest} != the JAX "
                  f"package's {STORE_DIGESTS[MAIN_CONFIG]}")
            check(not audit.rebinds and commit_failures() == commit0
                  and kernel_failures() == failures0 and not member.cache.err_tasks
                  and not member.cache.quarantined_tasks,
                  f"{what}: {len(audit.rebinds)} rebinds, {commit_failures() - commit0:.0f} "
                  f"commit failures, {len(member.cache.err_tasks)} resync entries")
        finally:
            member.stop()
    out = dict(cell=FED_ONE_CELL, config=MAIN_CONFIG, card=card, seed_ms=seed_s * 1e3,
               start_ms=sync_s * 1e3, launches=rec["launches"], run_once_ms=rec["run_once_ms"],
               flush_ms=flush_s * 1e3, digest=digest, phase_ms=(time.perf_counter() - t_phase) * 1e3)
    print(f"{FED_ONE_CELL}: one member over the in-process store bound {n_pods} pods in its "
          f"first cycle ({rec['run_once_ms']:.3f} ms, the commit landed {flush_s * 1e3:.3f} ms "
          f"later), store digest == STORE_DIGESTS, {rec['launches']} session kernel launches "
          f"on cuda; card {card}")
    del member, audit, api
    gc.collect()
    return out


def phase_federation_two_shards(card: str) -> dict:
    """(b) SECOND_CONFIG's cluster (10k pods x 1k nodes) in an in-process
    ``APIServer`` behind an in-process ``BusServer``, two
    ``FederatedScheduler`` members each on a ``RemoteAPIServer`` of its
    own (the federation tests' topology), driven cycle by cycle, a
    ``StoreAudit`` on the store.  The members' slices are disjoint and
    cover all 1,000 nodes; each member's binding cycle launches the
    session kernel on ``cuda``; every pod binds exactly once.  A gang
    that no shard can host alone (FED_TASK_CPU_MILLI tasks, minMember
    the larger shard's fitting nodes + FED_GANG_FOREIGN) binds whole
    through the broker's ``txn_commit``
    (``volcano_gang_assemblies_total{result="committed"}``); a burst of
    FED_BURST such pods homed on the gang's (now full) shard spills
    through ``cas_bind`` onto the other shard
    (``volcano_spillover_binds_total{result="bound"}``);
    ``verify_federation`` is clean.  Then ``shard.kill`` fires in member
    1's post-cycle (crash mode): member 0 holds both shards in the shard
    map within FED_TAKEOVER_S of member 1's last renew, and binds the 1,000 arrivals, each once, no rebind,
    the kernel launched; ``verify_federation`` is clean again."""
    import gc

    from volcano_tpu_torch import faults, metrics
    from volcano_tpu_torch.bus import BusServer, RemoteAPIServer
    from volcano_tpu_torch.client import APIServer
    from volcano_tpu_torch.federation import read_shard_map, shard_of_node, verify_federation
    from volcano_tpu_torch.federation.sharding import home_shard

    name = FED_TWO_CELL
    t_phase = time.perf_counter()
    objects = loop_objects(SECOND_CONFIG)
    n_pods = len(objects[1])
    api = APIServer()
    audit = StoreAudit(api)
    seed_store(api, objects)
    node_names = [n.metadata.name for n in objects[0]]
    del objects
    bus = BusServer(api, port=0).start()
    url = f"tcp://127.0.0.1:{bus.port}"
    remotes, members = [], []
    out = dict(cell=name, config=SECOND_CONFIG, card=card, lease_s=FED_LEASE_S,
               retry_s=FED_RETRY_S)

    def counter(metric: str, result: str) -> float:
        return metrics.registry.counter(metric, result=result)

    gang0 = counter("volcano_gang_assemblies_total", "committed")
    spill0 = counter("volcano_spillover_binds_total", "bound")
    failures0, commit0 = kernel_failures(), commit_failures()
    try:
        with policy_file(CYCLE_TIERS, ("gpu-allocate",)) as path:
            make = fed_conf(path)
            t0 = time.perf_counter()
            # both members at once: the first to tick claims both shards,
            # and releases one when the other joins (release on join)
            for i in range(2):
                remote = RemoteAPIServer(url, timeout=60.0)
                check(remote.wait_ready(30), f"{name}: the bus did not answer")
                remotes.append(remote)
                members.append(make(remote, f"fed-{i}", 2, lease_duration=FED_LEASE_S,
                                    lease_retry_period=FED_RETRY_S, spill_after=0,
                                    gang_assemble_after=0, kill_mode="crash"))
            for m in members:
                m.start()

            def holders() -> dict:
                rec = read_shard_map(api) or {}
                return {int(i): e["holder"] for i, e in rec.get("shards", {}).items()}

            wait_for(lambda: sorted(holders().values()) == ["fed-0", "fed-1"], 60.0,
                     f"{name}: each member holding one shard", interval=0.02)
            out["form_ms"] = (time.perf_counter() - t0) * 1e3
            formed = holders()

            # the cluster binds, each member on its own slice
            t0 = time.perf_counter()
            rounds = fed_rounds(members, lambda: len(audit.bound) == n_pods,
                                f"{name}: the cluster's binds")
            out["bind_ms"] = (time.perf_counter() - t0) * 1e3
            first = rounds[0]
            for m in members:
                r = first[m.identity]
                check(r["executor"] == "cuda" and r["launches"] > 0,
                      f"{name}: {m.identity}'s binding cycle: executor {r['executor']!r}, "
                      f"{r['launches']} launches")
            out["launches"] = {m.identity: [r[m.identity]["launches"] for r in rounds]
                               for m in members}
            out["binding_run_once_ms"] = {m.identity: first[m.identity]["run_once_ms"]
                                          for m in members}
            # each cycle waited for its member's slice to be applied
            slices = [set(m.cache.nodes) for m in members]
            check(not (slices[0] & slices[1]) and slices[0] | slices[1] == set(node_names),
                  f"{name}: slices of {len(slices[0])} and {len(slices[1])} nodes, "
                  f"{len(slices[0] & slices[1])} shared, not covering the 1,000")
            out["nodes_owned"] = {m.identity: len(s) for m, s in zip(members, slices)}
            check({m.identity: m.state.owned() for m in members}
                  == {h: {i} for i, h in holders().items()},
                  f"{name}: shard map holders {holders()}, members own "
                  f"{[m.state.owned() for m in members]}")
            check(not audit.rebinds, f"{name}: rebinds {audit.rebinds[:3]}")
            by_shard = {}
            for key, node in audit.binds():
                s = shard_of_node(node, 2)
                by_shard[s] = by_shard.get(s, 0) + 1
            out["binds_by_shard"] = by_shard

            # a gang no shard hosts alone, through the broker's txn_commit
            free = fed_free(api)
            fits = {s: sum(1 for n, (cpu, slots) in free.items()
                           if shard_of_node(n, 2) == s and cpu >= FED_TASK_CPU_MILLI and slots > 0)
                    for s in (0, 1)}
            home = max((0, 1), key=lambda s: (fits[s], -s))
            mm = fits[home] + FED_GANG_FOREIGN
            check(fits[1 - home] >= FED_GANG_FOREIGN + FED_BURST and mm > fits[1 - home],
                  f"{name}: shards fit {fits} tasks of {FED_TASK_CPU_MILLI}m")
            gang = next(f"fedgang{k}" for k in range(64)
                        if home_shard("bench", f"fedgang{k}", 2) == home)
            gang_objs = fed_job(gang, mm, mm)
            create_objects(api, gang_objs)
            keys = [f"bench/{o.metadata.name}" for o in gang_objs[1:]]
            homer = next(m for m in members if m.state.owns_shard(home))
            wait_for(lambda: fed_cached(homer, [o.metadata.name for o in gang_objs[1:]]), 60.0,
                     f"{name}: the gang in {homer.identity}'s cache", interval=0.02)

            def gang_bound() -> bool:
                bound = sum(1 for k in keys if k in audit.bound)
                check(bound in (0, mm), f"{name}: the gang partly bound ({bound}/{mm})")
                return bound == mm

            t0 = time.perf_counter()
            rounds = fed_rounds([homer], gang_bound, f"{name}: the gang {gang}")
            out["gang"] = dict(min_member=mm, fits=fits, home=home, rounds=len(rounds),
                               ms=(time.perf_counter() - t0) * 1e3,
                               spans=sorted({shard_of_node(audit.bound[k], 2) for k in keys}))
            committed = counter("volcano_gang_assemblies_total", "committed") - gang0
            check(committed >= 1 and out["gang"]["spans"] == [0, 1],
                  f"{name}: gang assemblies committed {committed:.0f}, the gang on shards "
                  f"{out['gang']['spans']}")
            out["gang_assemblies"] = {m.identity: m.broker.counters() for m in members}

            # a burst homed on the gang's shard, now full: spilled through cas_bind
            burst, k = [], 0
            while len(burst) < FED_BURST:
                if home_shard("bench", f"fedburst{k}", 2) == home:
                    burst.append(f"fedburst{k}")
                k += 1
            burst_objs = [o for b in burst for o in fed_job(b, 1, 1)]
            create_objects(api, burst_objs)
            bkeys = [f"bench/{b}-t0" for b in burst]
            wait_for(lambda: fed_cached(homer, [f"{b}-t0" for b in burst]), 60.0,
                     f"{name}: the burst in {homer.identity}'s cache", interval=0.02)
            t0 = time.perf_counter()
            rounds = fed_rounds([homer], lambda: all(k in audit.bound for k in bkeys),
                                f"{name}: the burst")
            spilled = counter("volcano_spillover_binds_total", "bound") - spill0
            check(spilled >= FED_BURST and all(shard_of_node(audit.bound[k], 2) != home
                                               for k in bkeys),
                  f"{name}: {spilled:.0f} spillover binds, the burst on shards "
                  f"{[shard_of_node(audit.bound[k], 2) for k in bkeys]}")
            out["spill"] = dict(rounds=len(rounds), ms=(time.perf_counter() - t0) * 1e3,
                                binds=spilled, counters={m.identity: m.spillover.counters()
                                                         for m in members})
            report = verify_federation(api, 2, bind_history={k: [v] for k, v in audit.binds()})
            check(report["ok"] and not audit.rebinds,
                  f"{name}: verify_federation {report['violations'][:3]}, rebinds "
                  f"{audit.rebinds[:3]}")
            out["verify"] = report["checked"]

            check(holders() == formed, f"{name}: the shards moved from {formed} to "
                                       f"{holders()} before the kill")
            # shard.kill in member 1's post-cycle: member 0 takes both shards
            faults.configure("seed=1;shard.kill=1:count=1")
            try:
                fed_cycle(members[1])
            finally:
                faults.configure(None)
            t_kill = time.monotonic()
            check(members[1]._crashed, f"{name}: shard.kill did not fire in fed-1")
            last_renew = max(e["renewTime"] for e in read_shard_map(api)["shards"].values()
                             if e["holder"] == "fed-1")
            wait_for(lambda: set(holders().values()) == {"fed-0"}, FED_TAKEOVER_S,
                     f"{name}: fed-0 holding both shards after fed-1's crash", interval=0.005)
            out["takeover_ms"] = (time.time() - last_renew) * 1e3
            out["takeover_from_kill_ms"] = (time.monotonic() - t_kill) * 1e3
            check(out["takeover_ms"] <= FED_TAKEOVER_S * 1e3,
                  f"{name}: fed-0 held both shards {out['takeover_ms']:.1f} ms after fed-1's "
                  f"last renew (limit {FED_TAKEOVER_S * 1e3:.0f})")
            count, total = metrics.registry.histogram(
                "volcano_shard_lease_renew_latency_milliseconds")
            renew = metrics.registry.histogram_snapshot(
                "volcano_shard_lease_renew_latency_milliseconds")
            from volcano_tpu_torch.metrics.scrape import histogram_quantile

            out["renew_ms"] = dict(count=count, mean=total / max(count, 1),
                                   p99=histogram_quantile(renew, 0.99),
                                   max_le=next(le for le, c in renew["buckets"] if c == count))

            # the survivor binds the arrivals
            arrivals = arrival_objects()
            arrival_pods = [o for o in arrivals if o.kind == "Pod"]
            before = len(audit.bound)
            create_s = create_objects(api, arrivals)
            t0 = time.perf_counter()
            wait_for(lambda: fed_cached(members[0], [o.metadata.name for o in arrival_pods]),
                     60.0, f"{name}: the arrivals in fed-0's cache", interval=0.02)
            t1 = time.perf_counter()
            rounds = fed_rounds(members, lambda: len(arrival_binds(audit, arrivals))
                                == len(arrival_pods), f"{name}: the arrivals")
            out["arrivals"] = dict(
                pods=len(arrival_pods), create_ms=create_s * 1e3,
                cached_ms=(t1 - t0) * 1e3, bind_ms=(time.perf_counter() - t1) * 1e3,
                rounds=len(rounds),
                launches=[r["fed-0"]["launches"] for r in rounds])
            check(rounds[0]["fed-0"]["launches"] > 0 and rounds[0]["fed-0"]["executor"] == "cuda",
                  f"{name}: fed-0's arrivals cycle: {rounds[0]['fed-0']}")
            check(len(audit.bound) == before + len(arrival_pods) and not audit.rebinds,
                  f"{name}: {len(audit.bound) - before} arrivals bound, rebinds "
                  f"{audit.rebinds[:3]}")
            report = verify_federation(api, 2, bind_history={k: [v] for k, v in audit.binds()})
            check(report["ok"], f"{name}: verify_federation after the takeover "
                                f"{report['violations'][:3]}")
            check(kernel_failures() == failures0 and commit_failures() == commit0,
                  f"{name}: {kernel_failures() - failures0:.0f} kernel failures, "
                  f"{commit_failures() - commit0:.0f} commit failures")
    finally:
        for m in members:
            m.stop()
        for r in remotes:
            r.close()
        bus.stop()
    out["phase_ms"] = (time.perf_counter() - t_phase) * 1e3
    print(f"{name}: two members over one bus own {out['nodes_owned']} nodes, bound {n_pods} "
          f"pods once each (launches {out['launches']}); a gang of {mm} ({fits} fitting a task "
          f"by shard) committed whole through txn_commit across shards {out['gang']['spans']}; "
          f"{FED_BURST} burst pods spilled through cas_bind; fed-1 killed, fed-0 held both "
          f"shards {out['takeover_ms']:.1f} ms later (limit {FED_TAKEOVER_S * 1e3:.0f}) and "
          f"bound the {len(arrival_pods)} arrivals in {out['arrivals']['bind_ms']:.1f} ms; "
          f"verify_federation clean; card {card}")
    del members, remotes, audit, api
    gc.collect()
    return out


def phase_federation(card: str) -> dict:
    """The sharded scheduler federation on the card: (a)
    ``phase_federation_one_shard`` and (b) ``phase_federation_two_shards``,
    each with its ``time:`` line; one ``{"federation": ...}`` line with
    the card's name and power limit."""
    one = timed(phase_federation_one_shard, card)
    two = timed(phase_federation_two_shards, card)
    out = dict(card=card, one_shard=one, two_shards=two)
    print(json.dumps({"federation": out}))
    return out


JOB_CELL = "jobs_150x50_1k_nodes_lifecycle"
#: the Job path's cell: SECOND_CONFIG's 1,000 nodes (64 CPU, 256 GiB, 110
#: pods), queues ``default`` (weight 1) and ``q1`` (weight 3), wave 1 of
#: 100 Jobs x 50 tasks (min_available 50, cpu and memory drawn with
#: ``seed`` from the generator's choices, odd jobs in q1, every fourth
#: with the svc and env plugins, every eighth with ssh, the first half
#: with ``ttl_seconds_after_finished=0``), the lifecycle (the first half
#: succeeds and is reaped, one pod of job ``3 * wave1 // 4`` fails with
#: exit code 137 under PodFailed -> RestartJob, the next job is suspended
#: and resumed), then wave 2 of 50 more jobs.  Cut twice for the
#: script's time on an NVIDIA H100 80GB HBM3 at 700 W: wave 2 from 100
#: jobs when the whole script took 1,155 s, the cell 118.5 s of it; wave
#: 1 from 200 when the script took ~990 s with the cell at 93.2 s and the
#: full-session micro windows and the events-only journal were to return
JOB_CONFIG = dict(nodes=1000, wave1=100, wave2=50, tasks=50, seed=15)
#: the same at a tenth of its jobs and nodes (tier-1,
#: tests/test_torch_e2e.py)
JOB_SMALL = dict(nodes=100, wave1=20, wave2=10, tasks=50, seed=15)
#: the scheduler's policy in the cell: the daemon phases' headline tiers,
#: with enqueue before gpu-allocate, since the pod gate holds a job's pods
#: until enqueue moves its PodGroup to Inqueue
JOB_ACTIONS = ("enqueue", "gpu-allocate")
#: the GC's clock in the cell: a fixed instant past every transition, so
#: a finished job whose TTL is 0 is reaped at the controllers' next drain
JOB_GC_NOW = 4.0e9
#: sha256 of ``job_store_dump`` after the cell, from the JAX package's
#: controllers and daemon with jax-allocate on the CPU
#: (tests/test_torch_digests.py holds it, and the port's small cell)
JOB_DIGESTS = {
    JOB_CELL: "a847f1959964078df7b80834437fe1c1f40a99aa92dd7786f20b0301ff569832",
}
#: ticks a settle may take before the run fails
JOB_SETTLE_TICKS = 12


def port_job_pkg():
    """The port's pieces of the Job path, by the names ``JobCell`` uses
    (tests build the JAX package's the same way)."""
    from types import SimpleNamespace

    from volcano_tpu_torch.admission import register_webhooks
    from volcano_tpu_torch.apis import batch, core, scheduling
    from volcano_tpu_torch.cli.vtctl import main as vtctl
    from volcano_tpu_torch.client import (
        ADDED,
        MODIFIED,
        AdmissionError,
        APIServer,
        KubeClient,
        VolcanoClient,
    )
    from volcano_tpu_torch.cmd.controllers import ControllersDaemon
    from volcano_tpu_torch.cmd.scheduler import SchedulerDaemon

    return SimpleNamespace(
        batch=batch, core=core, scheduling=scheduling, APIServer=APIServer,
        KubeClient=KubeClient, VolcanoClient=VolcanoClient, ADDED=ADDED, MODIFIED=MODIFIED,
        AdmissionError=AdmissionError, register_webhooks=register_webhooks, vtctl=vtctl, ControllersDaemon=ControllersDaemon,
        SchedulerDaemon=SchedulerDaemon, allocate="gpu-allocate")


class FakeKubelet:
    """Runs bound pods: Pending + node -> Running; ``finish`` ends one
    (a copy of ``tests/test_e2e.py``'s, over package ``m``)."""

    def __init__(self, m, api):
        self.m, self.api = m, api
        self.kube = m.KubeClient(api)
        self._pending = []
        api.watch("Pod", self._on_pod)

    def _on_pod(self, event, old, new) -> None:
        if event in (self.m.ADDED, self.m.MODIFIED) and new is not None:
            if new.spec.node_name and new.status.phase == "Pending":
                self._pending.append((new.metadata.namespace, new.metadata.name))

    def drain(self) -> int:
        n = 0
        while self._pending:
            namespace, name = self._pending.pop()
            pod = self.kube.get_pod(namespace, name)
            if pod is not None and pod.spec.node_name and pod.status.phase == "Pending":
                pod.status.phase = "Running"
                self.kube.update_pod_status(pod)
                n += 1
        return n

    def finish(self, namespace: str, name: str, phase: str = "Succeeded", exit_code=None) -> None:
        pod = self.kube.get_pod(namespace, name)
        pod.status.phase = phase
        pod.status.exit_code = exit_code
        self.kube.update_pod_status(pod)


def job_specs(cfg: dict) -> list:
    """(name, queue, cpu m, memory Mi, plugins, ttl) of every job of the
    cell, wave 1 then wave 2."""
    n = cfg["wave1"] + cfg["wave2"]
    rng = np.random.RandomState(cfg["seed"])
    cpu = rng.choice([250, 500, 1000, 2000, 4000], size=n)
    mem = rng.choice([256, 512, 1024, 2048, 4096, 8192], size=n)
    out = []
    for i in range(n):
        plugins = {}
        if i % 4 == 0:
            plugins.update(svc=[], env=[])
        if i % 8 == 0:
            plugins["ssh"] = []
        out.append((f"job-{i:04d}", "q1" if i % 2 else "default", int(cpu[i]), int(mem[i]),
                    plugins, 0 if i < cfg["wave1"] // 2 else None))
    return out


def job_object(m, spec, tasks: int):
    """One job of the cell as package ``m``'s ``batch.Job``."""
    name, queue, cpu, mem, plugins, ttl = spec
    task = m.batch.TaskSpec(
        name="worker", replicas=tasks,
        template=m.core.PodTemplateSpec(spec=m.core.PodSpec(containers=[m.core.Container(
            image="registry.k8s.io/pause:3.9",
            resources={"requests": {"cpu": f"{cpu}m", "memory": f"{mem}Mi"}})])))
    return m.batch.Job(
        metadata=m.core.ObjectMeta(name=name, namespace="default"),
        spec=m.batch.JobSpec(
            min_available=tasks, tasks=[task], queue=queue, plugins=dict(plugins),
            ttl_seconds_after_finished=ttl,
            policies=[m.batch.LifecyclePolicy(event=m.batch.POD_FAILED_EVENT,
                                              action=m.batch.RESTART_JOB_ACTION)]))


def job_store_dump(api) -> dict:
    """What the cell's digest covers: every job's status (phase and
    counters, without its transition time), every pod's node and phase,
    every PodGroup's phase, the surviving Services and Secrets, every
    Event's count and message."""
    def key(o):
        return f"{o.metadata.namespace}/{o.metadata.name}"

    return {
        "jobs": {key(j): (j.status.state.phase, j.status.min_available, j.status.pending,
                          j.status.running, j.status.succeeded, j.status.failed,
                          j.status.terminating, j.status.unknown, j.status.version,
                          j.status.retry_count,
                          tuple(sorted(j.status.controlled_resources.items())))
                 for j in api.list("Job")},
        "pods": {key(p): (p.spec.node_name, p.status.phase) for p in api.list("Pod")},
        "pod_groups": {key(g): g.status.phase for g in api.list("PodGroup")},
        "services": {key(s): repr(s.spec) for s in api.list("Service")},
        "secrets": {key(s): (s.type, tuple(sorted(s.data.items()))) for s in api.list("Secret")},
        "events": {(e.metadata.namespace, e.involved_object.get("name"), e.type, e.reason):
                   (e.count, e.message) for e in api.list("Event")},
    }


def job_digest(dump: dict) -> str:
    import hashlib

    return hashlib.sha256(repr({k: sorted(v.items()) for k, v in dump.items()}).encode()
                          ).hexdigest()


def pods_within_allocatable(api) -> list:
    """Nodes whose bound, unfinished pods ask for more cpu, memory or pod
    slots than the node's allocatable (empty when every pod fits)."""
    from volcano_tpu_torch.apis.quantity import int_value, milli_value

    used = {}
    for p in api.list("Pod"):
        if not p.spec.node_name or p.status.phase in ("Succeeded", "Failed"):
            continue
        u = used.setdefault(p.spec.node_name, [0, 0, 0])
        for c in p.spec.containers:
            req = (c.resources or {}).get("requests", {})
            u[0] += milli_value(req.get("cpu", 0))
            u[1] += int_value(req.get("memory", 0))
        u[2] += 1
    over = []
    for n in api.list("Node"):
        a = n.status.allocatable
        u = used.get(n.metadata.name, [0, 0, 0])
        if (u[0] > milli_value(a["cpu"]) or u[1] > int_value(a["memory"])
                or u[2] > int_value(a["pods"])):
            over.append((n.metadata.name, u))
    return over


class JobCell:
    """The Job path of package ``m`` on one store, stepped in a fixed
    order: each ``tick`` is the controllers daemon's ``drain()`` (job,
    podgroup and queue controllers, then the GC), the scheduler daemon's
    ``run_once`` (its policy ``JOB_ACTIONS``, with ``m.allocate``), then
    the kubelet.  With ``device`` each tick sets the session kernel's
    launch counters to 0 just before ``run_once`` and reads them and
    gpu-allocate's device time just after.  Each tick appends a record to
    ``ticks``: each controller's drain ms, the queue controller's
    ``sync_queue`` calls and the store's ``list`` calls in the drain, the
    pod gate's denials (counted where the registered Pod hook raises),
    ``run_once`` ms, the kubelet's ms, pods created and binds.  The
    cell's own reads go past the ``list`` count."""

    def __init__(self, m, cfg: dict, conf_path: str, device: bool = False):
        self.m, self.cfg, self.device = m, cfg, device
        self.api = api = m.APIServer()
        self.lists = 0
        self.read = api.list

        def counted_list(*args, **kwargs):
            self.lists += 1
            return self.read(*args, **kwargs)

        api.list = counted_list
        for node in job_cell_nodes(cfg["nodes"]):
            api.create(m.core.Node.from_dict(node.to_dict()))
        vc = m.VolcanoClient(api)
        for name, weight in (("default", 1), ("q1", 3)):
            vc.create_queue(m.scheduling.Queue(metadata=m.core.ObjectMeta(name=name, namespace=""),
                                               spec=m.scheduling.QueueSpec(weight=weight)))
        self.denials = 0
        register = api.register_admission
        api.register_admission = lambda kind, operation, hook: register(
            kind, operation, self._counted(hook) if kind == "Pod" else hook)
        m.register_webhooks(api, gate_pods=True)
        del api.register_admission
        self.vc, self.kube = vc, m.KubeClient(api)
        self.controllers = m.ControllersDaemon(api, listen_port=0)
        self.controllers.gc.clock = lambda: JOB_GC_NOW
        self.syncs = 0
        qc = self.controllers.queue_controller
        real_sync = qc.sync_queue

        def counted_sync(*args, **kwargs):
            self.syncs += 1
            return real_sync(*args, **kwargs)

        qc.sync_queue = counted_sync
        self.drain_ms = {}
        for name in ("job_controller", "podgroup_controller", "queue_controller"):
            ctl = getattr(self.controllers, name)
            ctl.drain = self._timed(name, ctl.drain)
        self.controllers.gc.process_expired = self._timed("gc", self.controllers.gc.process_expired)
        self.scheduler = m.SchedulerDaemon(api, scheduler_conf=conf_path, snapshot_reuse=True,
                                           listen_port=0)
        self.scheduler.cache.run()
        self.kubelet = FakeKubelet(m, api)
        self.ticks = []
        #: pods by ns/name: (job, node, phase), from the store's watch
        self.pods = {}
        self.created_pods = self.binds = 0
        api.watch("Pod", self._on_pod, send_initial=False)

    def _on_pod(self, event, old, new) -> None:
        if event == self.m.ADDED:
            self.created_pods += 1
        if new is None:
            self.pods.pop(f"{old.metadata.namespace}/{old.metadata.name}", None)
            return
        if new.spec.node_name and (old is None or not old.spec.node_name):
            self.binds += 1
        self.pods[f"{new.metadata.namespace}/{new.metadata.name}"] = (
            new.metadata.annotations.get(self.m.batch.JOB_NAME_KEY), new.spec.node_name,
            new.status.phase)

    def _timed(self, name: str, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.drain_ms[name] = self.drain_ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3

        return run

    def _counted(self, hook):
        """``hook``, counting the admission denials it raises."""
        def run(operation, obj):
            try:
                return hook(operation, obj)
            except self.m.AdmissionError:
                self.denials += 1
                raise

        return run

    def tick(self, stage: str) -> dict:
        self.drain_ms = {}
        binds0, created0 = self.binds, self.created_pods
        syncs0, lists0, denials0 = self.syncs, self.lists, self.denials
        t0 = time.perf_counter()
        self.controllers.drain()
        controllers_ms = (time.perf_counter() - t0) * 1e3
        rec = dict(stage=stage, tick=len(self.ticks), controllers_ms=controllers_ms,
                   drain_ms=dict(self.drain_ms), sync_queue_calls=self.syncs - syncs0,
                   store_lists=self.lists - lists0, gate_denials=self.denials - denials0)
        if self.device:
            import torch

            from volcano_tpu_torch.ops import session_kernel

            torch.cuda.synchronize()
            session_kernel.LAUNCHES = session_kernel.WIDE_LAUNCHES = 0
        t0 = time.perf_counter()
        self.scheduler.scheduler.run_once()
        rec["run_once_ms"] = (time.perf_counter() - t0) * 1e3
        if self.device:
            from volcano_tpu_torch.framework import get_action

            stats = get_action(self.m.allocate).last_phase_stats
            rec.update(launches=session_kernel.LAUNCHES + session_kernel.WIDE_LAUNCHES,
                       device_ms=stats.get("execute_ms"),
                       host_sweeps=stats.get("host_sweeps", 0))
        t0 = time.perf_counter()
        rec["kubelet_ran"] = self.kubelet.drain()
        rec["kubelet_ms"] = (time.perf_counter() - t0) * 1e3
        rec.update(pods_created=self.created_pods - created0, binds=self.binds - binds0)
        self.ticks.append(rec)
        return rec

    def phases(self) -> dict:
        return {j.metadata.name: j.status.state.phase for j in self.read("Job", "default")}

    def settle(self, stage: str, done) -> int:
        """Tick until ``done()``; the ticks it took (a cell that does not
        settle in JOB_SETTLE_TICKS fails the run)."""
        for n in range(JOB_SETTLE_TICKS):
            if n and done():
                return n
            self.tick(stage)
        check(done(), f"{stage}: not settled in {JOB_SETTLE_TICKS} ticks: "
              f"{sorted(set(self.phases().values()))}")
        return JOB_SETTLE_TICKS

    def running(self, names) -> bool:
        """Every job of ``names`` Running with every pod of it bound and
        Running."""
        phases = self.phases()
        want = set(names)
        return (all(phases.get(n) == self.m.batch.JOB_RUNNING for n in want)
                and all(node and phase == "Running" for job, node, phase in self.pods.values()
                        if job in want))

    def close(self) -> None:
        """The store's own ``list`` back (the daemons were never started,
        so nothing else runs)."""
        self.api.list = self.read


def job_cell_nodes(n_nodes: int) -> list:
    """The nodes of ``generate_cluster_objects`` (64 CPU, 256 GiB, 110
    pods each) for ``n_nodes`` nodes."""
    from volcano_tpu_torch.ops.synthetic import generate_cluster_objects

    return generate_cluster_objects(n_tasks=1, n_nodes=n_nodes, gang_size=1, seed=0)[0]


def run_job_cell(m, cfg: dict, conf_path: str, device: bool = False, log=None) -> dict:
    """The Job cell on package ``m`` (``JobCell``): wave 1, the
    lifecycle, wave 2, with every expected phase checked on the way.
    Returns the cell's records, its dump, digest and store."""
    import io

    specs = job_specs(cfg)
    names = [s[0] for s in specs]
    w1, w2 = names[:cfg["wave1"]], names[cfg["wave1"]:]
    finish = w1[:cfg["wave1"] // 2]
    restart = w1[3 * cfg["wave1"] // 4]
    suspend = w1[3 * cfg["wave1"] // 4 + 1]
    cell = JobCell(m, cfg, conf_path, device=device)
    out = dict(stages={})
    try:
        def stage(name, fn, done):
            t0 = time.perf_counter()
            first = len(cell.ticks)
            fn()
            ticks = cell.settle(name, done)
            out["stages"][name] = dict(ticks=ticks, s=time.perf_counter() - t0)
            if log is not None:
                for rec in cell.ticks[first:]:
                    log(rec)

        t0 = time.perf_counter()

        def wave(batch):
            for spec in batch:
                cell.vc.create_job(job_object(m, specs[names.index(spec)], cfg["tasks"]))

        stage("wave1", lambda: wave(w1), lambda: cell.running(w1))

        def lifecycle():
            for name in finish:
                for i in range(cfg["tasks"]):
                    cell.kubelet.finish("default", f"{name}-worker-{i}")
            cell.kubelet.finish("default", f"{restart}-worker-7", phase="Failed", exit_code=137)
            rc = m.vtctl(["job", "suspend", "-N", suspend, "-n", "default"], api=cell.api,
                         out=io.StringIO())
            check(rc == 0, f"vtctl job suspend {suspend}: rc {rc}")

        def lifecycle_done():
            phases = cell.phases()
            job = cell.api.get("Job", "default", restart)
            return (not any(n in phases for n in finish)
                    and phases.get(suspend) == m.batch.JOB_ABORTED
                    and job is not None and job.status.retry_count >= 1
                    and cell.running([n for n in w1 if n not in finish and n != suspend]))

        stage("lifecycle", lifecycle, lifecycle_done)
        gone = set(finish)
        reaped = [f"{k}/{o.metadata.name}" for k in ("Pod", "PodGroup", "Service", "Secret")
                  for o in cell.read(k, "default")
                  if "-".join(o.metadata.name.split("-")[:2]) in gone]
        check(not reaped, f"the GC left {len(reaped)} objects of reaped jobs: {reaped[:5]}")

        def resume():
            rc = m.vtctl(["job", "resume", "-N", suspend, "-n", "default"], api=cell.api,
                         out=io.StringIO())
            check(rc == 0, f"vtctl job resume {suspend}: rc {rc}")

        survivors = [n for n in w1 if n not in finish]
        stage("resume", resume, lambda: cell.running(survivors))
        stage("wave2", lambda: wave(w2), lambda: cell.running(survivors + w2))
        out["s"] = time.perf_counter() - t0
        phases = cell.phases()
        expect = {n: m.batch.JOB_RUNNING for n in survivors + w2}
        check(phases == expect, f"job phases: {sorted(set(phases.items()) - set(expect.items()))[:5]}")
        retries = cell.api.get("Job", "default", restart).status.retry_count
        check(retries == 1, f"{restart}: retry count {retries}")
        cell.close()
        over = pods_within_allocatable(cell.api)
        check(not over, f"pods over their nodes' allocatable: {over[:5]}")
        out.update(dump=job_store_dump(cell.api), ticks=cell.ticks, api=cell.api,
                   pods=len(cell.api.list("Pod")), jobs=len(phases))
        out["digest"] = job_digest(out["dump"])
        return out
    finally:
        cell.close()


def phase_jobs(card: str) -> dict:
    """The Job path in process (``JOB_CELL``): the port's admission
    (``register_webhooks`` with the pod gate), ``ControllersDaemon`` and
    ``SchedulerDaemon`` (gpu-allocate on the card), stepped with a kubelet
    through wave 1, the lifecycle and wave 2 (``run_job_cell``).  Every
    expected job phase, every pod within its node's allocatable, 3
    session-kernel launches in each cycle that binds, no host sweep,
    kernel failure or fallback, and the store's digest ``JOB_DIGESTS``.
    A ``{"jobs_tick": ...}`` line a tick and a ``{"jobs": ...}`` line."""
    import torch

    t0 = time.perf_counter()
    failures0, fallbacks0 = kernel_failures(), executor_fallbacks()
    torch.cuda.synchronize()
    with policy_file(CYCLE_TIERS, JOB_ACTIONS) as path:
        out = run_job_cell(port_job_pkg(), JOB_CONFIG, path, device=True,
                           log=lambda rec: print(json.dumps({"jobs_tick": rec})))
    binding = [t for t in out["ticks"] if t["binds"]]
    check(binding and all(t["launches"] == 3 for t in binding),
          f"{JOB_CELL}: launches in the binding cycles {[t['launches'] for t in binding]}")
    check(all(t["host_sweeps"] == 0 for t in out["ticks"]),
          f"{JOB_CELL}: host sweeps {[t['host_sweeps'] for t in out['ticks']]}")
    check(kernel_failures() == failures0 and executor_fallbacks() == fallbacks0,
          f"{JOB_CELL}: {kernel_failures() - failures0:.0f} kernel failures, "
          f"{executor_fallbacks() - fallbacks0:.0f} fallbacks")
    check(out["digest"] == JOB_DIGESTS[JOB_CELL],
          f"{JOB_CELL}: store digest {out['digest']} != the JAX package's {JOB_DIGESTS[JOB_CELL]}")
    ticks = out["ticks"]

    def total(key):
        return sum(t[key] for t in ticks)

    rec = dict(cell=JOB_CELL, config=JOB_CONFIG, card=card, digest=out["digest"],
               stages=out["stages"], ticks=len(ticks), jobs=out["jobs"], pods=out["pods"],
               binds=total("binds"), pods_created=total("pods_created"),
               launches=total("launches"), binding_cycles=len(binding),
               run_once_ms=total("run_once_ms"), device_ms=sum(t["device_ms"] or 0.0 for t in ticks),
               controllers_ms=total("controllers_ms"), kubelet_ms=total("kubelet_ms"),
               drain_ms={k: sum(t["drain_ms"].get(k, 0.0) for t in ticks)
                         for k in ("job_controller", "podgroup_controller", "queue_controller",
                                   "gc")},
               sync_queue_calls=total("sync_queue_calls"), store_lists=total("store_lists"),
               gate_denials=total("gate_denials"), s=time.perf_counter() - t0)
    print(json.dumps({"jobs": rec}))
    return rec


#: phase_local_up's cluster: BASELINE config 1 (the reference's
#: example/job.yaml, a three-replica gang job) on 100 seeded nodes
LOCAL_UP_NODES = 100
LOCAL_UP_JOB = """\
apiVersion: batch.volcano-tpu.io/v1alpha1
kind: Job
metadata:
  name: test-job
  namespace: default
spec:
  minAvailable: 3
  maxRetry: 5
  queue: default
  policies:
  - event: PodEvicted
    action: RestartJob
  plugins:
    ssh: []
    env: []
    svc: []
  tasks:
  - name: default-nginx
    replicas: 3
    template:
      metadata:
        name: web
      spec:
        containers:
        - name: nginx
          image: nginx
          resources:
            requests:
              cpu: "1"
        restartPolicy: OnFailure
"""
#: the admission webhook's denial of a Job whose minAvailable exceeds its
#: replicas (the JAX package's text, volcano_tpu/admission/jobs.py:250)
MIN_AVAILABLE_DENIAL = "'minAvailable' should not be greater than total replicas in tasks;"


class Spawned(Binary):
    """A child that ``cmd.local_up.multiproc_up`` started, its output in
    ``log_path``: ``Binary``'s log reads, status and SIGTERM."""

    def __init__(self, proc, log_path: str, name: str):
        self.proc, self.log_path, self.name = proc, log_path, name

    def close(self) -> None:
        import signal

        if self.alive():
            self.proc.send_signal(signal.SIGKILL)
            self.proc.wait(timeout=60)


def phase_local_up(card: str) -> dict:
    """The Job path over the wire: ``cmd.local_up.multiproc_up`` starts the
    port's apiserver, admission (``--gate-pods``), controllers and
    scheduler (on the card) binaries as children and seeds 100 nodes;
    ``vtctl --bus`` runs LOCAL_UP_JOB, which binds with its PodGroup
    Running while the scheduler child's launches rise by 3; the admission
    child refuses a Job whose minAvailable exceeds its replicas with the
    JAX package's message; ``vtctl job list``, ``job view``, ``describe
    job`` and ``queue list`` print; SIGTERM ends every child with exit 0.
    The children and this process talk over the same-host shm rings
    (``multiproc_up`` sets ``VTPU_BUS_SHM=1``; ``VTPU_BUS_SHM_DIR`` points
    at the phase's own directory): the scheduler child must have a ring
    pair mapped there, so a silent TCP fallback fails the run.  A
    ``{"local_up": ...}`` line."""
    import io
    import os
    import shutil
    import tempfile

    from volcano_tpu_torch.cli.vtctl import main as vtctl
    from volcano_tpu_torch.cmd.local_up import multiproc_up, shutdown_procs, wait_for_admission

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="vtpu-local-up-")
    shm_dir = os.path.join(tmp, "shm")
    saved_env = {k: os.environ.get(k) for k in ("VTPU_BUS_SHM", "VTPU_BUS_SHM_DIR")}
    os.environ["VTPU_BUS_SHM_DIR"] = shm_dir
    names = ("apiserver", "admission", "controllers", "scheduler-0")
    api, procs = multiproc_up(nodes=LOCAL_UP_NODES, gate_pods=True, log_dir=tmp,
                              schedule_period=0.2)
    children = [Spawned(p, os.path.join(tmp, f"{n}.log"), n) for p, n in zip(procs, names)]
    url = api.address
    rec = dict(card=card, nodes=LOCAL_UP_NODES)
    try:
        up_s = wait_for(lambda: wait_for_admission(api, timeout=1.0), CHILD_START_S,
                        "the admission child's webhook", failed=lambda: [
                            c.name for c in children if not c.alive()] or None)
        sched = children[3]
        metrics_port = int(sched.wait_log(r"serving on :(\d+)").group(1))
        before = sched.status()
        rings = shm_rings(sched.proc.pid, shm_dir)
        check({r.split("-")[0] for r in rings} == {"c2s", "s2c"},
              f"local_up: the scheduler child maps no shm ring pair under {shm_dir}: {rings}")

        def run(*argv):
            buf = io.StringIO()
            rc = vtctl(["--bus", url, *argv], out=buf)
            return rc, buf.getvalue()

        path = os.path.join(tmp, "job.yaml")
        with open(path, "w") as f:
            f.write(LOCAL_UP_JOB)
        rc, text = run("job", "run", "-f", path)
        check(rc == 0 and "run job test-job successfully" in text, f"vtctl job run: {rc} {text}")

        def bound():
            pods = api.list("Pod", "default")
            pg = api.get("PodGroup", "default", "test-job")
            return (len(pods) == 3 and all(p.spec.node_name for p in pods)
                    and pg is not None and pg.status.phase == "Running")

        bind_s = wait_for(bound, SETTLE_S, "test-job bound with its PodGroup Running",
                          failed=lambda: [c.name for c in children if not c.alive()] or None)
        after, _ = child_checked(sched, metrics_port, "local_up's scheduler child")
        launches = (after["session"] + after["session_wide"]
                    - before["session"] - before["session_wide"])
        check(launches == 3, f"local_up: the scheduler child launched {launches} times, expected 3")
        rc, text = run("job", "run", "-N", "too-small", "-r", "3", "--min", "4")
        check(rc == 1 and text.strip() == f"error: {MIN_AVAILABLE_DENIAL}",
              f"the admission child let an invalid job through: {rc} {text!r}")
        check(api.get("Job", "default", "too-small") is None, "too-small was created")
        reads = {}
        for argv in (("job", "list"), ("job", "view", "-N", "test-job"),
                     ("describe", "job", "-N", "test-job"), ("queue", "list")):
            rc, text = run(*argv)
            check(rc == 0 and text, f"vtctl {' '.join(argv)}: {rc} {text!r}")
            reads[" ".join(argv)] = len(text)
        print(run("describe", "job", "-N", "test-job")[1], end="")
        for kind in ("Service", "Secret", "NetworkPolicy"):
            check(api.get(kind, "default", "test-job" if kind != "Secret" else "test-job-ssh"),
                  f"the svc and ssh plugins' {kind} of test-job")
        api.close()
        codes = {c.name: c.terminate() for c in reversed(children)}
        check(all(code == 0 for code in codes.values()), f"children's exit codes {codes}")
        rec.update(up_s=up_s, submit_to_bound_s=bind_s, launches=launches,
                   reads=reads, exit_codes=codes, scheduler_rings=rings,
                   s=time.perf_counter() - t0)
        print(json.dumps({"local_up": rec}))
        return rec
    finally:
        api.close()
        shutdown_procs(procs)
        shutil.rmtree(tmp, ignore_errors=True)
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


#: the sidecar phase (``phase_sidecar``): the loop cell and the preempting
#: cell it drives through a compute-plane sidecar process, the cycle it
#: runs in-process after the sidecar is killed, and the seconds the
#: child has to answer its first health probe (its warmup included)
SIDECAR_LOOP = LOOP_A
#: SIDECAR_LOOP's cycles through the child: the cold one (a full frame)
#: and a warm one (a delta frame); 3 until the federation's phase needed
#: the room (the third repeated the second's delta frame)
SIDECAR_CYCLES = 2
SIDECAR_PREEMPT = PREEMPT_CYCLE_MAIN
SIDECAR_AFTER_KILL = SECOND_CONFIG
SIDECAR_START_S = 300.0


class Sidecar(Binary):
    """The compute-plane sidecar as a child process,
    ``python -m volcano_tpu_torch.cmd.compute_plane --socket PATH
    --warmup`` with no ``--device`` (it serves on the card), its socket
    and log in a fresh temporary directory."""

    def __init__(self):
        import os
        import tempfile

        path = tempfile.mkdtemp(prefix="vsc")
        if len(path) > 80:  # an AF_UNIX path holds at most 107 bytes
            os.rmdir(path)
            path = tempfile.mkdtemp(prefix="vsc", dir="/tmp")
        self.path = os.path.join(path, "cp.sock")
        super().__init__("volcano_tpu_torch.cmd.compute_plane",
                         ["--socket", self.path, "--warmup"], path)

    def wait_ready(self, client) -> float:
        """Seconds until the child answers a health probe; a child that
        exits, or does not answer within SIDECAR_START_S, fails the run."""
        t0 = time.monotonic()
        while not client.health():
            check(self.alive(), f"sidecar: the child exited with {self.proc.returncode}:\n"
                                f"{self.tail()}")
            check(time.monotonic() - t0 < SIDECAR_START_S,
                  f"sidecar: no answer in {SIDECAR_START_S} s:\n{self.tail()}")
            time.sleep(0.25)
        return time.monotonic() - t0

    def status(self) -> dict:
        """The child's kernel launches and device memory: SIGUSR1, then its
        ``compute plane status:`` line."""
        return super().status("compute plane status: ")

    def kill(self) -> None:
        import signal

        if self.alive():
            self.proc.send_signal(signal.SIGKILL)
        self.proc.wait(timeout=60)


def gpu_apps() -> dict:
    """pid → used memory (MiB) of every compute process ``nvidia-smi``
    lists on the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    apps = {}
    for line in out.splitlines():
        if "," in line:
            pid, mem = (x.strip() for x in line.split(",", 1))
            apps[int(pid)] = float(mem.split()[0]) if mem.split()[0].isdigit() else 0.0
    return apps


def executor_fallbacks() -> float:
    """Remote sessions that ran on the in-process kernel instead."""
    from volcano_tpu_torch import metrics

    return sum(metrics.registry.counters("volcano_executor_fallbacks_total").values())


class WireTally:
    """Frames and bytes of the compute-plane client in this process, by
    wrapping ``serialize_snapshot``/``serialize_delta``/
    ``serialize_preempt``, ``_recv_frame`` and the client's ``allocate``/
    ``preempt`` for the duration of a ``with``; :meth:`take` returns and
    resets the counts.  Of the round trips' time, ``serialize_ms`` went
    into building the request frames and ``gc_ms`` into this process's
    collector pauses (``gc.callbacks``)."""

    def __init__(self):
        from volcano_tpu_torch.serving import compute_plane as cp

        self.cp = cp
        self._in_preempt = False
        self._in_roundtrip = False
        self._gc_t0 = None
        self.take()

    def take(self) -> dict:
        out = getattr(self, "counts", None)
        self.counts = dict(full=0, delta=0, preempt=0, request_bytes=0, response_bytes=0,
                           roundtrip_ms=0.0, serialize_ms=0.0, gc_ms=0.0)
        return out

    def _gc(self, phase, info):
        if phase == "start":
            self._gc_t0 = time.perf_counter() if self._in_roundtrip else None
        elif self._gc_t0 is not None:
            self.counts["gc_ms"] += (time.perf_counter() - self._gc_t0) * 1e3
            self._gc_t0 = None

    def __enter__(self):
        cp = self.cp
        self._real = dict(serialize_snapshot=cp.serialize_snapshot,
                          serialize_delta=cp.serialize_delta,
                          serialize_preempt=cp.serialize_preempt, _recv_frame=cp._recv_frame,
                          allocate=cp.ComputePlaneClient.allocate,
                          preempt=cp.ComputePlaneClient.preempt)
        real = self._real

        def frame(kind, fn):
            def wrapped(*a, **k):
                t0 = time.perf_counter()
                out = fn(*a, **k)
                if not self._in_preempt:
                    self.counts[kind] += 1
                    self.counts["request_bytes"] += len(out) + cp._HEADER.size
                    self.counts["serialize_ms"] += (time.perf_counter() - t0) * 1e3
                return out
            return wrapped

        def preempt_frame(*a, **k):
            t0 = time.perf_counter()
            self._in_preempt = True
            try:
                out = real["serialize_preempt"](*a, **k)
            finally:
                self._in_preempt = False
            self.counts["preempt"] += 1
            self.counts["request_bytes"] += len(out) + cp._HEADER.size
            self.counts["serialize_ms"] += (time.perf_counter() - t0) * 1e3
            return out

        def recv(sock):
            mtype, payload = real["_recv_frame"](sock)
            self.counts["response_bytes"] += len(payload) + cp._HEADER.size
            return mtype, payload

        def timed(fn):
            def wrapped(*a, **k):
                t0 = time.perf_counter()
                self._in_roundtrip = True
                try:
                    return fn(*a, **k)
                finally:
                    self._in_roundtrip = False
                    self.counts["roundtrip_ms"] += (time.perf_counter() - t0) * 1e3
            return wrapped

        cp.serialize_snapshot = frame("full", real["serialize_snapshot"])
        cp.serialize_delta = frame("delta", real["serialize_delta"])
        cp.serialize_preempt = preempt_frame
        cp._recv_frame = recv
        cp.ComputePlaneClient.allocate = timed(real["allocate"])
        cp.ComputePlaneClient.preempt = timed(real["preempt"])
        import gc

        gc.callbacks.append(self._gc)
        return self

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self._gc)
        cp = self.cp
        for name in ("serialize_snapshot", "serialize_delta", "serialize_preempt",
                     "_recv_frame"):
            setattr(cp, name, self._real[name])
        cp.ComputePlaneClient.allocate = self._real["allocate"]
        cp.ComputePlaneClient.preempt = self._real["preempt"]


def http_get(port: int, path: str):
    """(status, body) of GET ``path`` on the local serving port."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        try:
            return e.code, e.read()
        finally:
            e.close()


def phase_sidecar(card: str, loop_recs: Optional[dict] = None) -> dict:
    """The compute-plane sidecar on the card, as a deployment runs it: a
    child process (``Sidecar``) owns the kernels; this process is the
    scheduler, its executors pointed at the child with
    ``executor.configure``.  Checks, each failing the run:
      * the child answers a health probe, and ``nvidia-smi`` lists its
        pid with memory in use;
      * SIDECAR_LOOP's cycles through ``Scheduler.run_once``: each the
        cell's digest, ``last_allocate_executor() == "auto"``, no
        fallback, no kernel launched in this process and the session
        kernel launched in the child (its counts read before and after
        each cycle, ``Sidecar.status``); cycle 0 ships a full frame,
        every later cycle one delta frame;
      * one preempting cycle of SIDECAR_PREEMPT: its digest, the preempt
        kernel launched once in the child, none here, no fallback;
      * a ``ServingServer`` over this process: /healthz "ok", /metrics,
        and /explain listing the jobs the preempting cycle left
        unschedulable with the messages of ``cache.unschedulable_digest``;
      * the child SIGKILLed: one SIDECAR_AFTER_KILL cycle gives its digest
        on the in-process kernel (executor ``cuda``, launches here), with
        exactly one fallback counted; /healthz reads "degraded: …
        compute-plane …" and /metrics holds the fallback.
    The executors, the breakers and the child are reset in a ``finally``.
    One ``{"sidecar": ...}`` line."""
    import os

    import torch

    from volcano_tpu_torch import faults
    from volcano_tpu_torch.ops import executor, preempt_kernel, session_kernel
    from volcano_tpu_torch.ops.synthetic import (
        BASELINE_CONFIGS,
        generate_cluster_objects,
        generate_preempt_cluster_objects,
    )
    from volcano_tpu_torch.serving import ServingServer
    from volcano_tpu_torch.serving.compute_plane import ComputePlaneClient
    from volcano_tpu_torch.serving.explain import explain_jobs

    t_phase = time.perf_counter()
    failures0 = kernel_failures()
    apps0 = gpu_apps()
    sidecar = Sidecar()
    probe = ComputePlaneClient(sidecar.path, timeout=10.0)
    serving = None
    out = dict(card=card, loop=LOOP_CELLS[SIDECAR_LOOP]["config"], preempt=SIDECAR_PREEMPT,
               after_kill=SIDECAR_AFTER_KILL)
    try:
        out["child_ready_s"] = sidecar.wait_ready(probe)
        probe.close()
        apps = gpu_apps()
        status0 = sidecar.status()
        rise = sum(apps.values()) - sum(apps0.values())
        out.update(child_pid=sidecar.proc.pid, smi_apps=apps, smi_rise_mib=rise,
                   child_memory_reserved=status0["memory_reserved"])
        if sidecar.proc.pid in apps:
            check(apps[sidecar.proc.pid] > 0,
                  f"sidecar: pid {sidecar.proc.pid} holds no memory on the card ({apps})")
        else:
            # a sandbox's processes may all show under one pid that is not
            # theirs: then the child is the rise of the listed memory when
            # it started (a CUDA context is hundreds of MiB), with device
            # memory held and kernels launched by its own account
            check(not any(pid in apps for pid in (os.getpid(), sidecar.proc.pid))
                  and rise >= 100 and status0["memory_reserved"] > 0
                  and status0["session"] > 0,
                  f"sidecar: the child is not on the card: nvidia-smi lists {apps0} before "
                  f"it started and {apps} after; the child reports {status0}")
        executor.configure(sidecar.path)

        def child_launches(before: dict, after: dict) -> dict:
            return {k: after[k] - before[k] for k in ("session", "session_wide", "preempt")}

        def child_requests(before: dict, after: dict) -> list:
            """The child's own timings of the requests it served between
            two status lines."""
            seen = max((r["n"] for r in before["requests"]), default=0)
            return [r for r in after["requests"] if r["n"] > seen]

        def zero_local():
            torch.cuda.synchronize()
            session_kernel.LAUNCHES = session_kernel.WIDE_LAUNCHES = 0
            preempt_kernel.LAUNCHES = 0

        def local_launches() -> int:
            return session_kernel.LAUNCHES + session_kernel.WIDE_LAUNCHES + preempt_kernel.LAUNCHES

        spec = LOOP_CELLS[SIDECAR_LOOP]
        objects = loop_objects(spec["config"])
        n_pods = len(objects[1])
        want = CYCLE_DIGESTS[spec["config"]]
        in_process = (loop_recs or {}).get(SIDECAR_LOOP, {}).get("cycles", [])
        cycles = []
        with WireTally() as wire:
            loop = loop_cycles(objects, spec["tiers"], spec["actions"], SIDECAR_CYCLES,
                               spec["between"])
            while True:
                fallbacks = executor_fallbacks()
                before = sidecar.status()
                zero_local()
                wire.take()
                rec = next(loop, None)
                if rec is None:
                    break
                after = sidecar.status()
                frames, launched = wire.take(), child_launches(before, after)
                k, ph = rec["cycle"], rec["phases"]
                what = f"sidecar {SIDECAR_LOOP} cycle {k}"
                digest = cycle_digest(rec["binds"])
                check(digest == want and len(rec["binds"]) == n_pods,
                      f"{what}: digest {digest} != the JAX package's {want}")
                check(executor.last_allocate_executor() == "auto",
                      f"{what}: executor {executor.last_allocate_executor()!r}, expected 'auto'")
                check(executor_fallbacks() == fallbacks, f"{what}: a fallback was counted")
                check(local_launches() == 0, f"{what}: this process launched a kernel")
                check(launched["session"] + launched["session_wide"] > 0,
                      f"{what}: the child launched no session kernel ({launched})")
                check((frames["full"], frames["delta"]) == ((1, 0) if k == 0 else (0, 1)),
                      f"{what}: {frames['full']} full and {frames['delta']} delta frames")
                cycles.append(dict(
                    cycle=k, frame="full" if k == 0 else "delta", mode=ph.get("mode"),
                    request_bytes=frames["request_bytes"],
                    response_bytes=frames["response_bytes"],
                    roundtrip_ms=frames["roundtrip_ms"], serialize_ms=frames["serialize_ms"],
                    roundtrip_gc_ms=frames["gc_ms"], execute_ms=ph.get("execute_ms"),
                    run_once_ms=rec["e2e_s"] * 1e3, stage_bytes=ph.get("stage_bytes"),
                    child_launches=launched["session"] + launched["session_wide"],
                    child_requests=child_requests(before, after),
                    in_process_device_ms=(in_process[k]["device_ms"]
                                          if k < len(in_process) else None)))
            del loop, objects

            fallbacks = executor_fallbacks()
            before = sidecar.status()
            zero_local()
            wire.take()
            rec = run_preempt_cycle(
                generate_preempt_cluster_objects(**PREEMPT_CYCLE_CELLS[SIDECAR_PREEMPT]),
                status_updater=ListStatusUpdater())
            after = sidecar.status()
            frames, launched = wire.take(), child_launches(before, after)
        what = f"sidecar {SIDECAR_PREEMPT}"
        digest = preempt_cycle_digest(rec["evicted"], rec["pipelined"])
        alloc = rec["allocate_phases"]
        check(digest == PREEMPT_CYCLE_DIGESTS[SIDECAR_PREEMPT],
              f"{what}: digest {digest} != the JAX package's "
              f"{PREEMPT_CYCLE_DIGESTS[SIDECAR_PREEMPT]}")
        check(rec["preempt_executor"] == "auto" and rec["preempt_route"] == "device",
              f"{what}: preempt executor {rec['preempt_executor']!r}, route "
              f"{rec['preempt_route']!r}")
        check(executor_fallbacks() == fallbacks, f"{what}: a fallback was counted")
        check(local_launches() == 0, f"{what}: this process launched a kernel")
        check(launched["preempt"] == 1 and launched["session"] + launched["session_wide"] > 0,
              f"{what}: the child launched {launched}")
        check(alloc.get("explained", 0) >= 1 and alloc.get("host_sweeps", -1) == 0,
              f"{what}: gpu-allocate explained {alloc.get('explained')}, swept the host "
              f"{alloc.get('host_sweeps')} times")
        out["preempt_cycle"] = dict(
            evicted=len(rec["evicted"]), pipelined=len(rec["pipelined"]),
            explained=alloc["explained"], child_launches=launched, frames=frames,
            child_requests=child_requests(before, after),
            gpu_allocate_ms=rec["action_s"]["gpu-allocate"] * 1e3,
            gpu_preempt_ms=rec["action_s"]["gpu-preempt"] * 1e3,
            allocate_execute_ms=alloc.get("execute_ms"),
            preempt_execute_ms=rec["preempt_phases"].get("execute_ms"))

        cache = rec["cache"]
        del rec
        serving = ServingServer(
            explain_source=lambda ns, job: explain_jobs(cache, ns, job)).start()
        check(http_get(serving.port, "/healthz") == (200, b"ok"),
              f"sidecar: /healthz {http_get(serving.port, '/healthz')}")
        status, body = http_get(serving.port, "/metrics")
        check(status == 200 and b"volcano_tpu_kernel_latency_milliseconds_count" in body,
              f"sidecar: /metrics answered {status}")
        status, body = http_get(serving.port, "/explain")
        check(status == 200, f"sidecar: /explain answered {status}")
        data = json.loads(body)
        digest_jobs = {d["name"]: d for d in cache.unschedulable_digest.values()}
        served = {j["name"]: j for j in data["jobs"]}
        check(served and set(served) == set(digest_jobs),
              f"sidecar: /explain lists {len(served)} jobs, the digest {len(digest_jobs)}")
        for name, job in served.items():
            want_msgs = {uid: t["message"] for uid, t in digest_jobs[name]["tasks"].items()}
            check({t["uid"]: t["message"] for t in job["unschedulable"]} == want_msgs,
                  f"sidecar: /explain's messages for {name} differ from the digest's")
        out["explain"] = dict(jobs=len(served), tasks=sum(len(j["unschedulable"])
                                                          for j in served.values()),
                              bytes=len(body), reasons=data.get("last_cycle", {}).get("reasons"))
        del cache, data, served, digest_jobs

        sidecar.kill()
        fallbacks = executor_fallbacks()
        zero_local()
        rec = run_cycle(generate_cluster_objects(**BASELINE_CONFIGS[SIDECAR_AFTER_KILL]))
        what = f"sidecar killed, {SIDECAR_AFTER_KILL}"
        launches = session_kernel.LAUNCHES + session_kernel.WIDE_LAUNCHES
        digest = cycle_digest(rec["binds"])
        check(digest == CYCLE_DIGESTS[SIDECAR_AFTER_KILL],
              f"{what}: digest {digest} != the JAX package's {CYCLE_DIGESTS[SIDECAR_AFTER_KILL]}")
        check(executor.last_allocate_executor() == "cuda" and launches > 0,
              f"{what}: executor {executor.last_allocate_executor()!r}, {launches} launches")
        check(executor_fallbacks() == fallbacks + 1,
              f"{what}: {executor_fallbacks() - fallbacks:.0f} fallbacks counted, expected 1")
        status, body = http_get(serving.port, "/healthz")
        check(status == 200 and body.startswith(b"degraded: ") and b"compute-plane" in body,
              f"{what}: /healthz {status} {body[:200]!r}")
        status, metrics_body = http_get(serving.port, "/metrics")
        check(b'volcano_executor_fallbacks_total{cause="error",from="remote",to="local"}'
              in metrics_body, f"{what}: /metrics holds no remote fallback")
        out["after_kill"] = dict(binds=len(rec["binds"]), launches=launches,
                                 execute_ms=rec["execute_s"] * 1e3, healthz=body.decode())
        check(kernel_failures() == failures0, "sidecar: kernel failures counted")
    finally:
        probe.close()
        executor.configure(None)
        faults.reset_breakers()
        if serving is not None:
            serving.stop()
        sidecar.close()
    out.update(cycles=cycles, phase_ms=(time.perf_counter() - t_phase) * 1e3)
    print(f"sidecar: child up in {out['child_ready_s']:.1f} s (pid {out['child_pid']}; "
          f"nvidia-smi {out['smi_apps']}, +{out['smi_rise_mib']} MiB when it started); "
          f"{len(cycles)} {SIDECAR_LOOP} cycles through it, "
          f"each the JAX digest, executor auto, no fallback: frames "
          f"{[c['frame'] for c in cycles]}, request bytes {[c['request_bytes'] for c in cycles]}, "
          f"response bytes {[c['response_bytes'] for c in cycles]}, round trip ms "
          f"{[round(c['roundtrip_ms'], 3) for c in cycles]} (of which serialize "
          f"{[round(c['serialize_ms'], 3) for c in cycles]}, this process's gc "
          f"{[round(c['roundtrip_gc_ms'], 3) for c in cycles]}; in-process device ms "
          f"{[None if c['in_process_device_ms'] is None else round(c['in_process_device_ms'], 3) for c in cycles]}; "
          f"the child's decode/put/kernel/reply ms "
          f"{[[tuple(None if r[k] is None else round(r[k], 3) for k in ('decode_ms', 'put_ms', 'kernel_ms', 'reply_ms')) for r in c['child_requests']] for c in cycles]}); "
          f"{SIDECAR_PREEMPT} through it with its digest; /explain {out['explain']['jobs']} jobs; "
          f"killed: {SIDECAR_AFTER_KILL} in-process with one fallback, /healthz degraded; "
          f"card {card}")
    print(json.dumps({"sidecar": out}))
    return out


class Stopwatch:
    """Wall time of an object's method, each call, by wrapping it on the
    instance: ``Stopwatch(journal, "write_cycle").ms`` lists one entry a
    call."""

    def __init__(self, obj, method: str):
        self.ms = []
        orig = getattr(obj, method)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return orig(*args, **kwargs)
            finally:
                self.ms.append((time.perf_counter() - t0) * 1e3)

        setattr(obj, method, timed)

    def take(self) -> list:
        out, self.ms = self.ms, []
        return out


#: the loop cells phase_replay records with the recorder on and the
#: cycles it records of each (the churn cell's first 3 of its 5: its
#: last two, ~16 s, gave way to the Job path's phases), the cells whose
#: last recorded cycle is journaled with events only (``snapshot_every=
#: 0``), the cycles it replays through ``native`` (the churn cell's every
#: recorded cycle; the 50k x 10k cycle, 10.5 s of host C++, gave way to
#: the daemon and bus phases), and the warm cycles a recorder mode gets
#: in the interleaved cost run of LOOP_A (two a mode, each mode in both
#: halves; four a mode until the flight recorder's checks took ~30 s of
#: the run's time)
#: (LOOP_A's 4 until the replicated store's phase needed the room: 2
#: captured and the events-only one since; LOOP_B's 3 until the
#: federation's did: its cold and first warm cycle since)
REPLAY_CELLS = {LOOP_A: 3, LOOP_C: 1, LOOP_B: 2}
REPLAY_EVENTS_ONLY = (LOOP_A,)
REPLAY_NATIVE = {LOOP_B: (0, 1)}
RECORDER_COST_ORDER = ("off", "events", "capture", "capture", "events", "off")


def recorded_loop(name: str, journal_dir: str) -> dict:
    """A loop cell's first REPLAY_CELLS[name] cycles with the recorder
    on, capturing every cycle (``trace.enable(journal_dir,
    snapshot_every=1)``); in a cell of REPLAY_EVENTS_ONLY the last cycle
    runs under a recorder of its own that journals events only
    (``snapshot_every=0``, into ``journal_dir + "-events"``), with the
    same checks but no capture and no ``snapshot-capture`` event, and
    goes under ``events_only``, not ``cycles``.  Every cycle:
    the digest phase_loop holds it to, the session kernel launched with
    executor ``cuda`` (3 launches a 50k x 10k revert cycle), no kernel
    failure; its journal record holds one ``bind`` decision a bind (the
    bound nodes the binds' nodes), no ``n_dropped``, and the spans and
    events the loop, the framework, gpu-allocate and the dispatcher
    emit (``dispatch:allocate`` naming ``cuda``; ``dispatch:preempt``
    naming ``cuda`` once in the preempting cycle).  The journal's write
    (inside ``end_cycle``, after ``run_once``'s time is stamped) and the
    npz capture (inside gpu-allocate) are timed apart."""
    import torch

    from volcano_tpu_torch import trace
    from volcano_tpu_torch.framework import get_action
    from volcano_tpu_torch.ops import preempt_kernel, session_kernel
    from volcano_tpu_torch.ops.executor import last_allocate_executor

    spec = LOOP_CELLS[name]
    objects = loop_objects(spec["config"])
    n_cycles = REPLAY_CELLS[name]
    rec = trace.enable(journal_dir, snapshot_every=1)
    cycles, events_only = [], None
    loop = loop_cycles(objects, spec["tiers"], spec["actions"], n_cycles, spec["between"])
    try:
        for k in range(n_cycles):
            capture = not (name in REPLAY_EVENTS_ONLY and k == n_cycles - 1)
            if not capture:
                captured, rec = rec, trace.enable(journal_dir + "-events", snapshot_every=0)
            if k == 0 or not capture:
                writes = Stopwatch(rec.journal, "write_cycle")
                captures = Stopwatch(rec.journal, "write_snapshot")
            failures = kernel_failures()
            torch.cuda.synchronize()
            session_kernel.LAUNCHES = session_kernel.WIDE_LAUNCHES = 0
            preempt_kernel.LAUNCHES = 0
            out = next(loop)
            launches = session_kernel.LAUNCHES + session_kernel.WIDE_LAUNCHES
            what = f"{name} recorded cycle {k}" + ("" if capture else " (events only)")
            record = rec.last_cycle()
            check(last_allocate_executor() == "cuda",
                  f"{what}: executor {last_allocate_executor()!r}, expected 'cuda'")
            check(launches == 3 if name == LOOP_A else launches > 0,
                  f"{what}: {launches} session-kernel launches")
            check(kernel_failures() == failures, f"{what}: kernel failures counted")
            if spec["between"] is None:
                digest = preempt_cycle_digest(out["evicted"], out["pipelined"])
                want = PREEMPT_CYCLE_DIGESTS[spec["config"]]
                preempts = [e for e in record["events"] if e["name"] == "dispatch:preempt"]
                check(len(preempts) == 1 and preempts[0]["args"]["executor"] == "cuda"
                      and preempt_kernel.LAUNCHES == 1 and
                      get_action("gpu-preempt").last_executor == "cuda",
                      f"{what}: dispatch:preempt {preempts}, "
                      f"{preempt_kernel.LAUNCHES} preempt launches")
            else:
                digest = cycle_digest(out["binds"])
                want = (CYCLE_DIGESTS[spec["config"]] if spec["between"] == "revert"
                        else LOOP_DIGESTS[name][k])
            check(digest == want, f"{what}: digest {digest} != the JAX package's {want}")
            check(record is not None and record["cycle"] == (k if capture else 0)
                  and "n_dropped" not in record,
                  f"{what}: record {None if record is None else record.get('cycle')}, "
                  f"{(record or {}).get('n_dropped')} dropped")
            binds = [d for d in record["decisions"] if d["kind"] == "bind"]
            check(len(binds) == len(out["binds"]) and sorted(d["node"] for d in binds)
                  == sorted(host for _, host in out["binds"]),
                  f"{what}: {len(binds)} bind decisions for {len(out['binds'])} binds")
            names = {e["name"] for e in record["events"]}
            missing = {"dispatch:allocate", "kernel:execute", "kernel:pack", "open_session",
                       "close_session", "action:gpu-allocate"} - names
            check(not missing, f"{what}: the record lacks {sorted(missing)}")
            check(("snapshot-capture" in names) == capture,
                  f"{what}: snapshot-capture {'missing' if capture else 'recorded'}")
            dispatched = {e["args"]["executor"] for e in record["events"]
                          if e["name"] == "dispatch:allocate"}
            check(dispatched == {"cuda"}, f"{what}: dispatch:allocate named {dispatched}")
            write_ms, capture_ms = writes.take(), captures.take()
            check(len(write_ms) == 1 and len(capture_ms) == int(capture),
                  f"{what}: {len(write_ms)} journal writes, {len(capture_ms)} captures")
            cyc = dict(cycle=k, binds=len(out["binds"]), launches=launches,
                       run_once_ms=out["e2e_s"] * 1e3, events=len(record["events"]),
                       decisions=len(record["decisions"]), journal_write_ms=write_ms[0],
                       capture_ms=capture_ms[0] if capture else None)
            if capture:
                cycles.append(cyc)
            else:
                events_only = cyc
                check(trace.Journal(journal_dir + "-events").snapshot_cycles() == [],
                      f"{what}: a snapshot in the events-only journal")
                rec = captured
    finally:
        loop.close()
        trace.disable()
    # the capturing recorder goes back for /trace/last: its last cycle
    # stays readable
    return dict(cell=name, pods=len(objects[1]), nodes=len(objects[0]), cycles=cycles,
                events_only=events_only, recorder=rec)


def replay_cycles(journal_dir: str, cycles, executor: str) -> list:
    """``trace.verify`` of each captured cycle through ``executor``: a
    match, and for ``cuda`` the session kernel launched inside the
    replay.  The npz load (``Journal.read_snapshot``) is timed apart
    from the run."""
    import torch

    from volcano_tpu_torch import trace
    from volcano_tpu_torch.ops import session_kernel

    journal = trace.Journal(journal_dir)
    loads = Stopwatch(journal, "read_snapshot")
    out = []
    for c in cycles:
        torch.cuda.synchronize()
        session_kernel.LAUNCHES = session_kernel.WIDE_LAUNCHES = 0
        t0 = time.perf_counter()
        result = trace.verify(journal, cycle=c, executor=executor)
        total_ms = (time.perf_counter() - t0) * 1e3
        launches = session_kernel.LAUNCHES + session_kernel.WIDE_LAUNCHES
        (load_ms,) = loads.take()
        what = f"{journal_dir} cycle {c} through {executor}"
        check(result.match, f"{what}: {result.summary()} {result.diffs[:5]}")
        check(result.recorded_executor == "cuda",
              f"{what}: recorded executor {result.recorded_executor!r}")
        check((launches > 0) == (executor == "cuda"), f"{what}: {launches} kernel launches")
        out.append(dict(cycle=c, executor=executor, tasks=result.n_tasks,
                        placed=result.n_placed_replayed, launches=launches, load_ms=load_ms,
                        run_ms=total_ms - load_ms))
    return out


def recorder_cost(card: str) -> dict:
    """The recorder's cost on LOOP_A's warm cycles, interleaved in one
    run: after a cold cycle with the recorder off, the warm cycles take
    RECORDER_COST_ORDER's modes in turn — off (the null recorder),
    events (a journal, ``snapshot_every=0``) and capture (every cycle
    captured).  Per mode the median ``run_once_ms`` and collector ms
    inside ``run_once`` (``GcClock``), and the journal write and npz
    capture ms.  Printed, not gated; every cycle's digest still
    checked."""
    import shutil
    import tempfile

    from volcano_tpu_torch import trace

    spec = LOOP_CELLS[LOOP_A]
    objects = loop_objects(spec["config"])
    root = tempfile.mkdtemp(prefix="vtpu-cost-")
    modes = ("off",) + RECORDER_COST_ORDER
    by_mode = {m: dict(run_once_ms=[], gc_ms=[], journal_write_ms=[], capture_ms=[])
               for m in ("off", "events", "capture")}
    try:
        with GcClock() as gc_clock:
            loop = loop_cycles(objects, spec["tiers"], spec["actions"], len(modes),
                               spec["between"], cycle_window=gc_clock.cycle)
            for k, mode in enumerate(modes):
                watches = ()
                if mode == "off":
                    trace.disable()
                else:
                    rec = trace.enable(f"{root}/{mode}",
                                       snapshot_every=1 if mode == "capture" else 0)
                    watches = (Stopwatch(rec.journal, "write_cycle"),
                               Stopwatch(rec.journal, "write_snapshot"))
                gc_clock.take()
                out = next(loop)
                gc_ms = gc_clock.take()["gc_ms"]
                digest = cycle_digest(out["binds"])
                check(digest == CYCLE_DIGESTS[spec["config"]],
                      f"recorder cost cycle {k} ({mode}): digest {digest}")
                if k == 0:
                    continue  # the cold cycle
                m = by_mode[mode]
                m["run_once_ms"].append(out["e2e_s"] * 1e3)
                m["gc_ms"].append(gc_ms)
                if watches:
                    m["journal_write_ms"] += watches[0].ms
                    m["capture_ms"] += watches[1].ms
    finally:
        trace.disable()
        shutil.rmtree(root, ignore_errors=True)
    med = {m: {key + "_median": (statistics.median(v) if v else None)
               for key, v in vals.items()} for m, vals in by_mode.items()}
    off = med["off"]["run_once_ms_median"]
    return dict(cell=LOOP_A, order=list(modes), card=card, samples=by_mode, medians=med,
                events_overhead=med["events"]["run_once_ms_median"] / off - 1,
                capture_overhead=med["capture"]["run_once_ms_median"] / off - 1)


def phase_replay(card: str) -> dict:
    """The trace recorder, the cycle journal and replay on the card.
      * LOOP_A's first 2 cycles, LOOP_C's preempting cycle and LOOP_B's
        first 3 churn cycles run with ``trace.enable(dir,
        snapshot_every=1)``, and LOOP_A's third with ``snapshot_every=0``
        (``recorded_loop``: each cycle's JAX digest, executor ``cuda``,
        its journal record complete);
      * every captured cycle replays through
        ``trace.verify(dir, cycle=c, executor="cuda")``: a match, with
        the session kernel launched inside each replay (the snapshot's
        full put, as a sidecar child takes it);
      * REPLAY_NATIVE's cycles replay through ``native``, the C++ host
        baseline on this machine's CPU: a match;
      * a ``ServingServer`` with the debug gate open serves the last
        recorded cycle of the process-global recorder at
        ``/trace/last``: its Chrome JSON, ``X`` spans and the decisions
        track;
      * ``python -m volcano_tpu_torch.cmd.trace replay --dir D
        --executor cuda`` exits 0 in a child process.
    One ``{"replay": ...}`` line.  The recorder's cost (``recorder_cost``,
    ~33 s) runs by hand only since the Job path's phases took its room;
    the events-only journal it drove runs in ``recorded_loop``."""
    import os
    import shutil
    import tempfile

    from volcano_tpu_torch import trace
    from volcano_tpu_torch.serving.http import ServingServer

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="vtpu-journal-")
    recorded, replays, native = {}, {}, {}
    try:
        for name in REPLAY_CELLS:
            recorded[name] = recorded_loop(name, os.path.join(root, name))
        for name in REPLAY_CELLS:
            d = os.path.join(root, name)
            caps = trace.Journal(d).snapshot_cycles()
            check(caps == [c["cycle"] for c in recorded[name]["cycles"]],
                  f"{name}: captured cycles {caps}")
            replays[name] = replay_cycles(d, caps, "cuda")
            if name in REPLAY_NATIVE:
                native[name] = replay_cycles(d, REPLAY_NATIVE[name], "native")

        rec = recorded[LOOP_B].pop("recorder")
        trace.set_recorder(rec)
        server = ServingServer(port=0, debug_enabled=True).start()
        try:
            status, body = http_get(server.port, "/trace/last")
        finally:
            server.stop()
            trace.disable()
        check(status == 200, f"/trace/last answered {status}")
        served = json.loads(body)
        want = json.loads(json.dumps(trace.chrome_trace(rec.last_cycle())))
        events = served.get("traceEvents", [])
        check(served == want and served["metadata"]["cycle"] == rec.last_cycle()["cycle"]
              and any(e["ph"] == "X" and e["name"] == "action:gpu-allocate" for e in events)
              and sum(e["cat"] == "decision" and e["tid"] == 0 for e in events)
              == recorded[LOOP_B]["cycles"][-1]["decisions"],
              f"/trace/last served cycle {served.get('metadata')}, not the last recorded")

        t0 = time.perf_counter()
        here = os.path.dirname(os.path.abspath(__file__))
        proc = subprocess.run(
            [sys.executable, "-m", "volcano_tpu_torch.cmd.trace", "replay", "--dir",
             os.path.join(root, LOOP_B), "--executor", "cuda"],
            cwd=here, env=dict(os.environ, PYTHONPATH=here), capture_output=True, text=True,
            timeout=300)
        cmd_s = time.perf_counter() - t0
        check(proc.returncode == 0 and "IDENTICAL" in proc.stdout,
              f"cmd.trace replay exited {proc.returncode}: {proc.stdout} {proc.stderr[-2000:]}")
    finally:
        trace.disable()
        shutil.rmtree(root, ignore_errors=True)
    for cell in recorded.values():
        cell.pop("recorder", None)
    out = dict(recorded=recorded, replays=replays, native=native,
               trace_last_bytes=len(body), cmd_trace_s=cmd_s, cmd_trace=proc.stdout.strip(),
               phase_ms=(time.perf_counter() - t_phase) * 1e3, card=card)
    events_only = recorded[LOOP_A]["events_only"]
    print(f"replay: {LOOP_A} cycle {events_only['cycle']} journaled with events only, "
          f"run_once {events_only['run_once_ms']:.3f} ms, journal write "
          f"{events_only['journal_write_ms']:.3f} ms; "
          f"{sum(len(v) for v in replays.values())} captured cycles replayed through "
          f"the session kernel with zero diff, run ms "
          f"{[round(r['run_ms'], 3) for v in replays.values() for r in v]}, load ms "
          f"{[round(r['load_ms'], 3) for v in replays.values() for r in v]}; native run ms "
          f"{ {k: [round(r['run_ms'], 3) for r in v] for k, v in native.items()} }; "
          f"card {card}")
    print(json.dumps({"replay": out}))
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


#: the two phases' seconds in PR 13's runs of its final tree, before the
#: flight recorder was in them
PR13_PHASE_S = {"phase_daemon": (71.3, 87.0), "phase_bus": (81.1, 91.5)}


def obs_line(card: str, daemon_rec: dict, bus_rec: dict, daemon_s: float,
             bus_s: float) -> dict:
    """The ``{"obs": ...}`` line: each phase's recorder numbers beside its
    seconds (as its ``time:`` line counts them) and PR 13's."""
    return dict(card=card, **{
        phase: dict(phase_s=s, pr13_phase_s=PR13_PHASE_S[phase], **rec["obs"])
        for phase, rec, s in (("phase_daemon", daemon_rec, daemon_s),
                              ("phase_bus", bus_rec, bus_s))})


def timed(phase, *args, **kwargs):
    """Run a phase and print the seconds of wall clock it took, with its
    first argument where it has one (the cell or config), and the CPU
    seconds this process spent in it (every thread): a phase whose wall
    clock grows between runs while its CPU seconds do not waited on
    children, the card or the host, and one whose CPU seconds grow with
    it ran slower on the host's cores."""
    t0, cpu0 = time.perf_counter(), time.process_time()
    out = phase(*args, **kwargs)
    cells = {MAIN_CONFIG, SECOND_CONFIG, PREEMPT_CYCLE_MAIN, PREEMPT_CYCLE_SECOND, *LOOP_CELLS}
    what = f" {args[0]}" if args and args[0] in cells else ""
    print(f"time: {phase.__name__}{what} {time.perf_counter() - t0:.1f} s "
          f"(cpu {time.process_time() - cpu0:.1f} s)")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU", file=sys.stderr)
        return 1
    import volcano_tpu_torch  # noqa: F401 — without the checkout, fail before any output

    specs = SpecPool()
    try:
        return run_phases(specs)
    finally:
        specs.close()


def run_phases(specs: SpecPool) -> int:
    """Every phase in order (the spec checks after the loop phases), then
    the kernels line and the result line."""
    import torch

    card = card_line()
    print(f"card: {card}")
    print(f"host: {len(os.sched_getaffinity(0))} cores for this process")
    timed(phase_build)
    timed(phase_kernel_vs_plain)
    timed(phase_preempt_kernel_vs_plain)
    timed(phase_int_kernel_vs_plain)
    timed(phase_wide_kernel_vs_plain)
    main_rec = timed(phase_main_path, MAIN_CONFIG, card, compare_plain=True, specs=specs)
    second_rec = timed(phase_main_path, SECOND_CONFIG, card, compare_plain=False, specs=specs)
    pre_rec = timed(phase_preempt_main_path, card)
    dgx_rec = timed(phase_dgx_cell, card, main_rec["ms"], specs)
    wide_rec = timed(phase_wide_cell, card, specs)
    timed(phase_lanes_session, card, specs)
    blocked_rec = timed(phase_blocked_vs_kernel, card, main_rec)
    sharded_rec = timed(phase_sharded_vs_kernel, card,
                        {MAIN_CONFIG: main_rec, SECOND_CONFIG: second_rec})
    cycle_rec = timed(phase_cycle, MAIN_CONFIG, card)
    timed(phase_cycle, SECOND_CONFIG, card)
    preempt_cycle_rec = timed(phase_preempt_cycle, PREEMPT_CYCLE_MAIN, card)
    timed(phase_preempt_cycle, PREEMPT_CYCLE_SECOND, card)
    loop_recs = {cell: timed(phase_loop, cell, card) for cell in LOOP_CELLS}
    plain_errs = specs.check_all()
    specs.close()
    for rec, cell in ((main_rec, MAIN_CONFIG), (wide_rec, WIDE_CELL)):
        rec["max_abs_err"] = max(rec["max_abs_err"], plain_errs[cell])
    micro_recs = timed(phase_micro, card)
    store_recs = timed(phase_store, card)
    t0 = time.perf_counter()
    daemon_rec = timed(phase_daemon, card)
    t1 = time.perf_counter()
    bus_rec = timed(phase_bus, card)
    print(json.dumps({"obs": obs_line(card, daemon_rec, bus_rec, t1 - t0,
                                      time.perf_counter() - t1)}))
    ha_rec = timed(phase_ha, card)
    fed_rec = timed(phase_federation, card)
    jobs_rec = timed(phase_jobs, card)
    local_up_rec = timed(phase_local_up, card)
    sidecar_rec = timed(phase_sidecar, card, loop_recs)
    replay_rec = timed(phase_replay, card)
    from volcano_tpu_torch import faults

    check(kernel_failures() == 0 and not faults.degraded_reasons(),
          f"the main paths counted {kernel_failures():.0f} kernel failures: "
          f"{faults.degraded_reasons()}")
    timed(phase_failures, card)

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
            "plain_rows": main_rec["plain_rows"],
            "plain_kernel_ms": main_rec["plain_kernel_ms"],
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
            "loop_launches": loop_recs[LOOP_A]["cycles"][-1]["launches"],
            "sidecar_launches": sidecar_rec["cycles"][-1]["child_launches"],
            "replay_launches": replay_rec["replays"][LOOP_A][-1]["launches"],
            "micro_launches": [w["launches"] for cell in MICRO_CARD_CELLS
                               for mode in micro_recs[cell]["modes"].values()
                               for w in mode["windows"] if w["route"] != "full"],
            "store_launches": {cell: [c["launches"] for mode in store_recs[cell]["modes"].values()
                                      for c in mode["cycles"]]
                               for cell in (STORE_CYCLE, STORE_CHURN, STORE_PREEMPT)},
            "daemon_launches": {"leader": daemon_rec["a_launches"],
                                "standby": daemon_rec["b_launches"]},
            "bus_launches": {"leader": bus_rec["a_launches"],
                             "standby": bus_rec["b_launches"]},
            "jobs_launches": {"binding_cycles": jobs_rec["binding_cycles"],
                              "launches": jobs_rec["launches"]},
            "local_up_launches": local_up_rec["launches"],
            "ha_launches": {"before_kill": ha_rec["launches"],
                            "after_kill": ha_rec["launches_after"]},
            "federation_launches": {
                "one_shard": fed_rec["one_shard"]["launches"],
                "two_shards": fed_rec["two_shards"]["launches"],
                "after_kill": fed_rec["two_shards"]["arrivals"]["launches"]},
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
            "plain_rows": wide_rec["plain_rows"],
            "plain_kernel_ms": wide_rec["plain_kernel_ms"],
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
            "loop_launches": loop_recs[LOOP_C]["cycles"][-1]["preempt_launches"],
            "sidecar_launches": sidecar_rec["preempt_cycle"]["child_launches"]["preempt"],
            "store_launches": [c["preempt_launches"]
                               for mode in store_recs[STORE_PREEMPT]["modes"].values()
                               for c in mode["cycles"]],
            "library_ms": None,
        },
    ]
    # the blocked and sharded formulations are torch ops, not kernels:
    # their times on lines of their own
    print(json.dumps({"blocked": dict(
        route="torch ops", source="volcano_tpu_torch/ops/blocked.py",
        replaces="volcano_tpu/ops/blocked.py:168", top_k=BLOCKED_TOP_K,
        wide_session_ms=wide_rec["blocked_session_ms"], wide_blocks=wide_rec["blocked_blocks"],
        wide_stops=wide_rec["blocked_stops"], **blocked_rec)}))
    print(json.dumps({"sharded": dict(
        route="torch ops", source="volcano_tpu_torch/ops/sharded.py",
        replaces="volcano_tpu/ops/sharded.py:65", top_k=BLOCKED_TOP_K, **sharded_rec)}))
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
