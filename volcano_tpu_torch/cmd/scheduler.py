"""vtpu-scheduler — the scheduler daemon.

The port of ``volcano_tpu/cmd/scheduler.py``.  Reference:
cmd/scheduler/app/server.go:77-157 — metrics HTTP server (:96-99),
healthz (:101), optional ConfigMap-lock leader election (:110-156)
around ``Scheduler.Run``.  Options mirror
cmd/scheduler/app/options/options.go:44-66.

Usage: python -m volcano_tpu_torch.cmd.scheduler [--bus tcp://host:port]
       [--leader-elect --leader-elect-id ID] [--scheduler-conf FILE]
       [--pipelined-commit] [--snapshot-reuse] [--warmup] [--device cuda|cpu]
       [--flight-recorder] [--watchdog] [--incident-dir DIR]
       [--shards N --shard-identity ID --shard-lease-duration S
        --gang-broker on|off --shard-autoscale on|off --autoscale-...]

``--device`` defaults to ``cuda``, where gpu-allocate, gpu-preempt and
gpu-reclaim run their kernels, and the process exits at start when
there is no GPU; ``--device cpu`` registers their CPU instances (the
plain PyTorch versions).  SIGTERM and SIGINT stop the daemon (a leader
releases its lease); SIGUSR1 logs one line, ``scheduler status:`` and a
JSON object: the kernel launches made in this process (``session``,
``session_wide``, ``preempt``), those of them made before the daemon
started (``warmup``, by ``--warmup``), the device memory it holds, and,
once the daemon is built, ``SchedulerDaemon.status()`` (cycles, cycles
that raised, skipped turns, renews and the longest gap between them,
resync entries, quarantined tasks).  ``--flight-recorder`` exports the
daemon's spans (cycles, kernel phases, commit flushes, bus requests,
landed binds) to the bus, where ``python -m volcano_tpu_torch.cli.vtctl
--bus URL trace pod -N NAME`` renders them; ``--watchdog`` runs the SLO
burn-rate watchdog, whose breaches degrade /healthz and write incident
bundles under ``--incident-dir``.  ``--shards N`` makes the daemon one
member of the sharded scheduler federation (``federation/``): it leases
node shards of the shard map over the store, schedules its slice, spills
over through ``cas_bind`` and assembles cross-shard gangs through
``txn_commit``; ``--leader-elect`` is then ignored (each member is
active over its own slice), the ``shard`` identity label is set, and the
``shard.kill`` fault point hard-exits the process.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import time

from volcano_tpu_torch.cache import SchedulerCache
from volcano_tpu_torch.client import APIServer, SchedulerClient
from volcano_tpu_torch.cmd.daemon import apply_faults, BaseDaemon, kernel_status, serve_forever
from volcano_tpu_torch.scheduler.scheduler import Scheduler
from volcano_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def _explain_source(daemon: "SchedulerDaemon", namespace: str, job: str):
    from volcano_tpu_torch.serving.explain import explain_jobs

    cache = getattr(daemon, "cache", None)
    if cache is None:  # pragma: no cover — request before construction done
        return {"jobs": []}
    return explain_jobs(cache, namespace, job)


class SchedulerDaemon(BaseDaemon):
    """The scheduler binary: cache + session loop + serving surface."""

    LOCK_NAME = "vtpu-scheduler"
    NAME = "vtpu-scheduler"

    def __init__(
        self,
        api: APIServer,
        scheduler_conf: str = "",
        schedule_period: float = 1.0,
        scheduler_name: str = "volcano-tpu",
        gc_quiesce_period: int = 0,
        snapshot_reuse: bool = False,
        cycle_deadline_ms=None,
        pipelined_commit: bool = False,
        micro_cycles: bool = False,
        micro_debounce_ms: float = 5.0,
        restricted_sessions: bool = False,
        shards: int = 0,
        shard_identity: str = "",
        shard_lease_duration: float = 2.0,
        gang_broker: bool = True,
        shard_autoscale=None,
        **daemon_kw,
    ):
        # /explain reads self.cache lazily (set right below) — the
        # serving server only dereferences at request time.  In micro
        # mode one _work call IS a whole schedule-period window (the
        # scheduler waits on its condition variable inside), so the
        # daemon's own inter-work sleep shrinks to a leadership-check
        # granularity instead of stacking a second period on top.
        super().__init__(
            api, period=0.05 if micro_cycles else schedule_period,
            explain_source=lambda ns, job: _explain_source(self, ns, job),
            **daemon_kw,
        )
        self.federation = None
        if shards >= 1:
            self.identity_labels["shard"] = shard_identity or self.identity
            # sharded federation: the shard-assignment leases replace
            # the leader-elected standby pattern (each member is active
            # over its own slice), so --leader-elect is ignored here
            from volcano_tpu_torch.federation import FederatedScheduler

            self.federation = FederatedScheduler(
                api,
                identity=shard_identity or self.identity,
                n_shards=shards,
                scheduler_conf_path=scheduler_conf,
                period=schedule_period,
                micro_cycles=micro_cycles,
                micro_debounce_ms=micro_debounce_ms,
                lease_duration=shard_lease_duration,
                pipelined_commit=pipelined_commit,
                snapshot_reuse=snapshot_reuse,
                scheduler_name=scheduler_name,
                gang_broker=gang_broker,
                kill_mode="exit",  # shard.kill hard-exits the process
                autoscale=shard_autoscale,
                restricted_sessions=restricted_sessions,
            )
            self.elector = None
            self.cache = self.federation.cache
            self.scheduler = self.federation.scheduler
            if cycle_deadline_ms is not None:
                from volcano_tpu_torch.faults import watchdog

                watchdog.configure_deadline(cycle_deadline_ms)
            if gc_quiesce_period:
                self.scheduler.gc_quiesce_period = gc_quiesce_period
            return
        self.cache = SchedulerCache(
            client=SchedulerClient(api),
            scheduler_name=scheduler_name,
            snapshot_reuse=snapshot_reuse,
            pipelined_commit=pipelined_commit,
        )
        self.scheduler = Scheduler(
            self.cache, scheduler_conf_path=scheduler_conf,
            period=schedule_period, gc_quiesce_period=gc_quiesce_period,
            cycle_deadline_ms=cycle_deadline_ms,
            micro_cycles=micro_cycles,
            micro_debounce_ms=micro_debounce_ms,
            restricted_sessions=restricted_sessions,
        )

    def _on_start(self) -> None:
        # informers first, and their first lists in the cache before the
        # loop starts (over the bus the lists arrive on the client's
        # dispatch thread; the reference scheduler's WaitForCacheSync)
        t0 = time.perf_counter()
        if self.federation is not None:
            # published on the lease-map stats blob so `vtctl top`
            # discovers this member's /metrics without configuration
            self.federation.metrics_addr = f"{self.serving.host}:{self.serving.port}"
            self.federation.start()  # cache.run() + the lease loop
        else:
            self.cache.run()
        self.cache.wait_for_cache_sync()
        log.info("%s %s: informers synced in %.1f ms", self.NAME, self.identity,
                 (time.perf_counter() - t0) * 1e3)

    def _work(self) -> None:
        if self.scheduler.micro_cycles:
            self.scheduler.run_cycle_window()
        else:
            self.scheduler.run_once()

    def status(self) -> dict:
        """``BaseDaemon.status`` and the cache's failed effects: its
        resync entries and quarantined tasks."""
        return dict(super().status(), resync=len(self.cache.err_tasks),
                    quarantined=len(self.cache.quarantined_tasks))

    def stop(self, crash: bool = False) -> None:
        # wake the scheduler's condition wait first, or the loop join
        # would wait out the in-flight window
        self.scheduler.stop()
        if self.federation is not None:
            if crash:
                self.federation.crash()
            else:
                self.federation.stop()
        super().stop(crash=crash)


def add_common_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--listen-host", default="127.0.0.1")
    parser.add_argument("--listen-port", type=int, default=8080)
    parser.add_argument("--leader-elect", action="store_true")
    parser.add_argument("--leader-elect-id", default=None)
    parser.add_argument(
        "--bus", default="",
        help="connect to an out-of-process vtpu-apiserver at "
        "tcp://host:port instead of running an in-process store "
        "(the reference's multi-binary deployment topology)",
    )
    parser.add_argument(
        "--enable-debug-stacks", action="store_true",
        help="serve /debug/stacks to non-loopback clients (forensics; "
        "stack dumps expose internals — default loopback-only)",
    )
    parser.add_argument(
        "--faults", default="",
        help="deterministic fault-injection schedule, e.g. "
        "'seed=42;bus.disconnect=0.05;compute.crash=0.1:count=2' "
        "(volcano_tpu_torch.faults; same grammar as VTPU_FAULTS — chaos "
        "testing only, never set in production)",
    )
    parser.add_argument(
        "--flight-recorder", action="store_true",
        help="cluster-wide flight recorder (volcano_tpu_torch/obs): record "
        "cross-process spans and export them to the bus as telemetry "
        "segments for `vtctl trace pod/gang` (drop-not-block; also "
        "VTPU_FLIGHT_RECORDER=1; sampling via VTPU_TELEMETRY_SAMPLE)",
    )
    parser.add_argument(
        "--watchdog", action="store_true",
        help="SLO burn-rate watchdog (volcano_tpu_torch/obs/slo.py): "
        "continuously evaluate declared SLOs over fast/slow windows "
        "of this process's own metrics; breaches surface on /healthz "
        "as degraded 'slo-burn:<name>', as volcano_slo_burn gauges, "
        "and trigger incident bundles (also VTPU_WATCHDOG=1; "
        "objectives overridable via VTPU_SLO_OBJECTIVES)",
    )
    parser.add_argument(
        "--incident-dir", default=None,
        help="directory for the bounded on-disk incident-bundle ring "
        "written when the watchdog breaches or `vtctl incidents "
        "capture` asks (default <tmp>/vtpu-incidents-<identity>; also "
        "VTPU_INCIDENT_DIR)",
    )


def resolve_bus(bus: str):
    """``--bus`` → backend for the daemon mains: dial failures become a
    clean exit instead of a traceback."""
    from volcano_tpu_torch.bus import BusError, connect_bus

    try:
        return connect_bus(bus)
    except BusError as e:
        raise SystemExit(str(e)) from e


def use_device(device: str) -> None:
    """``--device``: ``cuda`` (no GPU is an exit at start, before any
    work) or ``cpu``, which registers the CPU instances of gpu-allocate,
    gpu-preempt and gpu-reclaim under their names."""
    import torch

    if device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: vtpu-scheduler runs its kernels on cuda "
                             "unless given --device cpu")
        return
    from volcano_tpu_torch.actions.gpu_allocate import GpuAllocateAction
    from volcano_tpu_torch.actions.gpu_preempt import GpuPreemptAction
    from volcano_tpu_torch.actions.gpu_reclaim import GpuReclaimAction
    from volcano_tpu_torch.framework import register_action

    for action in (GpuAllocateAction, GpuPreemptAction, GpuReclaimAction):
        register_action(action(device=device))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="vtpu-scheduler")
    parser.add_argument("--scheduler-conf", default="")
    parser.add_argument("--schedule-period", type=float, default=1.0)
    parser.add_argument("--scheduler-name", default="volcano-tpu")
    parser.add_argument(
        "--gc-quiesce-period", type=int, default=0,
        help="every N cycles, gc-collect and freeze survivors so "
        "sessions stop re-traversing the long-lived cache graph "
        "(0 = off)",
    )
    parser.add_argument(
        "--snapshot-reuse", action="store_true",
        help="reuse the previous session's untouched clones at session "
        "open (warm-cycle optimization; relies on the shipped actions' "
        "touched-set discipline — leave off with out-of-tree actions)",
    )
    parser.add_argument(
        "--pipelined-commit", action="store_true",
        help="overlap the commit path (binds, evictions, status "
        "writebacks) with the next cycle's pack+device phase: effects "
        "queue onto bind workers, coalesce into batched commit frames, "
        "and a commit barrier at the next snapshot preserves coherence",
    )
    parser.add_argument(
        "--micro-cycles", action="store_true",
        help="event-driven scheduling: wake on watch-event arrival and "
        "run an incremental micro-cycle over the coalesced change "
        "instead of waiting out --schedule-period; full cycles keep "
        "running every period",
    )
    parser.add_argument(
        "--micro-debounce-ms", type=float, default=5.0,
        help="event-storm coalescing window: after the first watch "
        "event wakes the loop, wait this long so the rest of the burst "
        "lands in the same micro-cycle",
    )
    parser.add_argument(
        "--restricted-sessions", action="store_true",
        help="open micro-cycle sessions over only the jobs with "
        "schedulable work (plus the share ledger's seeded fair-share "
        "state), cross-checked by sampled shadow full sessions.  "
        "Requires --micro-cycles",
    )
    parser.add_argument(
        "--shards", type=int, default=0,
        help="sharded scheduler federation: run as one of N scheduler "
        "processes each owning a disjoint node shard via bus-backed "
        "shard-assignment leases, with cross-shard spillover binds for "
        "jobs that fail to place on their home shard (0 = off; 1 = "
        "single-shard federation, bit-identical to the plain scheduler)",
    )
    parser.add_argument(
        "--shard-identity", default="",
        help="stable identity in the shard map (defaults to the daemon "
        "identity); distinct per federation member",
    )
    parser.add_argument(
        "--shard-lease-duration", type=float, default=2.0,
        help="shard lease TTL, seconds: a crashed member's slices are "
        "absorbed by survivors within one TTL",
    )
    parser.add_argument(
        "--shard-autoscale", choices=("on", "off"), default="off",
        help="SLO-driven shard autoscaling: the member holding shard "
        "0's lease grows/shrinks the map's shard count one step at a "
        "time from sustained fleet p99 / queue-depth signals "
        "(hysteresis + cooldown); every member then ADOPTS the map's "
        "count instead of refusing a mismatch.  The controller moves "
        "the target only — the deploy layer scales the member fleet "
        "to follow it",
    )
    parser.add_argument(
        "--autoscale-min", type=int, default=1,
        help="shard-count floor the autoscaler never shrinks below",
    )
    parser.add_argument(
        "--autoscale-max", type=int, default=8,
        help="shard-count ceiling the autoscaler never grows past",
    )
    parser.add_argument(
        "--autoscale-up-p99-ms", type=float, default=500.0,
        help="scale up when the fleet's windowed submit→bind p99 "
        "sustains above this",
    )
    parser.add_argument(
        "--autoscale-up-pending", type=int, default=64,
        help="scale up when schedulable-pending tasks per shard "
        "sustain above this",
    )
    parser.add_argument(
        "--autoscale-down-p99-ms", type=float, default=50.0,
        help="scale down only when p99 sustains below this (AND the "
        "pending bar) — the hysteresis gap against flapping",
    )
    parser.add_argument(
        "--autoscale-down-pending", type=int, default=8,
        help="scale down only when pending per shard sustains below "
        "this (AND the p99 bar)",
    )
    parser.add_argument(
        "--autoscale-sustain", type=int, default=3,
        help="consecutive breaching evaluations before a decision",
    )
    parser.add_argument(
        "--autoscale-cooldown-s", type=float, default=30.0,
        help="minimum seconds between committed shard-count changes",
    )
    parser.add_argument(
        "--autoscale-period-s", type=float, default=2.0,
        help="evaluation cadence of the autoscale controller",
    )
    parser.add_argument(
        "--gang-broker", choices=("on", "off"), default="on",
        help="cross-shard gang assembly: a home-owned gang below "
        "minMember solicits foreign capacity and commits a full-gang "
        "placement via one atomic txn_commit (VBUS v6).  'off' keeps "
        "the pre-v6 refusal semantics: such a gang stays Pending at "
        "home, never partially placed",
    )
    parser.add_argument(
        "--warmup", action="store_true",
        help="build the kernel library and launch the session kernel "
        "once before the first cycle (same flag as vtpu-compute-plane)",
    )
    parser.add_argument(
        "--cycle-deadline-ms", type=float, default=0,
        help="cycle watchdog: a device phase that would overrun this "
        "wall-clock budget raises out of the cycle, which binds "
        "nothing (0 = off)",
    )
    # Host node subsampling (options.go:38-40, honored by the host
    # predicate loop via scheduler_helper's feasible-node budget).
    parser.add_argument(
        "--percentage-nodes-to-find", type=int, default=100,
        help="stop the host predicate scan after finding this percent "
        "of nodes feasible (100 = scan all; 0 = adaptive, shrinking "
        "with cluster size like the reference)",
    )
    parser.add_argument(
        "--minimum-feasible-nodes", type=int, default=100,
        help="never subsample below this many feasible nodes "
        "(options.go MinNodesToFind)",
    )
    parser.add_argument(
        "--minimum-percentage-nodes-to-find", type=int, default=5,
        help="floor for the adaptive percentage "
        "(options.go MinPercentageOfNodesToFind)",
    )
    parser.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="where the device actions run their kernels: cuda (the "
        "default; no GPU is an error) or cpu (the plain PyTorch versions)",
    )
    add_common_args(parser)
    return parser


def _autoscale_policy(args):
    """``--shard-autoscale on`` → the controller's policy from the
    ``--autoscale-*`` flags; None when off."""
    if args.shard_autoscale != "on":
        return None
    from volcano_tpu_torch.federation.autoscale import AutoscalePolicy

    return AutoscalePolicy(
        min_shards=args.autoscale_min,
        max_shards=args.autoscale_max,
        up_p99_ms=args.autoscale_up_p99_ms,
        up_pending=args.autoscale_up_pending,
        down_p99_ms=args.autoscale_down_p99_ms,
        down_pending=args.autoscale_down_pending,
        sustain=args.autoscale_sustain,
        cooldown_s=args.autoscale_cooldown_s,
        eval_period_s=args.autoscale_period_s,
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    apply_faults(args.faults)
    use_device(args.device)  # no GPU → exit before any work
    daemon, warmup = None, {}

    def status(*_):
        line = dict(kernel_status(), warmup=warmup)
        if daemon is not None:
            line.update(daemon.status())
        log.info("scheduler status: %s", json.dumps(line))

    signal.signal(signal.SIGUSR1, status)

    from volcano_tpu_torch.scheduler import util as sched_util

    sched_util.server_opts = sched_util.ServerOpts(
        min_nodes_to_find=args.minimum_feasible_nodes,
        min_percentage_of_nodes_to_find=args.minimum_percentage_nodes_to_find,
        percentage_of_nodes_to_find=args.percentage_nodes_to_find,
    )

    if args.warmup:
        if os.environ.get("VTPU_COMPUTE_PLANE"):
            # kernels run in the sidecar (which has its own --warmup);
            # the in-process copies only serve the failure fallback —
            # don't block startup building them
            log.info("skipping local warmup: VTPU_COMPUTE_PLANE is set "
                     "(warm the sidecar with its own --warmup)")
        else:
            from volcano_tpu_torch.ops.dispatch import warmup_kernels

            warmup_kernels(device=args.device)  # times and logs itself
    warmup.update((k, v) for k, v in kernel_status().items() if k != "memory_reserved")

    daemon = SchedulerDaemon(
        resolve_bus(args.bus),
        scheduler_conf=args.scheduler_conf,
        schedule_period=args.schedule_period,
        scheduler_name=args.scheduler_name,
        gc_quiesce_period=args.gc_quiesce_period,
        snapshot_reuse=args.snapshot_reuse,
        cycle_deadline_ms=args.cycle_deadline_ms or None,
        pipelined_commit=args.pipelined_commit,
        micro_cycles=args.micro_cycles,
        micro_debounce_ms=args.micro_debounce_ms,
        restricted_sessions=args.restricted_sessions,
        shards=args.shards,
        shard_identity=args.shard_identity,
        shard_lease_duration=args.shard_lease_duration,
        gang_broker=args.gang_broker == "on",
        shard_autoscale=_autoscale_policy(args),
        listen_host=args.listen_host,
        listen_port=args.listen_port,
        leader_elect=args.leader_elect,
        identity=args.leader_elect_id,
        debug_enabled=args.enable_debug_stacks,
        flight_recorder=True if args.flight_recorder else None,
        watchdog=True if args.watchdog else None,
        incident_dir=args.incident_dir,
    )
    return serve_forever(daemon)


if __name__ == "__main__":
    raise SystemExit(main())
