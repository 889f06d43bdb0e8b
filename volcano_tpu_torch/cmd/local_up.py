"""vtpu-local-up — bring up the whole control plane.

A copy of ``volcano_tpu/cmd/local_up.py``.  With ``--multiproc``,
``--apiserver-replicas N`` spawns the replicated persistent bus (N
apiserver children with per-replica WAL directories under
``--apiserver-data-dir``, lease ``--repl-lease-ttl``), and the children
and this process talk over the same-host shm rings (``VTPU_BUS_SHM=1``,
falling back to TCP where an attach fails).  ``--device`` (``cuda`` by
default, ``cpu`` for the CPU instances of gpu-allocate, gpu-preempt and
gpu-reclaim) places the scheduler: the in-process daemon's, or the
scheduler children's with ``--multiproc``; without ``--device cpu`` and
without a GPU the run exits at start.  ``--log-dir`` keeps each child's
output in a file of its own.

Usage: python -m volcano_tpu_torch.cmd.local_up --demo [--device cpu]
       python -m volcano_tpu_torch.cmd.local_up --multiproc --demo
           [--standby-scheduler] [--log-dir DIR]
           [--apiserver-replicas 3 --apiserver-data-dir DIR]

The standalone equivalent of hack/local-up-volcano.sh.  Three topologies:

* default: one in-process API server with admission + controllers +
  scheduler daemon threads (the original single-process simulation);
* ``--bus tcp://host:port``: the same daemon threads, but connected to
  an already-running external ``vtpu-apiserver``;
* ``--multiproc``: the reference's deployment topology — spawns
  ``vtpu-apiserver`` plus the scheduler / controllers / admission
  binaries as real OS processes talking TCP, optionally with a standby
  scheduler (``--standby-scheduler``) for cross-process HA takeover.

Then an interactive prompt serves ``vtctl`` commands against the live
cluster (or ``--demo`` submits a gang job, waits for it to run, and
exits).
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import List, Tuple

from volcano_tpu_torch.apis import batch, core, scheduling
from volcano_tpu_torch.client import AdmissionError, AlreadyExistsError, APIServer, KubeClient, VolcanoClient
from volcano_tpu_torch.cmd import AdmissionDaemon, ControllersDaemon, SchedulerDaemon


def _build_node(name: str, cpu: str, mem: str):
    alloc = {"cpu": cpu, "memory": mem, "pods": "110"}
    return core.Node(
        metadata=core.ObjectMeta(name=name, namespace=""),
        spec=core.NodeSpec(),
        status=core.NodeStatus(allocatable=dict(alloc), capacity=dict(alloc)),
    )


def seed_cluster(api, nodes: int, node_cpu: str, node_mem: str) -> None:
    """Create the synthetic node pool + default queue (idempotent, so a
    re-run against a live external bus is safe)."""
    kube = KubeClient(api)
    vc = VolcanoClient(api)
    for i in range(nodes):
        try:
            kube.create_node(_build_node(f"node-{i}", node_cpu, node_mem))
        except AlreadyExistsError:
            pass
    try:
        vc.create_queue(
            scheduling.Queue(metadata=core.ObjectMeta(name="default", namespace=""))
        )
    except AlreadyExistsError:
        pass


def local_up(nodes: int = 3, node_cpu: str = "8", node_mem: str = "16Gi",
             gate_pods: bool = False, scheduler_conf: str = "",
             listen_host: str = "127.0.0.1",
             admission_port: int = 0, controllers_port: int = 0,
             scheduler_port: int = 0, api=None,
             micro_cycles: bool = False):
    """Start the full control plane; returns (api, [daemons]).

    Ports default to 0 (ephemeral) for tests/interactive use; a real
    deployment (deploy/ renders this entry point as the pod command)
    passes fixed ports and a routable ``listen_host`` so probes and
    Services reach the daemons.  ``api`` may be a RemoteAPIServer to run
    the daemon threads against an external bus."""
    if api is None:
        api = APIServer()
    admission = AdmissionDaemon(
        api, gate_pods=gate_pods,
        listen_host=listen_host, listen_port=admission_port,
    ).start()
    seed_cluster(api, nodes, node_cpu, node_mem)
    controllers = ControllersDaemon(
        api, period=0.1,
        listen_host=listen_host, listen_port=controllers_port,
    ).start()
    scheduler = SchedulerDaemon(
        api, schedule_period=0.2, scheduler_conf=scheduler_conf,
        listen_host=listen_host, listen_port=scheduler_port,
        micro_cycles=micro_cycles,
    ).start()
    return api, [admission, controllers, scheduler]


# ---- multi-process topology ----


def _free_port(host: str) -> int:
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def _spawn(module: str, *flags: str, log_path: str = "") -> subprocess.Popen:
    """``python -m module flags``; its output goes to ``log_path``, or
    nowhere when empty."""
    with open(log_path or os.devnull, "w") as log:
        return subprocess.Popen(
            [sys.executable, "-m", module, *flags],
            env=dict(os.environ), stdout=log, stderr=subprocess.STDOUT,
        )


def wait_for_admission(api, timeout: float = 60.0) -> bool:
    """Block until the (remote) admission webhook is answering reviews.

    The probe is semantic: an invalid job (minAvailable=0) must be
    DENIED.  While the webhook is still registering, the create
    succeeds — the probe object is deleted and the poll retries, so a
    workload submitted afterwards always passes through admission."""
    probe = batch.Job(
        metadata=core.ObjectMeta(name="admission-probe", namespace="default"),
        spec=batch.JobSpec(min_available=0, tasks=[]),
    )
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            api.create(probe.clone())
        except AdmissionError:
            return True
        except AlreadyExistsError:
            # a probe leaked by an earlier attempt whose delete failed —
            # clear it so the next iteration can probe again, instead of
            # spinning on the conflict until the timeout
            try:
                api.delete("Job", "default", "admission-probe")
            except Exception:  # noqa: BLE001
                pass
            time.sleep(0.2)
            continue
        except Exception:  # noqa: BLE001 — bus still coming up
            time.sleep(0.2)
            continue
        try:
            api.delete("Job", "default", "admission-probe")
        except Exception:  # noqa: BLE001
            pass
        time.sleep(0.2)
    return False


def multiproc_up(nodes: int = 3, node_cpu: str = "8", node_mem: str = "16Gi",
                 gate_pods: bool = False, scheduler_conf: str = "",
                 listen_host: str = "127.0.0.1", bus_port: int = 0,
                 standby_scheduler: bool = False,
                 schedule_period: float = 0.2,
                 micro_cycles: bool = False,
                 flight_recorder: bool = False,
                 apiserver_replicas: int = 1,
                 apiserver_data_dir: str = "",
                 repl_lease_ttl: float = 2.0,
                 device: str = "cuda",
                 log_dir: str = "",
                 ) -> Tuple[object, List[subprocess.Popen]]:
    """The reference's deployment topology as real OS processes:
    vtpu-apiserver + vtpu-admission + vtpu-controllers + vtpu-scheduler
    (two schedulers with leader election when ``standby_scheduler``),
    the schedulers on ``device``.  ``apiserver_replicas > 1`` spawns the
    replicated persistent bus — N ``vtpu-apiserver`` processes with
    per-replica WAL dirs forming a leader/follower group, every daemon
    dialed to the full endpoint list.  With ``log_dir`` each child's
    output goes to ``<log_dir>/<binary>[-i].log``.

    Returns ``(RemoteAPIServer, [Popen, ...])`` in that order of
    binaries; the caller owns process teardown (``shutdown_procs``)."""
    import tempfile

    from volcano_tpu_torch.bus import connect_bus

    # same-host topology: engage the shared-memory ring transport for
    # every daemon (they inherit the environment via _spawn) and for
    # this process's own bus client.  VTPU_BUS_SHM=0 opts out; any
    # attach failure falls back to TCP, so this is a fast path, never a
    # new failure mode.
    os.environ.setdefault("VTPU_BUS_SHM", "1")

    def log_path(name: str) -> str:
        return os.path.join(log_dir, f"{name}.log") if log_dir else ""

    if bus_port == 0:
        bus_port = _free_port(listen_host)
    procs: List[subprocess.Popen] = []
    #: appended to EVERY daemon so the whole topology records into one
    #: flight-recorder namespace (`vtctl trace pod` spans ≥3 processes)
    fr_flags = ["--flight-recorder"] if flight_recorder else []

    if apiserver_replicas > 1:
        ports = [bus_port] + [_free_port(listen_host) for _ in range(apiserver_replicas - 1)]
        endpoints = [f"tcp://{listen_host}:{p}" for p in ports]
        bus_url = ",".join(endpoints)
        base_dir = apiserver_data_dir or tempfile.mkdtemp(prefix="vtpu-apiserver-")
        for i, port in enumerate(ports):
            procs.append(_spawn(
                "volcano_tpu_torch.cmd.apiserver",
                "--listen-host", listen_host, "--port", str(port),
                "--listen-port", "0",
                "--data-dir", os.path.join(base_dir, f"replica-{i}"),
                "--replicas", bus_url,
                "--replica-index", str(i),
                "--repl-lease-ttl", str(repl_lease_ttl),
                # the leader seeds after election (followers are
                # read-only), so every replica carries the flag
                "--seed-nodes", str(nodes),
                "--seed-node-cpu", node_cpu, "--seed-node-mem", node_mem,
                *fr_flags, log_path=log_path(f"apiserver-{i}"),
            ))
    else:
        bus_url = f"tcp://{listen_host}:{bus_port}"
        apiserver_flags = ["--listen-host", listen_host, "--port", str(bus_port),
                           "--listen-port", "0"]
        if apiserver_data_dir:
            apiserver_flags += ["--data-dir", apiserver_data_dir]
        procs.append(_spawn("volcano_tpu_torch.cmd.apiserver", *apiserver_flags, *fr_flags,
                            log_path=log_path("apiserver")))
    api = None
    try:
        # BusError after the wait means the spawned apiserver never came
        # up; the except below reaps it
        api = connect_bus(bus_url, wait=60.0)

        admission_flags = ["--bus", bus_url, "--listen-port", "0",
                           *fr_flags]
        if gate_pods:
            admission_flags.append("--gate-pods")
        procs.append(_spawn("volcano_tpu_torch.cmd.admission", *admission_flags,
                            log_path=log_path("admission")))
        procs.append(_spawn(
            "volcano_tpu_torch.cmd.controllers",
            "--bus", bus_url, "--listen-port", "0", "--period", "0.1",
            *fr_flags, log_path=log_path("controllers"),
        ))

        scheduler_flags = [
            "--bus", bus_url, "--listen-port", "0",
            "--schedule-period", str(schedule_period),
            "--device", device,
            *fr_flags,
        ]
        if micro_cycles:
            scheduler_flags.append("--micro-cycles")
        if scheduler_conf:
            scheduler_flags += ["--scheduler-conf", scheduler_conf]
        n_schedulers = 2 if standby_scheduler else 1
        for i in range(n_schedulers):
            flags = list(scheduler_flags)
            if standby_scheduler:
                flags += ["--leader-elect", "--leader-elect-id", f"sched-{i}"]
            procs.append(_spawn("volcano_tpu_torch.cmd.scheduler", *flags,
                                log_path=log_path(f"scheduler-{i}")))

        if apiserver_replicas > 1:
            # the elected leader seeds (followers are read-only); wait
            # for the pool to appear instead of racing the election
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline:
                try:
                    if len(api.list("Node")) >= nodes and api.list("Queue"):
                        break
                except Exception:  # noqa: BLE001 — group still electing
                    pass
                time.sleep(0.2)
            else:
                raise RuntimeError("replicated apiserver group never seeded the cluster")
        else:
            seed_cluster(api, nodes, node_cpu, node_mem)
    except BaseException:
        # a failure mid-setup must not strand the daemons it already
        # spawned (the caller never gets a handle to clean them up)
        if api is not None:
            api.close()
        shutdown_procs(procs)
        raise
    return api, procs


def shutdown_procs(procs: List[subprocess.Popen], grace: float = 5.0) -> None:
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + grace
    for p in procs:
        remaining = max(deadline - time.monotonic(), 0.1)
        try:
            p.wait(timeout=remaining)
        except subprocess.TimeoutExpired:
            p.kill()


def _demo(api, timeout: float = 30.0) -> int:
    vc = VolcanoClient(api)
    kube = KubeClient(api)
    task = batch.TaskSpec(
        name="worker",
        replicas=3,
        template=core.PodTemplateSpec(
            spec=core.PodSpec(
                containers=[
                    core.Container(
                        image="registry.k8s.io/pause:3.9",
                        resources={"requests": {"cpu": "1", "memory": "1Gi"}},
                    )
                ]
            )
        ),
    )
    vc.create_job(
        batch.Job(
            metadata=core.ObjectMeta(name="demo", namespace="default"),
            spec=batch.JobSpec(min_available=3, tasks=[task]),
        )
    )
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        pods = kube.list_pods("default")
        if pods and all(p.spec.node_name for p in pods):
            print("demo job bound:", [(p.metadata.name, p.spec.node_name) for p in pods])
            return 0
        time.sleep(0.2)
    print(f"demo job did not bind within {timeout:.0f}s", file=sys.stderr)
    return 1


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="vtpu-local-up")
    parser.add_argument("--nodes", type=int, default=3)
    parser.add_argument("--node-cpu", default="8")
    parser.add_argument("--node-mem", default="16Gi")
    parser.add_argument("--demo", action="store_true",
                        help="submit a gang job, wait for it to run, exit")
    parser.add_argument("--serve", action="store_true",
                        help="run as a daemon until SIGTERM/SIGINT "
                        "(no interactive prompt; the container mode)")
    parser.add_argument("--bus", default="",
                        help="connect the daemons to an external "
                        "vtpu-apiserver at tcp://host:port instead of "
                        "an in-process store")
    parser.add_argument("--multiproc", action="store_true",
                        help="spawn vtpu-apiserver + the three daemons "
                        "as real OS processes over TCP (the reference's "
                        "deployment topology)")
    parser.add_argument("--standby-scheduler", action="store_true",
                        help="with --multiproc: run a second scheduler "
                        "process under leader election (HA takeover)")
    parser.add_argument("--bus-port", type=int, default=0,
                        help="with --multiproc: fixed bus port "
                        "(0 = pick a free one)")
    parser.add_argument("--listen-host", default="127.0.0.1")
    parser.add_argument("--scheduler-port", type=int, default=0)
    parser.add_argument("--controllers-port", type=int, default=0)
    parser.add_argument("--admission-port", type=int, default=0)
    parser.add_argument("--micro-cycles", action="store_true",
                        help="event-driven scheduler: wake on watch "
                        "events and run debounced micro-cycles between "
                        "the periodic full cycles")
    parser.add_argument("--scheduler-conf", default="",
                        help="scheduler policy YAML, hot-reloaded per cycle")
    parser.add_argument("--flight-recorder", action="store_true",
                        help="enable the cluster-wide flight recorder "
                        "on every spawned daemon (vtctl trace pod/gang "
                        "renders the cross-process waterfall)")
    parser.add_argument("--apiserver-replicas", type=int, default=1,
                        help="with --multiproc: spawn N vtpu-apiserver "
                        "replicas forming the replicated persistent bus "
                        "(WAL + leader/follower log shipping); daemons "
                        "dial the full endpoint list")
    parser.add_argument("--apiserver-data-dir", default="",
                        help="with --multiproc: WAL/snapshot directory "
                        "(per-replica subdirs when replicated; empty = "
                        "a temp dir for replicas, volatile store for a "
                        "single apiserver)")
    parser.add_argument("--repl-lease-ttl", type=float, default=2.0,
                        help="apiserver leader-liveness lease TTL")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the scheduler runs its kernels: cuda "
                        "(no GPU is an exit at start) or cpu (the plain "
                        "PyTorch versions)")
    parser.add_argument("--log-dir", default="",
                        help="with --multiproc: keep each child's output in "
                        "<dir>/<binary>.log")
    return parser


def _interact_or_wait(args, api) -> int:
    if args.serve:
        stop = threading.Event()
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, lambda *_: stop.set())
        stop.wait()
        return 0
    from volcano_tpu_torch.cli.vtctl import main as vtctl_main

    print("interactive vtctl — e.g. `job list` (ctrl-d to exit)")
    for line in sys.stdin:
        argv_line = line.split()
        if argv_line:
            vtctl_main(argv_line, api=api)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("no CUDA device: vtpu-local-up runs the scheduler's kernels on "
                  "cuda unless given --device cpu", file=sys.stderr)
            return 1
    if args.multiproc:
        api, procs = multiproc_up(
            args.nodes, args.node_cpu, args.node_mem,
            scheduler_conf=args.scheduler_conf,
            listen_host=args.listen_host,
            bus_port=args.bus_port,
            standby_scheduler=args.standby_scheduler,
            micro_cycles=args.micro_cycles,
            flight_recorder=args.flight_recorder,
            apiserver_replicas=args.apiserver_replicas,
            apiserver_data_dir=args.apiserver_data_dir,
            repl_lease_ttl=args.repl_lease_ttl,
            device=args.device,
            log_dir=args.log_dir,
        )
        print(f"multi-process control plane up: bus {api.address}, "
              f"{len(procs)} daemons "
              f"(pids {[p.pid for p in procs]})")
        try:
            if not wait_for_admission(api):
                print("admission daemon never registered", file=sys.stderr)
                return 1
            if args.demo:
                return _demo(api, timeout=120.0)
            return _interact_or_wait(args, api)
        finally:
            api.close()
            shutdown_procs(procs)

    from volcano_tpu_torch.cmd.scheduler import use_device

    use_device(args.device)
    remote = None
    if args.bus:
        from volcano_tpu_torch.bus import BusError, connect_bus

        try:
            remote = connect_bus(args.bus)
        except BusError as e:
            print(str(e), file=sys.stderr)
            return 1

    api, daemons = local_up(
        args.nodes, args.node_cpu, args.node_mem,
        scheduler_conf=args.scheduler_conf,
        listen_host=args.listen_host,
        admission_port=args.admission_port,
        controllers_port=args.controllers_port,
        scheduler_port=args.scheduler_port,
        micro_cycles=args.micro_cycles,
        api=remote,
    )
    print(
        "control plane up: admission/controllers/scheduler serving on ports",
        [d.serving.port for d in daemons],
    )
    try:
        if args.demo:
            return _demo(api)
        return _interact_or_wait(args, api)
    finally:
        for d in daemons:
            d.stop()
        if remote is not None:
            remote.close()


if __name__ == "__main__":
    raise SystemExit(main())
