"""The port's daemons and binaries against the JAX package's.

``cmd/daemon.BaseDaemon``'s guarded loop and liveness; the identity
labels ``metrics.set_identity`` merges into ``render()``, line for line
the JAX registry's; the port's ``SchedulerDaemon`` (gpu-allocate on the
CPU) against the JAX package's (jax-allocate) on equal seeded stores of
2,000 pods × 200 nodes, synchronously and through the pipelined commit
plane, in process and with the port's daemon on its own
``RemoteAPIServer`` connection to a port or a JAX ``BusServer``; the
leader-elected pair's takeover (the leader crash-stopped after its binds
landed, arrivals created, the standby binding them) against the JAX
pair's on the same sequence.  Store dumps (``store_dump``) equal,
tolerance 0.  Then the entry points: both binaries' parsers keep the
JAX parsers' defaults and refuse the flags left out; ``--bus`` to a dead
port and no GPU without ``--device cpu`` exit at start; ``python -m
volcano_tpu_torch.cmd.apiserver`` and ``python -m
volcano_tpu_torch.cmd.scheduler --device cpu --bus ...`` as child
processes bind a small cluster and exit 0 on SIGTERM.
"""

from __future__ import annotations

import argparse
import functools
import json
import logging
import os
import re
import signal
import subprocess
import sys
import threading
import time

import pytest
import torch

import chip_smoke
import volcano_tpu.actions  # noqa: F401 — registers the JAX package's actions
import volcano_tpu.plugins  # noqa: F401 — registers its plugin builders
from tests.test_torch_store_loop import store_dump
from tests.torch_bus_helpers import cpu_actions, daemon_run, pkg, wait  # noqa: F401 — fixture
from volcano_tpu_torch.ops.synthetic import generate_cluster_objects

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT, JAX = pkg("port"), pkg("jax")
SMALL = dict(n_tasks=2000, n_nodes=200, gang_size=8, seed=3)
ARRIVING = 200


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread keeps the suite's parallel workers from
    contending for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _port_identity():
    """Daemons started here stamp the port registry's identity labels;
    clear them for later tests (the JAX registry's are cleared by
    conftest)."""
    yield
    PORT.registry.set_identity()


# ---- BaseDaemon ----


def test_base_daemon_guarded_loop(caplog):
    """A failing ``_work`` sets ``last_error``, is logged, is counted in
    ``failed_cycles`` and runs again; a good cycle clears ``last_error``
    but not the count; ``healthy()`` follows the loop thread."""
    from volcano_tpu_torch.cmd.daemon import BaseDaemon

    class Flaky(BaseDaemon):
        NAME = "flaky"

        def __init__(self, api):
            super().__init__(api, period=0.01, listen_port=0)
            self.calls = 0
            self.errors = []

        def _work(self):
            self.calls += 1
            if self.calls <= 2:
                raise RuntimeError(f"boom {self.calls}")
            self.errors.append(self.last_error)

    d = Flaky(PORT.APIServer())
    assert d.healthy()  # not started yet
    with caplog.at_level(logging.ERROR):
        d.start()
        try:
            assert wait(lambda: d.calls >= 4)
            assert d.healthy() and d.cycles >= 2 and d.last_error is None
            assert d.errors[0] == "boom 2"  # set by the failure, cleared by the next good cycle
            assert d.failed_cycles == 2 and d.status()["failed_cycles"] == 2
            assert d.skipped_turns == 0 and "renews" not in d.status()  # no elector
        finally:
            d.stop()
    assert not d.healthy()
    assert [r.getMessage() for r in caplog.records if "cycle failed" in r.getMessage()] == [
        "flaky cycle failed: boom 1", "flaky cycle failed: boom 2"]


# ---- identity labels ----


def _same_series(metrics):
    metrics.update_e2e_duration(0.012)
    metrics.register_schedule_attempt("scheduled")
    metrics.update_unschedule_job_count(3)
    metrics.observe_bus_request("commit_batch", 0.004, "ok")


def test_identity_render_equals_the_references(monkeypatch):
    """The same ``set_identity`` and the same series on both packages'
    registries render line for line the same text, every series with the
    identity labels and ``volcano_build_info``; only the ``version``
    label's value may differ (each package's ``__version__``).  An empty
    value is omitted, an unknown role renders ``other``."""
    from volcano_tpu.metrics import metrics as jax_metrics
    from volcano_tpu_torch import metrics as port_metrics

    monkeypatch.setattr(port_metrics, "registry", port_metrics.Registry())
    monkeypatch.setattr(jax_metrics, "registry", jax_metrics._Registry())
    texts = []
    for metrics in (port_metrics, jax_metrics):
        metrics.set_identity(daemon="scheduler", shard="", role="scheduler")
        _same_series(metrics)
        texts.append(re.sub(r'version="[^"]*"', 'version="V"', metrics.registry.render()))
    assert texts[0] == texts[1]
    series = texts[0].strip().splitlines()
    assert all('daemon="scheduler"' in s and 'role="scheduler"' in s and "shard" not in s
               for s in series)
    assert any(s.startswith("volcano_build_info{") for s in series)
    texts = []
    for metrics in (port_metrics, jax_metrics):
        metrics.set_identity(daemon="apiserver", role="no-such-role")
        texts.append(re.sub(r'version="[^"]*"', 'version="V"', metrics.registry.render()))
    assert texts[0] == texts[1] and 'role="other"' in texts[0]
    port_metrics.registry.set_identity()
    assert "daemon=" not in port_metrics.registry.render()


# ---- SchedulerDaemon against the JAX package's ----


@pytest.fixture(scope="module")
def small():
    return generate_cluster_objects(**SMALL)


@pytest.fixture(scope="module")
def jax_daemon(small, tmp_path_factory):
    """The JAX package's SchedulerDaemon on its store, pipelined: the
    first digest and the store's dump."""
    out = daemon_run("jax", small, tmp_path_factory.mktemp("jax-daemon"))
    return dict(first=out["first"], dump=store_dump(out["store"]))


@pytest.mark.parametrize("pipelined", [False, True], ids=["sync", "pipelined"])
def test_scheduler_daemon_equals_the_jax_daemon(cpu_actions, small, jax_daemon, tmp_path,
                                                pipelined):
    out = daemon_run("port", small, tmp_path, pipelined=pipelined)
    assert out["first"] == jax_daemon["first"]
    assert store_dump(out["store"]) == jax_daemon["dump"]


@pytest.mark.parametrize("server", ["port", "jax"])
def test_daemon_over_the_bus_equals_the_jax_daemon(cpu_actions, small, jax_daemon, tmp_path,
                                                   server):
    """The port's daemon on its own connection to a bus server (the
    port's, or the JAX package's), the cluster seeded through another:
    the same store as the JAX package's daemon in process."""
    s = pkg(server)
    store = s.APIServer()
    srv = s.BusServer(store, bookmark_interval=0.2).start()
    url = f"tcp://127.0.0.1:{srv.port}"
    seeder = PORT.RemoteAPIServer(url, timeout=30)
    client = PORT.RemoteAPIServer(url, timeout=30)
    try:
        assert seeder.wait_ready(5) and client.wait_ready(5)
        chip_smoke.seed_store(seeder, small)
        out = daemon_run("port", small, tmp_path, api=client)
        assert out["first"] == jax_daemon["first"]
        assert store_dump(store) == jax_daemon["dump"]
    finally:
        seeder.close()
        client.close()
        srv.stop()


@pytest.fixture(scope="module")
def jax_pair(small, tmp_path_factory):
    out = daemon_run("jax", small, tmp_path_factory.mktemp("jax-pair"), takeover=True,
                     arrivals=chip_smoke.arrival_objects(ARRIVING))
    return dict(first=out["first"], arrivals=out["arrivals"], dump=store_dump(out["store"]))


def test_takeover_equals_the_jax_pairs(cpu_actions, small, jax_pair, tmp_path):
    """Two leader-elected daemons on one store: the leader binds, is
    crash-stopped, the arrivals come, the standby binds them — the same
    store as the JAX pair's on the same sequence."""
    out = daemon_run("port", small, tmp_path, takeover=True,
                     arrivals=chip_smoke.arrival_objects(ARRIVING))
    assert (out["first"], out["arrivals"]) == (jax_pair["first"], jax_pair["arrivals"])
    assert store_dump(out["store"]) == jax_pair["dump"]


# ---- entry points ----


class _Parsed(Exception):
    pass


def _parsed(monkeypatch, main, argv) -> dict:
    """The namespace ``main(argv)`` parses, stopping it right there."""
    seen = {}
    real = argparse.ArgumentParser.parse_args

    def parse_args(self, args=None, namespace=None):
        seen.update(vars(real(self, args, namespace)))
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_args)
    with pytest.raises(_Parsed):
        main(argv)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", real)
    return seen


@pytest.mark.parametrize("binary", ["scheduler", "apiserver"])
def test_kept_flags_have_the_reference_defaults(monkeypatch, binary):
    import importlib

    port_main = importlib.import_module(f"volcano_tpu_torch.cmd.{binary}").main
    jax_main = importlib.import_module(f"volcano_tpu.cmd.{binary}").main
    port, ref = _parsed(monkeypatch, port_main, []), _parsed(monkeypatch, jax_main, [])
    port_only = {"device"} if binary == "scheduler" else set()
    assert set(port) - set(ref) == port_only
    assert {k: v for k, v in port.items() if k not in port_only} == {k: ref[k] for k in port
                                                                       if k not in port_only}
    if binary == "scheduler":
        assert port["device"] == "cuda"
        assert set(ref) - set(port) == {
            "shards", "shard_identity", "shard_lease_duration", "shard_autoscale",
            "autoscale_min", "autoscale_max", "autoscale_up_p99_ms", "autoscale_up_pending",
            "autoscale_down_p99_ms", "autoscale_down_pending", "autoscale_sustain",
            "autoscale_cooldown_s", "autoscale_period_s", "gang_broker"}
    else:
        assert set(ref) - set(port) == {"data_dir", "snapshot_every", "replicas",
                                        "replica_index", "repl_lease_ttl", "shm"}


@pytest.mark.parametrize("binary, argv", [
    ("scheduler", ["--shards", "2"]), ("scheduler", ["--shard-identity", "s0"]),
    ("scheduler", ["--autoscale-min", "1"]), ("scheduler", ["--gang-broker", "on"]),
    ("apiserver", ["--data-dir", "/tmp/x"]), ("apiserver", ["--replicas", "tcp://a:1"]),
    ("apiserver", ["--shm"]), ("apiserver", ["--snapshot-every", "8"]),
])
def test_left_out_flags_are_refused(binary, argv, capsys):
    import importlib

    main = importlib.import_module(f"volcano_tpu_torch.cmd.{binary}").main
    with pytest.raises(SystemExit) as exc:
        main(argv)
    assert exc.value.code == 2 and "unrecognized arguments" in capsys.readouterr().err


def test_dead_bus_exits_within_wait(cpu_actions, monkeypatch):
    """``--bus`` to a port nobody serves: SystemExit after ``wait``,
    before the daemon starts."""
    import volcano_tpu_torch.bus as bus
    from volcano_tpu_torch.cmd import scheduler

    monkeypatch.setattr(bus, "connect_bus", functools.partial(bus.connect_bus, wait=0.5))
    monkeypatch.setattr(scheduler, "serve_forever", lambda d: pytest.fail("daemon started"))
    t0 = time.monotonic()
    with pytest.raises(SystemExit, match="unreachable after"):
        scheduler.main(["--bus", "tcp://127.0.0.1:1", "--device", "cpu"])
    assert time.monotonic() - t0 < 10


def test_no_gpu_exits_at_start(monkeypatch):
    """Without a GPU and without ``--device cpu`` the scheduler exits
    before any work: no store, no warmup, no daemon."""
    from volcano_tpu_torch.cmd import scheduler

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(scheduler, "resolve_bus", lambda b: pytest.fail("dialed the bus"))
    with pytest.raises(SystemExit, match="no CUDA device"):
        scheduler.main(["--warmup"])


def _child(args):
    return subprocess.Popen([sys.executable, "-m", *args], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1"))


def _read_until(proc, pattern, lines, timeout=120.0):
    """The first match of ``pattern`` in the child's output, read on a
    thread into ``lines``."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for line in list(lines):
            m = re.search(pattern, line)
            if m:
                return m
        assert proc.poll() is None, "".join(lines)
        time.sleep(0.05)
    raise AssertionError(f"no {pattern!r}:\n{''.join(lines)}")


def test_binaries_as_child_processes(tmp_path):
    """``python -m volcano_tpu_torch.cmd.apiserver --port 0`` seeds its
    nodes; ``python -m volcano_tpu_torch.cmd.scheduler --device cpu
    --bus ... --leader-elect`` binds a small cluster created over the
    wire; both exit 0 on SIGTERM, the leader releasing its lease."""
    procs, readers = [], []

    def start(args):
        proc = _child(args)
        lines = []
        reader = threading.Thread(target=lambda: lines.extend(iter(proc.stdout.readline, "")),
                                  daemon=True)
        reader.start()
        procs.append(proc)
        readers.append(reader)
        return proc, lines

    client = None
    try:
        api_proc, api_lines = start(["volcano_tpu_torch.cmd.apiserver", "--port", "0",
                                     "--listen-port", "0", "--seed-nodes", "4"])
        bus_port = int(_read_until(api_proc, r"apiserver up: bus on :(\d+)", api_lines).group(1))
        url = f"tcp://127.0.0.1:{bus_port}"
        client = PORT.RemoteAPIServer(url, timeout=30)
        assert client.wait_ready(10)
        assert len(client.list("Node")) == 4 and client.get("Queue", "", "default") is not None
        conf = tmp_path / "scheduler.conf"
        conf.write_text(chip_smoke.loop_conf_text(chip_smoke.CYCLE_TIERS, ("gpu-allocate",)))
        sched, sched_lines = start(["volcano_tpu_torch.cmd.scheduler", "--device", "cpu",
                                    "--bus", url, "--leader-elect", "--leader-elect-id", "s-1",
                                    "--scheduler-conf", str(conf), "--listen-port", "0",
                                    "--schedule-period", "0.1", "--pipelined-commit"])
        _read_until(sched, r"s-1 became leader", sched_lines)
        pods = [o for o in chip_smoke.arrival_objects(8) if o.kind == "Pod"]
        for obj in chip_smoke.arrival_objects(8):
            if obj.kind == "Queue":
                obj.metadata.name = "default"
                continue
            if obj.kind == "PodGroup":
                obj.spec.queue = "default"
            client.create(obj)
        assert wait(lambda: all(p.spec.node_name for p in client.list("Pod", "bench"))
                    and len(client.list("Pod", "bench")) == len(pods), 60), "".join(sched_lines)
        # SIGUSR1: one status line, the daemon's counters with the launches
        sched.send_signal(signal.SIGUSR1)
        status = json.loads(_read_until(sched, r"scheduler status: (\{.*\})",
                                        sched_lines).group(1))
        assert status["cycles"] > 0 and status["failed_cycles"] == 0 and status["leading"]
        assert status["resync"] == status["quarantined"] == 0 and status["renews"] > 0
        assert status["warmup"] == dict(session=0, session_wide=0, preempt=0)  # no --warmup
        assert status["session"] == 0 and status["memory_reserved"] == 0  # --device cpu
        sched.send_signal(signal.SIGTERM)
        assert sched.wait(timeout=60) == 0, "".join(sched_lines)
        assert chip_smoke.lease_holder(client) == ""  # released on the graceful stop
        api_proc.send_signal(signal.SIGTERM)
        assert api_proc.wait(timeout=60) == 0, "".join(api_lines)
    finally:
        if client is not None:
            client.close()
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
            proc.stdout.close()
        for reader in readers:
            reader.join(timeout=10)
