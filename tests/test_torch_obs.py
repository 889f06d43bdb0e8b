"""The port's flight recorder (``volcano_tpu_torch/obs``) against the JAX
package's ``volcano_tpu/obs``, tolerance 0.

Span contexts: trace ids, span ids, the wire form and nesting equal, the
null span when the recorder is off.  The channel: segment payloads
byte-equal for the same emissions with the identity, the pid and the
clock fixed; each package's ``collect_spans`` reads the other's
segments; the ring-full and export-error counts equal.  Collection:
``select_trace``, ``select_union``, ``build_tree``, the waterfall text,
the Chrome JSON, the clock-skew estimate and ``stage_breakdown`` equal on
spans made from a seed.  The hooks: the port's ``Scheduler`` on the CPU
records ``cycle:full`` with its ``kernel:pack``/``kernel:execute``
children, ``commit:flush`` adopted into the cycle and ``bind:landed``
under it.  The wire: the ``span`` payload key and ``bus_status`` over
{port, JAX client} × {port, JAX server}.  And two processes: the port's
apiserver and scheduler binaries (``--device cpu``) with
``--flight-recorder``, whose waterfall the port's ``vtctl trace pod`` and
the JAX one render to the same text.
"""

from __future__ import annotations

import io
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from tests.torch_bus_helpers import PAIRS, cpu_actions, one_torch_thread, pair, wait  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pkgs():
    from volcano_tpu import obs as jax_obs
    from volcano_tpu.client import APIServer as JaxAPI
    from volcano_tpu.metrics import metrics as jax_metrics
    from volcano_tpu_torch import metrics as port_metrics
    from volcano_tpu_torch import obs as port_obs
    from volcano_tpu_torch.client import APIServer as PortAPI

    return {"port": (port_obs, PortAPI, port_metrics.registry),
            "jax": (jax_obs, JaxAPI, jax_metrics.registry)}


@pytest.fixture(autouse=True)
def _clean_obs():
    pkgs = _pkgs()
    for o, _api, reg in pkgs.values():
        o.disable()
        reg.reset()
    yield
    for o, _api, reg in pkgs.values():
        o.disable()
        reg.reset()


class _Clock:
    """A deterministic stand-in for the ``time`` module: every call
    advances by a fixed step, so two packages making the same calls read
    the same values."""

    def __init__(self):
        self.t = 1_700_000_000.0

    def _tick(self) -> float:
        self.t += 0.001
        return self.t

    time = perf_counter = monotonic = _tick

    @staticmethod
    def sleep(s):
        time.sleep(s)


@pytest.fixture
def fixed_clock(monkeypatch):
    """Each package's spans module on its own deterministic clock with
    its span-id sequence reset."""
    from volcano_tpu.obs import spans as jax_spans
    from volcano_tpu_torch.obs import spans as port_spans

    for mod in (port_spans, jax_spans):
        monkeypatch.setattr(mod, "time", _Clock())
        monkeypatch.setattr(mod, "_id_seq", 0)


def _segments(api, o) -> list:
    return sorted((cm.metadata.name, dict(cm.data)) for cm in api.list("ConfigMap", o.NAMESPACE))


def _metric_lines(reg, prefix: str) -> list:
    return [ln for ln in reg.render().splitlines() if ln.startswith(prefix)]


# ---- span contexts ----

def test_trace_ids_equal_across_packages():
    rng = np.random.RandomState(7)
    pkgs = _pkgs()
    port, jax = pkgs["port"][0], pkgs["jax"][0]
    for _ in range(200):
        ns, name = f"ns{rng.randint(5)}", f"pod-{rng.randint(1 << 30):x}"
        assert port.trace_id_for(ns, name) == jax.trace_id_for(ns, name)
        assert port.trace_id_for_pod(ns, name) == jax.trace_id_for_pod(ns, name)
        assert port.trace_id_for_gang(ns, name) == jax.trace_id_for_gang(ns, name)
    from volcano_tpu.obs import spans as jax_spans
    from volcano_tpu_torch.obs import spans as port_spans

    for ident in ("vtpu-scheduler-0", "apiserver-0", "daemon-a", ""):
        assert port_spans._proc_token(ident) == jax_spans._proc_token(ident)


def test_disabled_recorder_is_the_null_span():
    for o, _api, _reg in _pkgs().values():
        assert not o.enabled()
        with o.span("x") as s:
            assert s.span_id == ""
            assert o.current_wire() is None and o.current() is None
        with o.adopt({"t": "ab", "s": "c"}, "bus:get") as s:
            assert s.span_id == ""
        o.complete("y", 0.1)  # no-op, no error


def _span_scenario(o, api_cls, sample: float):
    """Nested spans, a re-rooted child, an adopted remote context, a
    degraded adopt, a completed region, an error, a suppressed region and
    a sampled-out subtree, through one exporter with a small batch and
    segment ring; → (segments, wires seen, exporter counts)."""
    api = api_cls()
    exp = o.enable(api, identity="d0", flush_interval=3600, batch=5, segments=3)
    exp.sample = sample
    rng = np.random.RandomState(3)
    wires = []
    with o.span("cycle:full", cat="scheduler", args={"cycle": 1}) as cyc:
        wires.append(o.current_wire())
        for i in range(4):
            name = f"p{rng.randint(1000)}"
            with o.span("inner", trace_id=o.trace_id_for_pod("ns", name), args={"i": i}):
                wires.append(o.current_wire())
                o.complete("bind:landed", 0.0, cat="bind",
                           trace_id=o.trace_id_for_pod("ns", name), args={"pod": f"ns/{name}"})
                with o.adopt(o.current_wire(), "bus:create", cat="bus", args={"kind": "Pod"}):
                    wires.append(o.current_wire())
        o.complete("kernel:execute", 0.002, cat="kernel")
        with o.adopt({"t": "abcd1234", "s": "peer-7"}, "bus:commit_batch", cat="bus"):
            pass
        with o.adopt(None, "local"):
            pass
        try:
            with o.span("boom"):
                raise ValueError("x")
        except ValueError:
            pass
        wires.append(o.current() == (cyc.trace_id, cyc.span_id))
    with o.suppressed():
        assert not o.enabled()
        with o.span("hidden"):
            o.complete("also-hidden", 0.01)
    wires.append(o.current_wire())
    exp.flush_all()
    return _segments(api, o), wires, (exp.exported, exp.dropped)


@pytest.mark.parametrize("sample", [1.0, 0.5])
def test_segment_payloads_byte_equal(fixed_clock, sample):
    pkgs = _pkgs()
    out = {}
    for name in ("port", "jax"):
        o, api_cls, _reg = pkgs[name]
        out[name] = _span_scenario(o, api_cls, sample)
        o.disable()
    assert out["port"] == out["jax"]
    segments, wires, (exported, dropped) = out["port"]
    spans = [s for _n, data in segments
             for s in json.loads(data["spans.volcano.tpu/batch"])["spans"]]
    assert exported > 0 and dropped == 0
    assert wires[-1] is None and wires[-2] is True
    names = {s["name"] for s in spans}
    assert "hidden" not in names and "also-hidden" not in names
    by_name = {s["name"]: s for s in spans}
    assert by_name["boom"]["args"] == {"error": "ValueError"}
    assert by_name["bus:commit_batch"]["p"] == "peer-7"
    assert by_name["local"]["p"] == by_name["cycle:full"]["s"]  # a plain local span
    if sample < 1.0:  # the sampled-out subtrees dropped whole
        assert sum(s["name"] == "inner" for s in spans) < 4
    else:
        assert len(segments) == 3  # the slot ring overwrote the oldest batch


def test_collectors_read_each_others_segments(fixed_clock):
    pkgs = _pkgs()
    stores = {}
    for name in ("port", "jax"):
        o, api_cls, _reg = pkgs[name]
        api = api_cls()
        exp = o.enable(api, identity="d", flush_interval=3600, batch=4)
        with o.span("cycle:full", cat="scheduler"):
            for i in range(6):
                o.complete("bind:landed", 0.0, trace_id=o.trace_id_for_pod("ns", f"p{i}"),
                           args={"pod": f"ns/p{i}"})
        exp.flush_all()
        o.disable()
        stores[name] = api
    port_obs, jax_obs = pkgs["port"][0], pkgs["jax"][0]
    for api in stores.values():
        got = port_obs.collect_spans(api)
        assert got == jax_obs.collect_spans(api) and len(got) == 7
    # the same emissions from each package read the same
    assert port_obs.collect_spans(stores["port"]) == jax_obs.collect_spans(stores["jax"])


def test_ring_full_and_export_error_counts_equal():
    pkgs = _pkgs()
    counts = {}

    class DeadApi:
        def create(self, obj):
            raise RuntimeError("bus down")

    for name in ("port", "jax"):
        o, api_cls, reg = pkgs[name]
        from importlib import import_module

        channel = import_module(o.__name__ + ".channel")
        exp = channel.SpanExporter(api_cls(), "d0", ring=4, flush_interval=3600)
        t0 = time.perf_counter()
        for i in range(100):
            exp.emit({"s": f"s{i}", "name": "n", "ts": 0.0})
        assert time.perf_counter() - t0 < 1.0  # never blocked
        dead = channel.SpanExporter(DeadApi(), "d1", flush_interval=3600)
        for i in range(3):
            dead.emit({"s": f"s{i}", "name": "n", "ts": 0.0})
        assert dead.flush() == 0  # dropped, never raised
        counts[name] = (exp.dropped, dead.dropped, exp.flush_all(),
                        _metric_lines(reg, "volcano_telemetry_"))
    assert counts["port"] == counts["jax"]
    assert counts["port"][:3] == (96, 3, 4)
    assert 'volcano_telemetry_dropped_total{reason="ring-full"} 96.0' in counts["port"][3]
    assert 'volcano_telemetry_dropped_total{reason="export-error"} 3.0' in counts["port"][3]


def test_sampling_decisions_equal():
    pkgs = _pkgs()
    ids = [pkgs["port"][0].trace_id_for_pod("ns", f"p{i}") for i in range(500)]
    keeps = {}
    for name in ("port", "jax"):
        o, api_cls, _reg = pkgs[name]
        from importlib import import_module

        channel = import_module(o.__name__ + ".channel")
        keeps[name] = [channel.SpanExporter(api_cls(), "d", sample=s, flush_interval=3600).keep(t)
                       for s in (0.0, 0.3, 0.5, 1.0) for t in ids + [""]]
    assert keeps["port"] == keeps["jax"]


# ---- selection + rendering ----

def _random_spans(seed: int, n: int = 120) -> list:
    """A forest of spans over three daemons: cycles with kernel children,
    commit flushes with binds of several pods and gangs, paired bus
    spans across processes with skewed clocks."""
    rng = np.random.RandomState(seed)
    from volcano_tpu_torch import obs

    spans, sid = [], 0
    daemons = [("sched-a", 11, 0.0), ("sched-b", 12, 3500.0), ("apiserver-0", 22, -1200.0)]

    def mk(name, parent="", trace="", d=0, ts=0.0, dur=1.0, cat="span", args=None):
        nonlocal sid
        sid += 1
        daemon, pid, skew = daemons[d]
        s = {"name": name, "s": f"{pid:x}-{sid:x}", "p": parent, "t": trace, "daemon": daemon,
             "pid": pid, "ts": float(ts + skew), "dur": float(dur), "tid": 1, "cat": cat}
        if args:
            s["args"] = args
        spans.append(s)
        return s["s"]

    t = 1e9
    while len(spans) < n:
        d = int(rng.randint(2))
        t += float(rng.randint(100, 5000))
        cyc = mk("cycle:full", d=d, ts=t, dur=rng.randint(1000, 9000), cat="scheduler",
                 args={"cycle": int(rng.randint(100))})
        mk("kernel:pack", cyc, d=d, ts=t + 10, dur=rng.randint(10, 500), cat="kernel")
        mk("kernel:execute", cyc, d=d, ts=t + 600, dur=rng.randint(10, 900), cat="kernel")
        flush = mk("commit:flush", cyc, d=d, ts=t + 1500, dur=800, cat="commit",
                   args={"items": 3, "queue_wait_ms": float(rng.randint(1, 50))})
        off = float(rng.randint(0, 200))
        cli = mk("bus:commit_batch", flush, d=d, ts=t + 1600, dur=500 + off, cat="bus",
                 args={"peer": "127.0.0.1:1"})
        mk("bus:commit_batch", cli, d=2, ts=t + 1700 + off / 2, dur=300, cat="bus")
        for _ in range(3):
            pod = f"p{rng.randint(8)}"
            args = {"pod": f"ns/{pod}", "node": f"n{rng.randint(4)}"}
            if rng.rand() < 0.5:
                args["gang"] = f"ns/g{rng.randint(3)}"
            mk("bind:landed", flush, trace=obs.trace_id_for_pod("ns", pod), d=d,
               ts=t + 2400, dur=0.0, cat="bind", args=args)
    return spans


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_collect_and_render_equal(seed):
    pkgs = _pkgs()
    port, jax = pkgs["port"][0], pkgs["jax"][0]
    spans = _random_spans(seed)
    for o in (port, jax):
        o.build_tree(spans)
    assert port.build_tree(spans) == jax.build_tree(spans)
    assert port.estimate_skew(spans) == jax.estimate_skew(spans) != {}
    skew = port.estimate_skew(spans)
    assert port.apply_skew(spans, skew) == jax.apply_skew(spans, skew)
    for ns, name in [("ns", "p0"), ("ns", "p3"), ("ns", "g1"), ("ns", "nobody")]:
        sel = port.select_trace(spans, ns, name)
        assert sel == jax.select_trace(spans, ns, name)
        texts = []
        for o in (port, jax):
            for kw in ({}, {"skew": {}}, {"clock0_us": 1e9}):
                buf = io.StringIO()
                o.render_waterfall(sel, buf, **kw)
                texts.append(buf.getvalue())
        assert texts[:3] == texts[3:]
        assert json.dumps(port.chrome_export(sel)) == json.dumps(jax.chrome_export(sel))
    idents = [("ns", "p1"), ("ns", "g0"), ("ns", "p5")]
    assert port.select_union(spans, idents) == jax.select_union(spans, idents)
    pods = [("ns", f"p{i}") for i in range(8)]
    assert port.stage_breakdown(spans, pods) == jax.stage_breakdown(spans, pods)
    text = io.StringIO()
    port.render_waterfall(port.select_trace(spans, "ns", "p0"), text)
    assert "clock skew corrected" in text.getvalue()


def test_related_identities_equal():
    from tests.torch_bus_helpers import to_jax

    import chip_smoke

    pkgs = _pkgs()
    objs = [o for o in chip_smoke.arrival_objects(4) if o.kind in ("Pod", "PodGroup")]
    stores = {"port": pkgs["port"][1](), "jax": pkgs["jax"][1]()}
    for obj in objs:
        stores["port"].create(obj)
    for obj in to_jax(objs):
        stores["jax"].create(obj)
    for pod in (o for o in objs if o.kind == "Pod"):
        ns, name = pod.metadata.namespace, pod.metadata.name
        got = pkgs["port"][0].related_identities(stores["port"], ns, name)
        assert got == pkgs["jax"][0].related_identities(stores["jax"], ns, name)
        assert len(got) == 2
    assert pkgs["port"][0].related_identities(stores["port"], "ns", "gone") == [("ns", "gone")]


# ---- the hooks: cycle, kernel phases, commit flush, landed binds ----

@pytest.mark.parametrize("pipelined", [False, True])
def test_scheduler_cycle_spans(cpu_actions, tmp_path, pipelined):
    """The port's Scheduler over its store on the CPU: the cycle span
    parents the kernel phases and (pipelined) the commit flushes that
    carry the landed binds; every pod has a waterfall with its cycle."""
    import chip_smoke
    from volcano_tpu_torch import obs
    from volcano_tpu_torch.cache import SchedulerCache
    from volcano_tpu_torch.client import APIServer, SchedulerClient
    from volcano_tpu_torch.scheduler.scheduler import Scheduler

    from tests.torch_bus_helpers import conf_file

    api = APIServer()
    objs = chip_smoke.arrival_objects(6)
    for obj in objs:
        if obj.kind == "Queue":
            continue
        if obj.kind == "PodGroup":
            obj.spec.queue = "default"
        api.create(obj)
    from volcano_tpu_torch.cmd.apiserver import seed_cluster

    seed_cluster(api, 3, "8", "32Gi")
    exp = obs.enable(api, identity="sched", flush_interval=3600)
    cache = SchedulerCache(client=SchedulerClient(api), pipelined_commit=pipelined)
    try:
        cache.run()
        sched = Scheduler(cache, scheduler_conf_path=conf_file(tmp_path, "port"))
        sched.run_once()
        if pipelined:
            assert cache._commit_plane.barrier(30)
    finally:
        if cache._commit_plane is not None:
            cache.stop_commit_plane()
    exp.flush_all()
    spans = obs.collect_spans(api)
    by_id = {s["s"]: s for s in spans}
    cycles = [s for s in spans if s["name"] == "cycle:full"]
    assert len(cycles) == 1 and cycles[0]["args"] == {"cycle": 1}
    kids = {s["name"] for s in spans if s["p"] == cycles[0]["s"]}
    assert {"kernel:pack", "kernel:execute"} <= kids
    binds = [s for s in spans if s["name"] == "bind:landed"]
    assert len(binds) == 6
    for b in binds:
        assert b["t"] == obs.trace_id_for_pod(*b["args"]["pod"].split("/"))
        assert b["args"]["node"].startswith("node-") and b["args"]["gang"]
        chain, s = [], b
        while s["p"] in by_id:
            s = by_id[s["p"]]
            chain.append(s["name"])
        assert chain[-1] == "cycle:full"
        assert chain == (["commit:flush", "cycle:full"] if pipelined else ["cycle:full"])
    if pipelined:
        flushes = [s for s in spans if s["name"] == "commit:flush"]
        assert flushes and all(f["p"] == cycles[0]["s"] for f in flushes)
        assert all("queue_wait_ms" in f["args"] and f["args"]["items"] > 0 for f in flushes)
    ns, name = binds[0]["args"]["pod"].split("/")
    sel = obs.select_union(spans, obs.related_identities(api, ns, name))
    assert {"cycle:full", "kernel:execute", "bind:landed"} <= {s["name"] for s in sel}


def test_recorder_changes_no_bind(cpu_actions, tmp_path):
    """A cycle with the recorder on binds exactly what it binds with it
    off."""
    import chip_smoke
    from volcano_tpu_torch import obs
    from volcano_tpu_torch.cache import SchedulerCache
    from volcano_tpu_torch.client import APIServer, SchedulerClient
    from volcano_tpu_torch.cmd.apiserver import seed_cluster
    from volcano_tpu_torch.scheduler.scheduler import Scheduler

    from tests.torch_bus_helpers import conf_file

    binds = []
    for on in (False, True):
        api = APIServer()
        seed_cluster(api, 4, "8", "32Gi")
        for obj in chip_smoke.arrival_objects(40):
            if obj.kind == "Queue":
                continue
            if obj.kind == "PodGroup":
                obj.spec.queue = "default"
            api.create(obj)
        if on:
            obs.enable(api, identity="sched", flush_interval=0.01)
        cache = SchedulerCache(client=SchedulerClient(api), pipelined_commit=True)
        try:
            cache.run()
            Scheduler(cache, scheduler_conf_path=conf_file(tmp_path, "port")).run_once()
            assert cache._commit_plane.barrier(30)
        finally:
            cache.stop_commit_plane()
            obs.disable()
        binds.append(sorted((p.metadata.name, p.spec.node_name) for p in api.list("Pod")))
    assert binds[0] == binds[1] and any(n for _p, n in binds[0])


# ---- the wire: the span key and bus_status, {port, JAX} × {port, JAX} ----

@pytest.mark.parametrize("pair", PAIRS, indirect=True, ids=lambda p: f"{p[0]}-client-{p[1]}-server")
def test_span_key_and_bus_status_across_the_wire(pair):
    """A request made inside a span carries its context; the server of
    either package adopts it as the child ``bus:<op>`` span, and either
    package's collector reads the pair from the server's store."""
    from importlib import import_module

    pkgs = _pkgs()
    c_obs = import_module("volcano_tpu_torch.obs" if pair.c.name == "port" else "volcano_tpu.obs")
    s_obs = import_module("volcano_tpu_torch.obs" if pair.s.name == "port" else "volcano_tpu.obs")
    assert pair.client.bus_status() == {"role": "standalone", "persistent": False}
    pair.store.metrics_address = "127.0.0.1:9"
    assert pair.client.bus_status() == {"role": "standalone", "persistent": False,
                                        "metrics_address": "127.0.0.1:9"}
    c_exp = c_obs.enable(pair.client, identity="sched-0", flush_interval=3600)
    s_exp = (s_obs.enable(pair.store, identity="apiserver-0", flush_interval=3600)
             if s_obs is not c_obs else c_exp)
    tid = c_obs.trace_id_for_pod("ns", "p0")
    with c_obs.span("cycle:full", cat="scheduler"):
        with c_obs.span("gang:assemble", trace_id=tid):
            pair.client.create(pair.c.core.ConfigMap(
                metadata=pair.c.core.ObjectMeta(name="x", namespace="ns"), data={"k": "v"}))
        pair.client.get("ConfigMap", "ns", "x")
    pair.client.get("ConfigMap", "ns", "x")  # no span open: no context, no span
    c_exp.flush_all()
    if s_exp is not c_exp:
        s_exp.flush_all()
    spans = pkgs["port"][0].collect_spans(pair.store)
    assert spans == pkgs["jax"][0].collect_spans(pair.store)
    creates = [s for s in spans if s["name"] == "bus:create"]
    gets = [s for s in spans if s["name"] == "bus:get"]
    assert len(creates) == 2 and len(gets) == 2
    client = next(s for s in creates if "peer" in s.get("args", {}))
    server = next(s for s in creates if s is not client)
    assert client["args"] == {"peer": pair.client.address}
    assert server["p"] == client["s"] and server["t"] == client["t"] == tid
    assert client["daemon"] == "sched-0"
    assert server["daemon"] == ("sched-0" if s_exp is c_exp else "apiserver-0")
    gang = next(s for s in spans if s["name"] == "gang:assemble")
    assert client["p"] == gang["s"]


# ---- two processes: the binaries with --flight-recorder ----

def _child(args, env=None):
    return subprocess.Popen([sys.executable, "-m", *args], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
                                     **(env or {})))


def _read_until(proc, pattern, lines, timeout=120.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for line in list(lines):
            m = re.search(pattern, line)
            if m:
                return m
        assert proc.poll() is None, "".join(lines)
        time.sleep(0.05)
    raise AssertionError(f"no {pattern!r}:\n{''.join(lines)}")


def test_binaries_waterfall_in_both_vtctls(tmp_path):
    """The port's apiserver and scheduler binaries, each a child process
    with ``--flight-recorder``: after the pods bind and the scheduler
    stops (its final flush), one pod's waterfall holds spans of both
    processes with the bus spans linked across the wire, and the port's
    ``vtctl trace pod`` (in process and as ``python -m``) and the JAX
    one print the same text; ``--chrome`` JSON too."""
    import chip_smoke
    from volcano_tpu.bus import RemoteAPIServer as JaxRemote
    from volcano_tpu.cli.vtctl import main as jax_vtctl
    from volcano_tpu_torch import obs
    from volcano_tpu_torch.bus import RemoteAPIServer
    from volcano_tpu_torch.cli.vtctl import main as port_vtctl

    procs, readers, clients = [], [], []

    def start(args):
        proc = _child(args)
        lines = []
        reader = threading.Thread(target=lambda: lines.extend(iter(proc.stdout.readline, "")),
                                  daemon=True)
        reader.start()
        procs.append(proc)
        readers.append(reader)
        return proc, lines

    try:
        api_proc, api_lines = start(["volcano_tpu_torch.cmd.apiserver", "--port", "0",
                                     "--listen-port", "0", "--seed-nodes", "4",
                                     "--flight-recorder"])
        bus_port = int(_read_until(api_proc, r"apiserver up: bus on :(\d+)", api_lines).group(1))
        url = f"tcp://127.0.0.1:{bus_port}"
        client = RemoteAPIServer(url, timeout=30)
        clients.append(client)
        assert client.wait_ready(10)
        conf = tmp_path / "scheduler.conf"
        conf.write_text(chip_smoke.loop_conf_text(chip_smoke.CYCLE_TIERS, ("gpu-allocate",)))
        sched, sched_lines = start(["volcano_tpu_torch.cmd.scheduler", "--device", "cpu",
                                    "--bus", url, "--leader-elect", "--leader-elect-id", "s-1",
                                    "--scheduler-conf", str(conf), "--listen-port", "0",
                                    "--schedule-period", "0.2", "--pipelined-commit",
                                    "--flight-recorder"])
        _read_until(sched, r"s-1 became leader", sched_lines)
        objs = chip_smoke.arrival_objects(6)
        pods = [o for o in objs if o.kind == "Pod"]
        for obj in objs:
            if obj.kind == "Queue":
                continue
            if obj.kind == "PodGroup":
                obj.spec.queue = "default"
            client.create(obj)
        assert wait(lambda: all(p.spec.node_name for p in client.list("Pod", "bench"))
                    and len(client.list("Pod", "bench")) == len(pods), 60), "".join(sched_lines)
        sched.send_signal(signal.SIGTERM)  # the graceful stop flushes the ring
        assert sched.wait(timeout=60) == 0, "".join(sched_lines)
        ns, name = pods[-1].metadata.namespace, pods[-1].metadata.name
        spans = obs.select_union(obs.collect_spans(client),
                                 obs.related_identities(client, ns, name))
        daemons = {s["daemon"] for s in spans}
        assert daemons == {"s-1", "apiserver-0"}, daemons
        by_id = {s["s"]: s for s in spans}
        names = {s["name"] for s in spans}
        assert {"cycle:full", "kernel:pack", "kernel:execute", "commit:flush",
                "bind:landed"} <= names
        server_bus = [s for s in spans if s["daemon"] == "apiserver-0"]
        assert server_bus and all(s["name"].startswith("bus:") for s in server_bus)
        for s in server_bus:
            peer = by_id[s["p"]]
            assert peer["name"] == s["name"] and peer["daemon"] == "s-1"
        texts = []
        jclient = JaxRemote(url, timeout=30)
        clients.append(jclient)
        assert jclient.wait_ready(10)
        argv = ["trace", "pod", "-n", ns, "-N", name]
        for main, api in ((port_vtctl, client), (jax_vtctl, jclient)):
            buf = io.StringIO()
            assert main(argv, api=api, out=buf) == 0
            texts.append(buf.getvalue())
            buf = io.StringIO()
            path = str(tmp_path / f"{len(texts)}.json")
            assert main(argv + ["--chrome", path], api=api, out=buf) == 0
            texts.append(open(path).read())
        assert texts[0] == texts[2] and texts[1] == texts[3]
        assert "2 daemon(s) / 2 process(es)" in texts[0]
        run = subprocess.run([sys.executable, "-m", "volcano_tpu_torch.cli.vtctl", "--bus", url,
                              *argv], cwd=ROOT, capture_output=True, text=True, timeout=120,
                             env=dict(os.environ, PYTHONPATH=ROOT))
        assert run.returncode == 0 and run.stdout == texts[0], run.stderr
        api_proc.send_signal(signal.SIGTERM)
        assert api_proc.wait(timeout=60) == 0, "".join(api_lines)
    finally:
        for c in clients:
            c.close()
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
            proc.stdout.close()
        for reader in readers:
            reader.join(timeout=10)
