"""The port's ``vtctl`` (``volcano_tpu_torch/cli/vtctl.py``) and the
binaries' recorder flags against the JAX package's.

On one store, the port's ``vtctl`` prints the JAX ``vtctl``'s text for
``trace pod|gang`` (and ``--chrome`` JSON), ``top`` (its table and
``--json``, targets from a shard map, the store's ``bus_status`` and
``--bus``), and ``incidents list|show|collect``; ``incidents capture``
writes a bundle both read.  The parsers of the flight recorder's
commands and the binaries' ``--flight-recorder``, ``--watchdog`` and
``--incident-dir`` parse as the reference's, and the binaries hand them
to their daemons.  ``vtctl trace record|replay`` runs the port's journal
commands on the CPU.
"""

from __future__ import annotations

import argparse
import io
import json
import os

import pytest

from tests.torch_bus_helpers import cpu_actions, one_torch_thread  # noqa: F401


def _vtctls():
    from volcano_tpu.cli.vtctl import main as jax_main
    from volcano_tpu_torch.cli.vtctl import main as port_main

    return port_main, jax_main


@pytest.fixture(autouse=True)
def _clean_obs():
    from volcano_tpu import obs as jax_obs
    from volcano_tpu.metrics import metrics as jax_metrics
    from volcano_tpu_torch import metrics, obs

    for o, reg in ((obs, metrics.registry), (jax_obs, jax_metrics.registry)):
        o.disable()
        reg.reset()
    yield
    for o, reg in ((obs, metrics.registry), (jax_obs, jax_metrics.registry)):
        o.disable()
        reg.reset()


def _both(argv, api) -> list:
    """(rc, text) of the port's vtctl and of the JAX one on ``api``."""
    out = []
    for main in _vtctls():
        buf = io.StringIO()
        out.append((main(list(argv), api=api, out=buf), buf.getvalue()))
    return out


# ---- trace pod|gang ----

def _span_store():
    """A port store holding the segments of two exporters (a scheduler
    and an apiserver process, as it were): cycles with kernel phases,
    commit flushes and paired bus spans, binds of pods of two gangs."""
    from volcano_tpu_torch import obs
    from volcano_tpu_torch.apis import core, scheduling
    from volcano_tpu_torch.client import APIServer
    from volcano_tpu_torch.obs import channel, spans

    api = APIServer()
    for i in range(4):
        api.create(core.Pod(metadata=core.ObjectMeta(
            name=f"p{i}", namespace="ns",
            annotations={scheduling.GROUP_NAME_ANNOTATION_KEY: f"g{i % 2}"})))
    sched = channel.SpanExporter(api, "sched-0", flush_interval=3600)
    server = channel.SpanExporter(api, "apiserver-0", flush_interval=3600)
    server.pid += 1  # a second process's pid
    for cycle in range(2):
        spans._set_exporter(sched)
        with obs.span("cycle:full", cat="scheduler", args={"cycle": cycle}):
            obs.complete("kernel:pack", 0.001, cat="kernel")
            obs.complete("kernel:execute", 0.003, cat="kernel")
            with obs.span("commit:flush", cat="commit", args={"items": 2}):
                with obs.span("bus:commit_batch", cat="bus", args={"peer": "x"}):
                    wire = obs.current_wire()
                    spans._set_exporter(server)
                    with obs.adopt(wire, "bus:commit_batch", cat="bus"):
                        pass
                    spans._set_exporter(sched)
                for i in (2 * cycle, 2 * cycle + 1):
                    obs.complete("bind:landed", 0.0, cat="bind",
                                 trace_id=obs.trace_id_for_pod("ns", f"p{i}"),
                                 args={"pod": f"ns/p{i}", "gang": f"ns/g{i % 2}"})
    spans._set_exporter(None)
    sched.flush_all()
    server.flush_all()
    return api


@pytest.mark.parametrize("argv", [
    ["trace", "pod", "-n", "ns", "-N", "p1"],
    ["trace", "pod", "--namespace", "ns", "--name", "p2"],
    ["trace", "gang", "-n", "ns", "-N", "g0"],
    ["trace", "pod", "-n", "ns", "-N", "nobody"],
])
def test_trace_identity_text_equal(argv, tmp_path):
    api = _span_store()
    got = _both(argv, api)
    assert got[0] == got[1]
    rc, text = got[0]
    if "nobody" in argv:
        assert rc == 1 and "no spans recorded" in text
        return
    assert rc == 0 and "bind:landed" in text and "kernel:execute" in text
    assert "2 daemon(s) / 2 process(es)" in text
    chrome = []
    for i, main in enumerate(_vtctls()):
        path = str(tmp_path / f"{i}.json")
        assert main(argv + ["--chrome", path], api=api, out=io.StringIO()) == 0
        chrome.append(open(path).read())
    assert chrome[0] == chrome[1] and json.loads(chrome[0])["traceEvents"]


# ---- incidents ----

def _incident_store(pkg: str, tmp_path):
    """A store of package ``pkg`` with two bundles' published summaries
    (one with a breach-window span)."""
    if pkg == "port":
        from volcano_tpu_torch import obs
        from volcano_tpu_torch.client import APIServer
        from volcano_tpu_torch.obs.incident import IncidentManager
    else:
        from volcano_tpu import obs
        from volcano_tpu.client import APIServer
        from volcano_tpu.obs.incident import IncidentManager
    api = APIServer()
    exp = obs.enable(api, identity="d0", flush_interval=3600)
    with obs.span("bind:landed", cat="scheduler", trace_id="ff00aa11"):
        pass
    exp.flush_all()
    obs.disable()
    mgr = IncidentManager(api, "d0", str(tmp_path / pkg / "inc"), settle_s=0.0)
    mgr.capture("slo-burn:submit-bind-p99", alerts=[{"name": "submit-bind-p99",
                                                     "burnFast": 2.0}])
    IncidentManager(api, "d1", str(tmp_path / pkg / "inc1"), settle_s=0.0).capture("manual")
    return api


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_incidents_text_equal(pkg, tmp_path):
    api = _incident_store(pkg, tmp_path)
    for argv in (["incidents", "list"], ["incident", "list"],
                 ["incidents", "list", "--identity", "d1"], ["incidents", "show"],
                 ["incidents", "show", "--index", "0"], ["incidents", "show", "--index", "7"],
                 ["incidents", "show", "--identity", "nobody"]):
        got = _both(argv, api)
        assert got[0] == got[1], argv
    rc, text = _both(["incidents", "list"], api)[0]
    assert rc == 0 and "slo-burn:submit-bind-p99" in text and "manual" in text
    rc, text = _both(["incidents", "show", "--index", "0"], api)[0]
    assert '"reason": "slo-burn:submit-bind-p99"' in text and "bind:landed" in text
    dirs = []
    for i, main in enumerate(_vtctls()):
        dest = tmp_path / f"got{i}"
        buf = io.StringIO()
        assert main(["incidents", "collect", "--out", str(dest)], api=api, out=buf) == 0
        dirs.append({f: (dest / f).read_text() for f in sorted(os.listdir(dest))})
        assert buf.getvalue() == f"collected 2 incident summaries into {dest}\n"
    assert dirs[0] == dirs[1] and len(dirs[0]) == 2


def test_incidents_empty_store_and_capture(tmp_path):
    from volcano_tpu_torch import obs
    from volcano_tpu_torch.client import APIServer

    api = APIServer()
    assert _both(["incidents", "list"], api) == [
        (0, "no incident bundles published on this bus\n")] * 2
    assert _both(["incidents", "show"], api) == [(1, "no matching incident bundle\n")] * 2
    port_main, _ = _vtctls()
    buf = io.StringIO()
    rc = port_main(["incidents", "capture", "--dir", str(tmp_path / "inc"), "--settle", "0"],
                   api=api, out=buf)
    assert rc == 0 and buf.getvalue().startswith("bundle: ")
    (bundle,) = os.listdir(tmp_path / "inc")
    meta = json.loads((tmp_path / "inc" / bundle / "meta.json").read_text())
    assert meta["reason"] == "manual" and meta["identity"] == "vtctl"
    assert sorted(meta["files"]) == sorted(os.listdir(tmp_path / "inc" / bundle))
    rec = json.loads(api.get("ConfigMap", obs.NAMESPACE, obs.BOOST_NAME).data[obs.BOOST_KEY])
    assert rec["reason"] == "manual" and rec["by"] == "vtctl"
    got = _both(["incidents", "list"], api)
    assert got[0] == got[1] and "manual" in got[0][1]


# ---- top ----

@pytest.fixture
def metrics_servers():
    """Two JAX ServingServers on registries of their own (burn 0.4 and
    2.5) and a port store whose shard map names them."""
    from volcano_tpu.metrics.metrics import _Registry
    from volcano_tpu.serving.http import ServingServer
    from volcano_tpu_torch.apis import core
    from volcano_tpu_torch.client import APIServer
    from volcano_tpu_torch.federation.leases import NAMESPACE, SHARD_MAP_KEY, SHARD_MAP_NAME

    servers = []
    for ident, burn in (("shard-a", 0.4), ("shard-b", 2.5)):
        reg = _Registry()
        reg.set_identity(daemon="scheduler", shard=ident)
        h = reg.histogram("volcano_submit_to_bind_latency_milliseconds", {},
                          buckets=[5.0, 10.0, 20.0])
        for v in (4.0, 8.0, 16.0):
            h.observe(v)
        reg.inc("volcano_pod_schedule_successes", {}, 3)
        reg.inc("volcano_telemetry_dropped_total", {"reason": "ring-full"}, 7)
        reg.set_gauge("volcano_slo_burn", {"slo": "submit-bind-p99", "window": "fast"}, burn)
        reg.set_gauge("volcano_slo_burn", {"slo": "submit-bind-p99", "window": "slow"},
                      burn * 10)
        servers.append(ServingServer(registry=reg).start())
    api = APIServer()
    rec = {"nShards": 2, "members": {}, "shards": {}, "stats": {
        "shard-a": {"metricsAddr": f"127.0.0.1:{servers[0].port}"},
        "shard-b": {"metricsAddr": f"127.0.0.1:{servers[1].port}"}}}
    api.create(core.ConfigMap(metadata=core.ObjectMeta(name=SHARD_MAP_NAME, namespace=NAMESPACE),
                              data={SHARD_MAP_KEY: json.dumps(rec)}))
    yield api, servers
    for s in servers:
        s.stop()


def test_top_text_equal(metrics_servers):
    api, servers = metrics_servers
    for argv in (["top"], ["top", "--json"], ["top", "--watch", "0.01", "--count", "2"]):
        got = _both(argv, api)
        assert got[0] == got[1], argv
        assert got[0][0] == 0
    text = _both(["top"], api)[0][1]
    assert "2.50" in next(ln for ln in text.splitlines() if "shard-b" in ln)
    doc = json.loads(_both(["top", "--json"], api)[0][1])
    assert doc["cluster"]["burn"] == 2.5 and doc["cluster"]["binds"] == 6
    assert doc["cluster"]["dropped"] == 14
    # the store's bus_status names a third target (the apiserver's /metrics)
    api.metrics_address = f"127.0.0.1:{servers[0].port}"
    got = _both(["top", "--json"], api)
    assert got[0] == got[1] and "apiserver [standalone]" in json.loads(got[0][1])["members"]
    from volcano_tpu_torch.client import APIServer

    assert _both(["top"], APIServer()) == [(1, (
        "no scrape targets discovered — need a running federation (shard map with "
        "metricsAddr), a --bus endpoint list, or explicit --metrics host:port\n"))] * 2


def test_top_and_incidents_over_the_bus(metrics_servers, tmp_path):
    """``--bus``: the port's vtctl dials the port's bus server, finds the
    apiserver's /metrics through ``bus_status`` and reads the store's
    incidents; the JAX vtctl prints the same."""
    from volcano_tpu_torch.bus import BusServer

    api, servers = metrics_servers
    api.metrics_address = f"127.0.0.1:{servers[1].port}"
    bus = BusServer(api, port=0).start()
    try:
        url = f"tcp://127.0.0.1:{bus.port}"
        texts = []
        for main in _vtctls():
            buf = io.StringIO()
            assert main(["--bus", url, "top", "--json"], out=buf) == 0
            texts.append(buf.getvalue())
            buf = io.StringIO()
            assert main(["--bus", url, "incidents", "list"], out=buf) == 0
            texts.append(buf.getvalue())
        assert texts[:2] == texts[2:]
        assert "apiserver-0 [standalone]" in json.loads(texts[0])["members"]
    finally:
        bus.stop()


# ---- parsers ----

def _parsed(monkeypatch, main, argv) -> dict:
    """The namespace ``main`` parses ``argv`` into, stopping there."""
    seen = {}

    class _Parsed(Exception):
        pass

    real = argparse.ArgumentParser.parse_args

    def parse_args(self, args=None, namespace=None):
        seen.update(vars(real(self, args, namespace)))
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_args)
    with pytest.raises(_Parsed):
        main(argv)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", real)
    return seen


@pytest.mark.parametrize("argv", [
    ["trace", "pod", "-N", "p"], ["trace", "gang", "-n", "x", "-N", "g", "--chrome", "c.json"],
    ["--bus", "tcp://h:1", "top", "--interval", "2", "--json"],
    ["top", "--watch", "1", "--count", "3", "--metrics", "a:1,b:2"],
    ["incidents", "list", "--identity", "d"], ["incident", "show", "--index", "2"],
    ["incidents", "collect", "-o", "d"],
    ["incidents", "capture", "-d", "d", "--settle", "0.5", "--boost-ttl", "9"],
    ["trace", "export", "-d", "a", "-d", "b", "--cycle", "3"],
])
def test_vtctl_parser_equal(monkeypatch, argv):
    port_main, jax_main = _vtctls()
    assert _parsed(monkeypatch, port_main, argv) == _parsed(monkeypatch, jax_main, argv)


@pytest.mark.parametrize("binary", ["scheduler", "apiserver"])
@pytest.mark.parametrize("argv", [[], ["--flight-recorder", "--watchdog", "--incident-dir", "d"]])
def test_obs_flags_parse_as_the_reference(monkeypatch, binary, argv):
    import importlib

    keys = ("flight_recorder", "watchdog", "incident_dir")
    port = _parsed(monkeypatch, importlib.import_module(f"volcano_tpu_torch.cmd.{binary}").main,
                   argv)
    ref = _parsed(monkeypatch, importlib.import_module(f"volcano_tpu.cmd.{binary}").main, argv)
    assert {k: port[k] for k in keys} == {k: ref[k] for k in keys}


@pytest.mark.parametrize("binary", ["scheduler", "apiserver"])
def test_binaries_hand_the_flags_to_their_daemons(cpu_actions, monkeypatch, binary, tmp_path):
    import importlib

    mod = importlib.import_module(f"volcano_tpu_torch.cmd.{binary}")
    built = []
    monkeypatch.setattr(mod, "serve_forever", lambda d: built.append(d) or 0, raising=False)
    if binary == "apiserver":
        import volcano_tpu_torch.cmd.daemon as daemon_mod

        monkeypatch.setattr(daemon_mod, "serve_forever", lambda d: built.append(d) or 0)
    extra = ["--device", "cpu"] if binary == "scheduler" else []
    argv = extra + ["--flight-recorder", "--watchdog", "--incident-dir", str(tmp_path)]
    assert mod.main(argv) == 0
    (d,) = built
    assert d.flight_recorder and d.watchdog is not None and d.incident_dir == str(tmp_path)
    assert d.incidents.directory == str(tmp_path)
    built.clear()
    assert mod.main(extra) == 0
    assert not built[0].flight_recorder and built[0].watchdog is None



# ---- the journal commands ----

def test_trace_record_and_replay_through_vtctl(tmp_path):
    port_main, _ = _vtctls()
    d = str(tmp_path / "j")
    buf = io.StringIO()
    assert port_main(["trace", "record", "-d", d, "--tasks", "64", "--nodes", "16",
                      "--gang-size", "4", "--cycles", "2", "--executor", "torch-scan",
                      "--device", "cpu"], out=buf) == 0
    assert "recorded 2 cycle(s)" in buf.getvalue()
    buf = io.StringIO()
    assert port_main(["trace", "replay", "-d", d, "--executor", "torch-scan",
                      "--device", "cpu"], out=buf) == 0
    assert buf.getvalue().endswith("(64/64 placed): IDENTICAL\n")
