"""The port's tail sampling, SLO watchdog and incident bundles against the
JAX package's, tolerance 0.

The tail sampler: one seeded stream of offered records, sweeps, peer
decisions and drains gives the same released spans, evictions, published
decisions and counters.  The exporters in tail mode publish the same
``vtpu-tail-*`` objects and resolve a peer's decisions the same way; the
capture boost keeps the same spans, and ``set_capture_boost``'s CAS rule
(extend, never shorten) leaves the same records.  The metrics side:
``parse_metrics``, ``histogram_quantile``, ``merge_histograms`` and
``delta`` on the same exposition texts, and ``TimeSeriesRing`` with
``BurnRateWatchdog`` over one sequence of scrape texts: the same burns,
alerts, ``degraded_reasons`` and fired breaches.  Incidents: the same
bundle files and ``meta.json`` (timestamps aside) and the same
``list_incidents``.  The daemons: ``BaseDaemon`` with the recorder and
the watchdog, its /healthz reading ``degraded: slo-burn:<name>`` during
a breach.
"""

from __future__ import annotations

import json
import os
import time
import zlib

import numpy as np
import pytest

from tests.torch_bus_helpers import one_torch_thread  # noqa: F401


def _pkg(name: str):
    """One package's recorder modules and registry by the same names."""
    from types import SimpleNamespace

    if name == "port":
        from volcano_tpu_torch import metrics, obs
        from volcano_tpu_torch.client import APIServer
        from volcano_tpu_torch.metrics import scrape
        from volcano_tpu_torch.metrics.timeseries import TimeSeriesRing
        from volcano_tpu_torch.obs import channel, incident, slo, spans, tail
        from volcano_tpu_torch import trace
        registry = metrics.registry
    else:
        from volcano_tpu import obs, trace
        from volcano_tpu.client import APIServer
        from volcano_tpu.metrics import metrics, scrape
        from volcano_tpu.metrics.timeseries import TimeSeriesRing
        from volcano_tpu.obs import channel, incident, slo, spans, tail
        registry = metrics.registry
    return SimpleNamespace(name=name, obs=obs, APIServer=APIServer, metrics=metrics,
                           scrape=scrape, TimeSeriesRing=TimeSeriesRing, channel=channel,
                           incident=incident, slo=slo, spans=spans, tail=tail, trace=trace,
                           registry=registry)


PKGS = ("port", "jax")


@pytest.fixture(autouse=True)
def _clean_obs():
    for name in PKGS:
        p = _pkg(name)
        p.obs.disable()
        p.registry.reset()
    yield
    for name in PKGS:
        p = _pkg(name)
        p.obs.disable()
        p.registry.reset()


class _Clock:
    """A deterministic ``time`` module stand-in: ``time()``,
    ``monotonic()`` and ``perf_counter()`` read ``t``, which the test
    advances."""

    def __init__(self, t: float = 1_700_000_000.0):
        self.t = t

    def time(self) -> float:
        return self.t

    monotonic = perf_counter = time

    @staticmethod
    def sleep(s):
        time.sleep(s)


def _coin(sample: float):
    return lambda tid: (zlib.crc32(tid.encode()) % 10_000) < sample * 10_000


def _lines(reg, prefix: str) -> list:
    return [ln for ln in reg.render().splitlines() if ln.startswith(prefix)]


# ---- the tail sampler ----

def _tail_script(p, seed: int, monkeypatch) -> list:
    """One seeded stream through package ``p``'s TailSampler: offers of
    records over a pool of traces (roots, error tags, slow spans),
    sweeps, peer decisions and drains, on a clock the script advances;
    → everything the sampler returned, its counters and its metrics."""
    clock = _Clock()
    monkeypatch.setattr(p.tail, "time", clock)
    rng = np.random.RandomState(seed)
    cfg = p.tail.TailConfig(max_traces=8, max_spans_per_trace=6, settle_s=0.5,
                            pending_timeout_s=3.0, floor_ms=25.0, p99_factor=4.0,
                            min_kind_samples=16, duration_window=32, decision_memo=64)
    ts = p.tail.TailSampler(_coin(0.3), cfg)
    tids = [format(zlib.crc32(f"ns/p{i}".encode()), "08x") for i in range(24)]
    names = ("bind:landed", "bus:create", "commit:flush", "cycle:full")
    out = []
    for step in range(600):
        clock.t += float(rng.exponential(0.05))
        r = rng.rand()
        if r < 0.8:
            tid = tids[rng.randint(len(tids))]
            rec = {"t": tid, "s": f"s{step}", "p": "", "name": names[rng.randint(4)],
                   "cat": "span", "ts": 1e15 + step, "dur": float(rng.lognormal(8.5, 1.0)),
                   "tid": 1}
            if rng.rand() < 0.15:
                rec["_root"] = True
            if rng.rand() < 0.03:
                rec["args"] = {("error", "fallback", "degraded")[rng.randint(3)]: "x"}
            out.append(("offer", ts.keep(tid), [x["s"] for x in ts.offer(rec)]))
        elif r < 0.92:
            out.append(("sweep", [x["s"] for x in ts.sweep(boost=rng.rand() < 0.05)]))
        elif r < 0.97:
            out.append(("drain", sorted(ts.drain_decisions().items())))
        else:
            decisions = {tids[i]: bool(rng.rand() < 0.5)
                         for i in rng.choice(len(tids), 3, replace=False)}
            out.append(("remote", [x["s"] for x in ts.apply_remote(decisions)]))
        out.append(ts.pending_count())
    out.append((ts.kept_traces, ts.dropped_traces, ts.evicted_traces, ts.anomaly_keeps,
                dict(ts._decided)))
    out.append(_lines(p.registry, "volcano_telemetry_tail_"))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_tail_sampler_equal(monkeypatch, seed):
    got = [_tail_script(_pkg(name), seed, monkeypatch) for name in PKGS]
    assert got[0] == got[1]
    kinds = {e[0] for e in got[0] if isinstance(e, tuple) and isinstance(e[0], str)}
    assert kinds >= {"offer", "sweep", "drain"}
    counters = got[0][-2]
    assert counters[0] > 0 and counters[1] > 0 and counters[2] > 0 and counters[3] > 0


def _rec(tid, name="op", dur=1000.0, sid=None, root=False, args=None, ts=1e6):
    r = {"t": tid, "s": sid or f"{tid}:{name}:{dur}", "p": "", "name": name, "cat": "span",
         "ts": ts, "dur": dur, "tid": 1}
    if root:
        r["_root"] = True
    if args:
        r["args"] = dict(args)
    return r


def _drop_tid(prefix: str, sample: float = 0.01) -> str:
    """A trace id the head coin drops at ``sample``."""
    coin = _coin(sample)
    for i in range(100_000):
        tid = format(zlib.crc32(f"default/{prefix}{i}".encode()), "08x")
        if not coin(tid):
            return tid
    raise AssertionError("no coin-dropped id")


def _exporters_script(p) -> list:
    """Two tail-mode exporters on one store: one holds the evidence for a
    trace and settles another by coin, publishes; the other resolves its
    pending spans from the published decisions; then a capture boost."""
    api = p.APIServer()
    e1 = p.channel.SpanExporter(api, "d1", sample=0.01, flush_interval=3600, tail=True)
    e2 = p.channel.SpanExporter(api, "d2", sample=0.01, flush_interval=3600, tail=True)
    e1.tail = p.tail.TailSampler(e1._coin, p.tail.TailConfig(settle_s=0.0))
    e2.tail = p.tail.TailSampler(e2._coin, p.tail.TailConfig(settle_s=0.0))
    t_keep, t_drop = _drop_tid("xk-"), _drop_tid("xd-")
    e2.emit(_rec(t_keep, "bus:bind", sid="d2-k"))
    e2.emit(_rec(t_drop, "bus:commit_batch", sid="d2-d"))
    e1.emit(_rec(t_keep, "bind", sid="d1-k", args={"error": "X"}))
    e1.emit(_rec(t_drop, "bind:landed", sid="d1-d", root=True))
    e1.tick()
    e2.tick()
    out = [sorted((cm.metadata.name, dict(cm.data))
                  for cm in api.list("ConfigMap", p.obs.NAMESPACE)),
           e2.tail.keep(t_keep), e2.tail.keep(t_drop), e2.tail.pending_count()]
    # a boost keeps what the coin drops, and bypasses the pending pool
    e1.set_boost({"until": time.time() + 30, "by": "t", "reason": "test", "ts": 1.0})
    e1.emit(_rec(_drop_tid("b-"), "bind", sid="boosted", root=True))
    out.append((e1.boost_active(), e1.tail.pending_count(), e1.flush(), e1.exported))
    out.append(_lines(p.registry, "volcano_telemetry_") + _lines(p.registry,
                                                                 "volcano_capture_boost"))
    return out


def test_tail_exporters_equal():
    got = [_exporters_script(_pkg(name)) for name in PKGS]
    assert got[0] == got[1]
    segments, keep, drop, pending = got[0][:4]
    assert keep and not drop and pending == 0
    assert any(name.startswith("vtpu-tail-d1") for name, _data in segments)
    assert got[0][4][:2] == (True, 0)


def test_boost_cas_and_poll_equal():
    out = {}
    for name in PKGS:
        p = _pkg(name)
        api = p.APIServer()
        seq = [p.incident.set_capture_boost(api, "a", "r1", ttl_s=100.0, now=1000.0),
               p.incident.set_capture_boost(api, "b", "r2", ttl_s=10.0, now=1005.0),
               p.incident.set_capture_boost(api, "b", "r2", ttl_s=300.0, now=1010.0),
               p.incident.set_capture_boost(api, "c", "r3", ttl_s=1.0, now=1300.0)]
        stored = json.loads(api.get("ConfigMap", p.obs.NAMESPACE,
                                    p.obs.BOOST_NAME).data[p.obs.BOOST_KEY])
        exp = p.channel.SpanExporter(api, "d0", sample=0.0, flush_interval=3600, tail=True)
        p.incident.set_capture_boost(api, "vtctl", "manual", ttl_s=30.0)
        exp._beat = exp._boost_poll_every - 1
        exp.tick()  # the poll beat
        rec = exp.boost_record()
        out[name] = (seq, stored, exp.boost_active(), rec["by"], rec["reason"])
    assert out["port"] == out["jax"]
    seq = out["port"][0]
    assert seq[1]["until"] == 1100.0 and seq[1]["by"] == "a"  # never shortened
    assert seq[2]["until"] == 1310.0 and seq[3]["until"] == 1310.0


# ---- the metrics read side and the watchdog ----

def _scrape_texts(seed: int) -> list:
    """Exposition texts of the port's registry after each of a seeded
    sequence of submit→bind latencies, commit failures, micro-cycle
    latencies and breaker states (the registry reset after)."""
    from volcano_tpu_torch import metrics

    rng = np.random.RandomState(seed)
    metrics.registry.reset()
    texts = []
    for step in range(40):
        slow = 10 <= step < 25
        for _ in range(rng.randint(5, 40)):
            metrics.observe_submit_to_bind(float(rng.lognormal(np.log(2.0 if slow else 0.2),
                                                               0.5)))
        for _ in range(rng.poisson(3 if 15 <= step < 30 else 0.1)):
            metrics.register_commit_failure("bind")
        metrics.update_micro_cycle_duration(float(rng.lognormal(np.log(0.05), 0.5)))
        metrics.update_circuit_breaker_state("cuda", float(28 <= step < 33))
        texts.append(metrics.registry.render())
    metrics.registry.reset()
    return texts


class _Replay:
    """A registry stand-in whose ``render`` replays the given texts."""

    def __init__(self, texts):
        self.texts = list(texts)

    def render(self) -> str:
        return self.texts.pop(0)


def _watchdog_script(p, texts) -> list:
    fired = []
    ring = p.TimeSeriesRing(_Replay(texts), capacity=16)
    wd = p.slo.BurnRateWatchdog(ring, slos=p.slo.resolve_slos("submit-bind-p99=1000"),
                                fast_window_s=30.0, slow_window_s=90.0,
                                on_breach=lambda a: fired.append(a.to_dict()))
    out = []
    for i in range(len(texts)):
        alerts = wd.run_once(now=1000.0 + 10.0 * i)
        out.append(([a.to_dict() for a in alerts], wd.degraded_reasons(),
                    _lines(p.registry, "volcano_slo_burn")))
    out.append((fired, wd.evaluations, wd.breaches, len(ring), ring.span_seconds()))
    out.append(ring.dump())
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_watchdog_equal(seed):
    texts = _scrape_texts(seed)
    got = [_watchdog_script(_pkg(name), texts) for name in PKGS]
    assert got[0] == got[1]
    fired = got[0][-2][0]
    assert {a["name"] for a in fired} >= {"submit-bind-p99", "commit-failures"}
    assert any("slo-burn:submit-bind-p99" in step[1] for step in got[0][:-2])


@pytest.mark.parametrize("seed", [0, 1])
def test_scrape_parsing_equal(seed):
    texts = _scrape_texts(seed)
    port, jax = _pkg("port").scrape, _pkg("jax").scrape
    for i, text in enumerate(texts):
        a, b = port.parse_metrics(text), jax.parse_metrics(text)
        assert a.series == b.series and a.histograms == b.histograms
        h = a.histogram("volcano_submit_to_bind_latency_milliseconds")
        assert h == b.histogram("volcano_submit_to_bind_latency_milliseconds")
        for q in (0.5, 0.9, 0.99, 1.0):
            assert port.histogram_quantile(h, q) == jax.histogram_quantile(h, q)
        if i:
            prev_a, prev_b = port.parse_metrics(texts[i - 1]), jax.parse_metrics(texts[i - 1])
            da, db = port.delta(a, prev_a), jax.delta(b, prev_b)
            assert da.series == db.series and da.histograms == db.histograms
            hs = [h, prev_a.histogram("volcano_submit_to_bind_latency_milliseconds")]
            assert port.merge_histograms(hs) == jax.merge_histograms(hs)
    assert port.histogram_quantile(None, 0.99) == 0.0


def test_resolve_slos_equal():
    for spec in ("", "submit-bind-p99=50, bogus=1, micro-cycle-p99=abc", "repl-lag=3"):
        a = [(s.name, s.kind, s.metric, s.objective, s.labels, s.description)
             for s in _pkg("port").slo.resolve_slos(spec)]
        b = [(s.name, s.kind, s.metric, s.objective, s.labels, s.description)
             for s in _pkg("jax").slo.resolve_slos(spec)]
        assert a == b


# ---- incident bundles ----

def _seed_store(p):
    """A store holding one exporter's segments: a cycle with binds."""
    api = p.APIServer()
    exp = p.channel.SpanExporter(api, "d0", flush_interval=3600)
    p.spans._set_exporter(exp)
    try:
        with p.obs.span("cycle:full", cat="scheduler"):
            for i in range(5):
                p.obs.complete("bind:landed", 0.0, trace_id=p.obs.trace_id_for_pod("ns", f"p{i}"),
                               args={"pod": f"ns/p{i}"})
    finally:
        p.spans._set_exporter(None)
    exp.flush_all()
    return api


def _copy_segments(src, p):
    """A fresh store of package ``p`` holding ``src``'s ConfigMaps."""
    from volcano_tpu.apis import core as jcore
    from volcano_tpu_torch.apis import core as pcore

    core = pcore if p.name == "port" else jcore
    api = p.APIServer()
    for cm in src.list("ConfigMap"):
        api.create(core.ConfigMap(metadata=core.ObjectMeta(name=cm.metadata.name,
                                                           namespace=cm.metadata.namespace),
                                  data=dict(cm.data)))
    return api


def _journal(tmp_path) -> str:
    """A journal of two recorded cycles (the port's recorder; both
    packages read it)."""
    from volcano_tpu_torch import trace

    d = str(tmp_path / "journal")
    rec = trace.TraceRecorder(journal=trace.Journal(d), snapshot_every=0)
    for i in range(2):
        rec.begin_cycle()
        rec.event("cycle-summary", "scheduler", placed=i)
        rec.end_cycle(duration_s=0.01)
    return d


def _strip_meta(meta: dict) -> dict:
    out = dict(meta, ts=None)
    if out.get("boost"):
        out["boost"] = dict(out["boost"], until=None, ts=None)
    return out


def test_incident_bundles_equal(tmp_path):
    source = _seed_store(_pkg("port"))
    journal = _journal(tmp_path)
    texts = _scrape_texts(0)[:4]
    got = {}
    for name in PKGS:
        p = _pkg(name)
        api = _copy_segments(source, p)
        ring = p.TimeSeriesRing(_Replay(texts))
        for i in range(4):
            ring.tick(now=1000.0 + i)
        exp = p.obs.enable(api, identity="d0", flush_interval=3600)
        mgr = p.incident.IncidentManager(api, "d0", str(tmp_path / name), cooldown_s=60.0,
                                         boost_ttl_s=30.0, settle_s=0.0, metrics_ring=ring,
                                         journal_dir=journal,
                                         explain_source=lambda: {"jobs": [{"name": "j"}]})
        alert = p.slo.Alert("submit-bind-p99", 12.7, 3.2, 636.8, 1000.0, 1030.0)
        mgr.on_alert(alert)  # settle 0: a synchronous capture
        mgr.on_alert(alert)  # inside the cooldown: the boost re-armed, no second bundle
        mgr.trigger("breaker-open", sync=True)
        bundles = sorted(os.listdir(tmp_path / name))
        files = {}
        for b in bundles:
            bdir = tmp_path / name / b
            files[b.split("-", 2)[2]] = {
                f: (_strip_meta(json.loads((bdir / f).read_text())) if f == "meta.json"
                    else (bdir / f).read_text())
                for f in sorted(os.listdir(bdir))}
        listed = [dict(r, meta=_strip_meta(r["meta"])) for r in p.obs.list_incidents(api)]
        got[name] = (files, listed, mgr.captured, mgr.suppressed_triggers, exp.boost_active(),
                     _lines(p.registry, "volcano_incidents_captured_total"))
        p.obs.disable()
    assert got["port"] == got["jax"]
    files, listed, captured, suppressed, boosted, _ = got["port"]
    assert set(files) == {"slo-burn-submit-bind-p99", "breaker-open"}
    meta = files["slo-burn-submit-bind-p99"]["meta.json"]
    assert meta["files"] == ["bus_status.json", "explain.json", "journal.json", "metrics.jsonl",
                             "shard_map.json", "spans.json", "meta.json"]
    assert meta["errors"] == {} and meta["spanCount"] == 6
    assert files["slo-burn-submit-bind-p99"]["shard_map.json"] == "null"
    assert len(json.loads(files["slo-burn-submit-bind-p99"]["journal.json"])) == 2
    assert (captured, suppressed, boosted) == (2, 1, True)
    assert [r["meta"]["reason"] for r in listed] == ["slo-burn:submit-bind-p99", "breaker-open"]


def test_incident_ring_prunes_and_survives_missing_sources(tmp_path):
    class _BrokenAPI:
        def list(self, *a, **k):
            raise RuntimeError("bus down")

        get = create = list

    got = {}
    for name in PKGS:
        p = _pkg(name)
        mgr = p.incident.IncidentManager(p.APIServer(), "d0", str(tmp_path / name / "ring"),
                                         ring=2, cooldown_s=0.0, settle_s=0.0)
        for i in range(4):
            mgr.capture(f"t{i}")
        broken = p.incident.IncidentManager(_BrokenAPI(), "d0", str(tmp_path / name / "b"),
                                            settle_s=0.0, journal_dir=str(tmp_path / "nope"))
        path = broken.capture("manual")
        meta = json.loads(open(os.path.join(path, "meta.json")).read())
        got[name] = ([b.split("-", 2)[2] for b in sorted(os.listdir(tmp_path / name / "ring"))],
                     _strip_meta(meta))
    assert got["port"] == got["jax"]
    assert got["port"][0] == ["t2", "t3"]
    assert set(got["port"][1]["errors"]) >= {"spans.json", "shard_map.json"}


# ---- the daemons: recorder, watchdog and /healthz ----

def test_daemon_recorder_watchdog_and_healthz(tmp_path, monkeypatch):
    """A BaseDaemon with the recorder and the watchdog: ``start`` installs
    the exporter, a breach of the watchdog's SLO reads ``degraded:
    slo-burn:<name>`` on /healthz and writes one bundle, ``stop`` flushes
    and uninstalls the exporter; the env vars turn them on as the flags
    do."""
    import urllib.request

    from volcano_tpu_torch import metrics, obs
    from volcano_tpu_torch.client import APIServer
    from volcano_tpu_torch.cmd.daemon import BaseDaemon

    class Idle(BaseDaemon):
        NAME = "vtpu-idle"

        def _work(self):
            with obs.span("cycle:full", cat="scheduler"):
                pass

    monkeypatch.setenv("VTPU_SLO_OBJECTIVES", "submit-bind-p99=50")
    monkeypatch.setenv("VTPU_WATCHDOG_PERIOD", "3600")
    monkeypatch.setenv("VTPU_BOOST_TTL", "1")
    api = APIServer()
    d = Idle(api, period=0.02, flight_recorder=True, watchdog=True,
             incident_dir=str(tmp_path / "inc"), identity="idle-0")
    try:
        d.start()
        assert obs.get_exporter() is d._obs_exporter and obs.enabled()

        def healthz() -> str:
            with urllib.request.urlopen(f"http://127.0.0.1:{d.serving.port}/healthz",
                                        timeout=5) as r:
                return r.read().decode()

        assert healthz() == "ok"
        d.watchdog.ring.tick(now=1000.0)
        for _ in range(50):
            metrics.observe_submit_to_bind(0.5)
        d.incidents.settle_s = 0.0
        alerts = d.watchdog.run_once(now=1030.0)
        assert [a.name for a in alerts] == ["submit-bind-p99"]
        assert healthz() == "degraded: slo-burn:submit-bind-p99"
        assert len(os.listdir(tmp_path / "inc")) == 1
    finally:
        d.stop()
    assert not obs.enabled() and d._obs_exporter is None
    names = {s["name"] for s in obs.collect_spans(api)}
    assert "cycle:full" in names  # the final flush landed
    monkeypatch.setenv("VTPU_FLIGHT_RECORDER", "1")
    monkeypatch.setenv("VTPU_WATCHDOG", "1")
    monkeypatch.setenv("VTPU_INCIDENT_DIR", str(tmp_path / "env"))
    e = Idle(api, identity="idle-1")
    assert e.flight_recorder and e.watchdog is not None
    assert e.incidents.directory == str(tmp_path / "env")
    monkeypatch.setenv("VTPU_FLIGHT_RECORDER", "0")
    monkeypatch.delenv("VTPU_WATCHDOG")
    f = Idle(api, identity="idle-2")
    assert not f.flight_recorder and f.watchdog is None
