"""The port's static-analysis suite (volcano_tpu_torch/analysis/) and
its runtime engines, on the CPU.

Every case of ``tests/test_analysis.py`` that has an object in the port
runs here on the port's passes (all but ``jit_safety``'s and the
explorer's, and the guarded-declaration scan, whose symbols name the
reference's replication module): the reference file's own class
sources, with ``volcano_tpu`` pointed at ``volcano_tpu_torch`` (so the
seeded sources sit at ``volcano_tpu_torch/`` paths) and the README
ladder's opener at the port's.  Then the port's own cases: the tree is
lint-clean under its one-entry baseline, dropping ``bus_status`` from
the port's ``OP_VERSIONS`` is flagged, the engines refuse to install over
the JAX package's, the race detector and the lock-order verifier stay
clean over bounded runs of the port's threaded code (the commit plane's
two workers, a bus server and its clients with remote admission, two
electors on one lock, the span channel's flusher, two shard lease
managers beside a gang broker), and ``vtctl lint`` and
``vtctl faults validate`` print what the JAX ``vtctl`` prints.  Every wait
is bounded.
"""

from __future__ import annotations

import ast
import io
import json
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from volcano_tpu.cli.vtctl import main as jax_vtctl
from volcano_tpu_torch.analysis import (  # noqa: F401 — the mirrored cases' names
    determinism,
    lock_discipline,
    lock_order,
    race,
    serde_drift,
)
from volcano_tpu_torch.analysis.__main__ import find_root, main as analysis_main
from volcano_tpu_torch.analysis.core import Baseline, Finding, SourceFile  # noqa: F401
from volcano_tpu_torch.cli.vtctl import main as port_vtctl
from tests.test_torch_commit_plane import MiniCluster, PORTP
from tests.torch_bus_helpers import cm, one_torch_thread, Pair, pkg, wait  # noqa: F401
from tests.torch_mirror import _port_source

ROOT = Path(__file__).resolve().parent.parent
PORT = pkg("port")

#: the reference's classes run here, with the cases each leaves out
MIRRORED = {
    "TestLockDiscipline": (),
    "TestDeterminism": (),
    "TestSerdeDrift": (),
    "TestBaseline": (),
    "TestLockOrder": (),
    "TestRepoTree": (),
    # its scan names the reference's replication module: the port's own
    # scan is test_scan_guarded_finds_the_ports_declarations below
    "TestRaceDetector": ("test_scan_guarded_finds_declarations_and_waivers",),
    "TestVersionLadderDrift": (),
}
#: module-level helpers of the reference file the classes use
HELPERS = ("_src", "_codes")


def _mirror(rel: str) -> str:
    """The port's copy of the mirrored helpers and classes of ``rel``."""
    text = (ROOT / rel).read_text()
    lines = text.splitlines(keepends=True)
    tree = ast.parse(text)
    parts = []
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name in HELPERS:
            parts.append(ast.get_source_segment(text, node))
        elif isinstance(node, ast.ClassDef) and node.name in MIRRORED:
            drop = set()
            for item in node.body:
                if isinstance(item, ast.FunctionDef) and item.name in MIRRORED[node.name]:
                    first = min([item.lineno] + [d.lineno for d in item.decorator_list])
                    drop.update(range(first, item.end_lineno + 1))
            parts.append("".join(
                line for n, line in enumerate(lines[node.lineno - 1:node.end_lineno],
                                              node.lineno) if n not in drop))
    assert len(parts) == len(HELPERS) + len(MIRRORED)
    source = _port_source("\n\n".join(parts))
    # the port's README ladder opens with its own phrase
    return re.sub(r"The wire protocol is at \*\*VBUS version (\d+)\*\*",
                  r"The port speaks **VBUS version \1** on the wire", source)


exec(compile(_mirror("tests/test_analysis.py"), "tests/test_analysis.py (the port's copy)",
             "exec"), globals())


# ---- the port's own cases ----

def test_mirror_runs_the_ports_modules():
    assert lock_discipline.__name__.startswith("volcano_tpu_torch.")
    assert "volcano_tpu_torch/fixture.py" in _mirror("tests/test_analysis.py")
    assert find_root() == str(ROOT)


def test_dropping_bus_status_is_flagged(monkeypatch):
    """The fault the port shipped before its registry entry: the server
    dispatches ``bus_status`` and the client sends it, so without the
    entry the serde pass flags it."""
    from volcano_tpu_torch.bus import protocol

    trimmed = dict(protocol.OP_VERSIONS)
    del trimmed["bus_status"]
    monkeypatch.setattr(protocol, "OP_VERSIONS", trimmed)
    findings = serde_drift.run(find_root())
    assert [(f.code, f.symbol) for f in findings] == [("SRD002", "bus_status")]
    assert protocol.OP_VERSIONS is trimmed


def test_baseline_holds_only_the_references_suppression():
    """Each entry of the port's baseline has the JAX package's entry for
    the same symbol, and a reason."""
    port = Baseline.load(str(ROOT / "volcano_tpu_torch/analysis/baseline.json")).entries
    ref = Baseline.load(str(ROOT / "volcano_tpu/analysis/baseline.json")).entries
    keys = {(e["pass"], e["code"], e["file"].replace("volcano_tpu/", "volcano_tpu_torch/", 1),
             e["symbol"]) for e in ref}
    assert port and all((e["pass"], e["code"], e["file"], e["symbol"]) in keys for e in port)
    assert all(e["reason"] for e in port)


def test_scan_guarded_finds_the_ports_declarations():
    decls = race.scan_guarded(find_root())
    symbols = {d.symbol for d in decls}
    assert "volcano_tpu_torch.faults.plane:FaultPlane._points" in symbols
    assert "volcano_tpu_torch.cache.commit_plane:CommitPlane._items" in symbols
    assert all(d.module.startswith("volcano_tpu_torch.") for d in decls)
    assert all(d.lock for d in decls)


def test_engines_refuse_to_install_over_the_jax_packages():
    """Both packages' verifiers would wrap ``threading.Lock`` twice: the
    port's refuse while the JAX package's are in place, and install once
    they are gone (in a child: the engines patch process globals)."""
    code = (
        "import threading\n"
        "from volcano_tpu.analysis import lock_order as jlo, race as jrace\n"
        "from volcano_tpu_torch.analysis import lock_order as plo, race as prace\n"
        "real = threading.Lock\n"
        "jlo.install()\n"
        "for install in (plo.install, prace.install):\n"
        "    try:\n"
        "        install()\n"
        "        raise SystemExit(f'{install.__module__} installed over the JAX wrapper')\n"
        "    except RuntimeError as e:\n"
        "        assert 'another' in str(e), e\n"
        "assert not plo.enabled() and not prace.enabled()\n"
        "jlo.uninstall()\n"
        "jrace.install()\n"
        "try:\n"
        "    prace.install()\n"
        "    raise SystemExit('race installed over the JAX detector')\n"
        "except RuntimeError:\n"
        "    pass\n"
        "jrace.uninstall()\n"
        "jlo.uninstall()\n"
        "assert threading.Lock is real\n"
        "prace.install()\n"
        "assert plo.enabled() and threading.Lock is not real\n"
        "prace.uninstall()\n"
        "assert threading.Lock is real and not plo.enabled()\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ---- the runtime engines over the port's threaded code ----

@pytest.fixture
def engines():
    """The port's race detector and its lock-order verifier installed
    for one test, every ``# guarded-by:`` attribute of the port tracked;
    everything taken off again after."""
    det = race.install()
    try:
        summary = race.instrument_package()
        assert summary["instrumented_attrs"] > 50 and not summary["skipped"], summary
        yield det
    finally:
        race.uninstall()
    assert not race.enabled() and not lock_order.enabled()
    assert threading.Lock is lock_order._real_lock


def _assert_clean(det, min_accesses: int = 1) -> None:
    race.check_clean()
    lock_order.check_acyclic()
    assert det.n_accesses >= min_accesses
    assert lock_order.report()["locks"] > 0


def test_commit_plane_workers_race_free(engines, tmp_path):
    """Two pipelined cycles: the binds, Events and statuses land through
    the plane's queue on its two bind workers."""
    cluster = MiniCluster(PORTP, tmp_path, "engines", pipelined=True, host=True)
    try:
        cluster.submit_workload()
        for _ in range(2):
            cluster.cycle()
            assert cluster.cache._commit_plane.barrier(30)
        assert len(cluster.placed()) == 5 and not cluster.rebinds
    finally:
        cluster.close()
    _assert_clean(engines, 500)


def test_bus_server_clients_and_admission_race_free(engines):
    """A port bus server, a webhook client reviewing ConfigMap creates,
    a submitting client with a live watch, and a commit frame."""
    p = Pair("port", "port")
    try:
        reviewer = p.new_client()

        def hook(operation, obj):
            if obj.metadata.name == "forbidden":
                raise PORT.AdmissionError("name is forbidden")
            obj.data["admitted-by"] = "hook"
            return obj

        reviewer.register_admission("ConfigMap", "CREATE", hook)
        assert wait(lambda: bool(p.server._admission.get(("ConfigMap", "CREATE"))), 5)
        events = []
        p.client.watch("ConfigMap", lambda e, o, n: events.append((e, (n or o).metadata.name)))
        for i in range(8):
            p.client.create(cm(PORT, f"c{i}"))
        with pytest.raises(PORT.ApiError, match="forbidden"):
            p.client.create(cm(PORT, "forbidden"))
        assert wait(lambda: len(events) >= 8, 10), events
        assert p.store.get("ConfigMap", "ns", "c7").data["admitted-by"] == "hook"
        assert p.client.bus_status()
    finally:
        p.close()
    _assert_clean(engines, 200)


def test_two_electors_on_one_lock_race_free(engines):
    api = PORT.APIServer()
    e1 = PORT.LeaderElector(api, "lock", "id-1", lease_duration=0.5, retry_period=0.02).start()
    e2 = PORT.LeaderElector(api, "lock", "id-2", lease_duration=0.5, retry_period=0.02).start()
    try:
        assert wait(lambda: e1.is_leader or e2.is_leader, 5)
        for _ in range(10):
            assert not (e1.is_leader and e2.is_leader)
            time.sleep(0.02)
        leader, standby = (e1, e2) if e1.is_leader else (e2, e1)
        leader.stop(release=True)
        assert wait(lambda: standby.is_leader, 5)
    finally:
        e1.stop()
        e2.stop()
    _assert_clean(engines, 50)


def test_span_channel_flusher_race_free(engines):
    """Spans from three threads batch through the exporter's ring; its
    flusher thread ships them into the store's segments."""
    from volcano_tpu_torch import obs

    api = PORT.APIServer()
    exp = obs.enable(api, identity="engines", flush_interval=0.01)
    try:
        def emit(k):
            for i in range(20):
                with obs.span(f"work:{k}:{i}", cat="test"):
                    pass

        threads = [threading.Thread(target=emit, args=(k,)) for k in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
            assert not t.is_alive()
        assert wait(lambda: exp.exported >= 60, 10), exp.exported
        segments = [c for c in api.list("ConfigMap", obs.NAMESPACE)
                    if c.metadata.name.startswith(obs.SEGMENT_PREFIX)]
        assert segments
    finally:
        obs.disable()
    _assert_clean(engines, 100)


def test_two_lease_managers_and_a_gang_broker_race_free(engines):
    """Two shard lease managers on one map, one feeding a member's shard
    state and filter (relist on acquire) from its thread; that member's
    gang broker plans on the filter's ledger and commits a gang through
    ``txn_commit`` meanwhile."""
    from tests.test_torch_federation_mixed import fed
    from volcano_tpu_torch.cache import SchedulerCache
    from volcano_tpu_torch.client import SchedulerClient
    from volcano_tpu_torch.federation import GangBroker, ShardLeaseManager, ShardState
    from volcano_tpu_torch.federation.filter import ShardInformerFilter
    from volcano_tpu_torch.federation.sharding import home_shard

    f = fed("port")
    api = PORT.APIServer()
    for i in range(8):  # both shards hold nodes
        api.create(f.b.build_node(f"n{i:03d}", {"cpu": "16", "memory": "64Gi"}))
    cache = SchedulerCache(client=SchedulerClient(api), scheduler_name="volcano-tpu")
    state = ShardState(2)
    filt = ShardInformerFilter(cache, state, lister=api)
    cache.set_informer_sink(filt)
    cache.run()

    def acquire(shard):
        state.acquire(shard)
        filt.on_acquire(shard)

    def release(shard):
        state.release(shard)
        filt.on_release(shard)

    other = set()
    mgrs = [ShardLeaseManager(api, "m0", 2, lease_duration=0.5, retry_period=0.02,
                              on_acquire=acquire, on_release=release,
                              stats=lambda: {"sketch": filt.capacity_sketch()}),
            ShardLeaseManager(api, "m1", 2, lease_duration=0.5, retry_period=0.02,
                              on_acquire=other.add, on_release=other.discard)]
    try:
        for m in mgrs:
            m.start()
        assert wait(lambda: len(state.owned()) == 1 and len(other) == 1, 10)
        assert wait(lambda: filt.owned_node_count() > 0, 5)
        home = next(iter(state.owned()))
        name = next(f"g{k}" for k in range(64) if home_shard("ns", f"g{k}", 2) == home)
        api.create(f.b.build_pod_group("ns", name, 2))
        for i in range(2):
            api.create(f.b.build_pod("ns", f"{name}-t{i}", "", {"cpu": "2", "memory": "1Gi"},
                                     group=name))
        broker = GangBroker(cache, state, filt, api, assemble_after=0)
        assert broker.run_once() == 1, broker.counters()
        assert sorted(bool(p.spec.node_name) for p in api.list("Pod")) == [True, True]
        for _ in range(10):
            filt.capacity_sketch()
            time.sleep(0.02)
    finally:
        for m in mgrs:
            m.stop()
    _assert_clean(engines, 200)


# ---- vtctl ----

def _run(main, argv):
    out = io.StringIO()
    return main(argv, out=out), out.getvalue()


def test_vtctl_lint_prints_what_the_jax_vtctl_prints(tmp_path):
    """Each package's tree is clean under its own one-entry baseline,
    and both ``vtctl lint``s say so in the same words."""
    port = _run(port_vtctl, ["lint"])
    assert port == _run(jax_vtctl, ["lint"])
    assert port == (0, "analysis: 0 finding(s), 1 suppressed, 0 stale baseline entries\n")
    report = tmp_path / "report.json"
    assert _run(port_vtctl, ["--bus", "tcp://unused:1", "lint", "--pass", "serde",
                             "--report", str(report)])[0] == 0
    assert json.loads(report.read_text())["findings"] == []


@pytest.mark.parametrize("spec, rc", [
    ("seed=1;device.lowering=1:count=3", 0),
    ("seed=7;device.nan=0.5:after=2;device.slow=1:ms=50", 0),
    ("seed=3", 0),
    ("seed=1;bogus", 1),
    ("seed=1;device.lowering=2", 1),
])
def test_vtctl_faults_validate_prints_what_the_jax_vtctl_prints(spec, rc):
    port = _run(port_vtctl, ["faults", "validate", "--spec", spec])
    assert port == _run(jax_vtctl, ["faults", "validate", "--spec", spec])
    assert port[0] == rc
