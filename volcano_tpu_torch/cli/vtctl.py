"""vtctl — the control CLI of the port.

The port of ``volcano_tpu/cli/vtctl.py``, for the commands whose callers
the port has:

  vtctl trace pod|gang    the flight recorder's cross-process submit→bind
                          waterfall of one pod or gang (``--chrome`` also
                          writes the merged multi-process Chrome JSON)
  vtctl trace record|replay|diff|export
                          the cycle journal (``cmd/trace.py``'s commands)
  vtctl top               /metrics aggregated across the membership
  vtctl incidents list|show|collect|capture
                          the incident bundles the SLO watchdog (or an
                          operator) captures

Commands run against an API server: an empty in-process one by default
(tests pass theirs to :func:`main`), or a ``vtpu-apiserver`` of the port
or of the JAX package with ``--bus tcp://host:port``.  The text of each
command is the JAX ``vtctl``'s for the same store.

Usage: python -m volcano_tpu_torch.cli.vtctl [--bus URL] trace pod -N NAME

Not present in the port yet, each waiting for its caller: ``job``,
``queue`` and ``describe`` (the Job kind and the controllers),
``shards`` (federation), ``bus status|add-replica|remove-replica``
(WAL and replication), ``faults validate``, ``lint`` and ``explore``
(``analysis/``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional

from volcano_tpu_torch import obs
from volcano_tpu_torch.client import ApiError, APIServer, VolcanoClient
from volcano_tpu_torch.cmd import trace as trace_cmd
from volcano_tpu_torch.metrics import scrape as _scrape
from volcano_tpu_torch.obs.shard_map import read_shard_map


# ---- the cycle journal (cmd/trace.py's commands) ----

def _journal(vc: VolcanoClient, args, out) -> int:
    return trace_cmd.COMMANDS[args.cmd](args, out)


# ---- flight recorder (obs/): the cross-process waterfall ----

def _trace_identity(vc: VolcanoClient, args, out, gang: bool) -> int:
    """Shared body of ``vtctl trace pod`` / ``vtctl trace gang``:
    collect the durably-held telemetry segments from the bus, select
    the identity's trace (matched spans + ancestor closure + the
    cycles' process-scope sub-spans) and render the submit→bind
    waterfall; ``--chrome`` additionally writes the merged
    multi-process trace_event JSON with real pid/tid rows.  Reads only
    the API surface — identical over in-process and ``--bus``."""
    spans = obs.collect_spans(vc.api)
    if gang:
        idents = [(args.namespace, args.name)]
    else:
        # a pod's waterfall unions the pod, its PodGroup, and its
        # owning Job (the controller's status-writeback trace)
        idents = obs.related_identities(vc.api, args.namespace, args.name)
    trace = obs.select_union(spans, idents)
    kind = "gang" if gang else "pod"
    print(f"Flight recorder — {kind} {args.namespace}/{args.name} "
          f"(trace {obs.trace_id_for(args.namespace, args.name)})",
          file=out)
    obs.render_waterfall(trace, out)
    if getattr(args, "chrome", ""):
        with open(args.chrome, "w") as f:
            f.write(json.dumps(obs.chrome_export(trace), indent=1))
        print(f"wrote merged Chrome trace to {args.chrome}", file=out)
    return 0 if trace else 1


def _trace_pod(vc: VolcanoClient, args, out) -> int:
    return _trace_identity(vc, args, out, gang=False)


def _trace_gang(vc: VolcanoClient, args, out) -> int:
    return _trace_identity(vc, args, out, gang=True)


# ---- top (federated /metrics aggregation) ----

#: the write-path ops whose latency the COMMIT column aggregates
_COMMIT_OPS = ("create", "commit_batch", "cas_bind", "txn_commit")


def _top_targets(vc: VolcanoClient, args) -> Dict[str, str]:
    """member label → host:port /metrics address.  Discovery is
    configuration-free: scheduler members advertise ``metricsAddr`` on
    the shard lease map's stats blob, apiservers advertise
    ``metrics_address`` on ``bus_status`` (every endpoint in the
    ``--bus`` list is asked).  ``--metrics a,b`` adds explicit extra
    targets."""
    targets: Dict[str, str] = {}
    try:
        rec = read_shard_map(vc.api)
    except ApiError:
        rec = None
    if rec:
        for ident in sorted(rec.get("stats") or {}):
            addr = (rec["stats"][ident] or {}).get("metricsAddr")
            if addr:
                targets[ident] = addr
    bus = getattr(args, "bus", "") or ""
    if bus:
        from volcano_tpu_torch.bus import BusError, connect_bus

        for i, url in enumerate(u.strip() for u in bus.split(",")):
            if not url:
                continue
            try:
                remote = connect_bus(url, wait=2.0)
                try:
                    st = remote.bus_status()
                finally:
                    remote.close()
            except (BusError, ApiError):
                continue
            addr = st.get("metrics_address")
            if addr:
                targets[f"apiserver-{i} [{st.get('role', '?')}]"] = addr
    else:
        st = vc.api.bus_status() if hasattr(vc.api, "bus_status") else {}
        addr = st.get("metrics_address")
        if addr:
            targets[f"apiserver [{st.get('role', '?')}]"] = addr
    for addr in (getattr(args, "metrics", "") or "").split(","):
        addr = addr.strip()
        if addr:
            targets.setdefault(addr, addr)
    return targets


def _max_burn(s) -> float:
    """Worst fast-window SLO burn rate in one scrape — max over the
    ``volcano_slo_burn{window="fast"}`` series (summing across SLOs
    would manufacture a breach out of several healthy ones)."""
    values = [
        v for (name, labels), v in s.series.items()
        if name == "volcano_slo_burn" and ("window", "fast") in labels
    ]
    return max(values) if values else 0.0


def _top(vc: VolcanoClient, args, out) -> int:
    """Aggregate /metrics across the whole membership (one row per
    member + a cluster TOTAL row); ``--watch N`` redraws every N
    seconds (``--count`` bounds the frames), ``--json`` emits the same
    numbers machine-readably."""
    watch = getattr(args, "watch", 0.0) or 0.0
    if watch <= 0:
        return _top_once(vc, args, out)
    count = getattr(args, "count", 0) or 0
    frames = 0
    rc = 0
    try:
        while True:
            rc = _top_once(vc, args, out)
            frames += 1
            if count and frames >= count:
                return rc
            time.sleep(watch)
            print("", file=out)
    except KeyboardInterrupt:
        return rc


def _top_once(vc: VolcanoClient, args, out) -> int:
    """One ``vtctl top`` frame: per-member rows + a cluster-wide TOTAL
    row.  With ``--interval S`` two scrapes bound a window and the
    counters/histograms become rates and windowed percentiles;
    otherwise the columns are process-lifetime cumulative."""
    targets = _top_targets(vc, args)
    if not targets:
        print("no scrape targets discovered — need a running federation "
              "(shard map with metricsAddr), a --bus endpoint list, or "
              "explicit --metrics host:port", file=out)
        return 1

    def scrape_all() -> Dict[str, object]:
        scrapes = {}
        for label, addr in targets.items():
            try:
                scrapes[label] = _scrape.parse_metrics(
                    _scrape.fetch_metrics(addr)
                )
            except OSError as e:
                print(f"  scrape of {label} ({addr}) failed: {e}", file=out)
        return scrapes

    first = scrape_all()
    interval = getattr(args, "interval", 0.0) or 0.0
    if interval > 0:
        time.sleep(interval)
        second = scrape_all()
        scrapes = {
            label: _scrape.delta(second[label], first[label])
            for label in second if label in first
        }
        window = f"{interval:g}s window"
    else:
        scrapes = first
        window = "cumulative"
    if not scrapes:
        print("every scrape failed", file=out)
        return 1

    def stats_for(s) -> dict:
        q = _scrape.histogram_quantile
        cycles = s.histogram("volcano_e2e_scheduling_latency_milliseconds")
        commit = _scrape.merge_histograms([h for h in (
            *(s.histogram("volcano_bus_request_latency_milliseconds",
                          method=op) for op in _COMMIT_OPS),
            *(s.histogram("volcano_bus_server_request_latency_milliseconds",
                          op=op) for op in _COMMIT_OPS),
        ) if h])
        return {
            "cycles": int((cycles or {}).get("count", 0)),
            "binds": int(s.value("volcano_pod_schedule_successes")),
            "s2bP99Ms": q(s.histogram(
                "volcano_submit_to_bind_latency_milliseconds"), 0.99),
            "commitP99Ms": q(commit, 0.99),
            "fsyncP99Ms": q(s.histogram(
                "volcano_wal_fsync_latency_milliseconds"), 0.99),
            "quorumP99Ms": q(s.histogram(
                "volcano_repl_quorum_wait_milliseconds"), 0.99),
            "dropped": int(s.value("volcano_telemetry_dropped_total")),
            "burn": _max_burn(s),
        }

    def row(label: str, st: dict) -> str:
        return (
            f"  {label:<30}"
            f"{st['cycles']:<8}"
            f"{st['binds']:<8}"
            f"{st['s2bP99Ms']:<9.1f}"
            f"{st['commitP99Ms']:<11.1f}"
            f"{st['fsyncP99Ms']:<10.1f}"
            f"{st['quorumP99Ms']:<11.1f}"
            f"{st['dropped']:<8}"
            f"{st['burn']:<6.2f}"
        )

    # cluster-wide: histograms merge pointwise, counters sum; the BURN
    # column takes the fleet max (a burn is a per-process judgement)
    total = _scrape.Scrape()
    for s in scrapes.values():
        for key, v in s.series.items():
            name = key[0]
            if name.endswith("_total") or name.endswith("_counts") or (
                "pod_schedule" in name
            ):
                total.series[key] = total.series.get(key, 0.0) + v
        for key, h in s.histograms.items():
            cur = total.histograms.get(key)
            total.histograms[key] = (
                _scrape.merge_histograms([cur, h]) if cur else h
            )
    member_stats = {label: stats_for(scrapes[label])
                    for label in sorted(scrapes)}
    cluster = stats_for(total)
    cluster["burn"] = max(
        [st["burn"] for st in member_stats.values()], default=0.0
    )
    if getattr(args, "json", False):
        report = {"window": window, "members": member_stats,
                  "cluster": cluster}
        if interval > 0:
            report["bindRatePerS"] = round(cluster["binds"] / interval, 3)
        print(json.dumps(report, indent=1, sort_keys=True), file=out)
        return 0
    print(f"Cluster metrics ({window}; {len(scrapes)} member(s)):",
          file=out)
    print(
        f"  {'MEMBER':<30}{'CYCLES':<8}{'BINDS':<8}{'S2B-99':<9}"
        f"{'COMMIT-99':<11}{'FSYNC-99':<10}{'QUORUM-99':<11}{'DROPPED':<8}"
        f"{'BURN':<6}",
        file=out,
    )
    for label, st in member_stats.items():
        print(row(label, st), file=out)
    print(row("CLUSTER", cluster), file=out)
    if interval > 0:
        print(f"  cluster bind rate: {cluster['binds'] / interval:.1f}/s",
              file=out)
    return 0


# ---- incidents (obs/incident.py) ----

def _select_incidents(vc: VolcanoClient, args):
    records = obs.list_incidents(vc.api)
    identity = getattr(args, "identity", "") or ""
    if identity:
        records = [r for r in records
                   if r["meta"].get("identity") == identity]
    return records


def _fmt_ts(ts: float) -> str:
    """Stored capture timestamp → fixed UTC rendering (derived from
    stored fields only — the byte-identity discipline)."""
    import datetime as _dt

    return _dt.datetime.fromtimestamp(ts, _dt.timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")


def _incidents_list(vc: VolcanoClient, args, out) -> int:
    records = _select_incidents(vc, args)
    if not records:
        print("no incident bundles published on this bus", file=out)
        return 0
    print(f"  {'#':<4}{'WHEN (UTC)':<22}{'IDENTITY':<24}{'TRIGGER':<28}"
          f"{'SPANS':<7}ALERTS", file=out)
    for i, rec in enumerate(records):
        meta = rec["meta"]
        alerts = ",".join(a.get("name", "?")
                          for a in meta.get("alerts") or []) or "-"
        print(
            f"  {i:<4}{_fmt_ts(meta.get('ts', 0.0)):<22}"
            f"{meta.get('identity', '?'):<24}"
            f"{meta.get('reason', '?'):<28}"
            f"{len(rec['spans']):<7}{alerts}",
            file=out,
        )
    return 0


def _incidents_show(vc: VolcanoClient, args, out) -> int:
    records = _select_incidents(vc, args)
    if not records:
        print("no matching incident bundle", file=out)
        return 1
    index = args.index if args.index is not None else len(records) - 1
    if not 0 <= index < len(records):
        print(f"error: index {index} out of range "
              f"(0..{len(records) - 1})", file=out)
        return 1
    rec = records[index]
    meta = dict(rec["meta"])
    print(f"incident {rec['object']}:", file=out)
    print(json.dumps(meta, indent=1, sort_keys=True), file=out)
    if rec["spans"]:
        print("", file=out)
        obs.render_waterfall(rec["spans"], out)
    return 0


def _incidents_collect(vc: VolcanoClient, args, out) -> int:
    """Pull every member's published incident summary into one local
    directory — the fleet-wide black-box retrieval."""
    records = _select_incidents(vc, args)
    if not records:
        print("no incident bundles published on this bus", file=out)
        return 0
    os.makedirs(args.out, exist_ok=True)
    for rec in records:
        path = os.path.join(args.out, f"{rec['object']}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1, sort_keys=True)
    print(f"collected {len(records)} incident summar"
          f"{'y' if len(records) == 1 else 'ies'} into {args.out}",
          file=out)
    return 0


def _incidents_capture(vc: VolcanoClient, args, out) -> int:
    """Operator-initiated capture: arm the cluster-wide boost, wait
    the settle window so boosted-fidelity spans land, write a bundle
    locally from whatever the bus holds."""
    from volcano_tpu_torch.obs.incident import IncidentManager, set_capture_boost

    identity = args.identity or "vtctl"
    try:
        boost = set_capture_boost(vc.api, identity, "manual",
                                  args.boost_ttl)
    except Exception as e:  # noqa: BLE001 — boostless capture still
        # beats no capture
        print(f"  capture-boost CAS failed ({e}); capturing unboosted",
              file=out)
        boost = None
    if args.settle > 0:
        time.sleep(args.settle)
    mgr = IncidentManager(
        vc.api, identity, args.dir,
        boost_ttl_s=args.boost_ttl, settle_s=0.0,
    )
    path = mgr.capture("manual", detail="vtctl incidents capture",
                       boost=boost)
    print(f"bundle: {path}", file=out)
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="vtctl", description="volcano-tpu control CLI")
    parser.add_argument(
        "--bus", default="",
        help="talk to a live vtpu-apiserver at tcp://host:port (the "
        "kubeconfig equivalent for the multi-process topology)",
    )
    sub = parser.add_subparsers(dest="group", required=True)

    trace_p = sub.add_parser(
        "trace", description="cycle journal: record, replay, diff, export; "
        "flight recorder: pod, gang"
    ).add_subparsers(dest="cmd", required=True)
    trace_cmd.add_commands(trace_p)

    for name in ("pod", "gang"):
        tp = trace_p.add_parser(
            name,
            description="flight recorder: render the cross-process "
            "submit→bind waterfall for one "
            + ("gang (PodGroup identity)" if name == "gang"
               else "pod identity")
            + " from the telemetry segments on the bus",
        )
        tp.add_argument("--name", "-N", required=True)
        tp.add_argument("--namespace", "-n", default="default")
        tp.add_argument(
            "--chrome", default="",
            help="also write the merged multi-process Chrome "
            "trace_event JSON here (real pid/tid rows)",
        )

    top = sub.add_parser(
        "top",
        description="aggregate /metrics across the whole membership "
        "(scheduler shards discovered from the shard lease map, "
        "apiservers from the --bus endpoint list): per-member and "
        "cluster-wide rates, commit/fsync/quorum latency columns",
    )
    top.set_defaults(cmd=None)
    top.add_argument(
        "--metrics", default="",
        help="extra host:port /metrics targets, comma-separated "
        "(for daemons outside the federation/replica discovery)",
    )
    top.add_argument(
        "--interval", type=float, default=0.0,
        help="seconds between two scrapes: columns become windowed "
        "rates/percentiles instead of process-lifetime cumulative",
    )
    top.add_argument(
        "--watch", type=float, default=0.0, metavar="N",
        help="redraw every N seconds until interrupted",
    )
    top.add_argument(
        "--count", type=int, default=0,
        help="with --watch: stop after this many frames (0 = forever)",
    )
    top.add_argument(
        "--json", action="store_true",
        help="emit the per-member and cluster stats as JSON",
    )

    inc = sub.add_parser(
        "incidents", aliases=["incident"],
        description="cluster incident bundles — the black box the SLO "
        "burn-rate watchdog (or an operator) captures at a breach: "
        "kept traces, metrics window, bus/shard state, capture-boost "
        "record (volcano_tpu_torch/obs/incident.py)",
    ).add_subparsers(dest="cmd", required=True)
    il = inc.add_parser(
        "list", description="every incident summary published on the "
        "bus, fleet-wide, oldest first",
    )
    il.add_argument("--identity", default="",
                    help="only bundles captured by this daemon identity")
    ish = inc.add_parser(
        "show", description="one incident's meta + the breach-window "
        "waterfall, from the stored summary",
    )
    ish.add_argument("--identity", default="")
    ish.add_argument("--index", type=int, default=None,
                     help="row from `incidents list` (default: latest)")
    ic = inc.add_parser(
        "collect", description="download every member's published "
        "incident summary into a local directory",
    )
    ic.add_argument("--identity", default="")
    ic.add_argument("--out", "-o", required=True,
                    help="destination directory")
    icap = inc.add_parser(
        "capture", description="operator-initiated capture: CAS the "
        "cluster-wide capture boost, wait --settle seconds for "
        "full-fidelity spans to land, write one bundle locally",
    )
    icap.add_argument("--dir", "-d", required=True,
                      help="bundle ring directory")
    icap.add_argument("--identity", default="",
                      help="identity stamped on the bundle "
                      "(default 'vtctl')")
    icap.add_argument("--settle", type=float, default=2.0,
                      help="seconds between boost and bundle write")
    icap.add_argument("--boost-ttl", type=float, default=30.0,
                      help="capture-boost TTL seconds")
    return parser


_HANDLERS = {
    ("top", None): _top,
    **{("trace", name): _journal for name in trace_cmd.COMMANDS},
    ("trace", "pod"): _trace_pod,
    ("trace", "gang"): _trace_gang,
    # the singular alias parses with group="incident"
    **{(group, cmd): handler
       for group in ("incidents", "incident")
       for cmd, handler in (("list", _incidents_list), ("show", _incidents_show),
                            ("collect", _incidents_collect),
                            ("capture", _incidents_capture))},
}


def main(argv: Optional[List[str]] = None, api: Optional[APIServer] = None, out=None) -> int:
    out = out if out is not None else sys.stdout
    args = build_parser().parse_args(argv)
    remote = None
    if api is None and getattr(args, "bus", ""):
        from volcano_tpu_torch.bus import BusError, connect_bus

        try:
            api = remote = connect_bus(args.bus, wait=10.0)
        except BusError as e:
            print(f"error: {e}", file=out)
            return 1
    if api is None:
        api = APIServer()  # empty standalone instance
    vc = VolcanoClient(api)
    handler = _HANDLERS[(args.group, args.cmd)]
    try:
        return handler(vc, args, out)
    except (ApiError, ValueError, OSError) as e:
        print(f"error: {e}", file=out)
        return 1
    except RuntimeError as e:
        # only for trace commands: RuntimeError there means a
        # supported-but-unavailable executor (replay on the card with no
        # card, native without the C++ toolchain) — a user error, not a
        # crash.  Elsewhere it's a genuine internal error whose
        # traceback must surface.
        if args.group == "trace":
            print(f"error: {e}", file=out)
            return 1
        raise
    finally:
        if remote is not None:
            remote.close()


if __name__ == "__main__":
    sys.exit(main())
