"""Flight-recorder collection + rendering — the read side of the
telemetry channel.  A copy of ``volcano_tpu/obs/collect.py``: the same
selection, waterfall text and Chrome JSON for the same spans.

Spans are collected from the segment ConfigMaps every daemon's
:class:`~volcano_tpu_torch.obs.channel.SpanExporter` ships to the bus, so a
pod's waterfall is assembled *after the fact* from whatever the
cluster durably holds — including spans from daemons that have since
died.  All reads go through the API surface only, so ``vtctl trace
pod``/``gang`` render identically over the in-process backend and
``--bus`` (the ``vtctl shards`` discipline).

Selection is two-step: spans matching the pod/gang identity directly
(trace_id, or the ``gang``/``pod`` span args), then the **ancestor
closure** — every span reachable by following ``parent_id`` upward
through the full collected set, regardless of its own trace_id.  That
is what stitches a pod's ``bind:landed`` span to the commit-plane
flush that carried it, the bus op that shipped it and the scheduling
cycle that decided it.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional, TextIO

from volcano_tpu_torch.obs.channel import NAMESPACE, SEGMENT_KEY, SEGMENT_PREFIX
from volcano_tpu_torch.obs.spans import trace_id_for


def collect_spans(api, namespace: str = NAMESPACE) -> List[Dict[str, Any]]:
    """Every span durably held in the telemetry namespace, stamped with
    its segment's daemon identity and pid, sorted by start time."""
    out: List[Dict[str, Any]] = []
    for cm in api.list("ConfigMap", namespace):
        name = cm.metadata.name or ""
        if not name.startswith(SEGMENT_PREFIX):
            continue
        try:
            seg = json.loads((cm.data or {}).get(SEGMENT_KEY, ""))
        except (ValueError, AttributeError):
            continue
        daemon = seg.get("daemon", "")
        pid = seg.get("pid", 0)
        for s in seg.get("spans", []):
            s = dict(s)
            s.setdefault("daemon", daemon)
            s.setdefault("pid", pid)
            out.append(s)
    out.sort(key=lambda s: (s.get("ts", 0.0), s.get("s", "")))
    return out


def _matches(span: Dict[str, Any], trace_id: str, ident: str) -> bool:
    if span.get("t") == trace_id:
        return True
    args = span.get("args") or {}
    return ident in (args.get("pod"), args.get("gang"), args.get("job"))


def select_trace(
    spans: Iterable[Dict[str, Any]], namespace: str, name: str
) -> List[Dict[str, Any]]:
    """Spans belonging to one pod/gang identity, plus (a) the ancestor
    closure that parents them — cycles, bus ops, commit flushes — and (b) the
    *process-scope* descendants of those ancestors (kernel / pack /
    explain sub-spans of the cycle that placed this pod).  Spans keyed
    to OTHER pod/gang identities never leak in: the downward closure
    admits only trace_id == "" spans."""
    spans = list(spans)
    tid = trace_id_for(namespace, name)
    ident = f"{namespace}/{name}"
    by_id = {s.get("s"): s for s in spans}
    children: Dict[str, List[Dict[str, Any]]] = {}
    for s in spans:
        children.setdefault(s.get("p", ""), []).append(s)
    picked: Dict[str, Dict[str, Any]] = {}
    frontier = [s for s in spans if _matches(s, tid, ident)]
    while frontier:
        nxt = []
        for s in frontier:
            sid = s.get("s")
            if sid in picked:
                continue
            picked[sid] = s
            parent = by_id.get(s.get("p", ""))
            if parent is not None:
                nxt.append(parent)
        frontier = nxt
    # downward: process-scope sub-spans of anything already picked
    frontier = list(picked.values())
    while frontier:
        nxt = []
        for s in frontier:
            for c in children.get(s.get("s"), ()):
                cid = c.get("s")
                if cid in picked or c.get("t", ""):
                    continue
                picked[cid] = c
                nxt.append(c)
        frontier = nxt
    out = list(picked.values())
    out.sort(key=lambda s: (s.get("ts", 0.0), s.get("s", "")))
    return out


def select_union(
    spans: Iterable[Dict[str, Any]], identities: Iterable[tuple]
) -> List[Dict[str, Any]]:
    """Union of :func:`select_trace` over several (namespace, name)
    identities, deduplicated and time-ordered.  A pod's full story
    spans THREE identities — the pod itself, its PodGroup (gang), and
    its owning Job (the controller's status-writeback trace) — and the
    caller (vtctl) derives them from the store objects."""
    spans = list(spans)
    picked: Dict[str, Dict[str, Any]] = {}
    for namespace, name in identities:
        for s in select_trace(spans, namespace, name):
            picked[s.get("s")] = s
    out = list(picked.values())
    out.sort(key=lambda s: (s.get("ts", 0.0), s.get("s", "")))
    return out


def related_identities(api, namespace: str, name: str) -> List[tuple]:
    """The identities whose traces make up one pod/gang waterfall:
    the name itself, plus — when the store still holds the pod — its
    PodGroup (group annotation) and owning Job (job-name annotation /
    ownerReference).  Best-effort: a deleted pod degrades to the bare
    identity."""
    idents = [(namespace, name)]
    try:
        pod = api.get("Pod", namespace, name)
    except Exception:  # noqa: BLE001 — collection must not fail on reads
        pod = None
    if pod is not None:
        ann = pod.metadata.annotations or {}
        from volcano_tpu_torch.apis import scheduling as _sched

        group = ann.get(_sched.GROUP_NAME_ANNOTATION_KEY, "")
        if group and (namespace, group) not in idents:
            idents.append((namespace, group))
        for ref in pod.metadata.owner_references or ():
            if getattr(ref, "kind", "") == "Job" and ref.name:
                if (namespace, ref.name) not in idents:
                    idents.append((namespace, ref.name))
    return idents


def estimate_skew(
    spans: Iterable[Dict[str, Any]],
) -> Dict[tuple, float]:
    """Per-process clock-skew estimate, from the paired client/server
    ``bus:<op>`` spans bus/remote.py + bus/server.py emit for every
    traced rpc: same name, linked parent → child, recorded on two
    different processes' wall clocks.

    Assuming roughly symmetric network delay, the *midpoint* of the
    client span (send → reply on the client clock) and the midpoint of
    the server span (handling on the server clock) are the same
    instant, so their difference IS the relative clock offset — the
    classic NTP offset estimate, with the rpc as the probe.  Per
    process-pair the median over all pairs rejects asymmetric-delay
    outliers; offsets then propagate breadth-first from a
    deterministic anchor process (the one holding the earliest span),
    so chained hops (scheduler → apiserver → another client) re-anchor
    onto one clock.

    → {(daemon, pid): offset µs to ADD to that process's timestamps}.
    Empty when no cross-process pair exists (recorder off, single
    process, or pre-pair segments) — rendering is unchanged then.
    Deterministic over stored span fields only, so ``vtctl trace``
    output keeps its byte-identity discipline."""
    spans = list(spans)
    by_id = {s.get("s"): s for s in spans}
    edges: Dict[tuple, Dict[tuple, List[float]]] = {}
    for child in spans:
        parent = by_id.get(child.get("p", ""))
        if parent is None:
            continue
        if child.get("cat") != "bus" or parent.get("cat") != "bus":
            continue
        if child.get("name") != parent.get("name"):
            continue
        ckey = (parent.get("daemon", ""), parent.get("pid", 0))
        skey = (child.get("daemon", ""), child.get("pid", 0))
        if ckey == skey:
            continue
        off = (
            (parent.get("ts", 0.0) + parent.get("dur", 0.0) / 2)
            - (child.get("ts", 0.0) + child.get("dur", 0.0) / 2)
        )
        edges.setdefault(ckey, {}).setdefault(skey, []).append(off)
        edges.setdefault(skey, {}).setdefault(ckey, []).append(-off)
    if not edges:
        return {}
    anchor = None
    for s in sorted(spans, key=lambda s: (s.get("ts", 0.0), s.get("s", ""))):
        key = (s.get("daemon", ""), s.get("pid", 0))
        if key in edges:
            anchor = key
            break
    if anchor is None:
        return {}
    offsets: Dict[tuple, float] = {anchor: 0.0}
    frontier = [anchor]
    while frontier:
        nxt = []
        for node in frontier:
            for neigh in sorted(edges.get(node, {})):
                if neigh in offsets:
                    continue
                offs = sorted(edges[node][neigh])
                n = len(offs)
                median = (
                    offs[n // 2] if n % 2
                    else (offs[n // 2 - 1] + offs[n // 2]) / 2
                )
                offsets[neigh] = offsets[node] + median
                nxt.append(neigh)
        frontier = nxt
    return offsets


def apply_skew(
    spans: Iterable[Dict[str, Any]], offsets: Dict[tuple, float]
) -> List[Dict[str, Any]]:
    """Re-anchor every span's wall timestamp onto the anchor process's
    clock (durations are perf-measured and untouched)."""
    out = []
    for s in spans:
        off = offsets.get((s.get("daemon", ""), s.get("pid", 0)), 0.0)
        out.append(dict(s, ts=s.get("ts", 0.0) + off) if off else dict(s))
    out.sort(key=lambda s: (s.get("ts", 0.0), s.get("s", "")))
    return out


def build_tree(spans: List[Dict[str, Any]]):
    """→ (roots, children) with children keyed by span id, both in
    start-time order.  A span whose parent is not in the set is a
    root (its parent was sampled out, pruned, or never flushed)."""
    ids = {s.get("s") for s in spans}
    children: Dict[str, List[Dict[str, Any]]] = {}
    roots: List[Dict[str, Any]] = []
    for s in spans:
        p = s.get("p", "")
        if p and p in ids:
            children.setdefault(p, []).append(s)
        else:
            roots.append(s)
    return roots, children


def render_waterfall(
    spans: List[Dict[str, Any]], out: TextIO,
    clock0_us: Optional[float] = None,
    skew: Optional[Dict[tuple, float]] = None,
) -> None:
    """Text waterfall: one line per span, indented by tree depth, with
    offset from the earliest span and duration — the submit→bind
    decomposition at a glance.  Cross-process timestamps are
    re-anchored onto one clock via :func:`estimate_skew` (pass
    ``skew={}`` for raw wall clocks); when a correction was applied a
    header line reports the estimated per-process offsets."""
    if not spans:
        print("no spans recorded for this identity "
              "(is the flight recorder enabled? sampled out?)", file=out)
        return
    if skew is None:
        skew = estimate_skew(spans)
    corrections = {
        k: v for k, v in (skew or {}).items() if abs(v) >= 1.0
    }
    if corrections:
        spans = apply_skew(spans, skew)
        parts = "; ".join(
            f"{daemon or '?'}/{pid} {off / 1e3:+.2f}ms"
            for (daemon, pid), off in sorted(corrections.items())
        )
        print(f"clock skew corrected (paired bus-span RTT midpoints): "
              f"{parts}", file=out)
    roots, children = build_tree(spans)
    t0 = clock0_us if clock0_us is not None else min(
        s.get("ts", 0.0) for s in spans
    )
    print(f"{'OFFSET':>10} {'DURATION':>10}  {'DAEMON':<24} SPAN", file=out)

    def walk(s: Dict[str, Any], depth: int) -> None:
        off_ms = (s.get("ts", 0.0) - t0) / 1e3
        dur_ms = s.get("dur", 0.0) / 1e3
        label = s.get("name", "")
        args = s.get("args") or {}
        detail = " ".join(
            f"{k}={args[k]}" for k in sorted(args) if k not in ("pod",)
        )
        print(
            f"{off_ms:>9.2f}ms {dur_ms:>8.2f}ms  "
            f"{s.get('daemon', '') or '?':<24} "
            f"{'  ' * depth}{label}"
            + (f"  [{detail}]" if detail else ""),
            file=out,
        )
        for c in children.get(s.get("s"), []):
            walk(c, depth + 1)

    for r in roots:
        walk(r, 0)
    daemons = sorted({s.get("daemon", "") for s in spans if s.get("daemon")})
    pids = sorted({s.get("pid", 0) for s in spans})
    print(
        f"{len(spans)} span(s) across {len(daemons)} daemon(s) "
        f"/ {len(pids)} process(es): {', '.join(daemons)}",
        file=out,
    )


def chrome_export(spans: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Merged multi-process Chrome ``trace_event`` JSON: one pid row
    per (daemon, os pid) with real thread ids, all on the shared
    wall-clock origin — open in chrome://tracing / Perfetto."""
    if not spans:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    t0 = min(s.get("ts", 0.0) for s in spans)
    events: List[Dict[str, Any]] = []
    seen_pids: Dict[tuple, int] = {}
    for s in spans:
        key = (s.get("daemon", ""), s.get("pid", 0))
        pid = seen_pids.get(key)
        if pid is None:
            pid = s.get("pid", 0) or (len(seen_pids) + 1)
            # two daemons in one test process still get distinct rows
            while pid in seen_pids.values():
                pid += 1
            seen_pids[key] = pid
            events.append({
                "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": key[0] or f"pid {key[1]}"},
            })
        ev = {
            "name": s.get("name", ""),
            "cat": s.get("cat", "span"),
            "ph": "X",
            "ts": s.get("ts", 0.0) - t0,
            "dur": s.get("dur", 0.0),
            "pid": pid,
            "tid": s.get("tid", 1),
        }
        args = dict(s.get("args") or {})
        args["trace_id"] = s.get("t", "")
        args["span_id"] = s.get("s", "")
        if s.get("p"):
            args["parent_id"] = s["p"]
        ev["args"] = args
        events.append(ev)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {
            "clock_origin_us": t0,
            "processes": {str(v): f"{k[0]} (pid {k[1]})"
                          for k, v in seen_pids.items()},
        },
    }


def stage_breakdown(
    spans: List[Dict[str, Any]], pods: Iterable[tuple]
) -> Dict[str, Any]:
    """Attribute each pod's submit→bind path to named stages from its
    collected spans.  ``pods`` is an iterable of (namespace, name).  Per stage:
    count, mean_ms and p99_ms over the pods that exhibit it."""
    per_stage: Dict[str, List[float]] = {}
    covered = 0
    all_spans = list(spans)
    for namespace, name in pods:
        trace = select_trace(all_spans, namespace, name)
        if not trace:
            continue
        covered += 1
        for s in trace:
            per_stage.setdefault(s.get("name", "?"), []).append(
                s.get("dur", 0.0) / 1e3
            )
    stages = {}
    for stage, durs in sorted(per_stage.items()):
        durs.sort()
        stages[stage] = {
            "count": len(durs),
            "mean_ms": round(sum(durs) / len(durs), 3),
            "p99_ms": round(durs[min(len(durs) - 1,
                                     int(len(durs) * 0.99))], 3),
        }
    return {"pods_with_spans": covered, "stages": stages}
