"""volcano_tpu_torch.obs — the cluster-wide flight recorder.

A copy of ``volcano_tpu/obs``, with the same wire, segment and record
formats, so a port daemon and a JAX one share one collector.  Pieces:

  * **spans** — cross-process span contexts ``(trace_id, span_id,
    parent_id)`` with trace ids derived from pod/gang identity,
    propagated over VBUS request payloads next to the cycle
    correlation field (spans.py); zero-cost when disabled.
  * **channel** — a drop-not-block telemetry export: bounded ring →
    batched segment objects on the bus, sampled by trace_id, so the
    apiserver's store and watch machinery is the collector and spans
    survive daemon death up to the last flush (channel.py), with
    tail-based retention (tail.py) and the cluster capture boost.
  * **collect** — assembly + rendering: the submit→bind waterfall
    across processes, merged multi-process Chrome export, and the
    per-stage attribution of pods' submit→bind paths (collect.py).
  * **slo** / **incident** — the burn-rate watchdog over the process's
    own metrics and the incident bundles it (or ``vtctl incidents
    capture``) writes.

Usage::

    from volcano_tpu_torch import obs

    obs.enable(api, identity="vtpu-scheduler-0")
    with obs.span("cycle", cat="scheduler"):
        ...
    # later, from any client of the same bus:
    spans = obs.collect_spans(api)
    obs.render_waterfall(obs.select_trace(spans, "default", "pod-1"), out)

Instrumented code calls :func:`span`/:func:`complete` unconditionally —
with the recorder off they cost one attribute read and return a shared
null context.
"""

from __future__ import annotations

from volcano_tpu_torch.obs.channel import (  # noqa: F401
    BOOST_KEY,
    BOOST_NAME,
    NAMESPACE,
    SEGMENT_KEY,
    SEGMENT_PREFIX,
    TAIL_KEY,
    TAIL_PREFIX,
    SpanExporter,
    disable,
    enable,
)
from volcano_tpu_torch.obs.collect import (  # noqa: F401
    apply_skew,
    build_tree,
    chrome_export,
    collect_spans,
    estimate_skew,
    related_identities,
    render_waterfall,
    select_trace,
    select_union,
    stage_breakdown,
)
from volcano_tpu_torch.obs.incident import (  # noqa: F401
    INCIDENT_KEY,
    INCIDENT_PREFIX,
    IncidentManager,
    list_incidents,
    set_capture_boost,
)
from volcano_tpu_torch.obs.slo import (  # noqa: F401
    DEFAULT_SLOS,
    Alert,
    BurnRateWatchdog,
    SLODef,
    resolve_slos,
)
from volcano_tpu_torch.obs.spans import (  # noqa: F401
    Span,
    adopt,
    complete,
    current,
    current_wire,
    enabled,
    get_exporter,
    span,
    suppressed,
    trace_id_for,
    trace_id_for_gang,
    trace_id_for_pod,
)

from volcano_tpu_torch.obs.tail import TailConfig, TailSampler  # noqa: F401

__all__ = [
    "Alert",
    "BOOST_KEY",
    "BOOST_NAME",
    "BurnRateWatchdog",
    "DEFAULT_SLOS",
    "INCIDENT_KEY",
    "INCIDENT_PREFIX",
    "IncidentManager",
    "NAMESPACE",
    "SEGMENT_KEY",
    "SEGMENT_PREFIX",
    "SLODef",
    "Span",
    "SpanExporter",
    "TAIL_KEY",
    "TAIL_PREFIX",
    "TailConfig",
    "TailSampler",
    "adopt",
    "apply_skew",
    "build_tree",
    "chrome_export",
    "collect_spans",
    "complete",
    "current",
    "related_identities",
    "select_union",
    "current_wire",
    "disable",
    "enable",
    "enabled",
    "estimate_skew",
    "get_exporter",
    "list_incidents",
    "render_waterfall",
    "resolve_slos",
    "select_trace",
    "set_capture_boost",
    "span",
    "stage_breakdown",
    "suppressed",
    "trace_id_for",
    "trace_id_for_gang",
    "trace_id_for_pod",
]
