"""Incident bundles — the cluster's black box, written at the breach.

A copy of ``volcano_tpu/obs/incident.py``; the shard map comes from
:mod:`volcano_tpu_torch.obs.shard_map` and the journal tail from the
port's :class:`volcano_tpu_torch.trace.Journal`.

When the burn-rate watchdog (obs/slo.py) edge-triggers a breach — or a
human runs ``vtctl incidents capture`` — two things must happen fast:

1. **capture boost**: a TTL-bounded cluster-wide record
   (``vtpu-capture-boost`` in the telemetry namespace) is CAS'd so
   every daemon's exporter raises its effective sample rate to 1.0;
   the fleet converges within one flusher poll (~1 s, inside one lease
   heartbeat — the record is also echoed on the lease-heartbeat stats
   blob the autoscaler already reads, so ``vtctl shards`` shows who is
   boosting and why).  CAS discipline: an existing record with a later
   expiry is never shortened, and re-triggers inside the window only
   extend — concurrent breaches cannot storm the object.
2. **bundle**: after a short settle delay (so the boost window's
   full-fidelity spans exist to be collected), one bounded on-disk
   bundle is written **atomically** (assembled under a dot-tmp name,
   ``os.rename``'d into place) holding the evidence an operator needs
   after the fact: recent kept traces, the metrics time-series window
   leading into the breach, ``bus_status``, the shard map + sketches
   blob, the explain digest, and the last trace-journal cycles.  The
   bundle directory is a ring: the oldest beyond ``ring`` bundles is
   pruned.

A bounded summary (meta + the breach-window spans) is also published
as ``vtpu-incident-<identity>-<slot>`` objects so ``vtctl incidents
list|show|collect`` render fleet-wide over the bus with the ``vtctl
shards`` byte-identity discipline: stored fields only, no call-time
clocks.

Per-trigger cooldown makes "exactly one bundle per breach episode"
hold even if the watchdog re-fires: re-triggers inside ``cooldown_s``
only re-arm the boost.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Callable, Dict, List, Optional

from volcano_tpu_torch import metrics
from volcano_tpu_torch.obs import spans as _spans
from volcano_tpu_torch.obs.channel import BOOST_KEY, BOOST_NAME, NAMESPACE
from volcano_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

INCIDENT_PREFIX = "vtpu-incident-"
INCIDENT_KEY = "incident.volcano.tpu/bundle"
#: spans carried in the published summary (bounded — the full set is
#: in the on-disk bundle and in the segment objects themselves)
SUMMARY_SPAN_CAP = 512


def set_capture_boost(api, identity: str, reason: str,
                      ttl_s: float, now: Optional[float] = None) -> dict:
    """CAS the cluster boost record: create it, or extend it if ours
    would expire later — never shorten a live boost.  Returns the
    record that ended up (or already was) in force."""
    from volcano_tpu_torch.apis import core
    from volcano_tpu_torch.client.apiserver import AlreadyExistsError

    ts = time.time() if now is None else now
    desired = {
        "until": ts + ttl_s,
        "by": identity,
        "reason": reason,
        "ts": ts,
    }
    payload = json.dumps(desired, separators=(",", ":"))
    with _spans.suppressed():
        try:
            api.create(core.ConfigMap(
                metadata=core.ObjectMeta(name=BOOST_NAME,
                                         namespace=NAMESPACE),
                data={BOOST_KEY: payload},
            ))
            return desired
        except AlreadyExistsError:
            cm = api.get("ConfigMap", NAMESPACE, BOOST_NAME)
            if cm is None:
                return desired
            try:
                existing = json.loads((cm.data or {}).get(BOOST_KEY, ""))
            except ValueError:
                existing = {}
            if float(existing.get("until", 0.0)) >= desired["until"]:
                return existing  # a later boost already covers us
            cm.data = {BOOST_KEY: payload}
            api.update(cm)
            return desired


class IncidentManager:
    """Bounded on-disk incident-bundle ring + cluster boost CAS for
    one daemon."""

    def __init__(
        self,
        api,
        identity: str,
        directory: str,
        ring: int = 8,
        cooldown_s: float = 60.0,
        boost_ttl_s: float = 30.0,
        settle_s: Optional[float] = None,
        metrics_ring=None,
        journal_dir: str = "",
        explain_source: Optional[Callable[[], object]] = None,
        slots: int = 4,
    ):
        self.api = api
        self.identity = identity
        self.directory = directory
        self.ring = max(1, ring)
        self.cooldown_s = cooldown_s
        self.boost_ttl_s = boost_ttl_s
        #: bundle write waits for the boost window's full-fidelity
        #: spans to exist; still lands well inside the boost TTL
        self.settle_s = (
            min(5.0, boost_ttl_s * 0.5) if settle_s is None else settle_s
        )
        self.metrics_ring = metrics_ring
        self.journal_dir = journal_dir
        self.explain_source = explain_source
        self.slots = max(1, slots)
        self._lock = threading.Lock()
        with self._lock:
            #: trigger → last capture wall-ts (the per-episode cooldown)
            self._last: Dict[str, float] = {}  # guarded-by: self._lock
            self._seq = 0  # guarded-by: self._lock
            self.captured = 0  # guarded-by: self._lock
            self.suppressed_triggers = 0  # guarded-by: self._lock

    # ---- the watchdog/breaker/manual entry point ----

    def trigger(self, trigger: str, detail: str = "",
                alerts: Optional[List[dict]] = None,
                sync: bool = False) -> Optional[threading.Thread]:
        """Breach entry point: arm the boost immediately; write the
        bundle after the settle delay (on a background thread unless
        ``sync``).  Cooldown-gated per trigger — one bundle per breach
        episode, re-triggers only re-arm the boost."""
        now = time.time()
        with self._lock:
            cooled = now - self._last.get(trigger, -1e18) < self.cooldown_s
            if not cooled:
                self._last[trigger] = now
            else:
                self.suppressed_triggers += 1
        try:
            boost = set_capture_boost(
                self.api, self.identity, trigger, self.boost_ttl_s, now=now)
        except Exception as e:  # noqa: BLE001 — a bus outage costs the
            # fleet boost, never the local bundle
            log.debug("capture-boost CAS failed: %s", e)
            boost = {"until": now + self.boost_ttl_s, "by": self.identity,
                     "reason": trigger, "ts": now}
        from volcano_tpu_torch import obs

        exporter = obs.get_exporter()
        if exporter is not None:
            exporter.set_boost(boost)
        if cooled:
            return None

        def _finalize():
            if self.settle_s > 0:
                time.sleep(self.settle_s)
            try:
                self.capture(trigger, detail=detail, alerts=alerts,
                             boost=boost)
            except Exception as e:  # noqa: BLE001 — capture failures
                # are logged, never raised into the watchdog
                log.error("incident capture (%s) failed: %s", trigger, e)

        if sync or self.settle_s <= 0:
            _finalize()
            return None
        t = threading.Thread(target=_finalize, daemon=True,
                             name=f"vtpu-incident-{self.identity}")
        t.start()
        return t

    def on_alert(self, alert) -> None:
        """The watchdog's ``on_breach`` hook."""
        self.trigger(f"slo-burn:{alert.name}",
                     detail=alert.to_dict().__repr__(),
                     alerts=[alert.to_dict()])

    # ---- bundle assembly ----

    def capture(self, trigger: str, detail: str = "",
                alerts: Optional[List[dict]] = None,
                boost: Optional[dict] = None) -> str:
        """Assemble + atomically write one bundle; publish the bounded
        summary object; returns the bundle directory path."""
        from volcano_tpu_torch import obs

        now = time.time()
        with self._lock:
            seq = self._seq
            self._seq += 1
        slug = trigger.replace("/", "-").replace(":", "-")
        name = f"incident-{int(now * 1000):013d}-{slug}"
        errors: Dict[str, str] = {}
        files: Dict[str, str] = {}

        def part(fname: str, build) -> None:
            try:
                files[fname] = build()
            except Exception as e:  # noqa: BLE001 — every part is
                # best-effort; the bundle records what it could not get
                errors[fname] = str(e)

        with _spans.suppressed():
            spans: List[dict] = []
            part("spans.json", lambda: json.dumps(
                spans.extend(obs.collect_spans(self.api)) or spans,
                separators=(",", ":")))
            part("bus_status.json", lambda: json.dumps(
                self.api.bus_status() if hasattr(self.api, "bus_status")
                else {"role": "standalone", "persistent": False},
                separators=(",", ":"), sort_keys=True))
            part("shard_map.json", lambda: json.dumps(
                self._shard_map(), separators=(",", ":"), sort_keys=True))
        if self.metrics_ring is not None:
            part("metrics.jsonl", lambda: "\n".join(
                json.dumps({"ts": ts, "text": text},
                           separators=(",", ":"))
                for ts, text in self.metrics_ring.dump()))
        if self.explain_source is not None:
            part("explain.json", lambda: json.dumps(
                self.explain_source(), separators=(",", ":"), default=str))
        if self.journal_dir:
            part("journal.json", lambda: json.dumps(
                self._journal_tail(), separators=(",", ":")))
        meta = {
            "reason": trigger,
            "detail": detail,
            "identity": self.identity,
            "ts": now,
            "boost": boost,
            "alerts": alerts or [],
            "files": sorted(files) + ["meta.json"],
            "errors": errors,
            "spanCount": len(spans),
        }
        files["meta.json"] = json.dumps(meta, indent=1, sort_keys=True)
        path = self._atomic_write(name, files)
        self._prune()
        self._publish(seq, meta, spans)
        with self._lock:
            self.captured += 1
        metrics.register_incident_captured(trigger)
        log.info("incident bundle %s written (%s)", path, trigger)
        return path

    def _shard_map(self) -> Optional[dict]:
        from volcano_tpu_torch.obs.shard_map import read_shard_map

        return read_shard_map(self.api)

    def _journal_tail(self, keep: int = 3) -> List[dict]:
        from volcano_tpu_torch import trace as _trace

        journal = _trace.Journal(self.journal_dir)
        cycles = journal.cycles()[-keep:]
        return [journal.read_cycle(c) for c in cycles]

    def _atomic_write(self, name: str, files: Dict[str, str]) -> str:
        os.makedirs(self.directory, exist_ok=True)
        tmp = os.path.join(self.directory, f".tmp-{name}")
        final = os.path.join(self.directory, name)
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for fname, text in files.items():
            with open(os.path.join(tmp, fname), "w") as f:
                f.write(text)
        os.rename(tmp, final)
        return final

    def _prune(self) -> None:
        try:
            bundles = sorted(
                d for d in os.listdir(self.directory)
                if d.startswith("incident-")
            )
        except OSError:
            return
        for stale in bundles[:-self.ring]:
            shutil.rmtree(os.path.join(self.directory, stale),
                          ignore_errors=True)

    def _publish(self, seq: int, meta: dict, spans: List[dict]) -> None:
        """The fleet-readable summary: meta + the breach-window spans,
        bounded, in a per-daemon slot ring."""
        window_lo = (meta["ts"] - 120.0) * 1e6
        recent = [s for s in spans if s.get("ts", 0.0) >= window_lo]
        recent = recent[-SUMMARY_SPAN_CAP:]
        payload = json.dumps(
            {"meta": meta, "spans": recent}, separators=(",", ":"))
        slot = seq % self.slots
        cm_name = f"{INCIDENT_PREFIX}{self.identity}-{slot:02d}"
        try:
            with _spans.suppressed():
                self._write_cm(cm_name, payload)
        except Exception as e:  # noqa: BLE001 — the on-disk bundle is
            # the source of truth; the summary is best-effort
            log.debug("incident summary publish failed: %s", e)

    def _write_cm(self, name: str, payload: str) -> None:
        from volcano_tpu_torch.apis import core
        from volcano_tpu_torch.client.apiserver import AlreadyExistsError

        data = {INCIDENT_KEY: payload}
        try:
            self.api.create(core.ConfigMap(
                metadata=core.ObjectMeta(name=name, namespace=NAMESPACE),
                data=data,
            ))
        except AlreadyExistsError:
            cm = self.api.get("ConfigMap", NAMESPACE, name)
            if cm is None:
                raise
            cm.data = data
            self.api.update(cm)


def list_incidents(api) -> List[dict]:
    """Every published incident summary on the bus, oldest-first by
    stored capture timestamp (stored fields only — the byte-identity
    discipline)."""
    out = []
    for cm in api.list("ConfigMap", NAMESPACE):
        name = cm.metadata.name or ""
        if not name.startswith(INCIDENT_PREFIX):
            continue
        try:
            rec = json.loads((cm.data or {}).get(INCIDENT_KEY, ""))
        except (ValueError, AttributeError):
            continue
        meta = rec.get("meta") or {}
        out.append({
            "object": name,
            "meta": meta,
            "spans": rec.get("spans") or [],
        })
    out.sort(key=lambda r: (r["meta"].get("ts", 0.0), r["object"]))
    return out
