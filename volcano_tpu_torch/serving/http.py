"""HTTP serving: /healthz + /metrics, and the forensics endpoints.

The port of ``volcano_tpu/serving/http.py``.  Reference: the scheduler
binary starts a Prometheus handler on --listen-address
(cmd/scheduler/app/server.go:96-99) and a healthz endpoint
(pkg/apis/helpers/helpers.go:195 StartHealthz).  One small threaded
server carries:

  GET /healthz     → 200 "ok" (liveness); 503 "unhealthy" when the
                     ``health_check`` says so; 200 "degraded: <reason>"
                     while the ``degraded_source`` names a reason: by
                     default an open circuit breaker (an executor's, or
                     the compute-plane sidecar's); a daemon with the SLO
                     watchdog adds ``slo-burn:<name>`` per breach
  GET /metrics     → Prometheus text exposition of metrics.registry
  GET /explain     → JSON "why is my job pending": unschedulable jobs,
                     their per-task fit-error messages and reason
                     histograms (serving/explain.py).  Narrow with
                     ?namespace=&job=
  GET /debug/stacks → live thread stacks
  GET /trace/last  → Chrome trace_event JSON of the last recorded
                     scheduling cycle (trace.get_recorder()); 404 until
                     a cycle has been recorded (is tracing enabled?)

The forensics endpoints (/explain, /debug/stacks, /trace/last) answer
loopback clients always and others only with ``debug_enabled``.
"""

from __future__ import annotations

import json
import sys
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlsplit

from volcano_tpu_torch import metrics, trace
from volcano_tpu_torch.faults.breaker import degraded_reasons
from volcano_tpu_torch.trace.export import chrome_trace


class _Handler(BaseHTTPRequestHandler):
    server_version = "volcano-tpu"

    def _deny_unless_debug(self) -> bool:
        """One gate for every forensics endpoint: answer an empty 404 and
        return True unless the client is loopback or debug serving is
        explicitly enabled."""
        if debug_allowed(
            getattr(self.server, "debug_enabled", False),
            self.client_address[0],
        ):
            return False
        self.send_response(404)
        self.send_header("Content-Length", "0")
        self.end_headers()
        return True

    def _text(self, code: int, body: bytes) -> None:
        self.send_response(code)
        self.send_header("Content-Type", "text/plain")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
        if self.path == "/healthz":
            check = getattr(self.server, "health_check", None)
            if check is not None and not check():
                self._text(503, b"unhealthy")
                return
            # degraded ≠ unhealthy: the daemon is alive and scheduling,
            # but a breaker is open (a kernel executor, an unreachable
            # compute-plane sidecar).  200 so liveness probes don't
            # restart a working pod; the body names the reason.
            reason = self.server.degraded_source()
            body = f"degraded: {reason}".encode() if reason else b"ok"
            ctype = "text/plain"
        elif self.path == "/metrics":
            body = metrics.registry.render().encode()
            ctype = "text/plain; version=0.0.4"
        elif self.path == "/trace/last":
            # scheduling forensics (task uids, node placements, evict
            # reasons) — same gate as /debug/stacks
            if self._deny_unless_debug():
                return
            record = trace.get_recorder().last_cycle()
            if record is None:
                self._text(404, b"no recorded cycle (is tracing enabled?)")
                return
            body = json.dumps(chrome_trace(record)).encode()
            ctype = "application/json"
        elif self.path == "/explain" or self.path.startswith("/explain?"):
            # unschedulability forensics (job/task names, node names,
            # failure reasons) — same gate as /debug/stacks
            if self._deny_unless_debug():
                return
            source = getattr(self.server, "explain_source", None)
            if source is None:
                self._text(404, b"no explain source (scheduler daemon only)")
                return
            query = parse_qs(urlsplit(self.path).query)
            data = source(
                query.get("namespace", [""])[0], query.get("job", [""])[0]
            )
            if data is None:
                self._text(404, b"job not found or nothing recorded")
                return
            body = json.dumps(data).encode()
            ctype = "application/json"
        elif self.path == "/debug/stacks":
            # the pprof-goroutine analogue: live thread stacks for hang
            # forensics.  Stack dumps leak internals, so off-loopback
            # clients need debug_enabled.
            if self._deny_unless_debug():
                return
            frames = sys._current_frames()
            parts = []
            for t in threading.enumerate():
                frame = frames.get(t.ident)
                parts.append(f"--- {t.name} (daemon={t.daemon}) ---")
                if frame is not None:
                    parts.append("".join(traceback.format_stack(frame)))
            body = "\n".join(parts).encode()
            ctype = "text/plain"
        else:
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # silence per-request stderr noise
        pass


def _degraded() -> Optional[str]:
    """/healthz's degraded reason: every open circuit breaker in the
    process (executor failures, unreachable compute-plane)."""
    reasons = degraded_reasons()
    return "; ".join(reasons) if reasons else None


def debug_allowed(debug_enabled: bool, client_ip: str) -> bool:
    """The forensics endpoints' policy: loopback always, anything else
    only with the explicit opt-in."""
    return debug_enabled or client_ip in ("127.0.0.1", "::1")


class ServingServer:
    """Threaded healthz+metrics server.  ``port=0`` binds an ephemeral
    port (read it back from ``.port`` after start)."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        health_check=None,
        debug_enabled: bool = False,
        explain_source=None,
        degraded_source=None,
    ):
        self._host = host
        self._port = port
        #: optional () -> bool; False turns /healthz into a 503
        self._health_check = health_check
        #: serve the forensics endpoints to non-loopback clients
        self._debug_enabled = debug_enabled
        #: optional (namespace, job) -> dict|None backing /explain — a
        #: scheduler wires serving/explain.explain_jobs here
        self._explain_source = explain_source
        #: optional () -> Optional[str]; a non-empty reason turns
        #: /healthz's 200 body into "degraded: <reason>".  None = the
        #: process-global breaker registry (``_degraded``)
        self._degraded_source = degraded_source if degraded_source is not None else _degraded
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        assert self._httpd is not None, "server not started"
        return self._httpd.server_address[1]

    @property
    def host(self) -> str:
        return self._host

    def start(self) -> "ServingServer":
        self._httpd = ThreadingHTTPServer((self._host, self._port), _Handler)
        self._httpd.health_check = self._health_check
        self._httpd.debug_enabled = self._debug_enabled
        self._httpd.explain_source = self._explain_source
        self._httpd.degraded_source = self._degraded_source
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="vtpu-serving", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
