"""healthz/readyz probe endpoints (reference:
``AddHealthzCheck``/``AddReadyzCheck``, ``cmd/*/main.go:143-150``),
plus the operator-plane ``GET /v1/debug/events`` /
``GET /v1/debug/trace`` views of the process flight recorder
(obs/journal.py) and tracer (utils/trace.py) — the controller and node
agent have no serving HTTP plane, so their journal and spans are
queryable here (the fleet telemetry aggregator's collection point).

A copy of ``instaslice_tpu/utils/probes.py`` (the port imports nothing
of the JAX package).
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from instaslice_tpu_torch.obs.journal import debug_events_payload
from instaslice_tpu_torch.obs.profiler import debug_profile_payload
from instaslice_tpu_torch.utils.lockcheck import debug_locks_payload
from instaslice_tpu_torch.utils.trace import debug_trace_payload


class ProbeServer:
    """Serves ``/healthz`` (process alive) and ``/readyz`` (callback).

    :meth:`set_draining` forces ``/readyz`` to 503 regardless of the
    callback — the graceful-shutdown hook: a component that got SIGTERM
    flips readiness FIRST so the Service stops routing to it, finishes
    in-flight work, then exits (liveness stays green throughout; a
    draining process is degrading gracefully, not dead)."""

    def __init__(
        self,
        bind_address: str,
        ready_check: Optional[Callable[[], bool]] = None,
    ) -> None:
        host, _, port = bind_address.rpartition(":")
        self._ready = ready_check or (lambda: True)
        self._draining = False
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path.startswith("/v1/debug/"):
                    qs = urllib.parse.parse_qs(
                        urllib.parse.urlsplit(self.path).query
                    )
                    try:
                        if self.path.startswith("/v1/debug/trace"):
                            code, payload = 200, debug_trace_payload(qs)
                        elif self.path.startswith("/v1/debug/events"):
                            code, payload = 200, debug_events_payload(qs)
                        elif self.path.startswith("/v1/debug/profile"):
                            code = 200
                            payload = debug_profile_payload(qs)
                        elif self.path.startswith("/v1/debug/locks"):
                            code, payload = 200, debug_locks_payload(qs)
                        else:
                            code = 404
                            payload = {"error": f"no route {self.path}"}
                    except ValueError as e:
                        code, payload = 400, {"error": str(e)}
                    except LookupError as e:
                        code, payload = 404, {"error": str(e)}
                    body = json.dumps(payload).encode()
                    self.send_response(code)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if self.path.startswith("/healthz"):
                    ok = True
                elif self.path.startswith("/readyz"):
                    ok = not outer._draining and outer._ready()
                else:
                    self.send_error(404)
                    return
                body = (b"ok" if ok
                        else b"draining" if outer._draining
                        else b"not ready")
                self.send_response(200 if ok else 503)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._srv = ThreadingHTTPServer(
            (host or "0.0.0.0", int(port)), Handler
        )
        self._thread = threading.Thread(
            target=self._srv.serve_forever, name="probes", daemon=True
        )

    @property
    def port(self) -> int:
        return self._srv.server_address[1]

    def set_draining(self, draining: bool = True) -> None:
        """Force ``/readyz`` to 503 (back to the callback with False)."""
        self._draining = draining

    def start(self) -> "ProbeServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        self._thread.join(timeout=5)
