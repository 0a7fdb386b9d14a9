"""Operator-side debug/metrics HTTP server; the port's copy of
`dynamo_tpu/operator/debug_server.py` (keep the two in step).

The operator is not a serving process, but planner v2 gives it state
worth scraping: the coordinated pool targets, the bounded decision
journal, and the dynamo_planner_* metrics. This sidecar server (one
daemon thread, stdlib http.server) exposes:

- ``GET /debug/planner``  per-DGD pool targets + decision journal JSON
- ``GET /metrics``        dynamo_planner_{target_replicas,decisions_total,
                          forecast_rps,scrape_errors_total} in Prometheus
                          text format (serving/metrics.py Registry)
- ``GET /healthz``        liveness

Enabled by default on OPERATOR_DEBUG_PORT (8081); port 0 disables.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

log = logging.getLogger("dynamo_tpu_torch.operator")


class OperatorDebugServer:
    def __init__(self, controller, port: int = 8081,
                 host: str = "0.0.0.0"):
        ctrl = controller

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # noqa: N802 — quiet
                pass

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 — http.server contract
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/debug/planner":
                        body = json.dumps(
                            ctrl.planner_debug_payload()).encode()
                        self._send(200, body, "application/json")
                    elif path == "/metrics":
                        text, ctype = ctrl.registry.scrape(
                            self.headers.get("Accept"))
                        self._send(200, text, ctype)
                    elif path in ("/healthz", "/health", "/live"):
                        self._send(200, b'{"status":"ok"}',
                                   "application/json")
                    else:
                        self._send(404, b'{"error":"no route"}',
                                   "application/json")
                except Exception:  # noqa: BLE001 — debug must not crash
                    log.exception("debug server request failed")
                    self._send(500, b'{"error":"internal"}',
                               "application/json")

        self._srv = ThreadingHTTPServer((host, port), Handler)
        self._srv.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._srv.server_address[1]

    def start(self) -> "OperatorDebugServer":
        self._thread = threading.Thread(
            target=self._srv.serve_forever, daemon=True,
            name="operator-debug")
        self._thread.start()
        log.info("operator debug server on :%d "
                 "(/debug/planner, /metrics)", self.port)
        return self

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
