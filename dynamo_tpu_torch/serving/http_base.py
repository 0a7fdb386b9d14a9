"""HTTP plumbing for the worker API server: JSON responses, error
envelopes with a jittered Retry-After on shed codes, body reading, chunked
SSE framing and the fault-injection seams of the inference routes (port
of `dynamo_tpu/serving/http_base.py`)."""

from __future__ import annotations

import json
import logging
import random
import socket
import struct
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from dynamo_tpu_torch.robustness import faults
from dynamo_tpu_torch.serving import protocol as proto

log = logging.getLogger("dynamo_tpu_torch.http")

MAX_BODY_BYTES = 10 * 1024 * 1024

# every shed/routing-failure response carries a retry hint (429 admission,
# 502 failed failover, 503 no-worker/draining, 504 deadline)
RETRY_AFTER_CODES = (429, 502, 503, 504)


def retry_after_value(base_s: float = 1.0) -> str:
    """Retry-After with +-20% jitter: a burst of clients shed together
    must not come back in lockstep and re-create the overload."""
    return f"{base_s * (1.0 + random.uniform(-0.2, 0.2)):.2f}"


# inference routes are the fault-injectable surface; control-plane routes
# (/internal/*, /metrics, /health) stay reliable even mid-chaos-test
FAULTABLE_PATHS = ("/v1/", "/disagg/")


class JsonHTTPHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    sse_started: bool = False
    # class-level defaults mirror handle_one_request's per-request reset
    _fault_reset_after_headers: bool = False
    _fault_closed: bool = False

    def log_message(self, fmt, *args):
        log.debug("%s %s", self.address_string(), fmt % args)

    def handle_one_request(self):
        # keep-alive reuses the handler: reset per-request state
        self.sse_started = False
        self._fault_reset_after_headers = False
        self._fault_closed = False
        self._x_request_id = None
        super().handle_one_request()

    def _fault_gate(self):
        """Per-request fault hook of the inference routes, called at the
        top of do_POST: a read stall delays processing; reset-after-headers
        arms an abrupt close that end_headers() executes."""
        if not self.path.startswith(FAULTABLE_PATHS):
            return
        faults.sleep_point("worker.read_stall")
        if faults.check("worker.reset_after_headers") is not None:
            self._fault_reset_after_headers = True

    def _fault_abort_connection(self):
        """RST-close the client connection (SO_LINGER 0, so the peer sees
        a hard reset, not a clean FIN that could read as end-of-body)."""
        self._fault_closed = True
        self.close_connection = True
        try:
            self.wfile.flush()
            self.connection.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                       struct.pack("ii", 1, 0))
            self.connection.close()
        except (OSError, ValueError):
            pass

    def set_request_id(self, rid: str) -> None:
        """The id the response's X-Request-Id carries (a request's trace
        id when the client sent none); the first one set wins."""
        if not getattr(self, "_x_request_id", None):
            self._x_request_id = rid

    def end_headers(self):
        inbound = self.headers.get("x-request-id") if self.headers else None
        self.send_header("X-Request-Id",
                         (inbound or "").strip()
                         or getattr(self, "_x_request_id", None)
                         or uuid.uuid4().hex)
        super().end_headers()
        if self._fault_reset_after_headers:
            self._fault_reset_after_headers = False
            self._fault_abort_connection()

    def _json(self, code: int, obj: Dict[str, Any], headers=None):
        data = json.dumps(obj).encode()
        try:
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            if self._fault_closed:
                return
            self.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError, socket.error):
            self.close_connection = True  # the client hung up first

    def _error(self, code: int, msg: str,
               etype: str = "invalid_request_error",
               headers: Optional[Dict[str, str]] = None):
        headers = dict(headers or {})
        if code in RETRY_AFTER_CODES:
            # shed/overload responses carry a jittered retry hint
            headers.setdefault("Retry-After", retry_after_value())
        self._json(code, {"error": {"message": msg, "type": etype,
                                    "code": code}}, headers)

    def _raw(self, code: int, body: bytes, content_type: str):
        """A non-JSON body (the /metrics page, a trace zip)."""
        try:
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            if self._fault_closed:
                return
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError, socket.error):
            self.close_connection = True  # the client hung up first

    def _read_json_body(self) -> Dict[str, Any]:
        length = int(self.headers.get("Content-Length", 0))
        if length <= 0 or length > MAX_BODY_BYTES:
            raise proto.BadRequest("missing or oversized request body")
        try:
            return json.loads(self.rfile.read(length))
        except json.JSONDecodeError as e:
            raise proto.BadRequest(f"invalid JSON: {e}")

    def _start_sse(self):
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        self.sse_started = True

    def _write_chunk(self, payload: bytes) -> bool:
        if self._fault_closed:
            return False
        try:
            self.wfile.write(b"%x\r\n%s\r\n" % (len(payload), payload))
            self.wfile.flush()
            return True
        except (BrokenPipeError, ConnectionResetError, socket.error,
                ValueError):
            return False

    def _sse_chunk(self, obj) -> bool:
        payload = (f"data: {obj}\n\n".encode() if isinstance(obj, str)
                   else b"data: " + json.dumps(obj).encode() + b"\n\n")
        return self._write_chunk(payload)

    def _end_sse(self):
        if self._fault_closed:
            return
        try:
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, socket.error,
                ValueError):
            pass

    def _sse_error(self, msg: str):
        """Error after SSE headers went out: an error event, then [DONE]."""
        self._sse_chunk({"error": {"message": msg, "type": "stream_error"}})
        self._sse_chunk("[DONE]")
        self._end_sse()


def make_http_server(handler_cls, attrs: Dict[str, Any], host: str,
                     port: int) -> ThreadingHTTPServer:
    handler = type(f"Bound{handler_cls.__name__}", (handler_cls,), attrs)
    srv = ThreadingHTTPServer((host, port), handler)
    srv.daemon_threads = True
    return srv

