"""NATS request plane: frontend -> worker request transport.

The port's own copy of `dynamo_tpu/serving/nats_plane.py` (it imports nothing
of the JAX package); keep the two in step.

Mirrors the reference platform's frontend/worker NATS plane
(reference install-dynamo-1node.sh:241-242; arch diagram
README.md:330-335). Subjects:

- `dynamo.req.worker.<worker-token>` — per-worker subject: the frontend's
  KV-affinity router picks the worker, NATS carries the request (the routed
  path; worker-token = sanitized advertised URL).
- `dynamo.req.model.<model-token>` — queue-group subject shared by every
  worker serving that model: router-less load balancing, one worker per
  request (NATS queue semantics), used when the frontend has no routing
  preference.

Wire format: the request payload is the raw OpenAI-API JSON body plus
"_path" (/v1/chat/completions or /v1/completions). The worker bridges the
message into its local HTTP handler (one loopback hop keeps a single code
path for parsing/streaming/metrics) and streams the response back on the
reply inbox as JSON frames:
    {"ack": true}                               (immediately on receipt)
    {"head": true, "status": N, "ctype": ...}   (once, before any body)
    {"c": <b64 chunk>}                          (0..n body chunks)
    {"done": true}                              (exactly once, last)
The ack decouples responder detection (fast, head_timeout) from head
arrival (a slow NON-streaming generation only sends its head once the
body is complete — that must not trip the no-responder fallback and
re-run inference over HTTP).
SSE bodies stream frame-by-frame, so frontend TTFT passthrough works the
same as the HTTP plane.
"""

from __future__ import annotations

import base64
import json
import logging
import threading
import urllib.error
import urllib.request
from typing import Iterator, Optional, Tuple

from dynamo_tpu_torch.qos import tenancy as qos_tenancy
from dynamo_tpu_torch.robustness import deadline as ddl
from dynamo_tpu_torch.serving.nats import Msg, NatsClient, subject_token

log = logging.getLogger("dynamo_tpu_torch.nats_plane")

WORKER_SUBJECT_PREFIX = "dynamo.req.worker"
MODEL_SUBJECT_PREFIX = "dynamo.req.model"
QUEUE_GROUP = "workers"


def worker_subject(worker_url: str) -> str:
    return f"{WORKER_SUBJECT_PREFIX}.{subject_token(worker_url)}"


def model_subject(model: str) -> str:
    return f"{MODEL_SUBJECT_PREFIX}.{subject_token(model)}"


class WorkerNatsPlane:
    """Worker-side responder: serve requests arriving over NATS by bridging
    them into the worker's own HTTP server."""

    def __init__(self, nats_url: str, self_http_url: str, model: str,
                 advertised_url: Optional[str] = None):
        self.http_url = self_http_url.rstrip("/")
        self.nc = NatsClient(nats_url, name=f"worker-{subject_token(model)}")
        self.nc.subscribe(worker_subject(advertised_url or self_http_url),
                          self._on_request)
        self.nc.subscribe(model_subject(model), self._on_request,
                          queue_group=QUEUE_GROUP)
        log.info("NATS request plane up: %s + %s (queue=%s)",
                 worker_subject(advertised_url or self_http_url),
                 model_subject(model), QUEUE_GROUP)

    def _on_request(self, msg: Msg) -> None:
        if not msg.reply:
            return
        # handler threads: inference streams can run for minutes
        threading.Thread(target=self._serve, args=(msg,), daemon=True,
                         name="nats-req").start()

    def _serve(self, msg: Msg) -> None:
        reply = msg.reply
        try:
            self.nc.publish(reply, b'{"ack": true}')
            body = json.loads(msg.data)
            path = body.pop("_path", "/v1/chat/completions")
            headers = {"Content-Type": "application/json"}
            # trace context AND the deadline budget rode the NATS message
            # headers (HPUB) — bridge them onto the loopback HTTP hop so
            # the worker's request span joins the frontend's trace and its
            # deadline keeps counting down
            inbound = msg.parsed_headers()
            for h in ("traceparent", "x-request-id", ddl.DEADLINE_HEADER,
                      qos_tenancy.RESOLVED_HEADER):
                if inbound.get(h):
                    headers[h] = inbound[h]
            deadline = ddl.Deadline.from_headers(headers)
            req = urllib.request.Request(
                self.http_url + path,
                data=json.dumps(body).encode(),
                headers=headers,
                method="POST",
            )
            try:
                resp = urllib.request.urlopen(req,
                                              timeout=deadline.timeout())
                status = resp.status
            except urllib.error.HTTPError as e:
                resp, status = e, e.code
            ctype = resp.headers.get("Content-Type", "application/json")
            self.nc.publish(reply, json.dumps(
                {"head": True, "status": status, "ctype": ctype}
            ).encode())
            while True:
                chunk = (resp.read1(32768) if hasattr(resp, "read1")
                         else resp.read(32768))
                if not chunk:
                    break
                self.nc.publish(reply, json.dumps(
                    {"c": base64.b64encode(chunk).decode()}
                ).encode())
            self.nc.publish(reply, json.dumps({"done": True}).encode())
        except Exception as e:
            log.exception("nats request failed")
            err = json.dumps({"error": {"message": str(e),
                                        "type": "internal_error"}})
            try:
                self.nc.publish(reply, json.dumps(
                    {"head": True, "status": 500,
                     "ctype": "application/json"}).encode())
                self.nc.publish(reply, json.dumps(
                    {"c": base64.b64encode(err.encode()).decode()}).encode())
                self.nc.publish(reply, json.dumps({"done": True}).encode())
            except Exception:
                pass

    def close(self) -> None:
        self.nc.close()


def nats_request(
    nc: NatsClient, subject: str, path: str, body: dict,
    timeout: float = 600.0, head_timeout: float = 5.0,
    trace_headers: Optional[dict] = None,
) -> Tuple[int, str, Iterator[bytes]]:
    """Frontend-side call: returns (status, content_type, chunk iterator).

    The first reply frame resolves status/ctype... frames carry body chunks
    until the done frame; chunks observed before done are yielded in order
    (for SSE, each frame lands as soon as the worker emits it).

    `trace_headers` (traceparent / x-request-id) ride as NATS message
    headers (HPUB), NOT in the JSON body — the request payload stays the
    raw OpenAI body and the context survives the plane the same way it
    survives HTTP.
    """
    payload = dict(body)
    payload["_path"] = path
    frames = nc.request_stream(subject, json.dumps(payload).encode(),
                               timeout=timeout, first_timeout=head_timeout,
                               headers=trace_headers or None)
    head = json.loads(next(frames).data)
    if head.get("ack"):  # responder exists; the head may take a while
        head = json.loads(next(frames).data)
    if not head.get("head"):
        raise ConnectionError(f"nats plane protocol error: {head}")
    status = int(head.get("status", 200))
    ctype = head.get("ctype", "application/json")

    def body_chunks() -> Iterator[bytes]:
        for msg in frames:
            frame = json.loads(msg.data)
            if "c" in frame:
                yield base64.b64decode(frame["c"])
            elif frame.get("done"):
                return

    return status, ctype, body_chunks()
