"""Tracer/Span + ring-buffer collector, OTLP-JSON-shaped export.

Design constraints:
- stdlib only — no opentelemetry dependency; the export dicts are shaped
  like OTLP/JSON `ExportTraceServiceRequest` so a real collector can ingest
  them unchanged later;
- bounded memory — one process-global deque (default 2048 spans,
  `DYNAMO_TPU_TRACE_BUFFER` overrides) shared by every Tracer in the
  process; 10k traced requests grow the heap by zero;
- kill switch — `DYNAMO_TPU_TRACE=0` makes `start_span` return the no-op
  singleton before any allocation (checked per call, so tests and live
  operators can flip it without restarting).

One collector per PROCESS, one Tracer per service role: a test process
hosting frontend + prefill + decode servers sees the whole trace from any
server's /debug/spans; in a real deployment each pod naturally exposes its
own slice and the trace id joins them across scrapes.

The port's own copy of `dynamo_tpu/observability/tracing.py`
(it imports nothing of the JAX package); keep the two in step.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Union

from dynamo_tpu_torch.observability.context import TraceContext, new_span_id, new_trace_id

DEFAULT_BUFFER_SPANS = 2048

_KIND_CODES = {  # OTLP SpanKind enum values
    "internal": 1, "server": 2, "client": 3, "producer": 4, "consumer": 5,
}


def tracing_enabled() -> bool:
    return os.environ.get("DYNAMO_TPU_TRACE", "1").lower() not in (
        "0", "false", "off", "no")


# requests slower than this log a WARNING carrying their trace id — the
# exemplar-style bridge from the latency histograms to /debug/spans
SLOW_REQUEST_ENV = "DYNAMO_TPU_SLOW_REQUEST_S"
DEFAULT_SLOW_REQUEST_S = 10.0


def slow_request_threshold_s() -> float:
    try:
        return float(os.environ.get(SLOW_REQUEST_ENV,
                                    DEFAULT_SLOW_REQUEST_S))
    except ValueError:
        return DEFAULT_SLOW_REQUEST_S


def _otlp_value(v: Any) -> Dict[str, Any]:
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}  # OTLP/JSON encodes int64 as string
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


def _otlp_attrs(attrs: Dict[str, Any]) -> List[Dict[str, Any]]:
    return [{"key": k, "value": _otlp_value(v)} for k, v in attrs.items()]


class Span:
    """One timed operation. Context-manager friendly:

        with tracer.start_span("router.pick", parent=ctx) as span:
            span.set_attribute("worker.url", url)

    `end()` is idempotent; the span reaches the collector exactly once, at
    first end. Attribute/event mutation after end is dropped silently (a
    late background thread must not resurrect an exported span)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_span_id", "kind",
                 "service", "start_ns", "end_ns", "attributes", "events",
                 "status_code", "status_message", "_collector", "_ended")

    recording = True

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_span_id: Optional[str], kind: str, service: str,
                 collector: "SpanCollector", start_ns: Optional[int] = None,
                 attributes: Optional[Dict[str, Any]] = None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_span_id = parent_span_id
        self.kind = kind
        self.service = service
        self.start_ns = time.time_ns() if start_ns is None else start_ns
        self.end_ns: Optional[int] = None
        self.attributes: Dict[str, Any] = dict(attributes or {})
        self.events: List[Dict[str, Any]] = []
        self.status_code = "UNSET"
        self.status_message = ""
        self._collector = collector
        self._ended = False

    # ------------------------------------------------------------- mutation
    def set_attribute(self, key: str, value: Any) -> "Span":
        if not self._ended:
            self.attributes[key] = value
        return self

    def set_attributes(self, attrs: Dict[str, Any]) -> "Span":
        if not self._ended:
            self.attributes.update(attrs)
        return self

    def add_event(self, name: str,
                  attributes: Optional[Dict[str, Any]] = None) -> "Span":
        if not self._ended:
            self.events.append({"name": name, "time_ns": time.time_ns(),
                                "attributes": dict(attributes or {})})
        return self

    def set_status(self, code: str, message: str = "") -> "Span":
        if not self._ended:
            self.status_code = code  # "OK" | "ERROR" | "UNSET"
            self.status_message = message
        return self

    def end(self, end_ns: Optional[int] = None) -> None:
        if self._ended:
            return
        self._ended = True
        self.end_ns = time.time_ns() if end_ns is None else end_ns
        if self.end_ns < self.start_ns:  # clock nonsense must not export
            self.end_ns = self.start_ns  # a negative-duration span
        self._collector.add(self)

    # -------------------------------------------------------------- plumbing
    @property
    def context(self) -> TraceContext:
        return TraceContext(self.trace_id, self.span_id)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, _tb) -> None:
        if exc is not None and not self._ended:
            self.set_status("ERROR", f"{exc_type.__name__}: {exc}")
        self.end()

    def to_otlp(self) -> Dict[str, Any]:
        return {
            "traceId": self.trace_id,
            "spanId": self.span_id,
            "parentSpanId": self.parent_span_id or "",
            "name": self.name,
            "kind": _KIND_CODES.get(self.kind, 1),
            "startTimeUnixNano": str(self.start_ns),
            "endTimeUnixNano": str(self.end_ns or self.start_ns),
            "attributes": _otlp_attrs(self.attributes),
            "events": [
                {"name": e["name"], "timeUnixNano": str(e["time_ns"]),
                 "attributes": _otlp_attrs(e["attributes"])}
                for e in self.events
            ],
            "status": ({"code": 2, "message": self.status_message}
                       if self.status_code == "ERROR"
                       else {"code": 1 if self.status_code == "OK" else 0}),
        }


class _NoopSpan:
    """The kill-switch singleton: absorbs the whole Span surface without
    allocating. Its `context` is None — propagation falls back to whatever
    inbound context the caller already holds."""

    recording = False
    context: Optional[TraceContext] = None
    trace_id = ""
    span_id = ""

    def set_attribute(self, *_a, **_k):
        return self

    def set_attributes(self, *_a, **_k):
        return self

    def add_event(self, *_a, **_k):
        return self

    def set_status(self, *_a, **_k):
        return self

    def end(self, *_a, **_k):
        return None

    def __enter__(self):
        return self

    def __exit__(self, *_a):
        return None


NOOP_SPAN = _NoopSpan()


class SpanCollector:
    """Bounded in-memory span sink (a deque ring buffer: the newest
    `capacity` finished spans win; old traces age out instead of growing
    the heap)."""

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            try:
                capacity = int(os.environ.get("DYNAMO_TPU_TRACE_BUFFER",
                                              DEFAULT_BUFFER_SPANS))
            except ValueError:
                capacity = DEFAULT_BUFFER_SPANS
        self.capacity = max(1, capacity)
        self._spans: "collections.deque[Span]" = collections.deque(
            maxlen=self.capacity)
        # spans evicted by ring wrap-around — previously a SILENT loss; now
        # `dynamo_spans_dropped_total` on /metrics, so "exemplar link
        # resolves to nothing" is diagnosable as buffer churn
        self.dropped_total = 0
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    def add(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) == self.capacity:
                self.dropped_total += 1
            self._spans.append(span)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    def snapshot(self, trace_id: Optional[str] = None,
                 service: Optional[str] = None,
                 name_prefix: Optional[str] = None) -> List[Span]:
        with self._lock:
            spans = list(self._spans)
        if trace_id:
            spans = [s for s in spans if s.trace_id == trace_id]
        if service:
            spans = [s for s in spans if s.service == service]
        if name_prefix:
            spans = [s for s in spans if s.name.startswith(name_prefix)]
        return spans

    def export(self, trace_id: Optional[str] = None,
               service: Optional[str] = None,
               name_prefix: Optional[str] = None) -> Dict[str, Any]:
        """OTLP/JSON `ExportTraceServiceRequest` shape: spans grouped into
        one resourceSpans entry per service name."""
        by_service: Dict[str, List[Span]] = {}
        for s in self.snapshot(trace_id, service, name_prefix):
            by_service.setdefault(s.service, []).append(s)
        return {
            "resourceSpans": [
                {
                    "resource": {"attributes": _otlp_attrs(
                        {"service.name": svc})},
                    "scopeSpans": [{
                        "scope": {"name": "dynamo_tpu.observability"},
                        "spans": [s.to_otlp() for s in spans],
                    }],
                }
                for svc, spans in sorted(by_service.items())
            ]
        }

    def trace_ids(self, limit: int = 64) -> List[str]:
        """Most-recent-first distinct trace ids (the /debug/spans index)."""
        out: List[str] = []
        seen = set()
        for s in reversed(self.snapshot()):
            if s.trace_id not in seen:
                seen.add(s.trace_id)
                out.append(s.trace_id)
                if len(out) >= limit:
                    break
        return out


_GLOBAL_COLLECTOR = SpanCollector()


def get_collector() -> SpanCollector:
    return _GLOBAL_COLLECTOR


class Tracer:
    """Span factory for one service role (frontend / worker-decode / ...).
    All tracers in a process share the global collector unless given their
    own (tests isolate with an explicit SpanCollector)."""

    def __init__(self, service: str,
                 collector: Optional[SpanCollector] = None):
        self.service = service
        # explicit None check: an EMPTY collector is falsy (__len__ == 0)
        # and `or` would silently swap in the global one
        self.collector = (collector if collector is not None
                          else _GLOBAL_COLLECTOR)

    def start_span(
        self,
        name: str,
        parent: Union[TraceContext, Span, None] = None,
        kind: str = "internal",
        attributes: Optional[Dict[str, Any]] = None,
        trace_seed: Optional[str] = None,
        start_ns: Optional[int] = None,
    ) -> Union[Span, _NoopSpan]:
        """`parent` may be a TraceContext (remote parent), a Span (local
        parent), or None (new root; `trace_seed` makes the root trace id
        deterministic — derived from the request id)."""
        if not tracing_enabled():
            return NOOP_SPAN
        if isinstance(parent, _NoopSpan):
            parent = None  # a noop parent parents nothing: new root
        elif isinstance(parent, Span):
            parent = parent.context
        if parent is not None:
            trace_id, parent_span_id = parent.trace_id, parent.span_id
        else:
            trace_id, parent_span_id = new_trace_id(trace_seed), None
        return Span(name, trace_id, new_span_id(), parent_span_id, kind,
                    self.service, self.collector, start_ns=start_ns,
                    attributes=attributes)


def spans_debug_payload(qs: Dict[str, List[str]],
                        collector: Optional[SpanCollector] = None
                        ) -> Dict[str, Any]:
    """Shared `GET /debug/spans` body builder (frontend + worker servers):
    honors ?trace_id=, ?service= and ?name= (span-name prefix) filters and
    always carries the recent trace-id index so operators can discover
    what to filter by."""
    collector = collector if collector is not None else get_collector()
    trace_id = (qs.get("trace_id") or [None])[0]
    service = (qs.get("service") or [None])[0]
    name_prefix = (qs.get("name") or [None])[0]
    payload = collector.export(trace_id=trace_id, service=service,
                               name_prefix=name_prefix)
    payload["traceIds"] = collector.trace_ids()
    payload["enabled"] = tracing_enabled()
    payload["capacity"] = collector.capacity
    payload["droppedTotal"] = collector.dropped_total
    return payload


def iter_otlp_spans(payload: Dict[str, Any]) -> Iterable[Dict[str, Any]]:
    """Flatten an export payload back to span dicts (test/tooling helper)."""
    for rs in payload.get("resourceSpans", []):
        for ss in rs.get("scopeSpans", []):
            for sp in ss.get("spans", []):
                yield sp
