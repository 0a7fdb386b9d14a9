"""Distributed request tracing, stdlib-only.

One request crosses four processes in the disaggregated topology —
frontend -> router decision -> decode worker -> prefill worker — and the
latency pathologies live in the hops, not the processes. This package
carries a W3C `traceparent` context across both transports (HTTP headers
and NATS message headers), records spans into a bounded in-process ring
buffer, and exports them OTLP-JSON-shaped at `GET /debug/spans` so an
external collector (or a test) can reassemble the trace.

- `context`  — traceparent parse/format + trace/span ID generation.
- `tracing`  — Tracer/Span + the ring-buffer SpanCollector and OTLP-dict
               export (no OTLP dependency; the shapes match
               `ExportTraceServiceRequest` so a collector can ingest them).

Kill switch: `DYNAMO_TPU_TRACE=0` short-circuits span creation to a no-op
singleton (context propagation still works, so downstream services keep
their correlation ids).

The port's own copy of `dynamo_tpu/observability/__init__.py`
(it imports nothing of the JAX package); keep the two in step.
"""

from dynamo_tpu_torch.observability.context import (  # noqa: F401
    TraceContext,
    extract_context,
    format_traceparent,
    inject_context,
    new_span_id,
    new_trace_id,
    parse_traceparent,
)
from dynamo_tpu_torch.observability.tracing import (  # noqa: F401
    NOOP_SPAN,
    Span,
    SpanCollector,
    Tracer,
    get_collector,
    tracing_enabled,
)
