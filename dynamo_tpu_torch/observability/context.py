"""W3C Trace Context: `traceparent` parse/format + ID generation.

The header format is the 4-field version-00 form
(https://www.w3.org/TR/trace-context/):

    traceparent: 00-<32 lowercase hex trace-id>-<16 hex parent-id>-<2 hex flags>

Only version 00 is emitted; any version byte other than `ff` is accepted
(the spec requires forward compatibility: a later version's first four
fields parse the same way, extra fields are ignored).

ID generation is deterministic when a seed is supplied: the same request id
maps to the same trace id on every hop, so a trace survives even a transport
that drops the header (the NATS fallback path, a misbehaving proxy) — the
worker re-derives the identical trace id from `x-request-id` and the spans
still join up in the collector.

The port's own copy of `dynamo_tpu/observability/context.py`
(it imports nothing of the JAX package); keep the two in step.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import re
from typing import Dict, Mapping, Optional

TRACEPARENT_HEADER = "traceparent"
REQUEST_ID_HEADER = "x-request-id"

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})(?:-.*)?$"
)


def new_trace_id(seed: Optional[str] = None) -> str:
    """32 lowercase hex chars; derived from `seed` when given (deterministic
    across processes), random otherwise. Never all-zero (invalid per spec)."""
    if seed:
        tid = hashlib.sha256(b"trace\x00" + seed.encode("utf-8", "replace")
                             ).hexdigest()[:32]
    else:
        tid = os.urandom(16).hex()
    return tid if tid != "0" * 32 else "1" * 32


def new_span_id(seed: Optional[str] = None) -> str:
    """16 lowercase hex chars; seeded variant for deterministic tests."""
    if seed:
        sid = hashlib.sha256(b"span\x00" + seed.encode("utf-8", "replace")
                             ).hexdigest()[:16]
    else:
        sid = os.urandom(8).hex()
    return sid if sid != "0" * 16 else "1" * 16


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """An extracted/minted trace position: the parent coordinates a new span
    attaches under."""

    trace_id: str
    span_id: str
    flags: int = 1  # sampled

    def to_traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-{self.flags:02x}"

    @staticmethod
    def new(seed: Optional[str] = None) -> "TraceContext":
        return TraceContext(new_trace_id(seed), new_span_id(seed))


def parse_traceparent(value: Optional[str]) -> Optional[TraceContext]:
    """Strict-enough parse: None on anything malformed (a bad inbound header
    must start a fresh trace, never corrupt ours)."""
    if not value:
        return None
    m = _TRACEPARENT_RE.match(value.strip().lower())
    if m is None:
        return None
    version, trace_id, span_id, flags = m.groups()
    if version == "ff":  # forbidden version value
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return TraceContext(trace_id, span_id, int(flags, 16))


def format_traceparent(ctx: TraceContext) -> str:
    return ctx.to_traceparent()


def extract_context(headers: Optional[Mapping],
                    request_id: Optional[str] = None) -> Optional[TraceContext]:
    """Pull a TraceContext out of HTTP-ish headers (any case-insensitive
    mapping with .get, e.g. http.client.HTTPMessage). Falls back to deriving
    a deterministic trace id from `x-request-id` (or the explicit
    `request_id`), so correlation survives header-stripping transports;
    returns None when there is nothing to join."""
    if headers is not None:
        ctx = parse_traceparent(headers.get(TRACEPARENT_HEADER))
        if ctx is not None:
            return ctx
        request_id = request_id or headers.get(REQUEST_ID_HEADER)
    if request_id:
        return TraceContext(new_trace_id(request_id),
                            new_span_id(request_id))
    return None


def inject_context(ctx: Optional[TraceContext], headers: Dict[str, str],
                   request_id: Optional[str] = None) -> Dict[str, str]:
    """Write traceparent (+ x-request-id when given) into a header dict;
    returns the dict for call-site chaining."""
    if ctx is not None:
        headers[TRACEPARENT_HEADER] = ctx.to_traceparent()
    if request_id:
        headers[REQUEST_ID_HEADER] = request_id
    return headers
