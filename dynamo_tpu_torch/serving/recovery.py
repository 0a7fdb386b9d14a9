"""Mid-stream request recovery: the token journal + SSE relay plumbing
(the port's own copy of `dynamo_tpu/serving/recovery.py`; keep the two in
step: the frontend and the workers speak this wire format).

Failover was first bounded at the CONNECT phase: once a worker started
generating, a crash mid-decode killed the client's stream, because a
naive retry would duplicate tokens. This module makes in-flight requests
recoverable state (docs/robustness.md "Recovery semantics"):

- the WORKER, when the frontend asks for journaling (``x-recovery-journal``
  header), interleaves SSE *comment* frames (``: dynr {...}``) with the
  data stream: a ``start`` record (response id + effective sampling seed)
  and, immediately BEFORE each content delta, a checkpoint carrying the
  token ids the delta covers and the cumulative content-char count;
- the FRONTEND parses the stream instead of blindly proxying bytes
  (``iter_sse_blocks``): comments feed a per-request ``RequestJournal``
  and are stripped, data frames are re-framed to the client verbatim;
- on a mid-stream failure (reset-after-headers, read stall timeout,
  crash-mid-decode's in-stream error event, EOF without ``[DONE]``) the
  frontend re-picks a healthy worker and re-POSTs the original body plus
  a ``dynamo_recovery`` extension: the journaled tokens become a
  continuation prefill (prompt ⊕ emitted tokens), sampling resumes from
  the journaled seed / PRNG-key snapshot (position-folded chains — the
  same guarantee preemption-by-recompute relies on), and the worker
  re-emits exactly the chars past ``delivered_chars`` so the seam is
  duplicate- and gap-free.

Checkpoint-before-data ordering is the exactly-once seam invariant: the
journal can only run AHEAD of delivery (``delivered_chars <= c``), never
behind, so replaying the journaled tokens always covers everything the
client saw and the skip count is exact.

Journaling is per-request opt-in by the frontend and restricted to the
shapes recovery can actually splice: streaming, single-choice (n == 1),
no tool-call gating. Everything else keeps the truncate semantics.
Kill switch: ``DYNAMO_TPU_RECOVERY=0``.

The port's sampling noise is counter-based and keyed by a 63-bit chain
root (`engine/sampling.py`), not a threefry key: its ``resume_key`` is that
root as two uint32 values [high, low] (`Engine.export_sampling_state`),
which passes the same two-uint32 check below.

Speculative decoding composes for free: checkpoints ride TokenEvents,
which the engine emits only for ACCEPTED tokens — a journal never names
a token the target chain hasn't confirmed, and a continuation restoring
the PRNG-key snapshot resumes the identical position-folded chain even
when the crash landed mid-verify-window (docs/perf.md "Speculative
decoding v2"; tests/test_speculative.py recovery-mid-speculation).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Optional, Tuple

# frontend -> worker: "journal this stream" opt-in header
JOURNAL_HEADER = "x-recovery-journal"
# body extension key carrying the continuation state on a re-dispatch
RECOVERY_BODY_KEY = "dynamo_recovery"
# SSE comment tag; SSE-compliant clients ignore comment lines, and the
# frontend relay strips them anyway
COMMENT_TAG = b": dynr "
ENV_DISABLE = "DYNAMO_TPU_RECOVERY"
# total dispatch attempts per request (initial + recoveries), matching the
# connect-phase failover bound
MAX_ATTEMPTS = 3
# prior-token cap on inbound continuations (anything longer than the
# engine's longest context is garbage by construction)
MAX_PRIOR_TOKENS = 131072


def enabled() -> bool:
    return os.environ.get(ENV_DISABLE, "1") != "0"


def journal_eligible(body: Dict) -> bool:
    """Can this request's stream be journaled and spliced? Streaming,
    single choice, no tool-call stream gating (the gate holds text back,
    so delivered chars would not be a pure function of the token ids)."""
    return (enabled()
            and isinstance(body, dict)
            and bool(body.get("stream"))
            and body.get("n", 1) == 1
            and not body.get("tools"))


def comment_frame(obj: Dict) -> bytes:
    """One journal record as an SSE comment block (worker side)."""
    return COMMENT_TAG + json.dumps(obj, separators=(",", ":")).encode() \
        + b"\n\n"


def normalize_continuation(rec) -> Dict:
    """Validate an inbound ``dynamo_recovery`` body extension (worker
    side). Raises ValueError on garbage — mapped to HTTP 400 upstream."""
    if not isinstance(rec, dict):
        raise ValueError("'dynamo_recovery' must be an object")
    toks = rec.get("prior_tokens") or []
    if (not isinstance(toks, list) or len(toks) > MAX_PRIOR_TOKENS
            or not all(isinstance(t, int) and not isinstance(t, bool)
                       and t >= 0 for t in toks)):
        raise ValueError("'prior_tokens' must be non-negative token ids")
    delivered = rec.get("delivered_chars", 0)
    if isinstance(delivered, bool) or not isinstance(delivered, int) \
            or delivered < 0:
        raise ValueError("'delivered_chars' must be a non-negative integer")
    seed = rec.get("seed")
    if seed is not None and (isinstance(seed, bool)
                             or not isinstance(seed, int)):
        raise ValueError("'seed' must be an integer")
    key = rec.get("resume_key")
    if key is not None and (
            not isinstance(key, list) or len(key) != 2
            or not all(isinstance(k, int) and not isinstance(k, bool)
                       and k >= 0 for k in key)):
        raise ValueError("'resume_key' must be two uint32 values")
    rid = rec.get("response_id")
    if rid is not None and (not isinstance(rid, str) or len(rid) > 80
                            or not rid.isprintable()):
        raise ValueError("'response_id' must be a short printable string")
    return {
        "prior_tokens": [int(t) for t in toks],
        "delivered_chars": int(delivered),
        "seed": seed,
        "resume_key": None if key is None else [int(k) for k in key],
        "response_id": rid,
        "role_sent": bool(rec.get("role_sent")),
    }


class RequestJournal:
    """Frontend-side per-request recovery state, fed by the worker's
    ``dynr`` comments and by the data frames the relay forwards."""

    def __init__(self, enabled_: bool = True):
        self.enabled = enabled_
        self.valid = True  # flips False on a journal inconsistency
        self.tokens: List[int] = []  # every token covered by a checkpoint
        self.delivered_chars = 0  # content chars actually forwarded
        self.checkpoint_chars = 0  # cumulative chars at the last checkpoint
        self.data_seen = False  # any data frame forwarded (role chunk sent)
        self.handoff = False  # the worker drained and handed the stream off
        self.response_id: Optional[str] = None
        self.seed: Optional[int] = None
        self.resume_key: Optional[List[int]] = None

    @property
    def recoverable(self) -> bool:
        return self.enabled and self.valid

    @property
    def seam_token_index(self) -> int:
        """0-based output-token index the next continuation resumes from."""
        return len(self.tokens)

    def apply_comment(self, raw: bytes) -> None:
        try:
            obj = json.loads(raw)
        except (ValueError, UnicodeDecodeError):
            self.valid = False
            return
        if not isinstance(obj, dict):
            self.valid = False
            return
        start = obj.get("start")
        if isinstance(start, dict):
            if self.response_id is None and start.get("id"):
                self.response_id = str(start["id"])
            if start.get("seed") is not None:
                self.seed = int(start["seed"])
            return
        self.tokens.extend(int(t) for t in (obj.get("t") or []))
        n = obj.get("n")
        if n is not None and int(n) != len(self.tokens):
            # a dropped/reordered checkpoint would corrupt the seam —
            # refuse to recover rather than risk duplicated tokens
            self.valid = False
        if obj.get("c") is not None:
            self.checkpoint_chars = int(obj["c"])
        if obj.get("handoff"):
            self.handoff = True
        if obj.get("key") is not None:
            try:
                self.resume_key = [int(k) for k in obj["key"]][:2]
            except (TypeError, ValueError):
                pass

    def on_data(self, payload: bytes) -> None:
        """Account a forwarded data frame's content chars."""
        self.data_seen = True
        try:
            obj = json.loads(payload)
        except (ValueError, UnicodeDecodeError):
            return
        if isinstance(obj, dict):
            self.delivered_chars += delta_content_len(obj)

    def continuation(self) -> Dict:
        """The ``dynamo_recovery`` body extension for a re-dispatch."""
        return {
            "prior_tokens": list(self.tokens),
            "delivered_chars": self.delivered_chars,
            "seed": self.seed,
            "resume_key": self.resume_key,
            "response_id": self.response_id,
            "role_sent": self.data_seen,
        }


def delta_content_len(obj: Dict) -> int:
    """Content chars carried by one streaming chunk (chat delta.content
    and legacy-completions choice.text both count; role/finish/usage
    chunks carry none)."""
    total = 0
    for ch in obj.get("choices") or []:
        if not isinstance(ch, dict):
            continue
        delta = ch.get("delta")
        if isinstance(delta, dict) and isinstance(delta.get("content"), str):
            total += len(delta["content"])
        if isinstance(ch.get("text"), str):
            total += len(ch["text"])
    return total


def iter_sse_blocks(resp) -> Iterator[Tuple[str, Optional[bytes]]]:
    """Split a worker SSE response into event blocks.

    Yields ("block", bytes) per event, then exactly one terminal marker:
    ("eof", None) on a clean end of stream, ("conn", None) when the read
    died (reset, stall timeout, chunked-coding violation). The caller
    decides whether the terminal means done (a ``[DONE]`` block arrived
    earlier) or a mid-stream failure."""
    buf = b""
    while True:
        try:
            chunk = (resp.read1(65536) if hasattr(resp, "read1")
                     else resp.read(65536))
        except Exception:
            yield ("conn", None)
            return
        if not chunk:
            yield ("eof", None)
            return
        buf += chunk
        while b"\n\n" in buf:
            block, buf = buf.split(b"\n\n", 1)
            if block.strip():
                yield ("block", block)


def parse_block(block: bytes):
    """Classify one SSE block. Returns (kind, payload):
    - ("journal", raw-json-bytes) for ``: dynr`` comments;
    - ("done", None) for the ``data: [DONE]`` sentinel;
    - ("error", None) for an in-stream error event (worker failure after
      the stream started — the recovery trigger);
    - ("data", payload-bytes) for ordinary data frames;
    - ("other", None) for anything else (forwarded verbatim)."""
    if block.startswith(COMMENT_TAG):
        return "journal", block[len(COMMENT_TAG):]
    if block.startswith(b":"):
        return "other", None
    if block.startswith(b"data:"):
        payload = block[5:].strip()
        if payload == b"[DONE]":
            return "done", None
        try:
            obj = json.loads(payload)
        except (ValueError, UnicodeDecodeError):
            return "data", payload
        if isinstance(obj, dict) and "error" in obj:
            return "error", None
        return "data", payload
    return "other", None
