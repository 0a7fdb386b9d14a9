"""Engine flight recorder: a bounded ring of structured per-step records.

The engine loop is a single-writer system — `Engine.step()` runs under
`_exec_lock` on one scheduler thread — so the recorder exploits that:
the engine opens a *draft* record at the top of each step, every decision
taken during the step (`admit`, `defer`, `qos_preempt` victim+beneficiary,
`spec_demote`, `kvbm_demote`/`kvbm_onboard`, `kv_oom`, `preempt`,
`finish`, …) attaches to the open draft lock-free, and the draft commits
into the ring with the step's batch composition and phase timings at the
end.  The only lock is a tiny mutex around ring append/snapshot; producer
threads (HTTP handlers noting a `resume` seam, aborts) that fire while no
draft is open commit standalone event records through the same mutex.

Exposure:

- ``GET /debug/flight?n=&rid=&tenant=&kind=&class=`` on every worker
  (`debug_flight_payload`) — filterable, newest-last;
- ``dump(reason)`` — the crash/abort hook: flushes any open draft (the
  partially-executed step that died is exactly the forensic record you
  want), appends a dump marker, and logs the ring tail so the history
  survives even if the process exits before anyone scrapes it.

Ring capacity comes from ``DYNAMO_TPU_FLIGHT_RECORDS`` (default 512;
0 disables recording entirely — every hook degrades to a no-op).

The port's own copy of `dynamo_tpu/observability/flight.py`
(it imports nothing of the JAX package); keep the two in step.
"""

from __future__ import annotations

import collections
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

log = logging.getLogger("dynamo_tpu_torch.flight")

DEFAULT_CAPACITY = 512
CAPACITY_ENV = "DYNAMO_TPU_FLIGHT_RECORDS"
# how many trailing records a dump writes to the log (full ring goes to
# the returned payload; the log line is for post-mortem grep)
DUMP_LOG_TAIL = 8


def _env_capacity() -> int:
    raw = os.environ.get(CAPACITY_ENV, "")
    try:
        return int(raw) if raw.strip() else DEFAULT_CAPACITY
    except ValueError:
        log.warning("bad %s=%r; using default %d", CAPACITY_ENV, raw,
                    DEFAULT_CAPACITY)
        return DEFAULT_CAPACITY


class FlightRecorder:
    """Bounded, lock-cheap ring of per-step engine records."""

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            capacity = _env_capacity()
        self.capacity = max(0, int(capacity))
        self.enabled = self.capacity > 0
        self._ring: "collections.deque[Dict[str, Any]]" = collections.deque(  # guarded_by: _lock
            maxlen=max(1, self.capacity))
        self._lock = threading.Lock()
        self._seq = 0  # guarded_by: _lock — monotonic id, survives wrap
        self.steps_total = 0
        self.dropped_total = 0
        # open per-step draft; engine scheduler thread only (begin/commit)
        self._draft: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------ engine thread --
    def begin(self) -> None:
        """Open the draft for one `Engine.step()`.  A draft still open from
        a previous begin means that step died mid-flight (exception unwound
        past commit): flush it flagged, never lose it."""
        if not self.enabled:
            return
        stale = self._draft
        if stale is not None:
            stale["aborted"] = True
            self._close_draft(stale, "aborted")
            self._append(stale)
        self._draft = {"t": time.time(), "kinds": [], "phases": {},
                       "events": []}

    def phase(self, kind: str, dur_s: float, **fields: Any) -> None:
        """Record one executed segment (a dispatch) of the open step.
        Accumulates raw float seconds — rounding happens once at record
        flush (_close_draft), so repeated phases in one step can't
        compound per-accumulate rounding error."""
        d = self._draft
        if d is None:
            return
        d["kinds"].append(kind)
        d["phases"][kind] = d["phases"].get(kind, 0.0) + dur_s
        for k, v in fields.items():
            d[k] = v

    @staticmethod
    def _close_draft(d: Dict[str, Any], empty_kind: str) -> None:
        """Finalize a draft in place: collapse kinds and convert the
        phase accumulators to the record format (ms, 3 decimals)."""
        d["kind"] = "+".join(d.pop("kinds")) or empty_kind
        d["phases"] = {k: round(v * 1e3, 3)
                       for k, v in d["phases"].items()}

    def commit(self, **fields: Any) -> None:
        """Finalize the open step record.  Steps that did nothing (no
        segment ran, no decision fired) are dropped — an idle engine must
        not wash real history out of the ring."""
        d, self._draft = self._draft, None
        if d is None:
            return
        if not d["kinds"] and not d["events"]:
            return
        d.update(fields)
        self._close_draft(d, "event")
        self.steps_total += 1
        self._append(d)

    # ------------------------------------------------------- any thread ----
    def note(self, event: str, **fields: Any) -> None:
        """Attach a decision to the open step record, or — when no draft is
        open (producer threads: resume seams, aborts, dumps) — commit a
        standalone event record.  Appending to a live draft from a foreign
        thread is safe: list.append is atomic, and the worst race lands the
        event on the just-committed record, which is where it belongs."""
        if not self.enabled:
            return
        rec = {"ev": event}
        rec.update(fields)
        d = self._draft
        if d is not None:
            d["events"].append(rec)
        else:
            self._append({"t": time.time(), "kind": "event",
                          "events": [rec]})

    def dump(self, reason: str, **fields: Any) -> Dict[str, Any]:
        """Crash/abort dump: flush any open draft, append a dump marker,
        and log the ring tail.  Returns the full ring so callers (fatal-step
        recovery, tests) can persist or assert on it."""
        if not self.enabled:
            return {"reason": reason, "records": []}
        d, self._draft = self._draft, None
        if d is not None:
            d["aborted"] = True
            if not d["kinds"] and not d["events"]:
                d["events"].append({"ev": "empty_step"})
            self._close_draft(d, "aborted")
            self._append(d)
        self.note("dump", reason=reason, **fields)
        records = self.records()
        tail = records[-DUMP_LOG_TAIL:]
        log.error("flight dump [%s]: %d records in ring; tail: %s",
                  reason, len(records), tail)
        return {"reason": reason, **fields, "records": records}

    # --------------------------------------------------------- internals ---
    def _append(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            rec["seq"] = self._seq
            self._seq += 1
            if len(self._ring) == self._ring.maxlen:
                self.dropped_total += 1
            self._ring.append(rec)

    def records(self, n: Optional[int] = None) -> List[Dict[str, Any]]:
        with self._lock:
            out = list(self._ring)
        if n is not None and n > 0:
            out = out[-n:]
        return out


# ------------------------------------------------------------ filtering ----

def _matches(rec: Dict[str, Any], rid: Optional[str],
             tenant: Optional[str], kind: Optional[str],
             klass: Optional[str] = None) -> bool:
    if kind is not None and kind not in rec.get("kind", ""):
        return False

    def hit(field: str, want: str) -> bool:
        if rec.get(field) == want:
            return True
        for s in rec.get("batch", ()):
            if s.get(field) == want:
                return True
        for e in rec.get("events", ()):
            if e.get(field) == want or e.get("victim_" + field) == want \
                    or e.get("beneficiary_" + field) == want:
                return True
        return False

    if rid is not None and not hit("rid", rid):
        return False
    if tenant is not None and not hit("tenant", tenant):
        return False
    if klass is not None and not hit("class", klass):
        return False
    return True


def debug_flight_payload(recorder: FlightRecorder,
                         qs: Dict[str, List[str]]) -> Dict[str, Any]:
    """Build the `GET /debug/flight` response from parsed query params.

    ``n`` bounds the returned records (default 128, applied AFTER the
    rid/tenant/kind/class filters so a busy engine can't wash out the one
    request you're chasing).  ``class=batch`` matches records whose events
    carry ``victim_class``/``beneficiary_class`` — QoS evictions of the
    preemptible batch tier are attributable without knowing tenant ids."""
    def one(key: str) -> Optional[str]:
        vals = qs.get(key) or []
        return vals[0] if vals and vals[0] != "" else None

    try:
        n = int(one("n") or 128)
    except ValueError:
        n = 128
    rid, tenant, kind = one("rid"), one("tenant"), one("kind")
    klass = one("class")
    recs = recorder.records()
    size = len(recs)
    if rid is not None or tenant is not None or kind is not None \
            or klass is not None:
        recs = [r for r in recs if _matches(r, rid, tenant, kind, klass)]
    return {
        "enabled": recorder.enabled,
        "capacity": recorder.capacity,
        "size": size,
        "steps_total": recorder.steps_total,
        "dropped_total": recorder.dropped_total,
        "matched": len(recs),
        "records": recs[-n:] if n > 0 else recs,
    }
