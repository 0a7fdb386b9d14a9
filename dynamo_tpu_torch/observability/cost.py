"""Per-tenant cost attribution: chip-seconds and HBM-byte-seconds.

Accumulated from the same per-step evidence the flight recorder sees:
every executed engine segment (decode window, mixed step, prefill, chunk)
calls `account(dur_s, shares, holdings)` with

- ``shares``   — tenant → work units this segment.  Decode slots are one
  unit each; prefill/chunk work is units = tokens, so a mixed step splits
  its wall time between the chunk's tenant (by token share) and the
  decode slots exactly as the attribution rule prescribes.
- ``holdings`` — tenant → KV bytes held on-device during the segment
  (sequence pages + inflight-prefill pages + parked disagg pages).

Chip-seconds for a tenant = dur_s × its unit share; byte-seconds accrue
bytes × dur_s.  Both are accumulated next to engine-level totals in the
SAME call, so the conservation invariant — per-tenant shares sum to the
engine totals — holds by construction and is assertable at any instant
(tests/test_cost_accounting.py; `/debug/costs` exposes both sides).

The frontend aggregates worker rollups fleet-wide: the worker heartbeat
carries `rollup()` in its stats payload, the existing gossip plane relays
registrations between frontend replicas, and `merge_rollups` sums them.

The port's own copy of `dynamo_tpu/observability/cost.py`
(it imports nothing of the JAX package); keep the two in step.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Iterable, Mapping


class CostLedger:
    """Monotonic per-tenant cost counters with engine-total conservation."""

    def __init__(self):
        self._lock = threading.Lock()
        self.chip_seconds: Dict[str, float] = {}  # guarded_by: _lock
        self.hbm_byte_seconds: Dict[str, float] = {}  # guarded_by: _lock
        self.chip_seconds_total = 0.0  # guarded_by: _lock
        self.hbm_byte_seconds_total = 0.0  # guarded_by: _lock
        self.segments_total = 0  # guarded_by: _lock
        # optional tenant -> tier classifier ("batch" | "interactive"),
        # wired once at engine construction from the QoS registry so the
        # preemptible batch tier prices as its own rollup row; read-only
        # after wiring (no lock needed)
        self.tier_of = None

    def account(self, dur_s: float, shares: Mapping[str, float],
                holdings: Mapping[str, float]) -> None:
        """Attribute one executed segment.  Totals only advance by exactly
        what gets distributed, so sum(per-tenant) == total always."""
        if dur_s <= 0.0:
            return
        unit_total = float(sum(shares.values()))
        byte_total = float(sum(holdings.values()))
        with self._lock:
            self.segments_total += 1
            if unit_total > 0.0:
                self.chip_seconds_total += dur_s
                for tenant, units in shares.items():
                    if units <= 0.0:
                        continue
                    self.chip_seconds[tenant] = (
                        self.chip_seconds.get(tenant, 0.0)
                        + dur_s * (units / unit_total))
            if byte_total > 0.0:
                self.hbm_byte_seconds_total += byte_total * dur_s
                for tenant, nbytes in holdings.items():
                    if nbytes <= 0.0:
                        continue
                    self.hbm_byte_seconds[tenant] = (
                        self.hbm_byte_seconds.get(tenant, 0.0)
                        + nbytes * dur_s)

    # ------------------------------------------------------------ export ---
    def chip_seconds_snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self.chip_seconds)

    def hbm_byte_seconds_snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self.hbm_byte_seconds)

    def per_tenant(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            tenants = set(self.chip_seconds) | set(self.hbm_byte_seconds)
            return {t: {"chip_seconds": self.chip_seconds.get(t, 0.0),
                        "hbm_byte_seconds": self.hbm_byte_seconds.get(t, 0.0)}
                    for t in sorted(tenants)}

    def rollup(self) -> Dict[str, Any]:
        """`GET /debug/costs` body / heartbeat `stats["costs"]` payload."""
        tier_of = self.tier_of
        with self._lock:
            tenants = set(self.chip_seconds) | set(self.hbm_byte_seconds)
            out = {
                "tenants": {
                    t: {"chip_seconds":
                        round(self.chip_seconds.get(t, 0.0), 6),
                        "hbm_byte_seconds":
                        round(self.hbm_byte_seconds.get(t, 0.0), 3)}
                    for t in sorted(tenants)},
                "totals": {
                    "chip_seconds": round(self.chip_seconds_total, 6),
                    "hbm_byte_seconds":
                    round(self.hbm_byte_seconds_total, 3)},
                "segments_total": self.segments_total,
            }
            if tier_of is not None:
                tiers: Dict[str, Dict[str, float]] = {}
                for t in tenants:
                    row = tiers.setdefault(
                        tier_of(t),
                        {"chip_seconds": 0.0, "hbm_byte_seconds": 0.0})
                    row["chip_seconds"] += self.chip_seconds.get(t, 0.0)
                    row["hbm_byte_seconds"] += \
                        self.hbm_byte_seconds.get(t, 0.0)
                out["tiers"] = {
                    tier: {k: round(v, 6) for k, v in row.items()}
                    for tier, row in sorted(tiers.items())}
        return out


def merge_rollups(rollups: Iterable[Mapping[str, Any]]) -> Dict[str, Any]:
    """Fleet-wide sum of per-worker `rollup()` payloads (frontend
    `/debug/costs`).  Tolerates malformed/missing entries — a worker on an
    older build just contributes nothing."""
    tenants: Dict[str, Dict[str, float]] = {}
    tiers: Dict[str, Dict[str, float]] = {}
    totals = {"chip_seconds": 0.0, "hbm_byte_seconds": 0.0}
    workers = 0
    for r in rollups:
        if not isinstance(r, Mapping):
            continue
        workers += 1
        for t, c in (r.get("tenants") or {}).items():
            if not isinstance(c, Mapping):
                continue
            agg = tenants.setdefault(
                t, {"chip_seconds": 0.0, "hbm_byte_seconds": 0.0})
            agg["chip_seconds"] += float(c.get("chip_seconds", 0.0))
            agg["hbm_byte_seconds"] += float(c.get("hbm_byte_seconds", 0.0))
        for tier, c in (r.get("tiers") or {}).items():
            if not isinstance(c, Mapping):
                continue
            agg = tiers.setdefault(
                tier, {"chip_seconds": 0.0, "hbm_byte_seconds": 0.0})
            agg["chip_seconds"] += float(c.get("chip_seconds", 0.0))
            agg["hbm_byte_seconds"] += float(c.get("hbm_byte_seconds", 0.0))
        tot = r.get("totals") or {}
        totals["chip_seconds"] += float(tot.get("chip_seconds", 0.0))
        totals["hbm_byte_seconds"] += float(tot.get("hbm_byte_seconds", 0.0))
    out = {"tenants": {t: {k: round(v, 6) for k, v in c.items()}
                       for t, c in sorted(tenants.items())},
           "totals": {k: round(v, 6) for k, v in totals.items()},
           "workers": workers}
    if tiers:
        out["tiers"] = {tier: {k: round(v, 6) for k, v in c.items()}
                        for tier, c in sorted(tiers.items())}
    return out
