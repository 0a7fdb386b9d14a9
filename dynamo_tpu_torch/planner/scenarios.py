"""Deterministic traffic schedules shared by the simulator and loadgen.

One pure function, `schedule_rate(kind, t, ...)`, maps sim/wall time to a
target arrival rate — the simulator (dynamo_tpu_torch.planner.sim) integrates
it under a fake clock and `benchmarks.utils.loadgen` replays the SAME
math open-loop against a live endpoint, so a CI-simulated scenario and a
cluster load test describe identical traffic.

Kinds:

- ``steady``:  base_rps flat.
- ``ramp``:    linear base -> peak over the whole duration.
- ``spike``:   flash crowd — base until ``spike_start_s``, linear climb
               over ``spike_ramp_s`` to peak, hold ``spike_hold_s``,
               linear fall over ``spike_fall_s`` back to base.
- ``diurnal``: sinusoidal base..peak with period ``period_s`` (trough at
               t=0) — a day's traffic curve compressed into the run.

Stdlib-only; no randomness (arrival *schedules* are deterministic — the
simulator integrates fractional arrivals exactly, loadgen spaces real
requests at 1/rate).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

SCHEDULE_KINDS = ("steady", "ramp", "spike", "diurnal")


def schedule_rate(
    kind: str,
    t: float,
    duration_s: float,
    base_rps: float,
    peak_rps: float,
    *,
    spike_start_s: float = 120.0,
    spike_ramp_s: float = 120.0,
    spike_hold_s: float = 180.0,
    spike_fall_s: float = 60.0,
    period_s: Optional[float] = None,
) -> float:
    """Target arrival rate (requests/s) at time ``t`` into the run."""
    if kind not in SCHEDULE_KINDS:
        raise ValueError(
            f"unknown schedule {kind!r} (one of {SCHEDULE_KINDS})")
    t = max(0.0, float(t))
    if kind == "steady":
        return base_rps
    if kind == "ramp":
        if duration_s <= 0:
            return peak_rps
        frac = min(1.0, t / duration_s)
        return base_rps + (peak_rps - base_rps) * frac
    if kind == "spike":
        up_end = spike_start_s + spike_ramp_s
        hold_end = up_end + spike_hold_s
        fall_end = hold_end + spike_fall_s
        if t < spike_start_s or t >= fall_end:
            return base_rps
        if t < up_end:
            return base_rps + (peak_rps - base_rps) * (
                (t - spike_start_s) / max(spike_ramp_s, 1e-9))
        if t < hold_end:
            return peak_rps
        return peak_rps - (peak_rps - base_rps) * (
            (t - hold_end) / max(spike_fall_s, 1e-9))
    # diurnal
    period = period_s or duration_s or 1.0
    phase = 0.5 - 0.5 * math.cos(2.0 * math.pi * t / max(period, 1e-9))
    return base_rps + (peak_rps - base_rps) * phase


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named traffic scenario the simulator replays (and loadgen can
    drive): a schedule plus the request shape and the traffic split
    across decode pools (`shares` — the adapter-skew axis)."""

    name: str
    kind: str
    duration_s: float
    base_rps: float
    peak_rps: float
    osl: int = 64                       # output tokens per request
    shares: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"decode": 1.0})
    params: Dict[str, float] = dataclasses.field(default_factory=dict)

    def rate(self, t: float) -> float:
        return schedule_rate(self.kind, t, self.duration_s, self.base_rps,
                             self.peak_rps, **self.params)


def flash_crowd(base_rps: float = 8.0, peak_rps: float = 80.0,
                duration_s: float = 900.0, osl: int = 64) -> Scenario:
    """A 10x flash crowd: ~3 minutes from base to peak (viral-link
    shaped), a sustained plateau, then back down — the coordinated
    planner's acceptance scenario."""
    return Scenario(
        name="flash_crowd", kind="spike", duration_s=duration_s,
        base_rps=base_rps, peak_rps=peak_rps, osl=osl,
        params=dict(spike_start_s=120.0, spike_ramp_s=180.0,
                    spike_hold_s=180.0, spike_fall_s=60.0))


def diurnal(base_rps: float = 10.0, peak_rps: float = 60.0,
            duration_s: float = 1200.0, osl: int = 64) -> Scenario:
    """One compressed day: sinusoidal trough-peak-trough over the run."""
    return Scenario(
        name="diurnal", kind="diurnal", duration_s=duration_s,
        base_rps=base_rps, peak_rps=peak_rps, osl=osl,
        params=dict(period_s=duration_s))


def adapter_skew(base_rps: float = 150.0, peak_rps: float = 800.0,
                 duration_s: float = 600.0, osl: int = 400,
                 adapter_share: float = 0.7) -> Scenario:
    """Adapter-skewed multi-tenant mix at 10k+ concurrent streams: most
    traffic pins one LoRA adapter's pool, the rest hits the base pool —
    the planner must size each pool from ITS share, not the aggregate."""
    return Scenario(
        name="adapter_skew", kind="diurnal", duration_s=duration_s,
        base_rps=base_rps, peak_rps=peak_rps, osl=osl,
        shares={"decode": 1.0 - adapter_share, "adapter": adapter_share},
        params=dict(period_s=duration_s))


SCENARIOS = {
    "flash_crowd": flash_crowd,
    "diurnal": diurnal,
    "adapter_skew": adapter_skew,
}
