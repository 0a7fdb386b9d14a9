"""Coordinated pool planner: forecast demand -> per-pool replica targets.

The decision loop "Taming the Chaos" (arxiv 2508.19559) argues for:
prefill, decode, aggregated, and adapter-pinned pools are sized from ONE
shared traffic forecast in the SAME tick, each through its own capacity
model — so a prefill scale-up that would flood decode raises the decode
target in the same decision, instead of queueing the flood and reacting a
provisioning-delay later (the bottleneck-moving failure mode the
uncoordinated baseline reproduces in tests/test_planner.py).

Per pool and tick:

- demand: coordinated mode projects the frontend forecast through the
  pool's share and currency (prompts/s for prefill, tokens/s = rps * osl
  for decode); uncoordinated mode (coordinate=False — the v1 baseline
  the simulator A/Bs against) only reacts to the pool's own queue /
  inflight signals.
- reactive floors: a real backlog (queued prompts, admitted streams) is
  never ignored just because the forecast missed it.
- coordination clamp: each prefill pool's post-decision admission rate is
  re-projected onto its partner decode pool (`coordinate_with`), raising
  the decode target in the same tick when a backlog flush would exceed
  decode's drain rate.
- SLO burn boost: a fast-window burn in the pool's own currency adds one
  replica at burn onset and holds the scale mid-burn (same semantics as
  the v1 planner's sloBurnBoost, per pool).
- hysteresis: scale-up is immediate; scale-down waits out
  `scale_down_delay_s` of sustained low demand and then steps down ONE
  replica per tick so every victim gets a full graceful drain
  (shed -> journaled-stream handoff -> KVBM host-tier demotion) before
  the next shrink.

Every applied decision lands in a bounded journal (GET /debug/planner on
the operator) and in the dynamo_planner_* metrics.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any, Dict, List, Mapping, Optional

from dynamo_tpu_torch.planner.capacity import PoolCapacity, capacity_from_spec
from dynamo_tpu_torch.planner.signals import PoolSignals

ROLES = ("prefill", "decode", "aggregated", "adapter")

# manifest keys of a pool-aware `autoscaling` block (superset of v1's)
_AUTOSCALING_KEYS = {
    "enabled", "minReplicas", "maxReplicas", "targetQueuedPerReplica",
    "scaleDownDelaySeconds", "metricsUrl", "historyUrl", "sloBurnBoost",
    "role", "pool", "expectedOsl", "targetUtilization", "trafficShare",
    "coordinateWith", "forecastHorizonSeconds", "preemptible",
}


@dataclasses.dataclass(frozen=True)
class PoolSpec:
    """One autoscaled pool (= one DGD service with a role)."""

    name: str
    capacity: PoolCapacity
    role: str = "aggregated"
    min_replicas: int = 1
    max_replicas: int = 8
    target_utilization: float = 0.7   # headroom under the roofline rate
    osl: int = 256                    # expected output tokens per request
    share: float = 1.0                # fraction of traffic on this pool
    target_queued_per_replica: int = 4
    scale_down_delay_s: float = 120.0
    slo_burn_boost: bool = True
    coordinate_with: str = ""         # partner decode pool (prefill pools)
    forecast_horizon_s: float = 60.0
    # preemptible batch pool (docs/robustness.md "Preemptible batch
    # tier"): sized from the TROUGH — the headroom the interactive
    # forecast leaves under max_replicas — and stepped down immediately
    # (no hysteresis, no burn boost) when the interactive SLO burns
    preemptible: bool = False

    def __post_init__(self):
        if self.role not in ROLES:
            raise ValueError(
                f"pool {self.name!r}: unknown role {self.role!r} "
                f"(one of {ROLES})")
        if not 0.0 < self.target_utilization <= 1.0:
            raise ValueError(
                f"pool {self.name!r}: targetUtilization must be in (0, 1]")
        if not 0.0 < self.share <= 1.0:
            raise ValueError(
                f"pool {self.name!r}: trafficShare must be in (0, 1]")


def is_pool_autoscaling(auto: Mapping[str, Any]) -> bool:
    """Does this `autoscaling` block opt into planner v2? Keyed on the
    pool-aware fields so every existing v1 manifest keeps the v1 loop."""
    return bool(auto.get("pool") or auto.get("role"))


def pool_spec_from_manifest(svc_name: str,
                            svc_spec: Mapping[str, Any]
                            ) -> Optional[PoolSpec]:
    """Parse one DGD service's pool-aware `autoscaling` block.

    Returns None for services without one (disabled, or v1 queue-only
    blocks). Unknown keys and malformed capacity specs raise — example
    manifests are validated with exactly this parser."""
    auto = svc_spec.get("autoscaling") or {}
    if not auto.get("enabled") or not is_pool_autoscaling(auto):
        return None
    unknown = set(auto) - _AUTOSCALING_KEYS
    if unknown:
        raise ValueError(
            f"service {svc_name!r}: unknown autoscaling keys "
            f"{sorted(unknown)} (known: {sorted(_AUTOSCALING_KEYS)})")
    role = str(auto.get("role") or
               ("prefill" if svc_spec.get("subComponentType") == "prefill"
                else "decode" if svc_spec.get("subComponentType") == "decode"
                else "aggregated"))
    pool = auto.get("pool")
    if not isinstance(pool, Mapping):
        raise ValueError(
            f"service {svc_name!r}: pool-aware autoscaling needs a "
            "`pool:` capacity block (explicit rates or a roofline spec)")
    preemptible = bool(auto.get("preemptible", False))
    # a preemptible pool may scale to ZERO replicas: at interactive peak
    # the whole batch tier yields its chips
    lo = max(0 if preemptible else 1, int(auto.get("minReplicas",
                                                   0 if preemptible else 1)))
    hi = max(lo, int(auto.get("maxReplicas", svc_spec.get("replicas", 1))))
    return PoolSpec(
        name=svc_name,
        capacity=capacity_from_spec(pool),
        role=role,
        min_replicas=lo,
        max_replicas=hi,
        target_utilization=float(auto.get("targetUtilization", 0.7)),
        osl=int(auto.get("expectedOsl", 256)),
        share=float(auto.get("trafficShare", 1.0)),
        target_queued_per_replica=max(
            1, int(auto.get("targetQueuedPerReplica", 4))),
        scale_down_delay_s=float(auto.get("scaleDownDelaySeconds", 120)),
        slo_burn_boost=bool(auto.get("sloBurnBoost", True)),
        coordinate_with=str(auto.get("coordinateWith") or ""),
        forecast_horizon_s=float(auto.get("forecastHorizonSeconds", 60)),
        preemptible=preemptible,
    )


@dataclasses.dataclass(frozen=True)
class Decision:
    """One applied replica change (the journal entry)."""

    t: float
    pool: str
    from_replicas: int
    to_replicas: int
    reason: str          # forecast | queue | inflight | burn | coordination
                         # | scale_down | trough | burn_reclaim
    forecast_rps: float
    burn: float
    queued: float
    inflight: float

    @property
    def direction(self) -> str:
        return "up" if self.to_replicas > self.from_replicas else "down"

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["direction"] = self.direction
        return d


@dataclasses.dataclass
class _PoolState:
    replicas: int
    low_since: Optional[float] = None
    burn_active: bool = False


class PoolPlanner:
    """The coordinated decision loop over a set of pools (one DGD)."""

    def __init__(self, pools: List[PoolSpec], coordinate: bool = True,
                 journal_maxlen: int = 256):
        if not pools:
            raise ValueError("PoolPlanner needs at least one pool")
        self.pools: Dict[str, PoolSpec] = {}
        self.state: Dict[str, _PoolState] = {}
        for p in pools:
            if p.name in self.pools:
                raise ValueError(f"duplicate pool name {p.name!r}")
            self.pools[p.name] = p
            self.state[p.name] = _PoolState(replicas=p.min_replicas)
        self.coordinate = coordinate
        self.journal: "collections.deque[Decision]" = collections.deque(
            maxlen=journal_maxlen)
        # (pool, direction) -> count, for dynamo_planner_decisions_total
        self.decisions_total: Dict[tuple, int] = {}
        self.last_forecast: Dict[str, float] = {}
        self.last_signals: Dict[str, PoolSignals] = {}

    # -------------------------------------------------------------- state --
    def seed(self, pool: str, replicas: int) -> None:
        """Adopt a persisted target (DGD status plannerReplicas) without
        emitting a decision — a restarted operator resumes the standing
        scale instead of journaling a spurious scale event."""
        if pool in self.state:
            spec = self.pools[pool]
            self.state[pool].replicas = max(
                spec.min_replicas, min(spec.max_replicas, int(replicas)))

    def targets(self) -> Dict[str, int]:
        return {name: st.replicas for name, st in self.state.items()}

    # ------------------------------------------------------------- demand --
    @staticmethod
    def _ceil_div(demand: float, per_replica: float) -> int:
        if per_replica <= 0:
            return 0
        return int(math.ceil(demand / per_replica - 1e-9))

    def _forecast_want(self, p: PoolSpec, s: PoolSignals) -> int:
        """Target replicas from the shared frontend forecast, in the
        pool's own currency."""
        rps = s.forecast_rps * p.share
        cap = p.capacity
        util = p.target_utilization
        want = 0
        if p.role in ("prefill", "aggregated") and cap.prompts_per_s > 0:
            want = max(want, self._ceil_div(rps, cap.prompts_per_s * util))
        if p.role in ("decode", "adapter", "aggregated") \
                and cap.tokens_per_s > 0:
            want = max(want,
                       self._ceil_div(rps * p.osl, cap.tokens_per_s * util))
        return want

    def _reactive_want(self, p: PoolSpec, s: PoolSignals) -> int:
        """Floor from the pool's OWN observed state — the whole decision
        in uncoordinated mode, a safety floor under the forecast in
        coordinated mode."""
        want = 0
        if p.role in ("prefill", "aggregated"):
            # the v1 backpressure rule: queued prompts per replica
            want = max(want, self._ceil_div(s.queued,
                                            p.target_queued_per_replica))
        if p.role in ("decode", "adapter", "aggregated") \
                and p.capacity.max_streams > 0:
            # signals are per-pool: `inflight` is THIS pool's admitted
            # streams (adapter pools see adapter traffic, not the total)
            want = max(want, self._ceil_div(
                s.inflight, p.capacity.max_streams * p.target_utilization))
        return want

    # --------------------------------------------------------------- tick --
    def tick(self, signals: Mapping[str, PoolSignals], now: float
             ) -> Dict[str, int]:
        """One planning pass; returns the target replicas per pool after
        applying hysteresis. Pools with no signals this tick hold their
        last decision."""
        wants: Dict[str, int] = {}
        reasons: Dict[str, str] = {}
        for name, p in self.pools.items():
            s = signals.get(name)
            if s is None:
                continue
            self.last_signals[name] = s
            self.last_forecast[name] = s.forecast_rps * p.share
            reactive = self._reactive_want(p, s)
            if p.preemptible:
                # trough sizing: the batch pool gets the headroom the
                # interactive forecast leaves under max_replicas —
                # bounded by its OWN observed demand (no point running
                # empty batch replicas), never grown past the trough
                # by backlog pressure (batch absorbs spare chips, it
                # does not buy new ones)
                headroom = max(0, p.max_replicas - self._forecast_want(p, s))
                wants[name] = min(headroom, reactive)
                reasons[name] = "trough" if headroom < reactive else (
                    "queue" if s.queued else "inflight")
                continue
            if self.coordinate:
                fw = self._forecast_want(p, s)
                wants[name] = max(fw, reactive)
                reasons[name] = ("forecast" if fw >= reactive else
                                 "queue" if s.queued else "inflight")
            else:
                wants[name] = reactive
                reasons[name] = "queue" if p.role in ("prefill",
                                                      "aggregated") \
                    else "inflight"

        # coordination: project every prefill pool's post-decision
        # admission rate onto its partner decode pool IN THIS TICK — a
        # queue-floor scale-up (backlog flush) must not flood a decode
        # pool sized only for the forecast
        if self.coordinate:
            for name, p in self.pools.items():
                if p.role != "prefill" or name not in wants:
                    continue
                partner = self.pools.get(p.coordinate_with)
                if partner is None or partner.name not in wants:
                    continue
                s = signals[name]
                clamped = max(self.state[name].replicas,
                              min(p.max_replicas, wants[name]))
                admit_rps = min(
                    max(s.forecast_rps * p.share, s.rps * p.share),
                    clamped * p.capacity.prompts_per_s)
                if s.queued > 0:
                    # a standing backlog flushes at full admission rate
                    admit_rps = clamped * p.capacity.prompts_per_s
                need = self._ceil_div(
                    admit_rps * partner.osl,
                    partner.capacity.tokens_per_s
                    * partner.target_utilization)
                if need > wants[partner.name]:
                    wants[partner.name] = need
                    reasons[partner.name] = "coordination"

        for name, want in wants.items():
            s = signals[name]
            if s.quarantined and not self.pools[name].preemptible:
                # watchdog-quarantined replicas count against the
                # Deployment but serve nothing — size for demand PLUS
                # the dead slots so effective capacity stays whole
                # until the operator replaces them (quarantine_tick)
                want += int(s.quarantined)
            self._apply(name, want, reasons[name], s, now)
        return self.targets()

    def _apply(self, name: str, want: int, reason: str, s: PoolSignals,
               now: float) -> None:
        p = self.pools[name]
        st = self.state[name]
        st.replicas = max(p.min_replicas, min(p.max_replicas, st.replicas))
        want = max(p.min_replicas, min(p.max_replicas, want))
        burn = s.burn_for_role(p.role)
        if p.preemptible:
            # preemptible batch pool: an interactive burn SHRINKS it
            # immediately (one replica per tick so each victim still
            # gets its reclamation drain), bypassing the scale-down
            # hysteresis — the tier's contract is instant yield
            if burn > 1.0 and st.replicas > p.min_replicas:
                step = max(p.min_replicas, st.replicas - 1)
                self._record(name, st.replicas, step, "burn_reclaim", s, now)
                st.replicas = step
                st.low_since = None
                return
            if want > st.replicas:
                self._record(name, st.replicas, want, reason, s, now)
                st.replicas = want
                st.low_since = None
            elif want < st.replicas:
                # trough closing: step down one per tick WITHOUT the
                # interactive pools' delay — the forecast already is
                # the hysteresis (it moves on the horizon, not per
                # request), and reclamation drains cover each victim
                step = st.replicas - 1
                self._record(name, st.replicas, step, "scale_down", s, now)
                st.replicas = step
            return
        # burn boost: +1 at burn onset, hold mid-burn (v1 semantics)
        if burn > 1.0 and p.slo_burn_boost:
            if not st.burn_active:
                st.burn_active = True
                if st.replicas + 1 > want:
                    want = min(p.max_replicas, st.replicas + 1)
                    reason = "burn"
            else:
                want = max(want, st.replicas)  # no mid-burn shrink
        else:
            st.burn_active = False

        if want > st.replicas:
            self._record(name, st.replicas, want, reason, s, now)
            st.replicas = want
            st.low_since = None
        elif want < st.replicas:
            if st.low_since is None:
                st.low_since = now
            elif now - st.low_since >= p.scale_down_delay_s:
                # one replica per tick: every victim drains fully
                # (annotated, SIGTERM shed/handoff/demote) before the
                # next shrink decision can land
                step = st.replicas - 1
                self._record(name, st.replicas, step, "scale_down", s, now)
                st.replicas = step
                # keep low_since armed so the next tick may step again
                # (already waited out the delay once this episode)
        else:
            st.low_since = None

    def _record(self, name: str, from_r: int, to_r: int, reason: str,
                s: PoolSignals, now: float) -> None:
        d = Decision(t=now, pool=name, from_replicas=from_r,
                     to_replicas=to_r, reason=reason,
                     forecast_rps=round(s.forecast_rps, 3),
                     burn=round(s.burn_for_role(self.pools[name].role), 3),
                     queued=s.queued, inflight=s.inflight)
        self.journal.append(d)
        key = (name, d.direction)
        self.decisions_total[key] = self.decisions_total.get(key, 0) + 1

    # -------------------------------------------------------------- debug --
    def debug_payload(self) -> Dict[str, Any]:
        return {
            "coordinate": self.coordinate,
            "pools": {
                name: {
                    "role": p.role,
                    "target_replicas": self.state[name].replicas,
                    "min_replicas": p.min_replicas,
                    "max_replicas": p.max_replicas,
                    "share": p.share,
                    "forecast_rps": round(
                        self.last_forecast.get(name, 0.0), 3),
                    "capacity": dataclasses.asdict(p.capacity),
                    "coordinate_with": p.coordinate_with or None,
                    "preemptible": p.preemptible,
                }
                for name, p in self.pools.items()
            },
            "decisions": [d.to_dict() for d in self.journal],
        }
