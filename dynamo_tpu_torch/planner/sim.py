"""Deterministic heavy-traffic simulation of the coordinated planner.

A discrete-event harness (fixed-step fake clock, no sockets, no device)
that models pools as roofline-parameterized queues and replays the
loadgen scenario schedules (scenarios.py) against the REAL planner
(planner.PoolPlanner) — the full control loop
(signals -> forecast -> capacity -> coordinated decision -> hitless
drain) asserted in tier-1 CI without a GPU:

- **prefill pools** are FIFO queues of request cohorts; a replica serves
  `prompts_per_s` prompts/s, and a request's simulated TTFT is its time
  from arrival to leaving prefill (queue wait + service).
- **decode pools** are capacity-shared stream sets: every admitted
  stream progresses at `min(1/itl_s, pool_tokens_per_s / streams)`
  tokens/s, so oversubscription stretches the achieved ITL exactly the
  way a saturated batch does. A request becomes a stream when its
  prefill completes and leaves after `osl` tokens.
- **scaling** is actuated with a provisioning delay (new replicas take
  `provision_delay_s` to come Ready) and a drain latency: a scale-down
  victim stops taking work immediately, hands its streams to the
  surviving replicas (hitless=True, the PR-4 SIGTERM drain), and leaves
  after `drain_s`. With hitless=False the victim's streams are DROPPED
  mid-flight — the counter-factual proving the drain path is what makes
  scale-down safe.
- **signals** are built from sim state each planner tick exactly as the
  operator scrapes them (queue depth, per-pool inflight, fast-window
  burn over a sliding window, and the 10s-bucket arrival-history ring
  the Forecaster consumes).

Everything is pure arithmetic over the fake clock: two runs of the same
scenario produce byte-identical reports.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Deque, Dict, List, Optional

from dynamo_tpu_torch.planner.planner import PoolPlanner, PoolSpec
from dynamo_tpu_torch.planner.scenarios import Scenario
from dynamo_tpu_torch.planner.signals import Forecaster, PoolSignals

HISTORY_BUCKET_S = 10.0   # mirrors observability/slo.py DEFAULT_BUCKET_S
BURN_WINDOW_S = 60.0      # sim fast window (60s of 10s buckets)


@dataclasses.dataclass
class SimPoolCfg:
    """One pool's simulation parameters around its real PoolSpec."""

    spec: PoolSpec
    provision_delay_s: float = 30.0
    drain_s: float = 10.0
    hitless: bool = True              # drain-before-shrink vs abrupt kill
    initial_replicas: Optional[int] = None


@dataclasses.dataclass
class PoolStats:
    requests_total: float = 0.0       # prefill completions (TTFT samples)
    requests_breached: float = 0.0
    tokens_total: float = 0.0         # decode deliveries (ITL samples)
    tokens_breached: float = 0.0
    dropped_streams: float = 0.0
    completed_streams: float = 0.0
    max_streams: float = 0.0
    replica_seconds: float = 0.0
    peak_replicas: int = 0

    @property
    def ttft_attainment(self) -> float:
        if self.requests_total <= 0:
            return 1.0
        return 1.0 - self.requests_breached / self.requests_total

    @property
    def itl_attainment(self) -> float:
        if self.tokens_total <= 0:
            return 1.0
        return 1.0 - self.tokens_breached / self.tokens_total


class _SimPool:
    def __init__(self, cfg: SimPoolCfg):
        self.cfg = cfg
        self.spec = cfg.spec
        self.ready = int(cfg.initial_replicas
                         if cfg.initial_replicas is not None
                         else cfg.spec.min_replicas)
        self.provisioning: List[float] = []   # ready_at times
        self.draining: List[float] = []       # gone_at times
        self.stats = PoolStats()
        # prefill: FIFO of [n_remaining, arrival_t, share_key]
        self.queue: Deque[List[Any]] = collections.deque()
        # decode: stream cohorts [n_streams, remaining_tokens]
        self.cohorts: List[List[float]] = []
        # sliding breach window: (t, samples, breaches)
        self.burn_ring: Deque[tuple] = collections.deque()

    # ---------------------------------------------------------- capacity --
    def settle(self, now: float) -> None:
        still = []
        for at in self.provisioning:
            if at <= now:
                self.ready += 1
            else:
                still.append(at)
        self.provisioning = still
        self.draining = [at for at in self.draining if at > now]

    @property
    def target_total(self) -> int:
        return self.ready + len(self.provisioning)

    def streams(self) -> float:
        return sum(c[0] for c in self.cohorts)

    def bank_burn(self, now: float, samples: float, breaches: float) -> None:
        self.burn_ring.append((now, samples, breaches))
        while self.burn_ring and self.burn_ring[0][0] < now - BURN_WINDOW_S:
            self.burn_ring.popleft()

    def fast_burn(self, budget: float) -> float:
        tot = sum(r[1] for r in self.burn_ring)
        br = sum(r[2] for r in self.burn_ring)
        if tot <= 0 or budget <= 0:
            return 0.0
        return (br / tot) / budget


@dataclasses.dataclass
class ScaleDownEvent:
    t: float
    pool: str
    drained: bool          # went through the graceful drain path
    done_at: float         # when the victim actually left
    dropped: float         # mid-stream drops caused (0 when drained)


@dataclasses.dataclass
class SimReport:
    scenario: str
    coordinate: bool
    duration_s: float
    pool_stats: Dict[str, PoolStats]
    decisions: List[Dict[str, Any]]
    scale_down_events: List[ScaleDownEvent]
    max_concurrent_streams: float
    requests_total: float
    final_replicas: Dict[str, int]

    @property
    def dropped_streams(self) -> float:
        return sum(s.dropped_streams for s in self.pool_stats.values())

    @property
    def ttft_attainment(self) -> float:
        tot = sum(s.requests_total for s in self.pool_stats.values())
        br = sum(s.requests_breached for s in self.pool_stats.values())
        return 1.0 if tot <= 0 else 1.0 - br / tot

    @property
    def itl_attainment(self) -> float:
        tot = sum(s.tokens_total for s in self.pool_stats.values())
        br = sum(s.tokens_breached for s in self.pool_stats.values())
        return 1.0 if tot <= 0 else 1.0 - br / tot

    def summary(self) -> Dict[str, Any]:
        return {
            "scenario": self.scenario,
            "coordinate": self.coordinate,
            "ttft_attainment": round(self.ttft_attainment, 5),
            "itl_attainment": round(self.itl_attainment, 5),
            "requests": round(self.requests_total, 1),
            "max_concurrent_streams": round(self.max_concurrent_streams),
            "dropped_streams": round(self.dropped_streams, 2),
            "decisions": len(self.decisions),
            "scale_downs": len(self.scale_down_events),
            "final_replicas": dict(self.final_replicas),
        }


class Simulator:
    """Replay one Scenario against a PoolPlanner over simulated pools.

    Exactly one pool must have role `prefill` (or `aggregated`, which
    then serves both phases); each key of `scenario.shares` names the
    decode/adapter pool receiving that traffic fraction."""

    def __init__(self, scenario: Scenario, pools: List[SimPoolCfg],
                 planner: PoolPlanner, *,
                 ttft_slo_s: float = 2.0, itl_slo_s: float = 0.1,
                 goal: float = 0.99, dt: float = 1.0,
                 tick_interval_s: float = 15.0,
                 forecaster: Optional[Forecaster] = None):
        self.scenario = scenario
        self.planner = planner
        self.pools: Dict[str, _SimPool] = {
            cfg.spec.name: _SimPool(cfg) for cfg in pools}
        self.ttft_slo_s = ttft_slo_s
        self.itl_slo_s = itl_slo_s
        self.budget = max(1e-6, 1.0 - goal)
        self.dt = dt
        self.tick_interval_s = tick_interval_s
        self.fc = forecaster or Forecaster(bucket_s=HISTORY_BUCKET_S)
        prefills = [p for p in self.pools.values()
                    if p.spec.role in ("prefill", "aggregated")]
        if len(prefills) != 1:
            raise ValueError("the simulator needs exactly one prefill "
                             "(or aggregated) pool")
        self.prefill = prefills[0]
        for key in scenario.shares:
            if key not in self.pools:
                raise ValueError(f"scenario routes share {key!r} to a "
                                 "pool the simulator was not given")
        # seed the planner at the pools' starting replicas: adopting the
        # current scale is not a decision (mirrors operator restart)
        for name, pool in self.pools.items():
            planner.seed(name, pool.ready)
        self._arr_acc = 0.0
        self._share_acc = {k: 0.0 for k in scenario.shares}
        self._hist_req = 0.0
        self._hist_rows: List[Dict[str, float]] = []
        self._hist_bucket = 0
        self.scale_down_events: List[ScaleDownEvent] = []
        self.max_concurrent = 0.0
        self.requests_total = 0.0

    # ------------------------------------------------------------ history --
    def _bank_arrivals(self, now: float, n: float) -> None:
        idx = int(now // HISTORY_BUCKET_S)
        if idx > self._hist_bucket:
            self._hist_rows.append(
                {"t": self._hist_bucket * HISTORY_BUCKET_S,
                 "requests": self._hist_req})
            if len(self._hist_rows) > 360:
                del self._hist_rows[0]
            self._hist_req = 0.0
            self._hist_bucket = idx
        self._hist_req += n

    # --------------------------------------------------------------- step --
    def _arrive(self, now: float) -> None:
        rate = self.scenario.rate(now)
        self._arr_acc += rate * self.dt
        n = int(self._arr_acc)
        if n <= 0:
            return
        self._arr_acc -= n
        self._bank_arrivals(now, n)
        self.requests_total += n
        # deterministic proportional split across decode shares
        remaining = float(n)
        shares = list(self.scenario.shares.items())
        for i, (key, frac) in enumerate(shares):
            if i == len(shares) - 1:
                part = remaining
            else:
                self._share_acc[key] += n * frac
                part = int(self._share_acc[key])
                self._share_acc[key] -= part
                part = min(float(part), remaining)
            remaining -= part
            if part > 0:
                self.prefill.queue.append([part, now, key])

    def _serve_prefill(self, now: float) -> None:
        pool = self.prefill
        budget = pool.ready * pool.spec.capacity.prompts_per_s * self.dt
        samples = breaches = 0.0
        while budget > 1e-9 and pool.queue:
            cohort = pool.queue[0]
            served = min(cohort[0], budget)
            cohort[0] -= served
            budget -= served
            ttft = (now + self.dt) - cohort[1]
            samples += served
            if ttft > self.ttft_slo_s:
                breaches += served
            # completed prompts become decode streams on the share's pool
            dst = self.pools[cohort[2]] \
                if cohort[2] in self.pools else pool
            dst.cohorts.append([served, float(self.scenario.osl)])
            if cohort[0] <= 1e-9:
                pool.queue.popleft()
        pool.stats.requests_total += samples
        pool.stats.requests_breached += breaches
        pool.bank_burn(now, samples, breaches)

    def _serve_decode(self, now: float, pool: _SimPool) -> None:
        streams = pool.streams()
        pool.stats.max_streams = max(pool.stats.max_streams, streams)
        if streams <= 0:
            pool.bank_burn(now, 0.0, 0.0)
            return
        cap = pool.spec.capacity
        nominal = 1.0 / max(cap.itl_s, 1e-9) if cap.itl_s > 0 \
            else cap.tokens_per_s / max(cap.max_streams, 1)
        capacity_tok = max(pool.ready, 0) * cap.tokens_per_s
        rate = min(nominal, capacity_tok / streams) if streams > 0 else 0.0
        delivered = streams * rate * self.dt
        achieved_itl = (1.0 / rate) if rate > 0 else float("inf")
        breached = delivered if achieved_itl > self.itl_slo_s else 0.0
        if rate <= 0:
            # fully stalled pool: every waiting stream is breaching —
            # bank one "sample" per stream-second so the burn signal and
            # the attainment math both see the outage
            delivered = 0.0
            samples = streams * self.dt / max(self.itl_slo_s, 1e-9)
            pool.stats.tokens_total += samples
            pool.stats.tokens_breached += samples
            pool.bank_burn(now, samples, samples)
            return
        pool.stats.tokens_total += delivered
        pool.stats.tokens_breached += breached
        pool.bank_burn(now, delivered, breached)
        done = 0.0
        keep = []
        for cohort in pool.cohorts:
            cohort[1] -= rate * self.dt
            if cohort[1] <= 1e-9:
                done += cohort[0]
            else:
                keep.append(cohort)
        pool.cohorts = keep
        pool.stats.completed_streams += done

    # ---------------------------------------------------------- actuation --
    def _actuate(self, name: str, target: int, now: float) -> None:
        pool = self.pools[name]
        total = pool.target_total
        while total < target:
            pool.provisioning.append(now + pool.cfg.provision_delay_s)
            total += 1
        while total > target:
            if pool.provisioning:
                # cancel a not-yet-ready replica: nothing to drain
                pool.provisioning.sort()
                pool.provisioning.pop()
                total -= 1
                continue
            if pool.ready <= 0:
                break
            victim_share = 1.0 / pool.ready
            pool.ready -= 1
            total -= 1
            dropped = 0.0
            if pool.cfg.hitless:
                # graceful drain: admission off, streams hand off to the
                # survivors (they stay in the shared cohort set), KV
                # demotes; the victim leaves after drain_s
                done_at = now + pool.cfg.drain_s
                pool.draining.append(done_at)
            else:
                # abrupt kill: the victim's share of streams dies
                done_at = now
                for cohort in pool.cohorts:
                    d = cohort[0] * victim_share
                    cohort[0] -= d
                    dropped += d
                pool.cohorts = [c for c in pool.cohorts if c[0] > 1e-9]
                pool.stats.dropped_streams += dropped
            self.scale_down_events.append(ScaleDownEvent(
                t=now, pool=name, drained=pool.cfg.hitless,
                done_at=done_at, dropped=dropped))

    # ------------------------------------------------------------ signals --
    def _signals(self, now: float) -> Dict[str, PoolSignals]:
        self.fc.ingest_history(self._hist_rows)
        horizon = max(p.spec.forecast_horizon_s
                      for p in self.pools.values())
        forecast = self.fc.forecast(horizon)
        rps = self.fc.rate()
        total_streams = sum(p.streams() for p in self.pools.values())
        out: Dict[str, PoolSignals] = {}
        for name, pool in self.pools.items():
            role = pool.spec.role
            burn = pool.fast_burn(self.budget)
            if role in ("prefill", "aggregated"):
                out[name] = PoolSignals(
                    role=role, queued=sum(c[0] for c in pool.queue),
                    inflight=total_streams, burn_ttft=burn, burn=burn,
                    rps=rps, forecast_rps=forecast, ts=now)
            else:
                out[name] = PoolSignals(
                    role=role, inflight=pool.streams(), burn_itl=burn,
                    burn=burn, rps=rps, forecast_rps=forecast, ts=now)
        return out

    # ---------------------------------------------------------------- run --
    def run(self) -> SimReport:
        now = 0.0
        next_tick = 0.0
        steps = int(round(self.scenario.duration_s / self.dt))
        for _ in range(steps):
            for pool in self.pools.values():
                pool.settle(now)
            self._arrive(now)
            self._serve_prefill(now)
            for pool in self.pools.values():
                if pool.spec.role in ("decode", "adapter") or (
                        pool is self.prefill
                        and pool.spec.role == "aggregated"):
                    self._serve_decode(now, pool)
            concurrent = sum(p.streams() for p in self.pools.values())
            self.max_concurrent = max(self.max_concurrent, concurrent)
            for pool in self.pools.values():
                pool.stats.replica_seconds += pool.ready * self.dt
                pool.stats.peak_replicas = max(pool.stats.peak_replicas,
                                               pool.ready)
            if now >= next_tick:
                targets = self.planner.tick(self._signals(now), now)
                for name, target in targets.items():
                    self._actuate(name, target, now)
                next_tick = now + self.tick_interval_s
            now += self.dt
        return SimReport(
            scenario=self.scenario.name,
            coordinate=self.planner.coordinate,
            duration_s=self.scenario.duration_s,
            pool_stats={n: p.stats for n, p in self.pools.items()},
            decisions=[d.to_dict() for d in self.planner.journal],
            scale_down_events=self.scale_down_events,
            max_concurrent_streams=self.max_concurrent,
            requests_total=self.requests_total,
            final_replicas={n: p.ready + len(p.provisioning)
                            for n, p in self.pools.items()},
        )
