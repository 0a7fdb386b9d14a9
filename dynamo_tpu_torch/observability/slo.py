"""Declarative SLOs + multi-window burn-rate tracking.

The observability substrate planner v2 and per-tenant QoS consume
(ROADMAP: coordinated SLA autoscaling / "Taming the Chaos", arxiv
2508.19559 — disaggregated autoscaling must be driven by per-pool SLO
burn, not raw load):

- **Targets** are declarative: TTFT / ITL / error-rate objectives per
  model (full ``<base>:<adapter>`` ids address adapter SLOs) and disagg
  role, loaded from env (`DYNAMO_TPU_SLO_*`) — the operator materializes
  the manifest's ``sloTargets`` key into exactly these envs
  (operator/materialize.slo_env).
- **Burn rate** is computed FROM the existing latency histograms
  (serving/metrics.py): the engine snapshots each histogram's cumulative
  counts on every tick and banks the deltas into fixed-width time
  buckets; a window's burn rate is
  ``(breaching fraction over the window) / error budget`` where the
  budget is ``1 - goal`` for latency objectives and the allowed rate
  itself for error-rate objectives. Burn 1.0 = exactly consuming budget;
  >1.0 = the SLO is burning down. No new instrumentation rides the hot
  path.
- **Determinism**: the clock is injectable (`clock=`), so CI drives the
  whole 5m/1h window machinery with fake time (tests/test_slo.py, per
  the ROADMAP's deterministic-simulation constraint).
- **Request-rate history**: a bounded ring of per-bucket request counts
  (`GET /debug/slo?history=1`) — planner v2's traffic-forecasting input.

Exposed as `dynamo_slo_attainment` / `dynamo_slo_burn_rate` gauges
(labels: slo, objective, window, model, role) refreshed at scrape time,
plus the `GET /debug/slo` JSON endpoint on the frontend and every worker.

The port's own copy of `dynamo_tpu/observability/slo.py`
(it imports nothing of the JAX package); keep the two in step.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from dynamo_tpu_torch.serving.metrics import FrontendMetrics, Gauge

log = logging.getLogger("dynamo_tpu_torch.slo")

# multi-window sliding burn rate: the fast window catches an active burn
# inside one autoscaler reaction time; the slow window filters blips
DEFAULT_WINDOWS_S = (300, 3600)
WINDOW_LABELS = {300: "5m", 3600: "1h"}
DEFAULT_BUCKET_S = 10
DEFAULT_HISTORY_BUCKETS = 360  # 1h of request-rate history at 10s buckets

TARGETS_ENV = "DYNAMO_TPU_SLO_TARGETS"
SCALAR_ENVS = {  # the one-default-target shorthand
    "DYNAMO_TPU_SLO_TTFT_MS": "ttft_ms",
    "DYNAMO_TPU_SLO_ITL_MS": "itl_ms",
    "DYNAMO_TPU_SLO_ERROR_RATE": "error_rate",
    "DYNAMO_TPU_SLO_GOAL": "goal",
}
_TARGET_KEYS = {  # accepted spec keys, camelCase (manifest) and snake_case
    "model": "model", "role": "role", "name": "name", "goal": "goal",
    "tenant": "tenant",
    "ttft_ms": "ttft_ms", "ttftMs": "ttft_ms",
    "itl_ms": "itl_ms", "itlMs": "itl_ms",
    "error_rate": "error_rate", "errorRate": "error_rate",
}


@dataclasses.dataclass(frozen=True)
class SLOTarget:
    """One declarative objective set. `model`/`role`/`tenant` are
    exact-match selectors ('*' = any); a '<base>:<adapter>' model selects
    the adapter's own latency series on the frontend. A non-wildcard
    `tenant` selects the per-tenant latency series
    (``dynamo_tenant_*``, dynamo_tpu.qos) instead of the model-labeled
    ones — the signal the QoS plane's burn-aware admission and the
    isolation chaos tests consume. Tenant selectors apply to the latency
    objectives only (there is no per-tenant error counter), so an
    error_rate on a tenant-scoped target emits no rows."""

    model: str = "*"
    role: str = "*"          # frontend | agg | prefill | decode | *
    tenant: str = "*"        # per-tenant QoS selector (dynamo_tpu.qos)
    ttft_ms: Optional[float] = None
    itl_ms: Optional[float] = None
    error_rate: Optional[float] = None
    goal: float = 0.99       # attainment objective for the latency SLOs
    name: str = ""

    def matches_model(self, model: str) -> bool:
        return self.model in ("*", model)

    def matches_role(self, role: str) -> bool:
        return self.role in ("*", role)

    @property
    def label(self) -> str:
        if self.name:
            return self.name
        parts = [p for p in (self.model, self.tenant, self.role)
                 if p != "*"]
        return "/".join(parts) or "default"

    def objectives(self) -> List[Tuple[str, float, float]]:
        """(objective, threshold, error budget) triplets. Latency budgets
        come from the attainment goal; the error-rate budget IS the target
        rate."""
        goal = min(max(self.goal, 0.0), 0.9999)
        out = []
        if self.ttft_ms is not None:
            out.append(("ttft", self.ttft_ms / 1e3, 1.0 - goal))
        if self.itl_ms is not None:
            out.append(("itl", self.itl_ms / 1e3, 1.0 - goal))
        if self.error_rate is not None and self.error_rate > 0:
            out.append(("error_rate", 0.0, self.error_rate))
        return out

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        return {k: v for k, v in d.items() if v not in (None, "")}


def target_from_dict(spec: Mapping[str, Any]) -> SLOTarget:
    """Validate one target spec (manifest or env JSON); unknown keys fail
    loudly so typos don't silently disable an SLO."""
    unknown = set(spec) - set(_TARGET_KEYS)
    if unknown:
        raise ValueError(f"unknown sloTargets keys: {sorted(unknown)}")
    kw: Dict[str, Any] = {}
    for k, v in spec.items():
        field = _TARGET_KEYS[k]
        if field in ("model", "role", "name", "tenant"):
            kw[field] = str(v)
        else:
            kw[field] = float(v)
    return SLOTarget(**kw)


def targets_from_env(env: Optional[Mapping[str, str]] = None
                     ) -> List[SLOTarget]:
    """DYNAMO_TPU_SLO_TARGETS (JSON list of target specs) plus the scalar
    shorthand envs (one wildcard target). Malformed specs are logged and
    skipped — SLO config must never stop a worker from serving."""
    env = os.environ if env is None else env
    out: List[SLOTarget] = []
    raw = env.get(TARGETS_ENV)
    if raw:
        try:
            specs = json.loads(raw)
            if not isinstance(specs, list):
                raise ValueError("must be a JSON list")
            for spec in specs:
                out.append(target_from_dict(spec))
        except (ValueError, TypeError) as e:
            log.warning("ignoring malformed %s: %s", TARGETS_ENV, e)
    scalars: Dict[str, float] = {}
    # one read per literal name (not a SCALAR_ENVS loop) so the
    # env-registry lint can see each knob at its read site
    for field, v in (("ttft_ms", env.get("DYNAMO_TPU_SLO_TTFT_MS")),
                     ("itl_ms", env.get("DYNAMO_TPU_SLO_ITL_MS")),
                     ("error_rate", env.get("DYNAMO_TPU_SLO_ERROR_RATE")),
                     ("goal", env.get("DYNAMO_TPU_SLO_GOAL"))):
        if v:
            try:
                scalars[field] = float(v)
            except ValueError:
                log.warning("ignoring non-numeric SLO scalar %s=%r",
                            field, v)
    if set(scalars) - {"goal"}:
        out.append(SLOTarget(**scalars))
    return out


class SLOEngine:
    """Sliding-window SLO attainment/burn computed from histogram deltas.

    One instance per serving process (frontend or worker). All state is
    in-memory and bounded: ``max(window) / bucket_s`` time buckets plus
    the request-rate history ring."""

    def __init__(self, metrics: FrontendMetrics, role: str,
                 targets: Optional[Sequence[SLOTarget]] = None,
                 clock=time.time,
                 bucket_s: int = DEFAULT_BUCKET_S,
                 windows_s: Sequence[int] = DEFAULT_WINDOWS_S,
                 history_buckets: int = DEFAULT_HISTORY_BUCKETS):
        self.metrics = metrics
        self.role = role
        self.targets = list(targets if targets is not None
                            else targets_from_env())
        self.clock = clock
        self.bucket_s = max(1, int(bucket_s))
        self.windows_s = tuple(sorted(windows_s))
        depth = max(max(self.windows_s) // self.bucket_s, history_buckets)
        # each bucket: {"idx": int, "requests": int,
        #               "data": {(target_i, objective): [total, breaches]}}
        self._buckets: "collections.deque" = collections.deque(maxlen=depth)
        self.history_buckets = history_buckets
        self._cur: Optional[Dict[str, Any]] = None
        # cumulative snapshots keyed (target_i, objective, series labels)
        self._last: Dict[tuple, Tuple[float, float]] = {}
        # (target_i, objective) pairs that have ever matched an observed
        # series — selectors that never match real traffic emit no rows
        # (a typo'd model selector shows up as a MISSING series, not a
        # perpetually-green one)
        self._matched: set = set()
        self._last_requests = 0.0
        self._lock = threading.Lock()
        r = metrics.registry
        labelnames = ("slo", "objective", "window", "model", "role",
                      "tenant")
        self.attainment_gauge = Gauge(
            "dynamo_slo_attainment",
            "Fraction of requests meeting the SLO objective over the "
            "window (1.0 with no traffic)", r, labelnames=labelnames)
        self.burn_gauge = Gauge(
            "dynamo_slo_burn_rate",
            "SLO error-budget burn rate over the window (>1.0 = the "
            "objective's budget is burning down)", r, labelnames=labelnames)

    # ------------------------------------------------------------- ticking --
    def _advance(self, now: float) -> None:
        idx = int(now // self.bucket_s)
        if self._cur is None:
            self._cur = {"idx": idx, "requests": 0, "data": {}}
            return
        if idx < self._cur["idx"]:
            return  # clock went backwards: hold the current bucket
        jump = idx - self._cur["idx"]
        maxlen = self._buckets.maxlen or 1
        if jump > maxlen:
            # a huge gap (suspend, fake-clock leap): every old bucket is
            # out of any window — drop them instead of filling the gap
            self._buckets.clear()
            self._cur = {"idx": idx, "requests": 0, "data": {}}
            return
        while self._cur["idx"] < idx:
            self._buckets.append(self._cur)
            self._cur = {"idx": self._cur["idx"] + 1, "requests": 0,
                         "data": {}}

    def _bank(self, ti: int, objective: str, series_key: tuple,
              total: float, breaches: float) -> None:
        """Delta one series' cumulative (total, breaches) into the current
        bucket."""
        self._matched.add((ti, objective))
        key = (ti, objective, series_key)
        p_tot, p_breach = self._last.get(key, (0.0, 0.0))
        d_tot, d_breach = total - p_tot, breaches - p_breach
        self._last[key] = (total, breaches)
        if d_tot <= 0 and d_breach <= 0:
            return
        cell = self._cur["data"].setdefault((ti, objective), [0.0, 0.0])
        cell[0] += max(d_tot, 0.0)
        cell[1] += max(d_breach, 0.0)

    def _collect(self) -> None:
        m = self.metrics
        # request-rate history (planner v2 forecasting input)
        req_total = sum(m.requests_total.values().values())
        d_req = req_total - self._last_requests
        self._last_requests = req_total
        if d_req > 0:
            self._cur["requests"] += int(d_req)
        err_by_model: Dict[str, float] = {}
        for lbl, v in m.errors_total.values().items():
            model = dict(lbl).get("model", "")
            err_by_model[model] = err_by_model.get(model, 0.0) + v
        req_by_model: Dict[str, float] = {}
        for lbl, v in m.requests_total.values().items():
            model = dict(lbl).get("model", "")
            req_by_model[model] = req_by_model.get(model, 0.0) + v
        for ti, t in enumerate(self.targets):
            if not t.matches_role(self.role):
                continue
            tenant_scoped = t.tenant != "*"
            for objective, threshold_s, _budget in t.objectives():
                if objective == "error_rate":
                    if tenant_scoped:
                        continue  # no per-tenant error counter (docstring)
                    for model, reqs in req_by_model.items():
                        if not t.matches_model(model):
                            continue
                        self._bank(ti, objective, ("model", model),
                                   reqs, err_by_model.get(model, 0.0))
                    continue
                if tenant_scoped:
                    # per-tenant QoS selector: the tenant-labeled latency
                    # series (dynamo_tenant_*) are the source, so one
                    # tenant's tail can't hide in the model aggregate
                    hist = (m.tenant_ttft if objective == "ttft"
                            else m.tenant_itl)
                    for lbl, (good, total) in hist.good_total(
                            threshold_s).items():
                        if dict(lbl).get("tenant", "") != t.tenant:
                            continue
                        self._bank(ti, objective, lbl, total, total - good)
                    continue
                hist = m.ttft if objective == "ttft" else m.itl
                for lbl, (good, total) in hist.good_total(threshold_s).items():
                    model = dict(lbl).get("model", "")
                    if not t.matches_model(model):
                        continue
                    self._bank(ti, objective, lbl, total, total - good)

    def tick(self, now: Optional[float] = None) -> None:
        """Advance the bucket clock and bank histogram deltas. Called at
        scrape/debug time (and by tests under fake clocks) — between ticks
        the histograms accumulate on their own."""
        with self._lock:
            self._advance(self.clock() if now is None else now)
            self._collect()

    # ---------------------------------------------------------- evaluation --
    def _window_sum(self, window_s: int, ti: int, objective: str
                    ) -> Tuple[float, float]:
        n = max(1, window_s // self.bucket_s)
        lo = self._cur["idx"] - n  # buckets with idx > lo are in-window
        tot = br = 0.0
        cell = self._cur["data"].get((ti, objective))
        if cell:
            tot, br = cell[0], cell[1]
        for b in self._buckets:
            if b["idx"] > lo:
                cell = b["data"].get((ti, objective))
                if cell:
                    tot += cell[0]
                    br += cell[1]
        return tot, br

    def evaluate(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """Attainment + burn rate per (target, objective, window)."""
        self.tick(now)
        out: List[Dict[str, Any]] = []
        with self._lock:
            for ti, t in enumerate(self.targets):
                if not t.matches_role(self.role):
                    continue
                for objective, threshold_s, budget in t.objectives():
                    if (ti, objective) not in self._matched:
                        continue
                    for w in self.windows_s:
                        tot, br = self._window_sum(w, ti, objective)
                        frac = (br / tot) if tot > 0 else 0.0
                        out.append({
                            "slo": t.label,
                            "objective": objective,
                            "window": WINDOW_LABELS.get(w, f"{w}s"),
                            "window_s": w,
                            "model": t.model,
                            "tenant": t.tenant,
                            "role": self.role,
                            "threshold_s": threshold_s,
                            "requests": int(tot),
                            "breaches": int(br),
                            "attainment": round(1.0 - frac, 6),
                            "burn_rate": round(frac / budget, 4)
                            if budget > 0 else 0.0,
                        })
        return out

    def refresh_gauges(self, now: Optional[float] = None) -> None:
        """Scrape-time gauge refresh (the /metrics handlers call this)."""
        for row in self.evaluate(now):
            labels = dict(slo=row["slo"], objective=row["objective"],
                          window=row["window"], model=row["model"],
                          role=row["role"], tenant=row["tenant"])
            self.attainment_gauge.set(row["attainment"], **labels)
            self.burn_gauge.set(row["burn_rate"], **labels)

    # ------------------------------------------------------------- history --
    def history(self) -> List[Dict[str, Any]]:
        """Per-bucket request counts, oldest first, current partial bucket
        last — exact counts, not rates (the forecaster derives rates)."""
        with self._lock:
            rows = [{"t": b["idx"] * self.bucket_s, "requests": b["requests"]}
                    for b in self._buckets]
            if self._cur is not None:
                rows.append({"t": self._cur["idx"] * self.bucket_s,
                             "requests": self._cur["requests"],
                             "partial": True})
        return rows[-self.history_buckets:]

    def debug_payload(self, include_history: bool = False) -> Dict[str, Any]:
        """The GET /debug/slo body (frontend + worker servers)."""
        payload: Dict[str, Any] = {
            "role": self.role,
            "bucket_s": self.bucket_s,
            "windows_s": list(self.windows_s),
            "targets": [t.to_dict() for t in self.targets],
            "evaluations": self.evaluate(),
        }
        if include_history:
            payload["history"] = self.history()
        return payload


def debug_slo_payload(engine: Optional[SLOEngine],
                      qs: Mapping[str, List[str]]) -> Dict[str, Any]:
    """Shared /debug/slo handler body: honors ?history=1."""
    if engine is None:
        return {"targets": [], "evaluations": [],
                "note": "no SLO engine attached"}
    want_history = (qs.get("history") or ["0"])[0] not in ("0", "", "false")
    return engine.debug_payload(include_history=want_history)
