"""Planner v2 signal plane: per-pool scrape + short-horizon forecast.

Inputs per pool (one pool = one DGD service with a role):

- the frontend queued-requests gauge (proportional backpressure),
- the fast-window SLO burn rates split by objective — TTFT burn drives
  prefill pools, ITL burn drives decode pools (observability/slo.py),
- per-tenant inflight gauges (dynamo_tpu_torch.qos) so adapter-pinned /
  tenant-skewed pools see *their* demand, not the aggregate,
- the `/debug/slo?history=1` request-rate ring, the forecasting
  input: a bounded list of per-bucket request counts.

The forecaster is Holt's linear exponential smoothing (EWMA level +
trend) over the ring — deliberately simple: the planner needs one
provisioning-delay of lead time, not a weather model. Everything takes an
injectable clock and an injectable fetcher so CI drives it without
sockets.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import re
import threading
import time
import urllib.request
from typing import Any, Dict, List, Mapping, Optional, Tuple

log = logging.getLogger("dynamo_tpu_torch.planner")

# how long a last-good scrape may stand in for a failing one before the
# planner treats the pool's signals as unknown (hold the last decision)
DEFAULT_STALENESS_S = 60.0


@dataclasses.dataclass
class PoolSignals:
    """One pool's view of the world at a planner tick."""

    role: str = "aggregated"     # prefill | decode | aggregated | adapter
    queued: float = 0.0          # frontend queued requests (backpressure)
    inflight: float = 0.0        # active streams (decode demand proxy)
    burn_ttft: float = 0.0       # fast-window TTFT burn (prefill currency)
    burn_itl: float = 0.0        # fast-window ITL burn (decode currency)
    burn: float = 0.0            # worst fast-window burn, any objective
    rps: float = 0.0             # most recent observed arrival rate
    forecast_rps: float = 0.0    # short-horizon forecast (frontend ring)
    quarantined: int = 0         # watchdog-quarantined workers: replicas
    # that count against the Deployment's size but serve nothing — the
    # planner adds them to `want` so effective capacity stays whole
    tenant_inflight: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    ts: float = 0.0              # when scraped (staleness bookkeeping)
    stale: bool = False          # served from the last-good cache

    def burn_for_role(self, role: str) -> float:
        if role == "prefill":
            return self.burn_ttft
        if role in ("decode", "adapter"):
            return self.burn_itl
        return self.burn


class Forecaster:
    """Holt's linear smoothing over the request-rate history ring.

    `ingest_history` consumes NEW complete buckets from a
    `/debug/slo?history=1` payload (idempotent across overlapping rings:
    buckets at or before the last consumed timestamp are skipped), so the
    operator can re-scrape the whole ring every tick and the fit only
    advances. The trend unit is rps-per-bucket; `forecast` converts the
    horizon to bucket steps."""

    def __init__(self, alpha: float = 0.5, beta: float = 0.3,
                 bucket_s: float = 10.0):
        self.alpha = min(max(alpha, 0.0), 1.0)
        self.beta = min(max(beta, 0.0), 1.0)
        self.bucket_s = max(float(bucket_s), 1e-9)
        self.level: Optional[float] = None
        self.trend = 0.0
        self._last_t: Optional[float] = None

    def observe(self, rps: float) -> None:
        """One bucket-spaced rate sample."""
        rps = max(0.0, float(rps))
        if self.level is None:
            self.level = rps
            self.trend = 0.0
            return
        prev = self.level
        self.level = (self.alpha * rps
                      + (1.0 - self.alpha) * (self.level + self.trend))
        self.trend = (self.beta * (self.level - prev)
                      + (1.0 - self.beta) * self.trend)

    def ingest_history(self, rows: List[Mapping[str, Any]],
                       bucket_s: Optional[float] = None) -> int:
        """Feed new complete buckets from a history ring; returns how many
        were consumed. Partial (current) buckets are skipped — they would
        read as a rate dip every tick."""
        if bucket_s:
            self.bucket_s = float(bucket_s)
        consumed = 0
        for row in rows or []:
            if row.get("partial"):
                continue
            try:
                t = float(row["t"])
                n = float(row.get("requests", 0))
            except (KeyError, TypeError, ValueError):
                continue
            if self._last_t is not None and t <= self._last_t:
                continue
            self._last_t = t
            self.observe(n / self.bucket_s)
            consumed += 1
        return consumed

    def forecast(self, horizon_s: float) -> float:
        """Projected rps `horizon_s` ahead (level + trend, floored at 0)."""
        if self.level is None:
            return 0.0
        steps = max(0.0, float(horizon_s)) / self.bucket_s
        return max(0.0, self.level + self.trend * steps)

    def rate(self) -> float:
        """The smoothed current rate (0 before any sample)."""
        return self.level or 0.0


# ----------------------------------------------------------------- parsing --
_QUEUED_RE = re.compile(r"^dynamo_frontend_queued_requests(?:\{[^}]*\})?\s")
_BURN_RE = re.compile(r'^dynamo_slo_burn_rate\{([^}]*)\}\s')
_TENANT_INFLIGHT_RE = re.compile(r'^dynamo_tenant_inflight\{([^}]*)\}\s')
_WORKER_HEALTH_RE = re.compile(r'^dynamo_frontend_worker_health\{([^}]*)\}\s')
_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def _labels_of(raw: str) -> Dict[str, str]:
    return {m.group(1): m.group(2) for m in _LABEL_RE.finditer(raw)}


def parse_metrics_text(text: str) -> Dict[str, Any]:
    """Extract the planner's inputs from one Prometheus text page.

    Returns a dict with queued (None when the page carries no
    queued-requests gauge — a per-pool worker page), burn (worst
    fast-window), burn_ttft, burn_itl, inflight, tenant_inflight, and
    the watchdog fleet view (quarantined count + quarantined_workers
    URLs, from the frontend's per-worker health gauge). Only
    window="5m" burn rows count — the slow window is a paging signal,
    not a scaling one."""
    queued: Optional[float] = None
    burn = burn_ttft = burn_itl = 0.0
    inflight = 0.0
    quarantined = 0
    quarantined_workers: List[str] = []
    tenant_inflight: Dict[str, float] = {}
    for ln in text.splitlines():
        if _QUEUED_RE.match(ln):
            try:
                queued = float(ln.split()[-1])
            except ValueError:
                pass
            continue
        m = _WORKER_HEALTH_RE.match(ln)
        if m:
            # watchdog fleet view: 3 = quarantined (out of rotation for
            # good — its replica slot is dead capacity until replaced)
            try:
                if float(ln.split()[-1]) >= 3.0:
                    quarantined += 1
                    url = _labels_of(m.group(1)).get("worker")
                    if url:
                        quarantined_workers.append(url)
            except ValueError:
                pass
            continue
        m = _BURN_RE.match(ln)
        if m:
            lbl = _labels_of(m.group(1))
            if lbl.get("window") != "5m":
                continue
            try:
                v = float(ln.split()[-1])
            except ValueError:
                continue
            burn = max(burn, v)
            if lbl.get("objective") == "ttft":
                burn_ttft = max(burn_ttft, v)
            elif lbl.get("objective") == "itl":
                burn_itl = max(burn_itl, v)
            continue
        m = _TENANT_INFLIGHT_RE.match(ln)
        if m:
            try:
                v = float(ln.split()[-1])
            except ValueError:
                continue
            tenant = _labels_of(m.group(1)).get("tenant", "")
            tenant_inflight[tenant] = tenant_inflight.get(tenant, 0.0) + v
            inflight += v
    return {"queued": queued, "burn": burn, "burn_ttft": burn_ttft,
            "burn_itl": burn_itl, "inflight": inflight,
            "quarantined": quarantined,
            "quarantined_workers": quarantined_workers,
            "tenant_inflight": tenant_inflight}


def _default_fetch(url: str, timeout_s: float) -> str:
    with urllib.request.urlopen(url, timeout=timeout_s) as r:
        return r.read().decode("utf-8", "replace")


class SignalsCollector:
    """Scrape + cache layer for planner signals.

    One instance per controller. Every scrape failure falls back to the
    last good result for the same URL as long as it is within
    `staleness_s` (marked `stale`), and increments `scrape_errors_total`
    (exposed as `dynamo_planner_scrape_errors_total`) — one flaky pool
    must never blind the whole tick."""

    def __init__(self, fetch=None, clock=time.monotonic,
                 timeout_s: float = 1.5,
                 staleness_s: float = DEFAULT_STALENESS_S):
        self._fetch = fetch or _default_fetch
        self.clock = clock
        self.timeout_s = timeout_s
        self.staleness_s = staleness_s
        self.scrape_errors_total = 0
        self._lock = threading.Lock()
        # url -> (ts, payload); shared by metrics + history scrapes
        self._last_good: Dict[str, Tuple[float, Any]] = {}

    def _remember(self, url: str, payload: Any) -> Any:
        with self._lock:
            self._last_good[url] = (self.clock(), payload)
        return payload

    def recall(self, url: str) -> Optional[Any]:
        """The last-good payload for `url` if still within the staleness
        bound (marked stale), else None."""
        return self._recall(url)

    def _recall(self, url: str) -> Optional[Any]:
        with self._lock:
            got = self._last_good.get(url)
        if got is None:
            return None
        ts, payload = got
        if self.clock() - ts > self.staleness_s:
            return None  # too old to act on: hold the last decision
        if isinstance(payload, dict):
            payload = {**payload, "stale": True}
        return payload

    def _count_error(self, url: str, e: Exception) -> None:
        with self._lock:
            self.scrape_errors_total += 1
        log.debug("planner scrape failed for %s: %s", url, e)

    def scrape_metrics(self, url: str) -> Optional[Dict[str, Any]]:
        """Planner inputs from one /metrics page, with last-good fallback."""
        try:
            parsed = parse_metrics_text(self._fetch(url, self.timeout_s))
        except Exception as e:  # noqa: BLE001 — network scrape boundary
            self._count_error(url, e)
            return self._recall(url)
        return self._remember(url, parsed)

    def scrape_history(self, url: str) -> Optional[Dict[str, Any]]:
        """The `/debug/slo?history=1` JSON payload ({bucket_s, history}),
        with the same last-good/staleness posture as metrics."""
        try:
            payload = json.loads(self._fetch(url, self.timeout_s))
            if not isinstance(payload, dict):
                raise ValueError("history payload must be a JSON object")
        except Exception as e:  # noqa: BLE001
            self._count_error(url, e)
            return self._recall(url)
        return self._remember(url, payload)
