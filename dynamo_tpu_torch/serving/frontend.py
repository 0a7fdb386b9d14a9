"""Frontend: OpenAI-compatible HTTP entrypoint that routes to engine workers.

The port's own copy of `dynamo_tpu/serving/frontend.py` (it imports
nothing of the JAX package); keep the two in step. The one addition: the
port reports whether its native router core loaded
(`runtime/native.router_status`), in the log at start and under "router"
in `/internal/workers`, since a pick that quietly ran in Python would hide
a broken build.

The equivalent of the reference's consumed Dynamo frontend/router
pod (every DGD manifest's `Frontend` service,
reference examples/deploy/vllm/agg.yaml:12-17). Responsibilities:
- serve /v1/models (union of registered workers) and proxy
  /v1/chat/completions + /v1/completions with SSE passthrough;
- KV-affinity routing via serving.router.Router (HRW prefix hashing);
- worker membership via HTTP heartbeats (POST /internal/register) — the
  lightweight stand-in for the reference's etcd registry + NATS request plane
  (SURVEY.md §2d); an etcd-backed registry can be swapped in via
  dynamo_tpu_torch.serving.registry;
- emit the dynamo_frontend_* metric contract at /metrics.
"""

from __future__ import annotations

import http.client
import json
import logging
import os
import socket
import threading
import time
import urllib.error
import urllib.request
from typing import List, Optional

from dynamo_tpu_torch.observability import context as obs_context
from dynamo_tpu_torch.observability import slo as obs_slo
from dynamo_tpu_torch.observability import tracing as obs_tracing
from dynamo_tpu_torch.qos import tenancy as qos_tenancy
from dynamo_tpu_torch.robustness import faults
from dynamo_tpu_torch.robustness.breaker import STATE_CODES
from dynamo_tpu_torch.robustness.watchdog import HEALTH_CODES as WD_HEALTH_CODES
from dynamo_tpu_torch.robustness.deadline import Deadline
from dynamo_tpu_torch.runtime import native
from dynamo_tpu_torch.serving import ha
from dynamo_tpu_torch.serving import protocol as proto
from dynamo_tpu_torch.serving import recovery
from dynamo_tpu_torch.serving.http_base import JsonHTTPHandler, make_http_server
from dynamo_tpu_torch.serving.metrics import FrontendMetrics, Gauge
from dynamo_tpu_torch.serving.router import Router, prefix_key, split_adapter
from dynamo_tpu_torch.utils import net

log = logging.getLogger("dynamo_tpu_torch.frontend")

# admission control: bound on concurrently proxied requests; overflow is
# answered 429 + Retry-After instead of queueing unboundedly (0 = off)
MAX_INFLIGHT_ENV = "DYNAMO_TPU_MAX_INFLIGHT"
DEFAULT_MAX_INFLIGHT = 256
# per-tenant QoS: shed over-share tenants when any matching SLO's fast
# window burns above this rate (0 disables; only meaningful with tenants
# configured AND SLO targets declared — docs/robustness.md)
BURN_SHED_ENV = "DYNAMO_TPU_QOS_BURN_SHED"
DEFAULT_BURN_SHED = 2.0
# preemptible batch tier: the tenant burn gate INVERTED — batch-class
# tenants admit only while every interactive SLO fast window burns BELOW
# this rate (interactive load is quiet); at/above it new batch work is
# paused with 429 batch_paused (0 disables the gate — batch admits like
# any tenant; docs/robustness.md "Preemptible batch tier")
BATCH_BURN_ADMIT_ENV = "DYNAMO_TPU_BATCH_BURN_ADMIT"
DEFAULT_BATCH_BURN_ADMIT = 1.0


def _env_max_inflight() -> int:
    try:
        return max(0, int(os.environ.get(MAX_INFLIGHT_ENV,
                                         DEFAULT_MAX_INFLIGHT)))
    except ValueError:
        return DEFAULT_MAX_INFLIGHT


def _env_burn_shed() -> float:
    try:
        return max(0.0, float(os.environ.get(BURN_SHED_ENV,
                                             DEFAULT_BURN_SHED)))
    except ValueError:
        return DEFAULT_BURN_SHED


def _env_batch_burn_admit() -> float:
    try:
        return max(0.0, float(os.environ.get(BATCH_BURN_ADMIT_ENV,
                                             DEFAULT_BATCH_BURN_ADMIT)))
    except ValueError:
        return DEFAULT_BATCH_BURN_ADMIT

# re-export: requests slower than this log a WARNING carrying their trace
# id — the exemplar-style bridge from the dynamo_frontend_* latency series
# to /debug/spans?trace_id=... (see docs/observability.md)
slow_request_threshold_s = obs_tracing.slow_request_threshold_s


class FrontendContext:
    def __init__(self, router: Optional[Router] = None,
                 nats_url: Optional[str] = None,
                 max_inflight: Optional[int] = None,
                 gossip_interval_s: Optional[float] = None):
        self.router = router or Router()
        # whether picks run in the native router core (built here on
        # first use) or in the bit-identical Python loop
        self.router_core = native.router_status()
        if self.router_core["native_router"]:
            log.info("native router core loaded")
        else:
            log.warning("native router core NOT loaded (%s); picks run in "
                        "python", self.router_core["native_router_error"])
        self.metrics = FrontendMetrics()
        self.worker_gauge = Gauge(
            "dynamo_frontend_workers", "Registered live workers",
            self.metrics.registry,
        )
        # live elasticity: fleet rollout progress at a glance — how many
        # live workers heartbeat each weight version (label death keeps
        # finished rollouts from leaving a zero-worker version row)
        self.worker_version_gauge = Gauge(
            "dynamo_frontend_worker_weight_version",
            "Live workers by heartbeat-reported weight version",
            self.metrics.registry, labelnames=("version",),
        )
        self._version_labels: set = set()
        from dynamo_tpu_torch.serving.metrics import Counter

        self.ledger_counter = Counter(
            "dynamo_frontend_kv_overlap_routed_total",
            "Requests routed by the KV-overlap prefix ledger",
            self.metrics.registry,
        )
        self.router.ledger_counter = self.ledger_counter
        # --- KV event plane (dynamo_tpu_torch.kvbm.events) ---
        self.kv_index_counter = Counter(
            "dynamo_frontend_kv_event_index_routed_total",
            "Requests routed by the worker-published KV event index",
            self.metrics.registry,
        )
        self.router.kv_index_counter = self.kv_index_counter
        self.kv_events_counter = Counter(
            "dynamo_frontend_kv_events_total",
            "Worker KV cache events received on the event plane",
            self.metrics.registry,
        )
        self.kv_index_gauge = Gauge(
            "dynamo_frontend_kv_event_index_blocks",
            "Blocks tracked by the KV event index", self.metrics.registry,
        )
        # --- robustness plane (docs/robustness.md) ---
        self.max_inflight = (max_inflight if max_inflight is not None
                             else _env_max_inflight())
        # --- per-tenant QoS (dynamo_tpu_torch.qos; docs/robustness.md
        # "Per-tenant QoS") --- tenant classes from DYNAMO_TPU_TENANTS;
        # admission becomes per-tenant: weighted in-flight caps, SLO-burn
        # shedding of over-share tenants, and a Retry-After derived from
        # the shed tenant's own budget-refill time. With no tenants
        # configured everything resolves to "default" and only the global
        # bound applies — byte-identical to the pre-QoS frontend.
        self.tenants = qos_tenancy.TenantRegistry.from_env()
        self.tenant_admission = qos_tenancy.TenantAdmission(
            self.tenants, self.max_inflight)
        self.burn_shed_threshold = _env_burn_shed()
        self.batch_burn_admit = _env_batch_burn_admit()
        self._burn_cache: Optional[tuple] = None  # (monotonic ts, rows)
        self.admission_rejected = Counter(
            "dynamo_frontend_admission_rejected_total",
            "Requests shed with 429 by admission control, by tenant and "
            "reason (inflight = per-tenant weighted cap; budget = global "
            "in-flight bound; slo_burn = SLO fast-burn shed of an "
            "over-share tenant; batch_paused = batch-class tenant held "
            "back while interactive SLO burn is hot)",
            self.metrics.registry, labelnames=("tenant", "reason"),
        )
        self.tenant_inflight_gauge = Gauge(
            "dynamo_tenant_inflight",
            "In-flight proxied requests by tenant",
            self.metrics.registry, labelnames=("tenant",),
        )
        self.deadline_shed = Counter(
            "dynamo_frontend_deadline_shed_total",
            "Requests shed with 504 because their deadline budget was "
            "exhausted before a worker answered",
            self.metrics.registry,
        )
        self.expired_counter = Counter(
            "dynamo_frontend_worker_expired_total",
            "Workers purged because their registration refresh lapsed, by "
            "the registration path that went quiet (direct = the worker's "
            "own heartbeat; peer = another frontend's NATS worker-gossip "
            "relay; etcd = a registry merge record)",
            self.metrics.registry, labelnames=("reason",),
        )
        self.router.expired_counter = self.expired_counter
        self.breaker_open_counter = Counter(
            "dynamo_frontend_breaker_open_total",
            "Circuit-breaker open transitions (threshold trips and failed "
            "half-open probes)",
            self.metrics.registry, labelnames=("worker",),
        )
        self.breaker_gauge = Gauge(
            "dynamo_frontend_breaker_state",
            "Per-worker circuit-breaker state (0=closed 1=half_open 2=open)",
            self.metrics.registry, labelnames=("worker",),
        )
        self.worker_health_gauge = Gauge(
            "dynamo_frontend_worker_health",
            "Per-worker engine health from heartbeats (0=healthy "
            "1=suspect 2=resurrecting 3=quarantined) — the fleet view "
            "the planner excludes quarantined capacity with",
            self.metrics.registry, labelnames=("worker",),
        )
        # --- request recovery plane (serving/recovery.py) ---
        self.recovered_counter = Counter(
            "dynamo_frontend_recovered_total",
            "Requests recovered after a worker failure, by phase (connect "
            "= pre-send failover re-pick; stream = mid-stream journaled "
            "continuation spliced onto the same client stream)",
            self.metrics.registry, labelnames=("phase",),
        )
        self.router.breakers.on_open = (
            lambda url: self.breaker_open_counter.inc(worker=url))
        self.tracer = obs_tracing.Tracer("frontend")
        # --- SLO plane (observability/slo.py): multi-window burn rate from
        # the latency histograms above; targets from DYNAMO_TPU_SLO_* (the
        # operator materializes the manifest's sloTargets key into them)
        self.slo = obs_slo.SLOEngine(self.metrics, role="frontend")
        from dynamo_tpu_torch.serving.metrics import CallbackCounter

        CallbackCounter(
            "dynamo_spans_dropped_total",
            "Finished spans evicted from the ring buffer before any "
            "scrape could lift them (size: DYNAMO_TPU_TRACE_BUFFER)",
            self.metrics.registry,
            lambda: self.tracer.collector.dropped_total,
        )
        # in-flight request tracking feeds the queued-requests gauge the
        # operator's planner scrapes for autoscaling
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self.start_time = time.time()
        # NATS request plane (the reference's frontend<->worker transport,
        # reference install-dynamo-1node.sh:241-242); HTTP remains the
        # fallback when the plane is down or unset
        self.nats = None
        # --- HA frontend plane (serving/ha.py; docs/robustness.md "HA
        # frontend plane") — replicated journal, resume claims, gossiped
        # tenant counters, worker-membership relay. All of it rides the
        # NATS plane; without a nats_url this frontend is standalone and
        # behaves byte-identically to the pre-HA stack.
        self.frontend_id = ha.frontend_id()
        self.journal_plane: Optional[ha.JournalPlane] = None
        self.tenant_gossip: Optional[ha.TenantGossip] = None
        self.worker_gossip: Optional[ha.WorkerGossip] = None
        self.draining = False  # flipped by SIGTERM; /healthz goes 503
        self.ha_journal_records = Counter(
            "dynamo_frontend_ha_journal_records_total",
            "Recovery-journal records re-published to / applied from the "
            "NATS journal plane, by direction",
            self.metrics.registry, labelnames=("direction",),
        )
        self.ha_journal_streams = Gauge(
            "dynamo_frontend_ha_journal_streams",
            "Streams tracked in the replicated journal store",
            self.metrics.registry,
        )
        self.ha_resumes = Counter(
            "dynamo_frontend_ha_resumes_total",
            "Cross-frontend stream resume attempts by outcome (resumed | "
            "unknown = no journal record for the response id | stale_cursor "
            "= record behind the client's delivered chars | invalid = "
            "n-gap/missing start record | completed = stream already done | "
            "lost_claim = another frontend won the resume | no_worker)",
            self.metrics.registry, labelnames=("outcome",),
        )
        self.ha_gossip = Counter(
            "dynamo_frontend_ha_gossip_messages_total",
            "Tenant-counter gossip snapshots by direction",
            self.metrics.registry, labelnames=("direction",),
        )
        self.ha_peer_frontends = Gauge(
            "dynamo_frontend_ha_peer_frontends",
            "Peer frontends with a fresh tenant-gossip snapshot",
            self.metrics.registry,
        )
        self.ha_peer_inflight = Gauge(
            "dynamo_frontend_ha_peer_inflight",
            "Gossiped peer-replica in-flight requests by tenant",
            self.metrics.registry, labelnames=("tenant",),
        )
        if nats_url:
            from dynamo_tpu_torch.serving.nats import NatsClient

            self.nats = NatsClient(nats_url, name="frontend")
            # KV event plane: workers publish block stored/demoted/removed
            # events; the router's KVEventIndex turns them into the
            # primary kv_overlap routing source (ledger = fallback)
            self.nats.subscribe("dynamo.kv_events.>", self._on_kv_event)
            self.journal_plane = ha.JournalPlane(self.nats, self.frontend_id)
            self.journal_plane.published_counter = self.ha_journal_records
            self.journal_plane.applied_counter = self.ha_journal_records
            self.tenant_gossip = ha.TenantGossip(
                self.nats, self.frontend_id, self.tenant_admission,
                interval_s=gossip_interval_s)
            self.tenant_gossip.gossip_counter = self.ha_gossip
            # fold gossiped peer counts into admission: caps/over-share
            # become fleet-wide within the gossip staleness bound
            self.tenant_admission.peer_counts_fn = (
                self.tenant_gossip.peer_counts)
            self.worker_gossip = ha.WorkerGossip(self.nats,
                                                 self.frontend_id,
                                                 self.router)

    def _on_kv_event(self, msg) -> None:
        try:
            payload = json.loads(msg.data)
        except (json.JSONDecodeError, UnicodeDecodeError):
            return
        if self.router.kv_index.apply(payload):
            self.kv_events_counter.inc()

    # ----------------------------------------- per-tenant admission ----
    def admit(self, tenant: str):
        """Admission decision for one request. Returns
        ``(admitted, reason, retry_after_s)``; an admitted request MUST be
        paired with release(). Checks, in order: the tenant's weighted
        in-flight cap, the SLO fast-burn shed (over-share tenants only —
        shedding is by tenant, never global), then the global bound."""
        adm = self.tenant_admission
        if self.tenants.enabled:
            if not adm.try_admit(tenant):
                return False, "inflight", adm.retry_after_s(tenant)
        else:
            adm.admit_unchecked(tenant)
        # the tenant slot is reserved: every shed below must release it
        if self._batch_paused(tenant):
            adm.release(tenant)
            return False, "batch_paused", adm.retry_after_s(tenant)
        if self._slo_burn_shed(tenant):
            adm.release(tenant)
            return False, "slo_burn", adm.retry_after_s(tenant)
        with self._inflight_lock:
            if self.max_inflight and self._inflight >= self.max_inflight:
                over = True
            else:
                self._inflight += 1
                over = False
        if over:
            adm.release(tenant)
            return False, "budget", adm.retry_after_s(tenant)
        return True, "", 0.0

    def release(self, tenant: str, duration_s: Optional[float] = None):
        with self._inflight_lock:
            self._inflight -= 1
        self.tenant_admission.release(tenant, duration_s)

    def _batch_paused(self, tenant: str) -> bool:
        """Inverted burn gate for the preemptible batch tier: a
        batch-class tenant admits only while the fast SLO window is
        QUIET (burn < batch_burn_admit on every interactive row). The
        normal shed asks "is the burn hot enough to shed over-share
        tenants?"; this asks "is it quiet enough to let offline work
        in at all?" — batch never waits on over_share, its mere
        presence during a burn is the problem. No SLO configured means
        no signal: batch admits (the engine-side class eviction still
        protects interactive latency)."""
        thr = self.batch_burn_admit
        if (thr <= 0 or not self.tenants.enabled
                or not self.tenants.is_batch(tenant)):
            return False
        fast = min(self.slo.windows_s) if self.slo.windows_s else 0
        for row in self._burn_rows():
            if row.get("window_s") != fast:
                continue
            if self.tenants.is_batch(row.get("tenant", "*")):
                continue  # the batch tier's own burn never pauses itself
            if row.get("burn_rate", 0.0) >= thr:
                return True
        return False

    def _slo_burn_shed(self, tenant: str) -> bool:
        """SLO-aware admission: when any matching SLO objective's FAST
        window burns above the threshold, shed tenants holding more than
        their weighted share of the in-flight load (the likely pressure
        source); under-share tenants keep admitting — the burn must never
        become a global gate."""
        thr = self.burn_shed_threshold
        if (thr <= 0 or not self.tenants.enabled
                or not self.tenant_admission.over_share(tenant)):
            return False
        fast = min(self.slo.windows_s) if self.slo.windows_s else 0
        for row in self._burn_rows():
            if row.get("window_s") != fast:
                continue
            row_tenant = row.get("tenant", "*")
            if row_tenant not in ("*", tenant):
                continue
            if row.get("burn_rate", 0.0) > thr:
                return True
        return False

    def _burn_rows(self):
        """SLO evaluations, cached ~1s — admission must not re-walk the
        whole burn-bucket machinery on every request of a burst."""
        now = time.monotonic()
        if self._burn_cache is not None and now - self._burn_cache[0] < 1.0:
            return self._burn_cache[1]
        try:
            rows = self.slo.evaluate()
        except Exception:
            log.exception("slo evaluation failed; burn shed skipped")
            rows = []
        self._burn_cache = (now, rows)
        return rows

    # ------------------------------------------------------- readiness ----
    def readiness(self) -> tuple:
        """(ready, detail) for /healthz — a REAL gate, not a liveness ping:
        unready while draining, while the NATS journal/KV-event/gossip
        subscriptions are down (this replica would journal nothing and see
        stale counters), or while the worker registry is empty (nothing to
        route to). The VIP's readinessProbe stops sending traffic here."""
        workers = len(self.router.alive(("agg", "prefill", "decode")))
        nats_ok = self.nats is None or self.nats.connected
        detail = {
            "workers": workers,
            "nats": ("unconfigured" if self.nats is None
                     else ("connected" if nats_ok else "disconnected")),
            "draining": self.draining,
            "frontend_id": self.frontend_id,
        }
        ready = workers > 0 and nats_ok and not self.draining
        return ready, detail


class _FrontendHandler(JsonHTTPHandler):
    ctx: FrontendContext
    _tenant = qos_tenancy.DEFAULT_TENANT  # set per-request in _proxy

    # ---------------------------------------------------------------- routes
    def do_GET(self):
        path = self.path.split("?")[0]
        ctx = self.ctx
        if path == "/v1/models":
            # base models plus every '<base>:<adapter>' any live worker
            # can serve (multi-LoRA addressing)
            self._json(200, proto.models_response(
                ctx.router.models_with_adapters()))
        elif path.startswith("/v1/models/"):
            mid = path[len("/v1/models/"):]
            if mid in ctx.router.models_with_adapters():
                self._json(200, proto.model_response(mid))
            else:
                self._error(404, f"model {mid!r} not found", "not_found")
        elif path == "/metrics":
            ctx.worker_gauge.set(len(ctx.router.alive(("agg", "prefill", "decode"))))
            ctx.kv_index_gauge.set(ctx.router.kv_index.stats()["entries"])
            with ctx._inflight_lock:
                ctx.metrics.queued.set(ctx._inflight)
            # breaker state is scrape-time truth (open->half_open happens
            # by clock, not by an event anyone could have observed)
            for url, state in ctx.router.breakers.snapshot().items():
                ctx.breaker_gauge.set(STATE_CODES[state], worker=url)
            # engine health rides worker heartbeats; scrape-time export
            # with label death so a departed worker's row disappears
            health_now = {w.url: WD_HEALTH_CODES.get(w.health, 0)
                          for w in ctx.router.alive(
                              ("agg", "prefill", "decode"))}
            with ctx.worker_health_gauge._lock:
                known_workers = [dict(lbl).get("worker")
                                 for lbl in ctx.worker_health_gauge._values]
            for u in known_workers:
                if u not in health_now:
                    ctx.worker_health_gauge.remove(worker=u)
            for u, code in health_now.items():
                ctx.worker_health_gauge.set(code, worker=u)
            # per-tenant in-flight occupancy (tenants that drained to zero
            # must read 0, not freeze at their last value)
            inflight = ctx.tenant_admission.snapshot()["inflight"]
            with ctx.tenant_inflight_gauge._lock:
                known = [dict(lbl).get("tenant")
                         for lbl in ctx.tenant_inflight_gauge._values]
            for t in known:
                if t not in inflight:
                    ctx.tenant_inflight_gauge.set(0, tenant=t)
            for t, n in inflight.items():
                ctx.tenant_inflight_gauge.set(n, tenant=t)
            # HA plane gauges are scrape-time truth (store size and peer
            # freshness both move without any local event)
            if ctx.journal_plane is not None:
                ctx.ha_journal_streams.set(len(ctx.journal_plane))
            if ctx.tenant_gossip is not None:
                ctx.ha_peer_frontends.set(ctx.tenant_gossip.live_peers())
                peer = ctx.tenant_gossip.peer_counts()
                with ctx.ha_peer_inflight._lock:
                    known = [dict(lbl).get("tenant")
                             for lbl in ctx.ha_peer_inflight._values]
                for t in known:
                    if t not in peer:
                        ctx.ha_peer_inflight.set(0, tenant=t)
                for t, n in peer.items():
                    ctx.ha_peer_inflight.set(n, tenant=t)
            by_ver: dict = {}
            for w in ctx.router.alive(("agg", "prefill", "decode")):
                v = (w.stats or {}).get("weight_version")
                if v:
                    by_ver[v] = by_ver.get(v, 0) + 1
            for v in ctx._version_labels - set(by_ver):
                ctx.worker_version_gauge.remove(version=v)
            for v, n in by_ver.items():
                ctx.worker_version_gauge.set(n, version=v)
            ctx._version_labels = set(by_ver)
            ctx.slo.refresh_gauges()
            body, ctype = ctx.metrics.registry.scrape(
                self.headers.get("Accept"))
            self._raw(200, body, ctype)
        elif path == "/internal/faults":
            self._json(200, faults.http_payload())
        elif path in ("/health", "/live", "/ready"):
            workers = len(ctx.router.alive(("agg", "prefill", "decode")))
            code = 200 if path != "/ready" or workers > 0 else 503
            self._json(code, {"status": "ok" if code == 200 else "no-workers",
                              "workers": workers})
        elif path == "/healthz":
            # the readiness gate the VIP probes (operator readinessProbe):
            # unlike /health it goes 503 whenever this replica could not
            # actually serve — NATS subscriptions down, no workers, or
            # draining (docs/robustness.md "HA frontend plane")
            ready, detail = ctx.readiness()
            detail["status"] = "ready" if ready else "unready"
            self._json(200 if ready else 503, detail)
        elif path == "/internal/workers":
            alive = ctx.router.alive(("agg", "prefill", "decode"))
            versions: dict = {}
            for w in alive:
                v = (w.stats or {}).get("weight_version")
                if v:
                    versions[v] = versions.get(v, 0) + 1
            self._json(200, {
                "workers": [
                    {"url": w.url, "model": w.model, "mode": w.mode,
                     "headroom": round(w.headroom, 3), "stats": w.stats}
                    for w in alive
                ],
                # per-version worker counts: the rollout controller's
                # cheap fleet-progress read (mirrors the
                # dynamo_frontend_worker_weight_version gauge)
                "weight_versions": versions,
                # the routing core and its KV-affinity sources
                "router": {
                    **ctx.router_core,
                    "kv_index": ctx.router.kv_index.stats(),
                    "kv_index_hits": ctx.router.kv_index_hits,
                    "ledger_hits": ctx.router.ledger_hits,
                },
            })
        elif path == "/debug/spans":
            from urllib.parse import parse_qs, urlparse

            qs = parse_qs(urlparse(self.path).query)
            self._json(200, obs_tracing.spans_debug_payload(
                qs, ctx.tracer.collector))
        elif path == "/debug/slo":
            from urllib.parse import parse_qs, urlparse

            qs = parse_qs(urlparse(self.path).query)
            self._json(200, obs_slo.debug_slo_payload(ctx.slo, qs))
        elif path == "/debug/tenants":
            # per-tenant QoS introspection: classes, caps, live in-flight
            self._json(200, {
                "enabled": ctx.tenants.enabled,
                "classes": ctx.tenants.describe(),
                "admission": ctx.tenant_admission.snapshot(),
                "burn_shed_threshold": ctx.burn_shed_threshold,
            })
        elif path == "/debug/costs":
            # fleet-wide chargeback rollup: every worker ships its cost
            # ledger in the heartbeat, so this aggregates registry state —
            # no scrape fan-out, and it works identically on every HA
            # frontend replica (heartbeats go to all of them)
            from dynamo_tpu_torch.observability.cost import merge_rollups

            per_worker = {}
            for w in ctx.router.alive(("agg", "prefill", "decode")):
                costs = (w.stats or {}).get("costs")
                if costs:
                    per_worker[w.url] = costs
            merged = merge_rollups(list(per_worker.values()))
            merged["workers"] = len(per_worker)
            merged["per_worker"] = per_worker
            self._json(200, merged)
        elif path == "/debug/timeline":
            # fleet-wide bubble attribution: each worker ships its
            # step-timeline summary in the heartbeat (same no-fan-out
            # pattern as /debug/costs); quantiles don't merge, so the
            # rollup reports worst-worker p95 per phase
            from dynamo_tpu_torch.observability.timeline import merge_summaries

            per_worker = {}
            for w in ctx.router.alive(("agg", "prefill", "decode")):
                tl = (w.stats or {}).get("timeline")
                if tl:
                    per_worker[w.url] = tl
            merged = merge_summaries(list(per_worker.values()))
            merged["workers"] = len(per_worker)
            merged["per_worker"] = per_worker
            self._json(200, merged)
        elif path in ("/debug", "/debug/"):
            self._json(200, {"endpoints": {
                "/debug/spans": "recent frontend/request spans "
                                "(?trace_id=&n=)",
                "/debug/slo": "SLO attainment windows and violation "
                              "breakdown",
                "/debug/tenants": "tenant classes, caps, live admission "
                                  "state",
                "/debug/costs": "fleet-wide per-tenant cost rollup "
                                "aggregated from worker heartbeats",
                "/debug/timeline": "fleet-wide step-timeline bubble "
                                   "attribution aggregated from worker "
                                   "heartbeats",
            }, "see_also": {
                "workers": "GET <worker>/debug/ for the worker-side index "
                           "(flight recorder, trace capture, costs)",
                "planner": "GET /debug/planner lives on the operator "
                           "debug server, not this frontend",
            }})
        else:
            self._error(404, f"no route {path}")

    def do_POST(self):
        path = self.path.split("?")[0]
        try:
            if path == "/internal/register":
                body = self._read_json_body()
                self.ctx.router.register(
                    body["url"], body.get("model", "?"),
                    body.get("mode", "agg"), body.get("stats"),
                )
                if self.ctx.worker_gossip is not None:
                    # relay the DIRECT heartbeat to peer frontends so a
                    # worker heartbeating here is never TTL-purged by a
                    # replica that can't hear it (serving/ha.py)
                    self.ctx.worker_gossip.publish_register(
                        body["url"], body.get("model", "?"),
                        body.get("mode", "agg"), body.get("stats"))
                self._json(200, {"ok": True})
            elif path == "/internal/deregister":
                # graceful worker drain (SIGTERM): stop routing to it NOW
                # instead of waiting out the heartbeat TTL
                body = self._read_json_body()
                self.ctx.router.deregister(body["url"])
                if self.ctx.worker_gossip is not None:
                    # a drain is authoritative fleet-wide
                    self.ctx.worker_gossip.publish_deregister(body["url"])
                self._json(200, {"ok": True})
            elif path == "/internal/faults":
                try:
                    self._json(200, faults.http_configure(
                        self._read_json_body()))
                except ValueError as e:
                    self._error(400, str(e))
            elif path in ("/v1/chat/completions", "/v1/completions"):
                self._proxy(path)
            else:
                self._error(404, f"no route {path}")
        except proto.BadRequest as e:
            self._error(400, str(e))
        except Exception:
            log.exception("frontend request failed")
            self._error(500, "internal error", "internal_error")

    def _send_nats_response(self, parts, model: str, t0: float,
                            exemplar=None):
        """Write a NATS-plane response out. The response has STARTED once we
        are here — mid-stream failures truncate (never re-dispatch to the
        HTTP plane, which would re-run inference and corrupt the stream)."""
        ctx = self.ctx
        m = ctx.metrics
        status, ctype, chunks = parts
        if "text/event-stream" in ctype:
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            first = True
            try:
                for chunk in chunks:
                    if first:
                        m.ttft.observe(time.monotonic() - t0,
                                       exemplar=exemplar, model=model)
                        m.tenant_ttft.observe(time.monotonic() - t0,
                                              tenant=self._tenant)
                        first = False
                    self.wfile.write(b"%x\r\n%s\r\n" % (len(chunk), chunk))
                    self.wfile.flush()
                self.wfile.write(b"0\r\n\r\n")
            except (BrokenPipeError, ConnectionResetError, socket.error):
                pass
            except Exception:
                log.exception("NATS stream truncated mid-response")
        else:
            payload = b"".join(chunks)
            m.ttft.observe(time.monotonic() - t0, exemplar=exemplar,
                           model=model)
            m.tenant_ttft.observe(time.monotonic() - t0,
                                  tenant=self._tenant)
            try:
                usage = json.loads(payload).get("usage", {})
                m.isl.observe(usage.get("prompt_tokens", 0), model=model)
                m.osl.observe(usage.get("completion_tokens", 0), model=model)
            except Exception:
                pass
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)
        m.duration.observe(time.monotonic() - t0, exemplar=exemplar,
                           model=model)

    # ----------------------------------------------------------------- proxy
    def _proxy(self, path: str):
        # in-flight accounting spans the WHOLE proxied exchange (SSE
        # passthrough included) — it is the queued-requests signal the
        # operator's planner autoscales on. Admission is per-tenant
        # (docs/robustness.md "Per-tenant QoS"): the tenant identity is
        # resolved from the client's headers at this edge, weighted
        # in-flight caps and the SLO-burn shed apply per tenant, and a
        # shed response carries a Retry-After derived from THAT tenant's
        # budget-refill time rather than the global jitter.
        ctx = self.ctx
        tenant = ctx.tenants.resolve(self.headers)
        self._tenant = tenant
        ctx.metrics.tenant_requests.inc(tenant=tenant)
        admitted, reason, retry_after = ctx.admit(tenant)
        if not admitted:
            ctx.admission_rejected.inc(tenant=tenant, reason=reason)
            detail = {
                "inflight": f"tenant {tenant!r} is at its in-flight cap "
                            f"({ctx.tenant_admission.cap(tenant)})",
                "budget": f"too many in-flight requests "
                          f"(limit {ctx.max_inflight})",
                "slo_burn": f"SLO budget is burning and tenant {tenant!r} "
                            "is over its fair share",
                "batch_paused": f"batch tenant {tenant!r} is paused while "
                                "interactive SLO burn is hot",
            }[reason]
            self._error(
                429, f"{detail}; retry shortly", "rate_limit_exceeded",
                headers={"Retry-After": f"{retry_after:.2f}"})
            return
        t_admit = time.monotonic()
        try:
            self._proxy_inner(path)
        finally:
            ctx.release(tenant, time.monotonic() - t_admit)

    def _proxy_inner(self, path: str):
        ctx = self.ctx
        raw = self._read_raw_body()
        try:
            body = json.loads(raw)
        except json.JSONDecodeError as e:
            raise proto.BadRequest(f"invalid JSON: {e}")
        if path.endswith("chat/completions"):
            parsed = proto.parse_chat_request(body)
            prompt_text = json.dumps(parsed["messages"])
        else:
            parsed = proto.parse_completion_request(body)
            prompt_text = parsed["prompt"]
        affinity = prefix_key(prompt_text)
        model = parsed["model"]

        # --- distributed tracing: this span is the trace ROOT unless the
        # client sent its own traceparent; x-request-id (inbound or minted
        # from the trace id) rides every response for correlation ---
        inbound_rid = ((self.headers.get("x-request-id") or "").strip()
                       or None)
        # end-to-end deadline: the client's x-deadline budget (clamped to
        # the operator default) starts counting down NOW; every downstream
        # hop gets the remainder
        deadline = Deadline.from_headers(self.headers)
        parent = obs_context.extract_context(self.headers)
        span = ctx.tracer.start_span(
            "frontend.request", parent=parent, kind="server",
            trace_seed=inbound_rid,
            attributes={"http.path": path, "model": model,
                        "deadline_s": round(deadline.budget_s, 3),
                        "stream": bool(parsed.get("stream")),
                        "tenant.id": self._tenant})
        rid = inbound_rid or (span.trace_id if span.recording else None)
        if rid:
            self.set_request_id(rid)
        # downstream hops get the SPAN as parent (or pass the inbound
        # context through untouched when tracing is switched off)
        trace_headers: dict = {}
        obs_context.inject_context(
            span.context if span.recording else parent, trace_headers,
            request_id=rid)
        # the resolved tenant identity rides EVERY downstream dispatch —
        # worker POSTs, the NATS plane, and recovery-continuation
        # re-dispatches all build their headers from trace_headers, so
        # the edge's decision survives failover and mid-stream recovery
        trace_headers[qos_tenancy.RESOLVED_HEADER] = self._tenant
        t_req = time.monotonic()
        try:
            if body.get(ha.RESUME_BODY_KEY) is not None:
                # a client resuming a stream whose original frontend died
                # (serving/ha.py): any replica can pick it up from the
                # replicated journal
                self._resume_stream(path, body, prompt_text, affinity,
                                    model, span, trace_headers, deadline)
            else:
                self._route_and_forward(path, raw, body, prompt_text,
                                        affinity, model, span,
                                        trace_headers, deadline)
        except Exception as e:
            span.set_status("ERROR", f"{type(e).__name__}: {e}")
            raise
        finally:
            dur = time.monotonic() - t_req
            span.set_attribute("duration_s", round(dur, 6))
            span.end()
            if span.recording and dur >= slow_request_threshold_s():
                log.warning(
                    "slow request: %.2fs model=%s path=%s trace_id=%s "
                    "x_request_id=%s — GET /debug/spans?trace_id=%s",
                    dur, model, path, span.trace_id, rid or "-",
                    span.trace_id)

    def _shed_deadline(self, span, where: str, model: Optional[str] = None):
        self.ctx.deadline_shed.inc()
        if model:
            self.ctx.metrics.errors_total.inc(model=model, code="504")
        span.set_status("ERROR", f"deadline exhausted ({where})")
        self._error(
            504, f"deadline budget exhausted {where}; request shed",
            "timeout")

    def _route_and_forward(self, path: str, raw: bytes, body: dict,
                           prompt_text: str, affinity: str, model: str,
                           span, trace_headers: dict, deadline: Deadline):
        ctx = self.ctx
        # exemplar: latency observations carry the trace id, so a hot
        # histogram bucket links straight to /debug/spans?trace_id=...
        ex = span.trace_id if span.recording else None
        if deadline.expired:
            # shed BEFORE routing: no pick, no dial, no engine slot
            self._shed_deadline(span, "before routing", model)
            return
        # multi-LoRA addressing: '<base>:<adapter>' routes on the BASE
        # model's worker set with adapter-affinity (resident > lazy-load
        # capable > any); the worker re-validates the adapter itself
        base, adapter = split_adapter(model, ctx.router.models())
        if adapter:
            span.set_attribute("router.adapter", adapter)
        explain: dict = {}
        with ctx.tracer.start_span("router.pick", parent=span,
                                   attributes={"model": model}) as pick_span:
            worker = ctx.router.pick(base, affinity,
                                     prompt_text=prompt_text,
                                     explain=explain, adapter=adapter)
            for k, v in explain.items():
                pick_span.set_attribute(f"router.{k}", v)
            if worker is not None:
                pick_span.set_attribute("worker.url", worker.url)
        if worker is None:
            span.set_status("ERROR", f"no live worker for {model!r}")
            ctx.metrics.errors_total.inc(model=model, code="503")
            self._error(503, f"no live worker for model {model!r}",
                        "service_unavailable")
            return

        m = ctx.metrics
        m.requests_total.inc(model=model)
        t0 = time.monotonic()
        if ctx.nats is not None:
            try:
                # resolving the head frame proves a responder exists; only
                # failures BEFORE it (no responder / timeout) may fall back
                parts = _nats_proxy_parts(ctx, worker, path, body,
                                          trace_headers, deadline)
            except Exception as e:
                log.warning("NATS plane failed (%s); HTTP fallback to %s",
                            e, worker.url)
                span.add_event("nats_fallback", {"error": str(e)})
            else:
                span.set_attribute("transport", "nats")
                span.set_attribute("worker.url", worker.url)
                self._send_nats_response(parts, model, t0, exemplar=ex)
                return
        # bounded failover: a CONNECT-phase failure (refused / no route /
        # DNS) proves the request never reached a worker, so retrying the
        # next pick is safe; a worker 503 (draining / overloaded) shed
        # BEFORE any work started, so it fails over too — that is what
        # makes rolling restarts hitless. A read timeout means a worker
        # accepted and may be generating — retrying would duplicate the
        # generation, so it is terminal (504). 502 only when no live
        # worker accepts. Journal-eligible STREAMS go further: the SSE
        # relay journals delivered tokens and splices a continuation onto
        # the same stream after a mid-stream worker death
        # (docs/robustness.md "Recovery semantics").
        journal_on = recovery.journal_eligible(body)
        resp = None
        last_err: Optional[str] = None
        last_503: Optional[tuple] = None  # replayed if every pick sheds
        tried: List[str] = []
        breakers = ctx.router.breakers
        for attempt in range(3):
            if attempt:
                # exclude workers that already refused: the ledger and HRW
                # are deterministic, so an unexcluded re-pick would bounce
                # off the same dead worker three times
                worker = ctx.router.pick(base, affinity,
                                         prompt_text=prompt_text,
                                         exclude=tried, adapter=adapter)
                if worker is None:
                    break
                span.add_event("failover_repick",
                               {"attempt": attempt, "worker.url": worker.url})
            if deadline.expired:
                # a failover re-pick must not outlive the client's budget
                self._shed_deadline(span, "during failover", model)
                return
            span.set_attribute("transport", "http")
            span.set_attribute("worker.url", worker.url)
            dispatch_headers = deadline.propagate({
                "Content-Type": "application/json", **trace_headers})
            if journal_on:
                # ask the worker to interleave recovery-journal comments
                # with the stream (serving/recovery.py)
                dispatch_headers[recovery.JOURNAL_HEADER] = "1"
            req = urllib.request.Request(
                worker.url.rstrip("/") + path,
                data=raw,
                headers=dispatch_headers,
                method="POST",
            )
            try:
                faults.raise_point(
                    "frontend.connect_refused",
                    lambda m: urllib.error.URLError(ConnectionRefusedError(m)))
                # the socket timeout IS the remaining deadline — the former
                # hard-coded 600 s held a proxy slot long after any client
                # had given up
                resp = urllib.request.urlopen(req,
                                              timeout=deadline.timeout())
                breakers.record_success(worker.url)
                break
            except urllib.error.HTTPError as e:
                # the worker is alive and answered: a real API response,
                # not a routing failure
                breakers.record_success(worker.url)
                payload = e.read()
                if e.code == 503:
                    # a draining/overloaded worker sheds BEFORE any work
                    # starts (admission gate), so failing over is safe;
                    # the shed response is replayed only if every pick
                    # sheds. The worker stays registered — it is alive,
                    # and re-heartbeats its real state
                    span.add_event("worker_503_failover",
                                   {"worker.url": worker.url})
                    tried.append(worker.url)
                    last_err = f"worker {worker.url} shed 503"
                    last_503 = (payload,
                                e.headers.get("Content-Type",
                                              "application/json"),
                                e.headers.get("Retry-After"))
                    continue
                # anything else is a definitive answer — pass it through
                if e.code >= 500:
                    ctx.metrics.errors_total.inc(model=model,
                                                 code=str(e.code))
                self.send_response(e.code)
                self.send_header(
                    "Content-Type",
                    e.headers.get("Content-Type", "application/json"))
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)
                return
            except (urllib.error.URLError, socket.error) as e:
                reason = getattr(e, "reason", e)
                if isinstance(reason, (TimeoutError, socket.timeout)):
                    breakers.record_failure(worker.url)
                    ctx.deadline_shed.inc()
                    ctx.metrics.errors_total.inc(model=model, code="504")
                    span.set_status("ERROR", "worker timeout")
                    self._error(
                        504, f"worker {worker.url} timed out mid-request "
                        f"(deadline budget {deadline.budget_s:.1f}s)",
                        "timeout")
                    return
                if not net.pre_send_failure(e):
                    # connection lost AFTER the request was written: the
                    # worker may already be generating — a retry would
                    # duplicate the whole generation, so answer terminally
                    breakers.record_failure(worker.url)
                    ctx.metrics.errors_total.inc(model=model, code="502")
                    span.set_status("ERROR", "worker connection lost")
                    self._error(
                        502,
                        f"worker {worker.url} connection lost after the "
                        "request was sent; not retried",
                        "bad_gateway")
                    return
                log.warning("worker %s unreachable (%s); failing over",
                            worker.url, e)
                breakers.record_failure(worker.url)
                ctx.router.deregister(worker.url)
                # belt and braces with the deregister: a racing heartbeat
                # could re-register the dead worker before the re-pick
                tried.append(worker.url)
                last_err = str(e)
        if resp is None:
            if last_503 is not None:
                # every live pick shed 503 (cluster-wide drain/overload):
                # replay the worker's own shed response, Retry-After
                # jitter included, rather than escalating to 502
                payload, p_ctype, retry_after = last_503
                span.set_status("ERROR", "all workers shed 503")
                ctx.metrics.errors_total.inc(model=model, code="503")
                self.send_response(503)
                self.send_header("Content-Type", p_ctype)
                self.send_header("Content-Length", str(len(payload)))
                if retry_after:
                    self.send_header("Retry-After", retry_after)
                self.end_headers()
                self.wfile.write(payload)
                return
            span.set_status("ERROR", "no reachable worker")
            ctx.metrics.errors_total.inc(model=model, code="502")
            self._error(
                502,
                f"no reachable worker for model {model!r}"
                + (f" (last error: {last_err})" if last_err else ""),
                "bad_gateway")
            return
        if attempt:
            # connect-phase recovery: an earlier pick failed pre-send and
            # the re-pick carried the request
            ctx.recovered_counter.inc(phase="connect")

        ctype = resp.headers.get("Content-Type", "application/json")
        if "text/event-stream" in ctype:
            self._relay_sse(resp, worker, path, body, prompt_text,
                            affinity, model, span, trace_headers, deadline,
                            tried, attempt, journal_on, t0,
                            base=base, adapter=adapter)
        else:
            try:
                payload = resp.read()
            except (socket.error, OSError, http.client.HTTPException) as e:
                # worker connection died between its headers and its body:
                # the generation may have run — terminal, never retried
                span.set_status("ERROR", "worker connection lost mid-response")
                ctx.router.breakers.record_failure(worker.url)
                ctx.metrics.errors_total.inc(model=model, code="502")
                self._error(
                    502,
                    f"worker {worker.url} connection lost mid-response "
                    f"({type(e).__name__}); not retried", "bad_gateway")
                return
            m.ttft.observe(time.monotonic() - t0, exemplar=ex, model=model)
            m.tenant_ttft.observe(time.monotonic() - t0,
                                  tenant=self._tenant)
            try:
                usage = json.loads(payload).get("usage", {})
                m.isl.observe(usage.get("prompt_tokens", 0), model=model)
                m.osl.observe(usage.get("completion_tokens", 0), model=model)
            except Exception:
                pass
            self.send_response(resp.status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            # recovery observability: how many dispatches this response
            # took, and whether a failover carried it
            self.send_header("x-request-attempts", str(attempt + 1))
            if attempt:
                self.send_header("x-recovered", "1")
            self.end_headers()
            self.wfile.write(payload)
        m.duration.observe(time.monotonic() - t0, exemplar=ex, model=model)

    # --------------------------------------------- cross-frontend resume --
    def _resume_stream(self, path: str, body: dict, prompt_text: str,
                       affinity: str, model: str, span, trace_headers: dict,
                       deadline: Deadline) -> None:
        """Resume a stream whose original frontend died (serving/ha.py).

        The client re-POSTs its ORIGINAL request body plus a
        ``dynamo_resume`` key naming the response id and how many content
        chars it already received. Any frontend replica can serve it: the
        replicated journal plane holds the seam cursor, so the surviving
        frontend claims the resume (single winner fleet-wide), re-picks a
        worker preferring journaled-prefix KV overlap, and dispatches a
        recovery continuation — the worker re-emits exactly the chars past the
        client's cursor, byte-identical for greedy/seeded streams."""
        ctx = self.ctx
        plane = ctx.journal_plane

        def refuse(code: int, outcome: str, msg: str, etype: str) -> None:
            ctx.ha_resumes.inc(outcome=outcome)
            if code >= 500:
                ctx.metrics.errors_total.inc(model=model, code=str(code))
            span.set_status("ERROR", f"resume refused: {outcome}")
            span.set_attribute("resume.outcome", outcome)
            self._error(code, msg, etype)

        if plane is None:
            ctx.ha_resumes.inc(outcome="invalid")
            raise proto.BadRequest(
                "stream resume requires the replicated journal plane "
                "(frontend started without --nats-url)")
        try:
            spec = ha.normalize_resume(body.get(ha.RESUME_BODY_KEY))
        except ValueError as e:
            ctx.ha_resumes.inc(outcome="invalid")
            raise proto.BadRequest(f"bad {ha.RESUME_BODY_KEY}: {e}")
        rid, delivered = spec["response_id"], spec["delivered_chars"]
        span.set_attribute("resume.response_id", rid)
        rec = plane.lookup(rid)
        if rec is None:
            refuse(404, "unknown",
                   f"no replicated journal for response {rid!r} "
                   "(expired, never journaled, or a different cluster)",
                   "not_found")
            return
        if rec.done:
            refuse(409, "completed",
                   f"response {rid!r} already delivered its [DONE]; "
                   "nothing to resume", "conflict")
            return
        if not rec.resumable:
            refuse(409, "invalid",
                   f"journal for response {rid!r} is not resumable "
                   "(inconsistent checkpoint sequence)", "conflict")
            return
        if delivered > rec.checkpoint_chars:
            # the replicated journal is BEHIND what the client saw: a
            # continuation from this cursor would re-sample the gap —
            # refuse rather than risk duplicated or diverging output
            refuse(409, "stale_cursor",
                   f"replicated journal for {rid!r} is behind the client "
                   f"({rec.checkpoint_chars} < {delivered} chars); "
                   "cannot resume without risking duplicate output",
                   "conflict")
            return
        if not plane.claim(rid):
            refuse(409, "lost_claim",
                   f"another frontend won the resume claim for {rid!r}; "
                   "retry there or wait", "conflict")
            return
        # pre-seed a journal at the replicated seam; the relay's own
        # accounting continues from the client's cursor, and the worker's
        # continuation checkpoints (cumulative n) extend it consistently
        journal = recovery.RequestJournal(enabled_=True)
        journal.tokens = list(rec.tokens)
        journal.delivered_chars = delivered
        journal.checkpoint_chars = rec.checkpoint_chars
        journal.data_seen = True  # the client already holds the role chunk
        journal.response_id = rec.rid
        journal.seed = rec.seed
        journal.resume_key = (list(rec.resume_key)
                              if rec.resume_key else None)

        clean = {k: v for k, v in body.items()
                 if k != ha.RESUME_BODY_KEY}
        base, adapter = split_adapter(model, ctx.router.models())
        m = ctx.metrics
        m.requests_total.inc(model=model)
        t0 = time.monotonic()
        tried: List[str] = []
        resp = None
        worker = None
        attempt = 0
        for attempt in range(recovery.MAX_ATTEMPTS):
            if deadline.expired:
                plane.release_claim(rid)
                self._shed_deadline(span, "during resume", model)
                return
            worker = ctx.router.pick(base or model, affinity,
                                     prompt_text=prompt_text,
                                     exclude=tried, relaxed_overlap=True,
                                     adapter=adapter)
            if worker is None:
                break
            cont = dict(clean)
            cont[recovery.RECOVERY_BODY_KEY] = journal.continuation()
            headers = deadline.propagate({
                "Content-Type": "application/json",
                recovery.JOURNAL_HEADER: "1", **trace_headers})
            req = urllib.request.Request(
                worker.url.rstrip("/") + path,
                data=json.dumps(cont).encode(), headers=headers,
                method="POST")
            try:
                resp = urllib.request.urlopen(req,
                                              timeout=deadline.timeout())
                ctx.router.breakers.record_success(worker.url)
                break
            except urllib.error.HTTPError as e:
                e.read()
                ctx.router.breakers.record_success(worker.url)
                tried.append(worker.url)
            except (urllib.error.URLError, socket.error):
                ctx.router.breakers.record_failure(worker.url)
                tried.append(worker.url)
        if resp is None:
            plane.release_claim(rid)
            refuse(503, "no_worker",
                   f"no healthy worker to resume response {rid!r}",
                   "service_unavailable")
            return
        ctx.ha_resumes.inc(outcome="resumed")
        span.set_attribute("resume.outcome", "resumed")
        span.add_event("stream_resumed", {
            "response_id": rid, "worker.url": worker.url,
            "seam_token_index": journal.seam_token_index})
        self._relay_sse(resp, worker, path, clean, prompt_text, affinity,
                        model, span, trace_headers, deadline, tried,
                        attempt, True, t0, base=base, adapter=adapter,
                        journal=journal)
        m.duration.observe(time.monotonic() - t0, model=model)

    # ----------------------------------------------- mid-stream recovery --
    def _relay_sse(self, resp, worker, path: str, body: dict,
                   prompt_text: str, affinity: str, model: str, span,
                   trace_headers: dict, deadline: Deadline,
                   tried: List[str], attempt: int, journal_on: bool,
                   t0: float, base: Optional[str] = None,
                   adapter: Optional[str] = None,
                   journal: Optional[recovery.RequestJournal] = None,
                   ) -> None:
        """SSE relay with mid-stream recovery (serving/recovery.py).

        The worker stream is parsed into event blocks instead of being
        byte-proxied: ``dynr`` journal comments feed the per-request
        RequestJournal and are stripped; data frames are re-framed to the
        client verbatim. On a mid-stream failure (in-stream error event,
        reset, stall timeout, EOF without [DONE]) a healthy worker is
        re-picked — preferring ANY journaled-prefix KV overlap
        (router relaxed_overlap) — and the request is re-POSTed as a
        continuation; the worker re-emits exactly the chars past the
        seam, so greedy/seeded streams are byte-identical to a fault-free
        run. Non-journaled streams keep the truncate semantics."""
        ctx = self.ctx
        m = ctx.metrics
        # a cross-frontend resume arrives with a journal pre-seeded from
        # the replicated journal plane (serving/ha.py); everything else
        # starts from a blank one
        if journal is None:
            journal = recovery.RequestJournal(enabled_=journal_on)
        plane = ctx.journal_plane
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("x-request-attempts", str(attempt + 1))
        if attempt:
            self.send_header("x-recovered", "1")
        self.end_headers()
        first = True
        t_prev: Optional[float] = None

        def forward(block: bytes) -> bool:
            nonlocal first, t_prev
            now = time.monotonic()
            ex = span.trace_id if span.recording else None
            if first:
                m.ttft.observe(now - t0, exemplar=ex, model=model)
                m.tenant_ttft.observe(now - t0, tenant=self._tenant)
                first = False
            elif t_prev is not None:
                # client-visible inter-token latency (includes relay +
                # network time the worker's own ITL histogram can't see)
                m.itl.observe(now - t_prev, exemplar=ex, model=model)
                m.tenant_itl.observe(now - t_prev, tenant=self._tenant)
            t_prev = now
            try:
                payload = block + b"\n\n"
                self.wfile.write(b"%x\r\n%s\r\n" % (len(payload), payload))
                self.wfile.flush()
                return True
            except (BrokenPipeError, ConnectionResetError, socket.error,
                    http.client.HTTPException, ValueError):
                return False

        def pump(stream):
            """Relay one worker stream. Returns (outcome, held_error):
            outcome in {"done", "client_gone", "failed"}."""
            for kind, block in recovery.iter_sse_blocks(stream):
                if kind != "block":
                    # conn/eof without [DONE]: the worker died (or handed
                    # off) mid-stream
                    return "failed", None
                bkind, extra = recovery.parse_block(block)
                if bkind == "journal":
                    journal.apply_comment(extra)
                    # HA: replicate the raw checkpoint to every peer
                    # frontend BEFORE the content it covers is forwarded,
                    # preserving the journal-runs-ahead seam invariant
                    # fleet-wide (a peer's copy is never behind what this
                    # frontend delivered at the time of the checkpoint)
                    if (plane is not None and journal.enabled
                            and journal.response_id):
                        plane.publish_record(journal.response_id, extra)
                elif bkind == "done":
                    return (("done", None) if forward(block)
                            else ("client_gone", None))
                elif bkind == "error":
                    # the worker reported its own death in-stream (crash
                    # mid-decode): hold the error — a successful splice
                    # makes it invisible to the client
                    return "failed", block
                else:
                    if not forward(block):
                        return "client_gone", None
                    if bkind == "data":
                        journal.on_data(extra)
            return "failed", None  # defensive: stream ended markerless

        outcome = "failed"
        held_error: Optional[bytes] = None
        while True:
            outcome, held_error = pump(resp)
            try:
                resp.close()
            except Exception:
                pass
            if outcome != "failed":
                break
            # ---- mid-stream failure: splice a continuation ----
            if journal.handoff:
                span.add_event("worker_handoff",
                               {"worker.url": worker.url,
                                "seam_token_index":
                                    journal.seam_token_index})
            resp = None
            while (journal.recoverable
                   and attempt + 1 < recovery.MAX_ATTEMPTS
                   and not deadline.expired):
                attempt += 1
                if worker.url not in tried:
                    tried.append(worker.url)
                explain: dict = {}
                nxt = ctx.router.pick(base or model, affinity,
                                      prompt_text=prompt_text,
                                      exclude=tried, explain=explain,
                                      relaxed_overlap=True, adapter=adapter)
                if nxt is None:
                    break
                worker = nxt
                cont = dict(body)
                cont[recovery.RECOVERY_BODY_KEY] = journal.continuation()
                headers = deadline.propagate({
                    "Content-Type": "application/json",
                    recovery.JOURNAL_HEADER: "1", **trace_headers})
                req = urllib.request.Request(
                    worker.url.rstrip("/") + path,
                    data=json.dumps(cont).encode(), headers=headers,
                    method="POST")
                try:
                    resp = urllib.request.urlopen(
                        req, timeout=deadline.timeout())
                    break
                except urllib.error.HTTPError as e:
                    # shed (503 draining) or rejected: spend the attempt
                    # and keep looking
                    e.read()
                    ctx.router.breakers.record_success(worker.url)
                    resp = None
                except (urllib.error.URLError, socket.error):
                    ctx.router.breakers.record_failure(worker.url)
                    resp = None
            if resp is None:
                # recovery impossible: surface the failure the pre-
                # recovery way — forward the worker's own error event (or
                # say why) and terminate the stream
                span.set_status(
                    "ERROR", "worker stream failed; not recovered")
                if held_error is not None:
                    forward(held_error)
                elif journal.enabled:
                    forward(b"data: " + json.dumps({"error": {
                        "message": "worker lost mid-stream; recovery "
                                   "failed (no healthy worker in budget)",
                        "type": "stream_error"}}).encode())
                if held_error is not None or journal.enabled:
                    forward(b"data: [DONE]")
                break
            # spliced: the continuation now feeds the SAME client stream
            ctx.recovered_counter.inc(phase="stream")
            span.add_event("stream_recovered", {
                "worker.url": worker.url, "attempt": attempt,
                "seam_token_index": journal.seam_token_index})
            span.set_attribute("recovery.seam_token_index",
                               journal.seam_token_index)
            span.set_attribute("worker.url", worker.url)
        if (plane is not None and journal.enabled and journal.response_id
                and outcome == "done"):
            # tombstone only on a [DONE] delivered to the client — a
            # client that vanished mid-stream must still be able to
            # resume through any peer frontend
            plane.publish_done(journal.response_id)
        try:
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, socket.error,
                http.client.HTTPException, ValueError):
            pass
        # the shared _route_and_forward tail observes request duration


def _nats_proxy_parts(ctx, worker, path, body, trace_headers=None,
                      deadline: Optional[Deadline] = None):
    from dynamo_tpu_torch.serving import nats_plane

    headers = dict(trace_headers or {})
    timeout = 600.0
    if deadline is not None:
        deadline.propagate(headers)  # budget rides the NATS msg headers too
        timeout = deadline.timeout()
    return nats_plane.nats_request(
        ctx.nats, nats_plane.worker_subject(worker.url), path, body,
        timeout=timeout, trace_headers=headers,
    )


# split out so _proxy's HTTP path stays exactly as-is
def make_frontend_server(ctx: FrontendContext, host="0.0.0.0", port=8000):
    return make_http_server(_FrontendHandler, {"ctx": ctx}, host, port)
