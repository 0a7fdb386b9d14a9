"""Per-tenant QoS: identity, weighted-fair budgets, SLO-aware admission.

The port's own copy of `dynamo_tpu/qos/tenancy.py` (its logger's name
changed only; keep the two in step). The operator's knob keeps its name,
``DYNAMO_TPU_TENANTS``.

A million-user fleet is multi-tenant; before this plane, admission was one
global ``DYNAMO_TPU_MAX_INFLIGHT`` gate and scheduling was priority-FIFO
with no tenant identity — one tenant's burst degraded every tenant
equally. This module (stdlib-only, jax-free) provides the three shared
pieces the serving stack composes (docs/robustness.md "Per-tenant QoS";
RTP-LLM ships this class of production multi-tenant scheduling):

- **Identity** — ``TenantRegistry``: tenant classes declared via the
  ``DYNAMO_TPU_TENANTS`` JSON env (the operator materializes the manifest
  ``tenants:`` key into it), resolved per-request from ``x-tenant-id`` /
  ``x-api-key`` / ``Authorization: Bearer`` headers at the edge; the
  frontend forwards its decision downstream as ``x-dynamo-tenant`` so the
  worker, disagg prefill RPC, and recovery continuations all agree.
- **Weighted-fair token budgets** — ``TenantAccountant``: a per-tenant
  balance debited one unit per decoded token and credited from TOTAL
  decode throughput in weight proportion across tenants with live demand.
  A tenant running alone nets zero (never over budget — QoS must be
  work-conserving); a tenant consuming beyond its weight share under
  contention goes negative and becomes the preferred preemption victim /
  deferred admission. No wall clock anywhere: budget dynamics are a pure
  function of token counts, so CI drives them deterministically.
- **Per-tenant admission** — ``TenantAdmission``: weighted in-flight caps
  derived from the global bound (or explicit ``max_inflight`` per class),
  plus the Retry-After derivation: a shed tenant is told to come back in
  its own expected slot-refill time (EWMA request duration / in-flight),
  not after a global jittered constant.

Tenant names feed metric labels and span attributes, so identity is
sanitized and unknown-id cardinality is bounded (``MAX_DYNAMIC_TENANTS``,
overflow maps to ``other``).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import re
import threading
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

log = logging.getLogger("dynamo_tpu_torch.qos")

TENANTS_ENV = "DYNAMO_TPU_TENANTS"
# frontend -> worker: the resolved tenant identity rides this header so
# every downstream hop (worker, disagg prefill RPC, recovery continuation
# re-dispatch) sees the same decision the edge made
RESOLVED_HEADER = "x-dynamo-tenant"
DEFAULT_TENANT = "default"
# label-cardinality bound for ids that arrive via x-tenant-id without a
# configured class: beyond this many distinct names, map to "other"
MAX_DYNAMIC_TENANTS = 64
OTHER_TENANT = "other"
# request priority bounds (vLLM semantics: lower admits sooner); shared
# with serving/protocol.py's request validation
PRIORITY_MIN, PRIORITY_MAX = -100, 100
# engine preemption-rank penalty for over-budget tenants: large enough to
# dominate any legal (request priority + class priority) sum, so an
# over-budget tenant's sequences are always the preferred victims
OVER_BUDGET_PENALTY = 1 << 10
# queue-order penalty for batch-class tenants: dominates any legal
# (request priority + class priority) sum, so batch work never queues
# ahead of interactive work whatever its declared priority; the engine's
# victim rank adds BATCH_VICTIM_PENALTY (> OVER_BUDGET_PENALTY) so batch
# sequences are preempted before even a misbehaving interactive tenant
BATCH_PRIORITY_PENALTY = 1 << 9
BATCH_VICTIM_PENALTY = 1 << 11

_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._:-]{0,47}$")

_CLASS_KEYS = {  # accepted spec keys: snake_case (env) and camelCase (manifest)
    "name": "name", "weight": "weight", "priority": "priority",
    "max_inflight": "max_inflight", "maxInflight": "max_inflight",
    "api_keys": "api_keys", "apiKeys": "api_keys",
    "burst_tokens": "burst_tokens", "burstTokens": "burst_tokens",
    "batch": "batch",
}


def sanitize_tenant(name: str) -> Optional[str]:
    """A tenant name that is safe as a metric label / span attr, or None."""
    name = (name or "").strip()
    return name if _NAME_RE.match(name) else None


@dataclasses.dataclass(frozen=True)
class TenantClass:
    """One declared tenant: scheduling weight, priority class, caps."""

    name: str
    weight: float = 1.0          # weighted-fair share (relative)
    priority: int = 0            # engine priority offset (lower = sooner)
    max_inflight: Optional[int] = None  # explicit in-flight cap (frontend)
    api_keys: Tuple[str, ...] = ()      # exact-match keys that resolve here
    burst_tokens: Optional[int] = None  # budget clamp override (engine)
    batch: bool = False          # preemptible offline lane (docs/robustness.md)

    def to_dict(self) -> Dict[str, Any]:
        d = {"name": self.name, "weight": self.weight,
             "priority": self.priority}
        if self.max_inflight is not None:
            d["max_inflight"] = self.max_inflight
        if self.api_keys:
            d["api_keys"] = list(self.api_keys)
        if self.burst_tokens is not None:
            d["burst_tokens"] = self.burst_tokens
        if self.batch:
            d["batch"] = True
        return d


def tenant_from_dict(spec: Mapping[str, Any]) -> TenantClass:
    """Validate one tenant spec (env JSON or operator manifest). Unknown
    keys fail loudly — a typo'd QoS class is a missing QoS class."""
    unknown = set(spec) - set(_CLASS_KEYS)
    if unknown:
        raise ValueError(f"unknown tenants keys: {sorted(unknown)}")
    kw: Dict[str, Any] = {}
    for k, v in spec.items():
        field = _CLASS_KEYS[k]
        if field == "name":
            name = sanitize_tenant(str(v))
            if name is None:
                raise ValueError(f"invalid tenant name {v!r}")
            kw["name"] = name
        elif field == "weight":
            w = float(v)
            if not w > 0:
                raise ValueError(f"tenant weight must be > 0, got {v!r}")
            kw["weight"] = w
        elif field == "priority":
            p = int(v)
            if not PRIORITY_MIN <= p <= PRIORITY_MAX:
                raise ValueError(
                    f"tenant priority must be in "
                    f"[{PRIORITY_MIN}, {PRIORITY_MAX}], got {v!r}")
            kw["priority"] = p
        elif field == "max_inflight":
            kw["max_inflight"] = max(0, int(v))
        elif field == "batch":
            if not isinstance(v, bool):
                raise ValueError(f"tenant batch must be a bool, got {v!r}")
            kw["batch"] = v
        elif field == "burst_tokens":
            kw["burst_tokens"] = max(1, int(v))
        elif field == "api_keys":
            if not isinstance(v, (list, tuple)):
                raise ValueError("api_keys must be a list of strings")
            kw["api_keys"] = tuple(str(k) for k in v)
    if "name" not in kw:
        raise ValueError("tenant specs need a 'name'")
    return TenantClass(**kw)


class TenantRegistry:
    """Tenant classes + per-request identity resolution.

    With no classes configured the registry is *disabled*: every request
    resolves to ``default``, weights are moot, and callers skip the QoS
    machinery entirely — an untenanted deployment behaves byte-identically
    to the pre-QoS stack."""

    def __init__(self, classes: Iterable[TenantClass] = ()):
        self.classes: Dict[str, TenantClass] = {}
        self._by_key: Dict[str, str] = {}
        for c in classes:
            self.classes[c.name] = c
            for k in c.api_keys:
                self._by_key[k] = c.name
        self._default = self.classes.get(
            DEFAULT_TENANT, TenantClass(DEFAULT_TENANT))
        self._dynamic: set = set(self.classes)
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return bool(self.classes)

    @classmethod
    def from_json(cls, raw: Optional[str]) -> "TenantRegistry":
        """Parse the DYNAMO_TPU_TENANTS JSON (a list of tenant specs).
        Malformed config is logged and ignored — QoS config must never
        stop a process from serving."""
        if not raw:
            return cls()
        try:
            specs = json.loads(raw)
            if not isinstance(specs, list):
                raise ValueError("must be a JSON list of tenant specs")
            return cls([tenant_from_dict(s) for s in specs])
        except (ValueError, TypeError) as e:
            log.warning("ignoring malformed %s: %s", TENANTS_ENV, e)
            return cls()

    @classmethod
    def from_env(cls, env: Optional[Mapping[str, str]] = None
                 ) -> "TenantRegistry":
        env = os.environ if env is None else env
        return cls.from_json(env.get(TENANTS_ENV))

    # ----------------------------------------------------------- identity --
    def resolve(self, headers, trusted: bool = False) -> str:
        """Resolve a request's tenant from its HTTP headers.

        Order: the internal ``x-dynamo-tenant`` (only when ``trusted`` —
        workers trust the frontend's edge decision; the edge itself
        ignores it), then ``x-tenant-id`` (a configured name, or a bounded
        dynamic identity under default-class parameters), then
        ``x-api-key`` / ``Authorization: Bearer`` against the configured
        key map. Everything else is ``default``."""
        get = headers.get
        if trusted:
            name = sanitize_tenant(get(RESOLVED_HEADER) or "")
            if name:
                return self._bound(name)
        name = sanitize_tenant(get("x-tenant-id") or "")
        if name:
            return self._bound(name)
        key = (get("x-api-key") or "").strip()
        if not key:
            auth = (get("authorization") or get("Authorization") or "").strip()
            if auth.lower().startswith("bearer "):
                key = auth[7:].strip()
        if key and key in self._by_key:
            return self._by_key[key]
        return DEFAULT_TENANT

    def _bound(self, name: str) -> str:
        """Admit a dynamic tenant name under the cardinality bound."""
        if name in self.classes:
            return name
        with self._lock:
            if name in self._dynamic:
                return name
            if len(self._dynamic) >= MAX_DYNAMIC_TENANTS + len(self.classes):
                return OTHER_TENANT
            self._dynamic.add(name)
            return name

    def cls(self, name: str) -> TenantClass:
        """The class governing `name` (dynamic ids inherit the default
        class's parameters under their own identity)."""
        c = self.classes.get(name)
        if c is not None:
            return c
        return dataclasses.replace(self._default, name=name,
                                   api_keys=(), max_inflight=None)

    def is_batch(self, name: str) -> bool:
        """Does `name` belong to a preemptible batch class? (Dynamic ids
        inherit the default class, which is interactive unless the
        operator explicitly declared ``default`` as batch.)"""
        return self.cls(name).batch

    def batch_tenants(self) -> List[str]:
        return sorted(n for n, c in self.classes.items() if c.batch)

    def weights(self, names: Iterable[str]) -> Dict[str, float]:
        return {n: self.cls(n).weight for n in names}

    def describe(self) -> List[Dict[str, Any]]:
        return [c.to_dict() for c in self.classes.values()]


class TenantAccountant:
    """Engine-side weighted-fair token-budget accountant.

    Pure token arithmetic, no clock: ``account()`` is called once per
    scheduler step with the tokens each tenant decoded and the set of
    tenants with live demand (running or queued). Each produced token
    debits its tenant 1.0 and the step's TOTAL production is credited to
    every demanding tenant in weight proportion — so balances measure
    deviation from the tenant's weighted-fair share of actual throughput,
    refill exactly as fast as the engine decodes, and a tenant running
    alone nets zero (work conservation: an idle fleet never throttles).
    Balances clamp to ±burst so an idle tenant cannot bank an unbounded
    claim and an aggressor's debt stays repayable.

    Speculative decoding: produced counts are TokenEvents, i.e. ACCEPTED
    tokens only — a verify window that proposes K drafts and lands n
    debits n+1, never K+1. Rejected drafts are the operator's compute
    bet (docs/perf.md "Speculative decoding v2"), not the tenant's
    budget."""

    def __init__(self, registry: TenantRegistry, burst_tokens: int = 512):
        self.registry = registry
        self.burst = max(1, int(burst_tokens))
        self.balance: Dict[str, float] = {}
        self.tokens_total: Dict[str, int] = {}
        self.preempted_total: Dict[str, int] = {}
        self.deferred_total: Dict[str, int] = {}
        self._lock = threading.Lock()

    def _clamp(self, name: str, v: float) -> float:
        b = self.registry.cls(name).burst_tokens or self.burst
        return max(-float(b), min(float(b), v))

    def account(self, produced: Mapping[str, int],
                demand: Iterable[str]) -> None:
        total = sum(produced.values())
        if total <= 0:
            return
        ws = self.registry.weights(set(demand) | set(produced))
        wsum = sum(ws.values()) or 1.0
        with self._lock:
            for t, n in produced.items():
                self.balance[t] = self.balance.get(t, 0.0) - n
                self.tokens_total[t] = self.tokens_total.get(t, 0) + int(n)
            for t, w in ws.items():
                self.balance[t] = self._clamp(
                    t, self.balance.get(t, 0.0) + total * w / wsum)

    def over_budget(self, name: str) -> bool:
        """Has `name` consumed beyond its weighted-fair share? (Strictly
        negative balance; a tenant at exactly its share is well-behaved.)"""
        with self._lock:
            return self.balance.get(name, 0.0) < -1e-9

    def slot_cap(self, name: str, max_slots: int,
                 demand: Iterable[str]) -> int:
        """Fair decode-slot share for `name` among the demanding tenants
        (ceil of the weighted share; always >= 1 so no tenant starves)."""
        ws = self.registry.weights(set(demand) | {name})
        wsum = sum(ws.values()) or 1.0
        return max(1, math.ceil(max_slots * ws.get(name, 1.0) / wsum))

    def note_preempt(self, name: str) -> None:
        with self._lock:
            self.preempted_total[name] = self.preempted_total.get(name, 0) + 1

    def note_defer(self, name: str) -> None:
        with self._lock:
            self.deferred_total[name] = self.deferred_total.get(name, 0) + 1

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "burst_tokens": self.burst,
                "balance": {t: round(v, 3)
                            for t, v in sorted(self.balance.items())},
                "tokens_total": dict(sorted(self.tokens_total.items())),
                "preempted_total": dict(sorted(self.preempted_total.items())),
                "deferred_total": dict(sorted(self.deferred_total.items())),
            }


class TenantAdmission:
    """Frontend-side per-tenant admission state.

    In-flight caps are the tenant's weighted share of the global bound
    (explicit ``max_inflight`` in the class overrides; caps deliberately
    overcommit — QoS protects share, the global bound protects the
    process). ``retry_after_s`` is the shed tenant's own budget-refill
    time: the EWMA of its request durations divided by its in-flight
    count — the expected wait until one of ITS slots frees — replacing
    the global jittered constant for tenant sheds.

    **Fleet-wide counters (serving/ha.py)**: with N frontend replicas,
    ``peer_counts_fn`` (wired to TenantGossip.peer_counts) folds the
    other replicas' gossiped per-tenant in-flight into the cap and
    over-share checks, so a tenant cannot multiply its budget by N by
    spraying the VIP — the caps hold FLEET-wide within the gossip
    staleness bound. Decisions stay local; only the counters widen."""

    EWMA_ALPHA = 0.2

    def __init__(self, registry: TenantRegistry, global_max: int):
        self.registry = registry
        self.global_max = max(0, int(global_max))
        self._inflight: Dict[str, int] = {}
        self._ewma_s: Dict[str, float] = {}
        self._lock = threading.Lock()
        # optional () -> {tenant: peer in-flight} (bounded-staleness
        # approximate; never raises — a broken plane degrades to local)
        self.peer_counts_fn = None

    def _peer_counts(self) -> Dict[str, int]:
        fn = self.peer_counts_fn
        if fn is None:
            return {}
        try:
            return dict(fn())
        except Exception:
            log.exception("tenant gossip peer view failed; using local")
            return {}

    def cap(self, tenant: str) -> int:
        """Per-tenant in-flight cap (0 = unbounded)."""
        c = self.registry.cls(tenant)
        if c.max_inflight is not None:
            return c.max_inflight
        if not self.registry.enabled or not self.global_max:
            return 0
        wsum = sum(x.weight for x in self.registry.classes.values()) or 1.0
        return max(1, int(self.global_max * c.weight / wsum))

    def inflight(self, tenant: str) -> int:
        with self._lock:
            return self._inflight.get(tenant, 0)

    def try_admit(self, tenant: str) -> bool:
        """Reserve one in-flight slot for `tenant` unless it is at its
        cap — counting gossiped peer-replica in-flight, so the cap is a
        fleet bound, not a per-process one the tenant can multiply by
        spraying replicas. The caller MUST pair a True return with
        release()."""
        cap = self.cap(tenant)
        peers = self._peer_counts().get(tenant, 0) if cap else 0
        with self._lock:
            n = self._inflight.get(tenant, 0)
            if cap and n + peers >= cap:
                return False
            self._inflight[tenant] = n + 1
            return True

    def admit_unchecked(self, tenant: str) -> None:
        """Count an admission that bypassed the cap (registry disabled)."""
        with self._lock:
            self._inflight[tenant] = self._inflight.get(tenant, 0) + 1

    def release(self, tenant: str, duration_s: Optional[float] = None) -> None:
        with self._lock:
            n = self._inflight.get(tenant, 0)
            if n > 1:
                self._inflight[tenant] = n - 1
            else:
                self._inflight.pop(tenant, None)
            if duration_s is not None and duration_s >= 0:
                prev = self._ewma_s.get(tenant)
                self._ewma_s[tenant] = (
                    duration_s if prev is None
                    else prev + self.EWMA_ALPHA * (duration_s - prev))

    def over_share(self, tenant: str) -> bool:
        """Is `tenant` holding more than its weighted share of the CURRENT
        total in-flight load? (The slo_burn shed predicate: when the SLO
        is burning, only tenants over their share are shed.)"""
        if not self.registry.enabled:
            return False
        peers = self._peer_counts()
        with self._lock:
            total = sum(self._inflight.values()) + sum(peers.values())
            mine = (self._inflight.get(tenant, 0) + peers.get(tenant, 0))
            ws = self.registry.weights(
                set(self._inflight) | set(peers) | {tenant})
        wsum = sum(ws.values()) or 1.0
        return total > 0 and mine > (total * ws.get(tenant, 1.0) / wsum)

    def retry_after_s(self, tenant: str) -> float:
        """The tenant's budget-refill time: expected seconds until one of
        its in-flight slots frees (EWMA duration / in-flight), clamped to
        [0.2s, 30s]. A tenant with nothing in flight (shed by the global
        bound or an SLO burn) gets its full EWMA duration."""
        with self._lock:
            dur = self._ewma_s.get(tenant, 1.0)
            n = self._inflight.get(tenant, 0)
        return max(0.2, min(30.0, dur / max(1, n)))

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            out = {
                "inflight": dict(sorted(self._inflight.items())),
                "ewma_duration_s": {t: round(v, 4)
                                    for t, v in sorted(self._ewma_s.items())},
                "caps": {t: self.cap(t) for t in sorted(self.registry.classes)},
            }
        if self.peer_counts_fn is not None:
            out["peer_inflight"] = dict(sorted(self._peer_counts().items()))
        return out
