"""Live memory-accounting plane: device memory gauges + exact KV-pool books.

Two evidence classes, deliberately kept apart:

- **Runtime-reported**: PyTorch's caching allocator on the engine's CUDA
  device — `bytes_in_use` is `torch.cuda.memory_stats()`'s
  `allocated_bytes.all.current`, `peak_bytes_in_use` its
  `allocated_bytes.all.peak`, `bytes_limit` the card's total memory
  (`torch.cuda.mem_get_info()[1]`, read once when the bridge is built).
  The allocator's counters are host-side books: a snapshot never touches
  the device. The CPU reports nothing, which degrades to no device rows.
- **Model-derived (exact)**: the KV page pool's ground truth, computed
  from `KVCacheSpec.bytes_per_token() × page_size` and the allocator's
  page books.  Every device page is attributed to exactly ONE owner —
  sequence tenant, inflight prefill, prefix cache ("cache"),
  unattributed-but-allocated ("other"), "free", or "trash" — so the
  device-tier bytes SUM to `num_pages × page_bytes` identically, which is
  the K and V pools' `nbytes` together. The draft model's pool is a tier
  of its own with the same guarantee; LoRA slot residency rides along.

Exported as `dynamo_memory_*` gauges plus the `dynamo_tenant_cost_*`
counters (the engine's CostLedger read at scrape time), and as the
`memory` section of `/worker/stats`.

The port's counterpart of `dynamo_tpu/observability/memory.py` (it
imports nothing of the JAX package): the books and series are the JAX
module's, the KVBM's host and disk tiers included (`host` and `disk`,
each its held blocks' bytes and its free room) and the parked
disaggregated pages (a prefill role's, claimed for their request's tenant);
the weight double buffer (`elasticity/weights.py`) has its rows in
`dynamo_memory_staged_weights_bytes`.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

import torch

from dynamo_tpu_torch.serving.metrics import (
    CallbackCounter,
    CallbackCounterVec,
    Gauge,
    Registry,
)

log = logging.getLogger("dynamo_tpu_torch.memory")


def device_memory_stats(device, bytes_limit: int = 0
                        ) -> List[Dict[str, Any]]:
    """The caching allocator's books for the engine's device (one row);
    empty on the CPU. `bytes_limit`: the card's total memory."""
    device = torch.device(device)
    if device.type != "cuda":
        return []
    ms = torch.cuda.memory_stats(device)
    return [{
        "device": f"cuda:{device.index or 0}",
        "bytes_in_use": int(ms.get("allocated_bytes.all.current", 0)),
        "bytes_limit": int(bytes_limit),
        "peak_bytes_in_use": int(ms.get("allocated_bytes.all.peak", 0)),
    }]


class MemoryAccountant:
    """Exact, disjoint attribution of the engine's KV page pool."""

    def __init__(self, engine):
        self.engine = engine
        spec = engine.kv_spec
        self.page_bytes = spec.bytes_per_token() * spec.page_size
        self.bytes_limit = 0
        if engine.device.type == "cuda":
            self.bytes_limit = torch.cuda.mem_get_info(engine.device)[1]

    # ------------------------------------------------------------ books ----
    def _page_owners(self):
        """One pass over the engine's holders: page -> (tenant, adapter).
        First claim wins (slot order, then inflight, parked, cache), so a
        cache page shared with a live sequence counts once, for the
        sequence — disjointness is what makes the sums exact."""
        eng = self.engine
        tenant_of: Dict[int, str] = {}
        adapter_of: Dict[int, str] = {}

        def claim(pages, tenant: str, adapter: str) -> None:
            for p in pages:
                if p > 0 and p not in tenant_of:
                    tenant_of[p] = tenant
                    adapter_of[p] = adapter

        for slot in sorted(list(eng.seqs)):
            seq = eng.seqs.get(slot)
            if seq is None:
                continue
            req = getattr(seq, "req", None)
            tenant = (eng._tenant_of(req) if req is not None else "default")
            adapter = (getattr(req, "adapter", None) or "base"
                       if req is not None else "base")
            claim(list(seq.pages), tenant, adapter)
        inf = eng._inflight
        if inf is not None:
            req = getattr(inf, "req", None)
            tenant = (eng._tenant_of(req) if req is not None else "default")
            adapter = (getattr(req, "adapter", None) or "base"
                       if req is not None else "base")
            claim(list(getattr(inf, "pages", ()) or ()), tenant, adapter)
        for rid, parked in list(eng._parked.items()):
            claim(list(parked[0]), eng._rid_tenant.get(rid, "default"),
                  "base")
        pc = eng.prefix_cache
        if pc is not None:
            for ns, pages in pc.pages_by_namespace().items():
                claim(pages, "cache", ns or "base")
        return tenant_of, adapter_of

    def snapshot(self) -> Dict[str, Any]:
        eng = self.engine
        alloc = eng.allocator
        pb = self.page_bytes
        total_pages = alloc.num_pages
        # holder iteration races the scheduler thread (same license the
        # existing /worker/stats reads run under); retry the rare
        # mutated-mid-iteration pass rather than locking the hot loop
        for attempt in range(3):
            try:
                free_pages = alloc.free_pages
                tenant_of, adapter_of = self._page_owners()
                break
            except RuntimeError:
                if attempt == 2:
                    raise
        by_tenant: Dict[str, int] = {}
        for t in tenant_of.values():
            by_tenant[t] = by_tenant.get(t, 0) + 1
        by_adapter: Dict[str, int] = {}
        for a in adapter_of.values():
            by_adapter[a] = by_adapter.get(a, 0) + 1
        claimed = len(tenant_of)
        # force the partition exact even when free_pages moved between the
        # two reads: claimed + free + other + trash == total, always
        free_pages = min(free_pages, max(0, total_pages - 1 - claimed))
        other = max(0, total_pages - 1 - free_pages - claimed)

        device_bytes = {t: n * pb for t, n in sorted(by_tenant.items())}
        if other:
            device_bytes["other"] = other * pb
        device_bytes["free"] = free_pages * pb
        device_bytes["trash"] = pb  # page 0, never allocated
        tiers: Dict[str, Dict[str, int]] = {"device": device_bytes}

        # Speculation v3: the draft model's KV pool is its own tier — a
        # first-class tenant of the memory plane with the same exact-sum
        # guarantee (the DraftEngine forces its partition the same way the
        # device tier is forced above)
        draft = eng.draft
        if draft is not None:
            tiers["draft"] = draft.partition_bytes()

        # the KVBM's host arenas and disk tier, each partitioned into the
        # blocks it holds and its free room
        kvbm = getattr(eng, "kvbm", None)
        kvbm_stats = None
        if kvbm is not None:
            kvbm_stats = kvbm.pool.stats()
            bn = int(kvbm_stats.get("block_nbytes", 0))
            used = int(kvbm_stats.get("used_blocks", 0))
            cap = int(kvbm_stats.get("capacity_blocks", 0))
            tiers["host"] = {"cache": used * bn,
                             "free": max(0, cap - used) * bn}
            disk = kvbm_stats.get("disk")
            if disk:
                dused = int(disk.get("used_blocks", 0))
                dcap = int(disk.get("capacity_blocks", 0))
                tiers["disk"] = {"cache": dused * bn,
                                 "free": max(0, dcap - dused) * bn}

        lora = eng.lora
        lora_out: Optional[Dict[str, Any]] = None
        if lora is not None:
            resident = sorted(lora.resident())
            slots_total = int(getattr(eng.cfg, "lora_slots", 0) or 0)
            lora_out = {
                "slots_total": slots_total,
                "resident": resident,
                "slots_free": max(0, slots_total - len(resident)),
            }

        # live elasticity: the weight double buffer, staged and retained
        # rollback weights, device bytes OUTSIDE the KV pool partition
        wm = getattr(eng, "weights", None)
        weights_out: Optional[Dict[str, Any]] = None
        if wm is not None:
            weights_out = {
                "version": wm.version,
                "staged_version": wm.staged_version,
                "staged_bytes": wm.staged_nbytes,
                "previous_version": wm.previous_version,
                "previous_bytes": wm.previous_nbytes,
            }

        return {
            "page_bytes": pb,
            "kv_dtype": eng.kv_spec.dtype,
            "pool": {
                "total_pages": total_pages,
                "free_pages": free_pages,
                "used_pages": claimed + other,
                "trash_pages": 1,
                "total_bytes": total_pages * pb,
                "used_bytes": (claimed + other) * pb,
                "free_bytes": free_pages * pb,
            },
            "device_pages_by_tenant": dict(sorted(by_tenant.items())),
            "device_pages_by_adapter": dict(sorted(by_adapter.items())),
            "tiers": tiers,
            "kvbm": kvbm_stats,
            "lora": lora_out,
            "weights": weights_out,
            "devices": device_memory_stats(eng.device, self.bytes_limit),
        }


class MemoryMetricsBridge:
    """Registers the dynamo_memory_* / dynamo_tenant_cost_* /
    dynamo_flight_* series and refreshes the gauges at scrape time."""

    def __init__(self, registry: Registry, engine):
        self.engine = engine
        self.accountant = MemoryAccountant(engine)
        self.pool_gauge = Gauge(
            "dynamo_memory_kv_pool_bytes",
            "KV cache bytes by tier (device/host/disk) and owner: tenant "
            "names plus cache/other/free/trash — each tier's samples sum "
            "to that tier's capacity (exact model-derived accounting)",
            registry, labelnames=("tier", "tenant"))
        self.pages_gauge = Gauge(
            "dynamo_memory_kv_pages",
            "Device KV page pool occupancy by state",
            registry, labelnames=("state",))
        self.device_gauge = Gauge(
            "dynamo_memory_device_bytes",
            "Runtime-reported device memory (the caching allocator's "
            "allocated bytes, now and at peak, and the card's total; no "
            "rows on the CPU)",
            registry, labelnames=("device", "kind"))
        self.lora_gauge = Gauge(
            "dynamo_memory_lora_slots",
            "LoRA adapter device-slot residency",
            registry, labelnames=("state",))
        self.weights_gauge = Gauge(
            "dynamo_memory_staged_weights_bytes",
            "Weight double-buffer device bytes held by live elasticity: "
            "buffer=staged (loaded, not yet flipped) / previous (retained "
            "for rollback until commit or the next stage)",
            registry, labelnames=("buffer",))
        ledger = engine.cost
        CallbackCounterVec(
            "dynamo_tenant_cost_chip_seconds_total",
            "Per-tenant attributed engine busy time (decode slots and "
            "prefill token shares x segment wall time); tenants sum to "
            "dynamo_engine_busy_seconds_total",
            registry, lambda: {(("tenant", t),): v for t, v in
                               ledger.chip_seconds_snapshot().items()},
            labelnames=("tenant",))
        CallbackCounterVec(
            "dynamo_tenant_cost_hbm_byte_seconds_total",
            "Per-tenant KV residency cost (bytes held on device x wall "
            "time); tenants sum to dynamo_engine_hbm_byte_seconds_total",
            registry, lambda: {(("tenant", t),): v for t, v in
                               ledger.hbm_byte_seconds_snapshot().items()},
            labelnames=("tenant",))
        CallbackCounter(
            "dynamo_engine_busy_seconds_total",
            "Engine wall time attributed across tenants (conservation "
            "denominator for dynamo_tenant_cost_chip_seconds_total)",
            registry, lambda: ledger.chip_seconds_total)
        CallbackCounter(
            "dynamo_engine_hbm_byte_seconds_total",
            "KV byte-seconds attributed across tenants (conservation "
            "denominator for dynamo_tenant_cost_hbm_byte_seconds_total)",
            registry, lambda: ledger.hbm_byte_seconds_total)
        flight = engine.flight
        CallbackCounter(
            "dynamo_flight_steps_total",
            "Engine steps committed to the flight-recorder ring",
            registry, lambda: flight.steps_total)
        CallbackCounter(
            "dynamo_flight_dropped_total",
            "Flight records displaced from the bounded ring",
            registry, lambda: flight.dropped_total)
        self._pool_labels: set = set()
        self._device_labels: set = set()

    # ---------------------------------------------------------- refresh ----
    def refresh(self) -> None:
        try:
            snap = self.accountant.snapshot()
        except Exception:
            log.exception("memory snapshot failed")
            return
        live = set()
        for tier, owners in snap["tiers"].items():
            for tenant, nbytes in owners.items():
                self.pool_gauge.set(float(nbytes), tier=tier, tenant=tenant)
                live.add((tier, tenant))
        for tier, tenant in self._pool_labels - live:
            # a tenant whose last page was freed must drop to zero, not
            # freeze at its final nonzero sample
            self.pool_gauge.remove(tier=tier, tenant=tenant)
        self._pool_labels = live

        pool = snap["pool"]
        self.pages_gauge.set(float(pool["used_pages"]), state="used")
        self.pages_gauge.set(float(pool["free_pages"]), state="free")
        self.pages_gauge.set(float(pool["trash_pages"]), state="trash")

        dev_live = set()
        for d in snap["devices"]:
            for kind, key in (("in_use", "bytes_in_use"),
                              ("limit", "bytes_limit"),
                              ("peak", "peak_bytes_in_use")):
                self.device_gauge.set(float(d[key]),
                                      device=d["device"], kind=kind)
                dev_live.add((d["device"], kind))
        for device, kind in self._device_labels - dev_live:
            self.device_gauge.remove(device=device, kind=kind)
        self._device_labels = dev_live

        lora = snap.get("lora")
        if lora:
            self.lora_gauge.set(float(lora["slots_total"]), state="total")
            self.lora_gauge.set(float(len(lora["resident"])),
                                state="resident")
            self.lora_gauge.set(float(lora["slots_free"]), state="free")

        w = snap.get("weights")
        if w:
            self.weights_gauge.set(float(w["staged_bytes"]),
                                   buffer="staged")
            self.weights_gauge.set(float(w["previous_bytes"]),
                                   buffer="previous")


def attach_memory_metrics(registry: Registry, engine) -> MemoryMetricsBridge:
    return MemoryMetricsBridge(registry, engine)
