"""KVBM manager: the engine-side bridge between the device prefix cache and
the lower tiers (host RAM, disk).

The port's copy of `dynamo_tpu/kvbm/manager.py`: the same counters,
events, spans (`kvbm.offload`, `kvbm.onboard`) and flight notes. `Engine`
constructs a KVBM when the prefix cache is on and `kvbm_host_blocks > 0`
and attaches it to its `PrefixCache`. From then on:

- `PrefixCache.evict` DEMOTES sole-owned victim pages through `demote()`
  instead of destroying them; pages the pool can't take fall back to a
  plain free.
- `PrefixCache.lookup` misses consult `onboard_chain()`: consecutive
  blocks found in the host tier are restored into the live pools, gated
  by the roofline restore-vs-recompute check.

On the card (where the JAX manager's `jnp.take` and jitted import become
copies the port orders itself):

- Demote gathers the victim pages into a fresh device tensor on the
  compute stream, so the gather follows every launch queued before it
  (an async decode window in flight included) and precedes every launch
  after it: the freed pages may be written at once, the gathered copy
  keeps their bytes. The pinned arenas are then filled from it on a copy
  stream of the KVBM's own, which waits on the gather's event; each
  slot's copy records an event on the slot (`HostBlockPool.note_copy`),
  and the host reads a slot's bytes only after it (the checksum under
  `integrity=full`, the disk spill).
- Onboard walks the chain on the host first (each block found in host
  RAM claimed, `HostBlockPool.claim`), checks it, asks the gate, makes
  device room and allocates, and only then copies the blocks, ONBOARD_BATCH
  at a time, from their arena slots into a device staging buffer (on the
  compute stream, after each slot's pending copy) and from there into the
  live pools in place (`index_copy_`): the captured decode and verify
  graphs hold the pools' addresses, so there is no new pool and no
  padding, and page 0 (the trash page) is never written. A refused or cut
  onboard copies nothing, and the transient device memory is one batch.
  The suffix's chunk, launched after it on the same stream, reads the
  onboarded pages. int8 rows (scales packed in the row) and MLA's latent
  rows move as whole rows: nothing is re-quantized.
- Only host-side refusals fall back (a full or all-pinned pool, a disk
  I/O error, the gate): the JAX manager recomputes on any exception, the
  port lets a CUDA error propagate to the watchdog's fatal-step path, as
  every other launch's error does.

On the CPU every copy is synchronous and the arenas are pageable.

Every call here runs under the engine's `_exec_lock`: demote and onboard
only fire from `evict()`/`lookup()`, whose callers (admission, page
growth, the drain's demote) all hold it.
"""

from __future__ import annotations

import logging
import threading
import zlib
from typing import Callable, List, Optional, Tuple

import torch

from dynamo_tpu_torch.kvbm.cost_model import OnboardGate
from dynamo_tpu_torch.kvbm.host_pool import DiskBlockTier, HostBlockPool
from dynamo_tpu_torch.observability import tracing as obs_tracing
from dynamo_tpu_torch.robustness.watchdog import integrity_mode

log = logging.getLogger("dynamo_tpu_torch.kvbm")

# blocks an onboard stages on the device at a time (2 MiB a block on the
# 8B at page 16 in bf16)
ONBOARD_BATCH = 16


def _crc(k: torch.Tensor, v: torch.Tensor) -> int:
    """CRC32 of a block's K then V bytes (the JAX manager's order)."""
    kb = k.contiguous().view(torch.uint8).numpy()
    vb = v.contiguous().view(torch.uint8).numpy()
    return zlib.crc32(vb, zlib.crc32(kb))


class KVBM:
    """Tiered KV block manager for one engine."""

    def __init__(self, engine, cfg=None):
        cfg = cfg or engine.cfg
        self.engine = engine
        spec = engine.kv_spec
        self.block_shape = (spec.num_layers, spec.page_size, spec.lane_width)
        self.dtype = getattr(torch, spec.dtype)
        self.device = engine.device
        self._cuda = self.device.type == "cuda"
        disk = None
        if getattr(cfg, "kvbm_disk_dir", None):
            disk = DiskBlockTier(cfg.kvbm_disk_dir,
                                 capacity_blocks=cfg.kvbm_disk_blocks)
        # the card's arenas are page-locked (a failure raises); a CPU
        # engine's stay pageable
        self.pool = HostBlockPool(cfg.kvbm_host_blocks, self.block_shape,
                                  self.dtype, disk=disk, pin=self._cuda)
        self.gate = OnboardGate(
            mode=getattr(cfg, "kvbm_gate", "auto"),
            model_cfg=engine.model_cfg,
            block_nbytes=self.pool.block_nbytes,
            page_size=cfg.page_size,
            prefill_chunk_tokens=cfg.prefill_chunk_tokens or cfg.page_size,
            device=self.device,
        )
        # the demote copies' stream (created at first use on the card)
        self._copy_stream: Optional[torch.cuda.Stream] = None
        # cluster plane hooks (set by the serving layer):
        # events(kind, [hash bytes], tier) -> None; kinds: stored | demoted
        # | removed. peer_fetch stays None: the cross-worker pull needs the
        # transfer plane, which the port has not yet.
        self.events: Optional[Callable[[str, List[bytes], str], None]] = None
        self.peer_fetch = None
        self.tracer = None  # set by ServingContext; spans kvbm.offload/onboard
        # integrity sentinel (DYNAMO_TPU_INTEGRITY=full): CRC32 per demoted
        # block, verified at onboard; a mismatch (host-RAM/disk bit flip)
        # drops the block to a cache miss (recompute) instead of importing
        # silent corruption into the device pool
        self._checksum = integrity_mode() == "full"
        self._crc: dict = {}  # block hash -> crc32 at demote time
        self._lock = threading.Lock()  # counters only
        # counters behind the dynamo_kvbm_* metric series
        self.host_hits_total = 0        # lookups served >= 1 block from tiers
        self.host_hit_blocks_total = 0
        self.host_misses_total = 0      # lookup tails the tiers couldn't serve
        self.demoted_blocks_total = 0
        self.onboarded_blocks_total = 0
        self.peer_onboarded_blocks_total = 0
        self.removed_blocks_total = 0
        self.gate_recompute_total = 0   # onboards the cost gate refused

    # ------------------------------------------------------------- helpers --
    def _emit(self, kind: str, hashes: List[bytes], tier: str) -> None:
        if self.events is None or not hashes:
            return
        try:
            self.events(kind, list(hashes), tier)
        except Exception:  # the event plane must never break serving
            log.exception("kvbm event sink failed")

    def _span(self, name: str, **attrs):
        if self.tracer is None:
            return obs_tracing.NOOP_SPAN
        return self.tracer.start_span(name, attributes=attrs)

    def _flight(self, event: str, **fields):
        """Tier moves land in the engine's flight ring: the KVBM runs on
        the engine thread (evict/onboard inside admission), so the note
        attaches to the very step record whose admission caused the move."""
        flight = getattr(self.engine, "flight", None)
        if flight is not None:
            flight.note(event, **fields)

    def _pages(self, pages: List[int]) -> torch.Tensor:
        return torch.tensor(pages, dtype=torch.long).to(self.device)

    # -------------------------------------------------------------- demote --
    def _gather(self, pages: List[int]) -> Tuple[torch.Tensor, torch.Tensor]:
        """The pages' K and V as [n, L, page, lanes] (one block a row), a
        fresh tensor gathered on the compute stream."""
        eng = self.engine
        idx = self._pages(pages)
        return (eng.k_pages.transpose(0, 1).index_select(0, idx),
                eng.v_pages.transpose(0, 1).index_select(0, idx))

    def _copy_stream_after_gather(self) -> Optional[torch.cuda.Stream]:
        """The copy stream, made to wait for the compute stream's work so
        far (the gather); None on the CPU."""
        if not self._cuda:
            return None
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        self._copy_stream.wait_stream(torch.cuda.current_stream(self.device))
        return self._copy_stream

    def _copy_to_slot(self, slot: int, k: torch.Tensor, v: torch.Tensor,
                      cs: Optional[torch.cuda.Stream]) -> None:
        """One block into an arena slot: on the copy stream on the card,
        after the slot's last copy, its own event noted on the slot."""
        if cs is None:
            self.pool.k_arena[slot].copy_(k)
            self.pool.v_arena[slot].copy_(v)
            return
        with torch.cuda.stream(cs):
            ev = self.pool.slot_event(slot)
            if ev is not None:
                cs.wait_event(ev)
            self.pool.k_arena[slot].copy_(k, non_blocking=True)
            self.pool.v_arena[slot].copy_(v, non_blocking=True)
            done = torch.cuda.Event()
            done.record(cs)
        self.pool.note_copy(slot, done)

    def demote(self, victims: List[Tuple[bytes, int]]) -> int:
        """Spill evicted sole-owned pages into the host tier. One device
        gather covers the whole victim batch; pages the pool cannot take
        (full of pinned entries) are reported `removed` and the caller
        frees them as before. Returns blocks demoted."""
        if not victims:
            return 0
        span = self._span("kvbm.offload", blocks=len(victims))
        try:
            k, v = self._gather([p for _, p in victims])
            cs = self._copy_stream_after_gather()
            demoted, removed, dropped = [], [], []
            for i, (h, _) in enumerate(victims):
                # an LRU eviction to disk reads the evicted slot's bytes
                # after their copy (HostBlockPool settles it)
                slot, fresh, lru_removed = self.pool.reserve(h)
                dropped.extend(lru_removed)
                if slot is None:
                    removed.append(h)
                    continue
                demoted.append(h)
                if fresh:
                    self._copy_to_slot(slot, k[i], v[i], cs)
                if self._checksum:
                    # the host reads the bytes only after their copy
                    self._crc[h] = _crc(*self.pool.view(slot))
            if cs is not None:
                # made on the compute stream, read on the copy stream: the
                # allocator must not hand their memory out before the
                # copies ran
                k.record_stream(cs)
                v.record_stream(cs)
            if self._checksum:
                for h in removed + dropped:
                    self._crc.pop(h, None)
            with self._lock:
                self.demoted_blocks_total += len(demoted)
                self.removed_blocks_total += len(removed) + len(dropped)
            self._emit("demoted", demoted, "host")
            self._emit("removed", removed + dropped, "none")
            span.set_attributes({"demoted": len(demoted),
                                 "removed": len(removed) + len(dropped)})
            self._flight("kvbm_demote", blocks=len(demoted),
                         removed=len(removed) + len(dropped))
            return len(demoted)
        except Exception as e:
            span.set_status("ERROR", f"demote failed: {e}")
            raise
        finally:
            span.end()

    def demote_all(self, prefix_cache) -> int:
        """Graceful-drain handoff: spill EVERY sole-owned prefix page into
        the host tier (prefix_cache.evict routes victims through demote()
        above, which publishes `demoted` events). Caller holds the engine
        exec lock. Returns pages demoted/evicted."""
        return prefix_cache.evict(prefix_cache.evictable())

    def _verify(self, h: bytes, k: torch.Tensor, v: torch.Tensor) -> bool:
        """Onboard-time CRC check (integrity=full). A mismatch means the
        block rotted in host RAM or on disk since demote: drop it from
        every tier (a cache miss — the prefix recomputes, correctly),
        count the fault on the watchdog, and never abort anything — the
        corruption was caught BEFORE it touched the device pool."""
        want = self._crc.get(h)
        if want is None:
            return True  # pre-sentinel block: no claim
        if _crc(k, v) == want:
            return True
        self._crc.pop(h, None)
        self.pool.drop(h)
        with self._lock:
            self.removed_blocks_total += 1
        self._emit("removed", [h], "none")
        self._flight("integrity_fault", sentinel="kv_checksum",
                     block=h.hex()[:16])
        wd = getattr(self.engine, "watchdog", None)
        if wd is not None:
            wd.record_integrity_fault("kv_checksum", [],
                                      block=h.hex()[:16])
        log.warning("kvbm checksum mismatch on block %s; dropped "
                    "(recompute)", h.hex()[:16])
        return False

    # ------------------------------------------------------------- onboard --
    def _upload(self, blocks, pages: List[int]) -> None:
        """Copy the walked blocks ((hash, slot, host tensors)) into the
        live pools' `pages`, in place, on the compute stream, ONBOARD_BATCH
        at a time through a device staging buffer. A block comes from its
        arena slot (after the slot's pending copy; the slot then notes
        this copy's event, so a later host write waits for it), from the
        bytes kept when the LRU reclaimed its slot, or, for a disk hit the
        pool could not take back, from host tensors."""
        eng = self.engine
        cur = torch.cuda.current_stream(self.device) if self._cuda else None
        read = []
        for s in range(0, len(blocks), ONBOARD_BATCH):
            part = blocks[s:s + ONBOARD_BATCH]
            k = torch.empty((len(part),) + self.block_shape,
                            dtype=self.dtype, device=self.device)
            v = torch.empty_like(k)
            for j, (h, slot, host) in enumerate(part):
                src = host if slot is None else self.pool.claimed(h)
                if src is None:
                    ev = (self.pool.slot_event(slot) if cur is not None
                          else None)
                    if ev is not None:
                        cur.wait_event(ev)
                    src = (self.pool.k_arena[slot], self.pool.v_arena[slot])
                    read.append(slot)
                k[j].copy_(src[0], non_blocking=True)
                v[j].copy_(src[1], non_blocking=True)
            idx = self._pages(pages[s:s + len(part)])
            eng.k_pages.transpose(0, 1).index_copy_(0, idx, k)
            eng.v_pages.transpose(0, 1).index_copy_(0, idx, v)
        if cur is not None and read:
            done = torch.cuda.Event()
            done.record(cur)
            for slot in read:
                self.pool.note_copy(slot, done)

    def onboard_chain(self, hashes: List[bytes]) -> List[Tuple[bytes, int]]:
        """Restore the longest consecutive run of `hashes` available in the
        lower tiers back into the device pool. Returns [(hash, page_id)]
        with each new page holding ONE allocator ref (cache-owned, exactly
        like a freshly inserted prefix page); the caller republishes them
        in its hash map. Gated by the restore-vs-recompute check."""
        if not hashes:
            return []
        try:
            return self._onboard(hashes)
        finally:
            self.pool.release_claims()

    def _onboard(self, hashes: List[bytes]) -> List[Tuple[bytes, int]]:
        disk_drops: List[bytes] = []
        blocks = []  # (hash, arena slot or None, host tensors or None)
        for h in hashes:
            slot, host = self.pool.find(h, removed=disk_drops)
            if slot is None and host is None:
                break
            if self._checksum and not self._verify(
                    h, *(self.pool.view(slot) if slot is not None else host)):
                break  # the chain must stay consecutive: stop before it
            if slot is not None:
                self.pool.claim(h)
            blocks.append((h, slot, host))
        source = "host"
        if disk_drops:
            for h in disk_drops:
                self._crc.pop(h, None)
            with self._lock:
                self.removed_blocks_total += len(disk_drops)
            self._emit("removed", disk_drops, "none")
        if not blocks:
            with self._lock:
                self.host_misses_total += 1
            return []
        eng = self.engine
        # cost gate FIRST — a refused onboard must not have demoted other
        # prefixes to make room for nothing
        if not self.gate.should_onboard(len(blocks)):
            with self._lock:
                self.gate_recompute_total += self.gate.skipped
                self.gate.skipped = 0
                self.host_misses_total += 1
            self._flight("kvbm_gate_recompute", blocks=len(blocks),
                         source=source)
            return []
        # make device room by rotating OTHER sole-owned cache entries down
        # a tier (they demote, not die — the incoming prefix is the hot
        # one); the chain's own hashes are protected from eviction, and
        # whatever room can't be made truncates the onboard
        free = eng.allocator.free_pages
        if len(blocks) > free and eng.prefix_cache is not None:
            eng.prefix_cache.evict(len(blocks) - free,
                                   protect=frozenset(hashes))
            free = eng.allocator.free_pages
        if len(blocks) > free:
            blocks = blocks[:free]
        if not blocks:
            with self._lock:
                self.host_misses_total += 1
            return []
        span = self._span("kvbm.onboard", blocks=len(blocks), source=source)
        try:
            pages = eng.allocator.alloc(len(blocks))
            self._upload(blocks, pages)
            out = [(h, p) for (h, _, _), p in zip(blocks, pages)]
            with self._lock:
                self.host_hits_total += 1
                self.host_hit_blocks_total += len(out)
                self.onboarded_blocks_total += len(out)
            self._emit("stored", [h for h, _ in out], "device")
            span.set_attribute("onboarded", len(out))
            self._flight("kvbm_onboard", blocks=len(out), source=source)
            return out
        except Exception as e:
            span.set_status("ERROR", f"onboard failed: {e}")
            raise
        finally:
            span.end()

    # --------------------------------------------------------------- stats --
    def stats(self) -> dict:
        with self._lock:
            out = {
                "host_hits_total": self.host_hits_total,
                "host_hit_blocks_total": self.host_hit_blocks_total,
                "host_misses_total": self.host_misses_total,
                "demoted_blocks_total": self.demoted_blocks_total,
                "onboarded_blocks_total": self.onboarded_blocks_total,
                "peer_onboarded_blocks_total": self.peer_onboarded_blocks_total,
                "removed_blocks_total": self.removed_blocks_total,
                "gate_recompute_total": self.gate_recompute_total,
            }
        out["host_pool"] = self.pool.stats()
        out["gate"] = self.gate.explain(1)
        return out
