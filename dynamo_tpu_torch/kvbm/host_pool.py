"""Bounded host-RAM block pool (+ optional disk tier) for demoted KV pages.

The port's copy of `dynamo_tpu/kvbm/host_pool.py`. One block = one KV
page's K and V slabs ([num_layers, page_size, lane_width] each, the exact
device-page layout of engine/kv_cache.py), keyed by the PrefixCache's
rolling block-hash digest, so a demoted page round-trips back onto the
device bit-exactly for any KV dtype (bf16, fp32, packed int8 rows).

The arena is PREALLOCATED at construction, one tensor per device pool
([capacity, L, page_size, lane_width] for K and one for V, in the pools'
dtype): the steady-state demote path only copies into it, never
allocates, so the host-RAM footprint is a config knob
(`kvbm_host_blocks * block_nbytes`), not a traffic function. For an
engine on the card the arenas are page-locked (`pin=True`), so the copies
between them and the device run as DMA without a staging copy; pinning
that fails raises. A CPU engine keeps pageable memory (a CPU-only torch
cannot pin). Eviction is LRU over unpinned entries; `pin`/`unpin` protect
a block while a peer streams it (an LRU eviction mid-serve would hand the
peer another block's bytes).

Device copies into and out of a slot are asynchronous: the manager
records each one's CUDA event on the slot (`note_copy`), and every host
read or write of a slot's bytes (the disk spill, a promotion from disk,
`get`, the checksums) waits for it first (`settle`).

An onboard walks its chain first and copies the blocks to the device
only once it knows how many it restores: it `claim`s each block it finds
in host RAM, and a claimed block whose slot the LRU reclaims meanwhile (a
disk promotion further down the chain, a demote making device room) has
its bytes kept aside first (`claimed`). The LRU order stays the JAX
pool's: the chain's host copies are about to be redundant (the device
gets them), so they may go, where pinning them would turn the room-making
demote's victims away.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, List, Optional, Tuple

import torch

log = logging.getLogger("dynamo_tpu_torch.kvbm")


def _raw(t: torch.Tensor) -> bytes:
    """A tensor's bytes, C order (bf16 has no numpy dtype: go through
    uint8)."""
    return t.contiguous().view(torch.uint8).numpy().tobytes()


class DiskBlockTier:
    """Disk tier behind the host pool: blocks LRU-evicted from host RAM
    spill here (bounded by `capacity_blocks`); host-pool misses check it
    before giving up. One file per block: K bytes then V bytes, raw
    C-order; the shape/dtype contract lives in the owning pool."""

    def __init__(self, directory: str, capacity_blocks: int = 256):
        self.dir = directory
        self.capacity = capacity_blocks
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._lru: Dict[bytes, str] = {}  # guarded_by: _lock — hash -> path, insertion order = LRU
        self.stored = 0
        self.hits = 0
        self.dropped = 0

    def _path(self, block_hash: bytes) -> str:
        return os.path.join(self.dir, block_hash.hex() + ".kv")

    def put(self, block_hash: bytes, k: torch.Tensor, v: torch.Tensor
            ) -> List[bytes]:
        """Store one block; returns the hashes DROPPED to make room."""
        dropped: List[bytes] = []
        path = self._path(block_hash)
        with self._lock:
            if block_hash in self._lru:
                self._lru[block_hash] = self._lru.pop(block_hash)
                return dropped
            while len(self._lru) >= self.capacity:
                old, old_path = next(iter(self._lru.items()))
                del self._lru[old]
                try:
                    os.remove(old_path)
                except OSError:
                    pass
                dropped.append(old)
                self.dropped += 1
        # the slow disk write runs with the lock RELEASED so concurrent
        # get()/put() on other blocks never stall behind it; the file is
        # content-addressed, so racing writers of the same hash produce
        # identical bytes and the capacity bound is soft by at most the
        # width of the race
        try:
            with open(path, "wb") as f:
                f.write(_raw(k))
                f.write(_raw(v))
        except OSError as e:
            log.warning("disk tier write failed for %s: %s",
                        block_hash.hex()[:12], e)
            return dropped
        with self._lock:
            if block_hash not in self._lru:
                self._lru[block_hash] = path
                self.stored += 1
        return dropped

    def get(self, block_hash: bytes, shape, dtype: torch.dtype
            ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        with self._lock:
            path = self._lru.get(block_hash)
            if path is None:
                return None
            self._lru[block_hash] = self._lru.pop(block_hash)  # LRU bump
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            with self._lock:
                self._lru.pop(block_hash, None)
            return None
        half = len(raw) // 2
        k = torch.frombuffer(bytearray(raw[:half]), dtype=torch.uint8)
        v = torch.frombuffer(bytearray(raw[half:]), dtype=torch.uint8)
        self.hits += 1
        return (k.view(dtype).reshape(shape), v.view(dtype).reshape(shape))

    def contains(self, block_hash: bytes) -> bool:
        with self._lock:
            return block_hash in self._lru

    def __len__(self) -> int:
        with self._lock:
            return len(self._lru)


class HostBlockPool:
    """Preallocated host-RAM KV block arenas with LRU eviction and
    pinning."""

    def __init__(self, capacity_blocks: int, block_shape,
                 dtype: torch.dtype, disk: Optional[DiskBlockTier] = None,
                 pin: bool = False):
        if capacity_blocks <= 0:
            raise ValueError("capacity_blocks must be > 0")
        self.capacity = capacity_blocks
        self.block_shape = tuple(block_shape)
        self.dtype = dtype
        # one arena per device pool, allocated once; a block's K is
        # k_arena[slot], its V v_arena[slot]
        shape = (capacity_blocks,) + self.block_shape
        self.k_arena = torch.empty(shape, dtype=dtype, pin_memory=pin)
        self.v_arena = torch.empty(shape, dtype=dtype, pin_memory=pin)
        self._free: List[int] = list(range(capacity_blocks - 1, -1, -1))  # guarded_by: _lock
        self._entries: Dict[bytes, int] = {}  # guarded_by: _lock — hash -> slot, dict order = LRU
        self._pins: Dict[bytes, int] = {}  # guarded_by: _lock
        # slot -> the CUDA event of the last device copy into or out of it
        self._events: Dict[int, object] = {}  # guarded_by: _lock
        # an onboard's claimed hashes -> None, or their bytes (host copies)
        # once the LRU reclaimed their slot
        self._claims: Dict[bytes, Optional[Tuple[torch.Tensor,
                                                 torch.Tensor]]] = {}  # guarded_by: _lock
        self._lock = threading.Lock()
        self.disk = disk
        # counters (exposed as dynamo_kvbm_* series by the serving layer)
        self.hits = 0
        self.misses = 0
        self.stored = 0
        self.evicted_lru = 0
        self.rejected_full = 0

    @property
    def block_nbytes(self) -> int:
        n = 1
        for s in self.block_shape:
            n *= s
        return 2 * n * self.dtype.itemsize

    @property
    def pinned(self) -> bool:
        return self.k_arena.is_pinned() and self.v_arena.is_pinned()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # -------------------------------------------------------- device copies --
    def note_copy(self, slot: int, event) -> None:
        """A device copy into or out of `slot` was queued; `event` is
        recorded after it."""
        with self._lock:
            self._events[slot] = event

    def slot_event(self, slot: int):
        """The last queued device copy's event on `slot` (None: none
        pending), for a stream to wait on before it touches the slot."""
        with self._lock:
            return self._events.get(slot)

    def _settle_locked(self, slot: int) -> None:  # holds: _lock
        """Wait for the slot's last device copy before the host reads or
        writes its bytes."""
        ev = self._events.pop(slot, None)
        if ev is not None:
            ev.synchronize()

    def settle(self, slot: int) -> None:
        with self._lock:
            self._settle_locked(slot)

    # ---------------------------------------------------------------- write --
    def reserve(self, block_hash: bytes) -> Tuple[Optional[int], bool,
                                                  List[bytes]]:
        """A slot for `block_hash`: (slot, fresh, removed). `fresh` is
        False when the block is already here (LRU bump, nothing to copy);
        slot None when every entry is pinned (the put is rejected).
        `removed` lists hashes dropped from EVERY tier to make room."""
        removed: List[bytes] = []
        with self._lock:
            slot = self._entries.get(block_hash)
            if slot is not None:
                self._entries[block_hash] = self._entries.pop(block_hash)
                return slot, False, removed
            slot = self._alloc_slot_locked(removed)
            if slot is None:
                self.rejected_full += 1
                return None, False, removed
            self._entries[block_hash] = slot
            self.stored += 1
        return slot, True, removed

    def put(self, block_hash: bytes, k: torch.Tensor, v: torch.Tensor
            ) -> Tuple[bool, List[bytes]]:
        """Store one block (host copy into the arena). Returns (stored,
        removed): `removed` lists hashes dropped from EVERY tier to make
        room (the event plane publishes them as gone). A full pool whose
        entries are all pinned rejects the put; the caller falls back to a
        plain free."""
        slot, fresh, removed = self.reserve(block_hash)
        if slot is None:
            return False, removed
        if fresh:
            with self._lock:
                self._settle_locked(slot)
                self.k_arena[slot].copy_(k)
                self.v_arena[slot].copy_(v)
        return True, removed

    def _alloc_slot_locked(self, removed: List[bytes]) -> Optional[int]:  # holds: _lock
        if self._free:
            return self._free.pop()
        # LRU-evict the oldest unpinned entry; spill it to disk if a tier
        # is configured (then only disk's own overflow is truly removed)
        for old, slot in self._entries.items():
            if self._pins.get(old, 0) > 0:
                continue
            del self._entries[old]
            self.evicted_lru += 1
            self._settle_locked(slot)
            if old in self._claims:
                self._claims[old] = (self.k_arena[slot].clone(),
                                     self.v_arena[slot].clone())
            if self.disk is not None:
                removed.extend(self.disk.put(
                    old, self.k_arena[slot], self.v_arena[slot]))
            else:
                removed.append(old)
            return slot
        return None  # everything pinned

    # ----------------------------------------------------------------- read --
    def find(self, block_hash: bytes, removed: Optional[List[bytes]] = None
             ) -> Tuple[Optional[int], Optional[Tuple[torch.Tensor,
                                                      torch.Tensor]]]:
        """Where a block is: (slot, None) in host RAM (LRU-bumped), else
        from the disk tier, which re-promotes it into host RAM: its slot,
        or (None, (k, v)) when every host entry is pinned; (None, None) on
        a miss. `removed`, when given, collects hashes a disk promotion
        displaced out of every tier (the caller owes the event plane a
        `removed` for them)."""
        with self._lock:
            slot = self._entries.get(block_hash)
            if slot is not None:
                self._entries[block_hash] = self._entries.pop(block_hash)
                self.hits += 1
                return slot, None
        if self.disk is not None:
            got = self.disk.get(block_hash, self.block_shape, self.dtype)
            if got is not None:
                self.hits += 1
                _, dropped = self.put(block_hash, got[0], got[1])
                if removed is not None:
                    removed.extend(dropped)
                with self._lock:
                    slot = self._entries.get(block_hash)
                return (slot, None) if slot is not None else (None, got)
        with self._lock:
            self.misses += 1
        return None, None

    def get(self, block_hash: bytes, removed: Optional[List[bytes]] = None
            ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """Copy a block out (see `find`). None on a miss."""
        slot, got = self.find(block_hash, removed)
        return self.read(slot) if slot is not None else got

    def read(self, slot: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Host copies of a slot's K and V, once its device copies are
        done."""
        with self._lock:
            self._settle_locked(slot)
            return self.k_arena[slot].clone(), self.v_arena[slot].clone()

    def view(self, slot: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """A slot's K and V in place (no copy), once its device copies are
        done: valid until the slot is written again."""
        self.settle(slot)
        return self.k_arena[slot], self.v_arena[slot]

    # --------------------------------------------------------------- claims --
    def claim(self, block_hash: bytes) -> None:
        """An onboard found `block_hash` here and copies it out later: if
        its slot is reclaimed first, keep its bytes (`claimed`)."""
        with self._lock:
            self._claims[block_hash] = None

    def claimed(self, block_hash: bytes
                ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """The kept bytes of a claimed block whose slot was reclaimed, else
        None (its slot still holds it)."""
        with self._lock:
            return self._claims.get(block_hash)

    def release_claims(self) -> None:
        with self._lock:
            self._claims.clear()

    def contains(self, block_hash: bytes) -> bool:
        with self._lock:
            if block_hash in self._entries:
                return True
        return self.disk is not None and self.disk.contains(block_hash)

    # ------------------------------------------------------------ lifecycle --
    def pin(self, block_hash: bytes) -> bool:
        with self._lock:
            if block_hash not in self._entries:
                return False
            self._pins[block_hash] = self._pins.get(block_hash, 0) + 1
            return True

    def unpin(self, block_hash: bytes) -> None:
        with self._lock:
            n = self._pins.get(block_hash, 0) - 1
            if n <= 0:
                self._pins.pop(block_hash, None)
            else:
                self._pins[block_hash] = n

    def drop(self, block_hash: bytes) -> bool:
        with self._lock:
            slot = self._entries.pop(block_hash, None)
            if slot is None:
                return False
            self._free.append(slot)
            self._pins.pop(block_hash, None)
            return True

    def stats(self) -> dict:
        with self._lock:
            out = {
                "capacity_blocks": self.capacity,
                "used_blocks": len(self._entries),
                "block_nbytes": self.block_nbytes,
                "hits": self.hits,
                "misses": self.misses,
                "stored": self.stored,
                "evicted_lru": self.evicted_lru,
                "rejected_full": self.rejected_full,
            }
        if self.disk is not None:
            out["disk"] = {
                "used_blocks": len(self.disk),
                "capacity_blocks": self.disk.capacity,
                "hits": self.disk.hits,
                "dropped": self.disk.dropped,
            }
        return out
