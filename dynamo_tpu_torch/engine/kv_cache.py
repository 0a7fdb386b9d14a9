"""Paged KV cache: device page pools + host-side page allocator.

Port of `dynamo_tpu/engine/kv_cache.py`, automatic prefix caching
(`PrefixCache`) included, without its KVBM host tier and KV event sink. The pools
are [num_layers, num_pages, page_size, lane_width] for K and V, page-major:
in the model dtype with the KV heads fused into the last axis (head h
occupies lanes [h*D, (h+1)*D), lane_width = KV*D), or, with
`kv_cache_dtype="int8"`, int8 packed rows of values and per-head bf16
scales (`dynamo_tpu_torch.ops.attention`, int8 rows), the JAX package's
layouts. Page 0 is a reserved trash page: inactive batch slots point at it
so the full-batch decode step needs no masked writes.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.ops.attention import kv_lane_width


class OutOfPages(Exception):
    """KV pool exhausted: the scheduler defers admission."""


@dataclasses.dataclass
class KVCacheSpec:
    num_layers: int
    num_kv_heads: int
    num_pages: int
    page_size: int
    head_dim: int
    dtype: str = "bfloat16"  # "int8": packed-scale quantized rows

    @staticmethod
    def from_model(cfg: ModelConfig, num_pages: int, page_size: int,
                   kv_cache_dtype: str = "auto") -> "KVCacheSpec":
        """Pools in the model's dtype ('auto' or '') or int8 packed rows
        ('int8'); any other value raises."""
        if kv_cache_dtype not in ("auto", "", "int8"):
            raise ValueError(f"kv_cache_dtype must be 'auto' or 'int8', got "
                             f"{kv_cache_dtype!r}")
        return KVCacheSpec(
            num_layers=cfg.num_layers,
            num_kv_heads=cfg.cache_kv_heads,
            num_pages=num_pages,
            page_size=page_size,
            head_dim=cfg.cache_head_dim,
            dtype="int8" if kv_cache_dtype == "int8" else cfg.dtype,
        )

    @property
    def quantized(self) -> bool:
        return self.dtype == "int8"

    @property
    def lane_width(self) -> int:
        return kv_lane_width(self.num_kv_heads, self.head_dim, self.quantized)

    @property
    def pool_bytes(self) -> int:
        """Bytes of the K and V pools together."""
        return self.num_pages * self.page_size * self.bytes_per_token()

    def bytes_per_token(self) -> int:
        """K and V bytes of one token over every layer (JAX
        `KVCacheSpec.bytes_per_token`)."""
        itemsize = getattr(torch, self.dtype).itemsize
        return 2 * self.num_layers * self.lane_width * itemsize

    @property
    def shape(self):
        return (self.num_layers, self.num_pages, self.page_size,
                self.lane_width)

    def page_table_width(self, bucket_tokens: int, chunk_tokens: int) -> int:
        """Page-list width for a chunked prefill at this bucket: the
        bucket's pages plus (chunk_pages - 1) trailing TRASH slots, so the
        final padded chunk's page slice lands on page 0 and never runs
        off the list."""
        ps = self.page_size
        return bucket_tokens // ps + (max(chunk_tokens, ps) // ps - 1)


def alloc_kv_pages(spec: KVCacheSpec, device) -> tuple:
    """Zeroed K and V pools on `device`."""
    dtype = getattr(torch, spec.dtype)
    k = torch.zeros(spec.shape, dtype=dtype, device=device)
    v = torch.zeros(spec.shape, dtype=dtype, device=device)
    return k, v


class PageAllocator:
    """Host-side free-list allocator over the device page pool: pages are
    identical, a sequence holds an ordered page list, page 0 is never
    handed out."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._refs = np.zeros(num_pages, dtype=np.int32)
        self._refs[0] = 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise OutOfPages(f"need {n} pages, {len(self._free)} free")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        return pages

    def ref(self, pages: List[int]) -> None:
        """One more owner for each page (a prefix shared by sequences and
        the prefix cache)."""
        for p in pages:
            assert self._refs[p] > 0
            self._refs[p] += 1

    def refs(self, page: int) -> int:
        return int(self._refs[page])

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if p == 0:
                continue
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)


class PrefixCache:
    """Automatic prefix caching over the paged KV pool (vLLM-style), the
    JAX package's `PrefixCache` less its KVBM tier and event sink.

    A fully prefilled prompt's FULL pages are published under a rolling
    block-hash chain (sha256 from b"root" over int64 token blocks, byte for
    byte the JAX package's); a new request reuses the longest cached prefix
    (ref-counted pages shared across sequences) and prefills only the
    suffix through the chunked path. Cached pages are immutable: only full
    pages are published, `lookup` leaves at least one token uncached, so
    decode and suffix writes always land on later pages. The cache holds
    one reference per published page; eviction (LRU) takes only pages
    nothing else references."""

    def __init__(self, allocator: PageAllocator, page_size: int):
        self.allocator = allocator
        self.page_size = page_size
        # block hash -> page id, in LRU order (oldest first), and each
        # hash's namespace (the memory books' per-adapter split)
        self._map: Dict[bytes, int] = {}
        self._ns: Dict[bytes, str] = {}
        self.hits = 0
        self.misses = 0
        self.cached_tokens_served = 0

    @staticmethod
    def _chain(prev: bytes, block) -> bytes:
        h = hashlib.sha256(prev)
        h.update(np.asarray(block, dtype=np.int64).tobytes())
        return h.digest()

    def _hashes(self, tokens, n_blocks: int,
                namespace: str = "") -> List[bytes]:
        """The rolling hash of each of the first n_blocks full pages. A
        `namespace` (a LoRA adapter) seeds the chain's root, so two
        adapters, or an adapter and the base model, never share a page
        (JAX `PrefixCache._hashes`, byte for byte)."""
        out, h = [], (b"root" if not namespace
                      else b"root|" + namespace.encode("utf-8"))
        for i in range(n_blocks):
            h = self._chain(h, tokens[i * self.page_size:
                                      (i + 1) * self.page_size])
            out.append(h)
        return out

    def lookup(self, prompt_tokens,
               namespace: str = "") -> Tuple[List[int], int]:
        """Longest cached prefix: (page ids, tokens). The pages come back
        ref'd for the caller. Leaves >= 1 token uncached so the last
        token's logits are computed."""
        limit = (len(prompt_tokens) - 1) // self.page_size
        pages: List[int] = []
        for h in self._hashes(prompt_tokens, limit, namespace):
            page = self._map.get(h)
            if page is None:
                break
            self._map[h] = self._map.pop(h)  # LRU bump
            pages.append(page)
        if pages:
            self.allocator.ref(pages)
            self.hits += 1
            self.cached_tokens_served += len(pages) * self.page_size
        else:
            self.misses += 1
        return pages, len(pages) * self.page_size

    def has_prefix(self, prompt_tokens, namespace: str = "") -> bool:
        """True when lookup() would hit, without taking references, bumping
        the LRU order or counting (admission grouping peeks)."""
        if len(prompt_tokens) <= self.page_size:
            return False
        return self._hashes(prompt_tokens, 1, namespace)[0] in self._map

    def insert(self, prompt_tokens, pages: List[int],
               namespace: str = "") -> None:
        """Publish a fully prefilled prompt's full pages; each newly
        published page gains a cache-owned reference."""
        n_full = len(prompt_tokens) // self.page_size
        for h, page in zip(self._hashes(prompt_tokens, n_full, namespace),
                           pages[:n_full]):
            if h in self._map:
                continue
            self.allocator.ref([page])
            self._map[h] = page
            self._ns[h] = namespace

    def evictable(self) -> int:
        """Pages reclaimable now (the cache is the sole owner)."""
        return sum(1 for p in self._map.values()
                   if self.allocator.refs(p) == 1)

    def evict(self, n: int) -> int:
        """Free up to n sole-owned pages, oldest first; returns how many."""
        if n <= 0:
            return 0
        victims = []
        for h, page in self._map.items():  # insertion order == LRU
            if self.allocator.refs(page) == 1:
                victims.append((h, page))
                if len(victims) >= n:
                    break
        for h, page in victims:
            del self._map[h]
            del self._ns[h]
            self.allocator.free([page])
        return len(victims)

    def pages_by_namespace(self) -> Dict[str, List[int]]:
        """Device pages the cache holds, grouped by namespace ("" = the
        base model): the memory books' per-adapter split."""
        out: Dict[str, List[int]] = {}
        for h, page in list(self._map.items()):
            out.setdefault(self._ns.get(h, ""), []).append(page)
        return out

    def stats(self) -> dict:
        return {
            "entries": len(self._map),
            "hits": self.hits,
            "misses": self.misses,
            "cached_tokens_served": self.cached_tokens_served,
        }


class SeqState:
    """Host-side state for one in-flight sequence (one decode slot)."""

    __slots__ = (
        "request_id", "slot", "pages", "num_tokens", "output_tokens",
        "max_tokens", "temperature", "top_p", "top_k", "stop_token_ids",
        "prompt_len", "logprobs", "prompt_ids", "req", "guide",
        "adapter_slot",
    )

    def __init__(
        self,
        request_id: str,
        slot: int,
        pages: List[int],
        prompt_len: int,
        max_tokens: int,
        temperature: float = 0.0,
        top_p: float = 1.0,
        top_k: int = 0,
        stop_token_ids: Optional[List[int]] = None,
        logprobs: Optional[int] = None,
    ):
        self.request_id = request_id
        self.slot = slot
        self.pages = pages
        self.prompt_len = prompt_len
        self.num_tokens = prompt_len  # tokens whose KV is in cache
        self.output_tokens: List[int] = []
        self.max_tokens = max_tokens
        self.temperature = temperature
        self.top_p = top_p
        self.top_k = top_k
        self.stop_token_ids = stop_token_ids or []
        self.logprobs = logprobs
        self.prompt_ids: List[int] = []
        self.req = None  # originating GenRequest (preemption continuation)
        # JSON-guided: the grammar state (mode, depth, bits) after the
        # output so far (the host mirror of the device state), else None
        self.guide: Optional[tuple] = None
        self.adapter_slot = 0  # LoRA slot (0 = base)
