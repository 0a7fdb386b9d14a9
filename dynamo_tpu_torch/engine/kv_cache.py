"""Paged KV cache: device page pools + host-side page allocator.

Port of `dynamo_tpu/engine/kv_cache.py` without the prefix cache. The pools
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
import math
from typing import List, Optional

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
        return 2 * math.prod(self.shape) * getattr(torch, self.dtype).itemsize

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

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if p == 0:
                continue
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)


class SeqState:
    """Host-side state for one in-flight sequence (one decode slot)."""

    __slots__ = (
        "request_id", "slot", "pages", "num_tokens", "output_tokens",
        "max_tokens", "temperature", "top_p", "top_k", "stop_token_ids",
        "prompt_len", "logprobs", "prompt_ids", "req",
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
