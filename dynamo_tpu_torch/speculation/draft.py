"""DraftEngine: a small same-tokenizer model proposing speculative drafts.

Port of `dynamo_tpu/speculation/draft.py`. The draft model runs over its
own paged KV pool (its own `PageAllocator`, page 0 trash) and proposes K
greedy tokens per verify window; the engine's verify step consumes them
unchanged, so what proposes never changes what streams. Per target slot
it keeps:

- rollback: the draft KV is valid for the common prefix of what it was
  built from and the target's accepted history; a rejection rolls back
  to that prefix;
- catch-up: the accepted tokens past it (the verify step's bonus token, a
  rolled-back suffix, a fresh or shed slot's whole history) are fed one
  token at a time before drafting;
- LRU shedding: when the pool cannot cover a window, the least recently
  drafting slot's pages are freed (draft KV is derived state, rebuilt by
  catch-up), and a window the pool cannot cover even then is refused
  (the engine demotes the slot for that step, counted).

One B=1 `llama.decode_step` serves catch-up and drafting, as the JAX
package compiles exactly one draft program. Its inputs live in static
device buffers: `feed` holds the token of every position (the history
uploaded from the host, the drafts written by the step itself),
`cursor` the position fed next, `n_known` the history's length and
`table` the slot's pages (max_pages_per_seq + 1 wide: a window's drafts
may overhang the target's table by one page). A step feeds
feed[cursor], takes the argmax of its logits on the device (first
maximum, as np.argmax) and writes it to feed[cursor + 1] when that
position lies past the history, then advances the cursor. So a proposal
is one upload, len(catch-up) + K - 1 steps back to back and one read of
the K drafts: on the card each step is a replay of ONE captured CUDA
graph (a 600-token catch-up would take seconds of host dispatch
eagerly), on the CPU and with `enforce_eager` the same body eagerly. A
failed capture raises; nothing falls back to eager.
"""

from __future__ import annotations

import hashlib
import logging
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from dynamo_tpu_torch.engine.decode_graphs import (CapturedStep, capturing,
                                                   upload)
from dynamo_tpu_torch.engine.kv_cache import (KVCacheSpec, PageAllocator,
                                              alloc_kv_pages)
from dynamo_tpu_torch.engine.tokenizer import get_tokenizer
from dynamo_tpu_torch.models import llama, loader
from dynamo_tpu_torch.models.config import ModelConfig

log = logging.getLogger("dynamo_tpu_torch.speculation")


def tokenizer_fingerprint(tok) -> str:
    """Hash of the tokenizer identity the engine's gate compares (class
    name, vocab size, bos and eos ids): drafts are token ids fed straight
    into the target's verify, so the two models must share one id
    space."""
    h = hashlib.sha256()
    for part in (type(tok).__name__, tok.vocab_size,
                 getattr(tok, "bos_token_id", None),
                 getattr(tok, "eos_token_id", None)):
        h.update(repr(part).encode())
    return h.hexdigest()[:16]


class DraftSlot:
    """Draft-side state for one target decode slot."""

    __slots__ = ("pages", "tokens", "done", "tick")

    def __init__(self):
        self.pages: List[int] = []  # draft-pool page ids
        # tokens[i] is the token whose KV occupies draft position i, for
        # i < done; beyond `done` the pool holds dead bytes
        self.tokens: List[int] = []
        self.done = 0
        self.tick = 0  # LRU clock stamp (bumped every propose)


class DraftEngine:
    """Draft-model proposer over its own paged KV pool. `model`: None
    (the checkpoint under cfg.draft_model_path, else the draft_model
    preset from seed cfg.seed + 1), a `models.llama.Llama` on the
    engine's device, or a JAX parameter tree of numpy arrays."""

    def __init__(self, engine, model=None):
        cfg = engine.cfg
        self.eng = engine
        self.k_max = cfg.num_speculative_tokens
        self.page_size = cfg.page_size
        self.device = engine.device
        name = cfg.draft_model or ""
        if not name and not cfg.draft_model_path:
            raise ValueError(
                "--draft-model (or --draft-model-path) is required with "
                "--drafter model: the model drafter runs a real second "
                "model; name a small same-tokenizer one (e.g. a 1B "
                "drafting for an 8B target)")
        default_dtype = "float32" if self.device.type == "cpu" else "bfloat16"
        self.model_cfg = ModelConfig.from_model_name(
            cfg.draft_model_path or name, dtype=cfg.dtype or default_dtype)
        bad = llama.unported_model_features(self.model_cfg)
        if bad:
            raise NotImplementedError(
                f"ModelConfig feature(s) {bad} of draft model "
                f"{self.model_cfg.name} are not ported to dynamo_tpu_torch "
                f"yet (see ROADMAP.md)")
        if self.model_cfg.vocab_size != engine.model_cfg.vocab_size:
            raise ValueError(
                f"draft model {name!r} vocab_size "
                f"({self.model_cfg.vocab_size}) != target "
                f"({engine.model_cfg.vocab_size}): draft proposals are "
                f"token ids fed straight to the target verify — the two "
                f"models must share one token id space")
        th = tokenizer_fingerprint(get_tokenizer(cfg.model, cfg.model_path))
        dh = tokenizer_fingerprint(
            get_tokenizer(name or cfg.model, cfg.draft_model_path))
        if th != dh:
            raise ValueError(
                f"draft model {name!r} tokenizer hash ({dh}) != target's "
                f"({th}): speculative drafts must come from the SAME "
                f"tokenizer or no proposal can ever verify")
        self.num_pages = cfg.resolved_draft_pages()
        if self.num_pages < self.k_max + 1:
            raise ValueError(
                f"--draft-num-pages ({self.num_pages}) must be >= K+1 "
                f"({self.k_max + 1}): one verify window drafts K tokens "
                f"plus the bonus position, and the pool must hold that "
                f"window even before the LRU arm can shed other slots")
        self.spec = KVCacheSpec.from_model(self.model_cfg, self.num_pages,
                                           cfg.page_size)
        self.allocator = PageAllocator(self.num_pages)
        self.k_pages, self.v_pages = alloc_kv_pages(self.spec, self.device)
        dtype = getattr(torch, self.model_cfg.dtype)
        if model is None:
            # a different seed than the target: two random-init models
            # must not be twins
            model = loader.load_or_init(
                self.model_cfg, cfg.draft_model_path, seed=cfg.seed + 1,
                device=self.device, dtype=dtype)
        elif isinstance(model, llama.Llama):
            # the draft model's ModelConfig, not the weights' own
            model = llama.with_config(model, self.model_cfg)
        else:
            model = loader.from_jax_params(self.model_cfg, model,
                                           device=self.device, dtype=dtype)
        self.model = model
        # the step's static inputs (see the module doc)
        self._table_width = cfg.max_pages_per_seq + 1
        n = self._table_width * cfg.page_size + 1
        self.feed = torch.zeros((n,), dtype=torch.int64, device=self.device)
        self.cursor = torch.zeros((1,), dtype=torch.int64, device=self.device)
        self.n_known = torch.zeros((1,), dtype=torch.int64,
                                   device=self.device)
        self.table = torch.zeros((1, self._table_width), dtype=torch.int32,
                                 device=self.device)
        self.eager = self.device.type != "cuda" or cfg.enforce_eager
        self._graph: Optional[CapturedStep] = None
        self.capture_s = 0.0
        self.replays = 0
        self.slots: Dict[int, DraftSlot] = {}
        self._tick = 0
        self.steps = 0  # draft-model forwards (catch-up + draft)
        self.catchup_tokens = 0  # re-fed accepted-but-undrafted tokens
        self.rollbacks = 0
        self.rolled_back_tokens = 0
        self.evictions = 0
        log.info("draft engine: model=%s (%d layers, vocab %d), pool %d "
                 "pages x %d bytes", name or cfg.draft_model_path,
                 self.model_cfg.num_layers, self.model_cfg.vocab_size,
                 self.num_pages, self.page_bytes)

    # ------------------------------------------------------------ books --

    @property
    def page_bytes(self) -> int:
        return self.spec.pool_bytes // self.num_pages

    def partition_bytes(self) -> Dict[str, int]:
        """The draft tier's `dynamo_memory_kv_pool_bytes` rows: per-tenant
        draft residency + free + trash, summing EXACTLY to the pool's
        capacity by the same first-claim/forced-remainder construction as
        the device tier (observability/memory.py; JAX
        `DraftEngine.partition_bytes`)."""
        eng = self.eng
        pb = self.page_bytes
        total = self.num_pages
        by_tenant: Dict[str, int] = {}
        claimed = 0
        for slot, ds in sorted(self.slots.items()):
            if not ds.pages:
                continue
            seq = eng.seqs.get(slot)
            req = getattr(seq, "req", None) if seq is not None else None
            tenant = eng._tenant_of(req) if req is not None else "default"
            by_tenant[tenant] = by_tenant.get(tenant, 0) + len(ds.pages)
            claimed += len(ds.pages)
        free = min(self.allocator.free_pages, max(0, total - 1 - claimed))
        other = max(0, total - 1 - free - claimed)
        out = {t: n * pb for t, n in sorted(by_tenant.items())}
        if other:
            out["other"] = other * pb
        out["free"] = free * pb
        out["trash"] = pb  # page 0, never allocated
        return out

    def stats(self) -> Dict[str, object]:
        return {
            "model": self.eng.cfg.draft_model or self.eng.cfg.draft_model_path,
            "num_pages": self.num_pages,
            "free_pages": self.allocator.free_pages,
            "page_bytes": self.page_bytes,
            "active_slots": sum(1 for d in self.slots.values() if d.pages),
            "draft_steps": self.steps,
            "catchup_tokens": self.catchup_tokens,
            "rollbacks": self.rollbacks,
            "rolled_back_tokens": self.rolled_back_tokens,
            "evictions": self.evictions,
            "graph": {"eager": self.eager, "captured": self._graph is not None,
                      "capture_s": self.capture_s, "replays": self.replays},
        }

    # ---------------------------------------------------------- LRU arm --

    def _shed_lru(self, keep: DraftSlot) -> bool:
        """Free the least recently drafting slot's pages (it re-prefills
        from accepted history on its next window). False when nothing is
        left to shed."""
        victim = None
        for ds in self.slots.values():
            if ds is keep or not ds.pages:
                continue
            if victim is None or ds.tick < victim.tick:
                victim = ds
        if victim is None:
            return False
        self.evictions += 1
        self.allocator.free(victim.pages)
        victim.pages = []
        victim.tokens = []
        victim.done = 0
        return True

    def _ensure_pages(self, ds: DraftSlot, need_tokens: int) -> bool:
        grow = -(-need_tokens // self.page_size) - len(ds.pages)
        if grow <= 0:
            return True
        while self.allocator.free_pages < grow:
            if not self._shed_lru(keep=ds):
                return False
        ds.pages.extend(self.allocator.alloc(grow))
        return True

    def release(self, slot: int) -> None:
        """Target slot teardown (finish, preempt, abort): drop its draft
        state."""
        ds = self.slots.pop(slot, None)
        if ds is not None and ds.pages:
            self.allocator.free(ds.pages)

    # ------------------------------------------------------------ model --

    def _body(self) -> None:
        """One draft step over the static buffers (see the module doc)."""
        pos = self.cursor
        logits = llama.decode_step(
            self.model, self.feed.index_select(0, pos), pos.to(torch.int32),
            self.table, (pos + 1).to(torch.int32), self.k_pages,
            self.v_pages, page_size=self.page_size)
        nxt_pos = pos + 1
        known = self.feed.index_select(0, nxt_pos)
        self.feed.index_copy_(0, nxt_pos, torch.where(
            nxt_pos >= self.n_known, logits.argmax(dim=-1), known))
        self.cursor += 1

    def capture(self) -> CapturedStep:
        """Warm up and capture the draft step: one pass on the capture
        stream over the trash page (an all-zero table at position 0, the
        history covering every position), then the graph; the buffers are
        restored after."""
        t0 = time.monotonic()
        bufs = (self.feed, self.cursor, self.n_known, self.table)
        saved = [t.clone() for t in bufs]
        self.cursor.zero_()
        self.table.zero_()
        self.n_known.fill_(self.feed.shape[0])
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            self._body()
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with capturing(graph, stream) as launches:
            self._body()
        for t, s in zip(bufs, saved):
            t.copy_(s)
        self._graph = CapturedStep(graph, launches)
        self.capture_s += time.monotonic() - t0
        return self._graph

    def _run(self, n: int) -> None:
        """n draft steps back to back."""
        self.steps += n
        if self.eager:
            for _ in range(n):
                self._body()
            return
        graph = self._graph if self._graph is not None else self.capture()
        for _ in range(n):
            graph.replay()
        self.replays += n

    def propose(self, seq, k: int) -> Optional[List[int]]:
        """Draft `k` tokens for a slot's next verify window, catching the
        draft KV up to the target's accepted history first. None when the
        pool cannot cover the window even after LRU shedding."""
        slot = seq.slot
        hist = list(seq.prompt_ids) + list(seq.output_tokens)
        if not hist or k < 1:
            return None
        ds = self.slots.get(slot)
        if ds is None:
            ds = self.slots[slot] = DraftSlot()
        self._tick += 1
        ds.tick = self._tick
        # rollback to the common prefix of the draft's tokens and history
        p = 0
        limit = min(ds.done, len(hist))
        while p < limit and ds.tokens[p] == hist[p]:
            p += 1
        if p < ds.done:
            self.rollbacks += 1
            self.rolled_back_tokens += ds.done - p
            ds.done = p
        if not self._ensure_pages(ds, len(hist) + k):
            return None
        # catch-up from the first position the draft KV lacks; caught up
        # already, the last position is fed again (it rewrites the same
        # KV) for its logits
        catchup = len(hist) - ds.done
        start = min(ds.done, len(hist) - 1)
        table = np.zeros((1, self._table_width), np.int32)
        table[0, :len(ds.pages)] = ds.pages
        upload(self.feed[start:len(hist)], np.asarray(hist[start:], np.int64))
        upload(self.cursor, np.asarray([start], np.int64))
        upload(self.n_known, np.asarray([len(hist)], np.int64))
        upload(self.table, table)
        self._run(len(hist) - start + k - 1)
        drafts = [int(t) for t in self.feed[len(hist):len(hist) + k].cpu()]
        self.catchup_tokens += catchup
        # the KV covers hist + drafts[:-1]; the last draft's is never
        # needed (its successor is drafted next window from accepted state)
        ds.tokens = hist + drafts[:-1]
        ds.done = len(hist) + k - 1
        return drafts
