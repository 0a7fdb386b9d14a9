"""Cluster-wide KV event plane — worker-side publisher.

The port's copy of `dynamo_tpu/kvbm/events.py`, taking its two helpers
from the port's copies of the modules the JAX file takes them from
(`subject_token` from the NATS client, `text_block_chain` from the
router). The publisher takes any client with the NATS client's
`publish(subject, data)`; the worker's `--nats-url` wiring
(`serving/worker.attach_nats_plane`) attaches one on the request plane's
connection, and each request registers its routing text
(`ServingContext.register_kv_route`).

Workers announce what their KV cache actually holds: `stored` (block on
device), `demoted` (spilled to the host/disk tier, still servable),
`removed` (gone from every tier). The frontend router subscribes
(serving/router.py `KVEventIndex`) and routes follow-up turns to the
worker that REALLY holds the prefix — replacing the frontend's passive
guess ledger as the primary kv_overlap source.

Hash-space bridging: the engine's block hashes chain over TOKEN ids
(engine/kv_cache.py), but the frontend is tokenizer-free — its routing
chain hashes fixed-size TEXT blocks of the canonical prompt
(serving/router.py text_block_chain). The worker sees both: it tokenizes
the same canonical text the frontend hashed, so the publisher records,
per admitted request, the (token-chain, text-chain) pair and translates
engine events into the router's text-hash space by proportional depth
(token page i of P covers text blocks [i*T/P, (i+1)*T/P) of T). Depth is
what routing consumes, so the approximation only blurs WHERE a partial
eviction truncates a prefix, never WHICH worker holds it.

Subject: `dynamo.kv_events.<model-token>.<worker-token>`; the frontend
subscribes to `dynamo.kv_events.>`. Payloads are small JSON batches; the
plane is advisory (at-most-once, like the request plane) — a lost event
degrades routing back to the ledger/HRW path, never correctness.
"""

from __future__ import annotations

import json
import logging
import threading
from typing import Dict, List, Optional, Tuple

from dynamo_tpu_torch.serving.nats import subject_token
from dynamo_tpu_torch.serving.router import text_block_chain

log = logging.getLogger("dynamo_tpu_torch.kvbm.events")

SUBJECT_PREFIX = "dynamo.kv_events"


def kv_event_subject(model: str, worker_url: str) -> str:
    return (f"{SUBJECT_PREFIX}.{subject_token(model)}"
            f".{subject_token(worker_url)}")


def token_block_chain(prompt_token_ids, page_size: int,
                      namespace: str = "") -> List[bytes]:
    """The engine's rolling page-block hash chain for a prompt's FULL
    pages — byte-identical to what PrefixCache.insert publishes (same
    `_chain` AND the same namespace seeding: weight version + LoRA
    adapter), so engine events and publisher groups share keys."""
    from dynamo_tpu_torch.engine.kv_cache import PrefixCache

    n_full = len(prompt_token_ids) // page_size
    out, h = [], (b"root" if not namespace
                  else b"root|" + namespace.encode("utf-8"))
    for i in range(n_full):
        h = PrefixCache._chain(
            h, prompt_token_ids[i * page_size:(i + 1) * page_size])
        out.append(h)
    return out


class _Group:
    """One admitted request's (token-chain, text-chain) association."""

    __slots__ = ("token_hex", "text", "depth")

    def __init__(self, token_hex: List[str], text: List[str]):
        self.token_hex = token_hex
        self.text = text
        self.depth = len(token_hex)  # usable token depth (pages)

    def text_range(self, i: int, j: int) -> List[str]:
        """Text blocks proportionally covered by token pages [i, j)."""
        p = max(len(self.token_hex), 1)
        t = len(self.text)
        return self.text[i * t // p:j * t // p]


class KVEventPublisher:
    """Translates engine KV events into router-space text-hash events and
    publishes them on NATS. Attach with `engine.set_kv_event_sink(pub.on_
    engine_event)`; the serving layer registers each request's canonical
    routing text via `register()` before submission."""

    def __init__(self, nats_client, worker_url: str, model: str,
                 max_groups: int = 4096):
        self.nc = nats_client
        self.worker_url = worker_url
        self.model = model
        self.subject = kv_event_subject(model, worker_url)
        self.max_groups = max_groups
        self._lock = threading.Lock()
        # dict order = LRU over registration
        self._groups: Dict[str, _Group] = {}  # keyed by first token hash
        # token hash hex -> (page index, [group keys]) — shared prefixes
        # hash identically at the same depth, so one hash maps to one index
        self._token_map: Dict[str, Tuple[int, List[str]]] = {}
        self.published_total = 0
        self.publish_errors_total = 0
        self._seq = 0

    # ------------------------------------------------------------ register --
    def register(self, prompt_token_ids, routing_text: str,
                 page_size: int, namespace: str = "") -> None:
        """Record one request's token-chain <-> text-chain association.
        `routing_text` must be the same canonical text the frontend hashed
        (completions: the prompt string; chat: json.dumps(messages));
        `namespace` the engine's active KV namespace (weight version) so
        the token chain keys match what the engine will publish."""
        tokens_hex = [h.hex()
                      for h in token_block_chain(prompt_token_ids, page_size,
                                                 namespace)]
        if not tokens_hex:
            return
        text = text_block_chain(routing_text)
        if not text:
            return
        key = tokens_hex[0] + f":{len(tokens_hex)}"
        g = _Group(tokens_hex, text)
        with self._lock:
            if key in self._groups:
                self._groups[key] = self._groups.pop(key)  # LRU bump
                return
            self._groups[key] = g
            for i, th in enumerate(tokens_hex):
                idx, keys = self._token_map.setdefault(th, (i, []))
                keys.append(key)
            while len(self._groups) > self.max_groups:
                old_key, old = next(iter(self._groups.items()))
                del self._groups[old_key]
                for th in old.token_hex:
                    ent = self._token_map.get(th)
                    if ent is None:
                        continue
                    if old_key in ent[1]:
                        ent[1].remove(old_key)
                    if not ent[1]:
                        del self._token_map[th]

    # -------------------------------------------------------------- events --
    def on_engine_event(self, kind: str, block_hashes: List[bytes],
                        tier: str) -> None:
        """Engine sink: translate token-hash events to text-hash events."""
        text_blocks: List[str] = []
        seen = set()
        with self._lock:
            for h in block_hashes:
                ent = self._token_map.get(h.hex())
                if ent is None:
                    continue
                i, keys = ent
                for key in keys:
                    g = self._groups.get(key)
                    if g is None:
                        continue
                    if kind == "removed":
                        # a prefix chain is only usable up to its first
                        # missing page: truncate the group there
                        if i < g.depth:
                            covered = g.text_range(i, len(g.token_hex))
                            g.depth = i
                        else:
                            covered = []
                    else:
                        covered = g.text_range(i, i + 1)
                        if kind == "stored" and i >= g.depth:
                            g.depth = i + 1
                    for t in covered:
                        if t not in seen:
                            seen.add(t)
                            text_blocks.append(t)
        if text_blocks:
            self.publish(kind, text_blocks, tier)

    def publish(self, kind: str, text_blocks: List[str], tier: str) -> None:
        with self._lock:
            self._seq += 1
            seq = self._seq
        payload = {
            "v": 1,
            "type": kind,
            "worker": self.worker_url,
            "model": self.model,
            "blocks": text_blocks,
            "tier": tier,
            "seq": seq,
        }
        try:
            self.nc.publish(self.subject, json.dumps(payload).encode())
            with self._lock:
                self.published_total += 1
        except Exception as e:  # plane down -> routing degrades, not serving
            with self._lock:
                self.publish_errors_total += 1
            log.debug("kv event publish failed: %s", e)

    def stats(self) -> dict:
        with self._lock:
            return {
                "groups": len(self._groups),
                "published_total": self.published_total,
                "publish_errors_total": self.publish_errors_total,
            }
