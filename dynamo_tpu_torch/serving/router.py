"""KV-affinity request router (the port's own copy of
`dynamo_tpu/serving/router.py`; keep the two in step: both packages must
make the same picks).

The reference's router lives in the consumed Dynamo runtime (Rust) and spreads
requests across worker replicas with KV-cache awareness (SURVEY.md §2b
"OpenAI-compatible frontend + router"). This implementation:

- **Rendezvous (HRW) hashing** on the prompt prefix: identical/shared prefixes
  deterministically land on the same worker, maximising paged-KV prefix reuse
  — without any shared state between frontend replicas.
- **Load shading**: the hash score is scaled by worker capacity headroom
  (free slots / free KV pages from heartbeats), so a hot worker sheds new
  prefixes to its peers.
- **Role filtering** for disaggregated topologies: chat traffic goes to
  `agg`/`decode` workers; `prefill` workers are selected separately by the
  decode worker's KV-fetch path (mirrors the reference's frontend→decode→
  prefill flow, reference examples/deploy/sglang/disagg.yaml).
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import Dict, List, Optional, Tuple

from dynamo_tpu_torch.robustness.breaker import BreakerBoard


@dataclasses.dataclass
class WorkerInfo:
    url: str
    model: str
    mode: str = "agg"  # agg | prefill | decode
    last_heartbeat: float = dataclasses.field(default_factory=time.monotonic)
    stats: Dict = dataclasses.field(default_factory=dict)
    # "direct" = heartbeated straight to this frontend; "etcd" = merged from
    # a peer replica's etcd registry record; "peer" = relayed by another
    # frontend over NATS worker gossip (serving/ha.py). Only direct workers
    # are re-published/relayed — non-direct records never loop.
    source: str = "direct"

    @property
    def headroom(self) -> float:
        """0..1 capacity signal from the last heartbeat."""
        s = self.stats or {}
        max_seqs = max(1, s.get("max_num_seqs", 1))
        active = s.get("active_seqs", 0) + s.get("pending", 0)
        slot_room = max(0.0, 1.0 - active / max_seqs)
        total_pages = max(1, s.get("total_pages", 1))
        page_room = s.get("free_pages", total_pages) / total_pages
        return 0.5 * slot_room + 0.5 * page_room

    @property
    def health(self) -> str:
        """Engine health from the heartbeat (robustness/watchdog.py state
        machine). Workers predating the watchdog field count healthy."""
        h = (self.stats or {}).get("health")
        if isinstance(h, dict):
            return h.get("state", "healthy")
        return h if isinstance(h, str) else "healthy"


def _pick_native(affinity_key: str, cands: List["WorkerInfo"]
                 ) -> Optional["WorkerInfo"]:
    """Run the pick loop in the native router core (runtime/csrc/
    dynamo_router.cpp — the Rust-frontend analogue); None = unavailable, let
    the caller's pure-Python loop decide. Scores are bit-identical either
    way (tests/test_router_native.py), so this is a pure hot-path swap."""
    try:
        from dynamo_tpu_torch.runtime.native import get_router_lib
    except Exception:
        return None
    lib = get_router_lib()
    if lib is None:
        return None
    try:
        key = affinity_key.encode()
        urls = [w.url.encode() for w in cands]
        if b"\x00" in key or any(b"\x00" in u for u in urls):
            return None  # C strings truncate at NUL; keep parity via Python
        import ctypes

        arr = (ctypes.c_char_p * len(urls))(*urls)
        hr = (ctypes.c_double * len(cands))(*[w.headroom for w in cands])
        idx = lib.dr_pick(key, arr, hr, len(cands))
    except Exception:
        return None
    if 0 <= idx < len(cands):
        return cands[idx]
    return None


def prefix_key(text: str, prefix_chars: int = 256) -> str:
    """Affinity key: the first prefix_chars of the prompt (system prompt +
    early turns), which is what shared KV pages actually cover."""
    return text[:prefix_chars]


def split_adapter(model: str, live_models) -> Tuple[str, Optional[str]]:
    """'<base>:<adapter>' -> (base, adapter); plain base ids pass through.

    Matching is against the LIVE base-model set first (a base id could in
    principle contain ':'), falling back to splitting at the last colon so
    an adapter request can still 503 with a precise model name when no
    base worker is up."""
    if model in live_models:
        return model, None
    for m in live_models:
        if model.startswith(m + ":"):
            return m, model[len(m) + 1:]
    base, sep, adapter = model.rpartition(":")
    return (base, adapter) if sep else (model, None)


# ledger text-block geometry: 64-char blocks, 64-block hash window.
# pick()'s relative-overlap denominator derives from the same constants.
BLOCK_CHARS = 64
MAX_BLOCKS = 64


def text_block_chain(text: str, block_chars: int = BLOCK_CHARS,
                     max_blocks: int = MAX_BLOCKS) -> List[str]:
    """Rolling hash chain over fixed-size TEXT blocks of the prompt — the
    frontend-side analogue of the engine's page-block hash chain
    (engine/kv_cache.py PrefixCache). The frontend is tokenizer-free, so
    the chain is over canonical prompt text: a conversation continuation
    extends its previous turns' text, so its leading blocks hash
    identically and the deepest known block locates the worker whose
    paged-KV prefix cache already holds the shared turns (exact token
    matching stays the worker's job)."""
    out: List[str] = []
    prev = b""
    for i in range(0, min(len(text), block_chars * max_blocks), block_chars):
        block = text[i:i + block_chars]
        if len(block) < block_chars:
            break  # partial tail block can't be stable across turns
        h = hashlib.sha256(prev)
        h.update(block.encode("utf-8", "surrogatepass"))
        prev = h.digest()
        out.append(prev.hex())
    return out


class PrefixLedger:
    """block-hash -> worker url, LRU-capped: remembers where each prefix
    chain was routed so follow-up turns land on the worker that already
    holds the KV — the passive form of the reference router's KV-event
    tracking (SURVEY.md §2b: the Dynamo router scores workers by cached-
    block overlap from worker KV events; here the routing decision itself
    is the event, so frontends stay shared-nothing)."""

    def __init__(self, cap: int = 65536):
        import collections

        self.cap = cap
        self._m: "collections.OrderedDict[str, str]" = (
            collections.OrderedDict())

    def record(self, model: str, chain: List[str], url: str) -> None:
        for h in chain:
            key = model + "|" + h  # namespace: models sharing a prompt
            if key in self._m:     # template must not clobber each other
                self._m.move_to_end(key)
            self._m[key] = url
        while len(self._m) > self.cap:
            self._m.popitem(last=False)

    def lookup(self, model: str, chain: List[str],
               live_urls) -> Tuple[Optional[str], int]:
        """Deepest block whose recorded worker is still live.
        Returns (url, depth); (None, 0) when nothing matches."""
        for depth in range(len(chain), 0, -1):
            url = self._m.get(model + "|" + chain[depth - 1])
            if url is not None and url in live_urls:
                return url, depth
        return None, 0


class KVEventIndex:
    """Per-worker global prefix index built from worker-published KV events
    (dynamo_tpu_torch.kvbm.events): block-hash -> {worker url -> tier}. Unlike
    the PrefixLedger — which only remembers where THIS frontend routed —
    the index reflects what workers actually hold (including blocks other
    frontend replicas routed, and blocks demoted to a worker's host tier),
    so it is pick()'s primary kv_overlap source; the ledger stays as the
    fallback when the event plane is down or cold.

    Event types: `stored` / `demoted` keep a block routable (device and
    host tiers both serve it — host onboards on lookup); `removed` drops
    the worker's claim. LRU-capped like the ledger."""

    def __init__(self, cap: int = 131072):
        import collections

        self.cap = cap
        self._m: "collections.OrderedDict[str, Dict[str, str]]" = (
            collections.OrderedDict())
        self._lock = threading.Lock()
        self.events_applied = 0

    def apply(self, payload: Dict) -> bool:
        """Apply one worker-published event payload (already-parsed JSON).
        Malformed payloads are dropped (False) — the plane is advisory."""
        try:
            kind = payload["type"]
            worker = payload["worker"]
            model = payload.get("model", "?")
            blocks = payload["blocks"]
            tier = payload.get("tier", "device")
        except (KeyError, TypeError):
            return False
        if kind not in ("stored", "demoted", "removed") or not isinstance(
                blocks, list):
            return False
        with self._lock:
            for b in blocks:
                key = model + "|" + str(b)
                holders = self._m.get(key)
                if kind == "removed":
                    if holders is not None:
                        holders.pop(worker, None)
                        if not holders:
                            del self._m[key]
                    continue
                if holders is None:
                    holders = self._m[key] = {}
                else:
                    self._m.move_to_end(key)
                holders[worker] = tier
            while len(self._m) > self.cap:
                self._m.popitem(last=False)
            self.events_applied += 1
        return True

    def drop_worker(self, url: str) -> None:
        """Forget a departed worker's claims (deregister/TTL purge)."""
        with self._lock:
            dead = [k for k, holders in self._m.items()
                    if holders.pop(url, None) is not None and not holders]
            for k in dead:
                del self._m[k]

    def lookup(self, model: str, chain: List[str], live_urls
               ) -> Tuple[Optional[str], int]:
        """Deepest block held by a live worker. Ties at equal depth go to
        the worker with the most headroom (live_urls maps url ->
        WorkerInfo). Returns (url, depth); (None, 0) on no match."""
        with self._lock:
            for depth in range(len(chain), 0, -1):
                holders = self._m.get(model + "|" + chain[depth - 1])
                if not holders:
                    continue
                alive = [u for u in holders if u in live_urls]
                if not alive:
                    continue
                best = max(alive, key=lambda u: live_urls[u].headroom)
                return best, depth
        return None, 0

    def stats(self) -> Dict:
        with self._lock:
            return {"entries": len(self._m),
                    "events_applied": self.events_applied}


class Router:
    def __init__(self, heartbeat_ttl: float = 15.0,
                 breakers: Optional[BreakerBoard] = None):
        self.ttl = heartbeat_ttl
        self._workers: Dict[str, WorkerInfo] = {}
        self._lock = threading.Lock()
        self._ledger = PrefixLedger()
        # KV event index (kvbm event plane): the PRIMARY kv_overlap source
        # when workers publish events; the ledger is the fallback
        self.kv_index = KVEventIndex()
        self.kv_index_hits = 0
        self.kv_index_counter = None  # optional metrics Counter
        self.ledger_hits = 0  # observability: KV-overlap routed requests
        # optional metrics Counter, inc'd at the routing decision itself
        # (under the router lock — scrape-time delta math would race
        # concurrent /metrics requests)
        self.ledger_counter = None
        # per-worker circuit breakers: pick() filters open breakers out of
        # the candidate set and admits the single half-open probe; the
        # frontend reports dial outcomes back via router.breakers
        self.breakers = breakers if breakers is not None else BreakerBoard()
        # workers whose heartbeat TTL lapsed and were purged during pick()
        self.expired_total = 0
        self.expired_counter = None  # optional metrics Counter

    # ---------------------------------------------------------- membership --
    def register(self, url: str, model: str, mode: str = "agg",
                 stats: Optional[Dict] = None, source: str = "direct"):
        with self._lock:
            w = self._workers.get(url)
            if w is None:
                self._workers[url] = WorkerInfo(url, model, mode,
                                                stats=stats or {},
                                                source=source)
                return
            if (source != "direct" and w.source == "direct"
                    and w.last_heartbeat >= time.monotonic() - self.ttl):
                # a live direct heartbeat is fresher than any peer's record
                # (etcd merge or NATS worker gossip); an expired one may be
                # resurrected by a peer that still hears the worker (e.g.
                # it re-registered elsewhere)
                return
            w.model, w.mode = model, mode
            w.source = source
            w.last_heartbeat = time.monotonic()
            if stats is not None:
                w.stats = stats

    def deregister(self, url: str):
        with self._lock:
            self._workers.pop(url, None)
        self.kv_index.drop_worker(url)

    def alive(self, roles=("agg", "decode"), model: Optional[str] = None
              ) -> List[WorkerInfo]:
        cutoff = time.monotonic() - self.ttl
        with self._lock:
            return [
                w for w in self._workers.values()
                if w.last_heartbeat >= cutoff and w.mode in roles
                and (model is None or w.model == model)
            ]

    def purge_expired(self) -> int:
        """Drop workers whose heartbeat TTL lapsed (alive() only FILTERS
        them; without this, a worker that died silently lingers in
        _workers forever and its expiry is invisible operationally).
        Called on every pick(); emits the worker_expired metric, labeled
        by the registration path whose refresh lapsed (reason="direct" is
        a worker that really went silent; reason="peer"/"etcd" means only
        the relay feeding this replica stopped — with NATS worker gossip
        up, a worker live ANYWHERE keeps every replica's last-seen fresh,
        so a one-frontend purge no longer churns fleet membership)."""
        cutoff = time.monotonic() - self.ttl
        with self._lock:
            dead = [(u, w.source) for u, w in self._workers.items()
                    if w.last_heartbeat < cutoff]
            for u, _src in dead:
                del self._workers[u]
            self.expired_total += len(dead)
            if dead and self.expired_counter is not None:
                for u, src in dead:
                    self.expired_counter.inc(reason=src)
        for u, _src in dead:
            self.kv_index.drop_worker(u)
        return len(dead)

    def models(self) -> List[str]:
        cutoff = time.monotonic() - self.ttl
        with self._lock:
            return sorted({
                w.model for w in self._workers.values()
                if w.last_heartbeat >= cutoff
            })

    def models_with_adapters(self) -> List[str]:
        """Base model ids plus one '<base>:<adapter>' entry per adapter any
        live worker can serve (resident or lazy-loadable) — the frontend's
        /v1/models surface."""
        cutoff = time.monotonic() - self.ttl
        out = set()
        with self._lock:
            for w in self._workers.values():
                if w.last_heartbeat < cutoff:
                    continue
                out.add(w.model)
                s = w.stats or {}
                for a in (s.get("adapters_available")
                          or s.get("adapters") or ()):
                    out.add(f"{w.model}:{a}")
        return sorted(out)

    # ------------------------------------------------------------- routing --
    def pick(self, model: str, affinity_key: str,
             roles=("agg", "decode"),
             prompt_text: Optional[str] = None,
             exclude=(),
             explain: Optional[Dict] = None,
             relaxed_overlap: bool = False,
             adapter: Optional[str] = None) -> Optional[WorkerInfo]:
        """`explain`, when given, is filled with the routing decision's
        inputs (candidate count, ledger depth/overlap, decision source) —
        the attributes the frontend's route-decision trace span records.

        `relaxed_overlap` is the recovery re-pick mode: a mid-stream
        failover re-dispatches prompt ⊕ emitted-tokens as a continuation
        prefill, so ANY worker holding even a shallow prefix of it (KV
        event index or ledger) beats the template-herding guardrail —
        the continuation's prefill cost is what the overlap offsets.

        `adapter` turns on adapter-affinity (multi-LoRA): workers
        advertising the adapter device-RESIDENT in their heartbeats win;
        with none resident, workers that can lazy-load it (host store)
        keep the request; failing that every base-model worker stays a
        candidate so stale stats can't strand the request. KV-overlap and
        HRW then run WITHIN the affinity set, and the prefix ledger/event
        index are keyed '<base>:<adapter>' so adapters never inherit each
        other's (or the base model's) routing history."""
        if explain is None:
            explain = {}
        self.purge_expired()
        cands = [w for w in self.alive(roles, model)
                 if w.url not in exclude]
        explain["candidates"] = len(cands)
        if cands:
            # circuit breakers: open breakers leave the candidate set (the
            # proactive form of the frontend's reactive failover); a
            # half-open breaker stays IN — being picked IS its probe
            allowed = [w for w in cands if self.breakers.would_allow(w.url)]
            skipped = len(cands) - len(allowed)
            if skipped:
                explain["breaker_skipped"] = skipped
            cands = allowed
        if cands:
            # engine watchdog: suspect/resurrecting/quarantined workers
            # advertise their health in heartbeats and leave the candidate
            # set — the proactive twin of their own 503 shed gate. A
            # quarantined worker would 503 every request anyway; skipping
            # it here saves the failover round trip.
            well = [w for w in cands if w.health == "healthy"]
            skipped = len(cands) - len(well)
            if skipped:
                explain["health_skipped"] = skipped
            cands = well
        if adapter and cands:
            explain["adapter"] = adapter
            resident = [w for w in cands
                        if adapter in ((w.stats or {}).get("adapters")
                                       or ())]
            if resident:
                cands = resident
                explain["adapter_affinity"] = "resident"
            else:
                lazy = [w for w in cands
                        if adapter in ((w.stats or {})
                                       .get("adapters_available") or ())]
                if lazy:
                    cands = lazy
                explain["adapter_affinity"] = "fallback_lazy_load"
        if not cands:
            # no worker serves this model -> let the frontend 503 rather than
            # bouncing the request off a wrong-model worker's 400
            return None
        # KV-overlap pass: follow the deepest prefix block we have routed
        # before, so multi-turn conversations keep landing on the worker
        # whose prefix cache holds their shared turns — even when HRW
        # load-shading diverted an earlier turn off the hash winner.
        # Guardrail against template-herding (every request sharing a
        # system prompt piling onto one worker): the overlap must be
        # RELATIVE — a true continuation shares most of its own chain
        # (its history IS the previous prompt), while an unrelated
        # request sharing only a system template matches a small leading
        # fraction however long the template is. Saturated holders still
        # shed to HRW (recompute beats queueing).
        chain = text_block_chain(prompt_text) if prompt_text else []
        # adapter requests key the routing history by '<base>:<adapter>' —
        # mirroring the engine's adapter-keyed prefix cache, so an
        # adapter's turns never herd onto a worker that only cached the
        # BASE model's KV for the same text
        ledger_model = f"{model}:{adapter}" if adapter else model
        if chain:
            live = {w.url: w for w in cands}
            # PRIMARY: the worker-published KV event index — real cache
            # contents (kvbm event plane), not this frontend's routing
            # history; the ledger covers cold/indexless prefixes
            url, depth = self.kv_index.lookup(ledger_model, chain, live)
            source = "kv_event_index"
            if url is None:
                with self._lock:
                    url, depth = self._ledger.lookup(ledger_model, chain,
                                                     live)
                source = "kv_overlap_ledger"
            # the ratio denominator uses the TRUE prompt length (capped at
            # the chain window) so a prompt longer than the hashed window
            # cannot make a long shared template look like majority
            # overlap; only a request whose entire hashed window is known
            # history clears the bar there
            denom = max(len(chain),
                        min(len(prompt_text) // BLOCK_CHARS, MAX_BLOCKS))
            explain["ledger_depth"] = depth
            explain["kv_overlap"] = round(depth / denom, 4) if denom else 0.0
            deep_enough = (depth >= 1 if relaxed_overlap
                           else depth >= 2 and depth * 10 >= 6 * denom)
            if relaxed_overlap:
                explain["recovery_repick"] = True
            if (url is not None and deep_enough
                    and live[url].headroom >= 0.05):
                with self._lock:
                    if source == "kv_event_index":
                        self.kv_index_hits += 1
                        if self.kv_index_counter is not None:
                            self.kv_index_counter.inc()
                    else:
                        self.ledger_hits += 1
                        if self.ledger_counter is not None:
                            self.ledger_counter.inc()
                    self._ledger.record(ledger_model, chain, url)
                explain["source"] = source
                explain["headroom"] = round(live[url].headroom, 4)
                return self._finish_pick(live[url], explain)
        picked = _pick_native(affinity_key, cands)
        explain["source"] = "hrw_native" if picked is not None else "hrw"
        if picked is None:
            best, best_score = None, -1.0
            for w in cands:
                h = hashlib.sha256(
                    (affinity_key + "|" + w.url).encode()
                ).digest()
                hash_score = int.from_bytes(h[:8], "big") / 2**64
                # weighted rendezvous: capacity scales the hash draw; a
                # worker with zero headroom can still win if it is the
                # only candidate
                score = hash_score * (0.25 + 0.75 * w.headroom)
                if score > best_score:
                    best, best_score = w, score
            picked = best
        if chain and picked is not None:
            with self._lock:
                self._ledger.record(ledger_model, chain, picked.url)
        if picked is not None:
            explain["headroom"] = round(picked.headroom, 4)
            return self._finish_pick(picked, explain)
        return picked

    def _finish_pick(self, picked: WorkerInfo, explain: Dict) -> WorkerInfo:
        """Common tail of every successful pick: consume the half-open
        probe slot (if any) and expose breaker state to the trace span."""
        self.breakers.on_picked(picked.url)
        explain["breaker"] = self.breakers.state(picked.url)
        return picked

    def pick_prefill(self, model: str, affinity_key: str) -> Optional[WorkerInfo]:
        return self.pick(model, affinity_key, roles=("prefill",))
