"""HA frontend plane: journal-on-NATS, resume claims, gossiped tenant
counters, worker-registration gossip (docs/robustness.md "HA frontend
plane").

The port's own copy of `dynamo_tpu/serving/ha.py` (it imports nothing of the
JAX package); keep the two in step: replicas of both packages share this
plane's subjects and records.

One frontend process used to hold four pieces of state that made it the
last SPOF in a stack whose workers are already hitless: the recovery
journal (serving/recovery.py), the KV event index, per-tenant admission
counts, and worker membership. This module replicates all four across N
frontend replicas over the SAME core-NATS plane the request path already
rides — no JetStream, no new dependency:

- **JournalPlane** — every worker ``dynr`` journal record a frontend
  relays (start record, seam checkpoints ``{n, c, t}``) is re-published
  on ``dynamo.journal.rec.<response-id>``; every frontend subscribes the
  wildcard into a bounded-LRU store, so a stream whose frontend dies can
  be resumed **byte-identically through a different frontend**: the
  client re-POSTs the original body plus ``dynamo_resume`` (response id
  + its own delivered-chars cursor), the surviving frontend rebuilds the
  ``dynamo_recovery`` continuation from the stored record, re-picks
  a worker with ``relaxed_overlap``, and relays exactly the chars past
  the seam. The store reuses the journal's n-consistency check: a
  replica that joined mid-stream (missed checkpoints) marks its record
  invalid and REFUSES the resume rather than risking duplicate tokens.
- **Resume claims** — two frontends racing to resume the same response
  id resolve to a single winner: each publishes a claim (nonce + its
  frontend id) on the journal subject and wins only if its claim is the
  minimum after a short deterministic window. Against a JetStream-
  enabled nats-server this maps onto a real KV compare-and-set; over
  core pub/sub (the mini broker) the claim window provides the same
  single-winner guarantee for in-process delivery.
- **TenantGossip** — bounded-staleness approximate tenant in-flight
  counters: each frontend periodically publishes its per-tenant counts
  on ``dynamo.frontend.gossip.<frontend-id>``; peers fold fresh
  snapshots into admission (qos/tenancy.TenantAdmission.peer_counts_fn)
  so the per-tenant weighted caps and over-share predicate hold FLEET-wide.
  Shed decisions stay local — gossip only widens the counters.
- **WorkerGossip** — a worker heartbeating to one frontend is
  re-published to the others (``source="peer"``), so a replica that
  never heard the heartbeat directly does not TTL-purge a live worker.

Kill switch: a frontend without a NATS url simply has no HA plane —
single-frontend behavior is byte-identical to the pre-HA stack.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from dynamo_tpu_torch.serving.nats import subject_token

log = logging.getLogger("dynamo_tpu_torch.ha")

# journal records / claims for one response id; the token is
# subject_token(response_id) so arbitrary ids stay one subject token
JOURNAL_SUBJECT_PREFIX = "dynamo.journal.rec"
JOURNAL_WILDCARD = JOURNAL_SUBJECT_PREFIX + ".>"
# per-frontend tenant in-flight snapshots
GOSSIP_SUBJECT_PREFIX = "dynamo.frontend.gossip"
GOSSIP_WILDCARD = GOSSIP_SUBJECT_PREFIX + ".>"
# worker membership relays (register/deregister heard directly)
WORKERS_SUBJECT_PREFIX = "dynamo.frontend.workers"
WORKERS_WILDCARD = WORKERS_SUBJECT_PREFIX + ".>"

# client -> frontend: body extension requesting a cross-frontend resume
RESUME_BODY_KEY = "dynamo_resume"

FRONTEND_ID_ENV = "DYNAMO_TPU_FRONTEND_ID"
# peers whose last gossip snapshot is older than this are ignored — the
# staleness bound on the approximate counters
GOSSIP_STALE_ENV = "DYNAMO_TPU_GOSSIP_STALE_S"
DEFAULT_GOSSIP_STALE_S = 5.0
# periodic snapshot cadence (0 disables the publisher thread; tests call
# publish_now() for deterministic propagation)
GOSSIP_INTERVAL_ENV = "DYNAMO_TPU_GOSSIP_INTERVAL_S"
DEFAULT_GOSSIP_INTERVAL_S = 1.0
# resume-claim settle window: how long a claimant waits for competing
# claims before declaring itself the winner
CLAIM_WINDOW_ENV = "DYNAMO_TPU_CLAIM_WINDOW_S"
DEFAULT_CLAIM_WINDOW_S = 0.05

# journal store LRU bound (records, i.e. concurrently-tracked streams)
JOURNAL_CAP = 4096


def _env_float(name: str, default: float) -> float:
    try:
        return max(0.0, float(os.environ.get(name, default)))
    except ValueError:
        return default


def frontend_id() -> str:
    """Stable-ish identity for this frontend replica: the operator
    materializes the pod name into DYNAMO_TPU_FRONTEND_ID; standalone
    processes mint a random one (identity only needs to be unique, not
    persistent — a restarted frontend rebuilds all HA state from NATS)."""
    fid = (os.environ.get(FRONTEND_ID_ENV) or "").strip()
    return subject_token(fid) if fid else f"fe-{uuid.uuid4().hex[:10]}"


def journal_subject(rid: str) -> str:
    return f"{JOURNAL_SUBJECT_PREFIX}.{subject_token(rid)}"


def normalize_resume(rec: Any) -> Dict[str, Any]:
    """Validate an inbound ``dynamo_resume`` body extension. Raises
    ValueError on garbage — mapped to HTTP 400 upstream."""
    if not isinstance(rec, dict):
        raise ValueError(f"'{RESUME_BODY_KEY}' must be an object")
    rid = rec.get("response_id")
    if not isinstance(rid, str) or not rid or len(rid) > 80 \
            or not rid.isprintable():
        raise ValueError("'response_id' must be a short printable string")
    delivered = rec.get("delivered_chars", 0)
    if isinstance(delivered, bool) or not isinstance(delivered, int) \
            or delivered < 0:
        raise ValueError("'delivered_chars' must be a non-negative integer")
    return {"response_id": rid, "delivered_chars": int(delivered)}


class JournalRecord:
    """One stream's replicated recovery journal, rebuilt from the worker's
    own ``dynr`` records as relayed by whichever frontend owns the stream."""

    __slots__ = ("rid", "tokens", "checkpoint_chars", "seed", "resume_key",
                 "origin", "valid", "started", "done", "updated", "claims")

    def __init__(self, rid: str):
        self.rid = rid
        self.tokens: List[int] = []
        self.checkpoint_chars = 0
        self.seed: Optional[int] = None
        self.resume_key: Optional[List[int]] = None
        self.origin: Optional[str] = None  # frontend id that relayed last
        # valid flips False on an n-gap (this replica missed checkpoints);
        # started requires the start record (carries the pinned seed) —
        # both must hold for a resume to be safe
        self.valid = True
        self.started = False
        self.done = False
        self.updated = time.monotonic()
        # claimant fid -> (nonce, received_monotonic); stale claims expire
        # so a claimant that crashed after winning cannot block resumes
        self.claims: Dict[str, tuple] = {}

    def apply(self, rec: Dict) -> None:
        """Apply one worker journal record (the exact objects
        recovery.RequestJournal.apply_comment consumes)."""
        self.updated = time.monotonic()
        start = rec.get("start")
        if isinstance(start, dict):
            self.started = True
            if start.get("seed") is not None:
                try:
                    self.seed = int(start["seed"])
                except (TypeError, ValueError):
                    pass
            return
        try:
            self.tokens.extend(int(t) for t in (rec.get("t") or []))
        except (TypeError, ValueError):
            self.valid = False
            return
        n = rec.get("n")
        if n is not None and int(n) != len(self.tokens):
            # same invariant as the live RequestJournal: a dropped or
            # reordered checkpoint corrupts the seam — refuse to resume
            # rather than risk duplicated tokens
            self.valid = False
        if rec.get("c") is not None:
            try:
                self.checkpoint_chars = int(rec["c"])
            except (TypeError, ValueError):
                self.valid = False
        if rec.get("key") is not None:
            try:
                self.resume_key = [int(k) for k in rec["key"]][:2]
            except (TypeError, ValueError):
                pass

    @property
    def resumable(self) -> bool:
        return self.valid and self.started and not self.done


class JournalPlane:
    """Replicated journal store + resume-claim protocol over one NATS
    subject family. Each frontend both publishes the records of streams
    it relays and subscribes the wildcard, so every replica converges on
    the same (bounded-LRU) view."""

    def __init__(self, nats, fid: str, cap: int = JOURNAL_CAP,
                 claim_window_s: Optional[float] = None):
        import collections

        self.nats = nats
        self.fid = fid
        self.cap = cap
        self.claim_window_s = (
            claim_window_s if claim_window_s is not None
            else _env_float(CLAIM_WINDOW_ENV, DEFAULT_CLAIM_WINDOW_S))
        self._records: "collections.OrderedDict[str, JournalRecord]" = (  # guarded_by: _lock
            collections.OrderedDict())
        self._lock = threading.Lock()
        # wired by the frontend to dynamo_frontend_ha_* counters
        self.published_counter = None
        self.applied_counter = None
        self.published_total = 0
        self.applied_total = 0
        if nats is not None:
            nats.subscribe(JOURNAL_WILDCARD, self._on_msg)

    # ------------------------------------------------------------ publish --
    def _publish(self, rid: str, envelope: Dict) -> None:
        if self.nats is None:
            return
        envelope["rid"] = rid
        envelope["origin"] = self.fid
        try:
            self.nats.publish(journal_subject(rid),
                              json.dumps(envelope,
                                         separators=(",", ":")).encode())
        except (OSError, ConnectionError) as e:
            # the plane is advisory for the OWNING stream (its live
            # RequestJournal still recovers locally); peers just see a
            # gap and mark the record non-resumable
            log.debug("journal publish failed for %s: %s", rid, e)
            return
        self.published_total += 1
        if self.published_counter is not None:
            self.published_counter.inc(direction="published")

    def publish_record(self, rid: str, raw: bytes) -> None:
        """Re-publish one worker ``dynr`` record (raw JSON bytes as parsed
        off the SSE comment) under the stream's response id."""
        try:
            rec = json.loads(raw)
        except (ValueError, UnicodeDecodeError):
            return
        if isinstance(rec, dict):
            self._publish(rid, {"rec": rec})

    def publish_done(self, rid: str) -> None:
        """Tombstone: the stream completed ([DONE] delivered) — peers must
        refuse resumes instead of re-running generation past EOS."""
        self._publish(rid, {"done": True})

    # ------------------------------------------------------------ receive --
    def _on_msg(self, msg) -> None:
        try:
            obj = json.loads(msg.data)
        except (ValueError, UnicodeDecodeError):
            return
        if not isinstance(obj, dict):
            return
        rid = obj.get("rid")
        if not isinstance(rid, str) or not rid:
            return
        with self._lock:
            rec = self._records.get(rid)
            if rec is None:
                rec = self._records[rid] = JournalRecord(rid)
            else:
                self._records.move_to_end(rid)
            origin = obj.get("origin")
            if isinstance(origin, str):
                rec.origin = origin
            claim = obj.get("claim")
            if isinstance(claim, dict):
                fid, nonce = claim.get("fid"), claim.get("nonce")
                if isinstance(fid, str) and isinstance(nonce, str):
                    rec.claims[fid] = (nonce, time.monotonic())
            elif obj.get("done"):
                rec.done = True
                rec.claims.clear()
            elif isinstance(obj.get("rec"), dict):
                rec.apply(obj["rec"])
            while len(self._records) > self.cap:
                self._records.popitem(last=False)
        self.applied_total += 1
        if self.applied_counter is not None:
            self.applied_counter.inc(direction="applied")

    # ------------------------------------------------------------- lookup --
    def lookup(self, rid: str) -> Optional[JournalRecord]:
        with self._lock:
            return self._records.get(rid)

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    # -------------------------------------------------------------- claim --
    def claim(self, rid: str, nonce: Optional[str] = None,
              window_s: Optional[float] = None) -> bool:
        """Single-winner resume claim. Publish (nonce, fid) on the journal
        subject, wait the settle window for competing claims, and win only
        if ours orders first. Core-NATS emulation of a KV compare-and-set:
        with reliable in-process delivery exactly one claimant sees itself
        as the minimum; a JetStream deployment would CAS the claim key
        instead and skip the window."""
        nonce = nonce if nonce is not None else uuid.uuid4().hex
        window = (window_s if window_s is not None else self.claim_window_s)
        self._publish(rid, {"claim": {"fid": self.fid, "nonce": nonce}})
        if window > 0:
            time.sleep(window)
        # only claims fresher than the settle horizon compete: a claimant
        # that crashed after winning ages out instead of blocking forever
        horizon = time.monotonic() - max(2.0 * window, 1.0)
        with self._lock:
            rec = self._records.get(rid)
            claims = {fid: n for fid, (n, ts) in rec.claims.items()
                      if ts >= horizon} if rec is not None else {}
        # defensive: our own claim must count even if the broker did not
        # echo it back yet (publisher-side network hiccup)
        claims.setdefault(self.fid, nonce)
        winner = min(claims.items(), key=lambda kv: (kv[1], kv[0]))[0]
        return winner == self.fid

    def release_claim(self, rid: str) -> None:
        """Drop every claim on `rid` (the winner finished or gave up, so a
        later resume attempt must not lose to a ghost claim)."""
        with self._lock:
            rec = self._records.get(rid)
            if rec is not None:
                rec.claims.clear()

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"streams": len(self._records),
                    "published": self.published_total,
                    "applied": self.applied_total}


class TenantGossip:
    """Bounded-staleness per-tenant in-flight counters across the frontend
    fleet. Each replica publishes its own TenantAdmission counts (snapshot
    + monotonic seq, so late/reordered core-NATS deliveries can't rewind a
    peer's view); receivers keep the freshest snapshot per peer and ignore
    anything older than the staleness bound. ``peer_counts()`` is the fold
    TenantAdmission consumes — admission DECISIONS stay local."""

    def __init__(self, nats, fid: str, admission,
                 interval_s: Optional[float] = None,
                 stale_s: Optional[float] = None):
        self.nats = nats
        self.fid = fid
        self.admission = admission
        self.interval_s = (
            interval_s if interval_s is not None
            else _env_float(GOSSIP_INTERVAL_ENV, DEFAULT_GOSSIP_INTERVAL_S))
        self.stale_s = (stale_s if stale_s is not None
                        else _env_float(GOSSIP_STALE_ENV,
                                        DEFAULT_GOSSIP_STALE_S))
        self._seq = 0
        # peer fid -> (received_monotonic, seq, {tenant: inflight})
        self._peers: Dict[str, tuple] = {}
        self._lock = threading.Lock()
        self.sent_total = 0
        self.received_total = 0
        self.gossip_counter = None  # wired to dynamo_frontend_ha_gossip_*
        self._stop = threading.Event()
        if nats is not None:
            nats.subscribe(GOSSIP_WILDCARD, self._on_msg)
            if self.interval_s > 0:
                threading.Thread(target=self._publish_loop, daemon=True,
                                 name="tenant-gossip").start()

    def _publish_loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.publish_now()

    def stop(self) -> None:
        self._stop.set()

    def publish_now(self) -> None:
        if self.nats is None:
            return
        with self._lock:
            self._seq += 1
            seq = self._seq
        counts = self.admission.snapshot()["inflight"]
        payload = json.dumps(
            {"fid": self.fid, "seq": seq, "inflight": counts},
            separators=(",", ":")).encode()
        try:
            self.nats.publish(f"{GOSSIP_SUBJECT_PREFIX}.{self.fid}", payload)
        except (OSError, ConnectionError):
            return  # this round is lost; the next snapshot supersedes it
        self.sent_total += 1
        if self.gossip_counter is not None:
            self.gossip_counter.inc(direction="sent")

    def _on_msg(self, msg) -> None:
        try:
            obj = json.loads(msg.data)
        except (ValueError, UnicodeDecodeError):
            return
        if not isinstance(obj, dict):
            return
        fid = obj.get("fid")
        if not isinstance(fid, str) or fid == self.fid:
            return
        counts = obj.get("inflight")
        if not isinstance(counts, dict):
            return
        try:
            seq = int(obj.get("seq", 0))
        except (TypeError, ValueError):
            return
        clean = {str(t): int(n) for t, n in counts.items()
                 if isinstance(n, int) and not isinstance(n, bool) and n >= 0}
        with self._lock:
            prev = self._peers.get(fid)
            if prev is not None and prev[1] >= seq:
                return  # stale/reordered snapshot must not rewind the view
            self._peers[fid] = (time.monotonic(), seq, clean)
        self.received_total += 1
        if self.gossip_counter is not None:
            self.gossip_counter.inc(direction="received")

    def peer_counts(self) -> Dict[str, int]:
        """Per-tenant in-flight summed over peers with a FRESH snapshot
        (the staleness bound: a dead peer's load stops counting against
        tenant caps within stale_s)."""
        cutoff = time.monotonic() - self.stale_s
        out: Dict[str, int] = {}
        with self._lock:
            for ts, _seq, counts in self._peers.values():
                if ts < cutoff:
                    continue
                for t, n in counts.items():
                    out[t] = out.get(t, 0) + n
        return out

    def live_peers(self) -> int:
        cutoff = time.monotonic() - self.stale_s
        with self._lock:
            return sum(1 for ts, _s, _c in self._peers.values()
                       if ts >= cutoff)

    def stats(self) -> Dict[str, Any]:
        return {"fid": self.fid, "live_peers": self.live_peers(),
                "peer_inflight": self.peer_counts(),
                "sent": self.sent_total, "received": self.received_total}


class WorkerGossip:
    """Relay worker membership between frontend replicas: a register or
    deregister heard DIRECTLY (HTTP heartbeat) is re-published; peers
    apply it with ``source="peer"`` — which, like etcd merges, never
    clobbers a fresh direct heartbeat — so a worker heartbeating to one
    replica stays registered (and TTL-refreshed) on all of them."""

    def __init__(self, nats, fid: str, router):
        self.nats = nats
        self.fid = fid
        self.router = router
        self.relayed_total = 0
        self.applied_total = 0
        if nats is not None:
            nats.subscribe(WORKERS_WILDCARD, self._on_msg)

    def _publish(self, payload: Dict) -> None:
        if self.nats is None:
            return
        payload["fid"] = self.fid
        try:
            self.nats.publish(f"{WORKERS_SUBJECT_PREFIX}.{self.fid}",
                              json.dumps(payload,
                                         separators=(",", ":")).encode())
            self.relayed_total += 1
        except (OSError, ConnectionError):
            pass  # peers fall back to their own TTL view

    def publish_register(self, url: str, model: str, mode: str,
                         stats: Optional[Dict]) -> None:
        self._publish({"op": "register", "url": url, "model": model,
                       "mode": mode, "stats": stats})

    def publish_deregister(self, url: str) -> None:
        self._publish({"op": "deregister", "url": url})

    def _on_msg(self, msg) -> None:
        try:
            obj = json.loads(msg.data)
        except (ValueError, UnicodeDecodeError):
            return
        if not isinstance(obj, dict) or obj.get("fid") == self.fid:
            return
        url = obj.get("url")
        if not isinstance(url, str) or not url:
            return
        op = obj.get("op")
        if op == "register":
            self.router.register(url, str(obj.get("model", "?")),
                                 str(obj.get("mode", "agg")),
                                 obj.get("stats") if isinstance(
                                     obj.get("stats"), dict) else None,
                                 source="peer")
            self.applied_total += 1
        elif op == "deregister":
            # an explicit drain is authoritative everywhere: the worker
            # itself asked to stop receiving traffic
            self.router.deregister(url)
            self.applied_total += 1


def build_continuation(rec: JournalRecord,
                       delivered_chars: int) -> Dict[str, Any]:
    """The ``dynamo_recovery`` body extension for a cross-frontend
    resume: the replicated journal supplies the seam (tokens, seed,
    sampler resume key); the CLIENT supplies its own delivered-chars
    cursor — the dying frontend's delivered count died with it, and the
    checkpoint-before-data invariant guarantees the journal covers
    everything any client actually saw."""
    return {
        "prior_tokens": list(rec.tokens),
        "delivered_chars": int(delivered_chars),
        "seed": rec.seed,
        "resume_key": (None if rec.resume_key is None
                       else list(rec.resume_key)),
        "response_id": rec.rid,
        "role_sent": True,
    }
