"""etcd-backed worker registry sync.

The port's own copy of `dynamo_tpu/serving/registry.py` (it imports nothing
of the JAX package); keep the two in step.

The reference platform keeps its component registry in etcd
(reference install-dynamo-1node.sh:238-239, the reason the install
waits on dynamo-platform-etcd-0). Our workers heartbeat to the frontend over
HTTP; with multiple frontend replicas behind one Service, each replica only
sees the heartbeats the Service happens to route to it. This module closes
the gap: every frontend replica publishes its locally-heartbeated workers to
etcd under a shared prefix (lease-scoped so dead frontends' records expire)
and merges every replica's records back into its own Router.

Talks to etcd's v3 JSON/gRPC gateway (enabled by default on :2379 in the
platform StatefulSet, deploy/platform/etcd.yaml) with stdlib urllib only —
keys/values are base64 per the gateway contract. Registry failures degrade
to local-only discovery; they never take the frontend down.
"""

from __future__ import annotations

import base64
import json
import logging
import threading
import time
import urllib.request
from typing import Dict, List, Optional

log = logging.getLogger("dynamo_tpu_torch.registry")


def _b64(s: str) -> str:
    return base64.b64encode(s.encode()).decode()


def _unb64(s: str) -> str:
    return base64.b64decode(s).decode()


class EtcdClient:
    """Minimal etcd v3 gateway client: lease grant/keepalive, put, range."""

    def __init__(self, endpoint: str, timeout: float = 5.0):
        self.endpoint = endpoint.rstrip("/")
        self.timeout = timeout

    def _call(self, path: str, body: dict) -> dict:
        req = urllib.request.Request(
            self.endpoint + path,
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return json.loads(resp.read() or b"{}")

    def grant_lease(self, ttl_s: int) -> int:
        out = self._call("/v3/lease/grant", {"TTL": ttl_s})
        return int(out["ID"])

    def keepalive(self, lease_id: int) -> bool:
        """True only if the lease is still alive — the gateway answers 200
        with an empty/zero-TTL result for an expired lease."""
        try:
            out = self._call("/v3/lease/keepalive", {"ID": lease_id})
            result = out.get("result") or {}
            return int(result.get("TTL", 0)) > 0
        except Exception:
            return False

    def delete(self, key: str):
        self._call("/v3/kv/deleterange", {"key": _b64(key)})

    def put(self, key: str, value: str, lease_id: Optional[int] = None):
        body = {"key": _b64(key), "value": _b64(value)}
        if lease_id:
            body["lease"] = lease_id
        self._call("/v3/kv/put", body)

    def range_prefix(self, prefix: str) -> Dict[str, str]:
        """All keys under prefix -> {key: value}."""
        end = prefix[:-1] + chr(ord(prefix[-1]) + 1)
        out = self._call(
            "/v3/kv/range", {"key": _b64(prefix), "range_end": _b64(end)}
        )
        kvs = out.get("kvs") or []
        return {_unb64(kv["key"]): _unb64(kv["value"]) for kv in kvs}


class EtcdRegistry:
    """Background sync between a Router and the shared etcd registry."""

    PREFIX = "/dynamo_tpu/workers/"

    def __init__(self, router, endpoint: str, ttl_s: int = 15,
                 interval_s: float = 3.0):
        self.router = router
        self.client = EtcdClient(endpoint)
        self.ttl_s = ttl_s
        self.interval_s = interval_s
        self._lease: Optional[int] = None
        self._published: set = set()  # keys this frontend currently owns
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- lifecycle
    def start(self):
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="etcd-registry"
        )
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()

    # ------------------------------------------------------------- sync loop
    def _ensure_lease(self) -> Optional[int]:
        if self._lease is not None and self.client.keepalive(self._lease):
            return self._lease
        try:
            self._lease = self.client.grant_lease(self.ttl_s)
        except Exception as e:
            log.debug("etcd lease grant failed: %s", e)
            self._lease = None
        return self._lease

    def sync_once(self) -> int:
        """Publish directly-heartbeated workers, merge remote ones.

        Merged (peer-origin) workers are NEVER re-published — re-publishing
        would re-parent a dead worker's record under this frontend's live
        lease and resurrect it forever. Liveness is etcd lease expiry alone:
        the keepalive happens in this same loop that prunes dead workers, so
        a live lease implies a running sync loop implies pruned records. (A
        producer-wall-clock staleness check was dropped — cross-host clock
        skew > 2*ttl silently degraded discovery to local-only.) Returns the
        merged count."""
        lease = self._ensure_lease()
        if lease is None:
            return 0
        local = [
            w for w in self.router.alive(roles=("agg", "prefill", "decode"))
            if w.source == "direct"
        ]
        now = time.time()
        live_keys = set()
        for w in local:
            record = json.dumps({
                "url": w.url, "model": w.model, "mode": w.mode,
                "stats": w.stats, "ts": now,
            })
            key = self.PREFIX + w.url
            live_keys.add(key)
            try:
                self.client.put(key, record, lease)
                self._published.add(key)
            except Exception as e:
                log.debug("etcd put failed for %s: %s", w.url, e)
        # drop records for workers that stopped heartbeating here
        for key in list(self._published - live_keys):
            try:
                self.client.delete(key)
                self._published.discard(key)
            except Exception as e:
                log.debug("etcd delete failed for %s: %s", key, e)
        # merge peers' records
        merged = 0
        try:
            records = self.client.range_prefix(self.PREFIX)
        except Exception as e:
            log.debug("etcd range failed: %s", e)
            return 0
        known = {w.url for w in local}
        for _, raw in records.items():
            try:
                rec = json.loads(raw)
            except json.JSONDecodeError:
                continue
            if rec.get("url") in known:
                continue  # local heartbeats are fresher
            self.router.register(
                rec["url"], rec.get("model", "?"), rec.get("mode", "agg"),
                stats=rec.get("stats"), source="etcd",
            )
            merged += 1
        return merged

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.sync_once()
            except Exception as e:  # registry must never take the frontend down
                log.warning("etcd sync failed: %s", e)
