"""Decode-worker side of disaggregated serving.

The port's copy of `dynamo_tpu/serving/disagg.py`. Request flow (the
reference's disagg topology, examples/deploy/sglang/disagg.yaml): the
frontend routes the user request to a DECODE worker; the decode worker
picks a PREFILL worker, POSTs /disagg/prefill, pulls the KV over one of
three planes, imports it into its own paged cache in place, and streams
tokens from there. The planes, counted in
`dynamo_worker_kv_transfers_total{plane}`:

- `ici_inproc`: the prefill engine lives in this process
  (`transfer.ici_registry`): direct engine calls and a device-to-device
  copy, no HTTP RPC and no host bounce;
- `ici_device`: another process on this card (or on one with peer
  access): the /disagg/stage RPC exports the gathered pages over CUDA IPC
  and this side opens them (`transfer.kv_transfer.DeviceKVClient`);
- `dcn`: the TCP plane through host memory (`fetch_kv`).

Under the `ici` backend a pair that can use neither device plane falls
back to `dcn` on purpose and warns once per pair, as the JAX client does;
the per-plane counts (also in `/worker/stats` `transfer_planes`) are what
a deployment checks to see that it did not.
"""

from __future__ import annotations

import hashlib
import json
import logging
import socket
import threading
import time
import urllib.parse
import urllib.request
from typing import Dict, List, Optional

import torch

from dynamo_tpu_torch.engine.request import GenRequest, TokenEvent
from dynamo_tpu_torch.observability import context as obs_context
from dynamo_tpu_torch.observability import tracing as obs_tracing
from dynamo_tpu_torch.robustness import deadline as ddl
from dynamo_tpu_torch.robustness import faults
from dynamo_tpu_torch.serving.metrics import Counter
from dynamo_tpu_torch.transfer import ici_registry
from dynamo_tpu_torch.transfer.kv_transfer import (DeviceKVClient,
                                                   device_uuid, fetch_kv)
from dynamo_tpu_torch.utils import net

log = logging.getLogger("dynamo_tpu_torch.disagg")


def _trace_headers(span) -> Dict[str, str]:
    """HTTP headers carrying `span`'s context to the prefill worker (empty
    when tracing is off — the RPCs stay byte-identical to the untraced
    wire format)."""
    h: Dict[str, str] = {}
    ctx = getattr(span, "context", None)
    if ctx is not None:
        obs_context.inject_context(ctx, h)
    return h


class _StagedPullError(Exception):
    """Device pull failed AFTER the stage RPC pinned a gather remotely:
    the TCP fallback must still send /disagg/release or the prefill
    worker's stage-ledger slot (and the gathered HBM copy) leaks."""


class _PrefillUnreachable(Exception):
    """Connection-level failure BEFORE any KV moved (retry-safe)."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class PrefillPool:
    """Known prefill workers: static (--prefill-url) plus frontend discovery."""

    def __init__(self, static_urls: Optional[List[str]] = None,
                 frontend_url: Optional[str] = None,
                 refresh_interval: float = 5.0):
        self._static = [u.strip() for u in (static_urls or []) if u.strip()]
        self._discovered: List[str] = []
        # HA frontend plane: frontend_url may name N replicas
        # (comma-separated); discovery asks each in turn until one answers
        # — every replica's registry is complete on its own
        self._frontend_urls = [u.strip() for u in (frontend_url or "").split(",")
                               if u.strip()]
        self._lock = threading.Lock()
        if frontend_url:
            t = threading.Thread(target=self._refresh_loop,
                                 args=(refresh_interval,), daemon=True,
                                 name="prefill-discovery")
            t.start()

    def _refresh_loop(self, interval: float):
        while True:
            for fe in self._frontend_urls:
                try:
                    with urllib.request.urlopen(
                        fe.rstrip("/") + "/internal/workers",
                        timeout=5,
                    ) as resp:
                        workers = json.loads(resp.read())["workers"]
                    urls = [w["url"] for w in workers
                            if w.get("mode") == "prefill"]
                    with self._lock:
                        self._discovered = urls
                    break
                except Exception as e:
                    log.debug("prefill discovery via %s failed: %s", fe, e)
            time.sleep(interval)

    def urls(self) -> List[str]:
        with self._lock:
            return list(dict.fromkeys(self._static + self._discovered))

    def pick(self, affinity_key: str, exclude=()) -> Optional[str]:
        urls = [u for u in self.urls() if u not in exclude]
        if not urls:
            return None
        best, best_score = None, -1
        for u in urls:
            h = hashlib.sha256((affinity_key + "|" + u).encode()).digest()
            score = int.from_bytes(h[:8], "big")
            if score > best_score:
                best, best_score = u, score
        return best


class DisaggDecodeClient:
    """Runs the prefill RPC + KV pull + import for one request."""

    PLANES = ("ici_inproc", "ici_device", "dcn")

    def __init__(self, ctx, pool: PrefillPool):
        self.ctx = ctx  # ServingContext
        self.pool = pool
        self._device_client = None
        self._dcn_warned: set = set()
        # the card this worker's pools live on: a prefill peer advertises
        # the device plane only to a decode worker that can open its memory
        self._uuid = device_uuid(ctx.engine.device)
        # per-plane COMPLETED-transfer counts (thread-safe labeled Counter,
        # scraped at /metrics and mirrored in /worker/stats): an ici
        # deployment that degrades to dcn is visible operationally
        self._plane_counter = Counter(
            "dynamo_worker_kv_transfers_total",
            "Completed disagg KV transfers by data plane",
            ctx.metrics.registry, labelnames=("plane",))

    @property
    def plane_counts(self) -> dict:
        vals = {p: 0 for p in self.PLANES}
        with self._plane_counter._lock:
            for lbl, v in self._plane_counter._values.items():
                vals[dict(lbl)["plane"]] = int(v)
        return vals

    def _warn_dcn_fallback(self, prefill_url: str, why: str):
        """--disaggregation-transfer-backend ici was requested but this pair
        degrades to the TCP plane: say so LOUDLY, once per pair (an operator
        deploying ici across pods must see the downgrade, not discover it in
        a bandwidth profile)."""
        if prefill_url in self._dcn_warned:
            return
        self._dcn_warned.add(prefill_url)
        log.warning(
            "ici transfer backend: prefill %s %s — falling back to the dcn "
            "(TCP host-bounce) plane for this pair", prefill_url, why)

    def start(self, req: GenRequest, parent_span=None,
              deadline: Optional[ddl.Deadline] = None) -> "object":
        """Returns the event queue, with the first token already delivered.

        Bounded prefill failover: an UNREACHABLE prefill worker (connection
        refused / dropped before any KV moved) is retried on the pool's
        next rendezvous pick; definitive rejections (400) and mid-transfer
        failures stay terminal.

        `parent_span` (the decode worker's request span) parents the
        disagg.prefill_rpc / disagg.kv_pull / disagg.kv_release spans and
        its trace context rides the prefill RPCs as HTTP headers.
        `deadline` (the request's remaining budget) bounds the prefill RPC
        and rides it as the x-deadline header."""
        if parent_span is None:
            parent_span = obs_tracing.NOOP_SPAN
        affinity = "".join(map(str, req.prompt_token_ids[:64]))
        tried: list = []
        while True:
            if deadline is not None and deadline.expired:
                raise TimeoutError(
                    "deadline budget exhausted before prefill dispatch")
            prefill_url = self.pool.pick(affinity, exclude=tried)
            if prefill_url is None:
                if tried:
                    raise RuntimeError(
                        f"prefill workers unreachable: {', '.join(tried)}")
                raise RuntimeError("no prefill worker available")
            try:
                return self._start_on(req, prefill_url, parent_span,
                                      deadline)
            except _PrefillUnreachable as e:
                log.warning("prefill %s unreachable (%s); failing over",
                            prefill_url, e.reason)
                tried.append(prefill_url)
                if len(tried) >= 3:
                    raise RuntimeError(
                        f"prefill workers unreachable: {', '.join(tried)}"
                    ) from e

    def _start_on(self, req: GenRequest, prefill_url: str,
                  parent_span=obs_tracing.NOOP_SPAN,
                  deadline: Optional[ddl.Deadline] = None) -> "object":
        ctx = self.ctx
        if ctx.engine.cfg.disaggregation_transfer_backend == "ici":
            local = ici_registry.lookup(prefill_url)
            if local is not None:
                return self._start_ici(req, local, prefill_url, parent_span)

        body = json.dumps({
            "request_id": req.request_id,
            "prompt_token_ids": req.prompt_token_ids,
            "temperature": req.temperature,
            "top_p": req.top_p,
            "top_k": req.top_k,
            "min_p": req.min_p,
            "logit_bias": req.logit_bias,
            # seeded requests must sample the same first token the agg path
            # would (the prefill worker continues the request's key chain)
            "seed": req.seed,
            "logprobs": req.logprobs,
            # the prefill worker samples the FIRST token, so the grammar
            # mask must apply there too
            "guided_json": req.guided_json,
            # multi-LoRA: prefill must run under the same adapter weights
            # the decode side will attach
            "adapter": req.adapter,
            # per-tenant QoS: the prefill worker's spans/metrics carry the
            # same tenant identity the decode side resolved
            "tenant": req.tenant,
            # the card this decode worker runs on: the prefill side offers
            # the CUDA IPC plane only to a peer that can open its memory
            # (a JAX prefill worker ignores the field)
            "device_uuid": self._uuid,
        }).encode()
        t0 = time.monotonic()
        rpc_span = ctx.tracer.start_span(
            "disagg.prefill_rpc", parent=parent_span, kind="client",
            attributes={"prefill.url": prefill_url,
                        "request.id": req.request_id,
                        "prompt_tokens": len(req.prompt_token_ids)})
        try:
            out = self._prefill_rpc(prefill_url, body, rpc_span, deadline)
        except BaseException as e:
            rpc_span.set_status("ERROR", f"{type(e).__name__}: {e}")
            rpc_span.end()
            raise
        rpc_span.set_attribute("n_tokens", int(out.get("n_tokens", 0)))
        rpc_span.end()
        # phase 2 — the KV pull. The prefill side now holds parked pages;
        # failures here are terminal for this request (the parked-KV TTL
        # sweep reclaims the pages), never silently retried elsewhere.
        pull_span = ctx.tracer.start_span(
            "disagg.kv_pull", parent=parent_span, kind="client",
            attributes={"prefill.url": prefill_url,
                        "request.id": req.request_id})
        first_token = out["first_token"]
        host = urllib.parse.urlparse(prefill_url).hostname
        released = False
        staged_ok = False  # stage RPC pinned a gather on the prefill side
        k = None
        want_ici = (
            ctx.engine.cfg.disaggregation_transfer_backend == "ici")
        if want_ici and out.get("device_transfer"):
            try:
                # cross-process device-buffer pull (no host bounce): the
                # stage RPC, then the peer's memory opened over CUDA IPC
                k, v = self._pull_device(prefill_url, req.request_id,
                                         pull_span)
                n_tokens = out["n_tokens"]
                self._plane_counter.inc(plane="ici_device")
            except _StagedPullError as e:
                staged_ok = True
                pull_span.add_event("device_pull_failed", {"error": str(e)})
                self._warn_dcn_fallback(
                    prefill_url, f"device-buffer pull failed ({e})")
            except Exception as e:
                pull_span.add_event("device_pull_failed", {"error": str(e)})
                self._warn_dcn_fallback(
                    prefill_url, f"device-buffer pull failed ({e})")
        elif want_ici:
            self._warn_dcn_fallback(
                prefill_url,
                "is neither in-process nor advertising device-buffer "
                "transfer")
        if k is None:
            try:
                k, v, n_tokens = fetch_kv(host, out["bootstrap_port"],
                                          req.request_id)
            except (ConnectionError, OSError) as e:
                pull_span.set_status("ERROR", str(e))
                pull_span.end()
                # the pull died with the prefill KV still parked: release
                # it NOW (best-effort; the TTL sweep remains the backstop)
                # so a frontend-recovered continuation re-prefilling under
                # the same request id never races a stale park — a
                # decode-side failure must leave the ledger balanced
                self._release_remote(prefill_url, req.request_id,
                                     parent_span)
                raise RuntimeError(
                    f"KV transfer from {prefill_url} failed: {e}") from e
            released = True  # the TCP plane acks (and releases) in-stream
            self._plane_counter.inc(plane="dcn")
        pull_span.set_attributes({
            "plane": "dcn" if released else "ici_device",
            "bytes": int(k.nbytes + v.nbytes),
            "n_tokens": int(n_tokens),
        })
        pull_span.end()
        log.info(
            "disagg%s: prefill(%d tok)+transfer(%.1f MB) in %.3fs via %s",
            "" if released else "[ici-device]", n_tokens,
            (k.nbytes + v.nbytes) / 1e6, time.monotonic() - t0,
            prefill_url,
        )

        q = ctx.service.attach(req.request_id)
        try:
            finished, reason = ctx.engine.import_kv(req, first_token, k, v)
            if not released and k.device.type == "cuda":
                # the scatter reads the peer's memory: it must be done
                # before the release lets the peer free it
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(k.device))
                done.synchronize()
            del k, v
        except Exception:
            ctx.service.detach(req.request_id)
            raise
        finally:
            # staged_ok + released: the TCP in-stream ack freed the parked
            # POOL pages but not the prefill side's stage-ledger slot (and
            # its pinned gather) — /disagg/release clears both and
            # engine.release_parked is idempotent for the already-freed
            # pages
            if not released or staged_ok:
                self._release_remote(prefill_url, req.request_id,
                                     parent_span)
        ev = TokenEvent(req.request_id, first_token, 0, finished, reason)
        if req.logprobs is not None and "logprob" in out:
            ev.logprob = out["logprob"]
            ev.top_logprobs = [tuple(t) for t in out.get("top_logprobs", [])]
        q.put(ev)
        ctx.service.wake()
        return q

    def _prefill_rpc(self, prefill_url: str, body: bytes, span,
                     deadline: Optional[ddl.Deadline] = None) -> dict:
        """Phase-1 prefill RPC. ONLY connection-phase failures here are
        retry-safe (no prefill ran, no KV parked anywhere); a read TIMEOUT
        means the worker accepted and may be computing, so a retry would
        duplicate the prefill — terminal instead. `span`'s trace context
        rides the request headers so the prefill worker's spans join this
        trace; the remaining deadline budget bounds the RPC (env-default
        budget when no deadline propagated — the former hard-coded 300 s)."""
        headers = {"Content-Type": "application/json",
                   **_trace_headers(span)}
        if deadline is not None:
            deadline.propagate(headers)
            timeout = deadline.timeout()
        else:
            timeout = ddl.default_budget_s()
        try:
            faults.raise_point(
                "disagg.prefill_connect_refused",
                lambda m: urllib.error.URLError(ConnectionRefusedError(m)))
            with urllib.request.urlopen(
                urllib.request.Request(
                    prefill_url.rstrip("/") + "/disagg/prefill", data=body,
                    headers=headers,
                    method="POST",
                ),
                timeout=timeout,
            ) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as e:
            # a definitive client error from the prefill side stays definitive
            # (400), so callers don't retry a request that can never succeed
            try:
                msg = json.loads(e.read())["error"]["message"]
            except Exception:
                msg = str(e)
            if e.code == 400:
                raise ValueError(f"prefill rejected request: {msg}") from e
            raise RuntimeError(
                f"prefill worker {prefill_url} failed ({e.code}): {msg}"
            ) from e
        except (urllib.error.URLError, ConnectionError, OSError) as e:
            # only pre-send failures (refused / no route / DNS) are
            # retry-safe; a reset AFTER the request was written means the
            # worker may be mid-prefill and a retry would duplicate it and
            # park orphan KV — terminal, like timeouts
            if net.pre_send_failure(e):
                raise _PrefillUnreachable(str(e)) from e
            reason = getattr(e, "reason", e)
            if isinstance(reason, (TimeoutError, socket.timeout)):
                raise RuntimeError(
                    f"prefill worker {prefill_url} timed out mid-prefill"
                ) from e
            raise RuntimeError(
                f"prefill worker {prefill_url} connection lost after the "
                f"request was sent ({e}); not retried"
            ) from e

    def _pull_device(self, prefill_url: str, request_id: str,
                     span=obs_tracing.NOOP_SPAN):
        """Stage (RPC) then open a parked sequence's KV over CUDA IPC (the
        cross-process ici leg)."""
        if self._device_client is None:
            self._device_client = DeviceKVClient(self.ctx.engine.device)
        with urllib.request.urlopen(
            urllib.request.Request(
                prefill_url.rstrip("/") + "/disagg/stage",
                data=json.dumps({"request_id": request_id}).encode(),
                headers={"Content-Type": "application/json",
                         **_trace_headers(span)},
                method="POST",
            ),
            timeout=30,
        ) as resp:
            staged = json.loads(resp.read())
        span.add_event("staged", {"transfer_uuid":
                                  staged.get("transfer_uuid", "?")})
        try:
            return self._device_client.pull(staged)
        except Exception as e:
            # the stage RPC already pinned a gather remotely: the caller
            # must release it even though it falls back to the TCP plane
            raise _StagedPullError(str(e)) from e

    def _release_remote(self, prefill_url: str, request_id: str,
                        parent_span=obs_tracing.NOOP_SPAN) -> None:
        """Best-effort parked-page release after a device-buffer pull, on a
        background thread — the first token is already in hand and must not
        wait on cleanup (the prefill side's TTL sweep covers lost acks)."""
        def _post():
            span = self.ctx.tracer.start_span(
                "disagg.kv_release", parent=parent_span, kind="client",
                attributes={"prefill.url": prefill_url,
                            "request.id": request_id})
            try:
                urllib.request.urlopen(
                    urllib.request.Request(
                        prefill_url.rstrip("/") + "/disagg/release",
                        data=json.dumps({"request_id": request_id}).encode(),
                        headers={"Content-Type": "application/json",
                                 **_trace_headers(span)},
                        method="POST",
                    ),
                    timeout=10,
                ).close()
                span.set_status("OK")
            except Exception as e:
                span.set_status("ERROR", str(e))
                log.warning("parked-KV release on %s failed (%s); TTL sweep "
                            "will reclaim", prefill_url, e)
            span.end()

        threading.Thread(target=_post, daemon=True,
                         name="disagg-release").start()

    def _start_ici(self, req: GenRequest, prefill_engine, prefill_url: str,
                   parent_span=obs_tracing.NOOP_SPAN):
        """In-process (colocated) prefill: direct engine calls + the
        device-to-device KV handoff — no HTTP RPC, no TCP byte pump, no host
        copy of the pages (the NIXL->ICI reroute made real)."""
        ctx = self.ctx
        t0 = time.monotonic()
        with ctx.tracer.start_span(
                "disagg.prefill_rpc", parent=parent_span,
                attributes={"prefill.url": prefill_url,
                            "request.id": req.request_id,
                            "prompt_tokens": len(req.prompt_token_ids),
                            "plane": "ici_inproc"}) as rpc_span:
            first_token, n_tokens, extras = prefill_engine.prefill_only(req)
            rpc_span.set_attribute("n_tokens", int(n_tokens))
        with ctx.tracer.start_span(
                "disagg.kv_pull", parent=parent_span,
                attributes={"prefill.url": prefill_url,
                            "request.id": req.request_id,
                            "plane": "ici_inproc"}) as pull_span:
            k, v, _ = prefill_engine.export_kv_device(req.request_id)
            pull_span.set_attribute("n_tokens", int(n_tokens))
        self._plane_counter.inc(plane="ici_inproc")  # handoff data in hand
        q = ctx.service.attach(req.request_id)
        try:
            finished, reason = ctx.engine.import_kv(req, first_token, k, v)
        except Exception:
            ctx.service.detach(req.request_id)
            raise
        finally:
            prefill_engine.release_parked(req.request_id)
        log.info(
            "disagg[ici]: prefill(%d tok)+device handoff in %.3fs via %s",
            n_tokens, time.monotonic() - t0, prefill_url,
        )
        ev = TokenEvent(req.request_id, first_token, 0, finished, reason)
        if req.logprobs is not None and "logprob" in extras:
            ev.logprob = extras["logprob"]
            ev.top_logprobs = [tuple(t) for t in extras.get("top_logprobs", [])]
        q.put(ev)
        ctx.service.wake()
        return q
