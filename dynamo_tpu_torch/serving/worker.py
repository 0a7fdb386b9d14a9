"""Engine-worker process entrypoint: one OpenAI worker on one GPU, in the
aggregated, prefill or decode role, specialised per backend profile.

Port of `dynamo_tpu/serving/worker.py`. The CLI is the JAX worker's
(`EngineConfig.add_cli_args`, `--host`, `--port`, `--frontend-url`,
`--heartbeat-interval`, `--prefill-url`, `--kvbm-peers`) plus `--device`
(the card unless `--device cpu`). Engine fields the port does not serve
are refused by the engine with NotImplementedError naming them, and so
are the worker flags it does not serve (the multi-host gang's
`--coordinator`, `--num-processes`, `--process-id`: `unported_flags`).

Disaggregated serving (`--disaggregation-mode prefill|decode`,
`--disaggregation-transfer-backend ici|dcn`,
`--disaggregation-bootstrap-port`): a prefill worker serves
`/disagg/prefill`, `/disagg/stage` and `/disagg/release`, registers its
engine in `transfer.ici_registry` under its URLs (a decode role in the
same process then hands KV over on the card), and registers with the
frontend under its mode, which the frontend never routes user traffic
to; a decode worker finds prefill workers by `--prefill-url` (comma
separated) or from the frontend's `/internal/workers`:

    python -m dynamo_tpu_torch.jetstream --model llama-3.1-8b-instruct \
        --disaggregation-mode prefill --port 8001 \
        --frontend-url http://127.0.0.1:8080
    python -m dynamo_tpu_torch.jetstream --model llama-3.1-8b-instruct \
        --disaggregation-mode decode --port 8002 \
        --frontend-url http://127.0.0.1:8080 \
        [--prefill-url http://127.0.0.1:8001]

`--kvbm-peers host:port,...` lets a worker with a KVBM host tier onboard
prefix blocks from its peers' host tiers (each peer's port is its
`/worker/stats` `kvbm.peer_port`, also in its heartbeat).

With `--nats-url` the worker also serves the NATS request plane
(`serving/nats_plane.WorkerNatsPlane`: its own subject and its model's
queue group, bridged into its HTTP server) and, when the engine has a
prefix cache, publishes its KV events on that connection
(`kvbm/events.KVEventPublisher`), which the frontend's router indexes:
`attach_nats_plane`, the wiring `chip_smoke.py` runs too. The plane
closes when the drain begins and when the worker exits.

With `--frontend-url` (comma-separated replicas) the worker heartbeats its
stats to every replica's `/internal/register` each
`--heartbeat-interval` seconds, with the JAX worker's payload (load,
adapters, weight version, costs, timeline, watchdog health). SIGTERM (or
SIGINT) runs the JAX worker's shutdown: admission off, a deregister from
every replica, then the drain state machine (`ServingContext.drain`:
finish within DRAIN_HANDOFF_GRACE_S, hand journaled streams off, wait up
to DRAIN_TIMEOUT_S), then the server stops; a second signal skips the
drain. A `/internal/reclaim` notice runs the same path under its
deadline. Each
entrypoint selects the JAX package's scheduling defaults for its profile
(explicit flags win), kept here as the port's own copy:

- ``jetstream`` — fixed 8-step decode windows (CUDA graphs on the card)
  driven synchronously; no chunked prefill, so no prefix caching:
  admission happens between windows.
- ``vllm_tpu`` — continuous batching: chunked prefill at 256 tokens
  interleaved with decode, automatic prefix caching, async (overlapped)
  scheduling.
- ``trtllm_tpu`` — the compiled-engine profile: 4-step async windows,
  chunks of 256, prefix caching; an `--engine-config FILE` (YAML or JSON
  EngineConfig overrides) is required, and warmup always runs before the
  server starts, even with `--no-warmup` or `warmup: false` in the file.
  On the TPU its compiled programs persist in an engine cache; here what
  persists is the kernel library, built once per source content into
  `build/dynamo_tpu_torch` and loaded from there by later processes
  (`ops/cuda_attention.py`). CUDA graphs cannot outlive their process, so
  the forced warmup captures the decode graphs again at every start.

All three leave `--mixed-batch-tokens` (the mixed ragged step: decode rows
and a prefill chunk in one forward) and `--kv-cache-dtype` (`int8`:
packed-scale KV pools) at their defaults, off, as the JAX profiles do; all
serve them when set, and `--model-path DIR` (a local safetensors
checkpoint) and `--quantization int8|w8a8` (int8 weights). The KVBM host
tier behind the prefix cache (`--kvbm-host-blocks N`, `--kvbm-gate
auto|always|never`, `--kvbm-disk-dir DIR`, `--kvbm-disk-blocks N`: pinned
host arenas on the card) and per-tenant QoS (`--tenants JSON` or
`DYNAMO_TPU_TENANTS`, `--qos-burst-tokens`) reach the engine as in the
JAX worker, the KVBM's cross-worker pull (`--kvbm-peers`) too.
`--warmup` (on
by default) builds the kernels and captures the greedy decode graphs
before the server starts. Every worker serves the JAX worker's
observability plane (`serving/api.py`): `/metrics`, `/debug` and its
routes, request spans; the JAX package's `DYNAMO_TPU_TRACE`,
`DYNAMO_TPU_TIMELINE`, `DYNAMO_TPU_FLIGHT_RECORDS`,
`DYNAMO_TPU_SLO_TARGETS` and `DYNAMO_TPU_CHIP` configure it.

    python -m dynamo_tpu_torch.jetstream --model llama-3.1-8b-instruct \
        --port 8000 [--mixed-batch-tokens 256] [--kv-cache-dtype int8]
    python -m dynamo_tpu_torch.vllm_tpu --model llama-3.1-8b-instruct \
        --port 8000 [--model-path DIR] [--quantization w8a8]
    python -m dynamo_tpu_torch.trtllm_tpu --engine-config engine.yaml \
        --model llama-3.1-8b-instruct --port 8000
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import signal
import socket
import threading
import time
import urllib.request
from typing import List, Optional

from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import Engine
from dynamo_tpu_torch.kvbm.events import KVEventPublisher
from dynamo_tpu_torch.serving.api import ServingContext, make_server
from dynamo_tpu_torch.serving.nats_plane import WorkerNatsPlane
from dynamo_tpu_torch.transfer import ici_registry

log = logging.getLogger("dynamo_tpu_torch.worker")

# the JAX package's profiles (dynamo_tpu/serving/worker.py), as argparse
# defaults: an explicit flag overrides its profile's value
BACKEND_PROFILES = {
    "jetstream": dict(
        num_scheduler_steps=8,
        async_scheduling=False,
        prefill_chunk_tokens=0,
        enable_prefix_caching=False,
    ),
    "vllm_tpu": dict(
        num_scheduler_steps=1,
        async_scheduling=True,
        prefill_chunk_tokens=256,
        enable_prefix_caching=True,
    ),
    "trtllm_tpu": dict(
        num_scheduler_steps=4,
        async_scheduling=True,
        prefill_chunk_tokens=256,
        enable_prefix_caching=True,
    ),
}


# the JAX worker's flags the port does not serve yet (the multi-host gang)
UNPORTED_FLAGS = ("coordinator", "num_processes", "process_id")


def unported_flags(args) -> List[str]:
    """The flags of `args` set to something the port does not serve."""
    return [f"--{n.replace('_', '-')}" for n in UNPORTED_FLAGS
            if getattr(args, n, None) not in (None, "")]


def _self_url(host: str, port: int) -> str:
    if host not in ("0.0.0.0", "::"):
        return f"http://{host}:{port}"
    # advertise the pod/host IP (downward-API env in K8s, hostname locally)
    adv = os.environ.get("POD_IP") or socket.gethostbyname(
        socket.gethostname())
    return f"http://{adv}:{port}"


def heartbeat_payload(ctx: ServingContext, self_url: str) -> dict:
    """One heartbeat's body: the JAX worker's keys."""
    eng = ctx.engine
    stats = {
        "active_seqs": eng.num_active,
        "pending": len(eng.pending),
        "free_pages": eng.allocator.free_pages,
        "total_pages": eng.cfg.num_pages,
        "max_num_seqs": eng.cfg.max_num_seqs,
        # the weight version, so the rollout controller sees each pod
        "weight_version": eng.weights.version,
        "costs": eng.cost.rollup(),
        "timeline": eng.timeline.summary(),
        # the router skips suspect/resurrecting/quarantined workers
        "health": eng.watchdog.summary(),
    }
    if ctx.kvbm_source is not None:
        stats["kvbm_host_blocks"] = eng.cfg.kvbm_host_blocks
        stats["kvbm_peer_port"] = ctx.kvbm_source.port
    if eng.lora is not None:
        # resident adapters drive the router's affinity pass
        stats["adapters"] = sorted(eng.lora.resident())
        stats["adapters_available"] = eng.lora.names()
    if ctx.preemptible:
        stats["preemptible"] = True
    return {"url": self_url, "model": ctx.served_model,
            "mode": eng.cfg.disaggregation_mode, "stats": stats}


def attach_nats_plane(ctx: ServingContext, nats_url: str, http_url: str,
                      advertised_url: str) -> Optional[WorkerNatsPlane]:
    """The JAX worker's `--nats-url` wiring: serve the NATS request plane
    (this worker's subject, named by `advertised_url`, and its model's
    queue group, bridged into its HTTP server at `http_url`) and, when the
    engine has a prefix cache, publish its KV events on the plane's
    connection so the frontend's router can index this worker's real
    cache contents. None when the broker is unreachable (HTTP only)."""
    try:
        plane = WorkerNatsPlane(nats_url, http_url, ctx.served_model,
                                advertised_url=advertised_url)
    except OSError as e:
        log.warning("NATS plane unavailable (%s); HTTP only", e)
        return None
    if ctx.engine.prefix_cache is not None:
        ctx.attach_kv_event_publisher(KVEventPublisher(
            plane.nc, advertised_url, ctx.served_model))
        log.info("kv event plane publishing on %s",
                 ctx.kv_event_publisher.subject)
    return plane


def _close_plane(plane: Optional[WorkerNatsPlane]) -> None:
    if plane is not None:
        try:
            plane.close()
        except Exception:
            pass


def _post_json(url: str, body: dict, timeout: float) -> None:
    urllib.request.urlopen(urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST"),
        timeout=timeout).close()


def heartbeat_loop(ctx: ServingContext, frontend_url: str, self_url: str,
                   interval: float, stop: threading.Event) -> None:
    """Register with EVERY frontend replica now and every `interval`
    seconds until `stop`: each replica's registry is complete on its own.
    One dead replica never starves the others of beats."""
    urls = [u.strip().rstrip("/") + "/internal/register"
            for u in frontend_url.split(",") if u.strip()]
    first = True
    while True:
        if not first and stop.wait(interval):
            return
        first = False
        body = heartbeat_payload(ctx, self_url)
        for url in urls:
            try:
                _post_json(url, body, timeout=5)
            except Exception as e:
                log.warning("heartbeat to %s failed: %s", url, e)


def deregister(frontend_url: str, self_url: str) -> None:
    """Deregister from every replica (one that misses it keeps routing
    here until the heartbeat's TTL expires)."""
    for fe in frontend_url.split(","):
        fe = fe.strip()
        if not fe:
            continue
        try:
            _post_json(fe.rstrip("/") + "/internal/deregister",
                       {"url": self_url}, timeout=3)
        except Exception as e:
            log.warning("deregister from %s failed (%s); that frontend "
                        "will expire the heartbeat", fe, e)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        log.warning("invalid %s %r; using %s", name, os.environ.get(name),
                    default)
        return default


def build_parser(backend_name: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=f"dynamo_tpu_torch.{backend_name}")
    EngineConfig.add_cli_args(p)
    p.set_defaults(**BACKEND_PROFILES.get(backend_name, {}))
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int,
                   default=int(os.environ.get("PORT", 8000)))
    p.add_argument("--device", default="cuda",
                   help="torch device the engine runs on (cpu for debugging)")
    p.add_argument("--frontend-url", default=os.environ.get("FRONTEND_URL"),
                   help="comma-separated frontend replicas to heartbeat to")
    p.add_argument("--heartbeat-interval", type=float, default=3.0)
    p.add_argument("--nats-url", default=os.environ.get("NATS_URL"),
                   help="NATS server URL: serve requests over the NATS "
                        "request plane in addition to HTTP, and publish "
                        "KV events there")
    p.add_argument("--prefill-url", default=os.environ.get("PREFILL_URL"),
                   help="comma-separated prefill worker URLs (decode role)")
    p.add_argument("--kvbm-peers", default=os.environ.get("KVBM_PEERS"),
                   help="comma-separated host:port peers whose KVBM host "
                        "tiers this worker may onboard prefix blocks from "
                        "(ports from the peers' /worker/stats "
                        "kvbm.peer_port)")
    # the JAX worker's multi-host flags, which the port refuses
    # (unported_flags)
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p


def main(argv=None, backend_name: str = "jetstream") -> None:
    logging.basicConfig(level=os.environ.get("LOG_LEVEL", "INFO"))
    p = build_parser(backend_name)
    args = p.parse_args(argv)
    bad = unported_flags(args)
    if bad:
        raise NotImplementedError(
            f"worker flag(s) {bad} are not ported to dynamo_tpu_torch yet "
            f"(see ROADMAP.md)")
    if backend_name == "trtllm_tpu" and not args.engine_config:
        p.error("--engine-config FILE is required for the trtllm_tpu "
                "backend (the TRT engine-build config analogue)")
    cfg = EngineConfig.from_cli_args(args)
    if backend_name == "trtllm_tpu" and not cfg.warmup:
        log.warning("trtllm_tpu ignores warmup=false: the compiled-engine "
                    "profile always builds before serving")
        cfg = dataclasses.replace(cfg, warmup=True)
    engine = Engine(cfg, device=args.device)
    if cfg.warmup:
        log.info("building the kernels and capturing the decode graphs "
                 "before serving")
        engine.warmup()
    ctx = ServingContext(
        engine, cfg.served_name,
        prefill_urls=(args.prefill_url.split(",") if args.prefill_url
                      else None),
        frontend_url=args.frontend_url,
        kvbm_peers=(args.kvbm_peers.split(",") if args.kvbm_peers
                    else None))
    srv = make_server(ctx, args.host, args.port)
    port = srv.server_address[1]
    self_url = _self_url(args.host, port)
    if cfg.disaggregation_mode == "prefill":
        # a decode role in this process resolves this engine under either
        # URL for the on-card handoff (transfer.ici_registry); harmless
        # otherwise
        for url in (self_url, f"http://127.0.0.1:{port}"):
            ici_registry.register(url, engine)
    nats_plane = None
    if args.nats_url:
        nats_plane = attach_nats_plane(ctx, args.nats_url,
                                       f"http://127.0.0.1:{port}", self_url)
    stop = threading.Event()
    hb_thread = None
    if args.frontend_url:
        hb_thread = threading.Thread(
            target=heartbeat_loop,
            args=(ctx, args.frontend_url, self_url,
                  args.heartbeat_interval, stop),
            daemon=True, name="heartbeat")
        hb_thread.start()

    def shutdown(*_, deadline_s=None, wait=False):
        """Graceful drain (pod termination): admission off (new requests
        shed 503 and the frontend fails them over), deregister from every
        frontend, then the drain state machine, then stop the server.
        Bounded by DRAIN_TIMEOUT_S (align terminationGracePeriod with it);
        a reclamation notice passes its `deadline_s` as the hard bound and
        `wait` so its thread sees the end. A second signal skips the
        drain."""
        if stop.is_set():  # an impatient second SIGTERM/SIGINT
            threading.Thread(target=srv.shutdown, daemon=True).start()
            return
        stop.set()

        def _drain():
            try:
                if deadline_s is not None:
                    # leave margin inside the notice for the deregister
                    drain_s = max(1.0, deadline_s - 3.0)
                    grace_s = min(5.0, drain_s / 4.0)
                else:
                    drain_s = _env_float("DRAIN_TIMEOUT_S", 30.0)
                    grace_s = _env_float("DRAIN_HANDOFF_GRACE_S", 5.0)
                ctx.begin_drain()
                # stop consuming the NATS request plane now: new subjects
                # must not refill the queue mid-drain
                _close_plane(nats_plane)
                if args.frontend_url:
                    if hb_thread is not None:
                        # a heartbeat in flight must land before the
                        # deregister, or it re-adds this worker
                        hb_thread.join(timeout=6.0)
                    deregister(args.frontend_url, self_url)
                # a request routed a moment before the deregister may be
                # accepted but not yet submitted
                time.sleep(1.0)
                if not ctx.drain(drain_s=drain_s,
                                 handoff_grace_s=min(grace_s, drain_s)):
                    log.warning("drain timeout with %d active / %d "
                                "pending; stopping anyway",
                                engine.num_active, len(engine.pending))
            finally:
                srv.shutdown()

        t = threading.Thread(target=_drain, daemon=True, name="drain")
        t.start()
        if wait:
            t.join()

    signal.signal(signal.SIGTERM, shutdown)
    signal.signal(signal.SIGINT, shutdown)
    # a /internal/reclaim notice drives the same drain under its deadline
    ctx.reclaim_cb = lambda d: shutdown(deadline_s=d, wait=True)
    log.info("worker serving %s on %s:%d (device %s)", cfg.served_name,
             args.host, srv.server_address[1], engine.device)
    try:
        srv.serve_forever()
    finally:
        _close_plane(nats_plane)
        ctx.close()


if __name__ == "__main__":
    main()
