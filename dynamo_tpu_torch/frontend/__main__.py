"""Frontend entrypoint: OpenAI-compatible router over registered workers.

The port's own copy of `dynamo_tpu/frontend/__main__.py` (it imports
nothing of the JAX package); keep the two in step. Same flags:

    python -m dynamo_tpu_torch.frontend --port 8000 \
        [--nats-url nats://host:4222] [--etcd-endpoint http://host:2379] \
        [--heartbeat-ttl 15] [--static-workers URL,... --static-model M]

Stand-in for the Dynamo frontend pod every reference manifest
declares (reference examples/deploy/vllm/agg.yaml:12-17).
"""

import argparse
import logging
import os
import signal
import threading
import time

from dynamo_tpu_torch.serving.frontend import FrontendContext, make_frontend_server


def main(argv=None):
    logging.basicConfig(level=os.environ.get("LOG_LEVEL", "INFO"))
    p = argparse.ArgumentParser(prog="dynamo_tpu_torch.frontend")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int,
                   default=int(os.environ.get("DYNAMO_PORT", 8000)))
    p.add_argument("--heartbeat-ttl", type=float, default=15.0)
    p.add_argument("--static-workers", default=os.environ.get("STATIC_WORKERS"),
                   help="comma-separated worker URLs (skip heartbeat discovery)")
    p.add_argument("--static-model", default=os.environ.get("STATIC_MODEL"))
    p.add_argument("--etcd-endpoint", default=os.environ.get("ETCD_ENDPOINT"),
                   help="etcd v3 gateway URL; enables cross-replica worker "
                        "registry sync (e.g. http://dynamo-platform-etcd:2379)")
    p.add_argument("--nats-url", default=os.environ.get("NATS_URL"),
                   help="NATS server URL; routes requests to workers over "
                        "the NATS plane (e.g. nats://dynamo-platform-nats:"
                        "4222), with HTTP fallback")
    args = p.parse_args(argv)

    from dynamo_tpu_torch.serving.router import Router

    router = Router(heartbeat_ttl=args.heartbeat_ttl)
    if args.static_workers:
        # static registration never expires
        router.ttl = float("inf")
        for url in args.static_workers.split(","):
            router.register(url.strip(), args.static_model or "?", "agg")
    if args.etcd_endpoint and args.static_workers:
        logging.getLogger("dynamo_tpu_torch.frontend").warning(
            "--static-workers skips discovery entirely; ignoring "
            "--etcd-endpoint (the two modes are mutually exclusive)"
        )
    elif args.etcd_endpoint:
        from dynamo_tpu_torch.serving.registry import EtcdRegistry

        EtcdRegistry(router, args.etcd_endpoint,
                     ttl_s=int(args.heartbeat_ttl)).start()
    ctx = FrontendContext(router, nats_url=args.nats_url)
    srv = make_frontend_server(ctx, args.host, args.port)
    log = logging.getLogger("dynamo_tpu_torch.frontend")

    def drain_then_stop():
        # SIGTERM (rolling restart / scale-down): flip /healthz to 503 so
        # the Service stops sending new streams here, then wait for
        # in-flight requests to finish before stopping the server. Streams
        # cut off by the hard stop are client-resumable through any peer
        # replica (serving/ha.py).
        ctx.draining = True
        budget = float(os.environ.get("FRONTEND_DRAIN_S", "5"))
        deadline = time.monotonic() + budget
        while time.monotonic() < deadline:
            with ctx._inflight_lock:
                n = ctx._inflight
            if n == 0:
                break
            time.sleep(0.2)
        else:
            with ctx._inflight_lock:
                n = ctx._inflight
            if n:
                log.warning("drain budget %.1fs exhausted with %d request(s)"
                            " in flight; stopping anyway", budget, n)
        srv.shutdown()

    def shutdown(*_):
        if ctx.draining:
            # second signal: operator means it — stop immediately
            threading.Thread(target=srv.shutdown, daemon=True).start()
            return
        threading.Thread(target=drain_then_stop, daemon=True).start()

    signal.signal(signal.SIGTERM, shutdown)
    signal.signal(signal.SIGINT, shutdown)
    logging.getLogger("dynamo_tpu_torch.frontend").info(
        "frontend listening on %s:%d", args.host, args.port
    )
    srv.serve_forever()


if __name__ == "__main__":
    main()
