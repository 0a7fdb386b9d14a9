"""Engine-worker process entrypoint: one aggregated OpenAI worker on one GPU.

Port of `dynamo_tpu/serving/worker.py` for the aggregated role. The CLI is
the JAX worker's (`EngineConfig.add_cli_args`) plus `--host`, `--port` and
`--device`; flags this slice does not serve are refused by the engine with
NotImplementedError naming them. The `jetstream` profile's defaults are the
slice's main path: one decode step per dispatch, chunked prefill at 256
tokens, no prefix caching, synchronous scheduling. (The JAX jetstream
profile fuses 8-step windows without chunking; multi-step windows are not
ported yet.) The profile leaves `--mixed-batch-tokens` (the mixed ragged
step: decode rows and a prefill chunk in one forward) and
`--kv-cache-dtype` (`int8`: packed-scale KV pools) at their defaults, off,
as the JAX profile does; both are served when set.

    python -m dynamo_tpu_torch.jetstream --model llama-3.1-8b-instruct \
        --no-enable-prefix-caching --port 8000 \
        [--mixed-batch-tokens 256] [--kv-cache-dtype int8]
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import threading

from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import Engine
from dynamo_tpu_torch.serving.api import ServingContext, make_server

log = logging.getLogger("dynamo_tpu_torch.worker")

BACKEND_PROFILES = {
    "jetstream": dict(
        num_scheduler_steps=1,
        async_scheduling=False,
        prefill_chunk_tokens=256,
        enable_prefix_caching=False,
    ),
}


def build_parser(backend_name: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=f"dynamo_tpu_torch.{backend_name}")
    EngineConfig.add_cli_args(p)
    p.set_defaults(**BACKEND_PROFILES.get(backend_name, {}))
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int,
                   default=int(os.environ.get("PORT", 8000)))
    p.add_argument("--device", default="cuda",
                   help="torch device the engine runs on (cpu for debugging)")
    return p


def main(argv=None, backend_name: str = "jetstream") -> None:
    logging.basicConfig(level=os.environ.get("LOG_LEVEL", "INFO"))
    args = build_parser(backend_name).parse_args(argv)
    cfg = EngineConfig.from_cli_args(args)
    engine = Engine(cfg, device=args.device)
    if cfg.warmup:
        log.info("building the attention kernels before serving")
        engine.warmup()
    ctx = ServingContext(engine, cfg.served_name)
    srv = make_server(ctx, args.host, args.port)

    def shutdown(*_):
        threading.Thread(target=srv.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, shutdown)
    signal.signal(signal.SIGINT, shutdown)
    log.info("worker serving %s on %s:%d (device %s)", cfg.served_name,
             args.host, srv.server_address[1], engine.device)
    try:
        srv.serve_forever()
    finally:
        ctx.close()


if __name__ == "__main__":
    main()
