"""Engine-worker process entrypoint: one aggregated OpenAI worker on one GPU,
specialised per backend profile.

Port of `dynamo_tpu/serving/worker.py` for the aggregated role. The CLI is
the JAX worker's (`EngineConfig.add_cli_args`) plus `--host`, `--port` and
`--device` (the card unless `--device cpu`); flags the port does not serve
are refused by the engine with NotImplementedError naming them. Each
entrypoint selects the JAX package's scheduling defaults for its profile
(explicit flags win), kept here as the port's own copy:

- ``jetstream`` — fixed 8-step decode windows (CUDA graphs on the card)
  driven synchronously; no chunked prefill, so no prefix caching:
  admission happens between windows.
- ``vllm_tpu`` — continuous batching: chunked prefill at 256 tokens
  interleaved with decode, automatic prefix caching, async (overlapped)
  scheduling.

Both leave `--mixed-batch-tokens` (the mixed ragged step: decode rows and a
prefill chunk in one forward) and `--kv-cache-dtype` (`int8`: packed-scale
KV pools) at their defaults, off, as the JAX profiles do; both are served
when set. `--warmup` (on by default) builds the kernels and captures the
greedy decode graphs before the server starts.

    python -m dynamo_tpu_torch.jetstream --model llama-3.1-8b-instruct \
        --port 8000 [--mixed-batch-tokens 256] [--kv-cache-dtype int8]
    python -m dynamo_tpu_torch.vllm_tpu --model llama-3.1-8b-instruct \
        --port 8000
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
        log.info("building the kernels and capturing the decode graphs "
                 "before serving")
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
