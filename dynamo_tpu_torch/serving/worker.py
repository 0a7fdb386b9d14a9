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
checkpoint) and `--quantization int8|w8a8` (int8 weights). `--warmup` (on
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
    "trtllm_tpu": dict(
        num_scheduler_steps=4,
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
    p = build_parser(backend_name)
    args = p.parse_args(argv)
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
