"""Roofline sizes of a model: parameters, active parameters, KV bytes per
token and weight bytes per parameter, and the two sides of the KVBM's
onboard gate.

The part of `dynamo_tpu/profiler/roofline.py` the live utilization gauges
(observability/engine_metrics.py) and the KVBM's gate (kvbm/cost_model.py)
read, copied: the port's own copy (it imports nothing of the JAX package);
keep the two in step. The gate's rates are the caller's: the JAX module's
defaults are a TPU's planning numbers, the port's come from the card
(kvbm/cost_model.py). The JAX module's analytic `estimate` of TTFT / ITL
for the SLA sweep waits for the planner. Counts assume bfloat16 (2 bytes)
parameters and KV unless a quantization says otherwise.
"""

from __future__ import annotations

from dynamo_tpu_torch.models.config import ModelConfig

BYTES = 2  # bfloat16


def param_count(cfg: ModelConfig) -> float:
    """Total parameter count (all experts for MoE)."""
    h, hd = cfg.hidden_size, cfg.head_dim
    if cfg.is_mla:
        nh, nope, rope = (cfg.num_heads, cfg.qk_nope_head_dim,
                          cfg.qk_rope_head_dim)
        lora, vd = cfg.kv_lora_rank, cfg.v_head_dim
        attn = (h * nh * (nope + rope)      # q projection
                + h * (lora + rope)         # latent down-projection
                + nh * nope * lora          # W_UK
                + nh * lora * vd            # W_UV
                + nh * vd * h)              # output projection
    else:
        attn = (h * cfg.num_heads * hd + 2 * h * cfg.num_kv_heads * hd
                + cfg.num_heads * hd * h)
    mlp_one = 3 * h * cfg.intermediate_size
    mlp = mlp_one * max(cfg.num_experts, 1)
    if cfg.is_moe and cfg.num_shared_experts:
        mlp += mlp_one * cfg.num_shared_experts
    router = h * cfg.num_experts if cfg.is_moe else 0
    per_layer = attn + mlp + router + 2 * h  # + rmsnorm scales
    embed = cfg.vocab_size * h * (1 if cfg.tie_word_embeddings else 2)
    return cfg.num_layers * per_layer + embed + h


def active_param_count(cfg: ModelConfig) -> float:
    """Params touched per token (MoE: routed top-k + shared experts)."""
    if not cfg.is_moe:
        return param_count(cfg)
    h = cfg.hidden_size
    mlp_one = 3 * h * cfg.intermediate_size
    inactive = (cfg.num_experts - cfg.num_experts_per_tok) * mlp_one
    return param_count(cfg) - cfg.num_layers * inactive


def kv_bytes_per_token(cfg: ModelConfig, kv_dtype: str = "auto",
                       tp: int = 1) -> float:
    # cache geometry, not attention geometry: MLA stores one shared latent
    # row per token (cache_kv_heads == 1) in REPLICATED pools — no TP lane
    # blocking applies
    kv_heads, head_dim = cfg.cache_kv_heads, cfg.cache_head_dim
    if cfg.is_mla:
        tp = 1
    lanes = kv_heads * head_dim
    if kv_dtype == "int8":
        # packed-scale int8 rows, lane-BLOCKED per TP shard and padded to a
        # 128 multiple PER BLOCK (ops/attention.kv_lane_width) —
        # at high tp the padding can eat the entire saving (e.g. 8 KV heads
        # of dim 128 at tp=8: 8 x 256-lane blocks = bf16-sized rows), so
        # the roofline must model the real layout, not lanes/2
        kv_l = max(kv_heads // max(tp, 1), 1)
        block = -(-(kv_l * head_dim + 2 * kv_l) // 128) * 128
        return 2.0 * cfg.num_layers * max(tp, 1) * block
    return 2.0 * cfg.num_layers * lanes * BYTES


def weight_bytes(quant: str) -> float:
    return 1.0 if quant in ("int8", "w8a8") else float(BYTES)


def kvbm_restore_seconds(n_bytes: float, bytes_per_s: float,
                         overhead_s: float) -> float:
    """Time to restore demoted KV blocks onto the device: bytes over the
    host<->device link plus one onboard's fixed overhead. One side of the
    KVBM onboard gate (kvbm/cost_model.py)."""
    return overhead_s + n_bytes / max(bytes_per_s, 1.0)


def kvbm_recompute_seconds(cfg: ModelConfig, n_tokens: int,
                           chip_flops: float, n_dispatches: int,
                           mfu: float, dispatch_s: float) -> float:
    """Time to RECOMPUTE a cached prefix instead of restoring it: the
    compute-bound prefill roofline for `n_tokens` at `mfu` of the card's
    peak (linear term only: the quadratic attention term would only widen
    restore's win) plus `dispatch_s` for each chunk of the chunked-prefill
    path that would run. The other side of the KVBM onboard gate."""
    flops = 2.0 * active_param_count(cfg) * n_tokens
    return n_dispatches * dispatch_s + flops / max(chip_flops * mfu, 1.0)
