"""Roofline sizes of a model: parameters, active parameters, KV bytes per
token and weight bytes per parameter.

The part of `dynamo_tpu/profiler/roofline.py` the live utilization gauges
read (observability/engine_metrics.py), copied: the port's own copy (it
imports nothing of the JAX package); keep the two in step. The JAX
module's analytic `estimate` of TTFT / ITL for the SLA sweep waits for the
planner. Counts assume bfloat16 (2 bytes) parameters and KV unless a
quantization says otherwise.
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
