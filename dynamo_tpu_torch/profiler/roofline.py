"""Analytic roofline model for LLM serving on GPUs: the sizes of a model
(parameters, active parameters, KV bytes per token, weight bytes per
parameter), the two sides of the KVBM's onboard gate, and the SLA
profiler's `estimate` of TTFT / ITL / throughput for a (model, system, tp,
batch) point.

The port's copy of `dynamo_tpu/profiler/roofline.py` (it imports nothing
of the JAX package); keep the two in step. The formula is the JAX
module's; what differs is the catalog (profiler/systems.py) and the
utilization factors, which are the card's own (`CARD_FACTORS`, below):

- prefill is compute-bound on the tensor cores: TTFT ~ FLOPs(isl) /
  (cards * peak * mfu_prefill) plus the TP all-reduces over NVLink and a
  fixed overhead;
- decode is memory-bound: ITL ~ bytes(weights + the batch's KV) /
  (HBM rate * hbm_eff), floored by the compute term, plus collectives and
  the overhead;
- capacity requires the sharded weights and the batch's KV to fit.

The gate's rates are the caller's: the JAX module's defaults are a TPU's
planning numbers, the port's come from the card (kvbm/cost_model.py).
Counts assume bfloat16 (2 bytes) parameters and KV unless a quantization
says otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.profiler.systems import SystemSpec

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


# Serving quantization tiers the engine implements (`--quantization`,
# `--kv-cache-dtype`), in PREFERENCE order: unquantized first — quantization
# is only recommended when the plain config can't fit or can't meet the SLA
# (matching how an operator would actually use the levers).
QUANT_TIERS = (
    ("none", "auto"),
    ("w8a8", "auto"),
    ("w8a8", "int8"),
)


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


@dataclasses.dataclass(frozen=True)
class Factors:
    """The fractions of the datasheet peaks a serving engine attains: MFU
    of a prefill, MFU of a decode step, the device memory's attained
    fraction, the interconnect's attained fraction, and the fixed seconds
    a step spends outside the device's work."""
    mfu_prefill: float
    mfu_decode: float
    hbm_eff: float
    link_eff: float
    dispatch_s: float


# The card's factors, measured by `chip_smoke.py --fleet` (phase 21) on an
# NVIDIA H100 80GB HBM3 at a 700.00 W power limit, serving the 8B
# (llama-3.1-8b-instruct, random bf16 weights) with the port's engine:
# - mfu_prefill: a 1920-token whole-prompt prefill's FLOPs (the formula of
#   `estimate`: 32.77 TFLOP) over its time from submission to the first
#   token on an idle one-slot engine (68.95 ms), against 989 TFLOP/s;
# - mfu_decode: a graph-window decode step of 256 slots, 2 x active
#   parameters x 256 FLOPs over its time (15.35 ms), against the same
#   peak: what the widest batch the sweep offers attains;
# - hbm_eff: a one-slot graph-window decode step, the weights' and the
#   context's bytes (16.08 GB) over its time (9.152 ms), against 3.35 TB/s;
# - dispatch_s: the served streams' inter-token time through the frontend
#   at one live stream (9.305 ms) less that one-slot step.
# The formula has no term for a first token's wait on the jetstream's
# decode window nor for a chunked prefill, so at a served point (128
# slots, 8-step windows, 256-token chunks) the estimate's TTFT runs about
# an order of magnitude low; phase 21 holds that ratio (ROADMAP queue 3).
# link_eff is not measured: the card machine holds one H100, so no
# all-reduce crosses NVLink there. Its value, one half (an all-reduce
# priced at half of the 450 GB/s a card's 18 links carry one way), is a
# planning figure until a multi-card run measures it; the sweep offers
# only tp 1 (the engine's degrees), so no decision it renders reads it.
CARD_FACTORS = Factors(mfu_prefill=0.4806, mfu_decode=0.2707,
                       hbm_eff=0.5246, link_eff=0.5, dispatch_s=0.000153)


@dataclasses.dataclass(frozen=True)
class Estimate:
    """Roofline estimate for one (tp, batch, quant tier) point."""
    tp: int
    replicas: int            # data-parallel engine replicas (cards // tp)
    batch: int               # per-replica decode batch (max_num_seqs)
    ttft_s: float
    itl_s: float
    tok_s_per_chip: float    # aggregate decode throughput / total cards
    hbm_used_frac: float     # worst-card memory occupancy at full batch
    feasible: bool
    quantization: str = "none"   # none | w8a8 (weights/activations)
    kv_dtype: str = "auto"       # auto (model dtype) | int8

    def meets(self, ttft_ms: Optional[float], itl_ms: Optional[float]) -> bool:
        if not self.feasible:
            return False
        if ttft_ms is not None and self.ttft_s * 1e3 > ttft_ms:
            return False
        if itl_ms is not None and self.itl_s * 1e3 > itl_ms:
            return False
        return True


def _allreduce_time(bytes_per_device: float, tp: int, sys: SystemSpec,
                    link_eff: float = CARD_FACTORS.link_eff) -> float:
    """Ring all-reduce over NVLink: 2*(tp-1)/tp of the buffer crosses each
    card's links. A TP group wider than one board would cross the boards'
    network, slower than NVLink: the model prices it at the NVLink rate,
    a bound from below."""
    if tp <= 1:
        return 0.0
    wire = 2.0 * (tp - 1) / tp * bytes_per_device
    return wire / (sys.chip.nvlink_bw * link_eff)


def estimate(
    cfg: ModelConfig,
    sys: SystemSpec,
    tp: int,
    batch: int,
    isl: int,
    osl: int,
    quantization: str = "none",
    kv_dtype: str = "auto",
    factors: Factors = CARD_FACTORS,
) -> Estimate:
    """Roofline TTFT/ITL/throughput for tp-way sharding and a decode batch.

    `quantization`/`kv_dtype` model the engine's serving levers: int8
    weights halve the weight footprint AND stream; w8a8 additionally runs
    int8 x int8 tensor-core products (modeled only through bytes:
    conservative); int8 KV halves the per-token page stream and pool
    pressure. `factors` are the card's (CARD_FACTORS) unless given."""
    f = factors
    replicas = max(sys.num_chips // tp, 1)
    p_total = param_count(cfg)
    p_active = active_param_count(cfg)
    chip = sys.chip
    wb = weight_bytes(quantization)
    kvb = kv_bytes_per_token(cfg, kv_dtype, tp=tp)
    if (kv_dtype == "int8" and not cfg.is_mla
            and cfg.cache_kv_heads % tp != 0):
        # the lane-blocked int8 layout requires tp | cache KV heads (MLA
        # pools replicate, so the blocking never applies there)
        return Estimate(tp=tp, replicas=max(sys.num_chips // tp, 1),
                        batch=batch, ttft_s=float("inf"),
                        itl_s=float("inf"), tok_s_per_chip=0.0,
                        hbm_used_frac=float("inf"), feasible=False,
                        quantization=quantization, kv_dtype=kv_dtype)
    # MLA latent pools REPLICATE across the model axis: every card holds
    # and streams the full KV pool (tp shards only the weights)
    kv_shards = 1 if cfg.is_mla else tp

    # --- capacity: per-card share of weights + this replica's KV pages.
    avg_ctx = isl + osl / 2.0
    kv_per_seq_full = kvb * (isl + osl)
    weights_per_chip = p_total * wb / tp
    kv_per_chip = batch * kv_per_seq_full / kv_shards
    hbm_frac = (weights_per_chip + kv_per_chip) / (chip.hbm_bytes * 0.92)
    feasible = hbm_frac <= 1.0

    # --- prefill (one request of isl tokens on one tp group).
    l, nh, hd = cfg.num_layers, cfg.num_heads, cfg.head_dim
    flops_prefill = 2.0 * p_active * isl + 4.0 * l * nh * hd * isl * isl
    t_compute = flops_prefill / (tp * chip.bf16_flops * f.mfu_prefill)
    # 2 all-reduces per layer of the activations (attn out + mlp out)
    act_bytes = isl * cfg.hidden_size * BYTES
    t_coll = 2 * l * _allreduce_time(act_bytes, tp, sys, f.link_eff)
    ttft = t_compute + t_coll + f.dispatch_s

    # --- decode step for the full batch at average context length
    # (per-card read bytes over per-card bandwidth; replicated MLA pools
    # get no TP bandwidth speedup on the KV stream).
    read_per_chip = (p_total * wb / tp
                     + batch * kvb * avg_ctx / kv_shards)
    t_mem = read_per_chip / (chip.hbm_bw * f.hbm_eff)
    t_flops = 2.0 * p_active * batch / (tp * chip.bf16_flops * f.mfu_decode)
    dec_act = batch * cfg.hidden_size * BYTES
    t_dcoll = 2 * l * _allreduce_time(dec_act, tp, sys, f.link_eff)
    itl = max(t_mem, t_flops) + t_dcoll + f.dispatch_s

    tok_s = replicas * batch / itl
    return Estimate(
        tp=tp, replicas=replicas, batch=batch,
        ttft_s=ttft, itl_s=itl,
        tok_s_per_chip=tok_s / sys.num_chips,
        hbm_used_frac=hbm_frac, feasible=feasible,
        quantization=quantization, kv_dtype=kv_dtype,
    )
