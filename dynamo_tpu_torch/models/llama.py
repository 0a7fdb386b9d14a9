"""Llama decoder over the paged KV cache, in PyTorch.

Port of `dynamo_tpu/models/llama.py` (Llama 3.x: SwiGLU, RMSNorm, rotary
embeddings with optional llama3, YaRN or Phi-3's longrope scaling, GQA,
tied or untied head), with DeepSeek-V2's multi-head latent attention
(`kv_lora_rank`: the absorbed form of `_qkv_mla`, one shared latent row
per token in the pools) and the ModelConfig switches of three more dense
families:
Qwen2/2.5 (`attention_bias`: q/k/v biases), Qwen3 (`qk_norm`: a per-head
RMSNorm of q and k over head_dim, before rope) and Gemma 1
(`hidden_act="gelu_tanh"`: GeGLU; `rms_norm_unit_offset`: norms scale by
1 + w; `embed_scale`: embeddings times sqrt(hidden_size)), Gemma-2 and
Gemma-3 (below), and the mixture-of-experts MLP (`num_experts`: Mixtral,
Qwen3-MoE; with `num_shared_experts`, `norm_topk_prob` and
`routed_scaling_factor`, DeepSeek's routing; `ops.moe`). What the port
does not implement is refused by `unported_model_features`.

Gemma-2/3 (JAX `_attn_kwargs`, `_is_global_layer`, `_layer_rope`, `_post`):
layer l is global where (l + 1) % sliding_window_pattern == 0 (never with
pattern 0), else local; a local layer's attention sees only the last
`sliding_window` positions (the ops' `window`, 0 on a global layer), every
layer's scores are capped by `attn_logit_softcapping` and the final logits
by `final_logit_softcapping` (cap * tanh(x / cap)), q is pre-scaled by
sqrt(head_dim / query_pre_attn_scalar) so that the ops' 1/sqrt(head_dim)
becomes 1/sqrt(query_pre_attn_scalar), the branch outputs of attention and
MLP pass their own norms (`post_norms`), and Gemma-3's local layers rotate
with `rope_local_theta` while its global layers rotate positions divided by
`rope_scaling_factor`. One predicate (`_is_global_layer`) decides both the
window and the rope, and both are host values per layer, so a captured
decode step holds each layer's window as a constant of its launch.

Differences in idiom, not in arithmetic:

- Weights live in an `nn.Module` (`Llama`, one `LlamaLayer` per layer)
  instead of a layer-stacked pytree, and the forward is a Python loop over
  layers instead of `lax.scan`.
- The KV pools [L, P, ps, KV*D] are updated IN PLACE: each layer gets the
  free view `k_pages[l]` with the sequence's own page ids, where the JAX
  scan offsets page ids by `l * P` into a flattened pool because a JAX
  slice would copy. The layout is unchanged (page 0 is the trash page), so
  the pools compare byte for byte with the JAX package's.
- Each forward takes `attn`, the attention functions to call
  (`ops.attention.DISPATCH` by default: the CUDA kernels on the card, the
  plain versions on the CPU; `ops.attention.PLAIN` forces the plain ones).

Multi-LoRA (`dynamo_tpu_torch.lora`): every forward takes `lora`, the
engine's `lora.apply.Stacks` (None: no adapters), and `adapter_slots`,
each sequence's slot (0 = the all-zero base slot): an int for the
single-prompt prefill and chunk, [N] for a batched prefill, [B] for the
decode and verify steps (a verify window repeats its slot over K+1 rows),
with `chunk_adapter_slot` for the chunk of a mixed step. q, k, v and o
each add their row's `lora.apply.delta` (JAX `llama.py` `_qkv`,
`_attn_out`).

MoE (JAX `_mlp`): the router's logits [T, X] (the product in the model
dtype, cast to f32), their top-k combine matrix, padding rows masked out
of it before any capacity is counted, then the dense dispatch, or the
capacity path where the forward allows it (the prefills, with
`moe_capacity_factor` > 0 and a capacity below the token count). The
decode, verify and mixed steps dispatch densely: their shapes do not
depend on the routing, so the captured steps take them, and the mixed
steps keep a sequence's tokens independent of what shares its step.

Projections and the LM head are plain matmuls, as the JAX package leaves
them to XLA; a weight quantized by `models.quant` (a `QTensor`, weight-only
or W8A8) goes through `quant.matmul` instead, and a quantized embedding
through `quant.take_rows` and `quant.tied_head`. Which path a site takes
is decided on the host from the weight's type, so a CUDA graph captures
only tensor ops.
"""

from __future__ import annotations

import copy
import functools
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from dynamo_tpu_torch.lora import apply as lora_apply
from dynamo_tpu_torch.models import quant
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.ops import attention as att
from dynamo_tpu_torch.ops import cuda_attention
from dynamo_tpu_torch.ops import moe as moe_ops
from dynamo_tpu_torch.ops.rope import (longrope_attention_factor,
                                       rope_cos_sin, rotate, yarn_get_mscale)


def _weight(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


def _expert_weight(shape, device, dtype) -> nn.Parameter:
    """An expert stack [X, K, N] stored as each expert's [N, K]
    (`quant.operand_layout`)."""
    x, k, n = shape
    return nn.Parameter(torch.empty((x, n, k), device=device,
                                    dtype=dtype).transpose(1, 2),
                        requires_grad=False)


def unported_model_features(m: ModelConfig) -> List[str]:
    """ModelConfig features this model does not implement: an activation
    other than SwiGLU or GeGLU, and a head_dim the attention kernels are
    not built for (one outside `cuda_attention.TILE_HEAD_DIMS`, such as 80
    or 112; an MLA model's rows are its latent row, which the kernels take
    at 640 and the plain versions at any width). Every rope scaling of
    `ModelConfig` is served, Phi-3's longrope among them."""
    checks = [
        ("hidden_act", m.hidden_act not in ("silu", "gelu_tanh")),
        ("head_dim", not m.is_mla
         and m.head_dim not in cuda_attention.TILE_HEAD_DIMS),
    ]
    return [name for name, bad in checks if bad]


class LlamaLayer(nn.Module):
    """One decoder layer's weights, in the JAX layout with the head axes
    flattened: wq [E, H*D], wk/wv [E, KV*D], wo [H*D, E], w_gate/w_up
    [E, F], w_down [F, E]; with MLA (`kv_lora_rank` R, nope/rope head dims
    N and P, value dim Dv) instead of wq/wk/wv: wq_mla [E, H*(N+P)],
    w_kv_a [E, R+P], kv_a_norm [R], w_uk [H, N, R], w_uv [H, R, Dv] and
    wo [H*Dv, E]; with `attention_bias`, bq [H*D] and bk/bv
    [KV*D]; with `qk_norm`, q_norm/k_norm [D]; with `num_experts` X,
    router [E, X], moe_w_gate/moe_w_up [X, E, F] and moe_w_down
    [X, F, E] (stored as each expert's [out, in]); with `post_norms`
    (Gemma-2/3), post_attn_norm/post_mlp_norm [E]; and w_gate/w_up/w_down
    only for shared experts, at width num_shared_experts * F (None where
    the config has no such weight). Each matmul weight is a tensor or,
    quantized, a `quant.QTensor` of the same shape; biases, norms and the
    router stay in the model dtype."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        e, h, kv, d = (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
                       cfg.head_dim)
        f = cfg.intermediate_size
        self.attn_norm = _weight((e,), device, dtype)
        if cfg.is_mla:
            nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
            r, vd = cfg.kv_lora_rank, cfg.v_head_dim
            self.wq = self.wk = self.wv = None
            self.wq_mla = _weight((e, h * (nope + rope)), device, dtype)
            self.w_kv_a = _weight((e, r + rope), device, dtype)
            self.kv_a_norm = _weight((r,), device, dtype)
            self.w_uk = _weight((h, nope, r), device, dtype)
            self.w_uv = _weight((h, r, vd), device, dtype)
            self.wo = _weight((h * vd, e), device, dtype)
        else:
            self.wq = _weight((e, h * d), device, dtype)
            self.wk = _weight((e, kv * d), device, dtype)
            self.wv = _weight((e, kv * d), device, dtype)
            self.wo = _weight((h * d, e), device, dtype)
        self.mlp_norm = _weight((e,), device, dtype)
        fd = cfg.num_shared_experts * f if cfg.is_moe else f
        self.w_gate = _weight((e, fd), device, dtype) if fd else None
        self.w_up = _weight((e, fd), device, dtype) if fd else None
        self.w_down = _weight((fd, e), device, dtype) if fd else None
        x = cfg.num_experts
        moe = cfg.is_moe
        self.router = _weight((e, x), device, dtype) if moe else None
        self.moe_w_gate = (_expert_weight((x, e, f), device, dtype)
                           if moe else None)
        self.moe_w_up = (_expert_weight((x, e, f), device, dtype)
                         if moe else None)
        self.moe_w_down = (_expert_weight((x, f, e), device, dtype)
                           if moe else None)
        bias = cfg.attention_bias
        self.bq = _weight((h * d,), device, dtype) if bias else None
        self.bk = _weight((kv * d,), device, dtype) if bias else None
        self.bv = _weight((kv * d,), device, dtype) if bias else None
        norm = cfg.qk_norm
        self.q_norm = _weight((d,), device, dtype) if norm else None
        self.k_norm = _weight((d,), device, dtype) if norm else None
        post = cfg.post_norms
        self.post_attn_norm = _weight((e,), device, dtype) if post else None
        self.post_mlp_norm = _weight((e,), device, dtype) if post else None


class Llama(nn.Module):
    """Weights of a dense Llama model (uninitialised: see models.loader;
    device "meta" builds the structure without memory, for a loader that
    sets every weight)."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype  # of activations and unquantized weights
        e = cfg.hidden_size
        self.embed = _weight((cfg.vocab_size, e), device, dtype)
        self.layers = nn.ModuleList(
            LlamaLayer(cfg, device, dtype) for _ in range(cfg.num_layers))
        self.final_norm = _weight((e,), device, dtype)
        self.lm_head = (None if cfg.tie_word_embeddings
                        else _weight((e, cfg.vocab_size), device, dtype))


# the ModelConfig fields that fix the weights' shapes and names
SHAPE_FIELDS = ("vocab_size", "hidden_size", "intermediate_size",
                "num_layers", "num_heads", "num_kv_heads", "head_dim",
                "tie_word_embeddings", "attention_bias", "qk_norm",
                "num_experts", "num_shared_experts", "kv_lora_rank",
                "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim",
                "post_norms")


def with_config(model: Llama, cfg: ModelConfig) -> Llama:
    """The same weights under `cfg` (an engine's own ModelConfig: as the
    JAX engine's parameter tree carries no config, its model_cfg decides
    rope, norms, routing and the MoE capacity factor), for the forwards,
    which read `model.cfg`: a shallow copy sharing every parameter and
    layer. Raises ValueError where `cfg` gives the weights other shapes."""
    differ = [f for f in SHAPE_FIELDS
              if getattr(model.cfg, f) != getattr(cfg, f)]
    if differ:
        raise ValueError(f"the weights of {model.cfg.name} do not have the "
                         f"shapes of {cfg.name}: {differ} differ")
    if model.cfg == cfg:
        return model
    view = copy.copy(model)
    view.cfg = cfg
    return view


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float,
             unit_offset: bool = False) -> torch.Tensor:
    """Normalize in f32, cast back to x's dtype, then scale by w, or by
    1 + w (Gemma's norms: zero weights are the identity) rounded to w's
    dtype first (the JAX package's cast order)."""
    x32 = x.to(torch.float32)
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    normed = (x32 * torch.rsqrt(var + eps)).to(x.dtype)
    return normed * (1 + w) if unit_offset else normed * w


def _norm(cfg: ModelConfig, x: torch.Tensor, w: torch.Tensor
          ) -> torch.Tensor:
    return rms_norm(x, w, cfg.rms_norm_eps, cfg.rms_norm_unit_offset)


def _embed_rows(model: Llama, tokens: torch.Tensor) -> torch.Tensor:
    x = quant.take_rows(model.embed, tokens.long(), model.dtype)
    if model.cfg.embed_scale:  # Gemma: times sqrt(E) in f32, cast back
        x = (x.to(torch.float32) * model.cfg.hidden_size ** 0.5).to(x.dtype)
    return x


def _is_global_layer(cfg: ModelConfig, l: int) -> bool:
    """THE local/global predicate (JAX `_is_global_layer`): layer l is
    global where (l + 1) % sliding_window_pattern == 0; pattern <= 0 means
    every layer is local (a uniform sliding window). The window and the
    per-layer rope both read it, so the two cannot disagree."""
    p = cfg.sliding_window_pattern
    return p > 0 and (l + 1) % p == 0


def _attn_kwargs(cfg: ModelConfig, l: int) -> dict:
    """Layer l's score modifiers for the attention ops (JAX
    `_attn_kwargs`): `logit_cap` where the model caps its scores, `window`
    where it has sliding layers (0 on a global layer); {} for every other
    model, whose calls stay as they were."""
    kw = {}
    if cfg.attn_logit_softcapping > 0.0:
        kw["logit_cap"] = cfg.attn_logit_softcapping
    if cfg.sliding_window > 0:
        kw["window"] = 0 if _is_global_layer(cfg, l) else cfg.sliding_window
    return kw


def _longrope_args(cfg: ModelConfig):
    """Phi-3's longrope argument of rope_cos_sin (JAX `_longrope_args`):
    (short factors, long factors, original_max_pos, attention factor over
    the checkpoint's context extension), or None."""
    if cfg.rope_longrope_scaling is None:
        return None
    short, long, orig = cfg.rope_longrope_scaling
    return short, long, orig, longrope_attention_factor(
        cfg.max_position_embeddings, orig)


def _rope(cfg: ModelConfig, positions: torch.Tensor,
          theta: Optional[float] = None, position_scale: float = 1.0):
    """cos/sin of `positions` at the rotated width (head_dim, or MLA's
    qk_rope_head_dim), at rope_theta unless `theta` is given, positions
    divided by `position_scale`, with the config's rope scaling."""
    width = cfg.qk_rope_head_dim if cfg.is_mla else cfg.head_dim
    return rope_cos_sin(positions, width,
                        cfg.rope_theta if theta is None else theta,
                        llama3_scaling=cfg.rope_llama3_scaling,
                        yarn_scaling=cfg.rope_yarn_scaling,
                        longrope_scaling=_longrope_args(cfg),
                        position_scale=position_scale)


def _ropes(cfg: ModelConfig, positions: torch.Tensor) -> list:
    """Each layer's cos/sin of one forward, computed once per distinct
    rope and shared: one for every layer, or with Gemma-3's
    `rope_local_theta` (JAX `_layer_rope`) local layers at
    rope_local_theta and global layers at rope_theta over positions /
    rope_scaling_factor."""
    if cfg.rope_local_theta <= 0:
        return [_rope(cfg, positions)] * cfg.num_layers
    local = _rope(cfg, positions, cfg.rope_local_theta)
    glob = _rope(cfg, positions, cfg.rope_theta, cfg.rope_scaling_factor)
    return [glob if _is_global_layer(cfg, l) else local
            for l in range(cfg.num_layers)]


@functools.lru_cache(maxsize=None)
def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """`value` rounded to `dtype`, as a Python float: a product by it
    rounds as JAX's product by `jnp.asarray(value, dtype)` (both compute
    in f32 and round once), and no host tensor enters a captured step."""
    return float(torch.tensor(value, dtype=dtype))


def _yarn_softmax_scale(cfg: ModelConfig, q: torch.Tensor) -> torch.Tensor:
    """YaRN's attention-magnitude correction (JAX `_yarn_softmax_scale`):
    the softmax scale gains yarn_get_mscale(factor, mscale_all_dim)^2,
    folded into q; none where an explicit attention_factor rides on
    cos/sin instead."""
    if cfg.rope_yarn_scaling is None:
        return q
    factor, _, _, _, _, msad, af = cfg.rope_yarn_scaling
    if af >= 0.0:
        return q
    m = yarn_get_mscale(factor, msad)
    if m == 1.0:
        return q
    return q * _in_dtype(m * m, q.dtype)


def _qkv(cfg: ModelConfig, layer: LlamaLayer, x: torch.Tensor, rope,
         lora=None):
    """x [T, E] -> q [T, H, D], k/v [T, KV, D]: the projections, their
    LoRA deltas (`lora`: this layer's {target: (A, B)} stacks and the
    rows' `lora.apply.slot_rows` mask), their biases (`attention_bias`), the per-head norms
    of q and k (`qk_norm`), then rope (cos, sin) on q and k, then q's
    YaRN and query_pre_attn_scalar scales, in the JAX order."""
    t = x.shape[0]
    act = quant.shared_activations(x, layer.wq)
    q = quant.matmul(x, layer.wq, act)
    k = quant.matmul(x, layer.wk, act)
    v = quant.matmul(x, layer.wv, act)
    if lora is not None:
        stacks, rows = lora
        q = q + lora_apply.delta_rows(x, *stacks["q"], rows)
        k = k + lora_apply.delta_rows(x, *stacks["k"], rows)
        v = v + lora_apply.delta_rows(x, *stacks["v"], rows)
    if cfg.attention_bias:
        q, k, v = q + layer.bq, k + layer.bk, v + layer.bv
    q = q.view(t, cfg.num_heads, cfg.head_dim)
    k = k.view(t, cfg.num_kv_heads, cfg.head_dim)
    v = v.view(t, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q, k = _norm(cfg, q, layer.q_norm), _norm(cfg, k, layer.k_norm)
    q = _yarn_softmax_scale(cfg, rotate(q, *rope))
    if cfg.query_pre_attn_scalar > 0:
        # the ops scale scores by head_dim^-0.5; Gemma-2/3 want
        # query_pre_attn_scalar^-0.5: q is pre-scaled by the ratio
        q = q * _in_dtype((cfg.head_dim / cfg.query_pre_attn_scalar) ** 0.5,
                          q.dtype)
    return q, rotate(k, *rope), v


def _qkv_mla(cfg: ModelConfig, layer: LlamaLayer, x: torch.Tensor, rope):
    """Absorbed-form MLA projections (JAX `_qkv_mla`): x [T, E] ->
    (q_eff [T, H, W], row [T, 1, W], row), W = cache_head_dim. The pools
    store one [c_kv | k_rope] row per token, shared by every head, and
    q_eff = [q_nope @ W_UK | q_rope] scores against it directly. In the
    JAX order: q_rope rotated, c_kv normed, k_rope rotated, q_nope
    through W_UK in f32 and cast back, the sqrt(W / (nope + rope))
    correction of the ops' 1/sqrt(W) scale, YaRN's softmax mscale^2,
    then zero lanes from R + rope up to W (DeepSeek-V2: 576 -> 640)."""
    nope, rd, r = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.kv_lora_rank
    t = x.shape[0]
    act = quant.shared_activations(x, layer.wq_mla)
    q = quant.matmul(x, layer.wq_mla, act).view(t, cfg.num_heads, nope + rd)
    q_rope = rotate(q[..., nope:], *rope)
    kv = quant.matmul(x, layer.w_kv_a, act)  # [T, R + rope]
    c_kv = _norm(cfg, kv[:, :r], layer.kv_a_norm)
    k_rope = rotate(kv[:, None, r:], *rope)[:, 0]
    q_lat = torch.einsum("thn,hnr->thr", q[..., :nope].to(torch.float32),
                         layer.w_uk.to(torch.float32)).to(q.dtype)
    width = cfg.cache_head_dim
    fix = _in_dtype((width / (nope + rd)) ** 0.5, q.dtype)
    q_eff = _yarn_softmax_scale(cfg, torch.cat([q_lat, q_rope], dim=-1) * fix)
    row = torch.cat([c_kv, k_rope], dim=-1)[:, None, :]
    pad = width - (r + rd)
    if pad:
        q_eff, row = F.pad(q_eff, (0, pad)), F.pad(row, (0, pad))
    return q_eff, row, row


def _attn_out(cfg: ModelConfig, layer: LlamaLayer, o: torch.Tensor,
              lora=None) -> torch.Tensor:
    """Attention output [T, H, D] -> residual [T, E], plus the rows' o
    deltas with `lora` (see _qkv). MLA: o's first kv_lora_rank lanes are
    probs @ c_kv, expanded per head through W_UV in f32 (cast back)
    before wo."""
    if cfg.is_mla:
        o = torch.einsum("thr,hrv->thv",
                         o[..., :cfg.kv_lora_rank].to(torch.float32),
                         layer.w_uv.to(torch.float32)).to(o.dtype)
    o2 = o.reshape(o.shape[0], -1)
    out = quant.matmul(o2, layer.wo)
    if lora is not None:
        stacks, rows = lora
        out = out + lora_apply.delta_rows(o2, *stacks["o"], rows)
    return out


def _dense_mlp(cfg: ModelConfig, layer: LlamaLayer, x: torch.Tensor
               ) -> torch.Tensor:
    """Gated MLP, x [T, E]: SwiGLU, or GeGLU (tanh GELU) for
    hidden_act "gelu_tanh"."""
    act = quant.shared_activations(x, layer.w_gate)
    g = quant.matmul(x, layer.w_gate, act)
    g = (F.gelu(g, approximate="tanh") if cfg.hidden_act == "gelu_tanh"
         else F.silu(g))
    return quant.matmul(g * quant.matmul(x, layer.w_up, act), layer.w_down)


def _mlp(cfg: ModelConfig, layer: LlamaLayer, x: torch.Tensor,
         token_mask: Optional[torch.Tensor] = None,
         allow_capacity: bool = False) -> torch.Tensor:
    """The gated MLP or the MoE block (JAX `_mlp`). x [T, E]; token_mask
    [T] bool, False for padding rows (prefill pads to a page multiple).
    The capacity-gather MoE path is prefill-only (allow_capacity): decode
    batches contain inactive slots with no mask to exclude them, and are
    small enough that dense dispatch wins anyway."""
    if not cfg.is_moe:
        return _dense_mlp(cfg, layer, x)
    # top-k routing into a dense [T, X] combine matrix, then one of two
    # dispatch paths (ops.moe): exact dense-masked by default;
    # capacity-based gather (T*k*cf expert-MLP rows instead of T*X) when
    # the deployment opts in via moe_capacity_factor > 0
    logits = (x @ layer.router).to(torch.float32)
    combine = moe_ops.topk_combine(
        logits, cfg.num_experts_per_tok, x.dtype,
        renormalize=cfg.norm_topk_prob,
        scaling_factor=cfg.routed_scaling_factor)
    if token_mask is not None:
        # padding rows must not claim expert capacity (nor compute)
        combine = combine * token_mask.to(combine.dtype)[:, None]
    experts = (layer.moe_w_gate, layer.moe_w_up, layer.moe_w_down)
    out = None
    if allow_capacity and cfg.moe_capacity_factor > 0:
        t = x.shape[0]
        cap = moe_ops.expert_capacity(t, cfg.num_experts,
                                      cfg.num_experts_per_tok,
                                      cfg.moe_capacity_factor)
        if cap < t:  # gather only pays off when capacity actually cuts rows
            out = moe_ops.moe_mlp_dropping(x, combine, *experts,
                                           capacity=cap,
                                           k=cfg.num_experts_per_tok)
    if out is None:
        out = moe_ops.moe_mlp_dense(x, combine, *experts)
    if cfg.num_shared_experts > 0:
        # DeepSeek-style always-active shared experts: one fused dense
        # SwiGLU of width shared*F alongside the routed top-k
        return _dense_mlp(cfg, layer, x) + out
    return out


def _logits(model: Llama, x: torch.Tensor) -> torch.Tensor:
    """The head's logits, capped by final_logit_softcapping (Gemma-2)
    before the engine samples or masks them, in the JAX order."""
    x = _norm(model.cfg, x, model.final_norm)
    if model.lm_head is None:  # tied head: x @ embed.T
        out = quant.tied_head(x, model.embed)
    else:
        out = quant.matmul(x, model.lm_head)
    cap = model.cfg.final_logit_softcapping
    if cap > 0.0:
        out = cap * torch.tanh(out / cap)
    return out


def _row_slots(lora: Optional[lora_apply.Stacks], slots, n: int,
               device) -> Optional[torch.Tensor]:
    """Per-row adapter slots [n] of a forward: `slots` as a tensor (one
    per row), or one int repeated (None: the base slot); None without
    `lora`."""
    if lora is None:
        return None
    if isinstance(slots, torch.Tensor):
        return slots.to(device)
    return torch.full((n,), int(slots or 0), dtype=torch.int32,
                      device=device)


def _slot_rows(lora: Optional[lora_apply.Stacks], slots, dtype):
    """The slot_rows mask of per-row slots (None without `lora`)."""
    if lora is None:
        return None
    return lora_apply.slot_rows(slots, lora.num_slots, dtype)


def _token_mask(cfg: ModelConfig, n: int, valid, device,
                lead: int = 0) -> Optional[torch.Tensor]:
    """The MoE block's token mask [lead + n] of a forward: `lead` rows
    that are all real (decode or verify rows), then n rows of which the
    first `valid` are real (an int, or [N] lengths of N lanes of n rows
    each, flattened); None for a dense model, which needs none."""
    if not cfg.is_moe:
        return None
    i = torch.arange(n, device=device)
    if isinstance(valid, torch.Tensor):
        mask = (i[None, :] < valid.to(device)[:, None]).reshape(-1)
    else:
        mask = i < valid
    if lead:
        mask = torch.cat([torch.ones((lead,), dtype=torch.bool,
                                     device=device), mask])
    return mask


def _post(cfg: ModelConfig, w: Optional[torch.Tensor], y: torch.Tensor
          ) -> torch.Tensor:
    """Gemma-2/3's sandwich norm on a branch output (post_attn_norm,
    post_mlp_norm; JAX `_post`); y itself for every other family."""
    return _norm(cfg, y, w) if cfg.post_norms else y


def _layer(cfg, layer, x, rope, attend, lora=None, l=0, rows=None,
           token_mask=None, allow_capacity=False):
    """Decoder layer l around `attend(q, k, v, **score_mods) -> o`, which
    also owns the KV write (before or after attention, as the caller
    needs) and takes the layer's `_attn_kwargs`; `rope` is the forward's
    per-layer list (`_ropes`). With `lora` (Stacks) the projections add the
    deltas of the rows' slots (`rows`: their slot_rows mask).
    `token_mask` and `allow_capacity` go to the MoE block (`_mlp`)."""
    ll = None if lora is None else (lora.layer(l), rows)
    h = _norm(cfg, x, layer.attn_norm)
    if cfg.is_mla:  # the LoRA registry refuses MLA models, as JAX's does
        q, k, v = _qkv_mla(cfg, layer, h, rope[l])
    else:
        q, k, v = _qkv(cfg, layer, h, rope[l], ll)
    o = attend(q, k, v, **_attn_kwargs(cfg, l))
    x = x + _post(cfg, layer.post_attn_norm, _attn_out(cfg, layer, o, ll))
    h = _norm(cfg, x, layer.mlp_norm)
    return x + _post(cfg, layer.post_mlp_norm,
                     _mlp(cfg, layer, h, token_mask, allow_capacity))


def prefill(model: Llama, tokens: torch.Tensor, seq_len: int,
            k_pages: torch.Tensor, v_pages: torch.Tensor, pages: torch.Tensor,
            *, page_size: int, attn: att.AttentionFns = att.DISPATCH,
            lora: Optional[lora_apply.Stacks] = None,
            adapter_slots: int = 0) -> torch.Tensor:
    """One padded prompt tokens [S] (S a page multiple, seq_len true
    tokens) -> logits [V] at the last real token; writes the prompt's KV
    into `pages` [S // ps] of every layer's pool."""
    cfg = model.cfg
    s = tokens.shape[0]
    rope = _ropes(cfg, torch.arange(s, device=tokens.device))
    lens = torch.tensor([seq_len], dtype=torch.int32).to(tokens.device)
    slots = _row_slots(lora, adapter_slots, s, tokens.device)
    mask = _token_mask(cfg, s, seq_len, tokens.device)
    x = _embed_rows(model, tokens)
    rows = _slot_rows(lora, slots, model.dtype)
    for l, layer in enumerate(model.layers):
        kp, vp = k_pages[l], v_pages[l]

        def attend(q, k, v, **mods):
            o = attn.prefill(q, k, v, lens, **mods)
            att.write_kv_prefill(kp, vp, k, v, pages, page_size=page_size)
            return o

        x = _layer(cfg, layer, x, rope, attend, lora, l, rows, mask, True)
    return _logits(model, x[seq_len - 1][None])[0]


def prefill_chunk(model: Llama, tokens: torch.Tensor, start: int,
                  chunk_len: int, k_pages: torch.Tensor,
                  v_pages: torch.Tensor, pages: torch.Tensor, *,
                  page_size: int, attn: att.AttentionFns = att.DISPATCH,
                  lora: Optional[lora_apply.Stacks] = None,
                  adapter_slots: int = 0) -> torch.Tensor:
    """One chunk tokens [C] (page multiple, chunk_len valid) at absolute
    position `start` of a sequence whose pages are `pages` [W] (ALL of
    them, trash-padded): write the chunk's KV, attend prefix + chunk, and
    return the logits [V] at the chunk's last valid token (meaningful on
    the final chunk)."""
    cfg = model.cfg
    c = tokens.shape[0]
    rope = _ropes(cfg, start + torch.arange(c, device=tokens.device))
    first = start // page_size
    chunk_pages = pages[first:first + c // page_size]
    slots = _row_slots(lora, adapter_slots, c, tokens.device)
    mask = _token_mask(cfg, c, chunk_len, tokens.device)
    x = _embed_rows(model, tokens)
    rows = _slot_rows(lora, slots, model.dtype)
    for l, layer in enumerate(model.layers):
        kp, vp = k_pages[l], v_pages[l]

        def attend(q, k, v, **mods):
            att.write_kv_prefill(kp, vp, k, v, chunk_pages,
                                 page_size=page_size)
            return attn.chunk(q, kp, vp, pages, start, page_size=page_size,
                              num_kv_heads=cfg.cache_kv_heads, **mods)

        x = _layer(cfg, layer, x, rope, attend, lora, l, rows, mask, True)
    return _logits(model, x[chunk_len - 1][None])[0]


def prefill_batch(model: Llama, tokens: torch.Tensor, seq_lens: torch.Tensor,
                  k_pages: torch.Tensor, v_pages: torch.Tensor,
                  pages: torch.Tensor, *, page_size: int,
                  attn: att.AttentionFns = att.DISPATCH,
                  lora: Optional[lora_apply.Stacks] = None,
                  adapter_slots: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """N same-bucket prompts tokens [N, S] with true lengths seq_lens [N]
    (>= 1) in one pass -> logits [N, V]. Lane n writes its KV into pages
    [n] ([N, S // ps], trash 0 for padding); attention stays per lane."""
    cfg = model.cfg
    n, s = tokens.shape
    rope = _ropes(cfg, torch.arange(s, device=tokens.device).repeat(n))
    x = _embed_rows(model, tokens.reshape(-1))
    flat_pages = pages.reshape(-1)
    slots = None
    if lora is not None:  # lane n's slot on each of its S rows
        lanes = (adapter_slots if adapter_slots is not None
                 else torch.zeros((n,), dtype=torch.int32))
        slots = lanes.to(tokens.device).repeat_interleave(s)
    rows = _slot_rows(lora, slots, model.dtype)
    mask = _token_mask(cfg, s, seq_lens, tokens.device)
    for l, layer in enumerate(model.layers):
        kp, vp = k_pages[l], v_pages[l]

        def attend(q, k, v, **mods):
            o = attn.prefill(q.view(n, s, *q.shape[1:]),
                             k.view(n, s, *k.shape[1:]),
                             v.view(n, s, *v.shape[1:]), seq_lens, **mods)
            att.write_kv_prefill(kp, vp, k, v, flat_pages,
                                 page_size=page_size)
            return o.reshape(n * s, *o.shape[2:])

        x = _layer(cfg, layer, x, rope, attend, lora, l, rows, mask, True)
    idx = torch.arange(n, device=x.device) * s + seq_lens.long() - 1
    return _logits(model, x[idx])


def decode_step(model: Llama, tokens: torch.Tensor, positions: torch.Tensor,
                block_tables: torch.Tensor, context_lens: torch.Tensor,
                k_pages: torch.Tensor, v_pages: torch.Tensor, *,
                page_size: int, attn: att.AttentionFns = att.DISPATCH,
                lora: Optional[lora_apply.Stacks] = None,
                adapter_slots: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """One decode step over every batch slot: tokens/positions [B],
    block_tables [B, Pmax], context_lens [B] INCLUDING the current token
    -> logits [B, V]. The token's KV is written before attention."""
    cfg = model.cfg
    rope = _ropes(cfg, positions)
    slots = _row_slots(lora, adapter_slots, tokens.shape[0], tokens.device)
    x = _embed_rows(model, tokens)
    rows = _slot_rows(lora, slots, model.dtype)
    for l, layer in enumerate(model.layers):
        kp, vp = k_pages[l], v_pages[l]

        def attend(q, k, v, **mods):
            att.write_kv_token(kp, vp, k, v, block_tables, positions,
                               page_size=page_size)
            return attn.decode(q, kp, vp, block_tables, context_lens,
                               page_size=page_size,
                               num_kv_heads=cfg.cache_kv_heads, **mods)

        x = _layer(cfg, layer, x, rope, attend, lora, l, rows)
    return _logits(model, x)


def mixed_step(model: Llama, tokens: torch.Tensor, positions: torch.Tensor,
               block_tables: torch.Tensor, context_lens: torch.Tensor,
               chunk_tokens: torch.Tensor, chunk_start: int, chunk_len: int,
               chunk_pages: torch.Tensor, k_pages: torch.Tensor,
               v_pages: torch.Tensor, *, page_size: int,
               attn: att.AttentionFns = att.DISPATCH,
               lora: Optional[lora_apply.Stacks] = None,
               adapter_slots: Optional[torch.Tensor] = None,
               chunk_adapter_slot: int = 0):
    """ONE mixed step: every decode slot advances a token and one prefill
    chunk makes progress, in one forward. tokens/positions [B],
    block_tables [B, Pmax] and context_lens [B] (INCLUDING the current
    token) are decode_step's; chunk_tokens [C] (page multiple, chunk_len
    valid) at absolute position chunk_start is prefill_chunk's, over the
    sequence's trash-padded page list chunk_pages [W]. The B + C rows run
    as one batch through the projections, rope and MLP; per layer the
    decode tokens' KV is written, then the chunk's pages, then one ragged
    attention serves both. -> (decode logits [B, V], logits [V] at the
    chunk's last valid token)."""
    cfg = model.cfg
    b, c = tokens.shape[0], chunk_tokens.shape[0]
    dev = tokens.device
    rope = _ropes(cfg, torch.cat([positions.to(dev).long(),
                                  chunk_start + torch.arange(c, device=dev)]))
    first = chunk_start // page_size
    write_pages = chunk_pages[first:first + c // page_size]
    x = _embed_rows(model, torch.cat([tokens.long(), chunk_tokens.long()]))
    slots = None
    if lora is not None:
        slots = torch.cat([_row_slots(lora, adapter_slots, b, dev),
                           _row_slots(lora, chunk_adapter_slot, c, dev)])
    rows = _slot_rows(lora, slots, model.dtype)
    mask = _token_mask(cfg, c, chunk_len, dev, lead=b)
    for l, layer in enumerate(model.layers):
        kp, vp = k_pages[l], v_pages[l]

        def attend(q, k, v, **mods):
            att.write_kv_token(kp, vp, k[:b], v[:b], block_tables, positions,
                               page_size=page_size)
            att.write_kv_prefill(kp, vp, k[b:], v[b:], write_pages,
                                 page_size=page_size)
            return attn.ragged(q, kp, vp, block_tables, context_lens,
                               chunk_pages, chunk_start, page_size=page_size,
                               num_kv_heads=cfg.cache_kv_heads, num_decode=b,
                               **mods)

        x = _layer(cfg, layer, x, rope, attend, lora, l, rows, mask)
    logits = _logits(model, torch.cat([x[:b], x[b + chunk_len - 1][None]]))
    return logits[:b], logits[b]


def _verify_rows(positions: torch.Tensor, block_tables: torch.Tensor,
                 room: torch.Tensor, k1: int):
    """The room contract of a verify window's KV writes (JAX
    `decode_verify`): row j of slot b writes position positions[b] + j
    through the slot's table, except that the draft rows (j >= 1) of a
    slot without room go to the trash page at position 0. Room is what
    keeps every write inside the block table: torch indexing past the
    table raises, and inside a graph replay that device-side assert
    poisons the CUDA context. -> (positions [B*K1] int64, tables
    [B*K1, Pmax])."""
    dev = positions.device
    j = torch.arange(k1, device=dev)
    pos = positions.long()[:, None] + j[None, :]
    valid = ((j[None, :] == 0) | room.to(dev)[:, None]).reshape(-1)
    pos = pos.reshape(-1)
    pos = torch.where(valid, pos, torch.zeros_like(pos))
    tables = torch.where(valid[:, None],
                         block_tables.repeat_interleave(k1, dim=0),
                         torch.zeros_like(block_tables[:1]))
    return pos, tables


def decode_verify(model: Llama, tokens: torch.Tensor, positions: torch.Tensor,
                  block_tables: torch.Tensor, room: torch.Tensor,
                  k_pages: torch.Tensor, v_pages: torch.Tensor, *,
                  page_size: int, attn: att.AttentionFns = att.DISPATCH,
                  lora: Optional[lora_apply.Stacks] = None,
                  adapter_slots: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """The speculative verify step (JAX `decode_verify`): tokens [B, K1],
    each slot's current token and K drafts, at positions [B] + j, through
    one forward -> logits [B, K1, V] at every window position. The K1
    tokens' KV is written before attention (`_verify_rows`: a slot
    without room [B] writes only its current token); rejected drafts
    leave KV past the accepted context, which later steps mask and
    overwrite."""
    cfg = model.cfg
    b, k1 = tokens.shape
    flat_pos, flat_tables = _verify_rows(positions, block_tables, room, k1)
    rope = _ropes(cfg, flat_pos)
    slots = None
    if lora is not None:  # each window repeats its sequence's slot
        slots = _row_slots(lora, adapter_slots, b,
                           tokens.device).repeat_interleave(k1)
    x = _embed_rows(model, tokens.reshape(b * k1))
    rows = _slot_rows(lora, slots, model.dtype)
    for l, layer in enumerate(model.layers):
        kp, vp = k_pages[l], v_pages[l]

        def attend(q, k, v, **mods):
            att.write_kv_token(kp, vp, k, v, flat_tables, flat_pos,
                               page_size=page_size)
            o = attn.verify(q.view(b, k1, *q.shape[1:]), kp, vp,
                            block_tables, positions, page_size=page_size,
                            num_kv_heads=cfg.cache_kv_heads, **mods)
            return o.reshape(b * k1, *o.shape[2:])

        x = _layer(cfg, layer, x, rope, attend, lora, l, rows)
    return _logits(model, x).view(b, k1, -1)


def mixed_verify_step(model: Llama, tokens: torch.Tensor,
                      positions: torch.Tensor, block_tables: torch.Tensor,
                      room: torch.Tensor, chunk_tokens: torch.Tensor,
                      chunk_start: int, chunk_len: int,
                      chunk_pages: torch.Tensor, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, *, page_size: int,
                      attn: att.AttentionFns = att.DISPATCH,
                      lora: Optional[lora_apply.Stacks] = None,
                      adapter_slots: Optional[torch.Tensor] = None,
                      chunk_adapter_slot: int = 0):
    """ONE ragged step where every decode slot runs its verify window and
    one prefill chunk makes progress (JAX `mixed_verify_step`). The rows
    are windows first, [B*K1 verify rows | C chunk rows]; the verify rows
    are decode_verify's (its room contract), the chunk is mixed_step's,
    and one ragged attention (decode_q = K1) serves both per layer.
    -> (logits [B, K1, V], logits [V] at the chunk's last valid token)."""
    cfg = model.cfg
    b, k1 = tokens.shape
    n, c = b * k1, chunk_tokens.shape[0]
    dev = tokens.device
    flat_pos, flat_tables = _verify_rows(positions, block_tables, room, k1)
    rope = _ropes(cfg, torch.cat([flat_pos,
                                  chunk_start + torch.arange(c, device=dev)]))
    first = chunk_start // page_size
    write_pages = chunk_pages[first:first + c // page_size]
    x = _embed_rows(model, torch.cat([tokens.reshape(n).long(),
                                      chunk_tokens.long()]))
    slots = None
    if lora is not None:
        slots = torch.cat([
            _row_slots(lora, adapter_slots, b, dev).repeat_interleave(k1),
            _row_slots(lora, chunk_adapter_slot, c, dev)])
    rows = _slot_rows(lora, slots, model.dtype)
    mask = _token_mask(cfg, c, chunk_len, dev, lead=n)
    for l, layer in enumerate(model.layers):
        kp, vp = k_pages[l], v_pages[l]

        def attend(q, k, v, **mods):
            att.write_kv_token(kp, vp, k[:n], v[:n], flat_tables, flat_pos,
                               page_size=page_size)
            att.write_kv_prefill(kp, vp, k[n:], v[n:], write_pages,
                                 page_size=page_size)
            return attn.ragged_verify(
                q, kp, vp, block_tables, positions, chunk_pages, chunk_start,
                page_size=page_size, num_kv_heads=cfg.cache_kv_heads,
                num_verify=b, verify_width=k1, **mods)

        x = _layer(cfg, layer, x, rope, attend, lora, l, rows, mask)
    logits = _logits(model, torch.cat([x[:n], x[n + chunk_len - 1][None]]))
    return logits[:n].view(b, k1, -1), logits[n]
