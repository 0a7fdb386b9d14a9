"""Weights for the port's Llama: a local safetensors checkpoint, random init
from a seed, or the JAX package's parameter tree carried across array by
array; optionally int8 (`models.quant`).

The JAX tree (`dynamo_tpu.models.llama.param_specs`) stacks every layer
weight on a leading layer axis and keeps heads as axes: embed [V, E],
wq [L, E, H, D], wk/wv [L, E, KV, D], wo [L, H, D, E], w_gate/w_up
[L, E, F], w_down [L, F, E], attn_norm/mlp_norm [L, E], final_norm [E],
lm_head [E, V] (untied models); bq [L, H, D] and bk/bv [L, KV, D]
(`attention_bias`), q_norm/k_norm [L, D] (`qk_norm`), post_attn_norm and
post_mlp_norm [L, E] (`post_norms`: Gemma-2/3's sandwich norms); for X experts
(`num_experts`) router [L, E, X], moe_w_gate/moe_w_up [L, X, E, F] and
moe_w_down [L, X, F, E], with w_gate/w_up/w_down only for shared experts
at width num_shared_experts * F; an MLA model (`kv_lora_rank` R, nope and
rope head dims N and P, value dim Dv) has wq_mla [L, E, H, N+P], w_kv_a
[L, E, R+P], kv_a_norm [L, R], w_uk [L, H, N, R], w_uv [L, H, R, Dv] and
wo [L, H, Dv, E] in place of wq/wk/wv/wo. `param_specs` below restates
that contract, and every function here that makes weights follows it.

`load_or_init` is the counterpart of the JAX package's
`load_or_init_params`: every `*.safetensors` under `model_path`
(`load_hf_safetensors`, HF tensor names), else seeded random init with a
warning; then quantization if asked. Loading is strictly local: nothing is
downloaded.
"""

from __future__ import annotations

import contextlib
import glob
import logging
import os
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from dynamo_tpu_torch.lora import apply as lora_apply
from dynamo_tpu_torch.models import quant
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.llama import Llama

log = logging.getLogger("dynamo_tpu_torch.loader")

Spec = Tuple[Tuple[int, ...], str, float]

# the per-layer weights, named as in the JAX tree; the optional ones after
# them, so that a config without them draws the same random weights
_ATTN_NAMES = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm")
_MLA_NAMES = ("attn_norm", "wq_mla", "w_kv_a", "kv_a_norm", "w_uk", "w_uv",
              "wo", "mlp_norm")  # kv_lora_rank, in place of _ATTN_NAMES
_MLP_NAMES = ("w_gate", "w_up", "w_down")  # dense, or shared experts
_BIAS_NAMES = ("bq", "bk", "bv")  # attention_bias
_QK_NORM_NAMES = ("q_norm", "k_norm")  # qk_norm
_POST_NORM_NAMES = ("post_attn_norm", "post_mlp_norm")  # post_norms
_MOE_NAMES = ("router",) + quant.EXPERT_NAMES  # num_experts


def _layer_names(cfg: ModelConfig) -> Tuple[str, ...]:
    dense_mlp = not cfg.is_moe or cfg.num_shared_experts > 0
    attn = _MLA_NAMES if cfg.is_mla else _ATTN_NAMES
    return (attn + (_MLP_NAMES if dense_mlp else ())
            + (_BIAS_NAMES if cfg.attention_bias else ())
            + (_QK_NORM_NAMES if cfg.qk_norm else ())
            + (_MOE_NAMES if cfg.is_moe else ())
            + (_POST_NORM_NAMES if cfg.post_norms else ()))


# above this many parameters a quantized model with no checkpoint is drawn
# as int8 directly instead of initialised and quantized (the JAX loader's
# threshold)
DIRECT_INT8_PARAMS = 2_000_000_000
# the standard deviation of int8 values uniform over [-127, 127]
UNIFORM_INT8_STD = ((255 ** 2 - 1) / 12) ** 0.5


def param_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    """name -> (JAX shape, kind, sigma); kind is "normal" (stddev sigma),
    "ones" or "zeros". Sigmas follow the JAX package: 1/sqrt(last JAX
    axis), 0.02 for the embedding, the head and the router; norms are
    zeros where they scale by 1 + w (`rms_norm_unit_offset`), biases
    zeros. MLA's names stand where JAX puts them, in place of wq..wo."""
    e, h, kv, d, f, l = (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
                         cfg.head_dim, cfg.intermediate_size, cfg.num_layers)

    def w(shape, sigma=None):
        return (shape, "normal",
                sigma if sigma is not None else 1.0 / shape[-1] ** 0.5)

    nk = "zeros" if cfg.rms_norm_unit_offset else "ones"
    p = {
        "embed": w((cfg.vocab_size, e), 0.02),
        "final_norm": ((e,), nk, 0.0),
        "attn_norm": ((l, e), nk, 0.0),
    }
    if cfg.is_mla:
        nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        r, vd = cfg.kv_lora_rank, cfg.v_head_dim
        p["wq_mla"] = w((l, e, h, nope + rope))
        p["w_kv_a"] = w((l, e, r + rope))
        p["kv_a_norm"] = ((l, r), "ones", 0.0)
        p["w_uk"] = w((l, h, nope, r))
        p["w_uv"] = w((l, h, r, vd))
        p["wo"] = w((l, h, vd, e))
    else:
        p["wq"] = w((l, e, h, d))
        p["wk"] = w((l, e, kv, d))
        p["wv"] = w((l, e, kv, d))
        p["wo"] = w((l, h, d, e))
    p["mlp_norm"] = ((l, e), nk, 0.0)
    if cfg.post_norms:
        p["post_attn_norm"] = ((l, e), nk, 0.0)
        p["post_mlp_norm"] = ((l, e), nk, 0.0)
    if not cfg.tie_word_embeddings:
        p["lm_head"] = w((e, cfg.vocab_size), 0.02)
    if cfg.is_moe:
        x = cfg.num_experts
        p["router"] = w((l, e, x), 0.02)
        p["moe_w_gate"] = w((l, x, e, f))
        p["moe_w_up"] = w((l, x, e, f))
        p["moe_w_down"] = w((l, x, f, e))
        f = cfg.num_shared_experts * f  # the shared experts' width
    if f:
        p["w_gate"] = w((l, e, f))
        p["w_up"] = w((l, e, f))
        p["w_down"] = w((l, f, e))
    if cfg.attention_bias:
        p["bq"] = ((l, h, d), "zeros", 0.0)
        p["bk"] = ((l, kv, d), "zeros", 0.0)
        p["bv"] = ((l, kv, d), "zeros", 0.0)
    if cfg.qk_norm:
        p["q_norm"] = ((l, d), nk, 0.0)
        p["k_norm"] = ((l, d), nk, 0.0)
    return p


def num_params(cfg: ModelConfig) -> int:
    """Parameters of the model, counted from its specs (nothing is
    allocated); every expert counts."""
    return sum(int(np.prod(shape)) for shape, _, _ in
               param_specs(cfg).values())


def _targets(model: Llama):
    """(JAX name, layer index or None, owner module) for every weight; the
    port's attribute on the owner has the JAX name."""
    yield "embed", None, model
    yield "final_norm", None, model
    if model.lm_head is not None:
        yield "lm_head", None, model
    names = _layer_names(model.cfg)
    for l, layer in enumerate(model.layers):
        for name in names:
            yield name, l, layer


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _scale_shape(name: str, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """A QTensor's scale in the port's layout: embed's per row, an expert
    stack's per expert and output column, the other weights' per output
    column."""
    if name in quant.EXPERT_NAMES:
        return (shape[0], 1, shape[2])
    return (shape[0], 1) if name == "embed" else (1, shape[1])


def _check_filled(model: Llama) -> Llama:
    left = [n for n, t in (*model.named_parameters(),
                           *model.named_buffers()) if t.is_meta]
    if left:
        raise ValueError(f"weights never set: {left}")
    return model


@torch.no_grad()
def init_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                dtype: torch.dtype = torch.bfloat16) -> Llama:
    """Random weights with the JAX package's shapes and sigmas, drawn in
    f32 from a `torch.Generator` on `device` and cast to `dtype` (the bits
    differ from JAX's threefry draws)."""
    specs = param_specs(cfg)
    model = Llama(cfg, device, dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for name, _, owner in _targets(model):
        param = getattr(owner, name)
        _, kind, sigma = specs[name]
        if kind == "ones":
            param.fill_(1.0)
        elif kind == "zeros":
            param.zero_()
        else:
            draw = torch.randn(param.shape, generator=gen, device=device,
                               dtype=torch.float32)
            param.copy_(draw.mul_(sigma))
    return model


@torch.no_grad()
def random_quantized_params(cfg: ModelConfig, seed: int = 0,
                            mode: str = "int8", device="cuda",
                            dtype: torch.dtype = torch.bfloat16) -> Llama:
    """Seeded random int8 weights built directly as QTensors, the JAX
    loader's `random_quantized_params`: int8 values uniform over
    [-127, 127] from a `torch.Generator` on `device`, per-channel scales
    sigma / UNIFORM_INT8_STD, so that the dequantized weights' standard
    deviation is each spec's sigma (the JAX loader's sigma * 4.5 / 127
    puts amax at 4.5 sigma, as a normal draw's, but a uniform draw's
    standard deviation is then 2.6 sigma: products through several such
    weights grow layer by layer, and attention scores saturate), norms
    and biases their constants in `dtype`, the MoE router drawn normal in
    `dtype` (it is not quantized); no float copy of the model is ever
    made."""
    if mode not in quant.MODES:
        raise ValueError(f"unknown quantization mode {mode!r}")
    specs = param_specs(cfg)
    model = Llama(cfg, "meta", dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for name, _, owner in _targets(model):
        shape = tuple(getattr(owner, name).shape)
        _, kind, sigma = specs[name]
        if kind != "normal":
            fill = torch.ones if kind == "ones" else torch.zeros
            quant.set_weight(owner, name,
                             _param(fill(shape, device=device, dtype=dtype)))
            continue
        if name not in quant.QUANT_AXES:  # the router: small, stays float
            draw = torch.randn(shape, generator=gen, device=device,
                               dtype=torch.float32)
            quant.set_weight(owner, name, _param(draw.mul_(sigma).to(dtype)))
            continue
        # matmul weights (each expert's) drawn as their [N, K]
        # transposes: the operand layout (quant.operand_layout); embed
        # row-major
        draw = (shape if name == "embed"
                else (*shape[:-2], shape[-1], shape[-2]))
        q = torch.randint(-127, 128, draw, generator=gen, device=device,
                          dtype=torch.int8)
        q = q if name == "embed" else q.transpose(-2, -1)
        scale = torch.full(_scale_shape(name, shape),
                           sigma / UNIFORM_INT8_STD, device=device,
                           dtype=torch.float32)
        quant.set_weight(owner, name, quant.QTensor(q, scale, mode))
    return _check_filled(model)


@torch.no_grad()
def from_jax_params(cfg: ModelConfig, params: Mapping[str, object],
                    device="cuda", dtype: torch.dtype = torch.bfloat16,
                    quantization: Optional[str] = "none") -> Llama:
    """Carry a JAX parameter tree (leaves as numpy arrays) into the port's
    modules: per-layer slices of the stacked weights, head axes flattened.

    A quantized leaf (anything with `.q` and `.scale`, such as the JAX
    package's QTensor after `jax.tree.map(np.asarray, ...)`) carries its
    int8 values and scales across as they are, and `quantization` names
    their mode ("int8" or "w8a8"); a float tree with `quantization` set is
    quantized in the port (`quant.quantize_params`). The LoRA stacks of a
    tree that has them (`lora_{t}{a,b}`) are accepted and not carried: an
    engine's adapters live in its registry's stacks, and
    `lora.apply.Stacks.from_arrays` builds a forward's `lora` argument
    from such a tree."""
    mode = quant.mode_name(quantization)
    specs = param_specs(cfg)
    missing = set(specs) - set(params)
    extra = set(params) - set(specs) - set(lora_apply.STACK_NAMES)
    if missing or extra:
        raise ValueError(f"parameter tree does not match {cfg.name}: "
                         f"missing {sorted(missing)}, unexpected "
                         f"{sorted(extra)}")

    def is_q(leaf) -> bool:
        return hasattr(leaf, "q") and hasattr(leaf, "scale")

    for name, (shape, _, _) in specs.items():
        leaf = params[name]
        got = tuple(np.shape(leaf.q if is_q(leaf) else leaf))
        if got != shape:
            raise ValueError(f"{name}: expected {shape}, got {got}")
    carried = any(is_q(leaf) for leaf in params.values())
    if carried and mode == "none":
        raise ValueError("the parameter tree holds quantized weights: pass "
                         "quantization='int8' or 'w8a8'")
    model = Llama(cfg, "meta", dtype)

    def tensor(arr, as_dtype=np.float32) -> torch.Tensor:
        return torch.from_numpy(np.array(arr, dtype=as_dtype))

    for name, layer, owner in _targets(model):
        shape = tuple(getattr(owner, name).shape)
        leaf = params[name]
        if is_q(leaf):
            q, s = tensor(leaf.q, np.int8), tensor(leaf.scale)
            if layer is not None:
                q, s = q[layer], s[layer]
            q = q.reshape(shape).to(device)
            if name != "embed":
                q = quant.operand_layout(q)
            s = s.reshape(_scale_shape(name, shape)).to(device)
            quant.set_weight(owner, name, quant.QTensor(q, s, mode))
            continue
        src = tensor(leaf)
        src = src if layer is None else src[layer]
        src = src.reshape(shape).to(device=device, dtype=dtype)
        if name in quant.EXPERT_NAMES:
            src = quant.operand_layout(src)
        quant.set_weight(owner, name, _param(src))
    _check_filled(model)
    if not carried and mode != "none":
        quant.quantize_params(model, mode)
    return model


def _read_safetensors(files: Sequence[str], stack: contextlib.ExitStack):
    """name -> a function that reads that tensor (a CPU torch tensor) from
    its file, for every `model.*` and `lm_head.*` tensor of `files`."""
    from safetensors import safe_open

    readers = {}
    for path in files:
        fh = stack.enter_context(safe_open(path, framework="pt"))
        for name in fh.keys():
            if name.startswith(("model.", "lm_head.")):
                readers[name] = (lambda fh=fh, name=name:
                                 fh.get_tensor(name))
    return readers


@torch.no_grad()
def load_hf_safetensors(cfg: ModelConfig, files: Sequence[str],
                        device="cuda",
                        dtype: torch.dtype = torch.bfloat16) -> Llama:
    """HF-layout tensors (`model.layers.{i}.self_attn.q_proj.weight`, ...)
    into the port's layout, the JAX loader's `load_hf_safetensors`:
    Gemma-2/3's four norms (`input_layernorm`, then, where HF's
    `post_attention_layernorm` is really post-attention,
    `pre_feedforward_layernorm` as the pre-MLP norm and
    `post_{attention,feedforward}_layernorm` as the branch outputs' norms),
    DeepSeek-V2's MLA projections (`q_proj` and `kv_a_proj_with_mqa` with
    their interleaved rope lanes de-interleaved for the half-split rope,
    `kv_a_layernorm`, `kv_b_proj` split per head into W_UK and W_UV,
    `o_proj`), separate q/k/v/o projections or Phi-3's fused `qkv_proj` and
    `gate_up_proj`, the norms, `lm_head` for untied models, Qwen2's
    `self_attn.{q,k,v}_proj.bias`, Qwen3's `self_attn.{q,k}_norm.weight`,
    and MoE layers in both upstream layouts: Mixtral's
    `block_sparse_moe.gate` and `experts.{j}.w1/w3/w2`, Qwen3-MoE's
    `mlp.gate` and `mlp.experts.{j}.gate_proj/up_proj/down_proj`, with
    DeepSeek's `shared_experts` beside them. Each tensor is read once,
    cast to `dtype` and transposed from HF's [out, in] to the port's
    [in, out] on `device` (vectors as they are); an expert stack keeps
    each expert's [out, in] as its storage (`quant.operand_layout`)."""
    h, kv, d, f = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                   cfg.intermediate_size)
    model = Llama(cfg, "meta", dtype)

    with contextlib.ExitStack() as stack:
        readers = _read_safetensors(files, stack)

        def get(name: str) -> torch.Tensor:
            try:
                read = readers.pop(name)
            except KeyError:
                raise ValueError(f"checkpoint has no tensor {name!r}") from None
            return read().to(device=device, dtype=dtype)

        def put(owner, name: str, t: torch.Tensor) -> None:
            quant.set_weight(owner, name, _param(t.contiguous()))

        put(model, "embed", get("model.embed_tokens.weight"))
        put(model, "final_norm", get("model.norm.weight"))
        fused_qkv = "model.layers.0.self_attn.qkv_proj.weight" in readers
        fused_mlp = "model.layers.0.mlp.gate_up_proj.weight" in readers
        if cfg.is_moe:
            moe_base, expert_names = _moe_layout(readers)
        for i, layer in enumerate(model.layers):
            pre = f"model.layers.{i}."
            put(layer, "attn_norm", get(pre + "input_layernorm.weight"))
            if cfg.post_norms:  # Gemma-2/3: the sandwich norms
                put(layer, "mlp_norm",
                    get(pre + "pre_feedforward_layernorm.weight"))
                put(layer, "post_attn_norm",
                    get(pre + "post_attention_layernorm.weight"))
                put(layer, "post_mlp_norm",
                    get(pre + "post_feedforward_layernorm.weight"))
            else:  # llama's post_attention_layernorm is the pre-MLP norm
                put(layer, "mlp_norm",
                    get(pre + "post_attention_layernorm.weight"))
            if cfg.is_mla:
                _put_mla(cfg, layer, pre, get, put)
            elif fused_qkv:  # Phi-3: rows q, then k, then v
                w = get(pre + "self_attn.qkv_proj.weight")
                put(layer, "wq", w[:h * d].t())
                put(layer, "wk", w[h * d:(h + kv) * d].t())
                put(layer, "wv", w[(h + kv) * d:].t())
            else:
                for name, hf in (("wq", "q_proj"), ("wk", "k_proj"),
                                 ("wv", "v_proj")):
                    put(layer, name, get(pre + f"self_attn.{hf}.weight").t())
            if not cfg.is_mla:
                put(layer, "wo", get(pre + "self_attn.o_proj.weight").t())
            if cfg.is_moe:
                base = pre + moe_base + "."
                put(layer, "router", get(base + "gate.weight").t())
                for name, hf in zip(quant.EXPERT_NAMES, expert_names):
                    stack = torch.stack([
                        get(f"{base}experts.{j}.{hf}.weight")
                        for j in range(cfg.num_experts)])  # [X, out, in]
                    quant.set_weight(layer, name,
                                     _param(stack.transpose(1, 2)))
                if cfg.num_shared_experts > 0:
                    for name, hf in zip(_MLP_NAMES, ("gate_proj", "up_proj",
                                                     "down_proj")):
                        put(layer, name, get(
                            f"{base}shared_experts.{hf}.weight").t())
            else:
                if fused_mlp:  # Phi-3: rows gate, then up
                    w = get(pre + "mlp.gate_up_proj.weight")
                    put(layer, "w_gate", w[:f].t())
                    put(layer, "w_up", w[f:].t())
                else:
                    put(layer, "w_gate",
                        get(pre + "mlp.gate_proj.weight").t())
                    put(layer, "w_up", get(pre + "mlp.up_proj.weight").t())
                put(layer, "w_down", get(pre + "mlp.down_proj.weight").t())
            if cfg.attention_bias:
                for name, hf in (("bq", "q_proj"), ("bk", "k_proj"),
                                 ("bv", "v_proj")):
                    put(layer, name, get(pre + f"self_attn.{hf}.bias"))
            if cfg.qk_norm:
                for name in _QK_NORM_NAMES:
                    put(layer, name, get(pre + f"self_attn.{name}.weight"))
        if not cfg.tie_word_embeddings:
            put(model, "lm_head", get("lm_head.weight").t())
    return _check_filled(model)


def _put_mla(cfg: ModelConfig, layer, pre: str, get, put) -> None:
    """One layer's DeepSeek-V2 attention tensors into the MLA weights (the
    JAX loader's MLA branch). The checkpoint interleaves each rope part's
    lanes (pair 2i, 2i + 1 rotates together); the port's rope is
    half-split, so the rope rows of q_proj and kv_a_proj_with_mqa take
    the de-interleaving order (evens, then odds) once, here. kv_b_proj
    [H*(N+Dv), R] holds each head's W_UK^T rows, then its W_UV^T rows."""
    e, h = cfg.hidden_size, cfg.num_heads
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    r, vd = cfg.kv_lora_rank, cfg.v_head_dim
    deint = torch.cat([torch.arange(0, rope, 2), torch.arange(1, rope, 2)])
    w = get(pre + "self_attn.q_proj.weight").view(h, nope + rope, e)
    w = torch.cat([w[:, :nope], w[:, nope + deint.to(w.device)]], dim=1)
    put(layer, "wq_mla", w.reshape(h * (nope + rope), e).t())
    w = get(pre + "self_attn.kv_a_proj_with_mqa.weight")  # [R + P, E]
    put(layer, "w_kv_a", torch.cat([w[:r], w[r + deint.to(w.device)]]).t())
    put(layer, "kv_a_norm", get(pre + "self_attn.kv_a_layernorm.weight"))
    b = get(pre + "self_attn.kv_b_proj.weight").view(h, nope + vd, r)
    put(layer, "w_uk", b[:, :nope])
    put(layer, "w_uv", b[:, nope:].transpose(1, 2))
    put(layer, "wo", get(pre + "self_attn.o_proj.weight").t())


def _moe_layout(readers) -> Tuple[str, Tuple[str, str, str]]:
    """(the MoE block's name under a layer, the HF names of the gate, up
    and down experts) of a checkpoint: Mixtral's `block_sparse_moe` with
    w1/w3/w2, or Qwen3-MoE's `mlp` with gate/up/down_proj (the JAX
    loader's two schemes)."""
    if ("model.layers.0.mlp.gate_proj.weight" in readers
            and "model.layers.0.mlp.gate.weight" not in readers):
        # DeepSeek's first_k_dense_replace layout: layer 0 is a plain
        # dense FFN while later layers are MoE, which one layer class
        # cannot hold
        raise ValueError(
            "checkpoint has a dense first layer (first_k_dense_replace); "
            "heterogeneous layer stacks are not supported yet")
    if "model.layers.0.block_sparse_moe.gate.weight" in readers:
        return "block_sparse_moe", ("w1", "w3", "w2")
    return "mlp", ("gate_proj", "up_proj", "down_proj")


def checkpoint_files(model_path: Optional[str]) -> list:
    """The `*.safetensors` files directly under `model_path` (sorted; none
    if it is not a directory)."""
    if not (model_path and os.path.isdir(model_path)):
        return []
    return sorted(glob.glob(os.path.join(model_path, "*.safetensors")))


def load_or_init(cfg: ModelConfig, model_path: Optional[str], seed: int = 0,
                 quantization: Optional[str] = "none", device="cuda",
                 dtype: torch.dtype = torch.bfloat16) -> Llama:
    """The checkpoint under `model_path` if it holds `*.safetensors`, else
    (with a warning when the directory exists) seeded random init; then
    int8 for quantization "int8" or "w8a8". With no checkpoint and more
    than DIRECT_INT8_PARAMS parameters, the int8 weights are drawn
    directly (`random_quantized_params`); smaller models are initialised
    and quantized, so that int8 stays comparable with the float model."""
    mode = quant.mode_name(quantization)
    files = checkpoint_files(model_path)
    if model_path and os.path.isdir(model_path) and not files:
        log.warning("no safetensors under %s; using random init", model_path)
    if mode != "none" and not files and num_params(cfg) > DIRECT_INT8_PARAMS:
        return random_quantized_params(cfg, seed, mode, device, dtype)
    if files:
        model = load_hf_safetensors(cfg, files, device, dtype)
    else:
        model = init_params(cfg, seed, device, dtype)
    return quant.quantize_params(model, mode)
