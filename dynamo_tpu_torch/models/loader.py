"""Weights for the port's Llama: random init from a seed, or the JAX
package's parameter tree carried across array by array.

The JAX tree (`dynamo_tpu.models.llama.param_specs`) stacks every layer
weight on a leading layer axis and keeps heads as axes: embed [V, E],
wq [L, E, H, D], wk/wv [L, E, KV, D], wo [L, H, D, E], w_gate/w_up
[L, E, F], w_down [L, F, E], attn_norm/mlp_norm [L, E], final_norm [E],
lm_head [E, V] (untied models). `param_specs` below restates that contract
for the dense models the port serves, so both functions build from it.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.llama import Llama

Spec = Tuple[Tuple[int, ...], str, float]

# the per-layer weights, named as in the JAX tree
_LAYER_NAMES = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate",
                "w_up", "w_down")


def param_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    """name -> (JAX shape, kind, sigma) for a dense Llama; kind is
    "normal" (stddev sigma), "ones" or "zeros". Sigmas follow the JAX
    package: 1/sqrt(last JAX axis), 0.02 for the embedding and head."""
    e, h, kv, d, f, l = (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
                         cfg.head_dim, cfg.intermediate_size, cfg.num_layers)

    def w(shape, sigma=None):
        return (shape, "normal",
                sigma if sigma is not None else 1.0 / shape[-1] ** 0.5)

    p = {
        "embed": w((cfg.vocab_size, e), 0.02),
        "final_norm": ((e,), "ones", 0.0),
        "attn_norm": ((l, e), "ones", 0.0),
        "wq": w((l, e, h, d)),
        "wk": w((l, e, kv, d)),
        "wv": w((l, e, kv, d)),
        "wo": w((l, h, d, e)),
        "mlp_norm": ((l, e), "ones", 0.0),
    }
    if not cfg.tie_word_embeddings:
        p["lm_head"] = w((e, cfg.vocab_size), 0.02)
    p["w_gate"] = w((l, e, f))
    p["w_up"] = w((l, e, f))
    p["w_down"] = w((l, f, e))
    return p


def _targets(model: Llama):
    """(JAX name, layer index or None, port parameter) for every weight."""
    yield "embed", None, model.embed
    yield "final_norm", None, model.final_norm
    if model.lm_head is not None:
        yield "lm_head", None, model.lm_head
    for l, layer in enumerate(model.layers):
        for name in _LAYER_NAMES:
            yield name, l, getattr(layer, name)


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
    for name, _, param in _targets(model):
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
def from_jax_params(cfg: ModelConfig, params: Mapping[str, np.ndarray],
                    device="cuda", dtype: torch.dtype = torch.bfloat16
                    ) -> Llama:
    """Carry a JAX parameter tree (leaves as numpy arrays) into the port's
    modules: per-layer slices of the stacked weights, head axes flattened."""
    specs = param_specs(cfg)
    missing = set(specs) - set(params)
    extra = set(params) - set(specs)
    if missing or extra:
        raise ValueError(f"parameter tree does not match {cfg.name}: "
                         f"missing {sorted(missing)}, unexpected "
                         f"{sorted(extra)}")
    for name, (shape, _, _) in specs.items():
        if tuple(np.shape(params[name])) != shape:
            raise ValueError(f"{name}: expected {shape}, got "
                             f"{tuple(np.shape(params[name]))}")
    model = Llama(cfg, device, dtype)
    stacked = {name: torch.from_numpy(np.array(arr, dtype=np.float32))
               for name, arr in params.items()}  # writable f32 copies
    for name, layer, param in _targets(model):
        src = stacked[name] if layer is None else stacked[name][layer]
        param.copy_(src.reshape(param.shape).to(device=device, dtype=dtype))
    return model
