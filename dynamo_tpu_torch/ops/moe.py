"""Mixture-of-experts dispatch paths, in PyTorch.

Port of `dynamo_tpu/ops/moe.py`. The JAX package composes these in XLA
(they reach no Pallas kernel), so here they are plain PyTorch: matrix
products on cuBLAS (bf16) or `torch._int_mm` (w8a8), through
`models.quant`'s expert products. Two paths:

- `moe_mlp_dense`: every expert processes every token, the top-k combine
  matrix zeroes the rest. No gathers, no token drops; the right choice for
  small decode batches where dispatch overhead dominates. No shape depends
  on the routing, so the captured decode and verify steps take it.
- `moe_mlp_dropping`: capacity-based dispatch for prefill-sized token counts.
  Each expert gathers its top-C tokens by router weight (C = T*k/X * cf),
  computes only those, and adds the weighted outputs back to their tokens.
  FLOPs drop from T*X expert-MLPs to C*X ≈ T*k*cf — a 4x cut for Mixtral
  (X=8, k=2). Tokens past an expert's capacity are dropped (standard
  capacity-factor semantics); cf defaults to 1.25. Prefill-only and
  eager, as in JAX. The add-back is ordered: each token sums its experts'
  outputs in expert order, starting from zero, as XLA's scatter-add walks
  the updates (expert 0's slots first); `index_add_` on the card adds
  them with atomics in no fixed order, so two runs could differ by a
  unit of the working dtype.

The dense combine matrix [T, X] is the single interface between routing and
dispatch, so both paths share the router code in models/llama.py.

Expert weights are [X, E, F] (gate, up) and [X, F, E] (down), each a
tensor or a `quant.QTensor`; their storage is each expert's [out, in]
matrix, the HF layout (see `quant.operand_layout`), so that the dense
gate and up products over every expert are one matrix product.

Top-k keeps the lower index first among equal values, as
`jax.lax.top_k` does (a stable sort), so exact ties select the same
experts and tokens in both packages.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from dynamo_tpu_torch.models import quant


def top_k(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries along the last axis, largest first, lower
    index first among equal values (`jax.lax.top_k`'s order) ->
    (values, indices)."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_combine(logits: torch.Tensor, k: int, dtype: torch.dtype,
                 renormalize: bool = True,
                 scaling_factor: float = 1.0) -> torch.Tensor:
    """Router logits [T, X] -> dense combine matrix [T, X]: top-k gate
    weights scattered back, zeros elsewhere.

    renormalize=True (Mixtral/Qwen3 convention): softmax over the selected
    top-k logits, weights sum to 1. renormalize=False (DeepSeek-V2
    norm_topk_prob=false): the GLOBAL softmax probabilities of the selected
    experts, sum < 1, optionally scaled by routed_scaling_factor."""
    topv, topi = top_k(logits, k)
    if renormalize:
        weights = torch.softmax(topv, dim=-1)
    else:
        weights = torch.softmax(logits, dim=-1).gather(-1, topi)
    if scaling_factor != 1.0:
        weights = weights * scaling_factor
    weights = weights.to(dtype)  # [T, K]
    return torch.zeros(logits.shape, dtype=dtype,
                       device=logits.device).scatter_(-1, topi, weights)


def moe_mlp_dense(x: torch.Tensor, combine: torch.Tensor, w_gate, w_up,
                  w_down) -> torch.Tensor:
    """All experts see all tokens; combine zeroes non-selected outputs.
    x [T, E], combine [T, X] -> [T, E]."""
    act = quant.shared_activations(x, w_gate)
    g = quant.expert_rows(x, w_gate, act)  # "te,xef->txf"
    u = quant.expert_rows(x, w_up, act)
    # "txf,xfe->txe", computed expert-major: y [X, T, E]
    y = quant.expert_batch((F.silu(g) * u).transpose(0, 1), w_down)
    # "txe,tx->te"
    return torch.bmm(combine[:, None, :], y.transpose(0, 1))[:, 0]


def expert_capacity(num_tokens: int, num_experts: int, k: int,
                    capacity_factor: float) -> int:
    """Static per-expert token capacity (a multiple of 8, the JAX
    package's lane tiling, kept so that both drop the same tokens)."""
    c = int(num_tokens * k / num_experts * capacity_factor)
    c = max(8, -(-c // 8) * 8)  # round up to 8
    return min(c, num_tokens)


def moe_mlp_dropping(x: torch.Tensor, combine: torch.Tensor, w_gate, w_up,
                     w_down, *, capacity: int,
                     k: Optional[int] = None) -> torch.Tensor:
    """Capacity-based dispatch: each expert computes only its top-C tokens.
    x [T, E], combine [T, X] -> [T, E]. `k`: the most experts a token is
    routed to (num_experts_per_tok; None: every expert), so that the
    ordered add-back gathers [T, k, E], not [T, X, E]."""
    t, e = x.shape
    n_exp = combine.shape[1]
    # per-expert token selection by routing weight: [X, C] indices into T
    sel_w, sel_i = top_k(combine.t(), capacity)
    xg = x[sel_i]  # [X, C, E]
    act = quant.shared_activations(xg, w_gate, quant.EXPERT_BATCH_DIMS)
    g = quant.expert_batch(xg, w_gate, act)  # "xce,xef->xcf"
    u = quant.expert_batch(xg, w_up, act)
    y = quant.expert_batch(F.silu(g) * u, w_down)  # [X, C, E]
    # weight by routing prob; zero-weight slots (capacity padding for experts
    # with fewer selected tokens) contribute nothing
    y = y * sel_w[..., None].to(y.dtype)
    # slot [t, x]: the row of y holding expert x's output for token t
    # (each expert selects a token at most once), else the zero row
    # appended at X * C
    ys = torch.cat([y.reshape(-1, e), y.new_zeros((1, e))])
    slot = torch.full((t, n_exp), n_exp * capacity, dtype=torch.long,
                      device=x.device)
    experts = torch.arange(n_exp, device=x.device)[:, None].expand_as(sel_i)
    slot[sel_i.reshape(-1), experts.reshape(-1)] = torch.arange(
        n_exp * capacity, device=x.device)
    # each token's routed experts in expert order (nonzero weights first,
    # stably), then the sum over them in that order
    kk = n_exp if k is None else min(k, n_exp)
    routed = torch.sort((combine == 0).to(torch.uint8), dim=1,
                        stable=True).indices[:, :kk]
    parts = ys[slot.gather(1, routed)]  # [T, k, E]
    out = torch.zeros((t, e), dtype=y.dtype, device=x.device)
    for j in range(kk):
        out = out + parts[:, j]
    return out
