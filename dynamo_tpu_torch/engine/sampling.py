"""Token sampling: greedy / temperature / top-k / top-p / min_p, OpenAI
logit_bias and presence/frequency penalties, optional logprobs.

Port of `dynamo_tpu/engine/sampling.py`. Every parameter is a per-slot
tensor so one call serves a heterogeneous batch; which optional passes run
is decided on the host from the same values (`SamplingState` carries the
gates), so the common all-greedy batch is one argmax with no device sync.

Randomness: a request owns a 63-bit chain root (its `seed`, or a draw from
the engine's generator), and the prediction made from position p samples
with Gumbel noise from a `torch.Generator` seeded with `fold_in(root, p)`.
Sampling is therefore deterministic per request whatever else is in the
batch, and across preemption, as in the JAX package, whose `fold_in` over
threefry keys it mirrors. The bits differ from JAX's: seeded streams match
the JAX package's in distribution, not token for token.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from dynamo_tpu_torch.engine.request import BIAS_K  # noqa: F401 (re-export)

_MASK64 = (1 << 64) - 1


class SamplingState(NamedTuple):
    temperature: torch.Tensor  # [B] float32; 0 -> greedy
    top_p: torch.Tensor  # [B] float32 in (0, 1]
    top_k: torch.Tensor  # [B] int64; 0 -> disabled
    presence_penalty: torch.Tensor  # [B] float32; 0 -> off
    frequency_penalty: torch.Tensor  # [B] float32; 0 -> off
    min_p: torch.Tensor  # [B] float32 in [0, 1); 0 -> disabled
    bias_ids: torch.Tensor  # [B, BIAS_K] int64 token ids; -1 -> empty lane
    bias_vals: torch.Tensor  # [B, BIAS_K] float32 logit biases
    # host-side gates over the same values
    sampled_rows: Tuple[int, ...]  # slots with temperature > 0
    all_greedy: bool
    any_bias: bool
    any_penalty: bool
    any_topk_topp: bool
    any_min_p: bool


def make_state(temperature, top_p, top_k, presence=None, frequency=None,
               min_p=None, bias_ids=None, bias_vals=None,
               device="cpu") -> SamplingState:
    """Build a SamplingState from host arrays (numpy or lists), defaulting
    penalties, min_p and bias to off."""
    temperature = np.asarray(temperature, np.float32)
    b = temperature.shape[0]
    top_p = np.asarray(top_p, np.float32)
    top_k = np.asarray(top_k, np.int64)
    zeros = np.zeros((b,), np.float32)
    presence = zeros if presence is None else np.asarray(presence, np.float32)
    frequency = (zeros if frequency is None
                 else np.asarray(frequency, np.float32))
    min_p = zeros if min_p is None else np.asarray(min_p, np.float32)
    bias_ids = (np.full((b, BIAS_K), -1, np.int64) if bias_ids is None
                else np.asarray(bias_ids, np.int64))
    bias_vals = (np.zeros((b, BIAS_K), np.float32) if bias_vals is None
                 else np.asarray(bias_vals, np.float32))

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return SamplingState(
        dev(temperature), dev(top_p), dev(top_k), dev(presence),
        dev(frequency), dev(min_p), dev(bias_ids), dev(bias_vals),
        sampled_rows=tuple(int(b) for b in np.flatnonzero(temperature > 0.0)),
        all_greedy=bool((temperature <= 0.0).all()),
        any_bias=bool((bias_ids >= 0).any()),
        any_penalty=bool(((presence != 0.0) | (frequency != 0.0)).any()),
        any_topk_topp=bool(((top_k > 0) | (top_p < 1.0)).any()),
        any_min_p=bool((min_p > 0.0).any()),
    )


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fold_in(key: int, data: int) -> int:
    """Derive the step seed for position `data` of chain root `key`."""
    return _splitmix64(int(key) ^ _splitmix64(int(data) & _MASK64)) >> 1


def fold_positions(keys: Sequence[int], positions: Sequence[int]):
    """Per-slot step seeds: fold_in(key[b], position[b])."""
    return [fold_in(k, p) for k, p in zip(keys, positions)]


def _penalized(logits: torch.Tensor, state: SamplingState,
               counts: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply logit_bias then presence/frequency penalties; return
    (logits32, greedy). The bias lands BEFORE the greedy argmax: OpenAI's
    logit_bias steers greedy decoding too."""
    logits = logits.to(torch.float32)
    if state.any_bias:
        v = logits.shape[1]
        ids = state.bias_ids.clamp(0, v - 1)
        # empty lanes (-1) and out-of-vocab ids add nothing
        valid = (state.bias_ids >= 0) & (state.bias_ids < v)
        vals = torch.where(valid, state.bias_vals,
                           torch.zeros_like(state.bias_vals))
        rows = torch.arange(logits.shape[0], device=logits.device)[:, None]
        logits = logits.index_put((rows.expand_as(ids), ids), vals,
                                  accumulate=True)
    if counts is not None and state.any_penalty:
        cf = counts.to(torch.float32)
        logits = (logits
                  - state.presence_penalty[:, None] * (cf > 0)
                  - state.frequency_penalty[:, None] * cf)
    # torch.argmax returns the first maximal index, as jnp.argmax does
    return logits, logits.argmax(dim=-1)


def _mask_min_p(scaled: torch.Tensor, state: SamplingState) -> torch.Tensor:
    """min_p (vLLM semantics): keep tokens whose probability is >= min_p
    times the most likely token's, under the temperature-scaled
    distribution."""
    probs = torch.softmax(scaled, dim=-1)
    floor = state.min_p[:, None] * probs.max(dim=-1, keepdim=True).values
    return scaled.masked_fill(probs < floor, float("-inf"))


def _mask_topk_topp(scaled: torch.Tensor, state: SamplingState
                    ) -> torch.Tensor:
    """Top-k, then top-p (nucleus) over the full vocabulary."""
    v = scaled.shape[1]
    sorted_desc = scaled.sort(dim=-1, descending=True).values
    k = torch.where(state.top_k <= 0, torch.full_like(state.top_k, v),
                    state.top_k).clamp(1, v)
    kth = sorted_desc.gather(1, (k - 1)[:, None])
    scaled = scaled.masked_fill(scaled < kth, float("-inf"))
    # keep the smallest prefix of the sorted distribution whose mass
    # before each kept token is < top_p
    sorted2 = scaled.sort(dim=-1, descending=True).values
    probs_sorted = torch.softmax(sorted2, dim=-1)
    cum = probs_sorted.cumsum(dim=-1)
    keep_sorted = (cum - probs_sorted) < state.top_p[:, None]
    num_keep = keep_sorted.sum(dim=-1).clamp_min(1)
    thresh = sorted2.gather(1, (num_keep - 1)[:, None])
    return scaled.masked_fill(scaled < thresh, float("-inf"))


def _gumbel(seeds: Sequence[int], rows: Sequence[int], shape,
            device) -> torch.Tensor:
    """Gumbel noise [B, V]: row b from a generator seeded with seeds[b]
    for b in `rows`, zeros elsewhere."""
    noise = torch.zeros(shape, dtype=torch.float32, device=device)
    tiny = torch.finfo(torch.float32).tiny
    for b in rows:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seeds[b]))
        u = torch.rand(shape[1], generator=gen, device=device,
                       dtype=torch.float32).clamp_min(tiny)
        noise[b] = -torch.log(-torch.log(u))
    return noise


def sample(logits: torch.Tensor, state: SamplingState, seeds: Sequence[int],
           counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B] sampled token ids (int64): Gumbel-max with per-slot step seeds
    (see fold_in). An all-greedy batch is one argmax."""
    logits32, greedy = _penalized(logits, state, counts)
    if state.all_greedy:
        return greedy
    scaled = logits32 / state.temperature.clamp_min(1e-6)[:, None]
    if state.any_topk_topp:
        scaled = _mask_topk_topp(scaled, state)
    if state.any_min_p:
        scaled = _mask_min_p(scaled, state)
    noise = _gumbel(seeds, state.sampled_rows, scaled.shape, scaled.device)
    sampled = (scaled + noise).argmax(dim=-1)
    return torch.where(state.temperature <= 0.0, greedy, sampled)


def sample_with_logprobs(logits: torch.Tensor, state: SamplingState,
                         seeds: Sequence[int],
                         counts: Optional[torch.Tensor] = None,
                         num_top: int = 5):
    """sample() plus the chosen token's logprob and the top-`num_top`
    alternatives, from the UNPENALIZED distribution at temperature 1 (the
    OpenAI contract: logprobs describe the model, not the sampler)."""
    tokens = sample(logits, state, seeds, counts)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    chosen = logp.gather(1, tokens[:, None])[:, 0]
    top_vals, top_ids = logp.topk(min(num_top, logp.shape[-1]), dim=-1)
    return tokens, chosen, top_ids, top_vals
