"""Token sampling: greedy / temperature / top-k / top-p / min_p, OpenAI
logit_bias and presence/frequency penalties, optional logprobs.

Port of `dynamo_tpu/engine/sampling.py`. Every parameter is a per-slot
tensor so one call serves a heterogeneous batch; which optional passes run
is decided on the host from the same values (`SamplingState` carries the
gates), so the common all-greedy batch is one argmax with no device sync.
The gates are the only host input: a captured decode window
(`engine/decode_graphs.py`) is keyed by them.

Randomness: a request owns a 63-bit chain root (its `seed`, or a draw from
the engine's generator), and the prediction made from position p samples
with Gumbel noise keyed by `fold_in(root, p)`. The noise is counter-based
integer arithmetic on the device: the bits of vocabulary entry v are
`_hash32` rounds over (row key, v), so a window that never reads its
positions back to the host draws them, and the bits are the same on the
CPU and the card (every intermediate stays below 2**59 in int64, where
signed overflow would not be portable). Sampling is therefore
deterministic per request whatever else is in the batch, whatever the
window length, and across preemption, as in the JAX package, whose
`fold_in` over threefry keys it mirrors. The bits differ from JAX's:
seeded streams match the JAX package's in distribution, not token for
token.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from dynamo_tpu_torch.engine.request import BIAS_K  # noqa: F401 (re-export)

_M32 = 0xFFFFFFFF
_HASH_MUL = 0x45D9F3B  # < 2**27: a 32-bit value times it stays < 2**59
_ROW_SALT = 0x2545F491
Keys = Union[torch.Tensor, Sequence[int]]


class SamplingState(NamedTuple):
    temperature: torch.Tensor  # [B] float32; 0 -> greedy
    top_p: torch.Tensor  # [B] float32 in (0, 1]
    top_k: torch.Tensor  # [B] int64; 0 -> disabled
    presence_penalty: torch.Tensor  # [B] float32; 0 -> off
    frequency_penalty: torch.Tensor  # [B] float32; 0 -> off
    min_p: torch.Tensor  # [B] float32 in [0, 1); 0 -> disabled
    bias_ids: torch.Tensor  # [B, BIAS_K] int64 token ids; -1 -> empty lane
    bias_vals: torch.Tensor  # [B, BIAS_K] float32 logit biases
    # host-side gates over the same values (see gates())
    all_greedy: bool
    any_bias: bool
    any_penalty: bool
    any_topk_topp: bool
    any_min_p: bool


def gates(temperature, top_p, top_k, presence, frequency, min_p,
          bias_ids) -> Tuple[bool, bool, bool, bool, bool]:
    """(all_greedy, any_bias, any_penalty, any_topk_topp, any_min_p) of
    host arrays; an all-greedy batch runs no temperature pass, so its
    top-k/top-p and min_p gates are off whatever the rows hold."""
    temperature = np.asarray(temperature)
    all_greedy = bool((temperature <= 0.0).all())
    return (all_greedy,
            bool((np.asarray(bias_ids) >= 0).any()),
            bool(((np.asarray(presence) != 0.0)
                  | (np.asarray(frequency) != 0.0)).any()),
            not all_greedy and bool(((np.asarray(top_k) > 0)
                                     | (np.asarray(top_p) < 1.0)).any()),
            not all_greedy and bool((np.asarray(min_p) > 0.0).any()))


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
        *gates(temperature, top_p, top_k, presence, frequency, min_p,
               bias_ids))


def _hash32(x):
    """A 32-bit integer hash (two multiply-xorshift rounds) of 32-bit
    values, on Python ints or int64 tensors alike."""
    x = ((x >> 16) ^ x) * _HASH_MUL & _M32
    x = ((x >> 16) ^ x) * _HASH_MUL & _M32
    return (x >> 16) ^ x


def fold_in(key, data):
    """The row key for position `data` of chain root `key` (< 2**63): 63
    bits, from two 32-bit lanes. Python ints or int64 tensors."""
    a = _hash32((key & _M32) ^ _hash32(data & _M32))
    b = _hash32(((key >> 32) & _M32) ^ _hash32(a ^ _ROW_SALT))
    return ((b & 0x7FFFFFFF) << 32) | a


def fold_positions(keys: Keys, positions) -> Keys:
    """Per-slot row keys fold_in(keys[b], positions[b]): a tensor for
    tensors (on their device), else a list of ints."""
    if isinstance(keys, torch.Tensor):
        return fold_in(keys.long(), positions.to(keys.device, torch.int64))
    return [fold_in(int(k), int(p)) for k, p in zip(keys, positions)]


def uniform_bits(row_keys: torch.Tensor, vocab: int) -> torch.Tensor:
    """[B, vocab] int64 random 32-bit values: entry v of row b hashes
    (row_keys[b], v)."""
    v = torch.arange(vocab, device=row_keys.device, dtype=torch.int64)
    x = _hash32(v[None, :] ^ (row_keys & _M32)[:, None])
    return _hash32(x ^ (row_keys >> 32)[:, None])


def gumbel(row_keys: torch.Tensor, vocab: int) -> torch.Tensor:
    """[B, vocab] float32 Gumbel noise from uniform_bits: the top 24 bits
    as a uniform in (0, 1), exactly, then -log(-log(u))."""
    u = ((uniform_bits(row_keys, vocab) >> 8).to(torch.float32) + 0.5) \
        * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def _as_keys(keys: Keys, device) -> torch.Tensor:
    if isinstance(keys, torch.Tensor):
        return keys.to(device, torch.int64)
    return torch.tensor([int(k) for k in keys], dtype=torch.int64,
                        device=device)


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


def sample(logits: torch.Tensor, state: SamplingState, keys: Keys,
           counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B] sampled token ids (int64): Gumbel-max with per-slot row keys
    `keys` (fold_positions; a tensor or ints). An all-greedy batch is one
    argmax."""
    logits32, greedy = _penalized(logits, state, counts)
    if state.all_greedy:
        return greedy
    scaled = logits32 / state.temperature.clamp_min(1e-6)[:, None]
    if state.any_topk_topp:
        scaled = _mask_topk_topp(scaled, state)
    if state.any_min_p:
        scaled = _mask_min_p(scaled, state)
    noise = gumbel(_as_keys(keys, scaled.device), scaled.shape[1])
    sampled = (scaled + noise).argmax(dim=-1)
    return torch.where(state.temperature <= 0.0, greedy, sampled)


def sample_with_logprobs(logits: torch.Tensor, state: SamplingState,
                         keys: Keys,
                         counts: Optional[torch.Tensor] = None,
                         num_top: int = 5):
    """sample() plus the chosen token's logprob and the top-`num_top`
    alternatives, from the UNPENALIZED distribution at temperature 1 (the
    OpenAI contract: logprobs describe the model, not the sampler)."""
    tokens = sample(logits, state, keys, counts)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    chosen = logp.gather(1, tokens[:, None])[:, 0]
    top_vals, top_ids = logp.topk(min(num_top, logp.shape[-1]), dim=-1)
    return tokens, chosen, top_ids, top_vals


def verify_accept(logits: torch.Tensor, drafts: torch.Tensor,
                  state: SamplingState, keys: torch.Tensor,
                  positions: torch.Tensor, eligible: torch.Tensor,
                  counts: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Longest-prefix draft acceptance that replays the sequential chain
    (`dynamo_tpu.engine.sampling.verify_accept`). logits [B, K1, V] at
    every window position, drafts [B, K], keys [B] chain roots (not row
    keys), positions [B] of each window's first row, eligible [B] bool ->
    (emitted [B, K1], n_acc [B]); `emitted[b, :n_acc[b] + 1]` are the
    tokens slot b produces.

    Row 0 is sampled with `counts`, exactly as a decode step samples its
    token. Row j of slot b is sampled with the row key of position
    positions[b] + j, the key a decode step at that position would use,
    without counts (a counts snapshot goes stale as tokens are accepted,
    so penalized slots must be ineligible). A draft is accepted iff the
    chain draws it, so greedy and seeded streams are the same with
    speculation on or off. Everything stays on the device: no host sync,
    so it runs inside a captured graph."""
    b, k1, v = logits.shape
    keys = _as_keys(keys, logits.device)
    positions = positions.to(logits.device, torch.int64)
    t0 = sample(logits[:, 0], state, fold_positions(keys, positions), counts)
    rep = SamplingState(*(f.repeat_interleave(k1, dim=0) for f in state[:8]),
                        *state[8:])
    pos_grid = (positions[:, None]
                + torch.arange(k1, device=logits.device)[None, :]).reshape(-1)
    grid_keys = fold_positions(keys.repeat_interleave(k1), pos_grid)
    grid = sample(logits.reshape(b * k1, v), rep, grid_keys).reshape(b, k1)
    emitted = torch.cat([t0[:, None], grid[:, 1:]], dim=1)
    match = (drafts.to(emitted.dtype) == emitted[:, :-1]).to(torch.int64)
    n_acc = torch.where(eligible, match.cumprod(dim=1).sum(dim=1),
                        torch.zeros_like(match[:, 0]))
    return emitted, n_acc
