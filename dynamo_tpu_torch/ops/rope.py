"""Rotary position embeddings (HF llama "rotate_half" convention).

Port of `dynamo_tpu/ops/rope.py`: base frequencies, Llama-3.1 frequency
scaling and YaRN (DeepSeek-V2's: the frequency remap and the rotary
magnitude on cos/sin; the softmax mscale^2 is the model's, on q), Phi-3's
longrope (per-dimension short and long factors chosen per position, on
the device, and its attention factor on cos/sin), angles in float32, and
Gemma-3's linear position scaling (float positions divided by a per-layer
factor, `position_scale`; the model picks each layer's theta and
factor). The model computes cos/sin once per forward and distinct rope
(`rope_cos_sin`) and rotates every layer's q and k with them (`rotate`);
`apply_rope` is the two together, the JAX package's signature.
"""

from __future__ import annotations

import functools
import math

import torch


def rope_freqs(head_dim: int, theta: float,
               device: torch.device | str = "cpu") -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def llama3_scale_freqs(inv: torch.Tensor, factor: float,
                       low_freq_factor: float, high_freq_factor: float,
                       original_max_pos: int) -> torch.Tensor:
    """Llama-3.1+ frequency-dependent rope scaling (HF rope_type "llama3"):
    long wavelengths are divided by `factor`, short ones kept, with a
    smooth ramp between; applied once to the inverse frequencies."""
    low_wavelen = original_max_pos / low_freq_factor
    high_wavelen = original_max_pos / high_freq_factor
    wavelen = 2.0 * math.pi / inv
    smooth = (original_max_pos / wavelen - low_freq_factor) / (
        high_freq_factor - low_freq_factor)
    smooth = smooth.clamp(0.0, 1.0)
    scaled = (1.0 - smooth) * inv / factor + smooth * inv
    out = torch.where(wavelen > low_wavelen, inv / factor, scaled)
    return torch.where(wavelen < high_wavelen, inv, out)


def yarn_scale_freqs(inv: torch.Tensor, theta: float, head_dim: int,
                     factor: float, beta_fast: float, beta_slow: float,
                     original_max_pos: int) -> torch.Tensor:
    """YaRN frequency remap (HF rope_type "yarn"; DeepSeek-V2's default):
    dims rotating at least beta_fast times over the original context keep
    their frequencies, dims rotating at most beta_slow times are divided
    by `factor`, with a ramp linear in the dim between (HF's correction
    dims; `high` clamps against the full rotary dim, as HF's does)."""

    def corr_dim(n_rot: float) -> float:
        return (head_dim * math.log(original_max_pos
                                    / (n_rot * 2 * math.pi))
                ) / (2 * math.log(theta))

    low = max(math.floor(corr_dim(beta_fast)), 0)
    high = min(math.ceil(corr_dim(beta_slow)), head_dim - 1)
    idx = torch.arange(head_dim // 2, dtype=torch.float32, device=inv.device)
    ramp = ((idx - low) / max(high - low, 1)).clamp(0.0, 1.0)
    keep = 1.0 - ramp  # 1 on the fast-rotating (low) dims
    return inv * keep + (inv / factor) * (1.0 - keep)


def longrope_attention_factor(max_pos: int, original_max_pos: int) -> float:
    """Phi-3 longrope's attention magnitude (HF Phi3 formula):
    sqrt(1 + ln(scale) / ln(original)) where the checkpoint extends its
    original context by `scale`, 1.0 otherwise. Multiplies cos/sin."""
    scale = max_pos / max(original_max_pos, 1)
    if scale <= 1.0:
        return 1.0
    return math.sqrt(1.0 + math.log(scale) / math.log(original_max_pos))


def yarn_get_mscale(scale: float, mscale: float = 1.0) -> float:
    """YaRN attention-magnitude correction (HF/DeepSeek formula)."""
    if scale <= 1.0:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def yarn_rotary_scale(yarn_scaling) -> float:
    """The rotary magnitude that multiplies cos/sin under YaRN
    (factor, beta_fast, beta_slow, original_max_pos, mscale,
    mscale_all_dim, attention_factor): an explicit attention_factor >= 0
    (generic HF yarn), else DeepSeek's mscale / mscale_all_dim ratio."""
    factor, _, _, _, ms, msad, af = yarn_scaling
    if af >= 0.0:
        return af
    return yarn_get_mscale(factor, ms) / yarn_get_mscale(factor, msad)


@functools.lru_cache(maxsize=16)
def _inv_freqs(head_dim: int, theta: float, llama3_scaling, yarn_scaling,
               device: torch.device) -> torch.Tensor:
    """Inverse frequencies, built once per (shape, scalings, device): a
    fresh host-to-device copy of theta in every layer would stall the GPU
    stream."""
    inv = rope_freqs(head_dim, theta)
    if llama3_scaling is not None:
        inv = llama3_scale_freqs(inv, *llama3_scaling)
    if yarn_scaling is not None:
        factor, beta_fast, beta_slow, orig = yarn_scaling[:4]
        inv = yarn_scale_freqs(inv, theta, head_dim, factor, beta_fast,
                               beta_slow, orig)
    return inv.to(device)


@functools.lru_cache(maxsize=16)
def _longrope_freqs(head_dim: int, theta: float, llama3_scaling, short,
                    long, device: torch.device):
    """(inv / short, inv / long): longrope's two sets of inverse
    frequencies (the factors as tuples of D/2 floats, so the key hashes),
    built once per device as _inv_freqs is."""
    for name, factors in (("short", short), ("long", long)):
        if len(factors) != head_dim // 2:
            raise ValueError(f"longrope {name} factors hold {len(factors)} "
                             f"values, the rotary width {head_dim} needs "
                             f"{head_dim // 2}")
    inv = rope_freqs(head_dim, theta)
    if llama3_scaling is not None:
        inv = llama3_scale_freqs(inv, *llama3_scaling)
    return tuple((inv / torch.tensor(f, dtype=torch.float32)).to(device)
                 for f in (short, long))


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 llama3_scaling=None, yarn_scaling=None,
                 longrope_scaling=None, position_scale: float = 1.0):
    """positions [T] -> (cos, sin), each [T, 1, D/2] float32, broadcasting
    over heads; under YaRN both carry its rotary magnitude. With
    `position_scale` != 1 the float32 positions are divided by it first
    (HF linear rope scaling: Gemma-3's global layers, JAX `_layer_rope`).
    `longrope_scaling` (short factors, long factors, original_max_pos,
    attention factor): a position below original_max_pos rotates at
    inv / short, one at or past it at inv / long (vLLM's su-rope, as the
    JAX `apply_rope`), chosen by a `torch.where` on the positions, so a
    captured step whose positions live on the card takes no host branch;
    cos/sin carry the attention factor."""
    l3 = None if llama3_scaling is None else tuple(llama3_scaling)
    yarn = None if yarn_scaling is None else tuple(yarn_scaling)
    pos = positions.to(torch.float32)
    if position_scale != 1.0:
        pos = pos / position_scale
    pos = pos[..., None]
    scale = 1.0
    if longrope_scaling is not None:
        short, long, orig, attn_factor = longrope_scaling
        inv_short, inv_long = _longrope_freqs(
            head_dim, float(theta), l3, tuple(map(float, short)),
            tuple(map(float, long)), positions.device)
        angles = pos * torch.where(pos >= orig, inv_long, inv_short)
        scale = attn_factor
    else:
        angles = pos * _inv_freqs(head_dim, float(theta), l3, yarn,
                                  positions.device)  # [T, D/2]
    cos, sin = torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]
    if yarn is not None:
        ratio = yarn_rotary_scale(yarn)
        if ratio != 1.0:
            scale = ratio
    if scale != 1.0:
        cos, sin = cos * scale, sin * scale
    return cos, sin


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
           ) -> torch.Tensor:
    """Rotate-half rope of x [T, heads, D] by cos/sin from rope_cos_sin, in
    float32, returned in x's dtype."""
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               llama3_scaling=None, yarn_scaling=None,
               longrope_scaling=None, position_scale: float = 1.0
               ) -> torch.Tensor:
    """x [T, heads, D] with positions [T] -> x rotated, same dtype.

    `llama3_scaling`: optional (factor, low_freq_factor, high_freq_factor,
    original_max_pos); `yarn_scaling`: optional (factor, beta_fast,
    beta_slow, original_max_pos, mscale, mscale_all_dim,
    attention_factor); `longrope_scaling`: optional (short_factors [D/2],
    long_factors [D/2], original_max_pos, attention_factor);
    `position_scale` as in rope_cos_sin."""
    cos, sin = rope_cos_sin(positions, x.shape[-1], theta, llama3_scaling,
                            yarn_scaling, longrope_scaling, position_scale)
    return rotate(x, cos, sin)
