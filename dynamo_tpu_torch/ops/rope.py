"""Rotary position embeddings (HF llama "rotate_half" convention).

Port of `dynamo_tpu/ops/rope.py`: base frequencies, Llama-3.1 frequency
scaling and YaRN (DeepSeek-V2's: the frequency remap and the rotary
magnitude on cos/sin; the softmax mscale^2 is the model's, on q), angles in
float32, and Gemma-3's linear position scaling (float positions divided
by a per-layer factor, `position_scale`; the model picks each layer's
theta and factor). Phi-3 longrope is not ported yet and raises. The
model computes cos/sin once per forward and distinct rope (`rope_cos_sin`)
and rotates every layer's q and k with them (`rotate`); `apply_rope` is
the two together, the JAX package's signature.
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


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 llama3_scaling=None, yarn_scaling=None,
                 longrope_scaling=None, position_scale: float = 1.0):
    """positions [T] -> (cos, sin), each [T, 1, D/2] float32, broadcasting
    over heads; under YaRN both carry its rotary magnitude. With
    `position_scale` != 1 the float32 positions are divided by it first
    (HF linear rope scaling: Gemma-3's global layers, JAX `_layer_rope`)."""
    if longrope_scaling is not None:
        raise NotImplementedError("longrope rope scaling is not ported yet")
    yarn = None if yarn_scaling is None else tuple(yarn_scaling)
    inv = _inv_freqs(head_dim, float(theta),
                     None if llama3_scaling is None else tuple(llama3_scaling),
                     yarn, positions.device)
    pos = positions.to(torch.float32)
    if position_scale != 1.0:
        pos = pos / position_scale
    angles = pos[..., None] * inv  # [T, D/2]
    cos, sin = torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]
    if yarn is not None:
        ratio = yarn_rotary_scale(yarn)
        if ratio != 1.0:
            cos, sin = cos * ratio, sin * ratio
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
    attention_factor); `position_scale` as in rope_cos_sin."""
    cos, sin = rope_cos_sin(positions, x.shape[-1], theta, llama3_scaling,
                            yarn_scaling, longrope_scaling, position_scale)
    return rotate(x, cos, sin)
