"""Rotary position embeddings (HF llama "rotate_half" convention).

Port of `dynamo_tpu/ops/rope.py` for the dense Llama path: base frequencies
and Llama-3.1 frequency scaling, angles in float32. YaRN and Phi-3 longrope
are not ported yet and raise. The model computes cos/sin once per forward
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


@functools.lru_cache(maxsize=16)
def _inv_freqs(head_dim: int, theta: float, llama3_scaling,
               device: torch.device) -> torch.Tensor:
    """Inverse frequencies, built once per (shape, scaling, device): a
    fresh host-to-device copy of theta in every layer would stall the GPU
    stream."""
    inv = rope_freqs(head_dim, theta)
    if llama3_scaling is not None:
        inv = llama3_scale_freqs(inv, *llama3_scaling)
    return inv.to(device)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 llama3_scaling=None, yarn_scaling=None,
                 longrope_scaling=None):
    """positions [T] -> (cos, sin), each [T, 1, D/2] float32, broadcasting
    over heads."""
    if yarn_scaling is not None:
        raise NotImplementedError("yarn rope scaling is not ported yet")
    if longrope_scaling is not None:
        raise NotImplementedError("longrope rope scaling is not ported yet")
    inv = _inv_freqs(head_dim, float(theta),
                     None if llama3_scaling is None else tuple(llama3_scaling),
                     positions.device)
    angles = positions.to(torch.float32)[..., None] * inv  # [T, D/2]
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
           ) -> torch.Tensor:
    """Rotate-half rope of x [T, heads, D] by cos/sin from rope_cos_sin, in
    float32, returned in x's dtype."""
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               llama3_scaling=None, yarn_scaling=None,
               longrope_scaling=None) -> torch.Tensor:
    """x [T, heads, D] with positions [T] -> x rotated, same dtype.

    `llama3_scaling`: optional (factor, low_freq_factor, high_freq_factor,
    original_max_pos)."""
    cos, sin = rope_cos_sin(positions, x.shape[-1], theta, llama3_scaling,
                            yarn_scaling, longrope_scaling)
    return rotate(x, cos, sin)
