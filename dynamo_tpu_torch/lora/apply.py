"""Batched in-engine LoRA application (the multi-LoRA path).

The port's own copy of `dynamo_tpu/lora/apply.py`. Adapters are stacked
into device tensors with a leading SLOT axis: for each target projection
`t` of q, k, v and o,

    a[t]: [L, S, in,  R]   (the A matrices, rank-padded to R)
    b[t]: [L, S, R,  out]  (the B matrices, alpha/rank scale folded in)

where L = num_layers, S = device adapter slots + 1 and R = the engine's
max rank (`Stacks`). Slot 0 is the reserved BASE slot: its matrices are
all-zero, so bare-base rows ride the same forward with a delta of exactly
0 and a mixed-adapter batch needs no per-adapter dispatch.

Each forward carries a per-row slot index and adds, per projection,

    y += (x @ A[s]) @ B[s]

(`delta`). The JAX package gathers A[slots] and B[slots] per row and
contracts them ([T, in, R] per projection); this XLA-composed math reaches
no Pallas kernel, so plain PyTorch is the port. `delta` computes the same
sum without the per-row gather: x against every slot's A at once (one
batched product, [S, T, R]), the rows of other slots zeroed, then one
product with the slots' B stacked ([S*R, out]). For the 8-slot decode
step that reads each A and B once instead of 8 times, and a prompt of T
rows (one slot: prefill and chunks pass its slot for every row) never
materializes a [T, in, R] gather, at the cost of S-1 zeroed rank blocks,
which are tiny beside the projection itself. A shrink/expand kernel is
later work (ROADMAP.md).

Rank padding is free correctness-wise: padded A columns are zero, so the
extra lanes of `x @ A[s]` contribute nothing through the (zero) padded B
rows. A speculative verify window repeats its sequence's slot index per
window position (`llama.decode_verify`, `mixed_verify_step`), so adapter
sequences accept drafts scored by their own weights.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

TARGETS = ("q", "k", "v", "o")


def param_name(target: str, which: str) -> str:
    """The JAX param-tree key of a stacked LoRA matrix ('a' or 'b')."""
    return f"lora_{target}{which}"


STACK_NAMES = tuple(param_name(t, w) for t in TARGETS for w in ("a", "b"))


def target_dims(model_cfg) -> Dict[str, Tuple[int, int]]:
    """target -> (in_features, out_features) of the wrapped projection."""
    e = model_cfg.hidden_size
    h = model_cfg.num_heads * model_cfg.head_dim
    kv = model_cfg.num_kv_heads * model_cfg.head_dim
    return {"q": (e, h), "k": (e, kv), "v": (e, kv), "o": (h, e)}


def stack_shapes(model_cfg, slots: int, rank: int
                 ) -> Dict[str, Tuple[int, ...]]:
    """Shapes of the device stacks for `slots` TOTAL slots (incl. base 0)."""
    l = model_cfg.num_layers
    out = {}
    for t, (d_in, d_out) in target_dims(model_cfg).items():
        out[param_name(t, "a")] = (l, slots, d_in, rank)
        out[param_name(t, "b")] = (l, slots, rank, d_out)
    return out


def init_stacks(model_cfg, slots: int, rank: int,
                dtype=np.float32) -> Dict[str, np.ndarray]:
    """All-zero host stacks (slot 0 stays zero forever = the base slot)."""
    return {name: np.zeros(shape, dtype)
            for name, shape in stack_shapes(model_cfg, slots, rank).items()}


def slot_rows(slots: torch.Tensor, num_slots: int,
              dtype: torch.dtype) -> torch.Tensor:
    """[S, T, 1] of 1 where row t's slot is s, else 0: computed once per
    forward and shared by every projection's delta_rows."""
    own = slots.to(torch.int64)[None, :] == torch.arange(
        num_slots, device=slots.device)[:, None]
    return own[..., None].to(dtype)


def delta_rows(x: torch.Tensor, a_stack: torch.Tensor,
               b_stack: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """delta with the slots given as slot_rows' mask: x against every
    slot's A ([S, T, R], one batched product), other slots' rows zeroed,
    then one product with the slots' B stacked ([S*R, out])."""
    s, _, r = a_stack.shape
    u = torch.matmul(x, a_stack) * rows
    return u.transpose(0, 1).reshape(x.shape[0], s * r) @ b_stack.reshape(
        s * r, -1)


def delta(x: torch.Tensor, a_stack: torch.Tensor, b_stack: torch.Tensor,
          slots: torch.Tensor) -> torch.Tensor:
    """y-delta for one projection: x [T, in], a_stack [S, in, R] (one
    layer's slice), b_stack [S, R, out] in x's dtype, slots [T] ->
    [T, out]: row t gets (x[t] @ A[slots[t]]) @ B[slots[t]]. Runs on
    device tensors only (no host sync), so it is captured with the decode
    step."""
    return delta_rows(x, a_stack, b_stack,
                      slot_rows(slots, a_stack.shape[0], x.dtype))


def pad_rank(a: np.ndarray, b: np.ndarray, rank: int
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-pad per-layer A [L, in, r] / B [L, r, out] up to max rank."""
    r = a.shape[-1]
    if r > rank:
        raise ValueError(f"adapter rank {r} exceeds the engine's "
                         f"--lora-rank {rank}")
    if r == rank:
        return a, b
    a2 = np.zeros(a.shape[:-1] + (rank,), a.dtype)
    a2[..., :r] = a
    b2 = np.zeros((b.shape[0], rank) + b.shape[2:], b.dtype)
    b2[:, :r] = b
    return a2, b2


def random_adapter(model_cfg, rank: int, seed: int = 0, scale: float = 0.05
                   ) -> Dict[str, np.ndarray]:
    """Seeded random adapter tensors (tests, smoke runs): per target,
    'ta'/'tb' with shapes [L, in, r] / [L, r, out]. Both sides nonzero so
    the delta is visible in greedy output immediately."""
    rng = np.random.default_rng(seed)
    l = model_cfg.num_layers
    out: Dict[str, np.ndarray] = {}
    for t, (d_in, d_out) in target_dims(model_cfg).items():
        out[t + "a"] = (rng.standard_normal((l, d_in, rank)) * scale
                        ).astype(np.float32)
        out[t + "b"] = (rng.standard_normal((l, rank, d_out)) * scale
                        ).astype(np.float32)
    return out


class Stacks:
    """The device stacks of every target: a[t] [L, S, in, R] and b[t]
    [L, S, R, out] in the model dtype, with `layer(l)` the per-layer views
    {t: (A [S, in, R], B [S, R, out])} a forward reads."""

    def __init__(self, a: Dict[str, torch.Tensor],
                 b: Dict[str, torch.Tensor]):
        self.a, self.b = a, b
        n_layers = next(iter(a.values())).shape[0]
        self._layers = [{t: (a[t][l], b[t][l]) for t in a}
                        for l in range(n_layers)]

    @classmethod
    def zeros(cls, model_cfg, slots: int, rank: int, device,
              dtype: torch.dtype) -> "Stacks":
        """All-zero stacks for `slots` TOTAL slots (incl. base 0)."""
        a, b = {}, {}
        for t, (d_in, d_out) in target_dims(model_cfg).items():
            l = model_cfg.num_layers
            a[t] = torch.zeros((l, slots, d_in, rank), dtype=dtype,
                               device=device)
            b[t] = torch.zeros((l, slots, rank, d_out), dtype=dtype,
                               device=device)
        return cls(a, b)

    @classmethod
    def from_arrays(cls, arrays: Mapping[str, np.ndarray], device,
                    dtype: torch.dtype) -> Optional["Stacks"]:
        """From a JAX param tree's lora_{t}{a,b} arrays (None if it has
        none)."""
        if param_name("q", "a") not in arrays:
            return None
        a, b = {}, {}
        for t in TARGETS:
            a[t] = torch.from_numpy(np.array(
                arrays[param_name(t, "a")], np.float32)).to(device, dtype)
            b[t] = torch.from_numpy(np.array(
                arrays[param_name(t, "b")], np.float32)).to(device, dtype)
        return cls(a, b)

    @property
    def num_slots(self) -> int:
        return self.a["q"].shape[1]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for d in (self.a, self.b) for t in d.values())

    def layer(self, l: int) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        return self._layers[l]

    def write_slot(self, slot: int,
                   tensors: Mapping[str, Optional[np.ndarray]]) -> None:
        """Copy one adapter's per-target [L, in, R] / [L, R, out] arrays
        into `slot` (a missing target writes zeros)."""
        for t in TARGETS:
            for which, stack in (("a", self.a[t]), ("b", self.b[t])):
                arr = tensors.get(t + which)
                if arr is None:
                    stack[:, slot].zero_()
                else:
                    stack[:, slot].copy_(torch.from_numpy(
                        np.asarray(arr, np.float32)).to(stack.dtype))
