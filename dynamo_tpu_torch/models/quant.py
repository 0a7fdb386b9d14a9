"""Int8 weights for the port's Llama: weight-only (`int8`) and W8A8
(`w8a8`).

Port of `dynamo_tpu/models/quant.py` for the models the port serves.
The arithmetic is the JAX package's, in the same cast order:

- `quantize`: symmetric int8 over the contraction axes, one f32 scale per
  output channel: amax over those axes, scale `where(amax > 0, amax / 127,
  1)`, q = clip(round(w / scale), -127, 127) (round half to even in both
  frameworks), so the int8 bytes and scales are the JAX package's exactly.
- weight-only (`int8`): `(x @ q.to(x.dtype)) * scale.to(x.dtype)`.
- W8A8 (`w8a8`): the activations are quantized per token over the
  contracted axis the same way, the product runs int8 x int8 -> int32
  (`torch._int_mm`, exact), and `acc.float() * x_scale * scale` is cast to
  x's dtype.

A quantized weight is a `QTensor` module holding `q` and `scale` buffers in
the port's flattened layout, with the mode as a flag (the JAX package
selects the path by the class, `QTensor` or `QTensorA8`):

    wq [E, H*D], scale [1, H*D]      wk, wv [E, KV*D], scale [1, KV*D]
    wo [H*D, E], scale [1, E]        w_gate, w_up [E, F], w_down [F, E]
    embed [V, E], scale [V, 1]       lm_head [E, V], scale [1, V]

    moe_w_gate, moe_w_up [X, E, F], scale [X, 1, F]
    moe_w_down [X, F, E], scale [X, 1, E]

wo's scale is JAX's over the contraction axes (1, 2) of [L, H, D, E]; an
expert stack's is JAX's over axis 2 of [L, X, E, F]: one per (expert,
output channel). A matmul weight's q is stored column-major (the
transpose of a contiguous [N, K]), the layout `torch._int_mm` takes as
its second operand, and an expert stack's q (and a float expert stack)
is stored as each expert's [N, K] the same way (`operand_layout`), so
that the dense gate and up products over every expert are one matrix
product; embed stays row-major, and the tied head contracts over its
transpose, which is column-major. The int8 product is cuBLAS's through
`torch._int_mm`: the JAX package leaves it to XLA, outside any Pallas
kernel.

The expert products (`expert_rows`, `expert_batch`) follow the JAX
`quant.einsum` at the MoE call sites, W8A8 activation scales included:
that einsum takes the activation's contracted axes to be every axis
whose label the weight also has, so for "te,xef->txf" a token's scale
spans E, but for "txf,xfe->txe" (and the capacity path's "xce,xef->xcf",
"xcf,xfe->xce") it spans the expert axis as well, one scale per token
(per capacity slot) over X and the contracted axis.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

MODES = ("int8", "w8a8")

# The JAX package's QUANT_AXES for the weights the port has: parameter
# name -> contraction axes of its STACKED tensor ([L, ...] for per-layer
# weights). In the port's flattened per-layer layout every dense weight
# contracts over its first axis, except embed, whose rows are the output
# channels, and an expert stack [X, K, N] over its axis 1.
QUANT_AXES: Dict[str, Tuple[int, ...]] = {
    "embed": (1,),  # [V, E]: per vocab row (also right for the tied head)
    "lm_head": (0,),  # [E, V]
    "wq": (1,),  # [L, E, H, D]
    "wk": (1,),
    "wv": (1,),
    "wo": (1, 2),  # [L, H, D, E]
    # MLA's projections (W_UK and W_UV stay unquantized: they run in f32
    # in the absorbed query and the output)
    "wq_mla": (1,),  # [L, E, H, nope+rope]
    "w_kv_a": (1,),  # [L, E, lora+rope]
    "w_gate": (1,),  # [L, E, F]
    "w_up": (1,),
    "w_down": (1,),  # [L, F, E]
    "moe_w_gate": (2,),  # [L, X, E, F]
    "moe_w_up": (2,),
    "moe_w_down": (2,),  # [L, X, F, E]
}
EXPERT_NAMES = ("moe_w_gate", "moe_w_up", "moe_w_down")
# the contracted axes of an expert-major activation [X, T, K] as the JAX
# einsum quantizes it (see the module doc)
EXPERT_BATCH_DIMS = (0, 2)

# torch._int_mm on CUDA refuses fewer rows than this; shorter operands get
# zero rows appended (exact: a zero row gives a zero output row)
INT_MM_MIN_ROWS = 17


def mode_name(quantization: Optional[str]) -> str:
    """"none", "int8" or "w8a8" for an EngineConfig.quantization value
    (None and "" mean none); anything else raises ValueError."""
    if quantization in (None, "", "none"):
        return "none"
    if quantization not in MODES:
        raise ValueError(f"unknown quantization {quantization!r}")
    return quantization


class QTensor(nn.Module):
    """Symmetric per-channel int8 weight, `w ~= q * scale`; `mode` "int8"
    (weight-only) or "w8a8" (int8 activations too)."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, mode: str):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"unknown quantization mode {mode!r}")
        if q.dtype != torch.int8 or scale.dtype != torch.float32:
            raise ValueError(f"QTensor needs int8 q and f32 scale, got "
                             f"{q.dtype} and {scale.dtype}")
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)
        self.mode = mode

    @property
    def a8(self) -> bool:
        return self.mode == "w8a8"

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    def extra_repr(self) -> str:
        return f"{tuple(self.q.shape)}, mode={self.mode}"


def quantize(w: torch.Tensor, axes: Tuple[int, ...],
             mode: str = "int8") -> QTensor:
    """Symmetric int8 over `axes` (the contraction axes), per-channel f32
    scales kept with size-1 axes: the JAX package's `quant.quantize`, byte
    for byte. q keeps w's layout."""
    w32 = w.to(torch.float32)
    amax = w32.abs().amax(dim=axes, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return QTensor(q, scale, mode)


def operand_layout(q: torch.Tensor) -> torch.Tensor:
    """q [..., K, N] as the transpose of a contiguous [..., N, K]:
    torch._int_mm's second operand (for each expert of a stack, float or
    int8)."""
    return q.transpose(-2, -1).contiguous().transpose(-2, -1)


def quantize_weight(name: str, w: torch.Tensor, mode: str) -> QTensor:
    """One weight of the port's model in its flattened layout (see the
    module doc), quantized over its contraction axis."""
    if name == "embed":
        return quantize(w, (1,), mode)
    qt = quantize(w, (1,) if name in EXPERT_NAMES else (0,), mode)
    return QTensor(operand_layout(qt.q), qt.scale, mode)


def set_weight(owner: nn.Module, name: str, value) -> None:
    """Put a tensor, Parameter or QTensor in the slot `name` of `owner`,
    whatever the slot held (nn.Module refuses a module over a parameter)."""
    if hasattr(owner, name):
        delattr(owner, name)
    setattr(owner, name, value)


def _weight_slots(model: nn.Module):
    """(owner module, name) of every weight named in QUANT_AXES."""
    for mod in list(model.modules()):
        if isinstance(mod, QTensor):
            continue
        for name in QUANT_AXES:
            if isinstance(getattr(mod, name, None), (torch.Tensor, QTensor)):
                yield mod, name


@torch.no_grad()
def quantize_params(model: nn.Module, mode: str = "int8") -> nn.Module:
    """Quantize every weight named in QUANT_AXES IN PLACE (each float
    weight is released as its QTensor replaces it); norms and biases stay
    in the model dtype. Returns `model`."""
    mode = mode_name(mode)
    if mode == "none":
        return model
    for owner, name in _weight_slots(model):
        w = getattr(owner, name)
        if isinstance(w, QTensor):
            raise ValueError(f"{name} is quantized already")
        set_weight(owner, name, quantize_weight(name, w, mode))
        del w
    return model


def with_mode(model: nn.Module, mode: str) -> nn.Module:
    """A second model over the SAME tensors whose quantized weights run in
    `mode` ("int8" or "w8a8"): both modes store the same q and scale."""
    if mode not in MODES:
        raise ValueError(f"unknown quantization mode {mode!r}")
    twin = type(model)(model.cfg, "meta", model.dtype)
    src = dict(model.named_modules())
    for path, mod in list(twin.named_modules()):
        if isinstance(mod, QTensor):
            continue
        orig = src[path]
        for name, p in list(orig.named_parameters(recurse=False)):
            setattr(mod, name, p)
        for name, child in orig.named_children():
            if isinstance(child, QTensor):
                set_weight(mod, name, QTensor(child.q, child.scale, mode))
    return twin


def is_quantized(model: nn.Module) -> bool:
    return any(isinstance(m, QTensor) for m in model.modules())


def mode_of(model: nn.Module) -> str:
    """"none", "int8" or "w8a8"; raises if the model mixes modes."""
    modes = {m.mode for m in model.modules() if isinstance(m, QTensor)}
    if len(modes) > 1:
        raise ValueError(f"model mixes quantization modes {sorted(modes)}")
    return modes.pop() if modes else "none"


def param_bytes(model: nn.Module) -> int:
    """Bytes of the (possibly quantized) weights: parameters and buffers."""
    return sum(t.numel() * t.element_size()
               for t in (*model.parameters(), *model.buffers()))


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] int8 @ b [K, N] int8 -> [M, N] int32, exact. On the card
    through torch._int_mm, with zero rows appended below INT_MM_MIN_ROWS
    and sliced off; it raises for a shape cuBLAS refuses."""
    m = a.shape[0]
    if a.is_cuda and m < INT_MM_MIN_ROWS:
        a = F.pad(a, (0, 0, 0, INT_MM_MIN_ROWS - m))
        return torch._int_mm(a, b)[:m]
    return torch._int_mm(a, b)


def activations(x: torch.Tensor, dims: Tuple[int, ...] = (-1,)
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [T, K] -> (int8 [T, K], f32 scale [T, 1]): per-token symmetric
    int8 over the contracted axes `dims` (the last by default), scales
    kept with size-1 axes, as the JAX einsum's W8A8 path."""
    x32 = x.to(torch.float32)
    amax = x32.abs().amax(dim=dims, keepdim=True)
    xs = torch.where(amax > 0, amax / 127.0, 1.0)
    xq = torch.clamp(torch.round(x32 / xs), -127, 127).to(torch.int8)
    return xq, xs


Activations = Optional[Tuple[torch.Tensor, torch.Tensor]]


def shared_activations(x: torch.Tensor, w,
                       dims: Tuple[int, ...] = (-1,)) -> Activations:
    """The int8 activations of x over `dims` if `w` is a W8A8 weight, else
    None: one quantization serves every projection of the same input (q, k
    and v; gate and up), which would each compute the same bits."""
    if isinstance(w, QTensor) and w.a8:
        return activations(x, dims)
    return None


def _qmatmul(x, q, scale, a8: bool, act: Activations) -> torch.Tensor:
    if a8:
        xq, xs = act if act is not None else activations(x)
        acc = int_mm(xq, q)
        return (acc.to(torch.float32) * xs * scale).to(x.dtype)
    return (x @ q.to(x.dtype)) * scale.to(x.dtype)


def matmul(x: torch.Tensor, w, act: Activations = None) -> torch.Tensor:
    """x [T, K] @ w [K, N] for a plain or quantized weight (the JAX
    package's `quant.einsum` over the flattened axes). `act`: x's int8
    activations from `shared_activations`, for a W8A8 weight."""
    if not isinstance(w, QTensor):
        return x @ w
    return _qmatmul(x, w.q, w.scale, w.a8, act)


def take_rows(w, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Embedding rows: for a QTensor the gathered int8 rows and their
    scales, each cast to `dtype`, then multiplied."""
    if not isinstance(w, QTensor):
        return F.embedding(ids, w).to(dtype)
    return w.q[ids].to(dtype) * w.scale[ids].to(dtype)


def tied_head(x: torch.Tensor, embed) -> torch.Tensor:
    """Logits through the tied embedding, x [T, E] @ embed.T [E, V]; a
    quantized embed's per-row scales sit on the output axis."""
    if not isinstance(embed, QTensor):
        return x @ embed.t()
    return _qmatmul(x, embed.q.t(), embed.scale.t(), embed.a8, None)


def _all_experts(w: torch.Tensor) -> torch.Tensor:
    """An expert stack [X, K, N] as [K, X*N]: a view in `operand_layout`."""
    x, k, n = w.shape
    return w.permute(1, 0, 2).reshape(k, x * n)


def expert_rows(x: torch.Tensor, w, act: Activations = None
                ) -> torch.Tensor:
    """x [T, K] through every expert of w [X, K, N] -> [T, X, N] (the JAX
    "te,xef->txf"), as one matrix product over the experts side by side;
    a W8A8 stack scales each token over K (`act`: x's shared
    activations)."""
    t = x.shape[0]
    nx, _, n = w.shape
    if not isinstance(w, QTensor):
        return (x @ _all_experts(w)).view(t, nx, n)
    scale = w.scale.transpose(0, 1)  # [1, X, N]
    if w.a8:
        xq, xs = act if act is not None else activations(x)
        acc = int_mm(xq, _all_experts(w.q)).view(t, nx, n)
        return (acc.to(torch.float32) * xs[:, :, None] * scale).to(x.dtype)
    y = (x @ _all_experts(w.q).to(x.dtype)).view(t, nx, n)
    return y * scale.to(y.dtype)


def expert_batch(x: torch.Tensor, w, act: Activations = None
                 ) -> torch.Tensor:
    """Expert-major rows x [X, T, K] through their own experts w
    [X, K, N] -> [X, T, N] (the JAX "xce,xef->xcf", and "txf,xfe->txe"
    with the token axis second); a W8A8 stack scales each row over X and
    K (EXPERT_BATCH_DIMS, see the module doc) and runs one int8 product
    per expert (`torch._int_mm` is 2-D)."""
    if not isinstance(w, QTensor):
        return torch.bmm(x, w)
    if w.a8:
        xq, xs = act if act is not None else activations(
            x, EXPERT_BATCH_DIMS)
        xq = xq.contiguous()
        acc = torch.stack([int_mm(xq[j], w.q[j])
                           for j in range(w.q.shape[0])])
        return (acc.to(torch.float32) * xs * w.scale).to(x.dtype)
    return torch.bmm(x, w.q.to(x.dtype)) * w.scale.to(x.dtype)
