"""The JSON grammar kernel's wrappers: `json_mask` and `json_advance`.

The kernel (`csrc/json_mask.cu`) is built into the attention kernels'
library (`cuda_attention.build`: every `csrc/*.cu`) and counted in the same
`cuda_attention.LAUNCHES`, so a captured decode step records its launches
and every replay adds them (`cuda_attention.counting_capture`). It ports
no Pallas kernel: the JAX package fuses the same mask into its jitted
decode window (see the source's header).

Each wrapper takes the tensors of one guided decode step: logits [B, V]
(bf16 or float32) or the sampled tokens [B] int64, the grammar state
mode, depth, bits [B] int32 (advanced in place), active [B] bool (the
guided rows) and a `json_guide.DeviceTable` on the same device. On CPU
tensors it runs the plain PyTorch version (`json_guide.mask_logits`,
`json_guide.advance`); on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from dynamo_tpu_torch.ops import cuda_attention as ca
from dynamo_tpu_torch.ops import json_guide
from dynamo_tpu_torch.ops.json_guide import DeviceTable


def _check_state(mode, depth, bits, active, table: DeviceTable,
                 dev: torch.device) -> int:
    b = mode.shape[0]
    for t, name in ((mode, "mode"), (depth, "depth"), (bits, "bits")):
        ca._expect(t, name, torch.int32, 1, dev)
    ca._expect(active, "active", torch.bool, 1, dev)
    if not (depth.shape[0] == bits.shape[0] == active.shape[0] == b):
        raise ValueError("mode, depth, bits and active differ in length")
    ca._expect(table.token_bytes, "token_bytes", torch.uint8, 2, dev)
    ca._expect(table.token_len, "token_len", torch.int32, 1, dev)
    ca._expect(table.eos, "eos", torch.uint8, 1, dev)
    v = table.token_bytes.shape[0]
    if (table.token_bytes.shape[1] != json_guide.TABLE_WIDTH
            or table.token_len.shape[0] != v or table.eos.shape[0] != v):
        raise ValueError(f"the device table must be [V, "
                         f"{json_guide.TABLE_WIDTH}] bytes with [V] lengths "
                         f"and stop flags")
    if table.token_bytes.data_ptr() % 16:
        raise ValueError("token_bytes must be 16-byte aligned")
    return b


def json_mask(logits, mode, depth, bits, active, table: DeviceTable):
    """In place: the logits [B, V] of each active row get -1e9 wherever
    the row's grammar state allows no token. Returns logits."""
    if logits.device.type == "cpu":
        return json_guide.mask_logits(logits, mode, depth, bits, active,
                                      table)
    dev = logits.device
    if logits.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"logits must be bf16 or float32, got "
                         f"{logits.dtype}")
    if logits.dim() != 2 or not logits.is_contiguous():
        raise ValueError("logits must be a contiguous [B, V] tensor")
    b = _check_state(mode, depth, bits, active, table, dev)
    if logits.shape != (b, table.vocab_size):
        raise ValueError(f"logits {tuple(logits.shape)} do not match "
                         f"[{b}, {table.vocab_size}]")
    lib = ca.build()
    p = ca._ptr
    rc = lib.dtt_json_mask(
        p(logits), int(logits.dtype == torch.bfloat16), p(mode), p(depth),
        p(bits), p(active), p(table.token_bytes), p(table.token_len),
        p(table.eos), b, table.vocab_size, ca._stream(logits))
    ca._raise_on(lib, rc, "json_mask")
    ca._count("json_mask")
    return logits


def json_advance(tokens, mode, depth, bits, active,
                 table: DeviceTable) -> None:
    """In place: each active row's state folds the bytes of its sampled
    token tokens [B] int64."""
    if tokens.device.type == "cpu":
        json_guide.advance(tokens, mode, depth, bits, active, table)
        return
    dev = tokens.device
    ca._expect(tokens, "tokens", torch.int64, 1, dev)
    b = _check_state(mode, depth, bits, active, table, dev)
    if tokens.shape[0] != b:
        raise ValueError("tokens and the grammar state differ in length")
    lib = ca.build()
    p = ca._ptr
    rc = lib.dtt_json_advance(
        p(tokens), p(mode), p(depth), p(bits), p(active),
        p(table.token_bytes), p(table.token_len), b, table.vocab_size,
        ca._stream(tokens))
    ca._raise_on(lib, rc, "json_advance")
    ca._count("json_advance")
