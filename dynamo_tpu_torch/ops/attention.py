"""Paged attention ops: KV-cache writes, plain PyTorch attention, dispatch.

Port of the bf16 paths of `dynamo_tpu/ops/attention.py`. The KV layout is
the JAX package's, so pools compare byte for byte:

  k_pages, v_pages: [num_pages, page_size, num_kv_heads * head_dim]
  block_table:      [batch, max_pages_per_seq] int32 (page ids; 0 is trash)
  context_lens:     [batch] int32, tokens INCLUDING the current one

The model passes each layer's pool as a view (`k_pages[l]` of the
[L, P, ps, KV*D] pool), and the writes below update it IN PLACE where the
JAX functions returned new arrays.

The plain versions (`*_ref`) compute what the TPU kernels compute: scale
1/sqrt(D) applied to q in f32, f32 softmax and products, the kernels' masks,
and exact zeros for a row that sees no valid token (decode ctx 0, prefill
seq_len 0). The dispatch functions send a CPU tensor to the plain version
and a CUDA tensor to the hand-written kernel in
`dynamo_tpu_torch.ops.cuda_attention`; there is no fallback between them.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Union

import torch

from dynamo_tpu_torch.ops import cuda_attention

SeqLens = Union[int, torch.Tensor]


def write_kv_token(k_pages, v_pages, k_new, v_new, block_table, positions, *,
                   page_size: int) -> None:
    """Scatter one new token's K/V per sequence into its page, in place.

    k_new/v_new [B, KV, D]; block_table [B, Pmax]; positions [B]. Inactive
    slots carry a zero block-table row and position 0, so their writes land
    in the trash page 0. Unlike JAX's dropping scatter, torch indexing
    raises on an out-of-range index: positions // page_size must stay below
    Pmax, which the engine guarantees."""
    b = k_new.shape[0]
    pos = positions.long()
    page_idx = block_table.long().gather(1, (pos // page_size)[:, None])[:, 0]
    slot_idx = pos % page_size
    k_pages[page_idx, slot_idx] = k_new.reshape(b, -1).to(k_pages.dtype)
    v_pages[page_idx, slot_idx] = v_new.reshape(b, -1).to(v_pages.dtype)


def write_kv_prefill(k_pages, v_pages, k_new, v_new, pages, *,
                     page_size: int) -> None:
    """Scatter a padded prompt's K/V [S, KV, D] into its pages [S // ps]
    (trash page 0 pads the list), in place."""
    n_pages = k_new.shape[0] // page_size
    idx = pages.long()
    k_pages[idx] = k_new.reshape(n_pages, page_size, -1).to(k_pages.dtype)
    v_pages[idx] = v_new.reshape(n_pages, page_size, -1).to(v_pages.dtype)


def _attend(q32: torch.Tensor, k32: torch.Tensor, v32: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """q32 [..., KV, G, Q, D] (already scaled), k32/v32 [..., KV, S, D],
    mask broadcastable to [..., KV, G, Q, S] -> f32 [..., KV, G, Q, D] with
    all-masked rows zero."""
    scores = torch.einsum("...kgqd,...ksd->...kgqs", q32, k32)
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("...kgqs,...ksd->...kgqd", probs, v32)
    seen = mask.any(dim=-1, keepdim=True).expand(out.shape[:-1] + (1,))
    return torch.where(seen, out, torch.zeros((), device=out.device))


def paged_attention_decode_ref(q, k_pages, v_pages, block_table, context_lens,
                               *, page_size: int) -> torch.Tensor:
    """Plain paged decode: q [B, H, D] over the pages of each row's block
    table, mask tok < ctx -> [B, H, D]."""
    b, h, d = q.shape
    n_kv = k_pages.shape[-1] // d
    pmax = block_table.shape[1]
    rows = k_pages[block_table.long()]  # [B, Pmax, ps, KV*D]
    k = rows.reshape(b, pmax * page_size, n_kv, d).permute(0, 2, 1, 3)
    v = v_pages[block_table.long()].reshape(b, pmax * page_size, n_kv,
                                            d).permute(0, 2, 1, 3)
    q32 = (q.float() * d ** -0.5).reshape(b, n_kv, h // n_kv, 1, d)
    span = torch.arange(pmax * page_size, device=q.device)
    mask = span[None, :] < context_lens.long()[:, None]  # [B, S]
    out = _attend(q32, k.float(), v.float(), mask[:, None, None, None, :])
    return out.reshape(b, h, d).to(q.dtype)


def prefill_attention_ref(q, k, v, seq_lens: SeqLens) -> torch.Tensor:
    """Plain causal prefill: q [N, S, H, D], k/v [N, S, KV, D], seq_lens [N]
    (or q [S, H, D] with an int seq_len), mask ki <= qi and ki < seq_len."""
    single = q.dim() == 3
    if single:
        q, k, v = q[None], k[None], v[None]
    n, s, h, d = q.shape
    n_kv = k.shape[2]
    lens = torch.as_tensor(seq_lens, device=q.device).long().reshape(-1)
    q32 = (q.float() * d ** -0.5).reshape(n, s, n_kv, h // n_kv, d)
    q32 = q32.permute(0, 2, 3, 1, 4)  # [N, KV, G, S, D]
    k32 = k.float().permute(0, 2, 1, 3)  # [N, KV, S, D]
    v32 = v.float().permute(0, 2, 1, 3)
    qi = torch.arange(s, device=q.device)[:, None]
    ki = torch.arange(s, device=q.device)[None, :]
    mask = (ki <= qi)[None] & (ki[None] < lens[:, None, None])  # [N, S, S]
    out = _attend(q32, k32, v32, mask[:, None, None])  # [N, KV, G, S, D]
    out = out.permute(0, 3, 1, 2, 4).reshape(n, s, h, d).to(q.dtype)
    return out[0] if single else out


def chunk_attention_ref(q, k_pages, v_pages, pages, start: int, *,
                        page_size: int) -> torch.Tensor:
    """Plain chunked-prefill attention: C queries at absolute positions
    start..start+C-1 over the sequence's pages [W] (prefix plus the chunk,
    already written), mask tok <= start + i -> [C, H, D]."""
    c, h, d = q.shape
    n_kv = k_pages.shape[-1] // d
    s_ctx = pages.shape[0] * page_size
    k = k_pages[pages.long()].reshape(s_ctx, n_kv, d).permute(1, 0, 2)
    v = v_pages[pages.long()].reshape(s_ctx, n_kv, d).permute(1, 0, 2)
    q32 = (q.float() * d ** -0.5).reshape(c, n_kv, h // n_kv, d)
    q32 = q32.permute(1, 2, 0, 3)  # [KV, G, C, D]
    qpos = int(start) + torch.arange(c, device=q.device)[:, None]
    kpos = torch.arange(s_ctx, device=q.device)[None, :]
    out = _attend(q32, k.float(), v.float(), (kpos <= qpos)[None, None])
    return out.permute(2, 0, 1, 3).reshape(c, h, d).to(q.dtype)


# ----------------------------------------------------------- dispatch --


def paged_attention_decode(q, k_pages, v_pages, block_table, context_lens, *,
                           page_size: int) -> torch.Tensor:
    if q.is_cuda:
        return cuda_attention.paged_attention_decode(
            q, k_pages, v_pages, block_table, context_lens,
            page_size=page_size)
    return paged_attention_decode_ref(q, k_pages, v_pages, block_table,
                                      context_lens, page_size=page_size)


def prefill_attention(q, k, v, seq_lens: SeqLens) -> torch.Tensor:
    if q.is_cuda:
        single = q.dim() == 3
        lens = seq_lens
        if not isinstance(lens, torch.Tensor):
            lens = torch.tensor([int(lens)], dtype=torch.int32)
        lens = lens.to(device=q.device, dtype=torch.int32).reshape(-1)
        if single:
            return cuda_attention.prefill_attention(
                q[None], k[None], v[None], lens)[0]
        return cuda_attention.prefill_attention(q, k, v, lens)
    return prefill_attention_ref(q, k, v, seq_lens)


def chunk_attention(q, k_pages, v_pages, pages, start: int, *,
                    page_size: int) -> torch.Tensor:
    if q.is_cuda:
        return cuda_attention.chunk_prefill_attention(
            q, k_pages, v_pages, pages, start, page_size=page_size)
    return chunk_attention_ref(q, k_pages, v_pages, pages, start,
                               page_size=page_size)


class AttentionFns(NamedTuple):
    """The three attention functions a forward pass calls."""

    decode: Callable
    prefill: Callable
    chunk: Callable


# the serving path: kernels on the card, plain versions on the CPU
DISPATCH = AttentionFns(paged_attention_decode, prefill_attention,
                        chunk_attention)
# the plain versions on any device (the card-side reference)
PLAIN = AttentionFns(paged_attention_decode_ref, prefill_attention_ref,
                     chunk_attention_ref)
