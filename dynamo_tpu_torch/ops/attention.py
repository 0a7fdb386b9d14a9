"""Paged attention ops: KV-cache writes, plain PyTorch attention, dispatch.

Port of the single-device paths of `dynamo_tpu/ops/attention.py`. The KV
layout is the JAX package's, so pools compare byte for byte:

  k_pages, v_pages: [num_pages, page_size, lane_width]
  block_table:      [batch, max_pages_per_seq] int32 (page ids; 0 is trash)
  context_lens:     [batch] int32, tokens INCLUDING the current one

A pool row is either the token's K (or V) in the model dtype, KV heads fused
(lane_width = KV*D, head h at lanes [h*D, (h+1)*D)), or an int8 packed row
(`kv_cache_dtype="int8"`):

  [KV*D int8 values | KV bf16 scales as 2*KV int8 lanes | zero pad]

padded to a multiple of 128 lanes (`kv_lane_width`). A head's scale is
amax/127 of its D values, rounded to bf16 and stored little-endian; a value
dequantizes as value * scale, exact in f32. This is the JAX package's
single-block layout (its tensor-parallel lane blocking is not ported). An
int8 pool does not encode its KV-head count, so every function that reads a
pool takes `num_kv_heads`, required for int8 pools.

The model passes each layer's pool as a view (`k_pages[l]` of the
[L, P, ps, W] pool), and the writes below update it IN PLACE where the JAX
functions returned new arrays.

The plain versions (`*_ref`) compute what the TPU kernels compute: scale
1/sqrt(D) applied to q in f32, K/V read (or dequantized) into f32, f32
softmax and products, the kernels' masks, and exact zeros for a row that
sees no valid token (decode ctx 0, prefill seq_len 0). Every function
also takes Gemma-2/3's two score modifiers, as the JAX package's XLA
references do (`dynamo_tpu/ops/attention.py`, `window=` and
`logit_cap=`): `window` > 0 lets a query at position p see key k only
where p - window < k (the window counts the query's own position; 0 is
no lower bound, a global layer's), and `logit_cap` > 0 caps each scaled
score s to cap * tanh(s / cap) before the mask (0 is no cap). Both are
host numbers, one per layer. The dispatch
functions send a CPU tensor to the plain version and a CUDA tensor to the
hand-written kernel in `dynamo_tpu_torch.ops.cuda_attention`; there is no
fallback between them.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import torch

from dynamo_tpu_torch.ops import cuda_attention

SeqLens = Union[int, torch.Tensor]


# ----------------------------------------------------------- int8 rows --


def kv_lane_width(n_kv: int, head_dim: int, quantized: bool) -> int:
    """Lane (last-dim) width of one KV page row."""
    if not quantized:
        return n_kv * head_dim
    return -(-(n_kv * head_dim + 2 * n_kv) // 128) * 128


def pack_kv_rows(x: torch.Tensor, lane_width: int) -> torch.Tensor:
    """[T, KV, D] values -> [T, lane_width] int8 packed rows."""
    t, kv, d = x.shape
    x32 = x.float()
    amax = x32.abs().amax(dim=2)  # [T, KV]
    scale = torch.where(amax > 0, amax / 127.0,
                        torch.ones((), device=x.device)).to(torch.bfloat16)
    q = torch.clamp(torch.round(x32 / scale.float()[:, :, None]), -127,
                    127).to(torch.int8)
    sc8 = scale.contiguous().view(torch.int8)  # [T, 2*KV], little-endian
    rows = torch.zeros((t, lane_width), dtype=torch.int8, device=x.device)
    rows[:, :kv * d] = q.reshape(t, kv * d)
    rows[:, kv * d:kv * d + 2 * kv] = sc8
    return rows


def unpack_kv_rows(rows: torch.Tensor, n_kv: int, head_dim: int
                   ) -> torch.Tensor:
    """[..., lane_width] int8 rows -> [..., KV, D] float32 values."""
    lead = rows.shape[:-1]
    kvd = n_kv * head_dim
    q = rows[..., :kvd].reshape(*lead, n_kv, head_dim)
    scale = rows[..., kvd:kvd + 2 * n_kv].contiguous().view(torch.bfloat16)
    return q.float() * scale.float()[..., None]


def pool_kv_heads(k_pages: torch.Tensor, head_dim: int,
                  num_kv_heads: Optional[int]) -> int:
    """KV-head count of a pool: a model-dtype pool's lane width encodes it;
    an int8 pool (packed scale lanes) needs the caller to say."""
    if k_pages.dtype == torch.int8:
        if num_kv_heads is None:
            raise ValueError("int8 KV pools need explicit num_kv_heads")
        return num_kv_heads
    return k_pages.shape[-1] // head_dim


def _paged_kv(pool: torch.Tensor, idx: torch.Tensor, n_kv: int,
              head_dim: int) -> torch.Tensor:
    """Pages `idx` [..., W] of `pool` as f32 [..., KV, W*ps, D] (int8 rows
    dequantized)."""
    rows = pool[idx.long()]  # [..., W, ps, lanes]
    rows = rows.reshape(*idx.shape[:-1], -1, rows.shape[-1])
    if pool.dtype == torch.int8:
        kv = unpack_kv_rows(rows, n_kv, head_dim)
    else:
        kv = rows.reshape(*rows.shape[:-1], n_kv, head_dim).float()
    return kv.transpose(-3, -2)


def _pool_rows(pool: torch.Tensor, k_new: torch.Tensor) -> torch.Tensor:
    """New K or V [T, KV, D] as pool rows [T, lane_width]."""
    if pool.dtype == torch.int8:
        return pack_kv_rows(k_new, pool.shape[-1])
    return k_new.reshape(k_new.shape[0], -1).to(pool.dtype)


# ------------------------------------------------------------- writes --


def write_kv_token(k_pages, v_pages, k_new, v_new, block_table, positions, *,
                   page_size: int) -> None:
    """Scatter one new token's K/V per sequence into its page, in place.

    k_new/v_new [B, KV, D]; block_table [B, Pmax]; positions [B]. Inactive
    slots carry a zero block-table row and position 0, so their writes land
    in the trash page 0. Unlike JAX's dropping scatter, torch indexing
    raises on an out-of-range index: positions // page_size must stay below
    Pmax, which the engine guarantees."""
    pos = positions.long()
    page_idx = block_table.long().gather(1, (pos // page_size)[:, None])[:, 0]
    slot_idx = pos % page_size
    k_pages[page_idx, slot_idx] = _pool_rows(k_pages, k_new)
    v_pages[page_idx, slot_idx] = _pool_rows(v_pages, v_new)


def write_kv_prefill(k_pages, v_pages, k_new, v_new, pages, *,
                     page_size: int) -> None:
    """Scatter a padded prompt's K/V [S, KV, D] into its pages [S // ps]
    (trash page 0 pads the list), in place."""
    n_pages = k_new.shape[0] // page_size
    idx = pages.long()
    k_pages[idx] = _pool_rows(k_pages, k_new).reshape(n_pages, page_size, -1)
    v_pages[idx] = _pool_rows(v_pages, v_new).reshape(n_pages, page_size, -1)


# ------------------------------------------------------ plain versions --


def _attend(q32: torch.Tensor, k32: torch.Tensor, v32: torch.Tensor,
            mask: torch.Tensor, logit_cap: float = 0.0) -> torch.Tensor:
    """q32 [..., KV, G, Q, D] (already scaled), k32/v32 [..., KV, S, D],
    mask broadcastable to [..., KV, G, Q, S] -> f32 [..., KV, G, Q, D] with
    all-masked rows zero; scores capped to cap * tanh(s / cap) first where
    logit_cap > 0."""
    scores = torch.einsum("...kgqd,...ksd->...kgqs", q32, k32)
    if logit_cap > 0:
        scores = logit_cap * torch.tanh(scores / logit_cap)
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("...kgqs,...ksd->...kgqd", probs, v32)
    seen = mask.any(dim=-1, keepdim=True).expand(out.shape[:-1] + (1,))
    return torch.where(seen, out, torch.zeros((), device=out.device))


def _in_window(kpos: torch.Tensor, qpos: torch.Tensor, window: int
               ) -> torch.Tensor:
    """Keys kpos a query at qpos sees under a sliding window (broadcast):
    qpos - window < kpos, or every key for window 0."""
    if window > 0:
        return kpos > qpos - window
    return torch.ones((), dtype=torch.bool, device=kpos.device)


def paged_attention_decode_ref(q, k_pages, v_pages, block_table, context_lens,
                               *, page_size: int,
                               num_kv_heads: Optional[int] = None,
                               window: int = 0, logit_cap: float = 0.0
                               ) -> torch.Tensor:
    """Plain paged decode: q [B, H, D] over the pages of each row's block
    table, mask tok < ctx (and ctx - 1 - window < tok) -> [B, H, D]."""
    b, h, d = q.shape
    n_kv = pool_kv_heads(k_pages, d, num_kv_heads)
    k = _paged_kv(k_pages, block_table, n_kv, d)  # [B, KV, S, D]
    v = _paged_kv(v_pages, block_table, n_kv, d)
    q32 = (q.float() * d ** -0.5).reshape(b, n_kv, h // n_kv, 1, d)
    span = torch.arange(k.shape[2], device=q.device)[None, :]
    ctx = context_lens.long()[:, None]
    mask = (span < ctx) & _in_window(span, ctx - 1, window)  # [B, S]
    out = _attend(q32, k, v, mask[:, None, None, None, :], logit_cap)
    return out.reshape(b, h, d).to(q.dtype)


def prefill_attention_ref(q, k, v, seq_lens: SeqLens, *, window: int = 0,
                          logit_cap: float = 0.0) -> torch.Tensor:
    """Plain causal prefill: q [N, S, H, D], k/v [N, S, KV, D], seq_lens [N]
    (or q [S, H, D] with an int seq_len), mask ki <= qi and ki < seq_len
    (and qi - window < ki)."""
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
    mask = ((ki <= qi) & _in_window(ki, qi, window))[None] \
        & (ki[None] < lens[:, None, None])  # [N, S, S]
    out = _attend(q32, k32, v32, mask[:, None, None],
                  logit_cap)  # [N, KV, G, S, D]
    out = out.permute(0, 3, 1, 2, 4).reshape(n, s, h, d).to(q.dtype)
    return out[0] if single else out


def chunk_attention_ref(q, k_pages, v_pages, pages, start: int, *,
                        page_size: int, num_kv_heads: Optional[int] = None,
                        window: int = 0, logit_cap: float = 0.0
                        ) -> torch.Tensor:
    """Plain chunked-prefill attention: C queries at absolute positions
    start..start+C-1 over the sequence's pages [W] (prefix plus the chunk,
    already written), mask tok <= start + i (and start + i - window < tok)
    -> [C, H, D]."""
    c, h, d = q.shape
    n_kv = pool_kv_heads(k_pages, d, num_kv_heads)
    k = _paged_kv(k_pages, pages, n_kv, d)  # [KV, S, D]
    v = _paged_kv(v_pages, pages, n_kv, d)
    q32 = (q.float() * d ** -0.5).reshape(c, n_kv, h // n_kv, d)
    q32 = q32.permute(1, 2, 0, 3)  # [KV, G, C, D]
    qpos = int(start) + torch.arange(c, device=q.device)[:, None]
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = (kpos <= qpos) & _in_window(kpos, qpos, window)
    out = _attend(q32, k, v, mask[None, None], logit_cap)
    return out.permute(2, 0, 1, 3).reshape(c, h, d).to(q.dtype)


def ragged_paged_attention_ref(q, k_pages, v_pages, tables, kv_lens,
                               q_starts, *, page_size: int,
                               num_kv_heads: Optional[int], num_decode: int,
                               decode_q: int = 1, window: int = 0,
                               logit_cap: float = 0.0) -> torch.Tensor:
    """Plain ragged attention, the TPU ragged kernel's contract read from
    the descriptors: q [num_decode*decode_q + C, H, D] holds num_decode
    rows of decode_q queries, then one chunk of C; row r (r = num_decode
    for the chunk) reads pages tables[r] [W], and its query j sits at
    q_starts[r] + j and sees key tok iff tok <= q_starts[r] + j and
    tok < kv_lens[r] (and q_starts[r] + j - window < tok)
    -> [num_decode*decode_q + C, H, D]."""
    total, h, d = q.shape
    nd = num_decode * decode_q
    c = total - nd
    n_kv = pool_kv_heads(k_pages, d, num_kv_heads)
    g = h // n_kv
    k = _paged_kv(k_pages, tables, n_kv, d)  # [R, KV, S, D]
    v = _paged_kv(v_pages, tables, n_kv, d)
    tok = torch.arange(k.shape[2], device=q.device)
    kv_lens, q_starts = kv_lens.long(), q_starts.long()

    def rows(qr, kr, vr, qpos, kv_len):
        # qr [N, Q, H, D] -> [N, Q, H, D]; qpos [N, Q]; kv_len [N]
        n, nq = qr.shape[:2]
        q32 = (qr.float() * d ** -0.5).reshape(n, nq, n_kv, g, d)
        kpos, at = tok[None, None], qpos[:, :, None]
        mask = ((kpos <= at) & _in_window(kpos, at, window)
                & (kpos < kv_len[:, None, None]))  # [N, Q, S]
        out = _attend(q32.permute(0, 2, 3, 1, 4), kr, vr,
                      mask[:, None, None], logit_cap)  # [N, KV, G, Q, D]
        return out.permute(0, 3, 1, 2, 4).reshape(n, nq, h, d)

    j = torch.arange(decode_q, device=q.device)
    dec = rows(q[:nd].reshape(num_decode, decode_q, h, d), k[:num_decode],
               v[:num_decode], q_starts[:num_decode, None] + j[None],
               kv_lens[:num_decode]).reshape(nd, h, d)
    i = torch.arange(c, device=q.device)
    chk = rows(q[nd:][None], k[num_decode:], v[num_decode:],
               (q_starts[num_decode] + i)[None], kv_lens[num_decode:])[0]
    return torch.cat([dec, chk]).to(q.dtype)


def ragged_descriptors(block_tables, context_lens, p_pages, p_start: int,
                       c: int):
    """The ragged kernel's descriptors for B decode rows plus one C-token
    chunk, built as `dynamo_tpu.ops.attention.ragged_mixed_attention`
    builds them: tables [B+1, max(Pmax, Wp)] (zero, i.e. trash, padded;
    the last row is the chunk's pages), kv_lens [B+1] (each decode row's
    context, then p_start + C) and q_starts [B+1] (max(ctx - 1, 0), then
    p_start)."""
    b, pmax = block_tables.shape
    wp = p_pages.shape[0]
    tabs = torch.zeros((b + 1, max(pmax, wp)), dtype=torch.int32,
                       device=block_tables.device)
    tabs[:b, :pmax] = block_tables
    tabs[b, :wp] = p_pages
    cl = context_lens.to(torch.int32)
    kv_lens = torch.cat([cl, cl.new_full((1,), int(p_start) + c)])
    q_starts = torch.cat([torch.clamp(cl - 1, min=0),
                          cl.new_full((1,), int(p_start))])
    return tabs, kv_lens, q_starts


def ragged_mixed_attention_ref(q, k_pages, v_pages, block_tables,
                               context_lens, p_pages, p_start: int, *,
                               page_size: int,
                               num_kv_heads: Optional[int] = None,
                               num_decode: int, window: int = 0,
                               logit_cap: float = 0.0) -> torch.Tensor:
    """Plain mixed-batch attention: q [B + C, H, D], B decode rows over
    their block tables then one chunk over its page list."""
    desc = ragged_descriptors(block_tables, context_lens, p_pages, p_start,
                              q.shape[0] - num_decode)
    return ragged_paged_attention_ref(
        q, k_pages, v_pages, *desc, page_size=page_size,
        num_kv_heads=num_kv_heads, num_decode=num_decode, window=window,
        logit_cap=logit_cap)


def verify_attention_ref(q, k_pages, v_pages, block_table, positions, *,
                         page_size: int, num_kv_heads: Optional[int] = None,
                         window: int = 0, logit_cap: float = 0.0
                         ) -> torch.Tensor:
    """Plain speculative-verify attention (JAX `verify_attention`): q
    [B, K1, H, D], the current token and K drafts of each sequence, whose
    K/V are already written; query j of sequence b sits at positions[b] + j
    and attends causally over the sequence's pages block_table [B, Pmax]
    -> [B, K1, H, D]. Inactive slots (a zero table row at position 0) see
    only the trash page."""
    b, k1, h, d = q.shape
    n_kv = pool_kv_heads(k_pages, d, num_kv_heads)
    k = _paged_kv(k_pages, block_table, n_kv, d)  # [B, KV, S, D]
    v = _paged_kv(v_pages, block_table, n_kv, d)
    q32 = (q.float() * d ** -0.5).reshape(b, k1, n_kv, h // n_kv, d)
    qpos = (positions.long()[:, None]
            + torch.arange(k1, device=q.device)[None, :])  # [B, K1]
    spos = torch.arange(k.shape[2], device=q.device)[None, None, :]
    at = qpos[:, :, None]
    mask = (spos <= at) & _in_window(spos, at, window)  # [B, K1, S]
    out = _attend(q32.permute(0, 2, 3, 1, 4), k, v, mask[:, None, None],
                  logit_cap)
    return out.permute(0, 3, 1, 2, 4).reshape(b, k1, h, d).to(q.dtype)


def ragged_verify_descriptors(block_tables, positions, k1: int,
                              p_pages=None, p_start: int = 0, c: int = 0):
    """The ragged kernel's descriptors for B verify windows of K1 queries
    plus one C-token chunk, JAX's unified ones
    (`dynamo_tpu.ops.attention.ragged_verify_attention`): tables
    [B+1, max(Pmax, Wp)] (zero-padded; the last row is the chunk's pages),
    kv_lens [B+1] (positions + K1, so each window's horizon covers every
    draft written this step, then p_start + C) and q_starts [B+1]
    (positions, then p_start). Without a chunk (p_pages None, C = 0) the
    last row is the trash page at kv_len 0, which the kernel never reads."""
    b, pmax = block_tables.shape
    wp = 0 if p_pages is None else p_pages.shape[0]
    tabs = torch.zeros((b + 1, max(pmax, wp)), dtype=torch.int32,
                       device=block_tables.device)
    tabs[:b, :pmax] = block_tables
    if wp:
        tabs[b, :wp] = p_pages
    ps = positions.to(torch.int32)
    kv_lens = torch.cat([ps + k1, ps.new_full((1,), int(p_start) + c)])
    q_starts = torch.cat([ps, ps.new_full((1,), int(p_start))])
    return tabs, kv_lens, q_starts


def ragged_verify_attention_ref(q, k_pages, v_pages, block_tables, positions,
                                p_pages, p_start: int, *, page_size: int,
                                num_kv_heads: Optional[int] = None,
                                num_verify: int, verify_width: int,
                                window: int = 0, logit_cap: float = 0.0
                                ) -> torch.Tensor:
    """Plain mixed verify attention: q [B*K1 + C, H, D], B verify windows
    of K1 queries over their block tables, then one chunk over its page
    list."""
    c = q.shape[0] - num_verify * verify_width
    desc = ragged_verify_descriptors(block_tables, positions, verify_width,
                                     p_pages, p_start, c)
    return ragged_paged_attention_ref(
        q, k_pages, v_pages, *desc, page_size=page_size,
        num_kv_heads=num_kv_heads, num_decode=num_verify,
        decode_q=verify_width, window=window, logit_cap=logit_cap)


# ----------------------------------------------------------- dispatch --


def paged_attention_decode(q, k_pages, v_pages, block_table, context_lens, *,
                           page_size: int, num_kv_heads: Optional[int] = None,
                           window: int = 0, logit_cap: float = 0.0
                           ) -> torch.Tensor:
    fn = (cuda_attention.paged_attention_decode if q.is_cuda
          else paged_attention_decode_ref)
    return fn(q, k_pages, v_pages, block_table, context_lens,
              page_size=page_size, num_kv_heads=num_kv_heads, window=window,
              logit_cap=logit_cap)


def prefill_attention(q, k, v, seq_lens: SeqLens, *, window: int = 0,
                      logit_cap: float = 0.0) -> torch.Tensor:
    if q.is_cuda:
        single = q.dim() == 3
        lens = seq_lens
        if not isinstance(lens, torch.Tensor):
            lens = torch.tensor([int(lens)], dtype=torch.int32)
        lens = lens.to(device=q.device, dtype=torch.int32).reshape(-1)
        if single:
            return cuda_attention.prefill_attention(
                q[None], k[None], v[None], lens, window=window,
                logit_cap=logit_cap)[0]
        return cuda_attention.prefill_attention(q, k, v, lens, window=window,
                                                logit_cap=logit_cap)
    return prefill_attention_ref(q, k, v, seq_lens, window=window,
                                 logit_cap=logit_cap)


def chunk_attention(q, k_pages, v_pages, pages, start: int, *,
                    page_size: int, num_kv_heads: Optional[int] = None,
                    window: int = 0, logit_cap: float = 0.0) -> torch.Tensor:
    fn = (cuda_attention.chunk_prefill_attention if q.is_cuda
          else chunk_attention_ref)
    return fn(q, k_pages, v_pages, pages, start, page_size=page_size,
              num_kv_heads=num_kv_heads, window=window, logit_cap=logit_cap)


def ragged_mixed_attention(q, k_pages, v_pages, block_tables, context_lens,
                           p_pages, p_start: int, *, page_size: int,
                           num_kv_heads: Optional[int] = None,
                           num_decode: int, window: int = 0,
                           logit_cap: float = 0.0) -> torch.Tensor:
    """Mixed-batch attention (the engine's mixed step): q [B + C, H, D],
    B decode rows then one C-token chunk at p_start, in one ragged
    kernel launch on the card."""
    desc = ragged_descriptors(block_tables, context_lens, p_pages, p_start,
                              q.shape[0] - num_decode)
    ragged = (cuda_attention.ragged_paged_attention if q.is_cuda
              else ragged_paged_attention_ref)
    return ragged(q, k_pages, v_pages, *desc, page_size=page_size,
                  num_kv_heads=num_kv_heads, num_decode=num_decode,
                  window=window, logit_cap=logit_cap)


def verify_attention(q, k_pages, v_pages, block_table, positions, *,
                     page_size: int, num_kv_heads: Optional[int] = None,
                     window: int = 0, logit_cap: float = 0.0
                     ) -> torch.Tensor:
    """Speculative-verify attention, q [B, K1, H, D] -> [B, K1, H, D]: on
    the card the ragged kernel with B rows of K1 queries and no chunk
    (C = 0), the same kernel the mixed verify step runs; on the CPU
    verify_attention_ref."""
    if not q.is_cuda:
        return verify_attention_ref(q, k_pages, v_pages, block_table,
                                    positions, page_size=page_size,
                                    num_kv_heads=num_kv_heads, window=window,
                                    logit_cap=logit_cap)
    b, k1, h, d = q.shape
    desc = ragged_verify_descriptors(block_table, positions, k1)
    out = cuda_attention.ragged_paged_attention(
        q.reshape(b * k1, h, d), k_pages, v_pages, *desc,
        page_size=page_size, num_kv_heads=num_kv_heads, num_decode=b,
        decode_q=k1, window=window, logit_cap=logit_cap)
    return out.view(b, k1, h, d)


def ragged_verify_attention(q, k_pages, v_pages, block_tables, positions,
                            p_pages, p_start: int, *, page_size: int,
                            num_kv_heads: Optional[int] = None,
                            num_verify: int, verify_width: int,
                            window: int = 0, logit_cap: float = 0.0
                            ) -> torch.Tensor:
    """Mixed verify attention (the engine's mixed speculative step): q
    [B*K1 + C, H, D], B verify windows of K1 queries (window b's query j at
    positions[b] + j) then one C-token chunk at p_start, in one ragged
    kernel launch on the card (decode_q = K1)."""
    c = q.shape[0] - num_verify * verify_width
    desc = ragged_verify_descriptors(block_tables, positions, verify_width,
                                     p_pages, p_start, c)
    ragged = (cuda_attention.ragged_paged_attention if q.is_cuda
              else ragged_paged_attention_ref)
    return ragged(q, k_pages, v_pages, *desc, page_size=page_size,
                  num_kv_heads=num_kv_heads, num_decode=num_verify,
                  decode_q=verify_width, window=window, logit_cap=logit_cap)


class AttentionFns(NamedTuple):
    """The attention functions a forward pass calls."""

    decode: Callable
    prefill: Callable
    chunk: Callable
    ragged: Callable
    verify: Callable
    ragged_verify: Callable


# the serving path: kernels on the card, plain versions on the CPU
DISPATCH = AttentionFns(paged_attention_decode, prefill_attention,
                        chunk_attention, ragged_mixed_attention,
                        verify_attention, ragged_verify_attention)
# the plain versions on any device (the card-side reference)
PLAIN = AttentionFns(paged_attention_decode_ref, prefill_attention_ref,
                     chunk_attention_ref, ragged_mixed_attention_ref,
                     verify_attention_ref, ragged_verify_attention_ref)
