"""The tensor-core tile's launch plans and the split-key decode rows, on
the CPU.

- The launch plans of the tile (`cuda_attention.tile_positions`,
  `check_decode_rows`, `split_keys`, `split_plan`, `split_spans`) are pure
  functions of host-known sizes. Every (query, visible key) pair is walked
  by exactly one block: chunk.cu's query tiles, prefill.cu's query tiles
  per lane (padding rows past seq_len, a lane at seq_len 0, S = 48), and
  the split decode rows of decode.cu (a [B, Pmax] table, contexts 0, 1,
  255, 256, 257 and full) and ragged.cu; no block reads a page past the
  list's width, the decode blocks stay within SPLIT_BLOCKS_PER_SM per SM
  whatever the table's width, and the tile's limits (head_dim 32, 64 or
  128, a GQA group of at most 64, a decode row of at most 64 rows) raise
  ValueError.
- The split-and-merge formula of the decode rows, in plain f32 PyTorch
  (`_partials` then `_merge`, models of decode_split_block and of
  merge_splits_kernel), at tiny-debug sizes (H 4, KV 2, D 32) on f32 and
  int8 pools, with the H100's spans and a small card's one span: against
  the plain ragged attention and the Pallas ragged kernel in interpret
  mode (ragged.cu's rows), and against the plain decode attention and the
  Pallas decode kernel in interpret mode (decode.cu's rows: decode_q = 1,
  queries at ctx - 1). Rows: context 0, spans that see no key, rows ending
  on a split boundary (256) and one key past it (257), a full table.
  Tolerance 1e-5: all are f32, and only the order of the sums differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import pallas_attention as pa
from dynamo_tpu.ops import ragged_attention as ra
from dynamo_tpu_torch.ops import attention as att
from dynamo_tpu_torch.ops import cuda_attention as ca

TOL = dict(rtol=1e-5, atol=1e-5)
LOG2E = 1.4426950408889634
H100_SMS = 132


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module: the parallel test workers share
    the cores, and torch's default pool in each of them oversubscribes
    them (the suite's tiny eager ops are as fast on one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _chunk_tiles(c, group, head_dim):
    """(first query, query count) of each query tile of a C-query chunk:
    chunk.cu's blocks along x, and the chunk blocks of ragged.cu."""
    pos = ca.tile_positions(group, head_dim)
    return [(i, min(pos, c - i)) for i in range(0, c, pos)]


def _walked(lo, hi, first_pos, n_pos, kv_len, width_keys):
    """Visible (query, key) pairs a block walks, as a [n_pos, width_keys]
    0/1 array: keys [lo, min(hi, first_pos + n_pos, kv_len)), masked by
    tok <= position."""
    horizon = min(hi, first_pos + n_pos, kv_len)
    assert horizon <= width_keys  # the page list is never read past W
    tok = np.arange(width_keys)[None]
    pos = first_pos + np.arange(n_pos)[:, None]
    return ((tok >= lo) & (tok < horizon) & (tok <= pos)).astype(np.int64)


def _visible(first_pos, n_pos, kv_len, width_keys):
    tok = np.arange(width_keys)[None]
    pos = first_pos + np.arange(n_pos)[:, None]
    return (tok <= pos) & (tok < kv_len)


@pytest.mark.parametrize("group", [1, 2, 3, 4, 8, 64])
@pytest.mark.parametrize("c", [1, 17, 100, 256])
def test_chunk_tiles_walk_each_visible_pair_once(c, group):
    start, ps = 37, 16
    width_keys = -(-(start + c) // ps) * ps
    tiles = _chunk_tiles(c, group, 128)
    count = np.zeros((c, width_keys), np.int64)
    for k, (first, n) in enumerate(tiles):
        assert 1 <= n and n * group <= ca.TILE_ROWS
        if k < len(tiles) - 1:  # full tiles but the last
            assert n == ca.TILE_ROWS // group
        count[first:first + n] += _walked(0, np.inf, start + first, n,
                                          start + c, width_keys)
    vis = _visible(start, c, start + c, width_keys)
    assert (count[vis] == 1).all() and (count[~vis] == 0).all()


@pytest.mark.parametrize("head_dim", [16, 32, 48, 64, 80, 96, 128, 256])
@pytest.mark.parametrize("group", [1, 2, 4, 8, 64])
def test_tile_takes_only_the_head_dims_it_is_built_for(head_dim, group):
    if head_dim in (32, 64, 128, 256):
        assert ca.tile_positions(group, head_dim) == 64 // group
        assert _chunk_tiles(64, group, head_dim)[0] == (0, 64 // group)
    else:
        with pytest.raises(ValueError, match="built for head_dim"):
            ca.tile_positions(group, head_dim)


@pytest.mark.parametrize("width,page_size,num_decode,num_kv", [
    (1, 16, 1, 1), (16, 16, 8, 8), (17, 16, 8, 8), (128, 16, 8, 8),
    (5, 4, 2, 2), (64, 4, 3, 2), (3, 100, 1, 8)])
def test_split_spans_partition_the_table(width, page_size, num_decode,
                                         num_kv):
    keys = width * page_size
    span = ca.split_keys(width, page_size, num_decode, num_kv, H100_SMS)
    spans = ca.split_spans(width, page_size, num_decode, num_kv, H100_SMS)
    assert span >= ca.SPLIT_KEYS and span % ca.KEY_TILE == 0
    assert len(spans) == -(-keys // span)
    assert spans[0][0] == 0 and spans[-1][1] == keys
    for (_, hi), (lo, _) in zip(spans, spans[1:]):
        assert hi == lo
    assert all(lo < keys and 0 < hi - lo <= span for lo, hi in spans)


@pytest.mark.parametrize("width,page_size,num_decode,num_kv,sms,want", [
    (128, 16, 8, 8, 132, 256),       # the smoke's table: 8 spans of 256
    (8192, 16, 8, 8, 132, 16384),    # a 128k context: 8 spans, not 512
    (2048, 16, 256, 8, 132, 32768),  # 256 slots x 32k: one span each
    (2048, 16, 1, 8, 132, 512),      # one long row: 64 spans of 512
    (40, 16, 6, 2, 3, 640)])         # a small card: one span of the table
def test_split_keys_bound_the_blocks_and_the_scratch(width, page_size,
                                                     num_decode, num_kv, sms,
                                                     want):
    """The decode blocks stay within SPLIT_BLOCKS_PER_SM per SM (or one
    span per row where the rows alone fill the card), so the partials'
    scratch [splits, rows x decode_q, H, D] f32 is bounded by the card,
    not by the table's width x page_size keys."""
    span = ca.split_keys(width, page_size, num_decode, num_kv, sms)
    assert span == want
    n = len(ca.split_spans(width, page_size, num_decode, num_kv, sms))
    assert num_decode * num_kv * n <= max(num_decode * num_kv,
                                          ca.SPLIT_BLOCKS_PER_SM * sms)
    if num_decode * num_kv * -(-width * page_size // ca.SPLIT_KEYS) \
            <= ca.SPLIT_BLOCKS_PER_SM * sms:
        assert span == ca.SPLIT_KEYS  # the cap does not bite: 256 keys


@pytest.mark.parametrize("decode_q", [1, 4])
@pytest.mark.parametrize("kv_len", [0, 1, 255, 256, 257, 511, 512, 640])
def test_ragged_splits_walk_each_visible_pair_once(kv_len, decode_q):
    width, ps = 40, 16  # 640 keys: three spans, the last one short
    spans = ca.split_spans(width, ps, 3, 2, H100_SMS)
    assert spans == [(0, 256), (256, 512), (512, 640)]
    assert ca.check_decode_rows(decode_q, 4, 32) == 16
    assert _chunk_tiles(32, 4, 32) == [(0, 16), (16, 16)]
    q_start = max(kv_len - decode_q, 0)
    count = np.zeros((decode_q, width * ps), np.int64)
    for lo, hi in spans:
        count += _walked(lo, hi, q_start, decode_q, kv_len, width * ps)
    vis = _visible(q_start, decode_q, kv_len, width * ps)
    assert (count[vis] == 1).all() and (count[~vis] == 0).all()


@pytest.mark.parametrize("group,head_dim,match", [
    (4, 8, "head_dim"), (4, 40, "head_dim"), (4, 144, "head_dim"),
    (4, 512, "head_dim"), (4, 0, "head_dim"),
    (65, 64, "64-row"), (128, 128, "64-row"), (0, 64, "64-row")])
def test_plans_refuse_what_the_tile_cannot_take(group, head_dim, match):
    with pytest.raises(ValueError, match=match):
        ca.tile_positions(group, head_dim)
    with pytest.raises(ValueError, match=match):
        ca.check_decode_rows(1, group, head_dim)


@pytest.mark.parametrize("decode_q,group", [(2, 64), (4, 32), (65, 1)])
def test_decode_rows_past_the_tile_are_refused(decode_q, group):
    with pytest.raises(ValueError, match="decode_q"):
        ca.check_decode_rows(decode_q, group, 64)
    ca.check_decode_rows(decode_q // 2 or 1, group, 64)


def _pools(rng, quantized, n_pool, n_kv, d, ps):
    kf = rng.normal(size=(n_pool * ps, n_kv, d)).astype(np.float32)
    vf = rng.normal(size=(n_pool * ps, n_kv, d)).astype(np.float32)
    if not quantized:
        return (torch.from_numpy(kf).reshape(n_pool, ps, n_kv * d),
                torch.from_numpy(vf).reshape(n_pool, ps, n_kv * d))
    w = att.kv_lane_width(n_kv, d, True)
    return tuple(att.pack_kv_rows(torch.from_numpy(x), w).reshape(
        n_pool, ps, w) for x in (kf, vf))


def _partials(q, k_pages, v_pages, tables, kv_lens, q_starts, span, *,
              page_size, num_kv_heads, num_decode, decode_q):
    """The decode blocks of ragged_kernel in plain f32: each decode row's
    keys [0, W * page_size) cut into spans of `span` keys, and per span,
    decode query and head the unnormalized partial: m the span's max score
    in log2 units (scores * log2(e) / sqrt(D)), p = 2^(score - m) over its
    visible keys, l = sum(p), o = p V; a span with no visible key gives
    m = -inf, l = 0, o = 0 -> o [S, nd, H, D], m [S, nd, H], l [S, nd, H]
    with nd = num_decode * decode_q."""
    _, h, d = q.shape
    nd = num_decode * decode_q
    g = h // num_kv_heads
    k = att._paged_kv(k_pages, tables[:num_decode], num_kv_heads, d)
    v = att._paged_kv(v_pages, tables[:num_decode], num_kv_heads, d)
    t = k.shape[2]  # [N, KV, T, D]
    n_spans = -(-t // span)
    pad = n_spans * span - t
    q32 = q[:nd].float().reshape(num_decode, decode_q, num_kv_heads, g, d)
    scores = torch.einsum("nqkgd,nktd->nkgqt", q32, k) * (d ** -0.5 * LOG2E)
    tok = torch.arange(t)
    qpos = q_starts[:num_decode].long()[:, None] + torch.arange(decode_q)
    mask = ((tok[None, None] <= qpos[:, :, None])
            & (tok[None, None] < kv_lens[:num_decode].long()[:, None, None]))
    scores = scores.masked_fill(~mask[:, None, None], float("-inf"))
    scores = torch.nn.functional.pad(scores, (0, pad), value=float("-inf"))
    scores = scores.reshape(scores.shape[:-1] + (n_spans, span))
    vs = torch.nn.functional.pad(v, (0, 0, 0, pad)).reshape(
        num_decode, num_kv_heads, n_spans, span, d)
    m = scores.amax(-1)  # [N, KV, G, Q, S]
    p = torch.exp2(scores - torch.where(torch.isfinite(m), m, 0.0)[..., None])
    l = p.sum(-1)
    o = torch.einsum("nkgqsj,nksjd->nkgqsd", p, vs)
    # -> [S, N, Q, KV, G(, D)]: split, decode query, head
    o = o.permute(4, 0, 3, 1, 2, 5).reshape(n_spans, nd, h, d)
    m = m.permute(4, 0, 3, 1, 2).reshape(n_spans, nd, h)
    l = l.permute(4, 0, 3, 1, 2).reshape(n_spans, nd, h)
    return o, m, l


def _merge(o, m, l):
    """merge_splits_kernel in plain f32: with M the max of m over the
    splits, sum_s o_s 2^(m_s - M) / sum_s l_s 2^(m_s - M), skipping splits
    with m = -inf; exact zeros where every split is empty."""
    seen = torch.isfinite(m)
    big = m.amax(0)
    w = torch.where(seen, torch.exp2(m - torch.where(torch.isfinite(big),
                                                     big, 0.0)), 0.0)
    denom = (w * l).sum(0)
    acc = (torch.where(seen[..., None], o, 0.0) * w[..., None]).sum(0)
    return torch.where(denom[..., None] > 0,
                       acc / denom.clamp_min(1e-30)[..., None], 0.0)


@pytest.mark.parametrize("sms", [H100_SMS, 3], ids=["h100", "small_card"])
@pytest.mark.parametrize("decode_q", [1, 4])
@pytest.mark.parametrize("quantized", [False, True],
                         ids=["f32_pool", "int8_pool"])
def test_split_merge_matches_plain_ragged(quantized, decode_q, sms):
    h, n_kv, d, ps, width = 4, 2, 32, 16, 20  # 320 keys
    rng = np.random.default_rng(31)
    kp, vp = _pools(rng, quantized, 200, n_kv, d, ps)
    # context 0, a row whose second span sees nothing, rows ending on and
    # one past the split boundary, a full table; then a 16-token chunk
    ctx = [0, 100, 255, 256, 257, width * ps]
    nrow = len(ctx)
    tables = np.zeros((nrow + 1, width), np.int32)
    perm = rng.permutation(199) + 1
    used = 0
    for r, n in enumerate(ctx):
        k = -(-n // ps)
        tables[r, :k] = perm[used:used + k]
        used += k
    tables[nrow, :1] = perm[used]
    q_starts = np.array([max(n - decode_q, 0) for n in ctx] + [0], np.int32)
    kv_lens = np.array(ctx + [16], np.int32)
    q = rng.normal(size=(nrow * decode_q + 16, h, d)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (q, tables, kv_lens, q_starts)]
    kw = dict(page_size=ps, num_kv_heads=n_kv, num_decode=nrow,
              decode_q=decode_q)

    # two spans of 256 on the H100; one of all 320 keys on a 3-SM card
    span = ca.split_keys(width, ps, nrow, n_kv, sms)
    assert span == (256 if sms == H100_SMS else 320)
    o, m, l = _partials(args[0], kp, vp, *args[1:], span, **kw)
    n_spans = len(ca.split_spans(width, ps, nrow, n_kv, sms))
    assert o.shape == (n_spans, nrow * decode_q, h, d)
    assert m.shape == l.shape
    if n_spans == 2:
        # row 1 (context 100) and row 3 (256, ending on the boundary) see
        # nothing in the second span; row 0 (context 0) in neither
        for r in (0, 1, 3):
            rows = slice(r * decode_q, (r + 1) * decode_q)
            assert torch.isneginf(m[1, rows]).all() and not l[1, rows].any()
            assert not o[1, rows].any()
    assert torch.isneginf(m[:, :decode_q]).all()
    out = _merge(o, m, l)

    nd = nrow * decode_q
    ref = att.ragged_paged_attention_ref(args[0], kp, vp, *args[1:], **kw)
    np.testing.assert_allclose(out.numpy(), ref[:nd].numpy(), **TOL)
    assert not out[:decode_q].any()  # context 0: exact zeros
    pallas = ra.ragged_paged_attention(
        jnp.asarray(q), jnp.asarray(kp.numpy()), jnp.asarray(vp.numpy()),
        jnp.asarray(tables), jnp.asarray(kv_lens), jnp.asarray(q_starts),
        interpret=True, **kw)
    # the Pallas kernel leaves a row at context 0 NaN (its one all-masked
    # block takes exp(-inf - -inf)); every other row agrees
    np.testing.assert_allclose(out[decode_q:].numpy(),
                               np.asarray(pallas)[decode_q:nd], **TOL)


def _decode_blocks(width, ps, contexts, n_kv, sms):
    """How many blocks of decode.cu's grid walk each (row, key) pair, as a
    [B, width * ps] count: block bx of row b = bx // splits, span s (as
    decode_split_block splits it) walks keys [s * span, (s + 1) * span)
    below min(ctx, width * ps), its query at ctx - 1. Asserts that no
    block reads a page past the table's width."""
    keys = width * ps
    span, n_splits = ca.split_plan(width, ps, len(contexts), n_kv, sms)
    count = np.zeros((len(contexts), keys), np.int64)
    for bx in range(len(contexts) * n_splits):
        b, s = divmod(bx, n_splits)
        ctx = contexts[b]
        hi = min((s + 1) * span, ctx, keys)  # the horizon: query ctx - 1
        assert -(-hi // ps) <= width  # the last page read is in the table
        count[b] += _walked(s * span, (s + 1) * span, ctx - 1, 1,
                            min(ctx, keys), keys)[0]
    return count, span, n_splits


@pytest.mark.parametrize("width,ps,n_kv,sms,span", [
    (128, 16, 8, H100_SMS, 256),    # the engine's 2048-key tables
    (512, 16, 8, H100_SMS, 960),    # 8192 keys: the spans widen
    (20, 16, 2, H100_SMS, 256),     # two spans, the last one short
    (20, 16, 2, 3, 320),            # a small card: one span
    (5, 4, 2, H100_SMS, 256)])      # a table shorter than one span
def test_decode_split_plan_walks_each_visible_key_once(width, ps, n_kv, sms,
                                                       span):
    """decode.cu's split plan over a [B, Pmax] table: each (row, visible
    key) pair is walked by exactly one block; contexts 0, 1, 255, 256, 257,
    full and one past full (cut at the table's end, as the kernel does)."""
    keys = width * ps
    contexts = [min(c, keys) for c in (0, 1, 255, 256, 257)] + [keys,
                                                               keys + 5]
    count, got, n_splits = _decode_blocks(width, ps, contexts, n_kv, sms)
    assert got == span and n_splits == -(-keys // span)
    assert len(contexts) * n_kv * n_splits <= max(
        len(contexts) * n_kv, ca.SPLIT_BLOCKS_PER_SM * sms)
    tok = np.arange(keys)[None]
    visible = tok < np.minimum(np.array(contexts), keys)[:, None]
    assert (count[visible] == 1).all() and (count[~visible] == 0).all()


@pytest.mark.parametrize("sms", [H100_SMS, 3], ids=["h100", "small_card"])
@pytest.mark.parametrize("quantized", [False, True],
                         ids=["f32_pool", "int8_pool"])
def test_split_merge_matches_plain_and_pallas_decode(quantized, sms):
    """decode.cu's rows: the split-and-merge model with decode_q = 1 and
    each query at ctx - 1, against the plain decode attention and the
    Pallas decode kernel in interpret mode, the row at ctx 0 (exact zeros
    in all three) included."""
    h, n_kv, d, ps, width = 4, 2, 32, 16, 20  # 320 keys
    rng = np.random.default_rng(37)
    kp, vp = _pools(rng, quantized, 160, n_kv, d, ps)
    ctx = [0, 1, 100, 255, 256, 257, width * ps]
    table = np.zeros((len(ctx), width), np.int32)
    perm = rng.permutation(159) + 1
    used = 0
    for r, n in enumerate(ctx):
        k = -(-n // ps)
        table[r, :k] = perm[used:used + k]
        used += k
    cl = np.array(ctx, np.int32)
    q = rng.normal(size=(len(ctx), h, d)).astype(np.float32)
    tq, tt, tc = torch.from_numpy(q), torch.from_numpy(table), \
        torch.from_numpy(cl)
    span, n_splits = ca.split_plan(width, ps, len(ctx), n_kv, sms)
    assert (span, n_splits) == ((256, 2) if sms == H100_SMS else (320, 1))
    o, m, l = _partials(tq, kp, vp, tt, tc, tc - 1, span, page_size=ps,
                        num_kv_heads=n_kv, num_decode=len(ctx), decode_q=1)
    assert o.shape == (n_splits, len(ctx), h, d)
    out = _merge(o, m, l)
    assert not out[0].any()  # context 0: exact zeros
    ref = att.paged_attention_decode_ref(tq, kp, vp, tt, tc, page_size=ps,
                                         num_kv_heads=n_kv)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)
    pallas = pa.paged_attention_decode(
        jnp.asarray(q), jnp.asarray(kp.numpy()), jnp.asarray(vp.numpy()),
        jnp.asarray(table), jnp.asarray(cl), page_size=ps,
        num_kv_heads=n_kv, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), **TOL)


@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("s", [48, 64, 256])
def test_prefill_tiles_walk_each_visible_pair_once(s, group):
    """prefill.cu's grid: query tiles of tile_positions(group) positions
    per lane, each walking keys below min(its last position + 1, seq_len)
    of its own lane. Each visible (query, key) pair, bucket-padding rows
    past seq_len included (they see every key below seq_len, as the TPU
    kernel computes them), is walked once; a lane at seq_len 0 walks
    nothing; no tile reads past the lane's S rows."""
    pos = ca.tile_positions(group, 128)
    for seq_len in (s, 0, 1, s // 3, s - 1):
        count = np.zeros((s, s), np.int64)
        for i0 in range(0, s, pos):
            n = min(pos, s - i0)
            assert 1 <= n and n * group <= ca.TILE_ROWS
            count[i0:i0 + n] += _walked(0, np.inf, i0, n, seq_len, s)
        vis = _visible(0, s, seq_len, s)
        assert (count[vis] == 1).all() and (count[~vis] == 0).all()
        if seq_len:
            assert vis[seq_len:].sum() == (s - seq_len) * seq_len
