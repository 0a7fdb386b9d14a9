"""The pair tile's launch plan below head_dim 640 on the CPU: prefill.cu's
and chunk.cu's kernels (and ragged.cu's chunk rows, which launch
chunk.cu's) at every head_dim below 640, whose blocks hold two query tiles
(a pair) of one KV head and walk one key span of the pair's keys each.

- The plan (`cuda_attention.chunk_spans`, `pair_tile_takes`,
  `pair_max_spans`): every launch of the port takes one span a pair,
  whatever its size, start, window or card, so a query row walks its own
  key tiles in key order in a whole prefill, in any chunk and in a mixed
  step's chunk rows alike (its bits do not depend on the launch); a
  measurement may ask for up to pair_max_spans.
- The walk (`_pair_walk`, pair_span_block's arithmetic): under windows of
  0, 512, 2047 and 4096 keys, groups 1, 2 and 8 (Phi-3's, Gemma-2's and a
  GQA of 8 heads), chunks of 1, 88 and 256 tokens at starts 0, 3008 and
  4864 and prefill lanes at seq_len 0, 1, mid-tile and S, in one span and
  in the measurement's two and three: every visible (query, key) pair is
  walked exactly once, every key tile a block loads is walked by one of
  its query tiles, no query tile walks a key tile wholly outside its rows'
  windows, and a tile walked without the element mask (not an edge tile)
  is visible whole.
- A plain f32 model of the spans' partials (m in log2 units, l, O) and
  their merge, masking element by element only on edge tiles, equals the
  JAX package's prefill_attention_xla and chunk_attention_xla (with the
  window and the tanh cap, `_softcap`; also at Phi-3-mini's shape: group
  1, 32 KV heads, head_dim 96, its 2047-key window) and, without a window
  or cap, the Pallas _prefill_kernel and _chunk_kernel in interpret mode.
  Tolerance 1e-5: f32 throughout, only the order of the sums differs. Rows
  that see no key are left out of the XLA comparison: the XLA references
  give the mean of V there (their finfo.min mask), the port exact zeros.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import attention as jatt
from dynamo_tpu.ops import pallas_attention as pa
from dynamo_tpu_torch.ops import cuda_attention as ca

TOL = dict(rtol=1e-5, atol=1e-5)
LOG2E = 1.4426950408889634
H100_SMS = 132

# (GQA group, KV heads, head_dim): Phi-3-mini's group at head_dim 64,
# Gemma-2-9B's, and a GQA of 8 heads at the 8B's head_dim
SHAPES = [(1, 32, 64), (2, 8, 256), (8, 4, 128)]
WINDOWS = [0, 512, 2047, 4096]
# chunks (C, start), then prefill lanes of a 256-position bucket at
# seq_len 0, 1, mid-tile and S (one launch of PREFILL_LANES lanes)
S_BUCKET = 256
PREFILL_LANES = 4
CASES = ([("chunk", c, start) for c in (1, 88, 256)
          for start in (0, 3008, 4864)]
         + [("prefill", S_BUCKET, seq_len) for seq_len in (0, 1, 100, 256)])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module: the parallel test workers share
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _visible(pos, tok, kv_len, window):
    """[len(pos), len(tok)] 0/1: key tok visible to the query at pos."""
    vis = (tok[None] <= pos[:, None]) & (tok[None] < kv_len)
    if window:
        vis &= tok[None] > pos[:, None] - window
    return vis


def _pair_walk(c, start, kv_len, group, head_dim, window, spans,
               per_block=2):
    """The blocks of one KV head of a pair-tile launch over c queries at
    positions start .. (chunk.cu: kv_len = start + c; prefill.cu: start
    0, kv_len = min(seq_len, S)) in `spans` spans a pair, as
    pair_span_block computes them on the card: (first query of the pair,
    (queries of tile 0, of tile 1), span, [(key tile start, (walked by
    tile 0, by tile 1), (edge for tile 0, for tile 1))]); with per_block
    = 1 (pair_query_tiles), blocks of one query tile, tile 1 empty. Each
    tile's keys
    are [lo_w, hi_w): its first query's window start (0 without a window)
    to min(last position + 1, kv_len); their union from the start of the
    key tile that holds it is cut into `spans` runs of whole key tiles
    (span u: tiles u * n // spans .. (u + 1) * n // spans); a tile walks
    the key tiles that meet its keys, masking element by element only on
    an edge tile (one some of its rows cannot see whole)."""
    positions = ca.tile_positions(group, head_dim)
    kn = ca.pair_keys(head_dim)
    out = []
    for first in range(0, c, per_block * positions):
        nq = (min(positions, c - first),
              max(0, min(positions, c - first - positions))
              if per_block == 2 else 0)
        lo_w, hi_w = [], []
        for w in range(2):
            qp = start + first + w * positions
            hi_w.append(min(qp + nq[w], kv_len) if nq[w] else 0)
            lo_w.append(max(0, qp - window + 1) if window else 0)
        live = [w for w in range(2) if lo_w[w] < hi_w[w]]
        lo = min((lo_w[w] for w in live), default=0)
        hi = max((hi_w[w] for w in live), default=0)
        lo_al = lo // kn * kn
        n_tiles = -(-(hi - lo_al) // kn) if live else 0
        for u in range(spans):
            tiles = []
            for t in range(u * n_tiles // spans, (u + 1) * n_tiles // spans):
                k0 = lo_al + t * kn
                walk, edge = [], []
                for w in range(2):
                    qp = start + first + w * positions
                    walk.append(w in live and k0 < hi_w[w]
                                and k0 + kn > lo_w[w])
                    edge.append(k0 + kn > kv_len or k0 + kn - 1 > qp
                                or bool(window)
                                and k0 <= qp + nq[w] - 1 - window)
                tiles.append((k0, tuple(walk), tuple(edge)))
            out.append((first, nq, u, tiles))
    return out


def _launch(kind, c, x):
    """(queries, start, kv_len) of a chunk (x = start) or of a prefill
    lane (x = seq_len)."""
    if kind == "chunk":
        return c, x, x + c
    return c, 0, min(x, c)


def _per_block(kind, c, group, d, n_kv):
    """Query tiles a block of the launch holds (pair_query_tiles): a chunk
    is one lane, a prefill PREFILL_LANES."""
    lanes = n_kv * (1 if kind == "chunk" else PREFILL_LANES)
    pairs = ca.pair_count(c, ca.tile_positions(group, d)) * lanes
    return ca.pair_query_tiles(pairs, H100_SMS)


@pytest.mark.parametrize("spans", [1, 2, 3], ids=["s1", "s2", "s3"])
@pytest.mark.parametrize("case", CASES,
                         ids=[f"{k}{c}-{x}" for k, c, x in CASES])
@pytest.mark.parametrize("shape", SHAPES,
                         ids=[f"g{g}-kv{kv}-d{d}" for g, kv, d in SHAPES])
@pytest.mark.parametrize("window", WINDOWS, ids=[f"w{w}" for w in WINDOWS])
def test_pair_walk_covers_each_visible_pair_once(window, shape, case, spans):
    """In the port's one span (the plan of every launch) and in the
    measurement's two and three (at most pair_max_spans)."""
    group, n_kv, d = shape
    kind, c0, x = case
    c, start, kv_len = _launch(kind, c0, x)
    positions = ca.tile_positions(group, d)
    kn = ca.pair_keys(d)
    plan = (ca.chunk_spans(c, start, group, d, n_kv, H100_SMS)
            if kind == "chunk" else 1)
    assert plan == 1
    n = min(spans, ca.pair_max_spans(start + c, window, positions, d))
    width = max(kv_len, 1)
    count = np.zeros((c, width), np.int64)
    per = _per_block(kind, c, group, d, n_kv)
    blocks = _pair_walk(c, start, kv_len, group, d, window, n, per)
    lanes = n_kv * (1 if kind == "chunk" else PREFILL_LANES)
    assert len(blocks) * lanes == n * ca.pair_blocks(c, positions, lanes,
                                                     H100_SMS)
    for first, nq, span, tiles in blocks:
        assert span < n and nq[0] >= 1 and sum(nq) == min(per * positions,
                                                          c - first)
        for k0, walk, edge in tiles:
            assert k0 % kn == 0 and 0 <= k0 < kv_len
            assert any(walk)  # every tile the producer loads feeds a tile
            tok = np.arange(k0, k0 + kn)
            for w in (0, 1):
                if not walk[w]:
                    continue
                p0 = first + w * positions
                vis = _visible(start + p0 + np.arange(nq[w]), tok, kv_len,
                               window)
                assert vis.any()  # never wholly outside the rows' windows
                if not edge[w]:  # walked without the element mask
                    assert vis.all()
                keep = tok < width
                count[p0:p0 + nq[w], tok[keep]] += vis[:, keep]
    want = _visible(start + np.arange(c), np.arange(width), kv_len, window)
    assert (count[want] == 1).all() and (count[~want] == 0).all()


def _row_walks(c, start, kv_len, group, d, window, per_block):
    """{absolute query position: [(span, key tile start)] of the tiles its
    query tile walks that hold a key it sees, in walk order} of one KV
    head of a one-span launch of per_block query tiles a block."""
    positions = ca.tile_positions(group, d)
    kn = ca.pair_keys(d)
    rows = {}
    for first, nq, span, tiles in _pair_walk(c, start, kv_len, group, d,
                                             window, 1, per_block):
        for w in (0, 1):
            for i in range(nq[w]):
                pos = start + first + w * positions + i
                rows[pos] = [(span, k0) for k0, walk, _ in tiles
                             if walk[w] and _visible(
                                 np.array([pos]), np.arange(k0, k0 + kn),
                                 kv_len, window).any()]
    return rows


@pytest.mark.parametrize("shape", SHAPES,
                         ids=[f"g{g}-kv{kv}-d{d}" for g, kv, d in SHAPES])
@pytest.mark.parametrize("window", WINDOWS, ids=[f"w{w}" for w in WINDOWS])
def test_a_rows_walk_does_not_depend_on_the_launch(window, shape):
    """A 600-token prompt's rows walk the same key tiles, in the same
    order and in the same span, whole (prefill.cu at start 0) and in
    chunks of 256 (chunk.cu), of 88 at unaligned starts, and of 16 (a
    mixed step's ragged chunk rows launch chunk.cu's kernel), in pairs or
    one query tile a block (pair_query_tiles; the whole prompt's launch
    in pairs too): so they take the same bits, as the whole prompt's
    tiles a row cannot see add exact zeros."""
    group, n_kv, d = shape
    s = 600
    wholes = [_row_walks(s, 0, s, group, d, window, per)
              for per in (_per_block("prefill", s, group, d, n_kv), 2)]
    for size in (256, 88, 16):
        for start in range(0, s, size):
            c = min(size, s - start)
            assert ca.chunk_spans(c, start, group, d, n_kv, H100_SMS) == 1
            for per in (_per_block("chunk", c, group, d, n_kv), 1, 2):
                part = _row_walks(c, start, start + c, group, d, window,
                                  per)
                for whole in wholes:
                    for pos, walk in part.items():
                        assert walk == whole[pos], (size, start, per, pos)


@pytest.mark.parametrize("sms", [H100_SMS, 114, 16, 3])
def test_every_launch_takes_one_span(sms):
    """chunk.cu's plan below head_dim 640 (the library's own,
    `dtt_chunk_spans`) is one span a pair at every size, start and card;
    prefill.cu's and ragged.cu's chunk rows' launches take the same."""
    for group, n_kv, d in SHAPES + [(4, 8, 128), (7, 4, 128), (64, 1, 32),
                                    (1, 32, 96)]:
        for c in (1, 48, 88, 256, 1000):
            for start in (0, 37, 512, 3008, 4864):
                assert ca.chunk_spans(c, start, group, d, n_kv, sms) == 1


def test_pair_tile_takes_every_head_dim_below_640():
    """prefill.cu and chunk.cu run the pair tile at 32, 64, 96 (Phi-3),
    128 and 256, and the latent tile at LATENT_DIM."""
    assert [d for d in ca.TILE_HEAD_DIMS
            if ca.pair_tile_takes(d)] == [32, 64, 96, 128, 256]
    assert not ca.pair_tile_takes(ca.LATENT_DIM)
    assert ca.pair_keys(128) == 64 and ca.pair_keys(256) == 32
    # a measurement's spans: at most the key tiles of the longest union
    assert ca.pair_max_spans(256 + 3008, 2047, 64, 128) == 8
    assert ca.pair_max_spans(150, 0, 32, 32) == 3


def test_a_launch_that_pairs_would_half_fill_takes_single_tiles():
    """pair_query_tiles: blocks of one query tile where the pairs' blocks
    would leave more than half the SMs idle (their single tiles then still
    run in one wave), pairs otherwise; pair_blocks counts a launch's
    blocks (a span's: the clocks' and the grid's)."""
    assert ca.pair_query_tiles(66, H100_SMS) == 1
    assert ca.pair_query_tiles(67, H100_SMS) == 2
    # (n, group, KV heads, head_dim, lanes) -> blocks on an H100: Phi-3's
    # 256-token chunk, Gemma-2-9B's, the 8B's, and prefills of two
    # 4096-position Phi-3 lanes and four 256-position 8B lanes
    cases = {(256, 1, 32, 96, 1): 128, (256, 2, 8, 256, 1): 64,
             (256, 4, 8, 128, 1): 128, (4096, 1, 32, 96, 2): 2048,
             (256, 4, 8, 128, 4): 256}
    for (n, group, n_kv, d, lanes), blocks in cases.items():
        positions = ca.tile_positions(group, d)
        assert ca.pair_blocks(n, positions, lanes * n_kv,
                              H100_SMS) == blocks, (n, group, d)
    # a card of 114 SMs takes Phi-3's chunk in pairs
    assert ca.pair_blocks(256, 64, 32, 114) == 64


def _pair_model(q, k, v, start, kv_len, group, window, cap, spans,
                per_block=2):
    """prefill.cu's and chunk.cu's pair tile in plain f32: q [C, H, D], K
    and V by position [T, KV, D] -> [C, H, D]. Per block of _pair_walk
    (per_block query tiles a block), each
    query tile's unnormalized partial over the key tiles it walks in the
    span (the element mask only on edge tiles, the cap as
    cap * tanh(s / cap) before it), m in log2 units, then the merge of the
    spans (merge_splits_kernel's formula)."""
    c, h, d = q.shape
    n_kv = k.shape[1]
    positions = ca.tile_positions(group, d)
    kn = ca.pair_keys(d)
    t = k.shape[0]
    parts = {}  # (pair first, w) -> [(o, m, l) per span]
    for first, nq, span, tiles in _pair_walk(c, start, kv_len, group, d,
                                             window, spans, per_block):
        for w in (0, 1):
            if not nq[w]:
                continue
            p0 = first + w * positions
            qt = q[p0:p0 + nq[w]].reshape(nq[w], n_kv, group, d)
            o = torch.zeros((nq[w], n_kv, group, d))
            m = torch.full((nq[w], n_kv, group), float("-inf"))
            l = torch.zeros((nq[w], n_kv, group))
            for k0, walk, edge in tiles:
                if not walk[w]:
                    continue
                tok = torch.arange(k0, k0 + kn)
                kt = torch.zeros((kn, n_kv, d))
                vt = torch.zeros((kn, n_kv, d))
                real = tok < min(t, kv_len)
                kt[real], vt[real] = k[tok[real]], v[tok[real]]
                s = torch.einsum("qkgd,tkd->qkgt", qt, kt) * d ** -0.5
                if cap:
                    s = cap * torch.tanh(s / cap)
                s = s * LOG2E
                if edge[w]:
                    vis = torch.from_numpy(_visible(
                        start + p0 + np.arange(nq[w]), tok.numpy(), kv_len,
                        window))
                    s = s.masked_fill(~vis[:, None, None], float("-inf"))
                m_new = torch.maximum(m, s.amax(-1))
                base = torch.where(torch.isfinite(m_new), m_new, 0.0)
                alpha = torch.exp2(m - base)
                p = torch.exp2(s - base[..., None])
                l = l * alpha + p.sum(-1)
                o = o * alpha[..., None] + torch.einsum("qkgt,tkd->qkgd", p,
                                                        vt)
                m = m_new
            parts.setdefault((first, w), []).append(
                (o.reshape(nq[w], h, d), m.reshape(nq[w], h),
                 l.reshape(nq[w], h)))
    out = torch.zeros((c, h, d))
    for (first, w), sp in parts.items():
        p0 = first + w * positions
        o, m, l = (torch.stack(x) for x in zip(*sp))
        seen = torch.isfinite(m)
        big = m.amax(0)
        wt = torch.where(seen, torch.exp2(
            m - torch.where(torch.isfinite(big), big, 0.0)), 0.0)
        denom = (wt * l).sum(0)
        acc = (o * wt[..., None]).sum(0)
        out[p0:p0 + o.shape[1]] = torch.where(
            denom[..., None] > 0, acc / denom.clamp_min(1e-30)[..., None],
            0.0)
    return out


def _sees_a_key(pos, kv_len, window):
    """Queries at pos that see at least one key."""
    lo = np.maximum(0, pos - window + 1) if window else np.zeros_like(pos)
    return np.minimum(pos + 1, kv_len) > lo


# (window, cap): none, a window inside a key tile, one across tiles with
# Gemma-2's cap, a wide one
MODS = [(0, 0.0), (0, 50.0), (37, 0.0), (100, 50.0), (4096, 0.0)]


@pytest.mark.parametrize("spans", [None, 1, 2, 4], ids=["plan", "s1", "s2",
                                                        "s4"])
@pytest.mark.parametrize("window,cap", MODS,
                         ids=[f"w{w}-cap{int(c)}" for w, c in MODS])
@pytest.mark.parametrize("group,n_kv,d", [(2, 2, 32), (1, 2, 256)],
                         ids=["g2-d32", "g1-d256"])
def test_chunk_pair_model_matches_xla_and_pallas(group, n_kv, d, window,
                                                 cap, spans):
    """An 88-token chunk at 300 (positions past several key tiles and the
    windows) over a trash-padded page list of f32 pools, in the plan's
    spans and in 1, 2 and 4 (at most pair_max_spans)."""
    c, start, ps = 88, 300, 16
    h = group * n_kv
    rng = np.random.default_rng(7 + d + window)
    n_pool = 40
    kp = rng.normal(size=(n_pool, ps, n_kv * d)).astype(np.float32)
    vp = rng.normal(size=(n_pool, ps, n_kv * d)).astype(np.float32)
    width = -(-(start + c) // ps) + 2
    pages = np.zeros((width,), np.int32)
    pages[:width - 2] = rng.permutation(n_pool - 1)[:width - 2] + 1
    q = rng.normal(size=(c, h, d)).astype(np.float32)
    k = kp[pages].reshape(-1, n_kv, d)
    v = vp[pages].reshape(-1, n_kv, d)
    most = ca.pair_max_spans(start + c, window, ca.tile_positions(group, d),
                             d)
    plan = ca.chunk_spans(c, start, group, d, n_kv, H100_SMS)
    n = min(spans, most) if spans else plan
    assert n <= most
    out = _pair_model(torch.from_numpy(q), torch.from_numpy(k),
                      torch.from_numpy(v), start, start + c, group, window,
                      cap, n).numpy()
    ref = np.asarray(jatt.chunk_attention_xla(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pages),
        start, page_size=ps, num_kv_heads=n_kv, window=window or None,
        logit_cap=cap))
    np.testing.assert_allclose(out, ref, **TOL)
    if window == 0 and cap == 0.0:
        pallas = pa.chunk_prefill_attention(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(pages), start, page_size=ps, num_kv_heads=n_kv,
            interpret=True)
        np.testing.assert_allclose(out, np.asarray(pallas), **TOL)


# Phi-3-mini's attention (group 1, 32 KV heads, head_dim 96, a 2047-key
# window on every layer): its served 256-token chunk at 3008 and a tail
PHI3_CHUNKS = [(256, 3008), (88, 2100)]


@pytest.mark.parametrize("per_block", [1, 2], ids=["tile", "pair"])
@pytest.mark.parametrize("spans", [None, 2], ids=["plan", "s2"])
@pytest.mark.parametrize("c,start", PHI3_CHUNKS,
                         ids=[f"c{c}-at{s}" for c, s in PHI3_CHUNKS])
def test_chunk_pair_model_matches_xla_at_phi3_shape(c, start, spans,
                                                    per_block):
    """A chunk at Phi-3-mini's shape, past its window, over a trash-padded
    page list of f32 pools, in the plan's one span a pair and in two (a
    measurement's), in blocks of one query tile (the plan's on the H100:
    the pairs would fill half of it) and of two: the walk from the key
    tile of each block's first window, against the XLA reference with the
    window."""
    group, n_kv, d, window, ps = 1, 32, 96, 2047, 16
    rng = np.random.default_rng(start + c)
    n_used = -(-(start + c) // ps)
    n_pool = n_used + 4
    kp = rng.normal(size=(n_pool, ps, n_kv * d)).astype(np.float32)
    vp = rng.normal(size=(n_pool, ps, n_kv * d)).astype(np.float32)
    pages = np.zeros((n_used + 2,), np.int32)
    pages[:n_used] = rng.permutation(n_pool - 1)[:n_used] + 1
    q = rng.normal(size=(c, group * n_kv, d)).astype(np.float32)
    k = kp[pages].reshape(-1, n_kv, d)
    v = vp[pages].reshape(-1, n_kv, d)
    plan = ca.chunk_spans(c, start, group, d, n_kv, H100_SMS)
    n = spans or plan
    assert plan == 1 and n <= ca.pair_max_spans(
        start + c, window, ca.tile_positions(group, d), d)
    assert _per_block("chunk", c, group, d, n_kv) == 1
    out = _pair_model(torch.from_numpy(q), torch.from_numpy(k),
                      torch.from_numpy(v), start, start + c, group, window,
                      0.0, n, per_block).numpy()
    ref = np.asarray(jatt.chunk_attention_xla(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pages),
        start, page_size=ps, num_kv_heads=n_kv, window=window))
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("spans", [None, 1, 2], ids=["plan", "s1", "s2"])
@pytest.mark.parametrize("window,cap", MODS,
                         ids=[f"w{w}-cap{int(c)}" for w, c in MODS])
def test_prefill_pair_model_matches_xla_and_pallas(window, cap, spans):
    """Lanes of a 150-position bucket at seq_len S, 0 (exact zeros), 1 and
    70 (a length inside a query tile), bucket-padding rows included, at
    group 2 and head_dim 32."""
    s, lens, group, n_kv, d = 150, [150, 0, 1, 70], 2, 2, 32
    h = group * n_kv
    rng = np.random.default_rng(11 + window)
    most = ca.pair_max_spans(s, window, ca.tile_positions(group, d), d)
    plan = 1  # prefill_attention's below LATENT_DIM
    n = min(spans, most) if spans else plan
    for lane, seq_len in enumerate(lens):
        q = rng.normal(size=(s, h, d)).astype(np.float32)
        k = rng.normal(size=(s, n_kv, d)).astype(np.float32)
        v = rng.normal(size=(s, n_kv, d)).astype(np.float32)
        out = _pair_model(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), 0, min(seq_len, s), group,
                          window, cap, n).numpy()
        if seq_len == 0:
            assert not out.any()
            continue
        ref = np.asarray(jatt.prefill_attention_xla(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), seq_len,
            window=window or None, logit_cap=cap))
        rows = _sees_a_key(np.arange(s), seq_len, window)
        np.testing.assert_allclose(out[rows], ref[rows], **TOL)
        if window == 0 and cap == 0.0:
            pallas = pa.prefill_attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), seq_len,
                                          interpret=True)
            np.testing.assert_allclose(out, np.asarray(pallas), **TOL)

