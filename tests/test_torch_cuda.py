"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU with nvcc (the kernels build for sm_90a) and skip
without one; run them there with

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(`--noconftest`: tests/conftest.py imports jax, which the card's machine
need not have).

Tolerance: atol=rtol=2e-2 on bf16 outputs (the plain versions compute in
f32 from the same bf16 inputs; both round the output to bf16).
"""

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.ops import attention as att
from dynamo_tpu_torch.ops import cuda_attention as ca

pytestmark = pytest.mark.cuda
TOL = dict(atol=2e-2, rtol=2e-2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module: the parallel test workers share
    the cores, and torch's default pool in each of them oversubscribes
    them (the suite's tiny eager ops are as fast on one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


def _rnd(dev, *shape, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)


@pytest.mark.parametrize("n_heads,n_kv,head_dim", [(32, 8, 128), (8, 2, 64),
                                                   (4, 4, 32)])
def test_decode_kernel_matches_plain(dev, n_heads, n_kv, head_dim):
    ps, pages, pmax = 16, 64, 8
    kp = _rnd(dev, pages, ps, n_kv * head_dim, seed=1)
    vp = _rnd(dev, pages, ps, n_kv * head_dim, seed=2)
    q = _rnd(dev, 5, n_heads, head_dim, seed=3)
    rng = np.random.default_rng(0)
    table = torch.tensor(rng.permutation(pages - 1)[:5 * pmax].reshape(5, pmax)
                         + 1, dtype=torch.int32, device=dev)
    ctx = torch.tensor([0, 1, 33, 100, 128], dtype=torch.int32, device=dev)
    out = ca.paged_attention_decode(q, kp, vp, table, ctx, page_size=ps)
    ref = att.paged_attention_decode_ref(q, kp, vp, table, ctx, page_size=ps)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)
    assert not out[0].any()  # ctx 0 -> exact zeros


def _decode_inputs(dev, int8, n_heads, n_kv, head_dim, ctx, pmax, pages=64,
                   ps=16, seed=0):
    """Pools of `pages` pages, q [len(ctx), H, D] and a [len(ctx), pmax]
    table giving each row distinct pages (trash-padded; page 0 past them)."""
    if int8:
        kp, vp = _int8_pools(dev, pages, ps, n_kv, head_dim, seed=seed + 1)
    else:
        kp = _rnd(dev, pages, ps, n_kv * head_dim, seed=seed + 1)
        vp = _rnd(dev, pages, ps, n_kv * head_dim, seed=seed + 2)
    q = _rnd(dev, len(ctx), n_heads, head_dim, seed=seed + 3)
    perm = np.random.default_rng(seed).permutation(pages - 1) + 1
    table = np.zeros((len(ctx), pmax), np.int32)
    used = 0
    for b, c in enumerate(ctx):
        n = -(-c // ps)
        table[b, :n] = perm[used:used + n]
        used += n
    return (q, kp, vp, torch.tensor(table, device=dev),
            torch.tensor(ctx, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("head_dim", [32, 64, 96, 128, 256, 640])
@pytest.mark.parametrize("group", [1, 2, 4, 7, 8])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_decode_kernel_groups_and_head_dims(dev, int8, group, head_dim):
    """Every GQA group and head_dim the tile takes, on both pools: rows at
    context 0, 1, on and one past a 256-key span boundary, and a full
    table (two spans). At head_dim 640 (the latent decode rows) a group
    of 7 puts two positions' rows in one 16-row block of the 64-row
    tile."""
    n_kv, ps = 2, 16
    ctx = [0, 1, 256, 257, 300, 512]
    q, kp, vp, table, cl = _decode_inputs(dev, int8, group * n_kv, n_kv,
                                          head_dim, ctx, 512 // ps, pages=128)
    kw = dict(page_size=ps, num_kv_heads=n_kv)
    out = ca.paged_attention_decode(q, kp, vp, table, cl, **kw)
    ref = att.paged_attention_decode_ref(q, kp, vp, table, cl, **kw)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)
    assert not out[0].any()  # ctx 0 -> exact zeros


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_decode_kernel_on_a_wide_table(dev, int8):
    """A 512-page table of 8 rows (8192 keys): the spans widen to 1024
    keys (8 per row), one row reads all of them."""
    ps, n_kv, d = 16, 8, 128
    ctx = [0, 1, 100, 1023, 1024, 1025, 3000, 8192]
    q, kp, vp, table, cl = _decode_inputs(dev, int8, 32, n_kv, d, ctx, 512,
                                          pages=1024, seed=50)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert ca.split_plan(512, ps, 8, n_kv, sms) == (1024, 8)
    kw = dict(page_size=ps, num_kv_heads=n_kv)
    out = ca.paged_attention_decode(q, kp, vp, table, cl, **kw)
    ref = att.paged_attention_decode_ref(q, kp, vp, table, cl, **kw)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)
    assert not out[0].any()


@pytest.mark.parametrize("s,lens,head_dim", [(256, [256, 200, 37, 1], 128),
                                             (48, [48, 0], 32)])
def test_prefill_kernel_matches_plain(dev, s, lens, head_dim):
    n = len(lens)
    q = _rnd(dev, n, s, 32, head_dim, seed=4)
    k = _rnd(dev, n, s, 8, head_dim, seed=5)
    v = _rnd(dev, n, s, 8, head_dim, seed=6)
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    out = ca.prefill_attention(q, k, v, sl)
    ref = att.prefill_attention_ref(q, k, v, sl)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)
    for lane, n_tok in enumerate(lens):  # seq_len 0 -> exact zeros
        if n_tok == 0:
            assert not out[lane].any()


@pytest.mark.parametrize("head_dim", [32, 64, 96, 128, 256, 640])
@pytest.mark.parametrize("group", [1, 2, 4, 7, 8, 16])
def test_prefill_kernel_groups_and_head_dims(dev, group, head_dim):
    """Every GQA group and head_dim the tile takes, at S = 48 (no multiple
    of the 64-key tile, nor of the latent tile's 32): a full lane, a lane
    at seq_len 0 and one whose bucket padding starts mid-tile."""
    n_kv, s, lens = 2, 48, [48, 0, 17]
    q = _rnd(dev, 3, s, group * n_kv, head_dim, seed=44)
    k = _rnd(dev, 3, s, n_kv, head_dim, seed=45)
    v = _rnd(dev, 3, s, n_kv, head_dim, seed=46)
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    out = ca.prefill_attention(q, k, v, sl)
    ref = att.prefill_attention_ref(q, k, v, sl)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)
    assert not out[1].any()


@pytest.mark.parametrize("s,d", [(48, 128), (256, 128), (48, 640),
                                 (256, 640)])
def test_prefill_lane_equals_chunk_at_start_0(dev, s, d):
    """A lane at seq_len = S runs the blocks of chunk.cu's chunk at start 0
    over the same K/V written to pages: bit-identical outputs. At head_dim
    640 (16 heads on one KV head) with one lane: the latent prefill's span
    plan is then chunk.cu's."""
    ps, n_kv, h, lanes = (16, 8, 32, 2) if d == 128 else (16, 1, 16, 1)
    q = _rnd(dev, lanes, s, h, d, seed=47)
    k = _rnd(dev, lanes, s, n_kv, d, seed=48)
    v = _rnd(dev, lanes, s, n_kv, d, seed=49)
    sl = torch.tensor([s, s // 3][:lanes], dtype=torch.int32, device=dev)
    pk = torch.zeros((s // ps + 1, ps, n_kv * d), dtype=torch.bfloat16,
                     device=dev)
    pv = torch.zeros_like(pk)
    pk[1:] = k[0].reshape(s // ps, ps, n_kv * d)
    pv[1:] = v[0].reshape(s // ps, ps, n_kv * d)
    pages = torch.arange(1, s // ps + 1, dtype=torch.int32, device=dev)
    chunk = ca.chunk_prefill_attention(q[0], pk, pv, pages, 0, page_size=ps)
    assert torch.equal(ca.prefill_attention(q, k, v, sl)[0], chunk)


def _page_list(dev, n_tok, ps, pool_pages, seed):
    """A trash-padded page list for n_tok tokens: distinct random pages,
    then a tail of page 0, 5 entries past the last page (so the list's
    width is no multiple of the 64-key tile for most n_tok)."""
    real = -(-n_tok // ps)
    pages = np.zeros((real + 5,), np.int32)
    pages[:real] = np.random.default_rng(seed).permutation(
        pool_pages - 1)[:real] + 1
    return torch.tensor(pages, device=dev)


@pytest.mark.parametrize("start", [0, 5, 48, 512, 1792])
@pytest.mark.parametrize("c", [1, 16, 17, 100, 256])
def test_chunk_kernel_matches_plain(dev, start, c):
    ps, n_kv, d = 16, 8, 128
    kp = _rnd(dev, 160, ps, n_kv * d, seed=7)
    vp = _rnd(dev, 160, ps, n_kv * d, seed=8)
    pages = _page_list(dev, start + c, ps, 160, seed=start + c)
    q = _rnd(dev, c, 32, d, seed=9)
    out = ca.chunk_prefill_attention(q, kp, vp, pages, start, page_size=ps)
    ref = att.chunk_attention_ref(q, kp, vp, pages, start, page_size=ps)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)


@pytest.mark.parametrize("head_dim", [32, 64, 96, 128, 256])
@pytest.mark.parametrize("group", [1, 2, 4, 7, 8])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_chunk_kernel_groups_and_head_dims(dev, int8, group, head_dim):
    """Every GQA group and head_dim the tile takes, on both pools, with a
    chunk whose last query tile is partial, over a prefix."""
    ps, n_kv, start, c = 16, 2, 40, 77
    if int8:
        kp, vp = _int8_pools(dev, 32, ps, n_kv, head_dim, seed=41)
    else:
        kp = _rnd(dev, 32, ps, n_kv * head_dim, seed=41)
        vp = _rnd(dev, 32, ps, n_kv * head_dim, seed=42)
    pages = _page_list(dev, start + c, ps, 32, seed=3)
    q = _rnd(dev, c, group * n_kv, head_dim, seed=43)
    out = ca.chunk_prefill_attention(q, kp, vp, pages, start, page_size=ps,
                                     num_kv_heads=n_kv)
    ref = att.chunk_attention_ref(q, kp, vp, pages, start, page_size=ps,
                                  num_kv_heads=n_kv)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)


def test_tile_limits_agree_with_the_library_and_are_refused(dev):
    lib = ca.build()
    for group in (1, 2, 3, 4, 7, 8, 64):
        for d in (32, 64, 96, 128, 256):
            assert lib.dtt_chunk_positions(group, d) == ca.tile_positions(
                group, d)
    assert lib.dtt_chunk_positions(65, 64) == 0
    for d in (16, 40, 80, 144):
        assert lib.dtt_chunk_positions(4, d) == 0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for width, ps, n_dec, n_kv in ((1, 16, 1, 8), (128, 16, 8, 8),
                                   (143, 16, 3, 2), (7, 4, 1, 1),
                                   (8192, 16, 8, 8), (2048, 16, 256, 8),
                                   (256, 16, 8, 32), (512, 16, 8, 8)):
        # windowed layers too: Phi-3's 2047, Gemma-2's 4096 (and its verify
        # windows of 5), a window of one key, one wider than the table, at
        # every head_dim below 640
        for window, dq in ((0, 1), (0, 5), (2047, 1), (4096, 1), (4096, 5),
                           (1, 1), (100, 4), (1 << 20, 1)):
            for d in (32, 64, 96, 128, 256):
                assert lib.dtt_decode_split_keys(width, ps, n_dec, dq, n_kv,
                                                 d, window, sms) == \
                    ca.split_keys(width, ps, n_dec, n_kv, sms, window, dq, d)
    pages = torch.ones((4,), dtype=torch.int32, device=dev)
    tables = torch.ones((2, 4), dtype=torch.int32, device=dev)
    lens = torch.tensor([3, 20], dtype=torch.int32, device=dev)
    for h, n_kv, d, match in ((8, 2, 40, "head_dim"),
                              (8, 2, 80, "head_dim"),
                              (4, 1, 512, "head_dim"),
                              (128, 1, 32, "64-row")):
        q = _rnd(dev, 16 + 1, h, d)
        kp = _rnd(dev, 4, 16, n_kv * d)
        with pytest.raises(ValueError, match=match):
            ca.chunk_prefill_attention(q[:16], kp, kp, pages, 0,
                                       page_size=16)
        with pytest.raises(ValueError, match=match):
            ca.ragged_paged_attention(q, kp, kp, tables, lens, lens - 1,
                                      page_size=16, num_decode=1)
        with pytest.raises(ValueError, match=match):
            ca.paged_attention_decode(q[:2], kp, kp, tables, lens,
                                      page_size=16)
        kd = kp[:1].reshape(1, 16, n_kv, d)
        with pytest.raises(ValueError, match=match):
            ca.prefill_attention(q[None, :16], kd, kd, lens[:1])
    q = _rnd(dev, 4 + 16, 64, 32)
    kp = _rnd(dev, 4, 16, 2 * 32)
    with pytest.raises(ValueError, match="decode_q"):
        ca.ragged_paged_attention(q, kp, kp, tables, lens, lens - 1,
                                  page_size=16, num_decode=1, decode_q=4)
    # the entry points refuse a tiling or a split other than their own
    q = _rnd(dev, 16, 32, 128)
    kp = _rnd(dev, 4, 16, 8 * 128)
    out = torch.empty_like(q)
    for positions, spans in ((8, 1), (16, 2)):  # own: 16 positions, 1 span
        rc = lib.dtt_chunk(ca._ptr(q), ca._ptr(kp), ca._ptr(kp),
                           ca._ptr(pages), ca._ptr(out), 16, 32, 8, 128, 16, 0,
                           positions, spans, 0.1, 0, 0.0, None,
                           ca._stream(q))
        assert rc != 0
    # at head_dim 640 a cluster holds 1 to 8 spans
    ql = _rnd(dev, 16, 16, 640)
    kl = _rnd(dev, 4, 16, 640)
    outl = torch.empty_like(ql)
    for spans in (0, 9):
        rc = lib.dtt_chunk(ca._ptr(ql), ca._ptr(kl), ca._ptr(kl),
                           ca._ptr(pages), ca._ptr(outl), 16, 16, 1, 640, 16,
                           0, 4, spans, 0.1, 0, 0.0, None, ca._stream(ql))
        assert rc != 0
    qr = _rnd(dev, 1 + 16, 32, 128)
    part = torch.empty((1, 1, 32, 128), dtype=torch.float32, device=dev)
    for n_splits, span in ((1, 64), (2, 256)):  # own: one span of 256
        rc = lib.dtt_ragged(
            ca._ptr(qr), ca._ptr(kp), ca._ptr(kp), ca._ptr(tables),
            ca._ptr(lens), ca._ptr(lens), ca._ptr(qr), ca._ptr(part),
            ca._ptr(part), 1, 1, 16, 32, 8, 128, 16, 4, 16, n_splits, span,
            0.1, 0, 0.0, ca._stream(qr))
        assert rc != 0
        args = [ca._ptr(qr), ca._ptr(kp), ca._ptr(kp), ca._ptr(tables),
                ca._ptr(lens), ca._ptr(qr), ca._ptr(part), ca._ptr(part), 2,
                32, 8, 128, 16, 4]
        assert lib.dtt_paged_decode(*args, n_splits, span, 0.1, 0, 0.0,
                                    ca._stream(qr)) != 0
        assert lib.dtt_paged_decode_int8(*args, 8 * 128 + 16 * 8, n_splits,
                                         span, 0.1, 0, 0.0,
                                         ca._stream(qr)) != 0
    # prefill refuses a tiling other than the tile's 64 / group positions
    kd = _rnd(dev, 1, 16, 8, 128)
    rc = lib.dtt_prefill(ca._ptr(q), ca._ptr(kd), ca._ptr(kd),
                         ca._ptr(lens), ca._ptr(out), 1, 16, 32, 8, 128, 8,
                         1, 0.1, 0, 0.0, None, ca._stream(q))
    assert rc != 0


def test_wrappers_count_launches_and_refuse_bad_inputs(dev):
    q = _rnd(dev, 2, 8, 64)
    kp = _rnd(dev, 4, 16, 128)
    table = torch.ones((2, 2), dtype=torch.int32, device=dev)
    ctx = torch.tensor([3, 20], dtype=torch.int32, device=dev)
    before = ca.LAUNCHES["decode"]
    att.paged_attention_decode(q, kp, kp, table, ctx, page_size=16)
    assert ca.LAUNCHES["decode"] == before + 1
    with pytest.raises(ValueError, match="bfloat16"):
        ca.paged_attention_decode(q.float(), kp, kp, table, ctx,
                                  page_size=16)
    with pytest.raises(ValueError, match="int32"):
        ca.paged_attention_decode(q, kp, kp, table.long(), ctx, page_size=16)
    with pytest.raises(ValueError, match="contiguous"):
        ca.paged_attention_decode(q.transpose(0, 1).contiguous()
                                  .transpose(0, 1), kp, kp, table, ctx,
                                  page_size=16)
    # a GQA group past the tile's 64 rows: the wrapper refuses it with the
    # tile's limit, and so does the library's entry point under the split
    # plan the wrapper would have used
    lib = ca.build()
    wide_q = _rnd(dev, 1, 2 * ca.TILE_ROWS, 64)
    kp1 = _rnd(dev, 4, 16, 64)
    with pytest.raises(ValueError, match="64-row"):
        ca.paged_attention_decode(wide_q, kp1, kp1, table[:1], ctx[:1],
                                  page_size=16)
    out = torch.empty_like(wide_q)
    part = torch.empty((1, 1, 2 * ca.TILE_ROWS, 66), dtype=torch.float32,
                       device=dev)
    rc = lib.dtt_paged_decode(
        ca._ptr(wide_q), ca._ptr(kp1), ca._ptr(kp1), ca._ptr(table[:1]),
        ca._ptr(ctx[:1]), ca._ptr(out), ca._ptr(part), ca._ptr(part), 1,
        wide_q.shape[1], 1, 64, 16, 2, 1, 256, 0.125, 0, 0.0,
        ca._stream(wide_q))
    assert rc != 0


def test_engine_generates_on_the_card(dev):
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import Engine
    from dynamo_tpu_torch.engine.request import GenRequest

    eng = Engine(EngineConfig(model="tiny-debug", page_size=16, num_pages=64,
                              max_num_seqs=4, max_seq_len=512,
                              prefill_chunk_tokens=32,
                              enable_prefix_caching=False))
    assert eng.device.type == "cuda" and eng.dtype == torch.bfloat16
    ca.reset_launch_counts()
    for i, n in enumerate([5, 9, 70]):
        eng.add_request(GenRequest(f"r{i}", list(range(1, n + 1)),
                                   max_tokens=8, ignore_eos=True))
    out = {}
    while eng.has_work:
        for ev in eng.step():
            out.setdefault(ev.request_id, []).append(ev.token_id)
    assert all(len(v) == 8 for v in out.values())
    # the classic path: its three kernels, none of the mixed or int8 ones
    assert all(ca.LAUNCHES[k] > 0 for k in ("decode", "prefill", "chunk")), \
        ca.LAUNCHES
    assert sum(n for k, n in ca.LAUNCHES.items()
               if k not in ("decode", "prefill", "chunk")) == 0, ca.LAUNCHES


def _int8_pools(dev, pages, ps, n_kv, d, seed):
    """int8 packed pools from random values, and the same values in bf16
    pools (the plain versions read the packed ones)."""
    w = att.kv_lane_width(n_kv, d, True)
    out = []
    for s in (seed, seed + 1):
        x = _rnd(dev, pages * ps, n_kv, d, seed=s).float()
        out.append(att.pack_kv_rows(x, w).reshape(pages, ps, w))
    return out


@pytest.mark.parametrize("n_heads,n_kv,head_dim", [(32, 8, 128), (8, 2, 64),
                                                   (4, 2, 32)])
def test_int8_decode_kernel_matches_plain(dev, n_heads, n_kv, head_dim):
    ps, pages, pmax = 16, 64, 8
    kp, vp = _int8_pools(dev, pages, ps, n_kv, head_dim, seed=11)
    q = _rnd(dev, 5, n_heads, head_dim, seed=3)
    rng = np.random.default_rng(0)
    table = torch.tensor(rng.permutation(pages - 1)[:5 * pmax].reshape(5, pmax)
                         + 1, dtype=torch.int32, device=dev)
    ctx = torch.tensor([0, 1, 33, 100, 128], dtype=torch.int32, device=dev)
    before = ca.LAUNCHES["decode_int8"]
    out = ca.paged_attention_decode(q, kp, vp, table, ctx, page_size=ps,
                                    num_kv_heads=n_kv)
    ref = att.paged_attention_decode_ref(q, kp, vp, table, ctx, page_size=ps,
                                         num_kv_heads=n_kv)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)
    assert not out[0].any()
    assert ca.LAUNCHES["decode_int8"] == before + 1


@pytest.mark.parametrize("start", [0, 5, 48, 512, 1792])
@pytest.mark.parametrize("c", [1, 16, 17, 100, 256])
def test_int8_chunk_kernel_matches_plain(dev, start, c):
    ps, n_kv, d = 16, 8, 128
    kp, vp = _int8_pools(dev, 160, ps, n_kv, d, seed=13)
    pages = _page_list(dev, start + c, ps, 160, seed=start + c)
    q = _rnd(dev, c, 32, d, seed=9)
    out = ca.chunk_prefill_attention(q, kp, vp, pages, start, page_size=ps,
                                     num_kv_heads=n_kv)
    ref = att.chunk_attention_ref(q, kp, vp, pages, start, page_size=ps,
                                  num_kv_heads=n_kv)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)


@pytest.mark.parametrize("decode_q", [1, 4])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_ragged_kernel_matches_plain(dev, int8, decode_q):
    """Eight decode rows (context 0 on the trash page, context 1, rows
    ending on a 256-key split boundary and one key past it, a full table) and a 256-token chunk at position 512 on a trash-padded
    list, in one call; with int8 pools too. The chunk rows equal chunk.cu's
    output exactly, and the decode rows decode.cu's (the same blocks under
    the same split plan: the same table width and row count)."""
    ps, n_kv, d, h, pmax = 16, 8, 128, 32, 64
    if int8:
        kp, vp = _int8_pools(dev, 256, ps, n_kv, d, seed=21)
    else:
        kp = _rnd(dev, 256, ps, n_kv * d, seed=21)
        vp = _rnd(dev, 256, ps, n_kv * d, seed=22)
    ctx = [0, 1, 17, 255, 256, 257, 700, pmax * ps]
    rng = np.random.default_rng(5)
    tables = np.zeros((9, pmax), np.int32)
    for r, n in enumerate(ctx[1:], start=1):
        tables[r, :-(-n // ps)] = rng.permutation(255)[:-(-n // ps)] + 1
    tables[8, :48] = np.arange(1, 49)  # the chunk's pages, trash tail
    kv_lens = np.array(ctx + [512 + 256], np.int32)
    q_starts = np.array([max(n - decode_q, 0) for n in ctx] + [512],
                        np.int32)
    kv_lens[1:8] = np.maximum(kv_lens[1:8], q_starts[1:8] + decode_q)
    q = _rnd(dev, 8 * decode_q + 256, h, d, seed=23)
    args = [torch.tensor(a, device=dev) for a in (tables, kv_lens, q_starts)]
    name = "ragged_int8" if int8 else "ragged"
    before = ca.LAUNCHES[name]
    out = ca.ragged_paged_attention(q, kp, vp, *args, page_size=ps,
                                    num_kv_heads=n_kv, num_decode=8,
                                    decode_q=decode_q)
    ref = att.ragged_paged_attention_ref(q, kp, vp, *args, page_size=ps,
                                         num_kv_heads=n_kv, num_decode=8,
                                         decode_q=decode_q)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)
    assert ca.LAUNCHES[name] == before + 1
    assert not out[:decode_q].any()  # context 0: exact zeros
    n_kw = dict(page_size=ps, num_kv_heads=n_kv)
    chunk = ca.chunk_prefill_attention(q[8 * decode_q:], kp, vp, args[0][8],
                                       512, **n_kw)
    assert torch.equal(out[8 * decode_q:], chunk)
    if decode_q == 1:
        dec = ca.paged_attention_decode(q[:8], kp, vp, args[0][:8],
                                        args[1][:8], **n_kw)
        assert torch.equal(out[:8], dec)
    with pytest.raises(ValueError, match="fewer than"):
        ca.ragged_paged_attention(q[:8 * decode_q - 1], kp, vp, *args,
                                  page_size=ps, num_kv_heads=n_kv,
                                  num_decode=8, decode_q=decode_q)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_ragged_kernel_verify_only_matches_plain(dev, int8):
    """Verify windows without a chunk (C = 0) at decode_q = K+1 = 5, the
    8B's shapes (group 4: 20 of the tile's 64 rows), through
    verify_attention's descriptors: windows at position 0, across a split
    boundary, at a table's end, and an inactive slot on the trash page;
    against verify_attention_ref, and counted under its variant."""
    ps, n_kv, d, h, pmax, k1 = 16, 8, 128, 32, 64, 5
    if int8:
        kp, vp = _int8_pools(dev, 256, ps, n_kv, d, seed=31)
    else:
        kp = _rnd(dev, 256, ps, n_kv * d, seed=31)
        vp = _rnd(dev, 256, ps, n_kv * d, seed=32)
    positions = [0, 7, 250, 700, pmax * ps - k1, 0]
    rng = np.random.default_rng(6)
    tables = np.zeros((6, pmax), np.int32)
    for r, p in enumerate(positions[:5]):
        n = -(-(p + k1) // ps)
        tables[r, :n] = rng.permutation(255)[:n] + 1
    q = _rnd(dev, 6, k1, h, d, seed=33)
    tab = torch.tensor(tables, device=dev)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    name = "ragged_int8" if int8 else "ragged"
    ca.reset_launch_counts()
    out = att.verify_attention(q, kp, vp, tab, pos, page_size=ps,
                               num_kv_heads=n_kv)
    ref = att.verify_attention_ref(q, kp, vp, tab, pos, page_size=ps,
                                   num_kv_heads=n_kv)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)
    assert ca.LAUNCHES[name] == 1
    assert ca.VARIANT_LAUNCHES[f"{name}[decode_q=5,no_chunk]"] == 1


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("n_heads,n_kv,d", [(16, 16, 256), (8, 1, 256),
                                            (28, 4, 128), (32, 4, 128),
                                            (16, 1, 640), (32, 32, 96)],
                         ids=["gemma-7b", "gemma-2b", "qwen2.5-7b",
                              "qwen3-30b-a3b", "deepseek-v2-lite",
                              "phi-3-mini"])
@pytest.mark.parametrize("decode_q,c", [(1, 256), (5, 256), (5, 0)],
                         ids=["chunk_rows", "verify_rows", "verify_only"])
def test_ragged_kernel_at_the_families_shapes(dev, int8, n_heads, n_kv, d,
                                              decode_q, c):
    """The ragged kernel at head_dim 256 (groups 1 and 8), at group 7 (a
    verify row of 5 x 7 = 35 tile rows), at group 8 with head_dim 128
    (qwen3-30b-a3b: 5 x 8 = 40 tile rows) and at MLA's latent row
    (head_dim 640, group 16: a verify row of 80 rows, two query tiles of
    the latent decode rows walking each span side by side) and at
    Phi-3's head_dim 96 (group 1, 32 KV heads): eight rows
    (context 0 on the
    trash page, rows across a split boundary, a full table) beside a
    256-token chunk at 512, or alone (C = 0); counted under its head_dim."""
    ps, pmax, nd = 16, 64, 8
    if int8:
        kp, vp = _int8_pools(dev, 256, ps, n_kv, d, seed=61)
    else:
        kp = _rnd(dev, 256, ps, n_kv * d, seed=61)
        vp = _rnd(dev, 256, ps, n_kv * d, seed=62)
    ctx = [0, 1, 17, 255, 256, 257, 700, pmax * ps]
    rng = np.random.default_rng(7)
    tables = np.zeros((nd + 1, pmax), np.int32)
    for r, n in enumerate(ctx[1:], start=1):
        tables[r, :-(-n // ps)] = rng.permutation(255)[:-(-n // ps)] + 1
    if c:
        tables[nd, :48] = np.arange(1, 49)
    kv_lens = np.array(ctx + [512 + c if c else 0], np.int32)
    q_starts = np.array([max(n - decode_q, 0) for n in ctx]
                        + [512 if c else 0], np.int32)
    kv_lens[1:nd] = np.maximum(kv_lens[1:nd], q_starts[1:nd] + decode_q)
    q = _rnd(dev, nd * decode_q + c, n_heads, d, seed=63)
    args = [torch.tensor(a, device=dev) for a in (tables, kv_lens, q_starts)]
    kw = dict(page_size=ps, num_kv_heads=n_kv, num_decode=nd,
              decode_q=decode_q)
    name = "ragged_int8" if int8 else "ragged"
    ca.reset_launch_counts()
    out = ca.ragged_paged_attention(q, kp, vp, *args, **kw)
    ref = att.ragged_paged_attention_ref(q, kp, vp, *args, **kw)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)
    assert not out[:decode_q].any()  # context 0: exact zeros
    assert ca.VARIANT_LAUNCHES[f"{name}[head_dim={d}]"] == 1


@pytest.mark.parametrize("kernel", ["decode", "decode_int8", "prefill",
                                    "chunk", "ragged_verify",
                                    "ragged_verify_int8",
                                    "chunk[head_dim=640]",
                                    "chunk_int8[head_dim=640]",
                                    "decode[head_dim=640]",
                                    "decode_int8[head_dim=640]",
                                    "ragged_verify[head_dim=640]",
                                    "ragged_verify_int8[head_dim=640]",
                                    "decode[cap=50]", "decode_int8[cap=50]",
                                    "prefill[cap=50]", "chunk[cap=50]",
                                    "ragged_verify[cap=50]",
                                    "ragged_verify_int8[cap=50]",
                                    "decode[head_dim=96]",
                                    "decode_int8[head_dim=96]",
                                    "prefill[head_dim=96]",
                                    "chunk[head_dim=96]",
                                    "ragged_verify[head_dim=96]",
                                    "ragged_verify_int8[head_dim=96]",
                                    "decode[window=2047]",
                                    "decode_int8[window=2047]",
                                    "ragged_verify[window=2047]",
                                    "ragged_verify_int8[window=2047]",
                                    "decode[window=4096,cap=50]",
                                    "decode_int8[window=4096,cap=50]",
                                    "ragged_verify[window=4096,cap=50]",
                                    "ragged_verify_int8[window=4096,cap=50]"])
def test_kernels_hold_at_large_values(dev, kernel):
    """V scaled by 40 (output rows of RMS near 5 over about 100 keys, as
    the 8B's activations reach at depth): the error of P V grows with a
    row's RMS, not with each element, so a small element of such a row
    sees all of it. With P rounded to bf16 once, about 0.1% of the
    elements of each case fell past atol 2e-2 of the f32 version; with P
    in two bf16 parts (attention_common.cuh) only the output's own
    rounding is left. At head_dim 640 (16 heads on one KV head: the
    latent chunk tile, the latent decode rows and verify windows) on both
    pools. With Gemma-2's tanh cap at 50 (`[cap=50]`) q is scaled by 6,
    so that scores of tens reach the bend of the cap. At Phi-3's head_dim
    96 (`[head_dim=96]`: 32 heads on 32 KV heads, group 1). Under the
    windowed decode plan (`[window=2047]`: Phi-3's heads and window, q
    scaled by 2 so that 2047 keys still give rows of RMS near 5;
    `[window=4096,cap=50]`: Gemma-2-9B's local layers, 16 heads on 8 of
    256 lanes), at contexts past the window on 4096- and 8192-key
    tables."""
    ps, n_kv, d, h, big = 16, 8, 128, 32, 40.0
    latent = kernel.endswith("[head_dim=640]")
    cap = 50.0 if kernel.endswith("cap=50]") else 0.0
    window = 0
    pool_pages, width, scale_q = 128, 32, 1.0
    if latent:
        n_kv, d, h = 1, 640, 16
    if kernel.endswith("[head_dim=96]"):
        n_kv, d, h = 32, 96, 32
    if kernel.endswith("[window=2047]"):
        n_kv, d, h, window, scale_q = 32, 96, 32, 2047, 2.0
        pool_pages, width = 320, 256
    if kernel.endswith("[window=4096,cap=50]"):
        n_kv, d, h, window = 8, 256, 16, 4096
        pool_pages, width = 520, 512
    kernel = kernel.split("[")[0]
    qs = 6.0 if cap else scale_q
    rng = np.random.default_rng(8)

    def pools(seed, int8):
        n = pool_pages * ps
        vals = [_rnd(dev, n, n_kv, d, seed=seed).float(),
                _rnd(dev, n, n_kv, d, seed=seed + 1).float() * big]
        if int8:
            w = att.kv_lane_width(n_kv, d, True)
            return [att.pack_kv_rows(x, w).reshape(pool_pages, ps, w)
                    for x in vals]
        return [x.to(torch.bfloat16).reshape(pool_pages, ps, n_kv * d)
                for x in vals]

    int8 = kernel.endswith("int8")
    kw = dict(page_size=ps, num_kv_heads=n_kv)
    if latent and kernel.startswith("chunk"):
        kp, vp = pools(74, int8)
        pages = _page_list(dev, 64 + 128, ps, 128, seed=9)
        q = _rnd(dev, 128, h, d, seed=76)
        out = ca.chunk_prefill_attention(q, kp, vp, pages, 64, **kw)
        ref = att.chunk_attention_ref(q, kp, vp, pages, 64, **kw)
        rms = ref.float().pow(2).mean(-1).sqrt()
        assert float(rms.median()) > 2.5  # the scale the test is about
        torch.testing.assert_close(out.float(), ref.float(), **TOL)
        return
    mods = dict(logit_cap=cap) if cap else {}
    if window:
        mods["window"] = window
    if kernel == "prefill":
        q = (_rnd(dev, 2, 128, h, d, seed=71).float() * qs).bfloat16()
        k = _rnd(dev, 2, 128, n_kv, d, seed=72)
        v = (_rnd(dev, 2, 128, n_kv, d, seed=73).float() * big).bfloat16()
        sl = torch.tensor([128, 100], dtype=torch.int32, device=dev)
        out = ca.prefill_attention(q, k, v, sl, **mods)
        ref = att.prefill_attention_ref(q, k, v, sl, **mods)
    elif kernel == "chunk":
        kp, vp = pools(74, False)
        pages = _page_list(dev, 64 + 128, ps, 128, seed=9)
        q = (_rnd(dev, 128, h, d, seed=76).float() * qs).bfloat16()
        out = ca.chunk_prefill_attention(q, kp, vp, pages, 64, page_size=ps,
                                         **mods)
        ref = att.chunk_attention_ref(q, kp, vp, pages, 64, page_size=ps,
                                      **mods)
    elif kernel.startswith("decode"):
        kp, vp = pools(77, int8)
        ctx = [17, 60, 100, 100, 150, 200, 300, 400]
        if window:  # below, at and past the window, to the table's end
            ctx = [100, window - 1, window, window + 1, window + 64,
                   window + 700, width * ps - 1, width * ps]
        q = (_rnd(dev, 8, h, d, seed=79).float() * qs).bfloat16()
        table = np.zeros((8, width), np.int32)
        for b, n in enumerate(ctx):
            table[b, :-(-n // ps)] = rng.permutation(
                pool_pages - 1)[:-(-n // ps)] + 1
        args = (torch.tensor(table, device=dev),
                torch.tensor(ctx, dtype=torch.int32, device=dev))
        out = ca.paged_attention_decode(q, kp, vp, *args, **kw, **mods)
        ref = att.paged_attention_decode_ref(q, kp, vp, *args, **kw, **mods)
    else:
        kp, vp = pools(80, int8)
        positions = [12, 60, 95, 200, 300, 400, 0, 100]
        if window:
            positions = [0, 100, window - 3, window, window + 61,
                         window + 700, width * ps - 6, width * ps - 5]
        table = np.zeros((8, width), np.int32)
        for b, p in enumerate(positions):
            n = -(-(p + 5) // ps)
            table[b, :n] = rng.permutation(pool_pages - 1)[:n] + 1
        q = (_rnd(dev, 8, 5, h, d, seed=82).float() * qs).bfloat16()
        args = (torch.tensor(table, device=dev),
                torch.tensor(positions, dtype=torch.int32, device=dev))
        out = att.verify_attention(q, kp, vp, *args, **kw, **mods)
        ref = att.verify_attention_ref(q, kp, vp, *args, **kw, **mods)
    rms = ref.float().pow(2).mean(-1).sqrt()
    assert float(rms.median()) > 2.5  # the scale the test is about
    torch.testing.assert_close(out.float(), ref.float(), **TOL)


# (window, cap) of a Gemma-2/3 layer: no window, a window of one key, of
# 37 and 100 keys (row bounds inside a 64-key tile, a tile's rows with
# different bounds, spans of the decode plan wholly below the window) and
# one wider than every context
SCORE_MODS = [(0, 50.0), (1, 0.0), (37, 0.0), (100, 50.0), (4096, 50.0)]


@pytest.mark.parametrize("window,cap", SCORE_MODS,
                         ids=[f"w{w}-cap{int(c)}" for w, c in SCORE_MODS])
@pytest.mark.parametrize("kernel", ["decode", "decode_int8", "prefill",
                                    "chunk", "chunk_int8", "ragged",
                                    "ragged_int8", "verify", "verify_int8"])
def test_window_and_cap_match_plain(dev, kernel, window, cap):
    """The four kernels under a sliding window and a tanh logit cap at
    Gemma-2-9B's heads (16 on 8, head_dim 256) against their plain
    versions: decode rows at contexts 0 to 1024 over a 1024-key table
    (spans of 256 keys, the early ones wholly below a 100-key window),
    two prefill lanes of 256 positions (32 a query tile), a 100-token
    chunk at 700, eight decode rows beside a 256-token chunk at 512, and
    verify windows of 5 without a chunk; q scaled by 4 so that the cap
    bends. Counted under the `window` and `cap` variants."""
    ps, n_kv, h, d, pmax = 16, 8, 16, 256, 64
    int8 = kernel.endswith("_int8")
    base = kernel.split("_")[0]
    mods = dict(window=window, logit_cap=cap)
    kw = dict(page_size=ps, num_kv_heads=n_kv)

    def big(x):
        return (x.float() * 4.0).bfloat16()

    def pools(seed):
        if int8:
            return _int8_pools(dev, 256, ps, n_kv, d, seed=seed)
        return (_rnd(dev, 256, ps, n_kv * d, seed=seed),
                _rnd(dev, 256, ps, n_kv * d, seed=seed + 1))

    ca.reset_launch_counts()
    if base == "decode":
        ctx = [0, 1, 37, 100, 257, 700, 1000, 1024]
        q, kp, vp, table, cl = _decode_inputs(dev, int8, h, n_kv, d, ctx,
                                              pmax, pages=256, seed=90)
        q = big(q)
        out = ca.paged_attention_decode(q, kp, vp, table, cl, **kw, **mods)
        ref = att.paged_attention_decode_ref(q, kp, vp, table, cl, **kw,
                                             **mods)
        assert not out[0].any()  # ctx 0 -> exact zeros
    elif base == "prefill":
        q = big(_rnd(dev, 2, 256, h, d, seed=91))
        k = _rnd(dev, 2, 256, n_kv, d, seed=92)
        v = _rnd(dev, 2, 256, n_kv, d, seed=93)
        sl = torch.tensor([256, 200], dtype=torch.int32, device=dev)
        out = ca.prefill_attention(q, k, v, sl, **mods)
        ref = att.prefill_attention_ref(q, k, v, sl, **mods)
    elif base == "chunk":
        kp, vp = pools(94)
        pages = _page_list(dev, 700 + 100, ps, 256, seed=95)
        q = big(_rnd(dev, 100, h, d, seed=96))
        out = ca.chunk_prefill_attention(q, kp, vp, pages, 700, **kw, **mods)
        ref = att.chunk_attention_ref(q, kp, vp, pages, 700, **kw, **mods)
    elif base == "ragged":
        kp, vp = pools(97)
        ctx = [0, 1, 17, 255, 256, 257, 700, pmax * ps]
        rng = np.random.default_rng(98)
        tables = np.zeros((9, pmax), np.int32)
        for r, n in enumerate(ctx[1:], start=1):
            tables[r, :-(-n // ps)] = rng.permutation(255)[:-(-n // ps)] + 1
        tables[8, :48] = np.arange(1, 49)
        kv_lens = np.array(ctx + [512 + 256], np.int32)
        q_starts = np.array([max(n - 1, 0) for n in ctx] + [512], np.int32)
        args = [torch.tensor(a, device=dev)
                for a in (tables, kv_lens, q_starts)]
        q = big(_rnd(dev, 8 + 256, h, d, seed=99))
        rkw = dict(kw, num_decode=8)
        out = ca.ragged_paged_attention(q, kp, vp, *args, **rkw, **mods)
        ref = att.ragged_paged_attention_ref(q, kp, vp, *args, **rkw, **mods)
        # the chunk rows are chunk.cu's, the decode rows decode.cu's
        assert torch.equal(out[8:], ca.chunk_prefill_attention(
            q[8:], kp, vp, args[0][8], 512, **kw, **mods))
        assert torch.equal(out[:8], ca.paged_attention_decode(
            q[:8], kp, vp, args[0][:8], args[1][:8], **kw, **mods))
    else:
        kp, vp = pools(100)
        k1 = 5
        positions = [0, 7, 250, 700, pmax * ps - k1, 0]
        rng = np.random.default_rng(101)
        tables = np.zeros((6, pmax), np.int32)
        for r, p in enumerate(positions[:5]):
            n = -(-(p + k1) // ps)
            tables[r, :n] = rng.permutation(255)[:n] + 1
        q = big(_rnd(dev, 6, k1, h, d, seed=102))
        args = (torch.tensor(tables, device=dev),
                torch.tensor(positions, dtype=torch.int32, device=dev))
        out = att.verify_attention(q, kp, vp, *args, **kw, **mods)
        ref = att.verify_attention_ref(q, kp, vp, *args, **kw, **mods)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)
    name = ("ragged" if base == "verify" else base) + ("_int8" if int8
                                                        else "")
    assert ca.VARIANT_LAUNCHES[f"{name}[window]"] >= bool(window)
    assert ca.VARIANT_LAUNCHES[f"{name}[cap]"] >= bool(cap)
    assert (f"{name}[window]" in ca.VARIANT_LAUNCHES) == bool(window)


# Phi-3's windows: 37 and 100 keys (bounds inside a 64-key tile, whose 64
# rows at group 1 are 64 positions with 64 different bounds) and its own
# 2047, wider than every context here but the decode table's
PHI3_WINDOWS = [37, 100, 2047]


@pytest.mark.parametrize("window", PHI3_WINDOWS,
                         ids=[f"w{w}" for w in PHI3_WINDOWS])
@pytest.mark.parametrize("kernel", ["decode", "decode_int8", "prefill",
                                    "chunk", "chunk_int8", "ragged",
                                    "ragged_int8", "verify", "verify_int8"])
def test_phi3_window_matches_plain(dev, kernel, window):
    """The four kernels at Phi-3's head shape (32 query heads on 32 KV
    heads of 96 lanes: group 1, and an int8 row's 64 scale bytes in four
    16-byte chunks) under a sliding window, against their plain
    versions: decode rows at contexts 0 to 4096 over a 4096-key table, a
    prefill lane of 256 positions beside one of 200 (64 a query tile), a
    100-token chunk at 700, eight decode rows beside a 256-token chunk at
    512, and verify windows of 5 without a chunk; counted under the
    `window` and `head_dim=96` variants."""
    ps, n_kv, h, d = 16, 32, 32, 96
    int8 = kernel.endswith("_int8")
    base = kernel.split("_")[0]
    mods = dict(window=window)
    kw = dict(page_size=ps, num_kv_heads=n_kv)

    def pools(seed):
        if int8:
            return _int8_pools(dev, 320, ps, n_kv, d, seed=seed)
        return (_rnd(dev, 320, ps, n_kv * d, seed=seed),
                _rnd(dev, 320, ps, n_kv * d, seed=seed + 1))

    ca.reset_launch_counts()
    if base == "decode":
        ctx = [0, 1, 37, 100, 700, 2047, 2048, 4096]
        q, kp, vp, table, cl = _decode_inputs(dev, int8, h, n_kv, d, ctx,
                                              4096 // ps, pages=720,
                                              seed=110)
        out = ca.paged_attention_decode(q, kp, vp, table, cl, **kw, **mods)
        ref = att.paged_attention_decode_ref(q, kp, vp, table, cl, **kw,
                                             **mods)
        assert not out[0].any()  # ctx 0 -> exact zeros
    elif base == "prefill":
        q = _rnd(dev, 2, 256, h, d, seed=111)
        k = _rnd(dev, 2, 256, n_kv, d, seed=112)
        v = _rnd(dev, 2, 256, n_kv, d, seed=113)
        sl = torch.tensor([256, 200], dtype=torch.int32, device=dev)
        out = ca.prefill_attention(q, k, v, sl, **mods)
        ref = att.prefill_attention_ref(q, k, v, sl, **mods)
    elif base == "chunk":
        kp, vp = pools(114)
        pages = _page_list(dev, 700 + 100, ps, 320, seed=115)
        q = _rnd(dev, 100, h, d, seed=116)
        out = ca.chunk_prefill_attention(q, kp, vp, pages, 700, **kw, **mods)
        ref = att.chunk_attention_ref(q, kp, vp, pages, 700, **kw, **mods)
    elif base == "ragged":
        kp, vp = pools(117)
        pmax = 64
        ctx = [0, 1, 17, 255, 256, 257, 700, pmax * ps]
        rng = np.random.default_rng(118)
        tables = np.zeros((9, pmax), np.int32)
        for r, n in enumerate(ctx[1:], start=1):
            tables[r, :-(-n // ps)] = rng.permutation(319)[:-(-n // ps)] + 1
        tables[8, :48] = np.arange(1, 49)
        kv_lens = np.array(ctx + [512 + 256], np.int32)
        q_starts = np.array([max(n - 1, 0) for n in ctx] + [512], np.int32)
        args = [torch.tensor(a, device=dev)
                for a in (tables, kv_lens, q_starts)]
        q = _rnd(dev, 8 + 256, h, d, seed=119)
        rkw = dict(kw, num_decode=8)
        out = ca.ragged_paged_attention(q, kp, vp, *args, **rkw, **mods)
        ref = att.ragged_paged_attention_ref(q, kp, vp, *args, **rkw, **mods)
        # the chunk rows are chunk.cu's, the decode rows decode.cu's
        assert torch.equal(out[8:], ca.chunk_prefill_attention(
            q[8:], kp, vp, args[0][8], 512, **kw, **mods))
        assert torch.equal(out[:8], ca.paged_attention_decode(
            q[:8], kp, vp, args[0][:8], args[1][:8], **kw, **mods))
    else:
        kp, vp = pools(120)
        pmax, k1 = 64, 5
        positions = [0, 7, 250, 700, pmax * ps - k1, 0]
        rng = np.random.default_rng(121)
        tables = np.zeros((6, pmax), np.int32)
        for r, p in enumerate(positions[:5]):
            n = -(-(p + k1) // ps)
            tables[r, :n] = rng.permutation(319)[:n] + 1
        q = _rnd(dev, 6, k1, h, d, seed=122)
        args = (torch.tensor(tables, device=dev),
                torch.tensor(positions, dtype=torch.int32, device=dev))
        out = att.verify_attention(q, kp, vp, *args, **kw, **mods)
        ref = att.verify_attention_ref(q, kp, vp, *args, **kw, **mods)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)
    name = ("ragged" if base == "verify" else base) + ("_int8" if int8
                                                        else "")
    assert ca.VARIANT_LAUNCHES[f"{name}[window]"] >= 1
    assert ca.VARIANT_LAUNCHES[f"{name}[head_dim=96]"] >= 1


# the windowed decode rows' shapes: Phi-3 (32 heads on 32 KV heads of 96
# lanes, window 2047, 4096-key tables) and Gemma-2-9B's local layers (16 on
# 8 of 256, window 4096, cap 50, 8192-key tables)
WINDOWED_SHAPES = {"phi3": (32, 32, 96, 2047, 0.0, 256),
                   "gemma2": (16, 8, 256, 4096, 50.0, 512)}


def _edge_contexts(window, span, ps, keys):
    """Decode contexts at a windowed row's edges: below the window, at it
    and one past, where the window's first key falls on a key tile, a
    page and a span of the plan (and one key either side), and the
    table's end."""
    ctx = {1, 100, window - 1, window, window + 1, keys - 1, keys}
    for edge in (ca.KEY_TILE, ps, span, 2 * span):
        ctx |= {window + edge - 1, window + edge, window + edge + 1}
    return sorted(c for c in ctx if 1 <= c <= keys)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("shape", sorted(WINDOWED_SHAPES))
def test_windowed_decode_rows_hold_at_the_window_edges(dev, shape, int8):
    """decode.cu's rows and ragged.cu's decode rows (beside a chunk) at
    Phi-3's and Gemma-2's shapes under the window-relative plan, at the
    contexts where a row one key short or one key long would show,
    against the plain decode attention; a ragged decode row equals
    decode.cu's bit for bit (the same blocks under the same plan), and
    the plan is the library's."""
    h, n_kv, d, window, cap, width = WINDOWED_SHAPES[shape]
    ps, sms = 16, torch.cuda.get_device_properties(dev).multi_processor_count
    keys = width * ps
    span, _ = ca.split_plan(width, ps, 8, n_kv, sms, window, 1, d)
    ctx = _edge_contexts(window, span, ps, keys)
    mods = dict(window=window, logit_cap=cap)
    kw = dict(page_size=ps, num_kv_heads=n_kv)
    pages = width + 8
    for i in range(0, len(ctx), 8):
        rows = ctx[i:i + 8]
        q, kp, vp, table, cl = _decode_inputs(
            dev, int8, h, n_kv, d, rows, width, pages=pages * len(rows),
            seed=130 + i)
        q = (q.float() * (4.0 if cap else 1.0)).bfloat16()
        n = len(rows)
        out = ca.paged_attention_decode(q, kp, vp, table, cl, **kw, **mods)
        ref = att.paged_attention_decode_ref(q, kp, vp, table, cl, **kw,
                                             **mods)
        torch.testing.assert_close(out.float(), ref.float(), **TOL)
        # the same rows in a mixed step beside a 256-token chunk at 512
        tables = torch.zeros((n + 1, width), dtype=torch.int32, device=dev)
        tables[:n] = table
        tables[n, :48] = torch.arange(1, 49, device=dev)
        kv_lens = torch.cat([cl, cl.new_tensor([768])])
        q_starts = torch.cat([cl - 1, cl.new_tensor([512])])
        qr = torch.cat([q, _rnd(dev, 256, h, d, seed=140 + i)])
        rag = ca.ragged_paged_attention(qr, kp, vp, tables, kv_lens,
                                        q_starts, num_decode=n, **kw, **mods)
        assert torch.equal(rag[:n], out)


def test_latent_kernels_refuse_window_and_cap(dev):
    """The latent tile (head_dim 640) takes no window or cap: the
    wrappers refuse both before any launch."""
    kp = _rnd(dev, 8, 16, 640, seed=1)
    q = _rnd(dev, 2, 16, 640, seed=2)
    table = torch.ones((2, 4), dtype=torch.int32, device=dev)
    ctx = torch.tensor([5, 9], dtype=torch.int32, device=dev)
    for mods in (dict(window=8), dict(logit_cap=50.0)):
        with pytest.raises(ValueError, match="latent"):
            ca.paged_attention_decode(q, kp, kp, table, ctx, page_size=16,
                                      **mods)


@pytest.mark.parametrize("family", ["gemma", "qwen2", "qwen3", "gemma2",
                                    "gemma3", "phi3", "phi3_longrope"])
def test_family_graph_windows_equal_eager_windows(dev, family):
    """The families' tiny configs (tiny-gemma-debug, tiny-gemma2-debug and
    tiny-gemma3-debug at head_dim 256: their decode and prefill reach the
    D = 256 kernels, Gemma-2/3's with each layer's window captured in the
    graph; Phi-3's switches at head_dim 96 with a window of 8 on every
    layer, and with longrope over a 16-token original context, whose
    factors each captured step picks from the positions on the card) in
    4-step graph windows against eager windows, bit for bit."""
    import dataclasses

    from dynamo_tpu_torch.models.config import PRESETS

    phi3 = dataclasses.replace(
        PRESETS["phi-3-mini-4k-instruct"], vocab_size=512, hidden_size=192,
        intermediate_size=256, num_layers=2, num_heads=2, num_kv_heads=2,
        sliding_window=8, eos_token_id=2, extra_stop_token_ids=())
    cfg = {"phi3": phi3,
           "phi3_longrope": dataclasses.replace(
               phi3, max_position_embeddings=128, rope_longrope_scaling=(
                   tuple(1.0 + i / 96 for i in range(48)),
                   tuple(1.0 + i / 8 for i in range(48)), 16)),
           "gemma": dataclasses.replace(PRESETS["tiny-gemma-debug"],
                                        head_dim=256),
           "gemma2": dataclasses.replace(PRESETS["tiny-gemma2-debug"],
                                         head_dim=256),
           "gemma3": dataclasses.replace(PRESETS["tiny-gemma3-debug"],
                                         head_dim=256),
           "qwen2": dataclasses.replace(PRESETS["tiny-debug"],
                                        attention_bias=True),
           "qwen3": dataclasses.replace(PRESETS["tiny-debug"],
                                        qk_norm=True)}[family]
    eager = _window_engine(True, model_cfg=cfg)
    with torch.no_grad():  # non-zero biases and norms
        g = torch.Generator(device=dev)
        g.manual_seed(5)
        for name, p in eager.model.named_parameters():
            if p.dim() == 1:
                p.add_(0.3 * torch.randn(p.shape, generator=g, device=dev,
                                         dtype=torch.float32).to(p.dtype))
    graphs = _window_engine(False, params=eager.model, model_cfg=cfg)
    want = _window_run(eager)
    ca.reset_launch_counts()
    assert _window_run(graphs) == want
    assert graphs.windows.stats()["replays"] > 0
    assert ca.VARIANT_LAUNCHES[f"decode[head_dim={cfg.head_dim}]"] > 0
    if cfg.sliding_window:
        assert ca.VARIANT_LAUNCHES["decode[window]"] > 0


def test_mixed_int8_engine_launches_its_kernels(dev):
    """A mixed engine on int8 pools: a long prompt alone takes the classic
    chunk path, then a long prompt beside a live stream rides the mixed
    step; every pool-reading int8 kernel launches and no bf16 one does."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import Engine
    from dynamo_tpu_torch.engine.request import GenRequest

    # prefill_chunk_tokens 0: the chunk size inherits the mixed budget
    eng = Engine(EngineConfig(model="tiny-debug", page_size=16, num_pages=64,
                              max_num_seqs=4, max_seq_len=512,
                              prefill_chunk_tokens=0, mixed_batch_tokens=32,
                              kv_cache_dtype="int8",
                              enable_prefix_caching=False))
    assert eng.cfg.prefill_chunk_tokens == 32
    assert eng.k_pages.dtype == torch.int8
    ca.reset_launch_counts()
    assert len(eng.generate(GenRequest("alone", list(range(1, 71)),
                                       max_tokens=4, ignore_eos=True))) == 4
    eng.add_request(GenRequest("live", [1, 2, 3], max_tokens=16,
                               ignore_eos=True))
    eng.step()
    eng.add_request(GenRequest("long", list(range(3, 90)), max_tokens=4,
                               ignore_eos=True))
    while eng.has_work:
        eng.step()
    assert eng.metrics.mixed_count > 0
    for k in ("prefill", "decode_int8", "chunk_int8", "ragged_int8"):
        assert ca.LAUNCHES[k] > 0, ca.LAUNCHES
    assert ca.LAUNCHES["ragged_int8"] == 2 * eng.metrics.mixed_count
    for k in ("decode", "chunk", "ragged"):
        assert ca.LAUNCHES[k] == 0, ca.LAUNCHES


def _window_engine(enforce_eager, params=None, model_cfg=None,
                   model="tiny-debug", **kw):
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import Engine

    return Engine(EngineConfig(model=model, page_size=16,
                               num_pages=64, max_num_seqs=4, max_seq_len=512,
                               prefill_chunk_tokens=32,
                               enable_prefix_caching=False,
                               num_scheduler_steps=4,
                               enforce_eager=enforce_eager, **kw),
                  model_cfg=model_cfg, params=params)


def _window_run(eng):
    """Greedy, seeded sampled and logprobs requests to the end: {rid:
    [(token, logprob)]}."""
    from dynamo_tpu_torch.engine.request import GenRequest

    reqs = [GenRequest("g", list(range(1, 8)), max_tokens=13,
                       ignore_eos=True),
            GenRequest("s", list(range(5, 45)), max_tokens=11,
                       temperature=0.8, top_p=0.9, seed=7, ignore_eos=True),
            GenRequest("lp", [3, 1, 4, 1, 5], max_tokens=9, logprobs=3,
                       ignore_eos=True)]
    for r in reqs:
        eng.add_request(r)
    out = {}
    while eng.has_work:
        for ev in eng.step():
            if ev.token_id >= 0:
                out.setdefault(ev.request_id, []).append(
                    (ev.token_id, ev.logprob, ev.top_logprobs))
    return out


@pytest.mark.parametrize("async_scheduling", [False, True],
                         ids=["sync", "async"])
def test_graph_windows_equal_eager_windows(dev, async_scheduling):
    """4-step windows replayed from CUDA graphs give the eager body's
    tokens and logprobs bit for bit (the same kernels on the same shapes),
    and the launch counts add each replay's recorded launches: 2 layers x
    (decode steps + one warm-up pass per captured graph)."""
    eager = _window_engine(True, async_scheduling=async_scheduling)
    graphs = _window_engine(False, params=eager.model,
                            async_scheduling=async_scheduling)
    want = _window_run(eager)
    ca.reset_launch_counts()
    got = _window_run(graphs)
    assert got == want
    st = graphs.windows.stats()
    assert not st["eager"] and st["graphs"] >= 2 and st["replays"] > 0
    layers = graphs.model_cfg.num_layers
    assert ca.LAUNCHES["decode"] == layers * (graphs.metrics.decode_steps
                                              + st["graphs"]), (ca.LAUNCHES,
                                                                st)
    assert graphs.metrics.decode_steps == st["replays"]


def test_warmup_captures_the_greedy_graphs(dev):
    """With and without logprobs, plain and JSON-guided: four graphs."""
    eng = _window_engine(False)
    eng.warmup()
    assert eng.windows.stats()["graphs"] == 4
    from dynamo_tpu_torch.engine.request import GenRequest

    assert len(eng.generate(GenRequest("w", [1, 2, 3], max_tokens=10,
                                       ignore_eos=True))) == 10
    assert len(eng.generate(GenRequest("g", [1, 2, 3], max_tokens=10,
                                       guided_json=True))) > 0
    assert eng.windows.stats()["graphs"] == 4  # no capture while serving


def test_json_kernel_matches_plain(dev):
    """json_mask and json_advance against their plain versions, exactly,
    on every mode at depths 0, 1, 5 and 31 over a 16-byte-wide table with
    specials and stop ids, bf16 and float32 logits; counted launches."""
    from dynamo_tpu_torch.ops import cuda_guide
    from dynamo_tpu_torch.ops import json_guide as jg

    rng = np.random.default_rng(0)
    v = 3000
    alpha = np.frombuffer(b'{}[]",:0123456789-.eE+tfnrulas \\/\n', np.uint8)
    lens = rng.integers(1, 17, size=v)
    tb = np.where(rng.random((v, 16)) < 0.85,
                  alpha[rng.integers(0, len(alpha), (v, 16))],
                  rng.integers(0, 256, (v, 16)))
    tb = np.where(np.arange(16)[None] < lens[:, None], tb, -1)
    lens[:20] = 0
    eos = np.zeros(v, bool)
    eos[:3] = True
    table = jg.DeviceTable(jg.VocabTable(tb.astype(np.int32),
                                         lens.astype(np.int32), eos), dev)
    modes = np.arange(jg.DEAD + 1, dtype=np.int32)
    b = len(modes)
    ca.reset_launch_counts()
    for depth in (0, 1, 5, 31):
        st = [torch.tensor(a, dtype=torch.int32, device=dev) for a in (
            modes, np.full(b, depth), rng.integers(-2**31, 2**31, b))]
        act = torch.tensor(rng.random(b) < 0.8, device=dev)
        for dtype in (torch.bfloat16, torch.float32):
            logits = torch.randn(b, v, device=dev).to(dtype)
            got, want = logits.clone(), logits.clone()
            cuda_guide.json_mask(got, *st, act, table)
            jg.mask_logits(want, *st, act, table)
            assert torch.equal(got, want)
        tokens = torch.tensor(rng.integers(0, v, b), device=dev)
        got_st = [t.clone() for t in st]
        want_st = [t.clone() for t in st]
        cuda_guide.json_advance(tokens, *got_st, act, table)
        jg.advance(tokens, *want_st, act, table)
        assert all(torch.equal(x, y) for x, y in zip(got_st, want_st))
    assert ca.LAUNCHES["json_mask"] == 8 and ca.LAUNCHES["json_advance"] == 4
    with pytest.raises(ValueError, match="must be"):
        cuda_guide.json_mask(logits.to(torch.float16), *st, act, table)


def _guided_run(eng):
    from dynamo_tpu_torch.engine.request import GenRequest

    reqs = [GenRequest("g", [1, 2, 3], max_tokens=40, guided_json=True),
            GenRequest("s", list(range(5, 45)), max_tokens=40,
                       temperature=1.0, seed=3, guided_json=True),
            GenRequest("p", [3, 1, 4], max_tokens=9, ignore_eos=True)]
    for r in reqs:
        eng.add_request(r)
    out = {}
    while eng.has_work:
        for ev in eng.step():
            if ev.token_id >= 0:
                out.setdefault(ev.request_id, []).append(ev.token_id)
    return out


def test_guided_graph_windows_equal_eager_windows(dev):
    """Guided 4-step windows replayed from CUDA graphs give the eager
    body's tokens; json_advance launches once per replayed step (the
    capture's launches are kept with the graph), json_mask as often plus
    once per prefill that samples a guided first token (one or two for
    the two guided requests)."""
    eager = _window_engine(True)
    graphs = _window_engine(False, params=eager.model)
    want = _guided_run(eager)
    ca.reset_launch_counts()
    assert _guided_run(graphs) == want
    st = graphs.windows.stats()
    assert st["replays"] > 0
    steps = ca.LAUNCHES["json_advance"]
    assert 0 < steps <= st["replays"] + st["graphs"]
    assert steps + 1 <= ca.LAUNCHES["json_mask"] <= steps + 2


def test_lora_graph_windows_equal_eager_windows(dev):
    """Base and adapter rows together in graph windows: the eager body's
    tokens; the base row's are those of lora_slots=0."""
    from dynamo_tpu_torch.engine.request import GenRequest
    from dynamo_tpu_torch.lora import apply as lora_apply

    def run(eng, adapters=True):
        if adapters:
            for i, n in enumerate(("a", "b")):
                eng.lora.register(n, tensors=lora_apply.random_adapter(
                    eng.model_cfg, 4, seed=i + 1, scale=0.3), rank=4)
        for i, a in enumerate((None, "a", "b")):
            eng.add_request(GenRequest(f"r{i}", [5, 6, 7, 8 + i],
                                       max_tokens=12, ignore_eos=True,
                                       adapter=a if adapters else None))
        out = {}
        while eng.has_work:
            for ev in eng.step():
                if ev.token_id >= 0:
                    out.setdefault(ev.request_id, []).append(ev.token_id)
        return out

    eager = _window_engine(True, lora_slots=2, lora_rank=4)
    want = run(eager)
    got = run(_window_engine(False, params=eager.model, lora_slots=2,
                             lora_rank=4))
    assert got == want
    base = run(_window_engine(False, params=eager.model), adapters=False)
    assert base["r0"] == got["r0"] and base["r1"] != got["r1"]


def test_noise_bits_on_the_card_are_the_cpu_ones(dev):
    from dynamo_tpu_torch.engine import sampling as smp

    keys = torch.tensor([7, 1234, (1 << 63) - 1], dtype=torch.int64)
    pos = torch.tensor([3, 17, 4095], dtype=torch.int32)
    rows_cpu = smp.fold_positions(keys, pos)
    rows_dev = smp.fold_positions(keys.to(dev), pos.to(dev))
    assert rows_dev.cpu().tolist() == rows_cpu.tolist()
    bits = smp.uniform_bits(rows_dev, 128256)
    assert torch.equal(bits.cpu(), smp.uniform_bits(rows_cpu, 128256))
    pinned = smp.uniform_bits(torch.tensor([smp.fold_in(1234, 17)],
                                           device=dev), 8)
    assert pinned[0].tolist() == [3506449212, 1812485701, 505603136,
                                  2319869864, 3651098138, 3592466632,
                                  1436975056, 3455550514]


@pytest.mark.parametrize("rows", [1, 8, 17, 256])
def test_int_mm_is_exact_at_few_rows(dev, rows):
    """torch._int_mm refuses 16 rows or fewer on the card: quant.int_mm
    pads with zero rows, and the int32 product equals the exact integer
    one (f64 on the card: every partial sum is an integer below 2^53)."""
    from dynamo_tpu_torch.models import quant

    g = torch.Generator(device=dev)
    g.manual_seed(rows)
    a = torch.randint(-127, 128, (rows, 4096), generator=g, device=dev,
                      dtype=torch.int8)
    b = quant.operand_layout(torch.randint(-127, 128, (4096, 1024),
                                           generator=g, device=dev,
                                           dtype=torch.int8))
    got = quant.int_mm(a, b)
    assert got.dtype == torch.int32 and got.shape == (rows, 1024)
    assert torch.equal(got.long(), (a.double() @ b.double()).long())


def test_w8a8_rows_do_not_depend_on_padding(dev):
    """8 rows alone (padded to 17 inside int_mm) and inside a 64-row batch
    give the same bits."""
    from dynamo_tpu_torch.models import quant

    x = _rnd(dev, 64, 512, seed=9)
    w = quant.quantize_weight("w_up", _rnd(dev, 512, 256, seed=10), "w8a8")
    assert torch.equal(quant.matmul(x[:8], w), quant.matmul(x, w)[:8])


@pytest.mark.parametrize("mode", ["none", "w8a8"])
def test_moe_graph_windows_equal_eager_windows(dev, mode):
    """tiny-moe-debug (its MoE blocks: the router's top-k, the dense
    dispatch over every expert, bf16 or w8a8 expert stacks) in 4-step
    graph windows against eager windows, bit for bit; the step captures
    (no host sync in the routing)."""
    from dynamo_tpu_torch.models import quant

    eager = _window_engine(True, quantization=mode, model="tiny-moe-debug")
    graphs = _window_engine(False, params=eager.model, quantization=mode,
                            model="tiny-moe-debug")
    assert graphs.model_cfg.is_moe and quant.mode_of(graphs.model) == mode
    want = _window_run(eager)
    assert _window_run(graphs) == want
    st = graphs.windows.stats()
    assert not st["eager"] and st["replays"] > 0


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("start,c", [(0, 64), (48, 100), (512, 256), (0, 1),
                                     (512, 88), (37, 100), (1792, 256),
                                     (100, 40)])
def test_chunk_and_prefill_kernels_at_the_latent_row(dev, int8, start, c):
    """chunk.cu at MLA's latent row (head_dim 640, one KV head for 16
    query heads: the latent chunk tile, each query tile's keys in spans
    merged by its cluster) on both pools: C = 1, the ~88-token tail at
    512, a start off the page grid (37), the last chunk of a 2048-token
    prompt (a 1792-token prefix), and span boundaries inside pages
    (C = 40 at 100: 4 spans of 26-35 keys); and prefill.cu on the same
    K/V (bf16: two lanes, one cut at 37 tokens) at start 0."""
    ps, d, h = 16, 640, 16
    if int8:
        kp, vp = _int8_pools(dev, 160, ps, 1, d, seed=71)
    else:
        kp, vp = _rnd(dev, 160, ps, d, seed=71), _rnd(dev, 160, ps, d,
                                                        seed=72)
    pages = torch.arange(1, 160, dtype=torch.int32, device=dev)[:136]
    q = _rnd(dev, c, h, d, seed=73)
    kw = dict(page_size=ps, num_kv_heads=1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    spans = ca.chunk_span_keys(c, start, 16, d, 1, sms)
    if (start, c) == (100, 40):  # a span boundary falls inside a page
        assert any(lo % ps for _, _, sp in spans for lo, hi in sp[1:]
                   if lo < hi)
    out = ca.chunk_prefill_attention(q, kp, vp, pages, start, **kw)
    ref = att.chunk_attention_ref(q, kp, vp, pages, start, **kw)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)
    if int8 or start:
        return
    k = kp[pages.long()].reshape(-1, 1, d)[:c]
    v = vp[pages.long()].reshape(-1, 1, d)[:c]
    qs = torch.stack([q, q])
    lens = torch.tensor([c, 37], dtype=torch.int32, device=dev)
    outp = ca.prefill_attention(qs, torch.stack([k, k]), torch.stack([v, v]),
                                lens)
    refp = att.prefill_attention_ref(qs, torch.stack([k, k]),
                                     torch.stack([v, v]), lens)
    torch.testing.assert_close(outp.float(), refp.float(), **TOL)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_latent_chunk_launches_give_equal_bits(dev, int8):
    """The latent chunk tile at the phase-3 shape (C = 256 at 512: two
    spans a query tile, 128 blocks) and the tail (C = 88 at 512: four
    spans): its spans merge in a fixed order, so two launches on the same
    inputs give the same bits, and every span count gives the plan's
    output within the tolerance; the library's span plan is the
    wrapper's, each cluster size fits the card, and a launch counts under
    chunk[head_dim=640]."""
    ps, d, h = 16, 640, 16
    if int8:
        kp, vp = _int8_pools(dev, 64, ps, 1, d, seed=81)
    else:
        kp, vp = _rnd(dev, 64, ps, d, seed=81), _rnd(dev, 64, ps, d, seed=82)
    pages = _page_list(dev, 768, ps, 64, seed=83)
    lib = ca.build()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for c, start in ((256, 512), (88, 512), (256, 0), (1, 700)):
        for group, hd in ((16, 640), (4, 640), (4, 128)):
            assert lib.dtt_chunk_spans(c, start, group, hd, 1, sms) == \
                ca.chunk_spans(c, start, group, hd, 1, sms)
        q = _rnd(dev, c, h, d, seed=84 + c)
        name = "chunk_int8" if int8 else "chunk"
        ca.reset_launch_counts()
        a = ca.chunk_prefill_attention(q, kp, vp, pages, start, page_size=ps,
                                       num_kv_heads=1)
        b = ca.chunk_prefill_attention(q, kp, vp, pages, start, page_size=ps,
                                       num_kv_heads=1)
        assert torch.equal(a, b)
        assert ca.VARIANT_LAUNCHES[f"{name}[head_dim=640]"] == 2
        for n in (1, 3, 8):
            other = ca.chunk_prefill_attention(q, kp, vp, pages, start,
                                               page_size=ps, num_kv_heads=1,
                                               spans=n)
            torch.testing.assert_close(other.float(), a.float(), **TOL)
    if sms == 132:  # an H100: two spans, 128 blocks in one wave
        assert ca.chunk_spans(256, 512, 16, d, 1, sms) == 2
    for n in range(1, ca.MAX_CHUNK_SPANS + 1):
        assert lib.dtt_chunk_max_clusters(n, int(int8)) >= 1



@pytest.mark.parametrize("s,lens", [(256, [256, 200, 37, 1]), (128, [100]),
                                    (256, [256])],
                         ids=["phase3", "served_128", "served_256"])
def test_latent_prefill_launches_give_equal_bits(dev, s, lens):
    """prefill.cu at head_dim 640 (16 heads on one KV head) at phase 3's
    shape and the served one-lane buckets: two launches give the same
    bits, K passed as the same tensor as V (as MLA's prefill passes its
    latent rows) gives the bits of a separate copy of V, every span count
    from 1 to 8 gives the plan's output within the tolerance and the
    plain version's,
    the library's span plan is the wrapper's, the clocks are stamped for
    every block, and a launch counts under prefill[head_dim=640]."""
    h, d, n = 16, 640, len(lens)
    q = _rnd(dev, n, s, h, d, seed=91)
    k = _rnd(dev, n, s, 1, d, seed=92)
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    lib = ca.build()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for nn, ss in ((n, s), (1, 48), (1, 1), (4, 256), (8, 1024), (2, 100)):
        for group, n_kv in ((16, 1), (4, 1), (7, 2)):
            assert lib.dtt_latent_prefill_spans(nn, ss, group, n_kv, sms) == \
                ca.latent_prefill_spans(nn, ss, group, n_kv, sms)
    ca.reset_launch_counts()
    a = ca.prefill_attention(q, k, k, sl)
    b = ca.prefill_attention(q, k, k, sl)
    assert torch.equal(a, b)
    assert ca.VARIANT_LAUNCHES["prefill[head_dim=640]"] == 2
    assert torch.equal(ca.prefill_attention(q, k, k.clone(), sl), a)
    ref = att.prefill_attention_ref(q, k, k, sl)
    torch.testing.assert_close(a.float(), ref.float(), **TOL)
    plan = ca.latent_prefill_spans(n, s, h, 1, sms)
    blocks = plan * n * -(-s // ca.tile_positions(h, d))
    clocks = torch.zeros((2 * blocks,), dtype=torch.int64, device=dev)
    assert torch.equal(ca.prefill_attention(q, k, k, sl, clocks=clocks), a)
    torch.cuda.synchronize()
    stamps = clocks.reshape(-1, 2)
    assert (stamps[:, 0] > 0).all() and (stamps[:, 1] >= stamps[:, 0]).all()
    for spans in range(1, ca.MAX_CHUNK_SPANS + 1):
        other = ca.prefill_attention(q, k, k, sl, spans=spans)
        torch.testing.assert_close(other.float(), a.float(), **TOL)
        torch.testing.assert_close(other.float(), ref.float(), **TOL)
    with pytest.raises(ValueError, match="spans"):
        ca.prefill_attention(q, k, k, sl, spans=ca.MAX_CHUNK_SPANS + 1)


def _latent_rows(dev, int8, decode_q, c, seed):
    """Phase 3's latent shapes (16 heads on one KV head, head_dim 640):
    pools, 8 decode rows at contexts 0, 1, 17, 100, 255, 600, 1024 and
    2048 on 128-page tables (verify windows ending there, the row at
    context 0 on the trash page), and with c > 0 a c-query chunk at 512
    whose pages are the table's last row -> (q, kp, vp, tables, kv_lens,
    q_starts, the decode rows' contexts)."""
    ps, d, h, pmax = 16, 640, 16, 128
    if int8:
        kp, vp = _int8_pools(dev, 512, ps, 1, d, seed=seed)
    else:
        kp, vp = _rnd(dev, 512, ps, d, seed=seed), _rnd(dev, 512, ps, d,
                                                          seed=seed + 1)
    ctx = [0, 1, 17, 100, 255, 600, 1024, 2048]
    perm = np.random.default_rng(seed).permutation(511) + 1
    tables = np.zeros((9, pmax), np.int32)
    used = 0
    for r, n in enumerate(ctx):
        tables[r, :-(-n // ps)] = perm[used:used + -(-n // ps)]
        used += -(-n // ps)
    tables[8, :-(-(512 + c) // ps)] = perm[:-(-(512 + c) // ps)]
    q_starts = [max(n - decode_q, 0) for n in ctx] + [512 if c else 0]
    kv_lens = [n and max(n, s + decode_q) for n, s in zip(ctx, q_starts)]
    kv_lens += [512 + c if c else 0]
    q = _rnd(dev, 8 * decode_q + c, h, d, seed=seed + 2)
    args = [torch.tensor(a, dtype=torch.int32, device=dev)
            for a in (tables, kv_lens, q_starts)]
    return (q, kp, vp, *args, ctx)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("decode_q,c", [(1, 0), (1, 256), (5, 0), (5, 256)],
                         ids=["decode_rows", "mixed", "verify_only",
                              "verify_rows"])
def test_latent_decode_rows_at_the_phase3_shapes(dev, int8, decode_q, c):
    """The latent decode rows (decode_latent_kernel, merge_latent_kernel)
    at phase 3's shapes on both pools: ragged with decode_q 1 and 5, with
    and without a 256-token chunk at 512, against its plain version; two
    launches give equal bits; its decode rows equal decode.cu's at
    decode_q = 1 (the same blocks under the same plan: 16 spans of at most
    128 keys on the H100), and its chunk rows equal chunk.cu's (the same
    cluster blocks at the same span count); decode.cu itself against its
    plain version; a row at context 0 gives exact zeros."""
    q, kp, vp, tables, kv_lens, q_starts, ctx = _latent_rows(
        dev, int8, decode_q, c, seed=91)
    kw = dict(page_size=16, num_kv_heads=1)
    rk = dict(kw, num_decode=8, decode_q=decode_q)
    name = "ragged_int8" if int8 else "ragged"
    ca.reset_launch_counts()
    out = ca.ragged_paged_attention(q, kp, vp, tables, kv_lens, q_starts,
                                    **rk)
    again = ca.ragged_paged_attention(q, kp, vp, tables, kv_lens, q_starts,
                                      **rk)
    ref = att.ragged_paged_attention_ref(q, kp, vp, tables, kv_lens,
                                         q_starts, **rk)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)
    assert torch.equal(out, again)
    assert not out[:decode_q].any()  # context 0: exact zeros
    assert ca.VARIANT_LAUNCHES[f"{name}[head_dim=640]"] == 2
    nd = 8 * decode_q
    if c:
        chunk = ca.chunk_prefill_attention(q[nd:], kp, vp, tables[8], 512,
                                           **kw)
        assert torch.equal(out[nd:], chunk)
    if decode_q == 1:
        cl = torch.tensor(ctx, dtype=torch.int32, device=dev)
        dec = ca.paged_attention_decode(q[:nd], kp, vp, tables[:8], cl, **kw)
        assert torch.equal(out[:nd], dec)
        ref = att.paged_attention_decode_ref(q[:nd], kp, vp, tables[:8], cl,
                                             **kw)
        torch.testing.assert_close(dec.float(), ref.float(), **TOL)
        assert torch.equal(dec, ca.paged_attention_decode(
            q[:nd], kp, vp, tables[:8], cl, **kw))


def test_latent_decode_plan_agrees_with_the_library_and_is_refused(dev):
    """The library's latent decode plan (dtt_latent_decode_spans) is the
    wrapper's (latent_decode_spans), and decode.cu and ragged.cu at head
    dim 640 refuse any other: another span count, or split keys; and a
    sliding window or a logit cap."""
    lib = ca.build()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for width, ps, nd, dq, group, n_kv in ((128, 16, 8, 1, 16, 1),
                                           (128, 16, 8, 5, 16, 1),
                                           (128, 16, 1, 1, 16, 1),
                                           (32, 16, 6, 1, 7, 2),
                                           (1, 16, 300, 5, 16, 1)):
        assert lib.dtt_latent_decode_spans(width, ps, nd, dq, group, n_kv,
                                           sms) == \
            ca.latent_decode_spans(width, ps, nd, dq, group, n_kv, sms)
    q = _rnd(dev, 8 + 16, 16, 640)
    kp = _rnd(dev, 8, 16, 640)
    tables = torch.ones((9, 128), dtype=torch.int32, device=dev)
    lens = torch.full((9,), 20, dtype=torch.int32, device=dev)
    out = torch.empty_like(q)
    n = ca.latent_decode_spans(128, 16, 8, 1, 16, 1, sms)
    part = torch.empty((n + 1) * 8 * 16 * 642, dtype=torch.float32,
                       device=dev)
    for n_splits, span in ((n + 1, 0), (n, 256)):
        args = [ca._ptr(q), ca._ptr(kp), ca._ptr(kp), ca._ptr(tables),
                ca._ptr(lens), ca._ptr(out), ca._ptr(part), ca._ptr(part), 8,
                16, 1, 640, 16, 128]
        assert lib.dtt_paged_decode(*args, n_splits, span, 0.1, 0, 0.0,
                                    ca._stream(q)) != 0
        rc = lib.dtt_ragged(
            ca._ptr(q), ca._ptr(kp), ca._ptr(kp), ca._ptr(tables),
            ca._ptr(lens), ca._ptr(lens), ca._ptr(out), ca._ptr(part),
            ca._ptr(part), 8, 1, 16, 16, 1, 640, 16, 128, 4, n_splits, span,
            0.1, 0, 0.0, ca._stream(q))
        assert rc != 0
    # the latent row takes no sliding window or logit cap, even under its
    # own plan, and no entry point takes a negative window
    for window, cap in ((8, 0.0), (0, 50.0), (-1, 0.0)):
        assert lib.dtt_paged_decode(*args, n, 0, 0.1, window, cap,
                                    ca._stream(q)) != 0


def test_latent_row_refuses_tiny_mla_pools(dev):
    """tiny-mla-debug's 40-lane latent rows are not a width the tile is
    built for: on a CUDA tensor the wrapper raises (its tests run the
    plain versions on the CPU)."""
    q = _rnd(dev, 2, 4, 40)
    kp = _rnd(dev, 8, 16, 40, seed=1)
    table = torch.ones((2, 1), dtype=torch.int32, device=dev)
    ctx = torch.tensor([3, 5], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="built for head_dim"):
        ca.paged_attention_decode(q, kp, kp, table, ctx, page_size=16)


def _latent_cfg():
    """A small MLA config with DeepSeek-V2's latent row (512 + 64 lanes,
    pools of 640) and YaRN, 16 heads, 2 layers, every layer MoE."""
    import dataclasses

    from dynamo_tpu_torch.models.config import PRESETS

    return dataclasses.replace(
        PRESETS["deepseek-v2-lite"], name="tiny-latent", vocab_size=512,
        hidden_size=256, intermediate_size=128, num_layers=2, num_experts=8,
        num_experts_per_tok=2, num_shared_experts=1)


def test_mla_graph_windows_equal_eager_windows(dev):
    """The MLA model at the latent row's width in 4-step graph windows
    against eager windows, bit for bit; its decode, prefill and chunk
    launches run at head_dim 640."""
    cfg = _latent_cfg()
    eager = _window_engine(True, model_cfg=cfg)
    assert eager.kv_spec.lane_width == 640
    graphs = _window_engine(False, params=eager.model, model_cfg=cfg)
    want = _window_run(eager)
    ca.reset_launch_counts()
    assert _window_run(graphs) == want
    assert graphs.windows.stats()["replays"] > 0
    for k in ("decode", "prefill", "chunk"):
        assert ca.VARIANT_LAUNCHES[f"{k}[head_dim=640]"] > 0, k


def test_capacity_prefill_is_bit_identical_across_runs(dev):
    """The MoE capacity path at DeepSeek-V2-Lite's expert widths (64
    experts of 1408, top 6, E = 2048) over a 1024-token prefill, twice:
    the ordered add-back gives the same bits (index_add_'s atomics added
    a token's experts in no fixed order)."""
    from dynamo_tpu_torch.models import quant
    from dynamo_tpu_torch.ops import moe

    t, x, e, f, k = 1024, 64, 2048, 1408, 6
    xs = _rnd(dev, t, e, seed=81)
    stacks = [quant.operand_layout(_rnd(dev, x, *shape, seed=82 + i)
                                   * shape[0] ** -0.5)
              for i, shape in enumerate(((e, f), (e, f), (f, e)))]
    logits = torch.randn((t, x), generator=torch.Generator(
        device=dev).manual_seed(85), device=dev)
    combine = moe.topk_combine(logits, k, torch.bfloat16, renormalize=False)
    cap = moe.expert_capacity(t, x, k, 1.25)
    a = moe.moe_mlp_dropping(xs, combine, *stacks, capacity=cap, k=k)
    b = moe.moe_mlp_dropping(xs, combine, *stacks, capacity=cap, k=k)
    assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["int8", "w8a8"])
def test_quantized_graph_windows_equal_eager_windows(dev, mode):
    """The quantized decode step (int8 GEMMs or dequantized weights, and
    their temporaries from the graphs' pool) replayed in 4-step windows
    gives the eager body's tokens and logprobs bit for bit."""
    from dynamo_tpu_torch.models import quant

    eager = _window_engine(True, quantization=mode)
    graphs = _window_engine(False, params=eager.model, quantization=mode)
    assert quant.mode_of(graphs.model) == mode
    want = _window_run(eager)
    got = _window_run(graphs)
    assert got == want
    st = graphs.windows.stats()
    assert not st["eager"] and st["replays"] > 0


def _spec_engine(enforce_eager, params=None, draft_params=None, **kw):
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import Engine

    return Engine(EngineConfig(model="tiny-debug", page_size=16,
                               num_pages=64, max_num_seqs=4, max_seq_len=512,
                               prefill_chunk_tokens=0,
                               enable_prefix_caching=False,
                               speculative_mode="ngram",
                               num_speculative_tokens=4,
                               enforce_eager=enforce_eager, **kw),
                  params=params, draft_params=draft_params)


def _spec_run(eng):
    """A repetitive greedy prompt, another greedy one and a seeded sampled
    one to the end: {rid: tokens}."""
    from dynamo_tpu_torch.engine.request import GenRequest

    reqs = [GenRequest("g", [5, 6, 7] * 4, max_tokens=20, ignore_eos=True),
            GenRequest("h", list(range(1, 9)), max_tokens=14,
                       ignore_eos=True),
            GenRequest("s", list(range(5, 45)), max_tokens=11,
                       temperature=0.8, top_p=0.9, seed=7, ignore_eos=True)]
    for r in reqs:
        eng.add_request(r)
    out = {}
    while eng.has_work:
        for ev in eng.step():
            if ev.token_id >= 0:
                out.setdefault(ev.request_id, []).append(ev.token_id)
    return out


def test_verify_graph_equals_eager_verify(dev):
    """The verify step replayed from its CUDA graph gives the eager
    step's tokens (the same kernels on the same shapes), one replay per
    verify step, and its ragged launches (C = 0, decode_q = 5) are
    counted: 2 layers x (replays + one warm-up pass per graph)."""
    eager = _spec_engine(True)
    graphs = _spec_engine(False, params=eager.model)
    want = _spec_run(eager)
    ca.reset_launch_counts()
    got = _spec_run(graphs)
    assert got == want
    st = graphs.verify.stats()
    assert not st["eager"] and st["graphs"] >= 1
    assert st["replays"] == st["steps"] == graphs.metrics.spec_verify_steps
    assert graphs.metrics.spec_accepted_tokens > 0
    layers = graphs.model_cfg.num_layers
    assert ca.VARIANT_LAUNCHES["ragged[decode_q=5,no_chunk]"] == \
        layers * (st["replays"] + st["graphs"]), ca.VARIANT_LAUNCHES


def test_draft_graph_equals_eager_draft(dev):
    """The model drafter's B=1 step replayed from its CUDA graph proposes
    what the eager step proposes, so the streams, the draft books and the
    acceptance are the same; a self-draft accepts nearly every greedy
    draft."""
    eager = _spec_engine(True, drafter="model", draft_model="tiny-debug")
    graphs = _spec_engine(False, params=eager.model,
                          draft_params=eager.draft.model,
                          drafter="model", draft_model="tiny-debug")
    graphs.warmup()
    assert graphs.draft.stats()["graph"]["captured"]
    want = _spec_run(eager)
    got = _spec_run(graphs)
    assert got == want
    keys = ("draft_steps", "catchup_tokens", "rollbacks", "evictions")
    assert {k: graphs.draft.stats()[k] for k in keys} == \
        {k: eager.draft.stats()[k] for k in keys}
    assert graphs.draft.replays == graphs.draft.steps > 0
    assert graphs.metrics.spec_accepted_tokens == \
        eager.metrics.spec_accepted_tokens
    selfd = _spec_engine(False, params=eager.model, draft_params=eager.model,
                         drafter="model", draft_model="tiny-debug")
    from dynamo_tpu_torch.engine.request import GenRequest

    selfd.generate(GenRequest("g", [5, 6, 7] * 4, max_tokens=20,
                              ignore_eos=True))
    m = selfd.metrics
    assert m.spec_accepted_tokens >= 0.5 * m.spec_draft_tokens > 0


# prefill.cu and chunk.cu below head_dim 640 (the pair tile at every
# head_dim, Phi-3's 96 included): a window inside a key tile, one across
# tiles with Gemma-2's cap, and none
PAIR_MODS = [(0, 0.0), (37, 0.0), (100, 50.0)]


@pytest.mark.parametrize("window,cap", PAIR_MODS,
                         ids=[f"w{w}-cap{int(c)}" for w, c in PAIR_MODS])
@pytest.mark.parametrize("head_dim", [32, 64, 96, 128, 256])
@pytest.mark.parametrize("kernel", ["prefill", "chunk", "chunk_int8"])
def test_pair_tile_at_every_head_dim(dev, kernel, head_dim, window, cap):
    """prefill.cu and chunk.cu (bf16 and int8 pools) at every head_dim
    below 640 (the pair tile), groups 1 and 4, with and
    without a window and the cap (q scaled by 4 so that the cap bends),
    against their plain versions: two prefill lanes of 200 positions (one
    at 130: padding rows past seq_len), a 100-token chunk at 300. The
    pair kernels' SASS runs S and P V on wgmma: chip_smoke.py's build
    phase holds that."""
    ps = 16
    mods = dict(window=window, logit_cap=cap)
    for group, n_kv in ((1, 4), (4, 2)):
        h = group * n_kv
        if kernel == "prefill":
            q = (_rnd(dev, 2, 200, h, head_dim, seed=130).float()
                 * 4.0).bfloat16()
            k = _rnd(dev, 2, 200, n_kv, head_dim, seed=131)
            v = _rnd(dev, 2, 200, n_kv, head_dim, seed=132)
            sl = torch.tensor([200, 130], dtype=torch.int32, device=dev)
            out = ca.prefill_attention(q, k, v, sl, **mods)
            ref = att.prefill_attention_ref(q, k, v, sl, **mods)
        else:
            if kernel == "chunk_int8":
                kp, vp = _int8_pools(dev, 40, ps, n_kv, head_dim, seed=133)
            else:
                kp = _rnd(dev, 40, ps, n_kv * head_dim, seed=133)
                vp = _rnd(dev, 40, ps, n_kv * head_dim, seed=134)
            pages = _page_list(dev, 400, ps, 40, seed=135)
            q = (_rnd(dev, 100, h, head_dim, seed=136).float()
                 * 4.0).bfloat16()
            kw = dict(page_size=ps, num_kv_heads=n_kv, **mods)
            out = ca.chunk_prefill_attention(q, kp, vp, pages, 300, **kw)
            ref = att.chunk_attention_ref(q, kp, vp, pages, 300, **kw)
        torch.testing.assert_close(out.float(), ref.float(), **TOL)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("label,h,n_kv,d,window,cap,start", [
    ("group1", 32, 32, 64, 2047, 0.0, 3008),
    ("phi3", 32, 32, 96, 2047, 0.0, 3008),
    ("gemma2", 16, 8, 256, 4096, 50.0, 4864),
    ("llama8b", 32, 8, 128, 0, 0.0, 512)])
def test_pair_tile_launches_give_equal_bits(dev, int8, label, h, n_kv, d,
                                            window, cap, start):
    """The pair tile at served chunk shapes (a 256-token chunk, one span
    a pair) and a prefill of two lanes: two launches give the same bits,
    every span count a measurement may ask for gives the plan's output
    within the tolerance (the spans merge in a fixed order: equal bits run
    to run), the library's plans (spans, query tiles a block) are the
    wrapper's, the clocks are stamped for every block, and a launch counts
    under its head_dim."""
    ps, c = 16, 256
    group = h // n_kv
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = ca.build()
    positions = ca.tile_positions(group, d)
    pool_pages = (start + c) // ps + 8
    if int8:
        kp, vp = _int8_pools(dev, pool_pages, ps, n_kv, d, seed=140)
    else:
        kp = _rnd(dev, pool_pages, ps, n_kv * d, seed=140)
        vp = _rnd(dev, pool_pages, ps, n_kv * d, seed=141)
    pages = _page_list(dev, start + c, ps, pool_pages, seed=142)
    q = _rnd(dev, c, h, d, seed=143)
    kw = dict(page_size=ps, num_kv_heads=n_kv, window=window, logit_cap=cap)
    name = "chunk_int8" if int8 else "chunk"
    plan = ca.chunk_spans(c, start, group, d, n_kv, sms)
    assert lib.dtt_chunk_spans(c, start, group, d, n_kv, sms) == plan == 1
    ca.reset_launch_counts()
    a = ca.chunk_prefill_attention(q, kp, vp, pages, start, **kw)
    b = ca.chunk_prefill_attention(q, kp, vp, pages, start, **kw)
    assert torch.equal(a, b)
    assert ca.VARIANT_LAUNCHES[f"{name}[head_dim={d}]"] == 2
    ref = att.chunk_attention_ref(q, kp, vp, pages, start, **kw)
    torch.testing.assert_close(a.float(), ref.float(), **TOL)
    most = ca.pair_max_spans(start + c, window, positions, d)
    for n in sorted({1, 2, 3, 4, 8, most}):
        if n > most:
            continue
        other = ca.chunk_prefill_attention(q, kp, vp, pages, start,
                                           spans=n, **kw)
        assert torch.equal(other, ca.chunk_prefill_attention(
            q, kp, vp, pages, start, spans=n, **kw))
        torch.testing.assert_close(other.float(), a.float(), **TOL)
    with pytest.raises(ValueError, match="spans"):
        ca.chunk_prefill_attention(q, kp, vp, pages, start, spans=most + 1,
                                   **kw)
    # the library's plan of query tiles a block is the wrapper's
    for pair_blocks in (1, sms // 2, sms // 2 + 1, sms, 4096):
        assert (lib.dtt_pair_query_tiles(pair_blocks, sms)
                == ca.pair_query_tiles(pair_blocks, sms))
    blocks = plan * ca.pair_blocks(c, positions, n_kv, sms)
    clocks = torch.zeros((2 * blocks,), dtype=torch.int64, device=dev)
    assert torch.equal(ca.chunk_prefill_attention(q, kp, vp, pages, start,
                                                  clocks=clocks, **kw), a)
    torch.cuda.synchronize()
    stamps = clocks.reshape(-1, 2)
    assert (stamps[:, 0] > 0).all() and (stamps[:, 1] >= stamps[:, 0]).all()
    if int8:
        return
    # prefill: two lanes of 512 positions, one at 300
    s = 512
    qp = _rnd(dev, 2, s, h, d, seed=144)
    k = _rnd(dev, 2, s, n_kv, d, seed=145)
    v = _rnd(dev, 2, s, n_kv, d, seed=146)
    sl = torch.tensor([s, 300], dtype=torch.int32, device=dev)
    mods = dict(window=window, logit_cap=cap)
    pa_ = ca.prefill_attention(qp, k, v, sl, **mods)
    assert torch.equal(ca.prefill_attention(qp, k, v, sl, **mods), pa_)
    pref = att.prefill_attention_ref(qp, k, v, sl, **mods)
    torch.testing.assert_close(pa_.float(), pref.float(), **TOL)
    for n in (1, 2, 4):
        if n <= ca.pair_max_spans(s, window, positions, d):
            other = ca.prefill_attention(qp, k, v, sl, spans=n, **mods)
            torch.testing.assert_close(other.float(), pref.float(), **TOL)


@pytest.mark.parametrize("label,h,n_kv,d,window,cap", [
    ("group1", 32, 32, 64, 2047, 0.0),
    ("phi3", 32, 32, 96, 2047, 0.0),
    ("gemma2", 16, 8, 256, 4096, 50.0),
    ("gemma3", 4, 1, 256, 512, 0.0),
    ("llama8b", 32, 8, 128, 0, 0.0)])
def test_pair_tile_rows_equal_whole_chunked_and_mixed(dev, label, h, n_kv, d,
                                                      window, cap):
    """A 600-token prompt's rows take the same bits whole (prefill.cu), in
    chunks of 256 and of 88 (chunk.cu at aligned and unaligned starts) and
    as a mixed step's chunk rows (ragged.cu, which launches chunk.cu's
    kernel with the start read on the card): a chunk at start 0 in a table
    far wider than it, and one at 264 beside a decode row. Every launch
    takes one span a pair, so a row walks its own key tiles in key order
    in each, whether its launch holds two query tiles a block or one
    (pair_query_tiles: the short launches here take one)."""
    ps, s = 16, 600
    q = _rnd(dev, 1, s, h, d, seed=150)
    k = _rnd(dev, 1, s, n_kv, d, seed=151)
    v = _rnd(dev, 1, s, n_kv, d, seed=152)
    mods = dict(window=window, logit_cap=cap)
    sl = torch.tensor([s], dtype=torch.int32, device=dev)
    whole = ca.prefill_attention(q, k, v, sl, **mods)[0]
    n_pages, spare = -(-s // ps), 64
    pk = torch.zeros((n_pages + 1, ps, n_kv, d), dtype=torch.bfloat16,
                     device=dev)
    pv = torch.zeros_like(pk)
    pk.view(-1, n_kv, d)[ps:ps + s] = k[0]
    pv.view(-1, n_kv, d)[ps:ps + s] = v[0]
    pk, pv = pk.reshape(n_pages + 1, ps, -1), pv.reshape(n_pages + 1, ps, -1)
    pages = torch.zeros((n_pages + spare,), dtype=torch.int32, device=dev)
    pages[:n_pages] = torch.arange(1, n_pages + 1, dtype=torch.int32,
                                   device=dev)
    kw = dict(page_size=ps, num_kv_heads=n_kv, **mods)
    for size in (256, 88):
        for start in range(0, s, size):
            c = min(size, s - start)
            out = ca.chunk_prefill_attention(q[0, start:start + c], pk, pv,
                                             pages, start, **kw)
            assert torch.equal(out, whole[start:start + c]), (size, start)
    tables = torch.stack([pages, pages])
    for start, c in ((0, 256), (264, 88)):
        qr = torch.cat([q[0, 99:100], q[0, start:start + c]])
        kv_lens = torch.tensor([100, start + c], dtype=torch.int32,
                               device=dev)
        q_starts = torch.tensor([99, start], dtype=torch.int32, device=dev)
        out = ca.ragged_paged_attention(qr, pk, pv, tables, kv_lens,
                                        q_starts, num_decode=1, **kw)
        assert torch.equal(out[1:], whole[start:start + c]), start


# ------------------------------------------------ the worker's lifecycle --

def _greedy_tokens(eng, rid, prompt=(3, 1, 4, 1, 5, 9, 2, 6), n=24):
    from dynamo_tpu_torch.engine.request import GenRequest

    return eng.generate(GenRequest(rid, list(prompt), max_tokens=n,
                                   ignore_eos=True))


def test_flip_and_rollback_keep_captured_windows_on_the_active_version(dev):
    """After a flip the CUDA graphs captured on v1 replay v2's weights (the
    swap writes the live storage): a window gives a fresh v2 engine's
    tokens, with no new capture; after a rollback, v1's again."""
    eng = _window_engine(False)
    eng.warmup()
    v1 = _greedy_tokens(eng, "v1")
    v2_ref = _greedy_tokens(_window_engine(False, seed=123), "v2ref")
    assert v1 != v2_ref
    graphs = eng.windows.stats()["graphs"]
    eng.weights.stage("v2", seed=123)
    eng.weights.flip()
    replays = eng.windows.stats()["replays"]
    ca.reset_launch_counts()
    assert _greedy_tokens(eng, "v2") == v2_ref
    assert ca.LAUNCHES["decode"] > 0
    assert eng.windows.stats()["replays"] > replays
    eng.weights.rollback()
    assert _greedy_tokens(eng, "v1b") == v1
    assert eng.windows.stats()["graphs"] == graphs


def test_resurrection_keeps_the_graphs_replaying(dev):
    """resurrect() zeroes the pools and batch buffers in place and
    restages the weights into their own storage: the graphs captured
    before replay after it and give the pre-trip tokens."""
    eng = _window_engine(False)
    eng.warmup()
    ref = _greedy_tokens(eng, "pre")
    graphs = eng.windows.stats()["graphs"]
    eng.resurrect()
    replays = eng.windows.stats()["replays"]
    ca.reset_launch_counts()
    assert _greedy_tokens(eng, "post") == ref
    assert ca.LAUNCHES["decode"] > 0
    assert eng.windows.stats()["replays"] > replays
    assert eng.windows.stats()["graphs"] == graphs


def test_device_hang_trips_the_watchdog_while_ready_answers(dev):
    """engine.device_hang queues a 2 s spin on the engine's stream: the
    scheduler blocks in the readback with the exec lock held, the monitor
    trips at the 0.5 s deadline, /ready answers 503 and /live 200 within
    100 ms meanwhile, and the engine resurrects and serves the pre-trip
    tokens on graph replays."""
    import json
    import threading
    import time
    import urllib.error
    import urllib.request

    from dynamo_tpu_torch.robustness import faults
    from dynamo_tpu_torch.serving import api

    eng = _window_engine(False)
    eng.warmup()
    ref = _greedy_tokens(eng, "pre")
    ctx = api.ServingContext(eng, "tiny-debug")
    srv = api.make_server(ctx, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"

    def get(path):
        t0 = time.monotonic()
        try:
            with urllib.request.urlopen(url + path, timeout=5) as r:
                code = r.status
        except urllib.error.HTTPError as e:
            code = e.code
        return code, time.monotonic() - t0

    plane = faults.reset_plane()
    try:
        eng.watchdog._deadline_override = 0.5
        plane.configure({"engine.device_hang": {"times": 1,
                                                "delay_s": 2.0}})
        # greedy: its graph was captured by warmup (a lazy capture is
        # exempt, and would hide the hang: the capture synchronizes)
        body = json.dumps({"model": "tiny-debug", "prompt": "hang",
                           "max_tokens": 16, "temperature": 0,
                           "ignore_eos": True}).encode()
        t = threading.Thread(target=lambda: urllib.request.urlopen(
            urllib.request.Request(url + "/v1/completions", data=body),
            timeout=60).read(), daemon=True)
        t.start()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and eng.watchdog.health == \
                "healthy":
            time.sleep(0.01)
        assert eng.watchdog.health in ("suspect", "resurrecting")
        ready, live = get("/ready"), get("/live")
        assert ready[0] == 503 and ready[1] < 0.1, ready
        assert live[0] == 200 and live[1] < 0.1, live
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and eng.watchdog.health != \
                "healthy":
            time.sleep(0.05)
        assert eng.watchdog.health == "healthy"
        assert get("/ready")[0] == 200
        t.join(timeout=30)
        # the worker's scheduler thread steps the engine whenever it has
        # work: stop it before this thread drives the engine, or it takes
        # some of the steps and their tokens
        srv.shutdown()
        ctx.close()
        ca.reset_launch_counts()
        assert _greedy_tokens(eng, "post") == ref
        assert ca.LAUNCHES["decode"] > 0
    finally:
        plane.clear()
        eng.watchdog._deadline_override = None
        srv.shutdown()
        ctx.close()


def test_slow_build_first_capture_and_profiler_do_not_trip(dev,
                                                           monkeypatch):
    """Under an armed derived deadline of 0.3 s (the floor lowered from
    2 s, the process warmed by an eager engine so that no cold cuBLAS or
    allocator set-up counts): a kernel-library build taking 1 s, the lazy
    capture of a graph key inside a dispatch seam (made 0.6 s longer
    inside the capture), and decode windows under an open torch.profiler
    session trip nothing."""
    import contextlib
    import time

    from torch.profiler import ProfilerActivity, profile

    from dynamo_tpu_torch.engine import decode_graphs

    _greedy_tokens(_window_engine(True), "warm")
    eng = _window_engine(False)
    eng.watchdog.floor_s = 0.3
    eng.watchdog.margin = 1.0
    real_build, real_capturing = ca.build, decode_graphs.capturing

    def slow_build():  # the wrappers call build() at every launch
        if ca._lib is None:
            time.sleep(1.0)
        return real_build()

    @contextlib.contextmanager
    def slow_capturing(*a, **k):
        time.sleep(0.6)
        with real_capturing(*a, **k) as launches:
            yield launches

    real_build()
    monkeypatch.setattr(ca, "_lib", None)
    monkeypatch.setattr(ca, "build", slow_build)
    monkeypatch.setattr(decode_graphs, "capturing", slow_capturing)
    assert not eng.windows.graphs
    _greedy_tokens(eng, "first")  # the build, then a lazy capture
    assert eng.windows.graphs
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        _greedy_tokens(eng, "profiled")
    assert eng.watchdog.summary()["trips_total"] == {}
    assert eng.watchdog.health == "healthy"


def test_a_sticky_cuda_error_quarantines_without_resurrection(dev):
    """In a child process: a device-side assert during a step poisons the
    CUDA context; the fatal-step path probes it once and quarantines the
    engine without a resurrection attempt, and the streams end."""
    import json
    import os
    import subprocess
    import sys

    script = r'''
import json, torch
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import Engine
from dynamo_tpu_torch.engine.request import GenRequest
from dynamo_tpu_torch.serving.engine_service import EngineService
eng = Engine(EngineConfig(model="tiny-debug", page_size=16, num_pages=64,
                          max_num_seqs=4, max_seq_len=512,
                          enable_prefix_caching=False))
calls = []
eng.resurrect = lambda: calls.append(1)
real = eng._step_locked
def poisoned():
    if eng.seqs:
        x = torch.zeros(4, device="cuda")
        x[torch.tensor([40], device="cuda")] += 1
        torch.cuda.synchronize()
    return real()
eng._step_locked = poisoned
svc = EngineService(eng)
req = GenRequest("p", [1, 2, 3], max_tokens=50, ignore_eos=True)
last = list(svc.drain(req, svc.submit(req), timeout=60))[-1]
print(json.dumps({"health": eng.watchdog.health, "resurrect": len(calls),
                  "last": last.finish_reason,
                  "sticky": eng.watchdog.summary()["last_trip"].get("sticky")}))
'''
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", script], cwd=root,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=root))
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert lines, out.stderr[-3000:]
    got = json.loads(lines[-1])
    assert got == {"health": "quarantined", "resurrect": 0,
                   "last": "abort", "sticky": True}, got


# ------------------------------------------------- the KVBM host tier --

def _kvbm_engine(**kw):
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import Engine

    return Engine(EngineConfig(**{
        **dict(model="tiny-debug", page_size=16, num_pages=64,
               max_num_seqs=4, max_seq_len=512, prefill_chunk_tokens=32,
               kvbm_host_blocks=16, kvbm_gate="always"), **kw}))


def _cache_prompt(eng, n_tokens=49, seed=5):
    """Run a greedy prompt so that its full pages sit in the prefix
    cache; returns the prompt."""
    from dynamo_tpu_torch.engine.request import GenRequest

    prompt = np.random.default_rng(seed).integers(1, 500, n_tokens).tolist()
    eng.generate(GenRequest("warm", prompt, max_tokens=2, ignore_eos=True))
    return prompt


def test_kvbm_arenas_are_pinned(dev):
    """An engine on the card keeps its host tier in page-locked memory."""
    eng = _kvbm_engine()
    pool = eng.kvbm.pool
    assert pool.pinned
    assert pool.k_arena.is_pinned() and pool.v_arena.is_pinned()
    assert pool.k_arena.shape == (16, eng.kv_spec.num_layers, 16,
                                  eng.kv_spec.lane_width)


def test_demoted_page_keeps_its_bytes_when_rewritten_at_once(dev):
    """The demote's gather is queued behind a long device spin and the
    freed pages are overwritten by the very next launch: the host tier
    still reads back each page's old bytes (the gather is ordered on the
    compute stream, the arena copies on the copy stream after it)."""
    eng = _kvbm_engine()
    _cache_prompt(eng)
    pc = eng.prefix_cache
    victims = list(pc._map.items())
    assert len(victims) == 3
    before = {h: (eng.k_pages[:, p].clone(), eng.v_pages[:, p].clone())
              for h, p in victims}
    torch.cuda._sleep(200_000_000)  # ~0.1 s of device spin
    assert pc.evict(len(victims)) == len(victims)
    for _, p in victims:
        eng.k_pages[:, p].fill_(7)
        eng.v_pages[:, p].fill_(-7)
    for h, (k, v) in before.items():
        got = eng.kvbm.pool.get(h)
        assert got is not None
        assert torch.equal(got[0], k.cpu()) and torch.equal(got[1], v.cpu())
    assert eng.kvbm.stats()["demoted_blocks_total"] == len(victims)


@pytest.mark.parametrize("int8", [False, True])
def test_onboarded_pages_give_the_chunk_the_same_bits(dev, int8):
    """chunk.cu over a cached prefix's pages, then over the pages the
    KVBM onboarded after demoting them: equal bit for bit (int8 rows move
    whole, scales included)."""
    eng = _kvbm_engine(kv_cache_dtype="int8" if int8 else "auto")
    prompt = _cache_prompt(eng)
    pc, ps = eng.prefix_cache, eng.cfg.page_size
    kv, d = eng.kv_spec.num_kv_heads, eng.kv_spec.head_dim
    own = eng.allocator.alloc(1)[0]  # the chunk's own page, never cached
    eng.k_pages[:, own] = eng.k_pages[:, 1]
    eng.v_pages[:, own] = eng.v_pages[:, 1]
    q = _rnd(dev, ps, eng.model_cfg.num_heads, d, seed=9)
    n_cached = len(pc._map)

    def chunk(pages):
        table = torch.tensor(pages + [own] + [0] * 4, dtype=torch.int32,
                             device=dev)
        return torch.stack([ca.chunk_prefill_attention(
            q, eng.k_pages[l], eng.v_pages[l], table, n_cached * ps,
            page_size=ps, num_kv_heads=kv)
            for l in range(eng.kv_spec.num_layers)])

    cached, _ = pc.lookup(prompt)
    assert len(cached) == n_cached == 3
    ref = chunk(cached)
    eng.allocator.free(cached)
    assert pc.evict(n_cached) == n_cached
    for p in cached:  # the freed pages, overwritten
        eng.k_pages[:, p].zero_()
        eng.v_pages[:, p].zero_()
    onboarded, n = pc.lookup(prompt)
    assert n == n_cached * ps
    assert eng.kvbm.stats()["onboarded_blocks_total"] == n_cached
    assert torch.equal(chunk(onboarded), ref)


# ---------------------------------------------------- disaggregation --

def _disagg_engine(mode="agg", params=None, **kw):
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import Engine

    return Engine(EngineConfig(**{
        **dict(model="tiny-debug", page_size=16, num_pages=64,
               max_num_seqs=4, max_seq_len=512, enable_prefix_caching=False,
               prefill_chunk_tokens=0, num_scheduler_steps=4,
               async_scheduling=False, disaggregation_mode=mode), **kw}),
        params=params)


@pytest.mark.parametrize("kv_cache_dtype", ["auto", "int8"])
def test_cuda_ipc_pull_across_processes_equals_the_gather(dev,
                                                          kv_cache_dtype):
    """A parked request's KV staged over CUDA IPC (`DeviceKVSource`) and
    opened in a child process (`DeviceKVClient.pull`) holds the parent's
    gather byte for byte (the child hashes what it mapped)."""
    import hashlib
    import json
    import os
    import subprocess
    import sys

    from dynamo_tpu_torch.engine.request import GenRequest
    from dynamo_tpu_torch.transfer.kv_transfer import DeviceKVSource

    script = r'''
import hashlib, json, sys
import torch
from dynamo_tpu_torch.transfer.kv_transfer import DeviceKVClient
staged = json.loads(sys.stdin.read())
k, v = DeviceKVClient(torch.device("cuda")).pull(staged)
torch.cuda.synchronize()
print(json.dumps({n: hashlib.sha256(t.contiguous().view(torch.uint8)
                                    .cpu().numpy().tobytes()).hexdigest()
                  for n, t in (("k", k), ("v", v))}))
'''
    eng = _disagg_engine("prefill", kv_cache_dtype=kv_cache_dtype)
    prompt = np.random.default_rng(3).integers(1, 500, 70).tolist()
    eng.prefill_only(GenRequest("ipc", prompt, max_tokens=4))
    src = DeviceKVSource(eng)
    assert src.eligible and src.eligible_for(src.uuid)
    staged = src.stage("ipc")
    assert staged["kv_shape"][1] == 5  # 70 tokens on 16-token pages
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", script], cwd=root,
                         input=json.dumps(staged), capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=root))
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert lines, out.stderr[-3000:]
    k, v, _ = eng.export_kv_device("ipc")
    want = {n: hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                              .tobytes()).hexdigest()
            for n, t in (("k", k), ("v", v))}
    assert json.loads(lines[-1]) == want
    src.mark_released("ipc")
    eng.release_parked("ipc")
    assert src.counts() == (0, 0)
    assert eng.allocator.free_pages == eng.cfg.num_pages - 1


def test_import_into_captured_windows_gives_the_aggregated_tokens(dev):
    """A decode role whose greedy graphs were captured before any import:
    the imported pages, scattered into its pools in place, are what the
    replayed windows read, so its streams equal an aggregated graph
    engine's token for token, with no new capture and the pools where
    they were."""
    from dynamo_tpu_torch.engine.request import GenRequest
    from dynamo_tpu_torch.transfer.kv_transfer import ICIHandoff

    agg = _disagg_engine()
    pre = _disagg_engine("prefill", params=agg.model)
    dec = _disagg_engine("decode", params=agg.model)
    for e in (pre, dec, agg):
        e.warmup()
    pools = (dec.k_pages.data_ptr(), dec.v_pages.data_ptr())
    graphs = dec.windows.stats()["graphs"]
    rng = np.random.default_rng(11)
    for i, n in enumerate((5, 40, 130)):
        prompt = rng.integers(1, 500, n).tolist()
        kw = dict(max_tokens=17, ignore_eos=True)
        want = agg.generate(GenRequest(f"a{i}", prompt, **kw))
        req = GenRequest(f"d{i}", prompt, **kw)
        first = pre.prefill_only(req)[0]
        ICIHandoff(pre, dec).transfer(req, first)
        got = [first]
        while dec.has_work:
            got += [ev.token_id for ev in dec.step() if ev.token_id >= 0]
        assert got == want, i
    st = dec.windows.stats()
    assert st["graphs"] == graphs == 4 and st["replays"] > 0
    assert (dec.k_pages.data_ptr(), dec.v_pages.data_ptr()) == pools
    assert pre.allocator.free_pages == pre.cfg.num_pages - 1
