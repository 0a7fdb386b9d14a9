"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU with nvcc (the kernels build for sm_90a) and skip
without one; run them there with

    python -m pytest tests/test_torch_cuda.py -q

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


@pytest.mark.parametrize("start,c", [(0, 256), (512, 256), (48, 16)])
def test_chunk_kernel_matches_plain(dev, start, c):
    ps, n_kv, d = 16, 8, 128
    kp = _rnd(dev, 128, ps, n_kv * d, seed=7)
    vp = _rnd(dev, 128, ps, n_kv * d, seed=8)
    width = (start + c) // ps + 15
    pages = torch.zeros((width,), dtype=torch.int32, device=dev)
    real = (start + c) // ps
    pages[:real] = torch.arange(1, real + 1, dtype=torch.int32, device=dev)
    q = _rnd(dev, c, 32, d, seed=9)
    out = ca.chunk_prefill_attention(q, kp, vp, pages, start, page_size=ps)
    ref = att.chunk_attention_ref(q, kp, vp, pages, start, page_size=ps)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)


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
    # a GQA group past the block's accumulators: the wrapper refuses it with
    # the library's own limit, and so does the library's entry point
    lib = ca.build()
    wide_q = _rnd(dev, 1, 2 * lib.dtt_max_rows_times_dim() // 64, 64)
    kp1 = _rnd(dev, 4, 16, 64)
    with pytest.raises(ValueError, match="accumulators"):
        ca.paged_attention_decode(wide_q, kp1, kp1, table[:1], ctx[:1],
                                  page_size=16)
    out = torch.empty_like(wide_q)
    rc = lib.dtt_paged_decode(
        ca._ptr(wide_q), ca._ptr(kp1), ca._ptr(kp1), ca._ptr(table[:1]),
        ca._ptr(ctx[:1]), ca._ptr(out), 1, wide_q.shape[1], 1, 64, 16, 2,
        0.125, ca._stream(wide_q))
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
                                                   (4, 2, 16)])
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


@pytest.mark.parametrize("start,c", [(0, 256), (512, 256), (48, 16)])
def test_int8_chunk_kernel_matches_plain(dev, start, c):
    ps, n_kv, d = 16, 8, 128
    kp, vp = _int8_pools(dev, 128, ps, n_kv, d, seed=13)
    width = (start + c) // ps + 15
    pages = torch.zeros((width,), dtype=torch.int32, device=dev)
    real = (start + c) // ps
    pages[:real] = torch.arange(1, real + 1, dtype=torch.int32, device=dev)
    q = _rnd(dev, c, 32, d, seed=9)
    out = ca.chunk_prefill_attention(q, kp, vp, pages, start, page_size=ps,
                                     num_kv_heads=n_kv)
    ref = att.chunk_attention_ref(q, kp, vp, pages, start, page_size=ps,
                                  num_kv_heads=n_kv)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)


@pytest.mark.parametrize("decode_q", [1, 4])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_ragged_kernel_matches_plain(dev, int8, decode_q):
    """Eight decode rows (an inactive one on the trash page at context 1,
    contexts up to a full table) and a 256-token chunk at position 512 on a
    trash-padded list, in one launch; with int8 pools too."""
    ps, n_kv, d, h, pmax = 16, 8, 128, 32, 64
    if int8:
        kp, vp = _int8_pools(dev, 256, ps, n_kv, d, seed=21)
    else:
        kp = _rnd(dev, 256, ps, n_kv * d, seed=21)
        vp = _rnd(dev, 256, ps, n_kv * d, seed=22)
    ctx = [1, 4, 17, 100, 255, 300, 700, pmax * ps]
    rng = np.random.default_rng(5)
    tables = np.zeros((9, pmax), np.int32)
    for r, n in enumerate(ctx[1:], start=1):
        tables[r, :-(-n // ps)] = rng.permutation(255)[:-(-n // ps)] + 1
    tables[8, :48] = np.arange(1, 49)  # the chunk's pages, trash tail
    kv_lens = np.array(ctx + [512 + 256], np.int32)
    q_starts = np.array([max(n - decode_q, 0) for n in ctx] + [512],
                        np.int32)
    kv_lens[:8] = np.maximum(kv_lens[:8], q_starts[:8] + decode_q)
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
    with pytest.raises(ValueError, match="chunk"):
        ca.ragged_paged_attention(q[:8 * decode_q], kp, vp, *args,
                                  page_size=ps, num_kv_heads=n_kv,
                                  num_decode=8, decode_q=decode_q)


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
