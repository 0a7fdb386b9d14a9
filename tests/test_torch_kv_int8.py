"""The port's int8 KV pools against the JAX package's.

The packed rows ([KV*D int8 values | KV bf16 scales | zero pad], padded to
128 lanes) must be byte-identical to `dynamo_tpu.ops.attention.pack_kv_rows`
and the pools byte-identical after the KV writes, trash page included. The
plain decode and chunk attention over int8 pools are held against the Pallas
kernels in interpret mode at rtol=atol=2e-5 (float32; both dequantize
value * scale in f32, which is exact). The engine with
`kv_cache_dtype="int8"` must give the JAX engine's greedy streams.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.engine import Engine as JEngine
from dynamo_tpu.engine.request import GenRequest as JGenRequest
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import PRESETS as JPRESETS
from dynamo_tpu.ops import attention as jatt
from dynamo_tpu.ops import pallas_attention as pa
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import Engine
from dynamo_tpu_torch.engine.kv_cache import KVCacheSpec
from dynamo_tpu_torch.engine.request import GenRequest
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.ops import attention as att

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module: the parallel test workers share
    the cores, and torch's default pool in each of them oversubscribes
    them (the suite's tiny eager ops are as fast on one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


def _values(seed, t, kv, d):
    """Random K/V values with a zero head (scale 1) and a wide one."""
    x = np.random.default_rng(seed).normal(size=(t, kv, d)).astype(np.float32)
    x[0, 0] = 0.0
    x[1, -1] *= 1000.0
    return x


def _int8_pool(x, n_pages, ps):
    """[n_pages*ps, KV, D] values -> a [n_pages, ps, W] int8 pool packed by
    the JAX package (numpy)."""
    _, kv, d = x.shape
    w = jatt.kv_lane_width(kv, d, True)
    return np.asarray(jatt.pack_kv_rows(jnp.asarray(x), w)).reshape(
        n_pages, ps, w)


@pytest.mark.parametrize("kv,d", [(8, 128), (2, 32), (2, 16), (4, 64),
                                  (1, 128), (3, 48)])
def test_lane_width_matches(kv, d):
    for quantized in (False, True):
        assert (att.kv_lane_width(kv, d, quantized)
                == jatt.kv_lane_width(kv, d, quantized))


def test_lane_width_of_llama_8b():
    cfg = ModelConfig.from_model_name("llama-3.1-8b-instruct")
    spec = KVCacheSpec.from_model(cfg, 8, 16, "int8")
    assert spec.lane_width == 1152 and spec.quantized
    bf16 = KVCacheSpec.from_model(cfg, 8, 16)
    assert bf16.lane_width == 1024 and spec.pool_bytes < bf16.pool_bytes


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv,d", [(2, 32), (8, 128), (3, 16)])
def test_pack_bytes_identical_to_jax(dtype, kv, d):
    x = _values(0, 12, kv, d)
    w = att.kv_lane_width(kv, d, True)
    ref = jatt.pack_kv_rows(jnp.asarray(x).astype(dtype), w)
    out = att.pack_kv_rows(_t(x).to(getattr(torch, dtype)), w)
    assert out.dtype == torch.int8 and out.shape == (12, w)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("kv,d", [(2, 32), (8, 128)])
def test_unpack_identical_to_jax(kv, d):
    x = _values(1, 9, kv, d)
    w = att.kv_lane_width(kv, d, True)
    rows = np.asarray(jatt.pack_kv_rows(jnp.asarray(x), w))
    ref = jatt.unpack_kv_rows(jnp.asarray(rows), kv, d, jnp.float32)
    out = att.unpack_kv_rows(_t(rows), kv, d)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    # round trip: within one quantization step of each head's amax
    bound = np.abs(x).max(axis=2, keepdims=True) / 127.0 + 1e-6
    assert (np.abs(out.numpy() - x) <= bound).all()
    # repacking the dequantized values gives the same bytes
    np.testing.assert_array_equal(att.pack_kv_rows(out, w).numpy(), rows)


def test_write_kv_token_int8_pools_identical_including_trash_page():
    ps, kv, d, npages = 4, 2, 32, 6
    w = att.kv_lane_width(kv, d, True)
    kp = _int8_pool(_values(2, npages * ps, kv, d), npages, ps)
    vp = _int8_pool(_values(3, npages * ps, kv, d), npages, ps)
    k_new, v_new = _values(4, 3, kv, d), _values(5, 3, kv, d)
    bt = np.array([[1, 2, 0], [3, 4, 5], [0, 0, 0]], np.int32)
    pos = np.array([5, 9, 0], np.int32)  # slot 2 inactive -> trash page 0
    jk, jv = jatt.write_kv_token(jnp.asarray(kp), jnp.asarray(vp),
                                 jnp.asarray(k_new), jnp.asarray(v_new),
                                 jnp.asarray(bt), jnp.asarray(pos),
                                 page_size=ps)
    tk, tv = _t(kp), _t(vp)
    att.write_kv_token(tk, tv, _t(k_new), _t(v_new), _t(bt), _t(pos),
                       page_size=ps)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tk.shape[-1] == w and tk[0, 0].any()


def test_write_kv_prefill_int8_pools_identical():
    ps, kv, d, npages = 4, 2, 32, 8
    kp = _int8_pool(_values(6, npages * ps, kv, d), npages, ps)
    vp = _int8_pool(_values(7, npages * ps, kv, d), npages, ps)
    k_new, v_new = _values(8, 12, kv, d), _values(9, 12, kv, d)
    pages = np.array([3, 5, 0], np.int32)  # one trash page pads the list
    jk, jv = jatt.write_kv_prefill(jnp.asarray(kp), jnp.asarray(vp),
                                   jnp.asarray(k_new), jnp.asarray(v_new),
                                   jnp.asarray(pages), page_size=ps)
    tk, tv = _t(kp), _t(vp)
    att.write_kv_prefill(tk[:], tv[:], _t(k_new), _t(v_new), _t(pages),
                         page_size=ps)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("n_heads,n_kv,d", [(8, 2, 128), (4, 4, 32)])
def test_int8_decode_plain_matches_pallas(n_heads, n_kv, d):
    rng = np.random.default_rng(10)
    bsz, ps, npages, pmax = 4, 16, 32, 6
    q = rng.normal(size=(bsz, n_heads, d)).astype(np.float32)
    kp = _int8_pool(_values(11, npages * ps, n_kv, d), npages, ps)
    vp = _int8_pool(_values(12, npages * ps, n_kv, d), npages, ps)
    bt = (np.arange(bsz * pmax, dtype=np.int32).reshape(bsz, pmax)
          % (npages - 1)) + 1
    cl = np.array([1, ps * 2 + 5, ps * pmax, 0], np.int32)
    ref = pa.paged_attention_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(cl), page_size=ps, num_kv_heads=n_kv, interpret=True)
    out = att.paged_attention_decode(_t(q), _t(kp), _t(vp), _t(bt), _t(cl),
                                     page_size=ps, num_kv_heads=n_kv)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert not out[3].any()  # ctx 0 -> exact zeros


@pytest.mark.parametrize("start,c", [(48, 16), (0, 32), (32, 8)])
def test_int8_chunk_plain_matches_pallas(start, c):
    rng = np.random.default_rng(13)
    ps, n_kv, d, h = 16, 2, 128, 8
    kp = _int8_pool(_values(14, 32 * ps, n_kv, d), 32, ps)
    vp = _int8_pool(_values(15, 32 * ps, n_kv, d), 32, ps)
    pages = np.array(list(range(1, 7)) + [0, 0], np.int32)
    q = rng.normal(size=(c, h, d)).astype(np.float32)
    ref = pa.chunk_prefill_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pages),
        start, page_size=ps, num_kv_heads=n_kv, interpret=True)
    out = att.chunk_attention(_t(q), _t(kp), _t(vp), _t(pages), start,
                              page_size=ps, num_kv_heads=n_kv)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_int8_pools_need_num_kv_heads():
    kp = torch.zeros((4, 4, 128), dtype=torch.int8)
    q = torch.zeros((1, 4, 32))
    with pytest.raises(ValueError, match="num_kv_heads"):
        att.paged_attention_decode(q, kp, kp, torch.ones((1, 1), dtype=torch.int32),
                                   torch.ones((1,), dtype=torch.int32),
                                   page_size=4)


def test_unknown_kv_dtype_is_refused():
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        KVCacheSpec.from_model(ModelConfig.from_model_name("tiny-debug"), 8,
                               4, "int4")
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        Engine(EngineConfig(model="tiny-debug", kv_cache_dtype="int4",
                            enable_prefix_caching=False), device="cpu")


BASE = dict(model="tiny-debug", page_size=16, num_pages=64, max_num_seqs=4,
            max_seq_len=512, prefill_chunk_tokens=32,
            enable_prefix_caching=False, kv_cache_dtype="int8")


def test_int8_engine_greedy_streams_match_jax_engine():
    """Batched prefill, a chunked 70-token prompt and decode over int8
    pools: the port's streams equal the JAX engine's, and the pools hold
    packed rows."""
    cfg = dataclasses.replace(JPRESETS["tiny-debug"], dtype="float32")
    jparams = jllama.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    reqs = [(f"r{i}", rng.integers(0, 256, size=n).tolist())
            for i, n in enumerate([5, 9, 70])]

    def run(engine, make_req):
        for rid, prompt in reqs:
            engine.add_request(make_req(rid, prompt, max_tokens=10,
                                        temperature=0.0, ignore_eos=True))
        out = {}
        while engine.has_work:
            for ev in engine.step():
                if ev.token_id >= 0:
                    out.setdefault(ev.request_id, []).append(ev.token_id)
        return out

    ref = run(JEngine(JEngineConfig(**BASE, async_scheduling=False),
                      params=jparams), JGenRequest)
    eng = Engine(EngineConfig(**BASE),
                 params={k: np.asarray(v) for k, v in jparams.items()},
                 device="cpu")
    got = run(eng, GenRequest)
    assert got == ref
    assert all(len(s) == 10 for s in got.values())
    assert eng.k_pages.dtype == torch.int8
    assert eng.k_pages.shape[-1] == eng.kv_spec.lane_width == 128
    assert eng.allocator.free_pages == BASE["num_pages"] - 1
