"""The port's mixed step against the JAX package's.

- The plain ragged attention against the Pallas ragged kernel in interpret
  mode, f32 and int8 pools, decode rows of 1 and 2 queries, rows that cross
  page boundaries, a one-token context, a full table and a chunk starting
  mid-prompt, at rtol=atol=2e-5 (float32).
- `ragged_mixed_attention` (descriptors built by the port) against the JAX
  dispatch on its Pallas interpret backend and its XLA composition.
- `llama.mixed_step` against the JAX function from the same weights, on
  f32 and int8 pools: logits and the pools afterwards.
- The engine with `mixed_batch_tokens`: greedy streams identical to the
  JAX engine's with the same setting and to the port's classic engine's,
  on bf16-layout (f32) and int8 pools.
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
from dynamo_tpu.ops import ragged_attention as ra
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import Engine
from dynamo_tpu_torch.engine.request import GenRequest
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models import loader
from dynamo_tpu_torch.models.config import PRESETS
from dynamo_tpu_torch.ops import attention as att

TOL = dict(rtol=2e-5, atol=2e-5)
PS = 16


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


def _pools(rng, quantized, n_pool=64, n_kv=2, d=64):
    kf = rng.normal(size=(n_pool * PS, n_kv, d)).astype(np.float32)
    vf = rng.normal(size=(n_pool * PS, n_kv, d)).astype(np.float32)
    if not quantized:
        return (kf.reshape(n_pool, PS, n_kv * d),
                vf.reshape(n_pool, PS, n_kv * d))
    w = jatt.kv_lane_width(n_kv, d, True)
    return tuple(np.asarray(jatt.pack_kv_rows(jnp.asarray(x), w)).reshape(
        n_pool, PS, w) for x in (kf, vf))


def _descriptors(decode_q):
    """Three decode rows (a 1-token context, one crossing two page
    boundaries, a full table) and a 32-token chunk at position 16 (mid page
    1) on a 5-page list; decode_q > 1 makes each row a window whose last
    query sits at its context's last token."""
    tables = np.zeros((4, 6), np.int32)
    tables[0, :1] = [1]
    tables[1, :3] = [2, 3, 4]
    tables[2, :6] = np.arange(10, 16)
    tables[3, :5] = [20, 21, 22, 23, 24]
    ctx = np.array([max(1, decode_q), 2 * PS + 5, 6 * PS], np.int32)
    start, c = 16, 32
    kv_lens = np.append(ctx, start + c).astype(np.int32)
    q_starts = np.append(ctx - decode_q, start).astype(np.int32)
    return tables, kv_lens, q_starts, c


@pytest.mark.parametrize("decode_q", [1, 2])
@pytest.mark.parametrize("quantized", [False, True],
                         ids=["f32_pool", "int8_pool"])
def test_ragged_plain_matches_pallas(quantized, decode_q):
    rng = np.random.default_rng(17)
    h, n_kv, d = 8, 2, 64
    kp, vp = _pools(rng, quantized, n_kv=n_kv, d=d)
    tables, kv_lens, q_starts, c = _descriptors(decode_q)
    q = rng.normal(size=(3 * decode_q + c, h, d)).astype(np.float32)
    ref = ra.ragged_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(kv_lens), jnp.asarray(q_starts), page_size=PS,
        num_kv_heads=n_kv, num_decode=3, decode_q=decode_q, interpret=True)
    out = att.ragged_paged_attention_ref(
        _t(q), _t(kp), _t(vp), _t(tables), _t(kv_lens), _t(q_starts),
        page_size=PS, num_kv_heads=n_kv, num_decode=3, decode_q=decode_q)
    assert out.shape == q.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_ragged_row_with_no_visible_key_is_zero():
    """A decode row with context 0 sees nothing: exact zeros, not NaN."""
    rng = np.random.default_rng(4)
    kp, vp = _pools(rng, False, n_kv=2, d=32)
    q = _t(rng.normal(size=(2 + 16, 4, 32)).astype(np.float32))
    tables = _t(np.array([[1, 0], [2, 3], [4, 5]], np.int32))
    out = att.ragged_paged_attention_ref(
        q, _t(kp), _t(vp), tables, _t(np.array([0, 7, 16], np.int32)),
        _t(np.array([0, 6, 0], np.int32)), page_size=PS, num_kv_heads=2,
        num_decode=2)
    assert not out[0].any() and out[1:].abs().sum() > 0


@pytest.mark.parametrize("backend", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("quantized", [False, True],
                         ids=["f32_pool", "int8_pool"])
def test_ragged_mixed_attention_matches_jax_dispatch(monkeypatch, backend,
                                                     quantized):
    rng = np.random.default_rng(23)
    h, n_kv, d = 8, 2, 64
    kp, vp = _pools(rng, quantized, n_kv=n_kv, d=d)
    tables, kv_lens, _, c = _descriptors(1)
    block_tables, ctx, p_pages = tables[:3], kv_lens[:3], tables[3, :5]
    q = rng.normal(size=(3 + c, h, d)).astype(np.float32)
    monkeypatch.setenv("DYNAMO_TPU_RAGGED_ATTENTION", backend)
    ref = jatt.ragged_mixed_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(block_tables), jnp.asarray(ctx), jnp.asarray(p_pages), 16,
        page_size=PS, num_kv_heads=n_kv, num_decode=3)
    out = att.ragged_mixed_attention(
        _t(q), _t(kp), _t(vp), _t(block_tables), _t(ctx), _t(p_pages), 16,
        page_size=PS, num_kv_heads=n_kv, num_decode=3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_descriptors_are_the_jax_ones():
    bt = _t(np.array([[1, 2, 0], [0, 0, 0]], np.int32))
    ctx = _t(np.array([20, 1], np.int32))
    tabs, kv_lens, q_starts = att.ragged_descriptors(
        bt, ctx, _t(np.array([5, 6, 7, 0, 0], np.int32)), 32, 16)
    assert tabs.tolist() == [[1, 2, 0, 0, 0], [0, 0, 0, 0, 0],
                             [5, 6, 7, 0, 0]]
    assert kv_lens.tolist() == [20, 1, 48]
    assert q_starts.tolist() == [19, 0, 32]


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(JPRESETS["tiny-debug"], dtype="float32")
    tcfg = dataclasses.replace(PRESETS["tiny-debug"], dtype="float32")
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    model = loader.from_jax_params(
        tcfg, {k: np.asarray(v) for k, v in jparams.items()}, device="cpu",
        dtype=torch.float32)
    return jcfg, jparams, model


@pytest.mark.parametrize("quantized", [False, True],
                         ids=["f32_pool", "int8_pool"])
def test_mixed_step_matches_jax(models, quantized):
    """Two live decode slots and an inactive one (trash page, context 1)
    beside the second 16-token chunk (9 valid) of a prompt, over every
    layer's pools."""
    jcfg, jparams, model = models
    rng = np.random.default_rng(31)
    layers, n_kv, d = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_dim
    pools = [_pools(rng, quantized, n_pool=16, n_kv=n_kv, d=d)
             for _ in range(layers)]
    kp = np.stack([p[0] for p in pools])
    vp = np.stack([p[1] for p in pools])
    tokens = np.array([11, 300, 0], np.int32)
    positions = np.array([20, 35, 0], np.int32)
    tables = np.array([[1, 2, 0], [3, 4, 9], [0, 0, 0]], np.int32)
    ctx = positions + 1
    chunk = np.zeros((16,), np.int32)
    chunk[:9] = rng.integers(0, jcfg.vocab_size, size=9)
    chunk_pages = np.array([5, 6, 0], np.int32)
    ref = jllama.mixed_step(
        jcfg, jparams, jnp.asarray(tokens), jnp.asarray(positions),
        jnp.asarray(tables), jnp.asarray(ctx), jnp.asarray(chunk),
        jnp.int32(16), jnp.int32(9), jnp.asarray(chunk_pages),
        jnp.asarray(kp), jnp.asarray(vp), page_size=PS)
    tk, tv = _t(kp), _t(vp)
    logits, chunk_logits = tllama.mixed_step(
        model, _t(tokens), _t(positions), _t(tables), _t(ctx), _t(chunk), 16,
        9, _t(chunk_pages), tk, tv, page_size=PS)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref.logits), **TOL)
    np.testing.assert_allclose(chunk_logits.numpy(),
                               np.asarray(ref.chunk_logits), **TOL)
    if quantized:
        # the packer is byte-identical (test_torch_kv_int8.py), but K/V come
        # from two frameworks' matmuls: a value within f32 rounding of a
        # quantization boundary may land one int8 step away
        for got, want in ((tk, ref.k_pages), (tv, ref.v_pages)):
            want = np.asarray(want)
            assert (got.numpy() != want).mean() < 1e-3
            step = att.unpack_kv_rows(_t(want), n_kv, d).abs().amax(-1) / 127
            diff = (att.unpack_kv_rows(got, n_kv, d)
                    - att.unpack_kv_rows(_t(want), n_kv, d)).abs()
            assert bool((diff <= 1.01 * step[..., None] + 1e-6).all())
    else:
        np.testing.assert_allclose(tk.numpy(), np.asarray(ref.k_pages), **TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(ref.v_pages), **TOL)


MIXED = dict(model="tiny-debug", page_size=4, num_pages=256, max_num_seqs=4,
             max_seq_len=256, prefill_chunk_tokens=8, mixed_batch_tokens=8,
             enable_prefix_caching=False)
PROMPT = [(i * 11) % 300 + 1 for i in range(50)]


def _interference(eng, make_req):
    """A live greedy stream, then a 50-token prompt arriving mid-decode:
    its chunks ride the mixed step while the stream decodes. Every step's
    events are kept."""
    out = {"live": [], "long": []}

    def collect(events):
        for ev in events:
            if ev.token_id >= 0:
                out[ev.request_id].append(ev.token_id)

    eng.add_request(make_req("live", [1, 2, 3], max_tokens=12,
                             temperature=0.0, ignore_eos=True))
    for _ in range(3):
        collect(eng.step())
    eng.add_request(make_req("long", PROMPT, max_tokens=4, temperature=0.0,
                             ignore_eos=True))
    while eng.has_work:
        collect(eng.step())
    return out


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_mixed_engine_matches_jax_and_classic(models, kv_dtype):
    jcfg, jparams, _ = models
    cfg = dict(MIXED, kv_cache_dtype=kv_dtype)
    ref = _interference(JEngine(JEngineConfig(**cfg, enforce_eager=True,
                                              async_scheduling=False),
                                params=jparams), JGenRequest)
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    eng = Engine(EngineConfig(**cfg), params=np_params, device="cpu")
    got = _interference(eng, GenRequest)
    classic = _interference(
        Engine(EngineConfig(**dict(cfg, mixed_batch_tokens=0)),
               params=eng.model, device="cpu"), GenRequest)
    assert got == ref == classic
    assert len(got["live"]) == 12 and len(got["long"]) == 4
    # the 50-token prompt took 7 chunks, 6 of them beside the live stream
    assert eng.metrics.mixed_count >= 5
    assert eng.metrics.decode_steps >= eng.metrics.mixed_count
    assert eng.allocator.free_pages == MIXED["num_pages"] - 1
    assert not eng.has_work


def test_mixed_config_normalization():
    """mixed_batch_tokens rounds up to a page multiple and an unset chunk
    size takes it (mixed implies chunked prefill)."""
    eng = Engine(EngineConfig(**dict(MIXED, mixed_batch_tokens=10,
                                     prefill_chunk_tokens=0)), device="cpu")
    assert eng.cfg.mixed_batch_tokens == 12
    assert eng.cfg.prefill_chunk_tokens == 12
    kept = Engine(EngineConfig(**dict(MIXED, mixed_batch_tokens=10,
                                      prefill_chunk_tokens=16)),
                  params=eng.model, device="cpu")
    assert kept.cfg.prefill_chunk_tokens == 16


def test_mixed_chunk_wider_than_classic_stays_on_its_page_list(models):
    """A mixed budget wider than the classic chunk: the page list is sized
    for the wider window, so the last padded mixed chunk's page slice stays
    on the list, and the streams still equal the classic engine's."""
    _, jparams, _ = models
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    cfg = dict(MIXED, prefill_chunk_tokens=8, mixed_batch_tokens=24)
    eng = Engine(EngineConfig(**cfg), params=np_params, device="cpu")
    got = _interference(eng, GenRequest)
    classic = _interference(
        Engine(EngineConfig(**dict(cfg, mixed_batch_tokens=0)),
               params=eng.model, device="cpu"), GenRequest)
    assert got == classic and eng.metrics.mixed_count >= 1


def test_mixed_abort_mid_prefill_frees_pages():
    eng = Engine(EngineConfig(**MIXED), device="cpu")
    eng.add_request(GenRequest("live", [1, 2, 3], max_tokens=30,
                               ignore_eos=True))
    eng.step()
    eng.add_request(GenRequest("long", PROMPT, max_tokens=4,
                               ignore_eos=True))
    eng.step()  # admits the long prompt's first chunk
    eng.step()  # a mixed step
    assert eng._inflight is not None and eng.metrics.mixed_count == 1
    eng.abort_request("long")
    events = eng.step()
    assert any(e.request_id == "long" and e.finish_reason == "abort"
               for e in events)
    eng.abort_request("live")
    while eng.has_work:
        eng.step()
    assert eng.allocator.free_pages == MIXED["num_pages"] - 1
