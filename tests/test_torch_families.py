"""The Qwen2, Qwen3 and Gemma-1 dense families in the port against the JAX
package, and the attention kernels' head_dim 256 (Gemma's).

- Attention at head_dim 256: the port's plain decode, prefill, chunk and
  ragged attention (chunk rows, verify rows beside a chunk, verify rows
  alone with C = 0) against the Pallas kernels in interpret mode, on f32
  and int8 pools, GQA groups 1 and 8 (gemma-7b-it's and gemma-2b-it's),
  and the ragged verify rows at group 7 (qwen2.5-7b-instruct's), at
  rtol=atol=2e-5 (float32, as tests/test_torch_ops.py). The tile's
  launch plan takes head_dim 256 for every group of 1 to 64.
- Models, float32 on the CPU from one JAX parameter tree carried across by
  `models.loader.from_jax_params`: tiny-gemma-debug (GeGLU, 1 + w norms,
  sqrt(E)-scaled embeddings, MQA), tiny-debug with `attention_bias`
  (Qwen2) and tiny-debug with `qk_norm` (Qwen3). Biases and norm weights
  are drawn non-zero (the JAX init makes biases zeros and Gemma's norms
  zeros, which would test nothing). Prefill, batched prefill, chunks,
  decode, the mixed step, the verify step and the mixed verify step: logits
  within rtol=atol=1e-4 (two frameworks' matmul orders over two layers, as
  tests/test_torch_model.py) and the pools within 1e-5. Engines: greedy
  streams equal to the JAX engine's token for token, classic and with
  mixed steps and n-gram speculation.
- The model drafter refuses a draft ModelConfig the port does not
  implement, as the engine does for its target; tiny-gemma-debug and
  tiny-gemma2-debug drafters propose what the JAX DraftEngine proposes.
- Checkpoints: tiny Qwen2-, Qwen3- and Gemma-shaped HF safetensors (with
  their config.json) load in both packages to equal parameters; w8a8 on
  the Qwen2 one keeps biases and norms unquantized and serves the JAX
  w8a8 engine's tokens.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.engine import Engine as JEngine
from dynamo_tpu.engine.kv_cache import SeqState as JSeqState
from dynamo_tpu.engine.request import GenRequest as JGenRequest
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models import loader as jloader
from dynamo_tpu.models.config import PRESETS as JPRESETS
from dynamo_tpu.models.config import ModelConfig as JModelConfig
from dynamo_tpu.ops import attention as jatt
from dynamo_tpu.ops import pallas_attention as pa
from dynamo_tpu.ops import ragged_attention as ra
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import Engine
from dynamo_tpu_torch.engine.kv_cache import SeqState
from dynamo_tpu_torch.engine.request import GenRequest
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models import loader, quant
from dynamo_tpu_torch.models.config import PRESETS, ModelConfig
from dynamo_tpu_torch.ops import attention as att
from dynamo_tpu_torch.ops import cuda_attention as ca

TOL = dict(rtol=2e-5, atol=2e-5)  # attention, float32
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
KV_TOL = dict(rtol=1e-5, atol=1e-5)
PS = 16
K = 4  # drafts per verify window


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


# ----------------------------------------------- attention at D = 256 --


def _pools(rng, quantized, n_pool, n_kv, d):
    kf = rng.normal(size=(n_pool * PS, n_kv, d)).astype(np.float32)
    vf = rng.normal(size=(n_pool * PS, n_kv, d)).astype(np.float32)
    if not quantized:
        return (kf.reshape(n_pool, PS, n_kv * d),
                vf.reshape(n_pool, PS, n_kv * d))
    w = jatt.kv_lane_width(n_kv, d, True)
    return tuple(np.asarray(jatt.pack_kv_rows(jnp.asarray(x), w)).reshape(
        n_pool, PS, w) for x in (kf, vf))


POOLS = pytest.mark.parametrize("quantized", [False, True],
                                ids=["f32_pool", "int8_pool"])
# gemma-7b-it's group 1 and gemma-2b-it's group 8, at small head counts
GROUPS_256 = pytest.mark.parametrize("n_heads,n_kv", [(2, 2), (8, 1)],
                                     ids=["group1", "group8"])


@POOLS
@GROUPS_256
def test_decode_plain_matches_pallas_at_head_dim_256(quantized, n_heads,
                                                     n_kv):
    rng = np.random.default_rng(0)
    d, bsz, pmax = 256, 4, 5
    kp, vp = _pools(rng, quantized, 24, n_kv, d)
    q = rng.normal(size=(bsz, n_heads, d)).astype(np.float32)
    bt = (np.arange(bsz * pmax, dtype=np.int32).reshape(bsz, pmax) % 23) + 1
    cl = np.array([1, PS * 2 + 5, PS * pmax, 0], np.int32)
    ref = pa.paged_attention_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(cl), page_size=PS, num_kv_heads=n_kv, interpret=True)
    out = att.paged_attention_decode(_t(q), _t(kp), _t(vp), _t(bt), _t(cl),
                                     page_size=PS, num_kv_heads=n_kv)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert not out[3].any()  # ctx 0 -> exact zeros


@GROUPS_256
@pytest.mark.parametrize("s,seq_len", [(64, 64), (48, 29)])
def test_prefill_plain_matches_pallas_at_head_dim_256(n_heads, n_kv, s,
                                                      seq_len):
    rng = np.random.default_rng(1)
    d = 256
    q = rng.normal(size=(s, n_heads, d)).astype(np.float32)
    k = rng.normal(size=(s, n_kv, d)).astype(np.float32)
    v = rng.normal(size=(s, n_kv, d)).astype(np.float32)
    ref = pa.prefill_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               seq_len, interpret=True)
    out = att.prefill_attention(_t(q), _t(k), _t(v), seq_len)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@POOLS
@GROUPS_256
def test_chunk_plain_matches_pallas_at_head_dim_256(quantized, n_heads,
                                                    n_kv):
    rng = np.random.default_rng(2)
    d, start, c = 256, 40, 24
    kp, vp = _pools(rng, quantized, 16, n_kv, d)
    pages = np.array([3, 1, 7, 9, 0, 0], np.int32)  # a trash-padded tail
    q = rng.normal(size=(c, n_heads, d)).astype(np.float32)
    ref = pa.chunk_prefill_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pages),
        start, page_size=PS, num_kv_heads=n_kv, interpret=True)
    out = att.chunk_attention(_t(q), _t(kp), _t(vp), _t(pages), start,
                              page_size=PS, num_kv_heads=n_kv)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _ragged_rows(decode_q):
    """Three rows' tables [3, 6] and contexts: a window at the start of a
    context, one crossing a page boundary, a full table."""
    tables = np.zeros((3, 6), np.int32)
    tables[0, :1] = [1]
    tables[1, :3] = [2, 3, 4]
    tables[2, :6] = np.arange(10, 16)
    return tables, np.array([decode_q, 2 * PS + 5, 6 * PS], np.int32)


@POOLS
@pytest.mark.parametrize("n_heads,n_kv,d,decode_q", [
    (8, 1, 256, 1), (2, 2, 256, K + 1), (7, 1, 128, K + 1)],
    ids=["d256-group8-chunk_rows", "d256-group1-verify_rows",
         "d128-group7-verify_rows"])
def test_ragged_plain_matches_pallas_at_new_shapes(quantized, n_heads, n_kv,
                                                   d, decode_q):
    """The ragged kernel's rows beside a 32-token chunk at 16 of a 5-page
    list, at head_dim 256 and at group 7, where a verify row holds
    5 x 7 = 35 of the tile's 64 rows."""
    rng = np.random.default_rng(3)
    kp, vp = _pools(rng, quantized, 32, n_kv, d)
    rows, ctx = _ragged_rows(decode_q)
    tables = np.zeros((4, 6), np.int32)
    tables[:3] = rows
    tables[3, :5] = [20, 21, 22, 23, 24]
    start, c = 16, 32
    kv_lens = np.append(ctx, start + c).astype(np.int32)
    q_starts = np.append(ctx - decode_q, start).astype(np.int32)
    q = rng.normal(size=(3 * decode_q + c, n_heads, d)).astype(np.float32)
    ref = ra.ragged_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(kv_lens), jnp.asarray(q_starts), page_size=PS,
        num_kv_heads=n_kv, num_decode=3, decode_q=decode_q, interpret=True)
    out = att.ragged_paged_attention_ref(
        _t(q), _t(kp), _t(vp), _t(tables), _t(kv_lens), _t(q_starts),
        page_size=PS, num_kv_heads=n_kv, num_decode=3, decode_q=decode_q)
    assert out.shape == q.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@POOLS
@pytest.mark.parametrize("n_heads,n_kv,d", [(8, 1, 256), (2, 2, 256),
                                            (14, 2, 128)],
                         ids=["d256-group8", "d256-group1", "d128-group7"])
def test_ragged_verify_only_plain_matches_jax(quantized, n_heads, n_kv, d):
    """C = 0: the verify step's ragged batch (windows of K+1, no chunk,
    through `ragged_verify_descriptors`) against what the JAX verify step
    runs there, `verify_attention` (the Pallas ragged kernel takes no
    batch without a chunk)."""
    rng = np.random.default_rng(4)
    k1 = K + 1
    kp, vp = _pools(rng, quantized, 32, n_kv, d)
    tables, ctx = _ragged_rows(k1)
    positions = ctx - k1
    q = rng.normal(size=(3, k1, n_heads, d)).astype(np.float32)
    ref = jatt.verify_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(positions), page_size=PS,
        num_kv_heads=n_kv)
    desc = att.ragged_verify_descriptors(_t(tables), _t(positions), k1)
    out = att.ragged_paged_attention_ref(
        _t(q).reshape(3 * k1, n_heads, d), _t(kp), _t(vp), *desc,
        page_size=PS, num_kv_heads=n_kv, num_decode=3, decode_q=k1)
    np.testing.assert_allclose(out.reshape(q.shape).numpy(), np.asarray(ref),
                               **TOL)


@pytest.mark.parametrize("group", [1, 7, 8, 16, 64])
def test_tile_takes_head_dim_256_at_every_group(group):
    assert ca.tile_positions(group, 256) == 64 // group
    assert ca.check_decode_rows(1, group, 256) == 64 // group
    if group <= 64 // (K + 1):  # a verify window of K+1 queries fits
        assert ca.check_decode_rows(K + 1, group, 128) == 64 // group
    else:
        with pytest.raises(ValueError, match="does not fit"):
            ca.check_decode_rows(K + 1, group, 128)
    assert ca.tile_positions(group, 96) == 64 // group  # Phi-3's
    with pytest.raises(ValueError, match="built for head_dim"):
        ca.tile_positions(group, 80)  # no kernel: never a quiet plain path
    with pytest.raises(ValueError, match="built for head_dim"):
        ca.tile_positions(group, 512)


# -------------------------------------------------------------- models --

FAMILIES = {
    "gemma": lambda p: p["tiny-gemma-debug"],
    "qwen2": lambda p: dataclasses.replace(p["tiny-debug"],
                                           attention_bias=True),
    "qwen3": lambda p: dataclasses.replace(p["tiny-debug"], qk_norm=True),
}


def family_cfgs(family: str):
    """(JAX ModelConfig, port ModelConfig) of a family, float32."""
    make = FAMILIES[family]
    return (dataclasses.replace(make(JPRESETS), dtype="float32"),
            dataclasses.replace(make(PRESETS), dtype="float32"))


def jax_params(jcfg, seed=0):
    """The JAX init from PRNGKey(seed), every constant leaf (norms,
    biases) redrawn around its constant from a numpy seed."""
    params = jllama.init_params(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 100)
    specs = jllama.param_specs(jcfg)
    out = {}
    for name, leaf in params.items():
        _, kind, _ = specs[name]
        if kind in ("zeros", "ones"):
            noise = rng.normal(size=leaf.shape).astype(np.float32)
            leaf = jnp.asarray(np.asarray(leaf) + 0.3 * noise)
        out[name] = leaf
    return out


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    jcfg, tcfg = family_cfgs(request.param)
    jparams = jax_params(jcfg)
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    model = loader.from_jax_params(tcfg, np_params, device="cpu",
                                   dtype=torch.float32)
    return request.param, jcfg, jparams, np_params, model


def _model_pools(cfg, seed, n_pages=16):
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, n_pages, PS, cfg.num_kv_heads * cfg.head_dim)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _pools_match(ref, tk, tv):
    np.testing.assert_allclose(tk.numpy(), np.asarray(ref.k_pages), **KV_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(ref.v_pages), **KV_TOL)


def test_family_leaves_carry_across(family):
    name, jcfg, jparams, np_params, model = family
    assert set(loader.param_specs(model.cfg)) == set(jparams)
    layer = model.layers[1]
    if jcfg.attention_bias:
        np.testing.assert_array_equal(layer.bq.numpy(),
                                      np_params["bq"][1].reshape(-1))
        np.testing.assert_array_equal(layer.bv.numpy(),
                                      np_params["bv"][1].reshape(-1))
        assert layer.bk.abs().min() > 0
    else:
        assert layer.bq is None and layer.bk is None
    if jcfg.qk_norm:
        np.testing.assert_array_equal(layer.k_norm.numpy(),
                                      np_params["k_norm"][1])
    else:
        assert layer.q_norm is None
    # every norm was redrawn away from its constant
    assert (model.final_norm != (0.0 if jcfg.rms_norm_unit_offset
                                 else 1.0)).all()
    assert tllama.unported_model_features(model.cfg) == []


def test_family_prefill_matches(family):
    _, jcfg, jparams, _, model = family
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab_size, size=32).astype(np.int32)
    pages = np.array([3, 7], np.int32)
    kp, vp = _model_pools(jcfg, 0)
    ref = jllama.prefill(jcfg, jparams, jnp.asarray(tokens), jnp.int32(27),
                         jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pages),
                         page_size=PS)
    tk, tv = _t(kp), _t(vp)
    logits = tllama.prefill(model, _t(tokens), 27, tk, tv, _t(pages),
                            page_size=PS)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref.last_logits),
                               **LOGIT_TOL)
    _pools_match(ref, tk, tv)


def test_family_prefill_batch_matches(family):
    _, jcfg, jparams, _, model = family
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, jcfg.vocab_size, size=(2, 32)).astype(np.int32)
    seq_lens = np.array([32, 11], np.int32)
    tokens[1, 11:] = 0
    pages = np.array([[1, 2], [4, 0]], np.int32)
    kp, vp = _model_pools(jcfg, 3)
    ref = jllama.prefill_batch(jcfg, jparams, jnp.asarray(tokens),
                               jnp.asarray(seq_lens), jnp.asarray(kp),
                               jnp.asarray(vp), jnp.asarray(pages),
                               page_size=PS)
    tk, tv = _t(kp), _t(vp)
    logits = tllama.prefill_batch(model, _t(tokens), _t(seq_lens), tk, tv,
                                  _t(pages), page_size=PS)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref.last_logits),
                               **LOGIT_TOL)
    _pools_match(ref, tk, tv)


def test_family_prefill_chunks_match(family):
    """A 40-token prompt in 16-token chunks over a trash-padded list."""
    _, jcfg, jparams, _, model = family
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, jcfg.vocab_size, size=40).astype(np.int32)
    pages = np.array([5, 6, 8, 0], np.int32)
    kp, vp = _model_pools(jcfg, 5)
    jk, jv = jnp.asarray(kp), jnp.asarray(vp)
    tk, tv = _t(kp), _t(vp)
    for start in (0, 16, 32):
        take = min(16, 40 - start)
        chunk = np.zeros((16,), np.int32)
        chunk[:take] = prompt[start:start + take]
        ref = jllama.prefill_chunk(jcfg, jparams, jnp.asarray(chunk),
                                   jnp.int32(start), jnp.int32(take), jk, jv,
                                   jnp.asarray(pages), page_size=PS)
        jk, jv = ref.k_pages, ref.v_pages
        logits = tllama.prefill_chunk(model, _t(chunk), start, take, tk, tv,
                                      _t(pages), page_size=PS)
        np.testing.assert_allclose(logits.numpy(),
                                   np.asarray(ref.last_logits), **LOGIT_TOL)
    _pools_match(ref, tk, tv)


def _decode_batch(jcfg, rng):
    """Two live slots mid-sequence, one inactive on the trash page."""
    tokens = rng.integers(0, jcfg.vocab_size, size=3).astype(np.int32)
    tokens[2] = 0
    positions = np.array([20, 35, 0], np.int32)
    tables = np.array([[1, 2, 0], [3, 4, 9], [0, 0, 0]], np.int32)
    return tokens, positions, tables


def test_family_decode_step_matches(family):
    _, jcfg, jparams, _, model = family
    kp, vp = _model_pools(jcfg, 6)
    tokens, positions, tables = _decode_batch(jcfg, np.random.default_rng(6))
    ctx = positions + 1
    ref = jllama.decode_step(jcfg, jparams, jnp.asarray(tokens),
                             jnp.asarray(positions), jnp.asarray(tables),
                             jnp.asarray(ctx), jnp.asarray(kp),
                             jnp.asarray(vp), page_size=PS)
    tk, tv = _t(kp), _t(vp)
    logits = tllama.decode_step(model, _t(tokens), _t(positions), _t(tables),
                                _t(ctx), tk, tv, page_size=PS)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref.logits),
                               **LOGIT_TOL)
    _pools_match(ref, tk, tv)


def test_family_mixed_step_matches(family):
    """The decode batch beside the second 16-token chunk (9 valid)."""
    _, jcfg, jparams, _, model = family
    rng = np.random.default_rng(7)
    kp, vp = _model_pools(jcfg, 7)
    tokens, positions, tables = _decode_batch(jcfg, rng)
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
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref.logits),
                               **LOGIT_TOL)
    np.testing.assert_allclose(chunk_logits.numpy(),
                               np.asarray(ref.chunk_logits), **LOGIT_TOL)
    _pools_match(ref, tk, tv)


def _verify_batch(jcfg, rng):
    """Windows of K+1: two live slots with room, one inactive slot on the
    trash page (position 0, no room)."""
    tokens = rng.integers(0, jcfg.vocab_size, size=(3, K + 1)).astype(
        np.int32)
    positions = np.array([10, 2 * PS - 2, 0], np.int32)
    tables = np.array([[1, 2, 0], [3, 4, 5], [0, 0, 0]], np.int32)
    room = np.array([True, True, False])
    return tokens, positions, tables, room


def test_family_decode_verify_matches(family):
    _, jcfg, jparams, _, model = family
    rng = np.random.default_rng(8)
    kp, vp = _model_pools(jcfg, 8)
    tokens, positions, tables, room = _verify_batch(jcfg, rng)
    ref = jllama.decode_verify(
        jcfg, jparams, jnp.asarray(tokens), jnp.asarray(positions),
        jnp.asarray(tables), jnp.asarray(room), jnp.asarray(kp),
        jnp.asarray(vp), page_size=PS)
    tk, tv = _t(kp), _t(vp)
    logits = tllama.decode_verify(model, _t(tokens), _t(positions),
                                  _t(tables), _t(room), tk, tv, page_size=PS)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref.logits),
                               **LOGIT_TOL)
    _pools_match(ref, tk, tv)


def test_family_mixed_verify_step_matches(family):
    _, jcfg, jparams, _, model = family
    rng = np.random.default_rng(9)
    kp, vp = _model_pools(jcfg, 9)
    tokens, positions, tables, room = _verify_batch(jcfg, rng)
    chunk = np.zeros((16,), np.int32)
    chunk[:9] = rng.integers(0, jcfg.vocab_size, size=9)
    chunk_pages = np.array([6, 7, 0], np.int32)
    ref = jllama.mixed_verify_step(
        jcfg, jparams, jnp.asarray(tokens), jnp.asarray(positions),
        jnp.asarray(tables), jnp.asarray(room), jnp.asarray(chunk),
        jnp.int32(16), jnp.int32(9), jnp.asarray(chunk_pages),
        jnp.asarray(kp), jnp.asarray(vp), page_size=PS)
    tk, tv = _t(kp), _t(vp)
    logits, chunk_logits = tllama.mixed_verify_step(
        model, _t(tokens), _t(positions), _t(tables), _t(room), _t(chunk),
        16, 9, _t(chunk_pages), tk, tv, page_size=PS)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref.logits),
                               **LOGIT_TOL)
    np.testing.assert_allclose(chunk_logits.numpy(),
                               np.asarray(ref.chunk_logits), **LOGIT_TOL)
    _pools_match(ref, tk, tv)


# ------------------------------------------------------------- engines --

ENGINE = dict(page_size=PS, num_pages=64, max_num_seqs=4, max_seq_len=512,
              enable_prefix_caching=False)
MODES = {
    # batched same-bucket prefill, a prompt chunked at 32, decode
    "classic": dict(prefill_chunk_tokens=32),
    # mixed steps beside live streams, n-gram verify windows
    "mixed_spec": dict(mixed_batch_tokens=32, prefill_chunk_tokens=32,
                       speculative_mode="ngram", num_speculative_tokens=K),
}


def _drive(engine, make_req, reqs):
    """Add (rid, prompt, max_tokens, delay) requests, each once `delay`
    steps have run, and step until idle: {rid: greedy tokens}."""
    streams, step = {}, 0
    pending = sorted(reqs, key=lambda r: r[3])
    while pending or engine.has_work:
        while pending and pending[0][3] <= step:
            rid, prompt, n, _ = pending.pop(0)
            engine.add_request(make_req(rid, prompt, max_tokens=n,
                                        temperature=0.0, ignore_eos=True))
        for ev in engine.step():
            if ev.token_id >= 0:
                streams.setdefault(ev.request_id, []).append(ev.token_id)
        step += 1
        assert step < 2000
    return streams


@pytest.mark.parametrize("mode", list(MODES))
def test_family_engine_greedy_streams_match_jax(family, mode):
    """Two short prompts and a repetitive one (it drafts), then a 70-token
    prompt that arrives while they decode (its chunks ride mixed steps in
    the mixed mode)."""
    name, jcfg, jparams, np_params, model = family
    _, tcfg = family_cfgs(name)
    rng = np.random.default_rng(10)
    reqs = [("a", rng.integers(0, 256, size=5).tolist(), 14, 0),
            ("b", rng.integers(0, 256, size=9).tolist(), 14, 0),
            ("c", [5, 6, 7] * 4, 14, 0),
            ("d", rng.integers(0, 256, size=70).tolist(), 8, 3)]
    cfg = dict(ENGINE, model=PRESETS["tiny-debug"].name, **MODES[mode])
    ref = _drive(JEngine(JEngineConfig(**cfg, async_scheduling=False),
                         model_cfg=jcfg, params=jparams), JGenRequest, reqs)
    eng = Engine(EngineConfig(**cfg), model_cfg=tcfg, params=model,
                 device="cpu")
    got = _drive(eng, GenRequest, reqs)
    assert got == ref
    assert [len(got[r]) for r in "abcd"] == [14, 14, 14, 8]
    if mode == "mixed_spec":
        assert eng.metrics.mixed_spec_count + eng.metrics.mixed_count > 0
        assert eng.metrics.spec_verify_steps > 0


# ------------------------------------------------------- the drafter --

SPEC = dict(page_size=8, num_pages=128, max_num_seqs=2, max_seq_len=256,
            num_speculative_tokens=K, prefill_chunk_tokens=0,
            enable_prefix_caching=False, speculative_mode="model")


def test_draft_model_with_unported_features_is_refused(tmp_path):
    """Once refused for its sliding window, tiny-gemma2-debug now drafts
    (window 8 on its local layer, caps 50 and 30) for itself as a separate
    model (the JAX draft engine's params, seed + 1, carried across): the
    same proposals as the JAX DraftEngine for a history past the window,
    then the same greedy streams. A draft config the port does not
    implement is still refused: a Phi-3 checkpoint whose config.json sets
    a head_dim the kernels are not built for (80; the preset's 96 is
    served since it was ported)."""
    jcfg = dataclasses.replace(JPRESETS["tiny-gemma2-debug"],
                               dtype="float32")
    jparams = jax_params(jcfg)
    cfg = dict(SPEC, model="tiny-gemma2-debug",
               draft_model="tiny-gemma2-debug")
    jeng = JEngine(JEngineConfig(**cfg), params=jparams)
    draft = {k: np.asarray(v) for k, v in jeng.draft.params.items()}
    eng = Engine(EngineConfig(**cfg), params={k: np.asarray(v) for k, v in
                                               jparams.items()},
                 device="cpu", draft_params=draft)
    assert eng.draft.model_cfg.sliding_window == 8
    props = []
    prompt = [5, 6, 7, 9, 5, 6, 7, 9, 5, 6, 7, 9, 5, 6]
    for e, cls in ((eng, SeqState), (jeng, JSeqState)):
        seq = cls("r", 0, [1], prompt_len=len(prompt), max_tokens=8)
        seq.prompt_ids, seq.output_tokens = list(prompt), [3]
        props.append([e.draft.propose(seq, K), e.draft.propose(seq, 2)])
        e.draft.release(0)
    assert props[0] == props[1]
    reqs = [("a", [5, 6, 7] * 5, 12, 0), ("b", list(range(30, 48)), 10, 0)]
    assert _drive(eng, GenRequest, reqs) == _drive(jeng, JGenRequest, reqs)
    (tmp_path / "config.json").write_text(json.dumps({
        "architectures": ["Phi3ForCausalLM"], "vocab_size": 512,
        "hidden_size": 160, "intermediate_size": 256,
        "num_hidden_layers": 2, "num_attention_heads": 2,
        "num_key_value_heads": 2, "head_dim": 80, "sliding_window": 16}))
    bad = EngineConfig(model="tiny-debug", speculative_mode="model",
                       draft_model="phi-3-mini-4k-instruct",
                       draft_model_path=str(tmp_path),
                       num_speculative_tokens=2, page_size=4, num_pages=64,
                       max_num_seqs=2)
    with pytest.raises(NotImplementedError, match="head_dim"):
        Engine(bad, device="cpu")


def test_gemma_drafter_proposes_what_jax_proposes():
    """tiny-gemma-debug drafting for itself as a separate model (the JAX
    draft engine's params, seed + 1, carried across): the same proposals
    for one history, then the same greedy streams."""
    jcfg, tcfg = family_cfgs("gemma")
    jparams = jax_params(jcfg)
    cfg = dict(SPEC, model="tiny-gemma-debug", draft_model="tiny-gemma-debug")
    jeng = JEngine(JEngineConfig(**cfg), params=jparams)
    draft = {k: np.asarray(v) for k, v in jeng.draft.params.items()}
    eng = Engine(EngineConfig(**cfg), params={k: np.asarray(v) for k, v in
                                               jparams.items()},
                 device="cpu", draft_params=draft)
    assert eng.draft.model_cfg.hidden_act == "gelu_tanh"
    props = []
    prompt = [5, 6, 7, 5, 6, 7, 5, 6, 7, 5, 6]
    for e, cls in ((eng, SeqState), (jeng, JSeqState)):
        seq = cls("r", 0, [1], prompt_len=len(prompt), max_tokens=8)
        seq.prompt_ids, seq.output_tokens = list(prompt), [3]
        props.append([e.draft.propose(seq, K), e.draft.propose(seq, 2)])
        e.draft.release(0)
    assert props[0] == props[1]
    reqs = [("a", [5, 6, 7] * 4, 12, 0), ("b", list(range(30, 45)), 10, 0)]
    assert _drive(eng, GenRequest, reqs) == _drive(jeng, JGenRequest, reqs)


# ---------------------------------------------------------- checkpoints --

TINY = PRESETS["tiny-debug"]
ARCHS = {"qwen2": "Qwen2ForCausalLM", "qwen3": "Qwen3ForCausalLM",
         "gemma": "GemmaForCausalLM"}


def write_family_checkpoint(path, family: str, seed: int = 0) -> dict:
    """A tiny HF checkpoint of `family` under `path` (one f32 safetensors
    file and its config.json) at tiny-debug's widths; the Gemma one MQA
    and tied, as tiny-gemma-debug. Returns the HF-named tensors."""
    rng = np.random.default_rng(seed)
    e, h, d, f, v, n_layers = (TINY.hidden_size, TINY.num_heads,
                               TINY.head_dim, TINY.intermediate_size,
                               TINY.vocab_size, TINY.num_layers)
    kv = 1 if family == "gemma" else TINY.num_kv_heads

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-1])).astype(
            np.float32)

    t = {"model.embed_tokens.weight": w(v, e), "model.norm.weight": w(e)}
    for i in range(n_layers):
        p = f"model.layers.{i}."
        t.update({p + "input_layernorm.weight": w(e),
                  p + "post_attention_layernorm.weight": w(e),
                  p + "self_attn.q_proj.weight": w(h * d, e),
                  p + "self_attn.k_proj.weight": w(kv * d, e),
                  p + "self_attn.v_proj.weight": w(kv * d, e),
                  p + "self_attn.o_proj.weight": w(e, h * d),
                  p + "mlp.gate_proj.weight": w(f, e),
                  p + "mlp.up_proj.weight": w(f, e),
                  p + "mlp.down_proj.weight": w(e, f)})
        if family == "qwen2":
            t.update({p + "self_attn.q_proj.bias": w(h * d),
                      p + "self_attn.k_proj.bias": w(kv * d),
                      p + "self_attn.v_proj.bias": w(kv * d)})
        if family == "qwen3":
            t.update({p + "self_attn.q_norm.weight": 1 + w(d),
                      p + "self_attn.k_norm.weight": 1 + w(d)})
    if family != "gemma":
        t["lm_head.weight"] = w(v, e)
    path.mkdir(parents=True, exist_ok=True)
    save_file(t, str(path / "model.safetensors"))
    config = {"architectures": [ARCHS[family]], "vocab_size": v,
              "hidden_size": e, "intermediate_size": f,
              "num_hidden_layers": n_layers, "num_attention_heads": h,
              "num_key_value_heads": kv, "head_dim": d,
              "rms_norm_eps": TINY.rms_norm_eps,
              "rope_theta": TINY.rope_theta,
              "max_position_embeddings": TINY.max_position_embeddings,
              "tie_word_embeddings": family == "gemma",
              "eos_token_id": TINY.eos_token_id,
              "bos_token_id": TINY.bos_token_id}
    if family == "gemma":
        config["hidden_activation"] = "gelu_pytorch_tanh"
    (path / "config.json").write_text(json.dumps(config))
    return t


@pytest.mark.parametrize("name", list(ARCHS))
def test_family_checkpoint_loads_like_jax(tmp_path, name):
    """Every port parameter equals the JAX loader's exactly; the config
    maps to the family's switches in both packages."""
    tensors = write_family_checkpoint(tmp_path, name)
    cfg = ModelConfig.from_model_name(str(tmp_path), dtype="float32")
    jcfg = JModelConfig.from_model_name(str(tmp_path), dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.attention_bias, cfg.qk_norm, cfg.embed_scale) == (
        name == "qwen2", name == "qwen3", name == "gemma")
    assert tllama.unported_model_features(cfg) == []
    files = loader.checkpoint_files(str(tmp_path))
    jtree = jloader.load_hf_safetensors(jcfg, files)
    model = loader.load_hf_safetensors(cfg, files, device="cpu",
                                       dtype=torch.float32)
    assert set(loader.param_specs(cfg)) == set(jtree)
    n = 0
    for pname, layer, owner in loader._targets(model):
        got = getattr(owner, pname)
        arr = np.asarray(jtree[pname].astype(np.float32))
        arr = arr if layer is None else arr[layer]
        assert torch.equal(got, _t(arr).reshape(got.shape)), (pname, layer)
        n += 1
    extra = {"qwen2": 3, "qwen3": 2, "gemma": 0}[name]
    assert n == 2 + (name != "gemma") + (9 + extra) * TINY.num_layers
    if name == "qwen2":
        assert torch.equal(model.layers[1].bk,
                           _t(tensors["model.layers.1.self_attn.k_proj.bias"]))
    if name == "qwen3":
        assert torch.equal(
            model.layers[0].q_norm,
            _t(tensors["model.layers.0.self_attn.q_norm.weight"]))


def test_qwen2_checkpoint_w8a8_matches_jax(tmp_path):
    """w8a8 after the load: biases and norms stay in the model dtype, the
    int8 weights are the JAX package's, and both engines serving the
    model_path give the same greedy streams."""
    write_family_checkpoint(tmp_path, "qwen2", seed=3)
    cfg = ModelConfig.from_model_name(str(tmp_path), dtype="float32")
    got = loader.load_or_init(cfg, str(tmp_path), quantization="w8a8",
                              device="cpu", dtype=torch.float32)
    layer = got.layers[0]
    assert isinstance(layer.wq, quant.QTensor) and layer.wq.a8
    for leaf in (layer.bq, layer.bk, layer.bv, layer.attn_norm,
                 got.final_norm):
        assert isinstance(leaf, torch.nn.Parameter)
        assert leaf.dtype == torch.float32
    twin = quant.with_mode(got, "int8")
    assert twin.layers[0].bq is layer.bq and twin.layers[0].wq.q is \
        layer.wq.q and not twin.layers[0].wq.a8
    jcfg = JModelConfig.from_model_name(str(tmp_path), dtype="float32")
    jq = jloader.load_or_init_params(jcfg, str(tmp_path), quantization="w8a8")
    want = loader.from_jax_params(cfg, jax.tree.map(np.asarray, jq),
                                  device="cpu", dtype=torch.float32,
                                  quantization="w8a8")
    a, b = dict(got.named_buffers()), dict(want.named_buffers())
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(want.layers[1].bv, got.layers[1].bv)
    base = dict(ENGINE, model="tiny-debug", model_path=str(tmp_path),
                prefill_chunk_tokens=32, quantization="w8a8")
    rng = np.random.default_rng(4)
    reqs = [(f"r{i}", rng.integers(0, 256, size=n).tolist(), 10, 0)
            for i, n in enumerate((6, 11, 50))]
    ref = _drive(JEngine(JEngineConfig(**base, async_scheduling=False)),
                 JGenRequest, reqs)
    eng = Engine(EngineConfig(**base), device="cpu")
    assert eng.model_cfg.attention_bias and quant.mode_of(eng.model) == "w8a8"
    assert _drive(eng, GenRequest, reqs) == ref
