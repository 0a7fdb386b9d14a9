"""DeepSeek-V2's multi-head latent attention (MLA) with YaRN rope in the
port, against the JAX package on the CPU.

- YaRN: `ops.rope.apply_rope` with DeepSeek-V2's scaling (mscale 0.707 on
  both sides: rotary ratio 1), with unequal mscales (a rotary magnitude
  on cos/sin) and with an explicit attention_factor, against
  `dynamo_tpu.ops.rope.apply_rope`, rtol=atol=1e-5 (float32, as
  tests/test_torch_ops.py); `yarn_get_mscale` equal.
- The MLA layer on tiny-mla-debug (float32), plain and with DeepSeek's
  YaRN tuple: `_qkv_mla` (the absorbed query, the latent row, the scale
  corrections) and `_attn_out` (W_UV, then wo) against the JAX functions,
  within 1e-5.
- Forwards of tiny-mla-debug with DeepSeek's YaRN tuple (`MLA`) from one
  JAX tree carried across by `models.loader.from_jax_params` (norms
  redrawn away from ones): prefill, batched prefill, chunks, decode, the
  mixed step, the verify step and the mixed verify step, logits within
  rtol=atol=1e-4 (two frameworks' matmul orders over two layers, as
  tests/test_torch_families.py) and the pools within 1e-5; a w8a8
  prefill from the quantized JAX tree.
- Engines: greedy streams equal to the JAX engine's, token for token:
  whole and chunked prefills with prefix-cache hits, mixed steps, int8
  KV pools (with mixed steps) and n-gram speculation.
- The plain attention versions at DeepSeek-V2's pool geometry (head_dim
  640, one KV head for 16 query heads) against the Pallas kernels in
  interpret mode (decode, prefill, chunk, the ragged kernel's chunk rows
  and verify rows; the verify step without a chunk against JAX's
  verify_attention), on f32 and int8 pools, at rtol=atol=2e-5 (float32,
  as tests/test_torch_families.py), with distinct K and V pools, as
  tests/test_mla.py holds the Pallas decode kernel.
- Weights: the MLA leaves carry across; a DeepSeek-V2-shaped HF checkpoint
  written here (interleaved rope lanes, kv_b_proj, MoE with a shared
  expert, YaRN in config.json) loads in both packages to equal
  parameters and serves the JAX engine's greedy tokens.
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
from dynamo_tpu.engine.request import GenRequest as JGenRequest
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models import loader as jloader
from dynamo_tpu.models import quant as jquant
from dynamo_tpu.models.config import PRESETS as JPRESETS
from dynamo_tpu.models.config import ModelConfig as JModelConfig
from dynamo_tpu.ops import attention as jatt
from dynamo_tpu.ops import pallas_attention as pa
from dynamo_tpu.ops import ragged_attention as ra
from dynamo_tpu.ops import rope as jrope
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import Engine
from dynamo_tpu_torch.engine.request import GenRequest
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models import loader, quant
from dynamo_tpu_torch.models.config import PRESETS, ModelConfig
from dynamo_tpu_torch.ops import attention as att
from dynamo_tpu_torch.ops import cuda_attention as ca
from dynamo_tpu_torch.ops import rope as trope

TOL = dict(rtol=1e-5, atol=1e-5)
ATT_TOL = dict(rtol=2e-5, atol=2e-5)  # attention at D = 640, float32
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
KV_TOL = dict(rtol=1e-5, atol=1e-5)
PS = 16
K = 4  # drafts per verify window
# DeepSeek-V2-Lite's rope_scaling (the preset's)
DEEPSEEK_YARN = PRESETS["deepseek-v2-lite"].rope_yarn_scaling


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


# ----------------------------------------------------------------- yarn --


@pytest.mark.parametrize("scaling", [
    DEEPSEEK_YARN,
    (40.0, 32.0, 1.0, 4096, 1.0, 0.707, -1.0),  # a rotary ratio != 1
    (4.0, 32.0, 1.0, 8192, 1.0, 0.0, 1.3),  # generic HF: attention_factor
], ids=["deepseek", "mscale_ratio", "attention_factor"])
def test_yarn_rope_matches_jax(scaling):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(9, 3, 64)).astype(np.float32)
    pos = np.array([0, 1, 5, 100, 4095, 4096, 9000, 40000, 163839],
                   np.int32)
    ref = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0,
                           yarn_scaling=scaling)
    out = trope.apply_rope(_t(x), _t(pos), 10000.0, yarn_scaling=scaling)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    for scale, ms in ((40.0, 0.707), (1.0, 0.707), (4.0, 1.0)):
        assert trope.yarn_get_mscale(scale, ms) == jrope.yarn_get_mscale(
            scale, ms)


# ------------------------------------------------------------ the layer --

MLA_CFGS = {
    "plain": lambda p: p["tiny-mla-debug"],
    "yarn": lambda p: dataclasses.replace(p["tiny-mla-debug"],
                                          rope_yarn_scaling=DEEPSEEK_YARN),
}


def mla_cfgs(variant: str = "yarn"):
    """(JAX ModelConfig, port ModelConfig) of tiny-mla-debug, float32."""
    make = MLA_CFGS[variant]
    return (dataclasses.replace(make(JPRESETS), dtype="float32"),
            dataclasses.replace(make(PRESETS), dtype="float32"))


_INIT = {}  # JAX inits by shape fields: the variants share one


def jax_params(jcfg, seed=0):
    """The JAX init from PRNGKey(seed), every constant leaf (the norms)
    redrawn around its constant from a numpy seed."""
    key = (tuple(getattr(jcfg, f) for f in tllama.SHAPE_FIELDS), seed)
    if key not in _INIT:
        _INIT[key] = jllama.init_params(jcfg, jax.random.PRNGKey(seed))
    params = _INIT[key]
    rng = np.random.default_rng(seed + 100)
    specs = jllama.param_specs(jcfg)
    out = {}
    for name, leaf in params.items():
        if specs[name][1] in ("zeros", "ones"):
            noise = rng.normal(size=leaf.shape).astype(np.float32)
            leaf = jnp.asarray(np.asarray(leaf) + 0.3 * noise)
        out[name] = leaf
    return out


def _np(params):
    return {k: np.asarray(v) for k, v in params.items()}


def _layer_tree(params, l):
    return {k: v[l] for k, v in params.items()
            if k not in ("embed", "final_norm", "lm_head")}


@pytest.mark.parametrize("variant", list(MLA_CFGS))
def test_qkv_mla_and_attn_out_match_jax(variant):
    """The absorbed query over the 40-lane latent row (tiny-mla-debug's
    32 + 8, unpadded), the row itself (K and V the same), and the output
    through W_UV and wo, at positions past YaRN's original context."""
    jcfg, tcfg = mla_cfgs(variant)
    params = jax_params(jcfg)
    model = loader.from_jax_params(tcfg, _np(params), device="cpu",
                                   dtype=torch.float32)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(6, jcfg.hidden_size)).astype(np.float32)
    pos = np.array([0, 3, 17, 4095, 5000, 30000], np.int32)
    lp = _layer_tree(params, 1)
    q, k, v = jllama._qkv_mla(jcfg, lp, jnp.asarray(x), jnp.asarray(pos))
    rope = tllama._rope(tcfg, _t(pos))
    tq, tk, tv = tllama._qkv_mla(tcfg, model.layers[1], _t(x), rope)
    assert tq.shape == (6, jcfg.num_heads, tcfg.cache_head_dim)
    assert tk.shape == (6, 1, tcfg.cache_head_dim) and tk is tv
    np.testing.assert_allclose(tq.numpy(), np.asarray(q), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(k), **TOL)
    o = rng.normal(size=(6, jcfg.num_heads, tcfg.cache_head_dim)).astype(
        np.float32)
    ref = jllama._attn_out(jcfg, lp, jnp.asarray(o))
    got = tllama._attn_out(tcfg, model.layers[1], _t(o))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_mla_is_served_and_its_shapes_are_checked():
    """DeepSeek-V2-Lite passes the feature gate (MLA and YaRN are ported)
    while Phi-3 and Gemma-2/3 are still refused; weights made under
    another ModelConfig of the same shapes run the engine's config, and
    weights of other shapes are refused."""
    for name in ("deepseek-v2-lite", "deepseek-v2-lite-chat",
                 "tiny-mla-debug"):
        assert tllama.unported_model_features(PRESETS[name]) == []
    for name in ("phi-3-mini-4k-instruct", "gemma-2-2b-it",
                 "gemma-3-1b-it"):
        assert tllama.unported_model_features(PRESETS[name])
    _, tcfg = mla_cfgs("plain")
    model = loader.init_params(tcfg, seed=0, device="cpu",
                               dtype=torch.float32)
    yarn = mla_cfgs("yarn")[1]
    assert tllama.with_config(model, yarn).cfg == yarn
    with pytest.raises(ValueError, match="kv_lora_rank"):
        tllama.with_config(model, dataclasses.replace(tcfg, kv_lora_rank=16))


# ------------------------------------------------------------ forwards --


@pytest.fixture(scope="module")
def tiny_mla():
    jcfg, tcfg = mla_cfgs()
    jparams = jax_params(jcfg)
    model = loader.from_jax_params(tcfg, _np(jparams), device="cpu",
                                   dtype=torch.float32)
    return jcfg, tcfg, jparams, model


def _model_pools(cfg, seed, n_pages=16):
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, n_pages, PS, cfg.cache_head_dim)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _pools_match(ref, tk, tv):
    np.testing.assert_allclose(tk.numpy(), np.asarray(ref.k_pages), **KV_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(ref.v_pages), **KV_TOL)


def test_mla_leaves_carry_across(tiny_mla):
    jcfg, tcfg, jparams, model = tiny_mla
    assert set(loader.param_specs(tcfg)) == set(jparams)
    assert list(loader.param_specs(tcfg)) == list(jllama.param_specs(jcfg))
    layer = model.layers[1]
    assert layer.wq is None and layer.wk is None and layer.wv is None
    np.testing.assert_array_equal(layer.w_uk.numpy(),
                                  np.asarray(jparams["w_uk"][1]))
    np.testing.assert_array_equal(layer.kv_a_norm.numpy(),
                                  np.asarray(jparams["kv_a_norm"][1]))
    np.testing.assert_array_equal(
        layer.wq_mla.numpy(),
        np.asarray(jparams["wq_mla"][1]).reshape(jcfg.hidden_size, -1))
    assert loader.num_params(tcfg) == sum(
        int(np.prod(s)) for s, _, _ in jllama.param_specs(jcfg).values())


def test_mla_prefill_matches(tiny_mla):
    jcfg, _, jparams, model = tiny_mla
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


def test_mla_prefill_batch_matches(tiny_mla):
    jcfg, _, jparams, model = tiny_mla
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


def test_mla_prefill_chunks_match(tiny_mla):
    """A 40-token prompt in 16-token chunks over a trash-padded list."""
    jcfg, _, jparams, model = tiny_mla
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


def test_mla_decode_step_matches(tiny_mla):
    jcfg, _, jparams, model = tiny_mla
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


def test_mla_mixed_step_matches(tiny_mla):
    """The decode batch beside the second 16-token chunk (9 valid)."""
    jcfg, _, jparams, model = tiny_mla
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
    tokens = rng.integers(0, jcfg.vocab_size, size=(2, K + 1)).astype(
        np.int32)
    positions = np.array([20, 35], np.int32)
    tables = np.array([[1, 2, 0], [3, 4, 9]], np.int32)
    room = np.array([True, True])
    return tokens, positions, tables, room


def test_mla_decode_verify_matches(tiny_mla):
    jcfg, _, jparams, model = tiny_mla
    kp, vp = _model_pools(jcfg, 8)
    tokens, positions, tables, room = _verify_batch(
        jcfg, np.random.default_rng(8))
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


def test_mla_mixed_verify_step_matches(tiny_mla):
    jcfg, _, jparams, model = tiny_mla
    rng = np.random.default_rng(9)
    kp, vp = _model_pools(jcfg, 9)
    tokens, positions, tables, room = _verify_batch(jcfg, rng)
    chunk = np.zeros((16,), np.int32)
    chunk[:11] = rng.integers(0, jcfg.vocab_size, size=11)
    chunk_pages = np.array([5, 6, 0], np.int32)
    ref = jllama.mixed_verify_step(
        jcfg, jparams, jnp.asarray(tokens), jnp.asarray(positions),
        jnp.asarray(tables), jnp.asarray(room), jnp.asarray(chunk),
        jnp.int32(16), jnp.int32(11), jnp.asarray(chunk_pages),
        jnp.asarray(kp), jnp.asarray(vp), page_size=PS)
    tk, tv = _t(kp), _t(vp)
    logits, chunk_logits = tllama.mixed_verify_step(
        model, _t(tokens), _t(positions), _t(tables), _t(room), _t(chunk),
        16, 11, _t(chunk_pages), tk, tv, page_size=PS)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref.logits),
                               **LOGIT_TOL)
    np.testing.assert_allclose(chunk_logits.numpy(),
                               np.asarray(ref.chunk_logits), **LOGIT_TOL)
    _pools_match(ref, tk, tv)


def test_mla_w8a8_prefill_matches(tiny_mla):
    """wq_mla and w_kv_a quantized along E (JAX QUANT_AXES), W_UK and
    W_UV left in float, as the JAX tree has them."""
    jcfg, tcfg, jparams, _ = tiny_mla
    jq = jquant.quantize_params(jparams, "w8a8")
    model = loader.from_jax_params(tcfg, jax.tree.map(np.asarray, jq),
                                   device="cpu", dtype=torch.float32,
                                   quantization="w8a8")
    layer = model.layers[0]
    assert isinstance(layer.wq_mla, quant.QTensor)
    assert isinstance(layer.w_kv_a, quant.QTensor)
    assert not isinstance(layer.w_uk, quant.QTensor)
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, jcfg.vocab_size, size=32).astype(np.int32)
    pages = np.array([3, 7], np.int32)
    kp, vp = _model_pools(jcfg, 12)
    ref = jllama.prefill(jcfg, jq, jnp.asarray(tokens), jnp.int32(30),
                         jnp.asarray(kp), jnp.asarray(vp),
                         jnp.asarray(pages), page_size=PS)
    tk, tv = _t(kp), _t(vp)
    logits = tllama.prefill(model, _t(tokens), 30, tk, tv, _t(pages),
                            page_size=PS)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref.last_logits),
                               **LOGIT_TOL)
    _pools_match(ref, tk, tv)


# ------------------------------------------------------------- engines --

ENGINE = dict(model="tiny-mla-debug", page_size=PS, num_pages=64,
              max_num_seqs=4, max_seq_len=512, enable_prefix_caching=False,
              async_scheduling=False, prefill_chunk_tokens=0)
MODES = {
    # the short prompts prefill whole, the long one in chunks of 32, and
    # its repeat hits the prefix cache
    "chunked": dict(prefill_chunk_tokens=32, enable_prefix_caching=True),
    "mixed": dict(mixed_batch_tokens=32, prefill_chunk_tokens=32),
    "mixed_int8": dict(mixed_batch_tokens=32, prefill_chunk_tokens=32,
                       kv_cache_dtype="int8"),
    "ngram": dict(speculative_mode="ngram", num_speculative_tokens=K),
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
def test_mla_engine_greedy_streams_match_jax(tiny_mla, mode):
    """Two short prompts and a repetitive one (it drafts), then a 70-token
    prompt that arrives while they decode (its chunks ride mixed steps in
    the mixed modes), and the same 70 tokens again once it has finished
    (a prefix hit in the chunked mode). Both engines run the YaRN config
    on the same weights; the port's pools are 40 lanes wide (one latent
    row), or int8 rows of 128 lanes."""
    jcfg, tcfg, jparams, model = tiny_mla
    rng = np.random.default_rng(10)
    long = rng.integers(0, 256, size=70).tolist()
    reqs = [("a", rng.integers(0, 256, size=5).tolist(), 12, 0),
            ("b", rng.integers(0, 256, size=9).tolist(), 12, 0),
            ("c", [5, 6, 7] * 4, 12, 0),
            ("d", long, 6, 3), ("e", long, 4, 40)]
    cfg = dict(ENGINE, **MODES[mode])
    ref = _drive(JEngine(JEngineConfig(**cfg), model_cfg=jcfg,
                         params=jparams), JGenRequest, reqs)
    eng = Engine(EngineConfig(**cfg), model_cfg=tcfg, params=model,
                 device="cpu")
    assert eng.kv_spec.lane_width == (128 if "int8" in mode else 40)
    got = _drive(eng, GenRequest, reqs)
    assert got == ref
    assert [len(got[r]) for r in "abcde"] == [12, 12, 12, 6, 4]
    m = eng.metrics
    if "mixed" in mode:
        assert m.mixed_count > 0
    if mode == "chunked":
        assert eng.prefix_cache.stats()["hits"] >= 1
    if mode == "ngram":
        assert m.spec_verify_steps > 0


# ----------------------------------------------- attention at D = 640 --

D, H = 640, 16  # DeepSeek-V2's padded latent row, its 16 query heads


def _pools(rng, quantized, n_pool):
    kf = rng.normal(size=(n_pool * PS, 1, D)).astype(np.float32)
    vf = rng.normal(size=(n_pool * PS, 1, D)).astype(np.float32)
    if not quantized:
        return kf.reshape(n_pool, PS, D), vf.reshape(n_pool, PS, D)
    w = jatt.kv_lane_width(1, D, True)
    return tuple(np.asarray(jatt.pack_kv_rows(jnp.asarray(x), w)).reshape(
        n_pool, PS, w) for x in (kf, vf))


POOLS = pytest.mark.parametrize("quantized", [False, True],
                                ids=["f32_pool", "int8_pool"])


def test_latent_pools_and_plans():
    """The pool geometry the kernels see: 640 lanes, 768 in int8 (640
    values, one bf16 scale, padded to 128); the tile's plan takes head_dim
    640 at group 16 (4 positions a block), and its decode rows take a
    verify window of 5 x 16 = 80 rows as two query tiles that walk the
    same key spans side by side (8 spans a row for 8 windows on 128-page
    tables on an H100)."""
    cfg = PRESETS["deepseek-v2-lite"]
    assert (cfg.cache_head_dim, cfg.cache_kv_heads) == (D, 1)
    assert att.kv_lane_width(1, D, True) == jatt.kv_lane_width(1, D, True)
    assert att.kv_lane_width(1, D, True) == 768
    assert ca.tile_positions(H, D) == 4
    assert ca.check_decode_rows(K + 1, H, D) == 4
    assert ca.latent_decode_spans(128, 16, 8, K + 1, H, 1, 132) == 8
    with pytest.raises(ValueError, match="built for head_dim"):
        ca.tile_positions(H, 40)  # tiny-mla-debug's rows: the plain path


@POOLS
def test_decode_plain_matches_pallas_at_the_latent_row(quantized):
    rng = np.random.default_rng(0)
    bsz, pmax = 2, 3
    kp, vp = _pools(rng, quantized, 8)
    q = rng.normal(size=(bsz, H, D)).astype(np.float32)
    bt = np.array([[1, 2, 3], [5, 4, 0]], np.int32)
    cl = np.array([PS * 2 + 5, PS + 3], np.int32)
    ref = pa.paged_attention_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(cl), page_size=PS, num_kv_heads=1, interpret=True)
    out = att.paged_attention_decode(_t(q), _t(kp), _t(vp), _t(bt), _t(cl),
                                     page_size=PS, num_kv_heads=1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **ATT_TOL)


def test_prefill_plain_matches_pallas_at_the_latent_row():
    rng = np.random.default_rng(1)
    s, seq_len = 32, 27
    q = rng.normal(size=(s, H, D)).astype(np.float32)
    k = rng.normal(size=(s, 1, D)).astype(np.float32)
    v = rng.normal(size=(s, 1, D)).astype(np.float32)
    ref = pa.prefill_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               seq_len, interpret=True)
    out = att.prefill_attention(_t(q), _t(k), _t(v), seq_len)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **ATT_TOL)


@POOLS
def test_chunk_plain_matches_pallas_at_the_latent_row(quantized):
    rng = np.random.default_rng(2)
    start, c = 16, 16
    kp, vp = _pools(rng, quantized, 8)
    pages = np.array([3, 1, 7, 0], np.int32)  # a trash-padded tail
    q = rng.normal(size=(c, H, D)).astype(np.float32)
    ref = pa.chunk_prefill_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pages),
        start, page_size=PS, num_kv_heads=1, interpret=True)
    out = att.chunk_attention(_t(q), _t(kp), _t(vp), _t(pages), start,
                              page_size=PS, num_kv_heads=1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **ATT_TOL)


@POOLS
@pytest.mark.parametrize("decode_q", [1, K + 1], ids=["decode_rows",
                                                      "verify_rows"])
def test_ragged_plain_matches_pallas_at_the_latent_row(quantized, decode_q):
    """Two rows beside a 16-token chunk at 16 of a 3-page list: decode
    rows (the mixed step) and verify windows of K+1 (5 x 16 = 80 tile
    rows)."""
    rng = np.random.default_rng(3)
    kp, vp = _pools(rng, quantized, 10)
    tables = np.array([[1, 2, 0], [3, 4, 5], [7, 8, 9]], np.int32)
    ctx = np.array([PS + 7, 2 * PS + 9], np.int32)
    start, c = 16, 16
    kv_lens = np.append(ctx, start + c).astype(np.int32)
    q_starts = np.append(ctx - decode_q, start).astype(np.int32)
    q = rng.normal(size=(2 * decode_q + c, H, D)).astype(np.float32)
    ref = ra.ragged_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(kv_lens), jnp.asarray(q_starts), page_size=PS,
        num_kv_heads=1, num_decode=2, decode_q=decode_q, interpret=True)
    out = att.ragged_paged_attention_ref(
        _t(q), _t(kp), _t(vp), _t(tables), _t(kv_lens), _t(q_starts),
        page_size=PS, num_kv_heads=1, num_decode=2, decode_q=decode_q)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **ATT_TOL)


@POOLS
def test_verify_only_plain_matches_jax_at_the_latent_row(quantized):
    """C = 0: the verify step's windows of K+1 alone (the ragged batch
    the kernel runs) against JAX's verify_attention."""
    rng = np.random.default_rng(4)
    k1 = K + 1
    kp, vp = _pools(rng, quantized, 10)
    tables = np.array([[1, 2, 0], [3, 4, 5]], np.int32)
    positions = np.array([PS + 2, 2 * PS + 9], np.int32)
    q = rng.normal(size=(2, k1, H, D)).astype(np.float32)
    ref = jatt.verify_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(positions), page_size=PS,
        num_kv_heads=1)
    desc = att.ragged_verify_descriptors(_t(tables), _t(positions), k1)
    out = att.ragged_paged_attention_ref(
        _t(q).reshape(2 * k1, H, D), _t(kp), _t(vp), *desc, page_size=PS,
        num_kv_heads=1, num_decode=2, decode_q=k1)
    np.testing.assert_allclose(out.reshape(q.shape).numpy(), np.asarray(ref),
                               **ATT_TOL)


# ---------------------------------------------------------- checkpoints --

CK = dict(V=256, E=64, L=2, H=4, NOPE=16, ROPE=8, R=32, VD=16, X=4, F=32)


def write_deepseek_checkpoint(path, seed: int = 0) -> dict:
    """A DeepSeek-V2-shaped HF checkpoint: MLA attention (q_proj,
    kv_a_proj_with_mqa, kv_a_layernorm, kv_b_proj, o_proj), MoE layers
    with a shared expert on every layer, YaRN in config.json."""
    c = CK
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-1])).astype(
            np.float32)

    e, h = c["E"], c["H"]
    t = {"model.embed_tokens.weight": w(c["V"], e),
         "model.norm.weight": 1 + w(e), "lm_head.weight": w(c["V"], e)}
    for i in range(c["L"]):
        p = f"model.layers.{i}."
        t[p + "input_layernorm.weight"] = 1 + w(e)
        t[p + "post_attention_layernorm.weight"] = 1 + w(e)
        a = p + "self_attn."
        t[a + "q_proj.weight"] = w(h * (c["NOPE"] + c["ROPE"]), e)
        t[a + "kv_a_proj_with_mqa.weight"] = w(c["R"] + c["ROPE"], e)
        t[a + "kv_a_layernorm.weight"] = 1 + w(c["R"])
        t[a + "kv_b_proj.weight"] = w(h * (c["NOPE"] + c["VD"]), c["R"])
        t[a + "o_proj.weight"] = w(e, h * c["VD"])
        m = p + "mlp."
        t[m + "gate.weight"] = 3 * w(c["X"], e)
        for j in range(c["X"]):
            t[m + f"experts.{j}.gate_proj.weight"] = w(c["F"], e)
            t[m + f"experts.{j}.up_proj.weight"] = w(c["F"], e)
            t[m + f"experts.{j}.down_proj.weight"] = w(e, c["F"])
        t[m + "shared_experts.gate_proj.weight"] = w(c["F"], e)
        t[m + "shared_experts.up_proj.weight"] = w(c["F"], e)
        t[m + "shared_experts.down_proj.weight"] = w(e, c["F"])
    path.mkdir(parents=True, exist_ok=True)
    save_file(t, str(path / "model.safetensors"))
    config = {"architectures": ["DeepseekV2ForCausalLM"],
              "vocab_size": c["V"], "hidden_size": e,
              "intermediate_size": 4 * c["F"], "moe_intermediate_size": c["F"],
              "num_hidden_layers": c["L"], "num_attention_heads": h,
              "num_key_value_heads": h, "kv_lora_rank": c["R"],
              "qk_nope_head_dim": c["NOPE"], "qk_rope_head_dim": c["ROPE"],
              "v_head_dim": c["VD"], "n_routed_experts": c["X"],
              "num_experts_per_tok": 2, "n_shared_experts": 1,
              "norm_topk_prob": False, "rope_theta": 10000.0,
              "rope_scaling": {"type": "yarn", "factor": 40,
                               "beta_fast": 32, "beta_slow": 1,
                               "original_max_position_embeddings": 4096,
                               "mscale": 0.707, "mscale_all_dim": 0.707},
              "rms_norm_eps": 1e-6, "max_position_embeddings": 163840,
              "tie_word_embeddings": False, "eos_token_id": 1,
              "bos_token_id": 0}
    (path / "config.json").write_text(json.dumps(config))
    return t


def test_deepseek_checkpoint_loads_like_jax(tmp_path):
    """Every port parameter equals the JAX loader's tensor exactly (the
    rope lanes de-interleaved, kv_b_proj split into W_UK and W_UV), and
    the checkpoint serves the JAX engine's greedy tokens."""
    tensors = write_deepseek_checkpoint(tmp_path)
    cfg = ModelConfig.from_model_name(str(tmp_path), dtype="float32")
    jcfg = JModelConfig.from_model_name(str(tmp_path), dtype="float32")
    assert cfg.is_mla and cfg.rope_yarn_scaling == jcfg.rope_yarn_scaling
    assert tllama.unported_model_features(cfg) == []
    files = loader.checkpoint_files(str(tmp_path))
    jtree = jloader.load_hf_safetensors(jcfg, files)
    model = loader.load_hf_safetensors(cfg, files, device="cpu",
                                       dtype=torch.float32)
    n = 0
    for name, layer, owner in loader._targets(model):
        got = getattr(owner, name)
        arr = np.asarray(jtree[name], np.float32)
        want = arr if layer is None else arr[layer]
        np.testing.assert_array_equal(got.numpy(),
                                      want.reshape(tuple(got.shape)))
        n += 1
    assert n == 3 + CK["L"] * len(loader._layer_names(cfg))
    # kv_b_proj's first head: its W_UK^T rows, then its W_UV^T rows
    b = tensors["model.layers.1.self_attn.kv_b_proj.weight"]
    nope, vd = CK["NOPE"], CK["VD"]
    np.testing.assert_array_equal(model.layers[1].w_uk[0].numpy(), b[:nope])
    np.testing.assert_array_equal(model.layers[1].w_uv[0].numpy(),
                                  b[nope:nope + vd].T)
    reqs = [("a", [3, 1, 4, 1, 5, 9, 2, 6], 6, 0)]
    kw = dict(ENGINE, model=str(tmp_path), model_path=str(tmp_path))
    ref = _drive(JEngine(JEngineConfig(**kw)), JGenRequest, reqs)
    got = _drive(Engine(EngineConfig(**kw), device="cpu"), GenRequest, reqs)
    assert got == ref
