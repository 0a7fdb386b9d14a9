"""Gemma-2 and Gemma-3 in the port against the JAX package.

- Attention with a sliding window and a tanh logit cap: the port's plain
  decode, prefill, chunk, mixed (ragged), verify and mixed verify
  attention against the JAX package's XLA references, which are what the
  JAX package runs for windowed or capped layers, for window in {0, 1, 5,
  past the context} and cap in {0, 50}, on f32 and int8 pools, at
  rtol=atol=2e-5 (float32, as tests/test_torch_families.py). Rows that
  see no key are left out of the comparison: the XLA references give
  them the mean of V (a finfo.min mask), the port exact zeros (the
  kernels' contract), which the port's own rows are checked for.
- Models, float32 on the CPU from one JAX parameter tree carried across by
  `models.loader.from_jax_params` (norm weights, post norms among them,
  redrawn around their constants): tiny-gemma2-debug (window 8 on layer 0,
  caps 50 and 30, query_pre_attn_scalar 64 against head_dim 32) and
  tiny-gemma3-debug (window 8 on layers 0-1, pattern 3, local theta 10k,
  global positions scaled by 8, qk norms). Prefill, batched prefill,
  chunks, decode, the mixed step, the verify step and the mixed verify
  step at contexts past the window: logits within rtol=atol=1e-4 and the
  pools within 1e-5 (tests/test_torch_families.py's Gemma-1 tolerances).
- Engines: greedy streams equal to the JAX engine's token for token on
  prompts longer than the window, classic, chunked with prefix caching and
  4-step decode windows, mixed steps on int8 pools, and n-gram
  speculation beside mixed steps.
- The gate: every Gemma-2/3 preset is served, as is Phi-3, refused only
  at a head_dim the kernels are not built for; HF Gemma-2/3 configs (and
  Gemma-3's multimodal wrapper) map to the JAX package's ModelConfig.
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
from dynamo_tpu.models.config import ModelConfig as JModelConfig
from dynamo_tpu.ops import attention as jatt
from dynamo_tpu.ops import rope as jrope
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import Engine
from dynamo_tpu_torch.engine.request import GenRequest
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models import loader
from dynamo_tpu_torch.models.config import PRESETS, ModelConfig
from dynamo_tpu_torch.ops import attention as att
from dynamo_tpu_torch.ops import cuda_attention as ca
from dynamo_tpu_torch.ops import rope as trope

TOL = dict(rtol=2e-5, atol=2e-5)  # attention, float32
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
KV_TOL = dict(rtol=1e-5, atol=1e-5)
PS = 8
K = 3  # drafts per verify window

GEMMA_PRESETS = ("gemma-2-2b-it", "gemma-2-9b-it", "gemma-3-1b-it",
                 "gemma-3-4b-it", "tiny-gemma2-debug", "tiny-gemma3-debug")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module: the parallel test workers share
    the cores (as tests/test_torch_families.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ the gate --


@pytest.mark.parametrize("name", GEMMA_PRESETS)
def test_gemma_presets_pass_the_gate(name):
    assert tllama.unported_model_features(PRESETS[name]) == []


def test_phi3_is_refused_for_its_head_dim():
    """Phi-3 is served since its head_dim 96 was ported; at a head_dim
    the kernels are not built for (80) it is refused, by name."""
    phi3 = PRESETS["phi-3-mini-4k-instruct"]
    assert tllama.unported_model_features(phi3) == []
    assert tllama.unported_model_features(
        dataclasses.replace(phi3, head_dim=80)) == ["head_dim"]


GEMMA2_HF = {
    "architectures": ["Gemma2ForCausalLM"], "model_type": "gemma2",
    "vocab_size": 256000, "hidden_size": 3584, "intermediate_size": 14336,
    "num_hidden_layers": 42, "num_attention_heads": 16,
    "num_key_value_heads": 8, "head_dim": 256,
    "hidden_activation": "gelu_pytorch_tanh", "rms_norm_eps": 1e-6,
    "rope_theta": 10000.0, "max_position_embeddings": 8192,
    "sliding_window": 4096, "attn_logit_softcapping": 50.0,
    "final_logit_softcapping": 30.0, "query_pre_attn_scalar": 256,
    "eos_token_id": 1, "bos_token_id": 2}
GEMMA3_HF = {
    "architectures": ["Gemma3ForCausalLM"], "model_type": "gemma3_text",
    "vocab_size": 262208, "hidden_size": 2560, "intermediate_size": 10240,
    "num_hidden_layers": 34, "num_attention_heads": 8,
    "num_key_value_heads": 4, "head_dim": 256,
    "hidden_activation": "gelu_pytorch_tanh", "rms_norm_eps": 1e-6,
    "rope_theta": 1000000.0, "rope_local_base_freq": 10000.0,
    "rope_scaling": {"rope_type": "linear", "factor": 8.0},
    "max_position_embeddings": 131072, "sliding_window": 1024,
    "sliding_window_pattern": 6, "query_pre_attn_scalar": 256,
    "eos_token_id": 1, "bos_token_id": 2}
WRAPPED_HF = {"architectures": ["Gemma3ForConditionalGeneration"],
              "model_type": "gemma3",
              "text_config": {k: v for k, v in GEMMA3_HF.items()
                              if k != "architectures"}}


@pytest.mark.parametrize("hf", [GEMMA2_HF, GEMMA3_HF, WRAPPED_HF],
                         ids=["gemma2", "gemma3", "gemma3_wrapper"])
def test_from_hf_config_maps_gemma_as_jax(hf):
    """Both packages read a Gemma-2, a Gemma-3 and the Gemma-3 multimodal
    wrapper's text config into the same ModelConfig, and the port serves
    it."""
    got = ModelConfig.from_hf_config(hf, name="g")
    ref = JModelConfig.from_hf_config(hf, name="g")
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.post_norms and got.sliding_window > 0
    assert tllama.unported_model_features(got) == []


# --------------------------------------------------- windowed attention --

D, H, KVH = 32, 4, 2  # head_dim, query heads, KV heads (group 2)
WINDOWS = pytest.mark.parametrize("window", [0, 1, 5, 1000],
                                  ids=["w0", "w1", "w5", "wide"])
CAPS = pytest.mark.parametrize("cap", [0.0, 50.0], ids=["nocap", "cap50"])
POOLS = pytest.mark.parametrize("quantized", [False, True],
                                ids=["f32_pool", "int8_pool"])


def _pools(rng, quantized, n_pool, scale=1.0):
    kf = (scale * rng.normal(size=(n_pool * PS, KVH, D))).astype(np.float32)
    vf = rng.normal(size=(n_pool * PS, KVH, D)).astype(np.float32)
    if not quantized:
        return (kf.reshape(n_pool, PS, KVH * D),
                vf.reshape(n_pool, PS, KVH * D))
    w = jatt.kv_lane_width(KVH, D, True)
    return tuple(np.asarray(jatt.pack_kv_rows(jnp.asarray(x), w)).reshape(
        n_pool, PS, w) for x in (kf, vf))


def _q(rng, *shape):
    # scores of a few units, so that the cap at 50 bends the large ones
    return (4.0 * rng.normal(size=shape + (H, D))).astype(np.float32)


def _jkw(window, cap):
    return dict(window=jnp.int32(window), logit_cap=cap)


@POOLS
@WINDOWS
@CAPS
def test_decode_matches_xla(quantized, window, cap):
    rng = np.random.default_rng(0)
    bsz, pmax = 4, 5
    kp, vp = _pools(rng, quantized, 24, scale=3.0)
    q = _q(rng, bsz)
    bt = (np.arange(bsz * pmax, dtype=np.int32).reshape(bsz, pmax) % 23) + 1
    cl = np.array([1, PS * 2 + 5, PS * pmax, 13], np.int32)
    ref = jatt.paged_attention_decode_xla(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(cl), page_size=PS, num_kv_heads=KVH, **_jkw(window, cap))
    out = att.paged_attention_decode(_t(q), _t(kp), _t(vp), _t(bt), _t(cl),
                                     page_size=PS, num_kv_heads=KVH,
                                     window=window, logit_cap=cap)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    zero = att.paged_attention_decode(_t(q[:1]), _t(kp), _t(vp), _t(bt[:1]),
                                      _t(np.zeros(1, np.int32)),
                                      page_size=PS, num_kv_heads=KVH,
                                      window=window, logit_cap=cap)
    assert not zero.any()  # ctx 0 -> exact zeros


@WINDOWS
@CAPS
def test_prefill_matches_xla(window, cap):
    rng = np.random.default_rng(1)
    s, seq_len = 40, 29
    q = _q(rng, s)
    k = (3.0 * rng.normal(size=(s, KVH, D))).astype(np.float32)
    v = rng.normal(size=(s, KVH, D)).astype(np.float32)
    ref = np.asarray(jatt.prefill_attention_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), seq_len,
        **_jkw(window, cap)))
    out = att.prefill_attention(_t(q), _t(k), _t(v), seq_len, window=window,
                                logit_cap=cap).numpy()
    # padding rows past seq_len + window - 1 see no key (zeros here)
    seen = s if not window else min(s, seq_len + window - 1)
    np.testing.assert_allclose(out[:seen], ref[:seen], **TOL)
    assert not out[seen:].any()
    batched = att.prefill_attention(
        _t(np.stack([q, q])), _t(np.stack([k, k])), _t(np.stack([v, v])),
        _t(np.array([seq_len, s], np.int32)), window=window, logit_cap=cap)
    np.testing.assert_array_equal(batched[0].numpy(), out)


@POOLS
@WINDOWS
@CAPS
def test_chunk_matches_xla(quantized, window, cap):
    rng = np.random.default_rng(2)
    kp, vp = _pools(rng, quantized, 12, scale=3.0)
    c, start = 16, 19
    q = _q(rng, c)
    pages = np.array([3, 7, 2, 9, 5, 0], np.int32)
    ref = jatt.chunk_attention_xla(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pages),
        start, page_size=PS, num_kv_heads=KVH, **_jkw(window, cap))
    out = att.chunk_attention(_t(q), _t(kp), _t(vp), _t(pages), start,
                              page_size=PS, num_kv_heads=KVH, window=window,
                              logit_cap=cap)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@POOLS
@WINDOWS
@CAPS
def test_mixed_matches_xla(quantized, window, cap):
    """Three decode rows beside an 11-token chunk at 13: the XLA
    composition (decode gather + chunk gather) against the ragged plain
    version over its descriptors."""
    rng = np.random.default_rng(3)
    kp, vp = _pools(rng, quantized, 24, scale=3.0)
    b, c, p_start = 3, 11, 13
    q = _q(rng, b + c)
    tables = np.array([[1, 2, 3, 0], [4, 5, 6, 8], [9, 0, 0, 0]], np.int32)
    ctx = np.array([20, 31, 3], np.int32)
    p_pages = np.array([10, 11, 12, 0], np.int32)
    ref = jatt.ragged_mixed_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(ctx), jnp.asarray(p_pages), p_start, page_size=PS,
        num_kv_heads=KVH, num_decode=b, **_jkw(window, cap))
    out = att.ragged_mixed_attention(
        _t(q), _t(kp), _t(vp), _t(tables), _t(ctx), _t(p_pages), p_start,
        page_size=PS, num_kv_heads=KVH, num_decode=b, window=window,
        logit_cap=cap)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _verify_inputs(rng, quantized):
    kp, vp = _pools(rng, quantized, 24, scale=3.0)
    q = _q(rng, 3, K + 1)
    tables = np.array([[1, 2, 3, 0], [4, 5, 6, 8], [0, 0, 0, 0]], np.int32)
    positions = np.array([11, 2 * PS + 6, 0], np.int32)
    return kp, vp, q, tables, positions


@POOLS
@WINDOWS
@CAPS
def test_verify_matches_xla(quantized, window, cap):
    rng = np.random.default_rng(4)
    kp, vp, q, tables, positions = _verify_inputs(rng, quantized)
    ref = jatt.verify_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(positions), page_size=PS, num_kv_heads=KVH,
        **_jkw(window, cap))
    out = att.verify_attention(_t(q), _t(kp), _t(vp), _t(tables),
                               _t(positions), page_size=PS, num_kv_heads=KVH,
                               window=window, logit_cap=cap)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@POOLS
@WINDOWS
@CAPS
def test_mixed_verify_matches_xla(quantized, window, cap):
    rng = np.random.default_rng(5)
    kp, vp, q, tables, positions = _verify_inputs(rng, quantized)
    chunk = _q(rng, 9)
    p_pages = np.array([10, 11, 0, 0], np.int32)
    qq = np.concatenate([q.reshape(-1, H, D), chunk])
    ref = jatt.ragged_verify_attention(
        jnp.asarray(qq), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(positions), jnp.asarray(p_pages), 5,
        page_size=PS, num_kv_heads=KVH, num_verify=3, verify_width=K + 1,
        **_jkw(window, cap))
    out = att.ragged_verify_attention(
        _t(qq), _t(kp), _t(vp), _t(tables), _t(positions), _t(p_pages), 5,
        page_size=PS, num_kv_heads=KVH, num_verify=3, verify_width=K + 1,
        window=window, logit_cap=cap)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_latent_rows_refuse_window_and_cap():
    """The kernels' wrappers check the modifiers before they touch the
    card: the latent tile (head_dim 640) takes neither, and negative ones
    are refused."""
    assert ca.score_mods(4096, 50.0, 256) == (4096, 50.0, ["window", "cap"])
    assert ca.score_mods(0, 0.0, 640) == (0, 0.0, [])
    for window, cap in ((8, 0.0), (0, 30.0)):
        with pytest.raises(ValueError, match="latent"):
            ca.score_mods(window, cap, ca.LATENT_DIM)
    with pytest.raises(ValueError, match=">= 0"):
        ca.score_mods(-1, 0.0, 256)


# -------------------------------------------------------------- rope --


def test_linear_position_scale_matches_jax():
    """Gemma-3's global rope: float positions divided by the factor (JAX
    apply_rope over positions / scale)."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(5, 2, D)).astype(np.float32)
    pos = np.array([0, 3, 17, 1000, 30000], np.int32)
    ref = jrope.apply_rope(jnp.asarray(x),
                           jnp.asarray(pos).astype(jnp.float32) / 8.0, 1e6)
    got = trope.apply_rope(_t(x), _t(pos), 1e6, position_scale=8.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------------- models --

MODELS = ("tiny-gemma2-debug", "tiny-gemma3-debug")


def model_cfgs(name):
    """(JAX ModelConfig, port ModelConfig), float32."""
    return (dataclasses.replace(JPRESETS[name], dtype="float32"),
            dataclasses.replace(PRESETS[name], dtype="float32"))


def jax_params(jcfg, seed=0):
    """The JAX init from PRNGKey(seed), every constant leaf (norms, the
    post norms among them) redrawn around its constant from a numpy
    seed."""
    params = jllama.init_params(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 100)
    specs = jllama.param_specs(jcfg)
    out = {}
    for name, leaf in params.items():
        if specs[name][1] in ("zeros", "ones"):
            noise = rng.normal(size=leaf.shape).astype(np.float32)
            leaf = jnp.asarray(np.asarray(leaf) + 0.3 * noise)
        out[name] = leaf
    return out


@pytest.fixture(scope="module", params=MODELS)
def gemma(request):
    jcfg, tcfg = model_cfgs(request.param)
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


def test_gemma_leaves_and_layers(gemma):
    """The sandwich norms carry across, and each layer's window and rope
    follow JAX's one local/global predicate."""
    name, jcfg, _, np_params, model = gemma
    assert set(loader.param_specs(model.cfg)) == set(np_params)
    np.testing.assert_array_equal(model.layers[1].post_mlp_norm.numpy(),
                                  np_params["post_mlp_norm"][1])
    ps = 4  # pages per layer of a flat JAX pool
    for l in range(jcfg.num_layers):
        jkw = jllama._attn_kwargs(jcfg, jnp.int32(l * ps), ps)
        tkw = tllama._attn_kwargs(model.cfg, l)
        assert tkw["window"] == int(jkw["window"])
        assert tkw.get("logit_cap", 0.0) == jkw.get("logit_cap", 0.0)
        assert tllama._is_global_layer(model.cfg, l) == bool(
            jllama._is_global_layer(jcfg, jnp.int32(l * ps), ps))
    windows = [tllama._attn_kwargs(model.cfg, l)["window"]
               for l in range(jcfg.num_layers)]
    assert windows == ([8, 0] if name == "tiny-gemma2-debug" else [8, 8, 0])


def test_gemma_prefill_matches(gemma):
    _, jcfg, jparams, _, model = gemma
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab_size, size=32).astype(np.int32)
    pages = np.array([3, 7, 1, 2], np.int32)
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


def test_gemma_prefill_batch_matches(gemma):
    _, jcfg, jparams, _, model = gemma
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, jcfg.vocab_size, size=(2, 32)).astype(np.int32)
    # lane 1's padding rows stay within the window of a real key (a row
    # that sees none differs by contract, see the module docstring)
    seq_lens = np.array([32, 26], np.int32)
    tokens[1, 26:] = 0
    pages = np.array([[1, 2, 3, 4], [5, 6, 8, 0]], np.int32)
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


def test_gemma_prefill_chunks_match(gemma):
    """A 40-token prompt in 16-token chunks over a trash-padded list."""
    _, jcfg, jparams, _, model = gemma
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, jcfg.vocab_size, size=40).astype(np.int32)
    pages = np.array([5, 6, 8, 9, 10, 11, 0, 0], np.int32)
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
    """Two live slots past the window, one inactive on the trash page."""
    tokens = rng.integers(0, jcfg.vocab_size, size=3).astype(np.int32)
    tokens[2] = 0
    positions = np.array([20, 35, 0], np.int32)
    tables = np.array([[1, 2, 3, 0, 0], [4, 5, 6, 7, 9], [0, 0, 0, 0, 0]],
                      np.int32)
    return tokens, positions, tables


def test_gemma_decode_step_matches(gemma):
    _, jcfg, jparams, _, model = gemma
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


def test_gemma_mixed_step_matches(gemma):
    """The decode batch beside the second 16-token chunk (9 valid)."""
    _, jcfg, jparams, _, model = gemma
    rng = np.random.default_rng(7)
    kp, vp = _model_pools(jcfg, 7)
    tokens, positions, tables = _decode_batch(jcfg, rng)
    ctx = positions + 1
    chunk = np.zeros((16,), np.int32)
    chunk[:9] = rng.integers(0, jcfg.vocab_size, size=9)
    chunk_pages = np.array([10, 11, 12, 13, 0], np.int32)
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
    """Windows of K+1: two live slots with room past the window, one
    inactive slot on the trash page (position 0, no room)."""
    tokens = rng.integers(0, jcfg.vocab_size, size=(3, K + 1)).astype(
        np.int32)
    positions = np.array([12, 3 * PS - 2, 0], np.int32)
    tables = np.array([[1, 2, 3, 0], [4, 5, 6, 7], [0, 0, 0, 0]], np.int32)
    room = np.array([True, True, False])
    return tokens, positions, tables, room


def test_gemma_decode_verify_matches(gemma):
    _, jcfg, jparams, _, model = gemma
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


def test_gemma_mixed_verify_step_matches(gemma):
    _, jcfg, jparams, _, model = gemma
    rng = np.random.default_rng(9)
    kp, vp = _model_pools(jcfg, 9)
    tokens, positions, tables, room = _verify_batch(jcfg, rng)
    chunk = np.zeros((16,), np.int32)
    chunk[:9] = rng.integers(0, jcfg.vocab_size, size=9)
    chunk_pages = np.array([10, 11, 12, 0], np.int32)
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

ENGINE = dict(page_size=PS, num_pages=96, max_num_seqs=4, max_seq_len=256,
              enable_prefix_caching=False)
MODES = {
    # whole-prompt and batched prefill, one-step decode
    "classic": dict(prefill_chunk_tokens=0),
    # prompts chunked at 16, prefix hits, 4-step decode windows
    "chunked_prefix_windows": dict(prefill_chunk_tokens=16,
                                   enable_prefix_caching=True,
                                   num_scheduler_steps=4),
    # mixed steps beside live streams on int8 pools
    "mixed_int8": dict(mixed_batch_tokens=16, prefill_chunk_tokens=16,
                       kv_cache_dtype="int8"),
    # n-gram verify windows, alone and riding mixed steps
    "mixed_ngram": dict(mixed_batch_tokens=16, prefill_chunk_tokens=16,
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
def test_gemma_engine_greedy_streams_match_jax(gemma, mode):
    """Prompts of 12-45 tokens against a window of 8: a repetitive one
    (it drafts), two random ones, one that shares the first one's 24-token
    prefix, and a 45-token one that arrives while they decode (chunked,
    or riding mixed steps)."""
    name, jcfg, jparams, np_params, model = gemma
    _, tcfg = model_cfgs(name)
    rng = np.random.default_rng(10)
    first = rng.integers(0, 256, size=30).tolist()
    reqs = [("a", first, 12, 0),
            ("b", [5, 6, 7] * 4, 12, 0),
            ("c", rng.integers(0, 256, size=13).tolist(), 12, 0),
            ("d", first[:24] + [9, 8, 7], 10, 4),
            ("e", rng.integers(0, 256, size=45).tolist(), 8, 3)]
    cfg = dict(ENGINE, model=PRESETS[name].name, **MODES[mode])
    ref = _drive(JEngine(JEngineConfig(**cfg, async_scheduling=False),
                         model_cfg=jcfg, params=jparams), JGenRequest, reqs)
    eng = Engine(EngineConfig(**cfg), model_cfg=tcfg, params=model,
                 device="cpu")
    got = _drive(eng, GenRequest, reqs)
    assert got == ref
    assert [len(got[r]) for r in "abcde"] == [12, 12, 12, 10, 8]
    if "prefix" in mode:
        assert eng.prefix_cache.hits > 0  # "d" reused "a"'s prefix pages
    if "ngram" in mode:
        assert eng.metrics.spec_verify_steps > 0
    if "mixed" in mode:
        assert eng.metrics.mixed_count + eng.metrics.mixed_spec_count > 0
