"""Phi-3 in the port against the JAX package: head_dim 96 and longrope.

- The gate: all 23 presets pass `unported_model_features`, Phi-3 and a
  longrope config among them; a head_dim the kernels are not built for
  (80, 112) and an activation other than SwiGLU or GeGLU are refused by
  name.
- Attention at Phi-3's head shape (head_dim 96, MHA: group 1) with a
  sliding window of 8 (and one past the context): the port's plain
  decode, prefill, chunk, mixed (ragged), verify and mixed verify
  attention against the JAX package's XLA references, which are what the
  JAX package runs for Phi-3 (a window on every layer), on f32, bf16 and
  int8 pools. f32 and int8 pools at rtol=atol=2e-5 (float32, as
  tests/test_torch_gemma.py); bf16 pools and q against the JAX reference
  run in float32 over the same bf16 values (in bf16 it rounds scores and
  probabilities to bf16, which is its own error, not the port's), at
  rtol=atol=1e-2: the plain versions compute in f32 and round their
  output to bf16 once. Rows that see no key are left out, as in
  tests/test_torch_gemma.py: the XLA references give them the mean of V,
  the port exact zeros.
- Longrope: `apply_rope` against JAX `apply_rope` across original_max_pos
  (short factors below it, long ones at and past it) with the attention
  factor, at rtol=atol=1e-5; `longrope_attention_factor` and the model's
  longrope argument equal to JAX's.
- Models, float32 on the CPU from one JAX parameter tree carried across by
  `models.loader.from_jax_params` (norms redrawn around 1): a tiny Phi-3
  (the preset's switches at head_dim 96, 2 heads, MHA, 2 layers, a window
  of 8 on every layer, an untied head), without and with longrope (48
  short and 48 long factors from a numpy seed, original_max_pos 16, so
  that short prompts cross both the window and original_max_pos).
  Prefill, batched prefill, chunks, decode, the mixed step, the verify
  step and the mixed verify step: logits within rtol=atol=1e-4 and the
  pools within 1e-5 (tests/test_torch_gemma.py's tolerances).
- Engines: greedy streams equal to the JAX engine's token for token on
  prompts past the window and past original_max_pos: classic, chunked
  (16-token chunks with prefix caching and 4-step decode windows), mixed
  steps, and mixed steps on int8 pools.
- Checkpoints: `from_hf_config` on a Phi3ForCausalLM config.json, with and
  without longrope, gives the JAX package's ModelConfig; a fused
  `qkv_proj`/`gate_up_proj` checkpoint with longrope, written here, loads
  equal to the JAX loader's tree, and both packages' engines serve the same
  greedy streams from it.
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
BF16_TOL = dict(rtol=1e-2, atol=1e-2)  # attention, bf16 output
ROPE_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
KV_TOL = dict(rtol=1e-5, atol=1e-5)
PS = 8
K = 3  # drafts per verify window
PHI3 = "phi-3-mini-4k-instruct"
WINDOW = 8
ORIG = 16  # the tiny longrope config's original_max_pos


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


def longrope_factors(seed=0, n=48):
    """(short, long) factor tuples of n values from a numpy seed: short
    factors near 1 and long ones up to 8, as Phi-3's 128k checkpoints
    have them."""
    rng = np.random.default_rng(seed)
    return (tuple(float(x) for x in rng.uniform(1.0, 1.3, n)),
            tuple(float(x) for x in rng.uniform(1.0, 8.0, n)))


# the preset's switches at tiny widths: head_dim 96, MHA, every layer
# windowed, an untied head
TINY = dict(vocab_size=512, hidden_size=192, intermediate_size=256,
            num_layers=2, num_heads=2, num_kv_heads=2, head_dim=96,
            sliding_window=WINDOW, eos_token_id=2, bos_token_id=1,
            extra_stop_token_ids=(), dtype="float32")
LONGROPE = dict(rope_longrope_scaling=(*longrope_factors(), ORIG),
                max_position_embeddings=8 * ORIG)
CONFIGS = {"phi3": TINY, "phi3_longrope": dict(TINY, **LONGROPE)}


def model_cfgs(name):
    """(JAX ModelConfig, port ModelConfig) of a tiny Phi-3 config."""
    return (dataclasses.replace(JPRESETS[PHI3], **CONFIGS[name]),
            dataclasses.replace(PRESETS[PHI3], **CONFIGS[name]))


# ------------------------------------------------------------ the gate --


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_every_preset_passes_the_gate(name):
    assert tllama.unported_model_features(PRESETS[name]) == []


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tiny_phi3_configs_pass_the_gate(name):
    jcfg, tcfg = model_cfgs(name)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert tcfg.head_dim == 96 and tcfg.num_heads == tcfg.num_kv_heads
    assert tllama.unported_model_features(tcfg) == []


@pytest.mark.parametrize("head_dim", [80, 112])
def test_unbuilt_head_dims_are_refused_by_name(head_dim):
    cfg = dataclasses.replace(PRESETS[PHI3], head_dim=head_dim)
    assert tllama.unported_model_features(cfg) == ["head_dim"]
    with pytest.raises(NotImplementedError, match="head_dim"):
        Engine(EngineConfig(model=PHI3, page_size=PS, num_pages=16,
                            max_num_seqs=1, max_seq_len=64),
               model_cfg=cfg, device="cpu")
    with pytest.raises(ValueError, match="built for head_dim"):
        ca.tile_positions(1, head_dim)


def test_other_activations_are_refused_by_name():
    cfg = dataclasses.replace(PRESETS[PHI3], hidden_act="relu", **LONGROPE)
    assert tllama.unported_model_features(cfg) == ["hidden_act"]


def test_tile_takes_head_dim_96():
    """The kernels' host plans at Phi-3's head shape: 64 positions a query
    tile at group 1, and a verify window of K+1 rows fits it."""
    assert 96 in ca.TILE_HEAD_DIMS
    assert ca.tile_positions(1, 96) == 64
    assert ca.check_decode_rows(K + 1, 1, 96) == 64
    assert ca.chunk_spans(256, 3000, 1, 96, 32, 132) == 1
    assert ca.decode_plan(256, 16, 8, 1, 1, 32, 96, 132) == \
        ca.split_plan(256, 16, 8, 32, 132)


PHI3_HF = {
    "architectures": ["Phi3ForCausalLM"], "model_type": "phi3",
    "vocab_size": 32064, "hidden_size": 3072, "intermediate_size": 8192,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 32, "hidden_act": "silu",
    "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
    "max_position_embeddings": 4096, "sliding_window": 2047,
    "tie_word_embeddings": False, "eos_token_id": 32000, "bos_token_id": 1}
PHI3_128K_HF = dict(
    PHI3_HF, max_position_embeddings=131072, sliding_window=262144,
    original_max_position_embeddings=4096,
    rope_scaling={"type": "longrope",
                  "short_factor": list(longrope_factors(1)[0]),
                  "long_factor": list(longrope_factors(1)[1])})


@pytest.mark.parametrize("hf", [PHI3_HF, PHI3_128K_HF],
                         ids=["phi3_4k", "phi3_128k_longrope"])
def test_from_hf_config_maps_phi3_as_jax(hf):
    """Both packages read a Phi-3 config.json, with and without longrope,
    into the same ModelConfig, and the port serves it: head_dim 96 from
    3072 / 32, a window on every layer, the 48-value factor arrays."""
    got = ModelConfig.from_hf_config(hf, name="p")
    ref = JModelConfig.from_hf_config(hf, name="p")
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.head_dim == 96 and got.sliding_window_pattern == 0
    assert tllama.unported_model_features(got) == []
    if "rope_scaling" in hf:
        short, long, orig = got.rope_longrope_scaling
        assert len(short) == len(long) == 48 and orig == 4096
        assert tllama._longrope_args(got) == jllama._longrope_args(ref)


# --------------------------------------------------------------- rope --


@pytest.mark.parametrize("max_pos,orig", [(131072, 4096), (4096, 4096),
                                          (128, 16), (8, 16)])
def test_longrope_attention_factor_matches_jax(max_pos, orig):
    assert trope.longrope_attention_factor(max_pos, orig) == \
        jrope.longrope_attention_factor(max_pos, orig)


@pytest.mark.parametrize("attn_factor", [1.0, 1.3228756555322954],
                         ids=["no_factor", "factor"])
@pytest.mark.parametrize("head_dim", [96, 32])
def test_longrope_matches_jax(head_dim, attn_factor):
    """Positions on both sides of original_max_pos (16), up to the
    8192 of the card's longrope phase: the short factors below it, the
    long ones at and past it, and the attention factor on cos/sin. (Far
    larger angles leave float32 cos/sin to each library's own range
    reduction, which differ in the last bits.)"""
    rng = np.random.default_rng(6)
    short, long = longrope_factors(2, head_dim // 2)
    x = rng.normal(size=(9, 2, head_dim)).astype(np.float32)
    pos = np.array([0, 1, 15, 16, 17, 40, 1000, 4095, 8191], np.int32)
    scaling = (short, long, ORIG, attn_factor)
    ref = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4,
                           longrope_scaling=scaling)
    got = trope.apply_rope(_t(x), _t(pos), 1e4, longrope_scaling=scaling)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **ROPE_TOL)
    # below original_max_pos nothing depends on the long factors
    other = trope.apply_rope(_t(x), _t(pos), 1e4,
                             longrope_scaling=(short, short, ORIG,
                                               attn_factor))
    torch.testing.assert_close(other[:3], got[:3], rtol=0, atol=0)
    assert not torch.equal(other[3:], got[3:])


def test_model_rope_carries_longrope_as_jax():
    """The model's cos/sin of a config with longrope: the factors, the
    original context and the attention factor of JAX `_longrope_args`."""
    jcfg, tcfg = model_cfgs("phi3_longrope")
    assert tllama._longrope_args(tcfg) == jllama._longrope_args(jcfg)
    assert tllama._longrope_args(model_cfgs("phi3")[1]) is None
    pos = torch.arange(40)
    cos, sin = tllama._rope(tcfg, pos)
    want = trope.rope_cos_sin(pos, 96, tcfg.rope_theta,
                              longrope_scaling=tllama._longrope_args(tcfg))
    assert torch.equal(cos, want[0]) and torch.equal(sin, want[1])
    assert cos.shape == (40, 1, 48)


# --------------------------------------------- attention at head_dim 96 --

D, H, KVH = 96, 2, 2  # head_dim, query heads, KV heads (group 1)
WINDOWS = pytest.mark.parametrize("window", [WINDOW, 1000],
                                  ids=["w8", "wide"])
POOLS = pytest.mark.parametrize("pool", ["f32", "bf16", "int8"])


def _tol(pool):
    return BF16_TOL if pool == "bf16" else TOL


def _cast(pool, *arrays):
    """numpy f32 arrays as (JAX, torch) pairs: for a bf16 pool the port
    gets bf16 tensors and JAX the same bf16 values in float32 (its
    reference then computes in float32 as the plain versions do);
    otherwise both get the arrays as they are."""
    out = []
    for a in arrays:
        if pool == "bf16" and a.dtype == np.float32:
            b = _t(a).to(torch.bfloat16)
            out.append((jnp.asarray(b.float().numpy()), b))
        else:
            out.append((jnp.asarray(a), _t(a)))
    return out


def _pools(rng, pool, n_pool, scale=1.0):
    kf = (scale * rng.normal(size=(n_pool * PS, KVH, D))).astype(np.float32)
    vf = rng.normal(size=(n_pool * PS, KVH, D)).astype(np.float32)
    if pool != "int8":
        return (kf.reshape(n_pool, PS, KVH * D),
                vf.reshape(n_pool, PS, KVH * D))
    w = jatt.kv_lane_width(KVH, D, True)
    return tuple(np.asarray(jatt.pack_kv_rows(jnp.asarray(x), w)).reshape(
        n_pool, PS, w) for x in (kf, vf))


def _q(rng, *shape):
    return (2.0 * rng.normal(size=shape + (H, D))).astype(np.float32)


def _close(out, ref, pool):
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               **_tol(pool))


@POOLS
@WINDOWS
def test_decode_matches_xla(pool, window):
    rng = np.random.default_rng(0)
    bsz, pmax = 4, 5
    kp, vp = _pools(rng, pool, 24, scale=2.0)
    q = _q(rng, bsz)
    bt = (np.arange(bsz * pmax, dtype=np.int32).reshape(bsz, pmax) % 23) + 1
    cl = np.array([1, PS * 2 + 5, PS * pmax, 13], np.int32)
    (jq, tq), (jk, tk), (jv, tv) = _cast(pool, q, kp, vp)
    ref = jatt.paged_attention_decode_xla(
        jq, jk, jv, jnp.asarray(bt), jnp.asarray(cl), page_size=PS,
        num_kv_heads=KVH, window=jnp.int32(window))
    out = att.paged_attention_decode(tq, tk, tv, _t(bt), _t(cl),
                                     page_size=PS, num_kv_heads=KVH,
                                     window=window)
    _close(out, ref, pool)
    zero = att.paged_attention_decode(tq[:1], tk, tv, _t(bt[:1]),
                                      _t(np.zeros(1, np.int32)),
                                      page_size=PS, num_kv_heads=KVH,
                                      window=window)
    assert not zero.any()  # ctx 0 -> exact zeros


@pytest.mark.parametrize("pool", ["f32", "bf16"])
@WINDOWS
def test_prefill_matches_xla(pool, window):
    rng = np.random.default_rng(1)
    s, seq_len = 40, 29
    q = _q(rng, s)
    k = (2.0 * rng.normal(size=(s, KVH, D))).astype(np.float32)
    v = rng.normal(size=(s, KVH, D)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = _cast(pool, q, k, v)
    ref = np.asarray(jatt.prefill_attention_xla(
        jq, jk, jv, seq_len, window=jnp.int32(window)).astype(jnp.float32))
    out = att.prefill_attention(tq, tk, tv, seq_len,
                                window=window).float().numpy()
    # padding rows past seq_len + window - 1 see no key (zeros here)
    seen = min(s, seq_len + window - 1)
    np.testing.assert_allclose(out[:seen], ref[:seen], **_tol(pool))
    assert not out[seen:].any()
    batched = att.prefill_attention(
        torch.stack([tq, tq]), torch.stack([tk, tk]), torch.stack([tv, tv]),
        _t(np.array([seq_len, s], np.int32)), window=window)
    np.testing.assert_array_equal(batched[0].float().numpy(), out)


@POOLS
@WINDOWS
def test_chunk_matches_xla(pool, window):
    rng = np.random.default_rng(2)
    kp, vp = _pools(rng, pool, 12, scale=2.0)
    c, start = 16, 19
    q = _q(rng, c)
    pages = np.array([3, 7, 2, 9, 5, 0], np.int32)
    (jq, tq), (jk, tk), (jv, tv) = _cast(pool, q, kp, vp)
    ref = jatt.chunk_attention_xla(
        jq, jk, jv, jnp.asarray(pages), start, page_size=PS,
        num_kv_heads=KVH, window=jnp.int32(window))
    out = att.chunk_attention(tq, tk, tv, _t(pages), start, page_size=PS,
                              num_kv_heads=KVH, window=window)
    _close(out, ref, pool)


@POOLS
@WINDOWS
def test_mixed_matches_xla(pool, window):
    """Three decode rows beside an 11-token chunk at 13: the XLA
    composition (decode gather + chunk gather) against the ragged plain
    version over its descriptors."""
    rng = np.random.default_rng(3)
    kp, vp = _pools(rng, pool, 24, scale=2.0)
    b, c, p_start = 3, 11, 13
    q = _q(rng, b + c)
    tables = np.array([[1, 2, 3, 0], [4, 5, 6, 8], [9, 0, 0, 0]], np.int32)
    ctx = np.array([20, 31, 3], np.int32)
    p_pages = np.array([10, 11, 12, 0], np.int32)
    (jq, tq), (jk, tk), (jv, tv) = _cast(pool, q, kp, vp)
    ref = jatt.ragged_mixed_attention(
        jq, jk, jv, jnp.asarray(tables), jnp.asarray(ctx),
        jnp.asarray(p_pages), p_start, page_size=PS, num_kv_heads=KVH,
        num_decode=b, window=jnp.int32(window))
    out = att.ragged_mixed_attention(
        tq, tk, tv, _t(tables), _t(ctx), _t(p_pages), p_start, page_size=PS,
        num_kv_heads=KVH, num_decode=b, window=window)
    _close(out, ref, pool)


def _verify_inputs(rng, pool):
    kp, vp = _pools(rng, pool, 24, scale=2.0)
    q = _q(rng, 3, K + 1)
    tables = np.array([[1, 2, 3, 0], [4, 5, 6, 8], [0, 0, 0, 0]], np.int32)
    positions = np.array([11, 2 * PS + 6, 0], np.int32)
    return kp, vp, q, tables, positions


@POOLS
@WINDOWS
def test_verify_matches_xla(pool, window):
    rng = np.random.default_rng(4)
    kp, vp, q, tables, positions = _verify_inputs(rng, pool)
    (jq, tq), (jk, tk), (jv, tv) = _cast(pool, q, kp, vp)
    ref = jatt.verify_attention(
        jq, jk, jv, jnp.asarray(tables), jnp.asarray(positions),
        page_size=PS, num_kv_heads=KVH, window=jnp.int32(window))
    out = att.verify_attention(tq, tk, tv, _t(tables), _t(positions),
                               page_size=PS, num_kv_heads=KVH, window=window)
    _close(out, ref, pool)


@POOLS
@WINDOWS
def test_mixed_verify_matches_xla(pool, window):
    rng = np.random.default_rng(5)
    kp, vp, q, tables, positions = _verify_inputs(rng, pool)
    chunk = _q(rng, 9)
    p_pages = np.array([10, 11, 0, 0], np.int32)
    qq = np.concatenate([q.reshape(-1, H, D), chunk])
    (jq, tq), (jk, tk), (jv, tv) = _cast(pool, qq, kp, vp)
    ref = jatt.ragged_verify_attention(
        jq, jk, jv, jnp.asarray(tables), jnp.asarray(positions),
        jnp.asarray(p_pages), 5, page_size=PS, num_kv_heads=KVH,
        num_verify=3, verify_width=K + 1, window=jnp.int32(window))
    out = att.ragged_verify_attention(
        tq, tk, tv, _t(tables), _t(positions), _t(p_pages), 5, page_size=PS,
        num_kv_heads=KVH, num_verify=3, verify_width=K + 1, window=window)
    _close(out, ref, pool)


# ------------------------------------------------------------- models --


def jax_params(jcfg, seed=0):
    """The JAX init from PRNGKey(seed), every constant leaf (the norms)
    redrawn around its constant from a numpy seed."""
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


@pytest.fixture(scope="module", params=list(CONFIGS))
def phi3(request):
    jcfg, tcfg = model_cfgs(request.param)
    jparams = jax_params(jcfg)
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    model = loader.from_jax_params(tcfg, np_params, device="cpu",
                                   dtype=torch.float32)
    return request.param, jcfg, jparams, model


def _model_pools(cfg, seed, n_pages=16):
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, n_pages, PS, cfg.num_kv_heads * cfg.head_dim)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _pools_match(ref, tk, tv):
    np.testing.assert_allclose(tk.numpy(), np.asarray(ref.k_pages), **KV_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(ref.v_pages), **KV_TOL)


def test_phi3_layers_are_all_windowed(phi3):
    """Pattern 0: every layer has the window, none is global."""
    _, jcfg, _, model = phi3
    assert [tllama._attn_kwargs(model.cfg, l)
            for l in range(jcfg.num_layers)] == [{"window": WINDOW}] * 2
    assert model.lm_head is not None  # untied


def test_phi3_prefill_matches(phi3):
    _, jcfg, jparams, model = phi3
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


def test_phi3_prefill_batch_matches(phi3):
    _, jcfg, jparams, model = phi3
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


def test_phi3_prefill_chunks_match(phi3):
    """A 40-token prompt in 16-token chunks over a trash-padded list: the
    second chunk crosses original_max_pos."""
    _, jcfg, jparams, model = phi3
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
    """A slot below original_max_pos, one past it, and one inactive on the
    trash page."""
    tokens = rng.integers(0, jcfg.vocab_size, size=3).astype(np.int32)
    tokens[2] = 0
    positions = np.array([12, 35, 0], np.int32)
    tables = np.array([[1, 2, 3, 0, 0], [4, 5, 6, 7, 9], [0, 0, 0, 0, 0]],
                      np.int32)
    return tokens, positions, tables


def test_phi3_decode_step_matches(phi3):
    _, jcfg, jparams, model = phi3
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


def test_phi3_mixed_step_matches(phi3):
    """The decode batch beside the second 16-token chunk (9 valid, at
    original_max_pos)."""
    _, jcfg, jparams, model = phi3
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
    """Windows of K+1: one slot whose window crosses original_max_pos,
    one past it, one inactive slot on the trash page (no room)."""
    tokens = rng.integers(0, jcfg.vocab_size, size=(3, K + 1)).astype(
        np.int32)
    positions = np.array([14, 3 * PS - 2, 0], np.int32)
    tables = np.array([[1, 2, 3, 0], [4, 5, 6, 7], [0, 0, 0, 0]], np.int32)
    room = np.array([True, True, False])
    return tokens, positions, tables, room


def test_phi3_decode_verify_matches(phi3):
    _, jcfg, jparams, model = phi3
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


def test_phi3_mixed_verify_step_matches(phi3):
    _, jcfg, jparams, model = phi3
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

ENGINE = dict(model=PHI3, page_size=PS, num_pages=96, max_num_seqs=4,
              max_seq_len=256, enable_prefix_caching=False)
MODES = {
    # whole-prompt and batched prefill, one-step decode
    "classic": dict(prefill_chunk_tokens=0),
    # prompts chunked at 16, prefix hits, 4-step decode windows
    "chunked": dict(prefill_chunk_tokens=16, enable_prefix_caching=True,
                    num_scheduler_steps=4),
    # mixed steps beside live streams
    "mixed": dict(mixed_batch_tokens=16, prefill_chunk_tokens=16),
    # the same on int8 pools
    "mixed_int8": dict(mixed_batch_tokens=16, prefill_chunk_tokens=16,
                       kv_cache_dtype="int8"),
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


def _requests():
    """Prompts of 12-45 tokens against a window of 8 and original_max_pos
    16: a repetitive one, two random ones, one sharing the first one's
    24-token prefix, and a 45-token one that arrives while they decode
    (chunked, or riding mixed steps)."""
    rng = np.random.default_rng(10)
    first = rng.integers(0, 256, size=30).tolist()
    return [("a", first, 12, 0),
            ("b", [5, 6, 7] * 4, 12, 0),
            ("c", rng.integers(0, 256, size=13).tolist(), 12, 0),
            ("d", first[:24] + [9, 8, 7], 10, 4),
            ("e", rng.integers(0, 256, size=45).tolist(), 8, 3)]


@pytest.mark.parametrize("mode", list(MODES))
def test_phi3_engine_greedy_streams_match_jax(phi3, mode):
    _, jcfg, jparams, model = phi3
    reqs = _requests()
    cfg = dict(ENGINE, **MODES[mode])
    ref = _drive(JEngine(JEngineConfig(**cfg, async_scheduling=False),
                         model_cfg=jcfg, params=jparams), JGenRequest, reqs)
    eng = Engine(EngineConfig(**cfg), model_cfg=model.cfg, params=model,
                 device="cpu")
    got = _drive(eng, GenRequest, reqs)
    assert got == ref
    assert [len(got[r]) for r in "abcde"] == [12, 12, 12, 10, 8]
    if mode == "chunked":
        assert eng.prefix_cache.hits > 0  # "d" reused "a"'s prefix pages
    if "mixed" in mode:
        assert eng.metrics.mixed_count > 0


# ---------------------------------------------------------- checkpoints --


def _phi3_checkpoint(path, seed=0) -> dict:
    """A tiny Phi3ForCausalLM checkpoint with longrope (fused qkv_proj and
    gate_up_proj, an untied head) and its config.json under `path`: the
    HF tensors, [out, in]."""
    c = CONFIGS["phi3_longrope"]
    e, f, v, l = (c["hidden_size"], c["intermediate_size"], c["vocab_size"],
                  c["num_layers"])
    hd = c["num_heads"] * c["head_dim"]
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-1])).astype(
            np.float32)

    t = {"model.embed_tokens.weight": w(v, e), "model.norm.weight": 1 + w(e),
         "lm_head.weight": w(v, e)}
    for i in range(l):
        p = f"model.layers.{i}."
        t[p + "input_layernorm.weight"] = 1 + w(e)
        t[p + "post_attention_layernorm.weight"] = 1 + w(e)
        t[p + "self_attn.qkv_proj.weight"] = w(3 * hd, e)
        t[p + "self_attn.o_proj.weight"] = w(e, hd)
        t[p + "mlp.gate_up_proj.weight"] = w(2 * f, e)
        t[p + "mlp.down_proj.weight"] = w(e, f)
    path.mkdir(parents=True, exist_ok=True)
    save_file(t, str(path / "model.safetensors"))
    short, long, orig = c["rope_longrope_scaling"]
    (path / "config.json").write_text(json.dumps({
        "architectures": ["Phi3ForCausalLM"], "model_type": "phi3",
        "vocab_size": v, "hidden_size": e, "intermediate_size": f,
        "num_hidden_layers": l, "num_attention_heads": c["num_heads"],
        "num_key_value_heads": c["num_kv_heads"], "hidden_act": "silu",
        "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
        "max_position_embeddings": c["max_position_embeddings"],
        "original_max_position_embeddings": orig,
        "sliding_window": WINDOW, "tie_word_embeddings": False,
        "eos_token_id": 2, "bos_token_id": 1,
        "rope_scaling": {"type": "longrope", "short_factor": list(short),
                         "long_factor": list(long)}}))
    return t


def test_fused_longrope_checkpoint_loads_and_serves_like_jax(tmp_path):
    """The tiny longrope Phi-3 as a fused HF checkpoint: both packages
    read the same ModelConfig from its config.json, every port parameter
    equals the JAX loader's tensor exactly (q, k, v and gate, up split
    from the fused rows), and both packages' engines on its model_path
    give the same greedy streams past the window and original_max_pos."""
    tensors = _phi3_checkpoint(tmp_path)
    cfg = ModelConfig.from_model_name(str(tmp_path), dtype="float32")
    jcfg = JModelConfig.from_model_name(str(tmp_path), dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    want = model_cfgs("phi3_longrope")[1]
    assert dataclasses.replace(cfg, name=want.name,
                               extra_stop_token_ids=()) == want
    files = loader.checkpoint_files(str(tmp_path))
    jtree = jloader.load_hf_safetensors(jcfg, files)
    model = loader.load_hf_safetensors(cfg, files, device="cpu",
                                       dtype=torch.float32)
    n = 0
    for name, layer, owner in loader._targets(model):
        got = getattr(owner, name)
        arr = np.asarray(jtree[name].astype(np.float32))
        arr = arr if layer is None else arr[layer]
        assert torch.equal(got, torch.from_numpy(np.array(arr)).reshape(
            got.shape)), (name, layer)
        n += 1
    assert n == 3 + 9 * cfg.num_layers
    qkv = torch.from_numpy(tensors["model.layers.1.self_attn.qkv_proj.weight"])
    hd = cfg.num_heads * cfg.head_dim
    assert torch.equal(model.layers[1].wk, qkv[hd:2 * hd].t())
    gu = torch.from_numpy(tensors["model.layers.0.mlp.gate_up_proj.weight"])
    assert torch.equal(model.layers[0].w_gate,
                       gu[:cfg.intermediate_size].t())
    base = dict(ENGINE, model_path=str(tmp_path), prefill_chunk_tokens=16)
    reqs = _requests()[:3]
    ref = _drive(JEngine(JEngineConfig(**base, async_scheduling=False)),
                 JGenRequest, reqs)
    eng = Engine(EngineConfig(**base), device="cpu")
    assert eng.model_cfg.rope_longrope_scaling == cfg.rope_longrope_scaling
    assert _drive(eng, GenRequest, reqs) == ref
