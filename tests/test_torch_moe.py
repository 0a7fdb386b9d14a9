"""The mixture-of-experts path of the port against the JAX package.

- Ops (`dynamo_tpu_torch.ops.moe` against `dynamo_tpu.ops.moe`), float32
  from seeded numpy inputs: the top-k combine matrix (renormalised, and
  the global softmax's probabilities with a scaling factor), exact ties
  (lower index first, as `jax.lax.top_k`), the dense dispatch, the
  static capacity, and the capacity dispatch at full capacity and at a
  capacity that drops tokens, within rtol=atol=1e-5.
- Quantized expert stacks: the port's expert products on the same int8
  bytes and scales as JAX `quant.einsum` at the MoE call sites
  ("te,xef->txf", "txf,xfe->txe", "xce,xef->xcf"), weight-only int8 and
  W8A8, within rtol=1e-5, atol=1e-4; the bytes `quantize_params` makes
  for an expert stack equal JAX's.
- The MoE block (`_mlp`) of tiny-moe-debug with a padding mask, capacity
  off and on (a capacity that cuts rows, and one that drops tokens), and
  of a tiny config with one shared expert, `norm_topk_prob=False` and
  `routed_scaling_factor=2.5`, within 1e-5.
- tiny-moe-debug's forwards (prefill with and without the capacity path,
  batched prefill, chunks, decode, the mixed step, the verify step, the
  mixed verify step) from one JAX tree carried across by
  `models.loader.from_jax_params` (the router redrawn at sigma 0.3, so
  that routing is decisive), logits within rtol=atol=1e-4 and pools
  within 1e-5, as tests/test_torch_families.py; and a w8a8 and an int8
  prefill from a quantized JAX tree.
- Engines: greedy streams of tiny-moe-debug equal to the JAX engine's,
  token for token: windows of 4 steps without graphs, mixed steps,
  prefix-cache hits, n-gram speculation and `moe_capacity_factor=1.25`.
- Checkpoints: tiny MoE checkpoints in Mixtral's and Qwen3-MoE's HF
  layouts (the latter with a shared expert) load in both packages to
  equal parameters.
- `num_params` of qwen3-30b-a3b and mixtral-8x7b-instruct-v0.1 equals
  the count from the JAX `param_specs`, without allocating the model.
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
from dynamo_tpu.ops import moe as jmoe
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import Engine
from dynamo_tpu_torch.engine.request import GenRequest
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models import loader, quant
from dynamo_tpu_torch.models.config import PRESETS, ModelConfig
from dynamo_tpu_torch.ops import moe

TOL = dict(rtol=1e-5, atol=1e-5)
QTOL = dict(rtol=1e-5, atol=1e-4)
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


def _experts(rng, x=4, e=32, f=16):
    """Expert stacks (gate, up [X, E, F], down [X, F, E]) in numpy."""
    def w(*shape):
        return (rng.normal(size=shape) / np.sqrt(shape[-2])).astype(
            np.float32)
    return w(x, e, f), w(x, e, f), w(x, f, e)


def _port_stack(w):
    """A numpy expert stack in the port's layout."""
    return quant.operand_layout(_t(w))


# ------------------------------------------------------------------ ops --


@pytest.mark.parametrize("renormalize,scaling", [(True, 1.0), (False, 2.5)],
                         ids=["renormalised", "global_scaled"])
def test_topk_combine_matches_jax(renormalize, scaling):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(24, 8)).astype(np.float32)
    ref = jmoe.topk_combine(jnp.asarray(logits), 3, jnp.float32,
                            renormalize=renormalize, scaling_factor=scaling)
    got = moe.topk_combine(_t(logits), 3, torch.float32,
                           renormalize=renormalize, scaling_factor=scaling)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert ((got != 0).sum(-1) == 3).all()


def test_top_k_keeps_the_lower_index_first_among_ties():
    """Exact ties, as bf16 router logits give often: the same experts as
    jax.lax.top_k, and the capacity path's zero weights in its order."""
    v = np.array([[1.0, 2.0, 2.0, 0.5, 2.0],
                  [0.0, 0.0, 0.0, 0.0, 0.0],
                  [3.0, 1.0, 3.0, 1.0, 1.0]], np.float32)
    for k in (1, 2, 3, 4):
        rv, ri = jax.lax.top_k(jnp.asarray(v), k)
        gv, gi = moe.top_k(_t(v), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))


DISPATCH = [("dense", None), ("dropping_full", 32), ("dropping_drops", 8)]


@pytest.mark.parametrize("path,capacity", DISPATCH,
                         ids=[d[0] for d in DISPATCH])
def test_moe_dispatch_matches_jax(path, capacity):
    """32 tokens over 4 experts, top 2, three tokens masked out of the
    combine matrix (padding rows: they must come out exactly 0 in the
    capacity path, whose zero-weight slots add nothing)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(32, 32)).astype(np.float32)
    wg, wu, wd = _experts(rng)
    logits = rng.normal(size=(32, 4)).astype(np.float32)
    combine = np.array(jmoe.topk_combine(jnp.asarray(logits), 2,
                                         jnp.float32))
    combine[-3:] = 0.0
    jargs = [jnp.asarray(a) for a in (x, combine, wg, wu, wd)]
    targs = [_t(x), _t(combine)] + [_port_stack(w) for w in (wg, wu, wd)]
    if capacity is None:
        ref = jmoe.moe_mlp_dense(*jargs)
        got = moe.moe_mlp_dense(*targs)
    else:
        ref = jmoe.moe_mlp_dropping(*jargs, capacity=capacity)
        got = moe.moe_mlp_dropping(*targs, capacity=capacity)
        assert not got[-3:].any()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    if path == "dropping_drops":  # some token lost an expert
        dense = moe.moe_mlp_dense(*targs)
        assert not torch.allclose(got, dense, **TOL)


@pytest.mark.parametrize("k", [3, None], ids=["top3", "every_expert"])
def test_capacity_combine_sums_like_jax(k):
    """The capacity path's ordered add-back (each token's expert outputs
    summed in expert order, as XLA's scatter-add walks the slots) against
    `dynamo_tpu.ops.moe.moe_mlp_dropping`: 64 tokens over 8 experts, top
    3, a capacity of 16 that drops tokens, within 1e-5 (float32); and the
    same bits whether the sum gathers each token's k routed experts or
    all X (the zero slots add exact zeros)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(64, 32)).astype(np.float32)
    wg, wu, wd = _experts(rng, x=8)
    logits = rng.normal(size=(64, 8)).astype(np.float32)
    combine = np.array(jmoe.topk_combine(jnp.asarray(logits), 3,
                                         jnp.float32))
    combine[-2:] = 0.0  # padding rows
    ref = jmoe.moe_mlp_dropping(*[jnp.asarray(a) for a in (
        x, combine, wg, wu, wd)], capacity=16)
    targs = [_t(x), _t(combine)] + [_port_stack(w) for w in (wg, wu, wd)]
    got = moe.moe_mlp_dropping(*targs, capacity=16, k=k)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert torch.equal(got, moe.moe_mlp_dropping(*targs, capacity=16))
    assert not got[-2:].any()


@pytest.mark.parametrize("t,x,k,cf", [(32, 4, 2, 1.25), (1024, 128, 8, 1.25),
                                      (1024, 8, 2, 1.25), (16, 4, 2, 1.25),
                                      (256, 128, 8, 0.5), (7, 8, 2, 1.0)])
def test_expert_capacity_matches_jax(t, x, k, cf):
    want = jmoe.expert_capacity(t, x, k, cf)
    assert moe.expert_capacity(t, x, k, cf) == want
    assert want <= t and (want % 8 == 0 or want == t)


# --------------------------------------------------- quantized experts --

QSPECS = ["te,xef->txf", "txf,xfe->txe", "xce,xef->xcf"]


@pytest.mark.parametrize("mode", ["int8", "w8a8"])
@pytest.mark.parametrize("spec", QSPECS)
def test_quantized_expert_products_match_jax_einsum(mode, spec):
    """The same int8 bytes and scales (JAX `quant.quantize` over the
    contracted axis, one scale per expert and output channel) through
    the JAX einsum and the port's expert product."""
    rng = np.random.default_rng(2)
    x, e, f, t = 4, 32, 16, 24
    wg, _, wd = _experts(rng, x, e, f)
    w = wd if spec == "txf,xfe->txe" else wg
    jw = jquant.quantize(jnp.asarray(w), (1,), jquant.qtensor_class(mode))
    tw = quant.QTensor(quant.operand_layout(_t(jw.q)), _t(jw.scale), mode)
    if spec == "te,xef->txf":
        a = rng.normal(size=(t, e)).astype(np.float32)
        got = quant.expert_rows(_t(a), tw)
    elif spec == "txf,xfe->txe":
        a = rng.normal(size=(t, x, f)).astype(np.float32)
        got = quant.expert_batch(_t(a).transpose(0, 1), tw).transpose(0, 1)
    else:
        a = rng.normal(size=(x, t, e)).astype(np.float32)
        a[2, 5] = 0.0  # an all-zero row: scale 1, as JAX
        got = quant.expert_batch(_t(a), tw)
    ref = jquant.einsum(spec, jnp.asarray(a), jw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **QTOL)


@pytest.mark.parametrize("mode", ["int8", "w8a8"])
def test_quantized_stacks_are_the_jax_bytes(mode):
    """`quantize_params` on a carried float tree: every expert stack's
    int8 values and scales equal JAX `quantize_params`' for that layer,
    q stored in the operand layout; the router stays a float weight."""
    jcfg, tcfg = moe_cfgs()
    params = jax_params(jcfg)
    jq = jquant.quantize_params(params, mode)
    model = loader.from_jax_params(tcfg, _np(params), device="cpu",
                                   dtype=torch.float32, quantization=mode)
    for l, layer in enumerate(model.layers):
        for name in quant.EXPERT_NAMES:
            got = getattr(layer, name)
            assert isinstance(got, quant.QTensor) and got.mode == mode
            np.testing.assert_array_equal(got.q.numpy(),
                                          np.asarray(jq[name].q[l]))
            np.testing.assert_array_equal(got.scale.numpy(),
                                          np.asarray(jq[name].scale[l]))
            assert got.q.transpose(1, 2).is_contiguous()
        assert not isinstance(layer.router, quant.QTensor)


# ---------------------------------------------------------- the block --

MOE_CFGS = {
    "tiny-moe-debug": {},
    # DeepSeek's routing: a shared expert, the global softmax's
    # probabilities of the selected experts, scaled
    "shared": dict(num_shared_experts=1, norm_topk_prob=False,
                   routed_scaling_factor=2.5),
}


def moe_cfgs(variant: str = "tiny-moe-debug", **change):
    """(JAX ModelConfig, port ModelConfig) of a tiny MoE config, float32."""
    kw = dict(MOE_CFGS[variant], dtype="float32", **change)
    return (dataclasses.replace(JPRESETS["tiny-moe-debug"], **kw),
            dataclasses.replace(PRESETS["tiny-moe-debug"], **kw))


def jax_params(jcfg, seed=0):
    """The JAX init from PRNGKey(seed) with the router redrawn at sigma
    0.3 from a numpy seed (the init's 0.02 gives near-uniform routing)."""
    params = dict(jllama.init_params(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)
    params["router"] = jnp.asarray(
        0.3 * rng.normal(size=params["router"].shape).astype(np.float32))
    return params


def _np(params):
    return {k: np.asarray(v) for k, v in params.items()}


def _layer_tree(params, l):
    return {k: v[l] for k, v in params.items()
            if k not in ("embed", "lm_head", "final_norm")}


BLOCK_CASES = [("tiny-moe-debug", 0.0), ("tiny-moe-debug", 1.25),
               ("tiny-moe-debug", 0.5), ("shared", 0.0), ("shared", 1.25)]


@pytest.mark.parametrize("variant,cf", BLOCK_CASES,
                         ids=[f"{v}-cf{cf}" for v, cf in BLOCK_CASES])
def test_moe_block_matches_jax(variant, cf):
    """`_mlp` on 32 rows, the last 7 padding: capacity off (cf 0), on at
    a capacity of 24 rows (cf 1.25) and of 8 rows that drops tokens (cf
    0.5); and with allow_capacity False the dense dispatch at any cf."""
    jcfg, tcfg = moe_cfgs(variant, moe_capacity_factor=cf)
    params = jax_params(jcfg)
    model = loader.from_jax_params(tcfg, _np(params), device="cpu",
                                   dtype=torch.float32)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(32, jcfg.hidden_size)).astype(np.float32)
    mask = np.arange(32) < 25
    for allow in (True, False):
        ref = jllama._mlp(jcfg, _layer_tree(params, 1), jnp.asarray(x),
                          token_mask=jnp.asarray(mask), allow_capacity=allow)
        got = tllama._mlp(tcfg, model.layers[1], _t(x), _t(mask), allow)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    if variant == "tiny-moe-debug":
        assert tllama._mlp(tcfg, model.layers[1], _t(x), _t(mask))[
            25:].abs().max() == 0
    ref = jllama._mlp(jcfg, _layer_tree(params, 0), jnp.asarray(x[:8]))
    got = tllama._mlp(tcfg, model.layers[0], _t(x[:8]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


# ------------------------------------------------------------ forwards --


@pytest.fixture(scope="module")
def tiny_moe():
    jcfg, tcfg = moe_cfgs()
    jparams = jax_params(jcfg)
    model = loader.from_jax_params(tcfg, _np(jparams), device="cpu",
                                   dtype=torch.float32)
    return jcfg, tcfg, jparams, model


def _model_pools(cfg, seed, n_pages=16):
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, n_pages, PS, cfg.num_kv_heads * cfg.head_dim)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _pools_match(ref, tk, tv):
    np.testing.assert_allclose(tk.numpy(), np.asarray(ref.k_pages), **KV_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(ref.v_pages), **KV_TOL)


def test_moe_leaves_carry_across(tiny_moe):
    jcfg, tcfg, jparams, model = tiny_moe
    assert set(loader.param_specs(tcfg)) == set(jparams)
    layer = model.layers[1]
    assert layer.w_gate is None and layer.w_down is None
    np.testing.assert_array_equal(layer.router.numpy(),
                                  np.asarray(jparams["router"][1]))
    np.testing.assert_array_equal(layer.moe_w_down.numpy(),
                                  np.asarray(jparams["moe_w_down"][1]))
    assert layer.moe_w_gate.transpose(1, 2).is_contiguous()
    assert tllama.unported_model_features(tcfg) == []


@pytest.mark.parametrize("cf", [0.0, 1.25], ids=["dense", "capacity"])
def test_moe_prefill_matches(tiny_moe, cf):
    """A 32-token bucket, 27 real tokens; at cf 1.25 the capacity (24
    rows) cuts the bucket, so the capacity path runs."""
    jcfg, tcfg, jparams, _ = tiny_moe
    jcfg = dataclasses.replace(jcfg, moe_capacity_factor=cf)
    model = loader.from_jax_params(
        dataclasses.replace(tcfg, moe_capacity_factor=cf), _np(jparams),
        device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab_size, size=32).astype(np.int32)
    pages = np.array([3, 7], np.int32)
    kp, vp = _model_pools(jcfg, 0)
    ref = jllama.prefill(jcfg, jparams, jnp.asarray(tokens), jnp.int32(27),
                         jnp.asarray(kp), jnp.asarray(vp),
                         jnp.asarray(pages), page_size=PS)
    tk, tv = _t(kp), _t(vp)
    logits = tllama.prefill(model, _t(tokens), 27, tk, tv, _t(pages),
                            page_size=PS)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref.last_logits),
                               **LOGIT_TOL)
    _pools_match(ref, tk, tv)


def test_moe_prefill_batch_matches(tiny_moe):
    jcfg, _, jparams, model = tiny_moe
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


def test_moe_prefill_chunks_match(tiny_moe):
    """A 40-token prompt in 16-token chunks over a trash-padded list."""
    jcfg, _, jparams, model = tiny_moe
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


def test_moe_decode_step_matches(tiny_moe):
    jcfg, _, jparams, model = tiny_moe
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


def test_moe_mixed_step_matches(tiny_moe):
    """The decode batch beside the second 16-token chunk (9 valid)."""
    jcfg, _, jparams, model = tiny_moe
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


def test_moe_decode_verify_matches(tiny_moe):
    jcfg, _, jparams, model = tiny_moe
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


def test_moe_mixed_verify_step_matches(tiny_moe):
    jcfg, _, jparams, model = tiny_moe
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


@pytest.mark.parametrize("mode", ["int8", "w8a8"])
def test_quantized_moe_prefill_matches(tiny_moe, mode):
    """A quantized JAX tree (its QTensors as numpy) carried across as it
    is: the prefill's logits within 1e-4 of the JAX model's."""
    jcfg, tcfg, jparams, _ = tiny_moe
    jq = jquant.quantize_params(jparams, mode)
    tree = jax.tree.map(np.asarray, jq)
    model = loader.from_jax_params(tcfg, tree, device="cpu",
                                   dtype=torch.float32, quantization=mode)
    assert quant.mode_of(model) == mode
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

ENGINE = dict(model="tiny-moe-debug", page_size=PS, num_pages=64,
              max_num_seqs=4, max_seq_len=512, enable_prefix_caching=False,
              async_scheduling=False, prefill_chunk_tokens=0)
MODES = {
    # 4-step decode windows (eager on the CPU), whole prefills
    "windows": dict(num_scheduler_steps=4),
    # mixed steps beside live streams
    "mixed": dict(mixed_batch_tokens=32, prefill_chunk_tokens=32),
    # prefix-cache hits: the repeated prompt re-enters as a chunk
    "prefix": dict(prefill_chunk_tokens=32, enable_prefix_caching=True),
    # n-gram verify windows
    "ngram": dict(speculative_mode="ngram", num_speculative_tokens=K),
    # the capacity path in whole prefills and in chunks
    "capacity": dict(moe_capacity_factor=1.25, prefill_chunk_tokens=32),
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
def test_moe_engine_greedy_streams_match_jax(tiny_moe, mode, monkeypatch):
    """Two short prompts and a repetitive one (it drafts), then a 70-token
    prompt that arrives while they decode (its chunks ride mixed steps in
    the mixed mode), and the same 70 tokens again once it has finished
    (a prefix hit in the prefix mode). The port's engine gets the
    fixture's weights, made at capacity factor 0: in the capacity mode
    its prefills must take the capacity path all the same."""
    jcfg, tcfg, jparams, model = tiny_moe
    dropping = []
    real = moe.moe_mlp_dropping
    monkeypatch.setattr(moe, "moe_mlp_dropping", lambda *a, **kw: (
        dropping.append(kw["capacity"]), real(*a, **kw))[1])
    rng = np.random.default_rng(10)
    long = rng.integers(0, 256, size=70).tolist()
    reqs = [("a", rng.integers(0, 256, size=5).tolist(), 14, 0),
            ("b", rng.integers(0, 256, size=9).tolist(), 14, 0),
            ("c", [5, 6, 7] * 4, 14, 0),
            ("d", long, 8, 3), ("e", long, 6, 40)]
    cfg = dict(ENGINE, **MODES[mode])
    ref = _drive(JEngine(JEngineConfig(**cfg), params=jparams), JGenRequest,
                 reqs)
    eng = Engine(EngineConfig(**cfg), params=model, device="cpu")
    got = _drive(eng, GenRequest, reqs)
    assert got == ref
    assert [len(got[r]) for r in "abcde"] == [14, 14, 14, 8, 6]
    m = eng.metrics
    if mode == "mixed":
        assert m.mixed_count > 0
    if mode == "prefix":
        assert eng.prefix_cache.stats()["hits"] >= 1
    if mode == "ngram":
        assert m.spec_verify_steps > 0
    if mode == "capacity":
        assert eng.model.cfg.moe_capacity_factor == 1.25
        assert model.cfg.moe_capacity_factor == 0.0  # shared, untouched
        assert 24 in dropping  # chunks of 32 rows (and whole prefills)
    else:
        assert not dropping


# ---------------------------------------------- the engine's ModelConfig --

DEBUG_ENGINE = dict(model="tiny-debug", page_size=4, num_pages=64,
                    max_num_seqs=2)


@pytest.fixture(scope="module")
def debug_weights():
    """tiny-debug's JAX weights and a config of the same shapes that
    differs in rope_theta (500000): (base, other, JAX tree)."""
    base = dataclasses.replace(JPRESETS["tiny-debug"], dtype="float32")
    other = dataclasses.replace(base, rope_theta=500000.0)
    return base, other, _np(jloader.load_or_init_params(base, None, seed=0))


def test_engine_runs_its_own_model_config_on_given_weights(debug_weights):
    """An Engine given a `llama.Llama` made under another ModelConfig of
    the same shapes runs its own model_cfg, as the JAX engine does (its
    parameter tree carries no config): a greedy 12-token request over
    range(3, 40) under rope_theta 500000 gives the JAX engine's tokens
    (the weights' own rope_theta gave [179, 248, 31, 490, ...]); weights
    of other shapes are refused."""
    base, other, tree = debug_weights
    tbase = dataclasses.replace(PRESETS["tiny-debug"], dtype="float32")
    tother = dataclasses.replace(tbase, rope_theta=500000.0)
    reqs = [("r", list(range(3, 40)), 12, 0)]
    ref = _drive(JEngine(JEngineConfig(**DEBUG_ENGINE), model_cfg=other,
                         params=tree), JGenRequest, reqs)
    model = loader.from_jax_params(tbase, tree, device="cpu",
                                   dtype=torch.float32)
    eng = Engine(EngineConfig(**DEBUG_ENGINE), model_cfg=tother,
                 params=model, device="cpu")
    assert eng.model.cfg.rope_theta == 500000.0
    assert model.cfg.rope_theta == tbase.rope_theta  # shared, untouched
    assert _drive(eng, GenRequest, reqs) == ref
    wide = dataclasses.replace(tother, hidden_size=2 * tother.hidden_size)
    with pytest.raises(ValueError, match="hidden_size"):
        Engine(EngineConfig(**DEBUG_ENGINE), model_cfg=wide, params=model,
               device="cpu")


def test_draft_engine_runs_its_own_model_config(debug_weights):
    """The DraftEngine twin: a drafter given weights made under another
    ModelConfig of the same shapes runs the draft model's config, and
    proposes what the drafter built from the same tree proposes."""
    from dynamo_tpu_torch.engine.kv_cache import SeqState

    base, _, tree = debug_weights
    tbase = dataclasses.replace(PRESETS["tiny-debug"], dtype="float32")
    odd = loader.from_jax_params(
        dataclasses.replace(tbase, rope_theta=500000.0), tree, device="cpu",
        dtype=torch.float32)
    cfg = EngineConfig(**DEBUG_ENGINE, speculative_mode="model",
                       draft_model="tiny-debug", num_speculative_tokens=2,
                       prefill_chunk_tokens=0, enable_prefix_caching=False)
    engines = [Engine(cfg, params=tree, device="cpu", draft_params=d)
               for d in (odd, tree)]
    assert engines[0].draft.model.cfg == engines[0].draft.model_cfg
    assert engines[0].draft.model.cfg.rope_theta == tbase.rope_theta
    props = []
    for e in engines:
        seq = SeqState("r", 0, [1], prompt_len=11, max_tokens=8)
        seq.prompt_ids, seq.output_tokens = list(range(3, 14)), [3]
        props.append(e.draft.propose(seq, 2))
        e.draft.release(0)
    assert props[0] == props[1]


# ---------------------------------------------------------- checkpoints --

TINY = PRESETS["tiny-moe-debug"]
E, H, KV, D, F_, V, L, X = (TINY.hidden_size, TINY.num_heads,
                            TINY.num_kv_heads, TINY.head_dim,
                            TINY.intermediate_size, TINY.vocab_size,
                            TINY.num_layers, TINY.num_experts)
LAYOUTS = {
    # Mixtral: block_sparse_moe, experts' w1 (gate), w3 (up), w2 (down)
    "mixtral": ("MixtralForCausalLM", "block_sparse_moe",
                ("w1", "w3", "w2"), 0),
    # Qwen3-MoE (q/k norms) with one DeepSeek-style shared expert
    "qwen3_moe": ("Qwen3MoeForCausalLM", "mlp",
                  ("gate_proj", "up_proj", "down_proj"), 1),
}


def write_moe_checkpoint(path, layout: str, seed: int = 0) -> dict:
    arch, base, names, shared = LAYOUTS[layout]
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-1])).astype(
            np.float32)

    t = {"model.embed_tokens.weight": w(V, E),
         "model.norm.weight": 1 + w(E), "lm_head.weight": w(V, E)}
    for i in range(L):
        p = f"model.layers.{i}."
        t[p + "input_layernorm.weight"] = 1 + w(E)
        t[p + "post_attention_layernorm.weight"] = 1 + w(E)
        for hf, out in (("q_proj", H * D), ("k_proj", KV * D),
                        ("v_proj", KV * D)):
            t[p + f"self_attn.{hf}.weight"] = w(out, E)
        t[p + "self_attn.o_proj.weight"] = w(E, H * D)
        if "Qwen3" in arch:
            t[p + "self_attn.q_norm.weight"] = 1 + w(D)
            t[p + "self_attn.k_norm.weight"] = 1 + w(D)
        m = p + base + "."
        t[m + "gate.weight"] = 3 * w(X, E)
        for j in range(X):
            t[m + f"experts.{j}.{names[0]}.weight"] = w(F_, E)
            t[m + f"experts.{j}.{names[1]}.weight"] = w(F_, E)
            t[m + f"experts.{j}.{names[2]}.weight"] = w(E, F_)
        if shared:
            for hf, shape in (("gate_proj", (shared * F_, E)),
                              ("up_proj", (shared * F_, E)),
                              ("down_proj", (E, shared * F_))):
                t[m + f"shared_experts.{hf}.weight"] = w(*shape)
    path.mkdir(parents=True, exist_ok=True)
    save_file(t, str(path / "model.safetensors"))
    config = {"architectures": [arch], "vocab_size": V, "hidden_size": E,
              "intermediate_size": 4 * F_, "num_hidden_layers": L,
              "num_attention_heads": H, "num_key_value_heads": KV,
              "head_dim": D, "rope_theta": TINY.rope_theta,
              "rms_norm_eps": TINY.rms_norm_eps,
              "max_position_embeddings": TINY.max_position_embeddings,
              "tie_word_embeddings": False, "num_experts_per_tok": 2,
              "eos_token_id": TINY.eos_token_id,
              "bos_token_id": TINY.bos_token_id}
    if layout == "mixtral":  # its intermediate_size is the expert width
        config.update(num_local_experts=X, intermediate_size=F_)
    else:
        config.update(num_experts=X, moe_intermediate_size=F_,
                      n_shared_experts=shared)
    (path / "config.json").write_text(json.dumps(config))
    return t


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_moe_checkpoint_loads_like_jax(tmp_path, layout):
    """Every port parameter equals the JAX loader's tensor exactly (expert
    stacks stored as each expert's HF [out, in]), and the checkpoint
    serves the JAX engine's greedy tokens."""
    tensors = write_moe_checkpoint(tmp_path, layout)
    cfg = ModelConfig.from_model_name(str(tmp_path), dtype="float32")
    jcfg = JModelConfig.from_model_name(str(tmp_path), dtype="float32")
    assert cfg.num_experts == X and cfg.intermediate_size == F_
    assert cfg.num_shared_experts == LAYOUTS[layout][3]
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
    assert n == 3 + L * len(loader._layer_names(cfg))
    base, names = LAYOUTS[layout][1], LAYOUTS[layout][2]
    down = tensors[f"model.layers.1.{base}.experts.2.{names[2]}.weight"]
    assert torch.equal(model.layers[1].moe_w_down[2], _t(down).t())
    assert model.layers[1].moe_w_down.transpose(1, 2).is_contiguous()
    reqs = [("a", [3, 1, 4, 1, 5, 9, 2, 6], 6, 0)]
    kw = dict(ENGINE, model=str(tmp_path), model_path=str(tmp_path))
    ref = _drive(JEngine(JEngineConfig(**kw)), JGenRequest, reqs)
    got = _drive(Engine(EngineConfig(**kw), device="cpu"), GenRequest, reqs)
    assert got == ref


def test_dense_first_layer_checkpoint_is_refused(tmp_path):
    """DeepSeek's first_k_dense_replace tensors (a dense layer 0 in an MoE
    checkpoint): the JAX loader's ValueError."""
    write_moe_checkpoint(tmp_path, "qwen3_moe")
    cfg = ModelConfig.from_model_name(str(tmp_path), dtype="float32")
    files = loader.checkpoint_files(str(tmp_path))
    from safetensors.numpy import load_file
    t = load_file(files[0])
    t["model.layers.0.mlp.gate_proj.weight"] = t.pop(
        "model.layers.0.mlp.gate.weight")
    save_file(t, files[0])
    with pytest.raises(ValueError, match="dense first layer"):
        loader.load_hf_safetensors(cfg, files, device="cpu",
                                   dtype=torch.float32)


# ---------------------------------------------------------- the presets --


@pytest.mark.parametrize("preset", ["qwen3-30b-a3b",
                                    "mixtral-8x7b-instruct-v0.1"])
def test_num_params_counts_every_expert(preset):
    """From the specs alone (nothing allocated): equal to the JAX
    param_specs' count, 30.5 B for qwen3-30b-a3b and 46.6 B for Mixtral
    (whose preset ties its head, as the JAX preset does), both above
    DIRECT_INT8_PARAMS (their int8 weights are drawn directly)."""
    want = sum(int(np.prod(shape)) for shape, _, _ in
               jllama.param_specs(JPRESETS[preset]).values())
    got = loader.num_params(PRESETS[preset])
    assert got == want
    assert got > loader.DIRECT_INT8_PARAMS
    assert round(got / 1e9, 1) == {"qwen3-30b-a3b": 30.5,
                                   "mixtral-8x7b-instruct-v0.1": 46.6}[preset]


def test_random_int8_experts_draw_in_the_operand_layout():
    """`random_quantized_params` for an MoE config: expert stacks as
    QTensors [X, K, N] with q stored as each expert's [N, K] and scales
    [X, 1, N]; the router a float weight; and an engine serves them."""
    cfg = dataclasses.replace(PRESETS["tiny-moe-debug"], dtype="float32")
    model = loader.random_quantized_params(cfg, seed=1, mode="w8a8",
                                           device="cpu",
                                           dtype=torch.float32)
    layer = model.layers[0]
    assert tuple(layer.moe_w_gate.shape) == (X, E, F_)
    assert tuple(layer.moe_w_gate.scale.shape) == (X, 1, F_)
    assert tuple(layer.moe_w_down.scale.shape) == (X, 1, E)
    assert layer.moe_w_down.q.transpose(1, 2).is_contiguous()
    assert layer.router.dtype == torch.float32
    eng = Engine(EngineConfig(**dict(ENGINE, quantization="w8a8")),
                 params=model, device="cpu")
    out = eng.generate(GenRequest("p", [1, 2, 3], max_tokens=4,
                                  ignore_eos=True))
    assert len(out) == 4
