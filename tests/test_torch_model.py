"""The port's dense Llama forward against the JAX package's on tiny-debug.

Both run in float32 on the CPU from the same weights: the JAX tree from
`dynamo_tpu.models.llama.init_params(PRNGKey(0))`, carried across by
`dynamo_tpu_torch.models.loader.from_jax_params`. Logits must agree within
rtol=atol=1e-4 (two framework's matmul orders over two layers) and the KV
pools within 1e-5; the JAX side reaches attention through its XLA paths,
which is what it runs on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import PRESETS as JPRESETS
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models import loader
from dynamo_tpu_torch.models.config import PRESETS

PS = 16
NUM_PAGES = 16
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
KV_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module: the parallel test workers share
    the cores, and torch's default pool in each of them oversubscribes
    them (the suite's tiny eager ops are as fast on one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(JPRESETS["tiny-debug"], dtype="float32")
    tcfg = dataclasses.replace(PRESETS["tiny-debug"], dtype="float32")
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    model = loader.from_jax_params(tcfg, np_params, device="cpu",
                                   dtype=torch.float32)
    return jcfg, jparams, model


def _pools(cfg, seed=0):
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, NUM_PAGES, PS, cfg.num_kv_heads * cfg.head_dim)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


def _check_pools(jk, jv, tk, tv):
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **KV_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **KV_TOL)


def test_param_tree_carries_across(models):
    jcfg, jparams, model = models
    assert set(loader.param_specs(model.cfg)) == set(jparams)
    np.testing.assert_array_equal(
        model.layers[1].wq.numpy(),
        np.asarray(jparams["wq"][1]).reshape(jcfg.hidden_size, -1))


def test_init_params_draws_the_jax_shapes_and_sigmas():
    cfg = dataclasses.replace(PRESETS["tiny-debug"], dtype="float32")
    model = loader.init_params(cfg, seed=0, device="cpu",
                               dtype=torch.float32)
    again = loader.init_params(cfg, seed=0, device="cpu",
                               dtype=torch.float32)
    assert torch.equal(model.layers[0].w_up, again.layers[0].w_up)
    std = float(model.layers[0].wq.std())
    assert abs(std - cfg.head_dim ** -0.5) < 0.02
    assert float(model.embed.std()) == pytest.approx(0.02, rel=0.1)
    assert torch.equal(model.final_norm, torch.ones(cfg.hidden_size))


def test_prefill_matches(models):
    jcfg, jparams, model = models
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab_size, size=32).astype(np.int32)
    pages = np.array([3, 7], np.int32)
    kp, vp = _pools(jcfg)
    ref = jllama.prefill(jcfg, jparams, jnp.asarray(tokens), jnp.int32(27),
                         jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pages),
                         page_size=PS)
    tk, tv = _t(kp), _t(vp)
    logits = tllama.prefill(model, _t(tokens), 27, tk, tv, _t(pages),
                            page_size=PS)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref.last_logits),
                               **LOGIT_TOL)
    _check_pools(ref.k_pages, ref.v_pages, tk, tv)


def test_prefill_batch_matches(models):
    jcfg, jparams, model = models
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, jcfg.vocab_size, size=(3, 32)).astype(np.int32)
    seq_lens = np.array([32, 9, 17], np.int32)
    tokens[1, 9:] = 0
    tokens[2, 17:] = 0
    pages = np.array([[1, 2], [4, 0], [5, 6]], np.int32)
    kp, vp = _pools(jcfg, seed=3)
    ref = jllama.prefill_batch(jcfg, jparams, jnp.asarray(tokens),
                               jnp.asarray(seq_lens), jnp.asarray(kp),
                               jnp.asarray(vp), jnp.asarray(pages),
                               page_size=PS)
    tk, tv = _t(kp), _t(vp)
    logits = tllama.prefill_batch(model, _t(tokens), _t(seq_lens), tk, tv,
                                  _t(pages), page_size=PS)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref.last_logits),
                               **LOGIT_TOL)
    _check_pools(ref.k_pages, ref.v_pages, tk, tv)


def test_prefill_chunk_sequence_matches(models):
    """A 40-token prompt in 16-token chunks at starts 0, 16, 32 over a
    trash-padded page list."""
    jcfg, jparams, model = models
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, jcfg.vocab_size, size=40).astype(np.int32)
    pages = np.array([5, 6, 8, 0], np.int32)
    kp, vp = _pools(jcfg, seed=5)
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
    _check_pools(jk, jv, tk, tv)


def test_decode_step_matches(models):
    """Two live slots mid-sequence and one inactive slot on the trash page
    (position 0, context 1)."""
    jcfg, jparams, model = models
    kp, vp = _pools(jcfg, seed=6)
    tokens = np.array([11, 300, 0], np.int32)
    positions = np.array([20, 35, 0], np.int32)
    tables = np.array([[1, 2, 0], [3, 4, 9], [0, 0, 0]], np.int32)
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
    _check_pools(ref.k_pages, ref.v_pages, tk, tv)
