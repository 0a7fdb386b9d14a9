"""Gemma-3's whole and chunked prefill, both packages side by side on the
CPU (tiny-gemma3-debug: window 8 on layers 0-1, qk norms, local and global
rope, sandwich norms; a 40-token prompt over its windows; the JAX init,
constant leaves redrawn, carried across by `models/loader.from_jax_params`).

The reference parts its own two paths: in f32 its whole and chunked
prefill write the same layer-0 K/V rows, and from layer 1 on differ by a
few f32 units (under 1e-5), and so do its last logits: they part in layer
0's attention or after it, where the chunk attends over the paged pool
and the whole prompt over its own rows. In
bf16 on the CPU both packages' paths agree bit for bit, and the port's do
in f32 too. So the bf16 unit between the port's plain whole and chunked
paths on the card is the reference's behaviour in the card's dtype, not a
fault of the port (ROADMAP queue 3, `[reference]`). In f32 the port's
logits hold the reference's within 1e-4 (rtol and atol), the families'
tolerance, on both paths."""

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

NAME = "tiny-gemma3-debug"
PS = 8
L = 40
PAGES = np.array([5, 6, 8, 9, 10, 11, 0, 0], np.int32)
VALID = [5, 6, 8, 9, 10]  # the pages positions 0..39 fill
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def paths(np_params):
    """(package, dtype, chunk) -> that package's (whole, chunked) paths,
    each computed once for the module."""
    done = {}

    def get(pkg, dtype, chunk):
        key = (pkg, dtype, chunk)
        if key not in done:
            fn = jax_paths if pkg == "jax" else port_paths
            done[key] = fn(np_params, dtype, chunk)
        return done[key]

    return get


@pytest.fixture(scope="module")
def np_params():
    cfg = dataclasses.replace(JPRESETS[NAME], dtype="float32")
    params = jllama.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(100)
    specs = jllama.param_specs(cfg)
    out = {}
    for k, v in params.items():
        a = np.asarray(v)
        if specs[k][1] in ("zeros", "ones"):
            a = a + 0.3 * rng.normal(size=a.shape).astype(np.float32)
        out[k] = a
    return out


def _prompt():
    return np.random.default_rng(4).integers(
        0, JPRESETS[NAME].vocab_size, size=L).astype(np.int32)


def jax_paths(np_params, dtype, chunk):
    cfg = dataclasses.replace(JPRESETS[NAME], dtype=dtype)
    jdt = getattr(jnp, dtype)
    params = {k: jnp.asarray(v).astype(jdt) for k, v in np_params.items()}
    shape = (cfg.num_layers, 16, PS, cfg.num_kv_heads * cfg.head_dim)
    prompt = _prompt()
    toks = np.zeros(64, np.int32)
    toks[:L] = prompt
    whole = jllama.prefill(cfg, params, jnp.asarray(toks), jnp.int32(L),
                           jnp.zeros(shape, jdt), jnp.zeros(shape, jdt),
                           jnp.asarray(PAGES), page_size=PS)
    kp, vp = jnp.zeros(shape, jdt), jnp.zeros(shape, jdt)
    for start in range(0, L, chunk):
        take = min(chunk, L - start)
        c = np.zeros(chunk, np.int32)
        c[:take] = prompt[start:start + take]
        part = jllama.prefill_chunk(cfg, params, jnp.asarray(c),
                                    jnp.int32(start), jnp.int32(take), kp,
                                    vp, jnp.asarray(PAGES), page_size=PS)
        kp, vp = part.k_pages, part.v_pages

    def f32(a):
        return np.asarray(jnp.asarray(a).astype(jnp.float32))

    return ((f32(whole.last_logits), f32(whole.k_pages)[:, VALID],
             f32(whole.v_pages)[:, VALID]),
            (f32(part.last_logits), f32(kp)[:, VALID], f32(vp)[:, VALID]))


def port_paths(np_params, dtype, chunk):
    cfg = dataclasses.replace(PRESETS[NAME], dtype=dtype)
    tdt = getattr(torch, dtype)
    model = loader.from_jax_params(cfg, np_params, device="cpu", dtype=tdt)
    shape = (cfg.num_layers, 16, PS, cfg.num_kv_heads * cfg.head_dim)
    prompt = _prompt()
    pages = torch.from_numpy(PAGES)
    toks = np.zeros(64, np.int64)
    toks[:L] = prompt
    kw, vw = torch.zeros(shape, dtype=tdt), torch.zeros(shape, dtype=tdt)
    whole = tllama.prefill(model, torch.from_numpy(toks), L, kw, vw, pages,
                           page_size=PS)
    kc, vc = torch.zeros(shape, dtype=tdt), torch.zeros(shape, dtype=tdt)
    for start in range(0, L, chunk):
        take = min(chunk, L - start)
        c = np.zeros(chunk, np.int64)
        c[:take] = prompt[start:start + take]
        last = tllama.prefill_chunk(model, torch.from_numpy(c), start, take,
                                    kc, vc, pages, page_size=PS)

    def f32(t):
        return t.float().numpy()

    return ((f32(whole), f32(kw[:, VALID]), f32(vw[:, VALID])),
            (f32(last), f32(kc[:, VALID]), f32(vc[:, VALID])))


@pytest.mark.parametrize("chunk", [8, 16, 24])
def test_the_reference_parts_its_paths_by_f32_units(paths, chunk):
    whole, chunked = paths("jax", "float32", chunk)
    np.testing.assert_array_equal(whole[1][0], chunked[1][0])  # layer 0 K
    np.testing.assert_array_equal(whole[2][0], chunked[2][0])  # layer 0 V
    for a, b in zip(whole, chunked):
        d = float(np.abs(a - b).max())
        assert 0.0 < d < 1e-5, d


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [8, 16, 24])
def test_the_ports_paths_agree_on_the_cpu(paths, dtype, chunk):
    whole, chunked = paths("port", dtype, chunk)
    for a, b in zip(whole, chunked):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("chunk", [8, 16])
def test_the_references_paths_agree_in_bf16_on_the_cpu(paths, chunk):
    whole, chunked = paths("jax", "bfloat16", chunk)
    for a, b in zip(whole, chunked):
        np.testing.assert_array_equal(a, b)


def test_port_paths_hold_the_references_in_f32(paths):
    jw, jc = paths("jax", "float32", 16)
    tw, tc = paths("port", "float32", 16)
    np.testing.assert_allclose(tw[0], jw[0], **LOGIT_TOL)
    np.testing.assert_allclose(tc[0], jc[0], **LOGIT_TOL)
    for a, b in zip(tw[1:], jw[1:]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
