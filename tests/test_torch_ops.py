"""The port's ops (dynamo_tpu_torch.ops, engine.sampling, models.llama
rms_norm) against the JAX package's on the same numpy inputs.

Attention: the port's plain versions against the Pallas TPU kernels run in
interpret mode, as tests/test_pallas_attention.py runs them, in float32 at
the repo's tolerance rtol=atol=2e-5. Every row is compared, including rows
with no valid token (zeros from both) and padded prompt rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import sampling as jsmp
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.ops import attention as jatt
from dynamo_tpu.ops import pallas_attention as pa
from dynamo_tpu.ops import rope as jrope
from dynamo_tpu_torch.engine import sampling as smp
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.ops import attention as att
from dynamo_tpu_torch.ops import rope as trope

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
    return torch.from_numpy(np.asarray(a))


def _decode_inputs(seed, bsz=4, n_heads=8, n_kv=2, head_dim=128,
                   page_size=16, num_pages=64, pmax=8):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(bsz, n_heads, head_dim)).astype(np.float32)
    kp = rng.normal(size=(num_pages, page_size,
                          n_kv * head_dim)).astype(np.float32)
    vp = rng.normal(size=(num_pages, page_size,
                          n_kv * head_dim)).astype(np.float32)
    bt = (np.arange(bsz * pmax, dtype=np.int32).reshape(bsz, pmax)
          % (num_pages - 1)) + 1
    # ragged: 1 token .. a full table, and an inactive ctx-0 row
    cl = np.array([1, page_size * 3 + 5, page_size * pmax, 0][:bsz],
                  np.int32)
    return q, kp, vp, bt, cl


@pytest.mark.parametrize("n_heads,n_kv", [(8, 2), (4, 4)])
def test_decode_plain_matches_pallas(n_heads, n_kv):
    q, kp, vp, bt, cl = _decode_inputs(0, n_heads=n_heads, n_kv=n_kv)
    ref = pa.paged_attention_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(cl), page_size=16, num_kv_heads=n_kv, interpret=True)
    out = att.paged_attention_decode(_t(q), _t(kp), _t(vp), _t(bt), _t(cl),
                                     page_size=16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    # the ctx-0 row is exact zeros, as the kernel's
    assert not out[3].any()


@pytest.mark.parametrize("s,seq_len,head_dim", [
    (128, 128, 128), (256, 200, 64), (48, 33, 32), (16, 5, 128), (32, 0, 32),
])
def test_prefill_plain_matches_pallas(s, seq_len, head_dim):
    rng = np.random.default_rng(2)
    n_heads, n_kv = 8, 2
    q = rng.normal(size=(s, n_heads, head_dim)).astype(np.float32)
    k = rng.normal(size=(s, n_kv, head_dim)).astype(np.float32)
    v = rng.normal(size=(s, n_kv, head_dim)).astype(np.float32)
    ref = pa.prefill_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               seq_len, interpret=True)
    out = att.prefill_attention(_t(q), _t(k), _t(v), seq_len)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_prefill_batched_lanes_match_pallas_per_lane():
    rng = np.random.default_rng(3)
    n, s, n_heads, n_kv, d = 3, 64, 8, 2, 32
    q = rng.normal(size=(n, s, n_heads, d)).astype(np.float32)
    k = rng.normal(size=(n, s, n_kv, d)).astype(np.float32)
    v = rng.normal(size=(n, s, n_kv, d)).astype(np.float32)
    lens = np.array([64, 17, 1], np.int32)
    out = att.prefill_attention(_t(q), _t(k), _t(v), _t(lens)).numpy()
    for i in range(n):
        ref = pa.prefill_attention(jnp.asarray(q[i]), jnp.asarray(k[i]),
                                   jnp.asarray(v[i]), int(lens[i]),
                                   interpret=True)
        np.testing.assert_allclose(out[i], np.asarray(ref), **TOL)


@pytest.mark.parametrize("start,c", [(0, 32), (48, 16), (32, 8), (112, 16)])
def test_chunk_plain_matches_pallas(start, c):
    rng = np.random.default_rng(11)
    ps, n_kv, d, h = 16, 2, 128, 8
    kp = rng.normal(size=(64, ps, n_kv * d)).astype(np.float32)
    vp = rng.normal(size=(64, ps, n_kv * d)).astype(np.float32)
    # 8 real pages then a trash tail the causal horizon never reaches
    pages = np.array(list(range(1, 9)) + [0, 0, 0, 0], np.int32)
    q = rng.normal(size=(c, h, d)).astype(np.float32)
    ref = pa.chunk_prefill_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pages),
        start, page_size=ps, num_kv_heads=n_kv, interpret=True)
    out = att.chunk_attention(_t(q), _t(kp), _t(vp), _t(pages), start,
                              page_size=ps)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_write_kv_token_matches_including_trash_page():
    rng = np.random.default_rng(5)
    ps, kv, d, npages = 4, 2, 8, 6
    kp = rng.normal(size=(npages, ps, kv * d)).astype(np.float32)
    vp = rng.normal(size=(npages, ps, kv * d)).astype(np.float32)
    k_new = rng.normal(size=(3, kv, d)).astype(np.float32)
    v_new = rng.normal(size=(3, kv, d)).astype(np.float32)
    # slot 2 is inactive: zero table row at position 0 -> trash page 0
    bt = np.array([[1, 2, 0], [3, 4, 5], [0, 0, 0]], np.int32)
    pos = np.array([5, 9, 0], np.int32)
    jk, jv = jatt.write_kv_token(jnp.asarray(kp), jnp.asarray(vp),
                                 jnp.asarray(k_new), jnp.asarray(v_new),
                                 jnp.asarray(bt), jnp.asarray(pos),
                                 page_size=ps)
    tk, tv = _t(kp.copy()), _t(vp.copy())
    att.write_kv_token(tk, tv, _t(k_new), _t(v_new), _t(bt), _t(pos),
                       page_size=ps)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tk[0, 0].numpy(),
                                  k_new[2].reshape(-1))


def test_write_kv_prefill_matches_in_place():
    rng = np.random.default_rng(6)
    ps, kv, d, npages = 4, 2, 8, 8
    kp = rng.normal(size=(npages, ps, kv * d)).astype(np.float32)
    vp = rng.normal(size=(npages, ps, kv * d)).astype(np.float32)
    k_new = rng.normal(size=(12, kv, d)).astype(np.float32)
    v_new = rng.normal(size=(12, kv, d)).astype(np.float32)
    pages = np.array([3, 5, 0], np.int32)  # one trash page pads the list
    jk, jv = jatt.write_kv_prefill(jnp.asarray(kp), jnp.asarray(vp),
                                   jnp.asarray(k_new), jnp.asarray(v_new),
                                   jnp.asarray(pages), page_size=ps)
    tk, tv = _t(kp.copy()), _t(vp.copy())
    view_k, view_v = tk[:], tv[:]  # updates land in the caller's storage
    att.write_kv_prefill(view_k, view_v, _t(k_new), _t(v_new), _t(pages),
                         page_size=ps)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_rope_llama3_matches():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(64, 8, 128)).astype(np.float32)
    pos = rng.integers(0, 8000, size=64)
    scaling = (8.0, 1.0, 4.0, 8192)
    ref = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500000.0,
                           llama3_scaling=scaling)
    out = trope.apply_rope(_t(x), _t(pos), 500000.0, llama3_scaling=scaling)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_rope_refuses_unported_scalings():
    """Phi-3's longrope is served since it was ported
    (tests/test_torch_phi3.py holds it against JAX), as YaRN is
    (tests/test_torch_mla.py); factor arrays that do not give each of
    the D/2 rotary frequencies one factor are refused, by name."""
    x = torch.ones(2, 1, 8)
    scaling = ((1.0,) * 4, (2.0,) * 4, 1, 1.0)
    out = trope.apply_rope(x, torch.arange(2), 1e4, longrope_scaling=scaling)
    # position 0 is unrotated, position 1 (past the original 1) rotates
    # at the long factors' halved frequencies
    torch.testing.assert_close(out[0], x[0])
    torch.testing.assert_close(out[1:], trope.apply_rope(
        x[1:], torch.tensor([0.5]), 1e4))
    for bad in (((1.0,) * 3, (2.0,) * 4), ((1.0,) * 4, (2.0,) * 8)):
        with pytest.raises(ValueError, match="longrope"):
            trope.apply_rope(x, torch.arange(2), 1e4,
                             longrope_scaling=(*bad, 4096, 1.0))


def test_rms_norm_matches():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(5, 64)).astype(np.float32) * 3
    w = rng.normal(size=(64,)).astype(np.float32)
    ref = jllama.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    out = tllama.rms_norm(_t(x), _t(w), 1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _states(b, v, rng):
    temp = np.full((b,), 0.8, np.float32)
    top_p = np.array([1.0, 0.9, 0.5, 0.3][:b], np.float32)
    top_k = np.array([0, 5, 0, 2][:b], np.int32)
    pres = np.array([0.0, 0.5, 1.0, -0.5][:b], np.float32)
    freq = np.array([0.2, 0.0, 0.3, 1.0][:b], np.float32)
    min_p = np.array([0.0, 0.05, 0.1, 0.0][:b], np.float32)
    bias_ids = np.full((b, smp.BIAS_K), -1, np.int32)
    bias_vals = np.zeros((b, smp.BIAS_K), np.float32)
    bias_ids[0, :3] = [1, 7, v + 3]  # an out-of-vocab id adds nothing
    bias_vals[0, :3] = [5.0, -2.0, 9.0]
    bias_ids[2, :2] = [4, 4]  # duplicate ids accumulate
    bias_vals[2, :2] = [1.5, 2.5]
    args = (temp, top_p, top_k, pres, freq, min_p, bias_ids, bias_vals)
    js = jsmp.make_state(*[jnp.asarray(a) for a in args])
    ts = smp.make_state(*args)
    return js, ts


def test_penalized_and_masks_match():
    rng = np.random.default_rng(9)
    b, v = 4, 50
    logits = rng.normal(size=(b, v)).astype(np.float32) * 2
    counts = rng.integers(0, 3, size=(b, v)).astype(np.int32)
    js, ts = _states(b, v, rng)
    jl, jg = jsmp._penalized(jnp.asarray(logits), js, jnp.asarray(counts))
    tl, tg = smp._penalized(_t(logits), ts, _t(counts))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    scaled = np.asarray(jl) / 0.8
    jm = jsmp._mask_topk_topp(jnp.asarray(scaled), js)
    tm = smp._mask_topk_topp(_t(scaled), ts)
    np.testing.assert_array_equal(np.isinf(tm.numpy()), np.isinf(np.asarray(jm)))
    jp = jsmp._mask_min_p(jnp.asarray(scaled), js)
    tp = smp._mask_min_p(_t(scaled), ts)
    np.testing.assert_array_equal(np.isinf(tp.numpy()), np.isinf(np.asarray(jp)))


def test_greedy_ties_take_the_first_index():
    logits = torch.tensor([[0.0, 3.0, 3.0, 1.0], [2.0, 2.0, 2.0, 2.0]])
    state = smp.make_state([0.0, 0.0], [1.0, 1.0], [0, 0])
    assert smp.sample(logits, state, [0, 0]).tolist() == [1, 0]
    ref = jsmp.sample(jnp.asarray(logits.numpy()),
                      jsmp.make_state(jnp.zeros(2), jnp.ones(2),
                                      jnp.zeros(2, jnp.int32)),
                      jnp.zeros((2, 2), jnp.uint32))
    assert np.asarray(ref).tolist() == [1, 0]


def test_seeded_sampling_is_per_request_whatever_the_batch():
    rng = np.random.default_rng(10)
    v = 64
    row = rng.normal(size=(v,)).astype(np.float32)
    other = rng.normal(size=(3, v)).astype(np.float32)
    seed = smp.fold_in(1234, 17)
    alone = smp.sample(_t(row[None]), smp.make_state([1.0], [1.0], [0]),
                       [seed])
    batch = torch.cat([_t(other[:2]), _t(row[None]), _t(other[2:])])
    mixed = smp.sample(batch, smp.make_state([0.7, 0.0, 1.0, 1.3],
                                             [1.0] * 4, [0] * 4),
                       [5, 6, seed, 7])
    assert int(mixed[2]) == int(alone[0])
    # different positions draw different noise
    draws = {int(smp.sample(_t(np.zeros((1, v), np.float32)),
                            smp.make_state([1.0], [1.0], [0]),
                            [smp.fold_in(1234, p)])[0]) for p in range(20)}
    assert len(draws) > 5


def test_sample_with_logprobs_reports_the_raw_distribution():
    rng = np.random.default_rng(12)
    logits = rng.normal(size=(2, 30)).astype(np.float32)
    bias_ids = np.full((2, smp.BIAS_K), -1, np.int32)
    bias_vals = np.zeros((2, smp.BIAS_K), np.float32)
    bias_ids[0, 0], bias_vals[0, 0] = 3, 50.0  # steers greedy, not logprobs
    args = (np.zeros(2, np.float32), np.ones(2, np.float32),
            np.zeros(2, np.int32), None, None, None, bias_ids, bias_vals)
    toks, chosen, tids, tvals = smp.sample_with_logprobs(
        _t(logits), smp.make_state(*args), [0, 0])
    jt, jc, jids, jvals = jsmp.sample_with_logprobs(
        jnp.asarray(logits),
        jsmp.make_state(*[None if a is None else jnp.asarray(a)
                          for a in args]),
        jnp.zeros((2, 2), jnp.uint32))
    assert toks.tolist() == np.asarray(jt).tolist() and toks[0] == 3
    np.testing.assert_allclose(chosen.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tvals.numpy(), np.asarray(jvals), **TOL)
