"""Speculative decoding in the port against the JAX package's.

At tiny-debug shapes (float32, page size 8, K = 4), with the JAX tree of
PRNGKey(0) carried across by `models.loader.from_jax_params`:

- `sampling.verify_accept` against JAX's on greedy logits (equal
  emitted tokens and acceptance counts); on sampled rows the two
  packages' noise differs by design (ROADMAP queue 3, "Sampling noise"),
  so the port's own property is held: row j draws what a decode step at
  position + j draws.
- `verify_attention_ref` against JAX `verify_attention`, the plain ragged
  attention at decode_q = 5 against the Pallas ragged kernel in interpret
  mode, a verify-only (C = 0) ragged batch against `verify_attention_ref`,
  and `ragged_verify_attention` against the JAX dispatch, on f32 and int8
  pools, at rtol=atol=2e-5.
- `llama.decode_verify` and `llama.mixed_verify_step` logits against
  JAX's, with a slot without room at the end of its table, on f32 and
  int8 pools, at rtol=atol=2e-5 (f32; the int8 pools' bytes may differ by
  one quantization step where two frameworks' matmuls round a value on a
  boundary, as in test_torch_ragged.py); and the room guard beside the
  verify write.
- Engines: greedy n-gram streams equal to the JAX spec engine's and to the
  port's spec-off streams token for token; seeded sampled streams equal
  to spec-off; the mixed spec engine against JAX's; prefix caching, page
  pressure with preemption, and max_seq_len; the logprobs and penalty
  demotions, counted; the knob validation messages equal to JAX's.
- The model drafter: `DraftEngine` proposals against JAX's on the same
  carried draft params, self-draft acceptance, rollback, LRU shedding and
  pool-exhaustion demotion; `AdaptiveK`'s k sequence against JAX's.

The card runs the verify step as a CUDA graph and the draft step as
another (tests/test_torch_cuda.py); here both run eagerly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import sampling as jsmp
from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.engine import Engine as JEngine
from dynamo_tpu.engine.kv_cache import SeqState as JSeqState
from dynamo_tpu.engine.request import GenRequest as JGenRequest
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import PRESETS as JPRESETS
from dynamo_tpu.ops import attention as jatt
from dynamo_tpu.ops import ragged_attention as ra
from dynamo_tpu.speculation import AdaptiveK as JAdaptiveK
from dynamo_tpu_torch.engine import sampling as smp
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import Engine
from dynamo_tpu_torch.engine.kv_cache import SeqState
from dynamo_tpu_torch.engine.request import GenRequest
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models import loader
from dynamo_tpu_torch.models.config import PRESETS
from dynamo_tpu_torch.ops import attention as att
from dynamo_tpu_torch.speculation import AdaptiveK

TOL = dict(rtol=2e-5, atol=2e-5)
PS = 8
K = 4
PROMPT = [5, 6, 7, 5, 6, 7, 5, 6, 7, 5, 6]
BASE = dict(model="tiny-debug", page_size=PS, num_pages=128, max_num_seqs=2,
            max_seq_len=256, num_speculative_tokens=K,
            prefill_chunk_tokens=0, enable_prefix_caching=False)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The engines here run many tiny eager ops (the draft model's B=1
    steps above all): on one thread they are as fast alone and do not
    oversubscribe the cores the parallel test workers share."""
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
    return jcfg, jparams, np_params, model


def _engines(models, spec, jax_too=True, **kw):
    """(the port's engine, the JAX engine or None) for BASE + kw with
    speculative_mode `spec`, on the same weights."""
    _, jparams, _, model = models
    cfg = dict(BASE, speculative_mode=spec, **kw)
    port = Engine(EngineConfig(**cfg), params=model, device="cpu")
    ref = JEngine(JEngineConfig(**cfg), params=jparams) if jax_too else None
    return port, ref


def drive(engine, make_req, reqs, steps=600):
    """Add `reqs` [(rid, prompt, kwargs)] and step until idle: ({rid:
    tokens}, {rid: finish reason})."""
    for rid, prompt, kw in reqs:
        engine.add_request(make_req(rid, prompt, **kw))
    streams, reasons = {}, {}
    for _ in range(steps):
        if not engine.has_work:
            break
        for ev in engine.step():
            if ev.token_id >= 0:
                streams.setdefault(ev.request_id, []).append(ev.token_id)
            if ev.finished:
                reasons[ev.request_id] = ev.finish_reason
    assert not engine.has_work
    return streams, reasons


def _greedy(n, **kw):
    return dict(max_tokens=n, temperature=0.0, ignore_eos=True, **kw)


# ------------------------------------------------------------ sampling --


def test_verify_accept_matches_jax_on_greedy_logits():
    """Slot 0's drafts are its argmax chain (all accepted), slot 1's match
    two rows then miss, slot 2 is ineligible: exact ints."""
    rng = np.random.default_rng(3)
    b, v = 3, 64
    logits = rng.normal(size=(b, K + 1, v)).astype(np.float32)
    arg = logits.argmax(-1)
    drafts = arg[:, :K].copy()
    drafts[1, 2] = (arg[1, 2] + 1) % v
    eligible = np.array([True, True, False])
    positions = np.array([7, 30, 2], np.int32)
    zeros = np.zeros((b,), np.float32)
    jstate = jsmp.make_state(jnp.asarray(zeros), jnp.ones((b,)),
                             jnp.zeros((b,), jnp.int32))
    emitted, n_acc = jsmp.verify_accept(
        jnp.asarray(logits), jnp.asarray(drafts), jstate,
        jax.random.split(jax.random.PRNGKey(0), b), jnp.asarray(positions),
        jnp.asarray(eligible))
    state = smp.make_state(zeros, np.ones((b,)), np.zeros((b,)))
    got_e, got_n = smp.verify_accept(
        _t(logits), _t(drafts), state, torch.tensor([1, 2, 3]),
        _t(positions), _t(eligible))
    assert got_e.tolist() == np.asarray(emitted).tolist()
    assert got_n.tolist() == np.asarray(n_acc).tolist() == [4, 2, 0]


def test_verify_accept_rows_draw_what_decode_steps_draw():
    """Sampled slots (temperature, top-p, top-k, a penalty on row 0): row 0
    is a decode step's draw with the counts, row j a decode step's draw at
    position + j; drafts equal to those draws are all accepted, one miss
    stops the prefix there."""
    rng = np.random.default_rng(5)
    b, v = 3, 128
    logits = _t(rng.normal(size=(b, K + 1, v)).astype(np.float32))
    state = smp.make_state([0.8, 1.0, 0.7], [0.9, 1.0, 1.0], [0, 20, 0],
                           presence=[0.0, 0.0, 0.5])
    keys = torch.tensor([11, 12, 13])
    positions = torch.tensor([3, 40, 9], dtype=torch.int32)
    counts = torch.zeros((b, v), dtype=torch.int32)
    counts[2, logits[2, 0].argmax()] = 3
    rows = [smp.sample(logits[:, 0], state,
                       smp.fold_positions(keys, positions), counts)]
    for j in range(1, K + 1):
        rows.append(smp.sample(logits[:, j], state,
                               smp.fold_positions(keys, positions + j)))
    chain = torch.stack(rows, dim=1)
    drafts = chain[:, :K].clone()
    drafts[1, 1] = (drafts[1, 1] + 1) % v
    emitted, n_acc = smp.verify_accept(
        logits, drafts, state, keys, positions,
        torch.tensor([True, True, False]), counts)
    assert torch.equal(emitted, chain)
    assert n_acc.tolist() == [K, 1, 0]


# ----------------------------------------------------------- attention --


def _pools(rng, quantized, n_pool=32, n_kv=2, d=32, ps=PS):
    kf = rng.normal(size=(n_pool * ps, n_kv, d)).astype(np.float32)
    vf = rng.normal(size=(n_pool * ps, n_kv, d)).astype(np.float32)
    if not quantized:
        return (kf.reshape(n_pool, ps, n_kv * d),
                vf.reshape(n_pool, ps, n_kv * d))
    w = jatt.kv_lane_width(n_kv, d, True)
    return tuple(np.asarray(jatt.pack_kv_rows(jnp.asarray(x), w)).reshape(
        n_pool, ps, w) for x in (kf, vf))


def _verify_inputs(rng, quantized, h=8, n_kv=2, d=32):
    """Three windows of K+1 queries: one at position 0, one crossing a
    page boundary, one ending at its table's last slot; an inactive slot
    (zero table at position 0)."""
    kp, vp = _pools(rng, quantized, n_kv=n_kv, d=d)
    tables = np.array([[1, 0, 0, 0], [2, 3, 4, 0], [5, 6, 7, 8],
                       [0, 0, 0, 0]], np.int32)
    positions = np.array([0, 6, 4 * PS - K - 1, 0], np.int32)
    q = rng.normal(size=(4, K + 1, h, d)).astype(np.float32)
    return q, kp, vp, tables, positions, n_kv


@pytest.mark.parametrize("quantized", [False, True],
                         ids=["f32_pool", "int8_pool"])
def test_verify_attention_ref_matches_jax(quantized):
    q, kp, vp, tables, positions, n_kv = _verify_inputs(
        np.random.default_rng(7), quantized)
    ref = jatt.verify_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(positions), page_size=PS,
        num_kv_heads=n_kv)
    out = att.verify_attention_ref(_t(q), _t(kp), _t(vp), _t(tables),
                                   _t(positions), page_size=PS,
                                   num_kv_heads=n_kv)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    # the dispatch on a CPU tensor is the plain version
    assert torch.equal(att.verify_attention(
        _t(q), _t(kp), _t(vp), _t(tables), _t(positions), page_size=PS,
        num_kv_heads=n_kv), out)


@pytest.mark.parametrize("quantized", [False, True],
                         ids=["f32_pool", "int8_pool"])
def test_verify_only_ragged_batch_equals_verify_attention(quantized):
    """C = 0: B rows of K+1 queries and no chunk, over the descriptors the
    card's verify_attention launches the ragged kernel with."""
    q, kp, vp, tables, positions, n_kv = _verify_inputs(
        np.random.default_rng(9), quantized)
    b, k1, h, d = q.shape
    desc = att.ragged_verify_descriptors(_t(tables), _t(positions), k1)
    assert desc[0][-1].tolist() == [0] * tables.shape[1]
    assert desc[1].tolist() == (positions + k1).tolist() + [0]
    assert desc[2].tolist() == positions.tolist() + [0]
    out = att.ragged_paged_attention_ref(
        _t(q).reshape(b * k1, h, d), _t(kp), _t(vp), *desc, page_size=PS,
        num_kv_heads=n_kv, num_decode=b, decode_q=k1)
    ref = att.verify_attention_ref(_t(q), _t(kp), _t(vp), _t(tables),
                                   _t(positions), page_size=PS,
                                   num_kv_heads=n_kv)
    np.testing.assert_allclose(out.reshape(b, k1, h, d).numpy(),
                               ref.numpy(), **TOL)


@pytest.mark.parametrize("quantized", [False, True],
                         ids=["f32_pool", "int8_pool"])
def test_ragged_plain_matches_pallas_at_verify_width(quantized):
    """decode_q = K+1 = 5 (the verify windows) beside a chunk at position
    16 of a 5-page list, against the Pallas ragged kernel in interpret
    mode (page size 16: the kernel's query block holds the window)."""
    rng = np.random.default_rng(17)
    ps, h, n_kv, d, dq = 16, 8, 2, 64, K + 1
    kp, vp = _pools(rng, quantized, n_pool=64, n_kv=n_kv, d=d, ps=ps)
    tables = np.zeros((4, 6), np.int32)
    tables[0, :1] = [1]
    tables[1, :3] = [2, 3, 4]
    tables[2, :6] = np.arange(10, 16)
    tables[3, :5] = [20, 21, 22, 23, 24]
    ctx = np.array([dq, 2 * ps + 5, 6 * ps], np.int32)
    start, c = 16, 32
    kv_lens = np.append(ctx, start + c).astype(np.int32)
    q_starts = np.append(ctx - dq, start).astype(np.int32)
    q = rng.normal(size=(3 * dq + c, h, d)).astype(np.float32)
    ref = ra.ragged_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(kv_lens), jnp.asarray(q_starts), page_size=ps,
        num_kv_heads=n_kv, num_decode=3, decode_q=dq, interpret=True)
    out = att.ragged_paged_attention_ref(
        _t(q), _t(kp), _t(vp), _t(tables), _t(kv_lens), _t(q_starts),
        page_size=ps, num_kv_heads=n_kv, num_decode=3, decode_q=dq)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("backend", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("quantized", [False, True],
                         ids=["f32_pool", "int8_pool"])
def test_ragged_verify_attention_matches_jax_dispatch(monkeypatch, backend,
                                                      quantized):
    q, kp, vp, tables, positions, n_kv = _verify_inputs(
        np.random.default_rng(23), quantized)
    b, k1, h, d = q.shape
    rng = np.random.default_rng(24)
    chunk = rng.normal(size=(2 * PS, h, d)).astype(np.float32)
    qr = np.concatenate([q.reshape(b * k1, h, d), chunk])
    p_pages = np.array([9, 10, 11, 0, 0], np.int32)
    monkeypatch.setenv("DYNAMO_TPU_RAGGED_ATTENTION", backend)
    ref = jatt.ragged_verify_attention(
        jnp.asarray(qr), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(positions), jnp.asarray(p_pages),
        PS, page_size=PS, num_kv_heads=n_kv, num_verify=b, verify_width=k1)
    out = att.ragged_verify_attention(
        _t(qr), _t(kp), _t(vp), _t(tables), _t(positions), _t(p_pages), PS,
        page_size=PS, num_kv_heads=n_kv, num_verify=b, verify_width=k1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


# --------------------------------------------------------------- model --


def _model_pools(jcfg, rng, quantized, n_pool=24):
    pools = [_pools(rng, quantized, n_pool=n_pool, n_kv=jcfg.num_kv_heads,
                    d=jcfg.head_dim) for _ in range(jcfg.num_layers)]
    return (np.stack([p[0] for p in pools]), np.stack([p[1] for p in pools]))


def _pools_close(got, want, quantized, n_kv, d):
    want = np.asarray(want)
    if not quantized:
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        return
    # see the module doc: one int8 step at most, on few bytes
    assert (got.numpy() != want).mean() < 1e-3
    step = att.unpack_kv_rows(_t(want), n_kv, d).abs().amax(-1) / 127
    diff = (att.unpack_kv_rows(got, n_kv, d)
            - att.unpack_kv_rows(_t(want), n_kv, d)).abs()
    assert bool((diff <= 1.01 * step[..., None] + 1e-6).all())


def _verify_batch(jcfg, rng):
    """Slot 0 mid-page, slot 1 at the end of its 3-page table without room
    (its drafts would run past the table), slot 2 inactive."""
    tokens = rng.integers(0, jcfg.vocab_size, size=(3, K + 1)).astype(
        np.int32)
    positions = np.array([10, 3 * PS - 2, 0], np.int32)
    tables = np.array([[1, 2, 0], [3, 4, 5], [0, 0, 0]], np.int32)
    room = np.array([True, False, False])
    return tokens, positions, tables, room


@pytest.mark.parametrize("quantized", [False, True],
                         ids=["f32_pool", "int8_pool"])
def test_decode_verify_matches_jax(models, quantized):
    jcfg, jparams, _, model = models
    rng = np.random.default_rng(31)
    kp, vp = _model_pools(jcfg, rng, quantized)
    tokens, positions, tables, room = _verify_batch(jcfg, rng)
    ref = jllama.decode_verify(
        jcfg, jparams, jnp.asarray(tokens), jnp.asarray(positions),
        jnp.asarray(tables), jnp.asarray(room), jnp.asarray(kp),
        jnp.asarray(vp), page_size=PS)
    tk, tv = _t(kp), _t(vp)
    logits = tllama.decode_verify(model, _t(tokens), _t(positions),
                                  _t(tables), _t(room), tk, tv, page_size=PS)
    assert logits.shape == (3, K + 1, jcfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref.logits), **TOL)
    for got, want in ((tk, ref.k_pages), (tv, ref.v_pages)):
        _pools_close(got, want, quantized, jcfg.num_kv_heads, jcfg.head_dim)


@pytest.mark.parametrize("quantized", [False, True],
                         ids=["f32_pool", "int8_pool"])
def test_mixed_verify_step_matches_jax(models, quantized):
    """decode_verify's batch beside the second 16-token chunk (9 valid) of
    a prompt, against JAX's ragged verify (its XLA composition: the Pallas
    kernel's lane gate refuses tiny-debug's 64-lane rows). The ragged
    descriptors pad each window's table with trash pages to the chunk
    list's width, as JAX's kernel path does, so the draft rows of the slot
    without room, whose positions run past its table, see the trash page
    there where the XLA composition sees no key: rows the engine discards
    (their acceptance is 0), left out of the comparison."""
    jcfg, jparams, _, model = models
    rng = np.random.default_rng(37)
    kp, vp = _model_pools(jcfg, rng, quantized)
    tokens, positions, tables, room = _verify_batch(jcfg, rng)
    chunk = np.zeros((2 * PS,), np.int32)
    chunk[:9] = rng.integers(0, jcfg.vocab_size, size=9)
    chunk_pages = np.array([6, 7, 8, 9, 0], np.int32)
    ref = jllama.mixed_verify_step(
        jcfg, jparams, jnp.asarray(tokens), jnp.asarray(positions),
        jnp.asarray(tables), jnp.asarray(room), jnp.asarray(chunk),
        jnp.int32(2 * PS), jnp.int32(9), jnp.asarray(chunk_pages),
        jnp.asarray(kp), jnp.asarray(vp), page_size=PS)
    tk, tv = _t(kp), _t(vp)
    logits, chunk_logits = tllama.mixed_verify_step(
        model, _t(tokens), _t(positions), _t(tables), _t(room), _t(chunk),
        2 * PS, 9, _t(chunk_pages), tk, tv, page_size=PS)
    want = np.asarray(ref.logits)
    kept = np.ones(want.shape[:2], bool)
    kept[1, 1:] = False
    np.testing.assert_allclose(logits.numpy()[kept], want[kept], **TOL)
    np.testing.assert_allclose(chunk_logits.numpy(),
                               np.asarray(ref.chunk_logits), **TOL)
    for got, want in ((tk, ref.k_pages), (tv, ref.v_pages)):
        _pools_close(got, want, quantized, jcfg.num_kv_heads, jcfg.head_dim)


def test_verify_write_room_guard(models):
    """The room contract keeps a window's writes inside its table: a slot
    at its table's end without room writes only its current token (the
    draft rows go to the trash page, whose other rows stay untouched);
    the same window claiming room would index past the table, which
    torch refuses (on the card, inside a graph, a device-side assert)."""
    jcfg, _, _, model = models
    kp, vp = _model_pools(jcfg, np.random.default_rng(41), False)
    tokens, positions, tables, room = _verify_batch(
        jcfg, np.random.default_rng(2))
    tk, tv = _t(kp), _t(vp)
    tllama.decode_verify(model, _t(tokens), _t(positions), _t(tables),
                         _t(room), tk, tv, page_size=PS)
    # slot 1 wrote position 3 * PS - 2 (page 5, row PS - 2) and nothing
    # after it: page 5's last row and every page it does not own are kept
    assert not np.array_equal(tk[:, 5, PS - 2].numpy(), kp[:, 5, PS - 2])
    np.testing.assert_array_equal(tk[:, 5, PS - 1].numpy(), kp[:, 5, PS - 1])
    np.testing.assert_array_equal(tk[:, 10:].numpy(), kp[:, 10:])
    np.testing.assert_array_equal(tk[:, 0, 1:].numpy(), kp[:, 0, 1:])
    with pytest.raises((IndexError, RuntimeError)):
        tllama.decode_verify(model, _t(tokens), _t(positions), _t(tables),
                             torch.ones(3, dtype=torch.bool), tk, tv,
                             page_size=PS)


# ------------------------------------------------------------- engines --


def test_ngram_greedy_streams_match_jax_and_spec_off(models):
    """Two concurrent greedy requests (one repetitive prompt that drafts
    well), one with a stop token that first occurs mid-chain."""
    off, _ = _engines(models, "off", jax_too=False)
    probe, _ = drive(off, GenRequest, [("a", PROMPT, _greedy(24))])
    stop = next(t for i, t in enumerate(probe["a"])
                if i >= 5 and t not in probe["a"][:i])
    reqs = [("a", PROMPT, _greedy(24)),
            ("b", list(range(40, 60)), _greedy(20, stop_token_ids=[stop]))]
    off2, _ = _engines(models, "off", jax_too=False)
    want = drive(off2, GenRequest, reqs)
    eng, jeng = _engines(models, "ngram")
    got = drive(eng, GenRequest, reqs)
    assert got == drive(jeng, JGenRequest, reqs) == want
    m = eng.metrics
    assert m.spec_verify_steps > 0 and m.spec_draft_tokens > 0
    assert m.spec_accepted_tokens > 0
    assert m.decode_steps < sum(map(len, got[0].values()))
    snap = m.snapshot()
    assert snap["spec_by_drafter"]["ngram"]["draft_tokens"] == \
        m.spec_draft_tokens
    assert m.spec_accept_count == sum(m.spec_accept_buckets)
    assert eng.allocator.free_pages == BASE["num_pages"] - 1


def test_sampled_streams_match_spec_off(models):
    """Seeded sampled requests (top-p, top-k, a logit bias) beside a
    greedy one: spec on emits what spec off emits."""
    reqs = [("s", PROMPT, dict(max_tokens=20, temperature=0.9, seed=7,
                               ignore_eos=True)),
            ("t", list(range(1, 15)), dict(max_tokens=18, temperature=0.7,
                                           top_p=0.9, top_k=40, seed=8,
                                           logit_bias={5: 2.0},
                                           ignore_eos=True)),
            ("g", PROMPT, _greedy(16))]
    want = drive(_engines(models, "off", jax_too=False)[0], GenRequest, reqs)
    eng, _ = _engines(models, "ngram", jax_too=False)
    assert drive(eng, GenRequest, reqs) == want
    assert eng.metrics.spec_verify_steps > 0


def test_mixed_spec_engine_matches_jax(models):
    """A live stream, then a 50-token prompt whose chunks ride the mixed
    verify step (chunks of 16) while the stream speculates."""
    cfg = dict(mixed_batch_tokens=2 * PS, prefill_chunk_tokens=2 * PS,
               max_num_seqs=4)
    long_prompt = [(i * 11) % 300 + 1 for i in range(50)]

    def run(eng, make_req):
        out = {"live": [], "long": []}
        eng.add_request(make_req("live", PROMPT, **_greedy(20)))
        for i in range(200):
            if i == 2:
                eng.add_request(make_req("long", long_prompt, **_greedy(6)))
            if i > 2 and not eng.has_work:
                break
            for ev in eng.step():
                if ev.token_id >= 0:
                    out[ev.request_id].append(ev.token_id)
        return out

    eng, jeng = _engines(models, "ngram", **cfg)
    got = run(eng, GenRequest)
    assert got == run(jeng, JGenRequest)
    assert got == run(_engines(models, "off", jax_too=False, **cfg)[0],
                      GenRequest)
    assert eng.metrics.mixed_spec_count >= 2
    assert eng.metrics.mixed_count == eng.metrics.mixed_spec_count
    assert eng.allocator.free_pages == BASE["num_pages"] - 1


@pytest.mark.parametrize("case", ["prefix_cache", "page_pressure",
                                  "max_seq_len"])
def test_spec_streams_under_pressure_match_spec_off(models, case):
    """Prefix caching with chunked prefill (a repeated prompt hits the
    cache); a pool too small for every sequence (admission defers, decode
    preempts by recompute, windows lose their room); a max_seq_len barely
    above the prompts (rooms run out near the limit)."""
    if case == "prefix_cache":
        kw = dict(prefill_chunk_tokens=PS, enable_prefix_caching=True)
        reqs = [("a", list(range(1, 30)), _greedy(20)),
                ("b", list(range(1, 30)), _greedy(12))]
    elif case == "page_pressure":
        kw = dict(num_pages=10, max_seq_len=96, max_num_seqs=3)
        reqs = [(f"r{i}", [(3 * i + j) % 7 + 1 for j in range(n)],
                 _greedy(30)) for i, n in enumerate([14, 18, 11])]
    else:
        kw = dict(max_seq_len=20, num_pages=32)
        reqs = [("a", PROMPT, _greedy(16)), ("b", PROMPT[:6], _greedy(16))]
    want = drive(_engines(models, "off", jax_too=False, **kw)[0], GenRequest,
                 reqs)
    eng, _ = _engines(models, "ngram", jax_too=False, **kw)
    assert drive(eng, GenRequest, reqs) == want
    m = eng.metrics
    assert m.spec_verify_steps > 0
    if case == "prefix_cache":
        assert eng.prefix_cache.stats()["hits"] >= 1
    elif case == "page_pressure":
        assert m.num_preempted > 0
        assert m.spec_demotions.get("page_shortfall", 0) > 0
    else:
        assert m.spec_demotions.get("page_shortfall", 0) > 0
    cached = eng.prefix_cache.evictable() if eng.prefix_cache else 0
    assert eng.allocator.free_pages + cached == kw.get("num_pages", 128) - 1


def test_logprobs_and_penalty_demotions_are_counted(models):
    """A logprobs request demotes whole steps to plain decode (the
    logprobs equal spec-off's); a penalized slot emits one token per
    verify step; both counted, streams unchanged."""
    reqs = [("lp", PROMPT, _greedy(8, logprobs=2))]
    off, _ = _engines(models, "off", jax_too=False)
    eng, _ = _engines(models, "ngram", jax_too=False)
    lp_off, lp_on = [], []
    for e, out in ((off, lp_off), (eng, lp_on)):
        e.add_request(GenRequest(*reqs[0][:2], **reqs[0][2]))
        while e.has_work:
            out += [(ev.token_id, ev.logprob, ev.top_logprobs)
                    for ev in e.step() if ev.token_id >= 0]
    assert lp_on == lp_off and len(lp_on) == 8
    assert eng.metrics.spec_demotions["logprobs"] > 0
    assert eng.metrics.spec_verify_steps == 0
    pen = [("p", PROMPT, _greedy(12, presence_penalty=0.8)),
           ("g", PROMPT, _greedy(12))]
    want = drive(_engines(models, "off", jax_too=False)[0], GenRequest, pen)
    eng, _ = _engines(models, "ngram", jax_too=False)
    assert drive(eng, GenRequest, pen) == want
    assert eng.metrics.spec_demotions["penalties"] > 0
    assert eng.metrics.spec_draft_tokens > 0  # the greedy slot drafted


@pytest.mark.parametrize("kw", [
    dict(num_speculative_tokens=0), dict(num_speculative_tokens=PS),
    dict(ngram_lookup=0), dict(drafter="other"),
    dict(drafter="model", draft_model="tiny-debug", draft_num_pages=3)],
    ids=["k0", "k_page", "ngram0", "drafter", "draft_pages"])
def test_knob_validation_messages_equal_jax(kw):
    cfg = dict(BASE, speculative_mode="ngram", **kw)
    with pytest.raises(ValueError) as jexc:
        JEngine(JEngineConfig(**cfg))
    with pytest.raises(ValueError) as exc:
        Engine(EngineConfig(**cfg), device="cpu")
    assert str(exc.value) == str(jexc.value)


def test_spec_off_knobs_are_inert_and_drafter_needs_a_model():
    Engine(EngineConfig(**dict(BASE, num_speculative_tokens=0)),
           device="cpu")
    with pytest.raises(ValueError, match="draft-model"):
        Engine(EngineConfig(**dict(BASE, speculative_mode="model")),
               device="cpu")


def _seq(cls, prompt, out):
    seq = cls("r", 0, [1], prompt_len=len(prompt), max_tokens=8)
    seq.prompt_ids, seq.output_tokens = list(prompt), list(out)
    return seq


def test_ngram_proposer_matches_jax(models):
    """A match with a continuation, no match (repeat the last token), a
    match running into the history's end, a one-token history."""
    eng, jeng = _engines(models, "ngram")
    cases = (([1, 2, 3, 9, 1, 2], []), ([4, 5, 6, 7], []),
             ([1, 2, 3, 1, 2, 3, 1], [2]), ([8], []))
    got = [eng._propose_ngram(_seq(SeqState, *c)) for c in cases]
    assert got == [jeng._propose_ngram(_seq(JSeqState, *c)) for c in cases]
    assert got[0] == [3, 9, 1, 2] and got[1] == [7] * K


# ------------------------------------------------------- model drafter --


def _draft_engines(models, jax_too=True, self_draft=False, **kw):
    """The model drafter on tiny-debug: the JAX engine's draft params
    (PRNG seed + 1) carried into the port, or the target's own weights."""
    _, jparams, np_params, model = models
    cfg = dict(BASE, speculative_mode="model", draft_model="tiny-debug", **kw)
    jeng = JEngine(JEngineConfig(**cfg), params=jparams) if jax_too else None
    if jeng is not None and self_draft:
        jeng.draft.params = jeng.params
    if self_draft:
        draft = model
    elif jeng is not None:
        draft = {k: np.asarray(v) for k, v in jeng.draft.params.items()}
    else:
        draft = None
    eng = Engine(EngineConfig(**cfg), params=model, device="cpu",
                 draft_params=draft)
    return eng, jeng


def test_draft_engine_proposals_and_streams_match_jax(models):
    """Distinct draft weights: the same proposals for one history, then
    (rejections and rollbacks) the same streams and draft books."""
    eng, jeng = _draft_engines(models)
    assert eng.draft.model_cfg.num_layers == jeng.draft.model_cfg.num_layers
    props = []
    for e, cls in ((eng, SeqState), (jeng, JSeqState)):
        seq = _seq(cls, PROMPT, [3])
        props.append([e.draft.propose(seq, K), e.draft.propose(seq, 2)])
        e.draft.release(0)
    assert props[0] == props[1]
    reqs = [("a", PROMPT, _greedy(16)), ("b", list(range(30, 45)),
                                         _greedy(12))]
    got = drive(eng, GenRequest, reqs)
    assert got == drive(jeng, JGenRequest, reqs)
    want = drive(_engines(models, "off", jax_too=False)[0], GenRequest, reqs)
    assert got == want
    keys = ("draft_steps", "catchup_tokens", "rollbacks",
            "rolled_back_tokens", "evictions")
    assert {k: eng.draft.stats()[k] for k in keys} == \
        {k: jeng.draft.stats()[k] for k in keys}
    assert eng.draft.stats()["rollbacks"] > 0
    assert eng.metrics.snapshot()["spec_by_drafter"]["model"]["draft_tokens"] \
        == eng.metrics.spec_draft_tokens > 0
    assert eng.draft.allocator.free_pages == eng.draft.num_pages - 1


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "seeded"])
def test_self_draft_streams_match_spec_off(models, sampled):
    """A draft that is the target: greedy streams accept nearly every
    draft (its greedy drafts are the chain), seeded sampled ones whatever
    the chain draws; both equal spec-off's."""
    kw = (dict(max_tokens=20, temperature=0.8, seed=42, ignore_eos=True)
          if sampled else _greedy(24))
    reqs = [("a", PROMPT, kw), ("b", list(range(2, 20)), kw)]
    want = drive(_engines(models, "off", jax_too=False)[0], GenRequest, reqs)
    eng, _ = _draft_engines(models, jax_too=False, self_draft=True)
    assert drive(eng, GenRequest, reqs) == want
    m = eng.metrics
    assert m.spec_draft_tokens > 0
    if not sampled:
        assert m.spec_accepted_tokens >= 0.9 * m.spec_draft_tokens
        assert m.decode_steps <= 24 // (K + 1) + 2


def test_draft_pool_sheds_lru_and_demotes_when_exhausted(models):
    """A draft pool too small for two histories sheds the least recently
    drafting slot (which catches up again); a window the pool cannot cover
    even then demotes its slot, counted. Streams equal spec-off's."""
    reqs = [("a", PROMPT, _greedy(24)), ("b", PROMPT, _greedy(24))]
    want = drive(_engines(models, "off", jax_too=False)[0], GenRequest, reqs)
    eng, _ = _draft_engines(models, jax_too=False, self_draft=True,
                            draft_num_pages=8)
    assert drive(eng, GenRequest, reqs) == want
    assert eng.draft.evictions > 0 and eng.draft.catchup_tokens > 0
    long_prompt = list(range(1, 61))  # 8 pages > the 5 a 6-page pool has
    reqs = [("l", long_prompt, _greedy(6))]
    want = drive(_engines(models, "off", jax_too=False)[0], GenRequest, reqs)
    eng, _ = _draft_engines(models, jax_too=False, self_draft=True,
                            draft_num_pages=6)
    assert drive(eng, GenRequest, reqs) == want
    assert eng.metrics.spec_demotions["draft_pool"] > 0


def test_adaptive_k_sequence_matches_jax_and_streams_hold(models):
    series = [(4, 4), (4, 4), (0, 4), (2, 2), (2, 2), (2, 2), (1, 3),
              (3, 3), (3, 3), (0, 3), (0, 1), (1, 1), (1, 1)]
    port, ref = AdaptiveK(4), JAdaptiveK(4)
    ks = []
    for n_acc, used in series:
        ks.append((port.k(0), ref.k(0)))
        port.update(0, n_acc, used)
        ref.update(0, n_acc, used)
    assert all(a == b for a, b in ks) and port.snapshot() == ref.snapshot()
    assert len({a for a, _ in ks}) > 2
    port.reset(0)
    assert port.k(0) == 4
    reqs = [("a", PROMPT, _greedy(20)), ("b", list(range(50, 70)),
                                         _greedy(16))]
    want = drive(_engines(models, "off", jax_too=False)[0], GenRequest, reqs)
    eng, _ = _engines(models, "ngram", jax_too=False, spec_adaptive_k=True)
    assert drive(eng, GenRequest, reqs) == want
    assert eng._adaptive.snapshot() == {}  # every slot reset at its finish
