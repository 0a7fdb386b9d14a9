"""JSON-guided decoding and forced tool calls in the port against the JAX
package's.

- The grammar (`ops/json_guide.py`): the port's numpy copy, its torch
  version (`transition_torch`, `token_mask_torch`, `mask_logits`,
  `advance`, which the CPU path of `ops/cuda_guide.py` runs) and its
  scalar version (`transition_scalar`, `advance_scalar`, `replay_scalar`:
  the engine's host mirror) against
  `dynamo_tpu.ops.json_guide`, exactly: `transition` over every mode x
  all 256 bytes at several (depth, bits), depth 31 and bit 31 included;
  `token_mask` on `for_byte_vocab` and on a synthetic 16-byte-wide table
  (stop tokens, specials, pieces of 1-16 bytes) from replayed states;
  `replay`, `advance_host`, `mask_row` and `validate_json_text`.
- Engines at tiny-debug shapes (float32, the JAX tree of PRNGKey(0)):
  guided greedy streams equal to the JAX engine's token for token; seeded
  guided streams the same in 1-step, 8-step and async windows, and each
  one that stops a complete JSON object; a preempted guided stream resumes
  the same; speculation demoted with reason "guided"; no mixed step while
  a guided sequence is live; the first token masked by the grammar
  kernel's wrapper on the prefill logits, from a continuation's replayed
  state.
- The in-process server: response_format on chat and completions, a
  forced tool call answered with tool_calls, and a streamed forced tool
  call refused with 400.

The card runs the mask and the state advance as the CUDA kernel inside
the captured decode step (tests/test_torch_cuda.py, chip_smoke.py).
"""

import dataclasses
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.engine import Engine as JEngine
from dynamo_tpu.engine.request import GenRequest as JGenRequest
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import PRESETS as JPRESETS
from dynamo_tpu.ops import json_guide as jjg
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import Engine
from dynamo_tpu_torch.engine.request import GenRequest
from dynamo_tpu_torch.engine.tokenizer import ByteTokenizer
from dynamo_tpu_torch.models import loader
from dynamo_tpu_torch.models.config import PRESETS
from dynamo_tpu_torch.ops import cuda_guide
from dynamo_tpu_torch.ops import json_guide as jg
from dynamo_tpu_torch.serving import api

PS = 8
BASE = dict(model="tiny-debug", page_size=PS, num_pages=128, max_num_seqs=4,
            max_seq_len=256, prefill_chunk_tokens=0,
            enable_prefix_caching=False)
TOK = ByteTokenizer()
TEXTS = ['{"a": [1, -2.5e+3, true, false, null], "b": {"c": "x\\u00e9"}}',
         '{ "k" : [ [ [ {} ] ] ] , "z":0.5}', '{"x": 01}', '{"a":1}}',
         '[1]', '{"s": "tab\tinside"}', '{"e": 1e}', '{}']


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module: the parallel test workers share
    the cores, and torch's default pool in each of them oversubscribes
    them (the suite's tiny eager ops are as fast on one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def synthetic_table(v=600, seed=0):
    """A 16-byte-wide table: pieces of 1-16 bytes drawn mostly from JSON's
    alphabet, some specials (no bytes) and stop tokens."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b'{}[]",:0123456789-.eE+tfnrulas \\/\n', np.uint8)
    tb = np.full((v, 16), -1, np.int32)
    tl = rng.integers(1, 17, size=v).astype(np.int32)
    tl = np.where(rng.random(v) < 0.7, np.minimum(tl, 3), tl)
    for i in range(v):
        src = alpha if rng.random() < 0.85 else np.arange(32, 256)
        tb[i, :tl[i]] = rng.choice(src, tl[i])
    tl[:10] = 0  # specials
    eos = np.zeros(v, bool)
    eos[10:13] = True
    tl[10:13] = 0
    return tb, tl, eos


def _states():
    """Grammar states (mode, depth, bits) reached by prefixes of TEXTS,
    and every mode at depths 0, 1, 5 and 31 with random bits."""
    out = {(jjg.START, 0, 0)}
    for t in TEXTS:
        m, d, b = np.int32(0), np.int32(0), np.int32(0)
        for c in t.encode():
            m, d, b = jjg.transition(np, m, d, b, np.int32(c))
            out.add((int(m), int(d), int(b)))
    rng = np.random.default_rng(5)
    for depth in (0, 1, 5, 31):
        for mode in range(jjg.DEAD + 1):
            out.add((mode, depth, int(rng.integers(-2**31, 2**31))))
    return sorted(out)


@pytest.mark.parametrize("depth,bits", [
    (0, 0), (1, 1), (5, 0b10110), (30, -1), (31, -2**31), (31, 0x5A5A5A5A),
    (2, 0)])
def test_transition_matches_jax_every_mode_and_byte(depth, bits):
    mode = np.repeat(np.arange(jjg.DEAD + 1, dtype=np.int32), 256)
    c = np.tile(np.arange(256, dtype=np.int32), jjg.DEAD + 1)
    d = np.full_like(mode, depth)
    b = np.full_like(mode, bits)
    want = jjg.transition(np, mode, d, b, c)
    got_np = jg.transition(np, mode, d, b, c)
    got_t = jg.transition_torch(*(torch.from_numpy(a) for a in (mode, d, b,
                                                                 c)))
    for w, n, t in zip(want, got_np, got_t):
        np.testing.assert_array_equal(n, w)
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), w)
    scalar = np.array([jg.transition_scalar(int(m), depth, bits, int(x))
                       for m, x in zip(mode, c)])
    np.testing.assert_array_equal(scalar, np.stack(want, axis=1))


@pytest.mark.parametrize("kind", ["byte_vocab", "synthetic_16"])
def test_token_mask_matches_jax(kind):
    if kind == "byte_vocab":
        jt = jjg.VocabTable.for_byte_vocab(300, [257, 299])
        pt = jg.VocabTable.for_byte_vocab(300, [257, 299])
    else:
        tb, tl, eos = synthetic_table()
        jt, pt = jjg.VocabTable(tb, tl, eos), jg.VocabTable(tb, tl, eos)
    states = np.asarray(_states(), np.int32)
    m, d, b = states.T
    want = jjg.token_mask(np, m, d, b, jt.token_bytes, jt.token_len,
                          jt.eos_mask)
    assert want.any() and not want.all()
    np.testing.assert_array_equal(
        jg.token_mask(np, m, d, b, pt.token_bytes, pt.token_len,
                      pt.eos_mask), want)
    dt = jg.DeviceTable(pt, "cpu")
    mt, dtt, bt = (torch.from_numpy(np.ascontiguousarray(a)) for a in
                   (m, d, b))
    np.testing.assert_array_equal(
        jg.token_mask_torch(mt, dtt, bt, dt).numpy(), want)
    # the wrapper's CPU path: -1e9 where a guided row allows nothing
    rng = np.random.default_rng(1)
    logits = rng.standard_normal(want.shape).astype(np.float32)
    active = rng.random(len(states)) < 0.8
    masked = torch.from_numpy(logits.copy())
    cuda_guide.json_mask(masked, mt, dtt, bt, torch.from_numpy(active), dt)
    np.testing.assert_array_equal(
        masked.numpy(),
        np.where(active[:, None] & ~want, np.float32(-1e9), logits))
    for i in (0, len(states) // 2):
        np.testing.assert_array_equal(jg.mask_row(pt, *states[i]),
                                      jjg.mask_row(jt, *states[i]))


def test_advance_replay_and_validation_match_jax():
    tb, tl, eos = synthetic_table()
    jt, pt = jjg.VocabTable(tb, tl, eos), jg.VocabTable(tb, tl, eos)
    dt = jg.DeviceTable(pt, "cpu")
    rng = np.random.default_rng(2)
    seqs = [list(rng.integers(0, len(tl), size=n)) for n in (1, 5, 30)]
    for toks in seqs + [[]]:
        want = jjg.replay(jt, toks)
        assert jg.replay(pt, toks) == want
        assert jg.replay_scalar(pt, toks) == want
        state = scalar = (jg.START, 0, 0)
        for t in toks:
            state = jg.advance_host(pt, state, int(t))
            scalar = jg.advance_scalar(pt, scalar, int(t))
            assert scalar == state
        assert state == want
    # tokens chosen so the grammar survives: every fold of the host
    # mirror's fast path against JAX's along a stream that stays alive
    state = want = (jg.START, 0, 0)
    for step in range(24):
        allow = jjg.mask_row(jt, *want)
        if not allow.any():
            break
        tok = int(rng.choice(np.flatnonzero(allow)))
        state = jg.advance_scalar(pt, state, tok)
        want = jjg.advance_host(jt, want, tok)
        assert state == want
    assert step > 5
    states = np.asarray(_states(), np.int32)
    toks = rng.integers(0, len(tl), size=len(states))
    active = rng.random(len(states)) < 0.8
    want = jjg.fold_bytes(np, states[:, 0], states[:, 1], states[:, 2],
                          jt.token_bytes[toks], jt.token_len[toks])
    m, d, b = (torch.from_numpy(np.ascontiguousarray(a))
               for a in states.T)
    cuda_guide.json_advance(torch.from_numpy(toks), m, d, b,
                            torch.from_numpy(active), dt)
    for got, w, old in zip((m, d, b), want[:3], states.T):
        np.testing.assert_array_equal(got.numpy(),
                                      np.where(active, w, old))
    for text in TEXTS:
        assert jg.validate_json_text(text) == jjg.validate_json_text(text)
        try:
            parsed = isinstance(json.loads(text), dict)
        except ValueError:
            parsed = False
        assert jg.validate_json_text(text) == parsed, text


# ---------------------------------------------------------------- engines --


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(JPRESETS["tiny-debug"], dtype="float32")
    tcfg = dataclasses.replace(PRESETS["tiny-debug"], dtype="float32")
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    model = loader.from_jax_params(
        tcfg, {k: np.asarray(v) for k, v in jparams.items()}, device="cpu",
        dtype=torch.float32)
    return jparams, model


def _port(models, **kw):
    return Engine(EngineConfig(**dict(BASE, **kw)), params=models[1],
                  device="cpu")


def drive(engine, make_req, reqs, steps=800):
    """Add reqs [(rid, prompt, kwargs)], step until idle: ({rid: tokens},
    {rid: finish reason})."""
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


def _guided(n=48, **kw):
    return dict(max_tokens=n, guided_json=True, **kw)


GREEDY = [("g0", TOK.encode("Reply in JSON."), _guided()),
          ("g1", TOK.encode("{"), _guided(32)),
          ("g2", TOK.encode("An object, please: "), _guided(40)),
          ("plain", TOK.encode("free text"), dict(max_tokens=12))]
SAMPLED = [(f"s{i}", TOK.encode(f"json {i}"),
            _guided(64, temperature=1.0, seed=10 + i)) for i in range(3)]


def _json_ok(tokens, reason):
    """A stream that stops is one complete JSON object (its stop token
    excluded)."""
    if reason != "stop":
        return True
    return jg.validate_json_text(TOK.decode(tokens[:-1]))


def _logprobs(engine, make_req, rid, prompt, kw):
    """A request's (token, logprob, top logprobs) per emitted token."""
    engine.add_request(make_req(rid, prompt, **kw))
    out = []
    while engine.has_work:
        out += [(e.token_id, e.logprob, e.top_logprobs)
                for e in engine.step() if e.token_id >= 0]
    return out


def test_guided_greedy_streams_match_jax(models):
    """Tokens and finish reasons; and one guided stream's logprobs, which
    both packages take from the grammar-masked logits (the first token's
    too), within 1e-4."""
    jparams, _ = models
    ref = JEngine(JEngineConfig(**BASE), params=jparams)
    want, want_r = drive(ref, JGenRequest, GREEDY)
    port = _port(models, num_scheduler_steps=8)
    got, got_r = drive(port, GenRequest, GREEDY)
    assert got == want and got_r == want_r
    lp_req = ("lp", TOK.encode("{"), _guided(12, logprobs=3))
    want_lp = _logprobs(ref, JGenRequest, *lp_req)
    got_lp = _logprobs(port, GenRequest, *lp_req)
    assert [t for t, _, _ in got_lp] == [t for t, _, _ in want_lp]
    for (_, g, gtop), (_, w, wtop) in zip(got_lp, want_lp):
        assert g == pytest.approx(w, abs=1e-4)
        np.testing.assert_allclose([v for _, v in gtop],
                                   [v for _, v in wtop], atol=1e-4)
        # masked alternatives tie at about -1e9, in no defined order
        assert ([i for i, v in gtop if v > -1e6]
                == [i for i, v in wtop if v > -1e6])
    assert any(r == "stop" for r in got_r.values())
    for rid, _, _ in GREEDY[:3]:
        assert _json_ok(got[rid], got_r[rid]), TOK.decode(got[rid])


def test_seeded_guided_streams_are_json_whatever_the_window(models):
    runs = [drive(_port(models, **kw), GenRequest, SAMPLED + GREEDY[:1])
            for kw in (dict(num_scheduler_steps=1, async_scheduling=False),
                       dict(num_scheduler_steps=8, async_scheduling=False),
                       dict(num_scheduler_steps=8, async_scheduling=True))]
    assert runs[1] == runs[0] and runs[2] == runs[0]
    streams, reasons = runs[0]
    assert any(r == "stop" for r in reasons.values())
    for rid, toks in streams.items():
        assert _json_ok(toks, reasons[rid]), TOK.decode(toks)


def test_preempted_guided_stream_resumes_the_same(models):
    reqs = [(f"p{i}", TOK.encode("x" * 20 + str(i)),
             _guided(40, temperature=1.0, seed=i, ignore_eos=True))
            for i in range(4)]
    want, _ = drive(_port(models), GenRequest, reqs)
    tight = _port(models, num_pages=14)
    got, _ = drive(tight, GenRequest, reqs)
    assert tight.metrics.num_preempted > 0
    assert got == want


def test_guided_sequences_demote_speculation(models):
    spec = _port(models, speculative_mode="ngram", num_speculative_tokens=4)
    got = drive(spec, GenRequest, GREEDY)
    assert spec.metrics.spec_demotions.get("guided", 0) > 0
    assert got == drive(_port(models), GenRequest, GREEDY)


def test_no_mixed_step_while_a_guided_sequence_is_live(models):
    long_prompt = TOK.encode("y" * 60)

    def run(guided):
        eng = _port(models, mixed_batch_tokens=16, max_seq_len=256)
        first = GenRequest("first", TOK.encode("start"), max_tokens=40,
                           ignore_eos=True, guided_json=guided,
                           temperature=1.0, seed=3)
        eng.add_request(first)
        eng.step()
        eng.step()
        eng.add_request(GenRequest("long", long_prompt, max_tokens=4,
                                   ignore_eos=True))
        while eng.has_work:
            eng.step()
        return eng.metrics.mixed_count

    assert run(False) > 0
    assert run(True) == 0


def test_first_token_is_masked_by_the_grammar_kernel(models, monkeypatch):
    """A guided request's first token is masked on the prefill logits by
    `cuda_guide.json_mask` (no host-built mask row), from the state its
    prior output replays to: after '{"a"' only ':' or whitespace."""
    calls = []
    real = cuda_guide.json_mask

    def spy(logits, mode, depth, bits, active, table):
        calls.append((logits.shape[0], mode.tolist(), depth.tolist(),
                      active.tolist()))
        return real(logits, mode, depth, bits, active, table)

    def no_host_mask(*args):
        raise AssertionError("the first token's mask was built on the host")

    monkeypatch.setattr(cuda_guide, "json_mask", spy)
    monkeypatch.setattr(jg, "mask_row", no_host_mask)
    prior = TOK.encode('{"a"')
    eng = _port(models)
    streams, _ = drive(eng, GenRequest, [(
        "cont", TOK.encode("key: ") + prior,
        _guided(3, prior_output_token_ids=prior))])
    assert calls[0] == (1, [jg.AFTER_KEY], [1], [True])
    assert TOK.decode(streams["cont"][:1]) in (":", " ", "\n", "\t", "\r")


# ----------------------------------------------------------------- server --


def _post(url, body, timeout=120):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def server(models):
    eng = _port(models, num_scheduler_steps=8)
    ctx = api.ServingContext(eng, served_model="tiny-debug")
    srv = api.make_server(ctx, host="127.0.0.1", port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    ctx.close()


def test_response_format_on_chat_and_completions(server):
    chat = _post(server + "/v1/chat/completions", {
        "model": "tiny-debug", "max_tokens": 64, "temperature": 1.0,
        "seed": 4, "n": 3, "response_format": {"type": "json_object"},
        "messages": [{"role": "user", "content": "JSON please"}]})
    texts = [(c["message"]["content"], c["finish_reason"])
             for c in chat["choices"]]
    comp = _post(server + "/v1/completions", {
        "model": "tiny-debug", "prompt": "an object:", "max_tokens": 64,
        "temperature": 1.0, "seed": 7, "n": 2,
        "response_format": {"type": "json_object"}})
    texts += [(c["text"], c["finish_reason"]) for c in comp["choices"]]
    assert any(f == "stop" for _, f in texts)
    for text, finish in texts:
        if finish == "stop":
            assert isinstance(json.loads(text), dict), text


TOOLS = [{"type": "function", "function": {
    "name": "lookup", "parameters": {"type": "object"}}}]


def test_forced_tool_call_returns_tool_calls(server):
    """Random weights seldom close an object within max_tokens, so a
    logit_bias on '}' (byte 125), which the grammar admits only where it
    closes an object, steers this one to finish."""
    out = _post(server + "/v1/chat/completions", {
        "model": "tiny-debug", "max_tokens": 64, "temperature": 1.0,
        "seed": 2, "tools": TOOLS, "logit_bias": {"125": 8},
        "tool_choice": {"type": "function", "function": {"name": "lookup"}},
        "messages": [{"role": "user", "content": "look it up"}]})
    choice = out["choices"][0]
    assert choice["finish_reason"] == "tool_calls"
    call = choice["message"]["tool_calls"][0]
    assert call["function"]["name"] == "lookup"
    assert isinstance(json.loads(call["function"]["arguments"]), dict)


def test_streamed_forced_tool_call_is_refused(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server + "/v1/chat/completions", {
            "model": "tiny-debug", "max_tokens": 8, "stream": True,
            "tools": TOOLS, "tool_choice": {
                "type": "function", "function": {"name": "lookup"}},
            "messages": [{"role": "user", "content": "x"}]})
    assert e.value.code == 400
    assert "forced tool_choice" in e.value.read().decode()
