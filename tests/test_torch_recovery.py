"""The port's recovery journal on the wire, on the CPU: the JAX package's
own frontend (`serving/frontend.py`, which imports no JAX) in front of two
port workers sharing one set of weights, with the port's
`worker.crash_mid_decode` and `worker.reset_after_headers` armed; a
greedy chat stream, a completions stream and a seeded sampled stream each
resume on the peer with the content of a fault-free run, byte for byte
(no tolerance), as `tests/test_recovery.py` asserts for JAX workers; the
greedy content is also the JAX worker's on the same params. Then the
journal's units against the JAX module's, and the port's resume_key: the
chain root as two uint32 values, restoring a sampled stream exactly."""

import dataclasses
import json
import threading
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.engine import Engine as JEngine
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import PRESETS as JPRESETS
from dynamo_tpu.serving import api as japi
from dynamo_tpu.serving import http_base as jhttp_base
from dynamo_tpu.serving import recovery as jrecovery
from dynamo_tpu.serving.frontend import FrontendContext, make_frontend_server
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import Engine
from dynamo_tpu_torch.engine.request import GenRequest
from dynamo_tpu_torch.robustness import faults
from dynamo_tpu_torch.serving import api
from dynamo_tpu_torch.serving import http_base
from dynamo_tpu_torch.serving import recovery

MODEL = "tiny-debug"
KW = dict(model=MODEL, page_size=4, num_pages=128, max_num_seqs=4,
          max_seq_len=128)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def post(url, path, body, headers=None, timeout=120, raw=False):
    req = urllib.request.Request(
        url + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST")
    resp = urllib.request.urlopen(req, timeout=timeout)
    return resp if raw else json.loads(resp.read())


def chat_body(text, max_tokens=12, **kw):
    return {"model": MODEL, "messages": [{"role": "user", "content": text}],
            "max_tokens": max_tokens, "temperature": 0, "ignore_eos": True,
            "stream": True, **kw}


def data_events(body_text):
    return [b.strip()[len("data: "):] for b in body_text.split("\n\n")
            if b.strip().startswith("data: ")]


def content(events):
    text = ""
    for e in events:
        if e == "[DONE]":
            continue
        for ch in json.loads(e).get("choices", []):
            text += (ch.get("delta") or {}).get("content") or ""
            text += ch.get("text") or ""
    return text


def stream(url, path, body, headers=None):
    resp = post(url, path, body, headers=headers, raw=True)
    return resp, resp.read().decode()


def _serve(ctx):
    srv = (japi if isinstance(ctx, japi.ServingContext) else api).make_server(
        ctx, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def stack():
    """The JAX frontend + two port workers on one set of weights (the JAX
    init carried across), and a JAX worker on the same params."""
    cfg = dataclasses.replace(JPRESETS[MODEL], dtype="float32")
    params = jllama.init_params(cfg, jax.random.PRNGKey(0))
    plane = faults.reset_plane()
    eng_a = Engine(EngineConfig(**KW),
                   params={k: np.asarray(v) for k, v in params.items()},
                   device="cpu")
    eng_b = Engine(EngineConfig(**KW), params=eng_a.model, device="cpu")
    ctxs, srvs, urls = [], [], []
    for eng in (eng_a, eng_b):
        ctx = api.ServingContext(eng, MODEL)
        srv, url = _serve(ctx)
        ctxs.append(ctx)
        srvs.append(srv)
        urls.append(url)
    jctx = japi.ServingContext(
        JEngine(JEngineConfig(**KW, async_scheduling=False), params=params),
        MODEL)
    jsrv, jurl = _serve(jctx)
    fctx = FrontendContext()
    fsrv = make_frontend_server(fctx, "127.0.0.1", 0)
    threading.Thread(target=fsrv.serve_forever, daemon=True).start()
    st = {"frontend": f"http://127.0.0.1:{fsrv.server_address[1]}",
          "fctx": fctx, "plane": plane, "workers": urls, "wctxs": ctxs,
          "jax_worker": jurl}
    register(st)
    yield st
    plane.clear()
    fsrv.shutdown()
    for srv, ctx in zip(srvs + [jsrv], ctxs + [jctx]):
        srv.shutdown()
        ctx.close()


def register(st):
    for url in st["workers"]:
        post(st["frontend"], "/internal/register", {
            "url": url, "model": MODEL, "mode": "agg",
            "stats": {"max_num_seqs": 4, "free_pages": 100,
                      "total_pages": 128}})


def quiesce(st):
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and any(
            c.engine.num_active or c.engine.pending for c in st["wctxs"]):
        time.sleep(0.05)
    for c in st["wctxs"]:
        assert not c.engine.num_active and not c.engine.pending


def counter_val(counter, **labels):
    key = tuple(sorted(labels.items()))
    with counter._lock:
        return counter._values.get(key, 0.0)


def roles(events):
    return [e for e in events if e != "[DONE]"
            and any((c.get("delta") or {}).get("role")
                    for c in json.loads(e)["choices"])]


def test_crash_mid_decode_chat_stream_resumes_byte_for_byte(stack):
    plane, fctx = stack["plane"], stack["fctx"]
    register(stack)
    body = chat_body("recover me exactly", max_tokens=12)
    _, ref = stream(stack["frontend"], "/v1/chat/completions", body)
    ref_events = data_events(ref)
    assert ref_events[-1] == "[DONE]" and "dynr" not in ref
    # the JAX worker on the same params streams the same content
    _, jref = stream(stack["jax_worker"], "/v1/chat/completions", body)
    assert content(data_events(jref)) == content(ref_events)

    before = counter_val(fctx.recovered_counter, phase="stream")
    plane.configure({"worker.crash_mid_decode": {"times": 1}})
    _, out = stream(stack["frontend"], "/v1/chat/completions", body)
    plane.clear()
    events = data_events(out)
    assert events[-1] == "[DONE]" and "dynr" not in out
    assert content(events) == content(ref_events)
    assert len(roles(events)) == 1
    assert counter_val(fctx.recovered_counter, phase="stream") == before + 1
    quiesce(stack)


def test_crash_mid_decode_completions_stream_resumes(stack):
    plane = stack["plane"]
    register(stack)
    body = {"model": MODEL, "prompt": "legacy completions recovery probe",
            "max_tokens": 10, "temperature": 0, "ignore_eos": True,
            "stream": True}
    _, ref = stream(stack["frontend"], "/v1/completions", body)
    plane.configure({"worker.crash_mid_decode": {"times": 1}})
    _, out = stream(stack["frontend"], "/v1/completions", body)
    plane.clear()
    assert data_events(out)[-1] == "[DONE]"
    assert content(data_events(out)) == content(data_events(ref))
    quiesce(stack)


def test_seeded_sampled_stream_resumes_identically(stack):
    """Sampled and seeded: the continuation resumes the same
    position-keyed noise, so the spliced stream is the fault-free one."""
    plane = stack["plane"]
    register(stack)
    body = chat_body("sampled seeded recovery", max_tokens=10,
                     temperature=0.8, seed=1234)
    _, ref = stream(stack["frontend"], "/v1/chat/completions", body)
    plane.configure({"worker.crash_mid_decode": {"times": 1}})
    _, out = stream(stack["frontend"], "/v1/chat/completions", body)
    plane.clear()
    assert content(data_events(out)) == content(data_events(ref))
    quiesce(stack)


def test_unseeded_sampled_stream_completes_exactly(stack):
    """The worker pins an effective seed into the journal at stream start,
    so an unseeded sampled continuation still delivers exactly max_tokens
    (usage counts across the seam)."""
    plane = stack["plane"]
    register(stack)
    body = chat_body("unseeded sampled recovery", max_tokens=10,
                     temperature=0.9, stream_options={"include_usage": True})
    plane.configure({"worker.crash_mid_decode": {"times": 1}})
    _, out = stream(stack["frontend"], "/v1/chat/completions", body)
    plane.clear()
    events = data_events(out)
    assert events[-1] == "[DONE]"
    usage = [json.loads(e)["usage"] for e in events if e != "[DONE]"
             and json.loads(e).get("usage")]
    assert usage and usage[-1]["completion_tokens"] == 10
    quiesce(stack)


def test_non_journaled_stream_still_truncates(stack):
    plane = stack["plane"]
    register(stack)
    plane.configure({"worker.crash_mid_decode": {"times": 1}})
    _, out = stream(stack["frontend"], "/v1/chat/completions",
                    chat_body("two choices", max_tokens=8, n=2))
    plane.clear()
    assert "stream_error" in out or "[DONE]" not in out
    quiesce(stack)


def test_reset_after_headers_stream_recovers_from_zero(stack):
    plane = stack["plane"]
    register(stack)
    body = chat_body("reset stream probe", max_tokens=8)
    _, ref = stream(stack["frontend"], "/v1/chat/completions", body)
    plane.configure({"worker.reset_after_headers": {"times": 1}})
    _, out = stream(stack["frontend"], "/v1/chat/completions", body)
    plane.clear()
    events = data_events(out)
    assert events[-1] == "[DONE]"
    assert content(events) == content(data_events(ref))
    assert len(roles(events)) == 1
    quiesce(stack)


def test_drain_handoff_resumes_on_the_peer(stack):
    """/internal/drain with handoff on worker A mid-stream: the journaled
    stream pushes its seam and sampling key to the frontend, which resumes
    it on B with the content of a fault-free run."""
    register(stack)
    ctx_a = stack["wctxs"][0]
    body = chat_body("handoff probe", max_tokens=40, temperature=0.7,
                     seed=77)
    _, ref = stream(stack["frontend"], "/v1/chat/completions", body)
    before = counter_val(stack["fctx"].recovered_counter, phase="stream")
    # pin the stream to A, then bring B back before the handoff
    post(stack["frontend"], "/internal/deregister",
         {"url": stack["workers"][1]})
    result = {}

    def run():
        result["out"] = stream(stack["frontend"], "/v1/chat/completions",
                               body)[1]

    t = threading.Thread(target=run)
    t.start()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and not ctx_a.engine.seqs:
        time.sleep(0.002)
    register(stack)
    ctx_a.request_handoff()
    ctx_a.service.nudge_all()
    t.join(timeout=60)
    ctx_a.drain_handoff.clear()
    out = result["out"]
    assert data_events(out)[-1] == "[DONE]"
    assert content(data_events(out)) == content(data_events(ref))
    assert counter_val(stack["fctx"].recovered_counter,
                       phase="stream") == before + 1
    quiesce(stack)


# ------------------------------------------------------------ units --

def test_journal_seam_accounting_matches_the_jax_module():
    for mod in (recovery, jrecovery):
        j = mod.RequestJournal(enabled_=True)
        j.apply_comment(b'{"start": {"id": "chatcmpl-x", "seed": 7}}')
        j.apply_comment(b'{"n": 2, "c": 5, "t": [11, 12]}')
        j.on_data(b'{"choices": [{"delta": {"content": "hello"}}]}')
        assert j.recoverable and j.delivered_chars == 5
        cont = j.continuation()
        assert cont["prior_tokens"] == [11, 12] and cont["seed"] == 7
        j.apply_comment(b'{"n": 9, "c": 6, "t": [13]}')
        assert not j.recoverable
    assert recovery.comment_frame({"n": 1}) == jrecovery.comment_frame(
        {"n": 1})
    for block in (b": dynr {}", b"data: [DONE]", b'data: {"error": 1}',
                  b'data: {"a": 1}', b": other"):
        assert recovery.parse_block(block) == jrecovery.parse_block(block)


@pytest.mark.parametrize("rec", [
    {"prior_tokens": ["x"]}, {"delivered_chars": -1}, {"resume_key": [1]},
    {"resume_key": [1, -2]}, {"seed": True}, {"response_id": "x" * 81},
    {"prior_tokens": [1], "delivered_chars": 0, "resume_key": [3, 4],
     "response_id": "cmpl-a", "seed": 9, "role_sent": 1},
])
def test_continuation_validation_is_the_jax_modules(rec):
    outs = []
    for mod in (recovery, jrecovery):
        try:
            outs.append(mod.normalize_continuation(rec))
        except ValueError as e:
            outs.append(("ValueError", str(e)))
    assert outs[0] == outs[1]


def test_journal_eligibility_is_the_jax_modules():
    for body in ({"stream": True}, {"stream": True, "n": 2},
                 {"stream": True, "tools": [{}]}, {"stream": False}, []):
        assert recovery.journal_eligible(body) == \
            jrecovery.journal_eligible(body)


def test_retry_after_jitter_bounds():
    assert set(http_base.RETRY_AFTER_CODES) == set(
        jhttp_base.RETRY_AFTER_CODES)
    vals = {float(http_base.retry_after_value()) for _ in range(64)}
    assert all(0.8 <= v <= 1.2 for v in vals) and len(vals) > 1


def test_resume_key_restores_the_sampled_chain():
    """The port's resume_key is its 63-bit chain root as [high, low]
    uint32 values (it passes the JAX module's two-uint32 check): a
    continuation with it, the prompt and the tokens so far samples the
    rest of an unseeded stream exactly."""
    eng = Engine(EngineConfig(**KW), device="cpu")
    prompt = [5, 9, 2, 6, 5, 3]
    eng.add_request(GenRequest("u", list(prompt), max_tokens=12,
                               temperature=1.0, ignore_eos=True))
    toks, state = [], None
    while eng.has_work:
        for ev in eng.step():
            toks.append(ev.token_id)
        if state is None and len(toks) >= 4:
            state = eng.export_sampling_state("u")
    assert state is not None and len(toks) == 12
    key = state["key"]
    assert recovery.normalize_continuation(
        {"resume_key": key})["resume_key"] == key
    assert jrecovery.normalize_continuation(
        {"resume_key": key})["resume_key"] == key
    n = state["n_output"]
    rest = eng.generate(GenRequest(
        "c", prompt + toks[:n], max_tokens=12 - n, temperature=1.0,
        ignore_eos=True, prior_output_token_ids=toks[:n], resume_key=key))
    assert rest == toks[n:]
    with pytest.raises(ValueError):
        eng.add_request(GenRequest("bad", prompt, resume_key=[1 << 31, 0]))
