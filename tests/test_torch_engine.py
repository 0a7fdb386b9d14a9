"""The port's Engine and OpenAI worker against the JAX package's.

Same weights (the JAX tree of tiny-debug from PRNGKey(0)), same requests,
float32 on the CPU: greedy token streams must be identical, through the
batched same-bucket prefill, the chunked prefill of a prompt longer than
prefill_chunk_tokens, the decode batch, and page-pressure deferral. One
greedy /v1/chat/completions through both packages' servers must return the
same content. The rest pins what the slice refuses.
"""

import dataclasses
import json
import re
import signal
import subprocess
import sys
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
from dynamo_tpu.serving import api as japi
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import Engine, unported_settings
from dynamo_tpu_torch.engine.request import GenRequest
from dynamo_tpu_torch.models.config import PRESETS
from dynamo_tpu_torch.serving import api

BASE = dict(model="tiny-debug", page_size=16, num_pages=64, max_num_seqs=4,
            max_seq_len=512, prefill_chunk_tokens=32,
            enable_prefix_caching=False)


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
def jparams():
    cfg = dataclasses.replace(JPRESETS["tiny-debug"], dtype="float32")
    return jllama.init_params(cfg, jax.random.PRNGKey(0))


def _np(params):
    return {k: np.asarray(v) for k, v in params.items()}


def _requests(rng, lengths, max_tokens):
    return [(f"r{i}", rng.integers(0, 256, size=n).tolist(), max_tokens)
            for i, n in enumerate(lengths)]


def _run(engine, make_req, reqs):
    for rid, prompt, mt in reqs:
        engine.add_request(make_req(rid, prompt, max_tokens=mt,
                                    temperature=0.0, ignore_eos=True))
    streams, reasons = {}, {}
    for _ in range(10_000):
        if not engine.has_work:
            break
        for ev in engine.step():
            if ev.token_id >= 0:
                streams.setdefault(ev.request_id, []).append(ev.token_id)
            if ev.finished:
                reasons[ev.request_id] = ev.finish_reason
    return streams, reasons


def test_greedy_streams_match_jax_engine(jparams):
    """Three same-bucket prompts (one batched prefill) and one 70-token
    prompt over the 32-token chunk, decoded together."""
    reqs = _requests(np.random.default_rng(0), [5, 9, 12, 70], 12)
    ref = _run(JEngine(JEngineConfig(**BASE), params=jparams), JGenRequest,
               reqs)
    eng = Engine(EngineConfig(**BASE), params=_np(jparams), device="cpu")
    got = _run(eng, GenRequest, reqs)
    assert got == ref
    assert all(len(s) == 12 for s in got[0].values())
    assert eng.allocator.free_pages == BASE["num_pages"] - 1


def test_greedy_streams_match_under_page_pressure(jparams):
    """A pool too small for every sequence at once: admission defers on
    OutOfPages and decode preempts by recompute, in both engines."""
    cfg = dict(BASE, num_pages=10, max_seq_len=128)
    reqs = _requests(np.random.default_rng(1), [20, 24, 18, 30], 40)
    ref = _run(JEngine(JEngineConfig(**cfg, async_scheduling=False),
                       params=jparams), JGenRequest, reqs)
    eng = Engine(EngineConfig(**cfg), params=_np(jparams), device="cpu")
    got = _run(eng, GenRequest, reqs)
    assert got == ref
    assert eng.metrics.num_preempted > 0 and eng.metrics.kv_oom == 0


def test_logprobs_match_jax_engine(jparams):
    """Chosen-token logprobs and top-3 alternatives of a greedy stream,
    first token (from prefill) and decoded ones, agree with the JAX
    engine's within 1e-4."""
    prompt = list(np.random.default_rng(2).integers(0, 256, size=11))
    outs = []
    for engine, make_req in (
            (JEngine(JEngineConfig(**BASE), params=jparams), JGenRequest),
            (Engine(EngineConfig(**BASE), params=_np(jparams), device="cpu"),
             GenRequest)):
        engine.add_request(make_req("lp", [int(t) for t in prompt],
                                    max_tokens=6, logprobs=3,
                                    ignore_eos=True))
        evs = [ev for _ in range(20) if engine.has_work
               for ev in engine.step() if ev.token_id >= 0]
        outs.append(evs)
    ref, got = outs
    assert [e.token_id for e in got] == [e.token_id for e in ref]
    for r, g in zip(ref, got):
        assert g.logprob == pytest.approx(r.logprob, rel=1e-4, abs=1e-4)
        assert [t for t, _ in g.top_logprobs] == [t for t, _ in r.top_logprobs]
        np.testing.assert_allclose([v for _, v in g.top_logprobs],
                                   [v for _, v in r.top_logprobs],
                                   rtol=1e-4, atol=1e-4)


def _serve(ctx_cls, make_server, engine):
    ctx = ctx_cls(engine, "tiny-debug")
    srv = make_server(ctx, host="127.0.0.1", port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return ctx, srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _post(url, body, timeout=120):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read().decode()


CHAT = {"model": "tiny-debug", "max_tokens": 16, "temperature": 0.0,
        "ignore_eos": True,
        "messages": [{"role": "user", "content": "Say hello to the port."}]}


def test_chat_completion_matches_jax_worker(jparams):
    outs = []
    for ctx_cls, mk, engine in (
            (japi.ServingContext, japi.make_server,
             JEngine(JEngineConfig(**BASE), params=jparams)),
            (api.ServingContext, api.make_server,
             Engine(EngineConfig(**BASE), params=_np(jparams),
                    device="cpu"))):
        ctx, srv, url = _serve(ctx_cls, mk, engine)
        try:
            status, body = _post(url + "/v1/chat/completions", CHAT)
        finally:
            srv.shutdown()
            ctx.close()
        assert status == 200
        outs.append(json.loads(body))
    ref, got = outs
    assert (got["choices"][0]["message"]["content"]
            == ref["choices"][0]["message"]["content"])
    assert got["usage"] == ref["usage"]
    assert got["usage"]["completion_tokens"] == 16


@pytest.fixture(scope="module")
def port_server():
    eng = Engine(EngineConfig(**BASE), device="cpu")
    ctx, srv, url = _serve(api.ServingContext, api.make_server, eng)
    yield url
    srv.shutdown()
    ctx.close()


def _sse(url, body):
    status, text = _post(url, body)
    events = [ln[len("data: "):] for ln in text.splitlines()
              if ln.startswith("data: ")]
    assert status == 200 and events[-1] == "[DONE]"
    return [json.loads(e) for e in events[:-1]]


def test_port_server_streams_chat_and_completions(port_server):
    chunks = _sse(port_server + "/v1/chat/completions",
                  dict(CHAT, stream=True,
                       stream_options={"include_usage": True}))
    assert chunks[0]["choices"][0]["delta"] == {"role": "assistant"}
    assert chunks[-1]["usage"]["completion_tokens"] == 16
    assert chunks[-2]["choices"][0]["finish_reason"] == "length"
    chunks = _sse(port_server + "/v1/completions",
                  {"model": "tiny-debug", "prompt": "abc", "max_tokens": 5,
                   "temperature": 0.0, "ignore_eos": True, "stream": True})
    assert chunks[-1]["choices"][0]["finish_reason"] == "length"
    status, body = _post(port_server + "/v1/completions",
                         {"model": "tiny-debug", "prompt": "abc",
                          "max_tokens": 5, "temperature": 0.7, "n": 2,
                          "seed": 3, "logprobs": 2, "ignore_eos": True})
    out = json.loads(body)
    assert status == 200 and len(out["choices"]) == 2
    assert out["usage"]["completion_tokens"] == 10
    assert len(out["choices"][0]["logprobs"]["token_logprobs"]) <= 5


def test_port_server_models_and_health(port_server):
    with urllib.request.urlopen(port_server + "/v1/models") as r:
        assert json.loads(r.read())["data"][0]["id"] == "tiny-debug"
    with urllib.request.urlopen(port_server + "/health") as r:
        assert json.loads(r.read())["status"] == "ok"


@pytest.mark.parametrize("body", [
    dict(CHAT, response_format={"type": "json_schema"}),
    dict(CHAT, model="not-served"),
    dict(CHAT, tools=[{"type": "function", "function": {"name": "f"}}],
         tool_choice={"type": "function", "function": {"name": "f"}},
         stream=True),
])
def test_port_server_refuses_with_400(port_server, body):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port_server + "/v1/chat/completions", body)
    assert e.value.code == 400


STILL_REFUSED = {"tensor_parallel": 2, "data_parallel": 2,
                 "expert_parallel": 2, "sequence_parallel": 2,
                 "disaggregation_mode": "prefill"}


@pytest.mark.parametrize("field,value", [
    ("kvbm_host_blocks", 8),
    ("tensor_parallel", 2),
    ("data_parallel", 2),
    ("expert_parallel", 2),
    ("sequence_parallel", 2),
    ("tenants", '[{"name": "a"}]'),
    ("disaggregation_mode", "prefill"),
])
def test_unported_settings_are_refused(field, value):
    """The settings still unported raise NotImplementedError naming the
    field; `kvbm_host_blocks` and `tenants`, refused until the KVBM and
    QoS were ported, now build an engine, and beside a still-unported
    setting only that one is named."""
    cfg = EngineConfig(**dict(BASE, **{field: value}))
    if field in STILL_REFUSED:
        with pytest.raises(NotImplementedError, match=field):
            Engine(cfg, device="cpu")
        return
    assert unported_settings(cfg) == []
    Engine(cfg, device="cpu")
    for other, bad in STILL_REFUSED.items():
        both = EngineConfig(**dict(BASE, **{field: value, other: bad}))
        assert unported_settings(both) == [other]


@pytest.mark.parametrize("field,value", [
    ("quantization", "int8"),
    ("quantization", "w8a8"),
    ("model_path", "tiny-debug"),
    ("speculative_mode", "ngram"),
    ("lora_slots", 2),
    ("kvbm_host_blocks", 8),
    ("tenants", '[{"name": "a"}]'),
])
def test_settings_ported_since_are_served(tmp_path, field, value):
    """Refused before the loader, int8 weights, speculative decoding,
    multi-LoRA serving, the KVBM and per-tenant QoS were ported. The
    model_path here is an empty directory named after a
    preset: the preset's config, and random init with a warning, as in
    the JAX package."""
    if field == "model_path":
        value = str(tmp_path / value)
        (tmp_path / "tiny-debug").mkdir()
    cfg = EngineConfig(**dict(BASE, **{field: value}))
    assert field not in unported_settings(cfg)
    eng = Engine(cfg, device="cpu")
    assert len(eng.generate(GenRequest("p", [1, 2, 3], max_tokens=3,
                                       ignore_eos=True))) == 3


@pytest.mark.parametrize("model,feature", [
    ("phi-3-mini-4k-instruct", "head_dim"),
])
def test_unported_models_are_refused(model, feature):
    """Every preset is served since Phi-3's head_dim 96 and longrope were
    ported; a head_dim the kernels are not built for (80) is still
    refused, by name, before any weight is made."""
    cfg = dataclasses.replace(PRESETS[model], head_dim=80)
    with pytest.raises(NotImplementedError, match=feature):
        Engine(EngineConfig(**dict(BASE, model=model)), model_cfg=cfg,
               device="cpu")


# a full-size preset's switches at tiny-debug's widths (its layer count
# kept where it is small enough to reach a global layer)
TINY_WIDTHS = dict(vocab_size=512, hidden_size=128, intermediate_size=256,
                   num_heads=4, num_kv_heads=2, head_dim=32)
# Phi-3's head_dim 96 (MHA) at tiny widths, a window past its prompts,
# and longrope over a 16-token original context (48 factors a set)
PHI3_TINY = dict(TINY_WIDTHS, hidden_size=192, num_heads=2, num_kv_heads=2,
                 head_dim=96, num_layers=2, sliding_window=4)
PHI3_LONGROPE = dict(
    max_position_embeddings=128,
    rope_longrope_scaling=(tuple(1.0 + i / 96 for i in range(48)),
                           tuple(1.0 + i / 8 for i in range(48)), 16))


@pytest.mark.parametrize("model,change", [
    ("tiny-gemma-debug", {}),
    ("tiny-debug", dict(qk_norm=True)),
    ("tiny-debug", dict(attention_bias=True)),
    ("tiny-moe-debug", {}),
    ("tiny-mla-debug", {}),
    ("tiny-mla-debug", dict(rope_yarn_scaling=(
        40.0, 32.0, 1.0, 4096, 0.707, 0.707, -1.0))),
    ("gemma-3-1b-it", dict(TINY_WIDTHS, num_layers=6, sliding_window=4)),
    ("tiny-gemma2-debug", {}),
    ("tiny-gemma3-debug", {}),
    ("gemma-2-2b-it", dict(TINY_WIDTHS, num_layers=2, sliding_window=4)),
    ("gemma-2-9b-it", dict(TINY_WIDTHS, num_layers=2, sliding_window=4)),
    ("phi-3-mini-4k-instruct", PHI3_TINY),
    ("phi-3-mini-4k-instruct", dict(PHI3_TINY, **PHI3_LONGROPE)),
], ids=["gemma", "qwen3-qk_norm", "qwen2-attention_bias", "moe", "mla",
        "mla-yarn", "gemma3-1b-switches", "gemma2-tiny", "gemma3-tiny",
        "gemma2-2b-switches", "gemma2-9b-switches", "phi3-switches",
        "phi3-longrope"])
def test_models_ported_since_are_served(model, change):
    """Refused before the Gemma-1, Qwen3, Qwen2, MoE, MLA, YaRN,
    Gemma-2/3 (sliding window, logit caps, sandwich norms,
    query_pre_attn_scalar, per-layer rope) and Phi-3 (head_dim 96,
    longrope) features were ported; an
    activation the port does not implement still is (for an MoE model the
    config itself refuses it: MoE is SwiGLU only)."""
    cfg = dataclasses.replace(PRESETS[model], dtype="float32", **change)
    eng = Engine(EngineConfig(**BASE), model_cfg=cfg, device="cpu")
    assert len(eng.generate(GenRequest("p", [1, 2, 3], max_tokens=3,
                                       ignore_eos=True))) == 3
    refused = ValueError if cfg.is_moe else NotImplementedError
    with pytest.raises(refused, match="hidden_act"):
        Engine(EngineConfig(**BASE), device="cpu",
               model_cfg=dataclasses.replace(cfg, hidden_act="relu"))


def test_engine_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(EngineConfig(**BASE))


def test_abort_and_stop_tokens():
    eng = Engine(EngineConfig(**BASE), device="cpu")
    first = eng.generate(GenRequest("a", [1, 2, 3], max_tokens=3,
                                    ignore_eos=True))
    # stopping on the first generated token ends the request at once
    stop = eng.generate(GenRequest("b", [1, 2, 3], max_tokens=8,
                                   stop_token_ids=[first[0]],
                                   ignore_eos=True))
    assert stop == first[:1]
    eng.add_request(GenRequest("c", [4, 5], max_tokens=50, ignore_eos=True))
    eng.step()
    eng.abort_request("c")
    events = eng.step()
    assert any(e.request_id == "c" and e.finish_reason == "abort"
               for e in events)
    assert not eng.has_work
    assert eng.allocator.free_pages == BASE["num_pages"] - 1


def _serve_worker(*extra):
    """Start `python -m dynamo_tpu_torch.jetstream` on the CPU with the
    profile's defaults plus `extra`, serve one chat completion, read
    /worker/stats, stop it with SIGTERM; returns the stats."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.jetstream", "--model",
         "tiny-debug", "--device", "cpu", "--host", "127.0.0.1", "--port",
         "0", "--max-seq-len", "256", "--num-pages", "32", *extra],
        stderr=subprocess.PIPE, text=True)
    try:
        port = None
        for line in proc.stderr:
            m = re.search(r"worker serving .* on 127\.0\.0\.1:(\d+)", line)
            if m:
                port = int(m.group(1))
                break
        assert port, "worker never reported its port"
        status, body = _post(f"http://127.0.0.1:{port}/v1/chat/completions",
                             dict(CHAT, max_tokens=4))
        assert status == 200
        assert json.loads(body)["usage"]["completion_tokens"] == 4
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/worker/stats",
                                    timeout=30) as r:
            stats = json.loads(r.read())
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        return stats
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_jetstream_worker_serves_and_stops():
    """`python -m dynamo_tpu_torch.jetstream` on the CPU: the JAX package's
    jetstream profile (8-step synchronous windows, no chunking, so no
    prefix caching) starts, one chat completion is served, SIGTERM stops
    the process."""
    stats = _serve_worker()
    assert stats["kv_cache"]["dtype"] == "float32"
    assert stats["metrics"]["mixed_count"] == 0


def test_jetstream_worker_serves_mixed_step_on_int8_pools():
    """The worker's --mixed-batch-tokens and --kv-cache-dtype int8 flags
    reach the engine, and /worker/stats reports the int8 pool."""
    stats = _serve_worker("--mixed-batch-tokens", "16", "--kv-cache-dtype",
                          "int8")
    assert stats["kv_cache"]["dtype"] == "int8"
    assert stats["kv_cache"]["lane_width"] == 128
    assert "mixed_count" in stats["metrics"]
