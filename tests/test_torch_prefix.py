"""Automatic prefix caching, admission routing and the backend profiles: the
port against the JAX package.

Same weights (the JAX tree of tiny-debug from PRNGKey(0)), float32 on the
CPU, the same script of requests at the same step() calls: with
enable_prefix_caching the greedy streams and `prefix_cache.stats()` must be
the JAX engine's for repeated prompts, a shared two-page prefix and
eviction under page pressure; the block-hash chain must be byte for byte
the JAX package's. The mixed engine must route a short prompt that arrives
while a stream decodes through the chunked path, as the JAX engine does
(it then rides the mixed step). The port's `jetstream` and `vllm_tpu`
profiles are the JAX package's, and `python -m dynamo_tpu_torch.vllm_tpu`
serves a chat completion with its prefix cache in /worker/stats.
"""

import dataclasses
import json
import re
import signal
import subprocess
import sys
import urllib.request

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.engine import Engine as JEngine
from dynamo_tpu.engine.kv_cache import PageAllocator as JPageAllocator
from dynamo_tpu.engine.kv_cache import PrefixCache as JPrefixCache
from dynamo_tpu.engine.request import GenRequest as JGenRequest
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import PRESETS as JPRESETS
from dynamo_tpu.serving.worker import BACKEND_PROFILES as JPROFILES
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import Engine
from dynamo_tpu_torch.engine.kv_cache import PageAllocator, PrefixCache
from dynamo_tpu_torch.engine.request import GenRequest
from dynamo_tpu_torch.serving.worker import BACKEND_PROFILES

BASE = dict(model="tiny-debug", page_size=16, num_pages=64, max_num_seqs=4,
            max_seq_len=512, prefill_chunk_tokens=32,
            enable_prefix_caching=True)


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


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, 256, size=n).tolist()


def _greedy(max_tokens):
    return dict(max_tokens=max_tokens, temperature=0.0, ignore_eos=True)


def drive(engine, make_req, script, steps=600):
    """Run `script` {step index: [(rid, prompt, kwargs)]} against `engine`
    until it is idle; returns ({rid: tokens}, {rid: finish reason})."""
    streams, reasons = {}, {}
    for i in range(steps):
        for rid, prompt, kw in script.get(i, []):
            engine.add_request(make_req(rid, prompt, **kw))
        if not engine.has_work and i > max(script):
            break
        for ev in engine.step():
            if ev.token_id >= 0:
                streams.setdefault(ev.request_id, []).append(ev.token_id)
            if ev.finished:
                reasons[ev.request_id] = ev.finish_reason
    return streams, reasons


def _both(jparams, cfg, script):
    ref_eng = JEngine(JEngineConfig(**cfg), params=jparams)
    ref = drive(ref_eng, JGenRequest, script)
    eng = Engine(EngineConfig(**cfg), params=_np(jparams), device="cpu")
    got = drive(eng, GenRequest, script)
    return ref_eng, ref, eng, got


def _scenario(name):
    """(config overrides, script) of one prefix-caching scenario."""
    if name == "repeat":
        # one 45-token prompt three times: the first misses, the others
        # reuse its two full pages; the third arrives mid-decode
        p = _prompt(0, 45)
        return {}, {0: [("a", p, _greedy(12))], 20: [("b", p, _greedy(12))],
                    24: [("c", p, _greedy(12))]}
    if name == "shared":
        # a 32-token (two-page) prefix shared by prompts of other tails
        head = _prompt(1, 32)
        return {}, {0: [("a", head + _prompt(2, 9), _greedy(10))],
                    15: [("b", head + _prompt(3, 20), _greedy(10)),
                         ("c", head + _prompt(4, 3), _greedy(10))],
                    40: [("d", head[:16] + _prompt(5, 30), _greedy(10))]}
    # eviction: a 12-page pool that can keep few prefixes, so admissions
    # evict the oldest unshared cached pages
    return (dict(num_pages=12, max_seq_len=128),
            {i * 6: [(f"e{i}", _prompt(10 + i % 3, 40 + i), _greedy(8))]
             for i in range(7)})


@pytest.mark.parametrize("name", ["repeat", "shared", "evict"])
@pytest.mark.parametrize("async_scheduling", [False, True],
                         ids=["sync", "async"])
def test_prefix_cache_matches_jax(jparams, name, async_scheduling):
    overrides, script = _scenario(name)
    cfg = dict(BASE, async_scheduling=async_scheduling, **overrides)
    ref_eng, ref, eng, got = _both(jparams, cfg, script)
    assert got == ref
    assert set(got[1].values()) == {"length"}
    assert eng.prefix_cache.stats() == ref_eng.prefix_cache.stats()
    assert eng.prefix_cache.stats()["hits"] >= 2
    # every page is back with the allocator or held by the cache alone
    held = len(eng.prefix_cache._map)
    assert eng.allocator.free_pages == cfg["num_pages"] - 1 - held
    assert eng.prefix_cache.evictable() == held
    if name == "evict":
        assert held < 7 * 2  # older prefixes were evicted


def test_prefix_hit_prefills_only_the_suffix():
    """A repeated 45-token prompt reuses two cached pages: its chunked
    prefill starts at token 32 and its stream is the first one's."""
    eng = Engine(EngineConfig(**BASE), device="cpu")
    p = _prompt(7, 45)
    first = eng.generate(GenRequest("a", p, max_tokens=6, ignore_eos=True))
    eng.add_request(GenRequest("b", p, max_tokens=6, ignore_eos=True))
    assert eng.step() == []
    assert eng._inflight.done == 32  # one 13-token chunk to go
    out = []
    while eng.has_work:
        out += [ev.token_id for ev in eng.step() if ev.token_id >= 0]
    assert out == first
    assert eng.prefix_cache.stats() == {"entries": 2, "hits": 1,
                                        "misses": 1,
                                        "cached_tokens_served": 32}
    assert eng.metrics.prompt_tokens == 90


@pytest.mark.parametrize("n", [1, 16, 17, 45, 64])
def test_prefix_hashes_match_jax(n):
    """The block-hash chain is byte for byte the JAX package's."""
    tokens = _prompt(n, n)
    blocks = n // 16
    got = PrefixCache(PageAllocator(8), 16)._hashes(tokens, blocks)
    ref = JPrefixCache(JPageAllocator(8), 16)._hashes(tokens, blocks)
    assert got == ref and len(got) == blocks


def test_short_prompt_rides_the_mixed_step_like_jax(jparams):
    """Mixed mode, one live stream, then a 20-token prompt (below the
    chunk): the JAX engine sends it through the chunked path, where it
    rides a mixed step; the port must count the same mixed steps and give
    the same greedy streams."""
    cfg = dict(BASE, enable_prefix_caching=False, mixed_batch_tokens=32,
               num_scheduler_steps=1)
    script = {0: [("live", _prompt(8, 12), _greedy(16))],
              3: [("short", _prompt(9, 20), _greedy(6))]}
    ref_eng, ref, eng, got = _both(jparams, cfg, script)
    assert ref_eng.metrics.mixed_count > 0
    assert eng.metrics.mixed_count == ref_eng.metrics.mixed_count
    assert got == ref


@pytest.mark.parametrize("profile", ["jetstream", "vllm_tpu"])
def test_backend_profiles_are_the_jax_ones(profile):
    assert BACKEND_PROFILES[profile] == JPROFILES[profile]


def test_jax_defaults_construct_and_serve():
    """EngineConfig's defaults (prefix caching and async scheduling on),
    and 4-step windows, serve a request."""
    for extra in ({}, {"num_scheduler_steps": 4}):
        eng = Engine(EngineConfig(model="tiny-debug", max_seq_len=256,
                                  num_pages=32, **extra), device="cpu")
        assert eng.prefix_cache is not None and eng.cfg.async_scheduling
        out = eng.generate(GenRequest("d", [1, 2, 3], max_tokens=9,
                                      ignore_eos=True))
        assert len(out) == 9


def test_vllm_tpu_worker_serves_with_prefix_cache():
    """`python -m dynamo_tpu_torch.vllm_tpu --device cpu`: one chat
    completion, twice; the second hits the prefix cache, which
    /worker/stats reports."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.vllm_tpu", "--model",
         "tiny-debug", "--device", "cpu", "--host", "127.0.0.1", "--port",
         "0", "--max-seq-len", "256", "--num-pages", "32"],
        stderr=subprocess.PIPE, text=True)
    try:
        port = None
        for line in proc.stderr:
            m = re.search(r"worker serving .* on 127\.0\.0\.1:(\d+)", line)
            if m:
                port = int(m.group(1))
                break
        assert port, "worker never reported its port"
        base = f"http://127.0.0.1:{port}"
        body = {"model": "tiny-debug", "max_tokens": 4, "temperature": 0.0,
                "ignore_eos": True,
                "messages": [{"role": "user", "content":
                              "A prompt long enough to fill two pages of "
                              "the cache."}]}
        outs = []
        for _ in range(2):
            req = urllib.request.Request(
                base + "/v1/chat/completions", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                assert r.status == 200
                outs.append(json.loads(r.read()))
        assert outs[0]["usage"]["completion_tokens"] == 4
        assert (outs[0]["choices"][0]["message"]["content"]
                == outs[1]["choices"][0]["message"]["content"])
        with urllib.request.urlopen(base + "/worker/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["prefix_cache"]["hits"] == 1
        assert stats["prefix_cache"]["entries"] >= 2
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
