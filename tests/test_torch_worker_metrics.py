"""The port's worker observability plane against the JAX worker's, on the
CPU: the same greedy requests through both OpenAI servers (tiny-debug,
page size 4), then their /metrics pages and /debug routes side by side.
"""

import contextlib
import dataclasses
import io
import json
import threading
import time
import urllib.error
import urllib.request
import zipfile

import jax
import numpy as np
import pytest
import torch

from benchmarks.utils.benchmark import server_histogram_pctls
from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.engine import Engine as JEngine
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import PRESETS as JPRESETS
from dynamo_tpu.serving import api as japi
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import Engine
from dynamo_tpu_torch.serving import api
from tests.metrics_lint import lint_exposition

BASE = dict(model="tiny-debug", page_size=4, num_pages=96, max_num_seqs=4,
            max_seq_len=256, prefill_chunk_tokens=16,
            enable_prefix_caching=False)
CHAT = {"model": "tiny-debug", "max_tokens": 9, "temperature": 0.0,
        "ignore_eos": True,
        "messages": [{"role": "user", "content": "Scrape the port."}]}
REQUESTS = [
    ("/v1/chat/completions", CHAT),
    ("/v1/chat/completions", dict(CHAT, stream=True, max_tokens=12)),
    ("/v1/completions", {"model": "tiny-debug", "prompt": "x" * 70,
                         "max_tokens": 5, "ignore_eos": True}),
    ("/v1/completions", {"model": "tiny-debug", "prompt": "two choices",
                         "max_tokens": 4, "n": 2, "ignore_eos": True}),
]
# the worker's lifecycle series (health, trips, integrity faults, weight
# version, staged weight bytes) are served now: no JAX family is left out
OUT_OF_SLICE: set = set()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module: the parallel test workers share
    the cores, and torch's default pool in each of them oversubscribes
    them (the suite's tiny eager ops are as fast on one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _post(url, body, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.read().decode(), dict(r.headers)


def _get(url, accept=None):
    req = urllib.request.Request(url, headers={"Accept": accept} if accept
                                 else {})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.read(), r.headers.get("Content-Type")


def _families(page: str) -> set:
    return {ln.split()[2] for ln in page.splitlines()
            if ln.startswith("# TYPE ")}


def _series(page: str, prefix: str) -> list:
    return sorted(ln for ln in page.splitlines() if ln.startswith(prefix))


@pytest.fixture(scope="module")
def workers():
    """Both workers served the same requests: {"jax"|"port": (url,
    plain page, OpenMetrics page, response headers)}."""
    cfg = dataclasses.replace(JPRESETS["tiny-debug"], dtype="float32")
    params = jllama.init_params(cfg, jax.random.PRNGKey(0))
    engines = {
        "jax": (japi.ServingContext, japi.make_server,
                JEngine(JEngineConfig(**BASE), params=params)),
        "port": (api.ServingContext, api.make_server,
                 Engine(EngineConfig(**BASE),
                        params={k: np.asarray(v) for k, v in params.items()},
                        device="cpu")),
    }
    out, servers = {}, []
    for name, (ctx_cls, make, engine) in engines.items():
        ctx = ctx_cls(engine, "tiny-debug")
        srv = make(ctx, host="127.0.0.1", port=0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        servers.append((srv, ctx))
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        headers = []
        for path, body in REQUESTS:
            status, _, h = _post(url + path, body,
                                 {"x-request-id": f"{name}-{path}"})
            assert status == 200
            headers.append(h)
        plain = _get(url + "/metrics")[0].decode()
        om = _get(url + "/metrics", "application/openmetrics-text")[0]
        out[name] = (url, plain, om.decode(), headers)
    yield out
    for srv, ctx in servers:
        srv.shutdown()
        ctx.close()


def test_request_counters_and_token_histograms_match(workers):
    ref, got = workers["jax"][1], workers["port"][1]
    for prefix in ("dynamo_frontend_requests_total{",
                   "dynamo_frontend_input_sequence_tokens_",
                   "dynamo_frontend_output_sequence_tokens_",
                   "dynamo_frontend_time_to_first_token_seconds_count",
                   "dynamo_frontend_inter_token_latency_seconds_count",
                   "dynamo_frontend_request_duration_seconds_count"):
        assert _series(got, prefix) == _series(ref, prefix), prefix
    # five choices: their first tokens, and every later token an ITL
    assert ('dynamo_frontend_time_to_first_token_seconds_count'
            '{model="tiny-debug"} 5') in got
    assert ('dynamo_frontend_inter_token_latency_seconds_count'
            '{model="tiny-debug"} 29') in got


def test_metric_families_are_the_jax_workers(workers):
    ref = _families(workers["jax"][1])
    got = _families(workers["port"][1])
    assert got == ref - OUT_OF_SLICE
    assert {"dynamo_engine_mfu", "dynamo_engine_mbu",
            "dynamo_engine_phase_seconds", "dynamo_engine_host_gap_seconds",
            "dynamo_memory_kv_pool_bytes"} <= got


@pytest.mark.parametrize("which", ["jax", "port"])
def test_scrapes_pass_the_exposition_lint(workers, which):
    _, plain, om, _ = workers[which]
    assert lint_exposition(plain) == []
    assert lint_exposition(om, openmetrics=True) == []
    if which == "port":
        assert " # {trace_id=" in om  # exemplars on the latency buckets


def test_engine_series_name_the_jax_phases(workers):
    page = workers["port"][1]
    for phase in ("prefill", "prefill_chunk", "decode_window",
                  "decode_step", "admit", "dispatch", "device_wait",
                  "detok"):
        assert (f'dynamo_engine_phase_seconds_count{{phase="{phase}"}}'
                in page), phase
    assert 'dynamo_engine_mfu 0.0' in page  # no card on the CPU
    assert 'dynamo_memory_kv_pool_bytes{tenant="free",tier="device"}' \
        in page


@pytest.mark.parametrize("which", ["jax", "port"])
def test_responses_carry_the_inbound_request_id(workers, which):
    ids = [h["X-Request-Id"] for h in workers[which][3]]
    assert ids == [f"{which}-{path}" for path, _ in REQUESTS]


def test_server_histogram_pctls_reads_the_port(workers):
    got = server_histogram_pctls(workers["port"][0])
    assert set(got) == {"ttft_ms", "itl_ms"}
    assert all(v["p50"] > 0 for v in got.values())


def test_debug_lists_the_jax_workers_routes(workers):
    index = json.loads(_get(workers["port"][0] + "/debug")[0])["endpoints"]
    assert set(index) == set(japi.WORKER_DEBUG_INDEX)
    for route in ("/debug/spans", "/debug/slo", "/debug/flight?n=4",
                  "/debug/timeline?format=summary", "/debug/costs"):
        body, ctype = _get(workers["port"][0] + route)
        assert ctype == "application/json" and json.loads(body), route
    spans = json.loads(_get(workers["port"][0] + "/debug/spans")[0])
    names = {sp["name"] for rs in spans["resourceSpans"]
             for ss in rs["scopeSpans"] for sp in ss["spans"]}
    assert {"worker.request", "worker.prefill", "worker.decode"} <= names
    stats = json.loads(_get(workers["port"][0] + "/worker/stats")[0])
    assert {"memory", "costs", "timeline"} <= set(stats)
    assert set(stats["metrics"]["phases"]) == {
        "prefill", "prefill_chunk", "decode_window", "decode_step",
        "mixed_step"}


def test_debug_trace_zips_and_refuses_a_concurrent_capture(workers):
    url = workers["port"][0] + "/debug/trace?duration_s=1.5"
    first = {}
    t = threading.Thread(target=lambda: first.update(got=_get(url)))
    t.start()
    time.sleep(0.4)
    with pytest.raises(urllib.error.HTTPError) as busy:
        _get(url)
    assert busy.value.code == 409
    t.join(timeout=60)
    assert not t.is_alive()
    body, ctype = first["got"]
    assert ctype == "application/zip"
    with zipfile.ZipFile(io.BytesIO(body)) as z:
        assert "traceEvents" in json.loads(z.read("trace.json"))


def test_debug_trace_starts_and_stops_the_profiler_between_steps():
    """The capture starts and stops the profiler with the scheduler held
    between two steps (on the card a stop beside a CUDA graph replay on
    the scheduler thread hung both threads), and holds it for nothing
    else: not across the capture's window."""
    engine = Engine(EngineConfig(**BASE), device="cpu")
    ctx = api.ServingContext(engine, "tiny-debug")
    held, real = [], engine.between_steps

    @contextlib.contextmanager
    def recording():
        with real():
            before = torch._C._autograd._profiler_enabled()
            yield
            held.append((before, torch._C._autograd._profiler_enabled()))

    engine.between_steps = recording
    try:
        data = ctx.capture_trace(0.05)
    finally:
        ctx.close()
    assert held == [(False, True), (True, False)]
    with zipfile.ZipFile(io.BytesIO(data)) as z:
        assert "traceEvents" in json.loads(z.read("trace.json"))
