"""One request script through two whole stacks, on the CPU: the JAX
frontend with two JAX tiny-debug workers, and the port's frontend with two
port workers on the same weights (`models/loader.from_jax_params`). Each
stack has its own package's NATS broker: the frontend routes over the
request plane and indexes the workers' KV events, which each worker
publishes through its package's NATS wiring. Both stacks give the same
greedy tokens, the same worker for each request (by registration order:
the workers of both stacks listen on the same two sockets, so HRW draws
alike), the same status codes (503 with no worker, 400, 504, 429), the
same KV-event-index routing of second turns, and the same
`dynamo_frontend_*` series names and label sets. Then the port's worker
CLI serves `--nats-url`."""

import dataclasses
import json
import os
import re
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.engine import Engine as JEngine
from dynamo_tpu.kvbm import events as jevents
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import PRESETS as JPRESETS
from dynamo_tpu.robustness import faults as jfaults
from dynamo_tpu.serving import api as japi
from dynamo_tpu.serving import frontend as jfrontend
from dynamo_tpu.serving import nats as jnats
from dynamo_tpu.serving import nats_plane as jnats_plane
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import Engine
from dynamo_tpu_torch.models import loader
from dynamo_tpu_torch.models.config import PRESETS
from dynamo_tpu_torch.robustness import faults
from dynamo_tpu_torch.serving import api
from dynamo_tpu_torch.serving import frontend
from dynamo_tpu_torch.serving import nats
from dynamo_tpu_torch.serving import worker as tworker

MODEL = "tiny-debug"
KW = dict(model=MODEL, page_size=4, num_pages=1024, max_num_seqs=4,
          max_seq_len=1024, async_scheduling=False)
STATS = {"max_num_seqs": 4, "free_pages": 900, "total_pages": 1024}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def wait_for(pred, timeout_s=20.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    pytest.fail(f"timed out waiting for {what}")


def post(url, body, headers=None, timeout=120):
    """(status, parsed body or SSE events)."""
    req = urllib.request.Request(
        url, data=body if isinstance(body, bytes) else json.dumps(
            body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            raw = r.read().decode()
            status = r.status
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())
    if raw.startswith("data: "):
        return status, [b[len("data: "):] for b in raw.split("\n\n")
                        if b.startswith("data: ")]
    return status, json.loads(raw)


def text_of(resp):
    status, body = resp
    assert status == 200, body
    if isinstance(body, list):  # a stream's events
        return "".join(
            (c.get("delta") or {}).get("content") or c.get("text") or ""
            for e in body if e != "[DONE]"
            for c in json.loads(e)["choices"])
    c = body["choices"][0]
    return c["message"]["content"] if "message" in c else c["text"]


class Slot:
    """A worker's listening socket, kept across both stacks (so a worker's
    URL, and with it its HRW draw, is the same in each); each stack puts
    its own worker's handler behind it."""

    def __init__(self):
        self.srv = ThreadingHTTPServer(("127.0.0.1", 0),
                                       BaseHTTPRequestHandler)
        self.srv.daemon_threads = True
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"

    def serve(self, make_server, ctx):
        probe = make_server(ctx, "127.0.0.1", 0)
        probe.server_close()
        self.srv.RequestHandlerClass = probe.RequestHandlerClass


def jax_nats_wiring(ctx, nats_url, url):
    """The JAX worker's `--nats-url` wiring (`dynamo_tpu/serving/worker.py`
    main), for an in-process JAX worker."""
    plane = jnats_plane.WorkerNatsPlane(nats_url, url, MODEL,
                                        advertised_url=url)
    if ctx.engine.prefix_cache is not None:
        ctx.attach_kv_event_publisher(
            jevents.KVEventPublisher(plane.nc, url, MODEL))
    return plane


def conversation(i):
    """A first turn of 5-10 of the router's 64-character text blocks (its
    second turn must share most of its chain to route by overlap). The KV
    event publisher keys a request by its first page and its page count,
    and at page 4 every chat's first page is the template's alone, so the
    first turns lie ~25 pages apart, clear of each other and of every
    second turn (~10 pages past its first): two requests of one page
    count on one worker would share a key, and the second's blocks would
    go unpublished, in both packages (ROADMAP queue 3)."""
    return [{"role": "user", "content": f"Conversation {i}: "
             + "the paged cache keeps page zero. " * (10 + 3 * i)}]


def run_script(pkg, front_mod, fctx, furl, slots, ctxs, plane_faults):
    """The request script; returns what both stacks must agree on."""
    out = {"codes": {}, "texts": [], "workers": [], "kv_index_hits": None}
    chat = f"{furl}/v1/chat/completions"
    body = {"model": MODEL, "max_tokens": 8, "temperature": 0,
            "ignore_eos": True}

    def served_by(fn):
        before = [c.engine.metrics.num_requests for c in ctxs]
        got = fn()
        after = [c.engine.metrics.num_requests for c in ctxs]
        moved = [i for i, (a, b) in enumerate(zip(before, after)) if b > a]
        assert len(moved) == 1, (before, after, got)
        return got, moved[0]

    msgs = conversation(0)
    out["codes"]["no_worker"] = post(chat, dict(body, messages=msgs))[0]
    for slot in slots:  # registration order gives the worker index
        post(f"{furl}/internal/register", {
            "url": slot.url, "model": MODEL, "mode": "agg",
            "stats": STATS})
    out["codes"]["bad_json"] = post(chat, b"{not json")[0]
    out["codes"]["no_messages"] = post(chat, dict(body))[0]
    out["codes"]["expired_deadline"] = post(
        chat, dict(body, messages=msgs), headers={"x-deadline": "0"})[0]
    # two-turn conversations: the first turn by HRW, the second by the KV
    # event index (the first turn's stored blocks)
    for i in range(4):
        msgs = conversation(i)
        n0 = fctx.router.kv_index.stats()["events_applied"]
        first, w = served_by(lambda: post(chat, dict(body, messages=msgs,
                                                     stream=i % 2 == 1)))
        wait_for(lambda: fctx.router.kv_index.stats()["events_applied"]
                 > n0, what=f"{pkg}: KV events of conversation {i}")
        msgs2 = msgs + [{"role": "assistant", "content": text_of(first)},
                        {"role": "user", "content": "And then?"}]
        second, w2 = served_by(lambda: post(chat, dict(body, messages=msgs2)))
        out["texts"] += [text_of(first), text_of(second)]
        out["workers"] += [w, w2]
    comp, w = served_by(lambda: post(f"{furl}/v1/completions", dict(
        body, prompt="A completion through the frontend: " * 3)))
    out["texts"].append(text_of(comp))
    out["workers"].append(w)
    out["kv_index_hits"] = fctx.router.kv_index_hits
    # admission: one request held at the worker (a read stall) fills the
    # frontend's in-flight bound of 1; the next is shed with 429
    fctx.max_inflight = 1
    # the frontend releases a request's in-flight count after its response
    # is written, so the last request may still count: wait until none
    # does, or the held request would be the one shed
    wait_for(lambda: fctx._inflight == 0, what=f"{pkg}: an idle frontend")
    plane_faults.configure({"worker.read_stall": {"times": 1,
                                                  "delay_s": 2.0}})
    held = {}
    t = threading.Thread(target=lambda: held.update(r=post(chat, dict(
        body, messages=conversation(0)))), daemon=True)
    t.start()
    # held: admitted by the frontend and stalled at the worker
    wait_for(lambda: fctx._inflight == 1 and plane_faults.snapshot()[
        "fired"].get("worker.read_stall") == 1, what=f"{pkg}: a held request")
    out["codes"]["over_inflight"] = post(chat, dict(
        body, messages=conversation(1)))[0]
    t.join(timeout=60)
    out["codes"]["held"] = held["r"][0]
    plane_faults.clear()
    fctx.max_inflight = 0
    with urllib.request.urlopen(f"{furl}/metrics", timeout=30) as r:
        page = r.read().decode()
    out["series"] = sorted({
        (m.group(1), tuple(sorted(re.findall(r'([a-z_]+)="', m.group(2)
                                             or ""))))
        for m in re.finditer(r"^(dynamo_frontend_[a-z_]+?)"
                             r"(?:_bucket|_count|_sum|_created)?"
                             r"(?:\{(.*)\})? ", page, re.M)})
    out["router"] = {"native": getattr(fctx, "router_core", None)}
    return out


def stack_run(pkg, slots, params_np, jparams):
    is_port = pkg == "dynamo_tpu_torch"
    nats_mod = nats if is_port else jnats
    front_mod = frontend if is_port else jfrontend
    plane_faults = (faults if is_port else jfaults).reset_plane()
    broker = nats_mod.MiniNatsBroker()
    if is_port:
        cfg = dataclasses.replace(PRESETS[MODEL], dtype="float32")
        model = loader.from_jax_params(cfg, params_np, device="cpu",
                                       dtype=torch.float32)
        ctxs = [api.ServingContext(Engine(EngineConfig(**KW), params=model,
                                          device="cpu"), MODEL)
                for _ in slots]
    else:
        ctxs = [japi.ServingContext(JEngine(JEngineConfig(**KW),
                                            params=jparams), MODEL)
                for _ in slots]
    planes = []
    for slot, ctx in zip(slots, ctxs):
        slot.serve((api if is_port else japi).make_server, ctx)
        planes.append(
            tworker.attach_nats_plane(ctx, broker.url, slot.url, slot.url)
            if is_port else jax_nats_wiring(ctx, broker.url, slot.url))
    # registrations never expire: the script sends no heartbeats, and a
    # slow run must not purge a worker between its steps
    fctx = front_mod.FrontendContext(
        front_mod.Router(heartbeat_ttl=float("inf")), nats_url=broker.url)
    fsrv = front_mod.make_frontend_server(fctx, "127.0.0.1", 0)
    threading.Thread(target=fsrv.serve_forever, daemon=True).start()
    try:
        wait_for(lambda: sum(len(c.subs) for c in list(broker._conns)) >= 5,
                 what=f"{pkg}: the planes' subscriptions")
        return run_script(pkg, front_mod, fctx,
                          f"http://127.0.0.1:{fsrv.server_address[1]}",
                          slots, ctxs, plane_faults)
    finally:
        plane_faults.clear()
        fsrv.shutdown()
        fsrv.server_close()
        fctx.nats.close()
        for plane, ctx in zip(planes, ctxs):
            plane.close()
            ctx.close()
        broker.close()


@pytest.fixture(scope="module")
def runs():
    cfg = dataclasses.replace(JPRESETS[MODEL], dtype="float32")
    jparams = jllama.init_params(cfg, jax.random.PRNGKey(0))
    params_np = {k: np.asarray(v) for k, v in jparams.items()}
    slots = [Slot(), Slot()]
    try:
        yield {pkg: stack_run(pkg, slots, params_np, jparams)
               for pkg in ("dynamo_tpu", "dynamo_tpu_torch")}
    finally:
        for slot in slots:
            slot.srv.shutdown()
            slot.srv.server_close()


def test_same_greedy_tokens_through_both_stacks(runs):
    ref, port = runs["dynamo_tpu"], runs["dynamo_tpu_torch"]
    # (ids of 256 and up decode to nothing in the byte tokenizer)
    assert "".join(ref["texts"]) and port["texts"] == ref["texts"]


def test_same_worker_for_each_request(runs):
    ref, port = runs["dynamo_tpu"], runs["dynamo_tpu_torch"]
    assert port["workers"] == ref["workers"]
    # every second turn went to the worker that served its first
    w = ref["workers"]
    assert all(w[2 * i] == w[2 * i + 1] for i in range(4))
    assert port["kv_index_hits"] == ref["kv_index_hits"] >= 4


def test_same_status_codes(runs):
    ref, port = runs["dynamo_tpu"], runs["dynamo_tpu_torch"]
    assert port["codes"] == ref["codes"] == {
        "no_worker": 503, "bad_json": 400, "no_messages": 400,
        "expired_deadline": 504, "over_inflight": 429, "held": 200}


def test_same_frontend_series_and_labels(runs):
    ref, port = runs["dynamo_tpu"], runs["dynamo_tpu_torch"]
    assert port["series"] == ref["series"]
    names = {name for name, _ in ref["series"]}
    assert {"dynamo_frontend_requests_total",
            "dynamo_frontend_kv_events_total",
            "dynamo_frontend_kv_event_index_routed_total",
            "dynamo_frontend_admission_rejected_total",
            "dynamo_frontend_deadline_shed_total"} <= names
    assert port["router"]["native"] == {"native_router": True}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_worker_cli_serves_the_nats_plane_and_publishes_kv_events():
    """`python -m dynamo_tpu_torch.jetstream --device cpu --nats-url`
    (prefix caching on, with its chunks): a request over the NATS plane
    is served, and its prefill's stored blocks arrive on the KV event
    subject; SIGTERM drains and the worker exits 0."""
    from dynamo_tpu_torch.serving import nats_plane

    broker = nats.MiniNatsBroker()
    nc = nats.NatsClient(broker.url, name="test-frontend")
    events = []
    nc.subscribe("dynamo.kv_events.>", events.append)
    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.jetstream", "--device",
         "cpu", "--model", MODEL, "--host", "127.0.0.1", "--port",
         str(port), "--page-size", "4", "--num-pages", "64",
         "--max-num-seqs", "2", "--max-seq-len", "128",
         "--enable-prefix-caching", "--prefill-chunk-tokens", "32",
         "--nats-url", broker.url],
        env=dict(os.environ, DRAIN_TIMEOUT_S="10",
                 DRAIN_HANDOFF_GRACE_S="1"),
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        # the worker's subject and its model's queue group
        wait_for(lambda: proc.poll() is not None or sum(
            len(c.subs) for c in list(broker._conns)) >= 3, 120,
                 "the worker's NATS subscriptions")
        assert proc.poll() is None, proc.stderr.read().decode()[-2000:]
        status, ctype, chunks = nats_plane.nats_request(
            nc, nats_plane.worker_subject(url), "/v1/completions",
            {"model": MODEL, "prompt": "Served over the NATS plane: " * 3,
             "max_tokens": 4, "temperature": 0, "ignore_eos": True},
            timeout=60, head_timeout=30)
        body = json.loads(b"".join(chunks))
        assert status == 200 and "json" in ctype
        assert body["usage"]["completion_tokens"] == 4
        wait_for(lambda: events, 30, "a KV event from the worker")
        ev = json.loads(events[0].data)
        assert ev["type"] == "stored" and ev["worker"] == url
        assert ev["model"] == MODEL and ev["blocks"]
        assert events[0].subject == (
            "dynamo.kv_events.tiny-debug." + nats.subject_token(url))
        proc.send_signal(15)
        assert proc.wait(timeout=60) == 0, \
            proc.stderr.read().decode()[-2000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        nc.close()
        broker.close()


def test_heartbeat_payload_carries_what_the_router_reads(monkeypatch):
    """The port's heartbeat carries the JAX heartbeat's fields that the
    router and the frontend read: load and pages (headroom), the KVBM's
    host blocks and peer port, the batch pool's `preemptible`, health, weight version,
    costs and the timeline; a router fed it computes the headroom."""
    monkeypatch.setenv("DYNAMO_TPU_PREEMPTIBLE", "1")
    eng = Engine(EngineConfig(**dict(KW, kvbm_host_blocks=8,
                                     kvbm_gate="always")), device="cpu")
    ctx = api.ServingContext(eng, MODEL)
    try:
        beat = tworker.heartbeat_payload(ctx, "http://w:1")
        assert {"active_seqs", "pending", "free_pages", "total_pages",
                "max_num_seqs", "kvbm_host_blocks", "preemptible",
                "weight_version", "costs", "timeline",
                "health"} <= set(beat["stats"])
        assert beat["stats"]["kvbm_host_blocks"] == 8
        # the KVBM's peer pull: where peers fetch this host tier
        assert beat["stats"]["kvbm_peer_port"] == ctx.kvbm_source.port
        r = frontend.Router()
        r.register(beat["url"], beat["model"], beat["mode"], beat["stats"])
        (w,) = r.alive()
        st = beat["stats"]
        assert w.headroom == 0.5 + 0.5 * st["free_pages"] / st["total_pages"]
        assert w.health == "healthy"
    finally:
        ctx.close()
