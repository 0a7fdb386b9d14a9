"""Disaggregated prefill/decode: the port against the JAX package, on the
CPU, on tiny-debug with float32 and int8 pools and on tiny-mla-debug (page
size 4), both packages on the same weights (`loader.from_jax_params`).

Per model, one run (`runs`) records:
- engine level, greedy: the JAX prefill and decode engines' in-process
  handoff, and the port's over `ici_inproc` (`ICIHandoff`: a device gather
  and an in-place scatter) and over `dcn` (`KVSource` and `fetch_kv`),
  each against the port's aggregated engine;
- engine level, seeded sampling (temperature 0.9, seed 77, two top
  logprobs) and guided JSON (temperature 1.4, seed 33): the port's disagg
  against the port's aggregated engine (the port's sampling noise is its
  own, counter-based: ROADMAP "Intended divergences", so only the port's
  two paths are compared);
- served: chat completions through the JAX frontend in front of a JAX
  prefill and decode worker, and through two port frontends in front of a
  port prefill worker and a port decode worker each (backend `dcn`, and
  `ici` with the prefill engine in this process's `ici_registry`), and
  the same chats sent to a port aggregated worker. The workers decode with
  a tokenizer that shows every token id as one character, so the texts
  compare token for token.

Tolerance: none. Greedy float32 streams are equal token for token, the
seeded and guided streams too, and the first token's logprob to 1e-6."""

import dataclasses
import json
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.engine import Engine as JEngine
from dynamo_tpu.engine.request import GenRequest as JGenRequest
from dynamo_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import PRESETS as JPRESETS
from dynamo_tpu.serving import api as japi
from dynamo_tpu.serving import frontend as jfrontend
from dynamo_tpu.transfer import kv_transfer as jkv
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import Engine
from dynamo_tpu_torch.engine.request import GenRequest
from dynamo_tpu_torch.engine.tokenizer import ByteTokenizer
from dynamo_tpu_torch.models import loader
from dynamo_tpu_torch.models.config import PRESETS
from dynamo_tpu_torch.ops import json_guide
from dynamo_tpu_torch.serving import api
from dynamo_tpu_torch.serving import frontend
from dynamo_tpu_torch.transfer import ici_registry
from dynamo_tpu_torch.transfer import kv_transfer as tkv

# whole-prompt prefills on every path (no prefix cache: a chat's template
# would hit it and the aggregated worker would prefill the suffix alone,
# reading the prefix back from int8 pools: other bits than the prefill
# role's whole prompt)
KW = dict(page_size=4, num_pages=128, max_num_seqs=4, max_seq_len=256,
          async_scheduling=False, enable_prefix_caching=False,
          disaggregation_bootstrap_port=0)
VARIANTS = {
    "f32": dict(model="tiny-debug"),
    "int8": dict(model="tiny-debug", kv_cache_dtype="int8"),
    "mla": dict(model="tiny-mla-debug"),
}
N_TOKENS = 8
CHATS = ["Disaggregated hello.", "The decode worker imports pages " * 3,
         "A third prompt, of another bucket. " * 5]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class VisibleTokenizer(ByteTokenizer):
    """Every token id decodes to one character (random weights emit ids
    the byte tokenizer decodes to nothing)."""

    def decode(self, ids) -> str:
        return "".join(chr(0x3400 + i) for i in ids)


class JVisibleTokenizer(JByteTokenizer):
    def decode(self, ids) -> str:
        return "".join(chr(0x3400 + i) for i in ids)


def drain(engine, rid):
    out = []
    while engine.has_work:
        for ev in engine.step():
            if ev.request_id == rid and ev.token_id >= 0:
                out.append(ev.token_id)
    return out


def serve(make_server, ctx, tokenizer=None):
    if tokenizer is not None:
        ctx.tokenizer = tokenizer
    srv = make_server(ctx, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def post(url, body):
    with urllib.request.urlopen(urllib.request.Request(
            url, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"}), timeout=120) as r:
        return json.loads(r.read())


def register(front_url, url, mode, model):
    post(f"{front_url}/internal/register", {
        "url": url, "model": model, "mode": mode,
        "stats": {"max_num_seqs": 4, "free_pages": 120, "total_pages": 128}})


def chat(url, model, content):
    out = post(f"{url}/v1/chat/completions", {
        "model": model, "messages": [{"role": "user", "content": content}],
        "max_tokens": N_TOKENS, "temperature": 0, "ignore_eos": True})
    assert out["usage"]["completion_tokens"] == N_TOKENS
    return [ord(c) - 0x3400 for c in out["choices"][0]["message"]["content"]]


def engine_runs(jpre, jdec, tpre, tdec, tagg):
    out = {"jax": [], "ici_inproc": [], "dcn": [], "agg": []}
    rng = np.random.default_rng(5)
    for i, n in enumerate((5, 11, 23)):
        prompt = rng.integers(0, 256, size=n).tolist()
        kw = dict(max_tokens=N_TOKENS, temperature=0.0, ignore_eos=True)
        req = JGenRequest(f"j{i}", prompt, **kw)
        first, _, _ = jpre.prefill_only(req)
        jkv.ICIHandoff(jpre, jdec).transfer(req, first)
        out["jax"].append([first] + drain(jdec, req.request_id))
        req = GenRequest(f"i{i}", prompt, **kw)
        first, _, _ = tpre.prefill_only(req)
        tkv.ICIHandoff(tpre, tdec).transfer(req, first)
        out["ici_inproc"].append([first] + drain(tdec, req.request_id))
        req = GenRequest(f"d{i}", prompt, **kw)
        first, _, _ = tpre.prefill_only(req)
        src = tkv.KVSource(tpre, port=0)
        try:
            k, v, n_tokens = tkv.fetch_kv("127.0.0.1", src.port, f"d{i}")
        finally:
            src.close()
        assert n_tokens == n and k.dtype == tpre.k_pages.dtype
        assert tdec.import_kv(req, first, k, v) == (False, None)
        out["dcn"].append([first] + drain(tdec, req.request_id))
        out["agg"].append(tagg.generate(GenRequest(f"a{i}", prompt, **kw)))
    assert tpre.allocator.free_pages == KW["num_pages"] - 1
    # seeded sampling and its first-token logprobs across the handoff
    prompt = [2, 4, 6, 8, 10]
    mk = lambda rid: GenRequest(rid, prompt, max_tokens=N_TOKENS,  # noqa
                                temperature=0.9, seed=77, ignore_eos=True,
                                logprobs=2)
    tagg.add_request(mk("sref"))
    ref_events = []
    while tagg.has_work:
        ref_events += [e for e in tagg.step() if e.token_id >= 0]
    req = mk("sd")
    first, _, extras = tpre.prefill_only(req)
    tkv.ICIHandoff(tpre, tdec).transfer(req, first)
    out["seeded"] = ([e.token_id for e in ref_events],
                     [first] + drain(tdec, "sd"))
    out["seeded_logprob"] = (ref_events[0].logprob, extras["logprob"],
                             len(extras["top_logprobs"]))
    # guided JSON: the prefill role masks the first token, the decode role
    # resumes the grammar from the state the first token leads to
    prompt = [6, 2, 8, 3, 1, 8, 5, 3]
    kw = dict(max_tokens=10, temperature=1.4, top_p=1.0, seed=33,
              ignore_eos=True, guided_json=True)
    ref = tagg.generate(GenRequest("gref", prompt, **kw))
    req = GenRequest("gd", prompt, **kw)
    first, _, _ = tpre.prefill_only(req)
    tkv.ICIHandoff(tpre, tdec).transfer(req, first)
    got = [first] + drain(tdec, "gd")
    out["guided"] = (ref, got, json_guide.replay(
        tagg._ensure_guide_table(), ref)[0] != json_guide.DEAD)
    return out


def served_runs(jpre, jdec, tpre, tdecs, tagg, model):
    """Chats through the JAX disagg stack, the port's two disagg stacks
    and the port's aggregated worker; the decode workers' plane counts."""
    servers, ctxs = [], []

    def up(make_server, ctx, tok=None):
        srv, url = serve(make_server, ctx, tok)
        servers.append(srv)
        ctxs.append(ctx)
        return url

    def front(mod):
        fctx = mod.FrontendContext()
        fsrv = mod.make_frontend_server(fctx, "127.0.0.1", 0)
        threading.Thread(target=fsrv.serve_forever, daemon=True).start()
        servers.append(fsrv)
        return f"http://127.0.0.1:{fsrv.server_address[1]}"

    out = {}
    try:
        jpre_url = up(japi.make_server, japi.ServingContext(jpre, model))
        jdec_url = up(japi.make_server, japi.ServingContext(
            jdec, model, prefill_urls=[jpre_url]), JVisibleTokenizer())
        jfront = front(jfrontend)
        register(jfront, jpre_url, "prefill", model)
        register(jfront, jdec_url, "decode", model)
        tpre_url = up(api.make_server, api.ServingContext(tpre, model))
        ici_registry.register(tpre_url, tpre)
        fronts = {}
        dec_ctxs = {}
        for plane, dec in tdecs.items():
            dec_ctxs[plane] = api.ServingContext(dec, model,
                                                 prefill_urls=[tpre_url])
            url = up(api.make_server, dec_ctxs[plane], VisibleTokenizer())
            fronts[plane] = front(frontend)
            register(fronts[plane], tpre_url, "prefill", model)
            register(fronts[plane], url, "decode", model)
        agg_url = up(api.make_server, api.ServingContext(tagg, model),
                     VisibleTokenizer())
        out["jax"] = [chat(jfront, model, c) for c in CHATS]
        for plane, url in fronts.items():
            out[plane] = [chat(url, model, c) for c in CHATS]
        out["agg"] = [chat(agg_url, model, c) for c in CHATS]
        out["planes"] = {p: dict(c.disagg_client.plane_counts)
                         for p, c in dec_ctxs.items()}
        with urllib.request.urlopen(f"{tpre_url}/worker/stats",
                                    timeout=30) as r:
            out["prefill_stats"] = json.loads(r.read())
    finally:
        ici_registry.clear()
        for srv in servers:
            srv.shutdown()
            srv.server_close()
        for ctx in ctxs:
            ctx.close()
    return out


@pytest.fixture(scope="module", params=list(VARIANTS))
def runs(request):
    variant = request.param
    spec = VARIANTS[variant]
    name = spec["model"]
    jcfg = dataclasses.replace(JPRESETS[name], dtype="float32")
    tcfg = dataclasses.replace(PRESETS[name], dtype="float32")
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    model = loader.from_jax_params(
        tcfg, {k: np.asarray(v) for k, v in jparams.items()}, device="cpu",
        dtype=torch.float32)
    kw = dict(KW, **spec)

    def jeng(mode):
        return JEngine(JEngineConfig(**kw, disaggregation_mode=mode),
                       model_cfg=jcfg, params=jparams)

    def teng(mode, backend="ici"):
        return Engine(EngineConfig(**kw, disaggregation_mode=mode,
                                   disaggregation_transfer_backend=backend),
                      model_cfg=tcfg, params=model, device="cpu")

    jpre, jdec = jeng("prefill"), jeng("decode")
    tpre, tagg = teng("prefill"), teng("agg")
    tdecs = {"dcn": teng("decode", "dcn"), "ici_inproc": teng("decode")}
    out = {"engine": engine_runs(jpre, jdec, tpre, tdecs["ici_inproc"],
                                 tagg)}
    out["served"] = served_runs(jpre, jdec, tpre, tdecs, tagg, name)
    out["variant"] = variant
    out["lanes"] = tpre.kv_spec.lane_width
    return out


def test_greedy_engine_handoffs_equal_jax_and_agg(runs):
    e = runs["engine"]
    assert e["jax"] == e["ici_inproc"] == e["dcn"] == e["agg"]
    assert all(len(s) == N_TOKENS for s in e["agg"])
    # int8 pools are packed rows of 128 lanes; MLA pools one latent row
    assert runs["lanes"] == {"f32": 64, "int8": 128, "mla": 40}[
        runs["variant"]]


def test_seeded_sampling_continues_across_handoff(runs):
    ref, got = runs["engine"]["seeded"]
    assert got == ref and len(ref) == N_TOKENS
    agg_lp, disagg_lp, n_top = runs["engine"]["seeded_logprob"]
    assert disagg_lp == pytest.approx(agg_lp, abs=1e-6) and n_top == 2


def test_guided_json_across_handoff(runs):
    ref, got, legal = runs["engine"]["guided"]
    assert got == ref and legal


def test_served_through_frontends_equal_jax_and_agg(runs):
    s = runs["served"]
    assert s["jax"] == s["dcn"] == s["ici_inproc"] == s["agg"]
    assert all(len(t) == N_TOKENS for t in s["agg"])


def test_served_planes_counted(runs):
    s = runs["served"]
    n = len(CHATS)
    assert s["planes"] == {
        "dcn": {"ici_inproc": 0, "ici_device": 0, "dcn": n},
        "ici_inproc": {"ici_inproc": n, "ici_device": 0, "dcn": 0}}
    st = s["prefill_stats"]
    assert st["disaggregation_mode"] == "prefill"
    assert st["native"]["native_transport"] is True
    assert st["parked_kv"] == 0
    assert st["free_pages"] == KW["num_pages"] - 1
