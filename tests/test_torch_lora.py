"""Multi-LoRA adapter serving in the port against the JAX package's.

At tiny-debug shapes (float32, the JAX tree of PRNGKey(0)), with adapters
drawn by `lora.apply.random_adapter` from seeds:

- `lora.apply.delta` (per-slot products, masked to each row's slot)
  against `dynamo_tpu.lora.apply.delta` (the per-row gather).
- The registry: `adapter.npz` and an HF-PEFT `adapter_model.safetensors`
  directory written here load to the JAX loader's arrays, and register
  to its rank-padded, alpha-scaled stacks; names, ranks and shapes are
  validated; LRU loads and pinning by live sequences.
- Every forward (prefill, prefill_chunk, prefill_batch, decode_step,
  mixed_step, decode_verify, mixed_verify_step) with base and adapter
  rows mixed against the JAX forward over the same stacks: logits within
  1e-4, pools within 1e-5.
- Engines: greedy streams of base and two adapters' requests together
  against the JAX engine's, through 8-step async windows, the mixed step
  and n-gram speculation; the base slot bit for bit against lora_slots=0
  (tokens and logprobs); an adapter and the base never share a prefix
  page (the namespaced hash chain is JAX's, byte for byte).
- The in-process server: `<base>:<adapter>` model ids, `/v1/models`,
  `GET`/`POST /v1/adapters` and the `lora` section of `/worker/stats`.

The card runs the same math inside its captured decode steps
(chip_smoke.py).
"""

import dataclasses
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.engine import Engine as JEngine
from dynamo_tpu.engine.kv_cache import PageAllocator as JPageAllocator
from dynamo_tpu.engine.kv_cache import PrefixCache as JPrefixCache
from dynamo_tpu.engine.request import GenRequest as JGenRequest
from dynamo_tpu.lora import apply as jlora
from dynamo_tpu.lora import registry as jregistry
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import PRESETS as JPRESETS
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import Engine
from dynamo_tpu_torch.engine.kv_cache import PageAllocator, PrefixCache
from dynamo_tpu_torch.engine.request import GenRequest
from dynamo_tpu_torch.lora import apply as lora_apply
from dynamo_tpu_torch.lora import registry
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models import loader
from dynamo_tpu_torch.models.config import PRESETS
from dynamo_tpu_torch.serving import api

PS = 8
RANK = 4
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
KV_TOL = dict(rtol=1e-5, atol=1e-5)
BASE = dict(model="tiny-debug", page_size=PS, num_pages=128, max_num_seqs=4,
            max_seq_len=256, prefill_chunk_tokens=0,
            enable_prefix_caching=False, lora_slots=2, lora_rank=RANK)
NAMES = ("ada", "bob")


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
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(JPRESETS["tiny-debug"], dtype="float32")
    tcfg = dataclasses.replace(PRESETS["tiny-debug"], dtype="float32")
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    model = loader.from_jax_params(
        tcfg, {k: np.asarray(v) for k, v in jparams.items()}, device="cpu",
        dtype=torch.float32)
    # large enough that each adapter shifts the greedy argmax of the tiny
    # random base within a few tokens
    adapters = {n: jlora.random_adapter(jcfg, rank=RANK, seed=i + 1,
                                        scale=0.3)
                for i, n in enumerate(NAMES)}
    return jcfg, jparams, model, adapters


def test_delta_matches_jax():
    rng = np.random.default_rng(0)
    s, d_in, r, d_out, t = 4, 24, 3, 16, 11
    x = rng.standard_normal((t, d_in)).astype(np.float32)
    a = rng.standard_normal((s, d_in, r)).astype(np.float32)
    b = rng.standard_normal((s, r, d_out)).astype(np.float32)
    a[0], b[0] = 0, 0  # the base slot
    slots = rng.integers(0, s, size=t).astype(np.int32)
    want = np.asarray(jlora.delta(jnp, jnp.asarray(x), jnp.asarray(a),
                                  jnp.asarray(b), jnp.asarray(slots)))
    got = lora_apply.delta(_t(x), _t(a), _t(b), _t(slots))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert not got[slots == 0].any()  # the base slot adds exactly 0


def _peft_dir(path, tensors, rank, alpha):
    """An HF-PEFT adapter directory: per layer lora_A [r, in], lora_B
    [out, r] under PEFT's key names."""
    from safetensors.numpy import save_file

    out = {}
    for t in "qkvo":
        for li in range(tensors[t + "a"].shape[0]):
            pre = (f"base_model.model.model.layers.{li}.self_attn.{t}_proj")
            out[f"{pre}.lora_A.weight"] = np.ascontiguousarray(
                tensors[t + "a"][li].T)
            out[f"{pre}.lora_B.weight"] = np.ascontiguousarray(
                tensors[t + "b"][li].T)
    path.mkdir()
    save_file(out, str(path / "adapter_model.safetensors"))
    (path / "adapter_config.json").write_text(
        json.dumps({"r": rank, "lora_alpha": alpha}))


def test_registry_loads_npz_and_peft_like_jax(tmp_path, models):
    jcfg, _, model, adapters = models
    registry.save_adapter_npz(str(tmp_path / "npz"), adapters["ada"], RANK,
                              alpha=8)
    _peft_dir(tmp_path / "peft", adapters["bob"], RANK, 2)
    eng = Engine(EngineConfig(**dict(BASE, lora_rank=6)), params=model,
                 device="cpu")
    for name, sub in (("ada", "npz"), ("bob", "peft")):
        got = registry._load_adapter_dir(str(tmp_path / sub))
        want = jregistry._load_adapter_dir(str(tmp_path / sub))
        assert got[1:] == want[1:]
        assert set(got[0]) == set(want[0])
        for k in want[0]:
            np.testing.assert_array_equal(got[0][k], want[0][k])
        ad = eng.lora.register(name, path=str(tmp_path / sub))
        scale = want[2] / want[1]
        for t in "qkvo":
            a, b = jlora.pad_rank(want[0][t + "a"], want[0][t + "b"] * scale,
                                  6)
            np.testing.assert_array_equal(ad.tensors[t + "a"], a)
            np.testing.assert_array_equal(ad.tensors[t + "b"], b)
    with pytest.raises(ValueError, match="invalid adapter name"):
        eng.lora.register("no:colons", tensors=adapters["ada"], rank=RANK)
    with pytest.raises(ValueError, match="shapes"):
        eng.lora.register("bad", tensors={**adapters["ada"],
                                          "qa": adapters["ada"]["qa"][:, 1:]},
                          rank=RANK)
    with pytest.raises(ValueError, match="rank"):
        eng.lora.register("big", tensors=jlora.random_adapter(jcfg, rank=8),
                          rank=8)


def test_registry_lru_and_pinning(models):
    _, _, model, adapters = models
    eng = Engine(EngineConfig(**dict(BASE, lora_slots=1)), params=model,
                 device="cpu")
    for n in NAMES:
        eng.lora.register(n, tensors=adapters[n], rank=RANK)
    assert eng.lora.acquire_slot("ada") == 1
    assert eng.lora.acquire_slot("bob") == 1  # idle "ada" evicted
    assert eng.lora.stats()["evictions_total"] == 1
    eng.add_request(GenRequest("live", [1, 2, 3], max_tokens=30,
                               ignore_eos=True, adapter="bob"))
    eng.step()
    with pytest.raises(registry.NoFreeAdapterSlot):
        eng.lora.acquire_slot("ada")
    # a request for the other adapter waits while the slot is pinned
    eng.add_request(GenRequest("wait", [1, 2, 3], max_tokens=2,
                               ignore_eos=True, adapter="ada"))
    eng.step()
    assert [r.request_id for r in eng.pending] == ["wait"]
    while eng.has_work:
        eng.step()
    assert eng.lora.slot_of("ada") == 1
    with pytest.raises(ValueError, match="unknown adapter"):
        eng.add_request(GenRequest("x", [1], adapter="nobody"))


# --------------------------------------------------------------- forwards --


def _stacked(jparams, jcfg, adapters):
    """The JAX tree with LoRA stacks of 3 slots: base, ada, bob (scale
    folded in as the registry folds alpha / rank = 1)."""
    params = dict(jparams)
    stacks = jlora.init_stacks(jcfg, 3, RANK)
    for slot, n in enumerate(NAMES, start=1):
        for t in "qkvo":
            stacks[jlora.param_name(t, "a")][:, slot] = adapters[n][t + "a"]
            stacks[jlora.param_name(t, "b")][:, slot] = adapters[n][t + "b"]
    params.update({k: jnp.asarray(v) for k, v in stacks.items()})
    return params, stacks


def _pools(cfg, rng, n_pool=24):
    shape = (cfg.num_layers, n_pool, PS, cfg.num_kv_heads * cfg.head_dim)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


FORWARDS = ("prefill", "prefill_chunk", "prefill_batch", "decode_step",
            "mixed_step", "decode_verify", "mixed_verify_step")


@pytest.mark.parametrize("kind", FORWARDS)
def test_forward_with_mixed_slots_matches_jax(models, kind):
    jcfg, jparams, _, _ = models
    # a delta about the size of the projections (the engines' adapters are
    # larger, so that greedy streams change; here they would sharpen the
    # softmax until f32 rounding in either framework shows past 1e-5)
    adapters = {n: jlora.random_adapter(jcfg, rank=RANK, seed=i + 1,
                                        scale=0.1)
                for i, n in enumerate(NAMES)}
    params, stacks = _stacked(jparams, jcfg, adapters)
    tcfg = dataclasses.replace(PRESETS["tiny-debug"], dtype="float32")
    arrays = {k: np.asarray(v) for k, v in params.items()}
    model = loader.from_jax_params(tcfg, arrays, device="cpu",
                                   dtype=torch.float32)
    lora = lora_apply.Stacks.from_arrays(arrays, "cpu", torch.float32)
    assert lora is not None and lora.num_slots == 3
    rng = np.random.default_rng(FORWARDS.index(kind))
    kp, vp = _pools(jcfg, rng)
    tk, tv = _t(kp), _t(vp)
    jk, jv = jnp.asarray(kp), jnp.asarray(vp)
    v = jcfg.vocab_size
    toks = rng.integers(0, v, size=(3, 2 * PS)).astype(np.int32)
    slots = np.array([2, 0, 1], np.int32)
    tables = np.array([[1, 2, 0], [3, 4, 9], [5, 6, 7]], np.int32)
    positions = np.array([10, 3, 17], np.int32)
    chunk_pages = np.array([11, 12, 13, 0], np.int32)
    lo = dict(lora=lora)
    if kind == "prefill":
        ref = jllama.prefill(jcfg, params, jnp.asarray(toks[0]),
                             jnp.int32(13), jk, jv, jnp.asarray(tables[0, :2]),
                             page_size=PS, adapter_slots=jnp.int32(2))
        got = tllama.prefill(model, _t(toks[0]), 13, tk, tv,
                             _t(tables[0, :2]), page_size=PS,
                             adapter_slots=2, **lo)
        pairs = [(got, ref.last_logits)]
    elif kind == "prefill_chunk":
        ref = jllama.prefill_chunk(jcfg, params, jnp.asarray(toks[0]),
                                   jnp.int32(PS), jnp.int32(11), jk, jv,
                                   jnp.asarray(chunk_pages), page_size=PS,
                                   adapter_slots=jnp.int32(1))
        got = tllama.prefill_chunk(model, _t(toks[0]), PS, 11, tk, tv,
                                   _t(chunk_pages), page_size=PS,
                                   adapter_slots=1, **lo)
        pairs = [(got, ref.last_logits)]
    elif kind == "prefill_batch":
        lens = np.array([16, 5, 9], np.int32)
        ref = jllama.prefill_batch(jcfg, params, jnp.asarray(toks),
                                   jnp.asarray(lens), jk, jv,
                                   jnp.asarray(tables[:, :2]), page_size=PS,
                                   adapter_slots=jnp.asarray(slots))
        got = tllama.prefill_batch(model, _t(toks), _t(lens), tk, tv,
                                   _t(tables[:, :2]), page_size=PS,
                                   adapter_slots=_t(slots), **lo)
        pairs = [(got, ref.last_logits)]
    elif kind == "decode_step":
        ref = jllama.decode_step(jcfg, params, jnp.asarray(toks[:, 0]),
                                 jnp.asarray(positions), jnp.asarray(tables),
                                 jnp.asarray(positions + 1), jk, jv,
                                 page_size=PS,
                                 adapter_slots=jnp.asarray(slots))
        got = tllama.decode_step(model, _t(toks[:, 0]), _t(positions),
                                 _t(tables), _t(positions + 1), tk, tv,
                                 page_size=PS, adapter_slots=_t(slots), **lo)
        pairs = [(got, ref.logits)]
    elif kind == "mixed_step":
        ref = jllama.mixed_step(
            jcfg, params, jnp.asarray(toks[:, 0]), jnp.asarray(positions),
            jnp.asarray(tables), jnp.asarray(positions + 1),
            jnp.asarray(toks[0]), jnp.int32(PS), jnp.int32(11),
            jnp.asarray(chunk_pages), jk, jv, page_size=PS,
            adapter_slots=jnp.asarray(slots), chunk_adapter_slot=jnp.int32(1))
        got, last = tllama.mixed_step(
            model, _t(toks[:, 0]), _t(positions), _t(tables),
            _t(positions + 1), _t(toks[0]), PS, 11, _t(chunk_pages), tk, tv,
            page_size=PS, adapter_slots=_t(slots), chunk_adapter_slot=1,
            **lo)
        pairs = [(got, ref.logits), (last, ref.chunk_logits)]
    else:
        k1 = 4
        room = np.array([True, True, True])
        if kind == "decode_verify":
            ref = jllama.decode_verify(
                jcfg, params, jnp.asarray(toks[:, :k1]),
                jnp.asarray(positions), jnp.asarray(tables),
                jnp.asarray(room), jk, jv, page_size=PS,
                adapter_slots=jnp.asarray(slots))
            got = tllama.decode_verify(
                model, _t(toks[:, :k1]), _t(positions), _t(tables), _t(room),
                tk, tv, page_size=PS, adapter_slots=_t(slots), **lo)
            pairs = [(got, ref.logits)]
        else:
            ref = jllama.mixed_verify_step(
                jcfg, params, jnp.asarray(toks[:, :k1]),
                jnp.asarray(positions), jnp.asarray(tables),
                jnp.asarray(room), jnp.asarray(toks[0]), jnp.int32(PS),
                jnp.int32(11), jnp.asarray(chunk_pages), jk, jv,
                page_size=PS, adapter_slots=jnp.asarray(slots),
                chunk_adapter_slot=jnp.int32(2))
            got, last = tllama.mixed_verify_step(
                model, _t(toks[:, :k1]), _t(positions), _t(tables), _t(room),
                _t(toks[0]), PS, 11, _t(chunk_pages), tk, tv, page_size=PS,
                adapter_slots=_t(slots), chunk_adapter_slot=2, **lo)
            pairs = [(got, ref.logits), (last, ref.chunk_logits)]
    for g, w in pairs:
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **LOGIT_TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(ref.k_pages), **KV_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(ref.v_pages), **KV_TOL)
    if kind == "decode_step":  # the adapters' rows differ from the base's
        base = tllama.decode_step(model, _t(toks[:, 0]), _t(positions),
                                  _t(tables), _t(positions + 1), _t(kp),
                                  _t(vp), page_size=PS)
        assert torch.equal(base[1], got[1])  # slot 0: a delta of exactly 0
        assert not torch.allclose(base[0], got[0], atol=1e-3)


# ---------------------------------------------------------------- engines --


def _port(models, adapters=True, **kw):
    _, _, model, ads = models
    eng = Engine(EngineConfig(**dict(BASE, **kw)), params=model,
                 device="cpu")
    if adapters:
        for n in NAMES:
            eng.lora.register(n, tensors=ads[n], rank=RANK)
    return eng


def drive(engine, make_req, reqs, steps=800):
    """Add reqs [(rid, prompt, kwargs)], step until idle: {rid: [(token,
    logprob)]}."""
    for rid, prompt, kw in reqs:
        engine.add_request(make_req(rid, prompt, **kw))
    out = {}
    for _ in range(steps):
        if not engine.has_work:
            break
        for ev in engine.step():
            if ev.token_id >= 0:
                out.setdefault(ev.request_id, []).append(ev.token_id)
    assert not engine.has_work
    return out


MIXED = [("base", [5, 6, 7, 5, 6, 7, 5, 6], dict(max_tokens=24)),
         ("ada", [5, 6, 7, 5, 6, 7, 5, 6], dict(max_tokens=24,
                                                adapter="ada")),
         ("bob", [9, 8, 7, 9, 8, 7], dict(max_tokens=20, adapter="bob")),
         ("ada2", [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
                   17, 18, 19, 20, 21, 22, 23, 24, 25],
          dict(max_tokens=16, adapter="ada"))]


def _ignore_eos(reqs):
    return [(r, p, dict(kw, ignore_eos=True)) for r, p, kw in reqs]


@pytest.fixture(scope="module")
def jax_streams(models):
    jcfg, jparams, _, adapters = models
    ref = JEngine(JEngineConfig(**BASE), params=dict(jparams))
    for n in NAMES:
        ref.lora.register(n, tensors=adapters[n], rank=RANK)
    return drive(ref, JGenRequest, _ignore_eos(MIXED))


@pytest.mark.parametrize("kw", [
    dict(num_scheduler_steps=8, async_scheduling=True),
    dict(mixed_batch_tokens=16),
    dict(speculative_mode="ngram", num_speculative_tokens=4),
], ids=["windows", "mixed", "ngram"])
def test_mixed_adapter_streams_match_jax(models, jax_streams, kw):
    eng = _port(models, **kw)
    got = drive(eng, GenRequest, _ignore_eos(MIXED))
    assert got == jax_streams
    assert got["ada"] != got["base"]  # same prompt, other weights
    if "mixed_batch_tokens" in kw:
        assert eng.metrics.mixed_count > 0
    if "speculative_mode" in kw:
        assert eng.metrics.spec_verify_steps > 0


def test_base_slot_is_bit_for_bit_lora_off(models):
    reqs = [(f"r{i}", [3 + i, 4, 5, 6, 7, 8], dict(
        max_tokens=12, ignore_eos=True, logprobs=2)) for i in range(3)]

    def events(eng):
        for rid, prompt, kw in reqs:
            eng.add_request(GenRequest(rid, prompt, **kw))
        out = []
        while eng.has_work:
            out += [(e.request_id, e.token_id, e.logprob, e.top_logprobs)
                    for e in eng.step()]
        return out

    kw = dict(num_scheduler_steps=4)
    assert events(_port(models, **kw)) == events(
        _port(models, adapters=False, **dict(kw, lora_slots=0)))


def test_adapter_and_base_never_share_prefix_pages(models):
    prompt = list(range(1, 3 * PS + 3))
    eng = _port(models, enable_prefix_caching=True, prefill_chunk_tokens=PS)

    def hits_after(rid, adapter):
        eng.generate(GenRequest(rid, prompt, max_tokens=2, ignore_eos=True,
                                adapter=adapter))
        return eng.prefix_cache.stats()["hits"]

    assert hits_after("b0", None) == 0
    assert hits_after("a0", "ada") == 0  # base pages are not ada's
    assert hits_after("a1", "ada") == 1
    assert hits_after("o0", "bob") == 1
    assert hits_after("b1", None) == 2
    port = PrefixCache(PageAllocator(8), PS)
    ref = JPrefixCache(JPageAllocator(8), PS)
    for ns in ("", "ada", "x.y-z"):
        assert port._hashes(prompt, 3, ns) == ref._hashes(prompt, 3, ns)


# ----------------------------------------------------------------- server --


def _call(url, body=None, timeout=120):
    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def server(models, tmp_path_factory):
    _, _, _, adapters = models
    path = tmp_path_factory.mktemp("adapters")
    registry.save_adapter_npz(str(path / "ada"), adapters["ada"], RANK)
    registry.save_adapter_npz(str(path / "bob"), adapters["bob"], RANK)
    eng = _port(models, adapters=False,
                lora_adapters=f"ada={path / 'ada'}")
    ctx = api.ServingContext(eng, served_model="tiny-debug")
    srv = api.make_server(ctx, host="127.0.0.1", port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", str(path / "bob")
    srv.shutdown()
    ctx.close()


def test_adapter_api_and_model_addressing(server):
    url, bob = server
    models = {m["id"] for m in _call(url + "/v1/models")["data"]}
    assert models == {"tiny-debug", "tiny-debug:ada"}
    out = _call(url + "/v1/adapters", {"name": "bob", "path": bob,
                                       "load": True})
    assert out["registered"] and out["resident"] and out["slot"] == 1
    assert _call(url + "/v1/models/tiny-debug:bob")["id"] == "tiny-debug:bob"

    def complete(model):
        return _call(url + "/v1/completions", {
            "model": model, "prompt": "hello", "max_tokens": 6,
            "temperature": 0, "ignore_eos": True})["choices"][0]["text"]

    assert complete("tiny-debug:ada") != complete("tiny-debug")
    listed = _call(url + "/v1/adapters")
    by_name = {d["name"]: d for d in listed["data"]}
    assert by_name["ada"]["resident"] and by_name["ada"]["requests"] == 1
    assert listed["slots"] == {"total": 2, "free": 0}
    stats = _call(url + "/worker/stats")["lora"]
    assert stats["slots_total"] == 2 and "ada" in stats["resident"]
    with pytest.raises(urllib.error.HTTPError) as e:
        _call(url + "/v1/chat/completions", {
            "model": "tiny-debug:ghost", "max_tokens": 2,
            "messages": [{"role": "user", "content": "x"}]})
    assert e.value.code == 400
    assert _call(url + "/v1/adapters", {"name": "bob",
                                        "unload": True})["unloaded"]
    assert _call(url + "/v1/adapters", {"name": "bob",
                                        "remove": True})["removed"]
    models = {m["id"] for m in _call(url + "/v1/models")["data"]}
    assert models == {"tiny-debug", "tiny-debug:ada"}
