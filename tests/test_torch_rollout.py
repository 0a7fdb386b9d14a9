"""The port's hitless weight rollout against the JAX engine's, on the CPU:
stage, flip, rollback and commit of a second weight version (both
packages load the same two checkpoints this file writes, so v1 and v2 are
the same weights in both), the headroom and tree checks that leave v1
untouched, the version-namespaced prefix cache, the armed finish-mode
flip, and `/internal/rollout` with its series. Greedy tokens are compared
exactly (no tolerance). The flip swaps contents in the live storage, so
the weights' addresses never move (what keeps the card's captured decode
graphs valid; `tests/test_torch_cuda.py` replays them across a flip)."""

import json
import os
import threading
import urllib.error
import urllib.request

import pytest
import torch

from dynamo_tpu.elasticity import weights as jweights
from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.engine import Engine as JEngine
from dynamo_tpu.engine.request import GenRequest as JGenRequest
from dynamo_tpu_torch.elasticity.weights import (BASE_VERSION, HEADROOM_ENV,
                                                 StageError, _Tree)
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import Engine
from dynamo_tpu_torch.engine.request import GenRequest
from dynamo_tpu_torch.serving import api
from tests.test_torch_loader import write_checkpoint

PROMPT = [3, 1, 4, 1, 5, 9, 2, 6]
BASE = dict(model="tiny-debug", page_size=4, num_pages=128, max_num_seqs=4,
            max_seq_len=128, prefill_chunk_tokens=16)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module: the parallel test workers share
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Two checkpoints of one architecture: v1 and v2."""
    root = tmp_path_factory.mktemp("rollout")
    write_checkpoint(root / "v1", seed=5)
    write_checkpoint(root / "v2", seed=9)
    return {k: str(root / k) for k in ("v1", "v2")}


def port_engine(path, **kw):
    return Engine(EngineConfig(**{**BASE, "model_path": path, **kw}),
                  device="cpu")


def jax_engine(path, **kw):
    return JEngine(JEngineConfig(**{**BASE, "model_path": path,
                                    "async_scheduling": False, **kw}))


def greedy(eng, make_req, rid, prompt=PROMPT, max_tokens=10):
    return eng.generate(make_req(rid, list(prompt), max_tokens=max_tokens,
                                 temperature=0.0, ignore_eos=True))


@pytest.fixture(scope="module")
def refs(ckpts):
    """The JAX engine's greedy tokens on v1 and on v2."""
    return {v: greedy(jax_engine(ckpts[v]), JGenRequest, "ref")
            for v in ("v1", "v2")}


def _addresses(eng):
    return [t.data_ptr() for _, t in
            list(eng.model.named_parameters()) + list(
                eng.model.named_buffers())]


def test_stage_flip_rollback_give_the_jax_engines_tokens(ckpts, refs):
    assert refs["v1"] != refs["v2"], "the two versions must differ"
    eng = port_engine(ckpts["v1"])
    wm = eng.weights
    addr = _addresses(eng)
    assert wm.version == BASE_VERSION and wm.namespace == ""
    assert greedy(eng, GenRequest, "r0") == refs["v1"]

    staged = wm.stage("v2", model_path=ckpts["v2"])
    assert staged["version"] == "v2" and staged["bytes"] > 0
    assert wm.staged_version == "v2" and wm.version == BASE_VERSION
    assert greedy(eng, GenRequest, "r1") == refs["v1"]

    assert wm.flip() == {"version": "v2", "state": "live",
                         "previous": BASE_VERSION}
    assert wm.version == "v2" and wm.namespace == "v2"
    assert wm.previous_version == BASE_VERSION
    assert greedy(eng, GenRequest, "r2") == refs["v2"]
    assert _addresses(eng) == addr, "the flip must not move the weights"

    rb = wm.rollback()
    assert rb["version"] == BASE_VERSION and rb["rolled_back"] == "v2"
    assert wm.previous_version is None and wm.staged_version is None
    assert greedy(eng, GenRequest, "r3") == refs["v1"]
    assert wm.stats()["flips_total"] == 1
    assert wm.stats()["rollbacks_total"] == 1

    wm.stage("v2", model_path=ckpts["v2"])
    wm.flip()
    assert greedy(eng, GenRequest, "r4") == refs["v2"]
    assert wm.commit()["dropped"] == BASE_VERSION
    assert wm.previous_nbytes == 0
    with pytest.raises(StageError):
        wm.rollback()
    assert _addresses(eng) == addr


@pytest.mark.parametrize("quantization", ["int8", "w8a8"])
def test_quantized_weights_flip_like_the_jax_engine(ckpts, quantization):
    """The swap moves int8 q (column-major) and f32 scales as it moves
    bf16 weights: a quantized engine's flip gives the tokens of an engine
    booted on v2 at the same quantization, and its rollback v1's (the
    quantized engines against JAX's: tests/test_torch_quant.py)."""
    want = {v: greedy(port_engine(ckpts[v], quantization=quantization),
                      GenRequest, "ref") for v in ("v1", "v2")}
    eng = port_engine(ckpts["v1"], quantization=quantization)
    assert greedy(eng, GenRequest, "q1") == want["v1"]
    eng.weights.stage("v2", model_path=ckpts["v2"])
    eng.weights.flip()
    assert greedy(eng, GenRequest, "q2") == want["v2"]
    eng.weights.rollback()
    assert greedy(eng, GenRequest, "q3") == want["v1"]


def test_the_jax_engine_rolls_the_same_checkpoints(ckpts, refs):
    """The reference side of the parity above: the JAX WeightManager on
    the same two checkpoints gives the tokens the port's flip gives."""
    eng = jax_engine(ckpts["v1"])
    assert greedy(eng, JGenRequest, "j0") == refs["v1"]
    eng.weights.stage("v2", model_path=ckpts["v2"])
    eng.weights.flip()
    assert greedy(eng, JGenRequest, "j1") == refs["v2"]
    eng.weights.rollback()
    assert greedy(eng, JGenRequest, "j2") == refs["v1"]


def test_stage_validations_protect_the_live_tree(ckpts):
    eng = port_engine(ckpts["v1"])
    wm = eng.weights
    with pytest.raises(StageError):
        wm.stage("")
    with pytest.raises(StageError):
        wm.stage(BASE_VERSION)
    wm.stage("v2", model_path=ckpts["v2"])
    with pytest.raises(StageError):
        wm.stage("v3", seed=2)
    assert wm.abort_stage() and not wm.abort_stage()
    assert wm.staged_version is None and wm.version == BASE_VERSION
    wm.stage("v2", model_path=ckpts["v2"])
    wm.flip()
    assert wm.previous_version == BASE_VERSION
    wm.stage("v3", model_path=ckpts["v1"])
    assert wm.previous_version is None, \
        "at most two trees resident: stage drops the rollback buffer"


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_insufficient_headroom_aborts_the_stage_with_v1_untouched(
        ckpts, refs, pkg, monkeypatch):
    eng = (port_engine(ckpts["v1"]) if pkg == "port"
           else jax_engine(ckpts["v1"]))
    req = GenRequest if pkg == "port" else JGenRequest
    err = StageError if pkg == "port" else jweights.StageError
    monkeypatch.setenv(HEADROOM_ENV, "10")
    with pytest.raises(err, match="aborting"):
        eng.weights.stage("v2", model_path=ckpts["v2"])
    monkeypatch.delenv(HEADROOM_ENV)
    assert eng.weights.staged_version is None
    assert eng.weights.stats()["stage_aborts_total"] == 1
    assert greedy(eng, req, "a1") == refs["v1"]
    evs = [e for r in eng.flight.records() for e in r.get("events", ())]
    assert any(e.get("ev") == "rollout_stage_abort"
               and e.get("reason") == "insufficient_hbm" for e in evs)


def test_a_tree_mismatch_never_stages(ckpts, refs):
    """v2 in int8 has q/scale buffers where the live float model has
    weights: the stage is refused, nothing stays resident, v1 serves on."""
    eng = port_engine(ckpts["v1"])
    with pytest.raises(StageError, match="tree_mismatch"):
        eng.weights.stage("v2", model_path=ckpts["v2"], quantization="int8")
    assert eng.weights.staged_version is None
    assert greedy(eng, GenRequest, "m") == refs["v1"]


def test_swap_layout_is_checked_storage_by_storage(ckpts):
    """Two trees swap only when every named tensor has the same shape,
    dtype, strides, offset and storage: a transposed leaf is refused."""
    a = port_engine(ckpts["v1"]).model
    b = port_engine(ckpts["v2"]).model
    assert _Tree(a).mismatch(_Tree(b)) is None
    b.layers[0].wq.data = b.layers[0].wq.data.t().contiguous().t()
    assert "leaf_mismatch" in _Tree(a).mismatch(_Tree(b))


def test_kv_namespace_composes_version_and_adapter(ckpts):
    eng = port_engine(ckpts["v1"])
    jeng = jax_engine(ckpts["v1"])
    for e in (eng, jeng):
        assert e._kv_namespace(None) == "" and e._kv_namespace("ad") == "ad"
        e.weights.stage("v2", model_path=ckpts["v2"])
        e.weights.flip()
    for a in (None, "ad"):
        assert eng._kv_namespace(a) == jeng._kv_namespace(a)
    assert eng._kv_namespace(None) == "v2#"
    booted = port_engine(ckpts["v1"], model_version="v2")
    assert booted.weights.version == "v2"
    assert booted._kv_namespace("ad") == "v2#ad"


def test_prefix_cache_misses_across_versions(ckpts):
    eng = port_engine(ckpts["v1"])
    jeng = jax_engine(ckpts["v1"])
    pc = eng.prefix_cache
    greedy(eng, GenRequest, "warm")
    assert pc.has_prefix(PROMPT, namespace="")
    assert not pc.has_prefix(PROMPT, namespace="v2#"), \
        "v1 blocks must never verify against v2 weights"
    greedy(eng, GenRequest, "again")  # a v1 hit
    hits = pc.stats()["hits"]
    assert hits >= 1
    eng.weights.stage("v2", model_path=ckpts["v2"])
    eng.weights.flip()
    greedy(eng, GenRequest, "warm2")
    assert pc.stats()["hits"] == hits, "a v1 hit must miss under v2"
    assert pc.has_prefix(PROMPT, namespace="v2#")
    by_ns = pc.pages_by_namespace()
    assert "" in by_ns and "v2#" in by_ns
    # the version-seeded chain is the JAX engine's, hash for hash
    assert pc._hashes(PROMPT, 2, namespace="v2#") == \
        jeng.prefix_cache._hashes(PROMPT, 2, namespace="v2#")


def test_armed_flip_inflight_matches_and_admissions_land_on_v2(ckpts, refs):
    """In-flight v1 streams cross an armed flip with the tokens of a
    no-rollout run; an admission held during the drain lands on v2 with
    the tokens of an engine booted on v2 (the JAX engine's)."""
    eng = port_engine(ckpts["v1"])
    wm = eng.weights
    eng.add_request(GenRequest("inflight", list(PROMPT), max_tokens=10,
                               temperature=0.0, ignore_eos=True))
    got = {"inflight": [], "held": []}
    for _ in range(3):
        for ev in eng.step():
            if ev.token_id >= 0:
                got[ev.request_id].append(ev.token_id)
    assert eng.num_active == 1 and got["inflight"]
    wm.stage("v2", model_path=ckpts["v2"])
    out = wm.flip(mode="finish")
    assert out["state"] == "armed" and wm.admission_held
    eng.add_request(GenRequest("held", list(PROMPT), max_tokens=10,
                               temperature=0.0, ignore_eos=True))
    for _ in range(3):
        for ev in eng.step():
            if ev.token_id >= 0:
                got[ev.request_id].append(ev.token_id)
    assert not got["held"], "admissions must hold while the flip is armed"
    while eng.has_work:
        for ev in eng.step():
            if ev.token_id >= 0:
                got[ev.request_id].append(ev.token_id)
    assert got["inflight"] == refs["v1"]
    assert wm.version == "v2" and not wm.admission_held
    assert got["held"] == refs["v2"]
    evs = [e for r in eng.flight.records() for e in r.get("events", ())]
    assert any(e.get("ev") == "rollout_flip_armed" for e in evs)
    assert any(e.get("ev") == "rollout_flip" and e.get("version") == "v2"
               for e in evs)


def test_resurrection_zeroes_the_pools_in_their_storage(ckpts, refs):
    """Resurrection keeps every device buffer where it was (the captured
    graphs' addresses): the pools and batch buffers are zeroed in place,
    the weights restaged into their own storage, and the engine serves
    the same tokens."""
    eng = port_engine(ckpts["v1"])
    greedy(eng, GenRequest, "z0")
    pools = (eng.k_pages.data_ptr(), eng.v_pages.data_ptr())
    counts = eng.batch.token_counts.data_ptr()
    addr = _addresses(eng)
    assert eng.k_pages.abs().sum() > 0
    eng.resurrect()
    assert (eng.k_pages.data_ptr(), eng.v_pages.data_ptr()) == pools
    assert eng.batch.token_counts.data_ptr() == counts
    assert _addresses(eng) == addr
    assert eng.k_pages.abs().sum() == 0 and eng.v_pages.abs().sum() == 0
    assert int(eng.batch.token_counts.sum()) == 0
    assert eng.allocator.free_pages == BASE["num_pages"] - 1
    assert greedy(eng, GenRequest, "z1") == refs["v1"]


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read().decode()


def test_rollout_endpoint_gauges_and_memory_partition(ckpts):
    """Mirrors the JAX worker's drill on the port's worker."""
    eng = port_engine(ckpts["v1"])
    ctx = api.ServingContext(eng, "tiny-debug")
    srv = api.make_server(ctx, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    ro = url + "/internal/rollout"
    try:
        code, st = _post(ro, {"action": "status"})
        assert code == 200 and st["version"] == BASE_VERSION
        assert st["staged"] is None
        page = _get(url + "/metrics")
        assert 'dynamo_engine_weight_version{version="v0"} 1' in page
        assert "dynamo_memory_staged_weights_bytes" in page
        code, out = _post(ro, {"action": "stage", "version": "v2",
                               "model_path": ckpts["v2"]})
        assert code == 200 and out["bytes"] > 0
        page = _get(url + "/metrics")
        assert ('dynamo_memory_staged_weights_bytes{buffer="staged"} '
                f'{float(out["bytes"])}') in page
        snap = ctx.memory_bridge.accountant.snapshot()
        dev = [ln for ln in page.splitlines()
               if ln.startswith("dynamo_memory_kv_pool_bytes{")
               and 'tier="device"' in ln]
        assert sum(float(ln.rsplit(" ", 1)[1]) for ln in dev) \
            == snap["pool"]["total_bytes"]
        assert snap["weights"]["staged_version"] == "v2"
        code, out = _post(ro, {"action": "flip"})
        assert out["state"] == "live" and out["version"] == "v2"
        page = _get(url + "/metrics")
        assert 'dynamo_engine_weight_version{version="v2"} 1' in page
        assert 'version="v0"' not in page
        assert 'dynamo_memory_staged_weights_bytes{buffer="previous"}' \
            in page
        code, out = _post(ro, {"action": "stage_flip", "version": "v2"})
        assert out["state"] == "live" and out.get("already")
        stats = json.loads(_get(url + "/worker/stats"))
        assert stats["weights"]["version"] == "v2"
        assert stats["weights"]["previous"] == BASE_VERSION
        assert _post(ro, {"action": "commit"})[1]["dropped"] == BASE_VERSION
        os.environ[HEADROOM_ENV] = "10"
        try:
            assert _post(ro, {"action": "stage", "version": "v3",
                              "seed": 7})[0] == 503
        finally:
            del os.environ[HEADROOM_ENV]
        assert json.loads(
            _get(url + "/worker/stats"))["weights"]["version"] == "v2"
        _post(ro, {"action": "stage", "version": "v3",
                   "model_path": ckpts["v1"]})
        code, out = _post(ro, {"action": "rollback"})
        assert out["state"] == "rolled_back" and out["version"] == "v2"
        assert out["rolled_back"] is None
        assert _post(ro, {"action": "warp"})[0] == 400
    finally:
        srv.shutdown()
        ctx.close()


def test_weight_manager_surface_is_the_jax_ones():
    """The knobs and the stats keys the operator and controller read."""
    from dynamo_tpu_torch.elasticity import weights as tweights

    assert tweights.HEADROOM_ENV == jweights.HEADROOM_ENV
    assert tweights.MARGIN_ENV == jweights.MARGIN_ENV
    assert tweights.BASE_VERSION == jweights.BASE_VERSION
    jst = jweights.WeightManager(None).stats()
    tst = tweights.WeightManager(None).stats()
    assert set(jst) <= set(tst)
    assert {k: tst[k] for k in jst} == jst
