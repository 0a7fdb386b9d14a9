"""The port's TCP planes against the JAX package's, on the CPU.

- The transport: each package's Listener (native or Python end) takes the
  other package's connect (native or Python), and the framing carries the
  same bytes.
- The dcn KV wire: the JAX `fetch_kv` pulls from the port's `KVSource` and
  the port's `fetch_kv` from the JAX one, for float32, bfloat16 and int8
  pages (sources over a stub engine holding the arrays), and between real
  tiny-debug prefill engines; both get arrays equal to the source's export
  byte for byte, and the source releases its parked pages on the ack.
- The KVBM peer wire: `fetch_host_blocks` both ways, over stub host tiers
  of the three dtypes and over a port engine's real host tier.
- The device plane's stage ledger (`DeviceKVSource`) on the CPU, with the
  export given by the test: duplicate stages, the TTL sweep to leaked, the
  resurrecting re-stage, the cap, a fresh nonce per stage and the release.
"""

import threading
import time

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.engine import Engine as JEngine
from dynamo_tpu.engine.request import GenRequest as JGenRequest
from dynamo_tpu.transfer import kv_transfer as jkv
from dynamo_tpu.transfer import transport as jtransport
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import Engine
from dynamo_tpu_torch.engine.request import GenRequest
from dynamo_tpu_torch.transfer import kv_transfer as tkv
from dynamo_tpu_torch.transfer import transport as ttransport

KW = dict(model="tiny-debug", page_size=4, num_pages=64, max_num_seqs=4,
          max_seq_len=64)
SHAPE = (2, 3, 4, 64)  # [L, n_pages, page_size, lanes]
DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16),
          "int8": (np.int8, torch.int8)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _arrays(dtype: str, seed: int, shape=SHAPE):
    """(numpy array, torch tensor) with the same bytes."""
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        a = rng.integers(-128, 128, size=shape).astype(np.int8)
    else:
        a = rng.normal(size=shape).astype(DTYPES[dtype][0])
    t = torch.frombuffer(bytearray(a.tobytes()),
                         dtype=DTYPES[dtype][1]).reshape(shape)
    return a, t


def _bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


class StubEngine:
    """What a KVSource reads: one parked request's pages."""

    def __init__(self, k, v, n_tokens=10):
        self.kv = {"r1": (k, v, n_tokens)}
        self.released = []

    def export_kv(self, rid):
        return self.kv[rid]

    def release_parked(self, rid):
        self.released.append(rid)

    def expire_parked(self, ttl_s):
        return 0


def _wait(pred, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline and not pred():
        time.sleep(0.01)
    assert pred()


# ------------------------------------------------------------ transport --

@pytest.mark.parametrize("listen_native", [True, False])
@pytest.mark.parametrize("connect_native", [True, False])
@pytest.mark.parametrize("server_pkg", ["jax", "port"])
def test_transport_interoperates(server_pkg, listen_native, connect_native):
    listen_mod, connect_mod = ((jtransport, ttransport)
                               if server_pkg == "jax"
                               else (ttransport, jtransport))
    lst = listen_mod.Listener(0, prefer_native=listen_native)
    got = {}

    def server():
        conn, key = lst.accept(timeout_ms=5000)
        got["key"] = key
        got["msg"] = conn.recv_msg()
        conn.send_msg(b"pong:" + got["msg"])
        conn.close()

    t = threading.Thread(target=server)
    t.start()
    conn = connect_mod.connect("127.0.0.1", lst.port, "req-xyz",
                               prefer_native=connect_native)
    payload = bytes(range(256)) * 4096  # 1 MiB
    conn.send_msg(payload)
    reply = conn.recv_msg()
    conn.close()
    t.join(timeout=10)
    lst.close()
    assert got == {"key": "req-xyz", "msg": payload}
    assert reply == b"pong:" + payload


# ---------------------------------------------------------- the dcn wire --

@pytest.mark.parametrize("dtype", list(DTYPES))
def test_jax_fetch_kv_pulls_from_port_source(dtype):
    (_, k), (_, v) = _arrays(dtype, 1), _arrays(dtype, 2)
    eng = StubEngine(k, v)
    src = tkv.KVSource(eng, port=0)
    try:
        jk, jv, n = jkv.fetch_kv("127.0.0.1", src.port, "r1")
        assert n == 10 and str(jk.dtype) == dtype
        assert jk.shape == SHAPE and jv.shape == SHAPE
        assert _bytes(jk) == _bytes(k) and _bytes(jv) == _bytes(v)
        _wait(lambda: eng.released == ["r1"])
        with pytest.raises(KeyError):
            jkv.fetch_kv("127.0.0.1", src.port, "no-such-request")
    finally:
        src.close()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_port_fetch_kv_pulls_from_jax_source(dtype):
    (k, _), (v, _) = _arrays(dtype, 3), _arrays(dtype, 4)
    eng = StubEngine(k, v)
    src = jkv.KVSource(eng, port=0)
    try:
        tk, tv, n = tkv.fetch_kv("127.0.0.1", src.port, "r1")
        assert n == 10 and tk.dtype == DTYPES[dtype][1]
        assert tuple(tk.shape) == SHAPE and tuple(tv.shape) == SHAPE
        assert _bytes(tk) == _bytes(k) and _bytes(tv) == _bytes(v)
        _wait(lambda: eng.released == ["r1"])
        with pytest.raises(KeyError):
            tkv.fetch_kv("127.0.0.1", src.port, "no-such-request")
    finally:
        src.close()


@pytest.fixture(scope="module")
def prefill_engines():
    """A JAX and a port prefill engine on the same tiny-debug weights."""
    import dataclasses

    from dynamo_tpu.models import llama as jllama
    from dynamo_tpu.models.config import PRESETS as JPRESETS

    cfg = dataclasses.replace(JPRESETS["tiny-debug"], dtype="float32")
    jparams = jllama.init_params(cfg, jax.random.PRNGKey(0))
    jeng = JEngine(JEngineConfig(**KW, disaggregation_mode="prefill"),
                   params=jparams)
    teng = Engine(EngineConfig(**KW, disaggregation_mode="prefill"),
                  params={k: np.asarray(v) for k, v in jparams.items()},
                  device="cpu")
    return jeng, teng


def test_engine_kv_crosses_packages(prefill_engines):
    """The same prompt parked by both engines: each package's fetch_kv
    pulls the other's pages byte for byte, which equal the puller's own
    export to 1e-5 (the two packages' float32 forwards, the pool
    tolerance of the engine parity tests), and release on the ack."""
    jeng, teng = prefill_engines
    prompt = [5, 3, 9, 2, 7, 1, 4, 8, 6, 2, 3]
    jfirst = jeng.prefill_only(JGenRequest("x", prompt, max_tokens=4,
                                           temperature=0.0))[0]
    tfirst = teng.prefill_only(GenRequest("x", prompt, max_tokens=4,
                                          temperature=0.0))[0]
    assert jfirst == tfirst
    jk_own, jv_own, _ = jeng.export_kv("x")
    tk_own, tv_own, _ = teng.export_kv("x")
    jsrc, tsrc = jkv.KVSource(jeng, port=0), tkv.KVSource(teng, port=0)
    free_j, free_t = jeng.allocator.free_pages, teng.allocator.free_pages
    try:
        tk, tv, tn = tkv.fetch_kv("127.0.0.1", jsrc.port, "x")
        jk, jv, jn = jkv.fetch_kv("127.0.0.1", tsrc.port, "x")
        assert tn == jn == len(prompt)
        assert _bytes(tk) == _bytes(jk_own) and _bytes(tv) == _bytes(jv_own)
        assert _bytes(jk) == _bytes(tk_own) and _bytes(jv) == _bytes(tv_own)
        np.testing.assert_allclose(jk, tk.numpy(), rtol=0, atol=1e-5)
        np.testing.assert_allclose(jv, tv.numpy(), rtol=0, atol=1e-5)
        _wait(lambda: jeng.allocator.free_pages == free_j + 3
              and teng.allocator.free_pages == free_t + 3)
    finally:
        jsrc.close()
        tsrc.close()


# ---------------------------------------------------- the KVBM peer wire --

class StubPool:
    def __init__(self, blocks):
        self.blocks = blocks

    def get(self, h):
        return self.blocks.get(h)


class StubKVBM:
    def __init__(self, blocks):
        self.pool = StubPool(blocks)


def _host_blocks(dtype, torch_side: bool):
    """Three host-layout blocks [L, page, lanes] by hash, and the hashes
    (the third one missing from the tier)."""
    hashes = [bytes([i]) * 32 for i in range(4)]
    blocks = {}
    for i, h in enumerate(hashes[:2]):
        (ka, kt), (va, vt) = (_arrays(dtype, 10 + i, (2, 4, 64)),
                              _arrays(dtype, 20 + i, (2, 4, 64)))
        blocks[h] = (kt, vt) if torch_side else (ka, va)
    # a block past the gap, which a consecutive run must not reach
    blocks[hashes[3]] = blocks[hashes[0]]
    return hashes, blocks


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("server_pkg", ["jax", "port"])
def test_host_blocks_cross_packages(server_pkg, dtype):
    port_server = server_pkg == "port"
    hashes, blocks = _host_blocks(dtype, torch_side=port_server)
    server = (tkv.HostTierSource if port_server else jkv.HostTierSource)(
        StubKVBM(blocks))
    fetch = jkv.fetch_host_blocks if port_server else tkv.fetch_host_blocks
    try:
        got = fetch("127.0.0.1", server.port, [h.hex() for h in hashes])
        assert len(got) == 2  # the run stops at the first miss
        for (k, v), h in zip(got, hashes):
            assert tuple(k.shape) == (2, 4, 64)
            assert _bytes(k) == _bytes(blocks[h][0])
            assert _bytes(v) == _bytes(blocks[h][1])
        assert fetch("127.0.0.1", server.port, ["ab" * 32]) == []
    finally:
        server.close()


def test_jax_peer_pulls_port_engine_host_tier():
    """A port engine demotes a prefix into its host tier; the JAX
    `fetch_host_blocks` reads those blocks off its HostTierSource with the
    bytes the port's own pool holds."""
    eng = Engine(EngineConfig(model="tiny-debug", page_size=4, num_pages=13,
                              max_num_seqs=2, max_seq_len=64,
                              prefill_chunk_tokens=8, kvbm_host_blocks=32,
                              kvbm_gate="always"), device="cpu")
    prefix = [(i * 7) % 290 + 1 for i in range(30)]
    other = [(i * 11) % 290 + 3 for i in range(30)]
    for rid, p in (("t1", prefix), ("fill", other)):
        eng.generate(GenRequest(rid, p, max_tokens=4, temperature=0.0,
                                ignore_eos=True))
    hashes = list(eng.kvbm.pool._entries)[:3]
    assert hashes, "nothing demoted"
    src = tkv.HostTierSource(eng.kvbm)
    try:
        got = jkv.fetch_host_blocks("127.0.0.1", src.port,
                                    [h.hex() for h in hashes])
        assert len(got) == len(hashes)
        for h, (k, v) in zip(hashes, got):
            kt, vt = eng.kvbm.pool.get(h)
            assert k.shape == tuple(kt.shape) and str(k.dtype) == "float32"
            assert _bytes(k) == _bytes(kt) and _bytes(v) == _bytes(vt)
    finally:
        src.close()


# ------------------------------------------------ the device stage ledger --

class LedgerEngine:
    """What a DeviceKVSource reads: device gathers of parked requests."""

    def __init__(self):
        self.device = torch.device("cpu")
        self.gathers = 0

    def export_kv_device(self, rid):
        if not rid.startswith("r"):
            raise KeyError(rid)
        self.gathers += 1
        return torch.zeros(2, 1, 4, 8), torch.ones(2, 1, 4, 8), 3


def _fake_export(t):
    return {"nbytes": int(t.nbytes), "id": id(t)}


def test_device_stage_ledger():
    eng = LedgerEngine()
    src = tkv.DeviceKVSource(eng, staged_ttl_s=0.2, max_staged=2,
                             export=_fake_export, uuid="GPU-test")
    assert src.eligible and src.eligible_for("GPU-test")
    assert not src.eligible_for("GPU-other") and not src.eligible_for(None)
    a = src.stage("r1")
    assert a["kv_shape"] == [2, 1, 4, 8] and a["kv_dtype"] == "float32"
    assert a["device_uuid"] == "GPU-test" and a["n_tokens"] == 3
    # a duplicate stage returns the original coordinates, no second gather
    assert src.stage("r1") == a and eng.gathers == 1
    b = src.stage("r2")
    assert b["transfer_uuid"] != a["transfer_uuid"]  # a fresh nonce
    assert src.counts() == (2, 0)
    # the cap counts live stages
    assert src.stage("r3") is None and eng.gathers == 2
    time.sleep(0.3)
    # the TTL sweep demotes both to leaked; they keep their cap slots
    assert src.counts() == (0, 2)
    assert src.stage("r3") is None
    # a late re-stage resurrects the original coordinates
    assert src.stage("r1") == a and src.counts() == (1, 1)
    src.mark_released("r1")
    src.mark_released("r2")
    assert src.counts() == (0, 0)
    with pytest.raises(KeyError):
        src.stage("unknown")
    # a re-stage after the release gathers anew, under a new nonce
    c = src.stage("r1")
    assert c["transfer_uuid"] != a["transfer_uuid"] and eng.gathers == 3


def test_device_stage_refused_without_a_card():
    eng = LedgerEngine()
    src = tkv.DeviceKVSource(eng, export=_fake_export)
    assert src.uuid is None and not src.eligible
    assert src.stage("r1") is None and eng.gathers == 0


# ------------------------------------------------ the roles' handshakes --

def test_import_refuses_a_mismatched_pool():
    """KV of one pool kind offered to a decode worker of another fails the
    handshake with the JAX engine's message, before any page moves."""
    pre = Engine(EngineConfig(**KW, disaggregation_mode="prefill"),
                 device="cpu")
    dec = Engine(EngineConfig(**KW, disaggregation_mode="decode",
                              kv_cache_dtype="int8"), params=pre.params,
                 device="cpu")
    req = GenRequest("m", [1, 2, 3, 4, 5], max_tokens=4)
    first = pre.prefill_only(req)[0]
    k, v, _ = pre.export_kv("m")
    free = dec.allocator.free_pages
    with pytest.raises(ValueError, match="same --kv-cache-dtype"):
        dec.import_kv(req, first, k, v)
    assert dec.allocator.free_pages == free and not dec.seqs


def test_worker_cli_prefill_role_serves_a_decode_worker():
    """The worker CLI's prefill role in its own process (`python -m
    dynamo_tpu_torch.jetstream --device cpu --disaggregation-mode
    prefill`) and a decode worker here, given it by `prefill_urls`: the
    decode worker's ici backend finds no device plane on the CPU and falls
    back to dcn across the processes; its tokens equal an aggregated
    engine's on the same seeded weights."""
    import json
    import os
    import subprocess
    import sys
    import urllib.request

    from dynamo_tpu_torch.serving.api import ServingContext, make_server

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sock_probe = ttransport.Listener(0, prefer_native=False)
    port = sock_probe.port
    sock_probe.close()
    cfg = ["--model", "tiny-debug", "--page-size", "4", "--num-pages", "64",
           "--max-num-seqs", "4", "--max-seq-len", "64", "--seed", "7"]
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.jetstream", "--device",
         "cpu", "--disaggregation-mode", "prefill",
         "--disaggregation-bootstrap-port", "0", "--host", "127.0.0.1",
         "--port", str(port), *cfg], cwd=root,
        env=dict(os.environ, PYTHONPATH=root), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    url = f"http://127.0.0.1:{port}"
    kw = dict(model="tiny-debug", page_size=4, num_pages=64, max_num_seqs=4,
              max_seq_len=64, seed=7)
    dec = Engine(EngineConfig(**kw, disaggregation_mode="decode"),
                 device="cpu")
    ctx = ServingContext(dec, "tiny-debug", prefill_urls=[url])
    srv = make_server(ctx, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            assert proc.poll() is None, proc.stdout.read().decode()[-3000:]
            try:
                with urllib.request.urlopen(url + "/health", timeout=2):
                    break
            except OSError:
                time.sleep(0.2)
        body = {"model": "tiny-debug", "max_tokens": 6, "temperature": 0,
                "ignore_eos": True,
                "messages": [{"role": "user", "content": "hello"}]}
        with urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{srv.server_address[1]}"
                "/v1/chat/completions", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"}),
                timeout=120) as r:
            out = json.loads(r.read())
        assert out["usage"]["completion_tokens"] == 6
        assert ctx.disagg_client.plane_counts == {
            "ici_inproc": 0, "ici_device": 0, "dcn": 1}
        with urllib.request.urlopen(url + "/worker/stats", timeout=10) as r:
            st = json.loads(r.read())
        assert st["disaggregation_mode"] == "prefill"
        assert st["staged_kv"] == {"live": 0, "leaked": 0}
        _wait(lambda: dec.num_active == 0)
        agg = Engine(EngineConfig(**kw), params=dec.params, device="cpu")
        tok = ctx.tokenizer
        ids = tok.encode(tok.apply_chat_template(body["messages"]))
        ref = agg.generate(GenRequest("ref", ids, max_tokens=6,
                                      temperature=0.0, ignore_eos=True))
        assert out["choices"][0]["message"]["content"] == tok.decode(ref)
    finally:
        srv.shutdown()
        ctx.close()
        proc.terminate()
        proc.wait(timeout=30)
