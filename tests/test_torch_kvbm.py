"""The KVBM host and disk tiers behind the prefix cache, and the KV event
plane: the port against the JAX package, on the CPU.

- The host pool and the disk tier (the cases of the JAX package's
  `tests/test_kvbm.py`): bytes round-trip exactly for f32, int8 and bf16,
  LRU order, pinning and the bounds give the JAX pool's answers.
- The gate: its modes, the auto gate's directions (its numbers are the
  card's in the port and a TPU's in the JAX package by design, so only the
  directions are compared), and the two roofline sides equal to the JAX
  functions' on the same rates.
- The engine: turn 1 caches a prompt, a second prompt evicts (demotes) its
  pages, turn 2 onboards them. Both engines run tiny-debug on the JAX
  params carried across (`models/loader.from_jax_params`), float32 or int8
  pools, or tiny-mla-debug's latent rows, with `kvbm_gate="always"`:
  greedy tokens are equal (exactly, no tolerance), and so are
  `kvbm.stats()` (less the gate's numbers) and the sequence of (kind,
  hashes, tier) events. The gate refusing, a pool too small, the disk
  tier, a drained worker's `drain_demote`, a block corrupted under
  `DYNAMO_TPU_INTEGRITY=full` and a resurrection give the JAX engine's
  tokens and counters too.
- A lookup whose onboard has to make device room never evicts the pages
  it already matched (a case the JAX package gets wrong: no parity), and
  a block an onboard claimed keeps its bytes when its host slot goes.
- The publisher turns engine events into the router's text-hash space as
  the JAX publisher does.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.engine import Engine as JEngine
from dynamo_tpu.engine.request import GenRequest as JGenRequest
from dynamo_tpu.kvbm import events as jevents
from dynamo_tpu.kvbm.cost_model import OnboardGate as JOnboardGate
from dynamo_tpu.kvbm.host_pool import DiskBlockTier as JDiskBlockTier
from dynamo_tpu.kvbm.host_pool import HostBlockPool as JHostBlockPool
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import PRESETS as JPRESETS
from dynamo_tpu.profiler import roofline as jroofline
from dynamo_tpu.serving import api as japi
from dynamo_tpu.serving.router import text_block_chain as jtext_chain
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import Engine
from dynamo_tpu_torch.engine.kv_cache import PageAllocator, PrefixCache
from dynamo_tpu_torch.engine.request import GenRequest
from dynamo_tpu_torch.kvbm import events
from dynamo_tpu_torch.kvbm.cost_model import OnboardGate
from dynamo_tpu_torch.kvbm.host_pool import DiskBlockTier, HostBlockPool
from dynamo_tpu_torch.models.config import PRESETS
from dynamo_tpu_torch.profiler import roofline
from dynamo_tpu_torch.serving import api

BLOCK = (2, 4, 8)  # [layers, page_size, lanes]
PREFIX = [(i * 7) % 290 + 1 for i in range(30)]
OTHER = [(i * 11) % 290 + 3 for i in range(30)]
# the JAX package's KVBM engine test config, the gate forced open in both
BASE = dict(page_size=4, num_pages=13, max_num_seqs=2, max_seq_len=64,
            prefill_chunk_tokens=8, kvbm_host_blocks=32,
            kvbm_gate="always")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module: the parallel test workers share
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jcfg(model):
    return dataclasses.replace(JPRESETS[model], dtype="float32")


@pytest.fixture(scope="module")
def params():
    """JAX params of tiny-debug and tiny-mla-debug, float32."""
    return {m: jllama.init_params(_jcfg(m), jax.random.PRNGKey(0))
            for m in ("tiny-debug", "tiny-mla-debug")}


def _blk(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind in "iu":
        return rng.integers(-100, 100, size=BLOCK).astype(dtype)
    return rng.normal(size=BLOCK).astype(dtype)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------- host pool --

@pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16"])
def test_host_pool_roundtrip_bit_exact(dtype):
    tdt = getattr(torch, dtype)
    pool = HostBlockPool(4, BLOCK, tdt)
    k = _t(_blk(0)).to(tdt)
    v = _t(_blk(1)).to(tdt)
    ok, removed = pool.put(b"h0", k, v)
    assert ok and not removed
    k2, v2 = pool.get(b"h0")
    assert torch.equal(k2.view(torch.uint8), k.view(torch.uint8))
    assert torch.equal(v2.view(torch.uint8), v.view(torch.uint8))
    assert pool.get(b"nope") is None
    assert pool.stats()["hits"] == 1 and pool.stats()["misses"] == 1
    assert pool.block_nbytes == 2 * k.numel() * tdt.itemsize
    assert not pool.pinned  # a CPU engine's arenas are pageable


def _pool_script(pool, put, pin, unpin, contains):
    """The JAX pool test's LRU and pinning steps: every answer in order."""
    out = [put(pool, b"a", 0), put(pool, b"b", 2), pin(pool, b"a"),
           put(pool, b"c", 4), contains(pool, b"a"), contains(pool, b"c")]
    unpin(pool, b"a")
    out += [put(pool, b"d", 6), contains(pool, b"c"), contains(pool, b"d"),
            pool.stats()]
    one = type(pool)(1, BLOCK, pool.dtype)
    put(one, b"a", 0)
    pin(one, b"a")
    out += [put(one, b"b", 2), one.stats()["rejected_full"]]
    return out


def test_host_pool_lru_pinning_and_bounds_match_jax():
    got = _pool_script(
        HostBlockPool(2, BLOCK, torch.float32),
        lambda p, h, s: p.put(h, _t(_blk(s)), _t(_blk(s + 1))),
        lambda p, h: p.pin(h), lambda p, h: p.unpin(h),
        lambda p, h: p.contains(h))
    want = _pool_script(
        JHostBlockPool(2, BLOCK, np.float32),
        lambda p, h, s: p.put(h, _blk(s), _blk(s + 1)),
        lambda p, h: p.pin(h), lambda p, h: p.unpin(h),
        lambda p, h: p.contains(h))
    assert got == want
    # "a" pinned, so "b" is the LRU victim; once unpinned "a" goes next
    assert got[3] == (True, [b"b"]) and got[6] == (True, [b"a"])
    assert got[-2:] == [(False, []), 1]  # every entry pinned: rejected


def test_claimed_block_keeps_its_bytes_when_its_slot_goes():
    """An onboard claims the blocks it walked; one whose slot the LRU
    reclaims before the copy (a later promotion, a room-making demote) has
    its bytes kept, bit for bit, and the LRU order is the unclaimed one."""
    pool = HostBlockPool(2, BLOCK, torch.float32)
    for h, seed in ((b"a", 0), (b"b", 2)):
        pool.put(h, _t(_blk(seed)), _t(_blk(seed + 1)))
    pool.claim(b"a")
    pool.claim(b"b")
    assert pool.claimed(b"a") is None  # still in its slot
    assert pool.put(b"c", _t(_blk(4)), _t(_blk(5))) == (True, [b"a"])
    k, v = pool.claimed(b"a")
    assert torch.equal(k, _t(_blk(0))) and torch.equal(v, _t(_blk(1)))
    assert pool.claimed(b"b") is None
    pool.release_claims()
    assert pool.claimed(b"a") is None
    assert pool.put(b"d", _t(_blk(6)), _t(_blk(7))) == (True, [b"b"])


@pytest.mark.parametrize("case", ["spill_and_promote", "bounded"])
def test_disk_tier_matches_jax(tmp_path, case):
    cap = 2 if case == "spill_and_promote" else 1

    def run(pool_cls, disk_cls, root, mk):
        disk = disk_cls(str(root), capacity_blocks=cap)
        pool = pool_cls(1, BLOCK, mk(0).dtype, disk=disk)
        out = [pool.put(b"a", mk(0), mk(1)), pool.put(b"b", mk(2), mk(3))]
        if case == "bounded":
            out.append(pool.put(b"c", mk(4), mk(5)))  # a dropped from disk
            return out + [len(disk)], None
        out.append(disk.contains(b"a"))
        k2, v2 = pool.get(b"a")  # a disk hit promotes back to RAM
        return out + [disk.hits, pool.stats()], (k2, v2)

    got, kv = run(HostBlockPool, DiskBlockTier, tmp_path / "port",
                  lambda s: _t(_blk(s)))
    want, jkv = run(JHostBlockPool, JDiskBlockTier, tmp_path / "jax",
                    lambda s: _blk(s))
    assert got == want
    if kv is not None:
        assert kv[0].numpy().tobytes() == jkv[0].tobytes() \
            == _blk(0).tobytes()
        assert kv[1].numpy().tobytes() == _blk(1).tobytes()
    else:
        assert got[2] == (True, [b"a"]) and got[3] == 1


# --------------------------------------------------------------- cost gate --

def test_gate_modes():
    assert OnboardGate(mode="always").should_onboard(1)
    g = OnboardGate(mode="never")
    assert not g.should_onboard(1) and g.skipped == 1
    with pytest.raises(ValueError):
        OnboardGate(mode="sometimes")


def test_gate_auto_directions():
    """The JAX test's directions: a realistic block on a fast link
    restores, a crawling link recomputes."""
    cfg = PRESETS["llama-3.2-1b-instruct"]
    fast = OnboardGate(mode="auto", model_cfg=cfg, block_nbytes=1 << 20,
                       page_size=16, chip_flops=2e14, bytes_per_s=8e9)
    assert fast.should_onboard(8)
    slow = OnboardGate(mode="auto", model_cfg=cfg, block_nbytes=1 << 20,
                       page_size=16, chip_flops=2e14, bytes_per_s=1e3)
    assert not slow.should_onboard(8)
    assert slow.explain(8)["restore_s"] > fast.explain(8)["restore_s"]
    # with its defaults (the card's numbers) the 8B's 2 MiB blocks restore
    big = PRESETS["llama-3.1-8b-instruct"]
    card = OnboardGate(mode="auto", model_cfg=big, block_nbytes=2 << 20,
                       page_size=16)
    assert card.chip_flops == 989e12
    assert all(card.should_onboard(n) for n in (1, 16, 64))
    # and the JAX gate, on its own defaults, points the same way
    jgate = JOnboardGate(mode="auto", model_cfg=JPRESETS[big.name],
                         block_nbytes=2 << 20, page_size=16)
    assert all(jgate.should_onboard(n) for n in (1, 16, 64))


@pytest.mark.parametrize("n_tokens,n_chunks", [(16, 1), (1024, 4)])
def test_roofline_sides_match_jax(n_tokens, n_chunks):
    name = "llama-3.1-8b-instruct"
    assert roofline.kvbm_restore_seconds(3e6, 2e10, overhead_s=1e-4) \
        == jroofline.kvbm_restore_seconds(3e6, 2e10, overhead_s=1e-4)
    got = roofline.kvbm_recompute_seconds(
        PRESETS[name], n_tokens, 989e12, n_dispatches=n_chunks, mfu=0.4,
        dispatch_s=0.002)
    want = jroofline.kvbm_recompute_seconds(
        JPRESETS[name], n_tokens, 989e12, n_dispatches=n_chunks, mfu=0.4)
    want += n_chunks * (0.002 - jroofline.DISPATCH_OVERHEAD_S)
    assert got == pytest.approx(want, rel=1e-12)


# ---------------------------------------------------- engine demote/onboard --

MODES = {
    "f32": ("tiny-debug", {}),
    "int8": ("tiny-debug", dict(kv_cache_dtype="int8")),
    "mla": ("tiny-mla-debug", {}),
}


def _engines(params, model="tiny-debug", **kw):
    cfg = dict(BASE, model=model, **kw)
    jeng = JEngine(JEngineConfig(**cfg), model_cfg=_jcfg(model),
                   params=params[model])
    eng = Engine(EngineConfig(**cfg),
                 model_cfg=dataclasses.replace(PRESETS[model],
                                               dtype="float32"),
                 params={k: np.asarray(v)
                         for k, v in params[model].items()},
                 device="cpu")
    return jeng, eng


def _sink(eng):
    """Record the engine's KV events as (kind, [hash hex], tier)."""
    got = []
    eng.set_kv_event_sink(
        lambda kind, hs, tier: got.append((kind, [h.hex() for h in hs],
                                           tier)))
    return got


def _turns(eng, make_req, max_tokens=4):
    """Turn 1 caches PREFIX, an unrelated prompt evicts (demotes) it, turn
    2 re-uses PREFIX: (turn 1 tokens, turn 2 tokens)."""
    def greedy(rid, prompt):
        return eng.generate(make_req(rid, list(prompt),
                                     max_tokens=max_tokens, temperature=0.0,
                                     ignore_eos=True))
    out1 = greedy("t1", PREFIX)
    greedy("fill", OTHER)
    return out1, greedy("t2", PREFIX)


def _counters(kvbm):
    st = kvbm.stats()
    st.pop("gate")  # the card's numbers against a TPU's, by design
    return st


@pytest.mark.parametrize("mode", sorted(MODES))
def test_demote_onboard_matches_jax(params, mode):
    model, kw = MODES[mode]
    jeng, eng = _engines(params, model, **kw)
    jev, ev = _sink(jeng), _sink(eng)
    want = _turns(jeng, JGenRequest)
    got = _turns(eng, GenRequest)
    assert got == want
    assert got[1] == got[0]  # the onboarded pages decode as cached ones
    st = _counters(eng.kvbm)
    assert st == _counters(jeng.kvbm)
    assert st["demoted_blocks_total"] > 0 and st["host_hits_total"] >= 1
    assert st["onboarded_blocks_total"] > 0
    assert ev == jev
    assert {e[0] for e in ev} >= {"stored", "demoted"}
    # the int8 and latent rows moved whole: the pools' row widths
    assert eng.kvbm.block_shape == (eng.kv_spec.num_layers, 4,
                                    eng.kv_spec.lane_width)


def test_bf16_pools_round_trip_exactly(params):
    """bf16 pools: turn 2 (onboarded) equals turn 1 and an engine that
    never evicted. The counters and events, which depend on the schedule
    and the prompts' hashes only, are the JAX engine's (on f32 pools: the
    JAX engine's bf16 forward does not run on the CPU), with blocks of half
    the bytes."""
    cfg = dict(BASE, model="tiny-debug", dtype="bfloat16")
    eng = Engine(EngineConfig(**cfg),
                 params={k: np.asarray(v)
                         for k, v in params["tiny-debug"].items()},
                 device="cpu")
    assert eng.k_pages.dtype == torch.bfloat16
    assert eng.kvbm.pool.k_arena.dtype == torch.bfloat16
    ev = _sink(eng)
    got = _turns(eng, GenRequest)
    assert got[1] == got[0]
    big = Engine(EngineConfig(**dict(cfg, num_pages=64)),
                 params=eng.model, device="cpu")
    ref = big.generate(GenRequest("r", PREFIX, max_tokens=4,
                                  temperature=0.0, ignore_eos=True))
    assert got[1] == ref
    jeng, _ = _engines(params)
    jev = _sink(jeng)
    _turns(jeng, JGenRequest)
    st, want = _counters(eng.kvbm), _counters(jeng.kvbm)
    assert 2 * st["host_pool"].pop("block_nbytes") \
        == want["host_pool"].pop("block_nbytes")
    assert st == want
    assert ev == jev


@pytest.mark.parametrize("case", ["gate_never", "pool_full", "disk"])
def test_fallbacks_match_jax(params, tmp_path, case):
    kw = {"gate_never": dict(kvbm_gate="never"),
          "pool_full": dict(kvbm_host_blocks=2),
          "disk": dict(kvbm_host_blocks=2, kvbm_disk_blocks=64)}[case]
    if case == "disk":
        jeng, _ = _engines(params, kvbm_disk_dir=str(tmp_path / "jax"),
                           **kw)
        _, eng = _engines(params, kvbm_disk_dir=str(tmp_path / "port"),
                          **kw)
    else:
        jeng, eng = _engines(params, **kw)
    jev, ev = _sink(jeng), _sink(eng)
    want = _turns(jeng, JGenRequest)
    got = _turns(eng, GenRequest)
    assert got == want and got[1] == got[0]
    st = _counters(eng.kvbm)
    assert st == _counters(jeng.kvbm)
    assert ev == jev
    if case == "gate_never":
        assert st["onboarded_blocks_total"] == 0
        assert st["gate_recompute_total"] >= 1
    elif case == "pool_full":
        assert st["demoted_blocks_total"] + st["removed_blocks_total"] >= 4
    else:
        assert st["host_pool"]["disk"]["used_blocks"] > 0


def test_evict_never_demotes_live_pages():
    """A page a live sequence co-owns is no victim; once sole-owned it
    goes to the KVBM (the JAX test's case)."""
    alloc = PageAllocator(32)
    pc = PrefixCache(alloc, 4)

    class Sink:
        def __init__(self):
            self.calls = []

        def demote(self, victims):
            self.calls.append(list(victims))
            return 0

    pc.kvbm = Sink()
    toks = list(range(1, 18))
    pages = alloc.alloc(5)
    pc.insert(toks, pages)
    alloc.free(pages)
    got, _ = pc.lookup(toks[:17])
    assert pc.evict(4) == 0 and pc.kvbm.calls in ([], [[]])
    alloc.free(got)
    assert pc.evict(4) == 4
    assert len(pc.kvbm.calls[-1]) == 4


def test_lookup_keeps_the_pages_it_matched_when_onboarding(params):
    """A shared head on the device, its tail in the host tier, and a pool
    with no free page (running sequences hold the rest): the onboard of
    the tail must not make room by evicting the head pages the same
    lookup already matched. The pages come back distinct, and once the
    pool frees up the request's greedy tokens are a cache-off engine's."""
    _, eng = _engines(params, num_pages=20)
    pc, alloc = eng.prefix_cache, eng.allocator
    head, tail = PREFIX[:8], PREFIX[8:16]
    prompt = head + tail + [5]
    eng.generate(GenRequest("warm", prompt, max_tokens=2, ignore_eos=True))
    assert pc.stats()["entries"] == 4
    # a second conversation on the same head bumps it: the tail is now
    # the oldest, and demotes while the head stays on the device
    held, _ = pc.lookup(head + [7])
    assert pc.evict(2) == 2 and len(eng.kvbm.pool) == 2
    alloc.free(held)
    assert pc.evictable() == 2
    hold = alloc.alloc(alloc.free_pages)
    pages, n = pc.lookup(prompt)
    assert len(set(pages)) == len(pages) and n == len(pages) * 4
    assert pages == held  # the tail found no room: the head alone
    assert all(alloc.refs(p) == 2 for p in pages)
    alloc.free(pages)
    # through the engine: admitted with the pool still full, then freed
    eng.add_request(GenRequest("r", prompt, max_tokens=6, temperature=0.0,
                               ignore_eos=True))
    eng.step()
    alloc.free(hold)
    toks = []
    while eng.has_work:
        toks += [ev.token_id for ev in eng.step() if ev.token_id >= 0]
    ref = Engine(EngineConfig(**dict(BASE, model="tiny-debug",
                                     enable_prefix_caching=False)),
                 model_cfg=eng.model_cfg, params=eng.model, device="cpu")
    assert toks == ref.generate(GenRequest("r", prompt, max_tokens=6,
                                           temperature=0.0,
                                           ignore_eos=True))
    assert eng.kvbm.stats()["onboarded_blocks_total"] == 2


@pytest.mark.parametrize("where", ["demote", "onboard"])
def test_device_errors_propagate(params, where):
    """A failure of the device work (a CUDA error on the card) in demote
    or onboard is not swallowed, as the JAX manager swallows every
    exception: it propagates out of step() to the watchdog's fatal-step
    path. Only host-side refusals (the gate, a full pool) fall back."""
    _, eng = _engines(params)
    eng.generate(GenRequest("t1", PREFIX, max_tokens=4, ignore_eos=True))

    def fail(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access")

    if where == "demote":
        eng.kvbm._gather = fail
        prompt = OTHER
    else:
        eng.generate(GenRequest("fill", OTHER, max_tokens=4,
                                ignore_eos=True))
        eng.kvbm._upload = fail
        prompt = PREFIX
    eng.add_request(GenRequest("t2", prompt, max_tokens=4, ignore_eos=True))
    with pytest.raises(RuntimeError, match="illegal memory access"):
        while eng.has_work:
            eng.step()


def test_drain_demote_counts_as_the_jax_worker(params):
    """A draining worker spills its prefix cache into the host tier: the
    same count through both packages' ServingContext."""
    out = {}
    jeng, eng = _engines(params, num_pages=64)
    for pkg, ctx_cls, make_req, e in (
            ("jax", japi.ServingContext, JGenRequest, jeng),
            ("port", api.ServingContext, GenRequest, eng)):
        ctx = ctx_cls(e, "tiny-debug")
        try:
            e.generate(make_req("warm", list(range(1, 20)), max_tokens=2,
                                temperature=0.0, ignore_eos=True))
            evictable = e.prefix_cache.evictable()
            out[pkg] = (evictable, ctx.drain_demote(),
                        e.kvbm.pool.stats()["used_blocks"])
            assert ctx.drain(drain_s=1.0, handoff_grace_s=0.1)
        finally:
            ctx.close()
    assert out["port"] == out["jax"]
    assert out["port"][1] == out["port"][0] > 0


def test_corrupted_block_is_dropped_under_full(params, monkeypatch):
    """DYNAMO_TPU_INTEGRITY=full: one flipped byte in a demoted block's
    host copy drops that block (a `kv_checksum` fault, the prefix
    recomputes from it on) and the tokens stay those of a clean run, as in
    the JAX engine."""
    monkeypatch.setenv("DYNAMO_TPU_INTEGRITY", "full")
    jeng, eng = _engines(params)

    def run(e, make_req, flip):
        def greedy(rid, prompt):
            return e.generate(make_req(rid, list(prompt), max_tokens=4,
                                       temperature=0.0, ignore_eos=True))
        out1 = greedy("t1", PREFIX)
        greedy("fill", OTHER)
        flip(e.kvbm)
        return out1, greedy("t2", PREFIX), e.watchdog.summary()[
            "integrity_faults_total"]

    def jflip(kvbm):
        h = next(iter(kvbm.pool._entries))
        kvbm.pool._arena[kvbm.pool._entries[h], 0].view(np.uint8).flat[0] \
            ^= 0xFF

    def flip(kvbm):
        h = next(iter(kvbm.pool._entries))
        slot = kvbm.pool._entries[h]
        kvbm.pool.settle(slot)
        kvbm.pool.k_arena[slot].view(torch.uint8).view(-1)[0] ^= 0xFF

    want = run(jeng, JGenRequest, jflip)
    got = run(eng, GenRequest, flip)
    assert got == want
    assert got[1] == got[0] and got[2] == {"kv_checksum": 1}
    st = _counters(eng.kvbm)
    assert st == _counters(jeng.kvbm) and st["removed_blocks_total"] >= 1


def test_resurrection_keeps_the_host_tier(params):
    """A resurrection zeroes the pools and empties the prefix cache; the
    host tier survives and the next turn onboards into the zeroed pools,
    giving the JAX engine's tokens and counters."""
    jeng, eng = _engines(params)
    jev, ev = _sink(jeng), _sink(eng)
    out = {}
    for pkg, e, make_req in (("jax", jeng, JGenRequest),
                             ("port", eng, GenRequest)):
        first = _turns(e, make_req)
        e.resurrect()
        assert e.prefix_cache.kvbm is e.kvbm
        held = len(e.kvbm.pool)
        again = e.generate(make_req("t3", list(PREFIX), max_tokens=4,
                                    temperature=0.0, ignore_eos=True))
        out[pkg] = (first, again, held, _counters(e.kvbm))
    assert out["port"] == out["jax"]
    assert out["port"][1] == out["port"][0][0] and out["port"][2] > 0
    assert out["port"][3]["onboarded_blocks_total"] > out["port"][3][
        "host_hits_total"] > 1
    # the port keeps the event sink across the rebuild (the JAX engine's
    # fresh prefix cache drops it)
    assert ev[:len(jev)] == jev


# ------------------------------------------------------------- event plane --

class _RecordingNats:
    def __init__(self):
        self.published = []

    def publish(self, subject, data, **kw):
        self.published.append((subject, json.loads(data)))


def test_helpers_are_the_jax_packages():
    text = "You are a helpful assistant. " * 200
    assert events.text_block_chain(text) == jtext_chain(text)
    assert events.kv_event_subject("m.x y", "http://w1:8000") \
        == jevents.kv_event_subject("m.x y", "http://w1:8000")
    toks = list(range(1, 40))
    for ns in ("", "v2#a"):
        assert events.token_block_chain(toks, 4, ns) \
            == jevents.token_block_chain(toks, 4, ns)


def test_publisher_translates_like_the_jax_publisher():
    text = "You are a helpful assistant. " * 20
    toks = list(range(1, 33))
    out = []
    for mod in (events, jevents):
        nc = _RecordingNats()
        pub = mod.KVEventPublisher(nc, "http://w1:8000", "m")
        pub.register(toks, text, page_size=4)
        hashes = mod.token_block_chain(toks, 4)
        pub.on_engine_event("stored", hashes, "device")
        pub.on_engine_event("removed", [hashes[4]], "none")
        out.append([(s, {k: v for k, v in p.items()})
                    for s, p in nc.published] + [pub.stats()])
    assert out[0] == out[1]
    chain = events.text_block_chain(text)
    assert set(out[0][0][1]["blocks"]) == set(chain)
    assert set(out[0][1][1]["blocks"]) == set(chain[len(chain) * 4 // 8:])


def test_engine_pipeline_publishes_like_the_jax_engine(params):
    """Engine events through the publisher's token -> text translation:
    the same payloads from both engines."""
    routing_text = "a shared system prompt, long enough to hash " * 8
    out = []
    for mod, e, make_req in zip((jevents, events), _engines(params),
                                (JGenRequest, GenRequest)):
        nc = _RecordingNats()
        pub = mod.KVEventPublisher(nc, "http://w0:8000", "tiny-debug")
        e.set_kv_event_sink(pub.on_engine_event)
        pub.register(PREFIX, routing_text, e.cfg.page_size)
        _turns(e, make_req)
        out.append([(s, p["type"], p["blocks"], p["tier"], p["seq"])
                    for s, p in nc.published])
    assert out[0] == out[1]
    kinds = {t for _, t, _, _, _ in out[1]}
    assert "stored" in kinds and "demoted" in kinds
