"""The port's KV-aware router against the JAX package's, on the CPU.

The JAX package's own router cases (`tests/test_router.py`,
`tests/test_router_native.py`) run against both packages
(`torch_tier_cases`); then random worker sets, headrooms, affinity keys
and KV-event sequences through both packages' `Router` and `KVEventIndex`
give the same picks and scores, and both native cores the same
`dr_hash64`."""

import ctypes
import hashlib
import string

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from dynamo_tpu.runtime import native as jnative
from dynamo_tpu.serving import router as jrouter
from dynamo_tpu_torch.runtime import native
from dynamo_tpu_torch.serving import router
from torch_tier_cases import FixtureCache, cases, run


@pytest.fixture(scope="module")
def tier_fixtures():
    with FixtureCache() as cache:
        yield cache


@pytest.mark.parametrize("pkg,case", cases("test_router"))
def test_router_cases(pkg, case, request, tier_fixtures):
    run(request, tier_fixtures, "test_router", pkg, case)


@pytest.mark.parametrize("pkg,case", cases("test_router_native"))
def test_router_native_cases(pkg, case, request, tier_fixtures):
    run(request, tier_fixtures, "test_router_native", pkg, case)


def test_native_core_builds_into_the_repo_build_dir():
    lib = native.get_router_lib()
    assert lib is not None, native.router_status()
    assert native.router_status() == {"native_router": True}
    assert native.BUILD_DIR.parts[-3:] == ("build", "dynamo_tpu_torch",
                                          "native")
    assert any(native.BUILD_DIR.glob("libdynamo_router_*.so"))


KEYS = st.text(alphabet=string.printable + "яüñ", max_size=300)


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(msgs=st.lists(KEYS, min_size=1, max_size=8))
def test_both_native_cores_hash_alike(msgs):
    lib, jlib = native.get_router_lib(), jnative.get_router_lib()
    for msg in msgs:
        raw = msg.encode()
        if b"\x00" in raw:
            continue
        want = int.from_bytes(hashlib.sha256(raw).digest()[:8], "big")
        assert lib.dr_hash64(raw) == jlib.dr_hash64(raw) == want


def _stats(active, pending, free, total, seqs, health):
    return {"max_num_seqs": seqs, "active_seqs": active, "pending": pending,
            "free_pages": free, "total_pages": total,
            "health": {"state": health}}


WORKERS = st.lists(
    st.tuples(st.integers(0, 40), st.integers(0, 8), st.integers(0, 8),
              st.integers(0, 100), st.sampled_from(
                  ["healthy"] * 4 + ["suspect", "quarantined"])),
    min_size=1, max_size=6)
# a conversation: a shared system prompt and a few turns of text
TEXTS = st.lists(st.text(alphabet="abcdefgh ", min_size=0, max_size=400),
                 min_size=1, max_size=4)


def _events(draw_blocks, workers):
    return [{"type": kind, "worker": workers[w % len(workers)],
             "model": "m", "blocks": blocks, "tier": tier}
            for kind, w, blocks, tier in draw_blocks]


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(workers=WORKERS, texts=TEXTS, data=st.data())
def test_router_picks_and_index_scores_match(workers, texts, data):
    """Both packages' routers, fed the same heartbeats, KV events and
    requests, pick the same worker (by index) with the same explanation,
    and their KV event indexes hold the same entries."""
    urls = [f"http://w{i}:8000" for i in range(len(workers))]
    routers = (jrouter.Router(), router.Router())
    for r in routers:
        for url, (active, pend, free, seqs, health) in zip(urls, workers):
            r.register(url, "m", stats=_stats(
                min(active, 40), pend, free, 100, max(1, seqs), health))
    prompts = ["".join(texts[:i + 1]) for i in range(len(texts))]
    chains = [jrouter.text_block_chain(p) for p in prompts]
    assert chains == [router.text_block_chain(p) for p in prompts]
    blocks = [b for c in chains for b in c] or ["x"]
    evs = data.draw(st.lists(st.tuples(
        st.sampled_from(["stored", "demoted", "removed", "bogus"]),
        st.integers(0, 9), st.lists(st.sampled_from(blocks), max_size=6),
        st.sampled_from(["device", "host"])), max_size=12))
    for ev in _events(evs, urls):
        assert routers[0].kv_index.apply(ev) == routers[1].kv_index.apply(ev)
    assert routers[0].kv_index.stats() == routers[1].kv_index.stats()
    assert list(routers[0].kv_index._m.items()) == list(
        routers[1].kv_index._m.items())
    for prompt, chain in zip(prompts, chains):
        live = {}
        for r in routers:
            live[r] = {w.url: w for w in r.alive()}
        assert (routers[0].kv_index.lookup("m", chain, live[routers[0]])
                == routers[1].kv_index.lookup("m", chain, live[routers[1]]))
        for relaxed in (False, True):
            picks, explains = [], []
            for r in routers:
                explain = {}
                w = r.pick("m", jrouter.prefix_key(prompt),
                           prompt_text=prompt, explain=explain,
                           relaxed_overlap=relaxed)
                picks.append(None if w is None else urls.index(w.url))
                explains.append(explain)
            assert picks[0] == picks[1]
            assert explains[0] == explains[1]


@settings(max_examples=40, deadline=None)
@given(key=KEYS, headrooms=st.lists(st.floats(0, 1), min_size=1,
                                     max_size=10))
def test_hrw_pick_matches_in_both_cores_and_python(key, headrooms):
    """The weighted rendezvous pick: both native cores and the Python
    loop choose the same worker."""
    raw = key.encode()
    if b"\x00" in raw:
        return
    urls = [f"http://worker-{i}:{8000 + i}".encode()
            for i in range(len(headrooms))]
    arr = (ctypes.c_char_p * len(urls))(*urls)
    hr = (ctypes.c_double * len(urls))(*headrooms)
    got = native.get_router_lib().dr_pick(raw, arr, hr, len(urls))
    assert got == jnative.get_router_lib().dr_pick(raw, arr, hr, len(urls))
    best, best_score = -1, -1.0
    for i, (u, h) in enumerate(zip(urls, headrooms)):
        draw = int.from_bytes(hashlib.sha256(raw + b"|" + u).digest()[:8],
                              "big") / 2**64
        if draw * (0.25 + 0.75 * h) > best_score:
            best, best_score = i, draw * (0.25 + 0.75 * h)
    assert got == best
