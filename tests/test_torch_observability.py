"""The port's observability plane against the JAX package's, on the CPU.

The copied modules (serving/metrics.py, observability/context, tracing,
flight, timeline, slo and cost) take the same scripted inputs, drawn from
a numpy seed, under one injected clock (time.time, time.monotonic,
time.time_ns) and one id source (os.urandom), in both packages: their
outputs must be equal, the /metrics pages byte for byte. The roofline
sizes equal the JAX package's for every preset; the KV books sum to the
pools' bytes and name the JAX snapshot's owners; the GPU catalog maps the
H100 and nothing else; the engine's hooks keep the JAX engine's books
(phase timer counts, histograms, flight records, timeline phases) on the
same requests; a failed step ends every stream and dumps the ring.
"""

import dataclasses
import itertools
import os
import time

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.engine import Engine as JEngine
from dynamo_tpu.engine.request import GenRequest as JGenRequest
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import PRESETS as JPRESETS
from dynamo_tpu.observability import context as jcontext
from dynamo_tpu.observability import cost as jcost
from dynamo_tpu.observability import flight as jflight
from dynamo_tpu.observability import memory as jmemory
from dynamo_tpu.observability import slo as jslo
from dynamo_tpu.observability import timeline as jtimeline
from dynamo_tpu.observability import tracing as jtracing
from dynamo_tpu.profiler import roofline as jroofline
from dynamo_tpu.serving import metrics as jmetrics
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import Engine
from dynamo_tpu_torch.engine.request import GenRequest
from dynamo_tpu_torch.models.config import PRESETS
from dynamo_tpu_torch.observability import context as pcontext
from dynamo_tpu_torch.observability import cost as pcost
from dynamo_tpu_torch.observability import engine_metrics as pengine_metrics
from dynamo_tpu_torch.observability import flight as pflight
from dynamo_tpu_torch.observability import memory as pmemory
from dynamo_tpu_torch.observability import slo as pslo
from dynamo_tpu_torch.observability import timeline as ptimeline
from dynamo_tpu_torch.observability import tracing as ptracing
from dynamo_tpu_torch.profiler import roofline as proofline
from dynamo_tpu_torch.profiler import systems
from dynamo_tpu_torch.serving import metrics as pmetrics

JAX = dict(metrics=jmetrics, context=jcontext, tracing=jtracing,
           flight=jflight, timeline=jtimeline, slo=jslo, cost=jcost)
PORT = dict(metrics=pmetrics, context=pcontext, tracing=ptracing,
            flight=pflight, timeline=ptimeline, slo=pslo, cost=pcost)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module: the parallel test workers share
    the cores, and torch's default pool in each of them oversubscribes
    them (the suite's tiny eager ops are as fast on one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Clock:
    """One scripted clock for time.time, time.monotonic and time.time_ns,
    advanced by the script; and a counter-driven os.urandom."""

    def __init__(self, t0: float = 1_700_000_000.0):
        self.t = t0
        self.ids = 0

    def advance(self, s: float) -> None:
        self.t += s

    def urandom(self, n: int) -> bytes:
        self.ids += 1
        return (self.ids.to_bytes(8, "big") * (n // 8 + 1))[:n]


def twin(monkeypatch, script, seed: int = 0):
    """Run script(mods, clock, rng) for the JAX package and the port, each
    from a fresh clock and a fresh numpy generator of `seed`; returns
    (jax_result, port_result)."""
    out = []
    for mods in (JAX, PORT):
        clock = Clock()
        monkeypatch.setattr(time, "time", lambda: clock.t)
        monkeypatch.setattr(time, "monotonic", lambda: clock.t - 1e9)
        monkeypatch.setattr(time, "time_ns", lambda: int(clock.t * 1e9))
        monkeypatch.setattr(os, "urandom", clock.urandom)
        out.append(script(mods, clock, np.random.default_rng(seed)))
    monkeypatch.undo()
    return out


# ------------------------------------------------------------- metrics --

def _registry_script(mods, clock, rng):
    m = mods["metrics"]
    fm = m.FrontendMetrics()
    r = fm.registry
    extra_counter = m.Counter("dtt_events_total", "Events by kind", r,
                              labelnames=("kind",))
    bare = m.Counter("dtt_bare_total", "A label-less counter", r)
    gauge = m.Gauge("dtt_gauge", "A labeled gauge", r,
                    labelnames=("device", "kind"))
    m.CallbackCounter("dtt_callback_total", "Read at scrape", r,
                      lambda: 41.5)
    m.CallbackCounterVec("dtt_callback_vec_total", "Read at scrape", r,
                         lambda: {(("op", "a"),): 2, (("op", "b\"q"),): 3},
                         labelnames=("op",))
    m.CallbackHistogram(
        "dtt_callback_seconds", "Read at scrape", r,
        lambda: [({"phase": "x"}, [0.1, 1.0], [1, 3, 4], 2.5, 4)])
    models = ["tiny", 'we"ird\\mod\nel']
    for i in range(60):
        model = models[int(rng.integers(0, 2))]
        ex = f"{int(rng.integers(0, 1 << 62)):032x}" if i % 3 else None
        fm.requests_total.inc(model=model)
        fm.ttft.observe(float(rng.exponential(0.2)), exemplar=ex,
                        model=model)
        fm.itl.observe(float(rng.exponential(0.02)), exemplar=ex,
                       model=model)
        fm.duration.observe(float(rng.exponential(3.0)), model=model)
        fm.isl.observe(int(rng.integers(1, 20000)), model=model)
        fm.osl.observe(int(rng.integers(0, 600)), model=model)
        if i % 7 == 0:
            fm.errors_total.inc(model=model, code="503")
        extra_counter.inc(float(rng.integers(1, 4)),
                          kind=f"k{int(rng.integers(0, 3))}")
        clock.advance(float(rng.uniform(0.001, 0.5)))
    bare.inc(3)
    fm.queued.set(7)
    gauge.set(1.5, device="cuda:0", kind="in_use")
    gauge.set(2.5, device="cuda:0", kind="limit")
    gauge.remove(device="cuda:0", kind="limit")
    return (r.expose(), r.expose(openmetrics=True),
            r.scrape("application/openmetrics-text; version=1.0.0"),
            r.scrape(None), fm.ttft.good_total(0.25), fm.itl.snapshot())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_scrapes_are_byte_identical(monkeypatch, seed):
    ref, got = twin(monkeypatch, _registry_script, seed)
    assert got[0] == ref[0]
    assert got[1] == ref[1]
    assert " # {trace_id=" in got[1] and got[1].endswith("# EOF\n")
    assert got[2:] == ref[2:]


# ------------------------------------------------------ context, spans --

def _context_script(mods, clock, rng):
    c = mods["context"]
    rids = [f"req-{int(rng.integers(0, 1 << 40))}" for _ in range(8)]
    headers = [
        {"traceparent": f"00-{'a' * 32}-{'b' * 16}-01"},
        {"traceparent": f"01-{'c' * 32}-{'d' * 16}-00-extra"},
        {"traceparent": f"ff-{'a' * 32}-{'b' * 16}-01"},
        {"traceparent": f"00-{'0' * 32}-{'b' * 16}-01"},
        {"traceparent": "garbage", "x-request-id": "fallback-rid"},
        {"TRACEPARENT": "ignored-case-by-dict"},
        {},
    ]
    out = []
    for rid in rids:
        ctx = c.TraceContext.new(rid)
        back = c.parse_traceparent(c.format_traceparent(ctx))
        out.append((c.new_trace_id(rid), c.new_span_id(rid),
                    ctx.to_traceparent(), back.trace_id, back.span_id,
                    back.flags))
    for h in headers:
        ctx = c.extract_context(h)
        out.append(None if ctx is None else ctx.to_traceparent())
        out.append(c.inject_context(ctx, {}, request_id="r1"))
    out.append(c.extract_context(None, request_id="only-rid"))
    out.append((c.new_trace_id(), c.new_span_id()))  # from os.urandom
    return [o.to_traceparent() if hasattr(o, "to_traceparent") else o
            for o in out]


def test_traceparent_round_trips_and_seeded_ids_match(monkeypatch):
    ref, got = twin(monkeypatch, _context_script)
    assert got == ref


def _span_script(mods, clock, rng):
    t = mods["tracing"]
    col = t.SpanCollector(capacity=6)
    tracer = t.Tracer("worker-agg", collector=col)
    for i in range(4):
        root = tracer.start_span("worker.request", kind="server",
                                 trace_seed=f"rid-{i}",
                                 attributes={"i": i, "ok": True,
                                             "x": float(rng.random())})
        clock.advance(0.01)
        with tracer.start_span("worker.prefill", parent=root) as sp:
            sp.add_event("chunk", {"n": int(rng.integers(0, 9))})
            clock.advance(float(rng.uniform(0.001, 0.05)))
        child = tracer.start_span("worker.decode", parent=root.context,
                                  start_ns=int(clock.t * 1e9) - 5)
        if i == 2:
            child.set_status("ERROR", "boom")
        child.end()
        root.end()
    return (t.spans_debug_payload({}, col),
            t.spans_debug_payload({"name": ["worker.p"]}, col),
            t.spans_debug_payload({"trace_id": [col.trace_ids()[0]]}, col),
            col.dropped_total)


def test_span_exports_match(monkeypatch):
    ref, got = twin(monkeypatch, _span_script)
    assert got == ref
    assert got[3] > 0  # the 6-span ring wrapped


def test_kill_switch_returns_the_noop_span(monkeypatch):
    monkeypatch.setenv("DYNAMO_TPU_TRACE", "0")
    span = ptracing.Tracer("x").start_span("worker.request")
    assert span is ptracing.NOOP_SPAN and not span.recording


# ----------------------------------------------------- flight, timeline --

def _flight_script(mods, clock, rng):
    f = mods["flight"]
    fr = f.FlightRecorder(capacity=16)
    for step in range(30):
        fr.begin()
        if step % 5 == 4:
            fr.commit(active=0)  # an idle step: elided
            continue
        for kind in ("prefill", "decode", "decode")[:1 + step % 3]:
            fr.phase(kind, float(rng.uniform(1e-4, 2e-2)),
                     take=int(rng.integers(0, 64)))
        rid = f"r{int(rng.integers(0, 4))}"
        fr.note("admit", rid=rid, slot=step % 4, tenant="default")
        if step % 6 == 0:
            fr.note("preempt", rid=rid, tenant="default", n_out=step)
        fr.commit(active=step % 4, pending=1, batch=[{"rid": rid,
                                                      "slot": 0}])
        clock.advance(0.01)
        if step == 20:
            fr.note("resume", rid="r9")  # no draft open: standalone
    fr.begin()
    fr.phase("decode", 0.5)
    dump = fr.dump("abort_all", rids=["r1"])
    qs = [{}, {"n": ["3"]}, {"rid": ["r1"]}, {"kind": ["prefill"]},
          {"tenant": ["default"], "n": ["0"]}, {"n": ["bad"]}]
    return dump, [f.debug_flight_payload(fr, q) for q in qs]


def test_flight_payloads_match(monkeypatch):
    ref, got = twin(monkeypatch, _flight_script)
    assert got == ref
    assert got[1][0]["dropped_total"] > 0


def _timeline_script(mods, clock, rng):
    t = mods["timeline"]
    c = mods["tracing"].SpanCollector(capacity=8)
    tl = t.StepTimeline(capacity=6, enabled=True)
    for step in range(12):
        tl.begin_step()
        for name in ("admit", "page_alloc", "dispatch", "device_wait",
                     "detok", "bank"):
            if rng.random() < 0.2:
                continue
            with tl.phase(name):
                clock.advance(float(rng.uniform(1e-5, 3e-3)))
                if name == "admit" and rng.random() < 0.5:
                    with tl.phase("dispatch"):  # nested: pauses admit
                        clock.advance(float(rng.uniform(1e-4, 1e-3)))
                    with tl.phase("device_wait"):
                        clock.advance(float(rng.uniform(1e-4, 1e-3)))
            clock.advance(float(rng.uniform(0, 1e-4)))  # untracked gap
        tl.commit_step(active=step % 3)
    mods["tracing"].Tracer("worker-agg", collector=c).start_span(
        "worker.request", trace_seed="rid").end()
    summary = tl.summary()
    qs = [{}, {"format": ["summary"]}, {"format": ["perfetto"]},
          {"steps": ["2"]}]
    return (summary, t.merge_summaries([summary, summary, {}]),
            [t.timeline_debug_payload(tl, q, collector=c) for q in qs])


def test_timeline_payloads_match(monkeypatch):
    ref, got = twin(monkeypatch, _timeline_script)
    assert got == ref
    assert got[0]["steps"] == 12 and got[0]["host_gap"]["count"] > 0


# ------------------------------------------------------------ slo, cost --

def _slo_script(mods, clock, rng):
    m, s = mods["metrics"], mods["slo"]
    fm = m.FrontendMetrics()
    targets = [s.target_from_dict({"model": "tiny", "ttftMs": 250,
                                   "itlMs": 25, "errorRate": 0.05,
                                   "goal": 0.9}),
               s.target_from_dict({"name": "all", "ttft_ms": 100}),
               s.target_from_dict({"model": "typo", "ttft_ms": 100})]
    eng = s.SLOEngine(fm, role="agg", targets=targets, clock=lambda: clock.t)
    for _ in range(200):
        fm.requests_total.inc(model="tiny")
        fm.ttft.observe(float(rng.exponential(0.15)), model="tiny")
        fm.itl.observe(float(rng.exponential(0.015)), model="tiny")
        if rng.random() < 0.04:
            fm.errors_total.inc(model="tiny", code="500")
        clock.advance(float(rng.uniform(0.5, 20.0)))
        if rng.random() < 0.1:
            eng.tick()
    eng.refresh_gauges()
    env_targets = s.targets_from_env(
        {"DYNAMO_TPU_SLO_TARGETS": '[{"model": "m", "ttftMs": 200}]',
         "DYNAMO_TPU_SLO_ITL_MS": "30", "DYNAMO_TPU_SLO_GOAL": "0.95"})
    return (s.debug_slo_payload(eng, {"history": ["1"]}),
            s.debug_slo_payload(None, {}), fm.registry.expose(),
            [t.to_dict() for t in env_targets])


def test_slo_payloads_and_gauges_match(monkeypatch):
    ref, got = twin(monkeypatch, _slo_script)
    assert got == ref
    assert got[0]["evaluations"] and "dynamo_slo_burn_rate{" in got[2]


def _cost_script(mods, clock, rng):
    c = mods["cost"]
    ledgers = []
    for _ in range(2):
        led = c.CostLedger()
        for _ in range(40):
            n = int(rng.integers(0, 4))
            shares = {f"t{i}": float(rng.integers(0, 5)) for i in range(n)}
            holdings = {f"t{i}": float(rng.integers(0, 1 << 20))
                        for i in range(n)}
            led.account(float(rng.uniform(-0.01, 0.05)), shares, holdings)
        ledgers.append(led)
    return ([led.rollup() for led in ledgers], ledgers[0].per_tenant(),
            c.merge_rollups([ledgers[0].rollup(), ledgers[1].rollup(),
                             "bad", {"tenants": {"x": "bad"}}]))


def test_cost_rollups_match(monkeypatch):
    ref, got = twin(monkeypatch, _cost_script)
    assert got == ref
    roll = got[0][0]
    assert sum(t["chip_seconds"] for t in roll["tenants"].values()) \
        == pytest.approx(roll["totals"]["chip_seconds"], abs=1e-5)


# ------------------------------------------------------------- roofline --

@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_roofline_sizes_match_the_jax_package(preset):
    cfg, jcfg = PRESETS[preset], JPRESETS[preset]
    assert proofline.param_count(cfg) == jroofline.param_count(jcfg)
    assert (proofline.active_param_count(cfg)
            == jroofline.active_param_count(jcfg))
    for kv_dtype, tp in itertools.product(("auto", "int8"), (1, 2, 8)):
        assert (proofline.kv_bytes_per_token(cfg, kv_dtype, tp=tp)
                == jroofline.kv_bytes_per_token(jcfg, kv_dtype, tp=tp))
    for q in ("none", "int8", "w8a8"):
        assert proofline.weight_bytes(q) == jroofline.weight_bytes(q)


# ------------------------------------------------------ systems, gauges --

def test_the_catalog_maps_the_h100_sxm_only():
    chip = systems.chip_for_device_kind("NVIDIA H100 80GB HBM3")
    assert chip is systems.CHIPS["h100-sxm"]
    assert chip.bf16_flops == 989e12 and chip.hbm_bw == 3.35e12
    assert chip.nvlink_bw == 18 * 25e9
    for other in ("NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB", "cpu", ""):
        assert systems.chip_for_device_kind(other) is None


BASE = dict(model="tiny-debug", page_size=4, num_pages=48, max_num_seqs=4,
            max_seq_len=128, prefill_chunk_tokens=16,
            enable_prefix_caching=True, async_scheduling=False)


def _serve_some(engine, n=3, max_tokens=6, seed=0):
    rng = np.random.default_rng(seed)
    for i in range(n):
        engine.add_request(GenRequest(
            f"r{i}", rng.integers(0, 256, size=10 + 9 * i).tolist(),
            max_tokens=max_tokens, ignore_eos=True))
    while engine.has_work:
        engine.step()


@pytest.mark.parametrize("forced", [None, "h100-sxm"])
def test_mfu_and_mbu_read_zero_without_a_known_card(monkeypatch, forced):
    """On the CPU no card is identified and both gauges read 0 after real
    decode work; DYNAMO_TPU_CHIP forces the catalog's entry, and then the
    JAX formula gives a share in (0, 1]."""
    if forced:
        monkeypatch.setenv("DYNAMO_TPU_CHIP", forced)
    eng = Engine(EngineConfig(**BASE), device="cpu")
    bridge = pengine_metrics.EngineMetricsBridge(pmetrics.Registry(), eng)
    _serve_some(eng)
    bridge.refresh()
    mfu, mbu = bridge.mfu_gauge._values[()], bridge.mbu_gauge._values[()]
    if forced is None:
        assert bridge.chip is None and mfu == 0.0 and mbu == 0.0
    else:
        assert bridge.chip is systems.CHIPS["h100-sxm"]
        assert 0.0 < mfu <= 1.0 and 0.0 < mbu <= 1.0
    bridge.refresh()  # an idle window reads 0
    assert bridge.mfu_gauge._values[()] == 0.0


# --------------------------------------------------------------- memory --

@pytest.mark.parametrize("model,kv", [("tiny-debug", "auto"),
                                      ("tiny-debug", "int8"),
                                      ("tiny-mla-debug", "auto")])
def test_kv_books_sum_to_the_pools_bytes(model, kv):
    eng = Engine(EngineConfig(**dict(BASE, model=model,
                                     kv_cache_dtype=kv)), device="cpu")
    acct = pmemory.MemoryAccountant(eng)
    pools = eng.k_pages.nbytes + eng.v_pages.nbytes
    assert eng.cfg.num_pages * acct.page_bytes == pools

    rng = np.random.default_rng(3)
    for i in range(3):
        eng.add_request(GenRequest(
            f"m{i}", rng.integers(0, 256, size=30).tolist(), max_tokens=8,
            ignore_eos=True))
    seen = set()
    while eng.has_work:
        eng.step()
        snap = acct.snapshot()
        dev = snap["tiers"]["device"]
        assert sum(dev.values()) == pools
        assert snap["pool"]["total_bytes"] == pools
        seen.update(dev)
    assert {"default", "free", "trash"} <= seen
    assert "cache" in acct.snapshot()["tiers"]["device"]


@pytest.fixture(scope="module")
def jparams():
    cfg = dataclasses.replace(JPRESETS["tiny-debug"], dtype="float32")
    return jllama.init_params(cfg, jax.random.PRNGKey(0))


def test_kv_owners_match_the_jax_snapshot(jparams):
    """The same requests stepped in both engines: after every step the
    device tier's owners and bytes, the pool counts and the per-adapter
    split equal the JAX accountant's."""
    cfg = dict(BASE, num_scheduler_steps=1)
    jeng = JEngine(JEngineConfig(**cfg), params=jparams)
    peng = Engine(EngineConfig(**cfg),
                  params={k: np.asarray(v) for k, v in jparams.items()},
                  device="cpu")
    jacct = jmemory.MemoryAccountant(jeng)
    pacct = pmemory.MemoryAccountant(peng)
    rng = np.random.default_rng(4)
    shared = rng.integers(0, 256, size=24).tolist()
    prompts = [shared + rng.integers(0, 256, size=n).tolist()
               for n in (3, 30, 5, 41)]
    for i, p in enumerate(prompts):
        jeng.add_request(JGenRequest(f"o{i}", p, max_tokens=7,
                                     ignore_eos=True))
        peng.add_request(GenRequest(f"o{i}", p, max_tokens=7,
                                    ignore_eos=True))
    steps = 0
    while jeng.has_work or peng.has_work:
        jeng.step()
        peng.step()
        steps += 1
        want, got = jacct.snapshot(), pacct.snapshot()
        for key in ("page_bytes", "pool", "device_pages_by_tenant",
                    "device_pages_by_adapter"):
            assert got[key] == want[key], (steps, key)
        assert got["tiers"]["device"] == want["tiers"]["device"], steps
    assert steps > 5


@pytest.mark.parametrize("extra", [
    dict(mixed_batch_tokens=16),
    dict(num_scheduler_steps=4, enable_prefix_caching=False),
])
def test_engine_books_match_the_jax_engine(jparams, extra):
    """The same requests stepped in both engines (mixed steps, chunks and
    batched prefills; or 4-step windows): every phase timer's count, the
    occupancy and mixed-fraction buckets, each flight record's kind and
    events and the timeline's per-phase step counts (the JAX engine's
    "bank" aside: the port banks nothing) are the JAX engine's."""
    cfg = dict(BASE, **extra)
    jeng = JEngine(JEngineConfig(**cfg), params=jparams)
    peng = Engine(EngineConfig(**cfg),
                  params={k: np.asarray(v) for k, v in jparams.items()},
                  device="cpu")
    rng = np.random.default_rng(5)
    for i, n in enumerate((5, 40, 7, 9, 33)):
        prompt = rng.integers(0, 256, size=n).tolist()
        jeng.add_request(JGenRequest(f"b{i}", prompt, max_tokens=9,
                                     ignore_eos=True))
        peng.add_request(GenRequest(f"b{i}", prompt, max_tokens=9,
                                    ignore_eos=True))
        jeng.step()
        peng.step()
    while jeng.has_work or peng.has_work:
        jeng.step()
        peng.step()
    jm, pm = jeng.metrics, peng.metrics
    assert ({p: t.count for p, t in pm.phases.items()}
            == {p: t.count for p, t in jm.phases.items()})
    assert pm.occupancy_buckets == jm.occupancy_buckets
    assert pm.mixed_buckets == jm.mixed_buckets
    assert pm.mixed_count == jm.mixed_count
    if extra.get("mixed_batch_tokens"):
        assert pm.mixed_count > 0

    def flight(eng):
        return [(r["kind"], [e["ev"] for e in r["events"]], r.get("active"))
                for r in eng.flight.records()]

    assert flight(peng) == flight(jeng)
    assert peng.cost.segments_total == jeng.cost.segments_total
    jsteps = {p: d.count for p, d in jeng.timeline.digests.items()
              if p != "bank"}
    assert {p: d.count for p, d in peng.timeline.digests.items()
            if p != "bank"} == jsteps


def test_a_failed_step_ends_every_stream_and_dumps_the_ring(monkeypatch):
    """A step that raises: the service notes it in the flight ring, the
    watchdog trips (a dump) and resurrects the engine in place, whose
    teardown gives every request's pages back (a dump record) and ends
    each waiting stream with an abort event, as the JAX service does."""
    from dynamo_tpu_torch.serving.engine_service import EngineService

    eng = Engine(EngineConfig(**dict(BASE, enable_prefix_caching=False)),
                 device="cpu")
    real = eng._step_locked
    calls = {"n": 0}

    def failing():
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("injected")
        return real()

    monkeypatch.setattr(eng, "_step_locked", failing)
    svc = EngineService(eng)
    try:
        reqs = [GenRequest(f"f{i}", list(range(1, 12 + i)), max_tokens=50,
                           ignore_eos=True) for i in range(2)]
        queues = [svc.submit(r) for r in reqs]
        last = [list(svc.drain(r, q, timeout=60))[-1]
                for r, q in zip(reqs, queues)]
    finally:
        svc.close()
    assert all(ev.finished and ev.finish_reason == "abort" for ev in last)
    assert eng.allocator.free_pages == BASE["num_pages"] - 1
    assert not eng.has_work
    events = [e["ev"] for r in eng.flight.records() for e in r["events"]]
    assert events[events.index("fatal_step"):] == [
        "fatal_step", "watchdog_trip", "dump", "resurrect_begin", "finish",
        "finish", "dump", "restage_live", "resurrect_done"]
    assert eng.watchdog.health == "healthy"
