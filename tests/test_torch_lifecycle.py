"""The port's worker lifecycle against the JAX worker's, on the CPU: the
watchdog (the same seam times through both packages' EngineWatchdog give
the same deadlines and transitions), the integrity sentinels, a fatal
step's inline resurrection and quarantine, a hung dispatch handed off and
resumed on a peer behind the JAX frontend, deadlines (504), the fault
plane's route, drain, readiness, and the worker CLI's heartbeats and
SIGTERM drain. Engines run tiny-debug on the JAX package's params carried
across (`models/loader.from_jax_params`); greedy tokens are compared
exactly (no tolerance)."""

import dataclasses
import http.server
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.engine import Engine as JEngine
from dynamo_tpu.engine.request import GenRequest as JGenRequest
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import PRESETS as JPRESETS
from dynamo_tpu.robustness import deadline as jdeadline
from dynamo_tpu.robustness import faults as jfaults
from dynamo_tpu.robustness import watchdog as jwatchdog
from dynamo_tpu.serving import api as japi
from dynamo_tpu.serving.frontend import FrontendContext, make_frontend_server
from dynamo_tpu.serving.router import Router
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import Engine
from dynamo_tpu_torch.engine.request import GenRequest
from dynamo_tpu_torch.robustness import deadline as tdeadline
from dynamo_tpu_torch.robustness import faults as tfaults
from dynamo_tpu_torch.robustness import watchdog as twatchdog
from dynamo_tpu_torch.serving import api
from dynamo_tpu_torch.serving import worker as tworker

MODEL = "tiny-debug"
KW = dict(model=MODEL, page_size=4, num_pages=128, max_num_seqs=4,
          max_seq_len=128)
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6]
WATCHDOGS = {"jax": jwatchdog, "port": twatchdog}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module: the parallel test workers share
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def params():
    cfg = dataclasses.replace(JPRESETS[MODEL], dtype="float32")
    return jllama.init_params(cfg, jax.random.PRNGKey(0))


def port_engine(params, **kw):
    return Engine(EngineConfig(**{**KW, **kw}),
                  params={k: np.asarray(v) for k, v in params.items()},
                  device="cpu")


def jax_engine(params, **kw):
    return JEngine(JEngineConfig(**{**KW, "async_scheduling": False, **kw}),
                   params=params)


def greedy(eng, make_req, rid, prompt=PROMPT, max_tokens=10):
    return eng.generate(make_req(rid, list(prompt), max_tokens=max_tokens,
                                 temperature=0.0, ignore_eos=True))


def run_all(eng, make_req, prompts, max_tokens=10):
    """Admit every prompt at once and step to the end: {rid: (tokens,
    finish reason)}."""
    for i, p in enumerate(prompts):
        eng.add_request(make_req(f"r{i}", list(p), max_tokens=max_tokens,
                                 temperature=0.0, ignore_eos=True))
    out = {}
    while eng.has_work:
        for ev in eng.step():
            toks, _ = out.get(ev.request_id, ([], None))
            if ev.token_id >= 0:
                toks = toks + [ev.token_id]
            out[ev.request_id] = (toks, ev.finish_reason if ev.finished
                                  else None)
    return out


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# ------------------------------------------------------- watchdog units --

@pytest.mark.parametrize("pkg", sorted(WATCHDOGS))
def test_deadline_floor_then_ewma_then_override(pkg):
    wdm = WATCHDOGS[pkg]
    clk = FakeClock()
    wd = wdm.EngineWatchdog(clock=clk)
    try:
        assert wd.deadline_s() == wd.floor_s == 2.0
        wd.device_enter("dispatch")
        clk.t += 0.5
        wd.device_exit("dispatch")
        assert wd.summary()["ewma_s"] == pytest.approx(0.5)
        assert wd.deadline_s() == pytest.approx(max(2.0, 0.5 * 20.0))
        wd.device_enter("dispatch")
        clk.t += 0.1
        wd.device_exit("dispatch")
        assert wd.summary()["ewma_s"] == pytest.approx(0.42)
    finally:
        wd.stop()
    wd2 = wdm.EngineWatchdog(deadline_s=1.25, clock=clk)
    wd2.device_enter("d")
    clk.t += 9.0
    wd2.device_exit("d")
    assert wd2.deadline_s() == 1.25
    wd2.stop()


def test_same_seam_times_give_the_same_deadlines_and_transitions():
    """One random sequence of seam times, trips and integrity faults
    through both packages' watchdogs: the same deadline after every seam,
    the same health after every trip, the same summaries (exact floats:
    the same arithmetic)."""
    rng = np.random.default_rng(3)
    seams = rng.exponential(0.05, size=40)
    trace = {}
    for pkg, wdm in WATCHDOGS.items():
        clk = FakeClock()
        wd = wdm.EngineWatchdog(quarantine_window_s=30.0, clock=clk)
        states = []
        wd.on_health = states.append
        out = []
        try:
            for i, dt in enumerate(seams):
                wd.device_enter("device_wait" if i % 2 else "dispatch")
                clk.t += float(dt)
                wd.device_exit("device_wait" if i % 2 else "dispatch")
                out.append(wd.deadline_s())
                if i in (10, 25):
                    wd.record_integrity_fault("logits", [f"r{i}"])
                if i == 12:
                    wd.trip("hung_dispatch", seam="dispatch", escalate=False)
                    out.append(wd.health)
                if i == 30:
                    clk.t += 40.0  # the first trip ages out of the window
                    wd.trip("hung_dispatch", seam="device_wait",
                            escalate=False)
                    out.append(wd.health)
                    clk.t += 1.0
                    wd.trip("fatal_step", seam="step", escalate=False)
                    out.append(wd.health)
            summary = wd.summary()
            summary["last_trip"].pop("t")
            trace[pkg] = (out, states, summary)
        finally:
            wd.stop()
    assert trace["port"] == trace["jax"]
    assert trace["port"][1] == ["suspect", "quarantined"]


@pytest.mark.parametrize("pkg", sorted(WATCHDOGS))
def test_env_knobs_configure_deadline_window_and_integrity(pkg, monkeypatch):
    wdm = WATCHDOGS[pkg]
    monkeypatch.setenv(wdm.DEADLINE_ENV, "3.5")
    monkeypatch.setenv(wdm.QUARANTINE_WINDOW_ENV, "42")
    wd = wdm.EngineWatchdog()
    assert wd.deadline_s() == 3.5 and wd.quarantine_window_s == 42.0
    wd.stop()
    monkeypatch.setenv(wdm.DEADLINE_ENV, "not-a-number")
    wd = wdm.EngineWatchdog()
    assert wd.deadline_s() == wd.floor_s
    wd.stop()
    monkeypatch.setenv(wdm.INTEGRITY_ENV, "full")
    assert wdm.integrity_mode() == "full"
    monkeypatch.setenv(wdm.INTEGRITY_ENV, "bogus")
    assert wdm.integrity_mode() == "logits"
    assert wdm.HEALTH_CODES == jwatchdog.HEALTH_CODES


@pytest.mark.parametrize("pkg", sorted(WATCHDOGS))
def test_monitor_trips_once_per_arming(pkg):
    wd = WATCHDOGS[pkg].EngineWatchdog(deadline_s=0.05)
    trips = []
    wd.on_trip = lambda kind, seam: trips.append((kind, seam))
    try:
        wd.device_enter("dispatch")
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and wd.health == "healthy":
            time.sleep(0.01)
        assert wd.health == "suspect"
        time.sleep(0.2)
        assert wd.summary()["trips_total"] == {"hung_dispatch": 1}
        assert trips == [("hung_dispatch", "dispatch")]
        wd.device_exit("dispatch")
    finally:
        wd.stop()


@pytest.mark.parametrize("pkg", sorted(WATCHDOGS))
def test_tripped_seam_never_poisons_the_ewma(pkg):
    clk = FakeClock()
    wd = WATCHDOGS[pkg].EngineWatchdog(quarantine_window_s=10.0, clock=clk)
    try:
        wd.device_enter("dispatch")
        clk.t += 0.2
        wd.device_exit("dispatch")
        ewma = wd.summary()["ewma_s"]
        wd.device_enter("dispatch")
        with wd._lock:
            wd._armed[2] = True  # as the monitor marks it
        clk.t += 500.0
        wd.device_exit("dispatch")
        assert wd.summary()["ewma_s"] == ewma
    finally:
        wd.stop()


@pytest.mark.parametrize("pkg", sorted(WATCHDOGS))
def test_quarantine_inside_the_window_is_terminal(pkg):
    clk = FakeClock()
    wd = WATCHDOGS[pkg].EngineWatchdog(quarantine_window_s=10.0, clock=clk)
    try:
        wd.trip("hung_dispatch", seam="dispatch", escalate=False)
        clk.t += 100.0  # outside the window: suspect again, not terminal
        wd.trip("hung_dispatch", escalate=False)
        assert wd.health == "suspect"
        clk.t += 5.0
        wd.trip("fatal_step", seam="step", escalate=False)
        assert wd.health == "quarantined" and wd.health_code == 3
        assert not wd._transition("healthy")
        assert not wd._transition("resurrecting")
    finally:
        wd.stop()


@pytest.mark.parametrize("pkg", sorted(WATCHDOGS))
def test_integrity_faults_count_without_health_change(pkg):
    wd = WATCHDOGS[pkg].EngineWatchdog()
    try:
        wd.record_integrity_fault("logits", ["r-1"], where="prefill")
        wd.record_integrity_fault("decode_tokens", ["r-2"], slot=1)
        wd.record_integrity_fault("logits", ["r-3"], where="prefill")
        assert wd.health == "healthy" and wd.ok_for_traffic
        assert wd.summary()["integrity_faults_total"] == {
            "logits": 2, "decode_tokens": 1}
    finally:
        wd.stop()


def test_exemptions_disarm_the_open_seam_and_hold_arming():
    """The port's long-but-not-hung seams: an exemption that begins
    mid-seam disarms it, no seam arms inside one or in its tail, and the
    engine's probe (an open profiler session) keeps seams unarmed."""
    clk = FakeClock()
    wd = twatchdog.EngineWatchdog(deadline_s=0.5, clock=clk)
    try:
        wd.device_enter("dispatch")
        assert wd._armed is not None
        with wd.exempt("graph_capture", tail_s=2.0):
            assert wd._armed is None
            wd.device_enter("device_wait")
            assert wd._armed is None
        clk.t += 1.0
        wd.device_enter("device_wait")  # inside the 2 s tail
        assert wd._armed is None
        clk.t += 1.5
        wd.device_enter("device_wait")
        assert wd._armed is not None
        wd.device_exit("device_wait")
        wd.exempt_probe = lambda: "profiler"
        wd.device_enter("dispatch")
        assert wd._armed is None
        wd.exempt_probe = lambda: None
        clk.t += twatchdog.PROFILER_TAIL_S - 0.1
        wd.device_enter("dispatch")
        assert wd._armed is None  # the profiler's tail
        clk.t += 0.2
        wd.device_enter("dispatch")
        assert wd._armed is not None
    finally:
        wd.stop()


def test_the_monitor_never_keeps_a_released_engine(params):
    """The watchdog holds its engine weakly and its monitor thread holds
    the watchdog weakly: a monitor that has not parked yet keeps neither
    a released engine alive nor one a closed serving context hooked (its
    on_trip and on_health reach the context, which holds the engine),
    and it ends with the watchdog."""
    import gc
    import weakref

    eng = port_engine(params)
    ctx = api.ServingContext(eng, MODEL)
    greedy(eng, GenRequest, "w")
    eng.watchdog._deadline_override = 30.0  # arm the monitor
    eng.watchdog.device_enter("dispatch")
    eng.watchdog.device_exit("dispatch")
    monitor = eng.watchdog._monitor
    assert monitor is not None and monitor.is_alive()
    ctx.close()
    ref, wref = weakref.ref(eng), weakref.ref(eng.watchdog)
    del eng, ctx
    gc.collect()
    assert ref() is None and wref() is None
    monitor.join(timeout=5)
    assert not monitor.is_alive()


# ------------------------------------------------ engine-level drills --

def test_fatal_step_inline_resurrection_then_quarantine(params):
    """Mirrors the JAX drill: a fatal step trips and resurrects inline,
    the rebuilt device state generates the same tokens (the JAX engine's
    too), and a second fatal step inside the window quarantines."""
    jeng = jax_engine(params)
    jref = greedy(jeng, JGenRequest, "j0")
    jeng.watchdog.on_fatal_step(RuntimeError("injected fatal step"))
    assert greedy(jeng, JGenRequest, "j1") == jref

    eng = port_engine(params)
    ref = greedy(eng, GenRequest, "r0")
    assert ref == jref
    eng.watchdog.on_fatal_step(RuntimeError("injected fatal step"))
    assert eng.watchdog.health == "healthy"
    assert eng.watchdog.summary()["trips_total"]["fatal_step"] == 1
    assert greedy(eng, GenRequest, "r1") == ref
    evs = [e["ev"] for r in eng.flight.records() for e in r["events"]]
    assert "resurrect_begin" in evs and "resurrect_done" in evs
    eng.watchdog.on_fatal_step(RuntimeError("injected again"))
    assert eng.watchdog.health == "quarantined"
    assert not eng.watchdog.ok_for_traffic


def test_a_poisoned_context_quarantines_without_resurrecting(params,
                                                              monkeypatch):
    """A CUDA error that sticks: the one context probe says poisoned, so
    the first fatal step quarantines and resurrect is never called (it
    could only raise again); the streams still end."""
    eng = port_engine(params)
    calls = []
    monkeypatch.setattr(eng, "device_poisoned", lambda: True)
    monkeypatch.setattr(eng, "resurrect", lambda: calls.append(1))
    eng.add_request(GenRequest("p", list(PROMPT), max_tokens=20,
                               ignore_eos=True))
    eng.step()
    assert eng.num_active == 1
    eng.watchdog.on_fatal_step(RuntimeError("an illegal memory access"))
    assert eng.watchdog.health == "quarantined" and not calls
    assert eng.num_active == 0
    assert eng.watchdog.summary()["last_trip"]["sticky"] is True


@pytest.mark.parametrize("where", ["batched", "single", "chunked"])
def test_nan_sentinel_aborts_exactly_the_poisoned_stream(params, where):
    """engine.device_nan poisons the lead lane of a prefill: that stream
    ends with integrity_fault and no token, the co-batched streams decode
    the same tokens as a fault-free run, health stays healthy; the JAX
    engine's batched drill gives the same streams."""
    rng = np.random.default_rng(7)
    n = 1 if where != "batched" else 4
    plen = 40 if where == "chunked" else 8
    prompts = [rng.integers(1, 256, size=plen).tolist() for _ in range(n)]
    kw = dict(prefill_chunk_tokens=16) if where == "chunked" else {}
    clean = run_all(port_engine(params, **kw), GenRequest, prompts)
    eng = port_engine(params, **kw)
    plane = tfaults.reset_plane()
    try:
        plane.configure({"engine.device_nan": {"times": 1}})
        got = run_all(eng, GenRequest, prompts)
    finally:
        plane.clear()
    assert got["r0"] == ([], "integrity_fault")
    for i in range(1, n):
        assert got[f"r{i}"] == clean[f"r{i}"]
    assert eng.watchdog.summary()["integrity_faults_total"] == {"logits": 1}
    assert eng.watchdog.health == "healthy"
    cached = eng.prefix_cache.evictable() if eng.prefix_cache else 0
    assert eng.allocator.free_pages + cached == KW["num_pages"] - 1
    if where == "batched":
        jeng = jax_engine(params)
        jplane = jfaults.reset_plane()
        try:
            jplane.configure({"engine.device_nan": {"times": 1}})
            jgot = run_all(jeng, JGenRequest, prompts)
        finally:
            jplane.clear()
        assert got == jgot


def test_decode_token_range_sentinel_aborts_one_slot(params, monkeypatch):
    """A corrupted decode readback (a token id outside the vocabulary)
    ends exactly that slot's stream; the other slot decodes on."""
    eng = port_engine(params, num_scheduler_steps=1)
    prompts = [PROMPT, [7, 7, 2, 9, 1]]
    clean = run_all(port_engine(params, num_scheduler_steps=1), GenRequest,
                    prompts)
    real = eng._materialize_window
    state = {"n": 0}

    def corrupt(pw, *a, **k):
        rb = pw[1]
        wait = rb.wait

        def bad_wait():
            out = wait()
            state["n"] += 1
            if state["n"] == 3:
                out[0][:, 0] = eng.model_cfg.vocab_size + 5
            return out

        rb.wait = bad_wait
        try:
            return real(pw, *a, **k)
        finally:
            rb.wait = wait

    monkeypatch.setattr(eng, "_materialize_window", corrupt)
    got = run_all(eng, GenRequest, prompts)
    assert got["r0"][1] == "integrity_fault"
    assert got["r0"][0] == clean["r0"][0][:len(got["r0"][0])]
    assert got["r1"] == clean["r1"]
    assert eng.watchdog.summary()["integrity_faults_total"] == {
        "decode_tokens": 1}


# ------------------------------------------------------------ serving --

def _post(url, body, headers=None, timeout=60):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _get(url, timeout=30):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def chat_body(text, max_tokens=4, **kw):
    return {"model": MODEL, "messages": [{"role": "user", "content": text}],
            "max_tokens": max_tokens, "temperature": 0, "ignore_eos": True,
            **kw}


def _serve(ctx_cls, make, engine):
    ctx = ctx_cls(engine, MODEL)
    srv = make(ctx, host="127.0.0.1", port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return ctx, srv, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def workers(params):
    """A JAX worker and a port worker on the same params."""
    out = {"jax": _serve(japi.ServingContext, japi.make_server,
                         jax_engine(params)),
           "port": _serve(api.ServingContext, api.make_server,
                          port_engine(params))}
    yield out
    for ctx, srv, _ in out.values():
        srv.shutdown()
        ctx.close()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_spent_deadline_sheds_504_without_a_slot(workers, pkg):
    ctx, _, url = workers[pkg]
    before = ctx.engine.metrics.num_requests
    code, body, headers = _post(url + "/v1/chat/completions",
                                chat_body("late"), {"x-deadline": "0"})
    assert code == 504 and b"deadline" in body
    assert headers.get("Retry-After")
    assert ctx.engine.metrics.num_requests == before


def test_deadline_spent_mid_stream_gives_both_workers_504(workers):
    """engine.device_slow stalls a decode readback past the request's
    x-deadline: both workers end the request with 504 (the drain timeout
    is the remaining budget) and abort it engine-side."""
    got = {}
    for pkg, plane_mod in (("jax", jfaults), ("port", tfaults)):
        ctx, _, url = workers[pkg]
        plane = plane_mod.reset_plane()
        plane.configure({"engine.device_slow": {"times": 1,
                                                "delay_s": 0.6}})
        try:
            got[pkg] = _post(url + "/v1/chat/completions",
                             chat_body("stalled", max_tokens=8),
                             {"x-deadline": "0.3"})[0]
        finally:
            plane.clear()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and ctx.engine.has_work:
            time.sleep(0.02)
        assert not ctx.engine.has_work
    assert got == {"jax": 504, "port": 504}


def test_deadline_module_is_the_jax_modules(monkeypatch):
    for mod in (jdeadline, tdeadline):
        monkeypatch.setenv(mod.ENV_DEFAULT, "30")
        d = mod.Deadline.from_headers({"x-deadline": "99"})
        assert d.budget_s == 30.0  # the header only shrinks the budget
        d = mod.Deadline.from_headers({"x-deadline": "junk"})
        assert d.budget_s == 30.0
        assert mod.Deadline(0.0).expired
        assert mod.Deadline(5.0).propagate({})["x-deadline"].startswith(
            "5.0")
        monkeypatch.setenv(mod.ENV_DEFAULT, "-1")
        assert mod.default_budget_s() == mod.DEFAULT_BUDGET_S


def test_fault_plane_route_round_trips_like_the_jax_workers(workers):
    tfaults.reset_plane(seed=0)
    jfaults.reset_plane(seed=0)
    snaps = {}
    for pkg in ("jax", "port"):
        url = workers[pkg][2]
        code, _, _ = _post(url + "/internal/faults",
                           {"seed": 7, "faults": {
                               "engine.device_slow": {"times": 2,
                                                      "delay_s": 0.0}}})
        assert code == 200
        code, body, _ = _post(url + "/internal/faults",
                              {"faults": {"no.such_point": {}}})
        assert code == 400
        code, body = _get(url + "/internal/faults")
        snaps[pkg] = json.loads(body)
        _post(url + "/internal/faults", {"faults": {}})
    assert snaps["port"]["armed"] == snaps["jax"]["armed"] == {
        "engine.device_slow": {"times": 2, "p": 1.0, "after": 0,
                               "delay_s": 0.0}}
    assert snaps["port"]["seed"] == snaps["jax"]["seed"] == 7
    assert snaps["port"]["registry"] == snaps["jax"]["registry"]


def test_fault_plane_draws_replay_the_jax_planes():
    """Seeded probabilistic points fire at the same checks in both."""
    fired = {}
    for pkg, mod in (("jax", jfaults), ("port", tfaults)):
        plane = mod.FaultPlane(seed=11)
        plane.configure({"worker.read_stall": {"times": -1, "p": 0.3,
                                               "after": 2}})
        fired[pkg] = [plane.check("worker.read_stall") is not None
                      for _ in range(50)]
    assert fired["port"] == fired["jax"] and any(fired["port"])


def test_quarantined_worker_sheds_and_fails_readiness(params):
    """Mirrors the JAX drill: /live stays 200 while /ready and /health go
    503, /v1 sheds 503 with Retry-After, a rollout is refused fast, and
    /worker/stats and /metrics still report the state."""
    eng = port_engine(params)
    ctx, srv, url = _serve(api.ServingContext, api.make_server, eng)
    try:
        assert _get(url + "/ready")[0] == 200
        eng.watchdog.trip("hung_dispatch", seam="dispatch", escalate=False)
        eng.watchdog.trip("hung_dispatch", seam="dispatch", escalate=False)
        assert eng.watchdog.health == "quarantined"
        assert _get(url + "/live")[0] == 200
        assert _get(url + "/ready")[0] == 503
        assert _get(url + "/health")[0] == 503
        code, body, headers = _post(url + "/v1/chat/completions",
                                    chat_body("shed me"))
        assert code == 503 and headers.get("Retry-After")
        assert b"quarantined" in body
        assert _post(url + "/internal/rollout",
                     {"action": "status"})[0] == 503
        st, body = _get(url + "/worker/stats")
        assert json.loads(body)["health"]["state"] == "quarantined"
        st, body = _get(url + "/metrics")
        assert b"dynamo_engine_health 3" in body
        assert b'dynamo_engine_watchdog_trips_total{kind="hung_dispatch"} 2' \
            in body
    finally:
        srv.shutdown()
        ctx.close()


def test_drain_sheds_new_requests_while_in_flight_streams_finish(params):
    eng = port_engine(params)
    ctx, srv, url = _serve(api.ServingContext, api.make_server, eng)
    try:
        ref = json.loads(_post(url + "/v1/chat/completions",
                               chat_body("drain me", max_tokens=24))[1])
        result = {}

        def run():
            result["r"] = _post(url + "/v1/chat/completions",
                                chat_body("drain me", max_tokens=24))

        t = threading.Thread(target=run)
        t.start()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not eng.seqs:
            time.sleep(0.005)
        code, body, _ = _post(url + "/internal/drain", {})
        assert code == 200 and json.loads(body)["draining"]
        code, body, headers = _post(url + "/v1/chat/completions",
                                    chat_body("too late"))
        assert code == 503 and headers.get("Retry-After")
        t.join(timeout=60)
        code, body, _ = result["r"]
        assert code == 200
        assert json.loads(body)["choices"] == ref["choices"]
        assert json.loads(_get(url + "/worker/stats")[1])["draining"]
        assert ctx.drain(drain_s=5.0, handoff_grace_s=1.0)
    finally:
        srv.shutdown()
        ctx.close()


def test_reclaim_drains_under_the_notice_deadline(params):
    eng = port_engine(params)
    ctx, srv, url = _serve(api.ServingContext, api.make_server, eng)
    try:
        code, body, _ = _post(url + "/internal/reclaim?deadline_s=2", {})
        out = json.loads(body)
        assert code == 200 and out["first_notice"] and out["reclaiming"]
        assert out["deadline_s"] == 2.0
        again = json.loads(_post(url + "/internal/reclaim", {})[1])
        assert not again["first_notice"]
        assert ctx.reclaim_done.wait(10)
        assert _post(url + "/v1/chat/completions", chat_body("x"))[0] == 503
        assert _post(url + "/internal/reclaim?deadline_s=-1", {})[0] == 400
        evs = [e["ev"] for r in eng.flight.records() for e in r["events"]]
        assert "reclaim" in evs
    finally:
        srv.shutdown()
        ctx.close()


# ------------------------------- a hung dispatch behind the JAX frontend --

def _sse_content(body):
    events = [b.strip()[len("data: "):] for b in body.split("\n\n")
              if b.strip().startswith("data: ")]
    assert events and events[-1] == "[DONE]", "stream must COMPLETE"
    return "".join((c.get("delta") or {}).get("content") or ""
                   for e in events if e != "[DONE]"
                   for c in json.loads(e)["choices"])


def test_hung_dispatch_handoff_resume_and_resurrection(params):
    """The JAX drill on two port workers behind the JAX frontend: a hang
    on worker A outlasts its deadline, the monitor trips it (suspect,
    shedding), the in-flight stream hands off mid-decode and resumes on
    peer B with the same content, and once the hang returns the lock A
    resurrects in place and serves the same content again."""
    plane = tfaults.reset_plane()
    eng_a = port_engine(params)
    eng_b = port_engine(params)
    ctx_a, srv_a, url_a = _serve(api.ServingContext, api.make_server, eng_a)
    ctx_b, srv_b, url_b = _serve(api.ServingContext, api.make_server, eng_b)
    fctx = FrontendContext(router=Router())
    fsrv = make_frontend_server(fctx, "127.0.0.1", 0)
    threading.Thread(target=fsrv.serve_forever, daemon=True).start()
    front = f"http://127.0.0.1:{fsrv.server_address[1]}"

    def register(url):
        _post(front + "/internal/register", {
            "url": url, "model": MODEL, "mode": "agg",
            "stats": {"max_num_seqs": 4, "free_pages": 100,
                      "total_pages": 128}})

    wd = eng_a.watchdog
    body = chat_body("hang the device", max_tokens=12, stream=True)
    try:
        register(url_a)
        ref = _sse_content(_post(front + "/v1/chat/completions",
                                 body)[1].decode())
        wd._deadline_override = 0.6
        plane.configure({"engine.device_hang": {"times": 1,
                                                "delay_s": 2.5}})
        result = {}

        def run():
            result["r"] = _post(front + "/v1/chat/completions", body,
                                timeout=60)

        t = threading.Thread(target=run, daemon=True)
        t.start()
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and not eng_a.has_work:
            time.sleep(0.01)
        assert eng_a.has_work, "the drill stream never reached worker A"
        register(url_b)  # the peer is there before the trip fires
        t.join(timeout=60)
        code, raw, _ = result["r"]
        assert code == 200
        assert _sse_content(raw.decode()) == ref
        assert wd.summary()["trips_total"].get("hung_dispatch", 0) >= 1
        assert eng_b.metrics.num_requests >= 1  # resumed on the peer
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline and wd.health != "healthy":
            time.sleep(0.05)
        assert wd.health == "healthy", f"A stuck {wd.health}"
        direct = json.loads(_post(url_a + "/v1/chat/completions",
                                  dict(body, stream=False))[1])
        assert direct["choices"][0]["message"]["content"] == ref
    finally:
        plane.clear()
        wd._deadline_override = None
        fsrv.shutdown()
        for srv, ctx in ((srv_a, ctx_a), (srv_b, ctx_b)):
            srv.shutdown()
            ctx.close()


# ------------------------------------------------------------ the CLI --

def test_unported_worker_flags_are_refused_by_name():
    # --nats-url is served (the frontend tier's request and KV event
    # planes): tests/test_torch_frontend_e2e.py runs it; --prefill-url and
    # --kvbm-peers are served (the disagg decode role and the KVBM's peer
    # pull: tests/test_torch_disagg*.py)
    for flag, value in (("--coordinator", "h:2"),
                        ("--num-processes", "2"), ("--process-id", "1")):
        with pytest.raises(NotImplementedError, match=flag):
            tworker.main(["--device", "cpu", flag, value])
    args = tworker.build_parser("jetstream").parse_args(
        ["--prefill-url", "http://p:1", "--kvbm-peers", "h:1",
         "--coordinator", "h:2"])
    assert tworker.unported_flags(args) == ["--coordinator"]


class _FakeFrontend(http.server.BaseHTTPRequestHandler):
    posts: list = []

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        type(self).posts.append((self.path, json.loads(self.rfile.read(n))))
        self.send_response(200)
        self.send_header("Content-Length", "2")
        self.end_headers()
        self.wfile.write(b"{}")

    def log_message(self, *a):
        pass


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_worker_cli_heartbeats_serves_and_deregisters_on_sigterm():
    """`python -m dynamo_tpu_torch.jetstream --device cpu --frontend-url`:
    it registers with the JAX worker's heartbeat payload, serves, and on
    SIGTERM drains, deregisters and exits 0."""
    fe = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _FakeFrontend)
    threading.Thread(target=fe.serve_forever, daemon=True).start()
    fe_url = f"http://127.0.0.1:{fe.server_address[1]}"
    port = _free_port()
    env = dict(os.environ, DRAIN_TIMEOUT_S="10", DRAIN_HANDOFF_GRACE_S="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.jetstream", "--device",
         "cpu", "--model", MODEL, "--host", "127.0.0.1", "--port",
         str(port), "--page-size", "4", "--num-pages", "64",
         "--max-num-seqs", "2", "--max-seq-len", "64", "--frontend-url",
         fe_url, "--heartbeat-interval", "0.5"],
        env=env, cwd=os.path.dirname(os.path.dirname(os.path.abspath(
            __file__))), stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            assert proc.poll() is None, proc.stderr.read().decode()[-2000:]
            try:
                if _get(url + "/ready", timeout=2)[0] == 200:
                    break
            except OSError:
                pass
            time.sleep(0.2)
        code, body, _ = _post(url + "/v1/chat/completions", chat_body("hi"))
        assert code == 200
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not any(
                p == "/internal/register" for p, _ in _FakeFrontend.posts):
            time.sleep(0.1)
        beats = [b for p, b in _FakeFrontend.posts
                 if p == "/internal/register"]
        assert beats and beats[0]["url"] == url
        assert {"active_seqs", "pending", "free_pages", "total_pages",
                "max_num_seqs", "weight_version", "costs", "timeline",
                "health"} <= set(beats[0]["stats"])
        assert beats[0]["stats"]["health"]["state"] == "healthy"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, proc.stderr.read().decode()[-2000:]
        assert ("/internal/deregister", {"url": url}) in _FakeFrontend.posts
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        fe.shutdown()
