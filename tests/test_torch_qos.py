"""Per-tenant QoS: the port against the JAX package, on the CPU.

- The registry, accountant and admission (`qos/tenancy.py`, the port's
  copy) give the JAX functions' answers on the same inputs: the cases of
  the JAX package's `tests/test_qos.py` (resolution order, dynamic ids
  and their bound, config validation, work conservation, an aggressor's
  debt and refill, slot caps, in-flight caps, Retry-After, over-share).
- The engine's weighted-fair scheduling: an aggressor flooding at 5x a
  well-behaved tenant's requests through both engines on the same params
  (tiny-debug, float32, the JAX params carried across) gives the same
  admissions, deferrals and preemption victims in the same order (the
  flight recorder's events), the same tokens (exactly) and the same
  `qos.stats()`; with a batch class the interactive tenant's return
  evicts the batch streams in the same order.
- Tenant tags leave greedy tokens unchanged.
- The worker resolves the tenant from the headers and observes
  `dynamo_tenant_requests_total` and the tenant TTFT and ITL histograms
  as the JAX worker does; `/worker/stats` has `qos`.
"""

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
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import PRESETS as JPRESETS
from dynamo_tpu.qos import tenancy as jtenancy
from dynamo_tpu.serving import api as japi
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import Engine
from dynamo_tpu_torch.engine.request import GenRequest
from dynamo_tpu_torch.qos import tenancy
from dynamo_tpu_torch.serving import api

MODEL = "tiny-debug"
TENANT_SPECS = [
    {"name": "acme", "weight": 3, "priority": 0, "api_keys": ["sk-acme-1"]},
    {"name": "good", "weight": 1, "priority": 0},
    {"name": "agg", "weight": 1, "priority": 5, "max_inflight": 2},
]
TENANTS_JSON = json.dumps(TENANT_SPECS)


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


def _np(params):
    return {k: np.asarray(v) for k, v in params.items()}


def both(script):
    """`script(module)` through the JAX module and the port's copy: the
    port's answers, once they are asserted equal."""
    want = script(jtenancy)
    got = script(tenancy)
    assert got == want
    return got


# ------------------------------------------------------------ identity --

def test_registry_resolution_order_matches_jax():
    def script(t):
        reg = t.TenantRegistry.from_json(TENANTS_JSON)
        hdrs = {t.RESOLVED_HEADER: "acme"}
        return [reg.enabled,
                reg.resolve({"x-tenant-id": "good"}),
                reg.resolve({"x-api-key": "sk-acme-1"}),
                reg.resolve({"authorization": "Bearer sk-acme-1"}),
                reg.resolve({"x-api-key": "nope"}), reg.resolve({}),
                reg.resolve(hdrs), reg.resolve(hdrs, trusted=True),
                reg.resolve({"x-tenant-id": "good",
                             "x-api-key": "sk-acme-1"}),
                reg.describe(), reg.batch_tenants()]
    got = both(script)
    assert got[1:9] == ["good", "acme", "acme", "default", "default",
                        "default", "acme", "good"]
    assert tenancy.RESOLVED_HEADER == "x-dynamo-tenant"
    assert tenancy.TENANTS_ENV == "DYNAMO_TPU_TENANTS"
    for name in ("OVER_BUDGET_PENALTY", "BATCH_PRIORITY_PENALTY",
                 "BATCH_VICTIM_PENALTY", "PRIORITY_MIN", "PRIORITY_MAX",
                 "MAX_DYNAMIC_TENANTS", "OTHER_TENANT", "DEFAULT_TENANT"):
        assert getattr(tenancy, name) == getattr(jtenancy, name)


def test_registry_dynamic_ids_bounded_and_sanitized_match_jax():
    def script(t):
        reg = t.TenantRegistry.from_json(TENANTS_JSON)
        out = [reg.resolve({"x-tenant-id": "new-cust-7"}),
               reg.cls("new-cust-7").weight,
               reg.resolve({"x-tenant-id": 'x"evil\n'}),
               reg.resolve({"x-tenant-id": "a" * 200})]
        for i in range(t.MAX_DYNAMIC_TENANTS + 5):
            out.append(reg.resolve({"x-tenant-id": f"dyn-{i}"}))
        return out + [reg.resolve({"x-tenant-id": "one-too-many"})]
    got = both(script)
    assert got[:4] == ["new-cust-7", 1.0, "default", "default"]
    assert got[-1] == tenancy.OTHER_TENANT


@pytest.mark.parametrize("spec", [
    {"name": "x", "bogus": 1}, {"name": "x", "weight": 0},
    {"name": "x", "priority": 10 ** 6}, {"weight": 2},
    {"name": "x", "batch": "yes"}, {"name": "bad name!"},
    {"name": "x", "maxInflight": 9, "apiKeys": ["k"], "burstTokens": 0,
     "batch": True, "priority": -3, "weight": 2.5},
])
def test_tenant_specs_validate_like_jax(spec):
    def script(t):
        try:
            return t.tenant_from_dict(spec).to_dict()
        except ValueError as e:
            return ("ValueError", str(e))
    both(script)


def test_malformed_config_disables_qos_like_jax():
    def script(t):
        return [t.TenantRegistry.from_json(raw).enabled
                for raw in ("{oops", None, "[]", '{"name": "a"}',
                            TENANTS_JSON)] + [
            t.TenantRegistry.from_env(
                {t.TENANTS_ENV: TENANTS_JSON}).enabled]
    assert both(script) == [False, False, False, False, True, True]


# ---------------------------------------------------------- accountant --

def test_accountant_budgets_match_jax():
    def script(t):
        reg = t.TenantRegistry.from_json(TENANTS_JSON)
        solo = t.TenantAccountant(reg)
        for _ in range(100):
            solo.account({"agg": 7}, {"agg"})
        acct = t.TenantAccountant(reg, burst_tokens=64)
        out = [solo.over_budget("agg"), solo.stats()]
        for _ in range(20):
            acct.account({"agg": 3, "good": 1}, {"agg", "good"})
        out += [acct.over_budget("agg"), acct.over_budget("good")]
        for _ in range(200):
            acct.account({"agg": 3, "good": 1}, {"agg", "good"})
        out.append(acct.stats())
        for _ in range(200):
            acct.account({"good": 2}, {"agg", "good"})
        acct.note_preempt("agg")
        acct.note_defer("agg")
        out += [acct.over_budget("agg"), acct.stats()]
        out += [acct.slot_cap(n, s, d) for n, s, d in (
            ("acme", 8, {"acme", "good"}), ("good", 8, {"acme", "good"}),
            ("good", 8, {"good"}), ("good", 2, {"acme", "good"}))]
        return out
    got = both(script)
    assert got[0] is False and got[1]["balance"]["agg"] == 0.0
    assert got[2:4] == [True, False]
    assert got[4]["balance"]["agg"] >= -64.0
    assert got[5] is False
    assert got[-4:] == [6, 2, 8, 1]


# ----------------------------------------------------------- admission --

def test_admission_matches_jax():
    def script(t):
        reg = t.TenantRegistry.from_json(TENANTS_JSON)
        adm = t.TenantAdmission(reg, global_max=10)
        out = [adm.cap("agg"), adm.cap("acme"), adm.try_admit("agg"),
               adm.try_admit("agg"), adm.try_admit("agg"),
               adm.try_admit("acme")]
        adm.release("agg", duration_s=8.0)
        out += [adm.try_admit("agg"), adm.retry_after_s("agg")]
        adm.release("agg", duration_s=10 ** 6)
        out += [adm.retry_after_s("agg"), adm.snapshot()]
        share = t.TenantAdmission(reg, global_max=0)
        for _ in range(6):
            share.try_admit("agg")
        share.try_admit("good")
        out += [share.over_share("agg"), share.over_share("good")]
        share.admit_unchecked("acme")
        out += [share.over_share("good"), share.snapshot()]
        return out
    got = both(script)
    assert got[:6] == [2, 6, True, True, False, True]
    assert got[7] == pytest.approx(4.0, rel=0.01) and got[8] <= 30.0
    assert got[10:13] == [True, False, True]


# -------------------------------------------------- engine WFQ parity --

FLIGHT_EVENTS = ("admit", "chunk_start", "defer", "qos_preempt", "preempt")


def _flood(params, pkg, tenants):
    """The JAX QoS suite's flood: one aggressor with 10 requests submitted
    first against a well-behaved tenant's 2, equal weights, 2 slots.
    -> (engine, tokens by rid, finish order, flight decisions)."""
    cfg = dict(model=MODEL, page_size=4, num_pages=40, max_num_seqs=2,
               max_seq_len=64, seed=11, enable_prefix_caching=False,
               tenants=json.dumps(tenants))
    if pkg == "jax":
        eng = JEngine(JEngineConfig(**cfg), params=params)
        make_req = JGenRequest
    else:
        eng = Engine(EngineConfig(**cfg), params=_np(params), device="cpu")
        make_req = GenRequest
    names = [t["name"] for t in tenants]
    for i in range(10):
        eng.add_request(make_req(f"{names[0]}{i}", [3 + i, 1, 4, 1, 5],
                                 max_tokens=12, ignore_eos=True,
                                 tenant=names[0]))
    for i in range(2):
        eng.add_request(make_req(f"{names[1]}{i}", [2 + i, 7, 1, 8],
                                 max_tokens=12, ignore_eos=True,
                                 tenant=names[1]))
    out, order = {}, []
    while eng.has_work:
        for ev in eng.step():
            if ev.token_id >= 0:
                out.setdefault(ev.request_id, []).append(ev.token_id)
            if ev.finished:
                order.append(ev.request_id)
    decisions = [
        {k: v for k, v in e.items()}
        for rec in eng.flight.records() for e in rec.get("events", ())
        if e.get("ev") in FLIGHT_EVENTS]
    return eng, out, order, decisions


WFQ = [{"name": "agg", "weight": 1}, {"name": "good", "weight": 1}]
BATCH = [{"name": "offline", "weight": 1, "batch": True},
         {"name": "chat", "weight": 1}]


@pytest.mark.parametrize("tenants", [WFQ, BATCH], ids=["wfq", "batch"])
def test_engine_scheduling_matches_jax(params, tenants):
    jeng, jout, jorder, jdec = _flood(params, "jax", tenants)
    eng, out, order, dec = _flood(params, "port", tenants)
    assert out == jout
    assert order == jorder
    assert dec == jdec
    assert eng.qos.stats() == jeng.qos.stats()
    assert eng.metrics.num_preempted == jeng.metrics.num_preempted
    for rid, toks in out.items():
        assert len(toks) == 12, rid  # preempted, never starved or killed
    st = eng.qos.stats()
    assert (st["deferred_total"].get(tenants[0]["name"], 0)
            + st["preempted_total"].get(tenants[0]["name"], 0)) > 0
    if tenants is WFQ:
        # isolation: the good tenant finishes among the first four
        assert {"good0", "good1"} <= set(order[:4]), order
    else:
        assert any(d["ev"] == "qos_preempt"
                   and d["reason"] == "interactive_return" for d in dec)
    # the cost ledger prices the batch class as its own tier
    tiers = eng.cost.rollup().get("tiers", {})
    assert set(tiers) == set(jeng.cost.rollup().get("tiers", {}))


def test_tenant_tags_leave_greedy_tokens_unchanged(params):
    kw = dict(model=MODEL, page_size=4, num_pages=128, max_num_seqs=4,
              max_seq_len=128, seed=11)
    base = Engine(EngineConfig(**kw, tenants="[]"), params=_np(params),
                  device="cpu")
    assert base.qos is None
    prompt = [3, 1, 4, 1, 5, 9]
    ref = base.generate(GenRequest("r", prompt, max_tokens=16,
                                   ignore_eos=True))
    qos = Engine(EngineConfig(**kw, tenants=TENANTS_JSON),
                 params=base.model, device="cpu")
    assert qos.qos is not None
    got = qos.generate(GenRequest("r", prompt, max_tokens=16,
                                  ignore_eos=True, tenant="acme"))
    assert got == ref
    jeng = JEngine(JEngineConfig(**kw, tenants=TENANTS_JSON), params=params)
    assert jeng.generate(JGenRequest("r", prompt, max_tokens=16,
                                     ignore_eos=True, tenant="acme")) == ref


def test_request_tenants_are_kept_only_while_they_run(params):
    """The engine books a request's tenant for its budget only with QoS
    on, and forgets it when the request ends: a worker without tenants
    keeps nothing per request, one with tenants nothing once drained."""
    kw = dict(model=MODEL, page_size=4, num_pages=128, max_num_seqs=4,
              max_seq_len=128, seed=11)
    for tenants in ("[]", TENANTS_JSON):
        eng = Engine(EngineConfig(**kw, tenants=tenants), params=_np(params),
                     device="cpu")
        for i in range(3):
            eng.add_request(GenRequest(f"r{i}", [3 + i, 1, 4], max_tokens=3,
                                       ignore_eos=True, tenant="acme"))
        assert len(eng._rid_tenant) == (0 if eng.qos is None else 3)
        while eng.has_work:
            eng.step()
        assert eng._rid_tenant == {}


# ------------------------------------------------------------- serving --

def _post(url, body, headers):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **headers})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.read().decode()


def _tenant_series(page):
    """{(name, tenant): value} of the tenant counter and the histograms'
    _count samples."""
    out = {}
    for line in page.splitlines():
        for name in ("dynamo_tenant_requests_total",
                     "dynamo_tenant_time_to_first_token_seconds_count",
                     "dynamo_tenant_inter_token_latency_seconds_count"):
            if line.startswith(name + "{"):
                tenant = line.split('tenant="')[1].split('"')[0]
                out[(name, tenant)] = float(line.rsplit(" ", 1)[1])
    return out


@pytest.mark.parametrize("stream", [False, True])
def test_worker_observes_tenant_series_like_jax(params, stream):
    """Requests tagged by x-tenant-id, by an API key, by the frontend's
    trusted header and untagged, through both workers: the same tenant
    series and `qos` section; the untagged request is `default`."""
    cases = [({"x-tenant-id": "good"}, 2), ({"x-api-key": "sk-acme-1"}, 1),
             ({"x-dynamo-tenant": "agg"}, 1), ({}, 1)]
    kw = dict(model=MODEL, page_size=4, num_pages=128, max_num_seqs=4,
              max_seq_len=128, tenants=TENANTS_JSON)
    pages, stats = {}, {}
    for pkg, ctx_cls, make, eng in (
            ("jax", japi.ServingContext, japi.make_server,
             JEngine(JEngineConfig(**kw), params=params)),
            ("port", api.ServingContext, api.make_server,
             Engine(EngineConfig(**kw), params=_np(params), device="cpu"))):
        ctx = ctx_cls(eng, MODEL)
        srv = make(ctx, host="127.0.0.1", port=0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            for headers, n in cases:
                for i in range(n):
                    body = {"model": MODEL, "prompt": f"hello {i}",
                            "max_tokens": 4, "temperature": 0,
                            "ignore_eos": True, "stream": stream}
                    req = urllib.request.Request(
                        base + "/v1/completions",
                        data=json.dumps(body).encode(),
                        headers={"Content-Type": "application/json",
                                 **headers})
                    with urllib.request.urlopen(req, timeout=120) as r:
                        r.read()
            pages[pkg] = _tenant_series(_get(base + "/metrics"))
            qos = json.loads(_get(base + "/worker/stats"))["qos"]
            stats[pkg] = {k: qos[k] for k in ("tokens_total",
                                              "burst_tokens")}
        finally:
            srv.shutdown()
            ctx.close()
    assert pages["port"] == pages["jax"]
    assert stats["port"] == stats["jax"]
    got = pages["port"]
    for tenant, n in (("good", 2), ("acme", 1), ("agg", 1),
                      ("default", 1)):
        assert got[("dynamo_tenant_requests_total", tenant)] == n
        assert got[("dynamo_tenant_time_to_first_token_seconds_count",
                    tenant)] == n
    assert stats["port"]["tokens_total"] == {"acme": 4, "agg": 4,
                                             "default": 4, "good": 8}
