"""The port's control plane against the JAX package's, and rehearsed on
the CPU:

- the port's roofline `estimate`, given a catalog built from the JAX
  catalog's numbers and the JAX module's utilization factors, equals the
  JAX `estimate` (the formula is the same; only the catalog and the
  factors differ);
- the planner's `Simulator` makes the same decisions in both packages
  over scenarios and pools hypothesis draws;
- `parse_metrics_text` and the history scrape read every planner input
  from a live port frontend's and a CPU worker's pages;
- a CPU rehearsal of `chip_smoke.py --fleet` (phase 21): a DGDR in the
  fake apiserver, `python -m dynamo_tpu_torch.operator --once`, the
  materialized frontend and worker (`--device cpu`, tiny-debug) spawned by
  a kubelet of one (tests/fake_kubelet.py), a chat through them, a planner
  scale-up from the live frontend's metrics under a burst, and the drain
  victim's `/internal/drain` reaching the worker.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.planner import planner as jax_planner
from dynamo_tpu.planner import scenarios as jax_scenarios
from dynamo_tpu.planner import sim as jax_sim
from dynamo_tpu.planner.capacity import PoolCapacity as JaxPoolCapacity
from dynamo_tpu.profiler import roofline as jax_roofline
from dynamo_tpu.profiler import systems as jax_systems
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.planner import planner as port_planner
from dynamo_tpu_torch.planner import scenarios as port_scenarios
from dynamo_tpu_torch.planner import sim as port_sim
from dynamo_tpu_torch.planner.capacity import PoolCapacity
from dynamo_tpu_torch.planner.signals import (Forecaster, SignalsCollector,
                                              parse_metrics_text)
from dynamo_tpu_torch.profiler import roofline, systems

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------- estimate --

JAX_FACTORS = roofline.Factors(
    jax_roofline.MFU_PREFILL, jax_roofline.MFU_DECODE, jax_roofline.HBM_EFF,
    jax_roofline.ICI_EFF, jax_roofline.DISPATCH_OVERHEAD_S)


def port_system(name: str) -> systems.SystemSpec:
    """The JAX catalog's system as the port's SystemSpec: the same peaks,
    its ICI links in the NVLink fields."""
    s = jax_systems.get_system(name)
    c = s.chip
    chip = systems.ChipSpec(c.name, c.bf16_flops, c.hbm_bytes, c.hbm_bw,
                            c.ici_link_bw, c.ici_links, c.chips_per_host)
    return systems.SystemSpec(s.name, chip, s.num_chips)


@pytest.mark.parametrize("model", [
    "llama-3.1-8b-instruct", "llama-3.2-1b-instruct",
    "meta-llama-3-70b-instruct", "qwen3-30b-a3b",
    "mixtral-8x7b-instruct-v0.1", "deepseek-v2-lite", "gemma-2-9b-it",
    "phi-3-mini-4k-instruct"])
@pytest.mark.parametrize("system", ["v5e-1", "v5e-8", "v5p-16", "v6e-4"])
def test_estimate_equals_jax_on_jax_catalog_and_factors(model, system):
    jcfg = JaxModelConfig.from_model_name(model)
    pcfg = ModelConfig.from_model_name(model)
    jsys, psys = jax_systems.get_system(system), port_system(system)
    assert jax_systems.valid_tp_sizes(jsys) == systems.valid_tp_sizes(psys)
    for tp in systems.valid_tp_sizes(psys):
        for batch in (1, 16, 256):
            for quant, kvd in roofline.QUANT_TIERS:
                for isl, osl in ((4000, 500), (128, 2048)):
                    want = jax_roofline.estimate(jcfg, jsys, tp, batch, isl,
                                                 osl, quant, kvd)
                    got = roofline.estimate(pcfg, psys, tp, batch, isl, osl,
                                            quant, kvd,
                                            factors=JAX_FACTORS)
                    assert dataclasses.asdict(got) == \
                        dataclasses.asdict(want), (tp, batch, quant, kvd)


def test_card_factors_are_the_cards_not_the_tpus():
    f = roofline.CARD_FACTORS
    assert (f.mfu_prefill, f.mfu_decode, f.hbm_eff, f.dispatch_s) != (
        JAX_FACTORS.mfu_prefill, JAX_FACTORS.mfu_decode,
        JAX_FACTORS.hbm_eff, JAX_FACTORS.dispatch_s)
    for v in (f.mfu_prefill, f.mfu_decode, f.hbm_eff, f.link_eff):
        assert 0.0 < v <= 1.0
    assert f.dispatch_s >= 0.0


# ------------------------------------------------------------ simulator --

def _sim(pkg, draw):
    planner, sim, scenarios = pkg
    cap = (JaxPoolCapacity if planner is jax_planner else PoolCapacity)
    prefill = planner.PoolSpec(
        name="prefill", role="prefill",
        capacity=cap(prompts_per_s=draw["prompts"], tokens_per_s=0.0,
                     max_streams=0),
        min_replicas=draw["lo"], max_replicas=draw["hi"],
        target_utilization=draw["util"], osl=draw["osl"],
        scale_down_delay_s=draw["delay"], coordinate_with="decode",
        forecast_horizon_s=draw["horizon"])
    decode = planner.PoolSpec(
        name="decode", role="decode",
        capacity=cap(prompts_per_s=0.0, tokens_per_s=draw["tokens"],
                     max_streams=draw["streams"], itl_s=0.05),
        min_replicas=draw["lo"], max_replicas=draw["hi"],
        target_utilization=draw["util"], osl=draw["osl"],
        scale_down_delay_s=draw["delay"],
        forecast_horizon_s=draw["horizon"])
    scen = getattr(scenarios, draw["scenario"])(
        base_rps=draw["base"], peak_rps=draw["base"] * draw["ratio"],
        duration_s=draw["duration"], osl=draw["osl"])
    return sim.Simulator(
        scen, [sim.SimPoolCfg(prefill, provision_delay_s=draw["provision"],
                              drain_s=10.0, hitless=draw["hitless"]),
               sim.SimPoolCfg(decode, provision_delay_s=draw["provision"],
                              drain_s=10.0, hitless=draw["hitless"])],
        planner.PoolPlanner([prefill, decode],
                            coordinate=draw["coordinate"]),
        ttft_slo_s=2.5, itl_slo_s=0.1, goal=0.99,
        forecaster=(jax_sim if planner is jax_planner else port_sim)
        .Forecaster(alpha=0.5, beta=0.5, bucket_s=10.0))


@settings(max_examples=12, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.fixed_dictionaries({
    "scenario": st.sampled_from(["flash_crowd", "diurnal"]),
    "base": st.floats(1.0, 12.0), "ratio": st.floats(1.0, 10.0),
    "duration": st.sampled_from([300.0, 480.0]),
    "osl": st.integers(16, 256), "prompts": st.floats(2.0, 20.0),
    "tokens": st.floats(200.0, 4000.0), "streams": st.integers(4, 64),
    "lo": st.integers(1, 3), "hi": st.integers(3, 12),
    "util": st.floats(0.3, 1.0), "delay": st.sampled_from([0.0, 30.0, 60.0]),
    "horizon": st.sampled_from([30.0, 60.0, 90.0]),
    "provision": st.sampled_from([0.0, 30.0]),
    "hitless": st.booleans(), "coordinate": st.booleans(),
}))
def test_simulator_decisions_equal_jax(draw):
    jax_report = _sim((jax_planner, jax_sim, jax_scenarios), draw).run()
    port_report = _sim((port_planner, port_sim, port_scenarios), draw).run()
    assert port_report.decisions == jax_report.decisions
    assert port_report.summary() == jax_report.summary()


# -------------------------------------------------------------- signals --

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(url: str, headers=None):
    req = urllib.request.Request(url, headers=headers or {})
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.read().decode()


def _post(url: str, body: dict, headers=None) -> str:
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.read().decode()


def _wait(cond, timeout: float, what: str) -> None:
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        try:
            if cond():
                return
        except OSError:
            pass
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


TENANTS = [{"name": "fleet", "weight": 1, "apiKeys": ["sk-fleet"]}]
AUTH = {"Authorization": "Bearer sk-fleet"}


def test_signals_from_a_live_port_frontend_and_worker(monkeypatch):
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import Engine
    from dynamo_tpu_torch.serving import frontend as fe_mod
    from dynamo_tpu_torch.serving.api import ServingContext, make_server
    from dynamo_tpu_torch.serving.router import Router

    monkeypatch.setenv("DYNAMO_TPU_TENANTS", json.dumps(TENANTS))
    monkeypatch.setenv("DYNAMO_TPU_SLO_TTFT_MS", "1")
    monkeypatch.setenv("DYNAMO_TPU_SLO_ITL_MS", "1")
    eng = Engine(EngineConfig(model="tiny-debug", page_size=16,
                              num_pages=64, max_num_seqs=2,
                              max_seq_len=256), device="cpu")
    ctx = ServingContext(eng, "tiny-debug")
    srv = make_server(ctx, host="127.0.0.1", port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    worker = f"http://127.0.0.1:{srv.server_address[1]}"
    fctx = fe_mod.FrontendContext(Router(heartbeat_ttl=float("inf")))
    fsrv = fe_mod.make_frontend_server(fctx, "127.0.0.1", 0)
    threading.Thread(target=fsrv.serve_forever, daemon=True).start()
    fe = f"http://127.0.0.1:{fsrv.server_address[1]}"
    try:
        _post(fe + "/internal/register", {
            "url": worker, "model": "tiny-debug", "mode": "agg",
            "stats": {"max_num_seqs": 2, "free_pages": 60,
                      "total_pages": 64}})
        chat = {"model": "tiny-debug", "max_tokens": 8, "temperature": 0.0,
                "ignore_eos": True, "stream": True,
                "messages": [{"role": "user", "content": "hi"}]}
        _post(fe + "/v1/chat/completions", chat, AUTH)
        # then a stream held in flight while both pages are read
        held = threading.Thread(target=_post, args=(
            fe + "/v1/chat/completions", dict(chat, max_tokens=200), AUTH))
        held.start()
        _wait(lambda: parse_metrics_text(_get(fe + "/metrics"))[
            "tenant_inflight"] == {"fleet": 1.0}, 30, "the stream in flight")
        pages = {"frontend": _get(fe + "/metrics"),
                 "worker": _get(worker + "/metrics")}
        held.join(timeout=120)
        keys = {"queued", "burn", "burn_ttft", "burn_itl", "inflight",
                "tenant_inflight", "quarantined", "quarantined_workers"}
        got = {k: parse_metrics_text(p) for k, p in pages.items()}
        for name, parsed in got.items():
            assert set(parsed) == keys, name
            # the 1 ms objectives burn on every request: the 5m rows read
            assert parsed["burn_ttft"] > 1.0 and parsed["burn_itl"] > 1.0, \
                (name, parsed)
            assert parsed["burn"] == max(parsed["burn_ttft"],
                                         parsed["burn_itl"])
        # the frontend's requests in flight and its tenants; the worker's
        # own queue gauge (its dynamo_frontend_* series: none waits there)
        assert got["frontend"]["queued"] == 1.0
        assert got["worker"]["queued"] == 0.0
        assert got["frontend"]["tenant_inflight"] == {"fleet": 1.0}
        assert got["frontend"]["inflight"] == 1.0
        assert got["frontend"]["quarantined"] == 0
        assert got["frontend"]["quarantined_workers"] == []
        assert 'dynamo_frontend_worker_health{worker="' + worker in \
            pages["frontend"]
        # the history ring, through the collector the controller uses
        for base in (fe, worker):
            payload = SignalsCollector().scrape_history(
                base + "/debug/slo?history=1")
            assert payload["bucket_s"] > 0
            assert sum(r["requests"] for r in payload["history"]) >= 1
            fc = Forecaster(bucket_s=payload["bucket_s"])
            fc.ingest_history(payload["history"], payload["bucket_s"])
            assert fc.rate() >= 0.0
    finally:
        fsrv.shutdown()
        srv.shutdown()
        ctx.close()


# ----------------------------------------------------- phase 21 rehearsal --

NS = "fleet-ns"


def _dgdr_objects(fe_url: str, worker_args: list):
    from dynamo_tpu_torch.operator import materialize as mat

    template = {
        "apiVersion": mat.API_VERSION, "kind": mat.DGD_KIND,
        "metadata": {"name": "fleet"},
        "spec": {"services": {
            "Frontend": {"componentType": "frontend", "replicas": 1,
                         "tenants": TENANTS},
            "DecodeWorker": {
                "componentType": "worker", "replicas": 1,
                "tenants": TENANTS, "kvbmHostBlocks": 8,
                "drainSeconds": 2,
                "extraPodSpec": {"mainContainer": {
                    "command": ["python3", "-m",
                                "dynamo_tpu_torch.jetstream"],
                    "args": worker_args}},
                "autoscaling": {
                    "enabled": True, "role": "decode",
                    "minReplicas": 1, "maxReplicas": 4,
                    "targetUtilization": 1.0, "expectedOsl": 16,
                    "scaleDownDelaySeconds": 5,
                    "forecastHorizonSeconds": 10,
                    "metricsUrl": fe_url + "/metrics",
                    "historyUrl": fe_url + "/debug/slo?history=1",
                    "pool": {"tokensPerSPerReplica": 1e6,
                             "maxStreamsPerReplica": 1},
                },
            },
        }},
    }
    dgdr = {
        "apiVersion": mat.API_VERSION, "kind": mat.DGDR_KIND,
        "metadata": {"name": "fleet-request", "namespace": NS},
        "spec": {"autoApply": True, "profilingConfig": {
            "config": {"configMapRef": {"name": "fleet-cm",
                                        "key": "dgd.yaml"}},
            "sla": {"isl": 256, "osl": 32, "ttft": 2000, "itl": 200},
            "tpuSystem": "h100-sxm-1"}},
    }
    cm = {"apiVersion": "v1", "kind": "ConfigMap",
          "metadata": {"name": "fleet-cm"},
          "data": {"dgd.yaml": json.dumps(template)}}
    return cm, dgdr


def test_phase21_rehearsal_on_the_cpu(monkeypatch):
    from dynamo_tpu_torch.operator import materialize as mat
    from dynamo_tpu_torch.operator.controller import (DRAIN_VICTIM_ANNOTATION,
                                                      Controller)
    from dynamo_tpu_torch.operator.k8s_client import K8sClient
    from tests.fake_k8s import FakeK8s
    from tests.fake_kubelet import run_pod

    fe_port, worker_port = _free_port(), _free_port()
    fe_url = f"http://127.0.0.1:{fe_port}"
    # the pod's port 8000, here on a free port of the host's loopback
    monkeypatch.setattr(mat, "WORKER_PORT", worker_port)
    worker_url = f"http://127.0.0.1:{worker_port}"
    args = ["--model", "tiny-debug", "--device", "cpu", "--page-size", "16",
            "--num-pages", "128", "--max-seq-len", "256",
            "--prefill-chunk-tokens", "64", "--enable-prefix-caching"]
    cm, dgdr = _dgdr_objects(fe_url, args)
    pods = []
    with FakeK8s() as fake:
        fake.put_object("v1", NS, "configmaps", cm)
        fake.put_object(mat.API_VERSION, NS, mat.DGDR_PLURAL, dgdr)
        env = dict(os.environ, KUBE_API_URL=fake.url)
        for _ in range(2):  # DGDR -> DGD, then DGD -> children
            done = subprocess.run(
                [sys.executable, "-m", "dynamo_tpu_torch.operator", "--once"],
                cwd=ROOT, env=env, capture_output=True, text=True,
                timeout=300)
            assert done.returncode == 0, done.stderr[-3000:]
        req = fake.get_object(mat.API_VERSION, NS, mat.DGDR_PLURAL,
                              "fleet-request")
        assert req["status"]["state"] == "successful", req["status"]
        deps = {n: fake.get_object("apps/v1", NS, "deployments", n)
                for n in ("fleet-frontend", "fleet-decodeworker")}
        worker_c = deps["fleet-decodeworker"]["spec"]["template"]["spec"][
            "containers"][0]
        assert worker_c["command"] == ["python3", "-m",
                                        "dynamo_tpu_torch.jetstream"]
        assert worker_c["resources"]["limits"] == {"nvidia.com/gpu": "1"}
        assert worker_c["resources"]["requests"] == {"nvidia.com/gpu": "1"}
        wargs = worker_c["args"]
        assert wargs[wargs.index("--tp") + 1] == "1"
        max_seqs = int(wargs[wargs.index("--max-num-seqs") + 1])
        services = {f"http://fleet-frontend:{mat.FRONTEND_PORT}": fe_url}
        try:
            pods.append(run_pod(fake, deps["fleet-frontend"], cwd=ROOT,
                                services=services,
                                env={"DYNAMO_PORT": str(fe_port)}))
            pods.append(run_pod(fake, deps["fleet-decodeworker"], cwd=ROOT,
                                services=services,
                                env={"PORT": str(worker_port)}))
            _wait(lambda: all(p.alive() for p in pods) and json.loads(
                _get(fe_url + "/internal/workers"))["workers"], 180,
                  "the worker registered at the frontend")
            stats = json.loads(_get(worker_url + "/worker/stats"))
            # the operator's env and args reached the engine
            assert stats["max_num_seqs"] == max_seqs
            assert stats["kvbm"]["host_pool"]["capacity_blocks"] == 8
            out = json.loads(_post(fe_url + "/v1/chat/completions", {
                "model": "tiny-debug", "max_tokens": 8, "temperature": 0.0,
                "ignore_eos": True,
                "messages": [{"role": "user", "content": "hello fleet"}]},
                AUTH))
            assert out["usage"]["completion_tokens"] == 8
            stats = json.loads(_get(worker_url + "/worker/stats"))
            assert "fleet" in stats["qos"]["tokens_total"], stats["qos"]
            # a burst of streams held in flight: the planner scales the
            # decode pool from the frontend's live tenant gauge
            ctrl = Controller(K8sClient(fake.url), namespace=None)
            ctrl.reconcile_once()
            burst = []

            def stream(i):
                burst.append(_post(fe_url + "/v1/chat/completions", {
                    "model": "tiny-debug", "max_tokens": 160,
                    "temperature": 0.0, "ignore_eos": True, "stream": True,
                    "messages": [{"role": "user", "content": f"burst {i}"}]},
                    AUTH))

            threads = [threading.Thread(target=stream, args=(i,))
                       for i in range(3)]
            for t in threads:
                t.start()
            _wait(lambda: parse_metrics_text(_get(fe_url + "/metrics"))[
                "inflight"] >= 3, 60, "three streams in flight")
            assert ctrl.planner_tick(now=1000.0) == 1
            ctrl.reconcile_once()
            dep = fake.get_object("apps/v1", NS, "deployments",
                                  "fleet-decodeworker")
            assert dep["spec"]["replicas"] == 3
            for t in threads:
                t.join(timeout=120)
            assert len(burst) == 3
            _wait(lambda: parse_metrics_text(_get(fe_url + "/metrics"))[
                "inflight"] == 0, 30, "the burst's end")
            ctrl.planner_tick(now=1010.0)       # arms the delay
            assert ctrl.planner_tick(now=1020.0) == 1   # steps down one
            pod = fake.get_object("v1", NS, "pods", pods[1].name)
            assert pod["metadata"]["annotations"][
                DRAIN_VICTIM_ANNOTATION] == "true"
            # the victim's pre-drain reached the worker
            assert json.loads(_get(worker_url + "/worker/stats"))[
                "draining"] is True
            ctrl.planner_tick(now=1030.0)
            ctrl.reconcile_once()
            dep = fake.get_object("apps/v1", NS, "deployments",
                                  "fleet-decodeworker")
            assert dep["spec"]["replicas"] == 1
        finally:
            tails = [p.tail() for p in pods]
            for p in pods:
                p.stop(timeout=20)
            print("\n".join(tails)[-4000:])
