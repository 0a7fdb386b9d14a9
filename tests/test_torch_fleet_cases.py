"""The JAX package's own control-plane cases, run against both packages
(`torch_tier_cases`): `tests/test_planner.py` (the forecaster, capacity,
the coordinated planner, the simulator, the controller's pool ticks, the
operator's debug server, the load generator), `tests/test_profiler.py`
(the roofline, the sweep, the DGD rewrite, the CLI) and
`tests/test_operator.py` (materialization, reconcile, the DGDR paths, the
profiler Job, watch streams, leader election, the v1 planner).

The port's run of `test_operator.py` reads the module's `DGD` with the GPU
values (`resources.limits.gpu: 1` in place of `tpu: 8`, no GKE TPU
selectors; `PORT_DGD`): the rest of each case is the JAX file's.

The cases in `TPU_ONLY` hold TPU values the port refuses or does not
catalog (`google.com/tpu`, GKE TPU selectors, multi-host gangs, `v5e` and
`v5p` systems, `tpuSystem: v5e-8`, the JAX package's `parallel`): they run
for the JAX package only, and each has a port case below with the GPU
values (`h100-sxm-<N>`, `nvidia.com/gpu`, refusals by name), named after
it with `_port` at the end.
"""

import copy
import json

import pytest

from torch_tier_cases import FixtureCache, cases, load, run

TPU_ONLY = {
    "test_operator": (
        "test_materialize_deployment_shape",
        "test_gang_scheduling_emits_podgroups",
        "test_multihost_service_materializes_gang_statefulset",
        "test_replicated_gangs_scale_in_one_statefulset",
        "test_resolve_replicated_gang_identity",
        "test_controller_reconciles_multihost_statefulset",
        "test_dgdr_generates_and_applies_dgd",
        "test_dgdr_profiler_image_dispatches_pod_not_inline",
    ),
    "test_profiler": (
        "test_sweep_8b_on_v5e8_meets_reference_sla",
        "test_70b_does_not_fit_single_v5e",
        "test_70b_fits_v5p64",
        "test_unmet_sla_falls_back_to_best_feasible",
        "test_estimate_monotonic_in_model_size",
        "test_disagg_split_sums_to_replicas",
        "test_disagg_split_none_for_single_replica_group",
        "test_apply_sla_overrides_no_model_flag_skips",
        "test_apply_sla_overrides_unknown_model_skips",
        "test_apply_sla_overrides_disagg_needs_two_replica_groups",
        "test_quant_tier_unlocks_disagg_on_small_chips",
        "test_quant_tier_prefers_unquantized_when_sufficient",
        "test_apply_sla_overrides_multi_host_topology",
        "test_apply_sla_overrides_removes_stale_quant_flags",
        "test_get_system_parses_arbitrary_shape",
        "test_apply_sla_overrides_rewrites_workers",
        "test_apply_sla_overrides_infeasible_annotates_only",
        "test_profiler_cli_json",
    ),
    "test_planner": (
        "test_capacity_from_roofline_scales_with_system",
        "test_capacity_from_spec_shapes",
    ),
}


def PORT_DGD(dgd: dict) -> dict:
    """test_operator.py's DGD with the GPU values."""
    out = copy.deepcopy(dgd)
    worker = out["spec"]["services"]["JetstreamDecodeWorker"]
    worker["resources"] = {"limits": {"gpu": "1"}}
    del worker["tpuAccelerator"], worker["tpuTopology"]
    return out


_port_operator = load("test_operator", "dynamo_tpu_torch")
_port_operator.DGD = PORT_DGD(_port_operator.DGD)


def both(name: str) -> list:
    """Every case of tests/<name>.py for both packages but TPU_ONLY's."""
    return cases(name, only=lambda n: n not in TPU_ONLY.get(name, ()))


def jax_only(name: str) -> list:
    return [p for p in cases(name, only=lambda n: n in TPU_ONLY[name])
            if p.values[0] == "dynamo_tpu"]


@pytest.fixture(scope="module")
def tier_fixtures():
    with FixtureCache() as cache:
        yield cache


@pytest.mark.parametrize("pkg,case", both("test_planner")
                         + jax_only("test_planner"))
def test_planner_cases(pkg, case, request, tier_fixtures):
    run(request, tier_fixtures, "test_planner", pkg, case)


@pytest.mark.parametrize("pkg,case", both("test_profiler")
                         + jax_only("test_profiler"))
def test_profiler_cases(pkg, case, request, tier_fixtures):
    run(request, tier_fixtures, "test_profiler", pkg, case)


@pytest.mark.parametrize("pkg,case", both("test_operator")
                         + jax_only("test_operator"))
def test_operator_cases(pkg, case, request, tier_fixtures):
    run(request, tier_fixtures, "test_operator", pkg, case)


def test_every_tpu_only_case_has_a_port_case():
    names = set(globals())
    missing = [case for cases_ in TPU_ONLY.values() for case in cases_
               if f"{case}_port" not in names]
    assert not missing, missing


# ------------------------------------------------------ the port's cases --

from dynamo_tpu_torch.models.config import ModelConfig  # noqa: E402
from dynamo_tpu_torch.operator import materialize as mat  # noqa: E402
from dynamo_tpu_torch.operator.controller import Controller  # noqa: E402
from dynamo_tpu_torch.operator.k8s_client import K8sClient  # noqa: E402
from dynamo_tpu_torch.profiler import (  # noqa: E402
    best_config, get_system, sweep)
from dynamo_tpu_torch.profiler.configurator import (  # noqa: E402
    ANNOTATION, apply_sla_overrides, disagg_split, served_tp_sizes)
from dynamo_tpu_torch.profiler.roofline import estimate  # noqa: E402
from tests.fake_k8s import FakeK8s  # noqa: E402

_profiler = load("test_profiler", "dynamo_tpu_torch")
_disagg_dgd = _profiler._disagg_dgd
DGD = _port_operator.DGD
REFERENCE_SLA = {"isl": 4000, "osl": 500, "ttft": 600, "itl": 25}


def _decision(out) -> dict:
    return json.loads(out["metadata"]["annotations"][ANNOTATION])


def _args(out, svc: str = "DecodeWorker") -> list:
    return out["spec"]["services"][svc]["extraPodSpec"]["mainContainer"][
        "args"]


# test_operator.py


def test_materialize_deployment_shape_port():
    out = mat.materialize(DGD)
    deps = {d["metadata"]["name"]: d for d in out["deployments"]}
    assert set(deps) == {"agg-demo-frontend",
                         "agg-demo-jetstreamdecodeworker"}
    w = deps["agg-demo-jetstreamdecodeworker"]
    assert w["spec"]["replicas"] == 2
    c = w["spec"]["template"]["spec"]["containers"][0]
    # gpu -> nvidia.com/gpu with request == limit
    assert c["resources"]["limits"]["nvidia.com/gpu"] == "1"
    assert c["resources"]["requests"]["nvidia.com/gpu"] == "1"
    env = {e["name"]: e.get("value") for e in c["env"]}
    assert env["FRONTEND_URL"] == "http://agg-demo-frontend:8000"
    assert env["EXTRA"] == "1"
    assert w["spec"]["template"]["spec"]["volumes"][0][
        "persistentVolumeClaim"]["claimName"] == "llm-models"
    assert c["volumeMounts"][0]["mountPath"] == DGD["spec"]["services"][
        "JetstreamDecodeWorker"]["volumeMounts"][0]["mountPoint"]
    # no GKE TPU node selectors, the port's worker module
    assert "nodeSelector" not in w["spec"]["template"]["spec"]
    assert c["command"] == ["python3", "-m", "dynamo_tpu_torch.jetstream"]
    assert w["metadata"]["labels"][mat.NS_LABEL] == "dynamo-agg-demo"
    assert w["metadata"]["ownerReferences"][0]["uid"] == "u-123"
    fc = deps["agg-demo-frontend"]["spec"]["template"]["spec"][
        "containers"][0]
    assert fc["envFrom"][0]["secretRef"]["name"] == "hf-token-secret"
    assert fc["command"] == ["python3", "-m", "dynamo_tpu_torch.frontend"]
    # a service without command or args gets the port's worker module
    bare = copy.deepcopy(DGD)
    del bare["spec"]["services"]["JetstreamDecodeWorker"]["extraPodSpec"]
    c = [d for d in mat.materialize(bare)["deployments"] if d["metadata"][
        "name"].endswith("worker")][0]["spec"]["template"]["spec"][
            "containers"][0]
    assert c["command"] == ["python3", "-m", "dynamo_tpu_torch.jetstream"]


@pytest.mark.parametrize("field,value,path", [
    ("resources", {"limits": {"tpu": "8"}}, "resources.limits.tpu"),
    ("resources", {"requests": {"tpu": "8"}}, "resources.requests.tpu"),
    ("tpuAccelerator", "tpu-v5-lite-podslice", "tpuAccelerator"),
    ("tpuTopology", "2x4", "tpuTopology"),
    ("hostsPerReplica", 2, "hostsPerReplica"),
])
def test_materialize_refuses_tpu_fields_by_name(field, value, path):
    cr = copy.deepcopy(DGD)
    cr["spec"]["services"]["JetstreamDecodeWorker"][field] = value
    with pytest.raises(NotImplementedError) as ei:
        mat.materialize(cr)
    assert ei.value.fields == [
        f"spec.services.JetstreamDecodeWorker.{path}"]
    assert f"JetstreamDecodeWorker.{path}" in str(ei.value)


def test_gang_scheduling_emits_podgroups_port():
    cr = {
        "apiVersion": mat.API_VERSION, "kind": mat.DGD_KIND,
        "metadata": {"name": "g", "namespace": "ns", "uid": "u1"},
        "spec": {"services": {
            "Frontend": {"componentType": "frontend", "replicas": 2},
            "Worker": {"componentType": "worker", "replicas": 4,
                       "resources": {"limits": {"gpu": "1"}}},
            "Solo": {"componentType": "worker", "replicas": 1},
        }},
    }
    out = mat.materialize(cr, gang=True)
    pgs = {p["metadata"]["name"]: p for p in out["podgroups"]}
    assert set(pgs) == {"g-worker"}
    assert pgs["g-worker"]["spec"]["minMember"] == 4
    deps = {d["metadata"]["name"]: d for d in out["deployments"]}
    wtpl = deps["g-worker"]["spec"]["template"]
    assert wtpl["metadata"]["annotations"][mat.POD_GROUP_KEY] == "g-worker"
    assert wtpl["spec"]["schedulerName"] == mat.DEFAULT_GANG_SCHEDULER
    for untouched in ("g-frontend", "g-solo"):
        tpl = deps[untouched]["spec"]["template"]
        assert "annotations" not in tpl["metadata"]
        assert "schedulerName" not in tpl["spec"]
    assert mat.materialize(cr)["podgroups"] == []


def _multihost_dgd(replicas: int = 1):
    return {
        "apiVersion": mat.API_VERSION, "kind": mat.DGD_KIND,
        "metadata": {"name": "mh", "namespace": "demo", "uid": "u-mh"},
        "spec": {"services": {
            "Frontend": {"componentType": "frontend", "replicas": 1},
            "BigWorker": {"componentType": "worker", "replicas": replicas,
                          "hostsPerReplica": 4,
                          "resources": {"limits": {"gpu": "8"}}},
        }},
    }


def test_multihost_service_materializes_gang_statefulset_port():
    with pytest.raises(NotImplementedError, match="BigWorker.hostsPerReplica"):
        mat.materialize(_multihost_dgd(), gang=True)


def test_replicated_gangs_scale_in_one_statefulset_port():
    with pytest.raises(NotImplementedError) as ei:
        mat.materialize(_multihost_dgd(3), gang=True)
    assert ei.value.fields == ["spec.services.BigWorker.hostsPerReplica"]


def test_resolve_replicated_gang_identity_port():
    # the gang's identity comes from the worker's multi-host flags, which
    # the port's worker refuses by name
    from dynamo_tpu_torch.serving import worker

    args = worker.build_parser("jetstream").parse_args(
        ["--coordinator", "mh-bigworker-0.mh-bigworker-gang.demo.svc:7777",
         "--num-processes", "4", "--process-id", "3"])
    assert worker.unported_flags(args) == [
        "--coordinator", "--num-processes", "--process-id"]
    with pytest.raises(NotImplementedError, match="--coordinator"):
        worker.main(["--coordinator", "x:1", "--device", "cpu"])


def test_controller_reconciles_multihost_statefulset_port():
    with FakeK8s() as fake:
        fake.put_object(mat.API_VERSION, "demo", mat.DGD_PLURAL,
                        _multihost_dgd())
        Controller(K8sClient(fake.url), namespace=None,
                   gang=True).reconcile_once()
        assert fake.get_object("apps/v1", "demo", "statefulsets",
                               "mh-bigworker") is None
        assert fake.get_object("apps/v1", "demo", "deployments",
                               "mh-frontend") is None
        cr = fake.get_object(mat.API_VERSION, "demo", mat.DGD_PLURAL, "mh")
        assert cr["status"]["state"] == "failed"
        assert cr["status"]["unserved"] == [
            "spec.services.BigWorker.hostsPerReplica"]
        cond = cr["status"]["conditions"][0]
        assert cond["reason"] == "Unserved"
        assert "BigWorker.hostsPerReplica" in cond["message"]
        # fixed: the refusal clears and the children appear
        fixed = _multihost_dgd()
        del fixed["spec"]["services"]["BigWorker"]["hostsPerReplica"]
        fake.put_object(mat.API_VERSION, "demo", mat.DGD_PLURAL, fixed)
        Controller(K8sClient(fake.url), namespace=None,
                   gang=True).reconcile_once()
        cr = fake.get_object(mat.API_VERSION, "demo", mat.DGD_PLURAL, "mh")
        assert cr["status"]["state"] == "pending"
        assert not cr["status"].get("unserved")
        assert fake.get_object("apps/v1", "demo", "deployments",
                               "mh-bigworker")


def _dgdr(name: str, cm: str, system: str, **prof) -> dict:
    return {
        "apiVersion": mat.API_VERSION, "kind": mat.DGDR_KIND,
        "metadata": {"name": name, "namespace": "dynamo", "uid": f"u-{name}"},
        "spec": {
            "model": "qwen/qwen3-0.6b", "backend": "jetstream",
            "autoApply": True,
            "profilingConfig": {
                "config": {"configMapRef": {"name": cm, "key": "d.yaml"}},
                "sla": dict(REFERENCE_SLA), "tpuSystem": system, **prof},
        },
    }


def _template(name: str) -> dict:
    return {
        "apiVersion": mat.API_VERSION, "kind": mat.DGD_KIND,
        "metadata": {"name": name},
        "spec": {"services": {
            "Frontend": {"componentType": "frontend", "replicas": 1},
            "PrefillWorker": {
                "componentType": "worker", "subComponentType": "prefill",
                "replicas": 1, "resources": {"limits": {"gpu": "1"}},
                "extraPodSpec": {"mainContainer": {
                    "args": ["--model", "qwen3-0.6b"]}}},
        }},
    }


def _put_template(fake, cm: str, template: dict) -> None:
    fake.put_object("v1", "dynamo", "configmaps", {
        "apiVersion": "v1", "kind": "ConfigMap", "metadata": {"name": cm},
        "data": {"d.yaml": json.dumps(template)}})


def test_dgdr_generates_and_applies_dgd_port():
    dgdr = _dgdr("qwen-request", "qwen-config", "h100-sxm-8")
    dgdr["spec"]["deploymentOverrides"] = {
        "workersImage": "dynamo-tpu/runtime:v2"}
    with FakeK8s() as fake:
        _put_template(fake, "qwen-config", _template("qwen-disagg"))
        fake.put_object(mat.API_VERSION, "dynamo", mat.DGDR_PLURAL, dgdr)
        ctrl = Controller(K8sClient(fake.url), namespace=None)
        ctrl.reconcile_once()
        gen = fake.get_object(mat.API_VERSION, "dynamo", mat.DGD_PLURAL,
                              "qwen-disagg")
        assert gen is not None, "autoApply should create the DGD"
        worker = gen["spec"]["services"]["PrefillWorker"]
        assert worker["extraPodSpec"]["mainContainer"]["image"] == \
            "dynamo-tpu/runtime:v2"
        assert "extraPodSpec" not in gen["spec"]["services"]["Frontend"]
        decision = _decision(gen)
        assert decision["system"] == "h100-sxm-8"
        assert decision["tp"] in served_tp_sizes(get_system("h100-sxm-8"))
        assert worker["resources"]["limits"] == {"gpu": str(decision["tp"])}
        assert "hostsPerReplica" not in worker
        req = fake.get_object(mat.API_VERSION, "dynamo", mat.DGDR_PLURAL,
                              "qwen-request")
        assert req["status"]["state"] == "successful"
        ctrl.reconcile_once()
        dep = fake.get_object("apps/v1", "dynamo", "deployments",
                              "qwen-disagg-prefillworker")
        c = dep["spec"]["template"]["spec"]["containers"][0]
        assert c["resources"]["requests"]["nvidia.com/gpu"] == \
            str(decision["tp"])


def test_dgdr_refuses_a_tpu_system_by_name():
    with FakeK8s() as fake:
        _put_template(fake, "cm", _template("never"))
        fake.put_object(mat.API_VERSION, "dynamo", mat.DGDR_PLURAL,
                        _dgdr("tpu-req", "cm", "v5e-8"))
        Controller(K8sClient(fake.url), namespace=None).reconcile_once()
        req = fake.get_object(mat.API_VERSION, "dynamo", mat.DGDR_PLURAL,
                              "tpu-req")
        assert req["status"]["state"] == "failed"
        assert "spec.profilingConfig.tpuSystem=v5e-8" in \
            req["status"]["message"]
        assert fake.get_object(mat.API_VERSION, "dynamo", mat.DGD_PLURAL,
                               "never") is None


def test_operator_refuses_to_start_beside_the_jax_operator(monkeypatch):
    import time

    from dynamo_tpu_torch.operator.__main__ import main
    from dynamo_tpu_torch.operator.leader import (
        LEASE_API, LEASE_NAME, PORT_IDENTITY_PREFIX, _now_str,
        other_operator_holder)

    def lease(holder, renewed):
        return {"apiVersion": LEASE_API, "kind": "Lease",
                "metadata": {"name": LEASE_NAME},
                "spec": {"holderIdentity": holder, "renewTime": renewed,
                         "leaseDurationSeconds": 15}}

    with FakeK8s() as fake:
        client = K8sClient(fake.url)
        assert other_operator_holder(client, "dynamo-system") is None
        fake.put_object(LEASE_API, "dynamo-system", "leases",
                        lease("jax-operator-0", _now_str()))
        assert other_operator_holder(client, "dynamo-system") == \
            "jax-operator-0"
        monkeypatch.setenv("KUBE_API_URL", fake.url)
        with pytest.raises(SystemExit, match="must not be installed"):
            main(["--leader-elect", "--debug-port", "0"])
        # the port's own replica, or a lapsed JAX holder, does not refuse
        fake.put_object(LEASE_API, "dynamo-system", "leases",
                        lease(PORT_IDENTITY_PREFIX + "pod-a", _now_str()))
        assert other_operator_holder(client, "dynamo-system") is None
        stale = time.strftime("%Y-%m-%dT%H:%M:%S.000000Z",
                              time.gmtime(time.time() - 60))
        fake.put_object(LEASE_API, "dynamo-system", "leases",
                        lease("jax-operator-0", stale))
        assert other_operator_holder(client, "dynamo-system") is None


def test_dgdr_profiler_image_dispatches_pod_not_inline_port(monkeypatch):
    dgdr = _dgdr("pod-prof", "pod-prof-cm", "h100-sxm-8",
                 profilerImage="dynamo-tpu/runtime:latest")
    with FakeK8s() as fake:
        _put_template(fake, "pod-prof-cm", _template("pod-prof-dgd"))
        fake.put_object(mat.API_VERSION, "dynamo", mat.DGDR_PLURAL, dgdr)
        ctrl = Controller(K8sClient(fake.url), namespace=None)
        ctrl.reconcile_once()
        assert fake.get_object(mat.API_VERSION, "dynamo", mat.DGD_PLURAL,
                               "pod-prof-dgd") is None
        job = fake.get_object("batch/v1", "dynamo", "jobs",
                              "pod-prof-profiler")
        cmd = job["spec"]["template"]["spec"]["containers"][0]["command"]
        assert cmd[:3] == ["python3", "-m", "dynamo_tpu_torch.profiler"]
        assert "--dgdr" in cmd and "pod-prof" in cmd
        assert job["metadata"]["ownerReferences"][0]["uid"] == "u-pod-prof"
        req = fake.get_object(mat.API_VERSION, "dynamo", mat.DGDR_PLURAL,
                              "pod-prof")
        assert req["status"]["state"] == "profiling"
        ctrl.reconcile_once()
        monkeypatch.setenv("KUBE_API_URL", fake.url)
        from dynamo_tpu_torch.profiler.__main__ import main as profiler_main

        profiler_main(["--dgdr", "pod-prof", "--namespace", "dynamo"])
        gen = fake.get_object(mat.API_VERSION, "dynamo", mat.DGD_PLURAL,
                              "pod-prof-dgd")
        assert gen is not None, "pod mode must create the DGD"
        assert _decision(gen)["system"] == "h100-sxm-8"
        req = fake.get_object(mat.API_VERSION, "dynamo", mat.DGDR_PLURAL,
                              "pod-prof")
        assert req["status"]["state"] == "successful"
        ctrl.reconcile_once()


# test_profiler.py


def test_sweep_8b_on_v5e8_meets_reference_sla_port():
    cfg = ModelConfig.from_model_name("meta-llama-3-8b-instruct")
    best = best_config(cfg, get_system("h100-sxm-8"), 4000, 500,
                       ttft_ms=600, itl_ms=25)
    assert best is not None and best.meets(600, 25)
    assert best.tp * best.replicas <= 8
    assert best.tp in served_tp_sizes(get_system("h100-sxm-8"))
    assert best.tok_s_per_chip > 100


def test_70b_does_not_fit_single_v5e_port():
    # 141 GB of bf16 weights exceed one H100's 80 GB: no bf16 point fits,
    # and the quantization tiers are what make it fit at all
    cfg = ModelConfig.from_model_name("meta-llama-3-70b-instruct")
    assert sweep(cfg, get_system("h100-sxm-1"), 4000, 500) == []
    assert not estimate(cfg, get_system("h100-sxm-1"), 1, 1, 4000,
                        500).feasible
    best = best_config(cfg, get_system("h100-sxm-1"), 4000, 500)
    assert best is not None and best.quantization == "w8a8"


def test_70b_fits_v5p64_port():
    # across boards at the served degree: one engine per card, w8a8
    cfg = ModelConfig.from_model_name("meta-llama-3-70b-instruct")
    best = best_config(cfg, get_system("h100-sxm-64"), 4000, 500, 600, 25)
    assert best is not None and best.feasible
    assert best.replicas == 64 // best.tp


def test_unmet_sla_falls_back_to_best_feasible_port():
    cfg = ModelConfig.from_model_name("meta-llama-3-8b-instruct")
    best = best_config(cfg, get_system("h100-sxm-8"), 4000, 500,
                       ttft_ms=600, itl_ms=0.01)
    assert best is not None
    assert not best.meets(600, 0.01)


def test_estimate_monotonic_in_model_size_port():
    small = ModelConfig.from_model_name("llama-3.2-1b-instruct")
    big = ModelConfig.from_model_name("meta-llama-3-8b-instruct")
    sys8 = get_system("h100-sxm-8")
    # estimate prices every degree valid_tp_sizes gives, served or not
    e_small = estimate(small, sys8, 8, 32, 4000, 500)
    e_big = estimate(big, sys8, 8, 32, 4000, 500)
    assert e_small.tok_s_per_chip > e_big.tok_s_per_chip
    assert e_small.ttft_s < e_big.ttft_s


def test_disagg_split_sums_to_replicas_port():
    cfg = ModelConfig.from_model_name("qwen3-0.6b")
    est = best_config(cfg, get_system("h100-sxm-16"), 4000, 500)
    split = disagg_split(est, 4000, 500)
    assert split["prefill"] >= 1 and split["decode"] >= 1
    assert split["prefill"] + split["decode"] == est.replicas


def test_disagg_split_none_for_single_replica_group_port():
    import dataclasses

    cfg = ModelConfig.from_model_name("meta-llama-3-8b-instruct")
    est = best_config(cfg, get_system("h100-sxm-8"), 4000, 500)
    assert disagg_split(dataclasses.replace(est, replicas=1), 4000,
                        500) is None


def test_apply_sla_overrides_no_model_flag_skips_port():
    dgd = _disagg_dgd("x")
    for svc in dgd["spec"]["services"].values():
        pod = svc.get("extraPodSpec")
        if pod:
            pod["mainContainer"]["args"] = ["--port", "8000"]
    before = json.dumps(dgd["spec"])
    out = apply_sla_overrides(dgd, {"isl": 100, "osl": 10},
                              system="h100-sxm-8")
    assert _decision(out)["result"] == "skipped"
    assert json.dumps(out["spec"]) == before


def test_apply_sla_overrides_unknown_model_skips_port():
    dgd = _disagg_dgd("no-such-model-xyz")
    before = json.dumps(dgd["spec"])
    out = apply_sla_overrides(dgd, {"isl": 100, "osl": 10},
                              system="h100-sxm-8")
    assert _decision(out)["result"] == "skipped"
    assert json.dumps(out["spec"]) == before


def test_apply_sla_overrides_disagg_needs_two_replica_groups_port():
    # one card is one replica group: a disaggregated graph needs two
    dgd = _disagg_dgd("meta-llama-3-8b-instruct")
    before = json.dumps(dgd["spec"])
    out = apply_sla_overrides(dgd, {"isl": 4000, "osl": 500},
                              system="h100-sxm-1")
    assert _decision(out)["result"] == "disagg_infeasible"
    assert json.dumps(out["spec"]) == before


def test_quant_tier_unlocks_disagg_on_small_chips_port():
    # 70B bf16 fits no card at the served degree; the w8a8 tier halves
    # the weights, so two cards give two replica groups
    dgd = _disagg_dgd("meta-llama-3-70b-instruct")
    out = apply_sla_overrides(dgd, {"isl": 4000, "osl": 500},
                              system="h100-sxm-2")
    decision = _decision(out)
    assert decision["quantization"] == "w8a8"
    assert decision["replicas"] >= 2
    args = _args(out)
    assert args[args.index("--quantization") + 1] == "w8a8"


def test_quant_tier_prefers_unquantized_when_sufficient_port():
    dgd = _disagg_dgd("llama-3.2-1b-instruct")
    out = apply_sla_overrides(dgd, {"isl": 1000, "osl": 100},
                              system="h100-sxm-8")
    decision = _decision(out)
    assert decision["quantization"] == "none"
    assert decision["kv_cache_dtype"] == "auto"
    assert "--quantization" not in _args(out)
    assert "--kv-cache-dtype" not in _args(out)


def test_apply_sla_overrides_multi_host_topology_port():
    # 70B on four boards: the sweep stays at the engine's degrees, within
    # a card's board, so no service becomes a multi-host gang
    dgd = _disagg_dgd("meta-llama-3-70b-instruct")
    dgd["spec"]["services"]["DecodeWorker"]["hostsPerReplica"] = 2
    out = apply_sla_overrides(dgd, dict(REFERENCE_SLA), system="h100-sxm-32")
    decision = _decision(out)
    assert decision["hosts_per_replica"] == 1
    assert decision["tp"] in served_tp_sizes(get_system("h100-sxm-32"))
    assert "hostsPerReplica" not in out["spec"]["services"]["PrefillWorker"]
    svc = out["spec"]["services"]["DecodeWorker"]
    assert svc["resources"]["limits"]["gpu"] == str(decision["tp"])
    # the template's own gang is left for the operator to refuse by name
    assert svc["hostsPerReplica"] == 2
    with pytest.raises(NotImplementedError, match="hostsPerReplica"):
        mat.materialize(out)


def test_apply_sla_overrides_removes_stale_quant_flags_port():
    dgd = _disagg_dgd("llama-3.2-1b-instruct")
    for name in ("PrefillWorker", "DecodeWorker"):
        dgd["spec"]["services"][name]["extraPodSpec"]["mainContainer"][
            "args"] += ["--quantization", "w8a8", "--kv-cache-dtype", "int8"]
    out = apply_sla_overrides(dgd, {"isl": 1000, "osl": 100},
                              system="h100-sxm-8")
    assert _decision(out)["quantization"] == "none"
    assert "--quantization" not in _args(out)
    assert "--kv-cache-dtype" not in _args(out)


def test_get_system_parses_arbitrary_shape_port():
    s = get_system("h100-sxm-512")
    assert s.num_chips == 512 and s.chip.name == "h100-sxm"
    assert get_system("h100-sxm-4").num_chips == 4
    for bad in ("h100-sxm-3", "h100-sxm-12", "v6e-512", "a100-sxm-8"):
        with pytest.raises(KeyError):
            get_system(bad)


def test_apply_sla_overrides_rewrites_workers_port():
    dgd = _disagg_dgd("meta-llama-3-8b-instruct")
    out = apply_sla_overrides(dgd, dict(REFERENCE_SLA), system="h100-sxm-16")
    decision = _decision(out)
    assert decision["meets_sla"] is True
    svcs = out["spec"]["services"]
    for name in ("PrefillWorker", "DecodeWorker"):
        args = _args(out, name)
        tp = int(args[args.index("--tp") + 1])
        assert tp == decision["tp"] == 1
        assert args.count("--tp") == 1, "must replace, not duplicate"
        assert svcs[name]["resources"]["limits"]["gpu"] == str(tp)
    total = svcs["PrefillWorker"]["replicas"] + svcs["DecodeWorker"][
        "replicas"]
    assert total == max(decision["replicas"], 2)
    assert "resources" not in svcs["Frontend"]


def test_apply_sla_overrides_infeasible_annotates_only_port():
    # the 70B with a 400k-token context fits no card at any tier: one
    # sequence's KV alone is 131 GB
    dgd = _disagg_dgd("meta-llama-3-70b-instruct")
    before = json.dumps(dgd["spec"])
    out = apply_sla_overrides(dgd, {"isl": 400000, "osl": 500},
                              system="h100-sxm-1")
    assert _decision(out)["result"] == "infeasible"
    assert json.dumps(out["spec"]) == before


def test_profiler_cli_json_port(capsys):
    from dynamo_tpu_torch.profiler.__main__ import main

    main(["--model", "meta-llama-3-8b-instruct", "--system", "h100-sxm-16",
          "--isl", "4000", "--osl", "500", "--ttft", "600", "--itl", "25",
          "--json"])
    out = json.loads(capsys.readouterr().out)
    assert out["system"] == "h100-sxm-16"
    assert out["best"]["meets_sla"] is True
    assert out["best"]["tp"] == 1
    split = out["disagg_split"]
    assert split["prefill"] >= 1 and split["decode"] >= 1


# test_planner.py


def test_capacity_from_roofline_scales_with_system_port():
    from dynamo_tpu_torch.planner import capacity_from_roofline

    small = capacity_from_roofline("Qwen/Qwen3-0.6B", system="h100-sxm-4",
                                   tp=1, batch=32, isl=1024, osl=256)
    big = capacity_from_roofline("Qwen/Qwen3-0.6B", system="h100-sxm-8",
                                 tp=1, batch=32, isl=1024, osl=256)
    assert small.prompts_per_s > 0 and small.tokens_per_s > 0
    assert small.source == "roofline"
    # a pod is one engine of tp cards: the system's size adds pods (the
    # configurator's `replicas`), not capacity per pod
    assert big.tokens_per_s == pytest.approx(small.tokens_per_s)
    assert big.prompts_per_s == pytest.approx(small.prompts_per_s)
    assert big.max_streams == small.max_streams == 32
    # the default tp is the engine's widest served degree; a wider one is
    # refused by name
    one = capacity_from_roofline("Qwen/Qwen3-0.6B", batch=32)
    assert one.max_streams == 32
    with pytest.raises(ValueError, match="autoscaling.pool.tp=4"):
        capacity_from_roofline("Qwen/Qwen3-0.6B", system="h100-sxm-4", tp=4)


def test_capacity_from_spec_shapes_port():
    from dynamo_tpu_torch.planner import capacity_from_spec

    cap = capacity_from_spec({"promptsPerSPerReplica": 12.5,
                              "tokensPerSPerReplica": 4000,
                              "maxStreamsPerReplica": 64})
    assert cap.prompts_per_s == 12.5 and cap.max_streams == 64
    roof = capacity_from_spec({"model": "Qwen/Qwen3-0.6B",
                               "tpuSystem": "h100-sxm-4", "tp": 1,
                               "batch": 32, "isl": 512, "osl": 128})
    assert roof.source == "roofline" and roof.tokens_per_s > 0
    with pytest.raises(KeyError, match="v5e-4"):
        capacity_from_spec({"model": "Qwen/Qwen3-0.6B",
                            "tpuSystem": "v5e-4", "tp": 4})
    with pytest.raises(ValueError, match="unknown autoscaling.pool"):
        capacity_from_spec({"promptsPerSecond": 5})
    with pytest.raises(ValueError, match="mixes explicit"):
        capacity_from_spec({"model": "x", "tokensPerSPerReplica": 1})
    with pytest.raises(ValueError):
        capacity_from_spec({})
