"""Materialize a DynamoGraphDeployment CR into Deployments + Services.

Pure functions (no I/O) so the reconcile math is unit-testable without a
cluster. Mirrors the behavior of the reference's consumed Go operator:
- CRD chain DGD -> per-service Deployments/Services
  (reference docs/k8s-cheatsheet.md:127-156)
- discovery label on children — ours is `tpu.dynamo.ai/dynamo-namespace=
  <ns>-<dgd>`, the analogue of `nvidia.com/dynamo-namespace`
  (reference deploy-incluster.sh:252-256)
- spec shape: services / componentType / subComponentType / replicas /
  resources.limits / envFromSecret / envs / pvcs / volumeMounts /
  extraPodSpec.mainContainer (reference examples/deploy/vllm/agg.yaml,
  reference examples/dgdr/trtllm/disagg_cache.yaml:11-34)
- garbage collection via ownerReferences on every child

The port's copy of `dynamo_tpu/operator/materialize.py`, for GPUs: the
default commands run the port's modules (`python3 -m
dynamo_tpu_torch.frontend`, `dynamo_tpu_torch.jetstream`);
`resources.limits.gpu` maps to `nvidia.com/gpu` with request == limit;
multi-replica worker pools get all-or-nothing gang semantics via a
pod-group label consumed by the gang scheduler (the Grove/KAI analogue,
reference install-dynamo-1node.sh:35-36,207-212). `GROUP`, the CRD kinds
and every `DYNAMO_TPU_*` env name stay the JAX operator's: the port's
worker reads those names.

What the port does not serve is refused by name (`Unserved`, which the
controller turns into a status condition on the CR), never dropped:
`resources.limits.tpu` (and `requests.tpu`), `tpuAccelerator`,
`tpuTopology` (GKE TPU node selectors), and a `hostsPerReplica` above 1
(the multi-host gang StatefulSet, whose members the port's worker cannot
join: it refuses `--coordinator`, `--num-processes`, `--process-id`).
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, List, Optional

GROUP = "tpu.dynamo.ai"
API_VERSION = f"{GROUP}/v1alpha1"
DGD_KIND = "DynamoGraphDeployment"
DGD_PLURAL = "dynamographdeployments"
DGDR_KIND = "DynamoGraphDeploymentRequest"
DGDR_PLURAL = "dynamographdeploymentrequests"

NS_LABEL = f"{GROUP}/dynamo-namespace"
COMPONENT_LABEL = f"{GROUP}/component"
COMPONENT_TYPE_LABEL = f"{GROUP}/component-type"
MANAGED_BY_LABEL = "app.kubernetes.io/managed-by"
OPERATOR_NAME = "dynamo-tpu-operator"
POD_GROUP_LABEL = f"{GROUP}/pod-group"


def default_image() -> str:
    """Image for services that don't pin one in extraPodSpec.mainContainer.

    The operator Deployment sets DYNAMO_TPU_DEFAULT_IMAGE to the image it
    itself runs from (threaded by install-dynamo-1node.sh via DYNAMO_IMAGE),
    so a versioned install materializes versioned workers. Read at call
    time, not import time, so `kubectl set env` takes effect on restart."""
    return os.environ.get("DYNAMO_TPU_DEFAULT_IMAGE",
                          "dynamo-tpu/runtime:latest")
# coscheduling (scheduler-plugins) contract — the Grove/KAI-analogue gang
# scheduler consumes these (reference install-dynamo-1node.sh:35-36,
# 207-212 gates the reference's equivalents behind the same kind of opt-in)
POD_GROUP_API = "scheduling.x-k8s.io/v1alpha1"
# the coscheduling plugin associates a pod with its PodGroup via this key as
# a LABEL; gang sites also stamp it as an annotation for tooling that
# expects the older convention (same key, both conventions, one constant)
POD_GROUP_KEY = "scheduling.x-k8s.io/pod-group"
DEFAULT_GANG_SCHEDULER = "scheduler-plugins-scheduler"

FRONTEND_PORT = 8000
WORKER_PORT = 8000

# resources.limits key -> K8s resource name (gpu is the native path)
RESOURCE_KEYS = {
    "gpu": "nvidia.com/gpu",
    "cpu": "cpu",
    "memory": "memory",
    "ephemeral-storage": "ephemeral-storage",
}


class Unserved(NotImplementedError):
    """A CR field set to something the port does not serve; `fields` are
    their paths in the CR (`spec.services.<name>.<field>`)."""

    def __init__(self, fields: List[str]):
        self.fields = list(fields)
        super().__init__(
            f"not served by dynamo_tpu_torch: {', '.join(self.fields)} "
            f"(see ROADMAP.md)")


def unserved_fields(cr: Dict[str, Any]) -> List[str]:
    """The paths of the CR's fields the port does not serve."""
    out = []
    for svc_name, spec in (cr.get("spec", {}).get("services")
                           or {}).items():
        at = f"spec.services.{svc_name}"
        for section in ("requests", "limits"):
            if "tpu" in ((spec.get("resources") or {}).get(section) or {}):
                out.append(f"{at}.resources.{section}.tpu")
        for field in ("tpuAccelerator", "tpuTopology"):
            if spec.get(field):
                out.append(f"{at}.{field}")
        if hosts_per_replica(spec) > 1:
            out.append(f"{at}.hostsPerReplica")
    return out


def child_name(dgd_name: str, service_name: str) -> str:
    return f"{dgd_name}-{service_name.lower()}"


def discovery_label_value(namespace: str, dgd_name: str) -> str:
    return f"{namespace}-{dgd_name}"


def owner_reference(cr: Dict[str, Any]) -> Dict[str, Any]:
    return {
        "apiVersion": cr.get("apiVersion", API_VERSION),
        "kind": cr.get("kind", DGD_KIND),
        "name": cr["metadata"]["name"],
        "uid": cr["metadata"].get("uid", ""),
        "controller": True,
        "blockOwnerDeletion": True,
    }


def _labels(namespace: str, dgd_name: str, svc_name: str, ctype: str) -> Dict[str, str]:
    return {
        NS_LABEL: discovery_label_value(namespace, dgd_name),
        COMPONENT_LABEL: svc_name.lower(),
        COMPONENT_TYPE_LABEL: ctype,
        MANAGED_BY_LABEL: OPERATOR_NAME,
    }


def _resources(spec: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Dict[str, str]] = {}
    for section in ("requests", "limits"):
        vals = (spec.get("resources") or {}).get(section) or {}
        mapped = {
            RESOURCE_KEYS.get(k, k): str(v)
            for k, v in vals.items()
            if v is not None
        }
        if mapped:
            out[section] = mapped
    # GPU containers must request == limit for nvidia.com/gpu
    lim = out.get("limits", {})
    if "nvidia.com/gpu" in lim:
        out.setdefault("requests", {})["nvidia.com/gpu"] = lim["nvidia.com/gpu"]
    return out


def frontend_host(cr: Dict[str, Any]) -> str:
    """Child-service DNS name of the graph's frontend component.

    Keyed on componentType (not the service's map key) so a DGD that names
    its frontend service anything (e.g. `Router:`) still gives workers a
    resolvable FRONTEND_URL.
    """
    dgd_name = cr["metadata"]["name"]
    for svc_name, spec in (cr.get("spec", {}).get("services") or {}).items():
        if spec.get("componentType") == "frontend":
            return child_name(dgd_name, svc_name)
    return f"{dgd_name}-frontend"


def _container(
    dgd_name: str, svc_name: str, spec: Dict[str, Any], ctype: str,
    frontend: str = "",
) -> Dict[str, Any]:
    main = ((spec.get("extraPodSpec") or {}).get("mainContainer")) or {}
    c: Dict[str, Any] = {
        "name": "main",
        "image": main.get("image") or default_image(),
        "ports": [{"containerPort": FRONTEND_PORT, "name": "http"}],
    }
    if main.get("workingDir"):
        c["workingDir"] = main["workingDir"]
    if main.get("command"):
        c["command"] = list(main["command"])
    if main.get("args"):
        c["args"] = list(main["args"])
    # user-supplied probes ride through
    for probe in ("readinessProbe", "livenessProbe", "startupProbe"):
        if main.get(probe):
            c[probe] = copy.deepcopy(main[probe])
    if not c.get("command") and not c.get("args"):
        # sensible defaults matching our runtime modules
        if ctype == "frontend":
            c["command"] = ["python3", "-m", "dynamo_tpu_torch.frontend"]
        else:
            c["command"] = ["python3", "-m", "dynamo_tpu_torch.jetstream"]
    if ctype == "frontend" and not c.get("readinessProbe"):
        # HA frontend plane: /healthz is a REAL readiness gate (unready
        # while the NATS subscription is down, the worker registry is
        # empty, or the replica is draining) — the Service only routes to
        # replicas that can actually serve
        c["readinessProbe"] = {
            "httpGet": {"path": "/healthz", "port": FRONTEND_PORT},
            "periodSeconds": 5,
            "failureThreshold": 2,
        }

    env: List[Dict[str, Any]] = [
        {
            "name": "POD_IP",
            "valueFrom": {"fieldRef": {"fieldPath": "status.podIP"}},
        },
        {"name": "DYNAMO_COMPONENT", "value": svc_name},
    ]
    if ctype == "frontend":
        # stable replica identity for journal-record origin + gossip
        # subjects (serving/ha.py frontend_id)
        env.append({
            "name": "DYNAMO_TPU_FRONTEND_ID",
            "valueFrom": {"fieldRef": {"fieldPath": "metadata.name"}},
        })
        # SIGTERM drain budget: healthz flips 503, in-flight streams get
        # this long to finish before the hard stop (cut streams resume
        # through a peer replica via the replicated journal)
        env.append({"name": "FRONTEND_DRAIN_S",
                    "value": str(drain_seconds(spec))})
    # SLO targets (observability/slo.py): `sloTargets` applies to EVERY
    # component type — the frontend tracks end-to-end burn, workers track
    # their own role's (prefill TTFT / decode ITL) burn
    for name, value in slo_env(spec):
        env.append({"name": name, "value": value})
    # per-tenant QoS (dynamo_tpu_torch.qos): `tenants:` applies to EVERY
    # component too — the frontend enforces weighted admission with it,
    # workers budget decode throughput and resolve identity with the
    # SAME classes, so edge and engine can never disagree on a weight
    for name, value in tenant_env(spec):
        env.append({"name": name, "value": value})
    if ctype != "frontend":
        env.append(
            {
                "name": "FRONTEND_URL",
                "value": f"http://{frontend or dgd_name + '-frontend'}:{FRONTEND_PORT}",
            }
        )
        # KVBM host-tier sizing (dynamo_tpu_torch.kvbm): the worker CLI reads
        # these envs as its --kvbm-host-blocks/--kvbm-disk-dir defaults,
        # so manifests size the tier without touching container args.
        # Host-RAM cost = blocks * bytes/page — pair kvbmHostBlocks with a
        # matching resources.limits.memory bump.
        if spec.get("kvbmHostBlocks") is not None:
            env.append({"name": "DYNAMO_TPU_KVBM_HOST_BLOCKS",
                        "value": str(spec["kvbmHostBlocks"])})
        if spec.get("kvbmDiskDir"):
            env.append({"name": "DYNAMO_TPU_KVBM_DISK_DIR",
                        "value": str(spec["kvbmDiskDir"])})
        # flight-recorder ring depth (observability/flight.py): 0 disables
        # recording; unset uses the built-in 512-record default. Cheap —
        # each record is a small dict, so even 4096 is a few MB.
        if spec.get("flightRecords") is not None:
            env.append({"name": "DYNAMO_TPU_FLIGHT_RECORDS",
                        "value": str(spec["flightRecords"])})
        # graceful-drain budget (worker SIGTERM: admission off, in-flight
        # handoff, KV demote); _pod_spec aligns the pod's
        # terminationGracePeriodSeconds with it so K8s never SIGKILLs a
        # pod that is still mid-handoff
        env.append({"name": "DRAIN_TIMEOUT_S",
                    "value": str(drain_seconds(spec))})
        # preemptible batch pool (`preemptible: true`): the worker
        # advertises itself reclaimable in its heartbeat, and the default
        # POST /internal/reclaim deadline comes from the pool's declared
        # notice window (`reclaimDeadlineSeconds`; _pod_spec adds the
        # spot nodeSelector/toleration)
        if spec.get("preemptible"):
            env.append({"name": "DYNAMO_TPU_PREEMPTIBLE", "value": "1"})
            if spec.get("reclaimDeadlineSeconds") is not None:
                env.append({"name": "DYNAMO_TPU_RECLAIM_DEADLINE_S",
                            "value": str(int(
                                spec["reclaimDeadlineSeconds"]))})
        # live weight rollouts (dynamo_tpu_torch.elasticity): `modelVersion`
        # labels the weights a FRESH pod boots with, so replacement pods
        # spawned mid/post-rollout land on the fleet's target version
        # (KV/prefix namespaces included) instead of the baseline. The
        # RUNNING fleet is flipped in place by the controller's
        # rollout_tick via POST /internal/rollout — this env only seeds
        # boot state; it never restarts pods.
        if spec.get("modelVersion"):
            env.append({"name": "DYNAMO_TPU_MODEL_VERSION",
                        "value": str(spec["modelVersion"])})
        # multi-LoRA serving (dynamo_tpu_torch.lora): `loraAdapters` lists the
        # adapters this worker registers at boot — entries are
        # {name, path} maps or "name=/path" strings; paths usually live on
        # a mounted PVC. `loraSlots`/`loraMaxRank` size the device slots.
        # The worker CLI reads these envs as its --lora-* defaults.
        spec_env = lora_adapter_env(spec)
        for name, value in spec_env:
            env.append({"name": name, "value": value})
        # Speculation v3 (dynamo_tpu_torch.speculation): `drafter` picks the
        # proposer the worker boots with, `draftModel` names the small
        # same-tokenizer draft model for the model drafter — a bare name
        # string, or a {model, path, pages} map to also pin the checkpoint
        # dir and the draft KV pool size. The worker CLI reads these envs
        # as its --drafter/--draft-model/--draft-model-path/
        # --draft-num-pages defaults.
        if spec.get("drafter"):
            env.append({"name": "DYNAMO_TPU_SPEC_DRAFTER",
                        "value": str(spec["drafter"])})
        dm = spec.get("draftModel")
        if dm:
            if isinstance(dm, dict):
                if dm.get("model"):
                    env.append({"name": "DYNAMO_TPU_SPEC_DRAFT_MODEL",
                                "value": str(dm["model"])})
                if dm.get("path"):
                    env.append({"name": "DYNAMO_TPU_SPEC_DRAFT_MODEL_PATH",
                                "value": str(dm["path"])})
                if dm.get("pages") is not None:
                    env.append({"name": "DYNAMO_TPU_SPEC_DRAFT_PAGES",
                                "value": str(int(dm["pages"]))})
            else:
                env.append({"name": "DYNAMO_TPU_SPEC_DRAFT_MODEL",
                            "value": str(dm)})
    for e in spec.get("envs") or []:
        env.append(dict(e))
    c["env"] = env

    if spec.get("envFromSecret"):
        c["envFrom"] = [{"secretRef": {"name": spec["envFromSecret"]}}]

    mounts = []
    for vm in spec.get("volumeMounts") or []:
        mounts.append(
            {"name": vm["name"], "mountPath": vm.get("mountPoint", vm.get("mountPath"))}
        )
    if mounts:
        c["volumeMounts"] = mounts

    res = _resources(spec)
    if res:
        c["resources"] = res
    return c


def lora_adapter_env(spec: Dict[str, Any]) -> List[tuple]:
    """The `loraAdapters`/`loraSlots`/`loraMaxRank` manifest keys as
    (env name, value) pairs for a worker container. `loraAdapters` entries
    may be {name, path} maps or "name=/path" strings; slots default to the
    adapter count when adapters are given without an explicit size."""
    out: List[tuple] = []
    adapters = spec.get("loraAdapters") or []
    pairs = []
    for a in adapters:
        if isinstance(a, dict):
            name, path = a.get("name"), a.get("path")
            if not name or not path:
                raise ValueError(
                    f"loraAdapters entries need name AND path: {a!r}")
            pairs.append(f"{name}={path}")
        else:
            if "=" not in str(a):
                raise ValueError(
                    f"loraAdapters string entries are name=/path: {a!r}")
            pairs.append(str(a))
    slots = spec.get("loraSlots")
    if slots is None and pairs:
        slots = len(pairs)
    if slots is not None:
        out.append(("DYNAMO_TPU_LORA_SLOTS", str(int(slots))))
    if pairs:
        out.append(("DYNAMO_TPU_LORA_ADAPTERS", ",".join(pairs)))
    if spec.get("loraMaxRank") is not None:
        out.append(("DYNAMO_TPU_LORA_RANK", str(int(spec["loraMaxRank"]))))
    return out


def slo_env(spec: Dict[str, Any]) -> List[tuple]:
    """The `sloTargets` manifest key as (env name, value) pairs.

    Two shapes (observability/slo.py consumes both):
    - a MAP of scalars — one wildcard target:
        sloTargets: {ttftMs: 500, itlMs: 50, errorRate: 0.01, goal: 0.99}
      -> DYNAMO_TPU_SLO_TTFT_MS=500 ...
    - a LIST of target specs (per model/adapter/role):
        sloTargets: [{model: llama:fr-adapter, role: decode, itlMs: 40}]
      -> DYNAMO_TPU_SLO_TARGETS=<json>
    Unknown keys fail loudly (a typo'd SLO is a disabled SLO)."""
    import json as _json

    tg = spec.get("sloTargets")
    if not tg:
        return []
    if isinstance(tg, dict):
        scalar_envs = {"ttftMs": "DYNAMO_TPU_SLO_TTFT_MS",
                       "itlMs": "DYNAMO_TPU_SLO_ITL_MS",
                       "errorRate": "DYNAMO_TPU_SLO_ERROR_RATE",
                       "goal": "DYNAMO_TPU_SLO_GOAL"}
        unknown = set(tg) - set(scalar_envs)
        if unknown:
            raise ValueError(
                f"unknown sloTargets keys: {sorted(unknown)} "
                f"(known: {sorted(scalar_envs)}; use a list for "
                "per-model/role targets)")
        return [(scalar_envs[k], str(tg[k])) for k in sorted(tg)]
    if isinstance(tg, list):
        # validate each spec via the SLO engine's own parser so the
        # operator rejects what the worker would reject
        from dynamo_tpu_torch.observability.slo import target_from_dict

        for spec_item in tg:
            target_from_dict(spec_item)
        return [("DYNAMO_TPU_SLO_TARGETS",
                 _json.dumps(tg, separators=(",", ":")))]
    raise ValueError("sloTargets must be a map of scalars or a list of "
                     "target specs")


def tenant_env(spec: Dict[str, Any]) -> List[tuple]:
    """The `tenants:` manifest key as (env name, value) pairs.

    A list of tenant-class specs (docs/robustness.md "Per-tenant QoS"):

        tenants:
          - {name: acme, weight: 4, priority: 0, maxInflight: 64,
             apiKeys: ["sk-acme-1"]}
          - {name: free-tier, weight: 1, priority: 5}

    Validated via the QoS plane's own parser so the operator rejects
    exactly what the frontend/worker would reject; specs are normalized
    (camelCase -> snake_case) before landing in DYNAMO_TPU_TENANTS."""
    import json as _json

    tg = spec.get("tenants")
    if not tg:
        return []
    if not isinstance(tg, list):
        raise ValueError("tenants must be a list of tenant-class specs")
    from dynamo_tpu_torch.qos.tenancy import tenant_from_dict

    normalized = [tenant_from_dict(item).to_dict() for item in tg]
    return [("DYNAMO_TPU_TENANTS",
             _json.dumps(normalized, separators=(",", ":")))]


def drain_seconds(spec: Dict[str, Any]) -> int:
    """The manifest's graceful-drain budget (`drainSeconds`, default 30):
    how long a SIGTERMed worker may spend finishing / handing off
    in-flight requests and demoting KV before it stops serving."""
    try:
        return max(0, int(spec.get("drainSeconds", 30)))
    except (TypeError, ValueError):
        return 30


def _pod_spec(
    namespace: str, dgd_name: str, svc_name: str, spec: Dict[str, Any], ctype: str,
    frontend: str = "",
) -> Dict[str, Any]:
    pod: Dict[str, Any] = {
        "containers": [_container(dgd_name, svc_name, spec, ctype, frontend)]
    }
    if ctype != "frontend":
        # drain-before-kill: the kubelet's grace period must outlast the
        # worker's DRAIN_TIMEOUT_S (set from the same drainSeconds in
        # _container) plus deregister/demote margin, or rolling restarts
        # SIGKILL pods mid-handoff
        pod["terminationGracePeriodSeconds"] = drain_seconds(spec) + 15
    else:
        # frontend drain (FRONTEND_DRAIN_S in _container) + margin: the
        # replica answers 503 on /healthz while in-flight streams finish
        pod["terminationGracePeriodSeconds"] = drain_seconds(spec) + 10
    volumes = []
    for pvc in spec.get("pvcs") or []:
        # pvcs[].create: false references an existing claim
        # (reference examples/dgdr/trtllm/disagg_cache.yaml:11-13)
        volumes.append(
            {
                "name": pvc["name"],
                "persistentVolumeClaim": {"claimName": pvc["name"]},
            }
        )
    for cm in spec.get("configMapVolumes") or []:
        # ConfigMap-backed volumes (per-role engine-config files,
        # examples/deploy/jetstream/engine-configs.yaml)
        volumes.append({"name": cm, "configMap": {"name": cm}})
    if volumes:
        pod["volumes"] = volumes
    node_sel: Dict[str, str] = {}
    if spec.get("preemptible"):
        # preemptible batch pool: land on spot-provisioned nodes (GKE
        # taints them; the toleration below is merged with any
        # user-supplied ones)
        node_sel["cloud.google.com/gke-spot"] = "true"
    if node_sel:
        pod["nodeSelector"] = node_sel
    extra = spec.get("extraPodSpec") or {}
    for key in ("tolerations", "affinity", "schedulerName", "priorityClassName"):
        if extra.get(key):
            pod[key] = extra[key]
    if spec.get("preemptible"):
        spot_tol = {"key": "cloud.google.com/gke-spot", "operator": "Equal",
                    "value": "true", "effect": "NoSchedule"}
        tols = list(pod.get("tolerations") or [])
        if spot_tol not in tols:
            tols.append(spot_tol)
        pod["tolerations"] = tols
    return pod


def build_deployment(
    cr: Dict[str, Any], svc_name: str, spec: Dict[str, Any],
    gang: bool = False, gang_scheduler: str = DEFAULT_GANG_SCHEDULER,
) -> Dict[str, Any]:
    namespace = cr["metadata"].get("namespace", "default")
    dgd_name = cr["metadata"]["name"]
    ctype = spec.get("componentType", "worker")
    frontend = frontend_host(cr)
    name = child_name(dgd_name, svc_name)
    labels = _labels(namespace, dgd_name, svc_name, ctype)
    if spec.get("subComponentType"):
        labels[f"{GROUP}/sub-component"] = spec["subComponentType"]
    pod_labels = dict(labels)
    # gang semantics for multi-pod pools: one pod-group per service
    pod_labels[POD_GROUP_LABEL] = name
    pod_meta: Dict[str, Any] = {"labels": pod_labels}
    pod_spec = _pod_spec(namespace, dgd_name, svc_name, spec, ctype, frontend)
    if gang and _gang_eligible(spec, ctype):
        # all-or-nothing placement via the coscheduling plugin: pods carry
        # the PodGroup label (what the plugin actually matches on) and are
        # bound by the gang scheduler
        pod_labels[POD_GROUP_KEY] = name
        pod_meta["annotations"] = {POD_GROUP_KEY: name}
        pod_spec.setdefault("schedulerName", gang_scheduler)
    return {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": {
            "name": name,
            "namespace": namespace,
            "labels": labels,
            "ownerReferences": [owner_reference(cr)],
        },
        "spec": {
            "replicas": int(spec.get("replicas", 1)),
            "selector": {"matchLabels": {COMPONENT_LABEL: svc_name.lower(),
                                         NS_LABEL: labels[NS_LABEL]}},
            "template": {
                "metadata": pod_meta,
                "spec": pod_spec,
            },
        },
    }


def hosts_per_replica(spec: Dict[str, Any]) -> int:
    """Pods per logical worker: > 1 would be a multi-host gang spanning
    `hostsPerReplica` pods, which the port refuses (`unserved_fields`)."""
    return int(spec.get("hostsPerReplica", 1) or 1)


def _gang_eligible(spec: Dict[str, Any], ctype: str) -> bool:
    """Gang placement applies when a service needs >1 pod to be useful at
    all: a multi-host gang (hostsPerReplica > 1, a SINGLE replica spanning
    several hosts; refused by the port) or a multi-replica worker group.
    Keyed on topology, not just replica count."""
    if ctype == "frontend":
        return False
    return int(spec.get("replicas", 1)) > 1 or hosts_per_replica(spec) > 1


def build_pod_group(
    cr: Dict[str, Any], svc_name: str, spec: Dict[str, Any]
) -> Dict[str, Any]:
    """scheduling.x-k8s.io PodGroup: minMember = the service's full replica
    count, so the coscheduling plugin holds all pods until all fit."""
    namespace = cr["metadata"].get("namespace", "default")
    dgd_name = cr["metadata"]["name"]
    name = child_name(dgd_name, svc_name)
    ctype = spec.get("componentType", "worker")
    return {
        "apiVersion": POD_GROUP_API,
        "kind": "PodGroup",
        "metadata": {
            "name": name,
            "namespace": namespace,
            "labels": _labels(namespace, dgd_name, svc_name, ctype),
            "ownerReferences": [owner_reference(cr)],
        },
        "spec": {
            # a multi-host gang needs EVERY host pod placed to be usable
            "minMember": int(spec.get("replicas", 1)) * hosts_per_replica(spec),
            "scheduleTimeoutSeconds": 300,
        },
    }


def build_service(
    cr: Dict[str, Any], svc_name: str, spec: Dict[str, Any]
) -> Dict[str, Any]:
    """Frontend gets a ClusterIP Service; workers get headless Services.

    The deploy orchestrator skips headless services when converting to
    NodePort (reference deploy-incluster.sh:409-413) and excludes
    `-d`/`-p` suffixed names from frontend selection (:459-464) — worker
    services here are headless, so both filters behave identically.

    """
    namespace = cr["metadata"].get("namespace", "default")
    dgd_name = cr["metadata"]["name"]
    ctype = spec.get("componentType", "worker")
    name = child_name(dgd_name, svc_name)
    labels = _labels(namespace, dgd_name, svc_name, ctype)
    svc: Dict[str, Any] = {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {
            "name": name,
            "namespace": namespace,
            "labels": labels,
            "ownerReferences": [owner_reference(cr)],
        },
        "spec": {
            "selector": {COMPONENT_LABEL: svc_name.lower(),
                         NS_LABEL: labels[NS_LABEL]},
            "ports": [{"port": FRONTEND_PORT, "targetPort": FRONTEND_PORT,
                       "name": "http"}],
        },
    }
    if ctype != "frontend":
        svc["spec"]["clusterIP"] = "None"
    return svc


def build_frontend_headless_service(
    cr: Dict[str, Any], svc_name: str, spec: Dict[str, Any]
) -> Dict[str, Any]:
    """Per-replica addressing for an HA frontend plane (replicas > 1).

    The ClusterIP Service is the VIP clients use; this companion headless
    Service resolves to EVERY frontend pod individually — what the chaos
    harness, per-replica drains, and debugging (`curl <pod>.<name>-
    headless/healthz`) need. publishNotReadyAddresses keeps draining
    replicas resolvable so their in-flight streams stay reachable."""
    svc = build_service(cr, svc_name, spec)
    svc["metadata"]["name"] = svc["metadata"]["name"] + "-headless"
    svc["spec"]["clusterIP"] = "None"
    svc["spec"]["publishNotReadyAddresses"] = True
    return svc


def build_pvcs(cr: Dict[str, Any]) -> List[Dict[str, Any]]:
    """PVCs with create: true are materialized by the operator."""
    namespace = cr["metadata"].get("namespace", "default")
    out = []
    seen = set()
    for spec in (cr.get("spec", {}).get("services") or {}).values():
        for pvc in spec.get("pvcs") or []:
            if not pvc.get("create") or pvc["name"] in seen:
                continue
            seen.add(pvc["name"])
            out.append(
                {
                    "apiVersion": "v1",
                    "kind": "PersistentVolumeClaim",
                    "metadata": {
                        "name": pvc["name"],
                        "namespace": namespace,
                        "ownerReferences": [owner_reference(cr)],
                    },
                    "spec": {
                        "accessModes": [pvc.get("accessMode", "ReadWriteOnce")],
                        "storageClassName": pvc.get("storageClass", "local-path"),
                        "resources": {
                            "requests": {"storage": pvc.get("size", "10Gi")}
                        },
                    },
                }
            )
    return out


def materialize(
    cr: Dict[str, Any], gang: bool = False,
    gang_scheduler: str = DEFAULT_GANG_SCHEDULER,
    replica_overrides: Optional[Dict[str, int]] = None,
) -> Dict[str, List[Dict[str, Any]]]:
    """CR -> {deployments, statefulsets, services, pvcs, podgroups}
    (`statefulsets` always empty: the port materializes no multi-host
    gang). Raises Unserved naming every field the port does not serve.

    `replica_overrides` ({service_name: replicas}) is the autoscaler's
    channel: the controller passes its current per-service decision so a
    reconcile pass never reverts a scale the planner made (the CR's own
    `replicas` stays the operator-independent baseline)."""
    refused = unserved_fields(cr)
    if refused:
        raise Unserved(refused)
    services = cr.get("spec", {}).get("services") or {}
    deployments = []
    svcs = []
    podgroups = []
    for svc_name, spec in services.items():
        if replica_overrides and svc_name in replica_overrides:
            spec = {**spec, "replicas": int(replica_overrides[svc_name])}
        deployments.append(
            build_deployment(cr, svc_name, spec, gang=gang,
                             gang_scheduler=gang_scheduler)
        )
        svcs.append(build_service(cr, svc_name, spec))
        ctype = spec.get("componentType", "worker")
        if ctype == "frontend" and int(spec.get("replicas", 1)) > 1:
            # HA frontend plane: VIP + per-replica headless companion
            svcs.append(build_frontend_headless_service(cr, svc_name, spec))
        if gang and _gang_eligible(spec, ctype):
            podgroups.append(build_pod_group(cr, svc_name, spec))
    return {
        "deployments": deployments,
        "statefulsets": [],
        "services": svcs,
        "pvcs": build_pvcs(cr),
        "podgroups": podgroups,
    }
