"""Reconcile loop: DynamoGraphDeployment(Request) CRs -> child resources.

Level-triggered reconciliation in two modes: resourceVersion WATCH streams
with a periodic full-relist resync (the controller-runtime-style default —
events trigger immediate passes, the resync backstop self-heals missed
ones), or a plain poll loop (`--no-watch`, single-node dev). Every pass is
a full list + diff, so both modes are self-healing by construction (the
reference's recovery posture is the same K8s-native self-healing,
SURVEY.md §5). Lease-based leader election (leader.py) gates passes so
`replicas: 2` is an HA pair.

DGD flow:  CR -> materialize() -> upsert Deployments/Services/PVCs, delete
stale children by ownership labels, roll child readiness up into CR status.
DGDR flow: CR -> render the DGD template from its ConfigMap, apply the SLA
profiler's deployment overrides, then (autoApply) create the DGD — mirroring
the operator-side DGDR pipeline (reference examples/dgdr/trtllm/
dgdr.yaml:14-36, run-dgdr.sh:22-29).

The port's copy of `dynamo_tpu/operator/controller.py`, for GPUs: the SLA
sweep runs the port's profiler over the GPU catalog
(`profilingConfig.tpuSystem` names an `h100-sxm-<N>` system, default
`h100-sxm-8`), the profiler Job runs `python3 -m dynamo_tpu_torch.profiler`,
and a CR that sets what the port does not serve is refused by name: a DGD
with a field `materialize.unserved_fields` lists gets state `failed` and a
`Ready=False` condition of reason `Unserved` naming each field (its
children are left as they were), a DGDR whose `tpuSystem` is not in the
GPU catalog goes `failed` naming `spec.profilingConfig.tpuSystem`.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, List, Optional

from dynamo_tpu_torch.operator import materialize as mat
from dynamo_tpu_torch.operator.k8s_client import ApiError, K8sClient
from dynamo_tpu_torch.planner import planner as planner_mod
from dynamo_tpu_torch.planner.signals import (
    Forecaster,
    PoolSignals,
    SignalsCollector,
    parse_metrics_text,
)
from dynamo_tpu_torch.serving.metrics import Counter, Gauge, Registry

log = logging.getLogger("dynamo_tpu_torch.operator")

# drain-before-delete (hitless rollouts): a stale worker Deployment/
# StatefulSet is first scaled to 0 — SIGTERM runs each pod's graceful
# drain (admission off, in-flight handoff, KV demote) under the pod's
# terminationGracePeriod — and only deleted on a later pass once its
# pods are gone. The annotation records that phase 1 happened.
DRAIN_ANNOTATION = f"{mat.GROUP}/drain-before-delete"
# drain-before-shrink (planner v2 scale-down): the chosen victim pod is
# annotated so (a) the Deployment controller deletes IT rather than a
# random peer (pod-deletion-cost) and (b) operators can see who is
# draining; the controller also best-effort POSTs /internal/drain so the
# pod starts shedding before its SIGTERM even arrives.
DRAIN_VICTIM_ANNOTATION = f"{mat.GROUP}/drain-victim"
POD_DELETION_COST = "controller.kubernetes.io/pod-deletion-cost"

# burn-gated weight rollouts (dynamo_tpu_torch.elasticity): a fast-window SLO
# burn above this threshold observed while a fleet flip is in progress
# rolls every already-flipped pod back to the previous version
ROLLOUT_MAX_BURN_ENV = "DYNAMO_TPU_ROLLOUT_MAX_BURN"
# seconds between per-pod flips — one pod at a time, paced so the 5m
# fast burn window can react to a bad canary before the next pod flips
ROLLOUT_STEP_ENV = "DYNAMO_TPU_ROLLOUT_STEP_S"


def _yaml_load(text: str) -> Dict[str, Any]:
    try:
        import yaml

        return yaml.safe_load(text)
    except ImportError:  # pragma: no cover - pyyaml is in the baked image
        return json.loads(text)


class Controller:
    def __init__(self, client: K8sClient, namespace: Optional[str] = "default",
                 gang: bool = False,
                 gang_scheduler: str = mat.DEFAULT_GANG_SCHEDULER):
        """namespace=None watches every namespace (cluster-wide list), the
        reference operator's default; a concrete namespace restricts it (the
        NAMESPACE_RESTRICTED_OPERATOR analogue,
        reference install-dynamo-1node.sh:32,203-205). gang=True emits
        coscheduling PodGroups for multi-pod worker services (the Grove/KAI
        opt-in analogue, :35-36,207-212)."""
        self.k8s = client
        self.namespace = namespace
        self.gang = gang
        self.gang_scheduler = gang_scheduler
        # live-metrics planner (the Dynamo planner analogue): per-service
        # replica decisions + scale-down hysteresis bookkeeping, keyed
        # (namespace, dgd, service). Flows into materialize() as
        # replica_overrides so reconciles never revert a scale.
        self._planner: Dict[tuple, Dict[str, Any]] = {}
        # planner v2 (dynamo_tpu_torch.planner): one coordinated PoolPlanner +
        # traffic Forecaster per DGD that declares pool-aware autoscaling
        # (`autoscaling.role`/`autoscaling.pool`), keyed (namespace, dgd)
        self._pool_planners: Dict[tuple, planner_mod.PoolPlanner] = {}
        self._forecasters: Dict[tuple, Forecaster] = {}
        # hardened signal scrapes: per-URL last-good cache with a
        # staleness bound + error counting
        self.collector = SignalsCollector()
        self._scrape_err_seen = 0
        self._decisions_seen: Dict[tuple, int] = {}
        # live weight rollouts (dynamo_tpu_torch.elasticity): per-service
        # progressive flip state keyed (namespace, dgd, service) —
        # target version, pods already flipped, pacing timestamp,
        # terminal state. A rolled_back rollout HOLDS (no re-flip)
        # until the manifest's modelVersion changes.
        self._rollouts: Dict[tuple, Dict[str, Any]] = {}
        self.registry = Registry()
        self.target_gauge = Gauge(
            "dynamo_planner_target_replicas",
            "Planner's current per-service replica target", self.registry,
            labelnames=("namespace", "dgd", "service"))
        self.forecast_gauge = Gauge(
            "dynamo_planner_forecast_rps",
            "Short-horizon forecast demand routed to the pool (rps)",
            self.registry, labelnames=("namespace", "dgd", "service"))
        self.decisions_counter = Counter(
            "dynamo_planner_decisions_total",
            "Applied planner replica changes", self.registry,
            labelnames=("namespace", "dgd", "service", "direction"))
        self.scrape_errors_counter = Counter(
            "dynamo_planner_scrape_errors_total",
            "Planner signal scrapes that failed (served from last-good "
            "cache when within the staleness bound)", self.registry)
        self.rollout_gauge = Gauge(
            "dynamo_operator_weight_rollout_flipped",
            "Pods flipped to the service's target weight version by the "
            "rollout controller", self.registry,
            labelnames=("namespace", "dgd", "service"))
        self.rollout_counter = Counter(
            "dynamo_operator_weight_rollout_total",
            "Rollout controller per-pod actions (flip = staged + flipped "
            "to the target, rollback = burn-gated revert, commit = "
            "rollback window closed)", self.registry,
            labelnames=("namespace", "dgd", "service", "direction"))

    @staticmethod
    def _ns(cr: Dict[str, Any]) -> str:
        return cr["metadata"].get("namespace") or "default"

    def _planner_overrides(self, ns: str, name: str) -> Dict[str, int]:
        return {svc: st["replicas"] for (n, d, svc), st
                in self._planner.items()
                if n == ns and d == name and st.get("replicas")}

    def _prune_planner(self, cr: Dict[str, Any]) -> None:
        """Drop planner decisions whose service lost its `autoscaling`
        block (or vanished) — checked on EVERY reconcile, not just in
        planner_tick, so removing autoscaling from the CR takes effect on
        the next watch event instead of persisting a stale replica
        override for up to a planner interval."""
        ns, name = self._ns(cr), cr["metadata"]["name"]
        services = cr.get("spec", {}).get("services") or {}
        stale = [key for key in self._planner
                 if key[0] == ns and key[1] == name
                 and not ((services.get(key[2]) or {}).get("autoscaling")
                          or {}).get("enabled")]
        for key in stale:
            log.info("planner: dropping stale override for %s/%s.%s "
                     "(autoscaling removed)", *key)
            del self._planner[key]

    # ------------------------------------------------------------- children --
    def _owned(self, api_version: str, plural: str, ns: str,
               ns_label: str) -> List[Dict]:
        sel = f"{mat.MANAGED_BY_LABEL}={mat.OPERATOR_NAME},{mat.NS_LABEL}={ns_label}"
        return self.k8s.list(api_version, plural, ns, label_selector=sel)

    def _drain_then_delete(self, api_version: str, plural: str, ns: str,
                           existing: Dict[str, Any]) -> None:
        """Two-phase prune: scale a stale workload to 0 first (its pods'
        SIGTERM drain hands in-flight requests off and demotes KV), then
        delete once the drain has actually happened — a raw delete would
        race the pods' grace period against the controller's cascade and
        drop whatever was mid-stream."""
        meta = existing["metadata"]
        name = meta["name"]
        ann = meta.get("annotations") or {}
        spec_replicas = int((existing.get("spec") or {}).get("replicas")
                            or 0)
        live = int((existing.get("status") or {}).get("replicas") or 0)
        if ann.get(DRAIN_ANNOTATION) and spec_replicas == 0 and live == 0:
            log.info("pruning drained %s %s/%s", plural, ns, name)
            self.k8s.delete(api_version, plural, ns, name)
            return
        if not ann.get(DRAIN_ANNOTATION) or spec_replicas != 0:
            log.info("draining stale %s %s/%s before delete", plural, ns,
                     name)
            self.k8s.merge_patch(api_version, plural, ns, name, {
                "metadata": {"annotations": {DRAIN_ANNOTATION: "true"}},
                "spec": {"replicas": 0},
            })
        # else: scaled to 0, pods still terminating — revisit next pass

    def reconcile_dgd(self, cr: Dict[str, Any]) -> None:
        name = cr["metadata"]["name"]
        ns = self._ns(cr)
        ns_label = mat.discovery_label_value(ns, name)
        self._prune_planner(cr)
        try:
            desired = mat.materialize(
                cr, gang=self.gang, gang_scheduler=self.gang_scheduler,
                replica_overrides=self._planner_overrides(ns, name))
        except mat.Unserved as e:
            log.warning("DGD %s/%s refused: %s", ns, name, e)
            self._patch_dgd_status(cr, {
                "state": "failed", "unserved": e.fields,
                "conditions": [{"type": "Ready", "status": "False",
                                "reason": "Unserved", "message": str(e)}]})
            return

        # PodGroups first: the gang scheduler must see the group before the
        # Deployment's pods arrive, or they schedule ungated. A cluster with
        # gang enabled but no PodGroup CRD must still get its Deployments —
        # warn once and continue ungated rather than failing every reconcile.
        for pg in desired["podgroups"]:
            try:
                self.k8s.upsert(mat.POD_GROUP_API, "podgroups", ns, pg)
            except ApiError as e:
                if not e.not_found:
                    raise
                log.warning(
                    "PodGroup CRD (%s) not installed; %s/%s schedules without "
                    "gang gating", mat.POD_GROUP_API, ns,
                    pg["metadata"]["name"],
                )
        for dep in desired["deployments"]:
            self.k8s.upsert("apps/v1", "deployments", ns, dep)
        for sts in desired["statefulsets"]:
            self.k8s.upsert("apps/v1", "statefulsets", ns, sts)
        for svc in desired["services"]:
            self.k8s.upsert("v1", "services", ns, svc)
        for pvc in desired["pvcs"]:
            try:
                self.k8s.create("v1", "persistentvolumeclaims", ns, pvc)
            except ApiError as e:
                if not e.conflict:  # PVC specs are immutable; leave existing
                    raise

        # prune children whose service was removed from the CR —
        # drain-before-delete: scale to 0 (graceful pod drain) on the
        # first pass, delete on a later one
        want_deps = {d["metadata"]["name"] for d in desired["deployments"]}
        kept_deps = []
        for existing in self._owned("apps/v1", "deployments", ns, ns_label):
            if existing["metadata"]["name"] not in want_deps:
                self._drain_then_delete("apps/v1", "deployments", ns,
                                        existing)
            else:
                kept_deps.append(existing)
        want_sts = {s["metadata"]["name"] for s in desired["statefulsets"]}
        for existing in self._owned("apps/v1", "statefulsets", ns, ns_label):
            if existing["metadata"]["name"] not in want_sts:
                self._drain_then_delete("apps/v1", "statefulsets", ns,
                                        existing)
            else:
                kept_deps.append(existing)  # joins the DGD status rollup
        want_svcs = {s["metadata"]["name"] for s in desired["services"]}
        for existing in self._owned("v1", "services", ns, ns_label):
            if existing["metadata"]["name"] not in want_svcs:
                self.k8s.delete(
                    "v1", "services", ns, existing["metadata"]["name"]
                )
        if self.gang:
            want_pgs = {p["metadata"]["name"] for p in desired["podgroups"]}
            try:
                for existing in self._owned(
                    mat.POD_GROUP_API, "podgroups", ns, ns_label
                ):
                    if existing["metadata"]["name"] not in want_pgs:
                        self.k8s.delete(
                            mat.POD_GROUP_API, "podgroups", ns,
                            existing["metadata"]["name"],
                        )
            except ApiError as e:
                if not e.not_found:  # PodGroup CRD not installed
                    raise

        self._update_dgd_status(cr, kept_deps)

    def _update_dgd_status(
        self, cr: Dict[str, Any], owned_deps: List[Dict[str, Any]]
    ) -> None:
        ns = self._ns(cr)
        ready = 0
        total = 0
        for dep in owned_deps:
            total += int(dep.get("spec", {}).get("replicas", 1))
            ready += int(dep.get("status", {}).get("readyReplicas") or 0)
        state = "successful" if total > 0 and ready >= total else "pending"
        planner = self._planner_overrides(
            ns, cr["metadata"]["name"])
        status = {
            "state": state,
            "readyReplicas": ready,
            "desiredReplicas": total,
            # persisted planner decisions: a restarted/failover operator
            # seeds its in-memory planner from here (planner_tick).
            # Explicit null when empty — patch_status is an RFC 7386
            # merge-patch, so OMITTING the key would retain a stale map
            # (and resurrect an old scale when autoscaling is re-enabled)
            "plannerReplicas": planner or None,
            "unserved": None,
            "conditions": [
                {
                    "type": "Ready",
                    "status": "True" if state == "successful" else "False",
                    "reason": f"{ready}/{total} replicas ready",
                }
            ],
        }
        self._patch_dgd_status(cr, status)

    def _patch_dgd_status(self, cr: Dict[str, Any],
                          status: Dict[str, Any]) -> None:
        try:
            self.k8s.patch_status(
                mat.API_VERSION, mat.DGD_PLURAL, self._ns(cr),
                cr["metadata"]["name"], status,
            )
        except ApiError as e:
            if not e.not_found:  # CR deleted mid-reconcile
                log.warning("status update failed: %s", e)

    # ----------------------------------------------------------------- DGDR --
    def reconcile_dgdr(self, cr: Dict[str, Any]) -> None:
        """SLA-driven deployment request: template + profiler -> DGD.

        With `profilingConfig.profilerImage` set, the sweep runs as its OWN
        pod (a Job in the DGDR's namespace — the reference's profiler-pod
        topology, reference examples/dgdr/trtllm/dgdr.yaml:15); the
        pod executes `python -m dynamo_tpu_torch.profiler --dgdr <name>`, which is
        run_dgdr() below — exactly the inline path. Without the field, the
        sweep runs inline in the operator (simpler, same result)."""
        if (cr.get("status") or {}).get("state") in ("successful", "failed"):
            return  # one-shot: profiling requests don't re-run
        image = ((cr.get("spec", {}).get("profilingConfig") or {})
                 .get("profilerImage"))
        if image:
            self._reconcile_profiler_job(cr, image)
        else:
            run_dgdr(self.k8s, cr)

    def _reconcile_profiler_job(self, cr: Dict[str, Any], image: str) -> None:
        """Drive the dispatched sweep Job through its lifecycle.

        No Job -> create it (plus the per-namespace profiler ServiceAccount
        and a namespace-scoped Role: read DGDRs + configmaps, write DGDR
        status, create DGDs — these are SHARED by every DGDR in the
        namespace, so they carry no owner and are not deleted on DGDR
        deletion; the Job itself is owned and cascades).
        Job Failed (backoff exhausted) -> DGDR goes terminal 'failed'.
        Job Complete but DGDR still non-terminal -> the pod exited in the
        'pending' retry state (template ConfigMap missing); delete the Job
        so the next pass re-dispatches — preserving the inline path's
        retry-until-rendered contract at Job granularity."""
        ns = self._ns(cr)
        name = cr["metadata"]["name"]
        try:
            job = self.k8s.get("batch/v1", "jobs", ns, f"{name}-profiler")
        except ApiError as e:
            if not e.not_found:
                raise
            job = None
        if job is not None:
            conds = {c.get("type"): c.get("status")
                     for c in (job.get("status") or {}).get("conditions", [])}
            if conds.get("Failed") == "True":
                _set_dgdr_status(
                    self.k8s, ns, name, "failed",
                    f"profiler pod failed after retries (image {image}); "
                    "see the Job's pod logs")
            elif conds.get("Complete") == "True":
                # pod ran but left the DGDR non-terminal: retryable state.
                # Background propagation: a bare API delete would ORPHAN the
                # Job's completed pod, leaking one pod per retry cycle
                self.k8s.delete("batch/v1", "jobs", ns, f"{name}-profiler",
                                propagation="Background")
            return  # running (or just handled): nothing else to write
        self._ensure_profiler_rbac(ns)
        self._create_profiler_job(cr, image)

    def _ensure_profiler_rbac(self, ns: str) -> None:
        sa = "dynamo-tpu-profiler"
        self.k8s.upsert("v1", "serviceaccounts", ns, {
            "apiVersion": "v1", "kind": "ServiceAccount",
            "metadata": {"name": sa, "namespace": ns},
        })
        self.k8s.upsert("rbac.authorization.k8s.io/v1", "roles", ns, {
            "apiVersion": "rbac.authorization.k8s.io/v1", "kind": "Role",
            "metadata": {"name": sa, "namespace": ns},
            "rules": [
                {"apiGroups": [mat.GROUP],
                 "resources": [mat.DGDR_PLURAL],
                 "verbs": ["get", "list"]},
                {"apiGroups": [mat.GROUP],
                 "resources": [f"{mat.DGDR_PLURAL}/status"],
                 "verbs": ["get", "update", "patch"]},
                {"apiGroups": [mat.GROUP],
                 "resources": [mat.DGD_PLURAL],
                 "verbs": ["get", "create", "update", "patch"]},
                {"apiGroups": [""], "resources": ["configmaps"],
                 "verbs": ["get", "list"]},
            ],
        })
        self.k8s.upsert("rbac.authorization.k8s.io/v1", "rolebindings", ns, {
            "apiVersion": "rbac.authorization.k8s.io/v1",
            "kind": "RoleBinding",
            "metadata": {"name": sa, "namespace": ns},
            "roleRef": {"apiGroup": "rbac.authorization.k8s.io",
                        "kind": "Role", "name": sa},
            "subjects": [{"kind": "ServiceAccount", "name": sa,
                          "namespace": ns}],
        })

    def _create_profiler_job(self, cr: Dict[str, Any], image: str) -> None:
        ns = self._ns(cr)
        name = cr["metadata"]["name"]
        owner = [mat.owner_reference(cr)]
        sa = "dynamo-tpu-profiler"
        job = {
            "apiVersion": "batch/v1",
            "kind": "Job",
            "metadata": {
                "name": f"{name}-profiler",
                "namespace": ns,
                "labels": {mat.MANAGED_BY_LABEL: mat.OPERATOR_NAME},
                "ownerReferences": owner,
            },
            "spec": {
                "backoffLimit": 2,
                "ttlSecondsAfterFinished": 3600,
                "template": {
                    "metadata": {"labels": {
                        mat.MANAGED_BY_LABEL: mat.OPERATOR_NAME,
                        f"{mat.GROUP}/profiler-for": name,
                    }},
                    "spec": {
                        "restartPolicy": "Never",
                        "serviceAccountName": sa,
                        "containers": [{
                            "name": "profiler",
                            "image": image,
                            "command": [
                                "python3", "-m", "dynamo_tpu_torch.profiler",
                                "--dgdr", name, "--namespace", ns,
                            ],
                        }],
                    },
                },
            },
        }
        try:
            self.k8s.create("batch/v1", "jobs", ns, job)
            log.info("profiler Job %s/%s-profiler dispatched (image %s)",
                     ns, name, image)
        except ApiError as e:
            if not e.conflict:  # Job pod specs are immutable: create-once
                raise
            return  # raced another pass: it already wrote the status
        _set_dgdr_status(self.k8s, ns, name, "profiling",
                         f"profiler pod running ({image})")

    # -------------------------------------------------------------- planner --
    def planner_tick(self, now: Optional[float] = None) -> int:
        """Live-metrics autoscaling pass (the Dynamo planner analogue,
        beyond the reference repo's static DGDR sizing).

        Two generations share the actuation path (replica_overrides +
        plannerReplicas status persistence):

        - v1 (queue-proportional): services with a plain `autoscaling`
          block resize toward ceil(queued / targetQueuedPerReplica),
          clamped to [minReplicas, maxReplicas], with the SLO-burn boost.
        - v2 (pool-aware, dynamo_tpu_torch.planner): services that declare
          `autoscaling.role`/`autoscaling.pool` are planned per DGD by a
          coordinated PoolPlanner — forecast demand from the frontend's
          request-rate ring, per-pool roofline capacity, prefill/decode
          scaled jointly in one tick, scale-down stepping one drained
          victim at a time (`_mark_drain_victims`).

        Scale-UP applies immediately; scale-DOWN waits out
        scaleDownDelaySeconds of sustained low load (flapping costs real
        GPU warmup time). Returns the number of services whose decision
        changed; reconcile applies the decisions via
        materialize(replica_overrides=...)."""
        now = time.monotonic() if now is None else now
        changed = 0
        try:
            dgds = self.k8s.list(mat.API_VERSION, mat.DGD_PLURAL,
                                 self.namespace)
        except ApiError:
            return 0
        live = set()
        live_v2 = set()
        # gather first, then scrape every unique URL CONCURRENTLY: the
        # tick runs on the reconcile thread, and N serially-unreachable
        # frontends (exactly the state during an initial rollout) must
        # not stall reconciles by N x timeout
        work = []
        v2_dgds: Dict[tuple, Dict[str, Any]] = {}
        urls: Dict[tuple, str] = {}
        for cr in dgds:
            ns, name = self._ns(cr), cr["metadata"]["name"]
            services = cr.get("spec", {}).get("services") or {}
            for svc_name, spec in services.items():
                auto = spec.get("autoscaling") or {}
                if not auto.get("enabled"):
                    continue
                live.add((ns, name, svc_name))
                urls[(ns, name, svc_name)] = auto.get("metricsUrl") or (
                    f"http://{mat.frontend_host(cr)}.{ns}:"
                    f"{mat.FRONTEND_PORT}/metrics")
                if planner_mod.is_pool_autoscaling(auto):
                    d = v2_dgds.setdefault((ns, name),
                                           {"cr": cr, "pools": []})
                    d["pools"].append((svc_name, spec, auto))
                else:
                    work.append((cr, ns, name, svc_name, spec, auto))
        scrapes = self._scrape_all(set(urls.values()))
        for cr, ns, name, svc_name, spec, auto in work:
            lo = max(1, int(auto.get("minReplicas", 1)))
            hi = max(lo, int(auto.get("maxReplicas",
                                      spec.get("replicas", 1))))
            target = max(1, int(auto.get("targetQueuedPerReplica", 4)))
            delay = float(auto.get("scaleDownDelaySeconds", 120))
            key = (ns, name, svc_name)
            st = self._planner.get(key)
            if st is None:
                # seed from the DGD status (written by the reconcile's
                # rollup) so an operator restart or leader failover
                # resumes the standing scale instead of snapping back to
                # the CR baseline mid-load
                persisted = ((cr.get("status") or {})
                             .get("plannerReplicas") or {}).get(svc_name)
                st = self._planner[key] = {
                    "replicas": int(persisted or spec.get("replicas", 1)),
                    "low_since": None}
            signals = scrapes.get(urls[key])
            if signals is None:
                continue  # unreachable metrics: hold the last decision
            queued = signals["queued"]
            burn = signals.get("burn", 0.0)
            # watchdog-quarantined workers count against the Deployment
            # but serve nothing: size for demand PLUS the dead replicas
            # so effective capacity stays whole until quarantine_tick
            # replaces them
            quarantined = int(signals.get("quarantined") or 0)
            st["replicas"] = max(lo, min(hi, st["replicas"]))
            want = max(lo, min(hi, -(-int(queued) // target) + quarantined))
            # SLO-burn boost (the ROADMAP's SLO-driven autoscaling seam,
            # fed by observability/slo.py): an active fast-window burn
            # means the pool is missing its objectives at the CURRENT
            # scale even if the queue looks tame — add ONE replica at the
            # start of a burn episode, then hold the scale (the 5m window
            # lags the capacity add, so re-boosting every tick would race
            # straight to maxReplicas; the queue signal keeps handling
            # proportional pressure). Opt out per service with
            # autoscaling.sloBurnBoost: false.
            if burn > 1.0 and auto.get("sloBurnBoost", True):
                if not st.get("burn_active"):
                    st["burn_active"] = True
                    want = max(want, min(hi, st["replicas"] + 1))
                else:
                    want = max(want, st["replicas"])  # no mid-burn shrink
            else:
                st["burn_active"] = False
            if want > st["replicas"]:
                log.info("planner: %s/%s.%s %d -> %d (queued=%d burn=%.2f)",
                         ns, name, svc_name, st["replicas"], want, queued,
                         burn)
                st["replicas"] = want
                st["low_since"] = None
                changed += 1
                self.decisions_counter.inc(namespace=ns, dgd=name,
                                           service=svc_name, direction="up")
            elif want < st["replicas"]:
                if self._rollout_active(key):
                    # never shrink mid-weight-rollout: a scale-down could
                    # delete exactly the already-flipped pods and the
                    # drain churn muddies the burn signal the gate reads
                    st["low_since"] = None
                elif st["low_since"] is None:
                    st["low_since"] = now
                elif now - st["low_since"] >= delay:
                    log.info("planner: %s/%s.%s %d -> %d after %.0fs "
                             "low load", ns, name, svc_name,
                             st["replicas"], want, now - st["low_since"])
                    st["replicas"] = want
                    st["low_since"] = None
                    changed += 1
                    self.decisions_counter.inc(namespace=ns, dgd=name,
                                               service=svc_name,
                                               direction="down")
            else:
                st["low_since"] = None
            self.target_gauge.set(st["replicas"], namespace=ns, dgd=name,
                                  service=svc_name)
        for key2, info in v2_dgds.items():
            live_v2.add(key2)
            try:
                changed += self._pool_tick(key2[0], key2[1], info, urls,
                                           scrapes, now)
            except Exception:
                log.exception("planner: pool tick for %s/%s failed", *key2)
        for key in [k for k in self._planner if k not in live]:
            del self._planner[key]  # DGD/service removed or autoscaling off
        for key2 in [k for k in self._pool_planners if k not in live_v2]:
            del self._pool_planners[key2]
            self._forecasters.pop(key2, None)
        # surface collector-side scrape failures on the operator registry
        delta = self.collector.scrape_errors_total - self._scrape_err_seen
        if delta > 0:
            self.scrape_errors_counter.inc(delta)
            self._scrape_err_seen = self.collector.scrape_errors_total
        return changed

    # --------------------------------------------------------- planner v2 --
    def _scrape_all(self, urls) -> Dict[str, Optional[Dict[str, Any]]]:
        """Scrape every unique URL concurrently with PER-FUTURE failure
        isolation: one scrape raising (or timing out) must lose only its
        own pool's fresh signals for the tick, never the whole batch —
        and even then the collector serves its last-good result while it
        is within the staleness bound (an `ex.map` zip would drop every
        service's signals when any one scrape raised mid-executor)."""
        out: Dict[str, Optional[Dict[str, Any]]] = {}
        unique = sorted(urls)
        if not unique:
            return out
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(8, len(unique))) as ex:
            futs = {url: ex.submit(self._scrape_signals, url)
                    for url in unique}
            for url, fut in futs.items():
                try:
                    out[url] = fut.result()
                except Exception:  # noqa: BLE001 — isolation boundary
                    log.exception("planner: scrape of %s raised", url)
                    self.collector.scrape_errors_total += 1
                    out[url] = self.collector.recall(url)
        return out

    def _scrape_signals(self, url: str) -> Optional[Dict[str, Any]]:
        """Planner inputs from one Prometheus text page: the
        queued-requests gauge, the fast-window SLO burn rates split by
        objective, and per-tenant inflight (planner/signals.py does the
        parsing). Returns None when the page is unreachable past the
        last-good staleness bound, or carries no queue gauge (hold the
        last decision)."""
        parsed = self.collector.scrape_metrics(url)
        if parsed is None or parsed.get("queued") is None:
            return None
        return parsed

    def _pool_tick(self, ns: str, name: str, info: Dict[str, Any],
                   urls: Dict[tuple, str],
                   scrapes: Dict[str, Optional[Dict[str, Any]]],
                   now: float) -> int:
        """One coordinated planning pass for a DGD's pool-aware services."""
        cr = info["cr"]
        specs: List[planner_mod.PoolSpec] = []
        autos: Dict[str, Dict[str, Any]] = {}
        for svc_name, spec, auto in info["pools"]:
            try:
                ps = planner_mod.pool_spec_from_manifest(svc_name, spec)
            except ValueError as e:
                log.warning("planner: %s/%s.%s invalid pool autoscaling "
                            "(%s); service skipped this tick", ns, name,
                            svc_name, e)
                continue
            if ps is not None:
                specs.append(ps)
                autos[svc_name] = auto
        if not specs:
            return 0
        key2 = (ns, name)
        persisted = (cr.get("status") or {}).get("plannerReplicas") or {}
        services = cr.get("spec", {}).get("services") or {}
        pl = self._pool_planners.get(key2)
        if pl is None or set(pl.pools) != {p.name for p in specs}:
            pl = planner_mod.PoolPlanner(specs)
            for p in specs:
                # a restarted/failover operator resumes the standing
                # scale from the DGD status rollup — seeding is not a
                # decision (no journal entry, no changed count)
                seed = persisted.get(p.name) or (
                    services.get(p.name) or {}).get("replicas",
                                                    p.min_replicas)
                pl.seed(p.name, int(seed))
            self._pool_planners[key2] = pl
        else:
            for p in specs:  # manifest edits take effect next tick
                pl.pools[p.name] = p

        fc = self._forecasters.get(key2)
        if fc is None:
            fc = self._forecasters[key2] = Forecaster()
        hist_url = None
        for svc_name in autos:
            hist_url = autos[svc_name].get("historyUrl") or hist_url
        if hist_url is None:
            hist_url = (f"http://{mat.frontend_host(cr)}.{ns}:"
                        f"{mat.FRONTEND_PORT}/debug/slo?history=1")
        payload = self.collector.scrape_history(hist_url)
        if payload:
            fc.ingest_history(payload.get("history") or [],
                              payload.get("bucket_s"))
        horizon = max(p.forecast_horizon_s for p in specs)
        forecast = fc.forecast(horizon)

        signals: Dict[str, PoolSignals] = {}
        for p in specs:
            scraped = scrapes.get(urls.get((ns, name, p.name), ""))
            if scraped is None:
                continue  # unreachable + stale: pool holds its decision
            signals[p.name] = PoolSignals(
                role=p.role,
                queued=float(scraped.get("queued") or 0.0),
                inflight=float(scraped.get("inflight") or 0.0),
                burn_ttft=float(scraped.get("burn_ttft") or 0.0),
                burn_itl=float(scraped.get("burn_itl") or 0.0),
                burn=float(scraped.get("burn") or 0.0),
                quarantined=int(scraped.get("quarantined") or 0),
                tenant_inflight=dict(scraped.get("tenant_inflight") or {}),
                rps=fc.rate(), forecast_rps=forecast, ts=now,
                stale=bool(scraped.get("stale")))

        targets = pl.tick(signals, now)
        changed = 0
        for svc_name, target in targets.items():
            key = (ns, name, svc_name)
            st = self._planner.get(key)
            if st is None:
                seed = int(persisted.get(svc_name) or (
                    services.get(svc_name) or {}).get("replicas", target))
                st = self._planner[key] = {"replicas": seed,
                                           "low_since": None}
            prev = int(st["replicas"])
            if target < prev and self._rollout_active(key):
                target = prev  # hold scale-down mid-weight-rollout
            if target != prev:
                log.info("planner: %s/%s.%s pool %d -> %d "
                         "(forecast=%.1frps)", ns, name, svc_name, prev,
                         target, pl.last_forecast.get(svc_name, 0.0))
                if target < prev:
                    self._mark_drain_victims(ns, name, svc_name,
                                             prev - target)
                st["replicas"] = target
                changed += 1
                self.decisions_counter.inc(
                    namespace=ns, dgd=name, service=svc_name,
                    direction="up" if target > prev else "down")
            self.target_gauge.set(target, namespace=ns, dgd=name,
                                  service=svc_name)
            self.forecast_gauge.set(
                round(pl.last_forecast.get(svc_name, 0.0), 3),
                namespace=ns, dgd=name, service=svc_name)
        return changed

    # ------------------------------------------------------- quarantine --
    def quarantine_tick(self, now: Optional[float] = None) -> int:
        """Replace watchdog-quarantined workers (docs/robustness.md
        "Engine watchdog & quarantine"): an engine that reached the
        terminal `quarantined` state serves nothing and never recovers
        in place, so its pod is DELETED — the Deployment controller
        recreates a fresh replica on (possibly) healthy silicon. The
        frontend's per-worker health gauge names the victims; pods are
        matched by podIP. Returns pods deleted."""
        import re as _re

        deleted = 0
        try:
            dgds = self.k8s.list(mat.API_VERSION, mat.DGD_PLURAL,
                                 self.namespace)
        except ApiError:
            return 0
        for cr in dgds:
            ns, name = self._ns(cr), cr["metadata"]["name"]
            url = (f"http://{mat.frontend_host(cr)}.{ns}:"
                   f"{mat.FRONTEND_PORT}/metrics")
            parsed = self.collector.scrape_metrics(url)
            victims = (parsed or {}).get("quarantined_workers") or []
            if not victims:
                continue
            ips = set()
            for u in victims:
                m = _re.match(r"https?://([^:/]+)", u)
                if m:
                    ips.add(m.group(1))
            if not ips:
                continue
            sel = f"{mat.NS_LABEL}={mat.discovery_label_value(ns, name)}"
            try:
                pods = self.k8s.list("v1", "pods", ns, label_selector=sel)
            except ApiError as e:
                log.debug("quarantine: pod listing failed (%s)", e)
                continue
            for pod in pods:
                if (pod.get("status") or {}).get("podIP") not in ips:
                    continue
                pod_name = pod["metadata"]["name"]
                try:
                    self.k8s.delete("v1", "pods", ns, pod_name)
                except ApiError as e:
                    log.warning("quarantine: deleting %s/%s failed: %s",
                                ns, pod_name, e)
                    continue
                deleted += 1
                log.warning("quarantine: replaced pod %s/%s (engine "
                            "quarantined at %s)", ns, pod_name,
                            victims)
        return deleted

    def _mark_drain_victims(self, ns: str, dgd: str, svc_name: str,
                            n: int) -> List[str]:
        """Pick and mark `n` victim pods for a hitless scale-down BEFORE
        the Deployment shrinks: newest pods first (least accumulated KV /
        prefix-cache value), annotated with a negative pod-deletion-cost
        so the ReplicaSet controller deletes exactly them, plus a
        best-effort pre-drain POST so shedding/handoff/KV-demotion starts
        ahead of the SIGTERM. Purely advisory — any failure here degrades
        to the plain SIGTERM drain the pod runs anyway."""
        sel = (f"{mat.COMPONENT_LABEL}={svc_name.lower()},"
               f"{mat.NS_LABEL}={mat.discovery_label_value(ns, dgd)}")
        try:
            pods = self.k8s.list("v1", "pods", ns, label_selector=sel)
        except ApiError as e:
            log.debug("planner: victim listing failed (%s)", e)
            return []
        fresh = [p for p in pods
                 if not ((p["metadata"].get("annotations") or {})
                         .get(DRAIN_VICTIM_ANNOTATION))]
        fresh.sort(key=lambda p: (p["metadata"].get("creationTimestamp")
                                  or "", p["metadata"]["name"]),
                   reverse=True)
        marked = []
        for pod in fresh[:max(0, n)]:
            pod_name = pod["metadata"]["name"]
            try:
                self.k8s.merge_patch("v1", "pods", ns, pod_name, {
                    "metadata": {"annotations": {
                        DRAIN_VICTIM_ANNOTATION: "true",
                        POD_DELETION_COST: "-1000",
                    }},
                })
            except ApiError as e:
                log.warning("planner: marking victim %s/%s failed: %s",
                            ns, pod_name, e)
                continue
            marked.append(pod_name)
            self._predrain_pod(pod)
        if marked:
            log.info("planner: marked %s for drain-before-shrink "
                     "(%s/%s.%s)", marked, ns, dgd, svc_name)
        return marked

    @staticmethod
    def _predrain_pod(pod: Dict[str, Any]) -> None:
        """Best-effort POST /internal/drain to the victim so admission
        stops and journaled streams begin handing off immediately."""
        ip = (pod.get("status") or {}).get("podIP")
        if not ip:
            return
        import urllib.request

        try:
            req = urllib.request.Request(
                f"http://{ip}:{mat.WORKER_PORT}/internal/drain",
                data=b"{}", method="POST",
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=1.0):
                pass
        except Exception:  # noqa: BLE001 — SIGTERM drain still runs
            log.debug("planner: pre-drain of %s unreachable", ip)

    # -------------------------------------------------------- weight rollout --
    def _rollout_active(self, key: tuple) -> bool:
        st = self._rollouts.get(key)
        return bool(st and st.get("state") == "in_progress")

    def rollout_tick(self, now: Optional[float] = None) -> int:
        """Progressive, burn-gated fleet weight flips (the elasticity
        subsystem's operator face; docs/robustness.md "Hitless weight
        rollout").

        A service's `modelVersion` names the weight version its pods
        should serve. Fresh pods boot on it (materialize env); this tick
        converges the RUNNING fleet in place, one pod per pacing step:
        POST /internal/rollout {stage_flip} makes the worker double-buffer
        v_next into spare HBM while v_prev serves, then flip the version
        pointer between steps — zero dropped streams. While any pod is
        flipped-but-uncommitted, the frontend's fast-window SLO burn gates
        progress: burn above DYNAMO_TPU_ROLLOUT_MAX_BURN means the new
        weights are hurting the objectives, so every flipped pod is rolled
        back (O(1): the previous tree never left HBM) and the rollout
        holds until the manifest changes. Once the whole fleet reports the
        target, a commit closes the rollback windows and frees the
        double-buffer. Returns the number of per-pod actions that landed.
        """
        now = time.monotonic() if now is None else now
        max_burn = float(os.environ.get(ROLLOUT_MAX_BURN_ENV, "") or 1.0)
        step_s = float(os.environ.get(ROLLOUT_STEP_ENV, "") or 15.0)
        try:
            dgds = self.k8s.list(mat.API_VERSION, mat.DGD_PLURAL,
                                 self.namespace)
        except ApiError:
            return 0
        actions = 0
        live = set()
        for cr in dgds:
            ns, name = self._ns(cr), cr["metadata"]["name"]
            services = cr.get("spec", {}).get("services") or {}
            rollout_status: Dict[str, Any] = {}
            for svc_name, spec in services.items():
                target = str(spec.get("modelVersion") or "")
                if not target or spec.get("componentType") == "frontend":
                    continue
                key = (ns, name, svc_name)
                live.add(key)
                st = self._rollouts.get(key)
                if st is None:
                    # seed from the persisted status rollup so an operator
                    # restart / leader failover resumes (and never re-flips
                    # a converged or held fleet)
                    persisted = ((cr.get("status") or {})
                                 .get("weightRollout") or {}).get(svc_name)
                    if (persisted or {}).get("target") == target:
                        st = {"target": target,
                              "state": persisted.get("state",
                                                     "in_progress"),
                              "flipped": set(persisted.get("flipped")
                                             or []),
                              "last_flip": 0.0}
                    self._rollouts[key] = st = st or {
                        "target": target, "state": "in_progress",
                        "flipped": set(), "last_flip": 0.0}
                elif st.get("target") != target:
                    # a NEW target supersedes everything, including a
                    # rolled_back hold — the manifest edit is the operator
                    # acknowledging the bad version
                    st = self._rollouts[key] = {
                        "target": target, "state": "in_progress",
                        "flipped": set(), "last_flip": 0.0}
                try:
                    actions += self._rollout_service(
                        ns, name, svc_name, st, cr, spec, max_burn,
                        step_s, now)
                except Exception:
                    log.exception("rollout: %s/%s.%s tick failed", ns,
                                  name, svc_name)
                rollout_status[svc_name] = {
                    "target": st["target"], "state": st["state"],
                    "flipped": sorted(st["flipped"])}
                self.rollout_gauge.set(len(st["flipped"]), namespace=ns,
                                       dgd=name, service=svc_name)
            # persisted like plannerReplicas: explicit null when empty —
            # patch_status is an RFC 7386 merge-patch, so omitting the
            # key would retain a stale rollout map
            if rollout_status or (cr.get("status")
                                  or {}).get("weightRollout"):
                try:
                    self.k8s.patch_status(
                        mat.API_VERSION, mat.DGD_PLURAL, ns, name,
                        {"weightRollout": rollout_status or None})
                except ApiError as e:
                    if not e.not_found:
                        log.warning("rollout status update failed: %s", e)
        for key in [k for k in self._rollouts if k not in live]:
            del self._rollouts[key]
            self.rollout_gauge.remove(namespace=key[0], dgd=key[1],
                                      service=key[2])
        return actions

    def _rollout_service(self, ns: str, dgd: str, svc_name: str,
                         st: Dict[str, Any], cr: Dict[str, Any],
                         spec: Dict[str, Any], max_burn: float,
                         step_s: float, now: float) -> int:
        """One service's rollout step: burn gate, then commit-or-flip."""
        if st["state"] != "in_progress":
            return 0
        sel = (f"{mat.COMPONENT_LABEL}={svc_name.lower()},"
               f"{mat.NS_LABEL}={mat.discovery_label_value(ns, dgd)}")
        try:
            pods = self.k8s.list("v1", "pods", ns, label_selector=sel)
        except ApiError as e:
            log.debug("rollout: pod listing failed (%s)", e)
            return 0
        # dead pods leave the flipped set; their replacements boot on the
        # target version via the materialized DYNAMO_TPU_MODEL_VERSION
        st["flipped"] &= {p["metadata"]["name"] for p in pods}
        pending = [p for p in pods
                   if p["metadata"]["name"] not in st["flipped"]]

        if st["flipped"]:
            burn = self._frontend_burn(cr, ns, spec)
            if burn is not None and burn > max_burn:
                n = self._rollout_post_all(ns, pods, st["flipped"],
                                           {"action": "rollback"})
                log.warning(
                    "rollout: %s/%s.%s burn %.2f > %.2f — rolled back "
                    "%d/%d flipped pods to the previous version; holding "
                    "until modelVersion changes", ns, dgd, svc_name, burn,
                    max_burn, n, len(st["flipped"]))
                for _ in st["flipped"]:
                    self.rollout_counter.inc(namespace=ns, dgd=dgd,
                                             service=svc_name,
                                             direction="rollback")
                st["flipped"] = set()
                st["state"] = "rolled_back"
                return n

        if not pending:
            # fleet converged under the burn gate: commit drops every
            # pod's retained previous tree (frees the double-buffer HBM)
            n = self._rollout_post_all(ns, pods, st["flipped"],
                                       {"action": "commit"})
            st["state"] = "done"
            for _ in st["flipped"]:
                self.rollout_counter.inc(namespace=ns, dgd=dgd,
                                         service=svc_name,
                                         direction="commit")
            log.info("rollout: %s/%s.%s complete at %s (%d pods "
                     "committed)", ns, dgd, svc_name, st["target"], n)
            return n

        if now - st["last_flip"] < step_s:
            return 0
        # newest pod first: it carries the least accumulated prefix/KV
        # value, so a bad canary costs the least warm state (the mirror
        # image of _mark_drain_victims' newest-first victim choice)
        pending.sort(key=lambda p: (p["metadata"].get("creationTimestamp")
                                    or "", p["metadata"]["name"]),
                     reverse=True)
        pod = pending[0]
        st["last_flip"] = now
        if self._rollout_post(ns, pod, {"action": "stage_flip",
                                        "version": st["target"]}):
            st["flipped"].add(pod["metadata"]["name"])
            self.rollout_counter.inc(namespace=ns, dgd=dgd,
                                     service=svc_name, direction="flip")
            log.info("rollout: %s/%s.%s flipped %s -> %s (%d/%d)", ns,
                     dgd, svc_name, pod["metadata"]["name"], st["target"],
                     len(st["flipped"]), len(pods))
            return 1
        return 0

    def _frontend_burn(self, cr: Dict[str, Any], ns: str,
                       spec: Dict[str, Any]) -> Optional[float]:
        """Max fast-window SLO burn from the DGD's frontend (the same
        scrape path — and the same `autoscaling.metricsUrl` override —
        the planner's burn boost rides); None = unreachable past the
        staleness bound (the rollout proceeds — losing the gate for one
        tick beats wedging every rollout on a metrics blip)."""
        url = ((spec.get("autoscaling") or {}).get("metricsUrl")
               or f"http://{mat.frontend_host(cr)}.{ns}:"
                  f"{mat.FRONTEND_PORT}/metrics")
        parsed = self.collector.scrape_metrics(url)
        if parsed is None:
            return None
        return float(parsed.get("burn") or 0.0)

    def _rollout_post_all(self, ns: str, pods: List[Dict[str, Any]],
                          names, body: Dict[str, Any]) -> int:
        by_name = {p["metadata"]["name"]: p for p in pods}
        n = 0
        for pod_name in sorted(names):
            pod = by_name.get(pod_name)
            if pod is not None and self._rollout_post(ns, pod, body):
                n += 1
        return n

    def _rollout_post(self, ns: str, pod: Dict[str, Any],
                      body: Dict[str, Any]) -> bool:
        """Best-effort POST /internal/rollout to one pod. False on any
        failure (unreachable, 503 stage refusal on insufficient HBM
        headroom, ...) — the pod keeps serving its current version
        untouched and the next tick retries; stage_flip is idempotent on
        the worker, so a retry after a timed-out-but-landed round trip
        is a cheap no-op."""
        ip = (pod.get("status") or {}).get("podIP")
        if not ip:
            return False
        import urllib.request

        try:
            req = urllib.request.Request(
                f"http://{ip}:{mat.WORKER_PORT}/internal/rollout",
                data=json.dumps(body).encode(), method="POST",
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=10.0):
                return True
        except Exception:  # noqa: BLE001 — advisory; retried next tick
            log.debug("rollout: POST %s to %s failed", body.get("action"),
                      ip)
            return False

    def planner_debug_payload(self) -> Dict[str, Any]:
        """The GET /debug/planner body (operator debug server): per-DGD
        pool targets + the bounded decision journal, plus v1 decisions."""
        return {
            "pools": {f"{ns}/{name}": pl.debug_payload()
                      for (ns, name), pl in self._pool_planners.items()},
            "services": {f"{ns}/{name}/{svc}": st.get("replicas")
                         for (ns, name, svc), st in self._planner.items()},
            "rollouts": {f"{ns}/{name}/{svc}": {
                "target": st["target"], "state": st["state"],
                "flipped": sorted(st["flipped"])}
                for (ns, name, svc), st in self._rollouts.items()},
            "scrape_errors_total": self.collector.scrape_errors_total,
        }

    @staticmethod
    def _scrape_queued(url: str) -> Optional[float]:
        """dynamo_frontend_queued_requests from a Prometheus text page
        (kept for tooling; planner_tick uses _scrape_signals)."""
        import urllib.request

        try:
            with urllib.request.urlopen(url, timeout=1.5) as r:
                parsed = parse_metrics_text(r.read().decode("utf-8",
                                                            "replace"))
        except Exception:
            return None
        return parsed.get("queued")

    # ----------------------------------------------------------------- loop --
    def reconcile_once(self) -> int:
        """One full pass over both CRD kinds; returns number of CRs seen."""
        n = 0
        try:
            dgdrs = self.k8s.list(mat.API_VERSION, mat.DGDR_PLURAL, self.namespace)
        except ApiError as e:
            if not e.not_found:
                raise
            dgdrs = []
        for cr in dgdrs:
            n += 1
            try:
                self.reconcile_dgdr(cr)
            except Exception:
                log.exception("DGDR %s reconcile failed", cr["metadata"]["name"])
        for cr in self.k8s.list(mat.API_VERSION, mat.DGD_PLURAL, self.namespace):
            n += 1
            try:
                self.reconcile_dgd(cr)
            except Exception:
                log.exception("DGD %s reconcile failed", cr["metadata"]["name"])
        return n

    def run(self, interval: float = 3.0, stop=None, watch: bool = False,
            resync_s: float = 30.0, leader=None,
            planner_interval: float = 15.0) -> None:
        """Reconcile until `stop`.

        watch=False: plain poll every `interval` (single-node dev default —
        self-healing by construction). watch=True: resourceVersion watch
        streams on both CRD kinds trigger immediate passes, with a full
        relist every `resync_s` as the informer-style resync backstop (a
        missed event costs at most one resync period, not correctness).

        `leader` (optional LeaderElector) gates every pass on is_leader so
        `replicas: 2` is an HA pair, not two writers."""
        import threading

        stop = stop or threading.Event()
        trigger = threading.Event()
        last_plan = 0.0
        if watch:
            for plural in (mat.DGD_PLURAL, mat.DGDR_PLURAL):
                threading.Thread(
                    target=self._watch_loop, args=(plural, trigger, stop),
                    daemon=True, name=f"watch-{plural}",
                ).start()
        log.info(
            "operator reconciling namespace %s (%s)", self.namespace,
            f"watch + {resync_s:.0f}s resync" if watch
            else f"poll every {interval:.1f}s")
        while not stop.is_set():
            # clear BEFORE the pass: an event landing mid-pass re-arms the
            # trigger and wakes the next pass immediately instead of
            # waiting out a full resync period
            trigger.clear()
            if leader is None or leader.is_leader:
                now = time.monotonic()
                if now - last_plan >= planner_interval:
                    last_plan = now
                    try:
                        # BEFORE reconcile so fresh decisions apply in the
                        # same pass
                        self.planner_tick(now)
                    except Exception:
                        log.exception("planner tick failed")
                    try:
                        self.rollout_tick(now)
                    except Exception:
                        log.exception("rollout tick failed")
                    try:
                        # after the planner sized around the dead
                        # capacity: replace quarantined pods so the
                        # Deployment refills the fleet
                        self.quarantine_tick(now)
                    except Exception:
                        log.exception("quarantine tick failed")
                try:
                    self.reconcile_once()
                except Exception:
                    log.exception("reconcile pass failed")
            wait_s = resync_s if watch else interval
            # wake on the next watch event OR the resync/poll deadline
            if trigger.wait(timeout=wait_s):
                # debounce: one burst of events -> one pass
                stop.wait(0.05)

    def _watch_loop(self, plural: str, trigger, stop) -> None:
        """list -> watch -> trigger; relist on any stream failure (incl.
        410 Gone when our resourceVersion aged out of the event window)."""
        while not stop.is_set():
            try:
                _, rv = self.k8s.list_with_rv(
                    mat.API_VERSION, plural, self.namespace)
            except ApiError as e:
                # CRD not installed yet (404): nothing to watch — back off a
                # full resync period rather than hammering the apiserver
                stop.wait(30.0 if e.not_found else 2.0)
                continue
            except Exception:
                log.exception("watch relist for %s failed", plural)
                stop.wait(2.0)
                continue
            trigger.set()  # state observed fresh: run a pass
            while not stop.is_set():
                try:
                    relist = False
                    for ev in self.k8s.watch(
                        mat.API_VERSION, plural, self.namespace,
                        resource_version=rv, timeout_s=60.0,
                    ):
                        if ev.get("type") == "ERROR":
                            # in-stream failure (the apiserver's usual way
                            # to deliver 410 once a watch is established):
                            # our rv is unusable — relist, don't re-watch
                            log.info(
                                "watch on %s got ERROR event (%s); "
                                "relisting", plural,
                                (ev.get("object") or {}).get("code"))
                            relist = True
                            break
                        obj_rv = ((ev.get("object") or {}).get("metadata")
                                  or {}).get("resourceVersion")
                        if obj_rv:
                            rv = obj_rv
                        trigger.set()
                    if relist:
                        break
                except ApiError as e:
                    if e.status == 410:
                        log.info("watch on %s expired (410); relisting",
                                 plural)
                    elif not e.not_found:
                        log.warning("watch on %s failed: %s", plural, e)
                    break  # relist from scratch
                except Exception as e:
                    log.warning("watch stream on %s dropped: %s", plural, e)
                    break
                # clean server-side close (timeoutSeconds): resume from the
                # last seen rv without relisting
            # fell out of the watch: loop back to relist


# --------------------------------------------------------------- DGDR core --
# Module-level so the SAME pipeline serves both homes: inline in the
# operator (no profilerImage) and inside the dispatched profiler pod
# (`python -m dynamo_tpu_torch.profiler --dgdr <name>`).


def run_dgdr(k8s: K8sClient, cr: Dict[str, Any]) -> None:
    """Render the DGD from the DGDR's template ConfigMap, apply the SLA
    sweep, create the DGD (autoApply), and write terminal status."""
    name = cr["metadata"]["name"]
    ns = Controller._ns(cr)
    spec = cr.get("spec", {})
    prof = spec.get("profilingConfig") or {}
    cm_ref = ((prof.get("config") or {}).get("configMapRef")) or {}
    template: Optional[Dict[str, Any]] = None
    if cm_ref.get("name"):
        try:
            cm = k8s.get("v1", "configmaps", ns, cm_ref["name"])
        except ApiError as e:
            if not e.not_found:
                raise
            cm = {}
        key = cm_ref.get("key") or next(iter(cm.get("data", {})), None)
        if key and key in cm.get("data", {}):
            template = _yaml_load(cm["data"][key])
    if template is None:
        # Transient: the user may create/fix the ConfigMap after the DGDR
        # (run-dgdr.sh creates them together; ordering isn't guaranteed).
        # "pending" is retried on every pass — only render success is
        # terminal, matching the wholly-missing-ConfigMap (404) path.
        _set_dgdr_status(k8s, ns, name, "pending",
                         "waiting for template ConfigMap/key")
        return

    sla = prof.get("sla") or {}
    overrides = spec.get("deploymentOverrides") or {}
    try:
        dgd = _render_dgd(cr, template, sla, overrides)
    except mat.Unserved as e:
        _set_dgdr_status(k8s, ns, name, "failed", str(e))
        return
    if spec.get("autoApply", False):
        try:
            k8s.create(mat.API_VERSION, mat.DGD_PLURAL, ns, dgd)
        except ApiError as e:
            if not e.conflict:
                raise
            k8s.merge_patch(
                mat.API_VERSION, mat.DGD_PLURAL, ns,
                dgd["metadata"]["name"], {"spec": dgd["spec"]},
            )
    _set_dgdr_status(
        k8s, ns, name, "successful",
        f"generated {dgd['metadata']['name']}", generated=dgd,
    )


def _render_dgd(
    cr: Dict[str, Any],
    template: Dict[str, Any],
    sla: Dict[str, Any],
    overrides: Dict[str, Any],
) -> Dict[str, Any]:
    dgd = json.loads(json.dumps(template))  # deep copy
    dgd.setdefault("metadata", {})
    dgd["metadata"]["namespace"] = Controller._ns(cr)
    dgd["metadata"].setdefault("name", cr["metadata"]["name"] + "-generated")
    dgd["metadata"].setdefault("labels", {})[
        f"{mat.GROUP}/generated-by"
    ] = cr["metadata"]["name"]
    # SLA profiling sweep (the aiconfigurator analogue): pick tp/batch
    # for the request's isl/osl/ttft/itl on the target GPU system; a
    # system outside the GPU catalog (a TPU slice's name) is refused
    if sla:
        from dynamo_tpu_torch.profiler.configurator import (
            DEFAULT_SYSTEM, apply_sla_overrides)
        from dynamo_tpu_torch.profiler.systems import get_system

        system = (cr["spec"].get("profilingConfig") or {}).get(
            "tpuSystem", DEFAULT_SYSTEM)
        try:
            get_system(system)
        except KeyError:
            raise mat.Unserved([f"spec.profilingConfig.tpuSystem={system}"])
        try:
            dgd = apply_sla_overrides(dgd, sla, system=system)
        except Exception as e:  # warn-and-continue posture: an unknown
            # model/system must not wedge the reconcile loop — the
            # template still deploys as written.
            log.warning("profiler skipped (%s); applying template unchanged", e)
    workers_image = overrides.get("workersImage")
    if workers_image:
        for svc in (dgd.get("spec", {}).get("services") or {}).values():
            if svc.get("componentType") != "frontend":
                svc.setdefault("extraPodSpec", {}).setdefault(
                    "mainContainer", {}
                )["image"] = workers_image
    return dgd


def _set_dgdr_status(
    k8s: K8sClient, ns: str, name: str, state: str, message: str,
    generated: Optional[Dict] = None,
) -> None:
    status: Dict[str, Any] = {"state": state, "message": message}
    if generated is not None:
        status["generatedDeployment"] = generated["metadata"]["name"]
    try:
        k8s.patch_status(
            mat.API_VERSION, mat.DGDR_PLURAL, ns, name, status
        )
    except ApiError as e:
        log.warning("DGDR status update failed: %s", e)
