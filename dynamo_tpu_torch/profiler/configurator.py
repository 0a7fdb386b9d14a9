"""SLA config sweep + DGD override application (aiconfigurator analogue).

The port's copy of `dynamo_tpu/profiler/configurator.py`. The operator's
DGDR path calls `apply_sla_overrides(dgd, sla, system=...)` to rewrite a
DGD template so that it meets the request's SLA block (`isl/osl/ttft/itl`,
reference examples/dgdr/trtllm/dgdr.yaml:22-26) on the target GPU system
(`h100-sxm-<N>`, profiler/systems.py): worker `--tp`, `--max-num-seqs`,
`resources.limits.gpu` (materialized as `nvidia.com/gpu`) and replica
counts are set from the sweep winner, and the decision is recorded in an
annotation for operators to inspect (the analogue of aiconfigurator's
profiling-job output).

The sweep offers only the tensor-parallel degrees the port's engine
serves (`served_tp_sizes`, read from `engine.unported_settings`, the one
place that refuses them), though `roofline.estimate` prices every degree
`valid_tp_sizes` gives; and it never writes `hostsPerReplica`, since the
port's worker refuses the multi-host gang's flags.
"""

from __future__ import annotations

import json
import shlex
from typing import Any, Dict, List, Optional, Tuple

from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.profiler import roofline
from dynamo_tpu_torch.profiler.systems import SystemSpec, get_system, valid_tp_sizes

_BATCHES = (1, 2, 4, 8, 16, 32, 64, 128, 256)

ANNOTATION = "tpu.dynamo.ai/profiler-decision"
DEFAULT_SYSTEM = "h100-sxm-8"


def served_tp_sizes(system: SystemSpec) -> Tuple[int, ...]:
    """The degrees of `valid_tp_sizes(system)` the port's engine serves:
    those `engine.unported_settings` does not refuse."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import unported_settings

    return tuple(tp for tp in valid_tp_sizes(system)
                 if "tensor_parallel" not in unported_settings(
                     EngineConfig(tensor_parallel=tp)))


def sweep(
    cfg: ModelConfig,
    system: SystemSpec,
    isl: int,
    osl: int,
    quantization: str = "none",
    kv_dtype: str = "auto",
) -> List[roofline.Estimate]:
    """All feasible (tp, batch) points on the system at the degrees the
    engine serves, throughput-sorted."""
    out = []
    for tp in served_tp_sizes(system):
        for b in _BATCHES:
            e = roofline.estimate(cfg, system, tp, b, isl, osl,
                                  quantization=quantization,
                                  kv_dtype=kv_dtype)
            if e.feasible:
                out.append(e)
    out.sort(key=lambda e: e.tok_s_per_chip, reverse=True)
    return out


def tiered_sweep(
    cfg: ModelConfig,
    system: SystemSpec,
    isl: int,
    osl: int,
    ttft_ms: Optional[float] = None,
    itl_ms: Optional[float] = None,
    min_replicas: int = 1,
) -> List[roofline.Estimate]:
    """Sweep the serving quantization tiers in PREFERENCE order and return
    the first tier with an SLA-meeting config (quantization has an accuracy
    cost, so it is recommended only when the plain config cannot fit or
    cannot meet the SLA — the call an operator would make by hand). Falls
    back to the best-throughput feasible points across all tiers when no
    tier meets the SLA; [] only when nothing fits at batch 1."""
    all_cands: List[roofline.Estimate] = []
    for quant, kvd in roofline.QUANT_TIERS:
        cands = [e for e in sweep(cfg, system, isl, osl, quant, kvd)
                 if e.replicas >= min_replicas]
        meeting = [e for e in cands if e.meets(ttft_ms, itl_ms)]
        if meeting:
            return meeting
        all_cands.extend(cands)
    all_cands.sort(key=lambda e: e.tok_s_per_chip, reverse=True)
    return all_cands


def best_config(
    cfg: ModelConfig,
    system: SystemSpec,
    isl: int,
    osl: int,
    ttft_ms: Optional[float] = None,
    itl_ms: Optional[float] = None,
) -> Optional[roofline.Estimate]:
    """Best point across quantization tiers: highest-throughput SLA-meeting
    config of the least-quantized sufficient tier, else the
    highest-throughput feasible point overall — mirroring the reference
    posture of warn-and-continue rather than refuse (deploy waits warn,
    reference deploy-incluster.sh:528-529). Returns None only when the
    model cannot fit on the system at batch 1 under any tier."""
    cands = tiered_sweep(cfg, system, isl, osl, ttft_ms, itl_ms)
    return cands[0] if cands else None


def disagg_split(est: roofline.Estimate, isl: int, osl: int) -> Optional[Dict[str, int]]:
    """Prefill:decode worker ratio balancing the two pools' work.

    A decode replica spends ~osl*ITL per request; a prefill replica ~TTFT.
    Provisioning prefill_replicas/decode_replicas ≈ TTFT/(osl*ITL) keeps the
    pools in equilibrium (neither starves the other). Returns None when the
    config has fewer than two replica groups — disaggregation needs at least
    one of each, so the caller must pick a config with replicas >= 2 (or give
    up on disagg for this system).
    """
    if est.replicas < 2:
        return None
    decode_time = max(osl * est.itl_s, 1e-9)
    ratio = est.ttft_s / decode_time
    total = est.replicas
    prefill = min(max(round(total * ratio / (1 + ratio)), 1), total - 1)
    return {"prefill": prefill, "decode": total - prefill}


# ---------------------------------------------------------------------------
# DGD rewriting


def _worker_services(dgd: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    svcs = (dgd.get("spec") or {}).get("services") or {}
    return {
        name: s for name, s in svcs.items()
        if (s.get("componentType") or "worker") != "frontend"
    }


def _get_args(svc: Dict[str, Any]) -> List[str]:
    main = ((svc.get("extraPodSpec") or {}).get("mainContainer")) or {}
    args = main.get("args") or []
    if isinstance(args, str):
        args = shlex.split(args)
    return list(args)


def _set_args(svc: Dict[str, Any], args: List[str]) -> None:
    svc.setdefault("extraPodSpec", {}).setdefault("mainContainer", {})["args"] = args


def _set_flag(args: List[str], flag: str, value: str) -> List[str]:
    """Replace `flag value` in an argv list, appending if absent."""
    out, i, done = [], 0, False
    while i < len(args):
        a = args[i]
        if a == flag:
            out += [flag, value]
            i += 2
            done = True
        elif a.startswith(flag + "="):
            out.append(f"{flag}={value}")
            i += 1
            done = True
        else:
            out.append(a)
            i += 1
    if not done:
        out += [flag, value]
    return out


def _unset_flag(args: List[str], flag: str) -> List[str]:
    """Remove `flag value` / `flag=value` from an argv list (re-applied
    DGDs must not keep a stale lever the new decision didn't choose)."""
    out, i = [], 0
    while i < len(args):
        a = args[i]
        if a == flag:
            i += 2
        elif a.startswith(flag + "="):
            i += 1
        else:
            out.append(a)
            i += 1
    return out


def _find_flag(args: List[str], *flags: str) -> Optional[str]:
    for i, a in enumerate(args):
        if a in flags and i + 1 < len(args):
            return args[i + 1]
        for f in flags:
            if a.startswith(f + "="):
                return a.split("=", 1)[1]
    return None


def _model_from_dgd(dgd: Dict[str, Any]) -> Optional[str]:
    """Worker model id, or None when no --model/--model-path flag exists.

    None means "don't profile": sweeping a fallback model would rewrite
    production workers from the wrong roofline.
    """
    for svc in _worker_services(dgd).values():
        m = _find_flag(_get_args(svc), "--model", "--model-path")
        if m:
            return m
    return None


def apply_sla_overrides(
    dgd: Dict[str, Any],
    sla: Dict[str, Any],
    system: str = DEFAULT_SYSTEM,
) -> Dict[str, Any]:
    """Rewrite a DGD in place from the SLA sweep winner; returns the DGD.

    Applied fields per worker service: `--tp`, `--max-num-seqs` args,
    `resources.limits.gpu`, `replicas` (split across prefill/decode pools for
    disaggregated graphs). No-ops (logging only via annotation) when the model
    doesn't fit the system at all. A system outside the catalog raises
    KeyError (the operator refuses the DGDR with it).
    """
    sys_spec = get_system(system)
    isl = int(sla.get("isl", 4000))
    osl = int(sla.get("osl", 500))
    ttft = float(sla["ttft"]) if "ttft" in sla else None
    itl = float(sla["itl"]) if "itl" in sla else None

    meta = dgd.setdefault("metadata", {})
    ann = meta.setdefault("annotations", {})

    def skip(result: str, **extra) -> Dict[str, Any]:
        ann[ANNOTATION] = json.dumps(
            {"system": sys_spec.name, "result": result, **extra}
        )
        return dgd

    model = _model_from_dgd(dgd)
    if model is None:
        return skip("skipped", reason="no --model/--model-path flag on workers")
    try:
        cfg = ModelConfig.from_model_name(model)
    except (ValueError, KeyError) as e:
        return skip("skipped", model=model, reason=f"unknown model: {e}")

    workers = _worker_services(dgd)
    roles = {
        name: (svc.get("subComponentType") or "").lower()
        for name, svc in workers.items()
    }
    has_disagg = "prefill" in roles.values()

    # disaggregation needs >= 2 replica groups (one per pool); a winner
    # that consumes the whole system would double the card demand
    min_reps = 2 if has_disagg else 1
    cands = tiered_sweep(cfg, sys_spec, isl, osl, ttft, itl,
                         min_replicas=min_reps)
    if not cands:
        if has_disagg and tiered_sweep(cfg, sys_spec, isl, osl, ttft, itl):
            return skip("disagg_infeasible", model=model,
                        reason="no config with >=2 replica groups fits")
        return skip("infeasible", model=model)
    est = cands[0]
    split = disagg_split(est, isl, osl) if has_disagg else None

    # one pod holds one TP group: the sweep's degrees are the engine's,
    # all within a board, so a replica is never a multi-host gang
    # (hostsPerReplica, which the port's worker refuses)
    for name, svc in workers.items():
        args = _get_args(svc)
        args = _set_flag(args, "--tp", str(est.tp))
        args = _set_flag(args, "--max-num-seqs", str(est.batch))
        # serving quantization levers: set when the winning tier needs
        # them, REMOVED when it doesn't (a re-applied DGD must not keep a
        # stale lever that contradicts the new decision annotation)
        if est.quantization != "none":
            args = _set_flag(args, "--quantization", est.quantization)
        else:
            args = _unset_flag(args, "--quantization")
        if est.kv_dtype != "auto":
            args = _set_flag(args, "--kv-cache-dtype", est.kv_dtype)
        else:
            args = _unset_flag(args, "--kv-cache-dtype")
        _set_args(svc, args)
        svc.setdefault("resources", {}).setdefault("limits", {})["gpu"] = \
            str(est.tp)
        if split and roles[name] in ("prefill", "decode"):
            svc["replicas"] = split[roles[name]]
        else:
            svc["replicas"] = est.replicas

    ann[ANNOTATION] = json.dumps({
        "system": sys_spec.name,
        "model": model,
        "tp": est.tp,
        "replicas": est.replicas,
        "hosts_per_replica": 1,
        "max_num_seqs": est.batch,
        "quantization": est.quantization,
        "kv_cache_dtype": est.kv_dtype,
        "split": split,
        "est_ttft_ms": round(est.ttft_s * 1e3, 2),
        "est_itl_ms": round(est.itl_s * 1e3, 2),
        "est_tok_s_per_chip": round(est.tok_s_per_chip, 1),
        "sla": {"isl": isl, "osl": osl, "ttft": ttft, "itl": itl},
        "meets_sla": est.meets(ttft, itl),
    })
    return dgd
