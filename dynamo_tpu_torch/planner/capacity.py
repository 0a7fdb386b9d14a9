"""Per-pool capacity model for the coordinated planner.

The port's copy of `dynamo_tpu/planner/capacity.py`: the roofline keys
resolve against the port's GPU catalog and roofline (`tpuSystem` names an
`h100-sxm-<N>` system), a replica is one engine (the port serves no
data-parallel pod), and a `tp` the port's engine does not serve is refused
by name.

Capacity is expressed in each pool's native SLO currency, per replica:
prompts/s for prefill pools (one replica = one worker pod = one engine on
its slice), tokens/s for decode pools. Targets then come from demand
(`target = ceil(demand / (capacity * utilization))`) instead of the v1
"queue big -> +1" loop.

Two sources, same dataclass:

- **roofline** (`capacity_from_roofline`): derived from the SLA
  profiler's analytic model (dynamo_tpu_torch.profiler.roofline) for a
  (model, system, tp, batch) point — the numbers the DGDR sweep already
  trusts. Imported lazily so this module stays stdlib-importable (sim,
  CI, benchmark venv).
- **explicit** (`capacity_from_spec`): declared in the manifest's
  `autoscaling.pool` block (promptsPerSPerReplica / tokensPerSPerReplica
  / maxStreamsPerReplica) for operators who measured their own numbers.

`capacity_from_spec` also accepts the roofline keys (model, tpuSystem,
tp, batch, isl, osl, quantization, kvDtype) and routes to the roofline
derivation; unknown keys fail loudly so a typo'd pool block breaks CI
(test_example_manifests), not production scaling.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

# manifest keys of the `autoscaling.pool` block (camelCase, like every
# other manifest surface) -> roofline/explicit parameters
_POOL_KEYS = {
    "model": "model", "tpuSystem": "system", "tp": "tp", "batch": "batch",
    "isl": "isl", "osl": "osl", "quantization": "quantization",
    "kvDtype": "kv_dtype",
    "promptsPerSPerReplica": "prompts_per_s",
    "tokensPerSPerReplica": "tokens_per_s",
    "maxStreamsPerReplica": "max_streams",
}


@dataclasses.dataclass(frozen=True)
class PoolCapacity:
    """What one replica of a pool can sustainably serve."""

    prompts_per_s: float      # prefill admissions per second per replica
    tokens_per_s: float       # aggregate decode tokens/s per replica
    max_streams: int          # concurrent decode streams per replica
    ttft_s: float = 0.0       # roofline prefill service time (one prompt)
    itl_s: float = 0.0        # roofline per-token latency at full batch
    source: str = "explicit"  # explicit | roofline

    def __post_init__(self):
        if self.prompts_per_s <= 0 and self.tokens_per_s <= 0:
            raise ValueError(
                "a pool capacity needs prompts_per_s and/or tokens_per_s")


def capacity_from_roofline(
    model: str,
    system: str = "h100-sxm-1",
    tp: Optional[int] = None,
    batch: int = 16,
    isl: int = 1024,
    osl: int = 256,
    quantization: str = "none",
    kv_dtype: str = "auto",
) -> PoolCapacity:
    """Roofline-derived capacity for one worker pod on `system`.

    One K8s replica = one pod = ONE engine on `tp` cards of the named
    system, as the configurator renders it (`replicas` pods of
    `limits.gpu = tp`): the port's engine refuses data_parallel above 1,
    so the Estimate's `replicas` data-parallel engines are that many pods,
    not one (the JAX package prices its pod as the whole slice). `tp`
    defaults to the widest degree the port's engine serves on the system
    (`configurator.served_tp_sizes`); a wider one is refused by name."""
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.profiler import roofline
    from dynamo_tpu_torch.profiler.configurator import served_tp_sizes
    from dynamo_tpu_torch.profiler.systems import get_system

    cfg = ModelConfig.from_model_name(model)
    sys_spec = get_system(system)
    served = served_tp_sizes(sys_spec)
    tp = int(tp or served[-1])
    if tp not in served:
        raise ValueError(
            f"autoscaling.pool.tp={tp}: the port's engine serves "
            f"tensor_parallel in {served} on {system}")
    est = roofline.estimate(cfg, sys_spec, tp=tp, batch=int(batch),
                            isl=int(isl), osl=int(osl),
                            quantization=quantization, kv_dtype=kv_dtype)
    if not est.feasible:
        raise ValueError(
            f"{model} on {system} tp={tp} batch={batch} does not fit "
            f"(hbm_used_frac={est.hbm_used_frac:.2f}); pick a bigger "
            "system, more tp, or a quantization tier")
    return PoolCapacity(
        prompts_per_s=1.0 / est.ttft_s,
        tokens_per_s=est.batch / est.itl_s,
        max_streams=est.batch,
        ttft_s=est.ttft_s,
        itl_s=est.itl_s,
        source="roofline",
    )


def capacity_from_spec(pool: Mapping[str, Any]) -> PoolCapacity:
    """Parse a manifest `autoscaling.pool` block.

    Explicit rates win when given; otherwise `model` triggers the
    roofline derivation. Unknown keys raise (a typo'd capacity block must
    fail example-manifest CI, not silently disable pool-aware scaling)."""
    unknown = set(pool) - set(_POOL_KEYS)
    if unknown:
        raise ValueError(
            f"unknown autoscaling.pool keys: {sorted(unknown)} "
            f"(known: {sorted(_POOL_KEYS)})")
    kw = {_POOL_KEYS[k]: v for k, v in pool.items()}
    explicit = {k: kw.pop(k) for k in
                ("prompts_per_s", "tokens_per_s", "max_streams")
                if k in kw}
    if explicit:
        if kw:
            raise ValueError(
                "autoscaling.pool mixes explicit rates with roofline keys "
                f"({sorted(_POOL_KEYS[k] for k in pool)}); use one or the "
                "other")
        prompts = float(explicit.get("prompts_per_s", 0.0))
        tokens = float(explicit.get("tokens_per_s", 0.0))
        streams = int(explicit.get("max_streams", 0) or 0)
        if streams <= 0 and tokens > 0:
            # a decode pool without a declared slot count: assume the
            # engine's common default batch so stream-count floors work
            streams = 16
        return PoolCapacity(prompts_per_s=prompts, tokens_per_s=tokens,
                            max_streams=streams)
    if "model" not in kw:
        raise ValueError(
            "autoscaling.pool needs either explicit rates "
            "(promptsPerSPerReplica / tokensPerSPerReplica) or a roofline "
            "spec starting with `model:`")
    return capacity_from_roofline(**kw)
