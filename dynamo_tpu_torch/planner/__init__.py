"""Planner v2 — coordinated SLA autoscaling across heterogeneous pools.

The control plane the ROADMAP names as its third open item ("Taming the
Chaos", arxiv 2508.19559: disaggregated LLM inference needs *coordinated*
autoscaling — prefill, decode, and adapter-pinned pools have different SLO
currencies (TTFT vs ITL), and scaling one pool without the other just
moves the bottleneck). The port's copy of `dynamo_tpu/planner` (keep the
two in step; `capacity.py` resolves its roofline keys against the port's
GPU catalog). Four planes, all stdlib-only (no torch import —
importable from the operator, the benchmark venv, and CI alike):

- signals.py   per-pool signal scrape (queue depth, SLO burn, per-tenant
               inflight, the `/debug/slo?history=1` request-rate ring)
               plus a Holt level+trend traffic forecaster.
- capacity.py  per-pool capacity estimates: prompts/s/replica for prefill,
               tokens/s/replica for decode, derived from the roofline
               profiler (dynamo_tpu_torch.profiler) or declared in the manifest.
- planner.py   the coordinated decision loop: target replicas per pool
               from forecast demand, prefill/decode scaled JOINTLY in one
               tick, burn boost, scale-down hysteresis, bounded decision
               journal (`GET /debug/planner` on the operator).
- sim.py       deterministic discrete-event traffic simulation (fake
               clock, no sockets, no device) replaying the loadgen scenario
               schedules (scenarios.py) against roofline-parameterized
               pools — the whole control loop asserted in tier-1 CI.

The operator (dynamo_tpu_torch.operator.controller) actuates decisions through
its existing planner-override path; scale-down is made hitless by marking
the victim pod for the graceful SIGTERM drain before the Deployment
shrinks (docs/autoscaling.md).
"""

from dynamo_tpu_torch.planner.capacity import (  # noqa: F401
    PoolCapacity,
    capacity_from_roofline,
    capacity_from_spec,
)
from dynamo_tpu_torch.planner.planner import (  # noqa: F401
    Decision,
    PoolPlanner,
    PoolSpec,
    pool_spec_from_manifest,
)
from dynamo_tpu_torch.planner.signals import (  # noqa: F401
    Forecaster,
    PoolSignals,
    SignalsCollector,
)
