"""SLA-driven deployment profiler (the aiconfigurator analogue) for GPUs.

The reference's DGDR workflow sweeps engine configs against an SLA block
(isl/osl/ttft/itl) with `useAiConfigurator: true` and a GPU system profile
(`aicSystem: a100_sxm`, reference examples/dgdr/trtllm/dgdr.yaml:22-31).
The port's counterpart of `dynamo_tpu/profiler`: an analytic roofline
model (`roofline`, with the H100's measured utilization factors) over the
GPU catalog (`systems`: `h100-sxm-<N>`), sweeping the tensor-parallel
degrees the engine serves, the batch size and the prefill/decode worker
split (`configurator`), returning the cheapest config that meets the SLA.
The live utilization gauges and the KVBM's gate read the same roofline
sizes.
"""

from dynamo_tpu_torch.profiler.configurator import (  # noqa: F401
    apply_sla_overrides,
    best_config,
    sweep,
)
from dynamo_tpu_torch.profiler.systems import SYSTEMS, get_system  # noqa: F401
