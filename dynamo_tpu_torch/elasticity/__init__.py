"""Live elasticity: hitless weight rollouts with in-place versioning (the
port's own copy of `dynamo_tpu/elasticity/`).

`weights.WeightManager` double-buffers the engine's weights so a fleet can
ship a model revision without a pod replacement: v2 loads onto the card
beside v1 while v1 keeps serving, then the two swap contents between
engine steps under `_exec_lock`. KV correctness rides the namespace the
prefix cache already keys adapters by: the active weight version seeds
every hash chain (`Engine._kv_namespace`), so v1 KV never verifies against
v2 weights.
"""

from dynamo_tpu_torch.elasticity.weights import (  # noqa: F401
    StageError,
    WeightManager,
)
