"""KVBM: tiered KV block manager (the Dynamo KVBM analogue), the port's
copy of `dynamo_tpu/kvbm`.

- `host_pool`  — bounded, preallocated host-RAM arenas (pinned on the
  card; LRU, pin-aware) that evicted device prefix pages DEMOTE into
  instead of being destroyed, with an optional disk tier behind the same
  interface;
- `manager`    — the engine-side bridge: `PrefixCache.evict` spills
  sole-owned pages down a tier, `PrefixCache.lookup` misses onboard them
  back into the live pools, gated by a roofline restore-vs-recompute
  check (`cost_model`, on the card's measured rates);
- `events`     — the cluster-wide KV event plane's publisher: block
  stored/demoted/removed events in the frontend router's text-hash
  space.

The cross-worker pull (the JAX package's `HostTierSource` and
`peer_fetch`) needs the transfer plane, which the port has not yet.
"""

from dynamo_tpu_torch.kvbm.host_pool import DiskBlockTier, HostBlockPool  # noqa: F401
from dynamo_tpu_torch.kvbm.cost_model import OnboardGate  # noqa: F401
from dynamo_tpu_torch.kvbm.manager import KVBM  # noqa: F401
