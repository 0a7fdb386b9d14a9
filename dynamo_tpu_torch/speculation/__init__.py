"""Speculative decoding's draft side: the n-gram proposer lives in the
engine; this package holds the draft-model proposer (`DraftEngine`) and
the per-slot window controller (`AdaptiveK`). Port of
`dynamo_tpu/speculation`."""

from dynamo_tpu_torch.speculation.adaptive import AdaptiveK
from dynamo_tpu_torch.speculation.draft import (DraftEngine,
                                                tokenizer_fingerprint)

__all__ = ["AdaptiveK", "DraftEngine", "tokenizer_fingerprint"]
