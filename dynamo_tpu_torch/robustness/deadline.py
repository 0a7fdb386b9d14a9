"""End-to-end deadline propagation (the port's own copy of
`dynamo_tpu/robustness/deadline.py`; keep the two in step).

A request's time budget is decided ONCE — by the client's ``x-deadline``
header (remaining seconds) or the ``DYNAMO_TPU_DEADLINE_S`` default — and
then RIDES the request: frontend -> worker (HTTP header or NATS message
header) -> decode -> prefill RPC. Each hop constructs a `Deadline` when
the request arrives and forwards ``remaining()`` downstream, so queueing
and transfer time anywhere in the path shrinks the budget everywhere
after it. The wire format is *relative seconds*, not an absolute
timestamp, so cross-host clock skew cannot corrupt the budget.

An exhausted budget sheds load EARLY — 504 + Retry-After before taking an
engine slot — instead of holding resources for an answer the client has
already given up on. The hard-coded ``timeout=600`` / ``timeout=300``
socket timeouts in the frontend proxy, the NATS plane, and the disagg
prefill RPC all derive from the propagated budget now.

The header may only SHRINK the budget: a client asking for more than the
operator's ``DYNAMO_TPU_DEADLINE_S`` is clamped to it (the env var is the
operator's statement of the longest request worth holding a slot for).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Mapping, Optional

DEADLINE_HEADER = "x-deadline"
ENV_DEFAULT = "DYNAMO_TPU_DEADLINE_S"
DEFAULT_BUDGET_S = 600.0

# floor for derived socket timeouts: 0 would mean "non-blocking", not
# "already late" — expiry is checked explicitly before every dial
MIN_TIMEOUT_S = 0.05


def default_budget_s() -> float:
    try:
        v = float(os.environ.get(ENV_DEFAULT, DEFAULT_BUDGET_S))
        return v if v > 0 else DEFAULT_BUDGET_S
    except ValueError:
        return DEFAULT_BUDGET_S


class Deadline:
    """A monotonic countdown started when the request reached this hop."""

    __slots__ = ("budget_s", "_t0", "_clock")

    def __init__(self, budget_s: float,
                 clock: Callable[[], float] = time.monotonic):
        self.budget_s = max(0.0, float(budget_s))
        self._clock = clock
        self._t0 = clock()

    @classmethod
    def from_headers(cls, headers: Optional[Mapping],
                     clock: Callable[[], float] = time.monotonic
                     ) -> "Deadline":
        """Parse the inbound ``x-deadline`` header (remaining seconds);
        absent/invalid values get the env default; oversized values are
        clamped to it."""
        budget = default_budget_s()
        raw = headers.get(DEADLINE_HEADER) if headers is not None else None
        if raw:
            try:
                budget = min(float(raw), budget)
            except ValueError:
                pass
        return cls(budget, clock=clock)

    def remaining(self) -> float:
        return max(0.0, self.budget_s - (self._clock() - self._t0))

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def timeout(self, floor: float = MIN_TIMEOUT_S) -> float:
        """The socket/poll timeout for a downstream call made NOW."""
        return max(floor, self.remaining())

    def header_value(self) -> str:
        return f"{self.remaining():.3f}"

    def propagate(self, headers: dict) -> dict:
        """Stamp the remaining budget onto an outbound header dict."""
        headers[DEADLINE_HEADER] = self.header_value()
        return headers
