"""Per-worker circuit breakers with half-open probes.

The port's own copy of `dynamo_tpu/robustness/breaker.py` (it imports nothing
of the JAX package); keep the two in step.

The frontend's reactive failover only helps AFTER a request has already
paid for a dead worker's connect timeout; a flapping worker keeps
collecting fresh requests between heartbeat expiries. The breaker makes
the router *proactive*: consecutive connect/timeout failures open the
breaker and the worker stops being a routing candidate immediately; after
a cooldown one probe request is let through (half-open) and its outcome
closes or re-opens the breaker.

State machine (classic three-state):

    closed --[threshold consecutive failures]--> open
    open   --[cooldown elapsed]---------------> half_open
    half_open --[probe success]---------------> closed
    half_open --[probe failure]---------------> open (cooldown restarts)

Wired in `serving.router.Router.pick` (candidate filter + probe
admission) and `serving.frontend` (success/failure reports, /metrics
export, `router.pick` span attributes). Env knobs:

- ``DYNAMO_TPU_BREAKER_THRESHOLD`` (default 3) consecutive failures to open;
- ``DYNAMO_TPU_BREAKER_COOLDOWN_S`` (default 5.0) open->half-open delay.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, Optional

ENV_THRESHOLD = "DYNAMO_TPU_BREAKER_THRESHOLD"
ENV_COOLDOWN = "DYNAMO_TPU_BREAKER_COOLDOWN_S"
DEFAULT_THRESHOLD = 3
DEFAULT_COOLDOWN_S = 5.0

# /metrics encoding of the state (docs/robustness.md)
STATE_CODES = {"closed": 0, "half_open": 1, "open": 2}


def _env_threshold() -> int:
    try:
        return max(1, int(os.environ.get(ENV_THRESHOLD, DEFAULT_THRESHOLD)))
    except ValueError:
        return DEFAULT_THRESHOLD


def _env_cooldown() -> float:
    try:
        return max(0.0, float(os.environ.get(ENV_COOLDOWN,
                                             DEFAULT_COOLDOWN_S)))
    except ValueError:
        return DEFAULT_COOLDOWN_S


class CircuitBreaker:
    """One worker's breaker. Not thread-safe on its own — the owning
    BreakerBoard serializes access."""

    def __init__(self, threshold: int, cooldown_s: float,
                 clock: Callable[[], float] = time.monotonic):
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self._clock = clock
        self.failures = 0          # consecutive, while closed
        self.opened_at: Optional[float] = None
        self.probe_at: Optional[float] = None  # half-open probe in flight
        # a lost probe (picked worker never reported back) must not wedge
        # the breaker open forever — after this long assume it died and
        # allow another probe
        self.probe_timeout_s = max(30.0, cooldown_s)

    @property
    def state(self) -> str:
        if self.opened_at is None:
            return "closed"
        if self._clock() - self.opened_at >= self.cooldown_s:
            return "half_open"
        return "open"

    def available(self) -> bool:
        """May this worker be a routing candidate right now?"""
        st = self.state
        if st == "closed":
            return True
        if st == "open":
            return False
        # half-open: exactly one probe at a time
        if self.probe_at is None:
            return True
        return self._clock() - self.probe_at >= self.probe_timeout_s

    def take_probe(self) -> None:
        if self.state == "half_open":
            self.probe_at = self._clock()

    def record_success(self) -> None:
        self.failures = 0
        self.opened_at = None
        self.probe_at = None

    def record_failure(self) -> bool:
        """Returns True when this failure OPENED the breaker (either the
        threshold trip or a failed half-open probe)."""
        if self.opened_at is not None:
            # open or half-open: any failure (re)starts the cooldown
            reopened = self.state == "half_open"
            self.opened_at = self._clock()
            self.probe_at = None
            return reopened
        self.failures += 1
        if self.failures >= self.threshold:
            self.opened_at = self._clock()
            self.probe_at = None
            return True
        return False


class BreakerBoard:
    """All workers' breakers, keyed by worker URL. Breakers survive
    deregistration on purpose: a dead worker that re-registers via a racing
    heartbeat stays quarantined until its probe succeeds."""

    def __init__(self, threshold: Optional[int] = None,
                 cooldown_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 on_open: Optional[Callable[[str], None]] = None):
        self.threshold = threshold if threshold is not None else _env_threshold()
        self.cooldown_s = (cooldown_s if cooldown_s is not None
                           else _env_cooldown())
        self._clock = clock
        self._lock = threading.Lock()
        self._breakers: Dict[str, CircuitBreaker] = {}
        self.on_open = on_open  # metrics hook: called OUTSIDE the lock

    def _get(self, url: str, create: bool = False
             ) -> Optional[CircuitBreaker]:
        b = self._breakers.get(url)
        if b is None and create:
            b = self._breakers[url] = CircuitBreaker(
                self.threshold, self.cooldown_s, self._clock)
        return b

    # ------------------------------------------------------- router surface --
    def would_allow(self, url: str) -> bool:
        """Candidate filter — no side effects (pick() may evaluate many
        candidates; only the picked one consumes a probe slot)."""
        with self._lock:
            b = self._breakers.get(url)
            return b is None or b.available()

    def on_picked(self, url: str) -> None:
        with self._lock:
            b = self._breakers.get(url)
            if b is not None:
                b.take_probe()

    # ----------------------------------------------------- outcome reporting --
    def record_success(self, url: str) -> None:
        with self._lock:
            b = self._breakers.get(url)
            if b is not None:
                b.record_success()

    def record_failure(self, url: str) -> None:
        with self._lock:
            opened = self._get(url, create=True).record_failure()
        if opened and self.on_open is not None:
            try:
                self.on_open(url)
            except Exception:  # a metrics hook must never break routing
                pass

    # ---------------------------------------------------------- introspection
    def state(self, url: str) -> str:
        with self._lock:
            b = self._breakers.get(url)
            return "closed" if b is None else b.state

    def snapshot(self) -> Dict[str, str]:
        with self._lock:
            return {url: b.state for url, b in self._breakers.items()}

    def forget(self, url: str) -> None:
        with self._lock:
            self._breakers.pop(url, None)
