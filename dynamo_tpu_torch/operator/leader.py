"""Lease-based leader election for the operator; the port's copy of
`dynamo_tpu/operator/leader.py` (keep the two in step).

The port's operator takes the JAX operator's Lease (the same name, in the
same namespace): both reconcile the same CRDs (group `tpu.dynamo.ai`) and
the same children, so never two writers. The two must not be installed
together: whichever holds the Lease decides every DGD (the port's writes a
TPU DGD `failed`, the JAX one's gives a GPU DGD `google.com/tpu` pods). So
the port's operator names itself with PORT_IDENTITY_PREFIX and refuses to
start while a live holder without it, the JAX operator, holds the Lease
(`other_operator_holder`).

The reference's consumed controller-manager runs with leader election so
`replicas: 2` is an HA pair, not a split-brain (one active manager,
standbys hold). Same protocol here: a coordination.k8s.io/v1 Lease named
`dynamo-tpu-operator` in the operator namespace; the holder renews
`renewTime` every `renew_s`, and a candidate takes over only after
`lease_duration_s` passes with no renewal.

Non-leaders do NOT reconcile. Losing the lease mid-flight flips
`is_leader` off; the controller checks it before every pass, so the worst
case is one final pass racing the new leader — safe, because reconcile is
level-triggered upserts of deterministic objects.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

from dynamo_tpu_torch.operator.k8s_client import ApiError, K8sClient

log = logging.getLogger("dynamo_tpu_torch.operator.leader")

LEASE_API = "coordination.k8s.io/v1"
LEASE_PLURAL = "leases"
TIME_FMT = "%Y-%m-%dT%H:%M:%S.%fZ"  # k8s MicroTime
LEASE_NAME = "dynamo-tpu-operator"
PORT_IDENTITY_PREFIX = "dynamo-tpu-torch."


def _now_str() -> str:
    t = time.time()
    return (time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(t))
            + f".{int(t % 1 * 1e6):06d}Z")


def _parse_time(s: Optional[str]) -> float:
    """MicroTime -> epoch seconds (0.0 when absent/unparseable: treat an
    unreadable renewTime as infinitely stale, never infinitely fresh)."""
    if not s:
        return 0.0
    try:
        import calendar

        base, _, frac = s.rstrip("Z").partition(".")
        t = calendar.timegm(time.strptime(base, "%Y-%m-%dT%H:%M:%S"))
        return t + (float("0." + frac) if frac else 0.0)
    except ValueError:
        return 0.0


def other_operator_holder(client: K8sClient, namespace: str,
                          lease_name: str = LEASE_NAME) -> Optional[str]:
    """The identity of the Lease's holder when it is live and not the
    port's operator (no PORT_IDENTITY_PREFIX), else None."""
    try:
        lease = client.get(LEASE_API, LEASE_PLURAL, namespace, lease_name)
    except ApiError as e:
        if e.not_found:
            return None
        raise
    spec = lease.get("spec") or {}
    holder = spec.get("holderIdentity")
    duration = float(spec.get("leaseDurationSeconds") or 15.0)
    if (not holder or holder.startswith(PORT_IDENTITY_PREFIX)
            or time.time() - _parse_time(spec.get("renewTime")) > duration):
        return None
    return holder


class LeaderElector:
    def __init__(self, client: K8sClient, namespace: str, identity: str,
                 lease_name: str = LEASE_NAME,
                 lease_duration_s: float = 15.0, renew_s: float = 5.0):
        self.k8s = client
        self.namespace = namespace
        self.identity = identity
        self.lease_name = lease_name
        self.lease_duration_s = lease_duration_s
        self.renew_s = renew_s
        self._leader = threading.Event()

    @property
    def is_leader(self) -> bool:
        return self._leader.is_set()

    # ------------------------------------------------------------ protocol --
    def _lease_body(self, transitions: int) -> dict:
        return {
            "apiVersion": LEASE_API,
            "kind": "Lease",
            "metadata": {"name": self.lease_name,
                         "namespace": self.namespace},
            "spec": {
                "holderIdentity": self.identity,
                "leaseDurationSeconds": int(self.lease_duration_s),
                "acquireTime": _now_str(),
                "renewTime": _now_str(),
                "leaseTransitions": transitions,
            },
        }

    def try_acquire_or_renew(self) -> bool:
        """One election round; returns whether this process holds the lease.

        Any apiserver/transport error demotes to non-leader (an operator
        that can't reach the apiserver can't prove it still holds the
        lease — fail safe; a raising elector thread would instead freeze
        the last-known answer, possibly 'leader', forever)."""
        try:
            return self._try_acquire_or_renew()
        except Exception as e:
            log.warning("leader election error: %s", e)
            self._leader.clear()
            return False

    def _try_acquire_or_renew(self) -> bool:
        try:
            lease = self.k8s.get(LEASE_API, LEASE_PLURAL, self.namespace,
                                 self.lease_name)
        except ApiError as e:
            if not e.not_found:
                raise
            try:
                self.k8s.create(LEASE_API, LEASE_PLURAL, self.namespace,
                                self._lease_body(0))
                log.info("%s acquired leadership (new lease)", self.identity)
                self._leader.set()
                return True
            except ApiError as ce:
                if not ce.conflict:
                    raise
                return self._try_acquire_or_renew()  # lost the create race
        spec = lease.get("spec") or {}
        holder = spec.get("holderIdentity")
        renew = _parse_time(spec.get("renewTime"))
        duration = float(spec.get("leaseDurationSeconds")
                         or self.lease_duration_s)
        if holder == self.identity:
            return self._write_lease(lease, {"renewTime": _now_str()},
                                     "renew")
        if time.time() - renew > duration:
            ok = self._write_lease(lease, {
                "holderIdentity": self.identity,
                "acquireTime": _now_str(),
                "renewTime": _now_str(),
                "leaseTransitions": int(spec.get("leaseTransitions") or 0) + 1,
            }, "takeover")
            if ok:
                log.info("%s took over leadership from stale holder %s",
                         self.identity, holder)
            return ok
        self._leader.clear()
        return False

    def _write_lease(self, lease: dict, spec_updates: dict,
                     what: str) -> bool:
        """Optimistic-concurrency lease write: PUT carries the read's
        resourceVersion, so two candidates acting on the same stale read
        cannot both win — the loser's 409 demotes it this round (client-go's
        Update semantics; an unconditional merge-patch would let a stalled
        holder and its usurper both believe they lead for a renew period)."""
        body = {
            "apiVersion": LEASE_API,
            "kind": "Lease",
            "metadata": {
                "name": self.lease_name,
                "namespace": self.namespace,
                "resourceVersion": lease.get("metadata", {}).get(
                    "resourceVersion"),
            },
            "spec": {**(lease.get("spec") or {}), **spec_updates},
        }
        try:
            self.k8s.replace(LEASE_API, LEASE_PLURAL, self.namespace,
                             self.lease_name, body)
        except ApiError as e:
            if not e.conflict:
                raise
            log.info("%s lost the lease %s race (409)", self.identity, what)
            self._leader.clear()
            return False
        self._leader.set()
        return True

    # ---------------------------------------------------------------- loop --
    def run(self, stop: Optional[threading.Event] = None) -> None:
        """Renew/contend until `stop`; flips is_leader as the lease moves."""
        while stop is None or not stop.is_set():
            was = self.is_leader
            now = self.try_acquire_or_renew()
            if was and not now:
                log.warning("%s LOST leadership", self.identity)
            wait = self.renew_s if now else max(self.renew_s / 2, 1.0)
            if stop is not None:
                if stop.wait(wait):
                    return
            else:
                time.sleep(wait)

    def start(self, stop: Optional[threading.Event] = None) -> threading.Thread:
        t = threading.Thread(target=self.run, args=(stop,), daemon=True,
                             name="leader-elector")
        t.start()
        return t
