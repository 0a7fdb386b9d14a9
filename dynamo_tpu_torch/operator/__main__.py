"""Operator entrypoint: `python -m dynamo_tpu_torch.operator [--once]`.

The port's copy of `dynamo_tpu/operator/__main__.py`: the controller-
manager analogue (`dynamo-platform-dynamo-operator-controller-manager`,
reference install-dynamo-1node.sh:244-245) reconciling the same CRDs into
GPU workloads (`nvidia.com/gpu`, the port's `dynamo_tpu_torch.*`
commands). `KUBE_API_URL` points it at an apiserver (a test double such as
tests/fake_k8s.FakeK8s included); in a pod it reads the service account.
It elects a leader on the JAX operator's Lease and refuses to start while
the JAX operator holds it (operator/leader.py).
"""

from __future__ import annotations

import argparse
import logging
import os

from dynamo_tpu_torch.operator.controller import Controller
from dynamo_tpu_torch.operator.k8s_client import K8sClient


def main(argv=None) -> None:
    logging.basicConfig(level=os.environ.get("LOG_LEVEL", "INFO"))
    p = argparse.ArgumentParser(prog="dynamo_tpu_torch.operator")
    p.add_argument("--namespace",
                   default=os.environ.get("WATCH_NAMESPACE")
                   or os.environ.get("NAMESPACE") or None,
                   help="restrict to one namespace (default: cluster-wide)")
    p.add_argument("--interval", type=float,
                   default=float(os.environ.get("RECONCILE_INTERVAL", "3")))
    p.add_argument("--gang", action="store_true",
                   default=os.environ.get("ENABLE_GANG_SCHEDULING", "").lower()
                   in ("1", "true"),
                   help="emit coscheduling PodGroups for multi-pod worker "
                        "services (Grove/KAI analogue)")
    p.add_argument("--gang-scheduler",
                   default=os.environ.get("GANG_SCHEDULER_NAME") or None)
    p.add_argument("--once", action="store_true",
                   help="single reconcile pass (CI / debugging)")
    p.add_argument("--watch", action=argparse.BooleanOptionalAction,
                   default=os.environ.get("OPERATOR_WATCH",
                                          "true").lower() != "false",
                   help="resourceVersion watch streams + periodic resync "
                        "instead of a fixed poll loop")
    p.add_argument("--resync", type=float,
                   default=float(os.environ.get("RESYNC_INTERVAL", "30")))
    p.add_argument("--leader-elect", action=argparse.BooleanOptionalAction,
                   default=os.environ.get("LEADER_ELECT",
                                          "true").lower() != "false",
                   help="coordination.k8s.io Lease election so replicas>1 "
                        "is an HA pair (one active reconciler)")
    p.add_argument("--leader-identity",
                   default=os.environ.get("POD_NAME") or None)
    p.add_argument("--debug-port", type=int,
                   default=int(os.environ.get("OPERATOR_DEBUG_PORT",
                                              "8081")),
                   help="planner debug/metrics server port "
                        "(/debug/planner, /metrics; 0 disables)")
    args = p.parse_args(argv)

    from dynamo_tpu_torch.operator import materialize as mat

    client = K8sClient.from_env()
    ctrl = Controller(
        client, namespace=args.namespace, gang=args.gang,
        gang_scheduler=args.gang_scheduler or mat.DEFAULT_GANG_SCHEDULER,
    )
    if args.once:
        n = ctrl.reconcile_once()
        scope = args.namespace or "all namespaces"
        print(f"reconciled {n} custom resources in {scope}")
        return
    leader = None
    if args.leader_elect:
        import socket

        from dynamo_tpu_torch.operator.leader import (
            LEASE_NAME,
            PORT_IDENTITY_PREFIX,
            LeaderElector,
            other_operator_holder,
        )

        identity = PORT_IDENTITY_PREFIX + (args.leader_identity or (
            f"{socket.gethostname()}-{os.getpid()}"))
        lease_ns = (os.environ.get("OPERATOR_NAMESPACE")
                    or args.namespace or "dynamo-system")
        holder = other_operator_holder(client, lease_ns)
        if holder:
            raise SystemExit(
                f"the Lease {lease_ns}/{LEASE_NAME} is held by {holder!r}, "
                "the JAX operator: it reconciles the same CRDs, and the two "
                "operators must not be installed together")
        leader = LeaderElector(client, lease_ns, identity)
        leader.start()
    if args.debug_port:
        from dynamo_tpu_torch.operator.debug_server import OperatorDebugServer

        try:
            OperatorDebugServer(ctrl, port=args.debug_port).start()
        except OSError as e:  # port taken: the operator still reconciles
            logging.getLogger("dynamo_tpu_torch.operator").warning(
                "debug server disabled (port %d: %s)", args.debug_port, e)
    ctrl.run(interval=args.interval, watch=args.watch, resync_s=args.resync,
             leader=leader)


if __name__ == "__main__":
    main()
