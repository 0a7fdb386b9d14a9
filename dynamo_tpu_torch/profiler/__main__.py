"""CLI for the SLA profiler: sweep a model on a GPU system against an SLA.

Usage (mirrors the aiconfigurator invocation semantics of
reference examples/dgdr/trtllm/dgdr.yaml:22-31):

    python3 -m dynamo_tpu_torch.profiler --model llama-3.1-8b-instruct \
        --system h100-sxm-8 --isl 4000 --osl 500 --ttft 600 --itl 25

`--dgdr NAME [--namespace NS]` is the profiler pod's mode: one DGDR's
sweep run against the apiserver (`KUBE_API_URL` or the in-cluster
service account), the command the operator's Job runs.
"""

from __future__ import annotations

import argparse
import json

from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.profiler import get_system, sweep
from dynamo_tpu_torch.profiler.configurator import DEFAULT_SYSTEM, disagg_split


def run_dgdr_pod(name: str, namespace: str) -> None:
    """Profiler-pod mode: execute one DGDR's sweep end-to-end against the
    apiserver — fetch the CR, render + SLA-override + autoApply the DGD,
    write terminal status. This is the command the operator's dispatched
    Job runs when `profilingConfig.profilerImage` is set (the reference's
    profiler-pod topology, reference examples/dgdr/trtllm/
    dgdr.yaml:15); the operator's inline path calls the same run_dgdr()."""
    from dynamo_tpu_torch.operator import materialize as mat
    from dynamo_tpu_torch.operator.controller import run_dgdr
    from dynamo_tpu_torch.operator.k8s_client import K8sClient

    k8s = K8sClient.from_env()
    cr = k8s.get(mat.API_VERSION, mat.DGDR_PLURAL, namespace, name)
    run_dgdr(k8s, cr)
    state = (k8s.get(mat.API_VERSION, mat.DGDR_PLURAL, namespace, name)
             .get("status") or {}).get("state")
    print(f"dgdr {namespace}/{name}: {state}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="dynamo_tpu_torch.profiler")
    p.add_argument("--dgdr", default=None,
                   help="profiler-pod mode: run this DGDR's sweep against "
                        "the apiserver and exit")
    p.add_argument("--namespace", default="default")
    p.add_argument("--model", default=None)
    p.add_argument("--system", default=DEFAULT_SYSTEM)
    p.add_argument("--isl", type=int, default=4000)
    p.add_argument("--osl", type=int, default=500)
    p.add_argument("--ttft", type=float, default=None, help="SLA TTFT ms")
    p.add_argument("--itl", type=float, default=None, help="SLA ITL ms")
    p.add_argument("--top", type=int, default=8, help="candidates to print")
    p.add_argument("--json", action="store_true", help="machine-readable output")
    args = p.parse_args(argv)

    if args.dgdr:
        run_dgdr_pod(args.dgdr, args.namespace)
        return
    if not args.model:
        p.error("--model is required (unless running --dgdr pod mode)")

    cfg = ModelConfig.from_model_name(args.model)
    system = get_system(args.system)
    cands = sweep(cfg, system, args.isl, args.osl)
    meeting = [e for e in cands if e.meets(args.ttft, args.itl)]
    best = (meeting or cands)[0] if cands else None

    if args.json:
        def enc(e):
            return {
                "tp": e.tp, "replicas": e.replicas, "batch": e.batch,
                "ttft_ms": round(e.ttft_s * 1e3, 2),
                "itl_ms": round(e.itl_s * 1e3, 2),
                "tok_s_per_chip": round(e.tok_s_per_chip, 1),
                "hbm_used_frac": round(e.hbm_used_frac, 3),
                "meets_sla": e.meets(args.ttft, args.itl),
            }
        print(json.dumps({
            "model": cfg.name, "system": system.name,
            "sla": {"isl": args.isl, "osl": args.osl,
                    "ttft": args.ttft, "itl": args.itl},
            "best": enc(best) if best else None,
            "disagg_split": disagg_split(best, args.isl, args.osl) if best else None,
            "candidates": [enc(e) for e in cands[: args.top]],
        }))
        return

    print(f"model={cfg.name} system={system.name} "
          f"sla: isl={args.isl} osl={args.osl} ttft={args.ttft} itl={args.itl}")
    if not cands:
        print("INFEASIBLE: model does not fit on this system at batch 1")
        return
    hdr = f"{'tp':>4} {'rep':>4} {'batch':>6} {'ttft_ms':>9} {'itl_ms':>8} {'tok/s/chip':>11} {'hbm%':>6} {'sla':>4}"
    print(hdr)
    for e in cands[: args.top]:
        mark = "ok" if e.meets(args.ttft, args.itl) else "-"
        print(f"{e.tp:>4} {e.replicas:>4} {e.batch:>6} "
              f"{e.ttft_s*1e3:>9.1f} {e.itl_s*1e3:>8.2f} "
              f"{e.tok_s_per_chip:>11.1f} {e.hbm_used_frac*100:>5.1f}% {mark:>4}")
    if best:
        split = disagg_split(best, args.isl, args.osl)
        note = (
            f"(disagg split prefill:decode = {split['prefill']}:{split['decode']})"
            if split else "(single replica group: disagg needs a larger system)"
        )
        print(f"chosen: tp={best.tp} replicas={best.replicas} "
              f"batch={best.batch} {note}")


if __name__ == "__main__":
    main()
