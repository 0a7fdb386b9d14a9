"""Restore-vs-recompute gate for KV onboarding (the port's copy of
`dynamo_tpu/kvbm/cost_model.py`, with the card's numbers).

A host-tier hit is only worth taking when restoring the pages (the
pinned host-to-device copy plus the onboard's fixed cost) beats
recomputing them (chunked-prefill passes over the same tokens). Both
sides come from the roofline (`profiler/roofline.py`): recompute is the
prefill FLOPs at the card's attained share of its peak plus a fixed cost
per chunk; restore is bytes over the host-to-device link plus one fixed
cost. The gate keeps degenerate cases (tiny prompts, a crawling disk
tier) honest instead of hard-coding "always onboard".

The rates below are the card's, measured by `chip_smoke.py` phase 18
(`kvbm_rates`) on an NVIDIA H100 80GB HBM3 at a 700 W power limit with
llama-3.1-8b-instruct's pools (2 MiB a block): the pinned host-to-device
rate of one 256 MiB copy (CUDA events; 44.0 and 55.1 GB/s in two calls,
the later kept); the wall time of a one-block onboard less its bytes at
that rate; the attained share of the bf16 peak from the eager chunked
prefill's walls at chunks of 1024 and 2048 tokens (43.7 and 66.4 ms):
their difference over their FLOPs' difference; and the fixed cost a
chunk: the wall at the engine's 256 tokens (26.4 ms, mostly the host's
launches) less its FLOPs at that share. The FLOPs peak is the card's
catalog entry
(`profiler/systems.py`), found from the engine's device name; an
unlisted card or the CPU plans with the H100 SXM's.
`DYNAMO_TPU_KVBM_H2D_GBPS` (the operator's knob, named as in the JAX
package) overrides the link rate.
"""

from __future__ import annotations

import os
from typing import Optional

from dynamo_tpu_torch.observability.engine_metrics import resolve_chip
from dynamo_tpu_torch.profiler import roofline, systems

# pinned host -> device copy rate (bytes/s)
DEFAULT_H2D_BYTES_S = 55.1e9
# fixed cost of one onboard (its host work and the scatter into the pools)
TRANSFER_OVERHEAD_S = 0.00039
# the eager chunked prefill: attained share of the bf16 peak, and the
# fixed cost of one 256-token chunk
PREFILL_MFU = 0.73
CHUNK_DISPATCH_S = 0.0207


def _h2d_bytes_s() -> float:
    try:
        return float(os.environ.get("DYNAMO_TPU_KVBM_H2D_GBPS", "0")) * 1e9 \
            or DEFAULT_H2D_BYTES_S
    except ValueError:
        return DEFAULT_H2D_BYTES_S


def card_flops(device=None) -> float:
    """Peak bf16 FLOP/s of the card serving on `device` (the catalog entry
    its name maps to, or `DYNAMO_TPU_CHIP`'s); the H100 SXM's when the
    device is the CPU or an unlisted card."""
    chip = resolve_chip(device) if device is not None else None
    return (chip or systems.CHIPS["h100-sxm"]).bf16_flops


class OnboardGate:
    """Decides whether to restore N cached blocks or recompute them.

    mode: "auto" (roofline compare) | "always" | "never". `chip_flops`
    defaults to the peak of the card on `device` (`card_flops`),
    `bytes_per_s` to the card's measured pinned copy rate."""

    def __init__(self, mode: str = "auto", model_cfg=None,
                 block_nbytes: int = 0, page_size: int = 16,
                 prefill_chunk_tokens: int = 256,
                 chip_flops: Optional[float] = None,
                 bytes_per_s: Optional[float] = None, device=None):
        if mode not in ("auto", "always", "never"):
            raise ValueError(f"kvbm_gate must be auto|always|never, "
                             f"got {mode!r}")
        self.mode = mode
        self.model_cfg = model_cfg
        self.block_nbytes = block_nbytes
        self.page_size = page_size
        self.chunk_tokens = max(prefill_chunk_tokens, page_size)
        self.chip_flops = chip_flops or card_flops(device)
        self.bytes_per_s = bytes_per_s or _h2d_bytes_s()
        self.skipped = 0  # onboards refused (recompute was cheaper)

    def restore_seconds(self, n_blocks: int) -> float:
        return roofline.kvbm_restore_seconds(
            n_blocks * self.block_nbytes, self.bytes_per_s,
            overhead_s=TRANSFER_OVERHEAD_S)

    def recompute_seconds(self, n_blocks: int) -> float:
        n_tokens = n_blocks * self.page_size
        n_chunks = max(1, -(-n_tokens // self.chunk_tokens))
        return roofline.kvbm_recompute_seconds(
            self.model_cfg, n_tokens, self.chip_flops, n_dispatches=n_chunks,
            mfu=PREFILL_MFU, dispatch_s=CHUNK_DISPATCH_S)

    def should_onboard(self, n_blocks: int) -> bool:
        if n_blocks <= 0 or self.mode == "never":
            if self.mode == "never" and n_blocks > 0:
                self.skipped += 1
            return False
        if self.mode == "always" or self.model_cfg is None:
            return True
        ok = self.restore_seconds(n_blocks) <= self.recompute_seconds(n_blocks)
        if not ok:
            self.skipped += 1
        return ok

    def explain(self, n_blocks: int) -> dict:
        return {
            "n_blocks": n_blocks,
            "restore_s": round(self.restore_seconds(n_blocks), 6),
            "recompute_s": round(self.recompute_seconds(max(n_blocks, 1)), 6)
            if self.model_cfg is not None else None,
            "mode": self.mode,
        }
