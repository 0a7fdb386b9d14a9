"""GPU catalog: per-card datasheet peaks the live MFU/MBU gauges
(observability/engine_metrics.py) judge utilization against.

The port's counterpart of `dynamo_tpu/profiler/systems.py`, whose catalog
holds TPU chips: the same `ChipSpec` role and `chip_for_device_kind`
lookup, keyed here on `torch.cuda.get_device_name()`. Numbers are
datasheet peaks (dense rates, no sparsity) at the card's full power limit;
a card capped below it runs slower under load, so a utilization read
against these is a lower bound there.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional

GiB = 1024**3


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    bf16_flops: float          # dense bf16 tensor-core peak, FLOP/s
    hbm_bytes: float           # device memory capacity, bytes
    hbm_bw: float              # device memory bandwidth, bytes/s
    nvlink_link_bw: float      # one-direction NVLink bandwidth per link, B/s
    nvlink_links: int          # NVLink links per card
    chips_per_host: int = 8    # cards on one HGX baseboard

    @property
    def nvlink_bw(self) -> float:
        """Per-card aggregate one-way NVLink bandwidth (all links)."""
        return self.nvlink_link_bw * self.nvlink_links


# NVIDIA's H100 SXM datasheet: 989 TFLOP/s dense bf16, 80 GB of HBM3 at
# 3.35 TB/s, NVLink 4 with 18 links of 25 GB/s a direction (900 GB/s
# both ways).
CHIPS: Dict[str, ChipSpec] = {
    "h100-sxm": ChipSpec("h100-sxm", 989e12, 80 * GiB, 3.35e12, 25e9, 18),
}

# torch.cuda.get_device_name() strings -> catalog keys. The SXM part
# reports "NVIDIA H100 80GB HBM3"; the PCIe and NVL parts, whose peaks
# differ, name themselves and match nothing here.
_DEVICE_NAME_PATTERNS = (
    (r"h100.*hbm3|h100 sxm", "h100-sxm"),
)


def chip_for_device_kind(kind: str) -> Optional[ChipSpec]:
    """Map a CUDA device name onto the catalog (None if unknown: another
    card, or the CPU, for which the gauges read 0)."""
    kind = (kind or "").lower()
    for pat, name in _DEVICE_NAME_PATTERNS:
        if re.search(pat, kind):
            return CHIPS[name]
    return None
