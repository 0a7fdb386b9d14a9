"""GPU catalog: per-card datasheet peaks the live MFU/MBU gauges
(observability/engine_metrics.py) judge utilization against, and the
named systems (cards on HGX boards) the SLA profiler sweeps.

The port's counterpart of `dynamo_tpu/profiler/systems.py`, whose catalog
holds TPU chips and slices: the same `ChipSpec`, `SystemSpec`, `SYSTEMS`,
`get_system`, `valid_tp_sizes` and `chip_for_device_kind`, keyed here on
`torch.cuda.get_device_name()`. Numbers are datasheet peaks (dense rates,
no sparsity) at the card's full power limit; a card capped below it runs
slower under load, so a utilization read against these is a lower bound
there. A system `h100-sxm-<N>` is N cards: 1, 2, 4 or 8 on one HGX board
(one NVLink domain of `chips_per_host` cards), multiples of 8 across
boards. DGDR manifests name it in `profilingConfig.tpuSystem`, the CRD's
field, which the port keeps.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Tuple

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


@dataclasses.dataclass(frozen=True)
class SystemSpec:
    name: str
    chip: ChipSpec
    num_chips: int

    @property
    def total_flops(self) -> float:
        return self.chip.bf16_flops * self.num_chips

    @property
    def total_hbm_bw(self) -> float:
        return self.chip.hbm_bw * self.num_chips


def _mk(family: str, n: int) -> SystemSpec:
    return SystemSpec(f"{family}-{n}", CHIPS[family], n)


# Named systems for DGDR profilingConfig.tpuSystem: part of one HGX board,
# a whole board, and whole boards side by side.
SYSTEMS: Dict[str, SystemSpec] = {
    s.name: s for s in [_mk("h100-sxm", n)
                        for n in (1, 2, 4, 8, 16, 32, 64)]
}

_SYSTEM_RE = re.compile(r"^(h100-sxm)-(\d+)$")


def get_system(name: str) -> SystemSpec:
    """Look up a system, accepting any `h100-sxm-<N>` whose cards fill
    part of one board (1, 2 or 4), a board (8), or whole boards."""
    if name in SYSTEMS:
        return SYSTEMS[name]
    m = _SYSTEM_RE.match(name.strip().lower())
    if m and m.group(1) in CHIPS:
        n = int(m.group(2))
        per_board = CHIPS[m.group(1)].chips_per_host
        if n in (1, 2, 4) or (n > 0 and n % per_board == 0):
            return SystemSpec(name, CHIPS[m.group(1)], n)
    raise KeyError(
        f"unknown GPU system {name!r}; known: {sorted(SYSTEMS)} or any "
        f"'h100-sxm-<N>' with N in 1, 2, 4 or a multiple of 8")


def valid_tp_sizes(system: SystemSpec) -> Tuple[int, ...]:
    """Tensor-parallel degrees that tile the system (powers of two)."""
    out = []
    tp = 1
    while tp <= system.num_chips:
        if system.num_chips % tp == 0:
            out.append(tp)
        tp *= 2
    return tuple(out)
