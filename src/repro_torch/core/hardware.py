"""Chip specification of the accelerator the calibrated profile describes.

H100 figures are HIGH quality (calibrated against ML.ENERGY v3.0 via
Liang et al.'s logistic fit).
"""
from __future__ import annotations

import dataclasses

# Paper §2.1: TDP fractions validated on H100 measurements.
IDLE_TDP_FRACTION = 0.43
NOM_TDP_FRACTION = 0.86


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Static hardware parameters for one accelerator generation."""

    name: str
    tdp_w: float
    vram_bytes: float
    mem_bw_Bps: float           # HBM bandwidth, bytes/s
    peak_bf16_flops: float      # dense bf16/fp16 FLOP/s
    ici_Bps: float              # per-link interconnect bandwidth, bytes/s
    rental_usd_hr: float        # paper Table 5 "$/hr" (per 8-chip instance)
    quality: str                # HIGH | FAIR (paper's provenance tag)

    @property
    def p_idle_w(self) -> float:
        return IDLE_TDP_FRACTION * self.tdp_w

    @property
    def p_nom_w(self) -> float:
        return NOM_TDP_FRACTION * self.tdp_w


GiB = 1024 ** 3

H100 = ChipSpec("H100-SXM5", tdp_w=700.0, vram_bytes=80 * GiB,
                mem_bw_Bps=3.35e12, peak_bf16_flops=989e12, ici_Bps=450e9,
                rental_usd_hr=32.2, quality="HIGH")
