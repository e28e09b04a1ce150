"""Chip specifications for the accelerators referenced by the paper.

H100 figures are HIGH quality (calibrated against ML.ENERGY v3.0 via
Liang et al.'s logistic fit); every other part is a FAIR-quality projection
per the paper's Appendix A.  TPU v5e is the JAX package's deployment target
and uses the same TDP-fraction heuristic.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

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
H200 = ChipSpec("H200-SXM", tdp_w=700.0, vram_bytes=141 * GiB,
                mem_bw_Bps=4.8e12, peak_bf16_flops=989e12, ici_Bps=450e9,
                rental_usd_hr=48.0, quality="FAIR")
B200 = ChipSpec("B200-SXM", tdp_w=1000.0, vram_bytes=180 * GiB,
                mem_bw_Bps=8.0e12, peak_bf16_flops=2250e12, ici_Bps=900e9,
                rental_usd_hr=64.0, quality="FAIR")
GB200 = ChipSpec("GB200-NVL", tdp_w=1200.0, vram_bytes=200 * GiB,
                 mem_bw_Bps=8.0e12, peak_bf16_flops=2250e12, ici_Bps=900e9,
                 rental_usd_hr=80.0, quality="FAIR")
# 197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s/link ICI.
TPU_V5E = ChipSpec("TPU-v5e", tdp_w=215.0, vram_bytes=16 * GiB,
                   mem_bw_Bps=819e9, peak_bf16_flops=197e12, ici_Bps=50e9,
                   rental_usd_hr=9.6, quality="FAIR")

CHIPS: Dict[str, ChipSpec] = {c.name: c
                              for c in (H100, H200, B200, GB200, TPU_V5E)}
