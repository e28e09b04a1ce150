"""Deployment profile (paper Appendix B) for one (model, accelerator, TP).

A profile bundles:
  * the logistic power model P(b)             (Eq. 1)
  * the decode roofline tau(n, L) = W + H(L)n (§2.2)
  * the KV token capacity -> n_max(window)    (Eq. 3)

`ManualProfile` carries calibrated constants: the paper's HIGH-quality
H100 + Llama-3.1-70B profile that meters every serving engine, and the
Table-1 projections of the same model on the other generations
(`GENERATION_PROFILES`).
`computed_profile` derives the same quantities from first principles
(ChipSpec x ModelSpec), as the MoE lever of `core.moe` needs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Protocol, runtime_checkable

import numpy as np

from .hardware import B200, GB200, H100, H200, TPU_V5E, ChipSpec
from .modelspec import LLAMA31_70B, ModelSpec
from .power import (B200_POWER, GB200_POWER, H100_POWER, H200_POWER,
                    TPU_V5E_POWER, PowerModel)
from .roofline import DecodeRoofline


@runtime_checkable
class GpuProfile(Protocol):
    """What `fleet_tpw_analysis` (Appendix B) needs from a profile."""

    name: str
    chip: ChipSpec
    power_model: PowerModel
    roofline: DecodeRoofline
    tp: int

    def n_max(self, window: float) -> int: ...
    def power_w(self, n: float) -> float: ...
    def tokens_per_s(self, n: float, mean_context: float) -> float: ...


@dataclasses.dataclass(frozen=True)
class BaseProfile:
    name: str
    chip: ChipSpec
    power_model: PowerModel
    roofline: DecodeRoofline
    kv_token_capacity: float     # tokens of KV the cache budget holds (per GPU)
    tp: int = 8
    weights_exceed_vram: bool = False

    def n_max(self, window: float) -> int:
        """Eq. 3: concurrency ceiling at serving context window `window`."""
        n = int(math.floor(self.kv_token_capacity / float(window)))
        return max(n, 1)  # paper clamps to 1 (405B / DeepSeek rows)

    def power_w(self, n: float) -> float:
        return float(self.power_model.power_w(n))

    def tokens_per_s(self, n: float, mean_context: float) -> float:
        return float(self.roofline.tokens_per_s(n, mean_context))

    # --- Eq. 2 ----------------------------------------------------------
    def tok_per_watt(self, n: float, mean_context: float) -> float:
        return self.tokens_per_s(n, mean_context) / self.power_w(n)

    def tok_per_watt_at_window(self, window: float,
                               utilization: float = 1.0,
                               mean_context: Optional[float] = None) -> float:
        """Table-1 convention: n = n_max(window), mean context = window."""
        n = self.n_max(window) * utilization
        return self.tok_per_watt(n, window if mean_context is None
                                 else mean_context)


class ManualProfile(BaseProfile):
    """Profile with externally calibrated constants."""


def computed_profile(model: ModelSpec, chip: ChipSpec,
                     power_model: Optional[PowerModel] = None,
                     *, tp: int = 8, kv_sharded: bool = True,
                     vram_reserve_frac: float = 0.035,
                     kv_overhead: float = 1.34,
                     l_calib: float = 8192,
                     name: Optional[str] = None) -> BaseProfile:
    """ComputedProfile: first-principles profile for any (model, chip, TP).

    vram_reserve_frac — framework/activation reserve off the top of VRAM.
    kv_overhead       — PagedAttention block fragmentation + metadata
                        (calibrated 1.34 = 55 KB / 40.96 KB on the H100
                        Llama-70B reference point).
    """
    if power_model is None:
        power_model = PowerModel.from_tdp_fraction(chip)
    weight_bytes_per_gpu = model.weight_bytes(active_only=False) / tp
    budget = chip.vram_bytes * (1.0 - vram_reserve_frac) - weight_bytes_per_gpu
    kappa = model.kv_bytes_per_token(tp=tp, kv_sharded=kv_sharded,
                                     overhead=kv_overhead)
    exceeds = budget <= 0
    capacity = max(budget, 0.0) / kappa if kappa > 0 else np.inf
    if exceeds:
        capacity = 1.0  # clamp: paper reports n_max = 1 for over-VRAM models
    # Weight streaming uses *active* bytes (MoE §3.2 override; upper bound —
    # dispatch overhead excluded, see core.moe for the sensitivity analysis).
    roofline = DecodeRoofline.from_first_principles(
        weight_bytes_per_gpu=model.weight_bytes(active_only=True) / tp,
        kv_bytes_per_token_per_gpu=kappa if model.n_kv_heads else 1e-9,
        mem_bw_Bps=chip.mem_bw_Bps, l_calib=l_calib)
    return BaseProfile(name=name or f"{model.name}@{chip.name}(TP{tp})",
                       chip=chip, power_model=power_model, roofline=roofline,
                       kv_token_capacity=capacity, tp=tp,
                       weights_exceed_vram=exceeds)


# H100 + Llama-3.1-70B, TP=8, TP-sharded GQA KV.  Token capacity 2^20 comes
# from the paper's calibration point n_max = 128 @ 8K (128 * 8192).  W and H0
# reverse-derived from Table 1.
H100_LLAMA70B = ManualProfile(
    name="Llama-3.1-70B@H100-SXM5(TP8,calibrated)",
    chip=H100, power_model=H100_POWER,
    roofline=DecodeRoofline(w_ms=6.72, h0_ms=0.139, l_calib=8192),
    kv_token_capacity=float(2 ** 20), tp=8)

# B200 projection: capacity ratio 2.6235x (Table 1 column 5), W = 2.95 ms,
# H0 reverse-derived 0.067 ms.  FAIR quality, +-20%.
B200_LLAMA70B = ManualProfile(
    name="Llama-3.1-70B@B200-SXM(TP8,projected)",
    chip=B200, power_model=B200_POWER,
    roofline=DecodeRoofline(w_ms=2.95, h0_ms=0.067, l_calib=8192),
    kv_token_capacity=float(2 ** 20) * 2.6235, tp=8)

# H200: same power envelope as H100, 1.41x bandwidth -> W = 4.76 ms,
# capacity scaled by usable-memory ratio (141-17.5)/(80*0.965-17.5) ~ 2.0.
H200_LLAMA70B = ManualProfile(
    name="Llama-3.1-70B@H200-SXM(TP8,projected)",
    chip=H200, power_model=H200_POWER,
    roofline=DecodeRoofline(w_ms=4.76, h0_ms=0.0985, l_calib=8192),
    kv_token_capacity=float(2 ** 20) * 2.0, tp=8)

GB200_LLAMA70B = ManualProfile(
    name="Llama-3.1-70B@GB200-NVL(TP8,projected)",
    chip=GB200, power_model=GB200_POWER,
    roofline=DecodeRoofline(w_ms=2.95, h0_ms=0.067, l_calib=8192),
    kv_token_capacity=float(2 ** 20) * 2.95, tp=8)

# Fleet-analysis B200 profile per the paper's §4.1 method: scaled from the
# H100 by the 2.62x KV-budget ratio; W improves with bandwidth but the
# per-token KV-scan coefficient H0 is not rescaled (only the capacity is).
B200_LLAMA70B_FLEET = ManualProfile(
    name="Llama-3.1-70B@B200-SXM(TP8,fleet-scaled)",
    chip=B200, power_model=B200_POWER,
    roofline=DecodeRoofline(w_ms=2.95, h0_ms=0.139, l_calib=8192),
    kv_token_capacity=float(2 ** 20) * 2.6235, tp=8)

# The same 70B served on a TPU-v5e slice (16 chips, model axis).
V5E_LLAMA70B = computed_profile(LLAMA31_70B, TPU_V5E, TPU_V5E_POWER, tp=16,
                                name="Llama-3.1-70B@TPU-v5e(16-chip)")

GENERATION_PROFILES = {
    "H100-SXM5": H100_LLAMA70B,
    "H200-SXM": H200_LLAMA70B,
    "B200-SXM": B200_LLAMA70B,
    "GB200-NVL": GB200_LLAMA70B,
    "TPU-v5e": V5E_LLAMA70B,
}
