"""Deployment profile (paper Appendix B) for one (model, accelerator, TP).

A profile bundles:
  * the logistic power model P(b)             (Eq. 1)
  * the decode roofline tau(n, L) = W + H(L)n (§2.2)
  * the KV token capacity -> n_max(window)    (Eq. 3)

`ManualProfile` carries calibrated constants: the paper's HIGH-quality
H100 + Llama-3.1-70B profile that meters every serving engine.
`computed_profile` derives the same quantities from first principles
(ChipSpec x ModelSpec), as the MoE lever of `core.moe` needs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from .hardware import H100, ChipSpec
from .modelspec import ModelSpec
from .power import H100_POWER, PowerModel
from .roofline import DecodeRoofline


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
