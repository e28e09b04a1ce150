"""Logistic GPU power model (paper Eq. 1, Appendix A Table 7).

P(b) = P_range / (1 + exp(-k (log2(b) - x0))) + P_idle

with b the number of concurrently in-flight sequences (vLLM max_num_seqs).
Works with python floats and numpy arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np

from .hardware import ChipSpec

ArrayLike = Union[float, int, np.ndarray]


@dataclasses.dataclass(frozen=True)
class PowerModel:
    """Eq. 1 logistic power curve for one accelerator."""

    name: str
    p_idle_w: float
    p_nom_w: float
    k: float = 1.0
    x0: float = 4.2
    quality: str = "FAIR"

    @property
    def p_range_w(self) -> float:
        return self.p_nom_w - self.p_idle_w

    def power_w(self, b: ArrayLike) -> ArrayLike:
        """Power draw at b in-flight sequences. b <= 0 -> idle power."""
        b = np.asarray(b, dtype=np.float64)
        safe_b = np.maximum(b, 1e-9)
        logistic = self.p_range_w / (1.0 + np.exp(-self.k * (np.log2(safe_b) - self.x0)))
        return np.where(b <= 0, self.p_idle_w, self.p_idle_w + logistic)

    def saturation_b(self) -> float:
        """Half-saturation concurrency 2**x0 (paper: ~18 seqs on H100)."""
        return 2.0 ** self.x0

    @classmethod
    def from_tdp_fraction(cls, chip: ChipSpec, x0: float = 4.2, k: float = 1.0,
                          quality: Optional[str] = None) -> "PowerModel":
        """FAIR-quality projection: P_idle = 0.43 TDP, P_nom = 0.86 TDP."""
        return cls(name=chip.name, p_idle_w=chip.p_idle_w,
                   p_nom_w=chip.p_nom_w, k=k, x0=x0,
                   quality=quality or chip.quality)


# --- Appendix A, Table 7 ------------------------------------------------
# H100: fitted to ML.ENERGY v3.0 / G2G Fig. 2 (HIGH).  Others projected.
# Appendix A lists x0 = 6.8 for B200/GB200, but the Table 1 B200 P_sat
# column is only consistent with x0 ~ 4.45; the table is followed.
H100_POWER = PowerModel("H100-SXM5", p_idle_w=300.0, p_nom_w=600.0, k=1.0,
                        x0=4.2, quality="HIGH")
H200_POWER = PowerModel("H200-SXM", p_idle_w=300.0, p_nom_w=600.0, k=1.0,
                        x0=4.2, quality="FAIR")
B200_POWER = PowerModel("B200-SXM", p_idle_w=430.0, p_nom_w=860.0, k=1.0,
                        x0=4.45, quality="FAIR")
GB200_POWER = PowerModel("GB200-NVL", p_idle_w=516.0, p_nom_w=1032.0, k=1.0,
                         x0=4.45, quality="FAIR")
TPU_V5E_POWER = PowerModel("TPU-v5e", p_idle_w=0.43 * 215.0,
                           p_nom_w=0.86 * 215.0, k=1.0, x0=4.2,
                           quality="FAIR")

POWER_MODELS = {m.name: m for m in (H100_POWER, H200_POWER, B200_POWER,
                                    GB200_POWER, TPU_V5E_POWER)}
