"""Deployment profile (paper Appendix B) for one (model, accelerator, TP).

A profile bundles:
  * the logistic power model P(b)             (Eq. 1)
  * the decode roofline tau(n, L) = W + H(L)n (§2.2)
  * the KV token capacity -> n_max(window)    (Eq. 3)

`ManualProfile` carries calibrated constants: the paper's HIGH-quality
H100 + Llama-3.1-70B profile that meters every serving engine.
"""
from __future__ import annotations

import dataclasses
import math

from .hardware import H100, ChipSpec
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


class ManualProfile(BaseProfile):
    """Profile with externally calibrated constants."""


# H100 + Llama-3.1-70B, TP=8, TP-sharded GQA KV.  Token capacity 2^20 comes
# from the paper's calibration point n_max = 128 @ 8K (128 * 8192).  W and H0
# reverse-derived from Table 1.
H100_LLAMA70B = ManualProfile(
    name="Llama-3.1-70B@H100-SXM5(TP8,calibrated)",
    chip=H100, power_model=H100_POWER,
    roofline=DecodeRoofline(w_ms=6.72, h0_ms=0.139, l_calib=8192),
    kv_token_capacity=float(2 ** 20), tp=8)
