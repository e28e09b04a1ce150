"""Decode roofline model (paper §2.2): tau(n, L) = W + H(L) * n.

W  — weight-streaming time per decode iteration (all touched weight bytes
     divided by HBM bandwidth).
H(L) — per-sequence KV-scan overhead, linear in the mean KV length L:
     H(L) = H0 * L / L_calib.
"""
from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np

ArrayLike = Union[float, int, np.ndarray]


@dataclasses.dataclass(frozen=True)
class DecodeRoofline:
    """Calibrated decode-latency roofline for one (model, accelerator) pair."""

    w_ms: float            # weight-streaming ms / iteration
    h0_ms: float           # KV-scan ms / sequence at L = l_calib
    l_calib: float = 8192  # calibration context length (tokens)

    def h_ms(self, mean_context: ArrayLike) -> ArrayLike:
        return self.h0_ms * (np.asarray(mean_context, dtype=float) / self.l_calib)

    def tau_ms(self, n: ArrayLike, mean_context: ArrayLike) -> ArrayLike:
        """Per-iteration decode latency at n in-flight sequences (ms)."""
        return self.w_ms + self.h_ms(mean_context) * np.asarray(n, dtype=float)
