"""Decode roofline model (paper §2.2): tau(n, L) = W + H(L) * n.

W  — weight-streaming time per decode iteration (all touched weight bytes
     divided by HBM bandwidth; for MoE, only *active* expert bytes).
H(L) — per-sequence KV-scan overhead, linear in the mean KV length L:
     H(L) = H0 * L / L_calib.

Throughput at concurrency n is n / tau(n, L) tokens/s per instance.
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

    def tokens_per_s(self, n: ArrayLike, mean_context: ArrayLike) -> ArrayLike:
        n = np.asarray(n, dtype=float)
        return np.where(n > 0, n / (self.tau_ms(n, mean_context) * 1e-3), 0.0)

    @property
    def x0_from_ratio(self) -> float:
        """Appendix A: x0 = log2(W / H0) — half-saturation from the roofline."""
        return float(np.log2(self.w_ms / self.h0_ms))

    @staticmethod
    def from_first_principles(*, weight_bytes_per_gpu: float,
                              kv_bytes_per_token_per_gpu: float,
                              mem_bw_Bps: float,
                              l_calib: float = 8192,
                              weight_stream_efficiency: float = 0.777,
                              kv_scan_efficiency: float = 0.968
                              ) -> "DecodeRoofline":
        """Compute W and H0 from bytes and bandwidth.

        Efficiency factors are calibrated so the H100 Llama-3.1-70B profile
        reproduces the paper's measured W = 6.72 ms and Table-1 tok/W:
        17.5 GB / (0.777 * 3.35 TB/s) = 6.72 ms; 55 KB * 8192 / (0.968 * 3.35
        TB/s) = 0.139 ms.
        """
        w_ms = weight_bytes_per_gpu / (weight_stream_efficiency
                                       * mem_bw_Bps) * 1e3
        h0_ms = (kv_bytes_per_token_per_gpu * l_calib
                 / (kv_scan_efficiency * mem_bw_Bps) * 1e3)
        return DecodeRoofline(w_ms=w_ms, h0_ms=h0_ms, l_calib=l_calib)
