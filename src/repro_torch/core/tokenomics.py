"""Token/Watt definition and decomposition (paper §2.2, Eqs. 2 & 4)."""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from .profiles import BaseProfile


def single_gpu_tok_per_watt(profile: BaseProfile, n_active: float,
                            mean_context: float) -> float:
    """Eq. 2: (n / tau(n, Lbar)) / P(n)."""
    return profile.tok_per_watt(n_active, mean_context)


@dataclasses.dataclass(frozen=True)
class ContextPoint:
    """One Table-1 row."""

    context: int
    n_max: int
    p_sat_w: float
    tok_per_s: float
    tok_per_watt: float


def context_sweep(profile: BaseProfile,
                  contexts: Sequence[int] = (2048, 4096, 8192, 16384, 32768,
                                             65536, 131072),
                  ) -> List[ContextPoint]:
    """Table 1: n_max / P_sat / tok/W vs serving context window.

    Table-1 convention: operate at full n_max with mean context = the window.
    """
    rows = []
    for w in contexts:
        n = profile.n_max(w)
        rows.append(ContextPoint(
            context=w, n_max=n,
            p_sat_w=profile.power_w(n),
            tok_per_s=profile.tokens_per_s(n, w),
            tok_per_watt=profile.tok_per_watt(n, w)))
    return rows


def fleet_tok_per_watt(arrival_rates: Sequence[float],
                       mean_outputs: Sequence[float],
                       instances: Sequence[int],
                       powers_w: Sequence[float]) -> float:
    """Eq. 4: sum_i lambda_i Lbar_out,i / sum_i n_i P(n_act,i)."""
    num = sum(l * o for l, o in zip(arrival_rates, mean_outputs))
    den = sum(n * p for n, p in zip(instances, powers_w))
    return num / den if den else 0.0


def tok_per_dollar_m(profile: BaseProfile, window: int,
                     mean_context: Optional[float] = None) -> float:
    """Table 5 'tok/$M': million output tokens per rented instance-hour $."""
    n = profile.n_max(window)
    tok_s = profile.tokens_per_s(n, mean_context or window)
    return tok_s * 3600.0 / profile.chip.rental_usd_hr / 1e6
