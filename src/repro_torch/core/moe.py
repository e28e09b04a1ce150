"""MoE architecture lever (paper §3.2).

Active-parameter weight streaming: in a dense model every weight is touched
every decode iteration; in a MoE only the activated experts stream, so
W = active_param_bytes / mem_bw — an *upper bound* on efficiency because
expert all-to-all dispatch adds latency.  `dispatch_sensitivity` reproduces
the paper's "at 10 ms dispatch the 5.1x shrinks to ~1.5x" analysis.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from .hardware import ChipSpec
from .modelspec import ModelSpec
from .power import PowerModel
from .profiles import BaseProfile, computed_profile
from .roofline import DecodeRoofline


def with_dispatch_floor(profile: BaseProfile,
                        dispatch_ms: float) -> BaseProfile:
    """`profile` with an expert all-to-all dispatch cost added to the
    per-iteration latency floor: tau(n, L) = (W + dispatch) + H(L) n.

    The floor is paid every decode iteration regardless of batch — exactly
    the mechanism that collapses the paper's 5.1x MoE upper bound toward
    ~1.5x at 10 ms dispatch.  A `PoolEngine` given the same `dispatch_ms`
    labels that share of each decode charge (`EnergyMeter.dispatch_joules`).
    """
    if dispatch_ms < 0.0:
        raise ValueError(f"dispatch_ms must be >= 0, got {dispatch_ms}")
    if dispatch_ms == 0.0:
        return profile
    rl = profile.roofline
    return dataclasses.replace(
        profile, roofline=DecodeRoofline(w_ms=rl.w_ms + dispatch_ms,
                                         h0_ms=rl.h0_ms,
                                         l_calib=rl.l_calib))


def moe_profile(model: ModelSpec, chip: ChipSpec,
                power_model: Optional[PowerModel] = None, *, tp: int = 8,
                dispatch_ms: float = 0.0, **kw) -> BaseProfile:
    """ComputedProfile with the active-parameter W override + optional
    dispatch overhead added to the per-iteration latency floor."""
    return with_dispatch_floor(
        computed_profile(model, chip, power_model, tp=tp, **kw), dispatch_ms)


@dataclasses.dataclass(frozen=True)
class DispatchPoint:
    dispatch_ms: float
    tok_per_watt: float
    advantage_vs_dense: float


def dispatch_sensitivity(moe: ModelSpec, dense: ModelSpec, chip: ChipSpec,
                         power_model: Optional[PowerModel] = None, *,
                         window: int = 8192, tp: int = 8,
                         concurrency: float = 8.0,
                         dispatch_grid_ms: tuple = (0.0, 1.0, 2.0, 5.0, 10.0,
                                                    20.0),
                         ) -> List[DispatchPoint]:
    """tok/W advantage of the MoE over the dense baseline vs dispatch cost.

    Evaluated at fixed moderate `concurrency` — the weight-stream-bound
    regime where §3.2's mechanism lives.  (At full n_max both models are
    KV-scan-bound and the active-parameter advantage collapses.)
    """
    dense_prof = computed_profile(dense, chip, power_model, tp=tp)
    dense_tpw = dense_prof.tok_per_watt(concurrency, window)
    out = []
    for d in dispatch_grid_ms:
        prof = moe_profile(moe, chip, power_model, tp=tp, dispatch_ms=d)
        tpw = prof.tok_per_watt(concurrency, window)
        out.append(DispatchPoint(dispatch_ms=d, tok_per_watt=tpw,
                                 advantage_vs_dense=tpw / dense_tpw))
    return out
