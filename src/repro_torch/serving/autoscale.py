"""Reactive per-pool autoscaling for the fleet simulator.

Steady-state runs provision each pool once and keep every instance
powered for the whole trace; under a diurnal envelope (a ~5x day/night
swing — `core.workloads.DiurnalProfile`) that charges peak-sized idle
power all night, which is exactly the regime where the 1/W law's fleet
denominator is dominated by watts nobody is using.  `Autoscaler` turns
the routed trace into **per-instance online windows**: each pool tracks
its own per-epoch arrival rate and scales its live instance count
between a floor and the peak plan, paying scale-up actuation lag,
weight-load time and warm-spare idle power on the way (the friction
knobs live in `core.autoscale.AutoscalePolicy`).

Execution-model fit: routing is context-length-based and
time-independent, so every request's destination pool is known up front
— the per-pool arrival-rate signal the controller consumes is exactly
the primary routed trace (migrated/escalated re-entries are excluded,
like a real RPS autoscaler that keys on ingress traffic).  Each scale-up
incarnation becomes a *fresh engine row* with a single
``[online_from, online_until)`` window, so the event-driven per-row
clocks need no new machinery: a row's clock simply starts at its online
time (after its weight load is charged as idle draw), the balancer only
assigns it requests arriving inside its window, and the fleet report
stops charging its idle power at its retire time.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence

import numpy as np

from ..core.autoscale import AutoscalePolicy

__all__ = ["AutoscalePolicy", "InstanceSchedule", "Autoscaler"]


@dataclasses.dataclass
class InstanceSchedule:
    """One pool's planned incarnations: row i of the (rebuilt) engine is
    online over ``[online_from[i], online_until[i])``.  The first
    `n_peak` rows are the initial (peak-provisioned) fleet; later rows
    are scale-up incarnations that pay `load_s` of weight streaming
    before their window opens.  A cancelled incarnation (scaled back
    down before it ever came online) has a zero-length window and is
    never charged."""

    online_from: np.ndarray
    online_until: np.ndarray
    n_peak: int
    load_s: float

    @property
    def n_rows(self) -> int:
        return int(len(self.online_from))

    def online_at(self, t) -> np.ndarray:
        """Live instance count at time(s) t (vectorised)."""
        t = np.asarray(t, dtype=np.float64)[..., None]
        return ((self.online_from[None, :] <= t)
                & (t < self.online_until[None, :])).sum(axis=-1)

    def online_instance_seconds(self, t0: float, t1: float) -> float:
        """Integral of the live instance count over [t0, t1]."""
        lo = np.maximum(self.online_from, t0)
        hi = np.minimum(self.online_until, t1)
        return float(np.maximum(0.0, hi - lo).sum())


class Autoscaler:
    """Plans `InstanceSchedule`s from routed per-pool arrival times.

    Deterministic and purely causal: the decision at epoch boundary t_e
    uses only the arrival counts observed over past epochs.  Target
    tracking is trend-aware — the last epoch-over-epoch rate *increase*
    is extrapolated forward by the known actuation delay (decision
    epoch + scale-up lag + weight load), the standard compensation for
    a controller whose capacity lands one delay behind its signal.
    Without it a steep diurnal morning ramp keeps capacity a full delay
    below the offered rate and the queue backlog it accrues can take
    hours of simulated day to drain.  Scale-*down* never extrapolates
    (the trend term is clamped at zero) and additionally waits out
    `scaledown_delay_s` of sustained low signal.
    """

    def __init__(self, policy: AutoscalePolicy):
        self.policy = policy

    def plan_pool(self, arrival_times: Sequence[float], *, n_peak: int,
                  rate_per_instance: float, horizon_s: float,
                  load_s: float = 0.0) -> InstanceSchedule:
        """Online windows for one pool.

        `rate_per_instance` is the request rate one instance sustains at
        the sized operating point — the peak plan's
        ``arrival_rate / instances`` — and the controller targets
        `target_utilization` of it.  `load_s` is the pool's weight-load
        duration (model bytes / `weight_load_Bps`), paid by every
        scale-up incarnation on top of `scaleup_lag_s`.
        """
        pol = self.policy
        n_peak = max(int(n_peak), 1)
        k_min = max(int(math.ceil(pol.min_frac * n_peak)), 1)
        cap = max(rate_per_instance, 1e-12) * pol.target_utilization
        dt = pol.control_interval_s
        n_epochs = max(int(math.ceil(horizon_s / dt)), 1)
        ts = np.asarray(arrival_times, dtype=np.float64)
        counts = np.bincount(
            np.clip((ts / dt).astype(np.int64), 0, n_epochs - 1),
            minlength=n_epochs) if len(ts) else np.zeros(n_epochs, np.int64)
        # rows: [on, off) per incarnation; the initial fleet is online
        # from t = 0 (the day starts peak-provisioned — the conservative
        # cold-start; the controller sheds from there)
        on: List[float] = [0.0] * n_peak
        off: List[float] = [math.inf] * n_peak
        live: List[int] = list(range(n_peak))  # LIFO retirement stack
        low_since = None
        # extrapolation horizon: how many epochs of growth the total
        # delay costs before a scale-up decision's capacity is live —
        # half an epoch of observation centring (the rate is an average
        # over the previous epoch) plus actuation lag plus weight load
        lead = 1.5 + (pol.scaleup_lag_s + load_s) / dt
        for e in range(1, n_epochs):
            t = e * dt
            rate = counts[e - 1] / dt
            growth = max(0.0, (counts[e - 1] - counts[e - 2]) / dt) \
                if e >= 2 else 0.0
            rate_hat = rate + growth * lead
            k_desired = min(
                max(int(math.ceil(rate_hat / cap)) + pol.spare_instances,
                    k_min), n_peak)
            k_cur = len(live)
            if k_desired > k_cur:
                t_on = t + pol.scaleup_lag_s + load_s
                for _ in range(k_desired - k_cur):
                    live.append(len(on))
                    on.append(t_on)
                    off.append(math.inf)
                low_since = None
            elif k_desired < k_cur:
                if low_since is None:
                    low_since = t
                if t - low_since >= pol.scaledown_delay_s:
                    for _ in range(k_cur - k_desired):
                        i = live.pop()      # LIFO: newest incarnation first
                        # a not-yet-online incarnation is cancelled
                        # outright (zero-length window, nothing charged)
                        off[i] = t if on[i] <= t else on[i]
                    low_since = None
            else:
                low_since = None
        return InstanceSchedule(online_from=np.asarray(on, np.float64),
                                online_until=np.asarray(off, np.float64),
                                n_peak=n_peak, load_s=load_s)
