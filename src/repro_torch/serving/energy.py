"""Per-pool energy metering — the serving-side realisation of Eq. 2/4.

Every engine iteration is charged P(b) * tau analytically: tau from the
calibrated decode roofline, P(b) from the logistic power model (no power
sensor is read).

Steady-state measurement window: setting `measure_t0`/`measure_t1` makes
the meter additionally accumulate in-window charges into the `m_*`
counters, so ramp-in and drain-out transients can be left out of the
measured tok/W (the totals are always kept too).  Decode charges are
ms-scale and midpoint-tested; idle, prefill and KV-handoff charges can
straddle the boundary (idle skips span seconds, prefill chunks hide behind
decode overlap) and are pro-rated by exact interval overlap.  With the
window left at its (0, inf) default the `m_*` counters mirror the totals.
"""
from __future__ import annotations

import dataclasses
import math

from ..core.profiles import BaseProfile


@dataclasses.dataclass
class EnergyMeter:
    profile: BaseProfile
    joules: float = 0.0
    idle_joules: float = 0.0
    prefill_joules: float = 0.0
    handoff_joules: float = 0.0   # KV-migration interconnect energy
    handoff_bytes: float = 0.0
    m_handoff_bytes: float = 0.0  # in-window share (pro-rated like joules)
    # MoE expert-dispatch attribution: the engine sets `dispatch_s` to its
    # pool's per-iteration all-to-all floor (core.moe.with_dispatch_floor —
    # already *inside* the roofline's tau, so this never adds energy, it
    # only labels the share of each decode charge spent moving activations
    # between experts instead of streaming weights)
    dispatch_s: float = 0.0
    dispatch_joules: float = 0.0
    m_dispatch_joules: float = 0.0
    tokens: int = 0
    prefill_tokens: int = 0
    sim_time_s: float = 0.0
    # steady-state measurement window + windowed counters
    measure_t0: float = 0.0
    measure_t1: float = math.inf
    m_tokens: int = 0
    m_joules: float = 0.0
    m_prefill_joules: float = 0.0
    m_idle_joules: float = 0.0
    m_handoff_joules: float = 0.0
    # whether the latest decode charge landed inside the window (engines
    # use this to attribute in-window tokens to slots for eviction backout)
    last_charge_in_window: bool = True

    def _in_window(self, dt_s: float) -> bool:
        mid = self.sim_time_s + 0.5 * dt_s
        return self.measure_t0 <= mid <= self.measure_t1

    def charge_decode_step(self, n_active: int, mean_context: float) -> float:
        """Charge one continuous-batching iteration; returns tau (s)."""
        tau_s = float(self.profile.roofline.tau_ms(max(n_active, 1),
                                                   mean_context)) * 1e-3
        power = self.profile.power_w(n_active)
        self.last_charge_in_window = self._in_window(tau_s)
        dispatch_j = power * min(self.dispatch_s, tau_s)
        if self.last_charge_in_window:
            self.m_tokens += n_active
            self.m_joules += power * tau_s
            self.m_dispatch_joules += dispatch_j
        self.joules += power * tau_s
        self.dispatch_joules += dispatch_j
        self.tokens += n_active
        self.sim_time_s += tau_s
        return tau_s

    def charge_prefill(self, n_tokens: int, *, mfu: float = 0.8,
                       streamed_params: float = 1e9,
                       overlap_s: float = 0.0) -> float:
        """Charge prefill compute at the saturated draw P_nom.  `overlap_s`
        is decode-iteration time the chunk hides behind (chunked prefill
        piggybacks on the memory-bound decode pass), so only the excess
        advances the clock; the in-window share is pro-rated by the overlap
        of [sim_time - hidden, sim_time + dt] with the window."""
        flops = 2.0 * streamed_params * n_tokens
        t = flops / (self.profile.tp * self.profile.chip.peak_bf16_flops
                     * mfu)
        e = self.profile.power_model.p_nom_w * t
        hidden = min(overlap_s, t)
        dt = t - hidden
        start, end = self.sim_time_s - hidden, self.sim_time_s + dt
        overlap = max(0.0, min(self.measure_t1, end)
                      - max(self.measure_t0, start))
        if overlap > 0 and t > 0:
            e_in = e * min(overlap / t, 1.0)
            self.m_joules += e_in
            self.m_prefill_joules += e_in
        self.joules += e
        self.prefill_joules += e
        self.prefill_tokens += n_tokens
        self.sim_time_s += dt
        return dt

    def charge_handoff(self, n_bytes: float, *, start_s: float,
                       duration_s: float, j_per_byte: float) -> float:
        """Charge a prefill->decode KV migration: link + HBM energy for
        `n_bytes` moved over [start_s, start_s + duration_s].  Non-output
        energy that never touches the token counters.  The transfer runs on
        the interconnect concurrently with compute, so the clock does not
        advance; the in-window share is pro-rated by exact interval
        overlap (an instantaneous transfer is tested at its start)."""
        e = n_bytes * j_per_byte
        end = start_s + duration_s
        if duration_s > 0:
            overlap = max(0.0, min(self.measure_t1, end)
                          - max(self.measure_t0, start_s))
            frac = overlap / duration_s
        else:
            frac = 1.0 if self.measure_t0 <= start_s <= self.measure_t1 \
                else 0.0
        if frac > 0:
            self.m_joules += e * frac
            self.m_handoff_joules += e * frac
            self.m_handoff_bytes += n_bytes * frac
        self.joules += e
        self.handoff_joules += e
        self.handoff_bytes += n_bytes
        return e

    def charge_idle(self, dt_s: float) -> None:
        """Charge `dt_s` of idle draw and advance the clock; idle skips can
        span seconds, so the in-window share is pro-rated exactly."""
        e = self.profile.power_model.p_idle_w * dt_s
        overlap = max(0.0, min(self.measure_t1, self.sim_time_s + dt_s)
                      - max(self.measure_t0, self.sim_time_s))
        if overlap > 0:
            e_in = self.profile.power_model.p_idle_w * overlap
            self.m_joules += e_in
            self.m_idle_joules += e_in
        self.joules += e
        self.idle_joules += e
        self.sim_time_s += dt_s

    @property
    def tok_per_watt(self) -> float:
        """Output tokens per joule, i.e. (tokens/s) / W; output-only
        accounting per the paper."""
        return self.tokens / self.joules if self.joules else 0.0
