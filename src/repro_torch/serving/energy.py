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

import numpy as np

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
    # FleetScope charge-channel sink (serving.telemetry.TraceRecorder),
    # attached by the owning engine's attach_trace — never at
    # construction, so telemetry-off runs skip one None check per charge
    trace: object = dataclasses.field(default=None, repr=False,
                                      compare=False)
    trace_pool: int = dataclasses.field(default=0, repr=False,
                                        compare=False)
    trace_instance: int = dataclasses.field(default=0, repr=False,
                                            compare=False)

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
        if self.trace is not None:
            self.trace.charge(self.trace_pool, "decode",
                              self.trace_instance, self.sim_time_s,
                              tau_s, power * tau_s, tokens=n_active,
                              dispatch=dispatch_j)
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
        if self.trace is not None:
            self.trace.charge(self.trace_pool, "prefill",
                              self.trace_instance, start, t, e,
                              tokens=n_tokens)
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
        if self.trace is not None:
            self.trace.charge(self.trace_pool, "handoff",
                              self.trace_instance, start_s, duration_s, e)
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
        if self.trace is not None:
            self.trace.charge(self.trace_pool, "idle",
                              self.trace_instance, self.sim_time_s,
                              dt_s, e)
        self.sim_time_s += dt_s

    @property
    def tok_per_watt(self) -> float:
        """Output tokens per joule, i.e. (tokens/s) / W; output-only
        accounting per the paper."""
        return self.tokens / self.joules if self.joules else 0.0


class MeterBank:
    """Structure-of-arrays `EnergyMeter`: one row per pool instance.

    The batched pool engine (serving.soa) simulates every instance of a
    provisioned pool in lockstep; each instance still owns its *own*
    timeline of charges, so the bank keeps every counter as an
    (instances,) float64/int64 array and the vectorized charge methods
    replicate `EnergyMeter`'s arithmetic expression-for-expression (same
    float64 operations, same order, per row).  An instance's accumulator
    therefore receives the identical sequence of additions it would have
    received from a scalar meter — the SoA parity suite asserts the
    results are bit-equal.

    Vector charges take `rows` (an index array over instances) plus
    per-row operands; `*_one` variants serve the rare slow paths (multi-
    slot prefill drains, KV handoffs) one instance at a time.
    """

    def __init__(self, profile: BaseProfile, n: int):
        self.profile = profile
        self.n = n
        f = lambda: np.zeros(n, np.float64)        # noqa: E731
        i = lambda: np.zeros(n, np.int64)          # noqa: E731
        self.joules = f()
        self.idle_joules = f()
        self.prefill_joules = f()
        self.handoff_joules = f()
        self.handoff_bytes = f()
        self.m_handoff_bytes = f()
        self.dispatch_s = 0.0                      # shared per-pool floor
        self.dispatch_joules = f()
        self.m_dispatch_joules = f()
        self.tokens = i()
        self.prefill_tokens = i()
        self.sim_time_s = f()
        self.measure_t0 = 0.0
        self.measure_t1 = math.inf
        self.m_tokens = i()
        self.m_joules = f()
        self.m_prefill_joules = f()
        self.m_idle_joules = f()
        self.m_handoff_joules = f()
        self.last_charge_in_window = np.ones(n, bool)
        # FleetScope charge sink (see EnergyMeter.trace) — attach_trace
        # only wires it at level="detail", keeping lifecycle tracing off
        # the vectorized charge path entirely
        self.trace = None
        self.trace_pool = 0

    # --- vectorized twins of the EnergyMeter charges --------------------

    def charge_decode_rows(self, rows: np.ndarray, n_active: np.ndarray,
                           mean_context: np.ndarray) -> np.ndarray:
        """One continuous-batching iteration on every `rows` instance;
        returns tau (s) per row.  `DecodeRoofline.tau_ms` and
        `PowerModel.power_w` are already numpy-vectorized, so the single
        source of Eq. 1 / the roofline stays in core — and the scalar
        meter evaluates the identical float64 expressions, which is what
        keeps batched-vs-scalar parity bit-exact."""
        nf = n_active.astype(np.float64)
        tau_s = self.profile.roofline.tau_ms(nf, mean_context) * 1e-3
        power = self.profile.power_model.power_w(nf)
        mid = self.sim_time_s[rows] + 0.5 * tau_s
        in_win = (self.measure_t0 <= mid) & (mid <= self.measure_t1)
        e = power * tau_s
        dispatch_j = power * np.minimum(self.dispatch_s, tau_s)
        self.last_charge_in_window[rows] = in_win
        self.m_tokens[rows] += np.where(in_win, n_active, 0)
        self.m_joules[rows] += np.where(in_win, e, 0.0)
        self.m_dispatch_joules[rows] += np.where(in_win, dispatch_j, 0.0)
        self.joules[rows] += e
        self.dispatch_joules[rows] += dispatch_j
        self.tokens[rows] += n_active
        if self.trace is not None:
            self.trace.charge(self.trace_pool, "decode", rows,
                              self.sim_time_s[rows], tau_s, e,
                              tokens=n_active, dispatch=dispatch_j)
        self.sim_time_s[rows] += tau_s
        return tau_s

    def charge_prefill_rows(self, rows: np.ndarray, n_tokens: np.ndarray,
                            *, mfu: float, streamed_params: float,
                            overlap_s: np.ndarray) -> np.ndarray:
        prof = self.profile
        flops = (2.0 * streamed_params) * n_tokens.astype(np.float64)
        t = flops / (prof.tp * prof.chip.peak_bf16_flops * mfu)
        e = prof.power_model.p_nom_w * t
        hidden = np.minimum(overlap_s, t)
        dt = t - hidden
        start = self.sim_time_s[rows] - hidden
        end = self.sim_time_s[rows] + dt
        overlap = np.maximum(0.0, np.minimum(self.measure_t1, end)
                             - np.maximum(self.measure_t0, start))
        safe_t = np.where(t > 0, t, 1.0)
        e_in = np.where((overlap > 0) & (t > 0),
                        e * np.minimum(overlap / safe_t, 1.0), 0.0)
        self.m_joules[rows] += e_in
        self.m_prefill_joules[rows] += e_in
        self.joules[rows] += e
        self.prefill_joules[rows] += e
        self.prefill_tokens[rows] += n_tokens
        if self.trace is not None:
            self.trace.charge(self.trace_pool, "prefill", rows, start, t,
                              e, tokens=n_tokens)
        self.sim_time_s[rows] += dt
        return dt

    def charge_idle_rows(self, rows: np.ndarray, dt_s: np.ndarray) -> None:
        p_idle = self.profile.power_model.p_idle_w
        e = p_idle * dt_s
        t = self.sim_time_s[rows]
        overlap = np.maximum(0.0, np.minimum(self.measure_t1, t + dt_s)
                             - np.maximum(self.measure_t0, t))
        e_in = np.where(overlap > 0, p_idle * overlap, 0.0)
        self.m_joules[rows] += e_in
        self.m_idle_joules[rows] += e_in
        self.joules[rows] += e
        self.idle_joules[rows] += e
        if self.trace is not None:
            self.trace.charge(self.trace_pool, "idle", rows, t, dt_s, e)
        self.sim_time_s[rows] += dt_s

    # --- scalar slow paths ----------------------------------------------

    def charge_prefill_one(self, i: int, n_tokens: int, *, mfu: float,
                           streamed_params: float,
                           overlap_s: float = 0.0) -> float:
        rows = np.array([i])
        return float(self.charge_prefill_rows(
            rows, np.array([n_tokens], np.int64), mfu=mfu,
            streamed_params=streamed_params,
            overlap_s=np.array([overlap_s]))[0])

    def charge_handoff_one(self, i: int, n_bytes: float, *, start_s: float,
                           duration_s: float, j_per_byte: float) -> float:
        """Per-request KV-migration charge — mirrors
        `EnergyMeter.charge_handoff` (wall-time interval, clock never
        advances)."""
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
            self.m_joules[i] += e * frac
            self.m_handoff_joules[i] += e * frac
            self.m_handoff_bytes[i] += n_bytes * frac
        self.joules[i] += e
        self.handoff_joules[i] += e
        self.handoff_bytes[i] += n_bytes
        if self.trace is not None:
            self.trace.charge(self.trace_pool, "handoff", i, start_s,
                              duration_s, e)
        return e


# --- conservation invariants --------------------------------------------

def conservation_violations(meter, *, rtol: float = 1e-9,
                            atol: float = 1e-6) -> list:
    """Invariant audit for an `EnergyMeter` or `MeterBank` (per row).

    Checks the accounting identities the rest of the stack leans on:
    every windowed `m_*` counter is bounded by its lifetime total, no
    counter has gone negative, the derived decode residual
    (joules - prefill - idle - handoff) is non-negative, and the MoE
    dispatch share fits inside it (dispatch rides *inside* decode
    charges, never additive).  Returns human-readable violation strings;
    empty list == conserved.  Tolerance is `atol + rtol * |joules|` per
    row — charges are exact float64 sums, so violations beyond rounding
    mean a charge path double-counted or backed out too much.
    """
    out = []

    def arr(name):
        return np.atleast_1d(np.asarray(getattr(meter, name), np.float64))

    joules = arr("joules")
    prefill = arr("prefill_joules")
    idle = arr("idle_joules")
    handoff = arr("handoff_joules")
    tol = atol + rtol * np.abs(joules)

    def chk(ok, msg):
        bad = np.flatnonzero(~ok)
        if len(bad):
            out.append(f"{msg} (rows {bad.tolist()})")

    decode = joules - prefill - idle - handoff
    chk(decode >= -tol,
        "decode residual negative: prefill+idle+handoff > joules")
    chk(arr("dispatch_joules") <= decode + tol,
        "dispatch_joules exceeds the decode share it must ride inside")
    m_sum = (arr("m_prefill_joules") + arr("m_idle_joules")
             + arr("m_handoff_joules"))
    chk(m_sum <= arr("m_joules") + tol,
        "windowed phase joules exceed windowed total")
    for m, t in (("m_joules", "joules"),
                 ("m_prefill_joules", "prefill_joules"),
                 ("m_idle_joules", "idle_joules"),
                 ("m_handoff_joules", "handoff_joules"),
                 ("m_dispatch_joules", "dispatch_joules"),
                 ("m_handoff_bytes", "handoff_bytes")):
        chk(arr(m) <= arr(t) + tol, f"{m} > {t}")
        chk(arr(m) >= -tol, f"{m} negative")
    m_tok = np.atleast_1d(np.asarray(meter.m_tokens))
    tok = np.atleast_1d(np.asarray(meter.tokens))
    chk(m_tok <= tok, "m_tokens > tokens")
    chk(m_tok >= 0, "m_tokens negative")
    chk(tok >= 0, "tokens negative")
    return out
