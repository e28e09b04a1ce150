"""Workload traces (paper §4/§7): context-length distributions and the
diurnal arrival envelope.

The paper uses two production traces (Azure LLM Inference / LMSYS-Chat-1M)
plus an "agent-heavy" archetype.  The raw traces are not redistributable, so
each workload here is a *parametric* reconstruction — a 2-component lognormal
mixture for prompt length (chat tail + document tail) and a lognormal for
output length — fitted to the statistics the paper states:

  Azure  — 89% of requests <= 4K total tokens; mean output ~325 tok.
  LMSYS  — short-dominant chat, split boundary B_short = 1.5K; mean output
           ~136 tok.
  Agent  — 74% <= 8K, p99 ~= 32K (paper §7).

Every consumer draws from one fixed-seed Monte-Carlo sample, so it sees the
identical distribution.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np

_N_SAMPLE = 200_000
_SEED = 20260712


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    # prompt mixture: ((weight, mu, sigma), ...)
    prompt_mix: Tuple[Tuple[float, float, float], ...]
    output_mu: float
    output_sigma: float
    arrival_rate: float = 1000.0   # requests / s (paper: lambda = 1000)
    max_total: float = 131072.0

    @functools.cached_property
    def _sample(self) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(_SEED)
        weights = np.array([w for w, _, _ in self.prompt_mix])
        comp = rng.choice(len(self.prompt_mix), size=_N_SAMPLE,
                          p=weights / weights.sum())
        mus = np.array([m for _, m, _ in self.prompt_mix])[comp]
        sigmas = np.array([s for _, _, s in self.prompt_mix])[comp]
        p = np.exp(rng.normal(mus, sigmas))
        o = rng.lognormal(self.output_mu, self.output_sigma, _N_SAMPLE)
        p = np.clip(p, 1, self.max_total - 1)
        o = np.clip(o, 1, self.max_total - p)
        return p, o

    @property
    def prompts(self) -> np.ndarray:
        return self._sample[0]

    @property
    def outputs(self) -> np.ndarray:
        return self._sample[1]

    def sample_requests(self, n: int, seed: int = 0) -> np.ndarray:
        """(n, 2) int array of (prompt_len, output_len) for the simulator."""
        rng = np.random.default_rng(seed)
        idx = rng.integers(0, _N_SAMPLE, size=n)
        return np.maximum(np.stack([self.prompts[idx], self.outputs[idx]],
                                   axis=1), 1.0).astype(np.int64)


# ----------------------------------------------------------------------
# Diurnal arrival envelope (non-stationary traffic).
#
# Everything above measures steady-state Poisson arrivals at a flat
# `arrival_rate`; real fleets ride a ~5x day/night swing (the Azure LLM
# inference trace shows working-hours peaks at ~5x the overnight trough).
# `DiurnalProfile` is a periodic piecewise-linear rate envelope r(t) over
# hourly control points, normalised so the *peak* control point is 1.0 —
# `peak_rate` then has the same meaning as `Workload.arrival_rate` at the
# busiest instant, which is exactly the rate `provision()`/`size_to_slo`
# size for.  Arrivals are sampled *exactly* (no thinning rejection noise)
# by time-rescaling: unit-rate exponential gaps are cumsummed and mapped
# through the inverse of the cumulative rate L(t) = integral r, which is
# piecewise quadratic and invertible in closed form per segment.

# Hourly shape of the Azure-style envelope (fraction of peak, hour 0-23):
# overnight trough 0.20, working-hours plateau ~1.0 — a 5x swing.
AZURE_DIURNAL_SHAPE: Tuple[float, ...] = (
    0.30, 0.25, 0.22, 0.20, 0.20, 0.22, 0.30, 0.45,
    0.62, 0.80, 0.92, 1.00, 1.00, 0.97, 0.95, 0.92,
    0.88, 0.82, 0.75, 0.68, 0.58, 0.48, 0.40, 0.34,
)


@dataclasses.dataclass(frozen=True)
class DiurnalProfile:
    """Periodic day/night arrival-rate envelope r(t) (requests / s).

    `shape` holds one rate multiplier per equal segment of the period
    (hourly for the default 24-point Azure envelope); r(t) interpolates
    linearly between control points and wraps at `day_s`.  `peak_rate`
    scales the whole envelope so max(shape) * peak_rate is the busiest
    instantaneous rate.  Benchmarks compress the day (`day_s` of minutes,
    not hours) so a whole simulated day stays CI-sized; the *shape* —
    and therefore the idle/overprovision arithmetic relative to peak —
    is unchanged by compression.
    """
    name: str = "azure-diurnal"
    peak_rate: float = 1000.0
    day_s: float = 86400.0
    shape: Tuple[float, ...] = AZURE_DIURNAL_SHAPE

    def __post_init__(self):
        if len(self.shape) < 2:
            raise ValueError("DiurnalProfile.shape needs >= 2 control points")
        if min(self.shape) <= 0:
            raise ValueError("DiurnalProfile.shape must be strictly positive "
                             "(a zero-rate segment makes L(t) non-invertible)")
        if self.peak_rate <= 0 or self.day_s <= 0:
            raise ValueError("peak_rate and day_s must be positive")

    # -- envelope geometry --------------------------------------------
    @functools.cached_property
    def _grid(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(knot times, knot rates, cumulative L at knots) over one period
        with the wrap point appended (len == len(shape) + 1)."""
        k = len(self.shape)
        scale = self.peak_rate / max(self.shape)
        t = np.linspace(0.0, self.day_s, k + 1)
        r = np.array(list(self.shape) + [self.shape[0]]) * scale
        seg = self.day_s / k
        # trapezoid integral of the piecewise-linear rate per segment
        cum = np.concatenate([[0.0], np.cumsum((r[:-1] + r[1:]) * 0.5 * seg)])
        return t, r, cum

    @property
    def swing(self) -> float:
        """Peak-to-trough rate ratio of the envelope."""
        return float(max(self.shape) / min(self.shape))

    @property
    def mean_rate(self) -> float:
        """Whole-day average arrival rate (requests / s)."""
        _, _, cum = self._grid
        return float(cum[-1] / self.day_s)

    def rate_at(self, t) -> np.ndarray:
        """Instantaneous rate r(t) (vectorised; periodic in day_s)."""
        knots, r, _ = self._grid
        tm = np.asarray(t, dtype=np.float64) % self.day_s
        return np.interp(tm, knots, r)

    def cumulative(self, t) -> np.ndarray:
        """L(t) = integral_0^t r(s) ds (vectorised, t >= 0, multi-day)."""
        knots, r, cum = self._grid
        t = np.asarray(t, dtype=np.float64)
        days, tm = np.divmod(t, self.day_s)
        seg = self.day_s / len(self.shape)
        i = np.minimum((tm // seg).astype(np.int64), len(self.shape) - 1)
        dt = tm - knots[i]
        slope = (r[i + 1] - r[i]) / seg
        return days * cum[-1] + cum[i] + r[i] * dt + 0.5 * slope * dt * dt

    def _invert(self, u: np.ndarray) -> np.ndarray:
        """L^-1(u): arrival times from rescaled unit-rate event times."""
        knots, r, cum = self._grid
        days, rem = np.divmod(np.asarray(u, dtype=np.float64), cum[-1])
        seg = self.day_s / len(self.shape)
        i = np.minimum(np.searchsorted(cum, rem, side="right") - 1,
                       len(self.shape) - 1)
        y = rem - cum[i]
        slope = (r[i + 1] - r[i]) / seg
        # solve 0.5*slope*dt^2 + r_i*dt = y for dt (positive root); the
        # linear fallback covers flat segments (slope == 0)
        disc = np.sqrt(np.maximum(r[i] ** 2 + 2.0 * slope * y, 0.0))
        with np.errstate(divide="ignore", invalid="ignore"):
            dt = np.where(np.abs(slope) > 1e-12 * self.peak_rate / seg,
                          (disc - r[i]) / np.where(slope == 0.0, 1.0, slope),
                          y / r[i])
        return days * self.day_s + knots[i] + dt

    def sample_arrivals(self, t_end: float, *, seed: int = 0) -> np.ndarray:
        """Exact non-homogeneous Poisson arrival times on [0, t_end).

        Time-rescaling: cumulative unit-rate exponential gaps E_k are an
        ordinary Poisson process on the L axis; mapping through L^-1
        yields arrivals with intensity r(t).  Deterministic per seed.
        """
        rng = np.random.default_rng(seed + 13)
        target = float(self.cumulative(t_end))
        est = int(target + 6.0 * np.sqrt(target) + 64)
        u = np.cumsum(rng.exponential(1.0, size=est))
        while u[-1] < target:  # pragma: no cover - 6-sigma headroom
            u = np.concatenate(
                [u, u[-1] + np.cumsum(rng.exponential(1.0, size=est))])
        u = u[u < target]
        return self._invert(u)


AZURE_DIURNAL = DiurnalProfile()


AZURE = Workload("azure-conv",
                 prompt_mix=((0.88, 5.90, 0.85), (0.12, 8.95, 0.70)),
                 output_mu=5.46, output_sigma=0.80)
LMSYS = Workload("lmsys-chat",
                 prompt_mix=((0.85, 4.90, 0.90), (0.15, 7.80, 0.80)),
                 output_mu=4.58, output_sigma=0.85)
AGENT = Workload("agent-heavy",
                 prompt_mix=((0.70, 7.00, 1.00), (0.30, 9.40, 0.60)),
                 output_mu=5.70, output_sigma=0.80)

WORKLOADS = {w.name: w for w in (AZURE, LMSYS, AGENT)}
