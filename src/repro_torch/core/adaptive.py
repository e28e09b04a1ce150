"""Beyond-paper: adaptive topology control (paper §10.3: "an online
controller that monitors the live request-length distribution and adjusts
pool boundaries dynamically could maintain near-optimal tok/W under
distribution shift").

`AdaptiveController` keeps an exponentially-weighted reservoir of observed
(prompt, output) pairs and periodically re-optimizes (B_short, gamma)
under the same SLO-constrained grid the offline optimizer uses.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from .modelspec import ModelSpec
from .profiles import BaseProfile
from .routing import FleetOpt, optimize_gamma
from .workloads import Workload


@dataclasses.dataclass(frozen=True)
class _ReservoirWorkload(Workload):
    """Workload view backed by observed samples instead of the parametric
    mixture."""
    samples: Optional[np.ndarray] = None        # (n, 2) prompt, output

    @property
    def _sample(self):  # type: ignore[override]
        return self.samples[:, 0].astype(float), \
            self.samples[:, 1].astype(float)


def _observed(samples: np.ndarray, arrival_rate: float) -> Workload:
    wl = _ReservoirWorkload(
        name="observed", prompt_mix=((1.0, 0.0, 1.0),),
        output_mu=0.0, output_sigma=1.0, arrival_rate=arrival_rate,
        samples=samples)
    return wl


class AdaptiveController:
    def __init__(self, profile: BaseProfile, model: ModelSpec, *,
                 arrival_rate: float = 1000.0, capacity: int = 20000,
                 b_short_grid: Tuple[int, ...] = (1536, 4096, 8192, 16384),
                 reoptimize_every: int = 5000, seed: int = 0):
        self.profile, self.model = profile, model
        self.arrival_rate = arrival_rate
        self.capacity = capacity
        self.grid = b_short_grid
        self.every = reoptimize_every
        self.rng = np.random.default_rng(seed)
        self.buf = np.zeros((0, 2), np.int64)
        self.seen = 0
        self.b_short, self.gamma = 4096, 2.0
        self.history: List[dict] = []

    def observe(self, prompt_len: int, output_len: int) -> None:
        row = np.array([[prompt_len, output_len]])
        if len(self.buf) < self.capacity:
            self.buf = np.concatenate([self.buf, row])
        else:   # reservoir sampling
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.capacity:
                self.buf[j] = row
        self.seen += 1
        if self.seen % self.every == 0 and len(self.buf) > 1000:
            self.reoptimize()

    def reoptimize(self) -> Tuple[int, float]:
        wl = _observed(self.buf, self.arrival_rate)
        best = (self.b_short, self.gamma, -1.0)
        for b in self.grid:
            g, rep = optimize_gamma(wl, self.profile, self.model, b)
            if rep.tok_per_watt > best[2]:
                best = (b, g, rep.tok_per_watt)
        self.b_short, self.gamma = best[0], best[1]
        self.history.append(dict(seen=self.seen, b_short=self.b_short,
                                 gamma=self.gamma,
                                 tok_per_watt=round(best[2], 2)))
        return self.b_short, self.gamma

    def route(self, prompt_len: int, expected_output: float) -> str:
        return ("short" if prompt_len + expected_output <= self.b_short
                else "long")
