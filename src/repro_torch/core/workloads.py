"""Workload traces (paper §4/§7): context-length distributions.

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
