"""Beyond-paper: K >= 3 context-window pools (paper §10.3 future work).

"The multiplicative gain structure suggests that finer-grained topologies
could compound further efficiency improvements, but this is not analyzed
here."  — we analyze it.  A K-pool topology partitions traffic by
predicted total into K geometric windows; each pool gets FleetOpt-style
overflow headroom (route at w/gamma, serve at w).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from .fleet import FleetReport, PoolSizing, size_fleet
from .modelspec import ModelSpec
from .profiles import BaseProfile
from .routing import _subset_stats
from .workloads import Workload


@dataclasses.dataclass
class MultiPool:
    """Pools at `windows` (ascending); requests go to the smallest window
    whose admission boundary (window / gamma) covers their predicted
    total."""

    windows: Sequence[int]
    gamma: float = 2.0

    def provision(self, workload: Workload, profile: BaseProfile,
                  model: ModelSpec) -> FleetReport:
        ws = [int(w) for w in self.windows]
        if not ws or any(a >= b for a, b in zip(ws, ws[1:])):
            raise ValueError(
                f"MultiPool windows must be strictly ascending, got {ws}")
        if self.gamma < 1.0:
            raise ValueError(f"gamma must be >= 1, got {self.gamma}")
        names = [f"pool-{w // 1024}K" for w in ws]
        if len(set(names)) != len(names):
            raise ValueError(f"windows {ws} collide at 1K naming"
                             f" granularity: {names}")
        p, o = workload.prompts, workload.outputs
        lam = workload.arrival_rate
        predicted = p + workload.mean_output
        pools: List[PoolSizing] = []
        assigned = np.zeros(p.shape, bool)
        for i, w in enumerate(ws):
            boundary = w / self.gamma if i < len(ws) - 1 else w
            mask = ~assigned & (predicted <= boundary)
            if i == len(ws) - 1:             # largest pool takes the rest
                mask = ~assigned
            assigned |= mask
            s = _subset_stats(p, o, mask)
            pools.append(PoolSizing(
                name=names[i], window=int(w), profile=profile,
                arrival_rate=lam * s["frac"],
                mean_output=s["mean_output"],
                mean_context=s["mean_context"],
                mean_prompt=s["mean_prompt"]))
        return size_fleet(pools, streamed_params=model.streamed_params,
                          label=f"MultiPool{list(self.windows)}")


def ladder_windows(k: int, *, max_window: int = 65536,
                   min_window: int = 2048) -> List[int]:
    """Geometric window ladder ending at max_window.  The min_window clamp
    can collapse the bottom rungs into duplicates (e.g. two 2K pools at
    k >= 4 under a 64K ceiling) — those are deduped, so the effective pool
    count may be smaller than `k`."""
    windows = [max(max_window // (4 ** (k - 1 - i)), min_window)
               for i in range(k)]
    return sorted(dict.fromkeys(windows))


def sweep_pool_counts(workload: Workload, profile: BaseProfile,
                      model: ModelSpec, *, max_window: int = 65536,
                      ) -> List[Tuple[int, float]]:
    """Fleet tok/W vs *effective* number of pools (deduped geometric window
    ladder).  Requested k whose clamped ladder collapses onto an already
    reported pool count are skipped — no dead duplicate-window pools."""
    out = []
    seen = set()
    for k in (1, 2, 3, 4, 5):
        windows = ladder_windows(k, max_window=max_window)
        if len(windows) in seen:
            continue
        seen.add(len(windows))
        rep = MultiPool(windows=windows).provision(workload, profile, model)
        out.append((len(windows), rep.tok_per_watt))
    return out
