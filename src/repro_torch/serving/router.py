"""Context-length router — the paper's technique as a serving-layer feature.

`ContextRouter` fronts a set of PoolEngines and routes each request through
an **ordered admission ladder**: (role, boundary) pairs with strictly
ascending boundaries, the last infinite.  A request goes to the first role
whose boundary covers its routing metric.  The three §4 topologies are
instances of the ladder:

  homo      — [(only, inf)]: one pool, the long window.
  two_pool  — [(short, B_short), (long, inf)] on the conservative metric
              prompt + p99(output) (no overflow handling).
  fleetopt  — [(short, gamma * B_short), (long, inf)] on predicted total;
              the short pool serves window gamma * B_short.

The router decides which segment of the logistic P(b) curve each engine
occupies — the mechanism behind the fleet-level 2.5x (paper §4.2).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from .request import Request


@dataclasses.dataclass
class RouterPolicy:
    # the topology kind this policy describes (a label: routing behaviour
    # is fully determined by the fields below)
    kind: str
    b_short: int = 4096
    gamma: float = 2.0
    p99_output: int = 1024     # conservative prompt_plus_p99 margin
    # ordered (role, admission boundary) ladder; required
    ladder: Optional[List[Tuple[str, float]]] = None
    # routing metric: "predicted_total" (prompt + E[output]) or
    # "prompt_plus_p99" (prompt + p99_output — conservative two_pool)
    metric_kind: str = "predicted_total"

    def admission_ladder(self) -> List[Tuple[str, float]]:
        """Ordered (role, boundary) pairs; route to the first role whose
        boundary >= the request's routing metric."""
        if not self.ladder:
            raise ValueError(f"{self.kind} policy needs an explicit ladder")
        return list(self.ladder)

    def metric(self, req: Request) -> float:
        if self.metric_kind == "prompt_plus_p99":
            return req.prompt_len + self.p99_output
        return req.predicted_total


class ContextRouter:
    """Routes requests over pool engines and aggregates their reports."""

    def __init__(self, pools: Dict[str, object], policy: RouterPolicy):
        self.pools = pools
        self.policy = policy
        ladder = policy.admission_ladder()
        missing = [r for r, _ in ladder if r not in pools]
        if missing:
            raise ValueError(f"ladder roles without a pool: {missing}"
                             f" (pools: {sorted(pools)})")
        bounds = [b for _, b in ladder]
        if not all(a < b for a, b in zip(bounds, bounds[1:])):
            raise ValueError("admission boundaries must be strictly"
                             f" ascending: {ladder}")
        if not math.isinf(bounds[-1]):
            raise ValueError(f"last ladder entry must admit everything:"
                             f" {ladder}")

    def route(self, req: Request) -> str:
        m = self.policy.metric(req)
        for name, boundary in self.policy.admission_ladder():
            if m <= boundary:
                self.pools[name].submit(req)
                return name
        raise AssertionError(f"no ladder entry admits metric {m}")

    def run(self, requests: List[Request], *, max_iters: int = 100_000
            ) -> Dict[str, dict]:
        """Route every request, drain every pool, report.  A pool still
        busy at `max_iters` raises `DrainTruncatedError`: a truncated drain
        would roll under-counted tokens/energy into the fleet tok/W."""
        for r in requests:
            self.route(r)
        for eng in self.pools.values():
            eng.run_until_drained(max_iters=max_iters)
        return self.report()

    def report(self) -> Dict[str, dict]:
        """Per-pool stats + fleet roll-up over each meter's measurement
        window (the `m_*` counters)."""
        out = {name: eng.stats() for name, eng in self.pools.items()}
        totals = [eng.measured_totals() for eng in self.pools.values()]
        tot_tok = sum(t["tokens"] for t in totals)
        tot_j = sum(t["joules"] for t in totals)
        out["fleet"] = dict(tokens=tot_tok, joules=round(tot_j, 1),
                            tok_per_watt=round(tot_tok / tot_j, 3)
                            if tot_j else 0.0)
        return out
