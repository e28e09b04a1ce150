"""Context-length router — the paper's technique as a serving-layer feature.

`ContextRouter` fronts a set of PoolEngines and routes each request through
an **ordered admission ladder**: (role, boundary) pairs with strictly
ascending boundaries, the last infinite.  A request goes to the first role
whose boundary covers its routing metric.  The §4 topologies and the
§10.3 K >= 3 generalisation are instances of the ladder:

  homo      — [(only, inf)]: one pool, the long window.
  two_pool  — [(short, B_short), (long, inf)] on the conservative metric
              prompt + p99(output) (no overflow handling).
  fleetopt  — [(short, gamma * B_short), (long, inf)] on predicted total;
              the short pool serves window gamma * B_short.
  multipool — an explicit K-entry ladder of geometric windows.
  semantic  — §5.1 model-heterogeneous routing: a [small @ B_short,
              large @ inf] ladder whose rungs serve *different models*.
              The classifier is the ladder metric degraded by
              `misroute_rate`: each decision flips with that probability,
              deterministically per request id.  A true-short request
              flipped large is just served inefficiently; a true-large one
              flipped small is tagged `escalate_at = detect_tokens`, and
              the small-model engine evicts it after that many decode
              tokens into its `escalated` list, to be re-served from
              scratch by the large pool, its small-pool tokens backed out.

The router decides which segment of the logistic P(b) curve each engine
occupies — the mechanism behind the fleet-level 2.5x (paper §4.2).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.routing import ESCALATION_DETECT_TOKENS
from ..core.topospec import SEMANTIC_KINDS  # noqa: F401  (re-export)
from .request import Request

_HASH_A = 2654435761          # Knuth multiplicative hash (mod 2^32)


def _misroute_u(rid: int, seed: int) -> float:
    """Deterministic per-request uniform in [0, 1) for the misroute draw:
    a pure function of (rid, seed), so routing is order-independent and a
    higher misroute rate flips a superset of a lower rate's requests."""
    return ((rid * _HASH_A + seed * 0x9E3779B9) % (1 << 32)) / float(1 << 32)


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
    # misroute channel: the (small, large) role pair the classifier's
    # decisions flip between; None disables flipping entirely
    flip: Optional[Tuple[str, str]] = None
    # classifier error rate, detection latency (decode tokens the small
    # model emits before a misroute escalates) and the seed of the
    # deterministic per-request misroute draw
    misroute_rate: float = 0.0
    detect_tokens: int = ESCALATION_DETECT_TOKENS
    misroute_seed: int = 0
    # the topology description this policy was compiled from, if any
    spec: Optional[object] = dataclasses.field(default=None, repr=False)

    @property
    def is_semantic(self) -> bool:
        return self.flip is not None

    def admission_ladder(self, roles: Sequence[str] = ()
                         ) -> List[Tuple[str, float]]:
        """Ordered (role, boundary) pairs; route to the first role whose
        boundary >= the request's routing metric.  `roles` is accepted
        for the reference's signature and not read: the ladder is
        explicit."""
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
                name = self._semantic_flip(req, name)
                self.pools[name].submit(req)
                return name
        raise AssertionError(f"no ladder entry admits metric {m}")

    def _semantic_flip(self, req: Request, nominal: str) -> str:
        """The classifier's error channel: flip the decision with
        probability `misroute_rate` (deterministic per request).  A
        true-large request flipped into the small-model pool is tagged for
        escalation after `detect_tokens` of decode."""
        pol = self.policy
        if not (pol.flip is not None and pol.misroute_rate > 0.0):
            return nominal
        if _misroute_u(req.rid, pol.misroute_seed) >= pol.misroute_rate:
            return nominal
        small, large = pol.flip
        if nominal not in (small, large):
            return nominal
        req.misrouted = True
        if nominal == large:
            req.escalate_at = pol.detect_tokens
            return small
        return large

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
