"""SLO-constrained fleet sizing: the simulator as provisioning authority.

The closed-form sizing in `core.fleet` is *optimistic*: its prefill
piggyback model (effective PREFILL_MFU) ignores queueing, so fleets it
provisions can violate the paper's P99 TTFT <= 500 ms constraint when
actually run through `serving.fleetsim` — Table 3's tok/W numbers were
quoted for fleets that don't meet their own SLO.  This module closes the
predict-vs-measure loop (the TokenPowerBench-style validation posture):

  1. provision a topology analytically (`core.topospec.TopologySpec.build`);
  2. *measure* its TTFT p99 by running the fleet end-to-end in FleetSim;
  3. while the measurement violates the SLO, recalibrate the violating
     pools — lower their effective prefill MFU (which raises the
     closed-form prefill instance bound) and force at least one extra
     instance — and re-provision;
  4. report the SLO-feasible fleet next to the unconstrained Eq. 4 one:
     the tok/W delta is the measured price of latency compliance.

Capacity is monotone non-decreasing across rounds and the SLO target is
never loosened — the loop only ever *adds* instances, so it terminates
(each violating pool grows every round) and the resulting tok/W cost is
monotone in the number of rounds.  See DESIGN.md §5/§6.

Measurement cost structure (DESIGN.md §10): every round replays one
**frozen** arrival trace (common random numbers — sampled once, so rounds
differ only in capacity and round-to-round variance is structurally
zero), `measure()` is memoized on the override signature (an exact repeat
of a configuration — e.g. a trim-bisection probe landing on an
already-measured count — costs nothing), and between rounds only pools
whose provisioning actually changed are re-simulated: unchanged pools
replay their prior round's `PoolSummary` snapshot through
`FleetSim.run(reuse=...)` (cross-pool flow only points forward, so an
unchanged topological prefix is exact, not approximate).
`SLOSizingResult.sim_stats` records the audit: full-fleet simulations
vs measure calls vs pools replayed.

The loop works for every router topology FleetSim can serve: homo,
two_pool, fleetopt, K >= 3 multipool ladders and the prefill/decode
disaggregated kinds (paper §10.3).  For disaggregated fleets the prefill
and decode fleets re-provision *independently*: TTFT violations grow the
prefill pools (they drain the prompt), TPOT violations (when
`SLOSpec.tpot_p99_ms` is set) grow the decode pools.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from .fleet import PREFILL_MFU, FleetReport, PoolOverride
from .modelspec import ModelSpec
from .profiles import BaseProfile
from .topospec import TopologySpec, plan_roles
from .workloads import Workload

# per-round backoff clamps: the capacity step is driven by the *fleet*
# TTFT overshoot (a violating pool's own p99 can be service-time-bound —
# a giant prompt's prefill takes seconds no matter how many instances
# exist — so stepping by per-pool overshoot over-provisions wildly);
# bounded to [1.15, 1.5] per round — geometric convergence with at most
# ~50% capacity overshoot past the compliance frontier — and the
# effective prefill MFU never drops below 2% of peak
_MIN_STEP = 1.15
_MAX_STEP = 1.5
_MIN_MFU = 0.02


def _max_hol() -> float:
    """Measured HOL-inflation calibration ceiling: never push the knob
    past the analytically calibrated plain-two-pool value — beyond it
    the queueing signal is double-counted with the instance ratchet,
    which grows capacity through min_instances in the same round.
    (Imported lazily: core.routing itself builds on core.fleet.)"""
    from .routing import HOL_INFLATION
    return HOL_INFLATION


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """Latency service-level objective (paper §4: P99 TTFT <= 500 ms).

    `tpot_p99_ms` optionally constrains the P99 time-per-output-token and
    `e2e_p99_s` the P99 end-to-end request latency the meters already
    report (None = TTFT-only, the paper's constraint).  The constraints
    pull on different pools: TTFT violations grow the pool that drained
    the request's prefill, TPOT and e2e violations grow the pool that
    decoded it (in a disaggregated fleet those are different fleets).
    """

    ttft_p99_s: float = 0.5
    tpot_p99_ms: Optional[float] = None
    e2e_p99_s: Optional[float] = None


@dataclasses.dataclass
class SLORound:
    """One provision -> simulate -> adjust iteration."""

    round: int
    instances: Dict[str, int]            # role -> provisioned instances
    ttft_p99_s: float                    # measured, fleet-wide
    per_pool_ttft_p99_s: Dict[str, float]
    violators: Dict[str, int]            # role -> attributed SLO violations
    budget: int                          # fleet-wide violator allowance
    analytical_tok_per_watt: float       # of this round's (adjusted) plan
    measured_tok_per_watt: float         # all-in, steady-state window
    measured_decode_tok_per_watt: float
    tpot_p99_ms: float = 0.0             # measured, fleet-wide
    e2e_p99_s: float = 0.0               # measured, fleet-wide


@dataclasses.dataclass
class SLOSizingResult:
    """SLO-feasible fleet + the audit trail that produced it."""

    kind: str
    workload: str
    slo: SLOSpec
    policy: object                       # serving.RouterPolicy
    plan: FleetReport                    # final, SLO-adjusted sizing
    unconstrained: FleetReport           # round-0 Eq. 4 sizing
    report: Dict[str, dict]              # final FleetSim report
    overrides: Dict[str, PoolOverride]   # accumulated recalibrations
    rounds: List[SLORound]
    compliant: bool
    # trim phase (DESIGN.md §5): per-role instances shaved back off the
    # geometric step's overshoot after compliance, and the number of
    # measured bisection trials it took.  The trials are not SLORounds —
    # `rounds` stays the monotone grow-only audit trail.
    trimmed: Dict[str, int] = dataclasses.field(default_factory=dict)
    trim_rounds: int = 0
    # measurement-cost audit (DESIGN.md §10): how many measure() calls the
    # sizing took, how many were full-fleet simulations vs memo hits, and
    # how many per-pool simulations the warm-start replay avoided
    sim_stats: Dict[str, int] = dataclasses.field(default_factory=dict)
    # measured HOL calibration: per-role occupancy-inflation factor the
    # loop fed back into the closed-form sizing (PoolOverride.hol_inflation)
    measured_hol: Dict[str, float] = dataclasses.field(default_factory=dict)
    # per-role violation forensics from the final measured fleet
    # (`explain()` rows: which pool busted the SLO, when, how badly) —
    # FleetScope's attribution view of the same per-request columns the
    # sizing loop reduces over
    explanation: List[dict] = dataclasses.field(default_factory=list)

    @property
    def ttft_p99_s(self) -> float:
        return float(self.report["fleet"].get("ttft_p99_s", 0.0))

    @property
    def slo_tok_per_watt(self) -> float:
        """The headline metric: analytical tok/W of the SLO-feasible fleet
        (Eq. 4 evaluated on the sizing that actually meets its SLO)."""
        return self.plan.tok_per_watt

    @property
    def measured_tok_per_watt(self) -> float:
        return float(self.report["fleet"]["tok_per_watt"])

    @property
    def measured_decode_tok_per_watt(self) -> float:
        return float(self.report["fleet"]["decode_tok_per_watt"])

    @property
    def compliance_cost_pct(self) -> float:
        """tok/W given up to meet the SLO, vs the unconstrained Eq. 4
        fleet (positive = compliance costs efficiency)."""
        u = self.unconstrained.tok_per_watt
        return 100.0 * (1.0 - self.slo_tok_per_watt / u) if u else 0.0

    @property
    def instances_added(self) -> int:
        return self.plan.instances - self.unconstrained.instances

    @property
    def instances_trimmed(self) -> int:
        return sum(self.trimmed.values())

    @property
    def calibrated_prefill_mfu(self) -> Dict[str, float]:
        """Effective per-pool prefill MFU the loop converged to (roles not
        listed kept the closed-form PREFILL_MFU)."""
        return {role: o.prefill_mfu for role, o in self.overrides.items()
                if o.prefill_mfu is not None}

    def row(self) -> dict:
        return dict(topology=self.kind, workload=self.workload,
                    unconstrained=round(self.unconstrained.tok_per_watt, 2),
                    slo_feasible=round(self.slo_tok_per_watt, 2),
                    cost_pct=round(self.compliance_cost_pct, 1),
                    measured=round(self.measured_decode_tok_per_watt, 2),
                    ttft_p99_s=round(self.ttft_p99_s, 3),
                    tpot_p99_ms=round(float(
                        self.report["fleet"].get("tpot_p99_ms", 0.0)), 3),
                    instances=self.plan.instances,
                    added=self.instances_added,
                    trimmed=self.instances_trimmed,
                    rounds=len(self.rounds),
                    compliant=self.compliant)


def explain(sim, slo: SLOSpec, *, n_bins: int = 12) -> List[dict]:
    """Per-role SLO violation forensics over a drained `FleetSim`.

    Mirrors the sizing loop's attribution (a TTFT violation belongs to
    the pool that drained the request's prefill — `ttft_role` on the
    cached summaries) but answers the *observability* question the loop
    never had to: which pool violated, **when**, and how badly.  Returns
    one row per role, worst offender first:

      role, n_obs, n_late, late_frac  — attribution counts
      worst_ttft_s                    — the single worst TTFT (NaN if the
                                        role observed nothing)
      first_violation_s,
      last_violation_s                — arrival-time span of the late
                                        requests (NaN when none)
      peak_window_s, peak_window_late — the [lo, hi) arrival-time bin (of
                                        `n_bins` over the run) holding
                                        the most violations, and its
                                        count — "the 14:00 peak did it"
    """
    n_roles = len(sim.order)
    arrivals = [[] for _ in range(n_roles)]
    ttfts = [[] for _ in range(n_roles)]
    for role in sim.order:
        s = sim.summaries[role]
        for k in range(n_roles):
            m = s.ttft_role == k
            if m.any():
                arrivals[k].append(s.arrival[m])
                ttfts[k].append((s.first_token - s.arrival)[m])
    t_hi = max((float(a.max()) for lst in arrivals for a in lst),
               default=1.0)
    edges = np.linspace(0.0, max(t_hi, 1e-9), n_bins + 1)
    out = []
    for k, role in enumerate(sim.order):
        a = np.concatenate(arrivals[k]) if arrivals[k] else np.empty(0)
        t = np.concatenate(ttfts[k]) if ttfts[k] else np.empty(0)
        late = t > slo.ttft_p99_s
        n_obs, n_late = len(t), int(late.sum())
        row = dict(role=role, n_obs=n_obs, n_late=n_late,
                   late_frac=round(n_late / n_obs, 4) if n_obs else 0.0,
                   worst_ttft_s=round(float(t.max()), 4) if n_obs
                   else float("nan"),
                   first_violation_s=float("nan"),
                   last_violation_s=float("nan"),
                   peak_window_s=(float("nan"), float("nan")),
                   peak_window_late=0)
        if n_late:
            la = a[late]
            row["first_violation_s"] = round(float(la.min()), 3)
            row["last_violation_s"] = round(float(la.max()), 3)
            hist, _ = np.histogram(la, bins=edges)
            b = int(np.argmax(hist))
            row["peak_window_s"] = (round(float(edges[b]), 3),
                                    round(float(edges[b + 1]), 3))
            row["peak_window_late"] = int(hist[b])
        out.append(row)
    out.sort(key=lambda r: (-r["n_late"], r["role"]))
    return out


class _FleetMeasurer:
    """Incremental provision-and-measure harness for the SLO loop.

    Three cost levers on top of the SoA fleet simulator:

      frozen trace  — the arrival trace is sampled exactly once (common
                      random numbers): rounds differ only in capacity,
                      and the trim bisection compares like with like.
      memoization   — `measure()` results are keyed by the override
                      signature (every per-role knob, by value), so an
                      exact configuration is never simulated twice.
      warm start    — consecutive measurements share the per-pool
                      `PoolSummary` snapshots: pools whose provisioning
                      (instance count — the only override-movable input
                      the simulator sees) is unchanged over an unchanged
                      topological prefix are replayed from their prior
                      steady state via `FleetSim.run(reuse=...)` instead
                      of re-simulated.

    `stats` carries the audit counts `size_to_slo` exposes as
    `SLOSizingResult.sim_stats`.

    The measurer is keyed on a `TopologySpec` (the IR is the single
    provisioning authority — `spec.build` replaces the old kind-string
    `build_topology` plumbing), and the frozen trace can be *injected*
    (`trace=`): the topology search (`core.topo_search`) sizes many
    candidate specs against one shared trace, so candidate scores differ
    only in topology, never in arrival noise.
    """

    def __init__(self, spec: TopologySpec, workload: Workload, *,
                 n_requests: int, seed: int, prefill_chunk: int,
                 engine: str = "numpy", trace=None, device="cuda"):
        # serving imports are lazy: core stays importable without the
        # serving layer, and the serving layer itself imports core.fleet
        from ..serving import fleetsim as _fs
        from ..serving.request import sample_trace
        self._fs = _fs
        self.spec, self.workload = spec, workload
        self.n_requests, self.seed = n_requests, seed
        self.prefill_chunk = prefill_chunk
        self.engine, self.device = engine, device
        # common random numbers: ONE frozen trace for every round/trial
        self._trace = trace if trace is not None else sample_trace(
            workload, n_requests, seed=seed, max_total=spec.max_window)
        self._memo: Dict[tuple, tuple] = {}
        self._prev: Optional[tuple] = None   # (roles, sigs, summaries)
        self.stats = dict(measure_calls=0, memo_hits=0, full_fleet_sims=0,
                          pool_sims=0, pools_reused=0)

    def _requests(self):
        # fresh mutable Request objects over the frozen trace, built by
        # the one shared construction path (serving.fleetsim) so the SLO
        # loop can never diverge from simulate_topology's conventions
        return self._fs.trace_requests(self.workload, self.n_requests,
                                       trace=self._trace)

    @staticmethod
    def _sig(overrides: Dict[str, PoolOverride]) -> tuple:
        return tuple(sorted(
            (role, (o.prefill_mfu, o.hol_inflation, o.min_instances,
                    o.extra_instances, o.max_instances))
            for role, o in overrides.items()))

    def measure(self, overrides: Dict[str, PoolOverride]):
        """Provision with `overrides`, measure end-to-end; returns
        (policy, plan, sim, report)."""
        self.stats["measure_calls"] += 1
        key = self._sig(overrides)
        if key in self._memo:
            self.stats["memo_hits"] += 1
            return self._memo[key]
        policy, plan, registry = self.spec.build(
            self.workload, pool_overrides=overrides or None)
        sim = self._fs.FleetSim(policy, plan, registry=registry,
                                prefill_chunk=self.prefill_chunk,
                                rng_seed=self.seed, engine=self.engine,
                                device=self.device)
        roles = plan_roles(plan)
        # the only sim-relevant quantity a PoolOverride can move is the
        # instance count (the recalibrated MFU/HOL change the *bounds*,
        # not the engines) — so an unchanged count over an unchanged
        # topological prefix means an identical pool simulation
        sigs = [max(p.instances, 1)
                for p in sorted(plan.pools, key=lambda p: p.window)]
        reuse = {}
        if self._prev is not None and self._prev[0] == roles:
            for role, new_sig, old_sig in zip(roles, sigs, self._prev[1]):
                if new_sig != old_sig:
                    break
                reuse[role] = self._prev[2][role]
        report = sim.run(self._requests(), reuse=reuse or None)
        self.stats["pool_sims"] += len(sim.fresh_roles)
        self.stats["pools_reused"] += len(roles) - len(sim.fresh_roles)
        if not reuse:
            self.stats["full_fleet_sims"] += 1
        self._prev = (roles, sigs, dict(sim.summaries))
        out = (policy, plan, sim, report)
        self._memo[key] = out
        return out


def size_to_slo_spec(spec: TopologySpec, workload: Workload, *,
                     slo: SLOSpec = SLOSpec(),
                     n_requests: int = 3000, seed: int = 0,
                     max_rounds: int = 8, prefill_chunk: int = 512,
                     trim: bool = True,
                     engine: str = "numpy",
                     trace=None, device="cuda") -> SLOSizingResult:
    """Iteratively re-provision `spec` until the *measured* TTFT p99 meets
    the SLO (or `max_rounds` is exhausted — `compliant` reports which).

    Each round replays the identical request trace (same seed), so rounds
    differ only in fleet capacity.  Violating pools are identified by
    violator-count attribution: a pool is grown when it holds more
    requests with TTFT > SLO than its completion-weighted share of the
    fleet-wide p99 budget (floor(1% x completions)), falling back to the
    largest remaining contributor; pools whose violator count stops
    dropping despite growth are saturated (service-time-bound) and
    excluded.  Each grown pool is recalibrated via `PoolOverride`:
    effective prefill MFU backed off by the *fleet* TTFT overshoot and
    the instance floor stepped up by the same factor (at least one
    instance per round, for guaranteed progress).

    Works for every `TopologySpec` FleetSim can serve — hand-built specs
    and every `TopologySpec.from_kind` compilation alike (the legacy
    kind-string front end is `size_to_slo`).  Pass `trace=` to share one
    frozen arrival trace across many candidate specs (the topology
    search's common-random-numbers discipline); by default the measurer
    samples its own trace capped at `spec.max_window`.  `engine` picks
    every round's drain ("numpy" or "graph"); `device` is where a "graph"
    drain runs ("cuda" unless the caller asks for the CPU).

    After compliance, a **trim phase** (`trim=True`) bisects each grown
    pool's instance count back down toward its round-0 sizing, keeping
    only capacity the measured SLO actually needs — the geometric step
    converges from above with up to ~1.5x overshoot, and the bisection
    claws that back (`SLOSizingResult.trimmed`).  Every trial re-measures
    the full fleet, so the final report is always measured-compliant;
    trials never enter `rounds` (which stays the monotone grow-only audit
    trail).
    """
    measurer = _FleetMeasurer(
        spec, workload, n_requests=n_requests, seed=seed,
        prefill_chunk=prefill_chunk, engine=engine, trace=trace,
        device=device)
    measure = measurer.measure
    kind = spec.kind

    def meets(report: Dict[str, dict]) -> bool:
        f = report["fleet"]
        return (float(f.get("ttft_p99_s", 0.0)) <= slo.ttft_p99_s
                and (slo.tpot_p99_ms is None
                     or float(f.get("tpot_p99_ms", 0.0)) <= slo.tpot_p99_ms)
                and (slo.e2e_p99_s is None
                     or float(f.get("e2e_p99_s", 0.0)) <= slo.e2e_p99_s))

    overrides: Dict[str, PoolOverride] = {}
    rounds: List[SLORound] = []
    measured_hol: Dict[str, float] = {}
    unconstrained: Optional[FleetReport] = None
    base_mfu: Dict[str, float] = {}
    policy = plan = report = sim = None
    compliant = False
    prev_violators: Dict[str, int] = {}
    grown_last: set = set()
    saturated: set = set()
    for round_i in range(max_rounds):
        policy, plan, sim, report = measure(overrides)
        if unconstrained is None:
            # round 0 has no overrides: this plan IS the pure Eq. 4 sizing
            # (later rounds re-provision fresh PoolSizing objects, so it
            # is never mutated again)
            unconstrained = plan
            # MFU backoff starts from each pool's *sized* MFU, not the
            # global closed-form constant (a disagg prefill pool may have
            # been provisioned at its own dedicated-prefill MFU)
            base_mfu = {pool.role: pool.sized_prefill_mfu
                        for pool in plan.pools}
        fleet_p99 = float(report["fleet"].get("ttft_p99_s", 0.0))
        fleet_tpot = float(report["fleet"].get("tpot_p99_ms", 0.0))
        fleet_e2e = float(report["fleet"].get("e2e_p99_s", 0.0))
        per_pool = {role: float(lat.get("ttft_p99_s", 0.0))
                    for role, lat in sim.latency_by_role().items()}
        # violation attribution: the fleet p99 <= SLO iff at most
        # floor(1% of observations) exceed the SLO — count each pool's
        # contribution to that fleet-wide violator budget.  A TTFT
        # violation is attributed to the pool that drained the request's
        # prefill (in a disagg fleet that is the prefill pool: decode
        # capacity cannot buy TTFT there); a TPOT or e2e violation (when
        # the SLO constrains them) to the pool that decoded the request.
        # Counted by array reduction over the cached pool summaries — the
        # summaries carry per-completed-request metric columns, so reused
        # (warm-started) pools attribute without any Request objects.
        n_roles = len(sim.order)
        viol = np.zeros(n_roles, np.int64)
        obs = np.zeros(n_roles, np.int64)
        for k, role in enumerate(sim.order):
            s = sim.summaries[role]
            obs += np.bincount(s.ttft_role, minlength=n_roles)
            late = (s.first_token - s.arrival) > slo.ttft_p99_s
            viol += np.bincount(s.ttft_role[late], minlength=n_roles)
            if slo.tpot_p99_ms is not None:
                m = s.n_generated > 1
                obs[k] += int(m.sum())
                tpot_ms = 1e3 * (s.finish[m] - s.first_token[m]) \
                    / (s.n_generated[m] - 1)
                viol[k] += int((tpot_ms > slo.tpot_p99_ms).sum())
            if slo.e2e_p99_s is not None:
                m = s.finish >= 0
                obs[k] += int(m.sum())
                viol[k] += int(((s.finish[m] - s.arrival[m])
                                > slo.e2e_p99_s).sum())
        violators = {role: int(viol[k]) for k, role in enumerate(sim.order)}
        observations = {role: int(obs[k])
                        for k, role in enumerate(sim.order)}
        n_obs = max(sum(observations.values()), 1)
        budget = int(0.01 * n_obs)
        rounds.append(SLORound(
            round=round_i,
            instances={role: sim.groups[role].instances
                       for role in sim.order},
            ttft_p99_s=fleet_p99, tpot_p99_ms=fleet_tpot,
            e2e_p99_s=fleet_e2e,
            per_pool_ttft_p99_s=per_pool,
            violators=violators, budget=budget,
            analytical_tok_per_watt=plan.tok_per_watt,
            measured_tok_per_watt=float(report["fleet"]["tok_per_watt"]),
            measured_decode_tok_per_watt=float(
                report["fleet"]["decode_tok_per_watt"])))
        if meets(report):
            compliant = True
            break
        # a pool that was grown last round but whose violator count did
        # not drop is service-time-bound (e.g. a giant prompt's prefill
        # takes seconds regardless of capacity): stop pouring instances in
        saturated |= {role for role in grown_last
                      if violators.get(role, 0)
                      >= prev_violators.get(role, 0)}
        # grow pools holding more than their observation-weighted share of
        # the fleet violator budget; fall back to the biggest contributor
        violating = [
            role for role in sim.order
            if violators[role] > budget * (observations[role] / n_obs)
            and role not in saturated]
        if not violating:
            violating = [r for r in sorted(violators, key=violators.get,
                                           reverse=True)
                         if violators[r] > 0 and r not in saturated][:1]
        if not violating:            # every contributor is saturated:
            break                    # capacity cannot buy this SLO
        overshoot = fleet_p99 / slo.ttft_p99_s
        if slo.tpot_p99_ms:
            overshoot = max(overshoot, fleet_tpot / slo.tpot_p99_ms)
        if slo.e2e_p99_s:
            overshoot = max(overshoot, fleet_e2e / slo.e2e_p99_s)
        step = min(max(overshoot, _MIN_STEP), _MAX_STEP)
        roles = plan_roles(plan)
        pools_by_role = {p.role: p for p in plan.pools}
        for role in violating:
            if role not in roles:    # defensive: role vanished from plan
                continue
            start_mfu = base_mfu.get(role, PREFILL_MFU)
            o = overrides.setdefault(
                role, PoolOverride(prefill_mfu=start_mfu))
            o.prefill_mfu = max((o.prefill_mfu or start_mfu) / step,
                                _MIN_MFU)
            # hol_inflation recalibration (ROADMAP gap): the simulator
            # measures each pool's head-of-line queueing directly — the
            # steady-state-windowed mean occupied-slot population
            # (m_slot_seconds / window span, ramp-in and drain excluded
            # like every m_* meter counter) vs the closed form's
            # Little's-law in-flight population at the hol = 1 baseline.
            # Feeding the measured inflation back through PoolOverride
            # raises the closed-form decode/prefill bounds for congested
            # pools instead of leaving the knob at the analytical
            # default (capped at the calibrated two-pool ceiling;
            # decode-phase pools only — a prefill-phase pool's occupancy
            # is chunk-queue depth, not a decode population).
            pool = pools_by_role[role]
            s = sim.summaries[role]
            if pool.phase != "prefill" and pool.n_inflight > 0:
                n_meas = s.m_slot_seconds / s.measure_span
                hol1 = pool.n_inflight / pool.hol_inflation
                hol_meas = n_meas / hol1 if hol1 > 0 else 1.0
                measured_hol[role] = round(hol_meas, 3)
                if hol_meas > 1.0:
                    o.hol_inflation = max(o.hol_inflation or 1.0,
                                          min(hol_meas, _max_hol()))
            # the MFU backoff only bites once the prefill bound binds, so
            # also ratchet the instance floor by the same step (at least
            # one new instance, for guaranteed progress); floor and bound
            # take a max in recalibrate(), they never compound
            cur = sim.groups[role].instances
            o.min_instances = max(o.min_instances, cur
                                  + max(int(math.ceil(cur * (step - 1.0))),
                                        1))
        prev_violators = violators
        grown_last = set(violating)
    # --- trim phase: bisect the geometric step's capacity overshoot back
    # down (ROADMAP open item).  Every candidate is measured end-to-end,
    # so a kept cap is a *verified* compliance fact; pools are trimmed
    # most-grown-first and each pool's accepted cap stays in force while
    # the next is bisected.
    trimmed: Dict[str, int] = {}
    trim_rounds = 0
    if trim and compliant and overrides and len(rounds) > 1:
        counts = dict(rounds[-1].instances)
        floors = rounds[0].instances
        grown = sorted((r for r in counts
                        if counts[r] > floors.get(r, counts[r])),
                       key=lambda r: counts[r] - floors[r], reverse=True)
        for role in grown:
            lo, best = floors[role], counts[role]
            o = overrides[role]   # grown roles always carry an override
            while lo < best:
                mid = (lo + best) // 2
                o.max_instances = mid
                trial = measure(overrides)
                trim_rounds += 1
                if meets(trial[3]):
                    best = mid
                    policy, plan, sim, report = trial
                else:
                    lo = mid + 1
            o.max_instances = best if best < counts[role] else 0
            if best < counts[role]:
                trimmed[role] = counts[role] - best
                counts[role] = best
    return SLOSizingResult(
        kind=kind, workload=workload.name, slo=slo, policy=policy,
        plan=plan, unconstrained=unconstrained, report=report,
        overrides=overrides, rounds=rounds, compliant=compliant,
        trimmed=trimmed, trim_rounds=trim_rounds,
        sim_stats=dict(measurer.stats), measured_hol=measured_hol,
        explanation=explain(sim, slo) if sim is not None else [])


def size_to_slo(kind: str, workload: Workload, profile: BaseProfile,
                model: ModelSpec, *, b_short: int = 4096,
                gamma: float = 2.0,
                windows: Optional[Sequence[int]] = None,
                slo: SLOSpec = SLOSpec(),
                n_requests: int = 3000, seed: int = 0,
                max_rounds: int = 8, prefill_chunk: int = 512,
                small_model: Optional[ModelSpec] = None,
                small_profile: Optional[BaseProfile] = None,
                misroute_rate: float = 0.0,
                dispatch_ms: float = 0.0,
                trim: bool = True,
                long_window: Optional[int] = None,
                engine: str = "numpy", device="cuda") -> SLOSizingResult:
    """Legacy kind-string front end for `size_to_slo_spec`: compile the
    kind to its `TopologySpec` (`TopologySpec.from_kind` is the single
    kind-dispatch site in the codebase) and size that.  The frozen-trace
    cap is `spec.max_window`, which subsumes the old multipool
    `max(windows)` special case; pass `long_window` to stretch the
    terminal serve window of the non-multipool kinds."""
    from .routing import LONG_WINDOW

    spec = TopologySpec.from_kind(
        kind, profile, model, b_short=b_short, gamma=gamma,
        long_window=int(long_window) if long_window else LONG_WINDOW,
        windows=windows, small_model=small_model,
        small_profile=small_profile, misroute_rate=misroute_rate,
        dispatch_ms=dispatch_ms, misroute_seed=seed)
    return size_to_slo_spec(
        spec, workload, slo=slo, n_requests=n_requests, seed=seed,
        max_rounds=max_rounds, prefill_chunk=prefill_chunk, trim=trim,
        engine=engine, device=device)
