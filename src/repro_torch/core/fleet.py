"""Fleet sizing & fleet-level tok/W (paper §4, Eq. 4).

Sizing model (documented; FleetOpt internals are unpublished, see DESIGN.md §4):

  decode bound  — Little's law on the decode phase: the steady-state
                  in-flight population is N = lambda_i * Lbar_out * tau(n_max,
                  Lbar_ctx); instances = ceil(N / n_max).
  prefill bound — P99 TTFT <= 500 ms forces enough aggregate prefill
                  throughput: tokens/s_prefill = tp * peak_flops * mfu /
                  (2 * streamed_params).  Chunked prefill piggybacks on
                  memory-bound decode iterations, captured by `prefill_mfu`.
  no-overflow penalty — plain two-pool routing (no FleetOpt overflow /
                  compression) suffers conservative admission and
                  head-of-line blocking of long prefills in the long pool;
                  modeled as a long-pool occupancy inflation factor
                  `hol_inflation` (calibrated against Table 3; = 1.0 for
                  Homo and FleetOpt).

Power per instance is evaluated at the operating concurrency
n_act = min(N / instances, rho_op * n_max), rho_op = 0.85 (§5.1 uses the same
utilization).  "Instance" = one TP group (the paper's per-"GPU" power rows
are per TP-8 instance; see EXPERIMENTS.md §Claims).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

from .profiles import BaseProfile

RHO_OP = 0.85           # operating utilization for the power term
# Effective prefill MFU (chunked prefill piggybacks on memory-bound decode
# iterations, so the achievable fraction of peak is high).  Calibrated
# jointly with HOL_INFLATION against Table 3 (see EXPERIMENTS.md §Claims).
# NOTE: this closed-form value is optimistic about queueing — fleets sized
# with it can violate the P99 TTFT SLO when actually run.  core.slo closes
# the loop by recalibrating an *effective* per-pool prefill MFU against the
# measured FleetSim TTFT (see DESIGN.md §5).
PREFILL_MFU = 0.8
# Dedicated prefill-phase pools (core.disagg) run compute-saturated: power
# is drawn near the logistic's P_nom asymptote, not at the decode operating
# point (batch-formation gaps keep it a hair under full saturation).
PREFILL_SATURATION = 0.97


@dataclasses.dataclass
class PoolSizing:
    """One provisioned pool of identical instances."""

    name: str
    window: int
    profile: BaseProfile
    arrival_rate: float          # requests/s routed here
    mean_output: float           # tokens
    mean_context: float          # mean KV length during decode
    mean_prompt: float           # tokens (prefill load)
    hol_inflation: float = 1.0
    # "decode" (default) or "prefill" — a prefill-phase pool (core.disagg)
    # is a compute-bound chunk processor: it is sized by the prefill bound
    # alone and draws saturated power instead of the decode operating point.
    phase: str = "decode"
    # physical MFU the prefill-phase *engines* run at (serving.fleetsim);
    # immutable under SLO recalibration, which only moves the sizing MFU.
    prefill_engine_mfu: Optional[float] = None
    # router role this pool serves, stamped by the TopologySpec IR
    # (core.topospec) at provision time — the single source every layer
    # (FleetSim wiring, SLO attribution, override application) reads role
    # names from; "" means the pool was built outside the IR.
    role: str = ""
    # computed:
    instances: int = 0
    n_active: float = 0.0
    power_w_per_instance: float = 0.0
    tokens_per_s: float = 0.0
    decode_bound: int = 0
    prefill_bound: int = 0
    n_inflight: float = 0.0      # Little's-law decode population (size())
    sized_prefill_mfu: float = PREFILL_MFU   # MFU the bounds were sized at

    def size(self, *, streamed_params: float,
             prefill_mfu: Optional[float] = None) -> "PoolSizing":
        if prefill_mfu is None:
            prefill_mfu = PREFILL_MFU  # read at call time (calibratable)
        self.sized_prefill_mfu = prefill_mfu
        prof = self.profile
        nmax = prof.n_max(self.window)
        tau_s = prof.roofline.tau_ms(nmax, self.mean_context) * 1e-3
        n_inflight = self.arrival_rate * self.mean_output * tau_s \
            * self.hol_inflation
        self.n_inflight = n_inflight
        self.decode_bound = math.ceil(n_inflight / nmax) if n_inflight else 0
        self.prefill_bound = self._prefill_bound(streamed_params, prefill_mfu)
        self.instances = max(self.decode_bound, self.prefill_bound, 0)
        if self.arrival_rate > 0:
            self.instances = max(self.instances, 1)
        if self.instances:
            self._operating_point()
            self.tokens_per_s = self.arrival_rate * self.mean_output
        return self

    def _prefill_bound(self, streamed_params: float,
                       prefill_mfu: float) -> int:
        """Instances forced by aggregate prefill throughput (tokens/s)."""
        prof = self.profile
        prefill_tput = (prof.tp * prof.chip.peak_bf16_flops * prefill_mfu
                        / (2.0 * streamed_params))
        prefill_load = self.arrival_rate * self.mean_prompt * self.hol_inflation
        return math.ceil(prefill_load / prefill_tput) if prefill_load else 0

    def _operating_point(self) -> None:
        nmax = self.profile.n_max(self.window)
        if self.phase == "prefill":
            # compute-bound: the profile's own concurrency ceiling and the
            # near-saturated end of its logistic (Eq. 1 as b -> inf)
            self.n_active = RHO_OP * nmax
            self.power_w_per_instance = \
                self.profile.power_model.p_nom_w * PREFILL_SATURATION
            return
        self.n_active = min(self.n_inflight / self.instances, RHO_OP * nmax)
        self.power_w_per_instance = self.profile.power_w(self.n_active)

    def recalibrate(self, *, streamed_params: float,
                    prefill_mfu: Optional[float] = None,
                    hol_inflation: Optional[float] = None,
                    min_instances: int = 0,
                    extra_instances: int = 0,
                    max_instances: int = 0) -> "PoolSizing":
        """SLO-loop re-provisioning knob (core.slo / DESIGN.md §5): re-derive
        the instance count under a recalibrated effective prefill MFU,
        head-of-line inflation factor and/or an instance-count floor,
        preserving every provision-time adjustment (e.g. FleetOpt's
        migrated-token backout of `tokens_per_s`).  The grow levers never
        *shrink* a pool — SLO compliance only adds capacity; `max_instances`
        (> 0) is the trim phase's cap, applied last so a measured-compliant
        bisection can shave the geometric step's overshoot below what the
        recalibrated bounds would provision (the cap encodes a *measured*
        compliance fact that overrides the pessimistic closed form)."""
        if self.arrival_rate <= 0:
            return self
        if hol_inflation is not None:
            self.hol_inflation = max(hol_inflation, self.hol_inflation)
            prof = self.profile
            nmax = prof.n_max(self.window)
            tau_s = prof.roofline.tau_ms(nmax, self.mean_context) * 1e-3
            self.n_inflight = self.arrival_rate * self.mean_output * tau_s \
                * self.hol_inflation
            self.decode_bound = math.ceil(self.n_inflight / nmax) \
                if self.n_inflight else 0
        if prefill_mfu is not None:
            self.sized_prefill_mfu = prefill_mfu
        if prefill_mfu is not None or hol_inflation is not None:
            self.prefill_bound = self._prefill_bound(
                streamed_params, self.sized_prefill_mfu)
        self.instances = max(self.instances, self.decode_bound,
                             self.prefill_bound, int(min_instances), 1)
        self.instances += max(int(extra_instances), 0)
        if max_instances > 0:
            self.instances = min(self.instances, max(int(max_instances), 1))
        self._operating_point()
        return self


@dataclasses.dataclass
class FleetReport:
    """Eq. 4 fleet-level result."""

    pools: List[PoolSizing]
    label: str = ""

    @property
    def instances(self) -> int:
        return sum(p.instances for p in self.pools)

    @property
    def gpus(self) -> int:
        return sum(p.instances * p.profile.tp for p in self.pools)

    @property
    def power_kw(self) -> float:
        return sum(p.instances * p.power_w_per_instance
                   for p in self.pools) / 1e3

    @property
    def tokens_per_s(self) -> float:
        return sum(p.tokens_per_s for p in self.pools)

    @property
    def tok_per_watt(self) -> float:
        pw = self.power_kw * 1e3
        return self.tokens_per_s / pw if pw else 0.0

    def row(self) -> dict:
        return dict(label=self.label, instances=self.instances,
                    gpus=self.gpus, kw=round(self.power_kw, 1),
                    tok_per_watt=round(self.tok_per_watt, 2))


def size_fleet(pools: List[PoolSizing], *, streamed_params: float,
               prefill_mfu: Optional[float] = None,
               label: str = "") -> FleetReport:
    for p in pools:
        p.size(streamed_params=streamed_params, prefill_mfu=prefill_mfu)
    return FleetReport(pools=[p for p in pools if p.arrival_rate > 0],
                       label=label)


@dataclasses.dataclass
class PoolOverride:
    """Per-pool sizing recalibration layered on a provisioned FleetReport.

    The SLO loop (core.slo) accumulates one of these per router role across
    rounds: `prefill_mfu` lowers the effective prefill MFU (raising the
    prefill instance bound), `hol_inflation` raises the head-of-line
    occupancy factor (raising both bounds), `min_instances` ratchets the
    pool to at least that capacity (levers take a max, they never
    compound), and `extra_instances` forces additional capacity beyond
    every bound.  `max_instances` (> 0) caps the pool from above — the
    trim phase's lever, set only from a *measured*-compliant simulation
    (DESIGN.md §5).  Applied via `apply_overrides`.
    """

    prefill_mfu: Optional[float] = None
    hol_inflation: Optional[float] = None
    min_instances: int = 0
    extra_instances: int = 0
    max_instances: int = 0


def apply_overrides(report: FleetReport,
                    overrides: Dict[str, PoolOverride], *,
                    roles: List[str],
                    streamed_params) -> FleetReport:
    """Recalibrate `report`'s pools (ascending-window order, one role name
    per pool) in place with the given per-role overrides.  In a
    model-heterogeneous fleet each pool streams its *own* model's
    parameters, so `streamed_params` may be a {role: params} dict (a bare
    float applies to every pool — the homogeneous case)."""
    pools = sorted(report.pools, key=lambda p: p.window)
    assert len(roles) == len(pools), (roles, [p.name for p in pools])
    for role, pool in zip(roles, pools):
        o = overrides.get(role)
        sp = streamed_params.get(role) \
            if isinstance(streamed_params, dict) else streamed_params
        if o is not None:
            pool.recalibrate(streamed_params=sp,
                             prefill_mfu=o.prefill_mfu,
                             hol_inflation=o.hol_inflation,
                             min_instances=o.min_instances,
                             extra_instances=o.extra_instances,
                             max_instances=o.max_instances)
    return report
