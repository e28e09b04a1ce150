"""Fleet-scale serving simulator: the measured side of the paper's claims.

The analytical layer (core.fleet / core.routing) *predicts* fleet tok/W from
closed-form sizing; everything here *measures* it by actually running the
fleet: one structure-of-arrays `BatchedPoolEngine` (serving.soa) per
provisioned pool — all `instances x n_slots` slots in one set of numpy
arrays, every instance stepped in lockstep — fed Poisson arrivals drawn
from the shared `core.workloads` traces through the same `ContextRouter`
the token-level engine uses, with chunked-prefill interleave, FleetOpt
overflow migration (preemption + re-prefill in the long pool), and
per-iteration `MeterBank` charging.  The output is measured fleet tok/s,
tok/W, TTFT/TPOT percentiles and per-pool occupancy that can be put
head-to-head against the `core.fleet` prediction — the TokenPowerBench-
style measurement cross-check of the 1/W law.  (The batched engines
replay the scalar `PoolEngine` semantics bit-for-bit.)

The pools drain in the numpy `BatchedPoolEngine` (`engine="numpy"`, the
bit-exact oracle) or in the compiled drain (`engine="graph"`,
serving.graph_engine: float64 torch steps replayed as CUDA graphs, the
twin of the reference's `engine="jax"`).  Every other engine name, "jax"
included, raises NotImplementedError rather than falling back to numpy.

Execution model (event-driven, per-instance timelines):

  * Routing is context-length-based and time-independent, so every request
    is routed up front; each instance then advances its own clock through
    its private event sequence (idle-skip to next arrival, decode
    iterations of tau(n, L), chunked prefill charges) — the batched
    engine carries the diverging clocks as a `MeterBank` row per
    instance.  Instances never need a shared clock
    — except for cross-pool request flow, which is always *forward* in the
    pool order: overflow migrations flow toward larger windows (pool i ->
    pool i+1 in the admission ladder; FleetOpt's short -> long is the K = 2
    case), the disaggregated kinds add the prefill -> decode KV-handoff
    hop within each window slice (plus decode-short -> prefill-long
    re-prefill on overflow), and the semantic kinds add the small-model ->
    large-model escalation hop for detected misroutes (serving.router).
    Every dependency forms a DAG, so pools run in
    topological order — ascending window, prefill before its paired decode
    — each pool drains, and its evicted / handed-off requests are injected
    into the destination pool's (time-sorted) queue carrying their eviction
    or handoff-completion timestamps (a handoff's `ready_time` includes the
    KV-migration delay over the interconnect, whose link + HBM energy is
    charged to the prefill engine's meter as non-output energy).  A K-pool
    request can migrate several hops (short -> mid -> long); `migrations`
    counts overflow hops, `handoffs` counts KV migrations.
  * Within a pool, requests are balanced over the N engine replicas by
    least *total assigned* predicted work (prompt + predicted output
    tokens).  All routing happens before any engine runs, so "outstanding"
    work cannot decay between assignments — cumulative assigned work is
    the correct (and intended) balancing key.

Energy accounting note: the analytical Eq. 4 number charges decode power
only; the simulator additionally meters prefill energy and idle power, so
its all-in tok/W sits *below* the analytical prediction.  The report
exposes both `tok_per_watt` (all-in) and `decode_tok_per_watt` (prefill
and idle energy backed out) — the latter is the like-for-like comparison
the integration test asserts against `core.fleet`.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.autoscale import AutoscalePolicy
from ..core.timeline import EV_ARRIVE, EV_ROUTE
from ..core.disagg import HANDOFF_J_PER_BYTE, INTERCONNECT_BPS
from ..core.fleet import FleetReport, PoolOverride
from ..core.modelspec import ModelSpec
from ..core.profiles import BaseProfile
from ..core.routing import LONG_WINDOW
from ..core.topospec import TopologySpec, plan_roles
from ..core.workloads import Workload

from .autoscale import Autoscaler, InstanceSchedule
from .engine import scaled_prefill_chunk
from .graph_engine import GraphPoolEngine, drain_engines
from .models import ModelProfileRegistry
from .request import (Request, latency_percentiles as _percentiles,
                      latency_percentiles_arrays, sample_trace)
from .router import ContextRouter, RouterPolicy
from .soa import BatchedPoolEngine


ENGINES = ("numpy", "graph")


def _check_engine(engine: str) -> None:
    """The port drains fleets in the numpy `BatchedPoolEngine` or in the
    compiled drain of ROADMAP A 2c (`GraphPoolEngine`); no other engine
    name is served, the reference's "jax" included, and none falls back
    to numpy."""
    if engine not in ENGINES:
        raise NotImplementedError(
            f"engine={engine!r}: the port drains fleets only in the engines "
            f"{ENGINES} (the compiled drain of ROADMAP A 2c is 'graph')")


def trace_requests(workload: Workload, n: int, *, seed: int = 0,
                   max_total: int = LONG_WINDOW,
                   arrival_rate: Optional[float] = None,
                   trace: Optional[List[Tuple[int, int, float]]] = None,
                   ) -> List[Request]:
    """n requests with (prompt, output) drawn from the workload trace and
    Poisson arrivals.  Prompts are zero-copy broadcast views — analytical
    engines only read the shape, so a 10k-request trace costs ~nothing.

    Pass `trace` (pre-sampled `sample_trace` triples) to materialise
    fresh Request objects over a *frozen* trace instead of re-sampling —
    the SLO loop's common-random-numbers path.  This function is the
    single source of the request-construction convention (zero-broadcast
    prompts, predicted_output = E[output] honest routing) for every
    consumer."""
    mean_out = int(round(workload.mean_output))
    if trace is None:
        trace = sample_trace(workload, n, seed=seed, max_total=max_total,
                             arrival_rate=arrival_rate)
    return [Request(
        rid=i, prompt=np.broadcast_to(np.int64(0), (p,)),
        max_new_tokens=o, arrival_time=t,
        # honest routing: the router sees prompt + E[output], never the
        # actual sampled output (core.routing.FleetOpt's assumption)
        predicted_output=mean_out)
        for i, (p, o, t) in enumerate(trace)]


def build_topology(kind: str, workload: Workload, profile: BaseProfile,
                   model: ModelSpec, *, b_short: int = 4096,
                   gamma: float = 2.0, long_window: int = LONG_WINDOW,
                   windows: Optional[Sequence[int]] = None,
                   pool_overrides: Optional[Dict[str, PoolOverride]] = None,
                   small_model: Optional[ModelSpec] = None,
                   small_profile: Optional[BaseProfile] = None,
                   misroute_rate: float = 0.0,
                   dispatch_ms: float = 0.0,
                   misroute_seed: int = 0,
                   ) -> Tuple[RouterPolicy, FleetReport, ModelProfileRegistry]:
    """(router policy, analytical sizing plan, model registry) for one §4
    topology, a K >= 3 `core.multipool` ladder (`kind="multipool"`, pass
    `windows`), or a model-heterogeneous kind — the same provisioning the
    simulator instantiates and the prediction it is measured against.
    `pool_overrides` layers per-role SLO recalibrations (core.slo) on the
    closed-form plan.

    This is a thin legacy-kind front end: the kind string compiles to a
    `core.topospec.TopologySpec` (the declarative IR every layer reads —
    DESIGN.md §12) and everything is derived from the spec.  Build the
    spec directly (`TopologySpec.from_kind` or by hand) to keep it —
    e.g. for `core.topo_search.optimize_topology`."""
    spec = TopologySpec.from_kind(
        kind, profile, model, b_short=b_short, gamma=gamma,
        long_window=long_window, windows=windows, small_model=small_model,
        small_profile=small_profile, misroute_rate=misroute_rate,
        dispatch_ms=dispatch_ms, misroute_seed=misroute_seed)
    return spec.build(workload, pool_overrides=pool_overrides)


@dataclasses.dataclass
class PoolSummary:
    """Everything the fleet roll-up, the SLO loop and the cross-pool
    replay need from one drained pool, computed in a single pass.

    This is both the "single cached summary per measurement window" that
    deduplicates the old per-field `sum(... for e in self.engines)`
    aggregation passes in `FleetSim.report` / `PoolGroup.measured_totals`,
    and the unit of **incremental re-simulation**: `core.slo`'s sizing
    loop hands a prior round's summaries back to `FleetSim.run(reuse=...)`
    for every pool whose provisioning did not change, and the pool is
    replayed from this snapshot — its outbox clones re-injected downstream
    — instead of being re-simulated."""

    role: str
    phase: str
    window: int
    instances: int
    n_slots: int
    # steady-state-windowed occupancy integral + the window span it was
    # measured over: the SLO HOL calibration derives the pool's mean
    # occupied-slot population (m_slot_seconds / measure_span) from
    # these, unrounded and with ramp-in/drain transients excluded —
    # consistent with every other windowed measurement in the loop
    m_slot_seconds: float
    measure_span: float
    stats: Dict[str, float]
    lat: Dict[str, float]            # latency_by_role percentiles
    # steady-state-windowed meter roll-ups + lifetime totals
    m_tokens: int
    m_joules: float
    m_prefill_joules: float
    m_idle_joules: float
    m_handoff_joules: float
    m_handoff_bytes: float
    m_dispatch_joules: float
    tokens: int
    joules: float
    sim_times: np.ndarray            # per-instance clock at drain
    p_idle_w: float
    # per-completed-request metric columns (vectorized SLO attribution)
    arrival: np.ndarray
    first_token: np.ndarray
    finish: np.ndarray
    n_generated: np.ndarray
    ttft_role: np.ndarray            # index into FleetSim.order
    # cross-pool flow
    n_overflowed: int
    n_escalated: int
    n_handoffs: int
    outbox: Dict[str, List[Request]]  # dest role -> request snapshots
    # autoscaled pools: per-row retire times (serving.autoscale) — the
    # fleet roll-up stops charging a row's trailing idle at its retire
    # time instead of the window end.  None = always-on (steady state).
    online_until: Optional[np.ndarray] = None


class PoolGroup:
    """One provisioned pool: a `BatchedPoolEngine` simulating all its
    instance replicas in lockstep, plus the replica load balancer.
    Requests are balanced by least *total assigned* predicted work
    (prompt + predicted output for decode pools; prompt only for
    prefill-phase pools, whose work ends at the handoff).  Every request
    is routed before any engine runs (see the execution model above), so
    there is no notion of work "draining" between assignments —
    `_pending` is deliberately a monotone cumulative-assignment counter,
    which load-balances the whole trace across replicas.  Quacks like a
    PoolEngine for the router (submit / stats)."""

    def __init__(self, role: str, engine: BatchedPoolEngine):
        self.role = role
        self.engine = engine
        self.phase = engine.phase
        self._pending = np.zeros(engine.instances, np.float64)
        self.summary: Optional[PoolSummary] = None

    @property
    def instances(self) -> int:
        return self.engine.instances

    def submit(self, req: Request) -> None:
        eng = self.engine
        if eng.online_from is not None:
            # autoscaled pool: balance only over the rows whose online
            # window covers the request's ready time (a retired or
            # not-yet-started incarnation cannot admit).  The controller
            # keeps >= 1 row always online; the fallbacks below are
            # belt-and-braces, not a load-bearing path.
            t = eng._ready(req)
            elig = (eng.online_from <= t) & (t < eng.online_until)
            if not elig.any():
                elig = eng.online_from <= t
            if not elig.any():
                elig = np.ones(eng.instances, bool)
            i = int(np.argmin(np.where(elig, self._pending, np.inf)))
        else:
            i = int(np.argmin(self._pending))
        self._pending[i] += req.prompt_len if self.phase == "prefill" \
            else req.predicted_total
        self.engine.submit(req, i)

    def queue_rids(self, instance: int) -> List[int]:
        """Request ids queued on one replica (tests/debug)."""
        return [r.rid for r in self.engine.queues[instance]]

    @property
    def completed(self) -> List[Request]:
        return [r for lst in self.engine.completed for r in lst]

    @property
    def relayed(self) -> List[Request]:
        """Requests whose prefill this (prefill-phase) pool drained."""
        return [r for lst in self.engine.relayed for r in lst]

    @property
    def streamed_params(self) -> float:
        return self.engine._streamed_params

    @property
    def prefill_chunk(self) -> Optional[int]:
        return self.engine.prefill_chunk

    @property
    def dispatch_s(self) -> float:
        return self.engine.bank.dispatch_s

    @property
    def lifetime_tokens(self) -> int:
        return int(self.engine.bank.tokens.sum())

    def latency_percentiles(self) -> Dict[str, float]:
        """TTFT/TPOT/e2e percentiles of the requests that *finished* in
        this pool (a migrated request's TTFT counts where its prefill
        finally drained).  A prefill-phase pool finishes nothing — its
        percentiles cover the requests it relayed (their TTFT is this
        pool's doing; the downstream metrics are informational)."""
        if self.summary is not None:
            return dict(self.summary.lat)
        return _percentiles(self.completed or self.relayed)

    def measured_totals(self) -> Dict[str, float]:
        if self.summary is not None:
            return dict(tokens=self.summary.m_tokens,
                        joules=self.summary.m_joules)
        b = self.engine.bank
        return dict(tokens=int(b.m_tokens.sum()),
                    joules=float(b.m_joules.sum()))

    def stats(self) -> Dict[str, float]:
        if self.summary is not None:
            return dict(self.summary.stats)
        return self._compute_stats()

    def _compute_stats(self) -> Dict[str, float]:
        eng, b = self.engine, self.engine.bank
        tok = int(b.tokens.sum())
        joules = float(b.joules.sum())
        slot_s = float(eng.slot_seconds.sum())
        avail = eng.n_slots * float(b.sim_time_s.sum())
        extra = {}
        if eng.online_from is not None:
            # autoscaled pool: mean live instance count over the
            # measurement window (the steady-state path adds no keys, so
            # committed baseline stats are byte-identical)
            span = max(b.measure_t1 - b.measure_t0, 1e-9)
            lo = np.maximum(eng.online_from, b.measure_t0)
            hi = np.minimum(eng.online_until, b.measure_t1)
            extra["avg_online_instances"] = round(
                float(np.maximum(0.0, hi - lo).sum()) / span, 2)
        return dict(role=self.role,
                    **extra,
                    phase=self.phase,
                    window=eng.window,
                    instances=eng.instances,
                    n_slots=eng.n_slots,
                    completed=sum(len(c) for c in eng.completed),
                    relayed=sum(len(c) for c in eng.relayed),
                    preempted=int(eng.preempted.sum()),
                    escalated=int(eng.n_escalated.sum()),
                    tokens=tok, joules=round(joules, 1),
                    m_tokens=int(b.m_tokens.sum()),
                    m_joules=round(float(b.m_joules.sum()), 1),
                    m_prefill_joules=round(
                        float(b.m_prefill_joules.sum()), 1),
                    tok_per_watt=round(tok / joules, 3) if joules else 0.0,
                    occupancy=round(slot_s / avail, 3) if avail else 0.0,
                    sim_time_s=round(float(b.sim_time_s.max()), 3)
                    if eng.instances else 0.0)

    def summarize(self, role_idx: Dict[str, int],
                  outbox: Dict[str, List[Request]],
                  n_overflowed: int, n_escalated: int,
                  n_handoffs: int) -> PoolSummary:
        """One-pass aggregation after the pool drains; cached so every
        later report path (stats / measured_totals / fleet roll-up /
        SLO attribution) reads the same numbers without re-summing."""
        eng, b = self.engine, self.engine.bank
        comp = self.completed
        own = role_idx[self.role]
        self.summary = PoolSummary(
            role=self.role, phase=self.phase, window=eng.window,
            instances=eng.instances, n_slots=eng.n_slots,
            m_slot_seconds=float(eng.m_slot_seconds.sum()),
            measure_span=max(b.measure_t1 - b.measure_t0, 1e-9),
            stats=self._compute_stats(),
            lat=_percentiles(comp or self.relayed),
            m_tokens=int(b.m_tokens.sum()),
            m_joules=float(b.m_joules.sum()),
            m_prefill_joules=float(b.m_prefill_joules.sum()),
            m_idle_joules=float(b.m_idle_joules.sum()),
            m_handoff_joules=float(b.m_handoff_joules.sum()),
            m_handoff_bytes=float(b.m_handoff_bytes.sum()),
            m_dispatch_joules=float(b.m_dispatch_joules.sum()),
            tokens=int(b.tokens.sum()),
            joules=float(b.joules.sum()),
            sim_times=b.sim_time_s.copy(),
            p_idle_w=eng.profile.power_model.p_idle_w,
            arrival=np.array([r.arrival_time for r in comp]),
            first_token=np.array([r.first_token_time for r in comp]),
            finish=np.array([r.finish_time for r in comp]),
            n_generated=np.array([r.n_generated for r in comp], np.int64),
            ttft_role=np.array([role_idx.get(r.prefill_role, own)
                                for r in comp], np.int64),
            n_overflowed=n_overflowed, n_escalated=n_escalated,
            n_handoffs=n_handoffs, outbox=outbox,
            online_until=None if eng.online_until is None
            else eng.online_until.copy())
        return self.summary


class FleetSim:
    """Instantiate an analytical sizing plan as a fleet of running engines.

    `registry` (serving.models) binds each role to the model its pool
    serves; passing only `model` builds a homogeneous registry, which is
    every pre-model-heterogeneity topology.  Each engine streams *its own
    pool's* model bytes, and the per-engine prefill chunk is scaled by its
    pool profile's HBM bandwidth (`scaled_prefill_chunk`) so faster
    generations spend their surplus FLOPs on prompt processing instead of
    idling at the H100-calibrated chunk rate.  `engine` picks the pools'
    drain ("numpy" or "graph", see `_check_engine`); a "graph" fleet
    drains on `device`."""

    def __init__(self, policy: RouterPolicy, plan: FleetReport, *,
                 model: Optional[ModelSpec] = None,
                 registry: Optional[ModelProfileRegistry] = None,
                 prefill_chunk: int = 512,
                 rng_seed: int = 0,
                 kv_interconnect_Bps: float = INTERCONNECT_BPS,
                 kv_handoff_j_per_byte: float = HANDOFF_J_PER_BYTE,
                 engine: str = "numpy",
                 autoscale: Optional[AutoscalePolicy] = None,
                 telemetry=None, device="cuda"):
        self.policy = policy
        self.plan = plan
        self.autoscale = autoscale
        # FleetScope: explicit kwarg wins; the class attribute is the
        # bench's opt-in hook (`fleet_sim_bench --trace` sets it once and
        # every sim the harness builds records into the shared recorder)
        self.telemetry = telemetry if telemetry is not None \
            else FleetSim.default_telemetry
        _check_engine(engine)
        if autoscale is not None and engine != "numpy":
            # the compiled drain starts every row's clock at zero, so
            # per-row online offsets would be silently dropped
            raise ValueError("autoscale requires the numpy engine")
        # `device` is where the graph engine drains ("cuda" unless the
        # caller asks for the CPU); the numpy engine has none
        engine_cls = BatchedPoolEngine if engine == "numpy" \
            else functools.partial(GraphPoolEngine, device=device)
        self.engine_kind = engine
        pools = sorted(plan.pools, key=lambda p: p.window)
        if registry is None:
            if model is None:
                raise ValueError("FleetSim needs a model or a registry")
            registry = ModelProfileRegistry.homogeneous(
                model, pools[0].profile)
        self.registry = registry
        self.model = registry.default.model
        self.kv_interconnect_Bps = kv_interconnect_Bps
        self.kv_handoff_j_per_byte = kv_handoff_j_per_byte
        spec: Optional[TopologySpec] = getattr(policy, "spec", None)
        if spec is None:
            raise ValueError(
                "FleetSim needs a spec-compiled policy: every pool's wiring"
                " (roles, eviction, overflow/escalation/handoff edges) is"
                " read from policy.spec — build the topology through"
                " core.topospec.TopologySpec (from_kind / build) or"
                " serving.fleetsim.build_topology")
        self.spec = spec
        role_names = plan_roles(plan)
        roles = list(zip(role_names, pools))
        # topological DAG order: ascending window, and within a disagg
        # slice prefill before its paired decode (the provisioning order —
        # the window sort is stable)
        self.order = role_names
        self.groups: Dict[str, PoolGroup] = {}
        surviving = set(role_names)
        spec_by_role = {sp.role: sp for sp in spec.pools}

        def _overflow_dest(role: str) -> Optional[str]:
            # follow the spec's overflow chain through pools the workload
            # dropped (a rung that routed no traffic provisions no pool):
            # its predecessor overflows straight to the next survivor
            dest = spec_by_role[role].overflow_to
            while dest is not None and dest not in surviving:
                dest = spec_by_role[dest].overflow_to
            return dest

        self._plan_by_role: Dict[str, object] = dict(roles)
        self._engine_kwargs: Dict[str, dict] = {}
        for role, p in roles:
            sp = spec_by_role[role]
            # Overflow headroom ends at the pool window: a request routed
            # here that outgrows it migrates one hop along the spec's
            # overflow edge (preemption + re-prefill in the destination
            # pool).  A pool whose edge resolves to no surviving
            # destination is terminal in practice and truncates at its
            # window, like the token-level engine.
            evict = sp.evict_on_overflow and _overflow_dest(role) is not None
            binding = registry.for_role(role)
            chunk = scaled_prefill_chunk(p.profile, prefill_chunk) \
                if prefill_chunk else prefill_chunk
            kwargs = dict(
                instances=max(p.instances, 1), window=p.window,
                profile=p.profile, name=p.name,
                prefill_chunk=chunk, phase=p.phase,
                prefill_mfu=p.prefill_engine_mfu,
                evict_on_overflow=evict, respect_arrival=True,
                streamed_params=binding.streamed_params,
                dispatch_ms=binding.dispatch_ms,
                rng_seed=rng_seed)
            # kept so the autoscaler can rebuild the pool with one row
            # per planned incarnation (serving.autoscale)
            self._engine_kwargs[role] = kwargs
            self.groups[role] = PoolGroup(role, engine_cls(**kwargs))
            if self.telemetry is not None:
                self.groups[role].engine.attach_trace(self.telemetry)
        # cross-pool edges, read straight off the spec's pools (all point
        # forward in `order` — validated at spec construction):
        #   handoff_to  — prefill role -> its slice's decode role
        #   overflow_to — evicting role -> where its evictions re-enter
        #                 (ladder specs: next surviving rung; disagg: the
        #                 next slice's *prefill* pool, where the request
        #                 re-prefills)
        #   escalate_to — semantic small-model role -> the large-model role
        #                 that re-serves detected misroutes from scratch
        self.handoff_to: Dict[str, str] = {}
        self.overflow_to: Dict[str, str] = {}
        self.escalate_to: Dict[str, str] = {}
        self._kv_bytes_per_tok: Dict[str, float] = {}
        for role, p in roles:
            sp = spec_by_role[role]
            dest = _overflow_dest(role)
            if dest is not None:
                self.overflow_to[role] = dest
            if sp.escalate_to is not None and sp.escalate_to in surviving:
                self.escalate_to[role] = sp.escalate_to
            if sp.handoff_to is not None and sp.handoff_to in surviving:
                self.handoff_to[role] = sp.handoff_to
                # per-role whole-instance KV bytes per prompt token
                self._kv_bytes_per_tok[role] = \
                    registry.for_role(role).kv_bytes_per_instance_token(
                        p.profile)
        self.router = ContextRouter(self.groups, policy)
        self.migrations = 0
        self.handoffs = 0
        self.escalations = 0
        self._window: Tuple[float, float] = (0.0, float("inf"))
        self.summaries: Dict[str, PoolSummary] = {}
        self.fresh_roles: List[str] = []
        # role -> InstanceSchedule planned by the autoscaler this run
        self.schedules: Dict[str, InstanceSchedule] = {}

    # simulated seconds served across every FleetSim.run in this process
    # (per-run horizon = the last arrival).  Instrumentation for the
    # bench's sim-seconds-per-wall-second throughput metric.
    sim_seconds_total: float = 0.0

    # process-wide FleetScope recorder picked up by sims built without an
    # explicit `telemetry=` kwarg (how the bench harness opts whole runs
    # into tracing without threading a kwarg through every call site)
    default_telemetry = None

    def run(self, requests: List[Request], *, warmup_frac: float = 0.35,
            max_iters: int = 20_000_000,
            reuse: Optional[Dict[str, PoolSummary]] = None
            ) -> Dict[str, dict]:
        """Route every request, drain the pools in topological order, and
        return `report()`.

        `reuse` maps a *prefix* of `self.order` to `PoolSummary`
        snapshots from a previous, identically-provisioned run over the
        identical trace (the SLO loop's incremental re-simulation —
        core.slo validates the prefix): those pools are replayed from
        their snapshots (summary adopted, outbox clones re-injected into
        downstream fresh pools) instead of being simulated again.
        Cross-pool flow only points forward, so a reused prefix can never
        receive requests from a fresh pool; the trailing assert enforces
        it."""
        self.begin_run(requests, warmup_frac=warmup_frac, reuse=reuse)
        for role in self.order:
            self.pre_role(role)
            self.drain_role(role, max_iters=max_iters)
        return self.finish_run()

    # --- staged drive: begin_run -> (pre_role, drain_role)* -> finish_run.
    # `run` composes these; the grid loop (`run_fleet_grid`) interleaves
    # them across many sims, stage by stage.

    def begin_run(self, requests: List[Request], *,
                  warmup_frac: float = 0.35,
                  reuse: Optional[Dict[str, PoolSummary]] = None) -> None:
        """Route the trace, set every pool's measurement window, and open
        the per-run cross-pool inbox state."""
        reqs = sorted(requests, key=lambda r: r.arrival_time)
        # steady-state measurement window: skip the fleet fill-up, stop at
        # the last arrival (the drain tail is not steady state either)
        t_last = reqs[-1].arrival_time if reqs else 0.0
        FleetSim.sim_seconds_total += t_last
        self._window = (warmup_frac * t_last, t_last)
        for grp in self.groups.values():
            grp.engine.bank.measure_t0, grp.engine.bank.measure_t1 = \
                self._window
        for r in reqs:
            self.router.route(r)
        if self.autoscale is not None:
            self._apply_autoscale()
        tr = self.telemetry
        if tr is not None:
            # emitted after routing *and* autoscale so `r.pool` reflects
            # the final replica assignment (the autoscale rebuild
            # re-submits the routed queues onto the scheduled rows)
            fleet_pid = tr.pool_id("fleet")
            for r in reqs:
                tr.event(EV_ARRIVE, r.rid, fleet_pid, -1, r.arrival_time)
                name, _, inst = (r.pool or "").partition("#")
                tr.event(EV_ROUTE, r.rid,
                         tr.pool_id(name) if name else fleet_pid,
                         int(inst) if inst else -1, r.arrival_time)
        self.summaries = {}
        self.fresh_roles = []
        # topological order: cross-pool flow (overflow migrations and KV
        # handoffs) only points forward, so draining pools in `order` sees
        # every injected request before its destination runs
        self._run_state = dict(
            reuse=reuse or {},
            role_idx={r: k for k, r in enumerate(self.order)},
            inbox={role: [] for role in self.order})

    def _apply_autoscale(self) -> None:
        """Replace each pool's peak-provisioned engine with an
        incarnation-per-row engine planned by the reactive autoscaler
        (serving.autoscale).  Runs inside `begin_run`, after primary
        routing (each pool's queues hold exactly its routed ingress —
        the controller's arrival-rate signal) and before any engine has
        stepped, so the rebuild replays the identical submissions onto
        the scheduled rows."""
        scaler = Autoscaler(self.autoscale)
        horizon = self._window[1]
        for role in self.order:
            grp = self.groups[role]
            eng = grp.engine
            routed = [r for q in eng.queues for r in q]
            times = [BatchedPoolEngine._ready(r) for r in routed]
            plan = self._plan_by_role[role]
            rate_per_inst = plan.arrival_rate / max(plan.instances, 1)
            binding = self.registry.for_role(role)
            load_s = binding.model.weight_bytes(active_only=False) \
                / self.autoscale.weight_load_Bps
            sched = scaler.plan_pool(
                times, n_peak=eng.instances,
                rate_per_instance=rate_per_inst,
                horizon_s=horizon, load_s=load_s)
            self.schedules[role] = sched
            kwargs = dict(self._engine_kwargs[role],
                          instances=sched.n_rows)
            new_eng = BatchedPoolEngine(**kwargs)
            if self.telemetry is not None:
                new_eng.attach_trace(self.telemetry)
            new_eng.bank.measure_t0, new_eng.bank.measure_t1 = self._window
            new_eng.set_online_windows(sched.online_from,
                                       sched.online_until,
                                       load_s=sched.load_s)
            new_grp = PoolGroup(role, new_eng)
            self.groups[role] = new_grp    # the router reads this dict
            for r in sorted(routed, key=BatchedPoolEngine._ready):
                new_grp.submit(r)

    def pre_role(self, role: str) -> Optional[BatchedPoolEngine]:
        """Inject the role's inbox and time-sort its queues; returns the
        engine about to drain (None when the role replays a reused
        snapshot).  Split from `drain_role` so a grid loop can collect a
        stage's prepared engines and batch their drains."""
        rs = self._run_state
        if role in rs["reuse"]:
            return None
        grp = self.groups[role]
        inbox = rs["inbox"]
        if inbox[role]:
            tr = self.telemetry
            for r in sorted(inbox[role], key=lambda r: r.ready_time):
                grp.submit(r)
                if tr is not None:
                    # re-entry hop (overflow / escalation / KV handoff):
                    # a second ROUTE at the destination replica
                    name, _, inst = r.pool.partition("#")
                    tr.event(EV_ROUTE, r.rid, tr.pool_id(name),
                             int(inst) if inst else -1, r.ready_time)
            inbox[role] = []
        grp.engine.sort_queues()    # keep queues time-sorted for the
        return grp.engine           # head-gated admission

    def drain_role(self, role: str, *,
                   max_iters: int = 20_000_000) -> None:
        """Drain one prepared pool (or adopt its reused snapshot) and
        deliver its outflow to the downstream inboxes."""
        rs = self._run_state
        reuse, inbox = rs["reuse"], rs["inbox"]
        if role in reuse:
            s = reuse[role]
            self.groups[role].summary = s
            self.summaries[role] = s
            self.migrations += s.n_overflowed
            self.escalations += s.n_escalated
            self.handoffs += s.n_handoffs
            for dest, snaps in s.outbox.items():
                if dest not in reuse:   # flow into a reused pool is
                    inbox[dest].extend(  # already inside its snapshot
                        copy.copy(r) for r in snaps)
            return
        self.fresh_roles.append(role)
        grp = self.groups[role]
        eng = grp.engine
        eng.run_until_drained(max_iters=max_iters)
        outbox: Dict[str, List[Request]] = {}
        n_over = n_esc = n_hand = 0
        for i in range(eng.instances):
            if eng.overflowed[i]:
                dest = self.overflow_to.get(role)
                assert dest is not None, \
                    "the terminal pool may not overflow-evict"
                n_over += len(eng.overflowed[i])
                inbox[dest].extend(eng.overflowed[i])
                outbox.setdefault(dest, []).extend(
                    copy.copy(r) for r in eng.overflowed[i])
                eng.overflowed[i] = []
            if eng.escalated[i]:
                dest = self.escalate_to.get(role)
                assert dest is not None, \
                    "only the semantic small pool may escalate"
                n_esc += len(eng.escalated[i])
                inbox[dest].extend(eng.escalated[i])
                outbox.setdefault(dest, []).extend(
                    copy.copy(r) for r in eng.escalated[i])
                eng.escalated[i] = []
            if eng.handoff[i]:
                dest = self.handoff_to[role]
                kappa = self._kv_bytes_per_tok[role]
                for r in eng.handoff[i]:
                    n_bytes = kappa * r.prompt_len
                    delay = n_bytes / self.kv_interconnect_Bps
                    eng.bank.charge_handoff_one(
                        i, n_bytes, start_s=r.ready_time,
                        duration_s=delay,
                        j_per_byte=self.kv_handoff_j_per_byte)
                    r.ready_time += delay
                    r.prefill_role = role
                n_hand += len(eng.handoff[i])
                inbox[dest].extend(eng.handoff[i])
                outbox.setdefault(dest, []).extend(
                    copy.copy(r) for r in eng.handoff[i])
                eng.handoff[i] = []
        self.migrations += n_over
        self.escalations += n_esc
        self.handoffs += n_hand
        self.summaries[role] = grp.summarize(rs["role_idx"], outbox,
                                             n_over, n_esc, n_hand)

    def finish_run(self) -> Dict[str, dict]:
        assert not any(self._run_state["inbox"].values()), \
            "undelivered cross-pool requests"
        # a prefill pool's latency snapshot was taken at its drain, before
        # the downstream decode pool filled in its relayed requests'
        # finish/TPOT — refresh those percentiles now that the whole
        # fleet has drained (the relayed objects are live, not clones),
        # so latency_by_role keeps reporting the informational
        # e2e/tpot keys and replayed summaries carry them too
        for role in self.fresh_roles:
            grp = self.groups[role]
            if grp.phase == "prefill" and grp.summary is not None:
                grp.summary.lat = _percentiles(grp.completed
                                               or grp.relayed)
        return self.report()

    def latency_by_role(self) -> Dict[str, Dict[str, float]]:
        """Per-pool latency percentiles (SLO-loop attribution: which rung
        of the ladder is busting the fleet TTFT)."""
        return {role: self.groups[role].latency_percentiles()
                for role in self.order}

    def report(self) -> Dict[str, dict]:
        """Fleet roll-up assembled from the cached per-pool summaries in
        one pass (no per-engine re-aggregation — the summaries were
        computed once when each pool drained)."""
        out: Dict[str, dict] = {}
        tok = joules = prefill_j = idle_j = handoff_j = handoff_b = 0.0
        dispatch_j = 0.0
        n_completed = 0
        arrival, first, finish, ngen = [], [], [], []
        for role in self.order:
            s = self.summaries[role]
            out[role] = dict(s.stats)
            n_completed += len(s.arrival)
            arrival.append(s.arrival)
            first.append(s.first_token)
            finish.append(s.finish)
            ngen.append(s.n_generated)
            tok += s.m_tokens
            joules += s.m_joules
            prefill_j += s.m_prefill_joules
            idle_j += s.m_idle_joules
            handoff_j += s.m_handoff_joules
            handoff_b += s.m_handoff_bytes
            dispatch_j += s.m_dispatch_joules
        # engines that sat idle past the window end never saw those idle
        # watts: charge the gap so the fleet denominator is wall-clock
        # honest.  An autoscaled row's gap ends at its retire time — a
        # powered-off incarnation draws nothing.
        t0, t1 = self._window
        for role in self.order:
            s = self.summaries[role]
            cap = t1 if s.online_until is None \
                else np.minimum(t1, s.online_until)
            gap = np.maximum(0.0, cap - np.maximum(s.sim_times, t0))
            extra = s.p_idle_w * float(gap.sum())
            joules += extra
            idle_j += extra
        span = max(t1 - t0, 1e-9)
        arrival = np.concatenate(arrival) if arrival else np.empty(0)
        first = np.concatenate(first) if first else np.empty(0)
        finish = np.concatenate(finish) if finish else np.empty(0)
        ngen = np.concatenate(ngen) if ngen else np.empty(0, np.int64)
        # decode-only backs out every non-output charge: prefill compute,
        # idle draw and the KV-handoff interconnect energy (core.disagg)
        decode_j = joules - prefill_j - idle_j - handoff_j
        out["fleet"] = dict(
            completed=n_completed,
            migrations=self.migrations,
            handoffs=self.handoffs,
            escalations=self.escalations,
            measure_window_s=(round(t0, 3), round(t1, 3)),
            tokens=int(tok), joules=round(joules, 1),
            tokens_per_s=round(tok / span, 1),
            tok_per_watt=round(tok / joules, 3) if joules else 0.0,
            decode_tok_per_watt=round(tok / decode_j, 3) if decode_j else 0.0,
            prefill_energy_frac=round(prefill_j / joules, 3) if joules
            else 0.0,
            idle_energy_frac=round(idle_j / joules, 3) if joules else 0.0,
            kv_handoff_joules=round(handoff_j, 3),
            kv_handoff_gb=round(handoff_b / 1e9, 3),
            kv_handoff_energy_frac=round(handoff_j / joules, 6) if joules
            else 0.0,
            # MoE all-to-all attribution: the dispatch share is *inside*
            # the decode charges (the roofline floor), so it is reported
            # as a fraction of fleet energy, never backed out
            moe_dispatch_joules=round(dispatch_j, 1),
            moe_dispatch_energy_frac=round(dispatch_j / joules, 4)
            if joules else 0.0,
            **latency_percentiles_arrays(arrival, first, finish, ngen))
        return out


def analytical_decode_tok_per_watt(plan: FleetReport) -> float:
    """Eq. 4 over the decode pools only — the closed-form twin of the
    simulator's `decode_tok_per_watt`.  Identical to `plan.tok_per_watt`
    for plans without prefill-phase pools."""
    dec = [p for p in plan.pools if p.phase != "prefill"]
    pw = sum(p.instances * p.power_w_per_instance for p in dec)
    return sum(p.tokens_per_s for p in dec) / pw if pw else 0.0


@dataclasses.dataclass
class SimVsAnalytical:
    """One head-to-head cell: measured fleet vs closed-form sizing.

    `analytical_tok_per_watt` is the like-for-like twin of
    `sim_decode_tok_per_watt`: for the disagg kinds that is the *decode
    fleet only* (the analytical whole-fleet number, which also pays the
    dedicated prefill pools, is kept in `analytical_fleet_tok_per_watt`);
    for every other kind the two analytical numbers coincide."""

    workload: str
    topology: str
    analytical_tok_per_watt: float
    sim_tok_per_watt: float          # all-in (prefill + idle metered)
    sim_decode_tok_per_watt: float   # like-for-like with Eq. 4
    report: Dict[str, dict]
    analytical_fleet_tok_per_watt: float = 0.0

    @property
    def delta_pct(self) -> float:
        """Decode-only simulated vs analytical, in percent."""
        return 100.0 * (self.sim_decode_tok_per_watt
                        / self.analytical_tok_per_watt - 1.0)

    def row(self) -> dict:
        f = self.report["fleet"]
        return dict(workload=self.workload, topology=self.topology,
                    analytical=round(self.analytical_tok_per_watt, 2),
                    simulated=round(self.sim_decode_tok_per_watt, 2),
                    delta_pct=round(self.delta_pct, 1),
                    all_in=round(self.sim_tok_per_watt, 2),
                    ttft_p99_s=f.get("ttft_p99_s", 0.0),
                    migrations=f["migrations"])


def prepare_spec(spec: TopologySpec, workload: Workload, *,
                 n_requests: int = 4000, seed: int = 0,
                 arrival_rate: Optional[float] = None,
                 prefill_chunk: int = 512,
                 pool_overrides: Optional[Dict[str, PoolOverride]] = None,
                 engine: str = "numpy",
                 trace: Optional[List[Tuple[int, int, float]]] = None,
                 autoscale: bool = False,
                 telemetry=None, device="cuda"):
    """Provision a `TopologySpec` analytically and synthesise its trace;
    returns `(sim, reqs, plan)` ready for `sim.run(reqs)` — the common
    front half of `simulate_spec`, split out so the grid loop (and the
    SLO / topology-search loops) can prepare many scenarios before
    batch-draining them.  The trace's clipping bound is the spec's largest
    serve window (`spec.max_window`) — no per-kind special cases.

    `trace` supplies pre-sampled (prompt, output, arrival) triples — the
    diurnal bench's non-stationary arrivals (`sample_diurnal_trace`) —
    instead of the steady Poisson default.  `autoscale=True` opts the
    sim into the spec's `autoscale` policy (or the default
    `AutoscalePolicy` if the spec carries none); the sizing plan itself
    is *always* peak-provisioned — the SLO loop sizes at
    `workload.arrival_rate` and never autoscales, per the spec contract.
    """
    if arrival_rate is not None and arrival_rate != workload.arrival_rate:
        workload = dataclasses.replace(workload, arrival_rate=arrival_rate)
    policy, plan, registry = spec.build(workload,
                                        pool_overrides=pool_overrides)
    as_policy = None
    if autoscale:
        as_policy = spec.autoscale if spec.autoscale is not None \
            else AutoscalePolicy()
    sim = FleetSim(policy, plan, registry=registry,
                   prefill_chunk=prefill_chunk, rng_seed=seed,
                   engine=engine, autoscale=as_policy,
                   telemetry=telemetry, device=device)
    sim.workload_name = workload.name     # grid-loop report labels
    sim.topology_kind = spec.kind
    reqs = trace_requests(workload, n_requests, seed=seed,
                          max_total=spec.max_window, trace=trace)
    return sim, reqs, plan


def prepare_topology(kind: str, workload: Workload, profile: BaseProfile,
                     model: ModelSpec, *, b_short: int = 4096,
                     gamma: float = 2.0,
                     n_requests: int = 4000, seed: int = 0,
                     arrival_rate: Optional[float] = None,
                     prefill_chunk: int = 512,
                     windows: Optional[Sequence[int]] = None,
                     pool_overrides: Optional[Dict[str, PoolOverride]] = None,
                     small_model: Optional[ModelSpec] = None,
                     small_profile: Optional[BaseProfile] = None,
                     misroute_rate: float = 0.0,
                     dispatch_ms: float = 0.0,
                     long_window: int = LONG_WINDOW,
                     engine: str = "numpy", device="cuda"):
    """Legacy-kind front end of `prepare_spec`: compile the kind string to
    a `TopologySpec` and prepare it."""
    spec = TopologySpec.from_kind(
        kind, profile, model, b_short=b_short, gamma=gamma,
        long_window=long_window, windows=windows, small_model=small_model,
        small_profile=small_profile, misroute_rate=misroute_rate,
        dispatch_ms=dispatch_ms, misroute_seed=seed)
    return prepare_spec(spec, workload, n_requests=n_requests, seed=seed,
                        arrival_rate=arrival_rate,
                        prefill_chunk=prefill_chunk,
                        pool_overrides=pool_overrides, engine=engine,
                        device=device)


def _sim_vs_analytical(sim: FleetSim, plan, kind: str,
                       workload_name: str,
                       report: Dict[str, dict]) -> SimVsAnalytical:
    return SimVsAnalytical(
        workload=workload_name, topology=kind,
        analytical_tok_per_watt=analytical_decode_tok_per_watt(plan),
        analytical_fleet_tok_per_watt=plan.tok_per_watt,
        sim_tok_per_watt=report["fleet"]["tok_per_watt"],
        sim_decode_tok_per_watt=report["fleet"]["decode_tok_per_watt"],
        report=report)


def simulate_topology(kind: str, workload: Workload, profile: BaseProfile,
                      model: ModelSpec, *, b_short: int = 4096,
                      gamma: float = 2.0,
                      n_requests: int = 4000, seed: int = 0,
                      arrival_rate: Optional[float] = None,
                      prefill_chunk: int = 512,
                      windows: Optional[Sequence[int]] = None,
                      pool_overrides: Optional[Dict[str, PoolOverride]] = None,
                      small_model: Optional[ModelSpec] = None,
                      small_profile: Optional[BaseProfile] = None,
                      misroute_rate: float = 0.0,
                      dispatch_ms: float = 0.0,
                      long_window: int = LONG_WINDOW,
                      engine: str = "numpy",
                      device="cuda") -> SimVsAnalytical:
    """Provision a topology analytically, then measure it end-to-end.
    `engine="graph"` drains the pools in the compiled drain on `device`
    (serving.graph_engine); the default numpy engine is the bit-exact
    oracle."""
    sim, reqs, plan = prepare_topology(
        kind, workload, profile, model, b_short=b_short, gamma=gamma,
        n_requests=n_requests, seed=seed, arrival_rate=arrival_rate,
        prefill_chunk=prefill_chunk, windows=windows,
        pool_overrides=pool_overrides, small_model=small_model,
        small_profile=small_profile, misroute_rate=misroute_rate,
        dispatch_ms=dispatch_ms, long_window=long_window, engine=engine,
        device=device)
    report = sim.run(reqs)
    return _sim_vs_analytical(sim, plan, kind, workload.name, report)


def simulate_spec(spec: TopologySpec, workload: Workload, *,
                  n_requests: int = 4000, seed: int = 0,
                  arrival_rate: Optional[float] = None,
                  prefill_chunk: int = 512,
                  pool_overrides: Optional[Dict[str, PoolOverride]] = None,
                  engine: str = "numpy",
                  device="cuda") -> SimVsAnalytical:
    """Measure an arbitrary `TopologySpec` end-to-end — `simulate_topology`
    for specs that never had a kind string (hand-built or searched)."""
    sim, reqs, plan = prepare_spec(
        spec, workload, n_requests=n_requests, seed=seed,
        arrival_rate=arrival_rate, prefill_chunk=prefill_chunk,
        pool_overrides=pool_overrides, engine=engine, device=device)
    report = sim.run(reqs)
    return _sim_vs_analytical(sim, plan, spec.kind, workload.name, report)


def run_fleet_grid(scenarios: List[Tuple[FleetSim, List[Request], object]],
                   *, max_iters: int = 20_000_000,
                   warmup_frac: float = 0.35,
                   pad_floors: Optional[Sequence[tuple]] = None,
                   engine: Optional[str] = None) -> List[SimVsAnalytical]:
    """Drain many prepared scenarios stage by stage so each topological
    stage's graph-engine pools drain as **one** batched call.

    `scenarios` is a list of `prepare_topology(...)` triples (sims built
    with `engine="graph"`; numpy sims also work — they just drain
    serially inside the stage loop).  Stage k collects the k-th pool of
    every scenario, batch-drains the graph ones via
    `graph_engine.drain_engines`, then lets each sim finish its per-stage
    bookkeeping (outbox routing, KV-handoff charging, summaries) on the
    host exactly as `FleetSim.run` would.  `pad_floors` forwards shape
    classes to `drain_engines` so sweeps spanning many pool geometries
    share a handful of captured graphs.  `engine`, when given, must be a
    served engine name (`_check_engine`) and the one every scenario's sim
    was built with."""
    if engine is not None:
        _check_engine(engine)
        kinds = {sim.engine_kind for sim, _, _ in scenarios}
        if kinds != {engine}:
            raise ValueError(f"engine={engine!r}, but the scenarios were "
                             f"built with {sorted(kinds)}")
    for sim, reqs, _ in scenarios:
        sim.begin_run(reqs, warmup_frac=warmup_frac)
    n_stages = max(len(sim.order) for sim, _, _ in scenarios)
    for k in range(n_stages):
        staged = []
        for sim, _, _ in scenarios:
            if k >= len(sim.order):
                continue
            eng = sim.pre_role(sim.order[k])
            if isinstance(eng, GraphPoolEngine):
                staged.append(eng)
        if staged:
            drain_engines(staged, max_iters=max_iters,
                          pad_floors=pad_floors)
        for sim, _, _ in scenarios:
            if k < len(sim.order):
                sim.drain_role(sim.order[k], max_iters=max_iters)
    out = []
    for sim, _, plan in scenarios:
        report = sim.finish_run()
        out.append(_sim_vs_analytical(
            sim, plan, sim.topology_kind, sim.workload_name, report))
    return out
