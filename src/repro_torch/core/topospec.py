"""Declarative topology IR: `TopologySpec` — the single source of truth.

Until this module, the repo's topologies were *string kinds* (``homo`` /
``fleetopt`` / ``multipool`` / ``disagg*`` / ``semantic*`` / ``moe*``)
threaded through parallel ``if kind == ...`` ladders in
`serving.fleetsim` (pool wiring, eviction policy, role lists),
`serving.router` (admission ladders, the semantic flip), `core.slo`
(violator attribution) and the benches — so the topology itself could
not be an optimization variable: there was nothing to search over.

`TopologySpec` replaces every one of those dispatch sites with data: an
ordered list of `PoolSpec` (role, window, profile, model, phase,
admission boundary, overflow / escalation / KV-handoff edges) plus
routing metadata.  Every layer derives what it needs from the spec:

  provision()   — the analytical `core.fleet` sizing (FleetReport whose
                  pools carry their router role), replacing the
                  per-kind Homogeneous / TwoPool / FleetOpt / MultiPool /
                  Semantic / Disaggregated provisioners bit-for-bit;
  policy()      — the `serving.router.RouterPolicy` with an *explicit*
                  admission ladder, metric kind and misroute flip pair;
  registry()    — the `serving.models.ModelProfileRegistry` binding each
                  role to the model/profile its pool serves;
  build()       — (policy, plan, registry), the `build_topology` tuple;
  roles / max_window / spec_hash — the derived facts the SLO loop, the
                  trace synthesiser and the perf baseline key off.

All legacy kind strings compile through `TopologySpec.from_kind(...)` —
the ONLY place kind-string dispatch is allowed to exist — and are pinned
bit-exact against the committed quick-bench baseline
(tests/core/test_topospec.py, tests/serving/test_spec_parity.py).

Provision accounting modes (`accounting=`): the four closed-form traffic
models the legacy provisioners implemented.  ``subset`` partitions the
trace greedily over the admission ladder (Homo / TwoPool / MultiPool /
MoE-pool); ``fleetopt`` prices output-length mispredictions as migrated
load (wasted short-pool decode backed out of tokens/s); ``semantic``
adds the misroute + escalation channels of §5.1; ``disagg`` provisions a
(prefill, decode) pool pair per window slice.  The math is a verbatim
transcription of the legacy provisioners — float op-order preserved, so
`math.ceil` instance counts can never flip (DESIGN.md §12).

On top of the IR, `core.topo_search.optimize_topology` searches the spec
space (window ladder depth K, per-pool chip and model, overflow headroom
gamma, disagg on/off) for the max measured-SLO-compliant tok/W fleet.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .autoscale import AutoscalePolicy
from .fleet import PREFILL_MFU, FleetReport, PoolSizing
from .modelspec import LLAMA31_8B, ModelSpec
from .moe import with_dispatch_floor
from .profiles import BaseProfile, computed_profile
from .routing import (ESCALATION_DETECT_TOKENS, HOL_INFLATION, LONG_WINDOW,
                      _subset_stats)
from .workloads import Workload

# kinds whose [small, large] rungs serve different models and whose
# classifier can misroute (the SemanticRouter layer).  Lives here — the
# IR owns the kind vocabulary — and is re-exported by serving.router for
# backward compatibility.
SEMANTIC_KINDS = ("semantic", "semantic_fleetopt", "moe_semantic")

# every legacy kind `from_kind` compiles (DESIGN.md §12 table)
KINDS = ("homo", "two_pool", "fleetopt", "multipool", "moe_pool",
         "semantic", "semantic_fleetopt", "moe_semantic",
         "disagg", "disagg_fleetopt")

_METRICS = ("predicted_total", "prompt_plus_p99")
_ACCOUNTINGS = ("subset", "fleetopt", "semantic", "disagg")
_PHASES = ("decode", "prefill")


@dataclasses.dataclass(frozen=True)
class PoolSpec:
    """One pool of the topology: identity, geometry, and outbound edges.

    `admit` is the pool's rung on the admission ladder (requests whose
    routing metric is <= admit and exceeds every earlier rung land
    here); None means the pool is not admission-reachable and must be
    fed by an inbound edge (a disagg decode pool, fed by its prefill
    partner's `handoff_to`).  `window` is the *serve* window — admit <
    window is FleetOpt-style overflow headroom.  Edges name other pools'
    roles and always point forward in the spec order (the topological
    drain order of serving.fleetsim)."""

    role: str
    window: int
    profile: BaseProfile
    model_key: str = "default"
    phase: str = "decode"
    admit: Optional[float] = None
    hol_inflation: float = 1.0
    evict_on_overflow: bool = False
    overflow_to: Optional[str] = None
    escalate_to: Optional[str] = None
    handoff_to: Optional[str] = None
    # FleetReport pool name; defaults to the role
    name: Optional[str] = None
    # MoE expert-dispatch floor attribution (serving.models.ModelBinding)
    dispatch_ms: float = 0.0
    # physical MFU a prefill-phase pool's engines run at
    prefill_engine_mfu: Optional[float] = None

    @property
    def pool_name(self) -> str:
        return self.name if self.name is not None else self.role


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """Ordered pools + routing metadata; validated at construction."""

    kind: str
    pools: Tuple[PoolSpec, ...]
    models: Dict[str, ModelSpec]
    metric: str = "predicted_total"
    accounting: str = "subset"
    # semantic misroute channel: classifier error rate, the deterministic
    # per-rid draw seed, detection latency, and the (small, large) role
    # pair whose decisions flip
    misroute_rate: float = 0.0
    detect_tokens: int = ESCALATION_DETECT_TOKENS
    misroute_seed: int = 0
    flip: Optional[Tuple[str, str]] = None
    # routing metadata carried onto the RouterPolicy (labels / sweeps)
    b_short: int = 4096
    gamma: float = 2.0
    label: str = ""
    # opt-in autoscaling policy (core.autoscale) for non-stationary
    # traffic runs.  `provision()` / the SLO loop ALWAYS size for peak
    # regardless — the knob only parameterises a FleetSim that was
    # explicitly asked to autoscale (prepare_spec(..., autoscale=True)),
    # so steady-state provisioning, sizing and committed baselines are
    # untouched by its presence.
    autoscale: Optional["AutoscalePolicy"] = None

    # --- construction-time validation -----------------------------------
    def __post_init__(self):
        if isinstance(self.pools, list):
            object.__setattr__(self, "pools", tuple(self.pools))
        if not self.pools:
            raise ValueError("TopologySpec needs at least one PoolSpec")
        roles = [sp.role for sp in self.pools]
        if len(set(roles)) != len(roles):
            dupes = sorted({r for r in roles if roles.count(r) > 1})
            raise ValueError(f"duplicate pool roles {dupes}: every"
                             f" PoolSpec.role must be unique")
        names = [sp.pool_name for sp in self.pools]
        if len(set(names)) != len(names):
            dupes = sorted({n for n in names if names.count(n) > 1})
            raise ValueError(f"duplicate pool names {dupes}: every pool"
                             f" needs a distinct FleetReport name")
        if self.metric not in _METRICS:
            raise ValueError(f"unknown routing metric {self.metric!r}"
                             f" (expected one of {_METRICS})")
        if self.accounting not in _ACCOUNTINGS:
            raise ValueError(f"unknown accounting mode {self.accounting!r}"
                             f" (expected one of {_ACCOUNTINGS})")
        idx = {sp.role: i for i, sp in enumerate(self.pools)}
        for sp in self.pools:
            if sp.phase not in _PHASES:
                raise ValueError(f"pool {sp.role!r}: unknown phase"
                                 f" {sp.phase!r} (expected one of {_PHASES})")
            if sp.window <= 0:
                raise ValueError(f"pool {sp.role!r}: window must be a"
                                 f" positive token count, got {sp.window}")
            if sp.hol_inflation < 1.0:
                raise ValueError(f"pool {sp.role!r}: hol_inflation must be"
                                 f" >= 1, got {sp.hol_inflation}")
            if sp.dispatch_ms < 0.0:
                raise ValueError(f"pool {sp.role!r}: dispatch_ms must be"
                                 f" >= 0, got {sp.dispatch_ms}")
            if sp.model_key not in self.models:
                raise ValueError(
                    f"pool {sp.role!r}: model_key {sp.model_key!r} is not in"
                    f" spec.models (have {sorted(self.models)})")
            for edge in ("overflow_to", "escalate_to", "handoff_to"):
                dest = getattr(sp, edge)
                if dest is None:
                    continue
                if dest not in idx:
                    raise ValueError(
                        f"pool {sp.role!r}: {edge} target {dest!r} is not a"
                        f" pool of this spec (roles: {sorted(idx)}) —"
                        f" dangling edge")
                if idx[dest] <= idx[sp.role]:
                    raise ValueError(
                        f"pool {sp.role!r}: {edge} -> {dest!r} points"
                        f" backward; cross-pool edges must point forward in"
                        f" the pool order (the topological drain order)")
            if sp.evict_on_overflow and sp.overflow_to is None:
                raise ValueError(
                    f"pool {sp.role!r} evicts on overflow but has no"
                    f" overflow_to destination for its evictions")
            if sp.phase == "prefill" and sp.handoff_to is None:
                raise ValueError(
                    f"prefill-phase pool {sp.role!r} needs a handoff_to"
                    f" decode partner — its drained prefills have nowhere"
                    f" to go")
            if sp.handoff_to is not None:
                dest = self.pools[idx[sp.handoff_to]]
                if sp.phase != "prefill" or dest.phase == "prefill":
                    raise ValueError(
                        f"handoff {sp.role!r} (phase={sp.phase!r}) ->"
                        f" {dest.role!r} (phase={dest.phase!r}) is not"
                        f" phase-consistent: a KV handoff flows a prefill"
                        f" pool into a decode pool")
                if dest.window != sp.window:
                    raise ValueError(
                        f"handoff {sp.role!r} -> {dest.role!r} crosses"
                        f" window slices ({sp.window} != {dest.window}):"
                        f" a prefill pool hands off to the decode pool of"
                        f" its own slice")
        admitting = self.admitting
        if not admitting:
            raise ValueError("no pool carries an admission boundary"
                             " (admit=...): requests cannot enter the fleet")
        admits = [sp.admit for sp in admitting]
        if any(a is not None and not math.isinf(a) and a <= 0
               for a in admits):
            raise ValueError(f"admission boundaries must be positive,"
                             f" got {admits}")
        if any(a >= b for a, b in zip(admits, admits[1:])):
            raise ValueError(
                f"admission boundaries must be strictly ascending in pool"
                f" order, got {[(sp.role, sp.admit) for sp in admitting]}")
        if not math.isinf(admits[-1]):
            raise ValueError(
                f"the last admitting pool ({admitting[-1].role!r}) must"
                f" admit everything (admit=math.inf), got {admits[-1]}")
        aws = [sp.window for sp in admitting]
        if any(a >= b for a, b in zip(aws, aws[1:])):
            raise ValueError(
                f"admitting pool windows must be strictly ascending"
                f" (generalized multipool ladder), got"
                f" {[(sp.role, sp.window) for sp in admitting]}")
        for sp in admitting:
            if not math.isinf(sp.admit) and sp.admit > sp.window:
                raise ValueError(
                    f"pool {sp.role!r}: admission boundary {sp.admit} exceeds"
                    f" its serve window {sp.window} — admitted requests"
                    f" could never fit")
        for sp in self.pools:
            if sp.admit is None and not any(
                    dest == sp.role for other in self.pools
                    for dest in (other.overflow_to, other.escalate_to,
                                 other.handoff_to)):
                raise ValueError(
                    f"pool {sp.role!r} has no admission boundary and no"
                    f" inbound edge — it can never receive traffic")
        if not 0.0 <= self.misroute_rate < 1.0:
            raise ValueError(f"misroute_rate must be in [0, 1), got"
                             f" {self.misroute_rate}")
        if self.misroute_rate and self.flip is None:
            raise ValueError("misroute_rate > 0 needs a flip=(small_role,"
                             " large_role) pair to flip between")
        if self.flip is not None:
            small, large = self.flip
            for r in (small, large):
                if r not in idx:
                    raise ValueError(f"flip role {r!r} is not a pool of"
                                     f" this spec (roles: {sorted(idx)})")
            if self.pools[idx[small]].escalate_to != large:
                raise ValueError(
                    f"flip small role {small!r} must escalate_to the large"
                    f" role {large!r} (misrouted true-large requests are"
                    f" detected and re-served there)")

    # --- derived facts ---------------------------------------------------
    @property
    def roles(self) -> List[str]:
        return [sp.role for sp in self.pools]

    @property
    def admitting(self) -> List[PoolSpec]:
        """Pools on the admission ladder, in rung order."""
        return [sp for sp in self.pools if sp.admit is not None]

    @property
    def max_window(self) -> int:
        """Trace clipping bound: the largest serve window in the fleet
        (subsumes the legacy `long_window` / max(multipool windows)
        special-casing)."""
        return max(sp.window for sp in self.pools)

    def pool(self, role: str) -> PoolSpec:
        for sp in self.pools:
            if sp.role == role:
                return sp
        raise KeyError(role)

    @property
    def spec_hash(self) -> str:
        """Stable short hash of everything that determines provisioning
        and serving behaviour — the perf-baseline key for searched fleets
        (benchmarks/perf_diff.py), and the search memo key."""
        def _prof(pr: BaseProfile) -> tuple:
            return (pr.name, pr.chip.name, pr.tp,
                    round(pr.kv_token_capacity, 3),
                    round(pr.roofline.w_ms, 6))
        canon = (
            self.kind, self.metric, self.accounting,
            round(self.misroute_rate, 9), self.detect_tokens,
            self.misroute_seed, self.flip,
            tuple(sorted((k, m.name) for k, m in self.models.items())),
            tuple((sp.role, sp.pool_name, sp.window, sp.phase,
                   None if sp.admit is None else round(float(sp.admit), 6),
                   sp.model_key, _prof(sp.profile),
                   round(sp.hol_inflation, 6), sp.evict_on_overflow,
                   sp.overflow_to, sp.escalate_to, sp.handoff_to,
                   round(sp.dispatch_ms, 6), sp.prefill_engine_mfu)
                  for sp in self.pools),
        )
        # appended ONLY when set: every pre-existing spec's hash — and
        # with it every committed topology_search.json cell key — is
        # unchanged by the autoscale knob's existence
        if self.autoscale is not None:
            canon = canon + (self.autoscale.canon(),)
        return hashlib.sha1(repr(canon).encode()).hexdigest()[:12]

    # --- provisioning ----------------------------------------------------
    def provision(self, workload: Workload) -> FleetReport:
        """Closed-form `core.fleet` sizing of this spec — the analytical
        twin of the fleet `serving.fleetsim` instantiates.  Every pool of
        the returned report carries its router role (`PoolSizing.role`),
        the single place roles enter the system."""
        fn = {"subset": self._provision_subset,
              "fleetopt": self._provision_fleetopt,
              "semantic": self._provision_semantic,
              "disagg": self._provision_disagg}[self.accounting]
        return fn(workload)

    def _streamed(self, sp: PoolSpec) -> float:
        return self.models[sp.model_key].streamed_params

    def _metric_values(self, workload: Workload) -> np.ndarray:
        p, o = workload.prompts, workload.outputs
        if self.metric == "prompt_plus_p99":
            # conservative two_pool admission: no overflow handling, so a
            # request may only go short if prompt + p99(output) fits
            return p + float(np.quantile(o, 0.99))
        return p + workload.mean_output

    def _provision_subset(self, workload: Workload) -> FleetReport:
        """Greedy ladder partition (Homo / TwoPool / MultiPool / MoE)."""
        p, o = workload.prompts, workload.outputs
        lam = workload.arrival_rate
        vals = self._metric_values(workload)
        admitting = self.admitting
        pools: List[PoolSizing] = []
        assigned = np.zeros(p.shape, bool)
        for i, sp in enumerate(admitting):
            if i == len(admitting) - 1:     # largest pool takes the rest
                mask = ~assigned
            else:
                mask = ~assigned & (vals <= sp.admit)
            assigned |= mask
            s = _subset_stats(p, o, mask)
            ps = PoolSizing(
                name=sp.pool_name, window=sp.window, profile=sp.profile,
                arrival_rate=lam * s["frac"],
                mean_output=s["mean_output"],
                mean_context=s["mean_context"],
                mean_prompt=s["mean_prompt"],
                hol_inflation=sp.hol_inflation, role=sp.role)
            ps.size(streamed_params=self._streamed(sp))
            pools.append(ps)
        return FleetReport(pools=[q for q in pools if q.arrival_rate > 0],
                           label=self.label)

    def _provision_fleetopt(self, workload: Workload) -> FleetReport:
        """FleetOpt overflow accounting: requests routed short by
        predicted total whose *actual* total outgrows the short serve
        window burn their short-pool decode (backed out of tokens/s) and
        migrate — re-prefilled and fully served in the long pool."""
        short_sp, long_sp = self.admitting
        p, o = workload.prompts, workload.outputs
        lam = workload.arrival_rate
        routed_short = (p + workload.mean_output) <= short_sp.admit
        mispredict = routed_short & ((p + o) > short_sp.window)
        legit = routed_short & ~mispredict
        lam_mis = lam * float(mispredict.mean())
        s = _subset_stats(p, o, legit)
        l = _subset_stats(p, o, ~routed_short)
        long_lam = lam * l["frac"] + lam_mis
        m = _subset_stats(p, o, mispredict)
        if long_lam > 0:
            wl_frac = lam * l["frac"] / long_lam
            l_mean_out = wl_frac * l["mean_output"] \
                + (1 - wl_frac) * m["mean_output"]
            l_mean_ctx = wl_frac * l["mean_context"] \
                + (1 - wl_frac) * m["mean_context"]
            l_mean_prompt = wl_frac * l["mean_prompt"] \
                + (1 - wl_frac) * m["mean_prompt"]
        else:
            l_mean_out = l_mean_ctx = l_mean_prompt = 0.0
        pools = [
            PoolSizing(name=short_sp.pool_name, window=short_sp.window,
                       profile=short_sp.profile,
                       arrival_rate=lam * s["frac"] + lam_mis,
                       mean_output=s["mean_output"],
                       mean_context=s["mean_context"],
                       mean_prompt=s["mean_prompt"],
                       hol_inflation=short_sp.hol_inflation,
                       role=short_sp.role),
            PoolSizing(name=long_sp.pool_name, window=long_sp.window,
                       profile=long_sp.profile, arrival_rate=long_lam,
                       mean_output=l_mean_out, mean_context=l_mean_ctx,
                       mean_prompt=l_mean_prompt,
                       hol_inflation=long_sp.hol_inflation,
                       role=long_sp.role),
        ]
        pools[0].size(streamed_params=self._streamed(short_sp))
        pools[1].size(streamed_params=self._streamed(long_sp))
        rep = FleetReport(pools=[q for q in pools if q.arrival_rate > 0],
                          label=self.label)
        # wasted short-pool decode work of migrated requests is real load
        # but produces no counted output tokens:
        if lam_mis > 0 and rep.pools:
            rep.pools[0].tokens_per_s -= lam_mis * s["mean_output"]
        return rep

    def _provision_semantic(self, workload: Workload) -> FleetReport:
        """§5.1 semantic accounting: FleetOpt-style length overflows plus
        the classifier misroute + escalation channels (core.routing
        .Semantic, transcribed)."""
        small_sp, large_sp = self.admitting
        p, o = workload.prompts, workload.outputs
        lam = workload.arrival_rate
        r = self.misroute_rate
        short_window = small_sp.window
        routed_small = (p + workload.mean_output) <= small_sp.admit
        overflow = routed_small & ((p + o) > short_window)
        legit = routed_small & ~overflow
        s = _subset_stats(p, o, legit)
        v = _subset_stats(p, o, overflow)
        l = _subset_stats(p, o, ~routed_small)
        # an overflower decodes only until its KV hits the serve window
        ovf_waste = float(np.maximum(
            short_window - p[overflow], 0.0).mean()) \
            if overflow.any() else 0.0
        lam_legit = lam * (1.0 - r) * s["frac"]
        lam_ovf = lam * (1.0 - r) * v["frac"]
        lam_esc = lam * r * l["frac"]
        lam_small = lam_legit + lam_ovf + lam_esc
        if lam_small > 0:
            w_legit, w_ovf, w_esc = (lam_legit / lam_small,
                                     lam_ovf / lam_small,
                                     lam_esc / lam_small)
            s_out = (w_legit * s["mean_output"] + w_ovf * ovf_waste
                     + w_esc * self.detect_tokens)
            s_prompt = (w_legit * s["mean_prompt"] + w_ovf * v["mean_prompt"]
                        + w_esc * l["mean_prompt"])
            s_ctx = (w_legit * s["mean_context"]
                     + w_ovf * (v["mean_prompt"] + ovf_waste / 2.0)
                     + w_esc * (l["mean_prompt"] + self.detect_tokens / 2.0))
        else:
            s_out = s_prompt = s_ctx = 0.0
        lam_mis_s = lam * r * s["frac"] + lam * r * v["frac"]
        lam_large = lam * (1.0 - r) * l["frac"] + lam_mis_s \
            + lam_ovf + lam_esc
        if lam_large > 0:
            comps = (  # (rate, output, context, prompt)
                (lam * (1.0 - r) * l["frac"] + lam_esc,
                 l["mean_output"], l["mean_context"], l["mean_prompt"]),
                (lam * r * s["frac"],
                 s["mean_output"], s["mean_context"], s["mean_prompt"]),
                (lam * r * v["frac"] + lam_ovf,
                 v["mean_output"], v["mean_context"], v["mean_prompt"]),
            )
            l_out = sum(c[0] * c[1] for c in comps) / lam_large
            l_ctx = sum(c[0] * c[2] for c in comps) / lam_large
            l_prompt = sum(c[0] * c[3] for c in comps) / lam_large
        else:
            l_out = l_ctx = l_prompt = 0.0
        pools = [
            PoolSizing(name=small_sp.pool_name, window=short_window,
                       profile=small_sp.profile, arrival_rate=lam_small,
                       mean_output=s_out, mean_context=s_ctx,
                       mean_prompt=s_prompt, role=small_sp.role),
            PoolSizing(name=large_sp.pool_name, window=large_sp.window,
                       profile=large_sp.profile, arrival_rate=lam_large,
                       mean_output=l_out, mean_context=l_ctx,
                       mean_prompt=l_prompt, role=large_sp.role),
        ]
        # sizing uses each pool's own streamed params — the point of the
        # topology (DESIGN.md §9)
        pools[0].size(streamed_params=self._streamed(small_sp))
        pools[1].size(streamed_params=self._streamed(large_sp))
        # wasted small-pool decode (overflow migrations + escalated
        # misroutes) is provisioned load that produces no counted output
        if pools[0].instances and (lam_ovf > 0 or lam_esc > 0):
            pools[0].tokens_per_s -= (lam_ovf * ovf_waste
                                      + lam_esc * self.detect_tokens)
        return FleetReport(pools=[q for q in pools if q.arrival_rate > 0],
                           label=self.label)

    def _provision_disagg(self, workload: Workload) -> FleetReport:
        """Prefill/decode disaggregation: one (compute-bound prefill,
        interference-free decode) pool pair per admitting window slice;
        slices that route no traffic provision no pools."""
        p, o = workload.prompts, workload.outputs
        lam = workload.arrival_rate
        predicted = p + workload.mean_output
        admitting = self.admitting
        pools: List[PoolSizing] = []
        assigned = np.zeros(p.shape, bool)
        for i, sp in enumerate(admitting):
            if i == len(admitting) - 1:
                mask = ~assigned
            else:
                mask = ~assigned & (predicted <= sp.admit)
            assigned |= mask
            if mask.sum() == 0:
                continue
            dec_sp = self.pool(sp.handoff_to)
            frac = float(mask.mean())
            mean_prompt = float(p[mask].mean())
            mean_out = float(o[mask].mean())
            mean_ctx = float((p[mask] + o[mask] / 2).mean())
            lam_i = lam * frac
            pf = PoolSizing(
                name=sp.pool_name, window=sp.window, profile=sp.profile,
                arrival_rate=lam_i,
                mean_output=0.0,     # output-only accounting (paper §10.1)
                mean_context=mean_prompt, mean_prompt=mean_prompt,
                phase="prefill", prefill_engine_mfu=sp.prefill_engine_mfu,
                role=sp.role)
            pf.size(streamed_params=self._streamed(sp),
                    prefill_mfu=sp.prefill_engine_mfu)
            dec = PoolSizing(
                name=dec_sp.pool_name, window=dec_sp.window,
                profile=dec_sp.profile, arrival_rate=lam_i,
                mean_output=mean_out, mean_context=mean_ctx,
                mean_prompt=0.0,     # prefill load removed from this pool
                role=dec_sp.role)
            dec.size(streamed_params=self._streamed(dec_sp))
            pools.extend([pf, dec])
        return FleetReport(pools=pools, label=self.label)

    # --- serving-layer compilation (lazy serving imports: core stays
    # importable without the serving layer, which itself builds on core) --
    def registry(self):
        """`serving.models.ModelProfileRegistry` binding each role to the
        model/profile its pool serves.  The default binding is the
        terminal pool's; only roles that differ are bound explicitly, so
        homogeneous specs keep `registry.heterogeneous == False`."""
        from ..serving.models import ModelBinding, ModelProfileRegistry
        term = self.pools[-1]
        reg = ModelProfileRegistry(default=ModelBinding(
            self.models[term.model_key], term.profile,
            dispatch_ms=term.dispatch_ms))
        for sp in self.pools:
            if (sp.model_key != term.model_key
                    or sp.profile is not term.profile
                    or sp.dispatch_ms != term.dispatch_ms):
                reg.bind(sp.role, ModelBinding(
                    self.models[sp.model_key], sp.profile,
                    dispatch_ms=sp.dispatch_ms))
        return reg

    def policy(self, workload: Workload, plan: FleetReport):
        """Explicit-ladder `RouterPolicy` over the pools that survived
        provisioning (a rung that routes no traffic provisions no pool
        and drops off the ladder; the last survivor admits everything)."""
        from ..serving.router import RouterPolicy
        surviving = {q.role for q in plan.pools}
        rungs = [sp for sp in self.admitting if sp.role in surviving]
        if not rungs:
            raise ValueError(
                f"{self.kind}: no admitting pool survived provisioning —"
                f" the workload routed no traffic anywhere")
        ladder = [(sp.role, float(sp.admit)) for sp in rungs[:-1]]
        ladder.append((rungs[-1].role, math.inf))
        p99 = int(np.quantile(workload.outputs, 0.99)) \
            if self.metric == "prompt_plus_p99" else 1024
        return RouterPolicy(
            kind=self.kind, b_short=self.b_short, gamma=self.gamma,
            p99_output=p99, ladder=ladder, metric_kind=self.metric,
            flip=self.flip, misroute_rate=self.misroute_rate,
            detect_tokens=self.detect_tokens,
            misroute_seed=self.misroute_seed, spec=self)

    def build(self, workload: Workload, *, pool_overrides=None):
        """(policy, plan, registry) — the `build_topology` contract,
        derived entirely from the spec."""
        from .fleet import apply_overrides
        plan = self.provision(workload)
        registry = self.registry()
        policy = self.policy(workload, plan)
        if pool_overrides:
            roles = plan_roles(plan)
            apply_overrides(plan, pool_overrides, roles=roles,
                            streamed_params=registry.streamed_params_by_role(
                                roles))
        return policy, plan, registry

    # --- legacy kind compilation ----------------------------------------
    @classmethod
    def from_kind(cls, kind: str, profile: BaseProfile, model: ModelSpec, *,
                  b_short: int = 4096, gamma: float = 2.0,
                  long_window: int = LONG_WINDOW,
                  windows: Optional[Sequence[int]] = None,
                  small_model: Optional[ModelSpec] = None,
                  small_profile: Optional[BaseProfile] = None,
                  misroute_rate: float = 0.0,
                  dispatch_ms: float = 0.0,
                  misroute_seed: int = 0) -> "TopologySpec":
        """Compile a legacy kind string to the IR — the only place kind
        dispatch exists.  Pinned bit-exact against the committed
        quick-bench baseline; see DESIGN.md §12 for the full table.

        The serving-twin conventions the legacy `build_topology` encoded
        are preserved: `fleetopt` routes *and* serves at
        W = int(gamma * b_short) (admission boundary == short serve
        window — the analytical twin of the router's
        `predicted <= gamma * b_short` rung, identical for every
        integral gamma * b_short), the disagg kinds likewise, `semantic`
        serves its small pool at int(g * b_short) with admission at
        b_short, and `multipool` admits each rung at window / gamma.
        """
        if misroute_rate and kind not in SEMANTIC_KINDS:
            raise ValueError(f"misroute_rate only applies to semantic kinds,"
                             f" not {kind!r}")
        if dispatch_ms and kind not in ("moe_pool", "moe_semantic"):
            raise ValueError(f"dispatch_ms only applies to MoE kinds,"
                             f" not {kind!r}")
        models = {"default": model}
        if kind in ("homo", "moe_pool"):
            moe = kind in ("moe_pool",)
            prof = with_dispatch_floor(profile, dispatch_ms) if moe \
                else profile
            pools = (PoolSpec(
                role="moe" if moe else "homo",
                name=f"homo-{long_window // 1024}K", window=long_window,
                profile=prof, admit=math.inf, dispatch_ms=dispatch_ms),)
            return cls(kind=kind, pools=pools, models=models,
                       b_short=b_short, gamma=gamma,
                       label=f"Homo {long_window // 1024}K")
        if kind in ("two_pool",):
            pools = (
                PoolSpec(role="short", name=f"short-{b_short // 1024}K",
                         window=b_short, profile=profile,
                         admit=float(b_short), overflow_to="long"),
                PoolSpec(role="long", name=f"long-{long_window // 1024}K",
                         window=long_window, profile=profile,
                         admit=math.inf, hol_inflation=HOL_INFLATION),
            )
            return cls(kind=kind, pools=pools, models=models,
                       metric="prompt_plus_p99", b_short=b_short,
                       gamma=gamma, label=f"Pool {b_short // 1024}K")
        if kind in ("fleetopt",):
            w_short = int(gamma * b_short)
            pools = (
                PoolSpec(role="short",
                         name=f"fleetopt-short-{w_short // 1024}K",
                         window=w_short, profile=profile,
                         admit=float(w_short), evict_on_overflow=True,
                         overflow_to="long"),
                PoolSpec(role="long",
                         name=f"fleetopt-long-{long_window // 1024}K",
                         window=long_window, profile=profile,
                         admit=math.inf),
            )
            return cls(kind=kind, pools=pools, models=models,
                       accounting="fleetopt", b_short=b_short, gamma=gamma,
                       label=f"FleetOpt {w_short // 1024}K/g=1")
        if kind in ("multipool",):
            if not windows:
                raise ValueError(
                    "kind='multipool' needs an ascending `windows` ladder"
                    " (e.g. core.multipool.ladder_windows)")
            ws = [int(w) for w in windows]
            if any(a >= b for a, b in zip(ws, ws[1:])):
                raise ValueError(f"MultiPool windows must be strictly"
                                 f" ascending, got {ws}")
            if gamma < 1.0:
                raise ValueError(f"gamma must be >= 1, got {gamma}")
            names = [f"pool-{w // 1024}K" for w in ws]
            if len(set(names)) != len(names):
                raise ValueError(f"windows {ws} collide at 1K naming"
                                 f" granularity: {names}")
            pools = tuple(PoolSpec(
                role=names[i], window=w, profile=profile,
                admit=(w / gamma if i < len(ws) - 1 else math.inf),
                evict_on_overflow=i < len(ws) - 1,
                overflow_to=names[i + 1] if i < len(ws) - 1 else None)
                for i, w in enumerate(ws))
            return cls(kind=kind, pools=pools, models=models,
                       b_short=b_short, gamma=gamma,
                       label=f"MultiPool{ws}")
        if kind in SEMANTIC_KINDS:
            if not 0.0 <= misroute_rate < 1.0:
                raise ValueError(f"misroute_rate must be in [0, 1), got"
                                 f" {misroute_rate}")
            g = 1.0 if kind in ("semantic",) else gamma
            if g < 1.0:
                raise ValueError(f"gamma must be >= 1, got {g}")
            if small_model is None:
                small_model = LLAMA31_8B
            if small_profile is None:
                # the paper's §5.1 small pool: the 8B-class model at TP1
                # on the same accelerator generation as the large pool
                small_profile = computed_profile(
                    small_model, profile.chip, profile.power_model, tp=1)
            large_profile = with_dispatch_floor(profile, dispatch_ms) \
                if kind in ("moe_semantic",) else profile
            w_short = int(g * b_short)
            pools = (
                PoolSpec(role="small",
                         name=f"semantic-small-{w_short // 1024}K",
                         window=w_short, profile=small_profile,
                         model_key="small", admit=float(b_short),
                         evict_on_overflow=True, overflow_to="large",
                         escalate_to="large"),
                PoolSpec(role="large",
                         name=f"semantic-large-{long_window // 1024}K",
                         window=long_window, profile=large_profile,
                         admit=math.inf, dispatch_ms=dispatch_ms),
            )
            return cls(kind=kind, pools=pools,
                       models={"default": model, "small": small_model},
                       accounting="semantic", misroute_rate=misroute_rate,
                       detect_tokens=ESCALATION_DETECT_TOKENS,
                       misroute_seed=misroute_seed,
                       flip=("small", "large"), b_short=b_short, gamma=g,
                       label=f"Semantic {b_short // 1024}K/g={g:g}"
                             + (f"/mr={misroute_rate:g}"
                                if misroute_rate else ""))
        if kind in ("disagg", "disagg_fleetopt"):
            split = kind in ("disagg_fleetopt",)
            w_short = int(gamma * b_short)
            slices = [(w_short, float(w_short)), (long_window, math.inf)] \
                if split else [(long_window, math.inf)]
            pools = []
            for i, (w, admit) in enumerate(slices):
                pf_role = f"prefill-{w // 1024}K"
                dec_role = f"decode-{w // 1024}K"
                nxt = f"prefill-{slices[i + 1][0] // 1024}K" \
                    if i < len(slices) - 1 else None
                pools.append(PoolSpec(
                    role=pf_role, window=w, profile=profile,
                    phase="prefill", admit=admit, handoff_to=dec_role,
                    prefill_engine_mfu=PREFILL_MFU))
                pools.append(PoolSpec(
                    role=dec_role, window=w, profile=profile,
                    evict_on_overflow=nxt is not None, overflow_to=nxt))
            return cls(kind=kind, pools=tuple(pools), models=models,
                       accounting="disagg", b_short=b_short, gamma=gamma,
                       label=f"Disagg{'+FleetOpt' if split else ''}")
        raise ValueError(kind)


def plan_roles(plan: FleetReport) -> List[str]:
    """Router role per plan pool, ascending-window order (ties keep the
    provisioning order — prefill before its paired decode — because
    Python's sort is stable).  Replaces the deleted
    `serving.fleetsim.topology_roles` kind table: roles now travel *on*
    the pools, stamped by `TopologySpec.provision`."""
    pools = sorted(plan.pools, key=lambda p: p.window)
    roles = [p.role for p in pools]
    if not all(roles):
        missing = [p.name for p in pools if not p.role]
        raise ValueError(
            f"plan pools {missing} carry no router role — provision fleets"
            f" through core.topospec.TopologySpec (build_topology does)")
    return roles
