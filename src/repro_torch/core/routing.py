"""Routing topologies (paper §4–§5): Homo / Pool / FleetOpt / Semantic.

A topology turns (workload, profile(s)) into provisioned pools:

  Homogeneous   — one pool at the long window; every GPU pays the 1/W price
                  of the worst-case context.
  TwoPool       — static context-length split at B_short.  Without an
                  overflow mechanism admission must be conservative
                  (prompt + p99(output) must fit the short window) and the
                  long pool suffers head-of-line inflation (see fleet.py).
  FleetOpt      — two-pool with overflow parameter gamma: the short pool
                  serves window gamma * B_short, admission by predicted total
                  <= gamma * B_short, no HOL penalty (the overflow headroom /
                  compress-and-route mechanism absorbs mispredictions).
                  `optimize_gamma` grid-searches gamma for fleet tok/W.
  Semantic      — §5.1: small *model* for short requests, large for long —
                  the model-heterogeneous topology.  Honest routing
                  (predicted total vs B_short) with FleetOpt-style overflow
                  headroom (serve at gamma * B_short), a semantic-classifier
                  `misroute_rate`, and an escalation hop: a true-large
                  request misrouted into the small-model pool is detected
                  after `detect_tokens` of decode and re-served from scratch
                  by the large pool; its small-pool work counts as
                  non-output energy (subtracted from tokens_per_s, the
                  FleetOpt migrated-token convention).  Served end-to-end
                  by serving.fleetsim (`semantic` / `semantic_fleetopt` /
                  `moe_semantic` kinds).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from .fleet import FleetReport, PoolSizing, size_fleet
from .modelspec import ModelSpec
from .profiles import BaseProfile
from .workloads import Workload

LONG_WINDOW = 65536   # paper: homogeneous / long pool serve at 64K
HOL_INFLATION = 2.15  # calibrated vs Table 3 (plain Pool, long pool)
# Decode tokens a semantic misroute generates in the small-model pool
# before the quality monitor catches it and escalates (shared by the
# analytical Semantic model and the serving-side SemanticRouter so the
# two layers price the same detection latency).
ESCALATION_DETECT_TOKENS = 32


def _subset_stats(prompts: np.ndarray, outputs: np.ndarray,
                  mask: np.ndarray) -> dict:
    if mask.sum() == 0:
        return dict(frac=0.0, mean_context=0.0, mean_output=0.0,
                    mean_prompt=0.0)
    p, o = prompts[mask], outputs[mask]
    return dict(frac=float(mask.mean()),
                mean_context=float((p + o / 2.0).mean()),
                mean_output=float(o.mean()),
                mean_prompt=float(p.mean()))


@dataclasses.dataclass
class Homogeneous:
    window: int = LONG_WINDOW

    def provision(self, workload: Workload, profile: BaseProfile,
                  model: ModelSpec) -> FleetReport:
        pool = PoolSizing(
            name=f"homo-{self.window // 1024}K", window=self.window,
            profile=profile, arrival_rate=workload.arrival_rate,
            mean_output=workload.mean_output,
            mean_context=workload.mean_context,
            mean_prompt=workload.mean_prompt)
        return size_fleet([pool], streamed_params=model.streamed_params,
                          label=f"Homo {self.window // 1024}K")


@dataclasses.dataclass
class TwoPool:
    b_short: int
    long_window: int = LONG_WINDOW
    hol_inflation: float = HOL_INFLATION

    def provision(self, workload: Workload, profile: BaseProfile,
                  model: ModelSpec) -> FleetReport:
        p, o = workload.prompts, workload.outputs
        # Conservative admission: no overflow handling, so a request may only
        # go short if prompt + p99(output) fits the short window.
        p99_out = float(np.quantile(o, 0.99))
        short_mask = p + p99_out <= self.b_short
        lam = workload.arrival_rate
        s = _subset_stats(p, o, short_mask)
        l = _subset_stats(p, o, ~short_mask)
        pools = [
            PoolSizing(name=f"short-{self.b_short // 1024}K",
                       window=self.b_short, profile=profile,
                       arrival_rate=lam * s["frac"],
                       mean_output=s["mean_output"],
                       mean_context=s["mean_context"],
                       mean_prompt=s["mean_prompt"]),
            PoolSizing(name=f"long-{self.long_window // 1024}K",
                       window=self.long_window, profile=profile,
                       arrival_rate=lam * l["frac"],
                       mean_output=l["mean_output"],
                       mean_context=l["mean_context"],
                       mean_prompt=l["mean_prompt"],
                       hol_inflation=self.hol_inflation),
        ]
        return size_fleet(pools, streamed_params=model.streamed_params,
                          label=f"Pool {self.b_short // 1024}K")


@dataclasses.dataclass
class FleetOpt:
    b_short: int
    gamma: float = 2.0
    long_window: int = LONG_WINDOW

    @property
    def short_window(self) -> int:
        return int(self.gamma * self.b_short)

    def mispredict_rate(self, workload: Workload) -> float:
        """Fraction of short-routed requests whose actual total overflows
        the gamma-window (these migrate and bust their TTFT/TPOT SLO)."""
        p, o = workload.prompts, workload.outputs
        routed_short = (p + workload.mean_output) <= self.b_short
        if routed_short.mean() == 0:
            return 0.0
        mis = routed_short & ((p + o) > self.short_window)
        return float(mis.sum() / routed_short.sum())

    def provision(self, workload: Workload, profile: BaseProfile,
                  model: ModelSpec) -> FleetReport:
        p, o = workload.prompts, workload.outputs
        lam = workload.arrival_rate
        # Honest routing: the router only knows the prompt and E[output].
        # The gamma-window is the overflow headroom: requests predicted to
        # fit B_short are served at window gamma*B_short, so output-length
        # mispredictions up to (gamma-1)*B_short finish in place.
        routed_short = (p + workload.mean_output) <= self.b_short
        mispredict = routed_short & ((p + o) > self.short_window)
        legit = routed_short & ~mispredict
        lam_mis = lam * float(mispredict.mean())
        s = _subset_stats(p, o, legit)
        l = _subset_stats(p, o, ~routed_short)
        # Mispredicted requests burn a short-pool slot for the full window
        # then migrate: re-prefilled and fully served in the long pool.
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
            PoolSizing(name=f"fleetopt-short-{self.short_window // 1024}K",
                       window=self.short_window, profile=profile,
                       arrival_rate=lam * s["frac"] + lam_mis,
                       mean_output=s["mean_output"],
                       mean_context=s["mean_context"],
                       mean_prompt=s["mean_prompt"]),
            PoolSizing(name=f"fleetopt-long-{self.long_window // 1024}K",
                       window=self.long_window, profile=profile,
                       arrival_rate=long_lam,
                       mean_output=l_mean_out,
                       mean_context=l_mean_ctx,
                       mean_prompt=l_mean_prompt),
        ]
        rep = size_fleet(pools, streamed_params=model.streamed_params,
                         label=f"FleetOpt {self.b_short // 1024}K"
                               f"/g={self.gamma:g}")
        # wasted short-pool decode work of migrated requests is real load
        # but produces no counted output tokens:
        if lam_mis > 0 and rep.pools:
            rep.pools[0].tokens_per_s -= lam_mis * s["mean_output"]
        return rep


def optimize_gamma(workload: Workload, profile: BaseProfile, model: ModelSpec,
                   b_short: int,
                   gammas: Tuple[float, ...] = (1.0, 1.5, 2.0, 3.0, 4.0, 6.0,
                                                8.0),
                   max_mispredict: float = 5e-5,
                   ) -> Tuple[float, FleetReport]:
    """gamma*: grid-optimal overflow parameter for fleet tok/W, subject to
    the SLO constraint that overflow migrations (which bust P99 TTFT) stay
    below `max_mispredict` of short-pool traffic (0.005%: the P99.99
    tail budget of the TTFT SLO).  Smaller gamma packs more
    sequences per instance (n_max ~ 1/window) but absorbs less of the
    output-length tail — the constraint is what pins gamma* = 2 on the
    Azure trace, matching the paper."""
    best: Tuple[float, Optional[FleetReport]] = (gammas[-1], None)
    for g in gammas:
        fo = FleetOpt(b_short=b_short, gamma=g)
        if fo.mispredict_rate(workload) > max_mispredict:
            continue
        rep = fo.provision(workload, profile, model)
        if best[1] is None or rep.tok_per_watt > best[1].tok_per_watt:
            best = (g, rep)
    if best[1] is None:   # no gamma satisfies the SLO: take the largest
        g = gammas[-1]
        best = (g, FleetOpt(b_short=b_short, gamma=g).provision(
            workload, profile, model))
    return best  # type: ignore[return-value]


@dataclasses.dataclass
class Semantic:
    """§5.1 semantic routing: small-model short pool, large-model long pool.

    Honest routing (the classifier sees prompt + E[output], like FleetOpt),
    with two error channels priced explicitly:

      * length mispredictions — a correctly-classified short request whose
        actual total outgrows the small pool's serve window
        (gamma * b_short) migrates: re-prefilled and fully served by the
        large pool, its small-pool decode work wasted (gamma = 1 is the
        headroom-free `semantic` serving kind; gamma > 1 the
        `semantic_fleetopt` kind).
      * semantic misroutes — a fraction `misroute_rate` of the classifier's
        decisions flip.  A true-short request sent large is merely served
        inefficiently; a true-large request sent small burns its (large)
        prompt prefill plus `detect_tokens` of small-model decode before
        escalation re-serves it from scratch in the large pool.

    Wasted small-pool work follows the FleetOpt migrated-token convention:
    the load is provisioned for, the output tokens are subtracted.
    """

    b_short: int
    small_profile: BaseProfile
    small_model: ModelSpec
    gamma: float = 2.0             # small-pool overflow headroom
    long_window: int = LONG_WINDOW
    misroute_rate: float = 0.0
    detect_tokens: int = ESCALATION_DETECT_TOKENS

    @property
    def short_window(self) -> int:
        return int(self.gamma * self.b_short)

    def provision(self, workload: Workload, profile: BaseProfile,
                  model: ModelSpec) -> FleetReport:
        if not 0.0 <= self.misroute_rate < 1.0:
            raise ValueError(f"misroute_rate must be in [0, 1), got"
                             f" {self.misroute_rate}")
        if self.gamma < 1.0:
            raise ValueError(f"gamma must be >= 1, got {self.gamma}")
        p, o = workload.prompts, workload.outputs
        lam = workload.arrival_rate
        r = self.misroute_rate
        routed_small = (p + workload.mean_output) <= self.b_short
        overflow = routed_small & ((p + o) > self.short_window)
        legit = routed_small & ~overflow
        s = _subset_stats(p, o, legit)
        v = _subset_stats(p, o, overflow)
        l = _subset_stats(p, o, ~routed_small)
        # an overflower decodes only until its KV hits the serve window
        # (then evicts), so its wasted small-pool output is window - prompt,
        # not its full sampled output
        ovf_waste = float(np.maximum(
            self.short_window - p[overflow], 0.0).mean()) \
            if overflow.any() else 0.0
        # --- small-model pool: correctly-routed shorts (1 - r of them)
        # plus the misrouted true-larges (r of the large class), which
        # prefill their big prompts here and decode detect_tokens each
        # before escalating ------------------------------------------------
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
        # --- large-model pool: correctly-routed larges, misrouted shorts,
        # and the re-served overflow + escalation traffic ------------------
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
            PoolSizing(name=f"semantic-small-{self.short_window // 1024}K",
                       window=self.short_window, profile=self.small_profile,
                       arrival_rate=lam_small,
                       mean_output=s_out, mean_context=s_ctx,
                       mean_prompt=s_prompt),
            PoolSizing(name=f"semantic-large-{self.long_window // 1024}K",
                       window=self.long_window, profile=profile,
                       arrival_rate=lam_large,
                       mean_output=l_out, mean_context=l_ctx,
                       mean_prompt=l_prompt),
        ]
        # NOTE: sizing uses each pool's own streamed params — the point of
        # the topology (DESIGN.md §9).
        pools[0].size(streamed_params=self.small_model.streamed_params)
        pools[1].size(streamed_params=model.streamed_params)
        # wasted small-pool decode (overflow migrations + escalated
        # misroutes) is provisioned load that produces no counted output
        if pools[0].instances and (lam_ovf > 0 or lam_esc > 0):
            pools[0].tokens_per_s -= (lam_ovf * ovf_waste
                                      + lam_esc * self.detect_tokens)
        return FleetReport(pools=[q for q in pools if q.arrival_rate > 0],
                           label=f"Semantic {self.b_short // 1024}K"
                                 f"/g={self.gamma:g}"
                                 + (f"/mr={self.misroute_rate:g}"
                                    if self.misroute_rate else ""))
