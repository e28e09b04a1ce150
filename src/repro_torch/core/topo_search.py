"""Topology search over the `TopologySpec` IR (DESIGN.md §12).

The point of compiling topologies to data (`core.topospec`) is that the
topology becomes an *optimization variable*: this module searches the
spec space for the fleet with the highest **measured-SLO-compliant**
tok/W.  The objective is `SLOSizingResult.slo_tok_per_watt` — Eq. 4
evaluated on a sizing that `core.slo.size_to_slo_spec` has verified
against the FleetSim-measured TTFT p99 — so a candidate only scores at
all if it actually meets the latency SLO (non-compliant candidates
score -inf and can never win).

Genome (one candidate fleet):

  windows      — ascending serve-window ladder; the terminal window is
                 FIXED at `LONG_WINDOW` so every candidate serves the
                 whole trace and all candidates share ONE frozen arrival
                 trace (common random numbers: scores differ only in
                 topology, never in arrival noise).
  gamma        — overflow headroom: rung i admits at window/gamma and
                 serves at window (multipool semantics; gamma = 1 is
                 plain partitioning).
  disagg       — serve each window slice as a (prefill, decode) pool
                 pair instead of a unified decode pool.
  chips        — per-rung accelerator profile (a key into the `chips`
                 candidate dict).
  small_first  — bind the shortest rung to the small model (§5.1
                 model-heterogeneity with a perfect length classifier;
                 only meaningful when `small_model` is given).

Search algorithm — coordinate descent with evolutionary restarts:

  1. seed at the best hand-built topology (multipool K=3: windows
     [4096, 16384, 65536], gamma=2) — the searched fleet therefore
     scores >= the incumbent *by construction*;
  2. sweep the incumbent's neighbourhood one axis at a time (window
     step up/down the grid, add/drop a rung, gamma step, disagg
     toggle, per-rung chip swap, small-model toggle) and move to the
     first improving neighbour (first-improvement descent: determinstic
     and budget-frugal);
  3. on a full sweep with no improvement (a local optimum), apply
     `np.random.default_rng(seed + restart)`-drawn random mutations to
     the incumbent and descend again (evolutionary restart);
  4. stop when the evaluation budget is exhausted or `max_restarts`
     consecutive restarts fail to improve the incumbent.

Every evaluation is memoized on `TopologySpec.spec_hash`, so revisiting
a genome (common after restarts) costs nothing and only *novel* specs
consume budget.

Each candidate's pools drain in `engine` ("numpy" on the host, or
"graph", the compiled drain of serving.graph_engine, on `device`: "cuda"
unless the caller asks for the CPU).  The engine changes where the
drain runs, never the search: the same descent, draws and memo.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .fleet import PREFILL_MFU
from .modelspec import ModelSpec
from .profiles import BaseProfile, computed_profile
from .routing import LONG_WINDOW
from .slo import SLOSizingResult, SLOSpec, size_to_slo_spec
from .topospec import PoolSpec, TopologySpec
from .workloads import Workload

# the non-terminal window grid (the terminal rung is pinned at
# LONG_WINDOW so every candidate shares one frozen trace)
_WINDOW_GRID = (2048, 4096, 8192, 16384, 32768)
_GAMMA_GRID = (1.0, 1.5, 2.0, 3.0, 4.0)
_MAX_RUNGS = 5          # terminal + up to 4 short rungs
_EPS = 1e-9             # improvement threshold (ties never move)


@dataclasses.dataclass(frozen=True)
class _Genome:
    """Hashable candidate encoding; `ladder_spec` compiles it to the IR."""

    windows: Tuple[int, ...]     # ascending; windows[-1] == LONG_WINDOW
    gamma: float
    disagg: bool
    chips: Tuple[str, ...]       # per-rung chip key, len == len(windows)
    small_first: bool


def ladder_spec(windows: Sequence[int], profiles: Sequence[BaseProfile],
                model: ModelSpec, *, gamma: float = 2.0,
                disagg: bool = False,
                small_model: Optional[ModelSpec] = None,
                small_profile: Optional[BaseProfile] = None,
                kind: str = "searched", label: str = "") -> TopologySpec:
    """Build a generalized K-rung ladder `TopologySpec` by hand.

    `windows` are ascending serve windows; rung i admits at
    window/gamma (the terminal rung admits everything) and overflows
    into rung i+1, exactly the multipool semantics — so
    `ladder_spec([4096, 16384, 65536], [p]*3, m)` provisions the same
    fleet as `TopologySpec.from_kind("multipool", ...)`.  `profiles`
    gives each rung its accelerator (one entry per rung).  With
    `disagg=True` every rung becomes a (prefill, decode) pool pair with
    a KV handoff inside the slice.  With `small_model` (+ its
    `small_profile`) the shortest rung serves the small model — §5.1
    model-heterogeneous routing under a perfect length classifier.
    """
    ws = [int(w) for w in windows]
    if any(a >= b for a, b in zip(ws, ws[1:])):
        raise ValueError(f"ladder windows must be strictly ascending,"
                         f" got {ws}")
    if gamma < 1.0:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    if len(profiles) != len(ws):
        raise ValueError(f"need one profile per rung: {len(ws)} windows"
                         f" vs {len(profiles)} profiles")
    if small_model is not None and small_profile is None:
        raise ValueError("small_model needs its small_profile (the small"
                         " rung's accelerator, sized for that model)")
    models: Dict[str, ModelSpec] = {"default": model}
    if small_model is not None:
        models["small"] = small_model
    k = len(ws)
    pools: List[PoolSpec] = []
    for i, w in enumerate(ws):
        terminal = i == k - 1
        admit = math.inf if terminal else w / gamma
        prof = profiles[i]
        model_key = "default"
        if small_model is not None and i == 0 and not terminal:
            model_key, prof = "small", small_profile
        if disagg:
            pf_role, dec_role = f"prefill-{w // 1024}K", f"decode-{w // 1024}K"
            nxt = None if terminal else f"prefill-{ws[i + 1] // 1024}K"
            pools.append(PoolSpec(
                role=pf_role, window=w, profile=prof, model_key=model_key,
                phase="prefill", admit=admit, handoff_to=dec_role,
                prefill_engine_mfu=PREFILL_MFU))
            pools.append(PoolSpec(
                role=dec_role, window=w, profile=prof, model_key=model_key,
                evict_on_overflow=nxt is not None, overflow_to=nxt))
        else:
            pools.append(PoolSpec(
                role=f"pool-{w // 1024}K", window=w, profile=prof,
                model_key=model_key, admit=admit,
                evict_on_overflow=not terminal,
                overflow_to=None if terminal else f"pool-{ws[i + 1] // 1024}K"))
    return TopologySpec(
        kind=kind, pools=tuple(pools), models=models,
        accounting="disagg" if disagg else "subset",
        b_short=ws[0], gamma=gamma,
        label=label or (f"Searched{[w // 1024 for w in ws]}K/g={gamma:g}"
                        + ("/disagg" if disagg else "")))


@dataclasses.dataclass
class TopologySearchResult:
    """Search outcome + the full evaluation audit trail."""

    workload: str
    best_spec: TopologySpec
    best_result: SLOSizingResult
    best_score: float                  # SLO-compliant analytical tok/W
    history: List[dict]                # one entry per novel evaluation
    evaluations: int                   # novel (budget-consuming) evals
    restarts: int

    def row(self) -> dict:
        return dict(workload=self.workload,
                    label=self.best_spec.label,
                    spec_hash=self.best_spec.spec_hash,
                    # a non-compliant best (SLO unattainable on this
                    # workload) reports 0, not -inf, like the bench rows
                    slo_feasible=round(self.best_score, 2)
                    if math.isfinite(self.best_score) else 0.0,
                    measured=round(
                        self.best_result.measured_decode_tok_per_watt, 2),
                    ttft_p99_s=round(self.best_result.ttft_p99_s, 3),
                    instances=self.best_result.plan.instances,
                    compliant=self.best_result.compliant,
                    evaluations=self.evaluations,
                    restarts=self.restarts)


def _neighbors(g: _Genome, chip_keys: Sequence[str],
               allow_small: bool) -> List[_Genome]:
    """The coordinate-descent neighbourhood, one axis moved at a time,
    in a fixed deterministic order."""
    out: List[_Genome] = []
    short = list(g.windows[:-1])
    # window step: move each short rung one notch up/down the grid
    for i, w in enumerate(short):
        gi = _WINDOW_GRID.index(w)
        for gj in (gi - 1, gi + 1):
            if not 0 <= gj < len(_WINDOW_GRID):
                continue
            cand = sorted(short[:i] + [_WINDOW_GRID[gj]] + short[i + 1:])
            if len(set(cand)) == len(cand):
                out.append(dataclasses.replace(
                    g, windows=tuple(cand) + (LONG_WINDOW,)))
    # add a rung (chip inherited from the rung it splits off of)
    if len(g.windows) < _MAX_RUNGS:
        for w in _WINDOW_GRID:
            if w in short:
                continue
            cand = sorted(short + [w])
            j = cand.index(w)
            chips = g.chips[:j] + (g.chips[min(j, len(g.chips) - 1)],) \
                + g.chips[j:]
            out.append(dataclasses.replace(
                g, windows=tuple(cand) + (LONG_WINDOW,), chips=chips))
    # drop a rung
    if len(g.windows) > 1:
        for i in range(len(short)):
            out.append(dataclasses.replace(
                g, windows=tuple(short[:i] + short[i + 1:]) + (LONG_WINDOW,),
                chips=g.chips[:i] + g.chips[i + 1:],
                small_first=g.small_first and len(short) > 1))
    # gamma step
    gi = _GAMMA_GRID.index(g.gamma)
    for gj in (gi - 1, gi + 1):
        if 0 <= gj < len(_GAMMA_GRID):
            out.append(dataclasses.replace(g, gamma=_GAMMA_GRID[gj]))
    # disagg toggle (the disagg ladder is model-homogeneous)
    out.append(dataclasses.replace(g, disagg=not g.disagg,
                                   small_first=False))
    # per-rung chip swap
    for i, cur in enumerate(g.chips):
        for key in chip_keys:
            if key != cur:
                out.append(dataclasses.replace(
                    g, chips=g.chips[:i] + (key,) + g.chips[i + 1:]))
    # small-model toggle on the shortest rung
    if allow_small and not g.disagg and len(g.windows) >= 2:
        out.append(dataclasses.replace(g, small_first=not g.small_first))
    return out


def _mutate(g: _Genome, rng: np.random.Generator, chip_keys: Sequence[str],
            allow_small: bool, n_ops: int) -> _Genome:
    """Evolutionary restart: `n_ops` random single-axis jumps applied to
    the incumbent (drawn from the same move set as the descent, but
    landing anywhere on each axis's grid, not one notch away)."""
    for _ in range(n_ops):
        short = list(g.windows[:-1])
        ops = ["gamma", "chip"]
        if len(g.windows) < _MAX_RUNGS and len(short) < len(_WINDOW_GRID):
            ops.append("add")
        if short:
            ops += ["drop", "move"]
        if allow_small and not g.disagg and len(g.windows) >= 2:
            ops.append("small")
        ops.append("disagg")
        op = ops[int(rng.integers(len(ops)))]
        if op == "gamma":
            g = dataclasses.replace(
                g, gamma=_GAMMA_GRID[int(rng.integers(len(_GAMMA_GRID)))])
        elif op == "chip":
            i = int(rng.integers(len(g.chips)))
            key = chip_keys[int(rng.integers(len(chip_keys)))]
            g = dataclasses.replace(
                g, chips=g.chips[:i] + (key,) + g.chips[i + 1:])
        elif op == "add":
            free = [w for w in _WINDOW_GRID if w not in short]
            w = free[int(rng.integers(len(free)))]
            cand = sorted(short + [w])
            j = cand.index(w)
            chips = g.chips[:j] + (g.chips[min(j, len(g.chips) - 1)],) \
                + g.chips[j:]
            g = dataclasses.replace(
                g, windows=tuple(cand) + (LONG_WINDOW,), chips=chips)
        elif op == "drop":
            i = int(rng.integers(len(short)))
            g = dataclasses.replace(
                g, windows=tuple(short[:i] + short[i + 1:]) + (LONG_WINDOW,),
                chips=g.chips[:i] + g.chips[i + 1:],
                small_first=g.small_first and len(short) > 1)
        elif op == "move":
            i = int(rng.integers(len(short)))
            w = _WINDOW_GRID[int(rng.integers(len(_WINDOW_GRID)))]
            cand = sorted(short[:i] + [w] + short[i + 1:])
            if len(set(cand)) == len(cand):
                g = dataclasses.replace(
                    g, windows=tuple(cand) + (LONG_WINDOW,))
        elif op == "small":
            g = dataclasses.replace(g, small_first=not g.small_first)
        elif op == "disagg":
            g = dataclasses.replace(g, disagg=not g.disagg,
                                    small_first=False)
    return g


def optimize_topology(workload: Workload, profile: BaseProfile,
                      model: ModelSpec, *, slo: SLOSpec = SLOSpec(),
                      chips: Optional[Dict[str, BaseProfile]] = None,
                      small_model: Optional[ModelSpec] = None,
                      n_requests: int = 1500, seed: int = 0,
                      budget: int = 24, max_restarts: int = 3,
                      max_rounds: int = 6, prefill_chunk: int = 512,
                      trim: bool = False,
                      engine: str = "numpy",
                      device="cuda") -> TopologySearchResult:
    """Search the `TopologySpec` space for the fleet with the highest
    measured-SLO-compliant tok/W on `workload` (module docstring: genome,
    moves, stopping rule).

    `chips` maps chip names to *large-model* profiles the per-rung chip
    axis may pick from (default: just `profile`); `small_model` enables
    the model axis (its per-chip profiles are derived at TP1, the §5.1
    convention).  `budget` caps the number of *novel* spec evaluations —
    each one is a full `size_to_slo_spec` sizing against the shared
    frozen trace; memo hits are free.  Deterministic for fixed inputs:
    the descent order is fixed and every random draw comes from
    `np.random.default_rng(seed + restart)`.  `engine` and `device` are
    handed to every `size_to_slo_spec` call (`device` matters only under
    `engine="graph"`).
    """
    from ..serving.request import sample_trace

    if chips is None:
        chips = {profile.chip.name: profile}
    chip_keys = tuple(sorted(chips))
    small_by_chip: Dict[str, BaseProfile] = {}
    if small_model is not None:
        small_by_chip = {
            key: computed_profile(small_model, pr.chip, pr.power_model, tp=1)
            for key, pr in chips.items()}
    default_key = profile.chip.name if profile.chip.name in chips \
        else chip_keys[0]

    # ONE frozen trace for every candidate (the terminal rung is pinned
    # at LONG_WINDOW, so max_window — the trace clip — is identical)
    trace = sample_trace(workload, n_requests, seed=seed,
                         max_total=LONG_WINDOW)

    def spec_of(g: _Genome) -> TopologySpec:
        profs = [chips[key] for key in g.chips]
        sm = small_model if (g.small_first and not g.disagg
                             and len(g.windows) >= 2) else None
        return ladder_spec(
            g.windows, profs, model, gamma=g.gamma, disagg=g.disagg,
            small_model=sm,
            small_profile=small_by_chip.get(g.chips[0]) if sm else None)

    memo: Dict[str, Tuple[float, SLOSizingResult, TopologySpec]] = {}
    history: List[dict] = []
    evals = itertools.count(1)
    n_evals = 0

    def evaluate(g: _Genome):
        nonlocal n_evals
        spec = spec_of(g)
        h = spec.spec_hash
        if h in memo:
            return memo[h]
        n_evals = next(evals)
        try:
            res = size_to_slo_spec(
                spec, workload, slo=slo, n_requests=n_requests, seed=seed,
                max_rounds=max_rounds, prefill_chunk=prefill_chunk,
                trim=trim, engine=engine, trace=trace, device=device)
            score = res.slo_tok_per_watt if res.compliant \
                else float("-inf")
            err = None
        except Exception as exc:  # a broken candidate loses, not the search
            res, score, err = None, float("-inf"), f"{type(exc).__name__}:"\
                f" {exc}"
        history.append(dict(
            eval=n_evals, spec_hash=h, label=spec.label,
            score=None if math.isinf(score) else round(score, 4),
            compliant=bool(res.compliant) if res is not None else False,
            error=err))
        memo[h] = (score, res, spec)
        return memo[h]

    # seed: the best hand-built topology (multipool K=3) — the search
    # result is >= the incumbent by construction
    g_best = _Genome(windows=(4096, 16384, LONG_WINDOW), gamma=2.0,
                     disagg=False, chips=(default_key,) * 3,
                     small_first=False)
    best_score, best_res, best_spec = evaluate(g_best)
    restarts = stall = 0
    while n_evals < budget and stall <= max_restarts:
        improved = False
        for g in _neighbors(g_best, chip_keys,
                            allow_small=small_model is not None):
            if n_evals >= budget:
                break
            score, res, spec = evaluate(g)
            if score > best_score + _EPS:
                g_best, best_score = g, score
                best_res, best_spec = res, spec
                improved = True
                break
        if improved:
            stall = 0
            continue
        if n_evals >= budget:
            break
        # local optimum: evolutionary restart from the incumbent
        restarts += 1
        stall += 1
        rng = np.random.default_rng(seed + restarts)
        g = _mutate(g_best, rng, chip_keys,
                    allow_small=small_model is not None,
                    n_ops=1 + restarts % 3)
        score, res, spec = evaluate(g)
        if score > best_score + _EPS:
            g_best, best_score = g, score
            best_res, best_spec = res, spec
            stall = 0
    if best_res is None:      # the seed itself failed — surface it loudly
        raise RuntimeError(
            f"topology search found no feasible fleet on {workload.name}:"
            f" {history}")
    return TopologySearchResult(
        workload=workload.name, best_spec=best_spec, best_result=best_res,
        best_score=best_score, history=history, evaluations=n_evals,
        restarts=restarts)
