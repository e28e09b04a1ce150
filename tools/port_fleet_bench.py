#!/usr/bin/env python3
"""The fleet tables of the quick benches and Table E, from the port, held
to the committed baselines.

  PYTHONPATH=src python3 tools/port_fleet_bench.py [--only sim|diurnal|grid|
                                                    topology]
                                                   [--engine numpy|graph]
                                                   [--device cuda|cpu]
                                                   [--out DIR]

A port-side twin of `benchmarks/fleet_sim_bench.py --quick` (Table A:
unconstrained H100 cells of azure-conv / lmsys-chat / agent-heavy x homo /
two_pool / fleetopt; Table B: SLO-constrained H100 / H200 / B200 x homo /
fleetopt / multipool on azure-conv; Table C: disaggregation; Table D:
semantic and MoE pools) and of `benchmarks/fleet_diurnal_bench.py --quick`
(Table F: a compressed diurnal day, static vs autoscaled), and of
`benchmarks/fleet_grid_bench.py` (Table E: the 260-cell Azure sensitivity
grid, misroute x dispatch floor x chip x pool count, at its defaults:
400 requests, seed 0, 4 scenarios per batched drain), and of
`benchmarks/topology_search_bench.py --quick` (azure-conv, 1500 requests,
budget 10, seed 0: the four hand-built fleets homo / two_pool / fleetopt /
multipool K=3 and the fleet `core.topo_search.optimize_topology` finds,
every one sized by `size_to_slo_spec` over one frozen trace).  It builds
each row as those benches do, importing only `repro_torch`, writes
{"meta", "rows"} as `fleet_sim.json`, `fleet_diurnal.json`,
`fleet_grid.json` and `topology_search.json` under DIR (default
build/port_fleet_bench/), and compares every row, field for field, with
benchmarks/results/fleet_sim.json (28 rows), fleet_diurnal.json (12
rows), fleet_grid.json (260 rows) and topology_search.json (5 rows, meta
included).  Prints each table's wall and, last, a JSON summary; exits 1
if any field of any row differs.

Tables A-D and F drain in the numpy engine on the host.  Table E and the
topology search drain in `--engine` (default numpy; "graph" is the
compiled drain of serving.graph_engine, on `--device`, default cuda;
Table E with the reference bench's shape classes).  Each wall is named
for what it measures: "host wall" where the pools drain in numpy or on
the CPU, "card wall" where the graph engine drains on the card, printed
beside the card's name and power limit (nvidia-smi).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from repro_torch.core import ladder_windows, size_to_slo
from repro_torch.core.autoscale import AutoscalePolicy
from repro_torch.core.hardware import B200, GB200, H100, H200
from repro_torch.core.modelspec import (LLAMA31_8B, LLAMA31_70B,
                                       QWEN3_235B_A22B)
from repro_torch.core.moe import moe_profile
from repro_torch.core.power import (B200_POWER, GB200_POWER, H100_POWER,
                                    H200_POWER)
from repro_torch.core.profiles import (B200_LLAMA70B_FLEET, GB200_LLAMA70B,
                                       H100_LLAMA70B, H200_LLAMA70B)
from repro_torch.core.routing import LONG_WINDOW
from repro_torch.core.slo import SLOSpec, size_to_slo_spec
from repro_torch.core.topo_search import optimize_topology
from repro_torch.core.topospec import TopologySpec
from repro_torch.core.workloads import AGENT, AZURE, LMSYS, DiurnalProfile
from repro_torch.serving import (prepare_spec, prepare_topology,
                                 run_fleet_grid, sample_diurnal_trace,
                                 sample_trace, simulate_topology)

ROOT = Path(__file__).resolve().parents[1]
RESULTS = ROOT / "benchmarks" / "results"

# the quick configuration of both benches
N_REQUESTS, SLO_REQUESTS, SEED = 1000, 1500, 0
B_SHORT = {"azure-conv": 4096, "lmsys-chat": 1536, "agent-heavy": 8192}
TOPOLOGIES = ("homo", "two_pool", "fleetopt")
GENERATIONS = (("H100", H100_LLAMA70B), ("H200", H200_LLAMA70B),
               ("B200", B200_LLAMA70B_FLEET))
SLO_KW = {"homo": dict(b_short=4096), "fleetopt": dict(b_short=4096),
          "multipool": dict(windows=ladder_windows(3))}
DISAGG_TOPOLOGIES = ("disagg", "disagg_fleetopt")
MOE_DISPATCH_MS = (0.0, 2.0, 10.0)
D_MISROUTE = 0.05
DIURNAL = dict(peak_rate=250.0, day_s=240.0, slo_requests=1500, seed=0,
               quick=True)
DIURNAL_GENERATIONS = (("H100", H100_LLAMA70B), ("B200", B200_LLAMA70B_FLEET))
PEAK_FRAC = 0.9

# Table E (benchmarks/fleet_grid_bench.py): its axes, defaults and the
# (row_floor, n_slots, queue) shape classes its compiled drains pad to —
# the reference tuned the list so the 260 cells share ~9 drain shapes
CHIPS = (("H100", H100, H100_POWER, H100_LLAMA70B),
         ("H200", H200, H200_POWER, H200_LLAMA70B),
         ("B200", B200, B200_POWER, B200_LLAMA70B_FLEET),
         ("GB200", GB200, GB200_POWER, GB200_LLAMA70B))
MISROUTES = (0.0, 0.02, 0.05, 0.08, 0.10, 0.15)
DISPATCH_MS = (0.0, 1.0, 2.0, 5.0, 10.0)
B_SHORTS = (2048, 4096, 8192)
GAMMAS = (1.5, 2.0, 3.0)
K_POOLS = (2, 3, 4)
GRID_WIDTH, GRID_REQUESTS = 4, 400
SHAPE_CLASSES = ((256, 32, 4),      # MoE expert pools, tiny slots/queues
                 (128, 48, 24),     # tail stages: second/overflow pools
                 (128, 96, 24),     # small dense pools
                 (64, 256, 64),     # semantic/16K first pools
                 (32, 768, 96),     # fleetopt short pools, 8K ladder
                 (8, 1536, 96))     # b_short=2048 / 4K-ladder slot monsters

# the topology search bench's quick configuration: azure-conv only, its
# four hand-built kinds (from_kind arguments as the bench selects them)
SEARCH = dict(slo_requests=1500, budget=10, seed=0, quick=True)
SEARCH_KW = {"homo": dict(b_short=B_SHORT["azure-conv"]),
             "two_pool": dict(b_short=B_SHORT["azure-conv"]),
             "fleetopt": dict(b_short=B_SHORT["azure-conv"]),
             "multipool": dict(windows=ladder_windows(3))}


def _table_a():
    rows = []
    for wl in (AZURE, LMSYS, AGENT):
        for kind in TOPOLOGIES:
            cell = simulate_topology(kind, wl, H100_LLAMA70B, LLAMA31_70B,
                                     b_short=B_SHORT[wl.name],
                                     n_requests=N_REQUESTS, seed=SEED)
            f = cell.report["fleet"]
            rows.append(dict(cell.row(), table="unconstrained",
                             occupancy={r: s["occupancy"]
                                        for r, s in cell.report.items()
                                        if r != "fleet"},
                             prefill_energy_frac=f["prefill_energy_frac"],
                             tokens_per_s=f["tokens_per_s"]))
    return rows


def _table_b():
    return [dict(size_to_slo(kind, AZURE, prof, LLAMA31_70B,
                             n_requests=SLO_REQUESTS, seed=SEED,
                             **SLO_KW[kind]).row(),
                 table="slo", generation=gen)
            for gen, prof in GENERATIONS for kind in SLO_KW]


def _slo_columns(res):
    return dict(slo_feasible=round(res.slo_tok_per_watt, 2),
                slo_measured_all_in=round(res.measured_tok_per_watt, 2),
                slo_ttft_p99_s=round(res.ttft_p99_s, 3),
                slo_added=res.instances_added)


def _table_c():
    rows = []
    for kind in DISAGG_TOPOLOGIES:
        kw = dict(b_short=B_SHORT[AZURE.name], seed=SEED)
        cell = simulate_topology(kind, AZURE, H100_LLAMA70B, LLAMA31_70B,
                                 n_requests=N_REQUESTS, **kw)
        res = size_to_slo(kind, AZURE, H100_LLAMA70B, LLAMA31_70B,
                          n_requests=SLO_REQUESTS, **kw)
        f = cell.report["fleet"]
        rows.append(dict(
            table="disagg", workload=AZURE.name, topology=kind,
            analytical=round(cell.analytical_tok_per_watt, 2),
            analytical_fleet=round(cell.analytical_fleet_tok_per_watt, 2),
            simulated=round(cell.sim_decode_tok_per_watt, 2),
            delta_pct=round(cell.delta_pct, 1),
            all_in=round(cell.sim_tok_per_watt, 2),
            ttft_p99_s=f.get("ttft_p99_s", 0.0),
            handoffs=f["handoffs"], migrations=f["migrations"],
            kv_handoff_joules=f["kv_handoff_joules"],
            kv_handoff_energy_frac=f["kv_handoff_energy_frac"],
            **_slo_columns(res), slo_compliant=res.compliant))
    return rows


def _table_d():
    bs = B_SHORT[AZURE.name]
    moe = moe_profile(QWEN3_235B_A22B, H100, H100_POWER, tp=8)
    cells = [("homo", H100_LLAMA70B, LLAMA31_70B, {}),
             ("fleetopt", H100_LLAMA70B, LLAMA31_70B, dict(b_short=bs)),
             ("semantic", H100_LLAMA70B, LLAMA31_70B, dict(b_short=bs)),
             ("semantic_fleetopt", H100_LLAMA70B, LLAMA31_70B,
              dict(b_short=bs, misroute_rate=D_MISROUTE))]
    cells += [("moe_pool", moe, QWEN3_235B_A22B, dict(dispatch_ms=d))
              for d in MOE_DISPATCH_MS]
    cells.append(("moe_semantic", moe, QWEN3_235B_A22B,
                  dict(b_short=bs, misroute_rate=D_MISROUTE,
                       dispatch_ms=2.0)))
    rows = []
    for kind, prof, mdl, kw in cells:
        cell = simulate_topology(kind, AZURE, prof, mdl,
                                 n_requests=N_REQUESTS, seed=SEED, **kw)
        res = size_to_slo(kind, AZURE, prof, mdl, n_requests=SLO_REQUESTS,
                          seed=SEED, **kw)
        f = cell.report["fleet"]
        rows.append(dict(
            table="model_hetero", workload=AZURE.name, topology=kind,
            model=mdl.name,
            dispatch_ms=float(kw.get("dispatch_ms", 0.0)),
            misroute_rate=float(kw.get("misroute_rate", 0.0)),
            analytical=round(cell.analytical_tok_per_watt, 2),
            simulated=round(cell.sim_decode_tok_per_watt, 2),
            delta_pct=round(cell.delta_pct, 1),
            all_in=round(cell.sim_tok_per_watt, 2),
            ttft_p99_s=f.get("ttft_p99_s", 0.0),
            escalations=f["escalations"], migrations=f["migrations"],
            dispatch_energy_frac=f["moe_dispatch_energy_frac"],
            **_slo_columns(res), slo_trimmed=res.instances_trimmed,
            slo_compliant=res.compliant))
    return rows


def _peak_ttft_p99(sim, dprof):
    arrival = np.concatenate([s.arrival for s in sim.summaries.values()])
    first = np.concatenate([s.first_token for s in sim.summaries.values()])
    mask = (dprof.rate_at(arrival) >= PEAK_FRAC * dprof.peak_rate) \
        & (first >= 0)
    if not mask.any():
        return 0.0
    return round(float(np.quantile(first[mask] - arrival[mask], 0.99)), 4)


def diurnal_spec(kind, profile, day_s):
    """Table F's spec of `kind`: the from_kind fleet with the autoscaler
    scaled to the compressed day (a control epoch of 1/40 day, hysteresis
    3 epochs, actuation lag 1/3 epoch)."""
    epoch = day_s / 40.0
    policy = AutoscalePolicy(control_interval_s=epoch, target_utilization=0.65,
                             scaleup_lag_s=epoch / 3.0,
                             scaledown_delay_s=3.0 * epoch, min_frac=0.15)
    return dataclasses.replace(
        TopologySpec.from_kind(kind, profile, LLAMA31_70B, **SLO_KW[kind]),
        autoscale=policy)


def _table_f():
    peak, day = DIURNAL["peak_rate"], DIURNAL["day_s"]
    dprof = DiurnalProfile(peak_rate=peak, day_s=day)
    wl = dataclasses.replace(AZURE, arrival_rate=peak)
    rows = []
    for gen, prof in DIURNAL_GENERATIONS:
        for kind in SLO_KW:
            spec = diurnal_spec(kind, prof, day)
            res = size_to_slo_spec(spec, wl, slo=SLOSpec(ttft_p99_s=0.2),
                                   n_requests=DIURNAL["slo_requests"],
                                   seed=SEED)
            trace = sample_diurnal_trace(wl, dprof, day, seed=SEED,
                                         max_total=spec.max_window)
            for provisioning in ("static", "autoscaled"):
                sim, reqs, plan = prepare_spec(
                    spec, wl, seed=SEED, trace=trace,
                    pool_overrides=res.overrides,
                    autoscale=provisioning == "autoscaled")
                f = sim.run(reqs, warmup_frac=0.0)["fleet"]
                span = max(sim._window[1], 1e-9)
                avg_online = sum(s.online_instance_seconds(0.0, span)
                                 for s in sim.schedules.values()) / span \
                    if sim.schedules else float(plan.instances)
                rows.append(dict(
                    table="diurnal", generation=gen, workload=wl.name,
                    topology=kind, provisioning=provisioning,
                    peak_rate=peak, day_s=day,
                    tok_per_watt=f["tok_per_watt"],
                    idle_energy_frac=f["idle_energy_frac"],
                    ttft_p99_s=f.get("ttft_p99_s", 0.0),
                    peak_ttft_p99_s=_peak_ttft_p99(sim, dprof),
                    completed=f["completed"], migrations=f["migrations"],
                    instances_peak=plan.instances,
                    avg_online_instances=round(avg_online, 2),
                    slo_compliant_at_peak=res.compliant))
    return rows


def grid_cells():
    """(row-label dict, kind, profile, model, prepare kwargs) per cell."""
    cells = []
    for gen, chip, power, prof in CHIPS:
        moe = moe_profile(QWEN3_235B_A22B, chip, power, tp=8)

        def cell(kind, profile, model, **kw):
            cells.append((dict(table="grid", generation=gen,
                               workload=AZURE.name, topology=kind,
                               model=model.name,
                               dispatch_ms=float(kw.get("dispatch_ms", 0.0)),
                               misroute_rate=float(
                                   kw.get("misroute_rate", 0.0)),
                               b_short=int(kw.get("b_short", 0)),
                               gamma=float(kw.get("gamma", 0.0)),
                               k_pools=len(kw.get("windows", ()))),
                          kind, profile, model, kw))

        for mr in MISROUTES:
            for d in DISPATCH_MS:
                cell("moe_semantic", moe, QWEN3_235B_A22B, b_short=4096,
                     misroute_rate=mr, dispatch_ms=d)
            for bs in B_SHORTS:
                cell("semantic_fleetopt", prof, LLAMA31_70B, b_short=bs,
                     misroute_rate=mr)
        for g in GAMMAS:
            for bs in B_SHORTS:
                cell("fleetopt", prof, LLAMA31_70B, b_short=bs, gamma=g)
        for d in DISPATCH_MS:
            cell("moe_pool", moe, QWEN3_235B_A22B, dispatch_ms=d)
        for k in K_POOLS:
            cell("multipool", prof, LLAMA31_70B,
                 windows=ladder_windows(k))
    return cells


def grid_row(label, cell) -> dict:
    """One Table E row, rounded as the reference bench rounds it."""
    f = cell.report["fleet"]
    return dict(label,
                analytical=round(cell.analytical_tok_per_watt, 3),
                simulated=round(cell.sim_decode_tok_per_watt, 3),
                all_in=round(cell.sim_tok_per_watt, 3),
                delta_pct=round(cell.delta_pct, 1),
                completed=f["completed"],
                escalations=f["escalations"],
                migrations=f["migrations"])


def grid_scenarios(cells, *, engine="numpy", device="cuda"):
    """`prepare_topology` triples of `cells` on Azure traffic."""
    return [prepare_topology(kind, AZURE, prof, mdl,
                             n_requests=GRID_REQUESTS, seed=SEED,
                             engine=engine, device=device, **kw)
            for _, kind, prof, mdl, kw in cells]


def grid_rows(cells, *, engine="numpy", device="cuda"):
    """Table E rows of `cells`, GRID_WIDTH scenarios per `run_fleet_grid`
    call (graph drains padded to SHAPE_CLASSES, as the reference's)."""
    rows = []
    for i in range(0, len(cells), GRID_WIDTH):
        chunk = cells[i:i + GRID_WIDTH]
        scenarios = grid_scenarios(chunk, engine=engine, device=device)
        floors = SHAPE_CLASSES if engine == "graph" else None
        rows += [grid_row(label, cell) for (label, *_), cell in zip(
            chunk, run_fleet_grid(scenarios, pad_floors=floors))]
    return rows


def _by(rows, **match):
    out = [r for r in rows
           if all(r.get(k) == v for k, v in match.items())]
    assert out, match
    return out


def derive(rows) -> str:
    """Sensitivity one-liners: each headline claim with its measured
    neighborhood boundaries."""
    fo = {(r["generation"], r["gamma"], r["b_short"]): r["simulated"]
          for r in _by(rows, topology="fleetopt")}
    gain = [fo[("B200", g, b)] / fo[("H100", g, b)]
            for g in GAMMAS for b in B_SHORTS]
    # misroute rate at which the semantic split stops beating plain
    # fleetopt (same chip, the paper's 4K boundary)
    fo_ref = fo[("H100", 2.0, 4096)]
    sem = sorted((r["misroute_rate"], r["simulated"]) for r in
                 _by(rows, topology="semantic_fleetopt",
                     generation="H100", b_short=4096))
    crossover = next((mr for mr, v in sem if v < fo_ref), None)
    cross_txt = f">{sem[-1][0]:g}" if crossover is None else f"{crossover:g}"
    moe = {(r["generation"], r["dispatch_ms"]): r["simulated"]
           for r in _by(rows, topology="moe_pool")}
    slope = moe[("H100", DISPATCH_MS[-1])] / moe[("H100", 0.0)]
    mp = {(r["generation"], r["k_pools"]): r["simulated"]
          for r in _by(rows, topology="multipool")}
    best_k = {gen: max(K_POOLS, key=lambda k: mp[(gen, k)])
              for gen, *_ in CHIPS}
    return (f"B200/H100 fleetopt gain across gamma x b_short: "
            f"{min(gain):.2f}-{max(gain):.2f}x; "
            f"semantic_fleetopt(H100,4K) falls below fleetopt at misroute "
            f"{cross_txt}; "
            f"MoE tok/W at {DISPATCH_MS[-1]:g}ms dispatch = {slope:.2f}x "
            f"of 0ms; best K per chip: "
            + ", ".join(f"{g}={k}" for g, k in best_k.items()))


def _grid_tables(engine, device):
    """(family, function making its rows) per Table E family, in the
    bench's order."""
    fams = {}
    for c in grid_cells():
        fams.setdefault(c[1], []).append(c)
    return tuple((fam, lambda cells=cells: grid_rows(
        cells, engine=engine, device=device)) for fam, cells in fams.items())


def search_run(*, engine="numpy", device="cuda"):
    """The quick topology search bench: (rows, the hand-built specs'
    `SLOSizingResult`s by kind, the `TopologySearchResult`)."""
    n, seed, wl, slo = SEARCH["slo_requests"], SEARCH["seed"], AZURE, \
        SLOSpec()
    # ONE frozen trace shared by every hand-built spec AND the search
    trace = sample_trace(wl, n, seed=seed, max_total=LONG_WINDOW)
    rows, sized = [], {}
    best_hand, best_hand_kind = float("-inf"), None
    for kind, kw in SEARCH_KW.items():
        spec = TopologySpec.from_kind(kind, H100_LLAMA70B, LLAMA31_70B, **kw)
        res = sized[kind] = size_to_slo_spec(
            spec, wl, slo=slo, n_requests=n, seed=seed, trim=False,
            engine=engine, trace=trace, device=device)
        score = res.slo_tok_per_watt if res.compliant else 0.0
        if res.compliant and score > best_hand:
            best_hand, best_hand_kind = score, kind
        rows.append(dict(
            table="topology_search", workload=wl.name, topology=kind,
            label=spec.label, spec_hash=spec.spec_hash,
            slo_feasible=round(score, 2),
            measured=round(res.measured_decode_tok_per_watt, 2),
            ttft_p99_s=round(res.ttft_p99_s, 3),
            instances=res.plan.instances, compliant=res.compliant))
    sr = optimize_topology(
        wl, H100_LLAMA70B, LLAMA31_70B, slo=slo, small_model=LLAMA31_8B,
        n_requests=n, seed=seed, budget=SEARCH["budget"], trim=False,
        engine=engine, device=device)
    rows.append(dict(
        table="topology_search", workload=wl.name, topology="searched",
        label=sr.best_spec.label, spec_hash=sr.best_spec.spec_hash,
        slo_feasible=round(sr.best_score, 2)
        if sr.best_result.compliant else 0.0,
        measured=round(sr.best_result.measured_decode_tok_per_watt, 2),
        ttft_p99_s=round(sr.best_result.ttft_p99_s, 3),
        instances=sr.best_result.plan.instances,
        compliant=sr.best_result.compliant,
        evaluations=sr.evaluations, restarts=sr.restarts,
        best_hand_built=best_hand_kind,
        gain_vs_hand_pct=round(100.0 * (sr.best_score / best_hand - 1.0), 1)
        if best_hand > 0 else None))
    return rows, sized, sr


def search_derived(rows) -> str:
    """The bench's one-liner: the searched fleet against the best
    hand-built one."""
    r = rows[-1]
    return (f"{r['workload']}: searched {r['slo_feasible']:.2f} tok/W"
            f" ({r['label']})"
            + (f" vs best hand-built {r['best_hand_built']}"
               f" ({r['gain_vs_hand_pct']:+g}%)"
               if r["best_hand_built"] is not None
               else " (no hand-built topology is SLO-compliant)"))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


BENCHES = {
    "sim": ("fleet_sim.json",
            dict(n_requests=N_REQUESTS, slo_requests=SLO_REQUESTS, seed=SEED,
                 quick=True),
            (("unconstrained", _table_a), ("slo", _table_b),
             ("disagg", _table_c), ("model_hetero", _table_d))),
    "diurnal": ("fleet_diurnal.json", DIURNAL, (("diurnal", _table_f),)),
    "grid": ("fleet_grid.json", None, None),
    "topology": ("topology_search.json", SEARCH, None),
}


def _diff(got, want):
    """Row-by-row differences as strings (empty: every field equal)."""
    got = json.loads(json.dumps(got))
    out = [] if len(got) == len(want) \
        else [f"{len(got)} rows, the baseline has {len(want)}"]
    for i, (g, w) in enumerate(zip(got, want)):
        for k in sorted(set(g) | set(w)):
            if g.get(k, "<missing>") != w.get(k, "<missing>"):
                out.append(f"row {i} ({w.get('table')}/{w.get('workload')}/"
                           f"{w.get('topology')}) {k}: "
                           f"{g.get(k, '<missing>')!r} != "
                           f"{w.get(k, '<missing>')!r}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=tuple(BENCHES), default=None)
    ap.add_argument("--engine", choices=("numpy", "graph"), default="numpy",
                    help="the drain of Table E and of the topology search"
                         " (the other tables: numpy)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the graph engine drains")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "port_fleet_bench")
    args = ap.parse_args(argv)
    args.out.mkdir(parents=True, exist_ok=True)
    summary = {}
    for name, (fname, meta, tables) in BENCHES.items():
        if args.only not in (None, name):
            continue
        wall_name, card = "host wall", None
        if name == "grid":
            meta = dict(n_requests=GRID_REQUESTS, seed=SEED,
                        width=GRID_WIDTH, engine=args.engine,
                        device=args.device if args.engine == "graph"
                        else "host")
            tables = _grid_tables(args.engine, args.device)
        if name == "topology":
            tables = (("topology_search", lambda: search_run(
                engine=args.engine, device=args.device)[0]),)
        if name in ("grid", "topology") and args.engine == "graph" \
                and args.device == "cuda":
            wall_name, card = "card wall", card_line()
        t0, rows, walls = time.perf_counter(), [], {}
        for table, build in tables:
            t = time.perf_counter()
            rows += build()
            walls[table] = round(time.perf_counter() - t, 3)
            print(f"{fname} {table}: {wall_name} {walls[table]} s"
                  + (f" ({card})" if card else ""))
        doc = {"meta": meta, "rows": rows}
        (args.out / fname).write_text(json.dumps(doc, indent=1))
        want = json.loads((RESULTS / fname).read_text())
        if isinstance(want, list):      # fleet_grid.json: rows, no meta
            want = {"meta": meta, "rows": want}
        diffs = _diff(rows, want["rows"])
        if meta != want["meta"]:
            diffs.append(f"meta {meta} != {want['meta']}")
        for d in diffs:
            print(f"{fname}: {d}")
        if name == "grid":
            print(f"{fname} derived: {derive(rows)}")
        if name == "topology":
            for r in rows:
                print(f"{fname} {r['topology']}: {r['label']}"
                      f" slo_feasible {r['slo_feasible']} measured"
                      f" {r['measured']} ttft_p99_s {r['ttft_p99_s']}"
                      f" instances {r['instances']}"
                      + ("" if r["compliant"] else " NON-COMPLIANT"))
            print(f"{fname} derived: {search_derived(rows)}")
        summary[name] = dict(rows=len(rows), baseline_rows=len(want["rows"]),
                             differences=len(diffs), wall=wall_name,
                             table_wall_s=walls,
                             wall_s=round(time.perf_counter() - t0, 3),
                             **({"card": card} if card else {}))
    print(json.dumps(summary))
    return 1 if any(s["differences"] for s in summary.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
