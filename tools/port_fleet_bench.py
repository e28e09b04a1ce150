#!/usr/bin/env python3
"""The fleet tables of the quick benches, from the port, held to the
committed baselines.

  PYTHONPATH=src python3 tools/port_fleet_bench.py [--only sim|diurnal]
                                                   [--out DIR]

A port-side twin of `benchmarks/fleet_sim_bench.py --quick` (Table A:
unconstrained H100 cells of azure-conv / lmsys-chat / agent-heavy x homo /
two_pool / fleetopt; Table B: SLO-constrained H100 / H200 / B200 x homo /
fleetopt / multipool on azure-conv; Table C: disaggregation; Table D:
semantic and MoE pools) and of `benchmarks/fleet_diurnal_bench.py --quick`
(Table F: a compressed diurnal day, static vs autoscaled).  It builds each
row as those benches do, importing only `repro_torch`, writes
{"meta", "rows"} as `fleet_sim.json` and `fleet_diurnal.json` under DIR
(default build/port_fleet_bench/), and compares every row, field for
field, with benchmarks/results/fleet_sim.json (28 rows) and
fleet_diurnal.json (12 rows).  Prints each table's host wall and, last, a
JSON summary; exits 1 if any field of any row differs.  Host work only:
no tensor, no card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np

from repro_torch.core import ladder_windows, size_to_slo
from repro_torch.core.autoscale import AutoscalePolicy
from repro_torch.core.hardware import H100
from repro_torch.core.modelspec import LLAMA31_70B, QWEN3_235B_A22B
from repro_torch.core.moe import moe_profile
from repro_torch.core.power import H100_POWER
from repro_torch.core.profiles import (B200_LLAMA70B_FLEET, H100_LLAMA70B,
                                       H200_LLAMA70B)
from repro_torch.core.slo import SLOSpec, size_to_slo_spec
from repro_torch.core.topospec import TopologySpec
from repro_torch.core.workloads import AGENT, AZURE, LMSYS, DiurnalProfile
from repro_torch.serving import (prepare_spec, sample_diurnal_trace,
                                 simulate_topology)

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


def _table_f():
    peak, day = DIURNAL["peak_rate"], DIURNAL["day_s"]
    dprof = DiurnalProfile(peak_rate=peak, day_s=day)
    wl = dataclasses.replace(AZURE, arrival_rate=peak)
    epoch = day / 40.0
    policy = AutoscalePolicy(control_interval_s=epoch, target_utilization=0.65,
                             scaleup_lag_s=epoch / 3.0,
                             scaledown_delay_s=3.0 * epoch, min_frac=0.15)
    rows = []
    for gen, prof in DIURNAL_GENERATIONS:
        for kind, kw in SLO_KW.items():
            spec = dataclasses.replace(
                TopologySpec.from_kind(kind, prof, LLAMA31_70B, **kw),
                autoscale=policy)
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


BENCHES = {
    "sim": ("fleet_sim.json",
            dict(n_requests=N_REQUESTS, slo_requests=SLO_REQUESTS, seed=SEED,
                 quick=True),
            (("unconstrained", _table_a), ("slo", _table_b),
             ("disagg", _table_c), ("model_hetero", _table_d))),
    "diurnal": ("fleet_diurnal.json", DIURNAL, (("diurnal", _table_f),)),
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
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "port_fleet_bench")
    args = ap.parse_args(argv)
    args.out.mkdir(parents=True, exist_ok=True)
    summary = {}
    for name, (fname, meta, tables) in BENCHES.items():
        if args.only not in (None, name):
            continue
        t0, rows, walls = time.perf_counter(), [], {}
        for table, build in tables:
            t = time.perf_counter()
            rows += build()
            walls[table] = round(time.perf_counter() - t, 3)
            print(f"{fname} {table}: host wall {walls[table]} s")
        doc = {"meta": meta, "rows": rows}
        (args.out / fname).write_text(json.dumps(doc, indent=1))
        want = json.loads((RESULTS / fname).read_text())
        diffs = _diff(rows, want["rows"])
        if meta != want["meta"]:
            diffs.append(f"meta {meta} != {want['meta']}")
        for d in diffs:
            print(f"{fname}: {d}")
        summary[name] = dict(rows=len(rows), baseline_rows=len(want["rows"]),
                             differences=len(diffs), table_wall_s=walls,
                             wall_s=round(time.perf_counter() - t0, 3))
    print(json.dumps(summary))
    return 1 if any(s["differences"] for s in summary.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
