#!/usr/bin/env python3
"""Trace-driven diurnal report from the port: Table F's cells as timelines.

  PYTHONPATH=src python3 tools/port_trace_report.py [--quick]
      [--peak-rate R] [--day-s S] [--slo-requests N] [--seed N] [--out DIR]

A port-side twin of `benchmarks/fleet_trace_report.py`.  Every Table F
cell (homo / fleetopt / multipool K=3, static and autoscaled, sized at
peak by `size_to_slo_spec` against a 200 ms TTFT p99) runs again with
FleetScope at level "detail" (`serving.telemetry.TraceRecorder`), and the
answers are read off the recorded timeline:

  * energy by phase (decode / prefill / idle / handoff / dispatch) per
    cell from the trace's charge channel, gated (`gate`) to reconcile with
    the meters' lifetime totals within 0.1% per phase;
  * the peak window (envelope >= 90% of peak): its tok/W and latency
    percentiles (an empty window renders "no data");
  * the autoscaler's ramp lag: after the overnight trough, when the
    online-instance count re-crossed 70% of its swing minus when demand
    did (positive: capacity trails demand; negative: scale-down hysteresis
    kept capacity online through the trough).

`--quick` is the H100 cells at the quick diurnal configuration (peak 250
req/s, a 240 s day, 1500 sizing requests); without it, both generations at
the full one (500 req/s, 480 s, 3000).  Writes, under DIR (default
build/port_trace_report/): `fleet_trace_report.md`, `fleet_trace_report.json`
(rows and every cell's timeline, core.timeline's schema) and
`perfetto.json` (the first cell's Chrome trace-event document, viewable at
ui.perfetto.dev).  Exits 1 when a cell does not reconcile.

The fleets drain in the numpy engine on the host.  Table F is
autoscaled, and the compiled drain (`engine="graph"`) refuses per-row
online windows (serving.graph_engine's "Not supported"), so numpy is the
only engine these cells have; no cell touches a device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np

from repro_torch.core.slo import SLOSpec, size_to_slo_spec
from repro_torch.core.workloads import AZURE, DiurnalProfile
from repro_torch.serving import (TraceRecorder, build_timeline,
                                 prepare_spec, reconcile_energy, to_perfetto)
from repro_torch.serving.request import (latency_percentiles_arrays,
                                         sample_diurnal_trace)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from port_fleet_bench import (DIURNAL_GENERATIONS, PEAK_FRAC,  # noqa: E402
                              SLO_KW, diurnal_spec)

ROOT = Path(__file__).resolve().parents[1]
N_BINS = 48                  # timeline grid per cell
RAMP_FRAC = 0.7              # demand / actuation crossing threshold
RECONCILE_RTOL = 1e-3        # <0.1% per phase per cell (hard gate)
PHASE_COLS = ("decode", "prefill", "idle", "handoff", "dispatch")
QUICK = dict(peak_rate=250.0, day_s=240.0, slo_requests=1500)
FULL = dict(peak_rate=500.0, day_s=480.0, slo_requests=3000)


def _fmt(v, nd=3) -> str:
    """Numbers for the markdown table; NaN renders honestly."""
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return "no data"
    return f"{v:.{nd}f}"


def _first_crossing(centers: np.ndarray, curve: np.ndarray,
                    frac: float, after: float = 0.0) -> float:
    """First bin center >= `after` where `curve` reaches
    lo + frac * (hi - lo) of its whole-day swing; NaN when the curve never
    swings (static provisioning) or never crosses again."""
    lo, hi = float(curve.min()), float(curve.max())
    if hi <= lo:
        return float("nan")
    idx = np.flatnonzero((curve >= lo + frac * (hi - lo))
                         & (centers >= after))
    return float(centers[idx[0]]) if len(idx) else float("nan")


def _peak_window_stats(sim, mask_fn) -> dict:
    """Latency percentiles over requests that arrived inside the peak
    envelope window, from the per-pool summary columns."""
    arrival = np.concatenate([s.arrival for s in sim.summaries.values()])
    first = np.concatenate([s.first_token for s in sim.summaries.values()])
    finish = np.concatenate([s.finish for s in sim.summaries.values()])
    ngen = np.concatenate([s.n_generated for s in sim.summaries.values()]) \
        if sim.summaries else np.empty(0, np.int64)
    m = mask_fn(arrival)
    return latency_percentiles_arrays(arrival[m], first[m], finish[m],
                                      ngen[m], strict_keys=True)


def run_cell(gen: str, prof, kind: str, provisioning: str, *,
             peak_rate: float, day_s: float, slo_requests: int,
             seed: int, sized_cache: dict):
    """One traced Table F cell -> (row, timeline, recorder, sim)."""
    dprof = DiurnalProfile(peak_rate=peak_rate, day_s=day_s)
    wl = dataclasses.replace(AZURE, arrival_rate=peak_rate)
    spec = diurnal_spec(kind, prof, day_s)
    key = (gen, kind)
    if key not in sized_cache:
        sized_cache[key] = size_to_slo_spec(
            spec, wl, slo=SLOSpec(ttft_p99_s=0.2),
            n_requests=slo_requests, seed=seed)
    res = sized_cache[key]
    trace = sample_diurnal_trace(wl, dprof, day_s, seed=seed,
                                 max_total=spec.max_window)
    rec = TraceRecorder(level="detail")
    sim, reqs, plan = prepare_spec(
        spec, wl, seed=seed, trace=trace, pool_overrides=res.overrides,
        autoscale=provisioning == "autoscaled", telemetry=rec)
    rep = sim.run(reqs, warmup_frac=0.0)

    # the gate's input: the trace's energy against the meters'
    banks = [g.engine.bank for g in sim.groups.values()]
    rc = reconcile_energy(rec, banks)
    max_rel = max(d["rel_err"] for d in rc.values())

    # engine names key the recorder's pools; schedules are keyed by role
    scheds = {sim.groups[role].engine.name: s
              for role, s in sim.schedules.items()}
    tl = build_timeline(rec, n_bins=N_BINS, schedules=scheds or None)
    centers = tl.centers
    rate = dprof.rate_at(centers)
    online = tl.fleet("online")
    # the day starts provisioned (sized at peak), so both crossings are
    # taken after the overnight trough
    t_trough = float(centers[int(np.argmin(rate))])
    t_demand = _first_crossing(centers, rate, RAMP_FRAC, after=t_trough)
    t_actuate = _first_crossing(centers, online, RAMP_FRAC,
                                after=t_trough)
    ramp_lag = t_actuate - t_demand \
        if math.isfinite(t_demand) and math.isfinite(t_actuate) \
        else float("nan")

    peak_bins = rate >= PEAK_FRAC * dprof.peak_rate
    tok_bins = tl.fleet("tokens")
    j_bins = tl.fleet("joules")
    pk_tok, pk_j = float(tok_bins[peak_bins].sum()), \
        float(j_bins[peak_bins].sum())
    peak_lat = _peak_window_stats(
        sim, lambda a: (dprof.rate_at(a) >= PEAK_FRAC * dprof.peak_rate))

    phases = rec.energy_by_phase()
    total = phases["total"] or 1.0
    f = rep["fleet"]
    row = dict(
        table="trace_report", generation=gen, workload=wl.name,
        topology=kind, provisioning=provisioning,
        peak_rate=peak_rate, day_s=day_s,
        tok_per_watt=f["tok_per_watt"],
        reconcile_max_rel_err=max_rel,
        **{f"{p}_j": round(phases[p], 1) for p in PHASE_COLS},
        **{f"{p}_frac": round(phases[p] / total, 4) for p in PHASE_COLS},
        ramp_lag_s=ramp_lag,
        peak_tok_per_watt=(pk_tok / pk_j) if pk_j else float("nan"),
        peak_ttft_p99_s=peak_lat["ttft_p99_s"],
        peak_tpot_p99_ms=peak_lat["tpot_p99_ms"],
        n_events=len(rec.events),
        instances_peak=plan.instances)
    return row, tl, rec, sim


def run(peak_rate: float = 250.0, day_s: float = 240.0,
        slo_requests: int = 1500, seed: int = 0, quick: bool = True):
    """(rows, derived, timelines, first_cell_recorder)."""
    gens = DIURNAL_GENERATIONS[:1] if quick else DIURNAL_GENERATIONS
    sized: dict = {}
    rows, timelines = [], {}
    first_rec = None
    for gen, prof in gens:
        for kind in SLO_KW:
            for provisioning in ("static", "autoscaled"):
                row, tl, rec, _ = run_cell(
                    gen, prof, kind, provisioning, peak_rate=peak_rate,
                    day_s=day_s, slo_requests=slo_requests, seed=seed,
                    sized_cache=sized)
                rows.append(row)
                timelines[f"{gen}/{kind}/{provisioning}"] = tl
                if first_rec is None:
                    first_rec = rec
    worst = max(r["reconcile_max_rel_err"] for r in rows)
    lags = [r["ramp_lag_s"] for r in rows
            if r["provisioning"] == "autoscaled"
            and math.isfinite(r["ramp_lag_s"])]
    derived = (f"worst phase-energy reconciliation over "
               f"{len(rows)} cells = {worst:.2e} (gate {RECONCILE_RTOL:g})"
               + (f"; autoscaler ramp lag "
                  f"{min(lags):.1f}-{max(lags):.1f}s" if lags else ""))
    return rows, derived, timelines, first_rec


def gate(rows) -> list:
    """Acceptance failures (empty = green)."""
    return [f"{r['generation']}/{r['topology']}/{r['provisioning']}: "
            f"trace energy does not reconcile with the meters "
            f"(rel err {r['reconcile_max_rel_err']:.2e} >= "
            f"{RECONCILE_RTOL:g})"
            for r in rows if r["reconcile_max_rel_err"] >= RECONCILE_RTOL]


def render_markdown(rows, timelines) -> str:
    out = ["# FleetScope trace report: the diurnal day, by phase\n"]
    hdr = ("| cell | tok/W | decode | prefill | idle | handoff | "
           "dispatch | ramp lag (s) | peak tok/W | peak TTFT p99 (s) |")
    out += [hdr, "|" + "---|" * 10]
    for r in rows:
        cell = f"{r['generation']}/{r['topology']}/{r['provisioning']}"
        out.append(
            f"| {cell} | {_fmt(r['tok_per_watt'])} | "
            + " | ".join(f"{100 * r[f'{p}_frac']:.1f}%"
                         for p in PHASE_COLS)
            + f" | {_fmt(r['ramp_lag_s'], 1)} |"
            f" {_fmt(r['peak_tok_per_watt'])} |"
            f" {_fmt(r['peak_ttft_p99_s'])} |")
    out.append("\nRamp lag: online-instance 70%-of-swing crossing minus "
               "demand's, after the overnight trough (negative = "
               "scale-down hysteresis kept capacity online through the "
               "trough, so the morning ramp found it already there).")
    out.append("\nPhase columns are shares of traced lifetime energy; "
               "every cell reconciles with the meter totals to "
               f"<{100 * RECONCILE_RTOL:g}% per phase "
               "(worst: "
               f"{max(r['reconcile_max_rel_err'] for r in rows):.2e}).\n")
    out.append("## Peak-window zoom (envelope >= "
               f"{int(100 * PEAK_FRAC)}% of peak)\n")
    for name, tl in timelines.items():
        tok = tl.fleet("tokens").sum()
        out.append(f"- **{name}**: {int(tok)} decode tokens over "
                   f"{tl.n_bins} bins of {tl.bin_s:.1f}s; online "
                   f"instances {tl.fleet('online').min():.0f}"
                   f"-{tl.fleet('online').max():.0f}")
    return "\n".join(out) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="H100-only cells at the quick diurnal config")
    ap.add_argument("--peak-rate", type=float, default=FULL["peak_rate"])
    ap.add_argument("--day-s", type=float, default=FULL["day_s"])
    ap.add_argument("--slo-requests", type=int, default=FULL["slo_requests"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "port_trace_report")
    args = ap.parse_args(argv)
    cfg = QUICK if args.quick else dict(
        peak_rate=args.peak_rate, day_s=args.day_s,
        slo_requests=args.slo_requests)
    rows, derived, timelines, first_rec = run(seed=args.seed,
                                              quick=args.quick, **cfg)
    args.out.mkdir(parents=True, exist_ok=True)
    md = render_markdown(rows, timelines)
    (args.out / "fleet_trace_report.md").write_text(md)
    (args.out / "fleet_trace_report.json").write_text(json.dumps(
        {"meta": dict(cfg, seed=args.seed, quick=args.quick), "rows": rows,
         "timelines": {k: tl.to_json() for k, tl in timelines.items()}},
        indent=1))
    (args.out / "perfetto.json").write_text(json.dumps(to_perfetto(first_rec)))
    print(md)
    print(derived)
    print(f"artifacts -> {args.out}")
    fails = gate(rows)
    if fails:
        print("ACCEPTANCE FAIL: " + "; ".join(fails), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
