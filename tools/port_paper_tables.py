#!/usr/bin/env python3
"""The paper's analytical tables, from the port.

  PYTHONPATH=src python3 tools/port_paper_tables.py [--only NAME] [--out DIR]

A port-side twin of the analytical suites of `benchmarks/run.py`, under
the same names: `table1_context_law` ... `table7_power_params` (Tables
1-7), `quantization_sweep`, `moe_dispatch_sensitivity` and
`per_arch_one_over_w` (`benchmarks/extra_sweeps.py`) and `beyond_paper`
(the §10.3 items).  Each suite builds its rows as the reference script
does, from `repro_torch.core` and `repro_torch.configs` only, and returns
`(rows, derived)`; the `PAPER` constants are the reference scripts'.

`--only NAME` runs the suites whose name contains NAME.  Each suite's rows
go to DIR/<name>.json (default build/port_paper_tables/), and one
`name,us_per_call,derived` CSV line is printed per suite, as
`benchmarks.run` prints it (us_per_call is the suite's host wall).  Exits
1 when a suite raises.  No suite touches a device: the analytical layer is
numpy on the host.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
import traceback
from pathlib import Path

from repro_torch.configs import get_config, list_archs
from repro_torch.core import (AGENT, AZURE, GRIDS, LMSYS, B200_LLAMA70B,
                              B200_LLAMA70B_FLEET, H100_LLAMA70B,
                              H200_LLAMA70B, V5E_LLAMA70B, Disaggregated,
                              FleetOpt, Homogeneous, TwoPool, bill,
                              computed_profile, context_sweep, fit_one_over_w,
                              gain_decomposition, speculative_tok_per_watt,
                              sweep_pool_counts)
from repro_torch.core.hardware import B200, H100, TPU_V5E
from repro_torch.core.modelspec import (DEEPSEEK_V3, LLAMA31_8B, LLAMA31_70B,
                                        LLAMA31_405B, QWEN3_235B_A22B)
from repro_torch.core.moe import dispatch_sensitivity, moe_profile
from repro_torch.core.power import (B200_POWER, H100_POWER, POWER_MODELS,
                                    TPU_V5E_POWER)
from repro_torch.core.profiles import GENERATION_PROFILES
from repro_torch.core.tokenomics import tok_per_dollar_m

ROOT = Path(__file__).resolve().parents[1]


# --- Table 1: n_max and tok/W vs context window (the 1/W law) -------------

T1_PAPER = {
    "H100-SXM5": [(2048, 512, 598, 35.0), (4096, 256, 593, 17.6),
                  (8192, 128, 583, 8.97), (16384, 64, 557, 4.69),
                  (32768, 32, 507, 2.58), (65536, 16, 435, 1.50),
                  (131072, 8, 369, 0.88)],
    "B200-SXM": [(2048, 1343, 859, 61.4), (4096, 671, 857, 30.8),
                 (8192, 335, 852, 15.5), (16384, 167, 838, 7.87),
                 (32768, 83, 805, 4.09), (65536, 41, 735, 2.24),
                 (131072, 20, 630, 1.30)],
}


def table1_context_law():
    rows = []
    worst = 0.0
    for gpu, prof in (("H100-SXM5", H100_LLAMA70B),
                      ("B200-SXM", B200_LLAMA70B)):
        sweep = context_sweep(prof)
        for r, (ctx, nm, psat, tpw) in zip(sweep, T1_PAPER[gpu]):
            delta = r.tok_per_watt / tpw - 1
            worst = max(worst, abs(delta))
            rows.append(dict(gpu=gpu, context=ctx, n_max=r.n_max,
                             n_max_paper=nm,
                             p_sat_w=round(r.p_sat_w, 0),
                             tok_per_watt=round(r.tok_per_watt, 2),
                             tok_per_watt_paper=tpw,
                             delta_pct=round(100 * delta, 1)))
    return rows, f"worst_cell_delta={100 * worst:.1f}%"


# --- Table 2: single-GPU tok/W across model families at 8K ----------------
# computed profiles throughout (replicated-KV storage, the Table-2
# convention); MoE rows use the active-parameter W (dispatch excluded)

T2_PAPER_TPW = {
    ("Llama-3.1-8B", "H100"): 6.46, ("Llama-3.1-8B", "B200"): 12.18,
    ("Llama-3.1-70B", "H100"): 7.41, ("Llama-3.1-70B", "B200"): 20.93,
    ("Llama-3.1-405B", "H100"): 0.09, ("Llama-3.1-405B", "B200"): 2.16,
    ("Qwen3-235B-A22B", "H100"): 37.82, ("Qwen3-235B-A22B", "B200"): 177.73,
    ("DeepSeek-V3", "H100"): 2.14, ("DeepSeek-V3", "B200"): 18.37,
}
T2_MODELS = [(LLAMA31_8B, 1), (LLAMA31_70B, 8), (LLAMA31_405B, 8),
             (QWEN3_235B_A22B, 8), (DEEPSEEK_V3, 8)]


def table2_model_archs():
    rows = []
    for model, tp in T2_MODELS:
        for gname, chip, pm in (("H100", H100, H100_POWER),
                                ("B200", B200, B200_POWER)):
            mk = moe_profile if model.is_moe else computed_profile
            prof = mk(model, chip, pm, tp=tp, kv_sharded=False)
            n = prof.n_max(8192)
            tpw = prof.tok_per_watt_at_window(8192)
            rows.append(dict(
                model=model.name, gpu=gname, tp=tp, n_max=n,
                tok_s=round(prof.tokens_per_s(n, 8192), 0),
                tok_per_watt=round(tpw, 2),
                tok_per_watt_paper=T2_PAPER_TPW[(model.name, gname)],
                moe_upper_bound=model.is_moe))
    # the physical §3.2 claim: the fixed-concurrency advantage in the
    # weight-stream-bound regime (the paper's 5.1x cell uses sub-idle power)
    dense = computed_profile(LLAMA31_70B, H100, H100_POWER, tp=8)
    moe = moe_profile(QWEN3_235B_A22B, H100, H100_POWER, tp=8)
    adv8 = moe.tok_per_watt(8, 8192) / dense.tok_per_watt(8, 8192)
    adv1 = moe.tokens_per_s(1, 8192) / dense.tokens_per_s(1, 8192)
    return rows, (f"qwen3_vs_70b: {adv1:.1f}x at n=1 (W-ratio bound), "
                  f"{adv8:.1f}x at n=8; collapses at n_max (KV-bound) — "
                  "paper's 5.1x cell uses sub-idle power, see EXPERIMENTS")


# --- Table 3: fleet tok/W for Homo / Pool / FleetOpt + §4.2 decomposition --

T3_PAPER = {  # (workload, gpu, topo) -> (instances, kW, tok/W)
    ("azure", "H100", "homo"): (141, 58.3, 5.58),
    ("azure", "H100", "pool"): (68, 32.0, 9.16),
    ("azure", "H100", "fleetopt"): (40, 23.1, 14.08),
    ("azure", "B200", "homo"): (47, 33.4, 9.74),
    ("azure", "B200", "pool"): (25, 19.1, 15.39),
    ("azure", "B200", "fleetopt"): (17, 13.7, 23.71),
    ("lmsys", "H100", "homo"): (69, 28.5, 4.77),
    ("lmsys", "H100", "pool"): (38, 16.4, 7.91),
    ("lmsys", "H100", "fleetopt"): (29, 12.9, 10.30),
    ("lmsys", "B200", "homo"): (24, 17.0, 7.98),
    ("lmsys", "B200", "pool"): (16, 11.7, 11.12),
    ("lmsys", "B200", "fleetopt"): (12, 9.0, 14.82),
}


def table3_fleet_topology():
    rows = []
    tpw_azure = {}
    for wname, wl, bs in (("azure", AZURE, 4096), ("lmsys", LMSYS, 1536)):
        for gname, prof in (("H100", H100_LLAMA70B),
                            ("B200", B200_LLAMA70B_FLEET)):
            reps = {
                "homo": Homogeneous().provision(wl, prof, LLAMA31_70B),
                "pool": TwoPool(b_short=bs).provision(wl, prof, LLAMA31_70B),
                "fleetopt": FleetOpt(b_short=bs, gamma=2.0).provision(
                    wl, prof, LLAMA31_70B)}
            if wname == "azure":
                tpw_azure[gname] = {t: r.tok_per_watt
                                    for t, r in reps.items()}
            for topo, rep in reps.items():
                pi, pk, pt = T3_PAPER[(wname, gname, topo)]
                rows.append(dict(
                    workload=wname, gpu=gname, topology=topo,
                    instances=rep.instances, instances_paper=pi,
                    kw=round(rep.power_kw, 1), kw_paper=pk,
                    tok_per_watt=round(rep.tok_per_watt, 2),
                    tok_per_watt_paper=pt,
                    delta_pct=round(100 * (rep.tok_per_watt / pt - 1), 0)))
    g = gain_decomposition(tpw_azure)
    return rows, (f"combined={g['combined']:.2f}x (paper 4.25) "
                  f"topo_h100={g['topo_h100']:.2f} (2.52) "
                  f"gen_homo={g['gen_homo']:.2f} (1.75)")


# --- Table 4: context-window vs semantic routing per-pool tok/W -----------

T4_PAPER = {  # pool -> (n_active, P_W, tok/W)
    "context-short-70B@8K": (109, 578, 8.77),
    "context-long-70B@64K": (14, 413, 1.52),
    "semantic-small-8B@8K": (49, 506, 6.24),
    "semantic-large-70B@64K": (14, 413, 1.52),
}
T4_RHO = 0.85


def table4_semantic_routing():
    prof8b = computed_profile(LLAMA31_8B, H100, H100_POWER, tp=1)
    pools = [
        ("context-short-70B@8K", H100_LLAMA70B, 8192),
        ("context-long-70B@64K", H100_LLAMA70B, 65536),
        ("semantic-small-8B@8K", prof8b, 8192),
        ("semantic-large-70B@64K", H100_LLAMA70B, 65536),
    ]
    rows = []
    for name, prof, window in pools:
        n_act = T4_RHO * prof.n_max(window)
        p = prof.power_w(n_act)
        tpw = prof.tok_per_watt(n_act, window)
        pn, pp, pt = T4_PAPER[name]
        rows.append(dict(pool=name, n_active=round(n_act, 0),
                         n_active_paper=pn,
                         power_w=round(p, 0), power_w_paper=pp,
                         tok_per_watt=round(tpw, 2),
                         tok_per_watt_paper=pt,
                         delta_pct=round(100 * (tpw / pt - 1), 0)))
    long_tie = abs(rows[1]["tok_per_watt"] - rows[3]["tok_per_watt"]) < 1e-9
    return rows, f"long_pool_tie={long_tie} (paper: both 1.52)"


# --- Table 5: GPU generations (70B @ 8K) + tok/$M --------------------------

T5_PAPER = {  # gpu -> (n_max@8K, tok/W, tok/$M)
    "H100-SXM5": (22, 7.41, 0.30), "H200-SXM": (44, 15.58, 0.49),
    "B200-SXM": (58, 20.93, 0.73), "GB200-NVL": (65, 18.49, 0.63),
}


def table5_gpu_generations():
    rows = []
    for name, prof in GENERATION_PROFILES.items():
        tpw = prof.tok_per_watt_at_window(8192)
        row = dict(gpu=name, tdp_w=prof.chip.tdp_w,
                   p_idle_w=prof.power_model.p_idle_w,
                   w_ms=round(prof.roofline.w_ms, 2),
                   n_max_8k=prof.n_max(8192),
                   tok_per_watt=round(tpw, 2),
                   tok_per_dollar_m=round(tok_per_dollar_m(prof, 8192), 2))
        if name in T5_PAPER:
            row["tok_per_watt_paper"] = T5_PAPER[name][1]
        rows.append(row)
    tpw = {r["gpu"]: r["tok_per_watt"] for r in rows}
    order_ok = (tpw["B200-SXM"] > tpw["H200-SXM"] > tpw["H100-SXM5"]
                and tpw["GB200-NVL"] < tpw["B200-SXM"])
    return rows, f"paper_ordering_reproduced={order_ok} (incl. GB200 dip)"


# --- Table 6: recommendation by workload archetype ------------------------

T6_GPUS = {"H100": H100_LLAMA70B, "H200": H200_LLAMA70B,
           "B200": B200_LLAMA70B_FLEET}


def table6_archetypes():
    rows = []
    for wl, bs in ((AZURE, 4096), (LMSYS, 1536), (AGENT, 8192)):
        best = (None, None, -1.0)
        for gname, prof in T6_GPUS.items():
            for tname, topo in (("homo", Homogeneous()),
                                ("pool", TwoPool(b_short=bs)),
                                ("fleetopt", FleetOpt(b_short=bs,
                                                      gamma=2.0))):
                rep = topo.provision(wl, prof, LLAMA31_70B)
                if rep.tok_per_watt > best[2]:
                    best = (tname, gname, rep.tok_per_watt)
        frac8k = wl.frac_total_leq(8192)
        archetype = ("short-dominant" if frac8k > 0.8 else
                     "mixed" if frac8k > 0.5 else "long-dominant")
        rows.append(dict(workload=wl.name, frac_leq_8k=round(frac8k, 2),
                         archetype=archetype, best_topology=best[0],
                         best_gpu=best[1],
                         best_tok_per_watt=round(best[2], 2)))
    ok = all(r["best_gpu"] == "B200" for r in rows)
    return rows, f"b200_best_everywhere={ok} (paper Table 6 agrees)"


# --- Table 7 (Appendix A): power model parameters -------------------------

T7_PAPER = {  # gpu -> (tdp, p_idle, p_nom, k, x0)
    "H100-SXM5": (700, 300, 600, 1.0, 4.2),
    "H200-SXM": (700, 300, 600, 1.0, 5.5),
    "B200-SXM": (1000, 430, 860, 1.0, 6.8),
    "GB200-NVL": (1200, 516, 1032, 1.0, 6.8),
}


def table7_power_params():
    rows = []
    for name, pm in POWER_MODELS.items():
        row = dict(gpu=name, p_idle_w=pm.p_idle_w, p_nom_w=pm.p_nom_w,
                   k=pm.k, x0=pm.x0, quality=pm.quality)
        if name in T7_PAPER:
            row["x0_paper"] = T7_PAPER[name][4]
        prof = GENERATION_PROFILES.get(name)
        if prof:
            # Appendix A footnote: x0 = log2(W / H0)
            row["x0_from_roofline"] = round(
                math.log2(prof.roofline.w_ms / prof.roofline.h0_ms), 2)
        rows.append(row)
    return rows, ("B200 x0: Table-1-consistent 4.45 used; Appendix-A lists "
                  "6.8 (paper-internal inconsistency, see EXPERIMENTS.md)")


# --- extra sweeps: §5.2 quantization, §3.2 dispatch, per-arch 1/W law ------

def quantization_sweep():
    rows = []
    for label, b in (("fp16", 2.0), ("fp8", 1.0), ("int4", 0.5)):
        m = dataclasses.replace(LLAMA31_70B, dtype_bytes=b)
        prof = computed_profile(m, H100, H100_POWER, tp=8)
        rows.append(dict(quant=label, w_ms=round(prof.roofline.w_ms, 2),
                         n_max_8k=prof.n_max(8192),
                         tok_per_watt_8k=round(
                             prof.tok_per_watt_at_window(8192), 2)))
    # int8 KV cache (weights fp16): kappa/2 -> n_max x2, worth one
    # context doubling on the 1/W curve
    base = computed_profile(LLAMA31_70B, H100, H100_POWER, tp=8)
    kv8 = computed_profile(LLAMA31_70B, H100, H100_POWER, tp=8,
                           kv_overhead=0.67)  # 1.34 * (1/2)
    for w in (8192, 65536):
        rows.append(dict(quant="int8-kv", window=w,
                         n_max=kv8.n_max(w), n_max_fp16=base.n_max(w),
                         tok_per_watt=round(kv8.tok_per_watt_at_window(w), 2),
                         tok_per_watt_fp16=round(
                             base.tok_per_watt_at_window(w), 2)))
    d = rows[1]["tok_per_watt_8k"] / rows[0]["tok_per_watt_8k"]
    kvgain = rows[-1]["tok_per_watt"] / rows[-1]["tok_per_watt_fp16"]
    return rows, (f"fp8_gain={d:.2f}x (paper: ~2x); int8-KV at 64K: "
                  f"{kvgain:.2f}x (~ one GPU generation, for free)")


def moe_dispatch_sensitivity():
    pts = dispatch_sensitivity(QWEN3_235B_A22B, LLAMA31_70B, H100,
                               H100_POWER)
    rows = [dict(dispatch_ms=p.dispatch_ms,
                 tok_per_watt=round(p.tok_per_watt, 2),
                 advantage=round(p.advantage_vs_dense, 2)) for p in pts]
    return rows, (f"advantage {rows[0]['advantage']}x -> "
                  f"{rows[-1]['advantage']}x at 20ms dispatch")


def per_arch_one_over_w():
    """The 1/W law for every architecture of `configs`, on the paper's H100
    and on the TPU v5e profile."""
    rows = []
    for arch in list_archs():
        spec = get_config(arch).analytical_spec()
        for chip, pm, tp in ((H100, H100_POWER, 8),
                             (TPU_V5E, TPU_V5E_POWER, 16)):
            prof = computed_profile(spec, chip, pm, tp=tp)
            if spec.n_kv_heads == 0:
                rows.append(dict(arch=arch, chip=chip.name, law="exempt",
                                 slope=0.0,
                                 note="attention-free: no KV ceiling"))
                continue
            fit = fit_one_over_w(prof,
                                 contexts=(2048, 4096, 8192, 16384, 32768))
            rows.append(dict(arch=arch, chip=chip.name,
                             slope=round(fit.slope, 2),
                             tpw_4k=round(
                                 prof.tok_per_watt_at_window(4096), 2),
                             tpw_32k=round(
                                 prof.tok_per_watt_at_window(32768), 2),
                             law="holds" if fit.slope < -0.8 else "weakened"))
    return rows, "1/W law: holds for attention archs, weakened for hybrid, exempt for SSM"


# --- beyond the paper: every §10.3 future-work item, quantified ------------

def beyond_paper():
    rows = []
    for wl in (AZURE, AGENT):
        for k, tpw in sweep_pool_counts(wl, H100_LLAMA70B, LLAMA31_70B):
            rows.append(dict(kind="multipool", workload=wl.name, pools=k,
                             tok_per_watt=round(tpw, 2)))
    reps = {"homo": Homogeneous().provision(AZURE, H100_LLAMA70B,
                                            LLAMA31_70B),
            "fleetopt": FleetOpt(b_short=4096, gamma=2.0).provision(
                AZURE, H100_LLAMA70B, LLAMA31_70B)}
    for grid_name, grid in GRIDS.items():
        for topo, rep in reps.items():
            b = bill(rep, grid)
            rows.append(dict(kind="carbon", grid=grid_name, topology=topo,
                             g_co2_per_mtok=round(b.g_co2_per_mtok, 1),
                             usd_per_mtok=round(b.usd_total_per_mtok, 2)))
    rows.append(dict(kind="tpu-v5e", profile=V5E_LLAMA70B.name,
                     tpw_8k=round(V5E_LLAMA70B.tok_per_watt_at_window(8192),
                                  2)))
    # prefill-decode disaggregation loses on output tok/W
    fo = reps["fleetopt"]
    dis = Disaggregated(b_short=4096, gamma=2.0).provision(
        AZURE, H100_LLAMA70B, LLAMA31_70B)
    rows.append(dict(kind="disagg", interleaved_tpw=round(fo.tok_per_watt, 2),
                     disagg_tpw=round(dis.tok_per_watt, 2),
                     note="dedicated prefill fleet burns P_nom watts that "
                          "interleaving absorbed"))
    draft = computed_profile(LLAMA31_8B, H100, H100_POWER, tp=1)
    for a, L in ((0.8, 4), (0.5, 8)):
        sp = speculative_tok_per_watt(H100_LLAMA70B, draft, accept_rate=a,
                                      speculation_len=L)
        rows.append(dict(kind="speculative", accept=a, spec_len=L,
                         tok_per_watt=round(sp.tok_per_watt, 2),
                         speedup=round(sp.speedup_vs_plain, 2)))
    k_tpw = {r["pools"]: r["tok_per_watt"] for r in rows
             if r.get("workload") == "agent-heavy"}
    return rows, (f"agent-heavy: K=1..5 pools -> "
                  f"{[k_tpw.get(k) for k in (1, 2, 3, 4, 5)]} tok/W "
                  "(finer topologies compound, with diminishing returns)")


SUITES = {
    "table1_context_law": table1_context_law,
    "table2_model_archs": table2_model_archs,
    "table3_fleet_topology": table3_fleet_topology,
    "table4_semantic_routing": table4_semantic_routing,
    "table5_gpu_generations": table5_gpu_generations,
    "table6_archetypes": table6_archetypes,
    "table7_power_params": table7_power_params,
    "quantization_sweep": quantization_sweep,
    "moe_dispatch_sensitivity": moe_dispatch_sensitivity,
    "per_arch_one_over_w": per_arch_one_over_w,
    "beyond_paper": beyond_paper,
}


def run_suites(only=None, out=None):
    """Run the suites whose name contains `only` (all by default): yields
    (name, rows, derived, us) per suite, or (name, None, error, None)
    when one raises (its traceback printed to stderr).  Rows are written
    to `out`/<name>.json if given."""
    for name, fn in SUITES.items():
        if only and only not in name:
            continue
        t0 = time.perf_counter()
        try:
            rows, derived = fn()
        except Exception as e:  # reported, and the exit code says so
            traceback.print_exc()
            yield name, None, f"{type(e).__name__}: {e}", None
            continue
        us = (time.perf_counter() - t0) * 1e6
        if out is not None:
            (out / f"{name}.json").write_text(json.dumps(rows, indent=1))
        yield name, rows, derived, us


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=None)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "port_paper_tables")
    args = ap.parse_args(argv)
    args.out.mkdir(parents=True, exist_ok=True)
    print("name,us_per_call,derived")
    failed = []
    for name, rows, derived, us in run_suites(args.only, args.out):
        if rows is None:
            failed.append(name)
            print(f"{name},ERROR,{derived}")
            continue
        print(f'{name},{us:.1f},"{derived}"')
    if failed:
        print(f"FAILED: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
