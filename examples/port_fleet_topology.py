"""Fleet topology design space (paper Tables 3-6) + measured cross-check,
on the PyTorch port (`repro_torch.core` / `repro_torch.serving`, host
numpy engines; it prints what examples/fleet_topology.py prints).

Evaluates Homo / Pool / FleetOpt on H100 & B200 over all three workload
archetypes, decomposes topology x generation gains (§4.2), compares
semantic vs context routing (§5.1), closes the loop with the event-driven
fleet simulator measuring the Azure topologies end-to-end (serving
.fleetsim) against the closed-form sizing that provisioned them — now
including §10.3 prefill/decode disaggregation with its KV-handoff hop and
the model-heterogeneous topologies (§5.1 semantic 8B/70B routing with
misroutes + escalation, §3.2 MoE active-parameter pools with the expert
dispatch floor) — and ends with the SLO-constrained sizing loop
(core.slo): the fleets re-provisioned until their *measured* TTFT p99
actually meets the paper's 500 ms target (then trimmed back down to the
compliance frontier), including a K = 3 multipool ladder and a
disaggregated fleet whose prefill/decode sides re-provision
independently (§10.3) — and closes with the declarative topology IR
(DESIGN.md §12): a custom mixed-generation spec built by hand from raw
PoolSpecs and an optimize_topology search over the spec space on Azure —
and finally a compressed diurnal day (DESIGN.md §13): the same
SLO-sized fleet serving an Azure-style day/night envelope static vs
autoscaled, whole-day tok/W measured with every scale-up lag, weight
load and warm spare charged.

  PYTHONPATH=src python examples/port_fleet_topology.py [--sim-requests N]
"""
from repro_torch.core import (AGENT, AZURE, LMSYS, B200_LLAMA70B_FLEET,
                              H100_LLAMA70B, FleetOpt, Homogeneous, Semantic,
                              TwoPool, computed_profile, gain_decomposition,
                              ladder_windows, optimize_gamma, size_to_slo)
from repro_torch.core.hardware import H100
from repro_torch.core.modelspec import LLAMA31_8B, LLAMA31_70B
from repro_torch.core.power import H100_POWER


def simulated_crosscheck(n_requests: int = 4000) -> None:
    """Measure the Azure topologies by actually running the fleet."""
    from repro_torch.serving import simulate_topology

    print(f"\n=== measured (fleet simulator, {n_requests} requests) ===")
    sim_tpw = {}
    for kind in ("homo", "two_pool", "fleetopt"):
        cell = simulate_topology(kind, AZURE, H100_LLAMA70B, LLAMA31_70B,
                                 b_short=4096, n_requests=n_requests)
        f = cell.report["fleet"]
        sim_tpw[kind] = cell.sim_decode_tok_per_watt
        print(f"  {kind:9s} analytical {cell.analytical_tok_per_watt:5.2f}"
              f" | simulated {cell.sim_decode_tok_per_watt:5.2f} tok/W"
              f" ({cell.delta_pct:+.1f}%)"
              f" | all-in {cell.sim_tok_per_watt:5.2f}"
              f" | TTFT p99 {f.get('ttft_p99_s', 0.0):.2f}s"
              f" | {f['migrations']} migrations")
    print(f"  measured fleetopt/homo gain: "
          f"{sim_tpw['fleetopt'] / sim_tpw['homo']:.2f}x")


def disaggregated_serving(n_requests: int = 4000) -> None:
    """§10.3 Splitwise: prefill/decode disaggregation served end-to-end —
    dedicated prefill pools, the KV-handoff hop over the interconnect,
    decode pools with zero prefill interference."""
    from repro_torch.serving import simulate_topology

    print(f"\n=== disaggregated prefill/decode (Azure, H100, "
          f"{n_requests} requests) ===")
    for kind in ("disagg", "disagg_fleetopt"):
        cell = simulate_topology(kind, AZURE, H100_LLAMA70B, LLAMA31_70B,
                                 b_short=4096, n_requests=n_requests)
        f = cell.report["fleet"]
        print(f"  {kind:15s} analytical fleet "
              f"{cell.analytical_fleet_tok_per_watt:5.2f}"
              f" / decode-only {cell.analytical_tok_per_watt:5.2f}"
              f" | measured decode {cell.sim_decode_tok_per_watt:5.2f}"
              f" ({cell.delta_pct:+.1f}%) all-in {cell.sim_tok_per_watt:5.2f}"
              f"\n{'':17s} TTFT p99 {f.get('ttft_p99_s', 0.0):.3f}s"
              f" | {f['handoffs']} KV handoffs moved {f['kv_handoff_gb']:.1f}"
              f" GB costing {f['kv_handoff_joules']:.1f} J"
              f" ({100 * f['kv_handoff_energy_frac']:.3f}% of fleet energy)")


def model_heterogeneous_serving(n_requests: int = 4000) -> None:
    """§5.1 semantic routing and §3.2 MoE pools served end-to-end: every
    pool binds its own (model, profile) through the ModelProfileRegistry,
    the semantic classifier misroutes at a configurable rate (detected
    misroutes escalate to the large model and are re-served from
    scratch), and the MoE pool streams active params under an expert
    dispatch floor."""
    from repro_torch.core.modelspec import QWEN3_235B_A22B
    from repro_torch.core.moe import moe_profile
    from repro_torch.serving import simulate_topology

    print(f"\n=== model-heterogeneous serving (Azure, H100, "
          f"{n_requests} requests) ===")
    for kind, kw in (("semantic", {}),
                     ("semantic_fleetopt", dict(misroute_rate=0.1))):
        cell = simulate_topology(kind, AZURE, H100_LLAMA70B, LLAMA31_70B,
                                 b_short=4096, n_requests=n_requests, **kw)
        f = cell.report["fleet"]
        print(f"  {kind:17s} mr={kw.get('misroute_rate', 0.0):4.2f}"
              f" | analytical {cell.analytical_tok_per_watt:5.2f}"
              f" | measured {cell.sim_decode_tok_per_watt:5.2f} tok/W"
              f" ({cell.delta_pct:+.1f}%) all-in {cell.sim_tok_per_watt:5.2f}"
              f" | {f['escalations']} escalations,"
              f" {f['migrations']} migrations")
    moe_prof = moe_profile(QWEN3_235B_A22B, H100, H100_POWER, tp=8)
    for d in (0.0, 10.0):
        cell = simulate_topology("moe_pool", AZURE, moe_prof,
                                 QWEN3_235B_A22B, n_requests=n_requests,
                                 dispatch_ms=d)
        f = cell.report["fleet"]
        print(f"  moe_pool          d={d:4.0f}ms"
              f" | analytical {cell.analytical_tok_per_watt:5.2f}"
              f" | measured {cell.sim_decode_tok_per_watt:5.2f} tok/W"
              f" ({cell.delta_pct:+.1f}%) all-in {cell.sim_tok_per_watt:5.2f}"
              f" | dispatch = {100 * f['moe_dispatch_energy_frac']:.1f}%"
              f" of fleet energy")


def slo_constrained_sizing(n_requests: int = 2000) -> None:
    """Fix the TTFT-SLO violation: re-provision until the measured p99
    complies, and report the tok/W price of compliance."""
    print(f"\n=== SLO-constrained sizing (P99 TTFT <= 500 ms, "
          f"{n_requests} requests) ===")
    cells = (("H100", H100_LLAMA70B, "fleetopt",
              dict(b_short=4096)),
             ("H100", H100_LLAMA70B, "multipool",
              dict(windows=ladder_windows(3))),
             ("H100", H100_LLAMA70B, "disagg_fleetopt",
              dict(b_short=4096)),
             ("B200", B200_LLAMA70B_FLEET, "fleetopt",
              dict(b_short=4096)))
    for gen, prof, kind, kw in cells:
        res = size_to_slo(kind, AZURE, prof, LLAMA31_70B,
                          n_requests=n_requests, **kw)
        cal = ", ".join(f"{r}={v:.2f}"
                        for r, v in res.calibrated_prefill_mfu.items())
        print(f"  {gen} {kind:9s} Eq.4 {res.unconstrained.tok_per_watt:5.2f}"
              f" -> SLO-feasible {res.slo_tok_per_watt:5.2f} tok/W"
              f" (cost {res.compliance_cost_pct:+.1f}%,"
              f" +{res.instances_added} inst,"
              f" {len(res.rounds)} rounds)"
              f" | measured TTFT p99 {res.ttft_p99_s:.3f}s"
              + (f" | calibrated prefill MFU: {cal}" if cal else ""))


def declarative_topology_ir(n_requests: int = 2000) -> None:
    """§12: topologies as data.  Build a custom 3-rung spec by hand from
    raw PoolSpecs (no kind string exists for it — a B200 terminal rung
    behind two H100 short rungs), measure it end-to-end, then let
    optimize_topology search the spec space on Azure."""
    from repro_torch.core import SLOSpec, optimize_topology
    from repro_torch.core.topospec import PoolSpec, TopologySpec
    from repro_torch.serving import simulate_spec

    print(f"\n=== declarative topology IR + search (Azure, "
          f"{n_requests} requests) ===")
    # hand-built: admit<=4K on H100, <=16K on H100, rest on B200 —
    # a mixed-generation ladder no legacy kind can express
    spec = TopologySpec(
        kind="custom", label="H100[4K,16K]+B200[64K]",
        pools=(
            PoolSpec(role="short", window=4096, profile=H100_LLAMA70B,
                     admit=4096.0, evict_on_overflow=True,
                     overflow_to="mid"),
            PoolSpec(role="mid", window=16384, profile=H100_LLAMA70B,
                     admit=16384.0, evict_on_overflow=True,
                     overflow_to="long"),
            PoolSpec(role="long", window=65536,
                     profile=B200_LLAMA70B_FLEET, admit=float("inf")),
        ),
        models={"default": LLAMA31_70B})
    cell = simulate_spec(spec, AZURE, n_requests=n_requests, seed=0)
    print(f"  {spec.label:28s} analytical {cell.analytical_tok_per_watt:5.2f}"
          f" | measured {cell.sim_decode_tok_per_watt:5.2f} tok/W"
          f" ({cell.delta_pct:+.1f}%)")
    # search: highest measured-SLO-compliant tok/W over (windows, gamma,
    # per-rung chip, small-model rung, disagg) — seeded at the hand-built
    # multipool K=3 incumbent, so the result can only tie or beat it
    res = optimize_topology(
        AZURE, H100_LLAMA70B, LLAMA31_70B, slo=SLOSpec(),
        chips={"H100": H100_LLAMA70B, "B200": B200_LLAMA70B_FLEET},
        small_model=LLAMA31_8B, n_requests=n_requests, seed=0, budget=12)
    print(f"  searched: {res.best_spec.label}"
          f" -> {res.best_score:.2f} SLO-compliant tok/W"
          f" ({res.evaluations} evaluations, {res.restarts} restarts,"
          f" TTFT p99 {res.best_result.ttft_p99_s:.3f}s)")


def diurnal_autoscaling(peak_rate: float = 150.0, day_s: float = 160.0):
    """A compressed diurnal day, static vs autoscaled (DESIGN.md §13)."""
    import dataclasses

    from repro_torch.core import AutoscalePolicy, TopologySpec
    from repro_torch.core.workloads import DiurnalProfile
    from repro_torch.serving import prepare_spec, sample_diurnal_trace

    print(f"\n=== diurnal day (peak {peak_rate:g}/s compressed into "
          f"{day_s:g}s), static vs autoscaled ===")
    dprof = DiurnalProfile(peak_rate=peak_rate, day_s=day_s)
    wl = dataclasses.replace(AZURE, arrival_rate=peak_rate)
    pol = AutoscalePolicy(control_interval_s=day_s / 40.0,
                          target_utilization=0.7,
                          scaleup_lag_s=day_s / 120.0,
                          scaledown_delay_s=day_s / 13.0, min_frac=0.2,
                          spare_instances=0)
    spec = dataclasses.replace(
        TopologySpec.from_kind("fleetopt", H100_LLAMA70B, LLAMA31_70B,
                               b_short=4096), autoscale=pol)
    trace = sample_diurnal_trace(wl, dprof, day_s, seed=0,
                                 max_total=spec.max_window)
    for autoscale in (False, True):
        sim, reqs, plan = prepare_spec(spec, wl, seed=0, trace=trace,
                                       autoscale=autoscale)
        f = sim.run(reqs, warmup_frac=0.0)["fleet"]
        mode = "autoscaled" if autoscale else "static    "
        online = ""
        if sim.schedules:
            avg = sum(s.online_instance_seconds(0.0, sim._window[1])
                      for s in sim.schedules.values()) / sim._window[1]
            online = f", avg {avg:.1f}/{plan.instances} instances online"
        print(f"  {mode}: {f['tok_per_watt']:5.2f} tok/W whole-day "
              f"(idle {100 * f['idle_energy_frac']:.0f}% of energy, "
              f"{f['completed']} completed{online})")


def main(sim_requests: int = 4000):
    tpw = {}
    print("=== Table 3: fleet tok/W ===")
    for wl, bs in ((AZURE, 4096), (LMSYS, 1536), (AGENT, 8192)):
        for gname, prof in (("H100", H100_LLAMA70B),
                            ("B200", B200_LLAMA70B_FLEET)):
            row = {}
            for tname, topo in (
                    ("homo", Homogeneous()), ("pool", TwoPool(b_short=bs)),
                    ("fleetopt", FleetOpt(b_short=bs, gamma=2.0))):
                rep = topo.provision(wl, prof, LLAMA31_70B)
                row[tname] = rep
            if wl is AZURE:
                tpw[gname] = {t: r.tok_per_watt for t, r in row.items()}
            cells = " | ".join(
                f"{t}: {r.instances:>3} inst {r.tok_per_watt:5.2f} tok/W"
                for t, r in row.items())
            print(f"{wl.name:12s} {gname}: {cells}")

    print("\n=== §4.2 gain decomposition (Azure) ===")
    for k, v in gain_decomposition(tpw).items():
        print(f"  {k:20s} {v:.2f}")

    print("\n=== gamma* optimization ===")
    g, rep = optimize_gamma(AZURE, H100_LLAMA70B, LLAMA31_70B, 4096)
    print(f"  gamma* = {g}, fleet tok/W = {rep.tok_per_watt:.2f} "
          f"(paper: gamma* = 2)")

    print("\n=== §5.1 semantic vs context routing (analytical) ===")
    prof8b = computed_profile(LLAMA31_8B, H100, H100_POWER, tp=1)
    sem = Semantic(b_short=4096, small_profile=prof8b,
                   small_model=LLAMA31_8B).provision(
        AZURE, H100_LLAMA70B, LLAMA31_70B)
    ctx = FleetOpt(b_short=4096, gamma=2.0).provision(
        AZURE, H100_LLAMA70B, LLAMA31_70B)
    print(f"  context routing : {ctx.tok_per_watt:.2f} tok/W "
          f"({ctx.instances} instances)")
    print(f"  semantic routing: {sem.tok_per_watt:.2f} tok/W "
          f"({sem.instances} instances; the 8B answers must be good "
          f"enough — §5.1's quality caveat, priced via misroute_rate)")

    simulated_crosscheck(n_requests=sim_requests)
    disaggregated_serving(n_requests=sim_requests)
    model_heterogeneous_serving(n_requests=sim_requests)
    slo_constrained_sizing(n_requests=max(sim_requests // 2, 1000))
    declarative_topology_ir(n_requests=max(sim_requests // 2, 1000))
    diurnal_autoscaling()


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--sim-requests", type=int, default=4000)
    main(sim_requests=ap.parse_args().sim_requests)
