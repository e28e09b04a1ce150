"""Inspecting a fleet run with FleetScope (DESIGN.md §14), on the PyTorch
port (`repro_torch.serving`, host numpy; it prints what
examples/inspect_run.py prints).

Traces a small FleetOpt cell at detail level, then reads everything the
recorder knows: the lifecycle event mix, the per-phase energy
decomposition reconciled against the energy meters, a fixed-grid
timeline (watts / tok/W over the run), SLO violation forensics, and a
Perfetto-viewable Chrome trace written to build/port_examples/ (or to
`out_dir`).

  PYTHONPATH=src python examples/port_inspect_run.py
"""
import json
import pathlib

import numpy as np

from repro_torch.core import AZURE, H100_LLAMA70B, SLOSpec, explain_slo
from repro_torch.core.modelspec import LLAMA31_70B
from repro_torch.core.topospec import TopologySpec
from repro_torch.serving import (TraceRecorder, build_timeline,
                                 prepare_spec, reconcile_energy, to_perfetto)

OUT_DIR = pathlib.Path(__file__).resolve().parents[1] / "build" \
    / "port_examples"


def main(out_dir=None):
    rec = TraceRecorder(level="detail")   # "lifecycle" = events only
    spec = TopologySpec.from_kind("fleetopt", H100_LLAMA70B, LLAMA31_70B,
                                  b_short=4096)
    sim, reqs, _ = prepare_spec(spec, AZURE, n_requests=600, seed=0,
                                telemetry=rec)
    report = sim.run(reqs)

    print("=== lifecycle events ===")
    print(" ", {k: v for k, v in rec.counts().items() if v})
    print(f"  fleet tok/W {report['fleet']['tok_per_watt']:.2f}, "
          f"completed {report['fleet']['completed']}")

    print("\n=== energy by phase (trace vs meters) ===")
    banks = [g.engine.bank for g in sim.groups.values()]
    for phase, row in reconcile_energy(rec, banks).items():
        print(f"  {phase:>8}: {row['meter_j']:>12.1f} J  "
              f"(rel err vs trace {row['rel_err']:.1e})")

    print("\n=== timeline: fleet watts / tok/W per bin ===")
    tl = build_timeline(rec, n_bins=12)
    watts, tpw = tl.fleet("watts"), tl.tok_per_watt()
    for b, c in enumerate(tl.centers):
        bar = "#" * int(watts[b] / max(watts.max(), 1.0) * 40)
        t = f"{tpw[b]:.2f}" if np.isfinite(tpw[b]) else "no data"
        print(f"  t={c:6.2f}s {watts[b]:>9.0f} W  tok/W {t:>8}  {bar}")

    print("\n=== SLO forensics (which pool was late, and when) ===")
    for row in explain_slo(sim, SLOSpec(ttft_p99_s=0.5)):
        print(f"  {row['role']:>16}: {row['n_late']}/{row['n_obs']} late"
              + (f", peak window {row['peak_window_s']}"
                 if row["n_late"] else ""))

    out_dir = pathlib.Path(out_dir) if out_dir is not None else OUT_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / "fleet_trace.json"
    out.write_text(json.dumps(to_perfetto(rec)))
    print(f"\nperfetto trace -> {out}  (open in ui.perfetto.dev)")


if __name__ == "__main__":
    main()
