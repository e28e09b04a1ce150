"""`fleet_tpw_analysis` — the paper's Appendix B planning API.

The paper states all fleet tok/W results are produced by this call from
inference-fleet-sim.  It accepts any object satisfying the GpuProfile
protocol (ManualProfile or ComputedProfile) so measured and projected
hardware compare on equal footing.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union

from .fleet import FleetReport
from .modelspec import ModelSpec, PAPER_MODELS
from .profiles import BaseProfile
from .routing import FleetOpt, Homogeneous, Semantic, TwoPool, optimize_gamma
from .workloads import WORKLOADS, Workload

Topology = Union[Homogeneous, TwoPool, FleetOpt, Semantic]


@dataclasses.dataclass
class FleetAnalysis:
    """Result bundle: one FleetReport per requested topology."""

    workload: str
    gpu: str
    reports: Dict[str, FleetReport]
    gamma_star: Optional[float] = None

    def table(self) -> List[dict]:
        base = None
        rows = []
        for name, rep in self.reports.items():
            row = rep.row()
            row["topology"] = name
            if base is None:
                base = rep.tok_per_watt
                row["vs_baseline"] = "-"
            else:
                row["vs_baseline"] = f"{(rep.tok_per_watt / base - 1) * 100:+.0f}%"
            rows.append(row)
        return rows


def fleet_tpw_analysis(*, workload: Union[str, Workload],
                       profile: BaseProfile,
                       model: Union[str, ModelSpec] = "Llama-3.1-70B",
                       b_short: int = 4096,
                       gamma: Optional[float] = None,
                       topologies: tuple = ("homo", "pool", "fleetopt"),
                       ) -> FleetAnalysis:
    """Evaluate routing topologies for a workload on a GpuProfile.

    gamma=None grid-optimizes the FleetOpt overflow parameter (gamma*).
    """
    wl = WORKLOADS[workload] if isinstance(workload, str) else workload
    mdl = PAPER_MODELS[model] if isinstance(model, str) else model
    reports: Dict[str, FleetReport] = {}
    gamma_star = gamma
    for t in topologies:
        if t == "homo":
            reports[t] = Homogeneous().provision(wl, profile, mdl)
        elif t == "pool":
            reports[t] = TwoPool(b_short=b_short).provision(wl, profile, mdl)
        elif t == "fleetopt":
            if gamma is None:
                gamma_star, rep = optimize_gamma(wl, profile, mdl, b_short)
                reports[t] = rep
            else:
                reports[t] = FleetOpt(b_short=b_short, gamma=gamma) \
                    .provision(wl, profile, mdl)
        else:
            raise ValueError(f"unknown topology {t!r}")
    return FleetAnalysis(workload=wl.name, gpu=profile.chip.name,
                         reports=reports, gamma_star=gamma_star)
