"""Beyond-paper: carbon- and cost-aware objectives (paper §10.3).

tok/W says nothing about *when* and *where* the joules are drawn.  This
module converts fleet reports into gCO2/Mtok and $/Mtok using PUE, grid
carbon intensity, electricity price and instance rental — "the per-GPU
power model provides a natural starting point for a joint energy-cost
objective" (paper §10.3), so we build exactly that.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from .fleet import FleetReport


@dataclasses.dataclass(frozen=True)
class GridProfile:
    name: str
    carbon_g_per_kwh: float      # grid intensity
    price_usd_per_kwh: float
    pue: float = 1.2             # datacenter power usage effectiveness


# Representative 2026 grid mixes (documented assumptions, not measurements)
GRIDS: Dict[str, GridProfile] = {
    "us-west-hydro": GridProfile("us-west-hydro", 90.0, 0.055),
    "us-east-mixed": GridProfile("us-east-mixed", 360.0, 0.085),
    "eu-north": GridProfile("eu-north", 45.0, 0.070),
    "apac-coal-heavy": GridProfile("apac-coal-heavy", 620.0, 0.095),
}


@dataclasses.dataclass(frozen=True)
class EnergyBill:
    tok_per_watt: float
    g_co2_per_mtok: float
    usd_energy_per_mtok: float
    usd_rental_per_mtok: float

    @property
    def usd_total_per_mtok(self) -> float:
        return self.usd_energy_per_mtok + self.usd_rental_per_mtok


def bill(report: FleetReport, grid: GridProfile) -> EnergyBill:
    """Convert a fleet report into carbon/cost per million output tokens."""
    tok_s = report.tokens_per_s
    kw_it = report.power_kw * grid.pue
    mtok_per_hour = tok_s * 3600 / 1e6
    kwh_per_mtok = kw_it / max(mtok_per_hour, 1e-12)
    rental_hr = sum(p.instances * p.profile.chip.rental_usd_hr
                    for p in report.pools)
    return EnergyBill(
        tok_per_watt=report.tok_per_watt,
        g_co2_per_mtok=kwh_per_mtok * grid.carbon_g_per_kwh,
        usd_energy_per_mtok=kwh_per_mtok * grid.price_usd_per_kwh,
        usd_rental_per_mtok=rental_hr / max(mtok_per_hour, 1e-12))


def rank_topologies(reports: Dict[str, FleetReport], grid: GridProfile,
                    objective: str = "g_co2_per_mtok") -> list:
    """Rank topologies by tok/W, carbon or total cost — the orderings can
    differ (rental dominates cost; carbon tracks energy)."""
    rows = []
    for name, rep in reports.items():
        b = bill(rep, grid)
        rows.append(dict(topology=name, tok_per_watt=round(b.tok_per_watt, 2),
                         g_co2_per_mtok=round(b.g_co2_per_mtok, 1),
                         usd_total_per_mtok=round(b.usd_total_per_mtok, 2)))
    key = objective if objective != "tok_per_watt" else None
    return sorted(rows, key=lambda r: r[objective],
                  reverse=(objective == "tok_per_watt"))
