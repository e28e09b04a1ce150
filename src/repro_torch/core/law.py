"""The 1/W law itself (paper §3.1) + gain decomposition (§4.2)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from .profiles import BaseProfile
from .tokenomics import context_sweep


@dataclasses.dataclass(frozen=True)
class LawFit:
    """log2(tok/W) regressed on log2(window): the law predicts slope -1."""

    slope: float
    r2: float
    halving_ratios: List[float]   # tok/W(2w)/tok/W(w) per doubling (~0.5)


def fit_one_over_w(profile: BaseProfile,
                   contexts: Sequence[int] = (2048, 4096, 8192, 16384, 32768,
                                              65536, 131072)) -> LawFit:
    rows = context_sweep(profile, contexts)
    x = np.log2([r.context for r in rows])
    y = np.log2([r.tok_per_watt for r in rows])
    slope, intercept = np.polyfit(x, y, 1)
    pred = slope * x + intercept
    ss_res = float(((y - pred) ** 2).sum())
    ss_tot = float(((y - y.mean()) ** 2).sum())
    ratios = [float(2.0 ** (y[i + 1] - y[i])) for i in range(len(y) - 1)]
    return LawFit(slope=float(slope), r2=1.0 - ss_res / ss_tot,
                  halving_ratios=ratios)


def gain_decomposition(tpw: Dict[str, Dict[str, float]]) -> Dict[str, float]:
    """§4.2: topology / generation gains and their multiplicativity.

    tpw[gen][topo] -> fleet tok/W, gens = {"H100","B200"},
    topos = {"homo","fleetopt"}.
    """
    d_topo_h = tpw["H100"]["fleetopt"] / tpw["H100"]["homo"]
    d_topo_b = tpw["B200"]["fleetopt"] / tpw["B200"]["homo"]
    d_gen_homo = tpw["B200"]["homo"] / tpw["H100"]["homo"]
    d_gen_fo = tpw["B200"]["fleetopt"] / tpw["H100"]["fleetopt"]
    combined = tpw["B200"]["fleetopt"] / tpw["H100"]["homo"]
    return dict(topo_h100=d_topo_h, topo_b200=d_topo_b,
                gen_homo=d_gen_homo, gen_fleetopt=d_gen_fo,
                combined=combined,
                product_of_means=float(np.sqrt(d_topo_h * d_topo_b)
                                       * np.sqrt(d_gen_homo * d_gen_fo)),
                independence_error=abs(d_topo_h - d_topo_b)
                / max(d_topo_h, d_topo_b))
