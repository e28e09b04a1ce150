"""Beyond-paper: prefill-decode disaggregation (paper §10.3 / Splitwise).

"Splitwise-style separation assigns prefill and decode to different GPU
pools.  Combined with context-length routing, this could remove prefill
energy from the output tok/W accounting and unlock further efficiency."

We build it — and serve it: prefill pools are compute-bound chunk
processors drawing near-saturated power; decode pools run pure token
generation with their concurrency ceiling n_max(window) and no prefill
interference.  The KV handoff crosses the interconnect once per request
(kappa * prompt bytes), costing transfer latency (TPOT, not TTFT — the
first token comes out of the prefill pool) and link + HBM energy, charged
to the EnergyMeter as non-output energy.  Composable with FleetOpt
windows (``split=True``); served end-to-end by `serving.fleetsim` via the
``disagg`` / ``disagg_fleetopt`` topology kinds.

Dedicated prefill runs the same calibrated compute-bound MFU as the
chunked-interleave charging model (fleet.PREFILL_MFU): separation removes
the decode-side interference, not the FLOP ceiling.  (Anything materially
lower makes the paper's P99 TTFT <= 500 ms SLO physically unreachable on
the Azure trace: at MFU 0.55 ~2% of prompts have a pure service-time
floor above 500 ms, more than the whole p99 violator budget.)
"""
from __future__ import annotations

import dataclasses
from typing import List

from .fleet import PREFILL_MFU, FleetReport, PoolSizing
from .modelspec import ModelSpec
from .profiles import BaseProfile
from .workloads import Workload

# Per-instance interconnect bandwidth available to KV migration (NVLink /
# NVSwitch class links; Splitwise uses the same assumption for its
# "negligible transfer latency" claim — we charge it instead of waving it).
INTERCONNECT_BPS = 450e9
# Energy per migrated KV byte: HBM read (~4 pJ/bit) + link traversal
# (~1.3 pJ/bit, NVLink4) + HBM write (~4 pJ/bit) ~= 9.3 pJ/bit ~= 75 pJ/B.
HANDOFF_J_PER_BYTE = 75e-12


@dataclasses.dataclass
class DisaggPools:
    """One (prefill fleet, decode fleet) pair for a traffic slice."""

    window: int
    prefill_instances: int
    decode_instances: int
    prefill_power_w: float       # per instance
    decode_power_w: float
    tokens_per_s: float          # output tokens (decode side)

    @property
    def power_kw(self) -> float:
        return (self.prefill_instances * self.prefill_power_w
                + self.decode_instances * self.decode_power_w) / 1e3


@dataclasses.dataclass
class Disaggregated:
    """Prefill/decode-disaggregated topology, optionally two-pool routed."""

    b_short: int = 4096
    gamma: float = 2.0
    long_window: int = 65536
    prefill_mfu: float = PREFILL_MFU  # dedicated prefill: compute-bound,
                                      # same calibrated MFU as interleave
    split: bool = True           # False = one disaggregated pool at 64K
    interconnect_Bps: float = INTERCONNECT_BPS

    def provision(self, workload: Workload, profile: BaseProfile,
                  model: ModelSpec) -> FleetReport:
        p, o = workload.prompts, workload.outputs
        lam = workload.arrival_rate
        if self.split:
            short = (p + workload.mean_output) <= self.b_short
            slices = [(int(self.gamma * self.b_short), short),
                      (self.long_window, ~short)]
        else:
            import numpy as np
            slices = [(self.long_window, np.ones_like(p, dtype=bool))]

        # Pools are appended prefill-before-decode per slice so the stable
        # window sort used by serving.fleetsim / core.fleet.apply_overrides
        # yields the handoff DAG order (prefill-w, decode-w, ascending w).
        pools: List[PoolSizing] = []
        for window, mask in slices:
            if mask.sum() == 0:
                continue
            frac = float(mask.mean())
            mean_prompt = float(p[mask].mean())
            mean_out = float(o[mask].mean())
            mean_ctx = float((p[mask] + o[mask] / 2).mean())
            lam_i = lam * frac
            # --- prefill fleet: compute-bound batch processors ----------
            pf = PoolSizing(
                name=f"prefill-{window // 1024}K", window=window,
                profile=profile, arrival_rate=lam_i,
                mean_output=0.0,     # output-only accounting (paper §10.1)
                mean_context=mean_prompt, mean_prompt=mean_prompt,
                phase="prefill", prefill_engine_mfu=self.prefill_mfu)
            pf.size(streamed_params=model.streamed_params,
                    prefill_mfu=self.prefill_mfu)
            # --- decode fleet: Little's law, no prefill interference ----
            dec = PoolSizing(
                name=f"decode-{window // 1024}K", window=window,
                profile=profile, arrival_rate=lam_i,
                mean_output=mean_out, mean_context=mean_ctx,
                mean_prompt=0.0)     # prefill load removed from this pool
            dec.size(streamed_params=model.streamed_params)
            pools.extend([pf, dec])
        return FleetReport(pools=pools,
                           label=f"Disagg{'+FleetOpt' if self.split else ''}")

    @staticmethod
    def kv_handoff_bytes_per_request(prompt_len: float, model: ModelSpec,
                                     profile: BaseProfile) -> float:
        """Whole-instance KV bytes one prefill->decode migration moves."""
        tp = profile.tp
        return model.kv_bytes_per_token(tp=tp) * tp * prompt_len

    @staticmethod
    def kv_handoff_bytes_per_s(workload: Workload, model: ModelSpec,
                               profile: BaseProfile) -> float:
        """Aggregate interconnect load of the prefill->decode migration
        (TP degree and KV sharding come from the profile actually serving
        the fleet, not a hardcoded TP=8)."""
        return workload.arrival_rate * Disaggregated.kv_handoff_bytes_per_request(
            workload.mean_prompt, model, profile)

    def kv_handoff_delay_s(self, prompt_len: float, model: ModelSpec,
                           profile: BaseProfile) -> float:
        """Per-request KV migration latency over the interconnect."""
        return self.kv_handoff_bytes_per_request(
            prompt_len, model, profile) / self.interconnect_Bps
