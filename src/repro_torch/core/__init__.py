"""repro_torch.core — the paper's analytical contribution.

Copies of the numpy-only reference modules (no tensor, no device):
  hardware   — ChipSpec constants (H100/H200/B200/GB200 + TPU v5e)
  power      — logistic P(b) model (Eq. 1, Table 7)
  roofline   — decode latency tau = W + H(L) n (§2.2)
  kvcache    — kappa / n_max helpers (Eq. 3)
  modelspec  — analytical model geometry (Table 2 models)
  profiles   — GpuProfile protocol, ManualProfile, computed_profile
  tokenomics — Eq. 2 / Eq. 4 + Table-1 context sweep
  workloads  — Azure / LMSYS / agent trace reconstructions, diurnal envelope
  fleet      — Little's-law fleet sizing (+ PoolOverride recalibration)
  routing    — Homo / TwoPool / FleetOpt / Semantic topologies
  disagg     — prefill/decode disaggregation (§10.3)
  multipool  — K >= 3 geometric window ladders (§10.3)
  topospec   — declarative topology IR (TopologySpec / PoolSpec)
  topo_search — tok/W-maximizing topology search over the IR
  autoscale  — the reactive autoscaler's policy
  slo        — SLO-constrained sizing loop (measured TTFT p99 authority)
  timeline   — FleetScope time-series grid + Chrome trace-event builders
  law        — 1/W-law fits + gain decomposition
  moe        — active-parameter streaming + dispatch sensitivity
  speculative — speculative decoding inside P(b) (§10.3)
  carbon     — carbon- and cost-aware bills of a fleet (§10.3)
  adaptive   — online re-optimization of the pool boundary (§10.3)
  analyzer   — fleet_tpw_analysis (Appendix B API)
"""
from . import (adaptive, analyzer, autoscale, carbon, disagg, fleet,
               hardware, kvcache, law, modelspec, moe, multipool, power,
               profiles, roofline, routing, slo, speculative, timeline,
               tokenomics, topo_search, topospec, workloads)
from .adaptive import AdaptiveController
from .autoscale import AutoscalePolicy
from .carbon import GRIDS, EnergyBill, GridProfile, bill
from .disagg import Disaggregated
from .fleet import PoolOverride
from .multipool import MultiPool, ladder_windows, sweep_pool_counts
from .slo import (SLOSizingResult, SLOSpec, explain as explain_slo,
                  size_to_slo, size_to_slo_spec)
from .timeline import (EVENT_NAMES, LIFECYCLE_KINDS, PHASES,
                       TIMELINE_SCHEMA_VERSION, TRACE_SCHEMA_VERSION,
                       MetricsTimeline, bin_intervals, chrome_trace_doc)
from .topo_search import TopologySearchResult, ladder_spec, optimize_topology
from .topospec import SEMANTIC_KINDS, PoolSpec, TopologySpec, plan_roles
from .speculative import speculative_tok_per_watt
from .analyzer import FleetAnalysis, fleet_tpw_analysis
from .hardware import B200, GB200, H100, H200, TPU_V5E, ChipSpec
from .law import fit_one_over_w, gain_decomposition
from .modelspec import ModelSpec
from .moe import dispatch_sensitivity, moe_profile, with_dispatch_floor
from .power import PowerModel
from .profiles import (B200_LLAMA70B, B200_LLAMA70B_FLEET, GB200_LLAMA70B,
                       H100_LLAMA70B, H200_LLAMA70B, V5E_LLAMA70B, BaseProfile,
                       GpuProfile, ManualProfile, computed_profile)
from .roofline import DecodeRoofline
from .routing import FleetOpt, Homogeneous, Semantic, TwoPool, optimize_gamma
from .tokenomics import context_sweep, fleet_tok_per_watt, single_gpu_tok_per_watt
from .workloads import (AGENT, AZURE, AZURE_DIURNAL, LMSYS, WORKLOADS,
                        DiurnalProfile, Workload)

__all__ = [n for n in dir() if not n.startswith("_")]
