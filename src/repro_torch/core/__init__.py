"""repro_torch.core — the analytical layer the serving and fleet layers read.

Copies of the numpy-only reference modules (no tensor, no device):
  hardware   — ChipSpec constants (H100/H200/B200/GB200 + TPU v5e)
  power      — logistic P(b) model (Eq. 1, Table 7)
  roofline   — decode latency tau = W + H(L) n (§2.2)
  modelspec  — analytical model geometry (Table 2 models)
  profiles   — the calibrated H100 / Llama-3.1-70B profile, its
               projections on the other generations, computed_profile
  workloads  — Azure / LMSYS / agent trace reconstructions, diurnal envelope
  moe        — active-parameter streaming + dispatch floor
  fleet      — Little's-law fleet sizing (+ PoolOverride recalibration)
  routing    — Homo / TwoPool / FleetOpt / Semantic topologies
  disagg     — prefill/decode disaggregation
  multipool  — K >= 3 geometric window ladders (§10.3)
  topospec   — declarative topology IR (TopologySpec / PoolSpec)
  autoscale  — the reactive autoscaler's policy
  slo        — SLO-constrained sizing loop (measured TTFT p99 authority)
  timeline   — FleetScope time-series grid + Chrome trace-event builders
"""
from . import (autoscale, disagg, fleet, hardware, modelspec, moe, multipool,
               power, profiles, roofline, routing, slo, timeline, topospec,
               workloads)
from .autoscale import AutoscalePolicy
from .disagg import Disaggregated
from .fleet import PoolOverride
from .multipool import MultiPool, ladder_windows, sweep_pool_counts
from .slo import (SLOSizingResult, SLOSpec, explain as explain_slo,
                  size_to_slo, size_to_slo_spec)
from .timeline import (EVENT_NAMES, LIFECYCLE_KINDS, PHASES,
                       TIMELINE_SCHEMA_VERSION, TRACE_SCHEMA_VERSION,
                       MetricsTimeline, bin_intervals, chrome_trace_doc)
from .topospec import SEMANTIC_KINDS, PoolSpec, TopologySpec, plan_roles
from .hardware import B200, GB200, H100, H200, TPU_V5E, ChipSpec
from .modelspec import ModelSpec
from .moe import dispatch_sensitivity, moe_profile, with_dispatch_floor
from .power import PowerModel
from .profiles import (B200_LLAMA70B, B200_LLAMA70B_FLEET, GB200_LLAMA70B,
                       H100_LLAMA70B, H200_LLAMA70B, V5E_LLAMA70B, BaseProfile,
                       ManualProfile, computed_profile)
from .roofline import DecodeRoofline
from .routing import FleetOpt, Homogeneous, Semantic, TwoPool, optimize_gamma
from .workloads import (AGENT, AZURE, AZURE_DIURNAL, LMSYS, WORKLOADS,
                        DiurnalProfile, Workload)

__all__ = [n for n in dir() if not n.startswith("_")]
