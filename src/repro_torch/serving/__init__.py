"""Serving runtime: context-length routing into continuous-batching pools,
and the fleet simulator over them.

`ContextRouter` routes requests by context length (and, for semantic
routing, by a classifier with a misroute channel) into `PoolEngine`s, each
a continuous-batching decode loop charged P(b) * tau by an `EnergyMeter`:
over the model with its KV slab on the card (model mode), or over the
scheduler alone (analytical mode, `cfg=None`).  `FleetSim` provisions a
whole fleet from a `core.topospec.TopologySpec` and drains every pool in a
numpy `BatchedPoolEngine` (all instances of a pool in lockstep, metered by
a `MeterBank`).  FleetScope (`TraceRecorder`, `build_timeline`,
`to_perfetto`) records either engine's lifecycle events and charges.
"""
from .autoscale import Autoscaler, AutoscalePolicy, InstanceSchedule
from .energy import EnergyMeter, MeterBank, conservation_violations
from .engine import (DrainTruncatedError, PoolEngine, resolve_prefill_chunk,
                     scaled_prefill_chunk)
from .fleetsim import (FleetSim, PoolGroup, PoolSummary, SimVsAnalytical,
                       analytical_decode_tok_per_watt, build_topology,
                       prepare_spec, prepare_topology, run_fleet_grid,
                       simulate_spec, simulate_topology, trace_requests)
from .models import ModelBinding, ModelProfileRegistry
from .request import (Request, latency_percentiles, sample_diurnal_trace,
                      sample_trace, synthetic_requests)
from .router import SEMANTIC_KINDS, ContextRouter, RouterPolicy
from .soa import BatchedPoolEngine
from .telemetry import (TraceRecorder, build_timeline, phase_totals,
                        reconcile_energy, to_perfetto)

__all__ = ["EnergyMeter", "MeterBank", "PoolEngine", "BatchedPoolEngine",
           "TraceRecorder", "build_timeline", "phase_totals",
           "reconcile_energy", "to_perfetto", "conservation_violations",
           "Request", "synthetic_requests", "sample_trace",
           "sample_diurnal_trace", "latency_percentiles",
           "Autoscaler", "AutoscalePolicy", "InstanceSchedule",
           "ContextRouter", "RouterPolicy", "FleetSim", "PoolGroup",
           "PoolSummary",
           "SimVsAnalytical", "analytical_decode_tok_per_watt",
           "build_topology", "simulate_topology", "simulate_spec",
           "trace_requests", "ModelBinding", "ModelProfileRegistry",
           "SEMANTIC_KINDS", "DrainTruncatedError", "resolve_prefill_chunk",
           "scaled_prefill_chunk", "prepare_topology", "prepare_spec",
           "run_fleet_grid"]
