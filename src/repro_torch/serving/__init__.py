"""Serving runtime: context-length routing into continuous-batching pools.

`ContextRouter` routes requests by context length (and, for semantic
routing, by a classifier with a misroute channel) into `PoolEngine`s, each
a continuous-batching decode loop charged P(b) * tau by an `EnergyMeter`:
over the model with its KV slab on the card (model mode), or over the
scheduler alone (analytical mode, `cfg=None`).
"""
from .energy import EnergyMeter
from .engine import (DrainTruncatedError, PoolEngine, resolve_prefill_chunk,
                     scaled_prefill_chunk)
from .models import ModelBinding, ModelProfileRegistry
from .request import (Request, latency_percentiles, sample_diurnal_trace,
                      sample_trace, synthetic_requests)
from .router import SEMANTIC_KINDS, ContextRouter, RouterPolicy

__all__ = ["EnergyMeter", "PoolEngine", "Request", "synthetic_requests",
           "sample_trace", "sample_diurnal_trace", "latency_percentiles",
           "ContextRouter", "RouterPolicy", "ModelBinding",
           "ModelProfileRegistry", "SEMANTIC_KINDS", "DrainTruncatedError",
           "resolve_prefill_chunk", "scaled_prefill_chunk"]
