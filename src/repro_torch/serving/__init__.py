"""Serving runtime: context-length routing into continuous-batching pools.

`ContextRouter` routes requests by context length into `PoolEngine`s,
each a continuous-batching decode loop over the model with its KV slab on
the card, charged P(b) * tau by an `EnergyMeter`.
"""
from .energy import EnergyMeter
from .engine import DrainTruncatedError, PoolEngine
from .request import Request, latency_percentiles
from .router import ContextRouter, RouterPolicy

__all__ = ["EnergyMeter", "DrainTruncatedError", "PoolEngine", "Request",
           "latency_percentiles", "ContextRouter", "RouterPolicy"]
