"""KV-cache accounting (paper Eq. 3).

Standalone helpers shared by the analytical layer (profiles) and the serving
scheduler (admission control).  kappa conventions follow DESIGN.md §4.
"""
from __future__ import annotations

import math


def n_max(kv_token_capacity: float, window: float) -> int:
    """Eq. 3: floor(V_KV / (kappa * W)) expressed in token capacity."""
    return max(int(math.floor(kv_token_capacity / float(window))), 1)


def kv_bytes_per_token(*, n_layers: int, n_kv_heads: int, head_dim: int,
                       dtype_bytes: float = 2.0, tp: int = 1,
                       kv_sharded: bool = True, overhead: float = 1.0,
                       attn_layer_fraction: float = 1.0) -> float:
    """kappa for a GQA transformer; 0 for attention-free models."""
    if n_kv_heads == 0:
        return 0.0
    heads = max(math.ceil(n_kv_heads / tp), 1) if kv_sharded else n_kv_heads
    return (2.0 * heads * head_dim * dtype_bytes * n_layers
            * attn_layer_fraction * overhead)


def halving_check(capacities: list[float], windows: list[float]) -> bool:
    """The discrete skeleton of the 1/W law: n_max halves per doubling."""
    ns = [n_max(c, w) for c, w in zip(capacities, windows)]
    return all(a == 2 * b or abs(a - 2 * b) <= 1 for a, b in zip(ns, ns[1:]))
