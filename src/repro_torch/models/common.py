"""Shared numerics for the model zoo: norms, RoPE, init helpers."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in the dtype the two promote to, as JAX computes `f32 @ bf16`
    in f32 (torch raises on mixed dtypes): float32 encoder frames meet
    bfloat16 weights in whisper's encoder and cross-attention K/V."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def dense_init(generator: torch.Generator, shape: Sequence[int],
               scale: Optional[float] = None, *, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    """Normal(0, scale) weights, drawn in f32 and cast (scale defaults to
    1/sqrt(fan_in) with fan_in = shape[0]: weights are (in, out))."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=device)
    return (w * scale).to(dtype)


def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D) with positions (..., S) or (S,); split-halves
    rotation with f32 angles."""
    d = x.shape[-1]
    freqs = torch.as_tensor(rope_frequencies(d, theta), dtype=torch.float32,
                            device=x.device)
    angles = positions.float()[..., None] * freqs        # (..., S, D/2)
    angles = angles[..., None, :]                        # head axis
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)
