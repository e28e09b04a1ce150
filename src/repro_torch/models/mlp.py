"""Dense MLP block (SwiGLU / GELU)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import dense_init, dot, dtype_of, rms_norm, silu


def init_mlp(generator: torch.Generator, cfg, device: torch.device) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    dt = dtype_of(cfg)
    p = {"norm": torch.ones(d, dtype=torch.float32, device=device),
         "w_up": dense_init(generator, (d, ff), dtype=dt, device=device),
         "w_down": dense_init(generator, (ff, d), dtype=dt, device=device)}
    if cfg.mlp_act == "swiglu":
        p["w_gate"] = dense_init(generator, (d, ff), dtype=dt, device=device)
    return p


def apply_mlp(params: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    """x + the MLP of x; a float32 x (whisper's encoder) meets bfloat16
    weights in float32, as in the reference."""
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    up = dot(h, params["w_up"])
    if cfg.mlp_act == "swiglu":
        up = silu(dot(h, params["w_gate"])) * up
    else:
        # jax.nn.gelu defaults to the tanh approximation
        up = F.gelu(up, approximate="tanh")
    return x + dot(up, params["w_down"])
