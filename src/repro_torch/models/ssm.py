"""Recurrent blocks: Mamba2 (SSD) and RWKV6 (Finch) time/channel mix.

Both are O(1)-state decoders, the architectures for which the paper's 1/W
law weakens: no per-token KV growth.  Prefill runs the whole prompt's
recurrence through `kernels.ops` (`ssd_scan`, `wkv_scan`): the
hand-written kernel on the card, the plain sequential scan on the CPU.
Decode takes one plain step per token, as the reference does.  The
kernels have no backward pass, so these blocks train on the CPU only: on
the card a full-sequence call whose inputs need a gradient raises
(ROADMAP A 5b).

Conventions:
  Mamba2:  S_t = exp(A dt_t) S_{t-1} + dt_t x_t (x) B_t ;  y_t = C_t . S_t + D x_t
  RWKV6:   out_t = r_t (S_{t-1} + diag(u) k_t^T v_t) ;
           S_t = diag(w_t) S_{t-1} + k_t^T v_t,  w_t data-dependent.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from .common import dense_init, dtype_of, rms_norm, silu

# ======================================================================
# Mamba2
# ======================================================================


def init_mamba2(generator: torch.Generator, cfg,
                device: torch.device) -> dict:
    d, di, ds, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    dt = dtype_of(cfg)
    conv_ch = di + 2 * ds
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "norm": torch.ones(d, **f32),
        "w_in": dense_init(generator, (d, 2 * di + 2 * ds + nh), dtype=dt,
                           device=device),
        "conv_w": dense_init(generator, (cfg.d_conv, conv_ch), scale=0.5,
                             **f32),
        "conv_b": torch.zeros(conv_ch, **f32),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "dt_bias": torch.zeros(nh, **f32),
        "D": torch.ones(nh, **f32),
        "norm_y": torch.ones(di, **f32),
        "w_out": dense_init(generator, (di, d), dtype=dt, device=device),
    }


def _causal_conv_full(x: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, x: (B,S,C), w: (K,C), zeros before t = 0."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = sum(xp[:, j:j + S] * w[j] for j in range(K))
    return out + b


def _mamba_inner(cfg, params, h, conv_state=None):
    """Projection, causal conv and split shared by the full and decode
    paths; `conv_state` (B, d_conv-1, C) given means one decode step."""
    di, ds, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    zxbcdt = h @ params["w_in"]
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * ds, nh], dim=-1)
    xbc = xbc.float()
    if conv_state is not None:
        seq = torch.cat([conv_state, xbc], dim=1)          # (B, K, C)
        conv = torch.einsum("bkc,kc->bc", seq,
                            params["conv_w"])[:, None] + params["conv_b"]
        new_conv_state = seq[:, 1:]
    else:
        conv = _causal_conv_full(xbc, params["conv_w"], params["conv_b"])
        # the last d_conv-1 inputs, right-aligned; a shorter prompt gets
        # the zeros the conv saw before t = 0 in front (the reference
        # keeps only the prompt's rows there: ROADMAP C7)
        K1 = cfg.d_conv - 1
        new_conv_state = F.pad(xbc, (0, 0, max(K1 - xbc.shape[1], 0), 0)
                               )[:, -K1:]
    xbc = silu(conv)
    xs, Bm, Cm = torch.split(xbc, [di, ds, ds], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    xh = xs.reshape(xs.shape[0], xs.shape[1], nh, cfg.ssm_head_dim)
    return z, xh, Bm, Cm, dt, A, new_conv_state


def _mamba_out(params, cfg, x, z, y):
    y = rms_norm(y * silu(z.float()), params["norm_y"], cfg.norm_eps)
    return x + y.to(x.dtype) @ params["w_out"]


def mamba2_full(params, cfg, x: torch.Tensor, *, mode: str = "train",
                impl: Optional[str] = None,
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Full-sequence Mamba2 block; the scan goes through `ops.ssd_scan`
    on xt = x dt and lA = dt A, and y gains D x as in the reference's
    chunk scan."""
    B, S, _ = x.shape
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    z, xh, Bm, Cm, dt, A, conv_state = _mamba_inner(cfg, params, h)
    y, state = ops.ssd_scan(xh * dt[..., None], Bm, Cm, dt * A, impl=impl)
    y = y + xh * params["D"][None, None, :, None]
    out = _mamba_out(params, cfg, x, z, y.reshape(B, S, cfg.d_inner))
    cache = {"conv": conv_state, "ssm": state} if mode == "prefill" else None
    return out, cache


def mamba2_decode(params, cfg, x: torch.Tensor, cache: dict,
                  ) -> Tuple[torch.Tensor, dict]:
    """One token, x: (B, 1, d); cache {"conv": (B, d_conv-1, C),
    "ssm": (B, nh, hd, ds)}.  Returns the new state; the caller writes
    it back."""
    B = x.shape[0]
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    z, xh, Bm, Cm, dt, A, new_conv = _mamba_inner(
        cfg, params, h, conv_state=cache["conv"])
    dA = torch.exp(dt[:, 0] * A)                               # (B, nh)
    xt = xh[:, 0] * dt[:, 0, :, None]                          # (B, nh, hd)
    s_new = cache["ssm"] * dA[..., None, None] \
        + torch.einsum("bnp,bs->bnps", xt, Bm[:, 0])
    y = torch.einsum("bnps,bs->bnp", s_new, Cm[:, 0]) \
        + xh[:, 0] * params["D"][None, :, None]
    out = _mamba_out(params, cfg, x, z, y.reshape(B, 1, cfg.d_inner))
    return out, {"conv": new_conv, "ssm": s_new}


# ======================================================================
# RWKV6
# ======================================================================

_LORA = 64


def init_rwkv6(generator: torch.Generator, cfg,
               device: torch.device) -> dict:
    d, H, hd, ff = cfg.d_model, cfg.rwkv_heads, cfg.rwkv_head_dim, cfg.d_ff
    dt = dtype_of(cfg)
    f32 = dict(dtype=torch.float32, device=device)

    def w(shape, **kw):
        kw.setdefault("dtype", dt)
        return dense_init(generator, shape, device=device, **kw)

    return {
        "norm_tm": torch.ones(d, **f32),
        "norm_cm": torch.ones(d, **f32),
        "maa": torch.full((5, d), 0.5, **f32),        # r,k,v,g,w mixing
        "w0": torch.full((H, hd), -6.0, **f32),
        "wA": w((d, _LORA), scale=0.01, dtype=torch.float32),
        "wB": w((_LORA, H * hd), scale=0.01, dtype=torch.float32),
        "u": torch.full((H, hd), 0.5, **f32),
        "Wr": w((d, d)), "Wk": w((d, d)), "Wv": w((d, d)), "Wg": w((d, d)),
        "Wo": w((d, d)),
        "ln_x": torch.ones(d, **f32),
        "maa_cm": torch.full((2, d), 0.5, **f32),
        "Wk_cm": w((d, ff)), "Wv_cm": w((ff, d)), "Wr_cm": w((d, d)),
    }


def _shift(x: torch.Tensor, prev: Optional[torch.Tensor] = None):
    """Token shift: x_{t-1}, with `prev` filling slot 0 (decode state)."""
    first = prev[:, None] if prev is not None else torch.zeros_like(x[:, :1])
    return torch.cat([first, x[:, :-1]], dim=1)


def _rwkv_decay(params, xw: torch.Tensor, H: int, hd: int) -> torch.Tensor:
    lora = torch.tanh(xw.float() @ params["wA"]) @ params["wB"]
    w = torch.exp(-torch.exp(params["w0"].reshape(-1) + lora))  # (0, 1)
    return w.reshape(*xw.shape[:-1], H, hd)


def _time_mix_in(params, h, hx, H, hd):
    """r, k, v (f32, (B,S,H,hd)), the gate g and the decay w from the
    normed input h and its shift hx."""
    B, S = h.shape[:2]
    maa = params["maa"].to(h.dtype)
    delta = hx - h
    r, k, v, g = (
        (h + delta * maa[i]) @ params[name]
        for i, name in enumerate(("Wr", "Wk", "Wv", "Wg")))
    r, k, v = (a.reshape(B, S, H, hd).float() for a in (r, k, v))
    w = _rwkv_decay(params, h + delta * maa[4], H, hd)
    return r, k, v, g, w


def _time_mix_out(params, cfg, x, out, g):
    B, S = x.shape[:2]
    out = rms_norm(out.reshape(B, S, cfg.d_model), params["ln_x"],
                   cfg.norm_eps)
    return x + (out * silu(g.float())).to(x.dtype) @ params["Wo"]


def _channel_mix(params, cfg, x, prev=None):
    """Returns (x + channel mix, the normed input h2)."""
    h2 = rms_norm(x, params["norm_cm"], cfg.norm_eps)
    hx2 = _shift(h2, prev)
    maa_cm = params["maa_cm"].to(h2.dtype)
    xk2 = h2 + (hx2 - h2) * maa_cm[0]
    xr2 = h2 + (hx2 - h2) * maa_cm[1]
    kcm = torch.square(torch.relu(xk2 @ params["Wk_cm"]))
    out2 = torch.sigmoid(xr2 @ params["Wr_cm"]) * (kcm @ params["Wv_cm"])
    return x + out2.to(x.dtype), h2


def rwkv6_full(params, cfg, x: torch.Tensor, *, mode: str = "train",
               impl: Optional[str] = None,
               ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Full-sequence RWKV6 block; the recurrence goes through
    `ops.wkv_scan`."""
    H, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
    h = rms_norm(x, params["norm_tm"], cfg.norm_eps)
    r, k, v, g, w = _time_mix_in(params, h, _shift(h), H, hd)
    out, state = ops.wkv_scan(r, k, v, w, params["u"], impl=impl)
    x = _time_mix_out(params, cfg, x, out, g)
    x, h2 = _channel_mix(params, cfg, x)
    cache = None
    if mode == "prefill":
        cache = {"wkv": state, "shift_tm": h[:, -1], "shift_cm": h2[:, -1]}
    return x, cache


def rwkv6_decode(params, cfg, x: torch.Tensor, cache: dict,
                 ) -> Tuple[torch.Tensor, dict]:
    """One token, x: (B, 1, d); cache {"wkv": (B,H,hd,hd), "shift_tm",
    "shift_cm": (B, d)}.  Returns the new state; the caller writes it
    back."""
    B = x.shape[0]
    H, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
    h = rms_norm(x, params["norm_tm"], cfg.norm_eps)
    r, k, v, g, w = _time_mix_in(params, h, _shift(h, cache["shift_tm"]),
                                 H, hd)
    r, k, v, w = r[:, 0], k[:, 0], v[:, 0], w[:, 0]          # (B, H, hd)
    S_prev = cache["wkv"]
    out = torch.einsum("bhd,bhde->bhe", r, S_prev) \
        + torch.einsum("bhd,bhd->bh", r, params["u"][None] * k)[..., None] \
        * v
    s_new = S_prev * w[..., None] + torch.einsum("bhd,bhe->bhde", k, v)
    x = _time_mix_out(params, cfg, x, out.reshape(B, 1, H, hd), g)
    x, h2 = _channel_mix(params, cfg, x, cache["shift_cm"])
    return x, {"wkv": s_new, "shift_tm": h[:, 0], "shift_cm": h2[:, 0]}
