"""Plain PyTorch versions of the kernels: direct, obviously-correct math.

The CPU path of every kernel wrapper, and what `chip_smoke.py` holds each
kernel against on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """Decode GQA attention, direct softmax in f32.

    q: (B, H, D) one query per sequence; k, v: (B, T, K, D);
    lengths: (B,) valid cache entries (t < lengths[b]).  Returns (B, H, D)
    in float32.  A sequence with lengths[b] <= 0 attends to nothing and
    gets a zero output, as the CUDA kernel gives it.  (The JAX reference
    and the Pallas kernel instead average V over all T rows there; the
    model never asks, its lengths are min(pos + 1, T) >= 1.)
    """
    B, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qh = q.reshape(B, K, G, D).float()
    s = torch.einsum("bkgd,btkd->bkgt", qh, k.float()) / math.sqrt(D)
    valid = torch.arange(T, device=q.device)[None] < lengths[:, None]
    s = s.masked_fill(~valid[:, None, None], -1e30)
    p = torch.softmax(s, dim=-1)
    p = p * valid.any(-1)[:, None, None, None]
    out = torch.einsum("bkgt,btkd->bkgd", p, v.float())
    return out.reshape(B, H, D)


def flash_decode_int8_ref(q: torch.Tensor, kq: torch.Tensor,
                          vq: torch.Tensor, ks: torch.Tensor,
                          vs: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """Decode GQA attention over an int8 K/V cache: the codes dequantized in
    f32 (code * per-(token, head) scale), then `flash_decode_ref`.

    kq, vq: int8 (B, T, K, D); ks, vs: float32 (B, T, K).  Returns
    (B, H, D) in float32; lengths <= 0 give a zero output, as there.
    """
    return flash_decode_ref(q, kq.float() * ks[..., None],
                            vq.float() * vs[..., None], lengths)


def mamba_scan_ref(xt: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                   lA: torch.Tensor,
                   init_state: Optional[torch.Tensor] = None):
    """Sequential SSD scan, one step per token, in f32.

    xt: (B,S,nh,hd) dt-scaled inputs; Bm/Cm: (B,S,ds); lA: (B,S,nh)
    log-decay.  state_t = exp(lA_t) state_{t-1} + xt_t (x) B_t and
    y_t = state_t . C_t, from `init_state` (B,nh,hd,ds) or zero.
    Returns (y (B,S,nh,hd), final_state (B,nh,hd,ds)), both float32.
    """
    B, S, nh, hd = xt.shape
    ds = Bm.shape[-1]
    state = (init_state.float().clone() if init_state is not None else
             torch.zeros(B, nh, hd, ds, dtype=torch.float32,
                         device=xt.device))
    xt, Bm, Cm, lA = xt.float(), Bm.float(), Cm.float(), lA.float()
    ys = []
    for t in range(S):
        state = state * torch.exp(lA[:, t])[:, :, None, None] \
            + torch.einsum("bnp,bs->bnps", xt[:, t], Bm[:, t])
        ys.append(torch.einsum("bnps,bs->bnp", state, Cm[:, t]))
    return torch.stack(ys, dim=1), state


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor,
             init_state: Optional[torch.Tensor] = None):
    """Sequential RWKV6 recurrence, one step per token, in f32.

    r,k,v,w: (B,S,H,hd); u: (H,hd).  out_t = r_t (state_{t-1} +
    diag(u) k_t^T v_t), state_t = diag(w_t) state_{t-1} + k_t^T v_t, from
    `init_state` (B,H,hd,hd) [k-dim, v-dim] or zero.  Returns
    (out (B,S,H,hd), final_state (B,H,hd,hd)), both float32.
    """
    B, S, H, hd = r.shape
    state = (init_state.float().clone() if init_state is not None else
             torch.zeros(B, H, hd, hd, dtype=torch.float32, device=r.device))
    r, k, v, w, u = r.float(), k.float(), v.float(), w.float(), u.float()
    outs = []
    for t in range(S):
        r_t, k_t, v_t = r[:, t], k[:, t], v[:, t]
        bonus = torch.einsum("bhd,bhd->bh", r_t, u[None] * k_t)
        outs.append(torch.einsum("bhd,bhde->bhe", r_t, state)
                    + bonus[..., None] * v_t)
        state = state * w[:, t, :, :, None] \
            + torch.einsum("bhd,bhe->bhde", k_t, v_t)
    return torch.stack(outs, dim=1), state
