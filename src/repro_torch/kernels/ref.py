"""Plain PyTorch versions of the kernels: direct, obviously-correct math.

The CPU path of every kernel wrapper, and what `chip_smoke.py` holds each
kernel against on the card.
"""
from __future__ import annotations

import math

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
