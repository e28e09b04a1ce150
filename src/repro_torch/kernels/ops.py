"""Dispatch the model calls: the kernel, or its plain version on request.

Mirrors the reference's `kernels/ops.py`, with one rule in place of its
backend and environment switches, held here and nowhere else: a CUDA
tensor launches the hand-written kernel (or raises), a CPU tensor takes
the plain version, and only an explicit `impl="plain"` runs the plain
version on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from .flash_decode import check_inputs, flash_decode
from .ref import flash_decode_ref


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *,
                     impl: Optional[str] = None) -> torch.Tensor:
    """(B,H,D) x (B,T,K,D) -> (B,H,D) in q.dtype; the tau = W + H(L)n
    KV-scan."""
    if impl not in (None, "plain"):
        raise ValueError(f"unknown decode_attention impl {impl!r}")
    if impl == "plain" or q.device.type == "cpu":
        check_inputs(q, k, v, lengths)
        return flash_decode_ref(q, k, v, lengths).to(q.dtype)
    return flash_decode(q, k, v, lengths)
