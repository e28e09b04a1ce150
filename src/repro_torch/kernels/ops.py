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

from . import flash_decode as _fd
from . import flash_decode_int8 as _fd8
from . import mamba_scan as _ms
from . import wkv6 as _wk
from .ref import (flash_decode_int8_ref, flash_decode_ref, mamba_scan_ref,
                  wkv6_ref)


def _plain(impl: Optional[str], x: torch.Tensor, name: str) -> bool:
    """True where the plain version runs (see the module docstring)."""
    if impl not in (None, "plain"):
        raise ValueError(f"unknown {name} impl {impl!r}")
    return impl == "plain" or x.device.type == "cpu"


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *,
                     impl: Optional[str] = None) -> torch.Tensor:
    """(B,H,D) x (B,T,K,D) -> (B,H,D) in q.dtype; the tau = W + H(L)n
    KV-scan."""
    if _plain(impl, q, "decode_attention"):
        _fd.check_inputs(q, k, v, lengths)
        return flash_decode_ref(q, k, v, lengths).to(q.dtype)
    return _fd.flash_decode(q, k, v, lengths)


def decode_attention_int8(q: torch.Tensor, kq: torch.Tensor,
                          vq: torch.Tensor, ks: torch.Tensor,
                          vs: torch.Tensor, lengths: torch.Tensor, *,
                          impl: Optional[str] = None) -> torch.Tensor:
    """`decode_attention` over an int8 K/V cache (`quantize_kv`'s codes and
    per-(token, head) scales): (B,H,D) x int8 (B,T,K,D) -> (B,H,D) in
    q.dtype."""
    if _plain(impl, q, "decode_attention_int8"):
        _fd8.check_inputs(q, kq, vq, ks, vs, lengths)
        return flash_decode_int8_ref(q, kq, vq, ks, vs, lengths).to(q.dtype)
    return _fd8.flash_decode_int8(q, kq, vq, ks, vs, lengths)


def ssd_scan(xt: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
             lA: torch.Tensor, *, impl: Optional[str] = None):
    """Mamba2 SSD scan from a zero state: (y (B,S,nh,hd), final state
    (B,nh,hd,ds)), float32."""
    if _plain(impl, xt, "ssd_scan"):
        _ms.check_inputs(xt, Bm, Cm, lA)
        return mamba_scan_ref(xt, Bm, Cm, lA)
    return _ms.mamba_scan(xt, Bm, Cm, lA)


def wkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, *,
             impl: Optional[str] = None):
    """RWKV6 recurrence from a zero state: (out (B,S,H,hd), final state
    (B,H,hd,hd)), float32."""
    if _plain(impl, r, "wkv_scan"):
        _wk.check_inputs(r, k, v, w, u)
        return wkv6_ref(r, k, v, w, u)
    return _wk.wkv6(r, k, v, w, u)
