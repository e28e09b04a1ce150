"""Dispatch the model calls: the kernel, or its plain version on request.

Mirrors the reference's `kernels/ops.py`, with one rule in place of its
backend and environment switches, held here and nowhere else: a CUDA
tensor launches the hand-written kernel (or raises), a CPU tensor takes
the plain version, and only an explicit `impl="plain"` runs the plain
version on the card.

DTensor arguments: each rank runs on its local shards (`on_shards`, a
`local_map`) where the placements keep the work local: batch or (KV)
heads sharded, the decode's T and the scans' S whole; the result is a
DTensor placed as the query.  On the card that is the only way: any other
placement raises NotImplementedError (a sequence-sharded KV needs a
cross-rank merge of the pieces' softmax states, which no kernel here
does).  The plain versions (the CPU, or impl="plain") run under DTensor's
sharding propagation where the work is not local.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models.common import (_is_dtensor, on_shards, replicated_like,
                             shard_kinds)
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
    plain = _plain(impl, q, "decode_attention")
    if _is_dtensor(q):
        args = (q, k, v, replicated_like(lengths, q))
        kv = {"batch": 0, "heads": 2}
        dims = ({"batch": 0, "heads": 1}, kv, kv, {"batch": 0})
        if not plain or shard_kinds(args, dims)[1] is None:
            return on_shards("flash_decode", _plain_decode if plain
                             else _fd.flash_decode, args, dims, dims[:1])
        q, k, v, lengths = args     # the plain version under propagation
    if plain:
        return _plain_decode(q, k, v, lengths)
    return _fd.flash_decode(q, k, v, lengths)


def _plain_decode(q, k, v, lengths):
    _fd.check_inputs(q, k, v, lengths)
    return flash_decode_ref(q, k, v, lengths).to(q.dtype)


def decode_attention_int8(q: torch.Tensor, kq: torch.Tensor,
                          vq: torch.Tensor, ks: torch.Tensor,
                          vs: torch.Tensor, lengths: torch.Tensor, *,
                          impl: Optional[str] = None) -> torch.Tensor:
    """`decode_attention` over an int8 K/V cache (`quantize_kv`'s codes and
    per-(token, head) scales): (B,H,D) x int8 (B,T,K,D) -> (B,H,D) in
    q.dtype."""
    plain = _plain(impl, q, "decode_attention_int8")
    if _is_dtensor(q):
        args = (q, kq, vq, ks, vs, replicated_like(lengths, q))
        kv = {"batch": 0, "heads": 2}
        dims = ({"batch": 0, "heads": 1}, kv, kv, kv, kv, {"batch": 0})
        if not plain or shard_kinds(args, dims)[1] is None:
            return on_shards("flash_decode_int8", _plain_decode_int8
                             if plain else _fd8.flash_decode_int8, args,
                             dims, dims[:1])
        q, kq, vq, ks, vs, lengths = args
    if plain:
        return _plain_decode_int8(q, kq, vq, ks, vs, lengths)
    return _fd8.flash_decode_int8(q, kq, vq, ks, vs, lengths)


def _plain_decode_int8(q, kq, vq, ks, vs, lengths):
    _fd8.check_inputs(q, kq, vq, ks, vs, lengths)
    return flash_decode_int8_ref(q, kq, vq, ks, vs, lengths).to(q.dtype)


def ssd_scan(xt: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
             lA: torch.Tensor, *, impl: Optional[str] = None):
    """Mamba2 SSD scan from a zero state: (y (B,S,nh,hd), final state
    (B,nh,hd,ds)), float32.  The prefill's scan; the kernel has no
    backward, and `forward(mode="train")` takes `models.ssm.
    mamba2_chunk_scan` instead."""
    if _is_dtensor(xt) and not _plain(impl, xt, "ssd_scan"):
        bh = {"batch": 0, "heads": 2}
        return on_shards(
            "mamba_scan", _ms.mamba_scan, (xt, Bm, Cm, lA),
            (bh, {"batch": 0}, {"batch": 0}, bh),
            (bh, {"batch": 0, "heads": 1}))
    if _plain(impl, xt, "ssd_scan"):
        _ms.check_inputs(xt, Bm, Cm, lA)
        return mamba_scan_ref(xt, Bm, Cm, lA)
    return _ms.mamba_scan(xt, Bm, Cm, lA)


def wkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, *,
             impl: Optional[str] = None):
    """RWKV6 recurrence from a zero state: (out (B,S,H,hd), final state
    (B,H,hd,hd)), float32.  The prefill's scan; the kernel has no
    backward, and `forward(mode="train")` takes `models.ssm.
    wkv6_chunk_scan` instead."""
    if _is_dtensor(r) and not _plain(impl, r, "wkv_scan"):
        bh = {"batch": 0, "heads": 2}
        return on_shards(
            "wkv6", _wk.wkv6, (r, k, v, w, u), (bh, bh, bh, bh, {"heads": 0}),
            (bh, {"batch": 0, "heads": 1}))
    if _plain(impl, r, "wkv_scan"):
        _wk.check_inputs(r, k, v, w, u)
        return wkv6_ref(r, k, v, w, u)
    return _wk.wkv6(r, k, v, w, u)
