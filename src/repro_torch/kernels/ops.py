"""Dispatch the model calls: the kernel, or its plain version on request.

Mirrors the reference's `kernels/ops.py`, with one rule in place of its
backend and environment switches, held here and nowhere else: a CUDA
tensor launches the hand-written kernel (or raises), a CPU tensor takes
the plain version, and only an explicit `impl="plain"` runs the plain
version on the card.

DTensor arguments: each rank runs on its local shards (`on_shards`, a
`local_map`) where the placements keep the work local: batch or (KV)
heads sharded, the scans' S whole; the result is a DTensor placed as the
query.  The decode's KV sequence T may be sharded too: each rank attends
to its T-shard and keeps the softmax state with the output
(`decode_piece`), the states are all-gathered over the mesh dimensions
that shard T, and `merge_pieces` merges them (the kernel on the card, the
plain version on the CPU or under impl="plain", alike).  Any other placement raises
NotImplementedError, on the card and off it.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models.common import (_is_dtensor, gather_states, on_shards,
                             replicated_like, seq_dims, shard_kinds,
                             shard_range, whole_where_seq)
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
        q = whole_where_seq(q, k)
        args = (q, k, v, replicated_like(lengths, q))
        kv = {"batch": 0, "heads": 2, "seq": 1}
        dims = ({"batch": 0, "heads": 1}, kv, kv, {"batch": 0})
        seq = seq_dims(k) if shard_kinds(args, dims)[0] else []
        if seq:
            mesh, (t0, nt) = k.device_mesh, shard_range(k, 1)

            def fn(*local):
                piece = decode_piece(*local, t0, nt, impl=impl)
                return merge_pieces(gather_states(piece, mesh, seq),
                                    local[0].dtype)
        else:
            fn = _plain_decode if plain else _fd.flash_decode
        return on_shards("flash_decode", fn, args, dims, dims[:1])
    if plain:
        return _plain_decode(q, k, v, lengths)
    return _fd.flash_decode(q, k, v, lengths)


def _plain_decode(q, k, v, lengths):
    _fd.check_inputs(q, k, v, lengths)
    return flash_decode_ref(q, k, v, lengths).to(q.dtype)


def decode_piece(q, k, v, lengths, t0: int, nt: int, *,
                 impl: Optional[str] = None) -> torch.Tensor:
    """One rank's share of a decode over a KV cache whose sequence is
    sharded: k, v (B, nt, K, D) hold the keys [t0, t0 + nt), attended at
    the local lengths clamp(lengths - t0, 0, nt).  Returns the f32 output
    with the lse appended, (B, H, D + 1), what the ranks all-gather and
    `merge_pieces` merges.  The kernel on the card, the plain version on
    the CPU or under impl="plain"."""
    lengths = (lengths - t0).clamp(0, nt)
    if _plain(impl, q, "decode_attention"):
        _fd.check_inputs(q, k, v, lengths)
        out, lse = flash_decode_ref(q, k, v, lengths, return_lse=True)
    else:
        out, lse = _fd.flash_decode(q, k, v, lengths, return_lse=True)
    return torch.cat([out, lse[..., None]], -1)


def merge_pieces(states: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """R pieces' `decode_piece` results, (R, B, H, D + 1), merged into the
    decode over their union, (B, H, D) in `dtype`."""
    return merge_decode(states[..., :-1], states[..., -1]).to(dtype)


def merge_decode(outs: torch.Tensor, lses: torch.Tensor) -> torch.Tensor:
    """Attention outputs over R disjoint pieces of the keys merged into the
    output over their union: outs (R, ..., D), lses (R, ...) (each piece's
    softmax state, as `flash_decode_ref(return_lse=True)` gives it: (R, B,
    H, D) and (R, B, H) for decode) -> (..., D) f32.
    w_r = exp(lse_r - max_r lse_r), out = sum_r w_r out_r / sum_r w_r; 0
    where every lse is -inf (no piece attends to anything), as the plain
    version's zero output."""
    outs, lses = outs.float(), lses.float()
    top = lses.amax(0)
    w = torch.exp(lses - torch.where(torch.isfinite(top), top, 0.0))
    den = w.sum(0)
    num = (w[..., None] * outs).sum(0)
    return torch.where(den[..., None] > 0,
                       num / den.clamp(min=1e-30)[..., None], 0.0)


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
