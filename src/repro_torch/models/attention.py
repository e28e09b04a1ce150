"""GQA attention block: full-sequence (train / prefill), decode, and
whisper's encoder self-attention and decoder cross-attention.

The full-sequence paths are plain PyTorch, as the reference computes them
in jnp outside any Pallas kernel: direct softmax with scores in f32,
causal (banded for sliding-window attention, SWA) or not.  Decode goes
through `kernels.ops.decode_attention`, the hand-written flash-decode
kernel on the card.  SWA decode uses a ring-buffer KV cache of `window`
slots.  Cross-attention reads encoder K/V that `encode_cross_kv` computes
once per sequence, at training, prefill and every decode step alike.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels import ops
from .common import (_is_dtensor, apply_rope, constrain, dense_init, dot,
                     dtype_of, heads_spec, on_shards, replicated_like,
                     rms_norm, roll, shard_kinds, shard_range)

NEG_INF = -1e30


def init_attention(generator: torch.Generator, cfg, device: torch.device,
                   *, cross: bool = False) -> dict:
    """A self- or (`cross`) cross-attention block's weights.  A
    cross-attention block also gets `q_norm`, which, as in the reference,
    nothing reads."""
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = dtype_of(cfg)
    p = {
        "norm": torch.ones(d, dtype=torch.float32, device=device),
        "wq": dense_init(generator, (d, H * hd), dtype=dt, device=device),
        "wk": dense_init(generator, (d, K * hd), dtype=dt, device=device),
        "wv": dense_init(generator, (d, K * hd), dtype=dt, device=device),
        "wo": dense_init(generator, (H * hd, d), dtype=dt, device=device),
    }
    if cfg.attn_bias:
        for name, width in (("bq", H * hd), ("bk", K * hd), ("bv", K * hd)):
            p[name] = torch.zeros(width, dtype=dt, device=device)
    if cross:
        p["q_norm"] = torch.ones(d, dtype=torch.float32, device=device)
    return p


def _split_heads(t: torch.Tensor, n: int, hd: int,
                 kv_heads: int) -> torch.Tensor:
    """(B, S, n * hd) -> (B, S, n, hd).  Under a mesh the projection's
    columns are first placed whole KV groups to a shard: over `model`
    where the `kv_heads` divide it, else replicated (DTensor cannot split
    a sharded dimension whose shards straddle heads or GQA groups)."""
    B, S = t.shape[:2]
    t = constrain(t, "BATCH", None, heads_spec(kv_heads))
    return t.reshape(B, S, n, hd)


def _merge_heads(out: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """(B, S, H, hd) -> (B, S, H * hd), placed as `_split_heads` places
    the heads: the gradient that flows back into the reshape is then
    placed so too (a shard of H * hd that straddles heads cannot be
    viewed back as heads)."""
    B, S = out.shape[:2]
    return constrain(out.reshape(B, S, -1), "BATCH", None,
                     heads_spec(kv_heads))


def _qkv(params, cfg, x, *, rope_positions=None):
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = _split_heads(q, H, hd, K)
    k = _split_heads(k, K, hd, K)
    v = _split_heads(v, K, hd, K)
    if rope_positions is not None:
        q = apply_rope(q, rope_positions, cfg.rope_theta)
        k = apply_rope(k, rope_positions, cfg.rope_theta)
    return q, k, v


def direct_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True, window: int = 0) -> torch.Tensor:
    """Direct-softmax GQA attention, scores in f32: the reference's
    `flash_attention` without its chunking.

    q: (B, S, H, D); k, v: (B, T, K, D) with H = K * G.  Query i sits at
    position i and key t at position t; `causal` keeps t <= i, and
    `window` > 0 further keeps t > i - window.  Returns (B, S, H, D) in
    q.dtype.  DTensors whose batch or heads alone are sharded are attended
    on each rank's shards (`on_shards`: the work is local, and DTensor's
    propagation of the einsums over batch and heads sharded at once
    fails); others go through DTensor's propagation.
    """
    fn = functools.partial(_direct_attention, causal=causal, window=window)
    if _is_dtensor(q):
        dims = ({"batch": 0, "heads": 2},) * 3
        if shard_kinds((q, k, v), dims)[1] is None:
            return on_shards("direct_attention", fn, (q, k, v), dims,
                             dims[:1])
    return fn(q, k, v)


def _direct_attention(q, k, v, *, causal: bool, window: int):
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qh = q.reshape(B, S, K, G, D).float()
    s = torch.einsum("bskgd,btkd->bkgst", qh, k.float()) / math.sqrt(D)
    if causal or window:
        q_pos = torch.arange(S, device=q.device)[:, None]
        k_pos = torch.arange(T, device=q.device)[None, :]
        mask = torch.ones(S, T, dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos <= q_pos
        if window:
            mask &= k_pos > q_pos - window
        s = s.masked_fill(~replicated_like(mask, s), NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)


def attention_full(params, cfg, x: torch.Tensor, *, mode: str = "train",
                   ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Full-sequence attention (train / prefill). Returns (y, cache|None)."""
    B, S, _ = x.shape
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    pos = torch.arange(S, device=x.device)
    q, k, v = _qkv(params, cfg, h, rope_positions=pos)
    out = direct_attention(q, k, v, window=cfg.swa_window)
    y = _merge_heads(out, cfg.n_kv_heads) @ params["wo"]
    cache = None
    if mode == "prefill":
        if cfg.swa_window:
            # ring-buffer layout: position p lives in slot p % W, matching
            # attention_decode's write pattern past the wrap point
            W = min(cfg.swa_window, S)
            kw, vw = k[:, S - W:], v[:, S - W:]
            if S > W:
                kw = roll(kw, S % W, 1)
                vw = roll(vw, S % W, 1)
            cache = {"k": kw, "v": vw}
        else:
            cache = {"k": k, "v": v}
    return x + y, cache


@dataclasses.dataclass(frozen=True)
class DecodeIndex:
    """Where one decode step writes and how far it reads, per sequence.

    pos: (B,) absolute position of the new token (RoPE);
    rows, slots: the cache writes (row b gets slot slots[i] for b =
        rows[i]); positions past a non-ring cache are left out, as the
        reference's out-of-bounds `.at[].set` is dropped;
    lengths: (B,) int32 valid cache entries for the kernel, min(pos+1, T):
        the reference's `t <= pos` (`t <= min(pos, T-1)` on the SWA ring)
        written as the kernel's `t < lengths`;
    host_rows, host_slots: rows and slots as host arrays, from which a
        DTensor cache's shard picks the writes it holds.
    """
    pos: torch.Tensor
    rows: torch.Tensor
    slots: torch.Tensor
    lengths: torch.Tensor
    host_rows: Optional[np.ndarray] = None
    host_slots: Optional[np.ndarray] = None


def decode_index(cfg, pos, batch: int, cache_len: int,
                 device: torch.device) -> DecodeIndex:
    """Built on the host once per decode step from host positions (the
    engine keeps them in numpy) and shared by every layer."""
    pos = np.broadcast_to(np.asarray(pos, np.int64), (batch,))
    slot = pos % cache_len if cfg.swa_window else pos
    rows = np.flatnonzero(slot < cache_len)
    lengths = np.minimum(pos + 1, cache_len).astype(np.int32)

    def as_t(a):
        return torch.as_tensor(np.array(a), device=device)

    return DecodeIndex(pos=as_t(pos), rows=as_t(rows),
                       slots=as_t(slot[rows]), lengths=as_t(lengths),
                       host_rows=rows, host_slots=slot[rows])


def write_kv(slab: torch.Tensor, idx: DecodeIndex,
             new: torch.Tensor) -> None:
    """slab[rows, slots] = new[rows, 0] in place: slab (B, T, K, D), new
    (B, 1, K, D).  On a DTensor slab, each rank writes the rows and slots
    its shard holds, from `new` placed as the slab but whole along T (one
    token has no T to shard): a write moves one row, wherever the cache's
    batch, sequence or heads lie."""
    if not _is_dtensor(slab):
        slab[idx.rows, idx.slots] = new[idx.rows, 0]
        return
    from torch.distributed.tensor import Replicate
    new = new.redistribute(slab.device_mesh, tuple(
        Replicate() if p.is_shard(1) else p for p in slab.placements))
    local, new_local = slab.to_local(), new.to_local()
    (b0, nb), (t0, nt) = shard_range(slab, 0), shard_range(slab, 1)
    rows, slots = idx.host_rows, idx.host_slots
    mine = (rows >= b0) & (rows < b0 + nb) & (slots >= t0) \
        & (slots < t0 + nt)
    r = torch.as_tensor(rows[mine] - b0, device=local.device)
    t = torch.as_tensor(slots[mine] - t0, device=local.device)
    local[r, t] = new_local[r, 0]


def attention_decode(params, cfg, x: torch.Tensor, cache: dict,
                     idx: DecodeIndex, *, impl: Optional[str] = None,
                     ) -> torch.Tensor:
    """One-token decode against a KV cache, updated in place.

    cache["k"]/["v"]: (B, T, K, D).  For SWA, T == window and the cache is a
    ring buffer indexed pos % window; otherwise slots are absolute.  The
    reference returns a new cache (JAX arrays are immutable); here the new
    K/V row is written into the given tensors, which saves a copy of the
    whole slab per layer.
    """
    B = x.shape[0]
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    q, k_new, v_new = _qkv(params, cfg, h, rope_positions=idx.pos[:, None])
    write_kv(cache["k"], idx, k_new)
    write_kv(cache["v"], idx, v_new)
    out = ops.decode_attention(q[:, 0], cache["k"], cache["v"], idx.lengths,
                               impl=impl)
    y = _merge_heads(out.to(x.dtype).reshape(B, 1, *out.shape[1:]),
                     cfg.n_kv_heads) @ params["wo"]
    return x + y


def encoder_attention(params, cfg, x: torch.Tensor) -> torch.Tensor:
    """whisper's encoder self-attention: bidirectional, with no RoPE and
    no bias (its bq/bk/bv are drawn and never read, as in the reference).
    x: (B, F, d), float32 frames in the reference's batches, so the block
    runs in float32 whatever the weights' dtype."""
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    q = _split_heads(dot(h, params["wq"]), H, hd, K)
    k = _split_heads(dot(h, params["wk"]), K, hd, K)
    v = _split_heads(dot(h, params["wv"]), K, hd, K)
    out = direct_attention(q, k, v, causal=False)
    return x + dot(_merge_heads(out, K), params["wo"])


def cross_attention_full(params, cfg, x: torch.Tensor,
                         enc_kv: dict) -> torch.Tensor:
    """Decoder cross-attention over precomputed encoder K/V (no mask), as
    in the reference: q from `params["norm"]` (never `q_norm`), no RoPE,
    no bq even where the config has biases.  The encoder's float32 K/V
    and a bfloat16 q meet in float32; the output is cast to q's dtype."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    q = _split_heads(h @ params["wq"], H, hd, cfg.n_kv_heads)
    out = direct_attention(q, enc_kv["k"], enc_kv["v"], causal=False)
    return x + _merge_heads(out, cfg.n_kv_heads) @ params["wo"]


def encode_cross_kv(params, cfg, enc_out: torch.Tensor) -> dict:
    """Cross-attention K/V of the encoder output (B, F, d), which is not
    normalised again; no bk/bv.  Float32 for float32 frames."""
    K, hd = cfg.n_kv_heads, cfg.hd
    return {"k": _split_heads(dot(enc_out, params["wk"]), K, hd, K),
            "v": _split_heads(dot(enc_out, params["wv"]), K, hd, K)}
