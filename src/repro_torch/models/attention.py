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
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels import ops
from .common import apply_rope, dense_init, dot, dtype_of, rms_norm

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


def _qkv(params, cfg, x, *, rope_positions=None):
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, K, hd)
    v = v.reshape(B, S, K, hd)
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
    q.dtype.
    """
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
        s = s.masked_fill(~mask, NEG_INF)
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
    y = out.reshape(B, S, -1) @ params["wo"]
    cache = None
    if mode == "prefill":
        if cfg.swa_window:
            # ring-buffer layout: position p lives in slot p % W, matching
            # attention_decode's write pattern past the wrap point
            W = min(cfg.swa_window, S)
            kw, vw = k[:, S - W:], v[:, S - W:]
            if S > W:
                kw = torch.roll(kw, S % W, dims=1)
                vw = torch.roll(vw, S % W, dims=1)
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
        written as the kernel's `t < lengths`.
    """
    pos: torch.Tensor
    rows: torch.Tensor
    slots: torch.Tensor
    lengths: torch.Tensor


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
                       slots=as_t(slot[rows]), lengths=as_t(lengths))


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
    cache["k"][idx.rows, idx.slots] = k_new[idx.rows, 0]
    cache["v"][idx.rows, idx.slots] = v_new[idx.rows, 0]
    out = ops.decode_attention(q[:, 0], cache["k"], cache["v"], idx.lengths,
                               impl=impl)
    y = out.to(x.dtype).reshape(B, 1, -1) @ params["wo"]
    return x + y


def encoder_attention(params, cfg, x: torch.Tensor) -> torch.Tensor:
    """whisper's encoder self-attention: bidirectional, with no RoPE and
    no bias (its bq/bk/bv are drawn and never read, as in the reference).
    x: (B, F, d), float32 frames in the reference's batches, so the block
    runs in float32 whatever the weights' dtype."""
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    q = dot(h, params["wq"]).reshape(B, S, H, hd)
    k = dot(h, params["wk"]).reshape(B, S, K, hd)
    v = dot(h, params["wv"]).reshape(B, S, K, hd)
    out = direct_attention(q, k, v, causal=False)
    return x + dot(out.reshape(B, S, -1), params["wo"])


def cross_attention_full(params, cfg, x: torch.Tensor,
                         enc_kv: dict) -> torch.Tensor:
    """Decoder cross-attention over precomputed encoder K/V (no mask), as
    in the reference: q from `params["norm"]` (never `q_norm`), no RoPE,
    no bq even where the config has biases.  The encoder's float32 K/V
    and a bfloat16 q meet in float32; the output is cast to q's dtype."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    q = (h @ params["wq"]).reshape(B, S, H, hd)
    out = direct_attention(q, enc_kv["k"], enc_kv["v"], causal=False)
    return x + out.reshape(B, S, -1) @ params["wo"]


def encode_cross_kv(params, cfg, enc_out: torch.Tensor) -> dict:
    """Cross-attention K/V of the encoder output (B, F, d), which is not
    normalised again; no bk/bv.  Float32 for float32 frames."""
    B, T, _ = enc_out.shape
    K, hd = cfg.n_kv_heads, cfg.hd
    return {"k": dot(enc_out, params["wk"]).reshape(B, T, K, hd),
            "v": dot(enc_out, params["wv"]).reshape(B, T, K, hd)}
