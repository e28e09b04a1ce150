"""GQA attention block: full-sequence (train / prefill), decode, and
whisper's encoder self-attention and decoder cross-attention.

The full-sequence paths are plain PyTorch, as the reference computes them
in jnp outside any Pallas kernel: `flash_attention`, the reference's
chunked online softmax with scores in f32 (512 x 512 a block), causal
(banded for sliding-window attention, SWA) or not.  Decode goes
through `kernels.ops.decode_attention`, the hand-written flash-decode
kernel on the card.  SWA decode uses a ring-buffer KV cache of `window`
slots.  Cross-attention reads encoder K/V that `encode_cross_kv` computes
once per sequence, at training, prefill and every decode step alike.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels import ops
from torch.utils.checkpoint import checkpoint

from .common import (_is_dtensor, apply_rope, constrain, dense_init, dot,
                     dtype_of, gather_states, heads_spec, on_shards, pad,
                     rms_norm, roll, seq_dims, shard_kinds, shard_range,
                     whole_where_seq)

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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    q_chunk: int = 512, kv_chunk: int = 512) -> torch.Tensor:
    """Chunked online-softmax GQA attention, the reference's
    `flash_attention`: scores in f32, one (q_chunk x kv_chunk) block of them
    at a time.

    q: (B, S, H, D); k, v: (B, T, K, D) with H = K * G.  Query i sits at
    position q_offset + i and key t at position t; `causal` keeps
    t <= q_pos, and `window` > 0 further keeps t > q_pos - window.  q, k
    and v are zero-padded to whole chunks and the pad keys masked.
    Returns (B, S, H, D) in q.dtype.

    A (q chunk, kv chunk) pair that the masks leave empty for every query
    of the chunk is skipped, which is exact wherever every query has at
    least one key (checked per q chunk; otherwise no pair of that chunk is
    skipped): an empty chunk after a valid one leaves (m, l, acc) as they
    are (p = 0, corr = 1), and an empty chunk before any valid one is
    wiped by the first valid one (corr = exp(-1e30 - m) = 0).  That skips
    the chunks above the causal diagonal and those wholly before a
    sliding window.  A pair that no mask cuts is not masked.

    Where autograd records the call, each q chunk is checkpointed
    (`torch.utils.checkpoint`, as the reference's `jax.checkpoint`): the
    backward recomputes its scores instead of keeping them.  DTensors
    whose batch or heads alone are sharded are attended on each rank's
    shards (`on_shards`).  Non-causal attention without a window over K/V
    whose sequence is sharded too (decode's cross-attention over a cached
    encoder K/V, which the rules shard so where its KV heads do not divide
    `model`) attends each rank's piece of the keys, and the softmax
    states, all-gathered over the mesh dimensions that shard them, are
    merged (`ops.merge_pieces`); it records no gradient.  Any other
    placement raises.
    """
    kw = dict(causal=causal, window=window, q_offset=int(q_offset),
              q_chunk=q_chunk, kv_chunk=kv_chunk)
    if not _is_dtensor(q):
        return _flash_attention(q, k, v, **kw)
    q = whole_where_seq(q, k)
    kv = {"batch": 0, "heads": 2, "seq": 1}
    dims = ({"batch": 0, "heads": 2}, kv, kv)
    seq = seq_dims(k) if shard_kinds((q, k, v), dims)[0] else []
    if not seq:
        return on_shards("flash_attention", functools.partial(
            _flash_attention, **kw), (q, k, v), dims, dims[:1])
    if causal or window or torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention merges over a sharded key sequence only"
            " without masks and without gradients (cross-attention decode)")
    mesh = k.device_mesh

    def merged(q, k, v):
        out, lse = _flash_attention(q, k, v, **kw, state=True)
        both = gather_states(torch.cat([out, lse[..., None]], -1), mesh,
                             seq)
        return ops.merge_pieces(both, q.dtype)
    return on_shards("flash_attention", merged, (q, k, v), dims, dims[:1])


def _kv_chunks(a: int, b: int, *, kc: int, nk: int, T: int, causal: bool,
               window: int) -> range:
    """The kv chunks a q chunk whose real queries sit at positions a..b
    attends to: all of them where a query has no key at all, else those
    the masks leave non-empty for some query (see `flash_attention`)."""
    def has_key(p):
        lo = max(0, p - window + 1) if window else 0
        return lo <= (min(T - 1, p) if causal else T - 1)

    if not (has_key(a) and has_key(b)):     # the keyed queries: an interval
        return range(nk)
    lo = max(0, (a - window + 1) // kc) if window else 0
    hi = min(nk, b // kc + 1) if causal else nk
    return range(lo, hi)


def _flash_attention(q, k, v, *, causal: bool, window: int, q_offset: int,
                     q_chunk: int, kv_chunk: int, state: bool = False):
    """`flash_attention` on plain tensors (each rank's shards; the dry run
    traces it once per signature, `launch.dryrun`): (B, S, H, D) in
    q.dtype, or with `state` the f32 output and its softmax state
    lse = m + ln l (B, S, H), with which outputs over pieces of the keys
    merge."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    scale = float(np.float32(1.0) / np.sqrt(np.float32(D)))
    qc, kc = min(q_chunk, S), min(kv_chunk, T)
    nq, nk = -(-S // qc), -(-T // kc)
    qs = pad(q, (0, 0, 0, 0, 0, nq * qc - S)).reshape(B, nq, qc, K, G, D)
    # K^T and V chunk-major in their own dtype, (B, K) folded into one
    # batch dimension: (nk, B K, D, kc) and (nk, B K, kc, D); a pair takes
    # its kv chunk to f32 (`_q_chunk`), as the reference's scan does
    kt = pad(k, (0, 0, 0, 0, 0, nk * kc - T)).reshape(
        B, nk, kc, K, D).permute(1, 0, 3, 4, 2).reshape(nk, B * K, D, kc)
    vt = pad(v, (0, 0, 0, 0, 0, nk * kc - T)).reshape(
        B, nk, kc, K, D).permute(1, 0, 3, 2, 4).reshape(nk, B * K, kc, D)
    record = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    if record:
        # whole in f32 under autograd: K's and V's gradients then sum over
        # the q chunks in f32 and round once
        kt, vt = kt.float(), vt.float()
    outs = []
    for qi in range(nq):
        q0 = q_offset + qi * qc
        chunks = _kv_chunks(q0, q_offset + min(S, (qi + 1) * qc) - 1, kc=kc,
                            nk=nk, T=T, causal=causal, window=window)
        fn = functools.partial(_q_chunk, q0=q0, chunks=chunks, kc=kc, T=T,
                               causal=causal, window=window, scale=scale,
                               state=state)
        if record:
            # nothing random inside: no RNG state to keep for the recompute
            outs.append(checkpoint(fn, qs[:, qi], kt, vt,
                                   use_reentrant=False,
                                   preserve_rng_state=False))
        else:
            outs.append(fn(qs[:, qi], kt, vt))
    if state:
        out, lse = (torch.cat(t, 1)[:, :S] for t in zip(*outs))
        return out, lse
    out = torch.cat(outs, 1) if nq > 1 else outs[0]
    return out[:, :S].to(q.dtype)


def _q_chunk(q_blk, kt, vt, *, q0: int, chunks: range, kc: int, T: int,
             causal: bool, window: int, scale: float, state: bool = False):
    """One q chunk (B, qc, K, G, D) against kv chunks `chunks` of kt, vt
    (`_flash_attention`'s layouts): the reference's online softmax, its
    (B, K, G, qc) rows flattened to (B K, G qc); (B, qc, H, D) f32, and
    with `state` lse (B, qc, H)."""
    B, qc, K, G, D = q_blk.shape
    dev = q_blk.device
    qg = q_blk.float().permute(0, 2, 3, 1, 4).reshape(B * K, G * qc, D)
    q_pos = torch.arange(q0, q0 + qc, device=dev)[:, None]
    m = torch.full((B * K, G * qc, 1), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B * K, G * qc, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B * K, G * qc, D), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    kts, vts = kt.unbind(0), vt.unbind(0)
    for kj in chunks:
        t0 = kj * kc
        s = torch.baddbmm(zero, qg, kts[kj].float(), beta=0, alpha=scale)
        # the masks, where they cut this pair at all
        if (causal and t0 + kc - 1 > q0) or t0 + kc > T \
                or (window and t0 <= q0 + qc - 1 - window):
            k_pos = torch.arange(t0, t0 + kc, device=dev)[None, :]
            mask = k_pos < T
            if causal:
                mask = mask & (k_pos <= q_pos)
            if window:
                mask = mask & (k_pos > q_pos - window)
            s = s.view(B * K, G, qc, kc).masked_fill(~mask, NEG_INF).view(
                B * K, G * qc, kc)
        # the running max only steadies the exponentials: the output does
        # not depend on it, so no gradient flows through it (the backward
        # then keeps p alone a pair, not s and acc too)
        m_new = torch.maximum(m, s.detach().amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = torch.addcmul(p.sum(-1, keepdim=True), l, corr)
        acc = torch.baddbmm(acc * corr, p, vts[kj].float())
        m = m_new
    out = (acc / l.clamp(min=1e-30)).view(B, K, G, qc, D)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, qc, K * G, D)
    if not state:
        return out
    lse = (m + torch.log(l)).view(B, K, G, qc).permute(0, 3, 1, 2)
    return out, lse.reshape(B, qc, K * G)


def attention_full(params, cfg, x: torch.Tensor, *, positions=None,
                   mode: str = "train",
                   ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Full-sequence attention (train / prefill). Returns (y, cache|None).
    `positions` (RoPE's, default 0..S-1) as in the reference; the mask
    counts queries from 0 there too."""
    B, S, _ = x.shape
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    pos = positions if positions is not None \
        else torch.arange(S, device=x.device)
    q, k, v = _qkv(params, cfg, h, rope_positions=pos)
    out = flash_attention(q, k, v, causal=True, window=cfg.swa_window)
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
    out = flash_attention(q, k, v, causal=False)
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
    out = flash_attention(q, enc_kv["k"], enc_kv["v"], causal=False)
    return x + _merge_heads(out, cfg.n_kv_heads) @ params["wo"]


def encode_cross_kv(params, cfg, enc_out: torch.Tensor) -> dict:
    """Cross-attention K/V of the encoder output (B, F, d), which is not
    normalised again; no bk/bv.  Float32 for float32 frames."""
    K, hd = cfg.n_kv_heads, cfg.hd
    return {"k": _split_heads(dot(enc_out, params["wk"]), K, hd, K),
            "v": _split_heads(dot(enc_out, params["wv"]), K, hd, K)}
