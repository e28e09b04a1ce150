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

from .common import (_is_dtensor, all_to_all, apply_rope, axis_size,
                     batch_axes, constrain, dense_init, dot, dtype_of,
                     heads_spec, on_shards, onto_rows, pad, rms_norm,
                     roll, seq_dims, shard_kinds, shard_range,
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


def _split_heads(t: torch.Tensor, n: int, hd: int, spec, *,
                 bind_grad: bool = True) -> torch.Tensor:
    """(B, S, n * hd) -> (B, S, n, hd).  Under a mesh the projection's
    columns are first placed whole heads to a shard: over `model` where
    `spec` (`heads_spec`, `_q_spec`) names it, else replicated (DTensor
    cannot split a sharded dimension whose shards straddle heads).
    `bind_grad=False` leaves the gradient to DTensor (`constrain`)."""
    B, S = t.shape[:2]
    t = constrain(t, "BATCH", None, spec, bind_grad=bind_grad)
    return t.reshape(B, S, n, hd)


def _merge_heads(out: torch.Tensor, spec) -> torch.Tensor:
    """(B, S, H, hd) -> (B, S, H * hd), placed as `_split_heads` placed
    the heads: the gradient that flows back into the reshape is then
    placed so too (a shard of H * hd that straddles heads cannot be
    viewed back as heads)."""
    B, S = out.shape[:2]
    return constrain(out.reshape(B, S, -1), "BATCH", None, spec)


def _q_split(cfg) -> Optional[str]:
    """How full-sequence attention splits its queries over the ambient
    mesh's `model` axis: "heads", each rank attends its own q heads (the
    KV heads divide `model`, or `model` spans whole KV groups whose q
    heads divide it: each rank then attends against its group's KV head,
    `flash_attention`); "rows", `model` spans whole KV groups whose q
    heads straddle its ranks (llava's 56 heads over 16): each rank attends
    a balanced share of the q rows with every head (`_rows_attention`);
    None, every rank attends every query (neither divides)."""
    m, K = axis_size("model"), cfg.n_kv_heads
    if K % m == 0 or "model" in batch_axes():
        return "heads"
    if m % K:
        return None
    if cfg.n_heads % m == 0:
        return "heads"
    return "rows" if cfg.n_heads * cfg.hd % m == 0 else None


def _q_spec(cfg):
    """The spec entry of q's heads (`_q_split`)."""
    return "model" if _q_split(cfg) == "heads" else None


def _qkv(params, cfg, x, *, rope_positions=None, q_spec=None,
         split_q: bool = True):
    """q, k, v of x, RoPE'd at `rope_positions` where given: k and v split
    into heads by `heads_spec`, q by `q_spec` (`heads_spec` by default);
    without `split_q` q stays (B, S, H * hd), placed over `model` as its
    projection, and without RoPE (`_rows_attention` takes it)."""
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    x = onto_rows(x, params["wq"])      # a decode step's, once for all three
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    kv_spec = heads_spec(K)
    # K and V gathered whole where their heads do not divide `model` get a
    # partial-sum gradient from the ranks' groups: DTensor reduce-scatters
    # it onto the projection's columns (bound, it would be all-reduced)
    k = _split_heads(k, K, hd, kv_spec, bind_grad=False)
    v = _split_heads(v, K, hd, kv_spec, bind_grad=False)
    if split_q:
        q = _split_heads(q, H, hd, kv_spec if q_spec is None else q_spec)
    else:
        q = constrain(q, "BATCH", None, "model")
    if rope_positions is not None:
        if split_q:
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
    shards (`on_shards`); q heads sharded over more ranks than there are
    KV heads attend their group's KV heads (`_group_attention`).
    Non-causal attention without a window over K/V whose sequence is
    sharded too (decode's cross-attention over a cached encoder K/V,
    which the rules shard so where its KV heads do not divide `model`)
    attends each rank's piece of the keys, and the softmax states are
    merged over the mesh dimensions that shard them (`ops.merge_ranks`);
    it records no gradient.  Any other placement raises.
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
        group = _group_dim(q, k)
        if group is not None:
            return _group_attention(q, k, v, group, kw)
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
        return ops.merge_ranks(torch.cat([out, lse[..., None]], -1), mesh,
                               seq, q.dtype)
    return on_shards("flash_attention", merged, (q, k, v), dims, dims[:1])


def _group_dim(q, k) -> Optional[int]:
    """The mesh dimension (of more than one rank) that shards q's heads
    where k's KV heads lie whole and do not divide its ranks: `model`
    spanning whole KV groups (`_q_split`); None where there is none."""
    mesh = q.device_mesh
    for m, (pq, pk) in enumerate(zip(q.placements, k.placements)):
        if pq.is_shard(2) and not pk.is_shard() and mesh.size(m) > 1 \
                and k.shape[2] % mesh.size(m):
            return m
    return None


def _group_attention(q, k, v, m: int, kw: dict):
    """Attention whose q heads are sharded over mesh dimension m, more
    ranks than KV heads: each rank attends its q heads against the KV
    heads of their group, sliced from k and v, which lie whole there
    (gathered from their projection's columns).  Their gradient is then
    a partial sum over the group's ranks (`on_shards`), which the
    projection's redistribution reduces."""
    H, K = q.shape[2], k.shape[2]
    G = H // K
    h0, nh = shard_range(q, 2)
    if not (G % nh == 0 or nh % G == 0 and h0 % G == 0):
        raise NotImplementedError(
            f"flash_attention: {nh} q heads a rank do not split or hold"
            f" whole GQA groups of {G}")
    g0, g1 = h0 // G, (h0 + nh - 1) // G + 1

    def local(q, k, v):
        return _flash_attention(q, k[:, :, g0:g1], v[:, :, g0:g1], **kw)

    b = {"batch": 0}
    dims = ({"batch": 0, "heads": 2}, b, b)
    return on_shards("flash_attention", local, (q, k, v), dims, dims[:1])


def _rows_attention(q, k, v, pos, cfg):
    """Causal attention of q (B, S, H * hd), RoPE not yet applied, whose
    columns are sharded over `model` (the rows of `wo` they meet), against
    whole k, v (B, S, K, hd).  The rows are cut into 2n chunks of L (n the
    ranks of `model`, S zero-padded to 2nL), and rank c attends chunks c
    and 2n - 1 - c with every head, equal shares under the causal mask:
    one all-to-all brings each rank its chunks' columns from every rank,
    and one sends the output's columns back, placed as q.  k's and v's
    gradient is a partial sum over `model`."""
    mesh = q.device_mesh
    md = mesh.mesh_dim_names.index("model")
    n, c = mesh.size(md), mesh.get_local_rank(md)
    H, hd = cfg.n_heads, cfg.hd
    S = q.shape[1]
    L = -(-S // (2 * n))
    chunks = [j for r in range(n) for j in (r, 2 * n - 1 - r)]
    back = [chunks.index(j) for j in range(2 * n)]
    pos = torch.cat([pos, torch.arange(S, 2 * n * L, device=pos.device)])
    kw = dict(causal=True, window=cfg.swa_window, q_chunk=512, kv_chunk=512)

    def local(q, k, v):
        B, _, w = q.shape
        q = pad(q, (0, 0, 0, 2 * n * L - S)).reshape(B, 2 * n, L, w)
        # (n, B, 2L, w): the rows each rank takes, in rank order
        q = q[:, chunks].reshape(B, n, 2 * L, w).transpose(0, 1)
        q = all_to_all(q, mesh, md)      # the columns of rank i's slice
        q = q.permute(1, 2, 0, 3).reshape(B, 2, L, H, hd)
        out = []
        for i, j in enumerate(chunks[2 * c:2 * c + 2]):
            qj = apply_rope(q[:, i], pos[j * L:(j + 1) * L].to(q.device),
                            cfg.rope_theta)
            out.append(_flash_attention(qj, k, v, q_offset=j * L, **kw))
        out = torch.stack(out, 1).reshape(B, 2 * L, n, w).permute(
            2, 0, 1, 3)
        out = all_to_all(out, mesh, md)  # rank i's rows of my columns
        out = out.transpose(0, 1).reshape(B, 2 * n, L, w)[:, back]
        return out.reshape(B, 2 * n * L, w)[:, :S]

    dims = ({"batch": 0, "cols": 2}, {"batch": 0}, {"batch": 0})
    return on_shards("flash_attention", local, (q, k, v), dims, dims[:1])


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
    split = _q_split(cfg) if _is_dtensor(h) else "heads"
    if split == "rows":
        if pos.dim() != 1:
            # the heads branch would attend every head on every rank
            raise NotImplementedError(
                "attention_full: q rows split over `model` (_q_split) at"
                f" batched positions {tuple(pos.shape)}")
        q, k, v = _qkv(params, cfg, h, rope_positions=pos, split_q=False)
        out = _rows_attention(q, k, v, pos, cfg)
    else:
        spec = _q_spec(cfg)
        q, k, v = _qkv(params, cfg, h, rope_positions=pos, q_spec=spec)
        out = _merge_heads(flash_attention(q, k, v, causal=True,
                                           window=cfg.swa_window), spec)
    y = out @ params["wo"]
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
                     heads_spec(cfg.n_kv_heads)) @ params["wo"]
    return x + y


def encoder_attention(params, cfg, x: torch.Tensor) -> torch.Tensor:
    """whisper's encoder self-attention: bidirectional, with no RoPE and
    no bias (its bq/bk/bv are drawn and never read, as in the reference).
    x: (B, F, d), float32 frames in the reference's batches, so the block
    runs in float32 whatever the weights' dtype."""
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    spec = _q_spec(cfg)
    q = _split_heads(dot(h, params["wq"]), H, hd, spec)
    k = _split_heads(dot(h, params["wk"]), K, hd, heads_spec(K))
    v = _split_heads(dot(h, params["wv"]), K, hd, heads_spec(K))
    out = flash_attention(q, k, v, causal=False)
    return x + dot(_merge_heads(out, spec), params["wo"])


def cross_attention_full(params, cfg, x: torch.Tensor,
                         enc_kv: dict) -> torch.Tensor:
    """Decoder cross-attention over precomputed encoder K/V (no mask), as
    in the reference: q from `params["norm"]` (never `q_norm`), no RoPE,
    no bq even where the config has biases.  The encoder's float32 K/V
    and a bfloat16 q meet in float32; the output is cast to q's dtype."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    spec = _q_spec(cfg)
    q = _split_heads(h @ params["wq"], H, hd, spec)
    out = flash_attention(q, enc_kv["k"], enc_kv["v"], causal=False)
    return x + _merge_heads(out, spec) @ params["wo"]


def encode_cross_kv(params, cfg, enc_out: torch.Tensor) -> dict:
    """Cross-attention K/V of the encoder output (B, F, d), which is not
    normalised again; no bk/bv.  Float32 for float32 frames."""
    K, hd = cfg.n_kv_heads, cfg.hd
    return {"k": _split_heads(dot(enc_out, params["wk"]), K, hd,
                              heads_spec(K)),
            "v": _split_heads(dot(enc_out, params["wv"]), K, hd,
                              heads_spec(K))}
