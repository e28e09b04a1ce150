"""Recurrent blocks: Mamba2 (SSD) and RWKV6 (Finch) time/channel mix.

Both are O(1)-state decoders, the architectures for which the paper's 1/W
law weakens: no per-token KV growth.  A full-sequence block takes one of
two scans, by `mode`:

  * mode="train": the reference's chunk scans, `mamba2_chunk_scan` and
    `wkv6_chunk_scan` below, plain tensor code that autograd
    differentiates on every device, as the reference trains its blocks
    through its jnp chunk scans;
  * mode="prefill": `kernels.ops` (`ssd_scan`, `wkv_scan`), the
    hand-written kernel on the card (no backward pass: it refuses to be
    recorded by autograd) and the plain sequential scan on the CPU.

Decode takes one plain step per token, as the reference does.

`wkv6_chunk_scan` does not copy the reference's factored form as it
stands: `k * exp(-cw)` about a 64-token chunk's start overflows float32
once the chunk's summed log-decay passes ~88, a mean w below ~0.25
(ROADMAP C2).  It takes the same factored form over blocks of at most
SUB_CHUNK = 16 tokens, factored about each block's middle token, with the
state carried from block to block: every exponent is then at most
8 |log w|, finite for w >= 2e-5 on every token (the tests hold it at w =
0.05 and 0.2 on every token of a 64-token chunk, where the reference's is
not finite).  Wherever the reference is finite the two agree to rounding.
`mamba2_chunk_scan` sums each pair's log-decay directly instead of
differencing the chunk's cumulative sum, which loses digits at zamba2's
decays (ROADMAP C12).

Conventions:
  Mamba2:  S_t = exp(A dt_t) S_{t-1} + dt_t x_t (x) B_t ;  y_t = C_t . S_t + D x_t
  RWKV6:   out_t = r_t (S_{t-1} + diag(u) k_t^T v_t) ;
           S_t = diag(w_t) S_{t-1} + k_t^T v_t,  w_t data-dependent.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from .common import (_is_dtensor, constrain, dense_init, dtype_of,
                     on_shards, pad, rms_norm, silu)

# ======================================================================
# Mamba2
# ======================================================================


def init_mamba2(generator: torch.Generator, cfg,
                device: torch.device) -> dict:
    d, di, ds, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    dt = dtype_of(cfg)
    conv_ch = di + 2 * ds
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "norm": torch.ones(d, **f32),
        "w_in": dense_init(generator, (d, 2 * di + 2 * ds + nh), dtype=dt,
                           device=device),
        "conv_w": dense_init(generator, (cfg.d_conv, conv_ch), scale=0.5,
                             **f32),
        "conv_b": torch.zeros(conv_ch, **f32),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "dt_bias": torch.zeros(nh, **f32),
        "D": torch.ones(nh, **f32),
        "norm_y": torch.ones(di, **f32),
        "w_out": dense_init(generator, (di, d), dtype=dt, device=device),
    }


def _causal_conv_full(x: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, x: (B,S,C), w: (K,C), zeros before t = 0."""
    K, S = w.shape[0], x.shape[1]
    xp = pad(x, (0, 0, K - 1, 0))
    out = sum(xp[:, j:j + S] * w[j] for j in range(K))
    return out + b


def _mamba_inner(cfg, params, h, conv_state=None):
    """Projection, causal conv and split shared by the full and decode
    paths; `conv_state` (B, d_conv-1, C) given means one decode step.
    A full sequence's conv and silu are taken MAMBA_ROWS rows at a time
    where autograd does not record them (`_conv_silu_rows`)."""
    di, ds, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    w_in = params["w_in"]
    if conv_state is None and not _records(h, w_in):
        # a DTensor weight whole on each rank: the split below needs the
        # product's columns whole, and gathering the (B, S, P) product
        # instead moves and holds it several times over
        w_in = constrain(w_in)
    zxbcdt = h @ w_in
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * ds, nh], dim=-1)
    if conv_state is not None:
        seq = torch.cat([conv_state, xbc.float()], dim=1)  # (B, K, C)
        conv = torch.einsum("bkc,kc->bc", seq,
                            params["conv_w"])[:, None] + params["conv_b"]
        new_conv_state = seq[:, 1:]
        xbc = silu(conv)
    else:
        # the last d_conv-1 inputs in f32, right-aligned; a shorter prompt
        # gets the zeros the conv saw before t = 0 in front (the reference
        # keeps only the prompt's rows there: ROADMAP C7)
        # (a copy of its own: a view would keep the whole (B, S, C)
        # input alive as long as the cache)
        K1 = cfg.d_conv - 1
        new_conv_state = xbc[:, -K1:].to(torch.float32, copy=True)
        if new_conv_state.shape[1] < K1:
            new_conv_state = pad(new_conv_state, (
                0, 0, K1 - new_conv_state.shape[1], 0))
        w, b = params["conv_w"], params["conv_b"]
        if _records(xbc, w, b):
            xbc = silu(_causal_conv_full(xbc.float(), w, b))
        else:
            xbc = _on_rows("mamba2_conv", _conv_silu_rows, (xbc,), (w, b))
            # z of its own: the projection's other columns, which only the
            # conv read, are let go before the scan
            z = z.contiguous()
    xs, Bm, Cm = torch.split(xbc, [di, ds, ds], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    xh = xs.reshape(xs.shape[0], xs.shape[1], nh, cfg.ssm_head_dim)
    return z, xh, Bm, Cm, dt, A, new_conv_state


def _mamba_out(params, cfg, x, z, y):
    """x + the gated, normed y projected back.  Where autograd does not
    record it, the gated norm is taken MAMBA_ROWS rows at a time in y's
    own rows, which it overwrites (`_gated_norm_rows`)."""
    if _records(y, z, params["norm_y"]):
        y = rms_norm(y * silu(z.float()), params["norm_y"],
                     cfg.norm_eps).to(x.dtype)
    else:
        y = _on_rows("mamba2_gated_norm", functools.partial(
            _gated_norm_rows, eps=cfg.norm_eps, dtype=x.dtype), (y, z),
            (params["norm_y"],))
    return x + y @ params["w_out"]


# tokens the Mamba2 block's conv, skip term and gated norm take at a time
# where autograd does not record them: every (B, S, C) f32 temporary of
# the whole-sequence form is then a block's, and a prompt of up to this
# many tokens is one block, its ops on the whole-sequence form's shapes
MAMBA_ROWS = 1024


def _row_blocks(S: int):
    for a in range(0, S, MAMBA_ROWS):
        yield a, min(a + MAMBA_ROWS, S)


def _on_rows(name, fn, rows, whole, n_out: int = 1):
    """fn(*rows, *whole), on each rank's batch rows where they are
    DTensors (the work is per row): the per-row inputs `rows`
    batch-sharded and the parameters `whole` replicated first
    (`constrain`); its `n_out` outputs batch-sharded."""
    if not _is_dtensor(rows[0]):
        return fn(*rows, *whole)
    rows = [constrain(a, "BATCH") for a in rows]
    whole = [constrain(a) for a in whole]
    b = {"batch": 0}
    return on_shards(name, fn, rows + whole,
                     [b] * len(rows) + [{}] * len(whole), (b,) * n_out)


def _conv_silu_rows(xbc: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """silu(_causal_conv_full(xbc.float(), w, b)), (B, S, C) f32, taken
    MAMBA_ROWS rows at a time into the one output: a block reads its rows
    and the d_conv - 1 before them (zeros before t = 0) into one f32
    tensor, and sums the K products in its output rows in place, in the
    whole form's order (0 + the first, then the rest, then b), so every
    element's arithmetic is the whole form's."""
    B, S, C = xbc.shape
    K1 = w.shape[0] - 1
    out = xbc.new_empty((B, S, C), dtype=torch.float32)
    for a, e in _row_blocks(S):
        lo = max(a - K1, 0)
        xp = xbc.new_zeros((B, e - a + K1, C), dtype=torch.float32)
        xp[:, K1 - (a - lo):] = xbc[:, lo:e]
        acc = out[:, a:e].zero_()
        for j in range(K1 + 1):
            acc.add_(xp[:, j:j + e - a] * w[j])
        del xp
        acc.add_(b).mul_(torch.sigmoid(acc))               # silu
    return out


def _plus_Dx(y: torch.Tensor, xh: torch.Tensor,
             D: torch.Tensor) -> torch.Tensor:
    """y + xh D, the scan's skip term (B, S, nh, hd); added into y in
    place, MAMBA_ROWS rows at a time, where autograd does not record
    it."""
    if _records(y, xh, D):
        return y + xh * D[None, None, :, None]
    return _on_rows("mamba2_skip", _plus_Dx_rows, (y, xh), (D,))


def _plus_Dx_rows(y, xh, D):
    D = D[None, None, :, None]
    for a, e in _row_blocks(y.shape[1]):
        y[:, a:e].add_(xh[:, a:e] * D)
    return y


def _gated_norm_rows(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                     *, eps: float, dtype: torch.dtype) -> torch.Tensor:
    """rms_norm(y * silu(z.float()), scale, eps).to(dtype), (B, S, di),
    MAMBA_ROWS rows at a time: each block's products in y's rows in place
    (y is overwritten), in `rms_norm`'s order, then rounded into the
    output."""
    out = y.new_empty(y.shape, dtype=dtype)
    for a, e in _row_blocks(y.shape[1]):
        yb, g = y[:, a:e], z[:, a:e].to(torch.float32, copy=True)
        yb.mul_(g.mul_(torch.sigmoid(g)))                  # y * silu(z)
        del g
        var = (yb * yb).mean(dim=-1, keepdim=True)
        out[:, a:e] = yb.mul_(torch.rsqrt(var + eps)).mul_(scale.float())
    return out


def _blocks(a: torch.Tensor, L: int, fill: float = 0.0) -> torch.Tensor:
    """(B, S, ...) -> (B, n, L, ...), padded with `fill` past S."""
    B, S = a.shape[:2]
    n = -(-S // L)
    a = pad(a, (0, 0) * (a.dim() - 2) + (0, n * L - S), value=fill)
    return a.reshape(B, n, L, *a.shape[2:])


def _scan_on_shards(name, fn, rows, whole, init_state):
    """A chunk scan of DTensors: each rank scans its own batch rows (the
    scan is per row), `init_state` with them (`_on_rows`)."""
    if init_state is None:
        return _on_rows(name, fn, rows, whole, n_out=2)
    n = len(rows)
    return _on_rows(name, lambda *a: fn(*a[:n], *a[n + 1:],
                                        init_state=a[n]),
                    (*rows, init_state), whole, n_out=2)


def _carry(s0: torch.Tensor, decay: torch.Tensor, inc: torch.Tensor):
    """The chunk scans' state passing: s_{c+1} = decay_c s_c + inc_c from
    s_0 = s0 (B, ...), over decay and inc (B, n, ...).  Returns the state
    entering each chunk (B, n, ...) and the final state."""
    starts, s = [], s0
    for c in range(inc.shape[1]):
        starts.append(s)
        s = s * decay[:, c] + inc[:, c]
    return torch.stack(starts, dim=1), s


# chunks a scan takes at once where autograd does not record it
MAMBA_GROUP = 16            # of 128 tokens: 2048 tokens a group
WKV_GROUP = 64              # blocks of 16 tokens: 1024 tokens a group


def _records(*tensors) -> bool:
    """Whether autograd records a call on `tensors` (None skipped)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _grouped(chunks, step: int, S: int, out: torch.Tensor, s0, rows, rest):
    """A chunk scan under no autograd, `step` tokens (whole chunks) a
    call: `chunks(*rows[g:g+step], *rest, state, ...)` for each group, the
    state carried from group to group; each group's output (padded to
    whole chunks) written into `out` (B, S, ...).  Returns the final
    state."""
    state = s0
    for g in range(0, S, step):
        y, state = chunks(*(a[:, g:g + step] for a in rows), *rest, state)
        out[:, g:g + step] = y[:, :min(step, S - g)]
    return state


def mamba2_chunk_scan(xh: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                      dt: torch.Tensor, A: torch.Tensor, D: torch.Tensor, *,
                      chunk: int = 128,
                      init_state: Optional[torch.Tensor] = None,
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan, the reference's `mamba2_chunk_scan`.
    xh: (B,S,nh,hd), Bm/Cm: (B,S,ds), dt: (B,S,nh) f32, A, D: (nh,).

    The reference's chunks, padding (dt = 0 past S), intra-chunk G,
    inter-chunk term and state update, with one change of form: the
    log-decay of a pair, sum_{t<s<=q} dt_s A, is summed pair by pair (a
    segment sum) instead of taken as the difference cs_q - cs_t of the
    chunk's cumulative sum.  At zamba2's A (down to -16) that sum reaches
    ~-3000 within a chunk, where the difference keeps ~4 fewer digits:
    the reference's form leaves dt's and A's gradients ~1e-5-1e-4 of
    their max from float64, this one ~3e-7 (ROADMAP C12).  Where autograd
    records the call, every chunk's products are taken at once (autograd
    keeps them anyway); only the state (B,nh,hd,ds) is carried chunk to
    chunk (`_carry`).  Otherwise (a prefill) MAMBA_GROUP chunks are taken
    at a time and the state carried between groups, as the reference's
    `lax.scan` holds one chunk's products at a time.  Returns (y
    (B,S,nh,hd), final_state (B,nh,hd,ds)), f32, y including D x.
    """
    if _is_dtensor(xh):
        return _scan_on_shards("mamba2_chunk_scan", functools.partial(
            mamba2_chunk_scan, chunk=chunk), (xh, Bm, Cm, dt), (A, D),
            init_state)
    B, S, nh, hd = xh.shape
    ds = Bm.shape[-1]
    Lc = min(chunk, S)
    s0 = (init_state.float() if init_state is not None else
          xh.new_zeros(B, nh, hd, ds, dtype=torch.float32))
    step = MAMBA_GROUP * Lc
    if S <= step or _records(xh, Bm, Cm, dt, A, D, init_state):
        y, state = _mamba2_chunks(xh, Bm, Cm, dt, A, s0, Lc)
        return y[:, :S] + xh * D[None, None, :, None], state
    y = xh.new_empty(B, S, nh, hd, dtype=torch.float32)
    state = _grouped(lambda *a: _mamba2_chunks(*a, Lc), step, S, y, s0,
                     (xh, Bm, Cm, dt), (A,))
    # D x added in place: one whole-sequence tensor fewer
    return _plus_Dx(y, xh, D), state


def _mamba2_chunks(xh, Bm, Cm, dt, A, s0, Lc: int):
    """`mamba2_chunk_scan`'s chunks of Lc tokens from state s0, all at
    once: (y (B, n Lc, nh, hd) without D x, padded to whole chunks, and
    the final state)."""
    B, S, nh, hd = xh.shape
    xh_c, B_c, C_c, dt_c = (_blocks(a, Lc) for a in (xh, Bm, Cm, dt))
    xt = xh_c * dt_c[..., None]                    # x-tilde, 0 past S
    lA = dt_c * A                                  # (B,n,Lc,nh) <= 0
    ones = torch.ones(Lc, Lc, dtype=torch.bool, device=xh.device)
    tri, past = ones.tril()[:, :, None], ones.tril(-1)[:, :, None]
    # seg[q, t] = sum_{t<s<=q} lA_s for q >= t, 0 above the diagonal (so
    # exp never meets the large positive values a where() after it would
    # back-propagate as inf * 0 = NaN)
    seg = torch.cumsum(torch.where(past, lA[:, :, :, None], 0.0), dim=2)
    G = torch.where(tri, torch.exp(seg), 0.0)      # weight(t -> q)
    # chunk c's own contribution to the state it hands on: t decays by
    # exp(seg[last, t])
    inc = torch.einsum("bctnp,bcts->bcnps",
                       xt * torch.exp(seg[:, :, -1])[..., None], B_c)
    cs = lA[:, :, :1] + seg[:, :, :, 0]            # inclusive, (B,n,Lc,nh)
    del seg             # (B, n, Lc, Lc, nh), let go before the products
    att = torch.einsum("bcqs,bcts->bcqt", C_c, B_c)
    # the pairs' weights taken into G in place where autograd does not
    # record them
    AG = att[..., None] * G if _records(att, G) else G.mul_(att[..., None])
    del G
    y = torch.einsum("bcqtn,bctnp->bcqnp", AG, xt)
    del AG
    starts, state = _carry(s0, torch.exp(cs[:, :, -1])[..., None, None],
                           inc)
    # inter-chunk: y_q += exp(cs_q) C_q . state entering the chunk
    y = y + torch.einsum("bcqs,bcnps->bcqnp", C_c, starts) \
        * torch.exp(cs)[..., None]
    return y.reshape(B, -1, nh, hd), state


def mamba2_full(params, cfg, x: torch.Tensor, *, mode: str = "train",
                impl: Optional[str] = None, chunk_scans: bool = False,
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Full-sequence Mamba2 block.  mode="train" (or `chunk_scans`) takes
    `mamba2_chunk_scan`; mode="prefill" takes `ops.ssd_scan` (`impl`
    picks its version) on xt = x dt and lA = dt A, y gaining D x as in the
    chunk scan."""
    B, S, _ = x.shape
    z, xh, Bm, Cm, dt, A, conv_state = _mamba_inner(
        cfg, params, rms_norm(x, params["norm"], cfg.norm_eps))
    if mode == "train" or chunk_scans:
        y, state = mamba2_chunk_scan(xh, Bm, Cm, dt, A, params["D"])
    else:
        y, state = ops.ssd_scan(xh * dt[..., None], Bm, Cm, dt * A,
                                impl=impl)
        y = _plus_Dx(y, xh, params["D"])
    del xh, Bm, Cm, dt      # the conv's output, let go before the epilogue
    out = _mamba_out(params, cfg, x, z, y.reshape(B, S, cfg.d_inner))
    cache = {"conv": conv_state, "ssm": state} if mode == "prefill" else None
    return out, cache


def mamba2_decode(params, cfg, x: torch.Tensor, cache: dict,
                  ) -> Tuple[torch.Tensor, dict]:
    """One token, x: (B, 1, d); cache {"conv": (B, d_conv-1, C),
    "ssm": (B, nh, hd, ds)}.  Returns the new state; the caller writes
    it back."""
    B = x.shape[0]
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    z, xh, Bm, Cm, dt, A, new_conv = _mamba_inner(
        cfg, params, h, conv_state=cache["conv"])
    xh, Bm, Cm, dt = (constrain(a, "BATCH") for a in (xh, Bm, Cm, dt))
    dA = torch.exp(dt[:, 0] * constrain(A))                    # (B, nh)
    xt = xh[:, 0] * dt[:, 0, :, None]                          # (B, nh, hd)
    s_new = constrain(cache["ssm"], "BATCH") * dA[..., None, None] \
        + torch.einsum("bnp,bs->bnps", xt, Bm[:, 0])
    y = torch.einsum("bnps,bs->bnp", s_new, Cm[:, 0]) \
        + xh[:, 0] * constrain(params["D"])[None, :, None]
    out = _mamba_out(params, cfg, x, z, y.reshape(B, 1, cfg.d_inner))
    return out, {"conv": new_conv, "ssm": s_new}


# ======================================================================
# RWKV6
# ======================================================================

_LORA = 64


def init_rwkv6(generator: torch.Generator, cfg,
               device: torch.device) -> dict:
    d, H, hd, ff = cfg.d_model, cfg.rwkv_heads, cfg.rwkv_head_dim, cfg.d_ff
    dt = dtype_of(cfg)
    f32 = dict(dtype=torch.float32, device=device)

    def w(shape, **kw):
        kw.setdefault("dtype", dt)
        return dense_init(generator, shape, device=device, **kw)

    return {
        "norm_tm": torch.ones(d, **f32),
        "norm_cm": torch.ones(d, **f32),
        "maa": torch.full((5, d), 0.5, **f32),        # r,k,v,g,w mixing
        "w0": torch.full((H, hd), -6.0, **f32),
        "wA": w((d, _LORA), scale=0.01, dtype=torch.float32),
        "wB": w((_LORA, H * hd), scale=0.01, dtype=torch.float32),
        "u": torch.full((H, hd), 0.5, **f32),
        "Wr": w((d, d)), "Wk": w((d, d)), "Wv": w((d, d)), "Wg": w((d, d)),
        "Wo": w((d, d)),
        "ln_x": torch.ones(d, **f32),
        "maa_cm": torch.full((2, d), 0.5, **f32),
        "Wk_cm": w((d, ff)), "Wv_cm": w((ff, d)), "Wr_cm": w((d, d)),
    }


def _shift(x: torch.Tensor, prev: Optional[torch.Tensor] = None):
    """Token shift: x_{t-1}, with `prev` filling slot 0 (decode state)."""
    first = prev[:, None] if prev is not None else torch.zeros_like(x[:, :1])
    return torch.cat([first, x[:, :-1]], dim=1)


def _rwkv_decay(params, xw: torch.Tensor, H: int, hd: int) -> torch.Tensor:
    # the low-rank product is a partial sum under a mesh: reduce it before
    # it meets w0
    lora = constrain(torch.tanh(xw.float() @ params["wA"]) @ params["wB"],
                     "BATCH")
    w = torch.exp(-torch.exp(constrain(params["w0"]).reshape(-1)
                             + lora))                          # (0, 1)
    return w.reshape(*xw.shape[:-1], H, hd)


def _time_mix_in(params, h, hx, H, hd):
    """r, k, v (f32, (B,S,H,hd)), the gate g and the decay w from the
    normed input h and its shift hx."""
    B, S = h.shape[:2]
    maa = params["maa"].to(h.dtype)
    delta = hx - h
    r, k, v, g = (
        (h + delta * maa[i]) @ params[name]
        for i, name in enumerate(("Wr", "Wk", "Wv", "Wg")))
    r, k, v = (a.reshape(B, S, H, hd).float() for a in (r, k, v))
    w = _rwkv_decay(params, h + delta * maa[4], H, hd)
    return r, k, v, g, w


def _time_mix_out(params, cfg, x, out, g):
    B, S = x.shape[:2]
    out = rms_norm(out.reshape(B, S, cfg.d_model), params["ln_x"],
                   cfg.norm_eps)
    return x + (out * silu(g.float())).to(x.dtype) @ params["Wo"]


def _channel_mix(params, cfg, x, prev=None):
    """Returns (x + channel mix, the normed input h2)."""
    h2 = rms_norm(x, params["norm_cm"], cfg.norm_eps)
    hx2 = _shift(h2, prev)
    maa_cm = params["maa_cm"].to(h2.dtype)
    xk2 = h2 + (hx2 - h2) * maa_cm[0]
    xr2 = h2 + (hx2 - h2) * maa_cm[1]
    kcm = torch.square(torch.relu(xk2 @ params["Wk_cm"]))
    out2 = torch.sigmoid(xr2 @ params["Wr_cm"]) * (kcm @ params["Wv_cm"])
    return x + out2.to(x.dtype), h2


SUB_CHUNK = 16


def wkv6_chunk_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor, *, chunk: int = 64,
                    init_state: Optional[torch.Tensor] = None,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV6 recurrence, the reference's `wkv6_chunk_scan` in the
    form the module docstring gives: blocks of L = min(chunk, SUB_CHUNK,
    S) tokens (w padded with 1.0 past S), each block's past pairs in the
    factored form about its middle token m,

      att[t, s] = sum_d r_t exp(cw_ex_t - cw_ex_m) . k_s exp(cw_ex_m - cw_s),

    for s < t, with cw / cw_ex the inclusive / exclusive cumulative
    log-decay inside the block, lw = log(max(w, 1e-12)).  Each exponent is
    at most max(m, L - m) |lw| <= 8 |lw|: finite for w >= 2e-5.  Where
    autograd records the call, every block's products are taken at once;
    only the state is carried block to block (`_carry`).  Otherwise
    WKV_GROUP blocks are taken at a time, the state carried between
    groups.

    r,k,v,w: (B,S,H,hd), u: (H,hd).  Returns (out (B,S,H,hd), final_state
    (B,H,hd,hd) [k-dim, v-dim]), f32.
    """
    if _is_dtensor(r):
        return _scan_on_shards("wkv6_chunk_scan", functools.partial(
            wkv6_chunk_scan, chunk=chunk), (r, k, v, w), (u,), init_state)
    B, S, H, hd = r.shape
    L = min(chunk, SUB_CHUNK, S)
    s0 = (init_state.float() if init_state is not None else
          r.new_zeros(B, H, hd, hd, dtype=torch.float32))
    step = WKV_GROUP * L
    if S <= step or _records(r, k, v, w, u, init_state):
        out, state = _wkv6_chunks(r, k, v, w, u, s0, L)
        return out[:, :S], state
    out = r.new_empty(B, S, H, hd, dtype=torch.float32)
    state = _grouped(lambda *a: _wkv6_chunks(*a, L), step, S, out, s0,
                     (r, k, v, w), (u,))
    return out, state


def _wkv6_chunks(r, k, v, w, u, s0, L: int):
    """`wkv6_chunk_scan`'s blocks of L tokens from state s0, all at once:
    (out (B, n L, H, hd), padded to whole blocks, and the final state)."""
    B, S, H, hd = r.shape
    r_, k_, v_ = (_blocks(a.float(), L) for a in (r, k, v))
    lw = torch.log(torch.clamp(_blocks(w.float(), L, fill=1.0), min=1e-12))
    cw = torch.cumsum(lw, dim=2)                   # (B,n,L,H,hd) inclusive
    cw_ex = cw - lw                                # exclusive: sum_{s<t}
    mid = cw_ex[:, :, L // 2, None]
    att = torch.einsum("bcthd,bcshd->bchts", r_ * torch.exp(cw_ex - mid),
                       k_ * torch.exp(mid - cw))
    past = torch.ones(L, L, dtype=torch.bool, device=r.device).tril(-1)
    out = torch.einsum("bchts,bcshe->bcthe", torch.where(past, att, 0.0),
                       v_)
    # current-token bonus
    out = out + torch.einsum("bcthd,bcthd->bcth", r_,
                             u.float() * k_)[..., None] * v_
    # the block's own contribution to the state it hands on
    last = cw[:, :, -1]                            # (B,n,H,hd)
    inc = torch.einsum("bcshd,bcshe->bchde",
                       k_ * torch.exp(last[:, :, None] - cw), v_)
    starts, state = _carry(s0, torch.exp(last)[..., None], inc)
    # the state entering the block: out_t += (r_t exp(cw_ex_t)) . state
    out = out + torch.einsum("bcthd,bchde->bcthe", r_ * torch.exp(cw_ex),
                             starts)
    return out.reshape(B, -1, H, hd), state


def rwkv6_full(params, cfg, x: torch.Tensor, *, mode: str = "train",
               impl: Optional[str] = None, chunk_scans: bool = False,
               ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Full-sequence RWKV6 block.  mode="train" (or `chunk_scans`) takes
    `wkv6_chunk_scan`; mode="prefill" takes `ops.wkv_scan` (`impl` picks
    its version)."""
    H, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
    h = rms_norm(x, params["norm_tm"], cfg.norm_eps)
    r, k, v, g, w = _time_mix_in(params, h, _shift(h), H, hd)
    if mode == "train" or chunk_scans:
        out, state = wkv6_chunk_scan(r, k, v, w, params["u"])
    else:
        out, state = ops.wkv_scan(r, k, v, w, params["u"], impl=impl)
    # the time mix's residual is a row-parallel partial under a mesh
    x = constrain(_time_mix_out(params, cfg, x, out, g), "BATCH")
    x, h2 = _channel_mix(params, cfg, x)
    cache = None
    if mode == "prefill":
        # copies of the last rows: views would keep h and h2 alive
        cache = {"wkv": state, "shift_tm": h[:, -1].clone(),
                 "shift_cm": h2[:, -1].clone()}
    return x, cache


def rwkv6_decode(params, cfg, x: torch.Tensor, cache: dict,
                 ) -> Tuple[torch.Tensor, dict]:
    """One token, x: (B, 1, d); cache {"wkv": (B,H,hd,hd), "shift_tm",
    "shift_cm": (B, d)}.  Returns the new state; the caller writes it
    back."""
    B = x.shape[0]
    H, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
    h = rms_norm(x, params["norm_tm"], cfg.norm_eps)
    r, k, v, g, w = _time_mix_in(params, h, _shift(h, cache["shift_tm"]),
                                 H, hd)
    r, k, v, w = (constrain(a[:, 0], "BATCH")                # (B, H, hd)
                  for a in (r, k, v, w))
    S_prev = constrain(cache["wkv"], "BATCH")
    out = torch.einsum("bhd,bhde->bhe", r, S_prev) \
        + torch.einsum("bhd,bhd->bh", r, constrain(params["u"])[None] * k
                       )[..., None] \
        * v
    s_new = S_prev * w[..., None] + torch.einsum("bhd,bhe->bhde", k, v)
    x = constrain(_time_mix_out(params, cfg, x, out.reshape(B, 1, H, hd), g),
                  "BATCH")
    x, h2 = _channel_mix(params, cfg, x, cache["shift_cm"])
    return x, {"wkv": s_new, "shift_tm": h[:, 0], "shift_cm": h2[:, 0]}
