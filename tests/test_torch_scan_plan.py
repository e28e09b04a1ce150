"""The scan kernels' planning and decomposition, on the CPU.

`mamba_scan.plan` / `wkv6.plan` (launches, blocks, workspace) against
independent counts; the rule for 16-byte loads (`wide_path`); and plain
PyTorch mirrors of the two kernels' decompositions (csrc/mamba_scan.cu,
csrc/wkv6.cu: per-chunk local states, the pass over the chunks, output
tiles; C . B^T once per (batch, chunk); the decays factored at 16-row
group boundaries, with exact exponentials on the diagonal blocks only)
held against the Pallas kernels in interpret mode at the JAX package's
tolerances, under strong decay too.  The kernels themselves run only on
the card (tests/test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import mamba_scan as jax_mamba_scan
from repro.kernels import wkv6 as jax_wkv6
from repro_torch.kernels import mamba_scan as MS
from repro_torch.kernels import wkv6 as WK

MAMBA_TOL = dict(atol=20 * 2e-5, rtol=5e-2)   # the JAX package's limits
WKV_TOL = dict(atol=2e-3, rtol=1e-3)
SCAN_EDGES = [1, 15, 16, 17, 63, 64, 65, 127, 128, 129]
SERVED = [4, 7, 15, 21, 28, 29, 42, 47, 50, 77, 89, 94, 140, 454, 579, 1015]


def _cdiv(a, b):
    return -(-a // b)


# ---------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------

@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("S", sorted(set(SCAN_EDGES + SERVED + [2000])))
def test_mamba_plan_puts_every_row_in_one_output_block(S, B):
    """Output blocks: 16-row tiles for a prompt of one chunk (only the
    tiles it fills), 64-row halves of every 128-token chunk otherwise;
    each row of y in exactly one block that does not exit early."""
    nh, hd, ds = 80, 64, 64
    p = MS.plan(B, S, nh, hd, ds)
    nc = _cdiv(S, MS.CHUNK)
    assert p["chunks"] == nc and p["launches"] == (2 if nc == 1 else 3)
    rows = MS.TILE if nc == 1 else MS.ROWS
    per_chunk = p["y_blocks"] // (B * nh * nc)
    assert per_chunk * rows >= min(S, MS.CHUNK)
    seen = np.zeros(S, int)
    for c in range(nc):
        n = min(MS.CHUNK, S - c * MS.CHUNK)
        for i in range(per_chunk):
            q0 = i * rows
            if q0 < n:                    # a block past S exits
                seen[c * MS.CHUNK + q0:c * MS.CHUNK + min(q0 + rows, n)] += 1
    assert (seen == 1).all()
    assert p["cb_blocks"] == B * nc * min(8, _cdiv(S, 16))
    assert p["state_blocks"] == B * nh * nc


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("S", sorted(set(SCAN_EDGES + SERVED + [2000])))
def test_wkv6_plan_puts_every_row_in_one_output_tile(S, B):
    H, hd = 32, 64
    p = WK.plan(B, S, H, hd)
    nc = _cdiv(S, WK.CHUNK)
    assert p["chunks"] == nc and p["launches"] == (1 if nc == 1 else 3)
    assert p["tiles"] == min(WK.CHUNK // WK.TILE, _cdiv(S, WK.TILE))
    seen = np.zeros(S, int)
    for c in range(nc):
        n = min(WK.CHUNK, S - c * WK.CHUNK)
        for i in range(p["tiles"]):
            t0 = i * WK.TILE
            if t0 < n:
                seen[c * WK.CHUNK + t0:c * WK.CHUNK + min(t0 + WK.TILE, n)] \
                    += 1
    assert (seen == 1).all()
    assert p["state_blocks"] == B * H * nc
    assert p["y_blocks"] == B * H * nc * p["tiles"]


@pytest.mark.parametrize("S", [1, 64, 65, 128, 129, 1015])
def test_scan_workspace_holds_what_the_kernels_write(S):
    """C . B^T per (batch, chunk) always; past one chunk the per-chunk
    states and decays (and, for wkv6, each chunk's prefix sums of log w);
    one chunk of wkv6 needs none."""
    B, nh, hd, ds = 2, 80, 64, 64
    nc = _cdiv(S, 128)
    want = B * nc * 128 * 128
    if nc > 1:
        want += B * nh * nc * hd * ds + B * nh * nc
    assert MS.plan(B, S, nh, hd, ds)["workspace"] == want
    H = 32
    nc = _cdiv(S, 64)
    want = (B * H * nc * hd * hd + B * H * nc * hd + B * H * nc * 64 * hd
            if nc > 1 else 0)
    assert WK.plan(B, S, H, hd)["workspace"] == want


def test_wide_path_rules():
    """16-byte loads where hd (and ds) are multiples of 4 and every base
    and stride is 16-byte aligned: the model's B and C, views of one
    projection at offsets that are multiples of 4, qualify; an odd offset,
    an odd row stride or hd = 30 do not."""
    x = torch.zeros(2, 9, 3, 64)
    proj = torch.zeros(2, 9, 8 + 128)
    assert MS.wide_path(x, proj[..., 8:72], proj[..., 72:136])
    assert not MS.wide_path(x, proj[..., 7:71], proj[..., 72:136])
    odd = torch.zeros(2, 9, 7 + 128)
    assert not MS.wide_path(x, odd[..., 0:64], odd[..., 64:128])
    assert not MS.wide_path(torch.zeros(2, 9, 3, 30), proj[..., 8:72],
                            proj[..., 72:136])
    r = torch.zeros(2, 9, 3, 64)
    assert WK.wide_path(r, r, r, r)
    shifted = torch.zeros(r.numel() + 1)[1:].view(r.shape)
    assert not WK.wide_path(r, shifted, r, r)
    assert not WK.wide_path(*(torch.zeros(2, 9, 3, 30),) * 4)


# ---------------------------------------------------------------------
# the kernels' decompositions, mirrored in plain PyTorch
# ---------------------------------------------------------------------

def _mamba_tiled(xt, Bm, Cm, lA, whole_chunk=False):
    """csrc/mamba_scan.cu's arithmetic: C . B^T once per chunk; per-chunk
    S_loc and exp(cs_last); the pass; then y by 16-row groups g of q (the
    output blocks hold one or four of them), each taking
    att over earlier groups as CB exp(cs_q - c_g) exp(c_g - cs_t) (c_g =
    cs at the row before g, both exponents <= 0), the diagonal 16 x 16
    block from exact masked exponentials, and the inter-chunk term
    exp(cs_q) C_q . S_in.  whole_chunk=True instead factors over the whole
    chunk (c_g = 0), the form that overflows."""
    B, S, nh, hd = xt.shape
    ds = Bm.shape[-1]
    L, T = MS.CHUNK, MS.TILE
    nc = _cdiv(S, L)
    cb, loc, dec = [], [], []
    for c in range(nc):
        sl = slice(c * L, min(S, (c + 1) * L))
        cs = torch.cumsum(lA[:, sl], 1)                    # (B, n, nh)
        cb.append(torch.einsum("bqs,bts->bqt", Cm[:, sl], Bm[:, sl]))
        loc.append(torch.einsum("btn,btnp,bts->bnps",
                                torch.exp(cs[:, -1:] - cs), xt[:, sl],
                                Bm[:, sl]))
        dec.append(torch.exp(cs[:, -1]))
    s_in, run = [], torch.zeros(B, nh, hd, ds)
    for c in range(nc):
        s_in.append(run)
        run = dec[c][..., None, None] * run + loc[c]
    y = torch.empty(B, S, nh, hd)
    tri = torch.tril(torch.ones(T, T, dtype=torch.bool))[None, :, :, None]
    for c in range(nc):
        c0, n = c * L, min(L, S - c * L)
        cs = torch.cumsum(lA[:, c0:c0 + n], 1)
        for t1 in range(0, n, T):            # the 16-row groups of q
            q = torch.arange(t1, min(t1 + T, n))
            cg = cs[:, t1 - 1] if t1 > 0 and not whole_chunk \
                else torch.zeros(B, nh)
            u = torch.exp(cs[:, q] - cg[:, None])          # (B, q, nh)
            v = torch.exp(cg[:, None] - cs[:, :t1])        # (B, t, nh)
            off = torch.einsum("bqt,bqn,btn,btnp->bqnp", cb[c][:, q, :t1],
                               u, v, xt[:, c0:c0 + t1])
            diff = cs[:, q][:, :, None] - cs[:, q][:, None]
            m = tri[:, :len(q), :len(q)]
            att = torch.where(m, cb[c][:, q][:, :, q, None] * torch.exp(
                torch.where(m, diff, torch.zeros(()))), torch.zeros(()))
            yq = off + torch.einsum("bqtn,btnp->bqnp", att, xt[:, c0 + q])
            if c > 0:
                yq = yq + torch.exp(cs[:, q])[..., None] * torch.einsum(
                    "bqs,bnps->bqnp", Cm[:, c0 + q], s_in[c])
            y[:, c0 + q] = yq
    return y, run


def _wkv6_tiled(r, k, v, w, u, whole_chunk=False):
    """csrc/wkv6.cu's arithmetic: per-chunk S_loc and exp(cw_last); the
    pass; then each 16-row tile t of y: att over earlier sub-chunks as the
    product of r exp(cx - c_i) and k exp(c_i - cw) (c_i = cw at the row
    before the tile, both exponents <= 0), the diagonal 16 x 16 block from
    the exact pairwise exponentials, the bonus, and the inter-chunk term.
    whole_chunk=True instead factors over the whole chunk (c_i = 0), the
    form that overflows."""
    B, S, H, hd = r.shape
    L, T = WK.CHUNK, WK.TILE
    nc = _cdiv(S, L)
    loc, dec = [], []
    for c in range(nc):
        sl = slice(c * L, min(S, (c + 1) * L))
        cw = torch.cumsum(torch.log(w[:, sl].clamp(min=1e-30)), 1)
        kd = k[:, sl] * torch.exp(cw[:, -1:] - cw)
        loc.append(torch.einsum("bshd,bshe->bhde", kd, v[:, sl]))
        dec.append(torch.exp(cw[:, -1]))
    s_in, run = [], torch.zeros(B, H, hd, hd)
    for c in range(nc):
        s_in.append(run)
        run = dec[c][..., None] * run + loc[c]
    y = torch.empty(B, S, H, hd)
    tri = torch.tril(torch.ones(T, T, dtype=torch.bool), -1)
    for c in range(nc):
        c0, n = c * L, min(L, S - c * L)
        cw = torch.cumsum(torch.log(w[:, c0:c0 + n].clamp(min=1e-30)), 1)
        cx = torch.cat([torch.zeros(B, 1, H, hd), cw[:, :-1]], 1)
        for t0 in range(0, n, T):
            tt = torch.arange(t0, min(t0 + T, n))
            rt, kt, vt = r[:, c0 + tt], k[:, c0 + tt], v[:, c0 + tt]
            ci = cw[:, t0 - 1] if t0 > 0 and not whole_chunk \
                else torch.zeros(B, H, hd)
            rq = rt * torch.exp(cx[:, tt] - ci[:, None])
            kk = k[:, c0:c0 + t0] * torch.exp(ci[:, None] - cw[:, :t0])
            off = torch.einsum("bthd,bshd->bths", rq, kk)
            ex = torch.exp(cx[:, tt][:, :, None] - cw[:, tt][:, None])
            m = tri[:len(tt), :len(tt)][None, :, :, None, None]
            diag = torch.einsum("bthd,bshd,btshd->bths", rt, kt,
                                torch.where(m, ex, torch.zeros(())))
            bonus = (rt * u * kt).sum(-1)
            yt = torch.einsum("bths,bshe->bthe", off, v[:, c0:c0 + t0]) \
                + torch.einsum("bths,bshe->bthe", diag, vt) \
                + bonus[..., None] * vt
            if c > 0:
                yt = yt + torch.einsum("bthd,bhde->bthe",
                                       rt * torch.exp(cx[:, tt]), s_in[c])
            y[:, c0 + tt] = yt
    return y, run


def _inputs_mamba(B, S, nh, hd, ds, seed):
    rng = np.random.default_rng(seed)
    n = rng.standard_normal
    return (n((B, S, nh, hd)).astype(np.float32),
            n((B, S, ds)).astype(np.float32), n((B, S, ds)).astype(np.float32),
            (-0.5 * rng.random((B, S, nh))).astype(np.float32))


def _inputs_wkv(B, S, H, hd, wmin, wmax, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(wmin, wmax, (B, S, H, hd)).astype(np.float32)
    u = (0.5 * rng.standard_normal((H, hd))).astype(np.float32)
    return r, k, v, w, u


@pytest.mark.parametrize("decay", [0.5, 8.0])
@pytest.mark.parametrize("S", [1, 17, 64, 129, 300])
def test_mamba_decomposition_matches_pallas(S, decay):
    """Finite, and within the JAX package's limits of the Pallas kernel,
    at the serve path's decay and at one strong enough that the decay
    over a chunk passes e^-88 (lA down to -8 a token)."""
    args = _inputs_mamba(2, S, 3, 16, 8, seed=S)
    args = args[:3] + (args[3] * (decay / 0.5),)
    y, st = _mamba_tiled(*map(torch.from_numpy, args))
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    py, pst = jax_mamba_scan(*map(jnp.asarray, args), interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(py), **MAMBA_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(pst), **MAMBA_TOL)


def test_mamba_whole_chunk_factoring_overflows():
    """The control: factoring over the whole chunk is not finite when the
    decay over a chunk passes e^-88."""
    args = _inputs_mamba(1, 128, 2, 8, 8, seed=2)
    args = args[:3] + (args[3] * 16.0,)
    y, _ = _mamba_tiled(*map(torch.from_numpy, args), whole_chunk=True)
    assert not bool(torch.isfinite(y).all())


@pytest.mark.parametrize("wmin,wmax", [(0.05, 0.06), (0.05, 1.0)])
@pytest.mark.parametrize("S", [1, 17, 64, 65, 150])
def test_wkv6_subchunk_factoring_matches_pallas(S, wmin, wmax):
    """Finite, and within the JAX package's limits of the Pallas kernel's
    exact form, under the strongest decay the repo checks."""
    args = _inputs_wkv(2, S, 2, 16, wmin, wmax, seed=S)
    y, st = _wkv6_tiled(*map(torch.from_numpy, args))
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    py, pst = jax_wkv6(*map(jnp.asarray, args), interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(py), **WKV_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(pst), **WKV_TOL)


def test_wkv6_whole_chunk_factoring_overflows():
    """The control: factoring over the whole chunk (the form the sub-chunk
    factoring avoids) is not finite at w in [0.05, 0.06]; 64 tokens of
    log 0.05 pass e^88."""
    args = _inputs_wkv(1, 64, 1, 8, 0.05, 0.06, seed=1)
    y, _ = _wkv6_tiled(*map(torch.from_numpy, args), whole_chunk=True)
    assert not bool(torch.isfinite(y).all())
