"""Port SSM path vs the JAX package on the CPU: scans, blocks, models.

The same inputs, made with numpy from a seed, go through the JAX Pallas
kernels in interpret mode (`repro.kernels.mamba_scan` / `wkv6`, zero
initial state), the JAX plain references (`repro.kernels.ref`, also from a
non-zero initial state: the Pallas scans take none, ROADMAP C4), and the
port's CPU path (`ops.ssd_scan` / `ops.wkv_scan` on CPU tensors, which take
the plain sequential versions).  Scan tolerances are the JAX package's
own (tests/kernels/test_kernels.py): mamba_scan atol 20 x 2e-5 (float32)
or 20 x 5e-2 (bfloat16 inputs), rtol 5e-2; wkv6 atol 2e-3, rtol 1e-3.

Models: zamba2-2.7b (Mamba2 + the shared attention/MLP pair) and
rwkv6-1.6b, `.reduced()` in float32 on the reference's converted weights.
Logits within ATOL = 1e-4 as in tests/test_torch_model.py (float32 sums
taken in other orders: the port's sequential scan against the JAX model's
chunked one); recurrent state within STATE_TOL, the same 1e-4 plus 1e-4
relative (its entries are sums over the whole prompt); greedy tokens
equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import profiles as JP
from repro.kernels import mamba_scan as jax_mamba_scan
from repro.kernels import wkv6 as jax_wkv6
from repro.kernels.ref import mamba_scan_ref as jax_mamba_scan_ref
from repro.kernels.ref import wkv6_ref as jax_wkv6_ref
from repro.models import model as JM
from repro import serving as JS
from repro_torch.configs import get_config
from repro_torch.core import profiles as P
from repro_torch.kernels import ops
from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.kernels.ref import mamba_scan_ref, wkv6_ref
from repro_torch.kernels.wkv6 import wkv6
from repro_torch.models import model as M
from repro_torch.models.convert import convert_params
from repro_torch.serving import PoolEngine

MAMBA_ATOL = {"float32": 20 * 2e-5, "bfloat16": 20 * 5e-2}
MAMBA_RTOL = 5e-2
WKV_TOL = dict(atol=2e-3, rtol=1e-3)
ATOL = 1e-4
STATE_TOL = dict(atol=1e-4, rtol=1e-4)
ARCH_IDS = ["zamba2-2.7b", "rwkv6-1.6b"]
MAMBA_SWEEP = [(2, 64, 3, 32, 16, 32), (1, 100, 2, 64, 64, 32),
               (1, 16, 1, 8, 8, 16)]          # (B, S, nh, hd, ds, chunk)
WKV_SWEEP = [(2, 64, 2, 32, 32), (1, 100, 3, 64, 64),
             (1, 7, 1, 8, 16)]                # (B, S, H, hd, chunk)


def _mamba_inputs(B, S, nh, hd, ds, seed, dtype="float32"):
    """numpy float32 inputs; xt, Bm, Cm hold values exactly representable
    in `dtype` (bfloat16 rounding done once, by torch); lA <= 0."""
    rng = np.random.default_rng(seed)
    tdt = getattr(torch, dtype)

    def normal(*shape):
        a = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(a).to(tdt).float().numpy()

    lA = (-np.abs(rng.standard_normal((B, S, nh))) * 0.5).astype(np.float32)
    return normal(B, S, nh, hd), normal(B, S, ds), normal(B, S, ds), lA


def _wkv_inputs(B, S, H, hd, wmin, seed, wmax=1.0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(wmin, wmax, (B, S, H, hd)).astype(np.float32)
    u = (0.5 * rng.standard_normal((H, hd))).astype(np.float32)
    return r, k, v, w, u


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


# ----------------------------------------------------------------------
# Scans
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,nh,hd,ds,ch", MAMBA_SWEEP)
def test_ssd_scan_matches_pallas(B, S, nh, hd, ds, ch, dtype):
    xt, Bm, Cm, lA = _mamba_inputs(B, S, nh, hd, ds, seed=S, dtype=dtype)
    mamba_scan.launches = 0
    y, st = ops.ssd_scan(*_t(xt, Bm, Cm, lA))
    assert mamba_scan.launches == 0          # CPU tensors: plain version
    assert y.dtype == st.dtype == torch.float32
    assert y.shape == (B, S, nh, hd) and st.shape == (B, nh, hd, ds)
    jdt = getattr(jnp, dtype)
    py, pst = jax_mamba_scan(jnp.asarray(xt, jdt), jnp.asarray(Bm, jdt),
                             jnp.asarray(Cm, jdt), jnp.asarray(lA),
                             chunk=ch, interpret=True)
    tol = dict(atol=MAMBA_ATOL[dtype], rtol=MAMBA_RTOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(py, np.float32), **tol)
    np.testing.assert_allclose(st.numpy(), np.asarray(pst), **tol)


@pytest.mark.parametrize("wmin", [0.05, 0.8])
@pytest.mark.parametrize("B,S,H,hd,ch", WKV_SWEEP)
def test_wkv_scan_matches_pallas(B, S, H, hd, ch, wmin):
    r, k, v, w, u = _wkv_inputs(B, S, H, hd, wmin, seed=S + H)
    wkv6.launches = 0
    y, st = ops.wkv_scan(*_t(r, k, v, w, u))
    assert wkv6.launches == 0
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    py, pst = jax_wkv6(*map(jnp.asarray, (r, k, v, w, u)), chunk=ch,
                       interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(py), **WKV_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(pst), **WKV_TOL)


def test_wkv_scan_finite_under_strong_decay():
    """w in [0.05, 0.06] over a whole 64-token chunk, where the JAX model's
    factored chunk scan overflows (ROADMAP C2): the port's plain version
    stays finite and matches the Pallas kernel's exact form."""
    r, k, v, w, u = _wkv_inputs(1, 64, 1, 8, 0.05, seed=3, wmax=0.06)
    y, st = ops.wkv_scan(*_t(r, k, v, w, u))
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    py, pst = jax_wkv6(*map(jnp.asarray, (r, k, v, w, u)), chunk=64,
                       interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(py), **WKV_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(pst), **WKV_TOL)


@pytest.mark.parametrize("B,S,nh,hd,ds", [(2, 40, 3, 16, 8), (1, 9, 2, 8, 4)])
def test_mamba_scan_ref_from_init_state(B, S, nh, hd, ds):
    xt, Bm, Cm, lA = _mamba_inputs(B, S, nh, hd, ds, seed=S + 11)
    s0 = np.random.default_rng(S).standard_normal(
        (B, nh, hd, ds)).astype(np.float32)
    y, st = mamba_scan_ref(*_t(xt, Bm, Cm, lA),
                           init_state=torch.from_numpy(s0))
    jy, jst = jax_mamba_scan_ref(*map(jnp.asarray, (xt, Bm, Cm, lA)),
                                 init_state=jnp.asarray(s0))
    tol = dict(atol=MAMBA_ATOL["float32"], rtol=MAMBA_RTOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **tol)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), **tol)
    # the initial state matters: from zero the output differs
    y0, _ = mamba_scan_ref(*_t(xt, Bm, Cm, lA))
    assert float((y0 - y).abs().max()) > 1e-2


@pytest.mark.parametrize("B,S,H,hd,wmin", [(2, 40, 2, 16, 0.05),
                                           (1, 9, 3, 8, 0.8)])
def test_wkv6_ref_from_init_state(B, S, H, hd, wmin):
    r, k, v, w, u = _wkv_inputs(B, S, H, hd, wmin, seed=S + 13)
    s0 = np.random.default_rng(S).standard_normal(
        (B, H, hd, hd)).astype(np.float32)
    y, st = wkv6_ref(*_t(r, k, v, w, u), init_state=torch.from_numpy(s0))
    jy, jst = jax_wkv6_ref(*map(jnp.asarray, (r, k, v, w, u)),
                           init_state=jnp.asarray(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **WKV_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), **WKV_TOL)
    y0, _ = wkv6_ref(*_t(r, k, v, w, u))
    assert float((y0 - y).abs().max()) > 1e-2


def _bad_mamba(bad):
    xt, Bm, Cm, lA = _t(*_mamba_inputs(1, 9, 2, 8, 4, seed=0))
    if bad == "float64":
        xt = xt.double()
    elif bad == "bfloat16":
        Bm, Cm = Bm.bfloat16(), Cm.bfloat16()
    elif bad == "head_dim":
        xt = torch.zeros(1, 9, 2, 65)
    elif bad == "lengths_disagree":
        lA = lA[:, :5]
    elif bad == "last_axis_stride":
        xt = xt.transpose(2, 3).contiguous().transpose(2, 3)
    return xt, Bm, Cm, lA


def _bad_wkv(bad):
    r, k, v, w, u = _t(*_wkv_inputs(1, 9, 2, 8, 0.5, seed=0))
    if bad == "float64":
        w = w.double()
    elif bad == "bfloat16":
        r = r.bfloat16()
    elif bad == "head_dim":
        r = k = v = w = torch.zeros(1, 9, 2, 65)
        u = torch.zeros(2, 65)
    elif bad == "lengths_disagree":
        v = v[:, :5]
    elif bad == "last_axis_stride":
        k = k.transpose(2, 3).contiguous().transpose(2, 3)
    return r, k, v, w, u


@pytest.mark.parametrize("entry", ["kernel", "ops"])
@pytest.mark.parametrize("bad", ["float64", "bfloat16", "head_dim",
                                 "lengths_disagree", "last_axis_stride"])
def test_scan_wrappers_reject_what_the_kernels_do_not_take(bad, entry):
    """Each kernel's wrapper and the CPU path of `ops` refuse the same
    inputs, so the plain version takes nothing the kernel would not."""
    calls = {"kernel": (mamba_scan, wkv6),
             "ops": (ops.ssd_scan, ops.wkv_scan)}[entry]
    with pytest.raises((TypeError, ValueError)):
        calls[0](*_bad_mamba(bad))
    with pytest.raises((TypeError, ValueError)):
        calls[1](*_bad_wkv(bad))


def test_scan_kernel_wrappers_refuse_cpu_tensors():
    """Only `ops` decides which version runs: the wrappers launch their
    kernel on CUDA tensors and raise on any other device."""
    mamba_scan.launches = wkv6.launches = 0
    with pytest.raises(ValueError, match="CUDA"):
        mamba_scan(*_t(*_mamba_inputs(1, 9, 2, 8, 4, seed=0)))
    with pytest.raises(ValueError, match="CUDA"):
        wkv6(*_t(*_wkv_inputs(1, 9, 2, 8, 0.5, seed=0)))
    assert mamba_scan.launches == wkv6.launches == 0
    with pytest.raises(ValueError, match="impl"):
        ops.ssd_scan(*_t(*_mamba_inputs(1, 9, 2, 8, 4, seed=0)),
                     impl="pallas")
    with pytest.raises(ValueError, match="impl"):
        ops.wkv_scan(*_t(*_wkv_inputs(1, 9, 2, 8, 0.5, seed=0)),
                     impl="interpret")


# ----------------------------------------------------------------------
# Models
# ----------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCH_IDS)
def pair(request):
    jcfg = jax_get_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    params = convert_params(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, cfg, params


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(B, S))


def test_convert_carries_shared_blocks():
    """zamba2's shared attention + MLP pair crosses over once, under
    params["shared"], and stays out of the per-repeat layers."""
    jcfg = jax_get_config("zamba2-2.7b").reduced()
    jparams = jax.tree.map(np.asarray,
                           JM.init_params(jax.random.PRNGKey(1), jcfg))
    params = convert_params(jparams, device="cpu")
    assert sorted(params["shared"]) == ["b5_attn", "b6_mlp"]
    for name, blk in jparams["shared"].items():
        assert sorted(params["shared"][name]) == sorted(blk)
        for leaf, a in blk.items():
            np.testing.assert_array_equal(params["shared"][name][leaf].numpy(),
                                          a)
    assert len(params["layers"]) == jcfg.n_repeat
    for layer in params["layers"]:
        assert sorted(layer) == [f"b{i}_mamba2" for i in range(5)]
    torch.testing.assert_close(params["layers"][1]["b2_mamba2"]["w_in"],
                               torch.from_numpy(
                                   jparams["unit"]["b2_mamba2"]["w_in"][1]))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_shapes_match_reference(arch):
    """The port's own init gives the reference's parameter and cache
    shapes and dtypes."""
    jcfg = jax_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    ref = convert_params(jax.tree.map(
        np.asarray, JM.init_params(jax.random.PRNGKey(0), jcfg)),
        device="cpu")
    shapes = jax.tree.map(lambda t: (tuple(t.shape), t.dtype), params)
    assert shapes == jax.tree.map(lambda t: (tuple(t.shape), t.dtype), ref)
    cache = M.init_cache(cfg, 3, 20, device="cpu")
    jcache = JM.init_cache(jcfg, 3, 20)
    assert sorted(cache) == sorted(jcache)
    for name, c in cache.items():
        assert sorted(c) == sorted(jcache[name])
        for key, t in c.items():
            assert tuple(t.shape) == jcache[name][key].shape
            assert str(t.dtype).split(".")[1] == jcache[name][key].dtype.name


def test_train_logits(pair):
    jcfg, jparams, cfg, params = pair
    toks = _tokens(cfg, 2, 24, seed=1)
    jlogits, _ = JM.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    logits = M.forward(params, cfg, torch.as_tensor(toks))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=ATOL, rtol=0)


def _to_slab(cache, max_seq, zeros):
    """Prefill cache -> decode cache: attention K/V (R, B, S', K, hd) into
    a max_seq slab; O(1) state as it is."""
    out = {}
    for name, c in cache.items():
        out[name] = {}
        for key, a in c.items():
            if key in ("k", "v"):
                slab = zeros(a.shape[:2] + (max_seq,) + a.shape[3:])
                slab[:, :, :a.shape[2]] = a
                a = slab
            out[name][key] = a
    return out


def _assert_caches_close(cache, jcache):
    for name in jcache:
        for key, a in jcache[name].items():
            tol = dict(atol=ATOL, rtol=0) if key in ("k", "v") else STATE_TOL
            np.testing.assert_allclose(cache[name][key].numpy(),
                                       np.asarray(a), err_msg=f"{name}/{key}",
                                       **tol)


@pytest.mark.parametrize("S", [5, 70])
def test_prefill_then_decode(pair, S):
    """Prefill logits and cache (S=70 spans two 64-token wkv6 chunks; every
    S is past zamba2's conv window), then 8 greedy decode steps."""
    jcfg, jparams, cfg, params = pair
    B, max_seq, steps = 2, 96, 8
    toks = _tokens(cfg, B, S, seed=S)
    jlogits, jcache, _ = JM.forward(jparams, jcfg,
                                    {"tokens": jnp.asarray(toks)},
                                    mode="prefill")
    logits, cache = M.forward(params, cfg, torch.as_tensor(toks),
                              mode="prefill")
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=ATOL, rtol=0)
    _assert_caches_close(cache, jcache)
    jcache = jax.tree.map(jnp.asarray, _to_slab(
        jax.tree.map(np.asarray, jcache), max_seq, np.zeros))
    cache = _to_slab(cache, max_seq, torch.zeros)
    step = jax.jit(lambda p, t, c, pos: JM.decode_step(p, jcfg, t, c, pos))
    nxt = np.array(jnp.argmax(jlogits[:, -1], axis=-1))
    gaps = []
    for i in range(steps):
        pos = np.full(B, S + i, np.int32)
        jl, jcache = step(jparams, jnp.asarray(nxt[:, None]), jcache,
                          jnp.asarray(pos))
        tl, cache = M.decode_step(params, cfg, torch.as_tensor(nxt[:, None]),
                                  cache, pos)
        jl = np.asarray(jl[:, 0])
        np.testing.assert_allclose(tl[:, 0].numpy(), jl, atol=ATOL, rtol=0)
        top2 = np.sort(jl, axis=-1)[:, -2:]
        gaps.append(float((top2[:, 1] - top2[:, 0]).min()))
        nxt = jl.argmax(-1)
        assert (tl[:, 0].argmax(-1).numpy() == nxt).all(), (i, gaps[-1])
    print(f"{cfg.name} S={S}: min top-1/top-2 gap {min(gaps):.3e}")
    _assert_caches_close(cache, jcache)


def test_decode_plain_impl_matches_default_on_cpu(pair):
    """On CPU tensors the kernel path is the plain version: both impls give
    the same prefill and decode logits."""
    _, _, cfg, params = pair
    toks = torch.as_tensor(_tokens(cfg, 1, 12, seed=7))
    a, ca = M.forward(params, cfg, toks, mode="prefill")
    b, cb = M.forward(params, cfg, toks, mode="prefill", impl="plain")
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    nxt = a[:, -1].argmax(-1)[:, None]
    pos = np.array([12], np.int32)
    da, _ = M.decode_step(params, cfg, nxt, _to_slab(ca, 16, torch.zeros),
                          pos)
    db, _ = M.decode_step(params, cfg, nxt, _to_slab(cb, 16, torch.zeros),
                          pos, impl="plain")
    torch.testing.assert_close(da, db, atol=0, rtol=0)


# ----------------------------------------------------------------------
# C7: a prompt shorter than the conv window
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def zamba():
    jcfg = jax_get_config("zamba2-2.7b").reduced()
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    params = convert_params(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, get_config("zamba2-2.7b").reduced(), params


@pytest.mark.parametrize("plen", [1, 2])
def test_short_prompt_conv_state_is_right_aligned(zamba, plen):
    """ROADMAP C7.  A 1- or 2-token prompt is spliced into a slot whose
    previous occupant left non-zero state.  The port's prefill keeps the
    conv window right-aligned behind zeros, so prefill + one decode step
    gives the logits of the reference's train-mode forward over the
    prompt plus that token.  The reference engine writes the prompt's
    rows at the start of the window and keeps the old occupant's rows
    after them: its decode logits differ (a documented divergence)."""
    jcfg, jparams, cfg, params = zamba
    rng = np.random.default_rng(plen)
    prompt = rng.integers(0, cfg.vocab, size=(1, plen))
    kw = dict(window=16, n_slots=1, name="t")
    eng = PoolEngine(cfg, params, profile=P.H100_LLAMA70B, **kw)
    jeng = JS.PoolEngine(jcfg, jparams, profile=JP.H100_LLAMA70B, **kw)
    old = {n: {k: rng.standard_normal(t.shape).astype(np.float32)
               for k, t in c.items()} for n, c in eng.cache.items()}
    eng.cache = jax.tree.map(torch.from_numpy, old)
    jeng.cache = jax.tree.map(jnp.asarray, old)

    logits, pc = M.forward(params, cfg, torch.as_tensor(prompt),
                           mode="prefill")
    jlogits, jpc, _ = JM.forward(jparams, jcfg,
                                 {"tokens": jnp.asarray(prompt)},
                                 mode="prefill")
    K1 = cfg.d_conv - 1
    for name in (f"b{i}_mamba2" for i in range(5)):
        conv = pc[name]["conv"].numpy()                 # (R, 1, K1, C)
        assert conv.shape[2] == K1
        assert not conv[:, :, :K1 - plen].any()
        np.testing.assert_allclose(conv[:, :, K1 - plen:],
                                   np.asarray(jpc[name]["conv"]),
                                   atol=ATOL, rtol=0)
    eng._splice(pc, 0)
    jeng._splice(jpc, 0, plen)
    assert not eng.cache["b0_mamba2"]["conv"][:, 0, :K1 - plen].any()

    tok = int(logits[0, -1].argmax())
    assert tok == int(jnp.argmax(jlogits[0, -1]))
    pos = np.array([plen], np.int32)
    dl, _ = M.decode_step(params, cfg, torch.tensor([[tok]]), eng.cache, pos)
    jdl, _ = JM.decode_step(jparams, jcfg, jnp.asarray([[tok]]), jeng.cache,
                            jnp.asarray(pos))
    full, _ = JM.forward(jparams, jcfg, {"tokens": jnp.asarray(
        np.concatenate([prompt, [[tok]]], axis=1))})
    want = np.asarray(full[0, -1])
    np.testing.assert_allclose(dl[0, 0].numpy(), want, atol=ATOL, rtol=0)
    assert np.abs(np.asarray(jdl[0, 0]) - want).max() > 100 * ATOL
