"""The port's chunk scans (`models/ssm.py`: `mamba2_chunk_scan`,
`wkv6_chunk_scan`, the scans `forward(mode="train")` trains through) vs the
JAX package's and vs the sequential plain scans, on the CPU.

Inputs are numpy, drawn from a seed, the same arrays for both packages.
Tolerances:

  * y and the final state: tests/models/test_ssm_blocks.py's, MAMBA_ATOL =
    5e-4 and WKV_TOL (atol 2e-3, rtol 1e-3), against the reference's scan
    and against the sequential refs alike;
  * gradients of every float input (init_state included) under one
    random cotangent on y and on the state: each within GRAD_REL = 1e-4 of
    that input's max|g| of the reference (jax.grad of its chunk scan, or
    autograd through the port's sequential ref in the C2 regime).

The C2 regime (ROADMAP C2): at constant w = 0.2 or 0.05 and chunk 64 the
reference's factored `k * exp(-cw)` overflows float32 and its output is not
finite.  The port factors blocks of at most 16 tokens about their middle
token (every exponent <= 8 |log w|), so it stays finite there, and down to
w = 2e-5, and is held to `wkv6_ref` instead.

C12: at zamba2's decays the reference's Mamba2 scan takes each pair's
log-decay as a difference of a cumulative sum near -3000 and loses digits;
the port's segment sum is held within 1e-5 of float64 there, the
reference at least 3x further off.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.models.ssm import mamba2_chunk_scan as jax_mamba2_chunk_scan
from repro.models.ssm import wkv6_chunk_scan as jax_wkv6_chunk_scan
from repro_torch.kernels.ref import mamba_scan_ref, wkv6_ref
from repro_torch.models import ssm as ssm_module
from repro_torch.models.ssm import (SUB_CHUNK, mamba2_chunk_scan,
                                    wkv6_chunk_scan)

MAMBA_ATOL = 5e-4
WKV_TOL = dict(atol=2e-3, rtol=1e-3)
GRAD_REL = 1e-4


def _mamba_inputs(B, S, nh, hd, ds, seed, state=False):
    """test_ssm_blocks.py's draw in numpy: x, B, C normal, dt =
    softplus(normal), A = -linspace(0.5, 2, nh), D 0 (here normal, so
    that its gradient is held too)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    out = [rng.standard_normal((B, S, nh, hd)).astype(f),
           rng.standard_normal((B, S, ds)).astype(f),
           rng.standard_normal((B, S, ds)).astype(f),
           np.logaddexp(0, rng.standard_normal((B, S, nh))).astype(f),
           -np.linspace(0.5, 2.0, nh).astype(f),
           rng.standard_normal(nh).astype(f)]
    if state:
        out.append(rng.standard_normal((B, nh, hd, ds)).astype(f))
    return out


def _wkv_inputs(B, S, H, hd, seed, w_range=None, state=False):
    """r, k, v normal, u 0.5 normal, and w either RWKV6's own range,
    exp(-exp(-6 + normal)) as test_ssm_blocks.py draws it, or uniform in
    w_range."""
    rng = np.random.default_rng(seed)
    f = np.float32
    r, k, v = (rng.standard_normal((B, S, H, hd)).astype(f)
               for _ in range(3))
    if w_range is None:
        w = np.exp(-np.exp(-6.0 + rng.standard_normal((B, S, H, hd))))
    else:
        w = rng.uniform(*w_range, (B, S, H, hd))
    out = [r, k, v, w.astype(f),
           (0.5 * rng.standard_normal((H, hd))).astype(f)]
    if state:
        out.append(rng.standard_normal((B, H, hd, hd)).astype(f))
    return out


def _split(fn, args):
    """(inputs, init_state or None) of a scan's argument list."""
    n = 6 if fn is mamba2_chunk_scan else 5
    return list(args[:n]), (args[n] if len(args) > n else None)


def _run(fn, args, chunk):
    xs, s0 = _split(fn, args)
    y, state = fn(*map(torch.from_numpy, xs), chunk=chunk,
                  init_state=None if s0 is None else torch.from_numpy(s0))
    return y.numpy(), state.numpy()


def _jax_scan(fn, args, chunk, cot=None):
    """The reference's y and final state on `args` (inputs, then
    init_state if given), and with `cot` (cotangents of y and the state)
    the gradients of every argument: one jitted vjp."""
    n = 6 if fn is jax_mamba2_chunk_scan else 5

    def scan(*a):
        return fn(*a[:n], chunk=chunk,
                  init_state=a[n] if len(a) > n else None)

    def run(*a):
        out, vjp = jax.vjp(scan, *a)
        return out, (vjp(cot) if cot is not None else None)

    (y, state), grads = jax.jit(run)(*map(jnp.asarray, args))
    return np.asarray(y), np.asarray(state), \
        None if grads is None else [np.asarray(g) for g in grads]


def _sequential(kind, args):
    """The port's sequential plain scan on the same inputs (Mamba: on
    xt = x dt and lA = dt A, with D x added)."""
    fn = mamba2_chunk_scan if kind == "mamba" else wkv6_chunk_scan
    xs, s0 = _split(fn, args)
    t = [torch.from_numpy(a) for a in xs]
    init = None if s0 is None else torch.from_numpy(s0)
    if kind == "mamba":
        xh, Bm, Cm, dt, A, D = t
        y, state = mamba_scan_ref(xh * dt[..., None], Bm, Cm, dt * A,
                                  init_state=init)
        return y + xh * D[None, None, :, None], state
    return wkv6_ref(*t, init_state=init)


def _cotangents(fn, args, seed):
    """Random cotangents of a scan's y and final state."""
    B, S, nh, hd = args[0].shape
    ds = args[1].shape[-1] if fn is mamba2_chunk_scan else hd
    rng = np.random.default_rng(seed + 1000)
    return (rng.standard_normal((B, S, nh, hd)).astype(np.float32),
            rng.standard_normal((B, nh, hd, ds)).astype(np.float32))


def _port_grads(fn, args, chunk, cot):
    xs, s0 = _split(fn, args)
    leaves = [torch.from_numpy(a).requires_grad_() for a in xs]
    init = None if s0 is None else torch.from_numpy(s0).requires_grad_()
    y, state = fn(*leaves, chunk=chunk, init_state=init)
    loss = (y * torch.from_numpy(cot[0])).sum() \
        + (state * torch.from_numpy(cot[1])).sum()
    wrt = leaves + ([init] if init is not None else [])
    return [g.numpy() for g in torch.autograd.grad(loss, wrt)]


def _assert_grads(got, want, rel=GRAD_REL):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert np.isfinite(a).all(), i
        scale = max(float(np.abs(b).max()), 1e-30)
        err = float(np.abs(a - b).max())
        assert err <= rel * scale, (i, err, scale)


# ---- twins of tests/models/test_ssm_blocks.py, derandomized -----------------

@settings(max_examples=12, deadline=None, derandomize=True)
@given(B=st.integers(1, 2), S=st.sampled_from([5, 64, 129]),
       nh=st.sampled_from([1, 3]), hd=st.sampled_from([8, 32]),
       ds=st.sampled_from([4, 16]), chunk=st.sampled_from([16, 64]))
def test_mamba_chunked_vs_reference_and_sequential(B, S, nh, hd, ds, chunk):
    args = _mamba_inputs(B, S, nh, hd, ds, seed=S * 7 + nh)
    y, state = _run(mamba2_chunk_scan, args, chunk)
    jy, jstate, _ = _jax_scan(jax_mamba2_chunk_scan, args, chunk)
    yr, sr = _sequential("mamba", args)
    for a, b in ((y, jy), (state, jstate), (y, yr.numpy()),
                 (state, sr.numpy())):
        np.testing.assert_allclose(a, b, atol=MAMBA_ATOL, rtol=0)


@settings(max_examples=10, deadline=None, derandomize=True)
@given(B=st.integers(1, 2), S=st.sampled_from([3, 64, 100]),
       H=st.sampled_from([1, 2]), hd=st.sampled_from([8, 32]),
       chunk=st.sampled_from([16, 64]))
def test_wkv6_chunked_vs_reference_and_sequential(B, S, H, hd, chunk):
    args = _wkv_inputs(B, S, H, hd, seed=S * 13 + H)
    y, state = _run(wkv6_chunk_scan, args, chunk)
    jy, jstate, _ = _jax_scan(jax_wkv6_chunk_scan, args, chunk)
    yr, sr = _sequential("wkv", args)
    for a, b in ((y, jy), (state, jstate), (y, yr.numpy()),
                 (state, sr.numpy())):
        np.testing.assert_allclose(a, b, **WKV_TOL)


@pytest.mark.parametrize("kind", ["mamba", "wkv"])
def test_state_carry_composes(kind):
    """Scanning [0:32] then [32:48] with the carried state == one scan
    (the reference's test, atol 1e-4; chunk 16)."""
    if kind == "mamba":
        fn, args = mamba2_chunk_scan, _mamba_inputs(1, 48, 2, 16, 8, seed=9)
        args[4], args[5] = -np.ones(2, np.float32), np.zeros(2, np.float32)
    else:
        fn, args = wkv6_chunk_scan, _wkv_inputs(1, 48, 2, 16, seed=9,
                                                w_range=(0.05, 1.0))
    n = 6 if kind == "mamba" else 5
    seq = [i for i in range(n) if args[i].ndim >= 3]

    def part(lo, hi):
        return [a[:, lo:hi] if i in seq else a for i, a in enumerate(args)]

    y_all, st_all = _run(fn, args, 16)
    y1, st1 = _run(fn, part(0, 32), 16)
    y2, st2 = _run(fn, part(32, 48) + [st1], 16)
    np.testing.assert_allclose(np.concatenate([y1, y2], 1), y_all,
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(st2, st_all, atol=1e-4, rtol=0)


# ---- init_state, ragged lengths, gradients ----------------------------------

MAMBA_CASES = [  # (B, S, nh, hd, ds, chunk, init_state): S a multiple of
    (2, 64, 3, 8, 4, 16, False),            # chunk, not one, and below it
    (1, 129, 2, 16, 8, 64, True),
    (2, 5, 1, 32, 16, 128, True),
    (1, 300, 3, 8, 16, 128, False)]
WKV_CASES = [  # (B, S, H, hd, chunk, w_range, init_state)
    (2, 64, 2, 8, 16, None, False),
    (1, 100, 2, 32, 64, None, True),
    (2, 3, 1, 8, 64, None, True),
    (1, 77, 2, 16, 16, (0.05, 1.0), True),
    (1, 130, 2, 16, 64, (0.05, 1.0), False)]


@pytest.mark.parametrize("case", MAMBA_CASES)
def test_mamba_grads_match_reference(case):
    *shape, chunk, state = case
    args = _mamba_inputs(*shape, seed=sum(shape), state=state)
    cot = _cotangents(mamba2_chunk_scan, args, sum(shape))
    y, st_ = _run(mamba2_chunk_scan, args, chunk)
    jy, jst, jgrads = _jax_scan(jax_mamba2_chunk_scan, args, chunk, cot)
    np.testing.assert_allclose(y, jy, atol=MAMBA_ATOL, rtol=0)
    np.testing.assert_allclose(st_, jst, atol=MAMBA_ATOL, rtol=0)
    _assert_grads(_port_grads(mamba2_chunk_scan, args, chunk, cot), jgrads)


@pytest.mark.parametrize("case", WKV_CASES)
def test_wkv6_grads_match_reference(case):
    *shape, chunk, w_range, state = case
    args = _wkv_inputs(*shape, seed=sum(shape), w_range=w_range,
                       state=state)
    cot = _cotangents(wkv6_chunk_scan, args, sum(shape))
    y, st_ = _run(wkv6_chunk_scan, args, chunk)
    jy, jst, jgrads = _jax_scan(jax_wkv6_chunk_scan, args, chunk, cot)
    np.testing.assert_allclose(y, jy, **WKV_TOL)
    np.testing.assert_allclose(st_, jst, **WKV_TOL)
    _assert_grads(_port_grads(wkv6_chunk_scan, args, chunk, cot), jgrads)


# ---- C12: the Mamba2 segment sum ----------------------------------------------

def _mamba_float64(xh, Bm, Cm, dt, A, D):
    """The sequential recurrence in float64 (mamba_scan_ref computes in
    float32)."""
    B, S, nh, hd = xh.shape
    state = xh.new_zeros(B, nh, hd, Bm.shape[-1])
    xt, lA, ys = xh * dt[..., None], dt * A, []
    for t in range(S):
        state = state * torch.exp(lA[:, t])[:, :, None, None] \
            + torch.einsum("bnp,bs->bnps", xt[:, t], Bm[:, t])
        ys.append(torch.einsum("bnps,bs->bnp", state, Cm[:, t]))
    return torch.stack(ys, 1) + xh * D[None, None, :, None], state


@pytest.mark.parametrize("seed", [0, 1])
def test_mamba_segment_sum_keeps_gradients_at_strong_decay(seed):
    """zamba2's decays (A = -linspace(1, 16), dt = softplus(normal); x, B, C
    as silu of normals, the block's conv output), chunk 128, S 256: every
    gradient of the port's scan within 1e-5 of its max|g| from float64,
    and the reference's dt or A gradient at least 3x further off (its
    cumulative-sum differences, ROADMAP C12)."""
    rng = np.random.default_rng(seed)
    B, S, nh, hd, ds = 2, 256, 4, 16, 16

    def silu(x):
        return (x / (1 + np.exp(-x))).astype(np.float32)

    args = [silu(rng.standard_normal((B, S, nh, hd))),
            silu(rng.standard_normal((B, S, ds))),
            silu(rng.standard_normal((B, S, ds))),
            np.logaddexp(0, rng.standard_normal((B, S, nh))).astype(
                np.float32),
            -np.linspace(1, 16, nh).astype(np.float32),
            np.ones(nh, np.float32)]
    cot = _cotangents(mamba2_chunk_scan, args, seed)
    port = _port_grads(mamba2_chunk_scan, args, 128, cot)
    _, _, ref = _jax_scan(jax_mamba2_chunk_scan, args, 128, cot)
    leaves = [torch.from_numpy(a).double().requires_grad_() for a in args]
    y, state = _mamba_float64(*leaves)
    exact = torch.autograd.grad(
        (y * torch.from_numpy(cot[0]).double()).sum()
        + (state * torch.from_numpy(cot[1]).double()).sum(), leaves)

    def rel(grads):
        return [float(np.abs(g - e.numpy()).max() / np.abs(e.numpy()).max())
                for g, e in zip(grads, exact)]

    mine, theirs = rel(port), rel(ref)
    assert max(mine) <= 1e-5, mine
    assert max(theirs[3:5]) >= 3 * max(mine), (mine, theirs)


# ---- C2: strong decay ---------------------------------------------------------

def _wkv_ref_grads(args, cot):
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    y, state = wkv6_ref(*leaves)
    loss = (y * torch.from_numpy(cot[0])).sum() \
        + (state * torch.from_numpy(cot[1])).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


def _strong_decay(w, chunk):
    """The port at constant w (B 1, S 64, H 2, hd 32): y, state, its
    gradients, and wkv6_ref's three."""
    args = _wkv_inputs(1, 64, 2, 32, seed=5)
    args[3] = np.full_like(args[3], w)
    cot = _cotangents(wkv6_chunk_scan, args, 5)
    y, st_ = _run(wkv6_chunk_scan, args, chunk)
    yr, sr = _sequential("wkv", args)
    return (args, cot, (y, st_, _port_grads(wkv6_chunk_scan, args, chunk,
                                            cot)),
            (yr.numpy(), sr.numpy(), _wkv_ref_grads(args, cot)))


@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("w", [0.2, 0.05])
def test_wkv6_finite_under_strong_decay(w, chunk):
    """Constant w on every token: the port is finite, with gradients,
    within WKV_TOL of wkv6_ref and of autograd through it (and within
    GRAD_REL of its max|g|), at chunk 16 and 64.  At chunk 64 the
    reference's own scan is not finite there (C2); at chunk 16 it is, and
    the port agrees with it."""
    args, cot, (y, st_, grads), (yr, sr, rgrads) = _strong_decay(w, chunk)
    assert np.isfinite(y).all() and np.isfinite(st_).all()
    np.testing.assert_allclose(y, yr, **WKV_TOL)
    np.testing.assert_allclose(st_, sr, **WKV_TOL)
    for a, b in zip(grads, rgrads):
        np.testing.assert_allclose(a, b, **WKV_TOL)
    _assert_grads(grads, rgrads)
    jy, jst, _ = _jax_scan(jax_wkv6_chunk_scan, args, chunk)
    if chunk == 64:
        assert not np.isfinite(jy).all()
    else:
        np.testing.assert_allclose(y, jy, **WKV_TOL)
        np.testing.assert_allclose(st_, jst, **WKV_TOL)


def test_wkv6_finite_down_to_2e_5():
    """w = 2e-5 on every token (8 |log w| = 86.6, below float32's 88.7):
    y and the state within WKV_TOL of wkv6_ref, every gradient finite, and
    those of r, k, v, u within GRAD_REL of max|g|.  (The gradient of w
    itself is a difference of terms of size ~max|g| / w times smaller
    than them here, so it is held to be finite only.)"""
    _, _, (y, st_, grads), (yr, sr, rgrads) = _strong_decay(2e-5, 64)
    np.testing.assert_allclose(y, yr, **WKV_TOL)
    np.testing.assert_allclose(st_, sr, **WKV_TOL)
    assert all(np.isfinite(g).all() for g in grads)
    _assert_grads(grads[:3] + grads[4:], rgrads[:3] + rgrads[4:])


def test_wkv6_blocks_are_sub_chunks():
    """chunk 64 and chunk 16 take the same 16-token blocks: equal bits."""
    args = _wkv_inputs(2, 100, 2, 8, seed=3, w_range=(0.05, 1.0))
    assert SUB_CHUNK == 16
    for a, b in zip(_run(wkv6_chunk_scan, args, 64),
                    _run(wkv6_chunk_scan, args, 16)):
        np.testing.assert_array_equal(a, b)


# ---- C15: a no-grad call takes its chunks a group at a time -------------------

GROUP_CASES = [  # (kind, shape, chunk, group, init_state): S not a multiple
    ("mamba", (2, 300, 3, 8, 16), 16, 4, True),     # of the group's tokens
    ("mamba", (1, 200, 2, 16, 8), 64, 1, False),
    ("wkv", (2, 300, 2, 16), 64, 5, True),
    ("wkv", (1, 37, 1, 8), 16, 1, False)]


@pytest.mark.parametrize("case", GROUP_CASES)
def test_grouped_scan_matches_all_at_once_and_reference(monkeypatch, case):
    """Without autograd the scans take a group of chunks at a time
    (MAMBA_GROUP, WKV_GROUP; here `group`), the state
    carried between groups: y within 1e-6 of max|y| of the all-at-once
    form (one group of every chunk), the final states equal to rounding,
    and both within the reference's tolerances (tests/models/
    test_ssm_blocks.py's) of its chunk scan, init_state included."""
    kind, shape, chunk, group, state = case
    if kind == "mamba":
        fn, jfn, tol = mamba2_chunk_scan, jax_mamba2_chunk_scan, dict(
            atol=MAMBA_ATOL, rtol=0)
        args = _mamba_inputs(*shape, seed=sum(shape), state=state)
    else:
        fn, jfn, tol = wkv6_chunk_scan, jax_wkv6_chunk_scan, WKV_TOL
        args = _wkv_inputs(*shape, seed=sum(shape), w_range=(0.05, 1.0),
                           state=state)
    xs, s0 = _split(fn, args)
    t = [torch.from_numpy(a) for a in xs]
    init = None if s0 is None else torch.from_numpy(s0)
    calls = []
    chunks = ssm_module._mamba2_chunks if kind == "mamba" \
        else ssm_module._wkv6_chunks
    size = "MAMBA_GROUP" if kind == "mamba" else "WKV_GROUP"
    monkeypatch.setattr(ssm_module, chunks.__name__, lambda *a: calls.append(
        a[0].shape[1]) or chunks(*a))
    monkeypatch.setattr(ssm_module, size, group)
    y, st_ = fn(*t, chunk=chunk, init_state=init)
    n_grouped = len(calls)
    monkeypatch.setattr(ssm_module, size, 10 ** 6)
    y1, st1 = fn(*t, chunk=chunk, init_state=init)
    L = min(chunk, shape[1]) if kind == "mamba" \
        else min(chunk, SUB_CHUNK, shape[1])
    S = shape[1]
    assert n_grouped == -(-S // (group * L)) and len(calls) == \
        n_grouped + 1 and calls[-1] == S
    assert y.shape == y1.shape and st_.shape == st1.shape
    scale = float(y1.abs().max())
    assert float((y - y1).abs().max()) <= 1e-6 * scale
    np.testing.assert_allclose(st_.numpy(), st1.numpy(), atol=1e-6 * float(
        st1.abs().max()), rtol=0)
    jy, jst, _ = _jax_scan(jfn, args, chunk)
    np.testing.assert_allclose(y.numpy(), jy, **tol)
    np.testing.assert_allclose(st_.numpy(), jst, **tol)


@pytest.mark.parametrize("kind", ["mamba", "wkv"])
def test_grouped_only_without_autograd(monkeypatch, kind):
    """Under autograd the scans keep the all-at-once form, the training
    path's: one call of every chunk whatever the group, and so the same
    bits."""
    fn = mamba2_chunk_scan if kind == "mamba" else wkv6_chunk_scan
    name = "_mamba2_chunks" if kind == "mamba" else "_wkv6_chunks"
    args = _mamba_inputs(1, 100, 2, 8, 4, seed=5) if kind == "mamba" \
        else _wkv_inputs(1, 100, 2, 8, seed=5, w_range=(0.05, 1.0))
    real, calls = getattr(ssm_module, name), []
    monkeypatch.setattr(ssm_module, name, lambda *a: calls.append(1)
                        or real(*a))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    y1, st1 = fn(*leaves, chunk=16)
    monkeypatch.setattr(ssm_module, "MAMBA_GROUP", 1)
    monkeypatch.setattr(ssm_module, "WKV_GROUP", 1)
    y, st_ = fn(*leaves, chunk=16)
    assert calls == [1, 1] and y.grad_fn is not None
    assert torch.equal(y, y1) and torch.equal(st_, st1)
