"""Port kernels on the CPU vs the JAX reference: flash_decode.

The same inputs, made with numpy from a seed, go through the JAX Pallas
kernel in interpret mode, the JAX plain reference, and the port's CPU path
(`ops.decode_attention` on CPU tensors, which takes the plain version).
Tolerances are the JAX package's own (tests/kernels/test_kernels.py):
atol 2e-5 in float32, 5e-2 in bfloat16, rtol 1e-2.  The CUDA kernel's
`plan`, its rule for 16-byte loads and its piece/merge arithmetic
(emulated in plain PyTorch) are held here too.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_decode as jax_flash_decode
from repro.kernels.ref import flash_decode_ref as jax_flash_decode_ref
from repro_torch.kernels import flash_decode as FD
from repro_torch.kernels import flash_decode_int8 as FD8
from repro_torch.kernels import ops
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.ref import flash_decode_ref

ATOL = {"float32": 2e-5, "bfloat16": 5e-2}
SWEEP = [  # (B, H, K, D, T, block_t) of the JAX kernel sweep
    (2, 8, 4, 64, 100, 64), (1, 16, 8, 128, 300, 256),
    (3, 4, 4, 32, 64, 16), (1, 4, 1, 128, 513, 128),
]


def _inputs(B, H, K, D, T, dtype, seed):
    """numpy float32 inputs holding values exactly representable in
    `dtype` (bfloat16 rounding done once, by torch), and int32 lengths."""
    rng = np.random.default_rng(seed)
    tdt = getattr(torch, dtype)
    arrs = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(tdt).float().numpy()
            for s in ((B, H, D), (B, T, K, D), (B, T, K, D))]
    lengths = rng.integers(1, T + 1, size=B).astype(np.int32)
    return (*arrs, lengths)


def _port(q, k, v, lengths, dtype):
    tdt = getattr(torch, dtype)
    return (torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
            torch.from_numpy(v).to(tdt), torch.from_numpy(lengths))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,K,D,T,bt", SWEEP)
def test_decode_attention_matches_pallas(B, H, K, D, T, bt, dtype):
    q, k, v, lengths = _inputs(B, H, K, D, T, dtype, seed=B * 7 + T)
    flash_decode.launches = 0
    out = ops.decode_attention(*_port(q, k, v, lengths, dtype))
    assert flash_decode.launches == 0          # CPU tensors: plain version
    assert out.dtype == getattr(torch, dtype) and out.shape == (B, H, D)
    jdt = getattr(jnp, dtype)
    pallas = jax_flash_decode(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                              jnp.asarray(v, jdt), jnp.asarray(lengths),
                              block_t=bt, interpret=True)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(pallas.astype(jnp.float32)),
                               atol=ATOL[dtype], rtol=1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,K,D,T,bt", SWEEP)
def test_flash_decode_ref_matches_jax_ref(B, H, K, D, T, bt, dtype):
    """The plain versions agree in f32 (the point is the algorithm)."""
    q, k, v, lengths = _inputs(B, H, K, D, T, dtype, seed=B * 7 + T + 1)
    ref = flash_decode_ref(*_port(q, k, v, lengths, "float32"))
    jref = jax_flash_decode_ref(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(lengths))
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), atol=2e-5,
                               rtol=1e-2)


@pytest.mark.parametrize("T", [1, 37, 200])
def test_entries_past_lengths_never_leak(T):
    """K/V entries at t >= lengths, overwritten with +-999, leave the
    output unchanged, in the port and in the Pallas kernel alike."""
    B, H, K, D = 3, 4, 2, 16
    q, k, v, lengths = _inputs(B, H, K, D, T, "float32", seed=T)
    mask = np.arange(T)[None, :, None, None] < lengths[:, None, None, None]
    k2 = np.where(mask, k, 999.0).astype(np.float32)
    v2 = np.where(mask, v, -999.0).astype(np.float32)
    out1 = ops.decode_attention(*_port(q, k, v, lengths, "float32"))
    out2 = ops.decode_attention(*_port(q, k2, v2, lengths, "float32"))
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), atol=1e-5)
    pallas = jax_flash_decode(jnp.asarray(q), jnp.asarray(k2),
                              jnp.asarray(v2), jnp.asarray(lengths),
                              block_t=32, interpret=True)
    np.testing.assert_allclose(out2.numpy(), np.asarray(pallas), atol=2e-5,
                               rtol=1e-2)


def test_plain_impl_and_unknown_impl():
    q, k, v, lengths = _port(*_inputs(2, 4, 2, 8, 9, "float32", seed=0),
                             "float32")
    torch.testing.assert_close(ops.decode_attention(q, k, v, lengths,
                                                    impl="plain"),
                               flash_decode_ref(q, k, v, lengths))
    with pytest.raises(ValueError, match="impl"):
        ops.decode_attention(q, k, v, lengths, impl="pallas")


@pytest.mark.parametrize("entry", ["kernel", "ops"])
@pytest.mark.parametrize("bad", ["int64_lengths", "float16", "mixed_dtype",
                                 "gqa_ratio", "head_dim_stride"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, entry):
    """The kernel's wrapper and the CPU path of `ops` refuse the same
    inputs, so the plain version takes nothing the kernel would not."""
    q, k, v, lengths = _port(*_inputs(2, 4, 2, 8, 9, "float32", seed=0),
                             "float32")
    if bad == "int64_lengths":
        lengths = lengths.long()
    elif bad == "float16":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "mixed_dtype":
        k = k.bfloat16()
    elif bad == "gqa_ratio":
        q = torch.zeros(2, 3, 8)
    elif bad == "head_dim_stride":
        k = k.transpose(2, 3).contiguous().transpose(2, 3)
    call = flash_decode if entry == "kernel" else ops.decode_attention
    with pytest.raises((TypeError, ValueError)):
        call(q, k, v, lengths)


def test_kernel_wrapper_refuses_cpu_tensors():
    """Only `ops` decides which version runs: the wrapper launches the
    kernel on a CUDA tensor and raises on any other device."""
    q, k, v, lengths = _port(*_inputs(2, 4, 2, 8, 9, "float32", seed=0),
                             "float32")
    flash_decode.launches = 0
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode(q, k, v, lengths)
    assert flash_decode.launches == 0


def test_zero_length_sequence_gets_zero_output():
    """lengths[b] <= 0 attends to nothing: a zero row (the CUDA kernel's
    output there), while the other rows are untouched."""
    q, k, v, lengths = _port(*_inputs(3, 4, 2, 8, 9, "float32", seed=1),
                             "float32")
    lengths = torch.tensor([0, 5, -2], dtype=torch.int32)
    out = ops.decode_attention(q, k, v, lengths)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert torch.equal(out[2], torch.zeros_like(out[2]))
    torch.testing.assert_close(out[1:2], ops.decode_attention(
        q[1:2], k[1:2], v[1:2], lengths[1:2]))
    assert float(out[1].abs().max()) > 0


# ---- the CUDA kernel's plan and its piece/merge arithmetic --------------
# (held on the CPU; the kernel itself runs in tests/test_torch_cuda.py)

MAIN = [(16, 32, 8, 128, 256), (4, 32, 8, 128, 1024),   # (B, H, K, D, T)
        (16, 32, 32, 80, 256), (4, 32, 32, 80, 1024)]
PLAN_CASES = [(B, K, T) for B in (1, 4, 16) for K in (1, 8, 32)
              for T in (1, 63, 64, 65, 256, 1000, 1024, 8192, 65536)]


# the two decode kernels' plans: bf16 flash_decode's (pieces of at most
# 512 rows) and flash_decode_int8's (1536: an int8 row is half the bytes)
PLANS = {"flash_decode": (FD.plan, FD.MAX_PIECE),
         "flash_decode_int8": (FD8.plan, FD8.MAX_PIECE)}


@pytest.mark.parametrize("kernel", sorted(PLANS))
@pytest.mark.parametrize("n_sm", [132, 16])
@pytest.mark.parametrize("B,K,T", PLAN_CASES)
def test_plan_puts_every_row_in_exactly_one_piece(B, K, T, n_sm, kernel):
    plan, max_piece = PLANS[kernel]
    piece, n_split = plan(B, K, T, n_sm)
    assert piece % FD.MIN_PIECE == 0 and piece >= FD.MIN_PIECE
    assert piece <= max(max_piece, T // FD.MAX_SPLIT + FD.MIN_PIECE)
    assert (n_split - 1) * piece < T <= n_split * piece
    hits = torch.zeros(T, dtype=torch.int64)
    for s in range(n_split):
        hits[s * piece:(s + 1) * piece] += 1
    assert bool((hits == 1).all())


@pytest.mark.parametrize("kernel", sorted(PLANS))
@pytest.mark.parametrize("B,K,T", [(1, 1, 1), (65535, 1, 4096),
                                   (1, 65535, 4096), (2, 8, 2 ** 24),
                                   (4, 8, 65536), (65535, 8, 2 ** 20)])
def test_plan_grid_stays_inside_cuda_limits(B, K, T, kernel):
    """grid (K, B, n_split): x below 2^31, y and z below 2^16; at most
    MAX_SPLIT pieces, whose weights the merging block keeps in shared
    memory."""
    piece, n_split = PLANS[kernel][0](B, K, T, 132)
    assert 1 <= n_split <= min(FD.MAX_SPLIT, 65535)
    assert K < 2 ** 31 and B <= 65535
    assert n_split * piece >= T


@pytest.mark.parametrize("kernel", sorted(PLANS))
@pytest.mark.parametrize("B,H,K,D,T", MAIN)
def test_plan_gives_two_blocks_per_sm_at_the_serve_shapes(B, H, K, D, T,
                                                           kernel):
    piece, n_split = PLANS[kernel][0](B, K, T, 132)
    assert n_split * K * B >= 2 * 132


def test_int8_kernel_keeps_its_256_row_pieces():
    """The int8 kernel's pieces: no longer a fixed 256 rows (its CHUNK is
    gone) but flash_decode's occupancy plan with a longer piece limit (an
    int8 row is half a bf16 row's bytes); at the serve shapes, where the
    limit does not bind, the two plans agree."""
    assert not hasattr(FD8, "CHUNK")
    assert FD8.MAX_PIECE > FD.MAX_PIECE
    assert FD8.MAX_PIECE % FD.MIN_PIECE == 0
    for B, K, T in PLAN_CASES:
        assert FD8.plan(B, K, T, 132) == FD.plan(B, K, T, 132,
                                                  max_piece=FD8.MAX_PIECE)
    for B, _, K, _, T in MAIN:
        assert FD8.plan(B, K, T, 132) == FD.plan(B, K, T, 132)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_path_rule(dtype):
    """16-byte segments where D, bases and strides allow; else narrow."""
    tdt = getattr(torch, dtype)
    vec = 16 // torch.empty((), dtype=tdt).element_size()
    k = torch.zeros(2, 9, 2, 64, dtype=tdt)
    assert FD.wide_path(k, k)
    odd = torch.zeros(2, 9, 2, vec + 4 if vec == 8 else 6, dtype=tdt)
    assert not FD.wide_path(odd, odd)
    shifted = torch.zeros(2, 9, 2, 65, dtype=tdt)[..., 1:]
    assert shifted.stride(-1) == 1 and not FD.wide_path(shifted, shifted)


def _lanes_per_row(segs):
    lanes = 1
    while lanes < segs and lanes < 32:
        lanes *= 2
    return lanes


def _online(states):
    """(m, l, acc) states combined in order, online, base 2."""
    m, l, acc = states[0]
    for m_s, l_s, a_s in states[1:]:
        m_new = torch.maximum(m, m_s)
        c_old, c_new = torch.exp2(m - m_new), torch.exp2(m_s - m_new)
        l = l * c_old + l_s * c_new
        acc = acc * c_old[:, None] + a_s * c_new[:, None]
        m = m_new
    return m, l, acc


def _piece_state(qg, k, v, c0, c1, R, warps):
    """One block's piece: warps taking R-row tiles in turn, each an online
    softmax with one max per tile; the warps' states combined in order."""
    G, D = qg.shape
    states = []
    for w in range(warps):
        m, l, acc = torch.full((G,), -1e30), torch.zeros(G), torch.zeros(G, D)
        for t0 in range(c0 + w * R, c1, warps * R):
            rows = slice(t0, min(t0 + R, c1))
            m, l, acc = _tile(m, l, acc, qg @ k[rows].float().T,
                              v[rows].float())
        states.append((m, l, acc))
    return _online(states)


def _tile(m, l, acc, s, v):
    """A tile's scores s (G, R) and rows v (R, D) into a warp's state."""
    m_new = torch.maximum(m, s.max(-1).values)
    p = torch.exp2(s - m_new[:, None])
    corr = torch.exp2(m - m_new)
    return m_new, l * corr + p.sum(-1), acc * corr[:, None] + p @ v


def _emulate_kernel(q, k, v, lengths, n_sm, warps=4, row_steps=4,
                    with_lse=False):
    """The kernel's arithmetic in plain PyTorch, f32: `plan`'s pieces, each
    a block of `warps` warps (`_piece_state`); q scaled by
    log2(e) / sqrt(D); a sequence of one piece written directly, else its
    pieces merged online in piece order; `with_lse` also gives the lse the
    kernel writes, (m + log2 l) ln 2 of the whole length (-inf where it is
    0)."""
    B, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    vec = 16 // q.element_size()
    R = row_steps * (32 // _lanes_per_row(-(-D // vec)))
    piece, _ = FD.plan(B, K, T, n_sm)
    out = torch.zeros(B, H, D)
    lse = torch.full((B, H), -math.inf)
    scale = math.log2(math.e) / math.sqrt(D)
    for b in range(B):
        n = min(max(int(lengths[b]), 0), T)
        for kh in range(K):
            heads = slice(kh * G, (kh + 1) * G)
            parts = [_piece_state(q[b, heads].float() * scale, k[b, :, kh],
                                  v[b, :, kh], c0, min(c0 + piece, n), R,
                                  warps)
                     for c0 in range(0, n, piece)]
            if parts:
                m, l, acc = _online(parts)
                out[b, heads] = acc / l[:, None]
                lse[b, heads] = (m + torch.log2(l)) * math.log(2.0)
    return (out, lse) if with_lse else out


EDGES = [(B, H, K, D, T) for B, H, K, D in [(3, 8, 4, 64), (3, 4, 1, 32)]
         for T in (63, 64, 65, 127, 128, 129)]


@pytest.mark.parametrize("B,H,K,D,T", [s[:5] for s in SWEEP] + EDGES)
def test_piece_and_merge_arithmetic_matches_plain(B, H, K, D, T):
    """The kernel's pieces, warp tiles and merges, emulated in plain
    PyTorch, against flash_decode_ref at the JAX sweep shapes and at T and
    lengths one row around the first two piece ends (64-row pieces on a
    132-SM card at these sizes); f32 at the JAX package's tolerance."""
    q, k, v, lengths = _port(*_inputs(B, H, K, D, T, "float32", seed=T),
                             "float32")
    piece, n_split = FD.plan(B, K, T, 132)
    if (B, H, K, D, T) in EDGES:
        lengths = torch.tensor([T, piece + 1, piece - 1], dtype=torch.int32)
    got = _emulate_kernel(q, k, v, lengths, 132)
    torch.testing.assert_close(got, flash_decode_ref(q, k, v, lengths),
                               atol=2e-5, rtol=1e-2)
    if T > piece:
        assert n_split > 1 and int(lengths.max()) > piece


# ---- the softmax state and the merge over pieces of T (a KV cache whose
# sequence is sharded over ranks) ------------------------------------------

def _lse_numpy(q, k, lengths):
    """ln sum_{t < lengths} exp(q . k_t / sqrt(D)) in float64, -inf where
    lengths <= 0: (B, H)."""
    B, H, D = q.shape
    K = k.shape[2]
    s = np.einsum("bkgd,btkd->bkgt", q.reshape(B, K, H // K, D)
                  .astype(np.float64), k.astype(np.float64)) / math.sqrt(D)
    out = np.full((B, K, H // K), -np.inf)
    for b in range(B):
        n = min(max(int(lengths[b]), 0), k.shape[1])
        if n:
            row = s[b, ..., :n]
            top = row.max(-1)
            out[b] = top + np.log(np.exp(row - top[..., None]).sum(-1))
    return out.reshape(B, H)


@pytest.mark.parametrize("B,H,K,D,T",
                         [s[:5] for s in SWEEP] + [(3, 4, 2, 8, 9)])
def test_plain_lse_matches_numpy_logsumexp(B, H, K, D, T):
    """flash_decode_ref(return_lse=True): the output unchanged, lse the
    float64 logsumexp over the valid rows at f32 precision, -inf (and a
    zero output) where lengths <= 0."""
    q, k, v, lengths = _inputs(B, H, K, D, T, "float32", seed=T + 3)
    if T == 9:
        lengths = np.array([0, 5, -2], np.int32)
    args = _port(q, k, v, lengths, "float32")
    out, lse = flash_decode_ref(*args, return_lse=True)
    assert torch.equal(out, flash_decode_ref(*args))
    assert lse.dtype == torch.float32 and lse.shape == (B, H)
    np.testing.assert_allclose(lse.numpy(), _lse_numpy(q, k, lengths),
                               atol=1e-5, rtol=1e-6)


def test_emulated_kernel_lse_matches_plain():
    """The kernel's base-2 state turned into lse, (m + log2 l) ln 2, in the
    emulation of its pieces and merges, against the plain lse: one- and
    many-piece sequences and an empty one."""
    q, k, v, lengths = _port(*_inputs(3, 8, 4, 64, 300, "float32", seed=4),
                             "float32")
    lengths = torch.tensor([300, 40, 0], dtype=torch.int32)
    out, lse = _emulate_kernel(q, k, v, lengths, 132, with_lse=True)
    want, want_lse = flash_decode_ref(q, k, v, lengths, return_lse=True)
    torch.testing.assert_close(out, want, atol=2e-5, rtol=1e-2)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-6)


def _slices(T, R):
    """R slices [t0, t1) covering [0, T), the last ones past short
    sequences' lengths."""
    cuts = [T * i // R for i in range(R + 1)]
    return list(zip(cuts[:-1], cuts[1:]))


@pytest.mark.parametrize("R", [1, 2, 3, 4])
def test_merge_decode_over_t_slices_matches_unsliced(R):
    """The plain version over R T-slices of one cache, each at local
    lengths clamp(lengths - t0, 0, nt), merged by `ops.merge_decode`,
    equals it over the whole cache: slices that a short sequence leaves
    empty (lse -inf) drop out, and a sequence of length 0 stays 0."""
    B, H, K, D, T = 6, 8, 2, 16, 64
    q, k, v, lengths = _port(*_inputs(B, H, K, D, T, "float32", seed=R),
                             "float32")
    lengths = torch.tensor([64, 1, 17, 33, 0, 48], dtype=torch.int32)
    outs, lses = [], []
    for t0, t1 in _slices(T, R):
        o, l = flash_decode_ref(q, k[:, t0:t1], v[:, t0:t1],
                                (lengths - t0).clamp(0, t1 - t0),
                                return_lse=True)
        outs.append(o)
        lses.append(l)
    got = ops.merge_decode(torch.stack(outs), torch.stack(lses))
    torch.testing.assert_close(got, flash_decode_ref(q, k, v, lengths),
                               atol=1e-6, rtol=0)
    assert torch.equal(got[4], torch.zeros_like(got[4]))
    if R > 1:
        assert bool(torch.isinf(torch.stack(lses)[-1, 1]).all())


def test_sequence_sharded_decode_merges_on_a_fake_mesh():
    """ops.decode_attention on a KV cache sharded along T over a fake
    2-rank mesh: each rank attends to its shard and the states are
    all-gathered and merged.  The fake group's all-gather copies rank 0's
    state to every slot, so the whole cache it stands for is rank 0's
    shard twice; the result, placed as the query, equals the plain
    version on that cache.  Batch or heads sharded the same way still run
    on local shards, and a sharded head_dim is refused."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore
    B, H, K, D, T = 3, 8, 2, 16, 24
    q, k, v, lengths = _port(*_inputs(B, H, K, D, T, "float32", seed=9),
                             "float32")
    lengths = torch.tensor([24, 5, 0], dtype=torch.int32)
    dist.init_process_group("fake", store=FakeStore(), world_size=2, rank=0)
    try:
        mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("model",))
        rep = [DTensor.from_local(t, mesh, [Replicate()], run_check=False)
               for t in (q, lengths)]
        kseq, vseq = (DTensor.from_local(t[:, :T // 2], mesh, [Shard(1)],
                                         run_check=False) for t in (k, v))
        out = ops.decode_attention(rep[0], kseq, vseq, rep[1])
        assert tuple(out.placements) == (Replicate(),)
        whole = [torch.cat([t[:, :T // 2]] * 2, 1) for t in (k, v)]
        torch.testing.assert_close(out.to_local(), flash_decode_ref(
            q, *whole, lengths), atol=1e-6, rtol=0)
        kd = DTensor.from_local(k[..., :D // 2], mesh, [Shard(3)],
                                run_check=False)
        with pytest.raises(NotImplementedError, match="cross-rank merge"):
            ops.decode_attention(rep[0], kd, kd, rep[1])
    finally:
        dist.destroy_process_group()
