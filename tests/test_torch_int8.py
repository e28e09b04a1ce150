"""Port of the int8-KV flash decode on the CPU vs the JAX reference.

`quantize_kv` against `repro.kernels.flash_decode_int8.quantize_kv` (codes
and scales bit-equal), and `ops.decode_attention_int8` on CPU tensors
(which takes the plain version) against the Pallas kernel in interpret
mode on the same int8 inputs, made with numpy from a seed.  Tolerances are
the JAX package's flash_decode ones (tests/kernels/test_kernels.py): atol
2e-5 in float32, 5e-2 in bfloat16, rtol 1e-2; against float attention on
the unquantized K/V, its int8 criterion (tests/kernels/
test_flash_decode_int8.py): max error under 2% of max|ref|.  The CUDA
kernel's exact widening of int8 codes (numpy, all 256 codes bit-exact) and
its pieces, warp tiles, factored scales and merges (emulated in plain
PyTorch) are held here too.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode_int8 import flash_decode_int8 as jax_fd8
from repro.kernels.flash_decode_int8 import quantize_kv as jax_quantize_kv
from repro.kernels.ref import flash_decode_ref as jax_flash_decode_ref
from repro_torch.kernels import flash_decode_int8 as FD8
from repro_torch.kernels import ops
from repro_torch.kernels.flash_decode_int8 import (flash_decode_int8,
                                                   quantize_kv)
from repro_torch.kernels.ref import flash_decode_int8_ref, flash_decode_ref
from test_torch_kernels import _lanes_per_row, _online

ATOL = {"float32": 2e-5, "bfloat16": 5e-2}
SHAPES = [  # (B, H, K, D, T, block_t): the JAX int8 test's, then a T that
    # is no multiple of the kernel's 256-row piece
    (2, 8, 4, 64, 100, 64), (1, 4, 2, 128, 300, 128),
    (3, 2, 2, 32, 50, 16), (2, 16, 4, 128, 777, 256),
]


def _as_dtype(x, dtype):
    """numpy float32 holding values exactly representable in `dtype`."""
    return torch.from_numpy(x).to(getattr(torch, dtype)).float().numpy()


def _inputs(B, H, K, D, T, dtype, seed):
    """q (rounded to `dtype`), float32 k and v, int32 lengths in [1, T]."""
    rng = np.random.default_rng(seed)
    q = _as_dtype(rng.standard_normal((B, H, D)).astype(np.float32), dtype)
    k, v = (rng.standard_normal((B, T, K, D)).astype(np.float32)
            for _ in range(2))
    lengths = rng.integers(1, T + 1, size=B).astype(np.int32)
    return q, k, v, lengths


def _port(q, dtype, *rest):
    """Torch tensors: q in `dtype`, the other arrays as they are."""
    return (torch.from_numpy(q).to(getattr(torch, dtype)),
            *(torch.from_numpy(np.ascontiguousarray(a)) for a in rest))


def _quantized(k, v):
    """The port's quantization as numpy arrays (kq, vq, ks, vs)."""
    return [t.numpy() for t in quantize_kv(torch.from_numpy(k),
                                           torch.from_numpy(v))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 100, 4, 64), (1, 300, 2, 128),
                                   (3, 50, 2, 32)])
def test_quantize_kv_bit_equal_to_jax(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    k = _as_dtype(3 * rng.standard_normal(shape).astype(np.float32), dtype)
    v = _as_dtype(rng.standard_normal(shape).astype(np.float32), dtype)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    ours = quantize_kv(torch.from_numpy(k).to(tdt),
                       torch.from_numpy(v).to(tdt))
    theirs = jax_quantize_kv(jnp.asarray(k, jdt), jnp.asarray(v, jdt))
    for a, b in zip(ours, theirs):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.numpy(), b)


def test_quantize_roundtrip_error_and_bytes():
    """The JAX test's bounds: 127-level symmetric quantization within 1% of
    max|k|, and codes plus scales under 0.55x the bf16 bytes."""
    rng = np.random.default_rng(0)
    k = torch.from_numpy(3 * rng.standard_normal((2, 64, 4, 64))
                         .astype(np.float32))
    kq, _, ks, _ = quantize_kv(k, k)
    assert kq.dtype == torch.int8 and ks.dtype == torch.float32
    deq = kq.float() * ks[..., None]
    assert float((deq - k).abs().max() / k.abs().max()) < 0.01
    nbytes = kq.numel() * kq.element_size() + ks.numel() * 2
    assert nbytes < 0.55 * k.numel() * 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,K,D,T,bt", SHAPES)
def test_decode_attention_int8_matches_pallas(B, H, K, D, T, bt, dtype):
    q, k, v, lengths = _inputs(B, H, K, D, T, dtype, seed=B * 11 + T)
    kq, vq, ks, vs = _quantized(k, v)
    flash_decode_int8.launches = 0
    out = ops.decode_attention_int8(*_port(q, dtype, kq, vq, ks, vs,
                                           lengths))
    assert flash_decode_int8.launches == 0     # CPU tensors: plain version
    assert out.dtype == getattr(torch, dtype) and out.shape == (B, H, D)
    pallas = jax_fd8(jnp.asarray(q, getattr(jnp, dtype)), jnp.asarray(kq),
                     jnp.asarray(vq), jnp.asarray(ks), jnp.asarray(vs),
                     jnp.asarray(lengths), block_t=bt, interpret=True)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(pallas.astype(jnp.float32)),
                               atol=ATOL[dtype], rtol=1e-2)


@pytest.mark.parametrize("B,H,K,D,T,bt", SHAPES)
def test_int8_close_to_float_attention(B, H, K, D, T, bt):
    """int8 K/V against float attention on the unquantized K/V (the JAX
    reference's plain version): within 2% of max|ref|."""
    q, k, v, lengths = _inputs(B, H, K, D, T, "float32", seed=B * 11 + T)
    out = ops.decode_attention_int8(*_port(q, "float32", *_quantized(k, v),
                                           lengths))
    ref = np.asarray(jax_flash_decode_ref(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v),
                                          jnp.asarray(lengths)))
    assert np.abs(out.numpy() - ref).max() / np.abs(ref).max() < 0.02


def test_int8_matches_float_when_exact():
    """+-1 values quantize exactly (scale 1/127, codes +-127), so int8
    attention equals the port's float attention on the same values."""
    B, H, K, D, T = 1, 2, 2, 32, 40
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    base = np.sign(rng.standard_normal((B, T, K, D))).astype(np.float32)
    lengths = np.array([T], np.int32)
    a = ops.decode_attention_int8(*_port(q, "float32",
                                         *_quantized(base, base), lengths))
    b = flash_decode_ref(*_port(q, "float32", base, base, lengths))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


@pytest.mark.parametrize("T", [1, 37, 300])
def test_int8_codes_past_lengths_never_leak(T):
    """Codes at t >= lengths overwritten with +-99 (and their scales
    inflated) leave the output bit-equal in the port, and the Pallas kernel
    agrees on the overwritten inputs."""
    B, H, K, D = 3, 4, 2, 16
    q, k, v, lengths = _inputs(B, H, K, D, T, "float32", seed=T)
    kq, vq, ks, vs = _quantized(k, v)
    past = np.arange(T)[None, :, None] >= lengths[:, None, None]
    kq2 = np.where(past[..., None], np.int8(99), kq)
    vq2 = np.where(past[..., None], np.int8(-99), vq)
    ks2, vs2 = (np.where(past, np.float32(1e3), s) for s in (ks, vs))
    out1 = ops.decode_attention_int8(*_port(q, "float32", kq, vq, ks, vs,
                                            lengths))
    out2 = ops.decode_attention_int8(*_port(q, "float32", kq2, vq2, ks2,
                                            vs2, lengths))
    assert torch.equal(out1, out2)
    pallas = jax_fd8(jnp.asarray(q), jnp.asarray(kq2), jnp.asarray(vq2),
                     jnp.asarray(ks2), jnp.asarray(vs2),
                     jnp.asarray(lengths), block_t=32, interpret=True)
    np.testing.assert_allclose(out2.numpy(), np.asarray(pallas), atol=2e-5,
                               rtol=1e-2)


def _small(seed=0):
    q, k, v, lengths = _inputs(2, 4, 2, 16, 9, "float32", seed=seed)
    return list(_port(q, "float32", *_quantized(k, v), lengths))


def test_int8_plain_impl_and_unknown_impl():
    args = _small()
    torch.testing.assert_close(ops.decode_attention_int8(*args,
                                                         impl="plain"),
                               flash_decode_int8_ref(*args))
    with pytest.raises(ValueError, match="impl"):
        ops.decode_attention_int8(*args, impl="pallas")


@pytest.mark.parametrize("entry", ["kernel", "ops"])
@pytest.mark.parametrize("bad", ["int64_lengths", "float16_q", "uint8_codes",
                                 "bf16_scales", "scales_shape", "gqa_ratio",
                                 "head_dim_not_16", "head_dim_stride",
                                 "unaligned_rows"])
def test_int8_wrapper_rejects_what_the_kernel_does_not_take(bad, entry):
    """The kernel's wrapper and the CPU path of `ops` refuse the same
    inputs, so the plain version takes nothing the kernel would not."""
    q, kq, vq, ks, vs, lengths = _small()
    if bad == "int64_lengths":
        lengths = lengths.long()
    elif bad == "float16_q":
        q = q.half()
    elif bad == "uint8_codes":
        kq = kq.to(torch.uint8)
    elif bad == "bf16_scales":
        vs = vs.bfloat16()
    elif bad == "scales_shape":
        ks = ks[:, :-1]
    elif bad == "gqa_ratio":
        q = torch.zeros(2, 3, 16)
    elif bad == "head_dim_not_16":
        q, kq, vq = q[..., :8].contiguous(), kq[..., :8].contiguous(), \
            vq[..., :8].contiguous()
    elif bad == "head_dim_stride":
        kq = kq.transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "unaligned_rows":      # rows of 16 codes, 8 bytes apart
        vq = torch.zeros(vq.numel(), dtype=torch.int8).as_strided(
            vq.shape, (vq.shape[1] * vq.shape[2] * 8, vq.shape[2] * 8, 8, 1))
    call = flash_decode_int8 if entry == "kernel" else \
        ops.decode_attention_int8
    with pytest.raises((TypeError, ValueError)):
        call(q, kq, vq, ks, vs, lengths)


def test_int8_kernel_wrapper_refuses_cpu_tensors():
    """Only `ops` decides which version runs: the wrapper launches the
    kernel on a CUDA tensor and raises on any other device."""
    flash_decode_int8.launches = 0
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode_int8(*_small())
    assert flash_decode_int8.launches == 0


def test_int8_zero_length_sequence_gets_zero_output():
    """lengths[b] <= 0 attends to nothing: a zero row (the CUDA kernel's
    output there), while the other rows are untouched."""
    q, k, v, lengths = _inputs(3, 4, 2, 16, 9, "float32", seed=1)
    args = list(_port(q, "float32", *_quantized(k, v)))
    out = ops.decode_attention_int8(
        *args, torch.tensor([0, 5, -2], dtype=torch.int32))
    assert not bool(out[0].any()) and not bool(out[2].any())
    torch.testing.assert_close(out[1:2], ops.decode_attention_int8(
        *(a[1:2] for a in args), torch.tensor([5], dtype=torch.int32)))
    assert float(out[1].abs().max()) > 0


# ---- the CUDA kernel's widening and its piece/merge arithmetic ----------
# (held on the CPU; the kernel itself runs in tests/test_torch_cuda.py)

def _byte_perm(x, y, s):
    """CUDA's __byte_perm on uint32 arrays: byte n of the result is byte
    (s >> 4 n) & 7 of the eight bytes x (0-3), y (4-7)."""
    pool = np.stack([(x >> (8 * i)) & 0xFF for i in range(4)]
                    + [np.full_like(x, (y >> (8 * i)) & 0xFF)
                       for i in range(4)])
    out = np.zeros_like(x)
    for n in range(4):
        out |= pool[(s >> (4 * n)) & 7] << (8 * n)
    return out


def test_byte_perm_mirror():
    x = np.array([0x33221100], np.uint32)
    assert _byte_perm(x, 0x77665544, 0x7531)[0] == 0x77553311
    assert _byte_perm(x, 0x4B000000, 0x7442)[0] == 0x4B000022


def test_widening_is_exact_for_all_256_codes():
    """The kernel's widen4: x = word ^ 0x80808080, then per code j the
    float bits __byte_perm(x, 0x4B000000, 0x7440 + j) = 2^23 + (code + 128),
    minus 8388736.0f (2^23 + 128, in f32) gives the code exactly."""
    codes = np.arange(-128, 128, dtype=np.int8)
    words = codes.view(np.uint32)                # 64 words of 4 codes
    x = words ^ np.uint32(0x80808080)
    got = np.stack([_byte_perm(x, 0x4B000000, 0x7440 + j).view(np.float32)
                    - np.float32(8388736.0) for j in range(4)], axis=1)
    assert got.dtype == np.float32
    assert np.array_equal(got.reshape(-1), codes.astype(np.float32))
    assert np.float32(8388736.0) == 2.0 ** 23 + 128


def _group_bucket(G):
    return next(b for b in (1, 2, 4, 8, 16) if G <= b)


def _int8_rows_per_tile(G, D):
    """csrc/flash_decode_int8.cu's lane layout: CPL codes a lane takes of a
    row (16 for G <= 4, 8 for G = 8, 4 for G = 16), D / CPL segments read by
    the next power of two lanes (at most 32, NSEG segments a lane), RS row
    steps a tile (4; 1 where the lane's V sums GB x CPL x NSEG take 128
    registers)."""
    gb = _group_bucket(G)
    cpl = 16 if gb <= 4 else 8 if gb == 8 else 4
    nseg = 2 if D // cpl > 32 else 1
    rs = 1 if gb * cpl * nseg >= 128 else 4
    return rs * (32 // _lanes_per_row(D // cpl))


def _int8_tile(m, l, acc, qg, kq, ks, vq, vs):
    """A tile's rows into a warp's state: scores ks_t (q . kq_t), base 2;
    the sums rescaled only where the tile raises the max (corr = 1
    otherwise); p_t vs_t times the V codes."""
    s = (qg @ kq.float().T) * ks[None]
    mx = s.max(-1).values
    up = mx > m
    corr = torch.where(up, torch.exp2(m - mx), torch.ones_like(m))
    m = torch.where(up, mx, m)
    p = torch.exp2(s - m[:, None])
    return (m, l * corr + p.sum(-1),
            acc * corr[:, None] + (p * vs[None]) @ vq.float())


def _emulate_int8_kernel(q, kq, vq, ks, vs, lengths, n_sm=132, warps=4):
    """The int8 kernel's arithmetic in plain PyTorch, f32: its `plan`'s
    pieces, each a block of `warps` warps taking tiles in turn (each an
    online softmax, `_int8_tile`), the warps combined in warp order; q
    scaled by log2(e) / sqrt(D); a sequence of one piece written directly,
    else its pieces merged in piece order."""
    B, H, D = q.shape
    T, K = kq.shape[1], kq.shape[2]
    G = H // K
    R = _int8_rows_per_tile(G, D)
    piece, _ = FD8.plan(B, K, T, n_sm)
    out = torch.zeros(B, H, D)
    scale = math.log2(math.e) / math.sqrt(D)
    for b in range(B):
        n = min(max(int(lengths[b]), 0), T)
        for kh in range(K):
            heads = slice(kh * G, (kh + 1) * G)
            qg = q[b, heads].float() * scale
            parts = []
            for c0 in range(0, n, piece):
                c1 = min(c0 + piece, n)
                states = []
                for w in range(warps):
                    st = (torch.full((G,), -1e30), torch.zeros(G),
                          torch.zeros(G, D))
                    for t0 in range(c0 + w * R, c1, warps * R):
                        r = slice(t0, min(t0 + R, c1))
                        st = _int8_tile(*st, qg, kq[b, r, kh], ks[b, r, kh],
                                        vq[b, r, kh], vs[b, r, kh])
                    states.append(st)
                parts.append(_online(states))
            if parts:
                _, l, acc = _online(parts)
                out[b, heads] = acc / l[:, None]
    return out


MIRROR_SHAPES = SHAPES + [  # multi-piece (64-row pieces), G = 8 and 16
    (3, 8, 4, 64, T, 64) for T in (63, 64, 65, 127, 128, 129)] + [
    (2, 16, 2, 32, 200, 64), (2, 32, 2, 16, 150, 32),
    (1, 32, 2, 256, 100, 32)]


@pytest.mark.parametrize("B,H,K,D,T,bt", MIRROR_SHAPES)
def test_kernel_arithmetic_mirror_matches_ref_and_pallas(B, H, K, D, T, bt):
    """The kernel's pieces, warp tiles, factored scales and merges, in
    plain PyTorch, against flash_decode_int8_ref and the Pallas kernel in
    interpret mode on the same codes, at the JAX int8 test's shapes, at T
    and lengths one row around the first piece ends, and at G = 8 and 16
    (the kernel's other lane layouts); f32 at the JAX package's
    tolerance."""
    q, k, v, lengths = _inputs(B, H, K, D, T, "float32", seed=B * 7 + T)
    piece, n_split = FD8.plan(B, K, T, 132)
    edge = (B, H, K, D) == (3, 8, 4, 64)
    if edge:
        lengths = np.array([T, min(piece + 1, T), piece - 1], np.int32)
    kq, vq, ks, vs = _quantized(k, v)
    args = _port(q, "float32", kq, vq, ks, vs, lengths)
    got = _emulate_int8_kernel(*args)
    torch.testing.assert_close(got, flash_decode_int8_ref(*args),
                               atol=2e-5, rtol=1e-2)
    pallas = jax_fd8(jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
                     jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(lengths),
                     block_t=bt, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=2e-5,
                               rtol=1e-2)
    if edge and T > piece:
        assert n_split > 1 and int(lengths.max()) > piece
