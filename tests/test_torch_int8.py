"""Port of the int8-KV flash decode on the CPU vs the JAX reference.

`quantize_kv` against `repro.kernels.flash_decode_int8.quantize_kv` (codes
and scales bit-equal), and `ops.decode_attention_int8` on CPU tensors
(which takes the plain version) against the Pallas kernel in interpret
mode on the same int8 inputs, made with numpy from a seed.  Tolerances are
the JAX package's flash_decode ones (tests/kernels/test_kernels.py): atol
2e-5 in float32, 5e-2 in bfloat16, rtol 1e-2; against float attention on
the unquantized K/V, its int8 criterion (tests/kernels/
test_flash_decode_int8.py): max error under 2% of max|ref|.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode_int8 import flash_decode_int8 as jax_fd8
from repro.kernels.flash_decode_int8 import quantize_kv as jax_quantize_kv
from repro.kernels.ref import flash_decode_ref as jax_flash_decode_ref
from repro_torch.kernels import ops
from repro_torch.kernels.flash_decode_int8 import (flash_decode_int8,
                                                   quantize_kv)
from repro_torch.kernels.ref import flash_decode_int8_ref, flash_decode_ref

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
