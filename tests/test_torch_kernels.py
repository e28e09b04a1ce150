"""Port kernels on the CPU vs the JAX reference: flash_decode.

The same inputs, made with numpy from a seed, go through the JAX Pallas
kernel in interpret mode, the JAX plain reference, and the port's CPU path
(`ops.decode_attention` on CPU tensors, which takes the plain version).
Tolerances are the JAX package's own (tests/kernels/test_kernels.py):
atol 2e-5 in float32, 5e-2 in bfloat16, rtol 1e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_decode as jax_flash_decode
from repro.kernels.ref import flash_decode_ref as jax_flash_decode_ref
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
