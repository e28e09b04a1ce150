"""Port kernels on the card: each kernel against its plain version.

Marked `cuda`; skips where no CUDA device is present.  On a machine with
an H100: `PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py`.
This file imports no jax, so it runs where only PyTorch is installed.
"""
import pytest
import torch

from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.ref import flash_decode_ref

pytestmark = pytest.mark.cuda
# float32: the JAX package's tolerance.  bfloat16: the kernel and the plain
# version both compute in f32 from the same bf16 inputs, so they differ by
# the kernel's one rounding of its output to bf16 (at most 2^-8 relative)
# plus f32 summation order; the limit is twice that rounding.
TOL = {torch.float32: dict(atol=2e-5, rtol=1e-2),
       torch.bfloat16: dict(atol=1e-4, rtol=2 ** -7)}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,D,T", [
    (2, 8, 4, 64, 100), (1, 16, 8, 128, 300), (3, 4, 4, 32, 64),
    (1, 4, 1, 128, 513), (16, 32, 8, 128, 256), (4, 32, 8, 128, 1024),
    (16, 32, 8, 128, 1024), (2, 32, 2, 120, 77),
])
def test_flash_decode_matches_plain_on_card(gen, B, H, K, D, T, dtype):
    q = torch.randn(B, H, D, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, T, K, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, T, K, D, generator=gen, device="cuda").to(dtype)
    lengths = torch.randint(1, T + 1, (B,), generator=gen, device="cuda",
                            dtype=torch.int32)
    before = flash_decode.launches
    out = flash_decode(q, k, v, lengths)
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 1
    torch.testing.assert_close(out.float(), flash_decode_ref(q, k, v,
                                                             lengths),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_zero_length_on_card(gen, dtype):
    """lengths[b] <= 0 gives a zero row on the card as in the plain
    version; the other rows still match."""
    B, H, K, D, T = 3, 8, 2, 64, 300
    q = torch.randn(B, H, D, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, T, K, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, T, K, D, generator=gen, device="cuda").to(dtype)
    lengths = torch.tensor([0, 257, -1], dtype=torch.int32, device="cuda")
    out = flash_decode(q, k, v, lengths)
    ref = flash_decode_ref(q, k, v, lengths)
    assert not bool(ref[0].any()) and not bool(out[0].any())
    assert not bool(out[2].any())
    torch.testing.assert_close(out.float(), ref, **TOL[dtype])
