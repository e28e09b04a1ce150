"""Port kernels on the card: each kernel against its plain version.

flash_decode at the JAX sweep shapes and the serve path's (llama31-8b:
G = 4, D = 128; zamba2's shared attention: G = 1, D = 80); mamba_scan
and wkv6 at the JAX sweep shapes and the full-width prefill shapes
(zamba2: nh 80, hd = ds = 64; rwkv6: H 32, hd 64), y and final state.

Marked `cuda`; skips where no CUDA device is present.  On a machine with
an H100: `PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py`.
This file imports no jax, so it runs where only PyTorch is installed.
"""
import pytest
import torch

from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.kernels.ref import flash_decode_ref, mamba_scan_ref, wkv6_ref
from repro_torch.kernels.wkv6 import wkv6

pytestmark = pytest.mark.cuda
# float32: the JAX package's tolerance.  bfloat16: the kernel and the plain
# version both compute in f32 from the same bf16 inputs, so they differ by
# the kernel's one rounding of its output to bf16 (at most 2^-8 relative)
# plus f32 summation order; the limit is twice that rounding.
TOL = {torch.float32: dict(atol=2e-5, rtol=1e-2),
       torch.bfloat16: dict(atol=1e-4, rtol=2 ** -7)}
# the JAX package's limits for the scans (float32 in and out)
MAMBA_TOL = dict(atol=4e-4, rtol=5e-2)
WKV_TOL = dict(atol=2e-3, rtol=1e-3)


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
    (16, 32, 32, 80, 256), (4, 32, 32, 80, 1024),
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


@pytest.mark.parametrize("B,S,nh,hd,ds", [
    (2, 64, 3, 32, 16), (1, 100, 2, 64, 64), (1, 16, 1, 8, 8),
    (1, 37, 80, 64, 64), (1, 1000, 80, 64, 64), (1, 1015, 80, 64, 64),
])
def test_mamba_scan_matches_plain_on_card(gen, B, S, nh, hd, ds):
    xt = torch.randn(B, S, nh, hd, generator=gen, device="cuda")
    Bm = torch.randn(B, S, ds, generator=gen, device="cuda")
    Cm = torch.randn(B, S, ds, generator=gen, device="cuda")
    lA = -0.5 * torch.rand(B, S, nh, generator=gen, device="cuda")
    before = mamba_scan.launches
    y, st = mamba_scan(xt, Bm, Cm, lA)
    torch.cuda.synchronize()
    assert mamba_scan.launches == before + 1
    yr, sr = mamba_scan_ref(xt, Bm, Cm, lA)
    torch.testing.assert_close(y, yr, **MAMBA_TOL)
    torch.testing.assert_close(st, sr, **MAMBA_TOL)


@pytest.mark.parametrize("wmin,wmax", [(0.05, 1.0), (0.05, 0.06),
                                       (0.8, 1.0)])
@pytest.mark.parametrize("B,S,H,hd", [
    (2, 64, 2, 32), (1, 100, 3, 64), (1, 7, 1, 8), (1, 1000, 32, 64),
])
def test_wkv6_matches_plain_on_card(gen, B, S, H, hd, wmin, wmax):
    r, k, v = (torch.randn(B, S, H, hd, generator=gen, device="cuda")
               for _ in range(3))
    w = wmin + (wmax - wmin) * torch.rand(B, S, H, hd, generator=gen,
                                          device="cuda")
    u = 0.5 * torch.randn(H, hd, generator=gen, device="cuda")
    before = wkv6.launches
    y, st = wkv6(r, k, v, w, u)
    torch.cuda.synchronize()
    assert wkv6.launches == before + 1
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    yr, sr = wkv6_ref(r, k, v, w, u)
    torch.testing.assert_close(y, yr, **WKV_TOL)
    torch.testing.assert_close(st, sr, **WKV_TOL)
