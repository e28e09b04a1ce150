"""Port kernels on the card: each kernel against its plain version.

flash_decode at the JAX sweep shapes and the serve path's (llama31-8b:
G = 4, D = 128; zamba2's shared attention: G = 1, D = 80; granite-moe:
G = 2, D = 64), at D from 8 to
256, at T and lengths on the edges of its pieces, on its narrow path, with
a strided q; two runs bit-identical, and a CUDA-graph replay equal to the
eager call;
flash_decode_int8 at the JAX int8 sweep shapes, the same serve shapes,
multi-piece shapes up to 4 x 65536 and a ragged T, and at G = 2, 8, 16,
on codes and scales from `quantize_kv` (which is also held bit-equal to
its CPU result); two runs bit-identical, the tickets left at 0, and a
CUDA-graph replay equal to the eager call; bf16 flash_decode bit-identical
to another checkout's kernel (REPRO_PARENT_CHECKOUT; skips without it);
mamba_scan
and wkv6 at the JAX sweep shapes and the full-width prefill shapes
(zamba2: nh 80, hd = ds = 64; rwkv6: H 32, hd 64), y and final state, at
the edges of their 16-row tiles and chunks and every served prompt length
(wkv6 also under strong decay, w in [0.05, 0.06]), at B = 2, on strided
and narrow operands; two runs bit-identical, and a CUDA-graph replay
equal to the eager call.
The MoE block (no kernel of its own: plain products over the sort-based
dispatch) at granite-moe's full width in float32, at its decode batches and
prompt lengths: against a dense per-token formulation on the card, and at
decode against its own CPU result.
Recycled slots of a serving engine at llama31-8b's and zamba2-2.7b's full
width, reduced depth: short prompts admitted into slots that served longer
sequences hold K/V rows and O(1) state bit-equal to a fresh prefill, and
the rows past each slot's position, overwritten with +-999, leave a decode
step's logits bit-equal.

Marked `cuda`; skips where no CUDA device is present.  On a machine with
an H100: `PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py`
(with `REPRO_PARENT_CHECKOUT=<root of the parent's checkout>` for the
parent comparison).
This file imports no jax, so it runs where only PyTorch is installed.
"""
import ctypes
import dataclasses
import os
import subprocess
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_decode as FD
from repro_torch.kernels.flash_decode import flash_decode, plan, wide_path
from repro_torch.kernels.flash_decode_int8 import (flash_decode_int8,
                                                   quantize_kv)
from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.kernels.ref import (flash_decode_int8_ref, flash_decode_ref,
                                     mamba_scan_ref, wkv6_ref)
from repro_torch.kernels.wkv6 import wkv6
from repro_torch.configs import get_config
from repro_torch.core.profiles import H100_LLAMA70B
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models.common import rms_norm, silu
from repro_torch.serving import PoolEngine, Request

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


def _fd_inputs(gen, B, H, K, D, T, dtype, lengths=None):
    q = torch.randn(B, H, D, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, T, K, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, T, K, D, generator=gen, device="cuda").to(dtype)
    if lengths is None:
        lengths = torch.randint(1, T + 1, (B,), generator=gen,
                                device="cuda", dtype=torch.int32)
    else:
        lengths = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, k, v, lengths


def _fd_check(q, k, v, lengths):
    before = flash_decode.launches
    out = flash_decode(q, k, v, lengths)
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), flash_decode_ref(q, k, v,
                                                             lengths),
                               **TOL[q.dtype])
    return out


def _n_sm():
    return torch.cuda.get_device_properties(0).multi_processor_count


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,D,T", [
    (2, 8, 4, 64, 100), (1, 16, 8, 128, 300), (3, 4, 4, 32, 64),
    (1, 4, 1, 128, 513), (16, 32, 8, 128, 256), (4, 32, 8, 128, 1024),
    (16, 32, 8, 128, 1024), (2, 32, 2, 120, 77),
    (16, 32, 32, 80, 256), (4, 32, 32, 80, 1024),
    (16, 16, 8, 64, 256), (4, 16, 8, 64, 1024),
    (2, 16, 4, 256, 300), (1, 16, 1, 256, 2000), (2, 24, 8, 80, 3000),
    (3, 16, 2, 8, 50), (16, 32, 8, 128, 8192), (2, 8, 8, 32, 20000),
])
def test_flash_decode_matches_plain_on_card(gen, B, H, K, D, T, dtype):
    _fd_check(*_fd_inputs(gen, B, H, K, D, T, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("edge", [-1, 0, 1])
@pytest.mark.parametrize("B,H,K,D", [(16, 32, 8, 128), (4, 32, 32, 80),
                                     (1, 8, 1, 64), (2, 16, 4, 256)])
def test_flash_decode_piece_edges_on_card(gen, B, H, K, D, edge, dtype):
    """T and lengths one row below, at and above the ends of the first and
    third pieces `plan` gives on this card (a sequence of one piece writes
    out directly, one of more pieces is merged by the last block)."""
    piece = plan(B, K, 64, _n_sm())[0]
    T = 3 * piece + edge
    lens = [piece + edge, 3 * piece + edge, piece, 1, T, 2 * piece + 1]
    q, k, v, lengths = _fd_inputs(gen, B, H, K, D, T, dtype,
                                  (lens * B)[:B])
    _fd_check(q, k, v, lengths)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [200, 4096])
def test_flash_decode_lengths_zero_one_past_t_on_card(gen, T, dtype):
    """lengths 0 (a zero row), 1, past T (all of it) and negative."""
    q, k, v, lengths = _fd_inputs(gen, 5, 32, 8, 128, T, dtype,
                                  [0, 1, T + 7, -3, T // 2])
    out = _fd_check(q, k, v, lengths)
    assert not bool(out[0].any()) and not bool(out[3].any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("how", ["batch", "head"])
def test_flash_decode_strided_q_on_card(gen, how, dtype):
    """q as a view: every other batch row, or heads 2 D apart."""
    B, H, K, D, T = 4, 32, 8, 128, 1024
    _, k, v, lengths = _fd_inputs(gen, B, H, K, D, T, dtype)
    if how == "batch":
        q = torch.randn(B, 2, H, D, generator=gen, device="cuda") \
            .to(dtype)[:, 1]
    else:
        q = torch.randn(B, H, 2 * D, generator=gen, device="cuda") \
            .to(dtype)[..., D:]
    assert not q.is_contiguous()
    _fd_check(q, k, v, lengths)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["d36", "offset_base"])
def test_flash_decode_narrow_path_on_card(gen, case, dtype):
    """Inputs that cannot be read as 16-byte segments take the narrow path:
    D = 36 (not a multiple of 8 bf16; a multiple of 4 f32, so f32 stays
    wide), and K/V views one element into a wider row (base and strides
    off 16 bytes)."""
    B, H, K, T = 3, 16, 4, 700
    if case == "d36":
        q, k, v, lengths = _fd_inputs(gen, B, H, K, 36, T, dtype)
        assert wide_path(k, v) == (dtype == torch.float32)
    else:
        D = 64
        q = torch.randn(B, H, D, generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn(B, T, K, D + 1, generator=gen, device="cuda")
                .to(dtype)[..., 1:] for _ in range(2))
        lengths = torch.randint(1, T + 1, (B,), generator=gen,
                                device="cuda", dtype=torch.int32)
        assert not wide_path(k, v)
    _fd_check(q, k, v, lengths)


@pytest.mark.parametrize("B,H,K,D,T", [(4, 32, 8, 128, 1024),
                                       (16, 32, 8, 128, 8192),
                                       (16, 32, 32, 80, 256)])
def test_flash_decode_runs_are_bit_identical_on_card(gen, B, H, K, D, T):
    """No float atomics: the same inputs give the same bits, whichever
    block of a sequence merges its pieces."""
    args = _fd_inputs(gen, B, H, K, D, T, torch.bfloat16)
    a = flash_decode(*args)
    b = flash_decode(*args)
    assert torch.equal(a, b)


@pytest.mark.parametrize("B,H,K,D,T", [(4, 32, 8, 128, 1024),
                                       (16, 32, 32, 80, 256)])
def test_flash_decode_cuda_graph_replay_on_card(gen, B, H, K, D, T):
    """The kernel allocates and synchronises nothing, and its tickets reset
    themselves: a captured call replayed (twice, on new inputs copied in)
    equals the eager call."""
    args = _fd_inputs(gen, B, H, K, D, T, torch.bfloat16)
    flash_decode(*args)                    # grows the workspace
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = flash_decode(*args)
    for _ in range(2):
        new = _fd_inputs(gen, B, H, K, D, T, torch.bfloat16)
        for dst, src in zip(args, new):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, flash_decode(*args))


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


def _int8_inputs(gen, B, H, K, D, T, dtype):
    q = torch.randn(B, H, D, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, T, K, D, generator=gen, device="cuda")
    v = torch.randn(B, T, K, D, generator=gen, device="cuda")
    lengths = torch.randint(1, T + 1, (B,), generator=gen, device="cuda",
                            dtype=torch.int32)
    return (q, *quantize_kv(k, v), lengths)


INT8_MULTI_PIECE = [(16, 32, 8, 128, 8192), (4, 32, 8, 128, 65536),
                    (3, 32, 8, 128, 3001)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,D,T", [
    (2, 8, 4, 64, 100), (1, 4, 2, 128, 300), (3, 2, 2, 32, 50),
    (16, 32, 8, 128, 256), (4, 32, 8, 128, 1024), (16, 32, 8, 128, 1000),
    (16, 32, 32, 80, 256), (4, 32, 32, 80, 1024), (2, 32, 2, 16, 77),
    # multi-piece (ragged T too), and G = 2, 8, 16 (the other lane layouts;
    # G = 16 at D = 256 takes two segments a lane)
    *INT8_MULTI_PIECE, (2, 8, 4, 48, 700), (2, 16, 2, 128, 3000),
    (2, 32, 2, 64, 1500), (2, 32, 2, 256, 700),
])
def test_flash_decode_int8_matches_plain_on_card(gen, B, H, K, D, T, dtype):
    """Kernel and plain version compute in f32 from the same codes and
    scales, so they are held at the limits of flash_decode."""
    args = _int8_inputs(gen, B, H, K, D, T, dtype)
    before = flash_decode_int8.launches
    out = flash_decode_int8(*args)
    torch.cuda.synchronize()
    assert flash_decode_int8.launches == before + 1
    assert out.dtype == dtype and out.shape == (B, H, D)
    torch.testing.assert_close(out.float(), flash_decode_int8_ref(*args),
                               **TOL[dtype])


def test_flash_decode_int8_masked_codes_and_zero_length_on_card(gen):
    """Codes past lengths overwritten with +-99 leave the output bit-equal;
    lengths <= 0 give a zero row as in the plain version."""
    q, kq, vq, ks, vs, _ = _int8_inputs(gen, 3, 8, 2, 64, 300,
                                        torch.bfloat16)
    lengths = torch.tensor([0, 257, -1], dtype=torch.int32, device="cuda")
    out = flash_decode_int8(q, kq, vq, ks, vs, lengths)
    ref = flash_decode_int8_ref(q, kq, vq, ks, vs, lengths)
    assert not bool(out[0].any()) and not bool(out[2].any())
    torch.testing.assert_close(out.float(), ref, **TOL[torch.bfloat16])
    lengths = torch.tensor([1, 257, 300], dtype=torch.int32, device="cuda")
    past = (torch.arange(300, device="cuda")[None, :, None, None]
            >= lengths[:, None, None, None])
    a = flash_decode_int8(q, kq, vq, ks, vs, lengths)
    b = flash_decode_int8(q, kq.masked_fill(past, 99),
                          vq.masked_fill(past, -99), ks, vs, lengths)
    assert torch.equal(a, b)


@pytest.mark.parametrize("B,H,K,D,T", INT8_MULTI_PIECE
                         + [(16, 32, 8, 128, 256), (16, 32, 32, 80, 256)])
def test_flash_decode_int8_bits_tickets_and_graph_replay_on_card(
        gen, B, H, K, D, T):
    """No float atomics: two runs give the same bits; every launch leaves
    the workspace's tickets at 0; a captured call replayed (twice, on new
    inputs copied in) equals the eager call bit for bit."""
    args = _int8_inputs(gen, B, H, K, D, T, torch.bfloat16)
    a = flash_decode_int8(*args)
    b = flash_decode_int8(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    tickets = FD._workspace.get(0)
    assert tickets is None or not bool(tickets[1].any())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = flash_decode_int8(*args)
    for _ in range(2):
        new = _int8_inputs(gen, B, H, K, D, T, torch.bfloat16)
        for dst, src in zip(args, new):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, flash_decode_int8(*args))
    assert tickets is None or not bool(FD._workspace[0][1].any())


def _parent_flash_decode_lib():
    """The bf16 kernel of another checkout (its root in the environment
    variable REPRO_PARENT_CHECKOUT), built with this checkout's flags."""
    root = os.environ.get("REPRO_PARENT_CHECKOUT")
    if not root:
        pytest.skip("set REPRO_PARENT_CHECKOUT to another checkout's root")
    src = Path(root) / "src" / "repro_torch" / "csrc" / "flash_decode.cu"
    lib = build.BUILD_DIR / "parent_flash_decode.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True)
    parent = ctypes.CDLL(str(lib))
    FD._configure(parent)
    return parent


@pytest.mark.parametrize("B,H,K,D,T", [
    (16, 32, 8, 128, 256), (4, 32, 8, 128, 1024), (16, 32, 32, 80, 256),
    (4, 32, 32, 80, 1024), (16, 32, 8, 128, 8192)])
def test_flash_decode_bits_equal_parent_checkout_on_card(gen, B, H, K, D, T):
    """decode_common.cuh now holds what both decode kernels share: the bf16
    kernel's outputs stay bit-identical to another checkout's kernel at the
    serve shapes (and one multi-piece shape), in both dtypes."""
    parent = _parent_flash_decode_lib()
    ours = build.load(FD.SOURCE, FD._configure)
    for dtype in (torch.float32, torch.bfloat16):
        args = _fd_inputs(gen, B, H, K, D, T, dtype)
        a = flash_decode(*args)
        build._loaded[FD.SOURCE] = parent
        try:
            b = flash_decode(*args)
        finally:
            build._loaded[FD.SOURCE] = ours
        torch.cuda.synchronize()
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_kv_on_card_matches_cpu(gen, dtype):
    k = (3 * torch.randn(4, 1024, 8, 128, generator=gen, device="cuda")
         ).to(dtype)
    v = torch.randn(4, 1024, 8, 128, generator=gen, device="cuda").to(dtype)
    for a, b in zip(quantize_kv(k, v), quantize_kv(k.cpu(), v.cpu())):
        assert torch.equal(a.cpu(), b)


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


# The scans at their new edges: 16-row tiles and sub-chunks, the 64-token
# wkv6 chunk and the 128-token mamba chunk, and every prompt length the
# serve path prefills (launch/serve.py demo_requests: azure-conv, 16
# requests, window_long 1024), at the serve widths.
SCAN_EDGES = [1, 15, 16, 17, 63, 64, 65, 127, 128, 129]
SERVED = [4, 7, 15, 21, 28, 29, 42, 47, 50, 77, 89, 94, 140, 454, 579, 1015]


def _mamba_inputs(gen, B, S, nh, hd, ds):
    xt = torch.randn(B, S, nh, hd, generator=gen, device="cuda")
    Bm = torch.randn(B, S, ds, generator=gen, device="cuda")
    Cm = torch.randn(B, S, ds, generator=gen, device="cuda")
    lA = -0.5 * torch.rand(B, S, nh, generator=gen, device="cuda")
    return xt, Bm, Cm, lA


def _wkv_inputs(gen, B, S, H, hd, wmin=0.05, wmax=1.0):
    r, k, v = (torch.randn(B, S, H, hd, generator=gen, device="cuda")
               for _ in range(3))
    w = wmin + (wmax - wmin) * torch.rand(B, S, H, hd, generator=gen,
                                          device="cuda")
    u = 0.5 * torch.randn(H, hd, generator=gen, device="cuda")
    return r, k, v, w, u


def _scan_check(fn, ref, args, tol):
    before = fn.launches
    y, st = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    yr, sr = ref(*args)
    torch.testing.assert_close(y, yr, **tol)
    torch.testing.assert_close(st, sr, **tol)
    return y, st


@pytest.mark.parametrize("B,S", [(1, S) for S in sorted(set(SCAN_EDGES
                                                           + SERVED))]
                         + [(2, 300), (2, 17)])
def test_mamba_scan_tile_edges_and_served_lengths_on_card(gen, B, S):
    _scan_check(mamba_scan, mamba_scan_ref,
                _mamba_inputs(gen, B, S, 80, 64, 64), MAMBA_TOL)


@pytest.mark.parametrize("wmin,wmax", [(0.05, 1.0), (0.05, 0.06)])
@pytest.mark.parametrize("B,S", [(1, S) for S in sorted(set(SCAN_EDGES
                                                           + SERVED))]
                         + [(2, 300), (2, 17)])
def test_wkv6_tile_edges_and_served_lengths_on_card(gen, B, S, wmin, wmax):
    _scan_check(wkv6, wkv6_ref, _wkv_inputs(gen, B, S, 32, 64, wmin, wmax),
                WKV_TOL)


@pytest.mark.parametrize("case", ["model_views", "offset_base", "hd30"])
def test_mamba_scan_strided_and_narrow_operands_on_card(gen, case):
    """Bm and Cm as the model gives them (views of one projection: the
    16-byte path), and operands the kernel must read element by element:
    a base off a 16-byte boundary, hd and ds not multiples of 4."""
    B, S, nh, hd, ds = 2, 200, 6, 64, 64
    if case == "hd30":
        hd, ds = 30, 18
    xt, _, _, lA = _mamba_inputs(gen, B, S, nh, hd, ds)
    off = 8 if case == "model_views" else 7
    proj = torch.randn(B, S, 8 + 2 * ds, generator=gen, device="cuda")
    Bm, Cm = proj[..., off:off + ds], proj[..., off + ds:off + 2 * ds]
    _scan_check(mamba_scan, mamba_scan_ref, (xt, Bm, Cm, lA), MAMBA_TOL)


@pytest.mark.parametrize("case", ["offset_base", "hd30"])
def test_wkv6_narrow_operands_on_card(gen, case):
    """Contiguous operands the kernel must read element by element: a base
    off a 16-byte boundary, or hd not a multiple of 4."""
    B, S, H, hd = 2, 150, 3, 30 if case == "hd30" else 64
    args = list(_wkv_inputs(gen, B, S, H, hd))
    if case == "offset_base":
        n = B * S * H * hd
        for j in range(4):
            buf = torch.empty(n + 1, device="cuda")
            buf[1:].copy_(args[j].reshape(-1))
            args[j] = buf[1:].view(B, S, H, hd)
    _scan_check(wkv6, wkv6_ref, tuple(args), WKV_TOL)


@pytest.mark.parametrize("S", [50, 1015])
def test_scans_bit_identical_and_graph_replay_on_card(gen, S):
    """No float atomics: two runs give the same bits; and a captured call
    replayed on new inputs copied in equals the eager call (the workspace
    is grown by the eager call before the capture)."""
    for fn, args in ((mamba_scan, _mamba_inputs(gen, 1, S, 80, 64, 64)),
                     (wkv6, _wkv_inputs(gen, 1, S, 32, 64))):
        a = fn(*args)
        b = fn(*args)
        assert all(torch.equal(x, z) for x, z in zip(a, b))
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn(*args)
        new = (_mamba_inputs(gen, 1, S, 80, 64, 64) if fn is mamba_scan
               else _wkv_inputs(gen, 1, S, 32, 64))
        for dst, src in zip(args, new):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        eager = fn(*args)
        assert all(torch.equal(x, z) for x, z in zip(out, eager))


# ---- the MoE block at granite-moe's width ---------------------------------

# chip_smoke.py's MOE_REL_BOUND: the two formulations share the f32 routing
# and differ in the order of their f32 sums (about 1e-6 of max|y|)
MOE_REL = 1e-4


def _dense_moe(p, cfg, x):
    """Every expert on every token, then per token the gate-weighted sum
    over its top-k, an assignment kept when fewer than C earlier tokens
    chose the same expert.  Returns (y, experts (T, k))."""
    B, S, d = x.shape
    T, E, k = B * S, cfg.n_experts, cfg.top_k
    h = rms_norm(x, p["norm"], cfg.norm_eps).reshape(T, d)
    probs = torch.softmax(h @ p["router"], dim=-1)
    gates, idx = probs.topk(k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    chose = torch.zeros(T, E, dtype=torch.long, device=x.device) \
        .scatter_(1, idx, 1)
    C = T if S == 1 else max(int(T * k / E * cfg.capacity_factor), 1)
    keep = (chose.cumsum(0) - chose).gather(1, idx) < C
    out = torch.bmm(silu(torch.einsum("td,edf->etf", h, p["w_gate"]))
                    * torch.einsum("td,edf->etf", h, p["w_up"]),
                    p["w_down"])
    picked = out[idx, torch.arange(T, device=x.device)[:, None]]
    return (picked * (gates * keep)[..., None]).sum(1).reshape(B, S, d), idx


@pytest.mark.parametrize("B,S", [(16, 1), (4, 1), (1, 37), (1, 1000)])
def test_apply_moe_on_card(gen, B, S):
    """granite-moe's MoE block in float32 on the card: within MOE_REL of
    max|y| of the dense formulation on the card (the keep mask decides the
    prefills, which drop at capacity); at decode also of the port's own CPU
    result on every token whose top-k set the two devices agree on (a
    router near-tie may flip one in the last bit)."""
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m"),
                              dtype="float32")
    p = moe.init_moe(gen, cfg, torch.device("cuda"))
    p["norm"] += 0.1 * torch.randn(cfg.d_model, generator=gen, device="cuda")
    x = 3 * torch.randn(B, S, cfg.d_model, generator=gen, device="cuda")
    y = moe.apply_moe(p, cfg, x) - x
    want, idx = _dense_moe(p, cfg, x)
    scale = float(want.abs().max())
    assert float((y - want).abs().max()) / scale <= MOE_REL
    if S > 1:
        return
    pc = {key: t.cpu() for key, t in p.items()}
    yc = moe.apply_moe(pc, cfg, x.cpu()) - x.cpu()
    _, idx_cpu = _dense_moe(pc, cfg, x.cpu())
    same = (idx.sort(-1).values.cpu() == idx_cpu.sort(-1).values).all(-1)
    assert int(same.sum()) >= B - 1
    d = (y.cpu() - yc).reshape(B, -1)[same]
    assert float(d.abs().max()) / scale <= MOE_REL


# ---- recycled slots of a serving engine -----------------------------------

@pytest.mark.parametrize("arch,n_repeat", [("llama31-8b", 2),
                                           ("zamba2-2.7b", 1)])
def test_recycled_slots_on_card(gen, arch, n_repeat):
    """Four 200-token requests served to completion, then four prompts of
    5-60 tokens admitted into the same slots: each slot's K/V rows
    [0, plen) and O(1) state equal a fresh batch-1 prefill bit for bit,
    the rows the longer sequences left behind are still there, and a
    decode step through flash_decode gives bit-equal logits when every row
    past each slot's position holds +999 in K and -999 in V."""
    cfg = dataclasses.replace(get_config(arch), n_repeat=n_repeat)
    params = M.init_params(cfg, gen, "cuda")
    eng = PoolEngine(cfg, params, window=256, n_slots=4,
                     profile=H100_LLAMA70B)
    for i in range(4):
        eng.submit(Request(rid=i, prompt=torch.randint(
            0, cfg.vocab, (200,), generator=gen, device="cuda").cpu().numpy(),
            max_new_tokens=8))
    eng.run_until_drained()
    short = [Request(rid=4 + i, prompt=torch.randint(
        0, cfg.vocab, (n,), generator=gen, device="cuda").cpu().numpy(),
        max_new_tokens=8) for i, n in enumerate((5, 17, 33, 60))]
    for r in short:
        eng.submit(r)
    with torch.inference_mode():
        eng._admit()
        stale = 0
        for slot, r in enumerate(eng.slots):
            _, pc = M.forward(params, cfg, torch.as_tensor(
                r.prompt[None], device="cuda"), mode="prefill")
            for name, slab in eng.cache.items():
                for key, dst in slab.items():
                    want = pc[name][key][:, 0]
                    if key in ("k", "v"):
                        assert torch.equal(dst[:, slot, :r.prompt_len], want)
                        stale += bool(dst[:, slot, r.prompt_len:207]
                                      .abs().sum() > 0)
                    else:
                        assert torch.equal(dst[:, slot], want)
        assert stale == 4 * 2 * cfg.attn_block_count // n_repeat
        tokens = torch.as_tensor(eng.tokens[:, None], device="cuda")
        past = torch.arange(eng.window, device="cuda")[None, :] \
            >= torch.as_tensor(eng.pos, device="cuda")[:, None]
        masked = {n: {k: t.clone() for k, t in c.items()}
                  for n, c in eng.cache.items()}
        for slab in masked.values():
            if "k" in slab:
                slab["k"].masked_fill_(past[None, :, :, None, None], 999.0)
                slab["v"].masked_fill_(past[None, :, :, None, None], -999.0)
        a, _ = M.decode_step(params, cfg, tokens, {
            n: {k: t.clone() for k, t in c.items()}
            for n, c in eng.cache.items()}, eng.pos)
        b, _ = M.decode_step(params, cfg, tokens, masked, eng.pos)
    assert torch.isfinite(a).all() and torch.equal(a, b)
