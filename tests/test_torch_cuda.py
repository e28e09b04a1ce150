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
flash_decode's softmax state (return_lse) against the plain version's,
the f32 output that comes with it rounded to the default output, and the
kernel over T-pieces of one cache, merged (a sequence-sharded cache),
against the unsliced kernel;
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
FleetScope on a model-mode fleet (chip_smoke.py's phase 11a at llama31-8b
`.reduced()`): the fleetopt overflow run traced at level detail equals its
analytical replay's golden stream, counts and per-pool energies exactly,
reconciles within 1e-9, conserves, takes one overflow, and launches
exactly what the untraced run launches.
The compiled fleet drain (`serving.graph_engine`, no kernel of its own):
its CUDA-graph replay equals its eager steps on the card bit for bit, in
the decode and the prefill phase, and two Table E cells drained by
`engine="graph"` on the card equal the numpy engine pool for pool
(chip_smoke.py's `fleet_parity`: integer and ordering fields exact, meters
at rtol 1e-9) and the committed rows of benchmarks/results/fleet_grid.json.
Training: each kernel wrapper raises on inputs that require grad where
autograd records (it has no backward) and runs under no_grad and
inference_mode; chip_smoke.py's 14a step (whisper-medium reduced) and 15a
steps (zamba2 and rwkv6 reduced, through the chunk scans, launching no
kernel), card against the CPU at tests/test_torch_training.py's
tolerances; the chunk scans at the SSMs' head widths, card against CPU,
gradients included; whisper's
reduced decode through flash_decode after a prefill with encoder frames,
against the plain attention on the same cache.
The SLO sizing loop under that drain: the hand-built FleetOpt fleet of the
topology search bench sized by `size_to_slo_spec(engine="graph",
device="cuda")` equals numpy's sizing (chip_smoke.py's `sizing_diffs`:
instances, rounds and compliance exact, the measured numbers at rtol 1e-9)
and its committed row of benchmarks/results/topology_search.json.

Marked `cuda`; skips where no CUDA device is present.  On a machine with
an H100: `PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py`
(with `REPRO_PARENT_CHECKOUT=<root of the parent's checkout>` for the
parent comparison).
This file imports no jax, so it runs where only PyTorch is installed.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
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
from repro_torch.launch.serve import demo_requests
from repro_torch.serving import (ContextRouter, PoolEngine, Request,
                                 RouterPolicy, TraceRecorder,
                                 conservation_violations, reconcile_energy,
                                 sample_trace)
from repro_torch.core.workloads import WORKLOADS
from repro_torch.serving import graph_engine as GE
from repro_torch.serving import run_fleet_grid

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "tools"), str(ROOT)]
import port_fleet_bench as PFB  # noqa: E402
from chip_smoke import (CHUNK_SCANS, LOGIT_REL_BOUND,  # noqa: E402
                        LSE_TOL, SSM_TRAIN_BATCH, TRAIN_BATCH,
                        chunk_scan_case, chunk_scan_diffs, fleet_parity,
                        rel_rows, scan_with_grads, sizing_diffs,
                        sliced_decode, step_diffs, step_on)

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
    (2, 16, 16, 64, 24), (2, 56, 8, 128, 2916),   # whisper, llava decode
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,D,T,lengths", [
    (3, 8, 2, 64, 300, [0, 257, -1]), (16, 32, 8, 128, 256, None),
    (4, 32, 8, 128, 1024, None), (16, 32, 8, 128, 8192, None),
    (4, 32, 32, 80, 1024, None), (2, 56, 8, 128, 2916, None)])
def test_flash_decode_lse_matches_plain_on_card(gen, B, H, K, D, T, lengths,
                                                dtype):
    """return_lse: the softmax state within LSE_TOL of the plain version's
    (-inf where lengths <= 0), in one-piece and merged sequences; the f32
    output that comes with it the default output's values before their
    rounding to q's dtype (bit-identical where that is float32)."""
    args = _fd_inputs(gen, B, H, K, D, T, dtype, lengths)
    out = flash_decode(*args)
    out32, lse = flash_decode(*args, return_lse=True)
    _, want = flash_decode_ref(*args, return_lse=True)
    torch.cuda.synchronize()
    assert out32.dtype == torch.float32 and torch.equal(out32.to(dtype), out)
    assert lse.dtype == torch.float32 and lse.shape == (B, H)
    torch.testing.assert_close(lse, want, **LSE_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R", [2, 4])
@pytest.mark.parametrize("B,H,K,D,T", [(16, 32, 8, 128, 256),
                                       (4, 32, 8, 128, 1024),
                                       (4, 32, 8, 128, 8192),
                                       (3, 8, 2, 64, 300)])
def test_flash_decode_t_slices_merge_on_card(gen, B, H, K, D, T, R, dtype):
    """The kernel over R T-pieces of one cache through ops.decode_piece,
    the states merged by ops.merge_states (chip_smoke.py's
    `sliced_decode`, what ranks of a sequence-sharded cache compute),
    within TOL of the unsliced kernel and of the plain version; pieces a
    short sequence leaves empty, and a sequence of length 0, included; one
    launch a piece."""
    lengths = [T, 1, T // 4 - 1] + [T // 2 + 1] * (B - 3)
    lengths[-1] = 0
    q, k, v, lengths = _fd_inputs(gen, B, H, K, D, T, dtype, lengths)
    whole = flash_decode(q, k, v, lengths)
    before = flash_decode.launches
    merged = sliced_decode(q, k, v, lengths, R)
    torch.cuda.synchronize()
    assert flash_decode.launches == before + R
    assert merged.dtype == dtype and not bool(merged[-1].any())
    torch.testing.assert_close(merged.float(), whole.float(), **TOL[dtype])
    torch.testing.assert_close(merged.float(), flash_decode_ref(
        q, k, v, lengths), **TOL[dtype])


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


PARENT_SHAPES = [(16, 32, 8, 128, 256), (4, 32, 8, 128, 1024),
                 (16, 32, 32, 80, 256), (4, 32, 32, 80, 1024),
                 (16, 32, 8, 128, 8192)]
# the parent's own wrapper and kernel, run in a process of its own on
# inputs saved by this one: its outputs saved back
_PARENT_RUN = """
import sys, torch
sys.path.insert(0, sys.argv[1])
from repro_torch.kernels.flash_decode import flash_decode
ins = torch.load(sys.argv[2])
outs = {key: flash_decode(*[t.cuda() for t in args]).cpu()
        for key, args in ins.items()}
torch.save(outs, sys.argv[3])
"""


@pytest.fixture(scope="module")
def parent_outputs(tmp_path_factory):
    """bf16 and f32 flash_decode of another checkout (its root in the
    environment variable REPRO_PARENT_CHECKOUT), through that checkout's
    own wrapper, at PARENT_SHAPES: {(shape, dtype name): (inputs, out)}."""
    root = os.environ.get("REPRO_PARENT_CHECKOUT")
    if not root:
        pytest.skip("set REPRO_PARENT_CHECKOUT to another checkout's root")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)
    ins = {(shape, str(dtype)): [t.cpu() for t in _fd_inputs(g, *shape,
                                                              dtype)]
           for shape in PARENT_SHAPES
           for dtype in (torch.float32, torch.bfloat16)}
    d = tmp_path_factory.mktemp("parent")
    torch.save(ins, d / "in.pt")
    subprocess.run([sys.executable, "-c", _PARENT_RUN,
                    str(Path(root) / "src"), str(d / "in.pt"),
                    str(d / "out.pt")], check=True)
    outs = torch.load(d / "out.pt")
    return {key: (ins[key], outs[key]) for key in ins}


@pytest.mark.parametrize("B,H,K,D,T", PARENT_SHAPES)
def test_flash_decode_bits_equal_parent_checkout_on_card(parent_outputs, B,
                                                         H, K, D, T):
    """decode_common.cuh holds what both decode kernels share: the kernel's
    outputs stay bit-identical to another checkout's kernel (run through
    its own wrapper) at the serve shapes and one multi-piece shape, in both
    dtypes; with the softmax state asked for, the f32 output rounded to
    the dtype."""
    for dtype in (torch.float32, torch.bfloat16):
        args, want = parent_outputs[((B, H, K, D, T), str(dtype))]
        args = [t.cuda() for t in args]
        out, _ = flash_decode(*args, return_lse=True)
        assert torch.equal(flash_decode(*args).cpu(), want)
        assert torch.equal(out.to(dtype).cpu(), want)


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


# ---- FleetScope on a model-mode fleet --------------------------------------

def _overflow_fleet(make, vocab):
    """chip_smoke.py's 10a traffic and pools: 25 azure-conv demo requests
    predicting the median output, Poisson arrivals at 50/s, a short pool
    (16 x 256) evicting at its window and a long one (4 x 1024); the short
    pool's overflow re-served in the long."""
    reqs = demo_requests(vocab, "azure-conv", 25, 1024)
    pred = int(np.median([r.max_new_tokens for r in reqs]))
    trace = sample_trace(WORKLOADS["azure-conv"], len(reqs), seed=0,
                         arrival_rate=50.0)
    for r, (_, _, t) in zip(reqs, trace):
        r.predicted_output, r.arrival_time = pred, t
    pools = {"short": make("short", window=256, n_slots=16,
                           evict_on_overflow=True, respect_arrival=True),
             "long": make("long", window=1024, n_slots=4,
                          respect_arrival=True)}
    router = ContextRouter(pools, RouterPolicy(
        kind="fleetopt", b_short=128, gamma=2.0,
        ladder=[("short", 256.0), ("long", math.inf)]))
    for r in reqs:
        router.route(r)
    pools["short"].run_until_drained()
    for r in pools["short"].overflowed:
        pools["long"].submit(r)
    pools["long"].run_until_drained()
    return pools


def test_fleetscope_traced_overflow_fleet_on_card(gen):
    cfg = get_config("llama31-8b").reduced()
    params = M.init_params(cfg, gen, "cuda")
    streamed = cfg.analytical_spec().streamed_params

    def fleet(traced, model):
        rec = TraceRecorder("detail")

        def make(role, **kw):
            eng = PoolEngine(cfg if model else None,
                             params if model else None,
                             profile=H100_LLAMA70B, name=role,
                             streamed_params=None if model else streamed,
                             **kw)
            if traced:
                eng.attach_trace(rec)
            return eng
        flash_decode.launches = 0
        pools = _overflow_fleet(make, cfg.vocab)
        return rec, pools, flash_decode.launches

    plain_rec, plain, plain_launches = fleet(False, True)
    rec, pools, launches = fleet(True, True)
    twin_rec, twins, _ = fleet(True, False)
    assert rec.golden_stream() == twin_rec.golden_stream()
    assert rec.counts() == twin_rec.counts()
    assert rec.counts()["overflow"] == 1
    assert [rec.energy_by_phase(p) for p in range(len(rec.pool_names))] \
        == [twin_rec.energy_by_phase(p)
            for p in range(len(twin_rec.pool_names))]
    meters = [e.meter for e in pools.values()]
    for row in reconcile_energy(rec, meters).values():
        assert row["rel_err"] < 1e-9, row
    assert all(conservation_violations(m) == [] for m in meters
               + [e.meter for e in twins.values()])
    steps = sum(e.decode_steps for e in pools.values())
    assert launches == plain_launches == cfg.attn_block_count * steps
    assert not plain_rec.events
    for role, eng in pools.items():
        assert [r.generated for r in eng.completed] \
            == [r.generated for r in plain[role].completed]


# --- the compiled fleet drain on the card -----------------------------------

def _grid_cell(kind, generation="H100"):
    cell, = [c for c in PFB.grid_cells()
             if c[1] == kind and c[0]["generation"] == generation][:1]
    return cell


def _prepare_azure(kind):
    from repro_torch.core.modelspec import LLAMA31_70B
    from repro_torch.serving import prepare_topology
    return prepare_topology(kind, WORKLOADS["azure-conv"], H100_LLAMA70B,
                            LLAMA31_70B, b_short=4096, n_requests=400,
                            seed=0, engine="graph", device="cuda")


@pytest.mark.parametrize("phase", ["decode", "prefill"])
def test_graph_drain_replay_equals_eager_on_card(gen, phase):
    """One shape class drained by eager steps on the card and by graph
    replays: every array of the final state equal bit for bit."""
    kind = "fleetopt" if phase == "decode" else "disagg"
    sim, reqs, _ = _prepare_azure(kind)
    sim.begin_run(reqs)
    role = next(r for r in sim.order if sim.groups[r].phase == phase)
    for r in sim.order[:sim.order.index(role)]:
        sim.pre_role(r)
        sim.drain_role(r)
    eng = sim.pre_role(role)
    packed = eng._pack(20_000_000)
    I, S, Q = (GE._bucket(eng.instances), GE._bucket(eng.n_slots),
               GE._bucket(packed["q_ready"].shape[1]))
    merged = GE._merge([packed], I, Q)
    drain = GE._Drain(phase, I, S, Q, merged, eng.device)
    eager = drain.run(merged, replay=False)
    graph = drain.run(merged)
    assert drain.graph is not None and int(eager["it"]) > 0
    for k in eager:
        assert eager[k].tobytes() == graph[k].tobytes(), k


@pytest.mark.parametrize("kind", ["fleetopt", "moe_semantic"])
def test_graph_drain_equals_numpy_on_card(gen, kind):
    """A Table E cell through run_fleet_grid with the shape classes:
    `engine="graph"` on the card against the numpy engine, pool for pool,
    and both rows equal to fleet_grid.json's."""
    cell = _grid_cell(kind)
    committed = json.loads((ROOT / "benchmarks" / "results"
                            / "fleet_grid.json").read_text())
    runs = {}
    for engine in ("numpy", "graph"):
        scen = PFB.grid_scenarios([cell], engine=engine, device="cuda")
        out, = run_fleet_grid(scen, pad_floors=PFB.SHAPE_CLASSES
                              if engine == "graph" else None)
        runs[engine] = (scen[0][0], json.loads(json.dumps(
            PFB.grid_row(cell[0], out))))
    (ref, ref_row), (sim, row) = runs["numpy"], runs["graph"]
    assert fleet_parity([ref], [sim]) == []
    assert row == ref_row and row in committed


def test_slo_sizing_under_graph_drain_equals_numpy_on_card(gen):
    """The FleetOpt hand-built spec of the quick topology search, sized on
    one frozen trace by the numpy engine and by the graph drain on the
    card: equal sizings, and the row equal to the committed one."""
    from repro_torch.core.modelspec import LLAMA31_70B
    from repro_torch.core.routing import LONG_WINDOW
    from repro_torch.core.slo import SLOSpec, size_to_slo_spec
    from repro_torch.core.topospec import TopologySpec
    from repro_torch.serving import sample_trace
    n, seed, wl = PFB.SEARCH["slo_requests"], PFB.SEARCH["seed"], \
        WORKLOADS["azure-conv"]
    spec = TopologySpec.from_kind("fleetopt", H100_LLAMA70B, LLAMA31_70B,
                                  **PFB.SEARCH_KW["fleetopt"])
    trace = sample_trace(wl, n, seed=seed, max_total=LONG_WINDOW)
    res = {engine: size_to_slo_spec(
        spec, wl, slo=SLOSpec(), n_requests=n, seed=seed, trim=False,
        engine=engine, trace=trace, device="cuda")
        for engine in ("numpy", "graph")}
    assert sizing_diffs(res["numpy"], res["graph"]) == []
    want = next(r for r in json.loads(
        (ROOT / "benchmarks" / "results" / "topology_search.json")
        .read_text())["rows"] if r["topology"] == "fleetopt")
    got = res["graph"]
    assert (got.plan.instances, got.compliant,
            round(got.slo_tok_per_watt, 2),
            round(got.measured_decode_tok_per_watt, 2),
            round(got.ttft_p99_s, 3)) == (
        want["instances"], want["compliant"], want["slo_feasible"],
        want["measured"], want["ttft_p99_s"])


# ---- training (ROADMAP A 5) -------------------------------------------------

def _grad_inputs(gen, name):
    def t(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    lengths = torch.tensor([3, 5], dtype=torch.int32, device="cuda")
    if name == "flash_decode":
        return flash_decode, (t(2, 4, 16), t(2, 5, 2, 16), t(2, 5, 2, 16),
                              lengths)
    if name == "flash_decode_int8":
        kq, vq, ks, vs = quantize_kv(t(2, 5, 2, 16), t(2, 5, 2, 16))
        return flash_decode_int8, (t(2, 4, 16), kq, vq, ks, vs, lengths)
    if name == "mamba_scan":
        return mamba_scan, (t(1, 6, 2, 8), t(1, 6, 8), t(1, 6, 8),
                            -t(1, 6, 2).abs())
    return wkv6, (t(1, 6, 2, 8), t(1, 6, 2, 8), t(1, 6, 2, 8),
                  torch.rand(1, 6, 2, 8, generator=gen, device="cuda"),
                  t(2, 8))


@pytest.mark.parametrize("name", ["flash_decode", "flash_decode_int8",
                                  "mamba_scan", "wkv6"])
def test_kernel_wrappers_refuse_grad_on_card(gen, name):
    fn, args = _grad_inputs(gen, name)
    with torch.no_grad():
        want = fn(*args)
    with torch.inference_mode():
        again = fn(*args)
    grad_args = tuple(a.requires_grad_() if a.is_floating_point() else a
                      for a in args)
    before = fn.launches
    with pytest.raises(RuntimeError, match="chunk scans in models/ssm.py"):
        fn(*grad_args)
    assert fn.launches == before
    with torch.no_grad():
        out = fn(*grad_args)
    for a, b, c in zip(*(x if isinstance(x, tuple) else (x,)
                         for x in (want, again, out))):
        torch.testing.assert_close(b, a, atol=0, rtol=0)
        torch.testing.assert_close(c, a, atol=0, rtol=0)


@pytest.mark.parametrize("arch", ["whisper-medium", "zamba2-2.7b",
                                  "rwkv6-1.6b"])
def test_train_step_card_matches_cpu(gen, arch):
    """chip_smoke.py's 14a on whisper-medium and its 15a on the SSMs
    (reduced, float32, the SSMs at 2 x 160 tokens): the card's train step
    within the CPU tests' bounds of the CPU's, launching no kernel."""
    from repro_torch.data import batch_iterator
    from repro_torch.training.optimizer import tree_map
    cfg = get_config(arch).reduced()
    batch = next(batch_iterator(cfg, **(TRAIN_BATCH if arch.startswith(
        "whisper") else SSM_TRAIN_BATCH)))
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cpu = step_on(cfg, tree_map(torch.clone, params), batch, "cpu")
    before = (mamba_scan.launches, wkv6.launches, flash_decode.launches)
    card = step_on(cfg, tree_map(lambda t: t.cuda(), params), batch, "cuda")
    assert max(step_diffs(cpu, card)) <= 1
    assert (mamba_scan.launches, wkv6.launches,
            flash_decode.launches) == before


@pytest.mark.parametrize("kind,w_range", [("mamba2", None),
                                          ("wkv6", (0.05, 1.0)),
                                          ("wkv6", (0.05, 0.06))])
def test_chunk_scans_card_matches_cpu(gen, kind, w_range):
    """The chunk scans training takes (models/ssm.py) at the models' head
    widths, B 2, S 300 (three Mamba chunks with a ragged last one,
    nineteen 16-token WKV blocks): y, the final state and every input's
    gradient on the card against the same scan on the CPU, at chip_smoke's
    15b limits."""
    shape = {"mamba2": (2, 300, 80, 64, 64), "wkv6": (2, 300, 32, 64)}[kind]
    args = chunk_scan_case(kind, shape, gen, w_range)
    cot = [torch.randn(shape[:4], generator=gen, device="cuda"),
           torch.randn(shape[0], shape[2], shape[3], shape[-1],
                       generator=gen, device="cuda")]
    card = scan_with_grads(CHUNK_SCANS[kind], args, cot)
    cpu = scan_with_grads(CHUNK_SCANS[kind], [a.cpu() for a in args],
                          [c.cpu() for c in cot])
    out, grad, finite = chunk_scan_diffs(
        kind, [card[0].cpu(), card[1].cpu(), [g.cpu() for g in card[2]]],
        cpu)
    assert out <= 1 and grad <= 1 and finite


def test_whisper_decode_through_kernel_on_card(gen):
    """whisper-medium reduced: prefill with encoder frames, then 4 decode
    steps through flash_decode against the plain attention on copies of
    the same cache (phase 4's bound), 2 layers x 4 launches."""
    cfg = get_config("whisper-medium").reduced()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    frames = torch.randn(2, cfg.encoder.n_frames, cfg.d_model, generator=gen,
                         device="cuda") * 0.02
    prompt = torch.randint(0, cfg.vocab, (2, 12), generator=gen,
                           device="cuda")
    with torch.no_grad():
        logits, cache = M.forward(params, cfg, prompt, mode="prefill",
                                  frames=frames)
        cache["b0_attn"] = {key: torch.nn.functional.pad(
            t, (0, 0, 0, 0, 0, 4)) for key, t in cache["b0_attn"].items()}
        tokens = logits[:, -1].argmax(-1, keepdim=True)
        before = flash_decode.launches
        for i in range(4):
            copy = {n: {k: t.clone() for k, t in c.items()}
                    for n, c in cache.items()}
            plain, _ = M.decode_step(params, cfg, tokens, copy, 12 + i,
                                     impl="plain")
            a, cache = M.decode_step(params, cfg, tokens, cache, 12 + i)
            rel, _, _, tie_ok = rel_rows(a[:, 0], plain[:, 0])
            assert max(rel) <= LOGIT_REL_BOUND and tie_ok
            tokens = a[:, 0].argmax(-1, keepdim=True)
    assert flash_decode.launches - before == cfg.attn_block_count * 4


# ---- the distribution layer on the card (chip_smoke.py phase 16b) -------

@pytest.fixture
def one_rank_mesh(gen, tmp_path):
    """A (1, 1) ("data", "model") mesh over an NCCL group of one rank."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), world_size=1, rank=0,
        device_id=torch.device("cuda", 0))
    try:
        yield make_local_mesh(model=1, data=1, device="cuda")
    finally:
        dist.destroy_process_group()


def _dtensor_step(mesh, cfg, params, fn, *args):
    from repro_torch.launch.sharding import distribute, param_specs
    from repro_torch.models.common import set_mesh
    dparams = distribute(params, param_specs(cfg, params, mesh,
                                             mode="serve"), mesh)
    with set_mesh(mesh), torch.no_grad():
        return fn(dparams, *args)


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


@pytest.mark.parametrize("arch", ["llama31-8b", "granite-moe-1b-a400m"])
def test_dtensor_decode_bit_equal_on_card(gen, one_rank_mesh, arch):
    """A decode step at full width (2 repeats) on DTensors placed by the
    serve rules equals the plain-tensor step bit for bit, logits and cache,
    with the same flash_decode launches (phase 16b at reduced depth)."""
    from repro_torch.launch.sharding import (batch_specs, cache_specs,
                                             distribute)
    mesh = one_rank_mesh
    cfg = dataclasses.replace(get_config(arch), n_repeat=2)
    params = M.init_params(cfg, gen, "cuda")
    B, T = 16, 256
    cache = M.init_cache(cfg, B, T, device="cuda")
    for blk in cache.values():
        for t in blk.values():
            t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
    tokens = torch.randint(0, cfg.vocab, (B, 1), generator=gen,
                           device="cuda")
    pos = np.random.default_rng(0).integers(1, T, B)
    copy = {n: {k: t.clone() for k, t in c.items()} for n, c in cache.items()}
    before = flash_decode.launches
    with torch.no_grad():
        want, want_cache = M.decode_step(params, cfg, tokens, copy, pos)
    plain_launches = flash_decode.launches - before
    dcache = distribute(cache, cache_specs(cfg, cache, mesh, batch=B), mesh)
    dtok = distribute(tokens, batch_specs(mesh, B) + (None,), mesh)
    got, got_cache = _dtensor_step(
        mesh, cfg, params,
        lambda p: M.decode_step(p, cfg, dtok, dcache, pos))
    assert flash_decode.launches - before == 2 * plain_launches \
        == 2 * cfg.attn_block_count
    assert torch.equal(_full(got), want)
    for n, c in want_cache.items():
        for k, t in c.items():
            assert torch.equal(_full(got_cache[n][k]), t), (n, k)


def test_dtensor_prefill_bit_equal_on_card(gen, one_rank_mesh):
    """zamba2-2.7b at full width, one repeat: a 1015-token prefill on
    DTensors equals the plain-tensor prefill bit for bit, logits and
    states, with the same mamba_scan launches."""
    from repro_torch.launch.sharding import batch_specs, distribute
    mesh = one_rank_mesh
    cfg = dataclasses.replace(get_config("zamba2-2.7b"), n_repeat=1)
    params = M.init_params(cfg, gen, "cuda")
    tokens = torch.randint(0, cfg.vocab, (1, 1015), generator=gen,
                           device="cuda")
    before = mamba_scan.launches
    with torch.no_grad():
        want, want_cache = M.forward(params, cfg, tokens, mode="prefill")
    dtok = distribute(tokens, batch_specs(mesh, 1) + (None,), mesh)
    got, got_cache = _dtensor_step(
        mesh, cfg, params,
        lambda p: M.forward(p, cfg, dtok, mode="prefill"))
    assert mamba_scan.launches - before == 2 * 5
    assert torch.equal(_full(got), want)
    for n, c in want_cache.items():
        for k, t in c.items():
            assert torch.equal(_full(got_cache[n][k]), t), (n, k)


def test_dtensor_kernels_refuse_split_reductions_on_card(gen):
    """On a fake 2-rank mesh over CUDA shards: flash_decode on a
    batch-sharded DTensor runs the kernel on each rank's shard (equal to
    the plain version on it); on a KV cache whose sequence is split over
    the ranks it runs the kernel on the rank's T-shard and merges the
    gathered softmax states (the fake group's all-gather copies rank 0's
    state to every slot, so the whole cache it stands for is rank 0's
    shard twice: the plain version on that cache); a scan sequence split
    over ranks raises NotImplementedError and launches nothing."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.kernels import ops
    dist.init_process_group("fake", store=FakeStore(), world_size=2, rank=0)
    try:
        mesh = init_device_mesh("cuda", (2,), mesh_dim_names=("data",))
        B, H, K, D, T = 4, 8, 2, 64, 128
        q = torch.randn(B // 2, H, D, generator=gen, device="cuda")
        k = torch.randn(B // 2, T, K, D, generator=gen, device="cuda")
        v = torch.randn(B // 2, T, K, D, generator=gen, device="cuda")
        lengths = torch.full((B // 2,), T, dtype=torch.int32, device="cuda")
        dt = [DTensor.from_local(t, mesh, [Shard(0)], run_check=False)
              for t in (q, k, v, lengths)]
        out = ops.decode_attention(*dt)
        assert tuple(out.placements) == (Shard(0),)
        torch.testing.assert_close(out.to_local(), flash_decode_ref(
            q, k, v, lengths), atol=2e-5, rtol=1e-2)
        kseq, vseq = (DTensor.from_local(t[:, :T // 2], mesh, [Shard(1)],
                                         run_check=False) for t in (k, v))
        lengths = torch.tensor([T, 7], dtype=torch.int32, device="cuda")
        rep = [DTensor.from_local(t, mesh, [Replicate()], run_check=False)
               for t in (q, lengths)]
        before = flash_decode.launches
        out = ops.decode_attention(rep[0], kseq, vseq, rep[1])
        assert flash_decode.launches == before + 1
        assert tuple(out.placements) == (Replicate(),)
        whole = [torch.cat([t[:, :T // 2]] * 2, 1) for t in (k, v)]
        torch.testing.assert_close(out.to_local(), flash_decode_ref(
            q, *whole, lengths), atol=2e-5, rtol=1e-2)
        before = flash_decode.launches
        xt = DTensor.from_local(torch.randn(1, 16, 2, 8, device="cuda"),
                                mesh, [Shard(1)], run_check=False)
        bm = DTensor.from_local(torch.randn(1, 16, 8, device="cuda"), mesh,
                                [Shard(1)], run_check=False)
        la = DTensor.from_local(-torch.rand(1, 16, 2, device="cuda"), mesh,
                                [Shard(1)], run_check=False)
        with pytest.raises(NotImplementedError, match="cross-rank merge"):
            ops.ssd_scan(xt, bm, bm, la)
        assert flash_decode.launches == before
    finally:
        dist.destroy_process_group()
