#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one card.

  python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device   the card's name and power limit (nvidia-smi);
  2. build    the four CUDA kernels of src/repro_torch/csrc (flash_decode,
              flash_decode_int8, mamba_scan, wkv6), one nvcc each, all
              started together;
  3. kernel   flash_decode against its plain PyTorch version at the JAX
              package's sweep shapes, the serve path's four shapes
              (llama31-8b G=4 D=128 and zamba2 G=1 D=80, each in a short
              pool 16 slots x 256 and a long pool 4 x 1024) and two larger
              ones, float32 and bfloat16 at the limits of TOL; masked
              entries overwritten with +-999 leave the output unchanged; a
              planted fault (every length one short) must fail the
              bfloat16 limit; times at those shapes (CUDA events, warmed
              up, inputs cycled through more than the 50 MB L2), beside the
              bound and one SDPA call as the library yardstick.
              mamba_scan and wkv6 against their plain sequential versions
              (y and final state) at the JAX sweep shapes and the
              full-width prefill shapes at S = 37, 1000, 1015 (wkv6 also at
              w in [0.05, 0.06]), at the limits of SCAN_TOL; a planted
              fault made from calls of the unchanged kernel (mamba_scan
              run chunk by chunk: no inter-chunk term; wkv6 plus its
              diagonal term: a causal mask taking s <= t) must fail them.
              flash_decode_int8 against its plain version on the same
              quantize_kv codes and scales at the JAX int8 test's shapes,
              the four serve shapes, the ragged T, the two larger ones and
              the paper's 64K window (4 x 65536), q in float32 and bfloat16
              at the limits of TOL (both compute in f32 from the same codes
              and scales); codes past lengths overwritten with +-99 leave
              the output bit-equal; two planted faults made from calls of
              the unchanged kernel (every length one short; ks and vs
              swapped) must fail the bfloat16 limit; at the JAX shapes the
              kernel stays within INT8_FLOAT_REL of max|ref| of float
              attention on the unquantized K/V (the JAX test's criterion);
              times at every shape beside the bound and the plain version,
              and, on the same K/V in bf16, flash_decode's and SDPA's;
  4. model    llama31-8b at full width and depth (bf16, seeded random
              weights): ragged prompts prefilled, one decode step through
              the kernel and one through the plain attention on the same
              cache, logits compared within a stated bound; a planted
              fault (attention that skips the last 64-row tile) must
              exceed that bound; then one more decode step on the same
              cache with every layer's attention run as quantize_kv of its
              own K/V plus ops.decode_attention_int8: exactly 32
              flash_decode_int8 launches (counts set to 0 just before, read
              just after), each call held against the plain int8 version
              on its own inputs at TOL[bfloat16]; each call's error against
              float attention on the unquantized bf16 cache and the logits
              against the bf16 kernel step are reported;
  5. serve    `run_policies` at full width over homo / two_pool / fleetopt;
              every request completes, the kernel's launch count equals
              32 layers x the decode steps taken, flash_decode_int8 is
              launched 0 times (no serve path runs it), and every pool's
              shape is one that phase 3 checked and timed;
  6. model    zamba2-2.7b and then rwkv6-1.6b at full width and depth
              (bf16, seeded random weights): ragged prompts prefilled
              through the scan kernel, every scan call held against the
              plain version on its own inputs (and the planted fault
              outside the limit); the same prompts prefilled once through
              the kernel and once with impl="plain" on a float32 copy of
              the weights, last logits within SCAN_LOGIT_BOUND, which the
              planted fault must exceed; then DECODE_STEPS greedy
              bf16 decode steps of the four sequences together (zamba2:
              the first step also in float32 through the plain attention,
              compared as in phase 4);
  7. serve    `run_policies` for each of the two, as in phase 5, with every
              count set to 0 just before and read just after: flash_decode
              launches = 9 x zamba2's decode steps, mamba_scan = 45 x its
              prefills, wkv6 = 24 x rwkv6's prefills, and no other kernel
              (flash_decode_int8 0);
              then each scan checked and timed at every prompt length the
              serve phase prefilled;
then one JSON line of kernel numbers (times averaged over the serve
paths' shapes, weighted by their launches at each; flash_decode_int8,
which no serve path launches, over the four MAIN shapes equally, its
launches those of phase 4) and, last, the device line.

Needs one CUDA card; exits non-zero without one.  float32 matmuls stay full
precision: TF32 is turned off for matmuls and cuDNN.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_decode as FD  # noqa: E402
from repro_torch.kernels import flash_decode_int8 as FD8  # noqa: E402
from repro_torch.kernels import mamba_scan as MS  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import wkv6 as WK  # noqa: E402
from repro_torch.kernels.ref import (flash_decode_int8_ref,  # noqa: E402
                                     flash_decode_ref, mamba_scan_ref,
                                     wkv6_ref)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

flash_decode, mamba_scan, wkv6 = FD.flash_decode, MS.mamba_scan, WK.wkv6
flash_decode_int8, quantize_kv = FD8.flash_decode_int8, FD8.quantize_kv
DEVICE = "cuda"
HBM_BPS = 3.35e12                       # H100 SXM, bytes/s
PEAK_FLOPS = {torch.bfloat16: 989e12,   # dense tensor-core bf16
              torch.float32: 67e12}     # float32 outside the tensor cores
# float32: the JAX package's tolerance.  bfloat16: kernel and plain version
# both compute in f32 from the same bf16 inputs, so they differ by the
# kernel's one rounding of its output to bf16 (at most 2^-8 relative) plus
# f32 summation order; the limit is twice that rounding, ten times tighter
# than the JAX package's bf16 atol of 5e-2.
TOL = {torch.float32: dict(atol=2e-5, rtol=1e-2),
       torch.bfloat16: dict(atol=1e-4, rtol=2 ** -7)}
SWEEP = [(2, 8, 4, 64, 100), (1, 16, 8, 128, 300), (3, 4, 4, 32, 64),
         (1, 4, 1, 128, 513)]           # (B, H, K, D, T)
# the shapes the serve phases give flash_decode (batch = a pool's slots,
# T = its window): llama31-8b, then zamba2's shared attention (G = 1,
# D = 80), each in the short pool 16 x 256 and the long pool 4 x 1024
MAIN = [(16, 32, 8, 128, 256), (4, 32, 8, 128, 1024),
        (16, 32, 32, 80, 256), (4, 32, 32, 80, 1024)]
EXTRA = [(16, 32, 8, 128, 1024), (16, 32, 8, 128, 8192)]
RAGGED_T = (16, 32, 8, 128, 1000)       # T a multiple of no tile or piece
# flash_decode_int8: the JAX int8 test's shapes, then the flash_decode
# shapes above and the paper's 64K window
INT8_SWEEP = [(2, 8, 4, 64, 100), (1, 4, 2, 128, 300), (3, 2, 2, 32, 50)]
INT8_SHAPES = INT8_SWEEP + MAIN + [RAGGED_T] + EXTRA \
    + [(4, 32, 8, 128, 65536)]
# int8 vs float attention on the unquantized K/V: the JAX package's
# criterion (tests/kernels/test_flash_decode_int8.py), max|d| / max|ref|
INT8_FLOAT_REL = 0.02
L2_BYTES = 50e6
# llama31-8b decode, kernel vs plain attention on one cache: the two differ
# only in the order of f32 sums inside attention before the bf16 rounding
# (a bf16 step is 2^-8 ~ 3.9e-3 relative), carried through 32 layers
LOGIT_REL_BOUND = 5e-2
SKIP_ROWS = 64                          # the planted fault's dropped tile
SERVE = dict(workload="azure-conv", requests=16, b_short=128,
             window_long=1024)
# The scans: the JAX package's limits (tests/kernels/test_kernels.py:
# mamba_scan f32 atol 20 x 2e-5, rtol 5e-2; wkv6 atol 2e-3, rtol 1e-3).
# Kernel and plain version are both f32 and differ only in the order of
# their sums (chunked products vs one step per token).
SCAN_TOL = {"mamba_scan": dict(atol=4e-4, rtol=5e-2),
            "wkv6": dict(atol=2e-3, rtol=1e-3)}
# (B, S, nh, hd, ds): the JAX sweep, then zamba2's full-width prefill at a
# short prompt, ~1000 tokens and a length no multiple of the 128 chunk
MAMBA_SHAPES = [(2, 64, 3, 32, 16), (1, 100, 2, 64, 64), (1, 16, 1, 8, 8),
                (1, 37, 80, 64, 64), (1, 1000, 80, 64, 64),
                (1, 1015, 80, 64, 64)]
# (B, S, H, hd), the same for rwkv6 (64-token chunks); each at every w range
WKV_SHAPES = [(2, 64, 2, 32), (1, 100, 3, 64), (1, 7, 1, 8),
              (1, 37, 32, 64), (1, 1000, 32, 64), (1, 1015, 32, 64)]
W_RANGES = [(0.05, 1.0), (0.8, 1.0), (0.05, 0.06)]
SCAN_SERVE_SHAPE = {"mamba_scan": (1, 80, 64, 64), "wkv6": (1, 32, 64)}
# zamba2 / rwkv6 prefill in float32, kernel vs plain scan: the scans
# differ in the order of their f32 sums (kernel vs plain at most ~1e-5
# relative on the models' own inputs), carried through 63 / 24 blocks;
# the bound leaves an order of magnitude to that and to the planted faults
SCAN_LOGIT_BOUND = 1e-2
PLENS = (37, 300, 600, 1000)            # ragged prompts of phases 4 and 6
DECODE_STEPS = 4
SSM = {"zamba2-2.7b": ("mamba_scan", "ssd_scan"),
       "rwkv6-1.6b": ("wkv6", "wkv_scan")}
SCANS = {"mamba_scan": (mamba_scan, mamba_scan_ref),
         "wkv6": (wkv6, wkv6_ref)}
FAULT = {"mamba_scan": "chunks scanned alone, no inter-chunk term",
         "wkv6": "causal mask taking s <= t"}
COUNTED = {"flash_decode": flash_decode,
           "flash_decode_int8": flash_decode_int8, "mamba_scan": mamba_scan,
           "wkv6": wkv6}


def log(msg: str) -> None:
    print(msg, flush=True)


def inputs(B, H, K, D, T, dtype, gen, *, strided_q=False):
    q = torch.randn(B, 2 if strided_q else 1, H, D, generator=gen,
                    device=DEVICE).to(dtype)[:, 0]
    k = torch.randn(B, T, K, D, generator=gen, device=DEVICE).to(dtype)
    v = torch.randn(B, T, K, D, generator=gen, device=DEVICE).to(dtype)
    lengths = torch.randint(1, T + 1, (B,), generator=gen, device=DEVICE,
                            dtype=torch.int32)
    return q, k, v, lengths


def bound(q, k, lengths):
    """Least time for the work (ms): bytes each read or written once (valid
    K/V rows, q, out, lengths) over HBM bandwidth, vs the QK and PV flops
    over the dtype's peak; returns (ms, "bytes" | "operations")."""
    B, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    valid = int(lengths.clamp(max=T).sum())
    es = q.element_size()
    nbytes = valid * K * D * 2 * es + 2 * B * H * D * es + 4 * B
    flops = 4 * valid * H * D
    return _bound(nbytes, flops, q.dtype)


def _bound(nbytes, flops, dtype):
    t_b, t_o = nbytes / HBM_BPS, flops / PEAK_FLOPS[dtype]
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def time_ms(fn, sets, iters):
    """Mean ms per call over `iters` calls cycling through `sets`."""
    for args in sets:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def n_sets(per_set_bytes, cap=256):
    """Input sets to cycle through so that a pass exceeds 3x the L2 (at
    most `cap`: the scans' shortest prompts stay in the L2)."""
    return min(cap, max(1, math.ceil(3 * L2_BYTES / per_set_bytes)))


def sdpa(q, k, v, mask):
    return torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, enable_gqa=True)[:, :, 0]


def check_kernel(shape, dtype, gen, *, strided_q=False):
    q, k, v, lengths = inputs(*shape, dtype, gen, strided_q=strided_q)
    out = flash_decode(q, k, v, lengths)
    ref = flash_decode_ref(q, k, v, lengths)
    torch.cuda.synchronize()
    err = float((out.float() - ref).abs().max())
    ok = out.dtype == dtype and bool(torch.isfinite(out).all()) \
        and torch.allclose(out.float(), ref, **TOL[dtype])
    T = k.shape[1]
    past = torch.arange(T, device=DEVICE)[None, :, None, None] \
        >= lengths[:, None, None, None]
    out2 = flash_decode(q, k.masked_fill(past, 999.0),
                        v.masked_fill(past, -999.0), lengths)
    leak = not torch.equal(out, out2)
    log(f"  kernel {dtype} B,H,K,D,T={shape}: max_abs_err={err:.3e}"
        f" ({TOL[dtype]}) masked_garbage_changed={leak}")
    if not ok or leak:
        raise SystemExit(f"flash_decode disagrees with its plain version at"
                         f" {shape} {dtype}")
    return err


def control_kernel(shape, gen):
    """Planted fault: the kernel run with every length one short, as a
    kernel that drops the last valid row would compute.  The bfloat16
    limit must reject it, or it could not tell such a fault from
    rounding."""
    dtype = torch.bfloat16
    q, k, v, lengths = inputs(*shape, dtype, gen)
    bad = flash_decode(q, k, v, lengths - 1)
    ref = flash_decode_ref(q, k, v, lengths)
    err = float((bad.float() - ref).abs().max())
    caught = not torch.allclose(bad.float(), ref, **TOL[dtype])
    log(f"  control {dtype} B,H,K,D,T={shape}, each length one short:"
        f" max_abs_err={err:.3e}, rejected by {TOL[dtype]}: {caught}")
    if not caught:
        raise SystemExit("the bfloat16 limit does not catch a dropped row")


def time_kernel(shape, dtype, gen):
    q, k, v, lengths = inputs(*shape, dtype, gen)
    per_set = (k.numel() + v.numel()) * k.element_size()
    sets = [(q, k, v, lengths)] + [inputs(*shape, dtype, gen)
                                   for _ in range(n_sets(per_set) - 1)]
    for s in sets[1:]:                     # same ragged lengths in every set
        s[3].copy_(lengths)
    T = shape[4]
    masks = [(torch.arange(T, device=DEVICE)[None] < s[3][:, None])
             [:, None, None, :] for s in sets]
    ms = time_ms(flash_decode, sets, 50)
    plain_ms = time_ms(flash_decode_ref, sets, 10)
    lib_ms = time_ms(lambda i: sdpa(*sets[i][:3], masks[i]),
                     [(i,) for i in range(len(sets))], 50)
    lib_err = float((sdpa(q, k, v, masks[0]).float()
                     - flash_decode_ref(q, k, v, lengths)).abs().max())
    b_ms, b_by = bound(q, k, lengths)
    row = dict(shape=dict(zip("BHKDT", shape)), dtype=str(dtype).split(".")[1],
               ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
               bound_by=b_by, library_max_abs_err=lib_err,
               input_sets=len(sets))
    log(f"  timing {json.dumps(row)}")
    return row


# ---- flash_decode_int8 --------------------------------------------------

def int8_inputs(shape, dtype, gen):
    """q, k, v, lengths as `inputs` gives them, and q with the quantize_kv
    codes and scales of k and v, lengths: the int8 kernel's arguments."""
    q, k, v, lengths = inputs(*shape, dtype, gen)
    return (q, k, v, lengths), (q, *quantize_kv(k, v), lengths)


def int8_bound(q, kq, lengths):
    """`bound` for the int8 cache: the valid rows' codes (2 D bytes) and
    two f32 scales (8 bytes) per kv head, plus q, out and lengths, vs the
    same QK and PV operations at q's dtype peak."""
    B, H, D = q.shape
    T, K = kq.shape[1], kq.shape[2]
    valid = int(lengths.clamp(max=T).sum())
    es = q.element_size()
    nbytes = valid * K * (2 * D + 8) + 2 * B * H * D * es + 4 * B
    return _bound(nbytes, 4 * valid * H * D, q.dtype)


def int8_err(args, out):
    """(max abs error against the plain int8 version, within TOL)."""
    ref = flash_decode_int8_ref(*args)
    err = float((out.float() - ref).abs().max())
    ok = out.dtype == args[0].dtype and bool(torch.isfinite(out).all()) \
        and torch.allclose(out.float(), ref, **TOL[args[0].dtype])
    return err, ok


def check_int8(shape, dtype, gen):
    (q, k, v, lengths), args = int8_inputs(shape, dtype, gen)
    out = flash_decode_int8(*args)
    err, ok = int8_err(args, out)
    _, kq, vq, ks, vs, _ = args
    past = torch.arange(shape[4], device=DEVICE)[None, :, None, None] \
        >= lengths[:, None, None, None]
    out2 = flash_decode_int8(q, kq.masked_fill(past, 99),
                             vq.masked_fill(past, -99), ks, vs, lengths)
    leak = not torch.equal(out, out2)
    msg = ""
    if shape in INT8_SWEEP:
        ref = flash_decode_ref(q, k, v, lengths)
        rel = float((out.float() - ref).abs().max() / ref.abs().max())
        ok = ok and rel < INT8_FLOAT_REL
        msg = (f" vs float attention on the unquantized K/V"
               f" {rel:.3e} of max|ref| (limit {INT8_FLOAT_REL})")
    log(f"  kernel flash_decode_int8 {dtype} B,H,K,D,T={shape}:"
        f" max_abs_err={err:.3e} ({TOL[dtype]})"
        f" masked_codes_changed={leak}{msg}")
    if not ok or leak:
        raise SystemExit(f"flash_decode_int8 disagrees with its plain version"
                         f" at {shape} {dtype}")
    return err


def control_int8(shape, gen):
    """Planted faults made from calls of the unchanged kernel: every
    length one short (a dropped last row) and the K and V scales swapped.
    The bfloat16 limit must reject both."""
    _, args = int8_inputs(shape, torch.bfloat16, gen)
    q, kq, vq, ks, vs, lengths = args
    for name, bad in (
            ("each length one short",
             flash_decode_int8(q, kq, vq, ks, vs, lengths - 1)),
            ("ks and vs swapped",
             flash_decode_int8(q, kq, vq, vs, ks, lengths))):
        err, ok = int8_err(args, bad)
        log(f"  control flash_decode_int8 bfloat16 B,H,K,D,T={shape}, {name}:"
            f" max_abs_err={err:.3e}, rejected by {TOL[torch.bfloat16]}:"
            f" {not ok}")
        if ok:
            raise SystemExit(f"the bfloat16 limit does not catch the int8"
                             f" kernel with {name}")


def time_int8(shape, gen):
    """The int8 kernel, its plain version and its bound at `shape`; beside
    them, on the same K/V in bf16 (the cache quantize_kv was given),
    flash_decode and SDPA: the int8 form's yardstick on bytes.  Input sets
    cycle past 3x the L2 for the int8 bytes (twice that for the bf16)."""
    dtype = torch.bfloat16
    first = int8_inputs(shape, dtype, gen)
    per_set = sum(t.numel() * t.element_size() for t in first[1][1:5])
    pairs = [first] + [int8_inputs(shape, dtype, gen)
                       for _ in range(n_sets(per_set) - 1)]
    lengths = first[0][3]
    for f16, i8 in pairs[1:]:            # same ragged lengths in every set
        f16[3].copy_(lengths)
    f16_sets = [p[0] for p in pairs]
    i8_sets = [p[1] for p in pairs]
    T = shape[4]
    masks = [(torch.arange(T, device=DEVICE)[None] < s[3][:, None])
             [:, None, None, :] for s in f16_sets]
    ms = time_ms(flash_decode_int8, i8_sets, 50)
    plain_ms = time_ms(flash_decode_int8_ref, i8_sets, 10)
    bf16_ms = time_ms(flash_decode, f16_sets, 50)
    sdpa_ms = time_ms(lambda i: sdpa(*f16_sets[i][:3], masks[i]),
                      [(i,) for i in range(len(f16_sets))], 50)
    b_ms, b_by = int8_bound(first[1][0], first[1][1], lengths)
    row = dict(shape=dict(zip("BHKDT", shape)), dtype="bfloat16",
               ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               flash_decode_bf16_ms=bf16_ms, sdpa_bf16_ms=sdpa_ms,
               input_sets=len(pairs))
    log(f"  timing {json.dumps(row)}")
    return row


# ---- the scans ----------------------------------------------------------

def scan_inputs(kind, shape, gen, w_range=(0.05, 1.0)):
    def randn(*s):
        return torch.randn(*s, generator=gen, device=DEVICE)

    if kind == "mamba_scan":
        B, S, nh, hd, ds = shape
        lA = -0.5 * torch.rand(B, S, nh, generator=gen, device=DEVICE)
        return randn(B, S, nh, hd), randn(B, S, ds), randn(B, S, ds), lA
    B, S, H, hd = shape
    lo, hi = w_range
    w = lo + (hi - lo) * torch.rand(B, S, H, hd, generator=gen,
                                    device=DEVICE)
    return randn(B, S, H, hd), randn(B, S, H, hd), randn(B, S, H, hd), w, \
        0.5 * randn(H, hd)


def faulty_scan(kind, *args):
    """The kernel with a planted fault, made from calls of the unchanged
    kernel: mamba_scan run on each chunk alone (every call starts from a
    zero state, so y loses its inter-chunk term and the state keeps only
    the last chunk); wkv6 with the diagonal s = t added to the past it
    attends to, as a causal mask taking s <= t computes:
    y_t + (sum_d r_t k_t / w_t) v_t (w floored as the kernel floors it)."""
    if kind == "mamba_scan":
        L = MS.CHUNK
        parts = [mamba_scan(*(a[:, c:c + L] for a in args))
                 for c in range(0, args[0].shape[1], L)]
        return torch.cat([y for y, _ in parts], 1), parts[-1][1]
    r, k, v, w, _ = args
    y, st = wkv6(*args)
    diag = (r * k / w.clamp(min=1e-30)).sum(-1, keepdim=True)
    return y + diag * v, st


def scan_err(kind, args, fault=False):
    """(within SCAN_TOL in y and state, max abs error over both)."""
    fn, ref = SCANS[kind]
    y, st = faulty_scan(kind, *args) if fault else fn(*args)
    yr, sr = ref(*args)
    torch.cuda.synchronize()
    err = max(float((y - yr).abs().max()), float((st - sr).abs().max()))
    ok = bool(torch.isfinite(y).all() and torch.isfinite(st).all()) \
        and torch.allclose(y, yr, **SCAN_TOL[kind]) \
        and torch.allclose(st, sr, **SCAN_TOL[kind])
    return ok, err


def check_scan(kind, shape, gen, **kw):
    ok, err = scan_err(kind, scan_inputs(kind, shape, gen, **kw))
    log(f"  kernel {kind} {shape} {kw or ''}: max_abs_err={err:.3e}"
        f" (y and state, {SCAN_TOL[kind]})")
    if not ok:
        raise SystemExit(f"{kind} disagrees with its plain version at"
                         f" {shape} {kw}")
    return err


def control_scan(kind, shape, gen):
    """The planted fault (`faulty_scan`) must fail the limit."""
    ok, err = scan_err(kind, scan_inputs(kind, shape, gen), fault=True)
    log(f"  control {kind} {shape}, planted fault ({FAULT[kind]}):"
        f" max_abs_err={err:.3e}, rejected by {SCAN_TOL[kind]}: {not ok}")
    if ok:
        raise SystemExit(f"the {kind} limit does not catch its planted"
                         " fault")


def scan_bound(kind, shape):
    """Least time (ms) for one scan: inputs read once and y and the final
    state written once (f32) over HBM bandwidth, vs the f32 operations the
    function needs over the f32 peak.  Those are the one-step recurrence's,
    fewer than the chunked algorithm's, per (token, head): mamba_scan
    5 hd ds (decay the state, add the outer product x B, y = state . C)
    and one exp; wkv6 5 hd^2 (r . state; decay, add k^T v) and 5 hd for
    the bonus (sum_d r u k, times v, added)."""
    if kind == "mamba_scan":
        B, S, nh, hd, ds = shape
        nbytes = 4 * (B * S * (2 * nh * hd + 2 * ds + nh) + B * nh * hd * ds)
        return _bound(nbytes, B * S * nh * (5 * hd * ds + 1), torch.float32)
    B, S, H, hd = shape
    nbytes = 4 * (B * S * H * hd * 5 + H * hd + B * H * hd * hd)
    return _bound(nbytes, B * S * H * (5 * hd * hd + 5 * hd), torch.float32)


def time_scan(kind, S, gen, serve_launches):
    """Check and time the kernel at a serve prompt length S (inputs cycled
    through more than the L2), beside its plain version."""
    head = SCAN_SERVE_SHAPE[kind]
    shape = head[:1] + (S,) + head[1:]
    fn, ref = SCANS[kind]
    args = scan_inputs(kind, shape, gen)
    ok, err = scan_err(kind, args)
    if not ok:
        raise SystemExit(f"{kind} disagrees with its plain version at the"
                         f" serve shape {shape}")
    per_set = sum(a.numel() * 4 for a in args)
    sets = [args] + [scan_inputs(kind, shape, gen)
                     for _ in range(n_sets(per_set) - 1)]
    ms = time_ms(fn, sets, 50)
    plain_ms = time_ms(ref, sets[:2], 2)
    b_ms, b_by = scan_bound(kind, shape)
    return dict(shape=dict(zip(("B", "S", "nh", "hd", "ds")
                               if kind == "mamba_scan"
                               else ("B", "S", "H", "hd"), shape)),
                dtype="float32", ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                serve_launches=serve_launches, input_sets=len(sets))


# ---- phases -------------------------------------------------------------

def phase_device():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(out.splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda}"
        f" device {torch.cuda.get_device_name(0)}")


def phase_build():
    t0 = time.perf_counter()
    jobs = (FD.build, FD8.build, MS.build, WK.build)
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda job: job(), jobs))
    log(f"build: {len(built)} libraries in {time.perf_counter() - t0:.2f} s")
    for path, build_log in built:
        log(f"  {path.name}")
        for line in build_log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"    ptxas: {line.strip()}")


def phase_kernel():
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in SWEEP + MAIN + EXTRA + [RAGGED_T]:
            errs[(shape, dtype)] = check_kernel(shape, dtype, gen)
        for shape in MAIN:
            check_kernel(shape, dtype, gen, strided_q=True)
    control_kernel(MAIN[1], gen)
    rows = {shape: time_kernel(shape, torch.bfloat16, gen)
            for shape in MAIN + EXTRA}
    int8_errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in INT8_SHAPES:
            int8_errs[(shape, dtype)] = check_int8(shape, dtype, gen)
    control_int8(MAIN[1], gen)
    int8_rows = {shape: time_int8(shape, gen) for shape in INT8_SHAPES}
    for shape in MAMBA_SHAPES:
        check_scan("mamba_scan", shape, gen)
    for shape in WKV_SHAPES:
        for w_range in W_RANGES:
            check_scan("wkv6", shape, gen, w_range=w_range)
    # the mamba fault shows from the second chunk on: S > 128
    control_scan("mamba_scan", MAMBA_SHAPES[4], gen)
    control_scan("wkv6", WKV_SHAPES[4], gen)
    return (max(errs[(s, torch.bfloat16)] for s in MAIN), rows,
            max(int8_errs[(s, torch.bfloat16)] for s in MAIN), int8_rows)


def rel_rows(a, b):
    """Per row max|a - b| / max|b|, and the top-1 check: a top-1 that
    differs must be a near-tie of b (top-1/top-2 gap within twice that
    row's largest difference)."""
    a, b = a.float(), b.float()
    d_max = (a - b).abs().amax(-1)
    rel = (d_max / b.abs().amax(-1)).tolist()
    top2 = b.topk(2, -1).values
    gap = (top2[:, 0] - top2[:, 1]).tolist()
    agree = (a.argmax(-1) == b.argmax(-1)).tolist()
    tie_ok = all(ok or g <= 2 * d for ok, g, d in
                 zip(agree, gap, d_max.tolist()))
    return rel, agree, gap, tie_ok


def clone_cache(cache):
    return {n: {k: t.clone() for k, t in c.items()} for n, c in cache.items()}


def splice(cache, pc, slot, plen):
    """A batch-1 prefill cache into decode-cache slot `slot`."""
    for name, c in pc.items():
        for key, t in c.items():
            if key in ("k", "v"):
                cache[name][key][:, slot, :plen] = t[:, 0]
            else:
                cache[name][key][:, slot] = t[:, 0]


def phase_model(cfg, params):
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    T = 1024
    cache = M.init_cache(cfg, len(PLENS), T, device=DEVICE)
    first = []
    for slot, plen in enumerate(PLENS):
        prompt = torch.randint(0, cfg.vocab, (1, plen), generator=gen,
                               device=DEVICE)
        logits, pc = M.forward(params, cfg, prompt, mode="prefill")
        splice(cache, pc, slot, plen)
        first.append(int(logits[0, -1].argmax()))
    tokens = torch.tensor(first, device=DEVICE)[:, None]
    pos = np.array(PLENS)

    def skip_tile(q, k, v, lengths, *, impl=None):
        return real(q, k, v, (lengths - SKIP_ROWS).clamp(min=1), impl=impl)

    a, _ = M.decode_step(params, cfg, tokens, clone_cache(cache), pos)
    b, _ = M.decode_step(params, cfg, tokens, clone_cache(cache), pos,
                         impl="plain")
    real, ops.decode_attention = ops.decode_attention, skip_tile
    try:
        c, _ = M.decode_step(params, cfg, tokens, clone_cache(cache), pos)
    finally:
        ops.decode_attention = real
    a, b, c = a[:, 0], b[:, 0], c[:, 0]
    if a.shape != (len(PLENS), cfg.vocab) or not bool(torch.isfinite(a).all()):
        raise SystemExit(f"decode logits malformed: {tuple(a.shape)}")
    rel, agree, gap, tie_ok = rel_rows(a, b)
    rel_fault = rel_rows(c, b)[0]
    log(f"  decode logits at positions {list(PLENS)}, per sequence:"
        f" max|d|/max|logits| kernel vs plain"
        f" {[f'{r:.3e}' for r in rel]} (bound {LOGIT_REL_BOUND});"
        f" top-1 equal {agree}, plain top-1/top-2 gap"
        f" {[f'{g:.3e}' for g in gap]}")
    log(f"  control, attention skipping the last {SKIP_ROWS}-row tile:"
        f" max|d|/max|logits| {[f'{r:.3e}' for r in rel_fault]}"
        f" (must exceed {LOGIT_REL_BOUND})")
    if max(rel) > LOGIT_REL_BOUND:
        raise SystemExit("full-width decode disagrees with its plain twin")
    if not tie_ok:
        raise SystemExit("a top-1 token differs where the plain logits"
                         " have no near-tie")
    if min(rel_fault) <= LOGIT_REL_BOUND:
        raise SystemExit("the logits bound does not catch a skipped tile")
    return phase_model_int8(cfg, params, tokens, cache, pos, a)


def phase_model_int8(cfg, params, tokens, cache, pos, a):
    """One more decode step on the same cache with every layer's attention
    run as quantize_kv of that layer's K/V plus ops.decode_attention_int8,
    every count set to 0 just before and read just after; each call held
    against the plain int8 version on its own inputs.  Returns the
    flash_decode_int8 launches of the step."""
    seen = dict(calls=0, err=0.0, bad=0, rel16=[])

    def int8_attention(q, k, v, lengths, *, impl=None):
        args = (q, *quantize_kv(k, v), lengths)
        out = ops.decode_attention_int8(*args, impl=impl)
        err, ok = int8_err(args, out)
        ref16 = flash_decode_ref(q, k, v, lengths)
        seen["calls"] += 1
        seen["err"] = max(seen["err"], err)
        seen["bad"] += not ok
        seen["rel16"].append(float((out.float() - ref16).abs().max()
                                   / ref16.abs().max()))
        return out

    for fn in COUNTED.values():
        fn.launches = 0
    real, ops.decode_attention = ops.decode_attention, int8_attention
    try:
        d, _ = M.decode_step(params, cfg, tokens, clone_cache(cache), pos)
    finally:
        ops.decode_attention = real
    counts = {name: fn.launches for name, fn in COUNTED.items()}
    d = d[:, 0]
    rel, agree, _, _ = rel_rows(d, a)
    log(f"  int8 step: {seen['calls']} attention calls through quantize_kv"
        f" + flash_decode_int8, launches {counts}; max abs error vs the"
        f" plain int8 version {seen['err']:.3e} ({TOL[torch.bfloat16]}),"
        f" {seen['bad']} calls outside it")
    log(f"  int8 step: per call max|d|/max|ref| vs float attention on the"
        f" unquantized bf16 cache {min(seen['rel16']):.3e}"
        f"-{max(seen['rel16']):.3e}; logits vs the bf16 kernel step,"
        f" max|d|/max|logits| {[f'{r:.3e}' for r in rel]}, top-1 equal"
        f" {agree} (reported)")
    if d.shape != (len(PLENS), cfg.vocab) or not bool(torch.isfinite(d).all()):
        raise SystemExit(f"int8 decode logits malformed: {tuple(d.shape)}")
    want = dict({n: 0 for n in counts},
                flash_decode_int8=cfg.attn_block_count)
    if seen["calls"] != cfg.attn_block_count or counts != want \
            or seen["bad"]:
        raise SystemExit("the int8 decode step did not run flash_decode_int8"
                         " once per layer within its limit")
    return counts["flash_decode_int8"]


def to_f32(cfg, params):
    """A float32 copy of the model: bf16 weights widen exactly."""
    cast = {dict: lambda d: {k: cast[type(v)](v) for k, v in d.items()},
            list: lambda xs: [cast[type(x)](x) for x in xs],
            torch.Tensor: lambda t: t.float()}
    return dataclasses.replace(cfg, dtype="float32"), cast[dict](params)


def phase_ssm_model(name, cfg, params):
    """Full-width prefill through the scan kernel, checked three ways:

    bf16 (the serve path's precision): every scan call of the prefill is
    held against the plain version on its own inputs within SCAN_TOL, and
    show; the last logits kernel vs plain prefill are reported, not gated
    (the random bf16 network turns the scans' last-bit differences into
    bf16 rounding flips that grow through the layers: at 63 blocks its
    logits move as far for rounding as for the planted fault).
    float32, the same weights widened: last logits kernel vs plain within
    SCAN_LOGIT_BOUND, and the planted fault must exceed it.
    Then DECODE_STEPS greedy decode steps of the four sequences in bf16
    (zamba2: the first step also compared in float32, flash_decode vs
    plain attention, within LOGIT_REL_BOUND)."""
    kind, op_name = SSM[name]
    ref = SCANS[kind][1]
    real = getattr(ops, op_name)
    seen = dict(calls=0, err=0.0, fault_shown=0, fault_missed=0)

    def checked(*args, impl=None):
        out = real(*args, impl=impl)
        y, st = out
        yr, sr = ref(*args)
        yf, _ = faulty_scan(kind, *args)
        tol = SCAN_TOL[kind]
        seen["calls"] += 1
        seen["err"] = max(seen["err"], float((y - yr).abs().max()),
                          float((st - sr).abs().max()))
        if not (torch.allclose(y, yr, **tol)
                and torch.allclose(st, sr, **tol)):
            raise SystemExit(f"{kind} disagrees with its plain version on"
                             f" {name}'s own prefill inputs"
                             f" {tuple(args[0].shape)}")
        if kind == "wkv6" or args[0].shape[1] > MS.CHUNK:
            caught = not torch.allclose(yf, yr, **tol)
            seen["fault_shown" if caught else "fault_missed"] += 1
        return out

    def faulted(*args, impl=None):
        return faulty_scan(kind, *args)

    def prefill(p, c, prompt, **kw):
        return M.forward(p, c, prompt, mode="prefill", **kw)

    cfg32, params32 = to_f32(cfg, params)
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    caches = {c.dtype: M.init_cache(c, len(PLENS), 1024, device=DEVICE)
              for c in (cfg, cfg32)}
    rows16, rows32, prefill_ms = [], [], {}
    for slot, plen in enumerate(PLENS):
        prompt = torch.randint(0, cfg.vocab, (1, plen), generator=gen,
                               device=DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a, pc = prefill(params, cfg, prompt)
        torch.cuda.synchronize()
        prefill_ms[plen] = 1e3 * (time.perf_counter() - t0)
        if a.shape != (1, 1, cfg.vocab) or not bool(torch.isfinite(a).all()):
            raise SystemExit(f"prefill logits malformed: {tuple(a.shape)}")
        setattr(ops, op_name, checked)
        try:
            prefill(params, cfg, prompt)
        finally:
            setattr(ops, op_name, real)
        b, _ = prefill(params, cfg, prompt, impl="plain")
        rows16.append((a[0], b[0]))
        splice(caches[cfg.dtype], pc, slot, plen)
        a32, pc32 = prefill(params32, cfg32, prompt)
        b32, _ = prefill(params32, cfg32, prompt, impl="plain")
        setattr(ops, op_name, faulted)
        try:
            c32, _ = prefill(params32, cfg32, prompt)
        finally:
            setattr(ops, op_name, real)
        rows32.append((a32[0], b32[0], c32[0]))
        splice(caches[cfg32.dtype], pc32, slot, plen)
    log(f"  bf16: {seen['calls']} {kind} calls of the kernel-path prefill"
        f" held against the plain version on their own inputs, max abs"
        f" error {seen['err']:.3e} (y and state, {SCAN_TOL[kind]}); the"
        f" planted fault ({FAULT[kind]}) fell outside the limit on"
        f" {seen['fault_shown']} of"
        f" {seen['fault_shown'] + seen['fault_missed']} calls where it can"
        f" show")
    if seen["fault_missed"] or not seen["fault_shown"]:
        raise SystemExit(f"the {kind} limit does not catch the planted fault"
                         f" on {name}'s own prefill inputs")
    a, b = (torch.cat(x) for x in zip(*rows16))
    rel16, agree16, _, _ = rel_rows(a, b)
    log(f"  bf16 prefill logits at lengths {list(PLENS)}, max|d|/max|logits|"
        f" kernel vs plain {[f'{r:.3e}' for r in rel16]} (reported: rounding"
        f" flips amplified through the layers); top-1 equal {agree16}")
    a, b, c = (torch.cat(x) for x in zip(*rows32))
    rel, agree, gap, tie_ok = rel_rows(a, b)
    rel_fault = rel_rows(c, b)[0]
    # a dropped inter-chunk term shows only past the first chunk
    shown = [r for r, plen in zip(rel_fault, PLENS)
             if kind == "wkv6" or plen > MS.CHUNK]
    log(f"  float32 prefill logits at lengths {list(PLENS)},"
        f" max|d|/max|logits| kernel vs plain {[f'{r:.3e}' for r in rel]}"
        f" (bound {SCAN_LOGIT_BOUND}); top-1 equal {agree}, plain"
        f" top-1/top-2 gap {[f'{g:.3e}' for g in gap]}")
    log(f"  control, planted fault ({FAULT[kind]}): max|d|/max|logits|"
        f" {[f'{r:.3e}' for r in rel_fault]} (must exceed"
        f" {SCAN_LOGIT_BOUND} where it can show)")
    log(f"  bf16 prefill wall ms by length (kernel path, host clock to"
        f" synchronize): {json.dumps(prefill_ms)}")
    if max(rel) > SCAN_LOGIT_BOUND:
        raise SystemExit(f"full-width {name} prefill disagrees with its"
                         " plain twin")
    if not tie_ok:
        raise SystemExit("a top-1 token differs where the plain logits"
                         " have no near-tie")
    if min(shown) <= SCAN_LOGIT_BOUND:
        raise SystemExit(f"the logits bound does not catch the {kind}"
                         " planted fault")

    pos = np.array(PLENS)
    if cfg.attn_block_count:
        cache32 = caches[cfg32.dtype]
        tokens = a.argmax(-1)[:, None]
        x, _ = M.decode_step(params32, cfg32, tokens, clone_cache(cache32),
                             pos)
        y, _ = M.decode_step(params32, cfg32, tokens, clone_cache(cache32),
                             pos, impl="plain")
        d_rel, d_agree, _, d_tie = rel_rows(x[:, 0], y[:, 0])
        log(f"  float32 decode logits, flash_decode vs plain attention:"
            f" {[f'{r:.3e}' for r in d_rel]} (bound {LOGIT_REL_BOUND});"
            f" top-1 equal {d_agree}")
        if max(d_rel) > LOGIT_REL_BOUND or not d_tie:
            raise SystemExit(f"full-width {name} decode disagrees with"
                             " its plain-attention twin")
    cache = caches[cfg.dtype]
    del params32, caches
    tokens = torch.cat([r[0] for r in rows16]).argmax(-1)[:, None]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DECODE_STEPS):
        logits, cache = M.decode_step(params, cfg, tokens, cache, pos)
        if logits.shape != (len(PLENS), 1, cfg.vocab) \
                or not bool(torch.isfinite(logits).all()):
            raise SystemExit(f"decode logits malformed:"
                             f" {tuple(logits.shape)}")
        tokens = logits[:, 0].argmax(-1)[:, None]
        pos = pos + 1
    torch.cuda.synchronize()
    log(f"  bf16: {DECODE_STEPS} decode steps of batch {len(PLENS)}:"
        f" {1e3 * (time.perf_counter() - t0) / DECODE_STEPS:.2f} ms wall"
        f" per step; last tokens {tokens[:, 0].tolist()}")


def phase_serve(cfg, params):
    """`run_policies` with every kernel count set to 0 just before and
    read just after; checks drain, tokens and launch counts.  Returns the
    counts, flash_decode launches by shape and prefills by prompt
    length."""
    for fn in COUNTED.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = serve.run_policies(cfg, params, **SERVE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in COUNTED.items()}
    steps = 0
    by_shape, by_len = {}, Counter()
    for policy, r in res.items():
        log(f"  == {policy} ==")
        for name, eng in r["engines"].items():
            log(f"    {name} {json.dumps(r['report'][name])}")
            log(f"    {name}: {eng.decode_steps} decode steps,"
                f" {1e3 * eng.decode_wall_s / max(eng.decode_steps, 1):.2f}"
                f" ms wall per decode step (batch {eng.n_slots},"
                f" window {eng.window})")
            for req in eng.completed:
                if len(req.generated) != req.n_generated or not all(
                        0 <= t < cfg.vocab for t in req.generated):
                    raise SystemExit(f"request {req.rid}: malformed tokens")
                by_len[req.prompt_len] += 1
            steps += eng.decode_steps
            if cfg.attn_block_count:
                shape = (eng.n_slots, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                         eng.window)
                by_shape[shape] = by_shape.get(shape, 0) \
                    + cfg.attn_block_count * eng.decode_steps
            if eng.busy:
                raise SystemExit(f"{policy}/{name} did not drain")
        n_done = sum(len(e.completed) for e in r["engines"].values())
        log(f"    fleet {json.dumps(r['report']['fleet'])};"
            f" {n_done}/{SERVE['requests']} requests completed")
        if n_done != SERVE["requests"]:
            raise SystemExit(f"{policy}: {n_done} of {SERVE['requests']}"
                             " requests completed")
    log(f"  FleetOpt / homo tok/W (metered P(b)*tau):"
        f" {serve.fleetopt_gain(res):.3f}x; serve wall {wall:.1f} s")
    prefills = sum(by_len.values())
    per_prefill = {kind: sum(b.kind == block for b in cfg.unit)
                   * cfg.n_repeat
                   for kind, block in (("mamba_scan", "mamba2"),
                                       ("wkv6", "rwkv6"))}
    want = dict(flash_decode=cfg.attn_block_count * steps,
                flash_decode_int8=0,
                **{k: n * prefills for k, n in per_prefill.items()})
    log(f"  launches {counts}; expected {want} ({cfg.attn_block_count}"
        f" attention blocks x {steps} decode steps,"
        f" {per_prefill} scan blocks x {prefills} prefills)")
    if steps == 0 or prefills == 0 or counts != want \
            or not any(counts.values()):
        raise SystemExit("the serve path did not go through its kernels"
                         " once per block per decode step / prefill")
    if not set(by_shape) <= set(MAIN):
        raise SystemExit(f"the serve path gave the kernel shapes"
                         f" {sorted(by_shape)}, not all checked and timed"
                         f" (MAIN {MAIN})")
    if by_shape:
        log(f"  flash_decode launches by (B, H, K, D, T): {by_shape}")
    return counts, by_shape, by_len, per_prefill


def load_model(name):
    cfg = get_config(name)
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                           DEVICE)
    torch.cuda.synchronize()
    log(f"  init {cfg.n_repeat} x {len(cfg.unit)} blocks d={cfg.d_model}"
        f" vocab={cfg.vocab} {cfg.dtype}: {time.perf_counter() - t0:.1f} s,"
        f" {torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    return cfg, params


def weighted(rows, launches):
    """Per-launch means of a kernel's rows, weighted by serve launches;
    bound_by is what bounds the larger part of that mean bound."""
    total = sum(launches.values())

    def mean(key):
        return sum(n * rows[s][key] for s, n in launches.items()) / total

    share = Counter()
    for s, n in launches.items():
        share[rows[s]["bound_by"]] += n * rows[s]["bound_ms"]
    return dict(ms=mean("ms"), plain_ms=mean("plain_ms"),
                bound_ms=mean("bound_ms"),
                bound_by=share.most_common(1)[0][0])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    log("[1] device")
    phase_device()
    log("[2] build")
    phase_build()
    log("[3] kernel vs plain")
    max_err, fd_rows, int8_max_err, int8_rows = phase_kernel()
    log("[4] model: llama31-8b, full width")
    cfg, params = load_model("llama31-8b")
    with torch.inference_mode():
        int8_launches = phase_model(cfg, params)
    log("[5] serve llama31-8b: " + json.dumps(SERVE))
    launches = Counter()
    fd_launches = Counter()
    counts, by_shape, _, _ = phase_serve(cfg, params)
    launches.update(counts)
    fd_launches.update(by_shape)
    del params
    torch.cuda.empty_cache()

    scan_rows, scan_launches, scan_err_max = {}, {}, {}
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    for name, (kind, _) in SSM.items():
        log(f"[6] model: {name}, full width")
        cfg, params = load_model(name)
        with torch.inference_mode():
            phase_ssm_model(name, cfg, params)
        log(f"[7] serve {name}: " + json.dumps(SERVE))
        counts, by_shape, by_len, per_prefill = phase_serve(cfg, params)
        launches.update(counts)
        fd_launches.update(by_shape)
        del params
        torch.cuda.empty_cache()
        log(f"  {kind} at every prompt length the serve phase prefilled"
            f" ({len(by_len)} lengths)")
        per = {S: per_prefill[kind] * n for S, n in by_len.items()}
        scan_launches[kind] = per
        scan_rows[kind] = {S: time_scan(kind, S, gen, per[S])
                           for S in sorted(per)}
        scan_err_max[kind] = max(r["max_abs_err"]
                                 for r in scan_rows[kind].values())
        for S in (min(per), max(per)):
            log(f"  timing {json.dumps(scan_rows[kind][S])}")
    log(f"total {time.perf_counter() - t_start:.1f} s,"
        f" peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    for shape, n in fd_launches.items():
        fd_rows[shape]["serve_launches"] = n
    fd_mean = weighted(fd_rows, fd_launches)
    fd_mean["library_ms"] = sum(
        n * fd_rows[s]["library_ms"] for s, n in fd_launches.items()) \
        / sum(fd_launches.values())
    kernels = [dict(
        name="flash_decode", route="cuda",
        source="src/repro_torch/csrc/flash_decode.cu",
        replaces="src/repro/kernels/flash_decode.py:61",
        launches=launches["flash_decode"], max_abs_err=max_err, **fd_mean,
        dtype="bfloat16", by_shape=list(fd_rows.values())),
        dict(name="flash_decode_int8", route="cuda",
             source="src/repro_torch/csrc/flash_decode_int8.cu",
             replaces="src/repro/kernels/flash_decode_int8.py:73",
             launches=int8_launches, max_abs_err=int8_max_err,
             **weighted(int8_rows, {s: 1 for s in MAIN}),
             library_ms=None, dtype="bfloat16",
             library_note="no one PyTorch call computes attention over an"
                          " int8 cache with per-row scales; flash_decode and"
                          " SDPA on the bf16 cache are in by_shape",
             mean_over="the four MAIN shapes, equally weighted",
             by_shape=list(int8_rows.values()))]
    for kind, line in (("mamba_scan", 57), ("wkv6", 64)):
        kernels.append(dict(
            name=kind, route="cuda", source=f"src/repro_torch/csrc/{kind}.cu",
            replaces=f"src/repro/kernels/{kind}.py:{line}",
            launches=launches[kind], max_abs_err=scan_err_max[kind],
            **weighted(scan_rows[kind], scan_launches[kind]),
            library_ms=None, dtype="float32",
            by_shape=list(scan_rows[kind].values())))
    if any(k["launches"] == 0 for k in kernels):
        raise SystemExit("a kernel of the main path was never launched")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
