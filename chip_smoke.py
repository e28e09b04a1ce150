#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one card.

  python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device   the card's name and power limit (nvidia-smi);
  2. build    the four CUDA kernels of src/repro_torch/csrc (flash_decode,
              flash_decode_int8, mamba_scan, wkv6), one nvcc each, all
              started together; ptxas' registers and spills of every
              kernel instance;
  3. kernel   flash_decode against its plain PyTorch version at the JAX
              package's sweep shapes, the serve path's six shapes
              (llama31-8b G=4 D=128, zamba2 G=1 D=80 and granite-moe G=2
              D=64, each in a short pool 16 slots x 256 and a long pool
              4 x 1024), two larger
              ones, the ragged T and the paper's 64K window (4 x 65536),
              float32 and bfloat16 at the limits of TOL; masked entries
              overwritten with +-999 leave the output unchanged; a planted
              fault (every length one short, at llama's and granite's
              long pool) must fail the bfloat16 limit;
              times at those shapes beside the bound and one SDPA call as
              the library yardstick, each both eager (CUDA events, warmed
              up, inputs cycled through more than the 50 MB L2) and as one
              CUDA-graph replay of the same 50 calls (device time, without
              the host's per-call work), with the piece size and block
              count `plan` chose.
              mamba_scan and wkv6 against their plain sequential versions
              (y and final state) at the JAX sweep shapes, the
              full-width prefill shapes at S = 37, 1000, 1015, the edges
              of the kernels' 16-row tiles and chunks (SCAN_EDGES) and a
              batch of two, all at the serve width (wkv6 at every
              W_RANGES, w in [0.05, 0.06] the strongest decay), at the
              limits of SCAN_TOL; a planted
              fault made from calls of the unchanged kernel (mamba_scan
              run chunk by chunk: no inter-chunk term; wkv6 plus its
              diagonal term: a causal mask taking s <= t) must fail them.
              flash_decode_int8 against its plain version on the same
              quantize_kv codes and scales at the JAX int8 test's shapes,
              llama's and zamba2's four serve shapes (MAIN), the ragged T,
              the two larger ones and the paper's 64K window
              (4 x 65536), q in float32 and bfloat16
              at the limits of TOL (both compute in f32 from the same codes
              and scales); codes past lengths overwritten with +-99 leave
              the output bit-equal; two planted faults made from calls of
              the unchanged kernel (every length one short; ks and vs
              swapped) must fail the bfloat16 limit; at the JAX shapes the
              kernel stays within INT8_FLOAT_REL of max|ref| of float
              attention on the unquantized K/V (the JAX test's criterion);
              times at every shape, eager and as a CUDA-graph replay
              (device_ms), beside the bound, the plain version, the piece
              size and block count, and, on the same K/V in bf16,
              flash_decode's and SDPA's (eager and device_ms);
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
              serve phase prefilled, eager and as a CUDA-graph replay
              (device_ms), with the launches and blocks of each call;
  8. model    granite-moe-1b-a400m at full width and depth (bf16, seeded
              random weights): the ragged prompts prefilled (walls as in
              phase 6); every MoE block call of the prefills at
              MOE_PREFILL_LENS and of one decode step at each of
              MOE_DECODE_BATCHES held, in float32 on its own inputs,
              against an independent dense formulation within
              MOE_REL_BOUND with the routing and keep mask equal exactly,
              the assignments dropped at capacity counted, and two planted
              faults (the keep mask ignored, k - 1 experts) outside the
              bound; then one decode step through the kernel and one
              through the plain attention on the same cache, in bf16 and
              on a float32 copy, logits as in phase 4 (MOE_LOGIT_REL_BOUND:
              bf16 on the sequences routed alike in every layer, float32 on
              all), with the (layer, sequence) pairs whose top-k expert
              sets differ between the two runs; the skipped-tile fault
              must exceed the bound;
  9. serve    `run_policies` for granite as in phase 5: flash_decode
              launches = 24 x its decode steps, no other kernel, and the
              same decode steps as llama31-8b's on the same traffic;
  10. pressure  the serving layer's eviction paths at full width over the
              weights of phases 4, 6 and 8, in the pools phase 3 checks
              (short 16 x 256, long 4 x 1024):
              10a llama31-8b, PRESSURE_REQUESTS demo requests with the
                  median predicted output and Poisson arrivals, routed by
                  fleetopt; the short pool evicts at its window
                  (`evict_on_overflow`), both respect arrivals; its
                  `overflowed` re-served in the long pool;
              10b llama31-8b, then zamba2-2.7b: one short pool full of
                  ragged requests, PREEMPT_STEPS steps, then
                  shrink(PREEMPT_KEEP), drained (every re-admission
                  re-prefills, through mamba_scan for zamba2);
              10c semantic escalation: granite-moe-1b-a400m as the small
                  rung (short pool), llama31-8b as the large (long pool),
                  SERVE's demo requests with 10a's arrival process, both
                  pools respecting arrivals, the misroute seed the first
                  whose analytical replay escalates; the small pool's
                  `escalated` re-served in the large.
              Each run: every count set to 0 just before and read just
              after, flash_decode = attention blocks x decode steps of
              each model's engines, mamba_scan = 45 x zamba2's
              admissions, no other kernel; every request completes exactly
              once, and the run's eviction path is taken; the same traffic
              through analytical-mode engines with each model's streamed
              parameters leaves equal meters, stats(), decode steps and
              per-request times, pools and counts; in 10a and 10c the
              metered tokens equal the completed requests' n_generated - 1
              (evicted tokens backed out); and after every admission into
              a recycled slot (`Recycled`): its K/V rows and O(1) state
              bit-equal to a fresh prefill, one decode step of the slab
              kernel vs plain (llama bf16 at LOGIT_REL_BOUND; zamba2 and
              granite on float32 copies, at LOGIT_REL_BOUND and
              MOE_LOGIT_REL_BOUND's float32 bound) and with every row past
              the positions set to +-999 bit-equal, its launches taken
              back out of the counts;
then one JSON line of kernel numbers (times averaged over the serve
paths' shapes, weighted by their launches at each, flash_decode's and the
scans' also as device_ms, flash_decode's library_device_ms; prefill walls
in phase 6 are each the median of 3 after one warm-up prefill at the same
length; flash_decode_int8, which no serve path
launches, over the four MAIN shapes equally, with its device_ms and the
share of its bound, its launches those of phase 4; launches count phases
5, 7, 9 and 10, the scans' means weight phase 7's prompt lengths) and,
last, the device line.

Needs one CUDA card; exits non-zero without one.  float32 matmuls stay full
precision: TF32 is turned off for matmuls and cuDNN.
"""
from __future__ import annotations

import contextlib
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
from repro_torch.core.profiles import H100_LLAMA70B  # noqa: E402
from repro_torch.core.workloads import WORKLOADS  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.common import rms_norm, silu  # noqa: E402
from repro_torch.serving import (ContextRouter, PoolEngine,  # noqa: E402
                                 Request, RouterPolicy, sample_trace)

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
# granite-moe-1b-a400m's attention (G = 2, D = 64) in the same two pools;
# SERVE_SHAPES are all the shapes a serve phase may give flash_decode
GRANITE = [(16, 16, 8, 64, 256), (4, 16, 8, 64, 1024)]
SERVE_SHAPES = MAIN + GRANITE
EXTRA = [(16, 32, 8, 128, 1024), (16, 32, 8, 128, 8192)]
RAGGED_T = (16, 32, 8, 128, 1000)       # T a multiple of no tile or piece
LONG = (4, 32, 8, 128, 65536)           # the paper's 64K window
# flash_decode_int8: the JAX int8 test's shapes, then llama31-8b's and
# zamba2's serve shapes (MAIN), the larger ones and the paper's 64K window
INT8_SWEEP = [(2, 8, 4, 64, 100), (1, 4, 2, 128, 300), (3, 2, 2, 32, 50)]
INT8_SHAPES = INT8_SWEEP + MAIN + [RAGGED_T] + EXTRA + [LONG]
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
# the edges of the scans' 16-row tiles and of their chunks (wkv6 64,
# mamba_scan 128 tokens)
SCAN_EDGES = (1, 15, 16, 17, 63, 64, 65, 127, 128, 129)
# (B, S, nh, hd, ds): the JAX sweep, then zamba2's full-width prefill at a
# short prompt, ~1000 tokens and a length no multiple of the 128 chunk,
# then the edges and a batch of two at that width
MAMBA_SHAPES = [(2, 64, 3, 32, 16), (1, 100, 2, 64, 64), (1, 16, 1, 8, 8),
                (1, 37, 80, 64, 64), (1, 1000, 80, 64, 64),
                (1, 1015, 80, 64, 64)] \
    + [(1, S, 80, 64, 64) for S in SCAN_EDGES] + [(2, 300, 80, 64, 64)]
# (B, S, H, hd), the same for rwkv6 (64-token chunks); each at every w range
WKV_SHAPES = [(2, 64, 2, 32), (1, 100, 3, 64), (1, 7, 1, 8),
              (1, 37, 32, 64), (1, 1000, 32, 64), (1, 1015, 32, 64)] \
    + [(1, S, 32, 64) for S in SCAN_EDGES] + [(2, 300, 32, 64)]
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
MOE_ARCH = "granite-moe-1b-a400m"
# The MoE block in float32 on each layer's own inputs, the port's dispatch
# vs dense_moe: the two take the same f32 routing and differ only in the
# order of their f32 sums (expert products over d = 1024 and fe = 512, the
# gate-weighted sum over k = 8), about 1e-6 of max|y|; 1e-4 leaves a
# hundredfold margin, and a dropped or missing assignment moves y by a
# gate's share of an expert's output, ~1e-1 of max|y|
MOE_REL_BOUND = 1e-4
MOE_DECODE_BATCHES = (16, 4)            # the serve pools' slots
MOE_PREFILL_LENS = (37, 1000)
MOE_FAULTS = ("top k-1 experts", "keep mask ignored")
MOE_TIMED_LAYERS = 4                    # 4 x 100 MB of expert weights
# granite decode, kernel vs plain attention on one cache.  bf16, as phase
# 4, on the sequences the two runs route alike in every layer: there the
# logits came out bit-equal (3 of 4 sequences, on an H100 at 700 W).  A
# sequence whose attention output rounds to another bf16 value at one
# layer can meet a router near-tie (k-th/(k+1)-th probability gap 3.3e-4
# against a shift of 8.3e-4 at layer 5 of the 37-token sequence), after
# which the two runs sum other experts in most later layers (17 of 24) and
# the logits differ by 0.51 of max|logits|: such a sequence is reported,
# not gated.  float32 (weights and cache widened), every sequence: the
# attention outputs differ in f32 summation order only; measured 4.5e-6 to
# 5.2e-6 with no routing difference, so 1e-3 leaves a 200-fold margin; the
# skipped tile gives 1.3-1.5 in both.
MOE_LOGIT_REL_BOUND = {"bfloat16": LOGIT_REL_BOUND, "float32": 1e-3}
# Phase 10 ("pressure").  10a: the smallest azure-conv demo stream
# (serve.demo_requests at SERVE's window_long) in which a request that
# FleetOpt admits to the short pool on its predicted output (the median
# output) outgrows the short window: analytical replays of the streams of
# 16-40 requests give the first eviction at 25.  Poisson arrivals at
# ARRIVAL_RATE (mean gap 20 ms, two to three metered decode steps).
PRESSURE_REQUESTS = 25
ARRIVAL_RATE = 50.0
SHORT_POOL = dict(window=256, n_slots=16)   # the pools phase 3 checks
LONG_POOL = dict(window=1024, n_slots=4)
# 10b: ragged requests filling one short pool, PREEMPT_STEPS decode steps,
# then shrink to PREEMPT_KEEP live requests
PREEMPT_REQUESTS, PREEMPT_STEPS, PREEMPT_KEEP = 20, 6, 4
# 10c: the semantic ladder's small-rung boundary on predicted total, the
# quality monitor's detection latency and the classifier's error rate
SEMANTIC = dict(boundary=128.0, detect_tokens=32, misroute_rate=0.25)
COUNTED = {"flash_decode": flash_decode,
           "flash_decode_int8": flash_decode_int8, "mamba_scan": mamba_scan,
           "wkv6": wkv6}


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def patched(module, name, fn):
    """`module.name` replaced by `fn` inside the block; yields the real one."""
    real = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield real
    finally:
        setattr(module, name, real)


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


def graph_ms(fn, sets, iters=50):
    """Device ms per call: one CUDA-graph replay of `iters` calls cycling
    through `sets` (captured after a warm-up), timed with CUDA events."""
    for args in sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*sets[i % len(sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
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
    lib_sets = [(i,) for i in range(len(sets))]

    def lib(i):
        return sdpa(*sets[i][:3], masks[i])

    ms = time_ms(flash_decode, sets, 50)
    device_ms = graph_ms(flash_decode, sets)
    plain_ms = time_ms(flash_decode_ref, sets, 10)
    lib_ms = time_ms(lib, lib_sets, 50)
    lib_device_ms = graph_ms(lib, lib_sets)
    lib_err = float((sdpa(q, k, v, masks[0]).float()
                     - flash_decode_ref(q, k, v, lengths)).abs().max())
    b_ms, b_by = bound(q, k, lengths)
    B, _, K, _, T = shape
    piece, n_split = FD.plan(B, K, T, torch.cuda.get_device_properties(
        0).multi_processor_count)
    row = dict(shape=dict(zip("BHKDT", shape)), dtype=str(dtype).split(".")[1],
               ms=ms, device_ms=device_ms, plain_ms=plain_ms,
               library_ms=lib_ms, library_device_ms=lib_device_ms,
               bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / device_ms,
               piece=piece, blocks=n_split * K * B,
               library_max_abs_err=lib_err, input_sets=len(sets))
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
    flash_decode and SDPA: the int8 form's yardstick on bytes.  Each
    eager and as one CUDA-graph replay (device_ms), with the piece size and
    block count the int8 kernel's `plan` chose.  Input sets cycle past 3x
    the L2 for the int8 bytes (twice that for the bf16)."""
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
    lib_sets = [(i,) for i in range(len(f16_sets))]

    def lib(i):
        return sdpa(*f16_sets[i][:3], masks[i])

    ms = time_ms(flash_decode_int8, i8_sets, 50)
    device_ms = graph_ms(flash_decode_int8, i8_sets)
    plain_ms = time_ms(flash_decode_int8_ref, i8_sets, 10)
    bf16_ms = time_ms(flash_decode, f16_sets, 50)
    bf16_device_ms = graph_ms(flash_decode, f16_sets)
    sdpa_ms = time_ms(lib, lib_sets, 50)
    sdpa_device_ms = graph_ms(lib, lib_sets)
    b_ms, b_by = int8_bound(first[1][0], first[1][1], lengths)
    B, _, K, _, T = shape
    piece, n_split = FD8.plan(B, K, T, torch.cuda.get_device_properties(
        0).multi_processor_count)
    row = dict(shape=dict(zip("BHKDT", shape)), dtype="bfloat16",
               ms=ms, device_ms=device_ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, bound_share=b_ms / device_ms, piece=piece,
               blocks=n_split * K * B, flash_decode_bf16_ms=bf16_ms,
               flash_decode_bf16_device_ms=bf16_device_ms,
               sdpa_bf16_ms=sdpa_ms, sdpa_bf16_device_ms=sdpa_device_ms,
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
    through more than the L2), eager and as one CUDA-graph replay, beside
    its plain version; with `plan`'s launches and blocks for the call."""
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
    device_ms = graph_ms(fn, sets)
    plain_ms = time_ms(ref, sets[:2], 2)
    b_ms, b_by = scan_bound(kind, shape)
    plan = (MS if kind == "mamba_scan" else WK).plan(*shape)
    return dict(shape=dict(zip(("B", "S", "nh", "hd", "ds")
                               if kind == "mamba_scan"
                               else ("B", "S", "H", "hd"), shape)),
                dtype="float32", ms=ms, device_ms=device_ms,
                plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                bound_by=b_by, bound_share=b_ms / device_ms,
                max_abs_err=err, serve_launches=serve_launches,
                launches_per_call=plan["launches"],
                blocks={k: v for k, v in plan.items() if "blocks" in k},
                input_sets=len(sets))


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
            if "Compiling entry function" in line:
                # the instance: a kernel template's arguments, or its name
                name = line.split("'")[1]
                at = name.find("kernelI")
                log(f"    ptxas: {name[at + 7:] if at >= 0 else name}")
            elif "registers" in line or "spill" in line or "smem" in line:
                log(f"    ptxas: {line.strip()}")


def phase_kernel():
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in SWEEP + SERVE_SHAPES + EXTRA + [RAGGED_T, LONG]:
            errs[(shape, dtype)] = check_kernel(shape, dtype, gen)
        for shape in SERVE_SHAPES:
            check_kernel(shape, dtype, gen, strided_q=True)
    control_kernel(MAIN[1], gen)
    control_kernel(GRANITE[1], gen)
    rows = {shape: time_kernel(shape, torch.bfloat16, gen)
            for shape in SERVE_SHAPES + EXTRA + [RAGGED_T, LONG]}
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
    return (max(errs[(s, torch.bfloat16)] for s in SERVE_SHAPES), rows,
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
    with patched(ops, "decode_attention", skip_tile) as real:
        c, _ = M.decode_step(params, cfg, tokens, clone_cache(cache), pos)
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
    with patched(ops, "decode_attention", int8_attention):
        d, _ = M.decode_step(params, cfg, tokens, clone_cache(cache), pos)
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
    rows16, rows32, prefill_ms, first_ms = [], [], {}, {}
    for slot, plen in enumerate(PLENS):
        prompt = torch.randint(0, cfg.vocab, (1, plen), generator=gen,
                               device=DEVICE)
        walls = []
        for _ in range(4):     # one warm-up at this length, then 3 timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a, pc = prefill(params, cfg, prompt)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        first_ms[plen] = walls[0]
        prefill_ms[plen] = sorted(walls[1:])[1]
        if a.shape != (1, 1, cfg.vocab) or not bool(torch.isfinite(a).all()):
            raise SystemExit(f"prefill logits malformed: {tuple(a.shape)}")
        with patched(ops, op_name, checked):
            prefill(params, cfg, prompt)
        b, _ = prefill(params, cfg, prompt, impl="plain")
        rows16.append((a[0], b[0]))
        splice(caches[cfg.dtype], pc, slot, plen)
        a32, pc32 = prefill(params32, cfg32, prompt)
        b32, _ = prefill(params32, cfg32, prompt, impl="plain")
        with patched(ops, op_name, faulted):
            c32, _ = prefill(params32, cfg32, prompt)
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
        f" synchronize), median of 3 after one warm-up prefill at that"
        f" length: {json.dumps(prefill_ms)}; the warm-up prefill itself:"
        f" {json.dumps(first_ms)}")
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


# ---- mixture of experts ----------------------------------------------------

def dense_moe(p, cfg, x, *, k=None, keep_all=False):
    """The MoE block as a plain formulation independent of the port's
    dispatch: every expert's SwiGLU on every token, then per token the
    gate-weighted sum over its top-k experts, an assignment kept when fewer
    than C earlier tokens chose the same expert (counted, not sorted).
    `k` and `keep_all` plant the faults (fewer experts, the keep mask
    ignored).  Returns x + y, the keep mask (T, k) and the experts (T, k)."""
    B, S, d = x.shape
    T, E = B * S, cfg.n_experts
    k = k or cfg.top_k
    h = rms_norm(x, p["norm"], cfg.norm_eps).reshape(T, d)
    probs = torch.softmax(h.float() @ p["router"], dim=-1)
    gates, idx = probs.topk(k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    chose = torch.zeros(T, E, dtype=torch.long, device=x.device) \
        .scatter_(1, idx, 1)
    earlier = chose.cumsum(0) - chose
    C = T if S == 1 else max(int(T * cfg.top_k / E * cfg.capacity_factor), 1)
    keep = earlier.gather(1, idx) < C
    if keep_all:
        keep = torch.ones_like(keep)
    g = torch.einsum("td,edf->etf", h, p["w_gate"])
    u = torch.einsum("td,edf->etf", h, p["w_up"])
    out = torch.bmm(silu(g) * u, p["w_down"])                   # (E, T, d)
    picked = out[idx, torch.arange(T, device=x.device)[:, None]]   # (T, k, d)
    y = (picked.float() * (gates * keep)[..., None]).sum(1)
    return x + y.reshape(B, S, d).to(x.dtype), keep, idx


def moe_check(p, cfg, x):
    """One MoE block call on the model's own input x, in float32: the
    port's `apply_moe` against `dense_moe`, the routing and keep mask equal
    exactly, and the planted faults' error (the ignored keep mask only
    where this call drops).  Errors are max|dy| / max|y| of the block's
    output y = out - x."""
    x32 = x.float()
    p32 = {key: t.float() for key, t in p.items()}
    B, S, d = x.shape
    T, k = B * S, cfg.top_k
    want, keep, idx = dense_moe(p32, cfg, x32)
    want = want - x32
    scale = float(want.abs().max())

    def rel(out):
        return float((out - x32 - want).abs().max()) / scale

    h = rms_norm(x32, p32["norm"], cfg.norm_eps).reshape(T, d)
    _, pidx = moe.router_topk(h @ p32["router"], k)
    _, (_, pkeep, inv) = moe._dispatch_group(
        h, pidx, cfg.n_experts, k, moe.capacity(cfg, T, S))
    drops = int((~keep).sum())
    faults = {"top k-1 experts": rel(dense_moe(p32, cfg, x32, k=k - 1)[0])}
    if drops:
        faults["keep mask ignored"] = rel(
            dense_moe(p32, cfg, x32, keep_all=True)[0])
    return dict(rel=rel(moe.apply_moe(p32, cfg, x32)), drops=drops,
                assignments=T * k, experts=int(idx.unique().numel()),
                same_keep=torch.equal(pidx, idx)
                and torch.equal(pkeep[inv].reshape(T, k), keep),
                C=moe.capacity(cfg, T, S), faults=faults)


def time_moe(cfg, params, seen):
    """One bf16 MoE block call at the inputs of the first MOE_TIMED_LAYERS
    layers (cycled, each with its own weights: more than the L2), eager and
    as a CUDA-graph replay, beside the least bytes two dispatches would
    move: every expert's weights (what the dense (E, C, d) products read)
    and only the experts the batch routes to (the mean over all layers of
    `seen`), each plus x read and the output written once; and beside the
    bf16 operations of the routed assignments' products."""
    sets = [(params["layers"][i]["b1_moe"], cfg, s["x"])
            for i, s in enumerate(seen[:MOE_TIMED_LAYERS])]
    x = sets[0][2]
    fe, E, d = cfg.moe_d_ff, cfg.n_experts, cfg.d_model
    per_expert = 3 * d * fe * x.element_size()
    io = 2 * x.numel() * x.element_size()
    experts = sum(s["experts"] for s in seen) / len(seen)
    flops = 2 * 3 * seen[0]["assignments"] * d * fe
    b_all = _bound(E * per_expert + io, flops, torch.bfloat16)
    b_routed = _bound(experts * per_expert + io, flops, torch.bfloat16)
    return dict(shape=dict(zip("BSd", x.shape)), experts_routed=experts,
                ms=time_ms(moe.apply_moe, sets, 20),
                device_ms=graph_ms(moe.apply_moe, sets, 20),
                bound_all_experts_ms=b_all[0], bound_routed_ms=b_routed[0],
                bound_routed_by=b_routed[1], weight_gb_all=E * per_expert
                * cfg.n_repeat / 1e9, weight_gb_routed=experts * per_expert
                * cfg.n_repeat / 1e9)


def phase_moe_model(cfg, params):
    """granite-moe-1b-a400m at full width: ragged prompts prefilled (walls
    as in phase 6), then
    (a) every MoE block call of the prefills at MOE_PREFILL_LENS and of a
        decode step at each of MOE_DECODE_BATCHES held against `dense_moe`
        in float32 within MOE_REL_BOUND (`moe_check`), with the assignments
        dropped at capacity counted and both planted faults outside the
        bound;
    (b) one decode step through flash_decode and one through the plain
        attention on the same cache, logits compared as in phase 4, with
        the (layer, sequence) pairs whose top-k expert sets differ between
        the two runs; in bf16 and on a float32 copy of the weights and
        cache (`moe_decode_twins`); the skipped-tile fault must exceed the
        bound in both."""
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    real = M.apply_moe
    checks = {}

    def checked(tag):
        seen = checks.setdefault(tag, [])

        def fn(p, c, x):
            seen.append(moe_check(p, c, x))
            if len(seen) <= MOE_TIMED_LAYERS:
                seen[-1]["x"] = x.clone()
            return real(p, c, x)
        return fn

    cache = M.init_cache(cfg, len(PLENS), 1024, device=DEVICE)
    first, prompts, prefill_ms, first_ms = [], [], {}, {}
    for slot, plen in enumerate(PLENS):
        prompt = torch.randint(0, cfg.vocab, (1, plen), generator=gen,
                               device=DEVICE)
        prompts.append(prompt)
        walls = []
        for _ in range(4):     # one warm-up at this length, then 3 timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, pc = M.forward(params, cfg, prompt, mode="prefill")
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        first_ms[plen] = walls[0]
        prefill_ms[plen] = sorted(walls[1:])[1]
        if logits.shape != (1, 1, cfg.vocab) \
                or not bool(torch.isfinite(logits).all()):
            raise SystemExit(f"prefill logits malformed:"
                             f" {tuple(logits.shape)}")
        splice(cache, pc, slot, plen)
        first.append(int(logits[0, -1].argmax()))
        if plen in MOE_PREFILL_LENS:
            with patched(M, "apply_moe", checked(f"prefill S={plen}")):
                M.forward(params, cfg, prompt, mode="prefill")
    log(f"  bf16 prefill wall ms by length (host clock to synchronize),"
        f" median of 3 after one warm-up prefill at that length:"
        f" {json.dumps(prefill_ms)}; the warm-up prefill itself:"
        f" {json.dumps(first_ms)}")
    tokens = torch.tensor(first, device=DEVICE)[:, None]
    pos = np.array(PLENS)
    for B in MOE_DECODE_BATCHES:
        reps = B // len(PLENS)
        toks = tokens if reps == 1 else torch.randint(
            0, cfg.vocab, (B, 1), generator=gen, device=DEVICE)
        batch = {n: {key: t.repeat_interleave(reps, 1) for key, t in c.items()}
                 for n, c in cache.items()}
        with patched(M, "apply_moe", checked(f"decode B={B}")):
            M.decode_step(params, cfg, toks, batch, np.repeat(pos, reps))
        del batch
    bad = []
    for tag, seen in checks.items():
        drops = [s["drops"] for s in seen]
        faults = {name: min(s["faults"][name] for s in seen
                            if name in s["faults"])
                  for name in MOE_FAULTS if any(name in s["faults"]
                                                for s in seen)}
        log(f"  moe {tag}: {len(seen)} calls, port vs dense max|dy|/max|y|"
            f" {max(s['rel'] for s in seen):.3e} (bound {MOE_REL_BOUND});"
            f" routing and keep mask equal in"
            f" {sum(s['same_keep'] for s in seen)}/{len(seen)}; C"
            f" {seen[0]['C']}; assignments dropped at capacity {sum(drops)}"
            f" of {sum(s['assignments'] for s in seen)} (per layer {drops});"
            f" planted faults, least"
            f" error where each can show: {json.dumps(faults)} (must exceed"
            f" {MOE_REL_BOUND})")
        if max(s["rel"] for s in seen) > MOE_REL_BOUND \
                or not all(s["same_keep"] for s in seen) \
                or any(f <= MOE_REL_BOUND for f in faults.values()):
            bad.append(tag)
        if tag.startswith("decode") and any(drops):
            bad.append(f"{tag} dropped an assignment")
    if not any("keep mask ignored" in s["faults"]
               for seen in checks.values() for s in seen):
        bad.append("no prefill dropped an assignment: the keep-mask fault"
                   " was never shown")
    if len(checks) != len(MOE_PREFILL_LENS) + len(MOE_DECODE_BATCHES) \
            or any(len(seen) != cfg.n_repeat for seen in checks.values()):
        bad.append("not every MoE block was checked")
    if bad:
        raise SystemExit(f"the MoE block disagrees with its plain"
                         f" formulation, or a fault passed: {bad}")
    for tag, seen in checks.items():
        log(f"  timing moe {tag}: {json.dumps(time_moe(cfg, params, seen))}")

    moe_decode_twins(cfg, params, tokens, cache, pos)
    cfg32, params32 = to_f32(cfg, params)
    cache32 = M.init_cache(cfg32, len(PLENS), 1024, device=DEVICE)
    for slot, prompt in enumerate(prompts):
        splice(cache32, M.forward(params32, cfg32, prompt, mode="prefill")[1],
               slot, prompt.shape[1])
    moe_decode_twins(cfg32, params32, tokens, cache32, pos)


def moe_decode_twins(cfg, params, tokens, cache, pos):
    """One decode step through flash_decode and one through the plain
    attention on the same cache (and one with the skipped-tile fault),
    recording every MoE block's routing.  Per sequence: the logits as in
    phase 4, and the layers whose top-k expert set differs between the two
    runs; for the first such layer, the plain run's gap between its k-th
    and (k+1)-th router probability and the largest change of that token's
    router probabilities between the runs.  Held to MOE_LOGIT_REL_BOUND of
    the dtype: in float32 every sequence, in bf16 those routed alike in
    every layer; a bf16 sequence routed otherwise is reported (from its
    first differing layer on, the two runs sum other experts)."""
    real = M.apply_moe
    probs = {}

    def recording(tag):
        store = probs.setdefault(tag, [])

        def fn(p, c, x):
            B, S, d = x.shape
            h = rms_norm(x, p["norm"], c.norm_eps).reshape(B * S, d)
            store.append(torch.softmax(h.float() @ p["router"], dim=-1))
            return real(p, c, x)
        return fn

    def skip_tile(q, k, v, lengths, *, impl=None):
        return attn(q, k, v, (lengths - SKIP_ROWS).clamp(min=1), impl=impl)

    with patched(M, "apply_moe", recording("kernel")):
        a, _ = M.decode_step(params, cfg, tokens, clone_cache(cache), pos)
    with patched(M, "apply_moe", recording("plain")):
        b, _ = M.decode_step(params, cfg, tokens, clone_cache(cache), pos,
                             impl="plain")
    with patched(ops, "decode_attention", skip_tile) as attn:
        c, _ = M.decode_step(params, cfg, tokens, clone_cache(cache), pos)
    a, b, c = a[:, 0], b[:, 0], c[:, 0]
    if a.shape != (len(PLENS), cfg.vocab) or not bool(torch.isfinite(a).all()):
        raise SystemExit(f"decode logits malformed: {tuple(a.shape)}")
    k = cfg.top_k
    flips, first = [], []
    for s in range(len(PLENS)):
        layers = [layer for layer, (pa, pb) in enumerate(zip(probs["kernel"],
                                                             probs["plain"]))
                  if not torch.equal(pa[s].topk(k).indices.sort().values,
                                     pb[s].topk(k).indices.sort().values)]
        flips.append(layers)
        if layers:
            pa = probs["kernel"][layers[0]][s]
            pb = probs["plain"][layers[0]][s]
            top = pb.topk(k + 1).values
            first.append(dict(layer=layers[0],
                              gap=float(top[k - 1] - top[k]),
                              shift=float((pa - pb).abs().max())))
    bound = MOE_LOGIT_REL_BOUND[cfg.dtype]
    gated = [s for s in range(len(PLENS))
             if cfg.dtype == "float32" or not flips[s]]
    rel, agree, gap, _ = rel_rows(a, b)
    tie_ok = rel_rows(a[gated], b[gated])[3] if gated else True
    rel_fault = rel_rows(c, b)[0]
    log(f"  {cfg.dtype} decode logits at positions {list(PLENS)}, per"
        f" sequence: max|d|/max|logits| kernel vs plain"
        f" {[f'{r:.3e}' for r in rel]} (bound {bound} on"
        f" sequences {gated}); top-1 equal {agree}, plain top-1/top-2 gap"
        f" {[f'{g:.3e}' for g in gap]}")
    log(f"  {cfg.dtype} layers whose top-{k} expert set differs between the"
        f" two runs, per sequence: {flips}; at the first such layer, the"
        f" plain run's k-th/(k+1)-th router probability gap and the largest"
        f" change of the token's router probabilities: {json.dumps(first)}")
    log(f"  {cfg.dtype} control, attention skipping the last {SKIP_ROWS}-row"
        f" tile: max|d|/max|logits| {[f'{r:.3e}' for r in rel_fault]} (must"
        f" exceed {bound})")
    if any(rel[s] > bound for s in gated):
        raise SystemExit(f"full-width granite {cfg.dtype} decode disagrees"
                         " with its plain-attention twin")
    if not tie_ok:
        raise SystemExit("a top-1 token differs where the plain logits"
                         " have no near-tie")
    if min(rel_fault) <= bound:
        raise SystemExit("the logits bound does not catch a skipped tile")


def phase_serve(cfg, params):
    """`run_policies` with every kernel count set to 0 just before and
    read just after; checks drain, tokens and launch counts.  Returns the
    counts, flash_decode launches by shape, prefills by prompt length,
    the scan blocks per prefill and the decode steps."""
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
    if not set(by_shape) <= set(SERVE_SHAPES):
        raise SystemExit(f"the serve path gave the kernel shapes"
                         f" {sorted(by_shape)}, not all checked and timed"
                         f" ({SERVE_SHAPES})")
    if by_shape:
        log(f"  flash_decode launches by (B, H, K, D, T): {by_shape}")
    return counts, by_shape, by_len, per_prefill, steps


# ---- phase 10: serving under pressure ---------------------------------------

def timed(reqs):
    """`reqs` arriving on `sample_trace`'s Poisson process."""
    trace = sample_trace(WORKLOADS[SERVE["workload"]], len(reqs), seed=0,
                         arrival_rate=ARRIVAL_RATE)
    for r, (_, _, t) in zip(reqs, trace):
        r.arrival_time = t
    return reqs


def traffic_overflow(vocab):
    """10a: the demo stream, each request predicting the median output,
    with timed arrivals."""
    reqs = serve.demo_requests(vocab, SERVE["workload"], PRESSURE_REQUESTS,
                               SERVE["window_long"])
    pred = int(np.median([r.max_new_tokens for r in reqs]))
    for r in reqs:
        r.predicted_output = pred
    return timed(reqs)


def traffic_preempt(vocab):
    """10b: ragged prompts of 4-159 tokens, 8-63 new tokens each."""
    rng = np.random.default_rng(10)
    lens = rng.integers((4, 8), (160, 64), size=(PREEMPT_REQUESTS, 2))
    return [Request(rid=i, prompt=rng.integers(0, vocab, int(p)),
                    max_new_tokens=int(o)) for i, (p, o) in enumerate(lens)]


def traffic_semantic(vocab):
    """10c: SERVE's demo stream, token ids below both models' vocabs, with
    timed arrivals (so that the small pool recycles slots)."""
    return timed(serve.demo_requests(vocab, SERVE["workload"],
                                     SERVE["requests"], SERVE["window_long"]))


def relay(first, outbox, second):
    """Drain `first`, submit what left it through `outbox`, drain `second`."""
    first.run_until_drained()
    for r in getattr(first, outbox):
        second.submit(r)
    second.run_until_drained()


def run_overflow(make, reqs):
    pools = {"short": make("short", **SHORT_POOL, evict_on_overflow=True,
                           respect_arrival=True),
             "long": make("long", **LONG_POOL, respect_arrival=True)}
    router = ContextRouter(pools, RouterPolicy(
        kind="fleetopt", b_short=SERVE["b_short"], gamma=2.0,
        ladder=[("short", float(SHORT_POOL["window"])),
                ("long", math.inf)]))
    for r in reqs:
        router.route(r)
    relay(pools["short"], "overflowed", pools["long"])
    return pools


def run_preempt(make, reqs):
    eng = make("short", **SHORT_POOL)
    for r in reqs:
        eng.submit(r)
    for _ in range(PREEMPT_STEPS):
        eng.step()
    eng.shrink(PREEMPT_KEEP)
    eng.run_until_drained()
    return {"short": eng}


def run_semantic(make, reqs, seed):
    pools = {"small": make("small", **SHORT_POOL, respect_arrival=True),
             "large": make("large", **LONG_POOL, respect_arrival=True)}
    router = ContextRouter(pools, RouterPolicy(
        kind="semantic", b_short=int(SEMANTIC["boundary"]),
        flip=("small", "large"), detect_tokens=SEMANTIC["detect_tokens"],
        misroute_rate=SEMANTIC["misroute_rate"], misroute_seed=seed,
        ladder=[("small", SEMANTIC["boundary"]), ("large", math.inf)]))
    for r in reqs:
        router.route(r)
    relay(pools["small"], "escalated", pools["large"])
    return pools


def analytical(streamed):
    """Engine factory of analytical-mode twins: no model, the streamed
    parameters of each role's model."""
    def make(role, **kw):
        return PoolEngine(None, None, profile=H100_LLAMA70B, name=role,
                          streamed_params=streamed[role], **kw)
    return make


def escalating_seed(reqs_of, streamed):
    """The first misroute seed whose analytical replay of 10c escalates a
    request out of the small pool (a true-large request flipped small
    that reaches the detection latency inside the small window)."""
    for seed in range(1000):
        pools = run_semantic(analytical(streamed), reqs_of(), seed)
        if pools["small"].escalated:
            return seed
    raise SystemExit("no misroute seed escalates a request in 10c")


def widen(cache):
    """A float32 copy of a decode cache (bf16 K/V widen exactly)."""
    return {n: {k: t.to(torch.float32, copy=True) for k, t in c.items()}
            for n, c in cache.items()}


class Recycled:
    """Phase 10's recycled-slot checks over one model's engines.  `watch`
    wraps an engine's
    `_admit`; after an admission pass that put a request into a slot that
    held one before, it holds (a) that slot's K/V rows [0, plen) and O(1)
    state, as the splice wrote them, bit-equal to a fresh batch-1 prefill
    of the same prompt; (b) one decode step over the whole slab through
    the kernel against the plain attention on the engine's own cache
    (bf16, or on float32 copies of the weights and cache when `f32` is
    given), per active slot within `bound`, a differing top-1 only at a
    near-tie; (c) the kernel step with every K row past each slot's
    position overwritten with +999 and V with -999, logits bit-equal.
    The launches these checks make are taken back out of the counts, and
    their wall time is kept apart."""

    def __init__(self, cfg, params, bound, f32=None):
        self.cfg, self.params, self.bound, self.f32 = cfg, params, bound, f32
        self.slots = self.steps = self.admissions = 0
        self.kv_unequal, self.kv_max = 0, 0.0
        self.rel, self.bad, self.masked_unequal = [], 0, 0
        self.seconds = 0.0

    def watch(self, eng):
        used = np.zeros(eng.n_slots, bool)
        real = eng._admit

        def admit():
            before = list(eng.slots)
            real()
            new = [i for i, r in enumerate(eng.slots)
                   if r is not None and r is not before[i]]
            self.admissions += len(new)
            recycled = [i for i in new if used[i]]
            used[new] = True
            if recycled:
                self.check(eng, recycled)
        eng._admit = admit
        return eng

    def check(self, eng, recycled):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        saved = {n: fn.launches for n, fn in COUNTED.items()}
        for i in recycled:
            prompt = torch.as_tensor(eng.slots[i].prompt[None], device=DEVICE)
            _, pc = M.forward(self.params, self.cfg, prompt, mode="prefill")
            for name, slab in eng.cache.items():
                for key, dst in slab.items():
                    piece = pc[name][key][:, 0]
                    if key in ("k", "v"):
                        t = min(piece.shape[1], dst.shape[2])
                        got, want = dst[:, i, :t], piece[:, -t:]
                    else:
                        got, want = dst[:, i], piece
                    if not torch.equal(got, want):
                        self.kv_unequal += 1
                        self.kv_max = max(self.kv_max, float(
                            (got.float() - want.float()).abs().max()))
            self.slots += 1
        self.decode_twins(eng)
        for n, fn in COUNTED.items():
            fn.launches = saved[n]
        torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0

    def decode_twins(self, eng):
        tokens = torch.as_tensor(eng.tokens[:, None], device=DEVICE)
        pos = eng.pos.copy()
        rows = np.flatnonzero(eng._active & (eng.prefill_left == 0))
        a, _ = M.decode_step(self.params, self.cfg, tokens,
                             clone_cache(eng.cache), pos)
        if self.f32 is None:
            x, y = a, M.decode_step(self.params, self.cfg, tokens,
                                    clone_cache(eng.cache), pos,
                                    impl="plain")[0]
        else:
            cfg32, params32 = self.f32
            x = M.decode_step(params32, cfg32, tokens, widen(eng.cache),
                              pos)[0]
            y = M.decode_step(params32, cfg32, tokens, widen(eng.cache),
                              pos, impl="plain")[0]
        rel, _, _, tie_ok = rel_rows(x[rows, 0], y[rows, 0])
        self.rel.append(max(rel))
        self.bad += max(rel) > self.bound or not tie_ok
        masked = clone_cache(eng.cache)
        past = torch.arange(eng.window, device=DEVICE)[None, :] \
            >= torch.as_tensor(pos, device=DEVICE)[:, None]
        for slab in masked.values():
            if "k" in slab:
                m = past[None, :, :slab["k"].shape[2], None, None]
                slab["k"].masked_fill_(m, 999.0)
                slab["v"].masked_fill_(m, -999.0)
        c, _ = M.decode_step(self.params, self.cfg, tokens, masked, pos)
        self.masked_unequal += not torch.equal(a, c)
        self.steps += 1

    def summary(self):
        return (f"{self.slots} recycled slots after {self.admissions}"
                f" admissions: K/V and state vs a fresh prefill unequal in"
                f" {self.kv_unequal} tensors (max |d| {self.kv_max:.3e},"
                f" bound: bit-equal); {self.steps} decode steps of the slab,"
                f" kernel vs plain ({'float32' if self.f32 else 'bfloat16'})"
                f" max|d|/max|logits| {max(self.rel, default=0.0):.3e}"
                f" (bound {self.bound}), {self.bad} outside it; rows past"
                f" each slot's position set to +-999 changed the logits in"
                f" {self.masked_unequal} of {self.steps} steps")

    def failed(self):
        return self.kv_unequal or self.bad or self.masked_unequal


SCHED = ("rid", "pool", "first_token_time", "finish_time", "n_generated",
         "preemptions", "escalations", "ready_time")


def schedule_of(pools):
    """What the scheduler decided, per pool: every meter field, stats(),
    decode steps, and each request's pool, times and counts by list."""
    out = {}
    for role, eng in pools.items():
        meter = {f.name: getattr(eng.meter, f.name)
                 for f in dataclasses.fields(eng.meter) if f.name != "profile"}
        lists = {name: [tuple(getattr(r, f) for f in SCHED)
                        for r in getattr(eng, name)]
                 for name in ("completed", "overflowed", "escalated")}
        out[role] = dict(meter=meter, stats=eng.stats(),
                         decode_steps=eng.decode_steps, **lists)
    return out


def phase_pressure(tag, run, models, n_requests, *, outbox=None,
                   preempted=False):
    """One phase-10 run.  `models` maps each role to (cfg, params,
    Recycled); `run(make)` builds its pools with `make` and drives them.
    The run goes once through model-mode engines on the card (every count
    set to 0 just before, read just after) and once through analytical
    twins with each model's streamed parameters, and is checked as the
    module docstring's phase 10 says.  Returns the counts, flash_decode
    launches by shape and the wall without the recycled-slot checks."""
    def make(role, **kw):
        cfg, params, recycled = models[role]
        return recycled.watch(PoolEngine(cfg, params, profile=H100_LLAMA70B,
                                         name=role, **kw))

    for fn in COUNTED.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pools = run(make)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in COUNTED.items()}
    checks = list({id(m[2]): m[2] for m in models.values()}.values())
    check_s = sum(c.seconds for c in checks)
    streamed = {role: m[0].analytical_spec().streamed_params
                for role, m in models.items()}
    twins = run(analytical(streamed))
    bad = []
    same = schedule_of(pools) == schedule_of(twins)
    log(f"  model mode vs analytical mode: meters, stats(), decode steps"
        f" and per-request pools, times, preemptions and escalations equal:"
        f" {same}")
    if not same:
        bad.append("the model-mode schedule differs from the analytical one")
    by_shape, want = Counter(), Counter()
    for role, eng in pools.items():
        cfg = models[role][0]
        log(f"    {role} ({cfg.name}) {json.dumps(eng.stats())}")
        log(f"    {role}: {eng.decode_steps} decode steps,"
            f" {1e3 * eng.decode_wall_s / max(eng.decode_steps, 1):.2f} ms"
            f" wall per decode step (batch {eng.n_slots}, window"
            f" {eng.window}); preempted {eng.preempted}, overflowed"
            f" {len(eng.overflowed)}, escalated {eng.n_escalated}")
        for req in eng.completed:
            if len(req.generated) != req.n_generated or not all(
                    0 <= t < cfg.vocab for t in req.generated):
                bad.append(f"request {req.rid}: malformed tokens")
        if eng.busy:
            bad.append(f"{role} did not drain")
        shape = (eng.n_slots, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                 eng.window)
        by_shape[shape] += cfg.attn_block_count * eng.decode_steps
        want["flash_decode"] += cfg.attn_block_count * eng.decode_steps
    for recycled in checks:
        cfg = recycled.cfg
        per_prefill = sum(b.kind == "mamba2" for b in cfg.unit) * cfg.n_repeat
        want["mamba_scan"] += per_prefill * recycled.admissions
        log(f"  {cfg.name}: {recycled.summary()}")
        if recycled.failed():
            bad.append(f"{cfg.name}: a recycled slot failed its checks")
    if not sum(c.slots for c in checks):
        bad.append("no slot was recycled")
    want = {name: want[name] for name in COUNTED}
    log(f"  launches {counts}; expected {want}; flash_decode by (B, H, K, D,"
        f" T) {dict(by_shape)}")
    if counts != want:
        bad.append("the launch counts differ from blocks x decode steps /"
                   " prefills")
    if not set(by_shape) <= set(SERVE_SHAPES):
        bad.append(f"shapes {sorted(by_shape)} were not checked in phase 3")
    done = [r for eng in pools.values() for r in eng.completed]
    once = sorted(r.rid for r in done) == list(range(n_requests))
    left = {name: sum(len(getattr(e, name)) for e in pools.values())
            for name in ("overflowed", "escalated")}
    n_preempted = sum(e.preempted for e in pools.values())
    log(f"  every request completed exactly once: {once}; overflowed"
        f" {left['overflowed']}, escalated {left['escalated']}, preempted"
        f" {n_preempted}")
    if not once:
        bad.append("a request did not complete exactly once")
    if (outbox and not left[outbox]) or (preempted and not n_preempted):
        bad.append("no request took the path this run exists for")
    if outbox:
        metered = sum(e.meter.tokens for e in pools.values())
        earned = sum(r.n_generated - 1 for r in done)
        log(f"  metered tokens over the pools {metered}, sum of n_generated"
            f" - 1 over the completed requests {earned}")
        if metered != earned:
            bad.append("evicted tokens were not backed out of the meters")
    log(f"  {tag} wall {wall:.1f} s, of which {check_s:.1f} s in the"
        f" recycled-slot checks")
    if bad:
        raise SystemExit(f"phase 10 {tag}: {bad}")
    return counts, by_shape, wall - check_s


def phase_10(llama, zamba2, granite):
    """10a-10c over the weights of earlier phases.  Returns the launches,
    flash_decode launches by shape and the serve walls (checks excluded)."""
    counts, by_shape, walls = Counter(), Counter(), {}

    def add(tag, out):
        counts.update(out[0])
        by_shape.update(out[1])
        walls[tag] = out[2]

    cfg, params = llama
    llama_check = Recycled(cfg, params, LOGIT_REL_BOUND)
    log("[10a] overflow migration with timed arrivals, llama31-8b:"
        f" {PRESSURE_REQUESTS} demo requests, short {SHORT_POOL} evicting"
        f" at its window, long {LONG_POOL}, Poisson arrivals at"
        f" {ARRIVAL_RATE}/s")
    add("10a", phase_pressure(
        "10a", lambda make: run_overflow(make, traffic_overflow(cfg.vocab)),
        {"short": (cfg, params, llama_check),
         "long": (cfg, params, llama_check)},
        PRESSURE_REQUESTS, outbox="overflowed"))
    for name, (mcfg, mparams) in (("llama31-8b", llama),
                                  ("zamba2-2.7b", zamba2)):
        log(f"[10b] preemption, {name}: {PREEMPT_REQUESTS} ragged requests"
            f" in {SHORT_POOL}, {PREEMPT_STEPS} steps, shrink({PREEMPT_KEEP})")
        # zamba2 as phase 6 holds it: kernel vs plain on float32 copies
        f32 = None if name == "llama31-8b" else to_f32(mcfg, mparams)
        check = Recycled(mcfg, mparams, LOGIT_REL_BOUND, f32)
        add(f"10b {name}", phase_pressure(
            f"10b {name}",
            lambda make: run_preempt(make, traffic_preempt(mcfg.vocab)),
            {"short": (mcfg, mparams, check)}, PREEMPT_REQUESTS,
            preempted=True))
        del f32, check
    gcfg, gparams = granite
    vocab = min(gcfg.vocab, cfg.vocab)
    streamed = {"small": gcfg.analytical_spec().streamed_params,
                "large": cfg.analytical_spec().streamed_params}
    seed = escalating_seed(lambda: traffic_semantic(vocab), streamed)
    log(f"[10c] semantic escalation: small {gcfg.name} {SHORT_POOL},"
        f" large {cfg.name} {LONG_POOL}, {SEMANTIC}, misroute_seed {seed}"
        f" (the first whose analytical replay escalates)")
    add("10c", phase_pressure(
        "10c", lambda make: run_semantic(make, traffic_semantic(vocab), seed),
        {"small": (gcfg, gparams, Recycled(
            gcfg, gparams, MOE_LOGIT_REL_BOUND["float32"],
            to_f32(gcfg, gparams))),
         "large": (cfg, params, Recycled(cfg, params, LOGIT_REL_BOUND))},
        SERVE["requests"], outbox="escalated"))
    return counts, by_shape, walls


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
    counts, by_shape, _, _, steps = phase_serve(cfg, params)
    launches.update(counts)
    fd_launches.update(by_shape)
    llama = (cfg, params)       # phase 10 serves these weights again

    scan_rows, scan_launches, scan_err_max = {}, {}, {}
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    for name, (kind, _) in SSM.items():
        log(f"[6] model: {name}, full width")
        cfg, params = load_model(name)
        with torch.inference_mode():
            phase_ssm_model(name, cfg, params)
        log(f"[7] serve {name}: " + json.dumps(SERVE))
        counts, by_shape, by_len, per_prefill, _ = phase_serve(cfg, params)
        launches.update(counts)
        fd_launches.update(by_shape)
        if name == "zamba2-2.7b":
            zamba2 = (cfg, params)
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
        for S in sorted(per):
            r = scan_rows[kind][S]
            log(f"  timing {kind} S={S}: device_ms {r['device_ms']:.5f}"
                f" ms {r['ms']:.5f} bound_ms {r['bound_ms']:.5f}"
                f" ({r['bound_by']}) plain_ms {r['plain_ms']:.3f}"
                f" launches/call {r['launches_per_call']} blocks"
                f" {r['blocks']} serve launches {r['serve_launches']}")
    log(f"[8] model: {MOE_ARCH}, full width")
    cfg, params = load_model(MOE_ARCH)
    with torch.inference_mode():
        phase_moe_model(cfg, params)
    log(f"[9] serve {MOE_ARCH}: " + json.dumps(SERVE))
    counts, by_shape, _, _, moe_steps = phase_serve(cfg, params)
    launches.update(counts)
    fd_launches.update(by_shape)
    log(f"  {moe_steps} decode steps, as llama31-8b's {steps} (the same"
        f" traffic gives the same lengths)")
    if moe_steps != steps:
        raise SystemExit("granite's serve took other decode steps than"
                         " llama31-8b's on the same traffic")
    granite = (cfg, params)
    del params
    t10 = time.perf_counter()
    counts, by_shape, walls = phase_10(llama, zamba2, granite)
    launches.update(counts)
    fd_launches.update(by_shape)
    log(f"phase 10: {time.perf_counter() - t10:.1f} s; serve walls without"
        f" the recycled-slot checks {json.dumps(walls)}")
    del llama, zamba2, granite
    torch.cuda.empty_cache()
    log(f"total {time.perf_counter() - t_start:.1f} s,"
        f" peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    for shape, n in fd_launches.items():
        fd_rows[shape]["serve_launches"] = n
    fd_mean = weighted(fd_rows, fd_launches)
    for key in ("device_ms", "library_ms", "library_device_ms"):
        fd_mean[key] = sum(n * fd_rows[s][key]
                           for s, n in fd_launches.items()) \
            / sum(fd_launches.values())
    int8_mean = weighted(int8_rows, {s: 1 for s in MAIN})
    int8_mean["device_ms"] = sum(int8_rows[s]["device_ms"]
                                 for s in MAIN) / len(MAIN)
    int8_mean["bound_share"] = int8_mean["bound_ms"] / int8_mean["device_ms"]
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
             **int8_mean, library_ms=None, dtype="bfloat16",
             library_note="no one PyTorch call computes attention over an"
                          " int8 cache with per-row scales; flash_decode and"
                          " SDPA on the bf16 cache are in by_shape",
             mean_over="the four MAIN shapes, equally weighted",
             by_shape=list(int8_rows.values()))]
    for kind, line in (("mamba_scan", 57), ("wkv6", 64)):
        rows, per = scan_rows[kind], scan_launches[kind]
        mean = weighted(rows, per)
        mean["device_ms"] = sum(n * rows[S]["device_ms"]
                                for S, n in per.items()) / sum(per.values())
        kernels.append(dict(
            name=kind, route="cuda", source=f"src/repro_torch/csrc/{kind}.cu",
            replaces=f"src/repro/kernels/{kind}.py:{line}",
            launches=launches[kind], max_abs_err=scan_err_max[kind],
            **mean, library_ms=None, dtype="float32",
            by_shape=list(rows.values())))
    if any(k["launches"] == 0 for k in kernels):
        raise SystemExit("a kernel of the main path was never launched")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
