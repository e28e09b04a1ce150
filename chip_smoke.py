#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one card.

  python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device   the card's name and power limit (nvidia-smi);
  2. build    the CUDA flash-decode kernel from src/repro_torch/csrc;
  3. kernel   the kernel against its plain PyTorch version at the JAX
              package's sweep shapes, the serve path's two shapes (short
              pool 16 slots x 256, long pool 4 x 1024) and two larger ones,
              float32 and bfloat16 at the limits of TOL; masked entries
              overwritten with +-999 leave the output unchanged; a planted
              fault (every length one short) must fail the bfloat16 limit;
              times at those shapes (CUDA events, warmed up, inputs cycled
              through more than the 50 MB L2), beside the byte bound and
              one SDPA call as the library yardstick;
  4. model    llama31-8b at full width and depth (bf16, seeded random
              weights): ragged prompts prefilled, one decode step through
              the kernel and one through the plain attention on the same
              cache, logits compared within a stated bound; a planted
              fault (attention that skips the last 64-row tile) must
              exceed that bound;
  5. serve    `run_policies` at full width over homo / two_pool / fleetopt;
              every request completes, the kernel's launch count equals
              32 layers x the decode steps taken, and every pool's shape is
              one that phase 3 checked and timed;
then one JSON line of kernel numbers (times averaged over the serve path's
shapes, weighted by its launches at each) and, last, the device line.

Needs one CUDA card; exits non-zero without one.  float32 matmuls stay full
precision: TF32 is turned off for matmuls and cuDNN.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_decode import build, flash_decode  # noqa: E402
from repro_torch.kernels.ref import flash_decode_ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

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
# the shapes the serve phase gives the kernel (batch = a pool's slots,
# T = its window): short pool 16 x 256, long pool 4 x 1024
MAIN = [(16, 32, 8, 128, 256), (4, 32, 8, 128, 1024)]
EXTRA = [(16, 32, 8, 128, 1024), (16, 32, 8, 128, 8192)]
RAGGED_T = (16, 32, 8, 128, 1000)       # T a multiple of no tile or piece
L2_BYTES = 50e6
# llama31-8b decode, kernel vs plain attention on one cache: the two differ
# only in the order of f32 sums inside attention before the bf16 rounding
# (a bf16 step is 2^-8 ~ 3.9e-3 relative), carried through 32 layers
LOGIT_REL_BOUND = 5e-2
SKIP_ROWS = 64                          # the planted fault's dropped tile
SERVE = dict(workload="azure-conv", requests=16, b_short=128,
             window_long=1024)


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
    t_b, t_o = nbytes / HBM_BPS, flops / PEAK_FLOPS[q.dtype]
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
    sets = [(q, k, v, lengths)] + [
        inputs(*shape, dtype, gen)
        for _ in range(max(1, math.ceil(3 * L2_BYTES / per_set)) - 1)]
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


def phase_device():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(out.splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda}"
        f" device {torch.cuda.get_device_name(0)}")


def phase_build():
    t0 = time.perf_counter()
    path, build_log = build()
    log(f"build: {path.name} in {time.perf_counter() - t0:.2f} s")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"  ptxas: {line.strip()}")


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
    return max(errs[(s, torch.bfloat16)] for s in MAIN), rows


def phase_model(cfg, params):
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    plens, T = (37, 300, 600, 1000), 1024
    cache = M.init_cache(cfg, len(plens), T, device=DEVICE)
    first = []
    for slot, plen in enumerate(plens):
        prompt = torch.randint(0, cfg.vocab, (1, plen), generator=gen,
                               device=DEVICE)
        logits, pc = M.forward(params, cfg, prompt, mode="prefill")
        for name, c in pc.items():
            for key in ("k", "v"):
                cache[name][key][:, slot, :plen] = c[key][:, 0]
        first.append(int(logits[0, -1].argmax()))
    tokens = torch.tensor(first, device=DEVICE)[:, None]
    pos = np.array(plens)

    def clone():
        return {n: {k: t.clone() for k, t in c.items()}
                for n, c in cache.items()}

    def skip_tile(q, k, v, lengths, *, impl=None):
        return real(q, k, v, (lengths - SKIP_ROWS).clamp(min=1), impl=impl)

    a, _ = M.decode_step(params, cfg, tokens, clone(), pos)
    b, _ = M.decode_step(params, cfg, tokens, clone(), pos, impl="plain")
    real, ops.decode_attention = ops.decode_attention, skip_tile
    try:
        c, _ = M.decode_step(params, cfg, tokens, clone(), pos)
    finally:
        ops.decode_attention = real
    a, b, c = a[:, 0].float(), b[:, 0].float(), c[:, 0].float()
    if a.shape != (len(plens), cfg.vocab) or not bool(torch.isfinite(a).all()):
        raise SystemExit(f"decode logits malformed: {tuple(a.shape)}")
    scale = b.abs().amax(-1)
    rel = ((a - b).abs().amax(-1) / scale).tolist()
    rel_fault = ((c - b).abs().amax(-1) / scale).tolist()
    # a top-1 that differs must be a near-tie of the plain logits: its
    # top-1/top-2 gap within twice the largest difference of that sequence
    top2 = b.topk(2, -1).values
    gap = (top2[:, 0] - top2[:, 1]).tolist()
    agree = (a.argmax(-1) == b.argmax(-1)).tolist()
    d_max = (a - b).abs().amax(-1).tolist()
    log(f"  decode logits at positions {list(plens)}, per sequence:"
        f" max|d|/max|logits| kernel vs plain"
        f" {[f'{r:.3e}' for r in rel]} (bound {LOGIT_REL_BOUND});"
        f" top-1 equal {agree}, plain top-1/top-2 gap"
        f" {[f'{g:.3e}' for g in gap]}")
    log(f"  control, attention skipping the last {SKIP_ROWS}-row tile:"
        f" max|d|/max|logits| {[f'{r:.3e}' for r in rel_fault]}"
        f" (must exceed {LOGIT_REL_BOUND})")
    if max(rel) > LOGIT_REL_BOUND:
        raise SystemExit("full-width decode disagrees with its plain twin")
    if not all(ok or g <= 2 * d for ok, g, d in zip(agree, gap, d_max)):
        raise SystemExit("a top-1 token differs where the plain logits"
                         " have no near-tie")
    if min(rel_fault) <= LOGIT_REL_BOUND:
        raise SystemExit("the logits bound does not catch a skipped tile")


def phase_serve(cfg, params):
    flash_decode.launches = 0
    t0 = time.perf_counter()
    res = serve.run_policies(cfg, params, **SERVE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_decode.launches
    steps = 0
    by_shape = {}
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
            steps += eng.decode_steps
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
    n_attn = cfg.attn_block_count
    log(f"  flash_decode launches {launches} = {n_attn} x {steps} decode"
        f" steps: {launches == n_attn * steps}")
    if steps == 0 or launches != n_attn * steps:
        raise SystemExit("the serve path did not go through the kernel once"
                         " per layer per decode step")
    if not set(by_shape) <= set(MAIN):
        raise SystemExit(f"the serve path gave the kernel shapes"
                         f" {sorted(by_shape)}, not all checked and timed"
                         f" (MAIN {MAIN})")
    log(f"  launches by (B, H, K, D, T): {by_shape}")
    return launches, by_shape


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
    max_err, rows = phase_kernel()
    log("[4] model: llama31-8b, full width")
    cfg = get_config("llama31-8b")
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                           DEVICE)
    torch.cuda.synchronize()
    log(f"  init {cfg.n_repeat} layers d={cfg.d_model} vocab={cfg.vocab}"
        f" {cfg.dtype}: {time.perf_counter() - t0:.1f} s,"
        f" {torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    with torch.inference_mode():
        phase_model(cfg, params)
    log("[5] serve: " + json.dumps(SERVE))
    launches, by_shape = phase_serve(cfg, params)
    log(f"total {time.perf_counter() - t_start:.1f} s,"
        f" peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    # per-launch means over the serve path's shapes, each weighted by the
    # launches the serve phase made at it
    for shape, n in by_shape.items():
        rows[shape]["serve_launches"] = n

    def mean(key):
        return sum(n * rows[s][key] for s, n in by_shape.items()) / launches

    most = max(by_shape, key=by_shape.get)
    kernel = dict(
        name="flash_decode", route="cuda",
        source="src/repro_torch/csrc/flash_decode.cu",
        replaces="src/repro/kernels/flash_decode.py:61",
        launches=launches, max_abs_err=max_err, ms=mean("ms"),
        plain_ms=mean("plain_ms"), bound_ms=mean("bound_ms"),
        bound_by=rows[most]["bound_by"],
        library_ms=mean("library_ms"), dtype="bfloat16",
        by_shape=list(rows.values()))
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
