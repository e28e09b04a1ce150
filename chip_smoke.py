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
              4 x 1024), phase 14's two decode shapes (whisper-medium G=1
              D=64, llava-next-34b G=7 D=128), two larger
              ones, the ragged T and the paper's 64K window (4 x 65536),
              float32 and bfloat16 at the limits of TOL; at each, the
              kernel's softmax state (return_lse) within LSE_TOL of the
              plain version's, and the f32 output that comes with it
              rounded to the dtype equal to the output; masked entries
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
              weights): ragged prompts prefilled (the S = 1000 prefill's
              peak device memory over what was allocated before it printed
              beside the bytes of the cache it returns), one decode step
              through the kernel and one through the plain attention on the same
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
  11. fleetscope  FleetScope (serving.telemetry) on the card: 10a's and
              10c's traffic served again at full width with every
              model-mode engine traced by `attach_trace` into a
              TraceRecorder at level "detail" (11a llama31-8b fleetopt,
              11b granite small / llama large), and through analytical
              twins traced alike; counts set to 0 just before, read just
              after.  Each run: golden streams, event counts and every
              pool's energy by phase equal the analytical replay's
              exactly; the schedule (meters, stats(), decode steps,
              per-request times) equals both the replay's and phase 10's
              untraced run's; the launches equal phase 10's for the same
              traffic (tracing adds none); the charge channel reconciles
              with the meters within 1e-9 relative in every phase; no
              meter breaks `conservation_violations`; exactly one overflow
              (11a) or one escalate event per escalated request (11b), the
              same requests phase 10 evicted.  The traced wall per decode
              step is printed beside phase 10's untraced one (reported,
              not gated), and the timeline and Perfetto document of each
              model-mode run are built, the document written to
              build/chip_smoke/.  11c (host): the port's FleetSim, traced
              at level detail, on the unconstrained azure-conv fleetopt
              cell of benchmarks/results/fleet_sim.json (H100 Llama-70B
              profile, 1000 requests, seed 0), its row equal to the
              committed one, reconciled within 1e-9 and conserving;
  12. drain   the compiled fleet drain (serving.graph_engine,
              engine="graph": float64 torch steps replayed as CUDA graphs;
              no hand-written kernel) on the card: 12a one Table E cell of
              each of its five families on each of its four chips (the
              first of each in tools/port_fleet_bench.py's grid_cells, 400
              requests, seed 0), drained by run_fleet_grid with the shape
              classes under "graph" and under the numpy engine: every pool
              of every cell equal (integer and ordering fields exact,
              meters and times at rtol 1e-9, atol 1e-12, the reference
              drain tests' `_assert_parity`), and every rounded row equal
              to benchmarks/results/fleet_grid.json's; 12b one shape class
              drained by eager steps on the card and by graph replays,
              every array of the final state bit-equal; 12c a traced
              (lifecycle) FleetSim(engine="graph") on fleet_sim.json's
              azure-conv fleetopt cell (1000 requests, seed 0): counts
              and every request's event sequence equal numpy's, times at
              rtol 1e-9; 12d a planted fault made from the unchanged
              module (coast's closed-form spans charged without idle
              power) must fail 12a's gate on the fleetopt cells; 12e the
              graph card wall and the numpy host wall per family, named,
              beside the card's name and power limit;
  13. search  the topology search of tools/port_fleet_bench.py --only
              topology (the quick topology_search_bench: azure-conv, 1500
              requests, budget 10, seed 0, over one frozen trace) run with
              engine="graph" on the card and engine="numpy" on the host:
              13a the 5 rows (4 hand-built fleets and the searched one)
              equal benchmarks/results/topology_search.json's, meta
              included, under both; the search's history equals numpy's
              entry for entry (eval, spec_hash, label, score, compliant,
              error), no entry carries an error, evaluations, restarts and
              the winner equal; every spec sized in either run (the
              hand-built ones and every evaluation) gives equal
              SLOSizingResults: plan.instances, every round's instances,
              violators and budget and compliance exactly, the measured
              TTFT p99, tok/W and round metrics at rtol 1e-9; and the same
              for three fleet shapes the search's budget does not reach (a
              disaggregated ladder, the small-model rung, a chip-mixed
              ladder); 13b 12d's planted fault on the graph drain of the
              search's seed spec (multipool K=3) must fail 13a's gate; 13c
              the graph card wall and the numpy host wall of the search,
              the CUDA graphs it captured and the SLO rounds of each spec,
              beside the card's name and power limit; 13d every suite of
              tools/port_paper_tables.py on the card's host, each
              returning rows, its derived string printed;
  14. train   training on the card (TF32 off, as everywhere here):
              14a one reduced float32 config of each training family
              (TRAIN_ARCHS: yi-6b, granite-moe-1b-a400m at capacity 0.5,
              whisper-medium, llava-next-34b), one `make_train_step` from
              the same `init_params` draw and `batch_iterator` batch on
              the card's host CPU and on the card: the loss, every
              gradient leaf and every updated leaf within the tolerances
              tests/test_torch_training.py states against JAX; two planted
              faults made from the unchanged modules on the card side
              (whisper's frames, llava's patches rolled by one along the
              batch) must fail that gate;
              14b `launch/train.py`'s path at the reference's ~100M demo
              (DEMO_ARGS: yi-6b, preset 100m, 100 steps, batch 8 x 128, lr
              2e-3): the last logged loss >= 1 nat below the first (the
              reference test's criterion), the checkpoint written,
              reloaded bit-equal, its keys those of
              `to_reference_layout`;
              14c granite-moe-1b-a400m at full width and depth, bf16,
              capacity 1.25: 10 AdamW steps at batch 4 x 512, every loss,
              grad_norm and aux loss finite, step 9's loss below step 0's,
              assignments dropped; peak memory, wall per step and the
              dropped share printed;
              14d whisper-medium at full width and depth (24 + 24 layers,
              1500 frames, bf16): one train step at batch 2 x 64, every
              encoder weight the loss reads with a finite, nonzero
              gradient (it reaches the encoder only through
              cross-attention); then, under no_grad, a 16-token prefill
              and 8 decode steps through flash_decode, each against the
              plain attention on the same cache within LOGIT_REL_BOUND,
              the cross-attention cache equal to encode_cross_kv of the
              encoder output, launches exactly 24 x 8;
              14e llava-next-34b at full width, depth cut to 2 repeats:
              2880 patches and a 32-token prompt prefilled, 4 decode steps
              at positions offset by n_patches through flash_decode (G =
              7, D = 128) against plain, launches exactly 2 x 4;
              then phase 14's flash_decode launches and shapes on a line
              (the shapes must be those phase 3 checked),
              and its walls beside the card's name and power limit;
  15. ssm train  zamba2 and rwkv6 trained on the card through the chunk
              scans of models/ssm.py (TF32 off):
              15a zamba2-2.7b and rwkv6-1.6b reduced in float32, one
              `make_train_step` on the card's host CPU and on the card at
              batch 2 x 160 (two 128-token Mamba2 chunks, ten 16-token
              RWKV6 blocks), held at 14a's bounds, every count set to 0
              just before the card's step and read just after: no kernel
              launched; a planted fault made from the unchanged module
              (SSM_FAULT: `_carry` hands each chunk a zero state) must
              pass a bound SSM_FAULT_FACTOR times or more; each scan
              wrapper called with grad raises the no-backward RuntimeError
              and launches nothing; a no_grad prefill of the same tokens
              launches each scan exactly once per block;
              15b each chunk scan at its model's full width and 15c's
              batch (Mamba2 (4, 512, 80, 64, 64), RWKV6 (4, 512, 32, 64)
              at w in [0.05, 1) and [0.05, 0.06]) against the sequential
              plain scan on the card: y and the final state within
              tests/models/test_ssm_blocks.py's limits (CHUNK_SCAN_TOL),
              autograd's gradient of every input within GRAD_REL of its
              max|g|, all finite; the wall of one forward and backward;
              15c zamba2-2.7b (45 Mamba2 blocks + 9 shared attention / MLP)
              and rwkv6-1.6b (24 blocks) at full width and depth, bf16: 10
              AdamW steps at 14c's batch 4 x 512, every loss, grad_norm and
              updated weight finite, step 9's loss below step 0's, no
              kernel launched; peak memory and the wall of each step; then,
              under no_grad, the trained weights prefill a 4 x 512 batch
              through the scan kernel (bf16: finite, one launch a block)
              and on a float32 copy through the kernel and through
              impl="plain", last logits within SCAN_LOGIT_BOUND;
              15d `launch/train.py --arch <each> --preset 10m --steps 100
              --batch 8 --seq 128 --lr 2e-3`: as 14b, the last logged loss
              >= 1 nat below the first, the checkpoint reloaded bit-equal
              with `to_reference_layout`'s keys;
              then phase 15's walls beside the card's name and power limit;
  16. distribution  the distribution layer (launch/{mesh,sharding,
              dryrun}.py, the model's `constrain` sites, DTensor arguments
              of kernels/ops.py):
              16a on the card's host, DIST_PAIRS (one pair per rule of
              tests/launch/test_sharding_rules.py, full size, 16 x 16 and
              three at 2 x 16 x 16) traced by `dryrun.run_pair` on the fake
              production mesh, DIST_WORKERS processes at once: each `ok`,
              its traced argument bytes equal to the rules'
              (`dryrun.argument_bytes`), DIST_FIT's pairs with
              fits_h100 (pure DP on 2 x 16 x 16, a 32K prefill whose KV
              heads do not divide `model`), DIST_CEIL's at or under their
              ceilings (the 32K prefills of granite's head, whole on every
              rank, zamba2's Mamba2 blocks and granite-moe's combine,
              ROADMAP C18-C20, C22), DIST_FLOPS' flops a rank at or under
              theirs (each `model` rank on its share of the heads: GQA
              whose KV heads do not divide `model`, zamba2's Mamba2
              heads, C21-C22) and DIST_COLL's collective bytes a device at
              or under theirs (grok's decode, C23);
              per pair the trace wall,
              arguments and peak GiB per device, fits_h100, the roofline
              terms and collective bytes by kind; a planted fault (DIST_FAULT:
              `model` on a dimension it does not divide) must raise in
              `sharding.distribute`;
              16b on the card, a (1, 1) ("data", "model") mesh over an NCCL
              group of one rank (a FileStore under build/): llama31-8b and
              granite-moe-1b-a400m decode one step at the short pool's
              16 x 256 and zamba2-2.7b prefills a DIST_PROMPT-token prompt,
              at full width and depth, once on plain tensors and once on
              DTensors placed by `param_specs(mode="serve")` /
              `cache_specs`: logits, caches and states bit-equal, the same
              flash_decode / mamba_scan launches in each (counts set to 0
              before each step, read after), twice (cold, warm), the walls
              printed side by side (DTensor's host cost); then one
              train step (`loss_and_grads`) of llama31-8b at full width
              and DIST_TRAIN's depth and batch, once on plain tensors and
              once on DTensors placed by `param_specs(mode="train")` /
              `batch_specs` (the loss through the vocab-parallel
              cross-entropy, `models/model.py` `_VocabParallelCE`): the
              loss and every gradient leaf bit-equal (deterministic
              algorithms on for the two steps), no kernel launched;
              16c on the card, llama31-8b's decode at the short and long
              pools' shapes (SEQ_SHAPES, bf16) with its cache cut into 2
              and 4 T-pieces, as ranks hold a sequence-sharded cache: each
              piece through ops.decode_piece (the kernel at local lengths,
              its f32 output and lse), the pieces' states stacked and
              merged by ops.merge_states, the merge that ops.merge_ranks
              runs on each rank, its two all-reduces a reduction over the
              stack (ops.reduce_stacked), within TOL of the unsliced
              kernel and of the plain version; pieces that a short
              sequence leaves empty; exactly one launch a piece (counts
              set to 0 just before, read just after); eager ms beside the
              unsliced call's;
  17. examples  examples/port_serve_demo.py and examples/port_train_demo.py
              (the twins of the reference's serve_demo.py / train_demo.py,
              which wrap `python -m repro_torch.launch.{serve,train}` with
              the reference's default arguments) run as subprocesses on
              the card: each must exit 0 within EXAMPLE_TIMEOUT s; their
              last lines and walls are printed;
then one JSON line of kernel numbers (times averaged over the serve
paths' shapes, weighted by their launches at each, flash_decode's and the
scans' also as device_ms, flash_decode's library_device_ms; prefill walls
in phase 6 are each the median of 3 after one warm-up prefill at the same
length; flash_decode_int8, which no serve path
launches, over the four MAIN shapes equally, with its device_ms and the
share of its bound, its launches those of phase 4; launches count phases
5, 7, 9, 10 and 11, the scans' means weight phase 7's prompt lengths) and,
last, the device line.

Needs one CUDA card; exits non-zero without one.  float32 matmuls stay full
precision: TF32 is turned off for matmuls and cuDNN.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import multiprocessing
import subprocess
import sys
import time
import types
from collections import Counter
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
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
from repro_torch.core import topo_search as TS  # noqa: E402
from repro_torch.core.modelspec import LLAMA31_8B, LLAMA31_70B  # noqa: E402
from repro_torch.core.profiles import (B200_LLAMA70B_FLEET,  # noqa: E402
                                       H100_LLAMA70B, H200_LLAMA70B,
                                       computed_profile)
from repro_torch.core.routing import LONG_WINDOW  # noqa: E402
from repro_torch.core.slo import SLOSpec, size_to_slo_spec  # noqa: E402
from repro_torch.core.topospec import TopologySpec  # noqa: E402
from repro_torch.core.workloads import WORKLOADS  # noqa: E402
from repro_torch.data import batch_iterator  # noqa: E402
from repro_torch.launch import dryrun as DRY  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import (make_local_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.launch.shapes import SHAPES  # noqa: E402
from repro_torch.launch.sharding import (batch_specs,  # noqa: E402
                                         cache_specs, distribute,
                                         param_specs)
from repro_torch.models.common import set_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.attention import encode_cross_kv  # noqa: E402
from repro_torch.models.convert import (flatten_paths,  # noqa: E402
                                        to_reference_layout)
from repro_torch.models.common import rms_norm, silu  # noqa: E402
from repro_torch.models import ssm as ssm_blocks  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ContextRouter, PoolEngine, Request, RouterPolicy, SimVsAnalytical,
    TraceRecorder, analytical_decode_tok_per_watt, build_timeline,
    conservation_violations, prepare_spec, reconcile_energy, run_fleet_grid,
    sample_trace, to_perfetto)
from repro_torch.serving import graph_engine as GE  # noqa: E402
from repro_torch.training import (AdamW, load_checkpoint,  # noqa: E402
                                  make_train_step)
from repro_torch.training.optimizer import tree_leaves, tree_map  # noqa: E402
from repro_torch.training.train import batch_to, loss_and_grads  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
import port_fleet_bench as PFB  # noqa: E402
import port_paper_tables as PPT  # noqa: E402

ROOT = Path(__file__).resolve().parent
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
# the softmax state lse = ln sum_t exp(s_t) of the kernel (base 2 inside:
# (m + log2 l) ln 2, its exponentials the SFU's ex2 at ~2^-22 relative)
# against torch.logsumexp on the same f32 scores: f32 summation order over
# at most 65536 rows
LSE_TOL = dict(atol=1e-4, rtol=1e-5)
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
# Phase 14 ("train").  14a: one reduced float32 config of each training
# family, one train step on the card's host CPU and on the card from the
# same weights and batch, held to the tolerances tests/test_torch_training.py
# states against JAX: the loss within LOSS_ATOL, every gradient leaf within
# GRAD_REL of its max|g|, every updated leaf within STEP_ATOL except where
# the CPU's gradient is within NOISE_REL of its leaf's max (Adam's first
# step moves such an element by +-lr, either sign: 2 lr apart at most).
# granite-moe at capacity 0.5, so that the dispatch drops.
TRAIN_ARCHS = ("yi-6b", "granite-moe-1b-a400m", "whisper-medium",
               "llava-next-34b")
TRAIN_CHANGES = {"granite-moe-1b-a400m": dict(capacity_factor=0.5)}
TRAIN_BATCH = dict(batch=2, seq=24)
TRAIN_OPT = dict(lr=1e-3, total_steps=10)
LOSS_ATOL, GRAD_REL, STEP_ATOL, NOISE_REL = 1e-5, 1e-4, 1e-6, 1e-3
# the planted faults, made from the unchanged modules, card side only
TRAIN_FAULTS = {"whisper-medium": "frames rolled by one along the batch",
                "llava-next-34b": "patches rolled by one along the batch"}
# 14b: the reference's ~100M-parameter demo ("paper-scale" preset) with
# tests/training/test_training.py's lr, and that test's criterion: the last
# logged loss at least DEMO_FALL nats below the first
DEMO_ARGS = ["--arch", "yi-6b", "--preset", "100m", "--steps", "100",
             "--batch", "8", "--seq", "128", "--lr", "2e-3"]
DEMO_FALL = 1.0
# 14c: granite-moe at full width and depth, bf16, its own capacity 1.25;
# lr 2e-3 as 14b, a 2-step warmup so that 10 steps train
MOE_TRAIN = dict(batch=4, seq=512, steps=10,
                 opt=dict(lr=2e-3, warmup_steps=2, total_steps=10))
# 14d: whisper-medium at full width and depth, bf16 weights, f32 frames
WHISPER_TRAIN = dict(batch=2, seq=64)
ENC_PROMPT, ENC_DECODE_STEPS = 16, 8
# 14e: llava-next-34b at full width, depth cut to 2 repeats (34.4 B
# parameters do not fit one card); its 2880 patches and a 32-token prompt
LLAVA_REPEATS, LLAVA_BATCH, LLAVA_PROMPT, LLAVA_DECODE_STEPS = 2, 2, 32, 4
# the shapes 14d and 14e give flash_decode, checked in phase 3 beside the
# serve shapes: whisper-medium (G = 1, D = 64) and llava-next-34b (G = 7,
# the first group that is not a power of two, D = 128), B = the batch, T =
# the prompt (and llava's patches) plus the decode steps
TRAIN_DECODE_SHAPES = [
    (WHISPER_TRAIN["batch"], 16, 16, 64, ENC_PROMPT + ENC_DECODE_STEPS),
    (LLAVA_BATCH, 56, 8, 128, 2880 + LLAVA_PROMPT + LLAVA_DECODE_STEPS)]
# Phase 15 ("SSM training").  15a: zamba2 and rwkv6 reduced in float32,
# one train step on the card's host CPU and on the card at 14a's bounds,
# at 2 x 160 tokens: two of Mamba2's 128-token chunks, ten of the RWKV6
# scan's 16-token blocks (three 64-token chunks); the planted fault, made
# from the unchanged module, must pass a bound by SSM_FAULT_FACTOR or more.
SSM_TRAIN_BATCH = dict(batch=2, seq=160)
SSM_FAULT = "the chunk scans' carried state zeroed at each chunk boundary"
SSM_FAULT_FACTOR = 10.0
# a direct call of each scan wrapper with grad (tiny inputs)
GUARD_SHAPE = {"mamba_scan": (1, 6, 2, 8, 8), "wkv6": (1, 6, 2, 8)}
# 15b: each chunk scan at its model's full width (zamba2: nh 80, hd = ds =
# 64; rwkv6: H 32, hd 64) at 15c's batch 4 x 512, against the sequential
# plain scan on the card: y and the final state within
# tests/models/test_ssm_blocks.py's limits (Mamba atol 5e-4, WKV atol 2e-3
# and rtol 1e-3, elementwise), every input's gradient within GRAD_REL of
# its max|g|; wkv6 at w in [0.05, 1) and the strongest decay [0.05, 0.06]
# (C2)
CHUNK_SCAN_SHAPES = {"mamba2": (4, 512, 80, 64, 64), "wkv6": (4, 512, 32, 64)}
CHUNK_SCAN_W = ((0.05, 1.0), (0.05, 0.06))
CHUNK_SCAN_TOL = {"mamba2": dict(atol=5e-4, rtol=0.0),
                  "wkv6": dict(atol=2e-3, rtol=1e-3)}
# 15c: both at full width and depth, bf16, 14c's batch, steps and AdamW
SSM_TRAIN = MOE_TRAIN
# 15d: the launcher at the reference's "10m" preset, 14b's other arguments
SSM_DEMO_ARGS = ["--preset", "10m", "--steps", "100", "--batch", "8",
                 "--seq", "128", "--lr", "2e-3"]
# phase 16: the dry run's pairs on the host (16a), each with the rule of
# tests/launch/test_sharding_rules.py it exercises, and the card's steps
# on a (1, 1) mesh (16b)
DIST_PAIRS = [      # the longest trace first: the pool's wall is its own
    ("llama31-70b", "train_4k", False,
     "FSDP + TP, sequence-parallel residual (> 3e10 params)"),
    ("granite-3-8b", "prefill_32k", True,
     "the 2 x 16 x 16 mesh: a vocab that does not divide model, the head"
     " whole on every rank"),
    ("granite-3-8b", "prefill_32k", False,
     "GQA, 8 KV heads < 16: q heads split by KV group over model"),
    ("zamba2-2.7b", "prefill_32k", False,
     "Mamba2 blocks over 32K tokens, their heads split on model"),
    ("granite-moe-1b-a400m", "prefill_32k", False,
     "32K-token MoE dispatch and combine, experts on model"),
    ("yi-6b", "decode_32k", False,
     "KV sequence-sharded on model (4 KV heads < 16)"),
    ("zamba2-2.7b", "decode_32k", False, "KV heads on model (32 KV heads)"),
    ("zamba2-2.7b", "long_500k", False,
     "batch 1: hybrid SSM states and KV unsharded by batch"),
    ("h2o-danube-3-4b", "long_500k", False,
     "context parallel: KV sequence on data+model"),
    ("granite-moe-1b-a400m", "train_4k", False,
     "pure DP: batch over data+model, 256 dispatch groups, experts"
     " replicated"),
    ("grok-1-314b", "decode_32k", False,
     "serve keeps FSDP (314 B params), TP inside its 8 experts"),
    ("llava-next-34b", "prefill_32k", False,
     "serve drops FSDP (34 B), 2880-patch prefix, 7 q heads a KV group"
     " straddling 2 ranks: q rows split over model"),
    ("whisper-medium", "decode_32k", False,
     "encoder-decoder: cross-attention cache, KV heads on model"),
    ("whisper-medium", "decode_32k", True,
     "the 2 x 16 x 16 mesh: batch over pod+data"),
    ("granite-moe-1b-a400m", "train_4k", True,
     "pure DP on 2 x 16 x 16: batch 256 over data+model, pod holding it"
     " twice"),
]
# 16a's pairs that must fit one card's 80 GiB: a pure-DP batch that does
# not divide the mesh (C17), a 32K prefill's caches written sharded (C16)
DIST_FIT = {("granite-moe-1b-a400m", "train_4k", True),
            ("llava-next-34b", "prefill_32k", False)}
# 16a's pairs whose peak GiB per device must stay at or under a ceiling:
# the reference's own dry-run peak x 1.10 (x 1.05 for zamba2), C18-C22
DIST_CEIL = {("granite-3-8b", "prefill_32k", True): 5.89,
             ("zamba2-2.7b", "prefill_32k", False): 4.50,
             ("granite-moe-1b-a400m", "prefill_32k", False): 5.52}
# 16a's pairs whose flops a rank must stay at or under a ceiling: each
# model rank computes its share of the heads (C21, C22)
DIST_FLOPS = {("granite-3-8b", "prefill_32k", False): 1.33e14,
              ("granite-3-8b", "prefill_32k", True): 6.65e13,
              ("llava-next-34b", "prefill_32k", False): 4.7e14,
              ("zamba2-2.7b", "prefill_32k", False): 3.5e13}
# 16a's pairs whose collective bytes a device must stay at or under a
# ceiling (C23)
DIST_COLL = {("grok-1-314b", "decode_32k", False): 0.46e9}
DIST_WORKERS = 4                        # host processes tracing 16a's pairs
DIST_FAULT = ((1000, 64), ("model", None))   # 1000 % 16 != 0
DIST_DECODE = ("llama31-8b", MOE_ARCH)  # one decode step each, 16 x 256
DIST_PROMPT = 1015                      # zamba2's prefill, as phase 7's
DIST_TRAIN = dict(arch="llama31-8b", n_repeat=2, batch=2, seq=512)
# phase 17: the examples/ twins that run on the card
EXAMPLES = ("port_serve_demo", "port_train_demo")
EXAMPLE_TIMEOUT = 300
# 16c: llama31-8b's decode in the pools phase 3 checks (G = 4, D = 128,
# bf16), its cache cut into SEQ_SLICES pieces of T as ranks would hold a
# sequence-sharded cache; the first sequences' lengths leave pieces empty
SEQ_SHAPES = [(SHORT_POOL["n_slots"], 32, 8, 128, SHORT_POOL["window"]),
              (LONG_POOL["n_slots"], 32, 8, 128, LONG_POOL["window"])]
SEQ_SLICES = (2, 4)


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
    """The kernel vs plain at `shape`; also its softmax state (return_lse)
    vs the plain lse within LSE_TOL, and the f32 output that comes with it
    the same values as the default output before their rounding to
    `dtype`."""
    q, k, v, lengths = inputs(*shape, dtype, gen, strided_q=strided_q)
    out = flash_decode(q, k, v, lengths)
    ref, ref_lse = flash_decode_ref(q, k, v, lengths, return_lse=True)
    out32, lse = flash_decode(q, k, v, lengths, return_lse=True)
    torch.cuda.synchronize()
    err = float((out.float() - ref).abs().max())
    lse_err = float((lse - ref_lse).abs().max())
    lse_ok = out32.dtype == torch.float32 \
        and torch.equal(out32.to(dtype), out) \
        and torch.allclose(lse, ref_lse, **LSE_TOL)
    ok = out.dtype == dtype and bool(torch.isfinite(out).all()) \
        and torch.allclose(out.float(), ref, **TOL[dtype]) and lse_ok
    T = k.shape[1]
    past = torch.arange(T, device=DEVICE)[None, :, None, None] \
        >= lengths[:, None, None, None]
    out2 = flash_decode(q, k.masked_fill(past, 999.0),
                        v.masked_fill(past, -999.0), lengths)
    leak = not torch.equal(out, out2)
    log(f"  kernel {dtype} B,H,K,D,T={shape}: max_abs_err={err:.3e}"
        f" ({TOL[dtype]}) masked_garbage_changed={leak}; lse"
        f" max_abs_err={lse_err:.3e} ({LSE_TOL}), its f32 out rounded"
        f" equal: {lse_ok}")
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
        for shape in SWEEP + SERVE_SHAPES + TRAIN_DECODE_SHAPES + EXTRA \
                + [RAGGED_T, LONG]:
            errs[(shape, dtype)] = check_kernel(shape, dtype, gen)
        for shape in SERVE_SHAPES + TRAIN_DECODE_SHAPES:
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
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        logits, pc = M.forward(params, cfg, prompt, mode="prefill")
        if plen == PLENS[-1]:
            held = sum(t.numel() * t.element_size() for c in pc.values()
                       for t in c.values())
            log(f"  prefill at S = {plen}: peak"
                f" {(torch.cuda.max_memory_allocated() - base) / 2**30:.4f}"
                f" GiB over what was allocated before it, returned cache"
                f" {held / 2**30:.4f} GiB")
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

        def fn(p, c, x, **kw):
            seen.append(moe_check(p, c, x))
            if len(seen) <= MOE_TIMED_LAYERS:
                seen[-1]["x"] = x.clone()
            return real(p, c, x, **kw)
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

        def fn(p, c, x, **kw):
            B, S, d = x.shape
            h = rms_norm(x, p["norm"], c.norm_eps).reshape(B * S, d)
            store.append(torch.softmax(h.float() @ p["router"], dim=-1))
            return real(p, c, x, **kw)
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
                 for f in dataclasses.fields(eng.meter)
                 if f.name != "profile" and f.compare}
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
    launches by shape, the wall without the recycled-slot checks and the
    model-mode pools."""
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
    return counts, by_shape, wall - check_s, pools


def phase_10(llama, zamba2, granite):
    """10a-10c over the weights of earlier phases.  Returns the launches,
    flash_decode launches by shape, the serve walls (checks excluded) and,
    for phase 11, 10a's and 10c's counts and model-mode pools and 10c's
    misroute seed."""
    counts, by_shape, walls, runs = Counter(), Counter(), {}, {}

    def add(tag, out):
        counts.update(out[0])
        by_shape.update(out[1])
        walls[tag] = out[2]
        runs[tag] = dict(counts=out[0], shapes=out[1], pools=out[3])

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
    runs["10c"]["seed"] = seed
    return counts, by_shape, walls, {t: runs[t] for t in ("10a", "10c")}


# ---- phase 11: FleetScope on the card ---------------------------------------

def traced(make):
    """An engine factory whose engines all record into one detail-level
    `TraceRecorder`; returns (recorder, factory)."""
    rec = TraceRecorder("detail")

    def make_traced(role, **kw):
        eng = make(role, **kw)
        eng.attach_trace(rec)
        return eng
    return rec, make_traced


def pool_energy(rec):
    """Per-phase joules of the charge channel, per pool name."""
    return {name: rec.energy_by_phase(pid)
            for pid, name in enumerate(rec.pool_names)}


def phase_trace(tag, run, models, ref, *, evictions):
    """One phase-11 run: `run(make)` again over model-mode engines on the
    card, each traced by `attach_trace`, and over analytical twins traced
    alike; checked as the module docstring's phase 11 says against each
    other and against `ref`, phase 10's untraced run of the same traffic.
    `evictions` names the lifecycle event and outbox the run exists for.
    Writes the model-mode run's Perfetto document under build/ and returns
    its launch counts."""
    kind, outbox = evictions

    def make(role, **kw):
        cfg, params = models[role]
        return PoolEngine(cfg, params, profile=H100_LLAMA70B, name=role, **kw)

    rec, make_traced = traced(make)
    for fn in COUNTED.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pools = run(make_traced)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in COUNTED.items()}
    streamed = {role: cfg.analytical_spec().streamed_params
                for role, (cfg, _) in models.items()}
    twin_rec, make_twin = traced(analytical(streamed))
    twins = run(make_twin)
    bad = []
    checks = {
        "golden streams equal": rec.golden_stream() == twin_rec.golden_stream(),
        "event counts equal": rec.counts() == twin_rec.counts(),
        "per-pool energy by phase equal": pool_energy(rec)
        == pool_energy(twin_rec),
        "schedule equal to the analytical replay's":
            schedule_of(pools) == schedule_of(twins),
        "schedule equal to phase 10's untraced run":
            schedule_of(pools) == schedule_of(ref["pools"]),
        "launches equal to phase 10's": counts == ref["counts"]}
    rows = reconcile_energy(rec, [e.meter for e in pools.values()])
    worst = max(r["rel_err"] for r in rows.values())
    checks["reconciled within 1e-9"] = worst < 1e-9
    violations = [v for e in (*pools.values(), *twins.values())
                  for v in conservation_violations(e.meter)]
    checks["meters conserve"] = not violations
    left = sorted(r.rid for e in pools.values() for r in getattr(e, outbox))
    want = sorted(r.rid for e in ref["pools"].values()
                  for r in getattr(e, outbox))
    n_events = rec.counts()[kind]
    checks[f"one {kind} event per request in `{outbox}`, as in phase 10"] = \
        bool(left) and n_events == len(left) and left == want
    done = sorted(r.rid for e in pools.values() for r in e.completed)
    checks["every request completed once"] = done == sorted(
        r.rid for e in ref["pools"].values() for r in e.completed)
    for name, ok in checks.items():
        log(f"  {name}: {ok}")
        if not ok:
            bad.append(name)
    log(f"  events {rec.counts()}; {kind} rids {left} (phase 10: {want});"
        f" launches {counts} (phase 10: {ref['counts']})")
    log(f"  reconcile_energy (model mode): " + ", ".join(
        f"{p} {r['trace_j']:.6g} J rel {r['rel_err']:.1e}"
        for p, r in rows.items()) + f"; conservation violations"
        f" {violations}")
    for role, eng in pools.items():
        old = ref["pools"][role]
        log(f"    {role}: {eng.decode_steps} decode steps,"
            f" {1e3 * eng.decode_wall_s / max(eng.decode_steps, 1):.2f} ms"
            f" wall per decode step traced, phase 10 untraced"
            f" {1e3 * old.decode_wall_s / max(old.decode_steps, 1):.2f} ms")
    t1 = time.perf_counter()
    tl = build_timeline(rec)
    doc = to_perfetto(rec)
    out = Path(__file__).resolve().parent / "build" / "chip_smoke"
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"fleetscope_{tag}.json"
    path.write_text(json.dumps(doc))
    binned = float(tl.fleet("joules").sum())
    log(f"  timeline {tl.n_bins} bins over [{tl.t0:.3f}, {tl.t1:.3f}] s,"
        f" {binned:.6g} J binned of {rows['total']['meter_j']:.6g} J"
        f" metered; Perfetto document {len(doc['traceEvents'])} events ->"
        f" {path.relative_to(out.parent.parent)}"
        f" ({time.perf_counter() - t1:.2f} s to build)")
    log(f"  {tag} wall {wall:.1f} s traced")
    if bad:
        raise SystemExit(f"phase 11 {tag}: {bad}")
    return counts


def phase_fleetsim():
    """11c: the port's FleetSim, detail-traced, on the unconstrained
    azure-conv fleetopt cell of benchmarks/results/fleet_sim.json (H100
    Llama-70B profile, 1000 requests, seed 0), built as
    benchmarks/fleet_sim_bench.py --quick builds the row.  Host work."""
    spec = TopologySpec.from_kind("fleetopt", H100_LLAMA70B, LLAMA31_70B,
                                  b_short=4096)
    rec = TraceRecorder("detail")
    t0 = time.perf_counter()
    sim, reqs, plan = prepare_spec(spec, WORKLOADS["azure-conv"],
                                   n_requests=1000, seed=0, telemetry=rec)
    report = sim.run(reqs)
    wall = time.perf_counter() - t0
    f = report["fleet"]
    cell = SimVsAnalytical(
        workload="azure-conv", topology="fleetopt",
        analytical_tok_per_watt=analytical_decode_tok_per_watt(plan),
        analytical_fleet_tok_per_watt=plan.tok_per_watt,
        sim_tok_per_watt=f["tok_per_watt"],
        sim_decode_tok_per_watt=f["decode_tok_per_watt"], report=report)
    row = json.loads(json.dumps(dict(
        cell.row(), table="unconstrained",
        occupancy={r: s["occupancy"] for r, s in report.items()
                   if r != "fleet"},
        prefill_energy_frac=f["prefill_energy_frac"],
        tokens_per_s=f["tokens_per_s"])))
    results = Path(__file__).resolve().parent / "benchmarks" / "results"
    want, = [r for r in json.loads((results / "fleet_sim.json").read_text(
    ))["rows"] if r["table"] == "unconstrained"
        and r["workload"] == "azure-conv" and r["topology"] == "fleetopt"]
    banks = [g.engine.bank for g in sim.groups.values()]
    rows = reconcile_energy(rec, banks)
    violations = [v for b in banks for v in conservation_violations(b)]
    log(f"  row {json.dumps(row)}")
    log(f"  equal to the committed row: {row == want}; reconcile_energy"
        f" max rel {max(r['rel_err'] for r in rows.values()):.1e};"
        f" conservation violations {violations}; {len(rec.events)} events,"
        f" {len(rec.charges)} charge chunks; host wall {wall:.2f} s")
    bad = [name for name, ok in (
        ("the row differs from the committed one", row == want),
        ("not reconciled within 1e-9",
         all(r["rel_err"] < 1e-9 for r in rows.values())),
        ("the meter banks do not conserve", not violations)) if not ok]
    if bad:
        raise SystemExit(f"phase 11c: {bad}")


def phase_11(llama, granite, runs):
    """11a-11c: FleetScope over phase 10a's and 10c's traffic on the card,
    then the fleet simulator on the host.  Returns the launches."""
    counts = Counter()
    log(f"[11a] FleetScope, llama31-8b fleetopt on 10a's traffic, every"
        f" engine traced at level detail")
    counts.update(phase_trace(
        "11a", lambda make: run_overflow(make, traffic_overflow(
            llama[0].vocab)),
        {"short": llama, "long": llama}, runs["10a"],
        evictions=("overflow", "overflowed")))
    seed = runs["10c"]["seed"]
    vocab = min(granite[0].vocab, llama[0].vocab)
    log(f"[11b] FleetScope, semantic escalation granite -> llama on 10c's"
        f" traffic, misroute_seed {seed}")
    counts.update(phase_trace(
        "11b", lambda make: run_semantic(make, traffic_semantic(vocab),
                                         seed),
        {"small": granite, "large": llama}, runs["10c"],
        evictions=("escalate", "escalated")))
    log("[11c] FleetSim (host): unconstrained azure-conv fleetopt, 1000"
        " requests, seed 0, traced at level detail")
    phase_fleetsim()
    return counts


# ---- phase 12: the compiled fleet drain on the card ------------------------

DRAIN_RTOL, DRAIN_ATOL = 1e-9, 1e-12     # test_jax_engine's _assert_parity
DRAIN_METERS = ("joules", "m_joules", "prefill_joules", "m_prefill_joules",
                "idle_joules", "m_idle_joules", "dispatch_joules",
                "m_dispatch_joules", "sim_time_s")
DRAIN_FIELDS = ("completed", "overflowed", "escalated", "relayed", "handoff")


def drain_parity(ref, got):
    """`_assert_parity` of the reference's drain tests, as a list of
    failures: integer and ordering fields exact, meters and times within
    DRAIN_RTOL / DRAIN_ATOL."""
    bad = []

    def close(a, b):
        return np.allclose(a, b, rtol=DRAIN_RTOL, atol=DRAIN_ATOL)

    for k in DRAIN_METERS:
        if not close(getattr(got.bank, k), getattr(ref.bank, k)):
            bad.append(k)
    for k in ("tokens", "m_tokens", "prefill_tokens"):
        if not np.array_equal(getattr(got.bank, k), getattr(ref.bank, k)):
            bad.append(k)
    for k in ("slot_seconds", "m_slot_seconds"):
        if not close(getattr(got, k), getattr(ref, k)):
            bad.append(k)
    for k in ("preempted", "n_escalated"):
        if not np.array_equal(getattr(got, k), getattr(ref, k)):
            bad.append(k)
    for field in DRAIN_FIELDS:
        for sa, sb in zip(getattr(ref, field), getattr(got, field)):
            if [r.rid for r in sa] != [r.rid for r in sb]:
                bad.append(f"{field} order")
                continue
            for ra, rb in zip(sa, sb):
                same = all(getattr(ra, k) == getattr(rb, k) for k in (
                    "n_generated", "preemptions", "escalations",
                    "prefill_done", "generated"))
                for k in ("finish_time", "first_token_time", "ready_time"):
                    a, b = getattr(ra, k), getattr(rb, k)
                    same &= (a is None) == (b is None) and (
                        a is None or close(a, b))
                if not same:
                    bad.append(f"{field} rid {ra.rid}")
    return bad


def grid_family(cells, engine):
    """One run_fleet_grid call over `cells` (Table E's path: shape classes
    for the graph drain); returns (sims, rows, wall s)."""
    t0 = time.perf_counter()
    scenarios = PFB.grid_scenarios(cells, engine=engine, device=DEVICE)
    out = run_fleet_grid(scenarios, pad_floors=PFB.SHAPE_CLASSES
                         if engine == "graph" else None)
    rows = [PFB.grid_row(label, cell)
            for (label, *_), cell in zip(cells, out)]
    return [sim for sim, _, _ in scenarios], rows, time.perf_counter() - t0


def fleet_parity(ref_sims, sims):
    """drain_parity of every pool of every scenario."""
    return [f"cell {i} {role}: {b}"
            for i, (ra, rb) in enumerate(zip(ref_sims, sims))
            for role in ra.order
            for b in drain_parity(ra.groups[role].engine,
                                  rb.groups[role].engine)]


@contextlib.contextmanager
def no_coast_idle():
    """The planted fault, made from the unchanged module: every drain's
    inputs hide the idle-power term from `coast` alone (its closed-form
    decode spans are charged logistic power only).  Fresh graphs are
    captured inside the block and dropped after it."""
    class Inputs(dict):
        def __getitem__(self, k):
            v = dict.__getitem__(self, k)
            if k == "p_idle" and sys._getframe(1).f_code.co_name == "coast":
                return torch.zeros_like(v)
            return v

    def get_drain(*args):
        d = GE._Drain(*args)
        d.p = Inputs(d.p)
        return d

    GE._DRAIN_CACHE.clear()
    try:
        with patched(GE, "_get_drain", get_drain):
            yield
    finally:
        GE._DRAIN_CACHE.clear()


def phase_drain():
    """12a-12e, as the module docstring says.  Launches no kernel."""
    fams = {}
    for c in PFB.grid_cells():
        label, kind = c[0], c[1]
        fams.setdefault(kind, {}).setdefault(label["generation"], c)
    label = ("generation", "topology", "dispatch_ms", "misroute_rate",
             "b_short", "gamma", "k_pools")
    want = {tuple(r[k] for k in label): r for r in json.loads(
        (ROOT / "benchmarks" / "results" / "fleet_grid.json").read_text())}

    def differs(row):
        return json.loads(json.dumps(row)) \
            != want[tuple(row[k] for k in label)]

    card = PFB.card_line()
    bad, walls, n_graphs = [], {}, len(GE._DRAIN_CACHE)
    for kind, by_gen in fams.items():
        cells = list(by_gen.values())
        ref_sims, ref_rows, np_wall = grid_family(cells, "numpy")
        sims, rows, wall = grid_family(cells, "graph")
        captured = len(GE._DRAIN_CACHE) - n_graphs
        n_graphs += captured
        walls[kind] = dict(graph_card_wall_s=round(wall, 3),
                           numpy_host_wall_s=round(np_wall, 3),
                           graphs_captured=captured)
        diffs = fleet_parity(ref_sims, sims)
        diffs += [f"{r['generation']} row differs from fleet_grid.json"
                  for r in rows + ref_rows if differs(r)]
        log(f"  12a {kind}: {len(cells)} cells ({', '.join(by_gen)}),"
            f" graph card wall {wall:.2f} s ({captured} graphs captured)"
            f" [{card}], numpy host wall {np_wall:.2f} s; parity and"
            f" committed rows: {diffs or 'equal'}")
        bad += [f"12a {kind}: {d}" for d in diffs]

    # 12b: one shape class, eager steps on the card vs graph replays
    sim, reqs, _ = PFB.grid_scenarios([fams["fleetopt"]["H100"]],
                                      engine="graph", device=DEVICE)[0]
    sim.begin_run(reqs)
    eng = sim.pre_role(sim.order[0])
    packed = eng._pack(20_000_000)
    dims = (GE._bucket(eng.instances), GE._bucket(eng.n_slots),
            GE._bucket(packed["q_ready"].shape[1]))
    merged = GE._merge([packed], dims[0], dims[2])
    drain = GE._get_drain(eng.phase, *dims, merged, eng.device)
    eager = drain.run(merged, replay=False)
    graph = drain.run(merged)
    differ = [k for k in eager if eager[k].tobytes() != graph[k].tobytes()]
    log(f"  12b {eng.name} (I, S, Q) = {dims}: {int(eager['it'])} steps;"
        f" graph replay vs eager, arrays differing: {differ or 'none'}"
        f" of {len(eager)}")
    if differ:
        bad.append(f"12b: graph replay differs from eager in {differ}")

    # 12c: FleetScope's lifecycle stream, numpy vs graph, per request
    spec = TopologySpec.from_kind("fleetopt", H100_LLAMA70B, LLAMA31_70B,
                                  b_short=4096)
    streams = {}
    for engine in ("numpy", "graph"):
        rec = TraceRecorder("lifecycle")
        sim, reqs, _ = prepare_spec(spec, WORKLOADS["azure-conv"],
                                    n_requests=1000, seed=0, engine=engine,
                                    telemetry=rec, device=DEVICE)
        sim.run(reqs)
        by_rid = {}
        for t, rid, kind, pool, inst in rec.sorted_events():
            by_rid.setdefault(rid, []).append((kind, pool, inst, t))
        streams[engine] = (rec.counts(), rec.pool_names, by_rid)
    (c_np, p_np, a), (c_g, p_g, b) = streams["numpy"], streams["graph"]
    stream_bad = sorted(a.keys() ^ b.keys()) + [
        rid for rid in a.keys() & b.keys()
        if [e[:3] for e in a[rid]] != [e[:3] for e in b[rid]]
        or not np.allclose([e[3] for e in a[rid]], [e[3] for e in b[rid]],
                           rtol=DRAIN_RTOL, atol=DRAIN_ATOL)]
    log(f"  12c azure fleetopt, 1000 requests: counts {dict(c_g)}; equal"
        f" to numpy's: {c_np == c_g and p_np == p_g}; requests whose"
        f" stream differs: {stream_bad or 'none'}")
    if stream_bad or c_np != c_g or p_np != p_g:
        bad.append(f"12c: lifecycle streams differ ({stream_bad[:5]})")

    # 12d: the planted fault must fail 12a's gate
    cells = list(fams["fleetopt"].values())
    ref_sims, _, _ = grid_family(cells, "numpy")
    with no_coast_idle():
        sims, rows, _ = grid_family(cells, "graph")
    caught = fleet_parity(ref_sims, sims) + [
        f"{r['generation']} row" for r in rows if differs(r)]
    log(f"  12d planted fault (coast without idle power) on fleetopt:"
        f" {len(caught)} failures, e.g. {caught[:3]}")
    if not caught:
        bad.append("12d: the planted fault passed 12a's gate")
    log(f"  12e walls per family (graph: card wall on {card}; numpy: host"
        f" wall): {json.dumps(walls)}")
    if bad:
        raise SystemExit(f"phase 12: {bad}")
    return walls


# ---- phase 13: the topology search, drained on the card -------------------

HISTORY_KEYS = ("eval", "spec_hash", "label", "score", "compliant", "error")
ROUND_EXACT = ("round", "instances", "violators", "budget")
ROUND_CLOSE = ("ttft_p99_s", "analytical_tok_per_watt",
               "measured_tok_per_watt", "measured_decode_tok_per_watt",
               "tpot_p99_ms", "e2e_p99_s")
SIZED_CLOSE = ("ttft_p99_s", "slo_tok_per_watt",
               "measured_decode_tok_per_watt")


def search_shapes():
    """Fleet shapes the quick search does not reach at its budget, each a
    ladder of the search's genome: a disaggregated ladder (prefill-phase
    pools and their KV handoffs), the small-model rung and a chip-mixed
    ladder."""
    p = H100_LLAMA70B
    small = computed_profile(LLAMA31_8B, p.chip, p.power_model, tp=1)
    ladder = (4096, 16384, LONG_WINDOW)
    return {"disagg": TS.ladder_spec((4096, LONG_WINDOW), [p] * 2,
                                     LLAMA31_70B, disagg=True),
            "small-model rung": TS.ladder_spec(
                ladder, [p] * 3, LLAMA31_70B, small_model=LLAMA31_8B,
                small_profile=small),
            "chip mix": TS.ladder_spec(
                ladder, [p, B200_LLAMA70B_FLEET, H200_LLAMA70B],
                LLAMA31_70B)}


def close(a, b):
    return math.isclose(a, b, rel_tol=DRAIN_RTOL, abs_tol=DRAIN_ATOL)


def sizing_diffs(ref, got):
    """13a's gate on one spec's two `SLOSizingResult`s: the plan's
    instances, every round's integers and compliance exactly, the measured
    numbers at DRAIN_RTOL."""
    bad = []
    if got.plan.instances != ref.plan.instances:
        bad.append(f"plan.instances {ref.plan.instances} !="
                   f" {got.plan.instances}")
    if got.compliant != ref.compliant:
        bad.append(f"compliant {ref.compliant} != {got.compliant}")
    if len(got.rounds) != len(ref.rounds):
        bad.append(f"rounds {len(ref.rounds)} != {len(got.rounds)}")
    for a, b in zip(ref.rounds, got.rounds):
        bad += [f"round {a.round} {k}" for k in ROUND_EXACT
                if getattr(a, k) != getattr(b, k)]
        bad += [f"round {a.round} {k} {getattr(a, k)!r} !="
                f" {getattr(b, k)!r}" for k in ROUND_CLOSE
                if not close(getattr(a, k), getattr(b, k))]
    bad += [f"{k} {getattr(ref, k)!r} != {getattr(got, k)!r}"
            for k in SIZED_CLOSE if not close(getattr(ref, k),
                                               getattr(got, k))]
    return bad


def search_diffs(ref, got):
    """13a's gate on two `TopologySearchResult`s: the history entry for
    entry, no entry with an error, the same counts and winner."""
    bad = []
    ha = [{k: h[k] for k in HISTORY_KEYS} for h in ref.history]
    hb = [{k: h[k] for k in HISTORY_KEYS} for h in got.history]
    if len(ha) != len(hb):
        bad.append(f"history has {len(hb)} entries, numpy's {len(ha)}")
    bad += [f"history {a} != {b}" for a, b in zip(ha, hb) if a != b]
    bad += [f"eval {h['eval']} raised: {h['error']}" for h in hb + ha
            if h["error"] is not None]
    for k in ("evaluations", "restarts"):
        if getattr(ref, k) != getattr(got, k):
            bad.append(f"{k} {getattr(ref, k)} != {getattr(got, k)}")
    if ref.best_spec.spec_hash != got.best_spec.spec_hash:
        bad.append("best spec differs")
    return bad


@contextlib.contextmanager
def sizing_log(log_):
    """Every `size_to_slo_spec` call of the search, by spec hash:
    (spec, result)."""
    real = TS.size_to_slo_spec

    def sized(spec, *args, **kw):
        res = log_[spec.spec_hash] = (spec, real(spec, *args, **kw))
        return res[1]

    with patched(TS, "size_to_slo_spec", sized):
        yield


def phase_search():
    """13a-13d, as the module docstring says.  Launches no kernel."""
    card = PFB.card_line()
    want = json.loads((ROOT / "benchmarks" / "results"
                       / "topology_search.json").read_text())
    bad, runs = [], {}
    for engine in ("numpy", "graph"):
        n_graphs, evals = len(GE._DRAIN_CACHE), {}
        t0 = time.perf_counter()
        with sizing_log(evals):
            rows, sized, sr = PFB.search_run(engine=engine, device=DEVICE)
        wall = time.perf_counter() - t0
        runs[engine] = dict(sized=sized, sr=sr, evals=evals, wall=wall,
                            graphs=len(GE._DRAIN_CACHE) - n_graphs)
        diffs = PFB._diff(rows, want["rows"])
        if PFB.SEARCH != want["meta"]:
            diffs.append(f"meta {PFB.SEARCH} != {want['meta']}")
        log(f"  13a {engine}: {PFB.search_derived(rows)}; rows vs"
            f" topology_search.json: {diffs or 'equal'}")
        bad += [f"13a {engine}: {d}" for d in diffs]
    a, b = runs["numpy"], runs["graph"]
    diffs = search_diffs(a["sr"], b["sr"])
    for kind, res in a["sized"].items():
        diffs += [f"{kind}: {d}" for d in sizing_diffs(res, b["sized"][kind])]
    for h, (spec, res) in a["evals"].items():
        got = b["evals"].get(h)
        diffs += [f"{spec.label}: not evaluated under graph"] if got is None \
            else [f"{spec.label}: {d}" for d in sizing_diffs(res, got[1])]
    log(f"  13a graph vs numpy: {len(a['sr'].history)} evaluations,"
        f" {a['sr'].restarts} restarts, {len(a['sized'])} hand-built specs:"
        f" {diffs or 'history, results and sizings equal, no error'}")
    bad += [f"13a: {d}" for d in diffs]

    # the shapes the search's budget does not reach, on the same trace
    trace = sample_trace(WORKLOADS["azure-conv"], PFB.SEARCH["slo_requests"],
                         seed=PFB.SEARCH["seed"], max_total=LONG_WINDOW)
    shapes = {}
    for name, spec in search_shapes().items():
        res = {engine: size_to_slo_spec(
            spec, WORKLOADS["azure-conv"], slo=SLOSpec(),
            n_requests=PFB.SEARCH["slo_requests"], seed=PFB.SEARCH["seed"],
            trim=False, engine=engine, trace=trace, device=DEVICE)
            for engine in ("numpy", "graph")}
        diffs = sizing_diffs(res["numpy"], res["graph"])
        shapes[name] = len(res["graph"].rounds)
        log(f"  13a {name} ({spec.label}): {res['graph'].plan.instances}"
            f" instances, {len(res['graph'].rounds)} rounds, compliant"
            f" {res['graph'].compliant}; graph vs numpy:"
            f" {diffs or 'equal'}")
        bad += [f"13a {name}: {d}" for d in diffs]

    # 13b: the planted fault, on the graph drain of the search's seed spec
    seed_spec, ref = a["evals"][a["sr"].history[0]["spec_hash"]]
    with no_coast_idle():
        faulty = size_to_slo_spec(
            seed_spec, WORKLOADS["azure-conv"], slo=SLOSpec(),
            n_requests=PFB.SEARCH["slo_requests"], seed=PFB.SEARCH["seed"],
            trim=False, engine="graph", trace=trace, device=DEVICE)
    caught = sizing_diffs(ref, faulty)
    log(f"  13b planted fault (coast without idle power) on"
        f" {seed_spec.label}: {len(caught)} failures, e.g. {caught[:3]}")
    if not caught:
        bad.append("13b: the planted fault passed 13a's gate")

    # 13c: walls, captures and rounds
    rounds = {spec.label: len(res.rounds)
              for spec, res in b["evals"].values()}
    rounds.update({kind: len(res.rounds) for kind, res in b["sized"].items()})
    log(f"  13c search: graph card wall {b['wall']:.2f} s [{card}],"
        f" {b['graphs']} CUDA graphs captured; numpy host wall"
        f" {a['wall']:.2f} s; SLO rounds per spec {json.dumps(rounds)};"
        f" shapes {json.dumps(shapes)}")

    # 13d: the paper's analytical tables on the card's host
    t0 = time.perf_counter()
    for name, rows, derived, _ in PPT.run_suites():
        log(f"  13d {name}: {len(rows or ())} rows; {derived}")
        if not rows:
            bad.append(f"13d {name}: {derived if rows is None else 'no rows'}")
    log(f"  13d host wall {time.perf_counter() - t0:.2f} s")
    if bad:
        raise SystemExit(f"phase 13: {bad}")
    return dict(graph_card_wall_s=round(b["wall"], 3),
                numpy_host_wall_s=round(a["wall"], 3),
                graphs_captured=b["graphs"])


# ---- phase 14: training ------------------------------------------------------

def step_on(cfg, params, batch, device, fault=None):
    """One `make_train_step` of `params` (updated in place) on `device`:
    the loss, the gradient tree the step handed AdamW (flat, reference
    keys, None as zeros) and the updated leaves (flat), all as numpy."""
    b = batch_to(batch, device)
    seen = {}

    class Keep(AdamW):
        def update(self, grads, state, params, **kw):
            seen["grads"] = grads
            return super().update(grads, state, params, **kw)

    opt = Keep(**TRAIN_OPT)
    with fault() if fault else contextlib.nullcontext():
        params, _, m = make_train_step(cfg, opt)(params, opt.init(params), b)
    grads = seen["grads"]
    none = {id(p) for p, g in zip(tree_leaves(params), tree_leaves(grads))
            if g is None}
    grads = tree_map(lambda g, p: torch.zeros_like(p) if g is None else g,
                     grads, params)
    return (float(m["loss"]), flatten_paths(to_reference_layout(grads)),
            flatten_paths(to_reference_layout(params)), len(none), m["lr"])


def step_diffs(cpu, card):
    """14a's gate: (loss error, worst gradient error / GRAD_REL bound,
    worst update error / its bound); all three <= 1 pass."""
    loss, grads, new, n_none, lr = cpu
    closs, cgrads, cnew, cn_none, _ = card
    g_worst = u_worst = 0.0
    for key, g in grads.items():
        scale = max(float(np.abs(g).max()), 1e-30)
        g_worst = max(g_worst, float(np.abs(cgrads[key] - g).max())
                      / (GRAD_REL * scale))
        atol = np.where(np.abs(g) > NOISE_REL * np.abs(g).max(), STEP_ATOL,
                        2 * lr)
        u_worst = max(u_worst, float((np.abs(cnew[key] - new[key])
                                      / atol).max()))
    if n_none != cn_none:
        g_worst = math.inf
    return abs(closs - loss) / LOSS_ATOL, g_worst, u_worst


def train_fault(arch):
    """A context that plants arch's TRAIN_FAULTS entry."""
    if arch == "whisper-medium":
        def rolled(params, cfg, frames):
            return real(params, cfg, frames.roll(1, 0))
        name = "encoder_apply"
    else:
        def rolled(params, cfg, tokens, patches=None):
            return real(params, cfg, tokens, patches.roll(1, 0))
        name = "embed_inputs"
    real = getattr(M, name)
    return lambda: patched(M, name, rolled)


def phase_train_parity():
    """14a: card against the port's CPU arithmetic."""
    for arch in TRAIN_ARCHS:
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  **TRAIN_CHANGES.get(arch, {}))
        batch = next(batch_iterator(cfg, **TRAIN_BATCH))
        cpu_params = M.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
        runs = {}
        faults = [("card", None)] + ([("fault", train_fault(arch))]
                                     if arch in TRAIN_FAULTS else [])
        for tag, fault in faults:
            runs[tag] = step_diffs(
                step_on(cfg, tree_map(torch.clone, cpu_params), batch,
                        "cpu"),
                step_on(cfg, tree_map(lambda t: t.to(DEVICE), cpu_params),
                        batch, DEVICE, fault))
        card = runs["card"]
        log(f"  14a {arch} reduced (f32{', capacity 0.5' if arch in TRAIN_CHANGES else ''}):"
            f" card vs CPU, error / bound: loss {card[0]:.3e}, worst grad"
            f" leaf {card[1]:.3e}, worst updated leaf {card[2]:.3e}")
        if max(card) > 1:
            raise SystemExit(f"14a: {arch}'s train step on the card disagrees"
                             " with the CPU's")
        if "fault" in runs:
            log(f"  14a {arch} control, {TRAIN_FAULTS[arch]} on the card:"
                f" loss {runs['fault'][0]:.3e}, grad {runs['fault'][1]:.3e},"
                f" update {runs['fault'][2]:.3e} (must exceed 1)")
            if max(runs["fault"]) <= 1:
                raise SystemExit(f"14a: the gate does not catch"
                                 f" {TRAIN_FAULTS[arch]}")


def run_launcher(tag, argv):
    """`launch/train.py` on the card with `argv` and a checkpoint: the last
    logged loss at least DEMO_FALL nats below the first (the reference
    test's criterion), the checkpoint reloaded bit-equal, its keys those
    of `to_reference_layout`.  Returns the wall (s)."""
    arch, preset = (argv[argv.index(f) + 1] for f in ("--arch", "--preset"))
    path = ROOT / "build" / "chip_smoke" / f"{arch}-{preset}.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    cfg, params, hist = launch_train.main(argv + [
        "--device", DEVICE, "--ckpt", str(path)])
    wall = time.perf_counter() - t0
    fall = hist[0]["loss"] - hist[-1]["loss"]
    log(f"  {tag} {cfg.name}: {cfg.param_count() / 1e6:.1f}M params, loss"
        f" {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f} (fell"
        f" {fall:.4f} nats, must fall >= {DEMO_FALL}), {wall:.1f} s with the"
        f" checkpoint")
    if not fall >= DEMO_FALL:
        raise SystemExit(f"{tag}: {cfg.name}'s loss did not fall by 1 nat")
    with np.load(path) as data:
        keys = sorted(set(data.files) - {"__step__"})
    want = sorted(flatten_paths(to_reference_layout(params)))
    loaded, step = load_checkpoint(str(path), tree_map(torch.empty_like,
                                                       params))
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                  tree_leaves(loaded)))
    log(f"  {tag} checkpoint {path.stat().st_size / 2**20:.1f} MiB,"
        f" {len(keys)} leaves, keys equal to_reference_layout's:"
        f" {keys == want}, step {step}, reloaded bit-equal: {same}")
    path.unlink()
    if keys != want or step != int(argv[argv.index("--steps") + 1]) \
            or not same:
        raise SystemExit(f"{tag}: the checkpoint does not round-trip")
    return wall


def phase_train_demo():
    """14b: launch/train.py's path on the reference's 100M demo."""
    return run_launcher("14b", DEMO_ARGS)


def phase_train_moe():
    """14c: granite-moe at full width and depth, 10 AdamW steps."""
    cfg, params = load_model(MOE_ARCH)
    opt = AdamW(**MOE_TRAIN["opt"])
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    it = batch_iterator(cfg, batch=MOE_TRAIN["batch"], seq=MOE_TRAIN["seq"])
    seen = {"aux": [], "kept": [], "all": 0}
    real_lb, real_dispatch = moe.load_balance_loss, moe._dispatch_group

    def lb_spy(logits, idx, E):
        out = real_lb(logits, idx, E)
        seen["aux"].append(out.detach())
        return out

    def dispatch_spy(hf, idx, E, k, C):
        buf, meta = real_dispatch(hf, idx, E, k, C)
        seen["kept"].append(meta[1].sum())
        seen["all"] += meta[1].numel()
        return buf, meta

    rows = []
    torch.cuda.reset_peak_memory_stats()
    with patched(moe, "load_balance_loss", lb_spy), \
            patched(moe, "_dispatch_group", dispatch_spy):
        for i in range(MOE_TRAIN["steps"]):
            batch = batch_to(next(it), DEVICE)
            seen["aux"] = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch)
            torch.cuda.synchronize()
            rows.append(dict(loss=float(m["loss"]),
                             grad_norm=float(m["grad_norm"]),
                             aux=float(sum(seen["aux"])), lr=m["lr"],
                             wall_s=time.perf_counter() - t0))
    dropped = 1 - float(sum(seen["kept"])) / seen["all"]
    log(f"  14c {cfg.name}: {MOE_TRAIN['steps']} steps at batch"
        f" {MOE_TRAIN['batch']} x {MOE_TRAIN['seq']}, capacity"
        f" {cfg.capacity_factor}: dropped-assignment share {dropped:.4f},"
        f" peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for i, r in enumerate(rows):
        log(f"    step {i}: loss {r['loss']:.4f} grad_norm"
            f" {r['grad_norm']:.3f} aux {r['aux']:.4f} lr {r['lr']:.2e}"
            f" wall {r['wall_s'] * 1e3:.1f} ms")
    # a non-finite gradient leaf would make the global norm non-finite
    if not all(math.isfinite(r[k]) for r in rows
               for k in ("loss", "grad_norm", "aux")):
        raise SystemExit("14c: a non-finite loss, gradient or aux loss")
    if not rows[-1]["loss"] < rows[0]["loss"]:
        raise SystemExit("14c: granite's loss did not fall in 10 steps")
    if not dropped > 0:
        raise SystemExit("14c: the training dispatch dropped nothing")
    del params, state
    torch.cuda.empty_cache()
    return [r["wall_s"] for r in rows]


def decode_vs_plain(tag, cfg, params, cache, tokens, pos0, steps):
    """`steps` greedy decode steps through the kernel, each also run with
    the plain attention on a copy of the same cache: logits within
    LOGIT_REL_BOUND (phase 4's bound), a differing top-1 only at a
    near-tie.  Counts set to 0 just before and read just after.  Returns
    the cache, the flash_decode launches and the one (B, H, K, D, T) shape
    the decode steps handed flash_decode."""
    shapes = Counter()

    def seen(q, k, v, lengths):
        shapes[(*q.shape[:2], *k.shape[2:], k.shape[1])] += 1
        return FD.flash_decode(q, k, v, lengths)

    for fn in COUNTED.values():
        fn.launches = 0
    worst = 0.0
    for i in range(steps):
        plain, _ = M.decode_step(params, cfg, tokens, clone_cache(cache),
                                 pos0 + i, impl="plain")
        with patched(ops, "_fd", types.SimpleNamespace(flash_decode=seen)):
            a, cache = M.decode_step(params, cfg, tokens, cache, pos0 + i)
        rel, agree, _, tie_ok = rel_rows(a[:, 0], plain[:, 0])
        worst = max(worst, max(rel))
        if not bool(torch.isfinite(a).all()) or max(rel) > LOGIT_REL_BOUND \
                or not tie_ok:
            raise SystemExit(f"{tag}: decode step {i} through flash_decode"
                             f" disagrees with plain ({rel}, top-1 {agree})")
        tokens = a[:, 0].argmax(-1, keepdim=True)
    counts = {name: fn.launches for name, fn in COUNTED.items()}
    want = dict({n: 0 for n in counts},
                flash_decode=cfg.attn_block_count * steps)
    log(f"  {tag}: {steps} decode steps, max|d|/max|logits| kernel vs plain"
        f" {worst:.3e} (bound {LOGIT_REL_BOUND}), launches {counts}")
    if counts != want or len(shapes) != 1:
        raise SystemExit(f"{tag}: launches {counts}, want {want}; shapes"
                         f" {dict(shapes)}")
    return cache, counts["flash_decode"], next(iter(shapes))


def pad_self_attn(cache, slots):
    """Self-attention K/V of a prefill cache widened to `slots` slots."""
    return {name: ({key: torch.nn.functional.pad(
        t, (0, 0, 0, 0, 0, slots - t.shape[2])) for key, t in c.items()}
        if name.endswith("_attn") and "cross" not in name else c)
        for name, c in cache.items()}


def phase_train_whisper():
    """14d: whisper-medium at full width: a train step, then decode."""
    cfg, params = load_model("whisper-medium")
    b = batch_to(next(batch_iterator(cfg, **WHISPER_TRAIN)), DEVICE)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads = loss_and_grads(params, cfg, b)
    opt = AdamW(**TRAIN_OPT)
    params, _ = opt.update(grads, opt.init(params), params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    enc = {f"encoder/{k}": g for k, g in flatten_paths(
        {"layers": {str(i): layer for i, layer in
                    enumerate(grads["encoder"]["layers"])},
         "final_norm": grads["encoder"]["final_norm"]}).items()}
    read = {k: g for k, g in enc.items() if g is not None}
    norms = {k: float(g.float().norm()) for k, g in read.items()}
    unread = sorted({k.rsplit("/", 1)[1] for k, g in enc.items()
                     if g is None})
    log(f"  14d {cfg.name} ({cfg.n_repeat} + {cfg.encoder.n_layers} layers,"
        f" {cfg.encoder.n_frames} frames, {cfg.dtype}): one train step at"
        f" batch {WHISPER_TRAIN['batch']} x {WHISPER_TRAIN['seq']}, loss"
        f" {float(loss):.4f}, {wall:.2f} s, peak"
        f" {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {len(read)}"
        f" encoder leaves with a gradient, norms {min(norms.values()):.3e}"
        f"-{max(norms.values()):.3e}; unread (None): {unread}")
    if not math.isfinite(float(loss)) or not all(
            math.isfinite(n) and n > 0 for n in norms.values()):
        raise SystemExit("14d: an encoder gradient is zero or not finite")
    if unread != ["bk", "bq", "bv"]:
        raise SystemExit(f"14d: unexpected unread encoder leaves {unread}")
    del grads
    torch.cuda.empty_cache()
    with torch.no_grad():
        frames = b["frames"]
        prompt = b["tokens"][:, :ENC_PROMPT]
        logits, cache = M.forward(params, cfg, prompt, mode="prefill",
                                  frames=frames)
        enc_out = M.encoder_apply(params, cfg, frames)
        cross = cache["b1_cross_attn"]
        equal = all(torch.equal(cross[key][r], encode_cross_kv(
            params["layers"][r]["b1_cross_attn"], cfg, enc_out)[key])
            for r in range(cfg.n_repeat) for key in ("k", "v"))
        kept = clone_cache({"x": cross})["x"]
        cache = pad_self_attn(cache, ENC_PROMPT + ENC_DECODE_STEPS)
        cache, launches, shape = decode_vs_plain(
            "14d whisper", cfg, params, cache,
            logits[:, -1].argmax(-1, keepdim=True), ENC_PROMPT,
            ENC_DECODE_STEPS)
        unchanged = all(torch.equal(cache["b1_cross_attn"][key], kept[key])
                        for key in ("k", "v"))
    log(f"  14d cross-attention cache ({cross['k'].dtype}) equal to"
        f" encode_cross_kv of the encoder output: {equal}; unchanged by"
        f" decode: {unchanged}")
    if not equal or not unchanged:
        raise SystemExit("14d: the cross-attention cache is not the"
                         " encoder's K/V")
    del params, cache
    torch.cuda.empty_cache()
    return wall, shape, launches


def phase_train_llava():
    """14e: llava-next-34b at full width, 2 repeats: patches + prompt
    prefilled, then decode at positions offset by n_patches."""
    cfg = dataclasses.replace(get_config("llava-next-34b"),
                              n_repeat=LLAVA_REPEATS)
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                           DEVICE)
    log(f"  14e {cfg.name} cut to n_repeat = {LLAVA_REPEATS} of 60 (34.4 B"
        f" parameters do not fit one card): {cfg.param_count() / 1e9:.2f} B"
        f" params, init {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    B, P = LLAVA_BATCH, cfg.n_patches
    patches = torch.randn(B, P, cfg.d_model, generator=gen,
                          device=DEVICE) * 0.02
    prompt = torch.randint(0, cfg.vocab, (B, LLAVA_PROMPT), generator=gen,
                           device=DEVICE)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = M.forward(params, cfg, prompt, mode="prefill",
                                  patches=patches)
        torch.cuda.synchronize()
        prefill = time.perf_counter() - t0
        T = P + LLAVA_PROMPT + LLAVA_DECODE_STEPS
        log(f"  14e prefill of {P} patches + {LLAVA_PROMPT} tokens at batch"
            f" {B}: {prefill:.2f} s, cache {tuple(cache['b0_attn']['k'].shape)}")
        cache, launches, shape = decode_vs_plain(
            "14e llava", cfg, params, pad_self_attn(cache, T),
            logits[:, -1].argmax(-1, keepdim=True), P + LLAVA_PROMPT,
            LLAVA_DECODE_STEPS)
    del params, cache
    torch.cuda.empty_cache()
    return prefill, shape, launches


def phase_train():
    """Phase 14: 14a-14e, each timed; prints the walls beside the card."""
    walls = {}
    for tag, fn in (("14a", phase_train_parity), ("14b", phase_train_demo),
                    ("14c", phase_train_moe), ("14d", phase_train_whisper),
                    ("14e", phase_train_llava)):
        t0 = time.perf_counter()
        out = fn()
        walls[tag] = time.perf_counter() - t0
        if tag == "14c":
            moe_step_walls = out
        elif tag == "14d":
            whisper_step, whisper_shape, whisper_launches = out
        elif tag == "14e":
            llava_prefill, llava_shape, llava_launches = out
    if {whisper_shape, llava_shape} != set(TRAIN_DECODE_SHAPES):
        raise SystemExit(f"phase 14 gave flash_decode {whisper_shape} and"
                         f" {llava_shape}, not the shapes phase 3 checked"
                         f" ({TRAIN_DECODE_SHAPES})")
    log(f"  phase 14 flash_decode: {whisper_launches + llava_launches}"
        " launches, shapes (B, H, K, D, T): "
        + ", ".join(f"{tag} {shape} x {n} (G = {shape[1] // shape[2]},"
                    f" D = {shape[3]})" for tag, shape, n in (
                        ("whisper", whisper_shape, whisper_launches),
                        ("llava", llava_shape, llava_launches))))
    log(f"  phase 14 walls on {PFB.card_line()}: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items())
        + f"; granite step {min(moe_step_walls) * 1e3:.1f}-"
        f"{max(moe_step_walls) * 1e3:.1f} ms, whisper train step"
        f" {whisper_step:.2f} s, llava prefill {llava_prefill:.2f} s")


# ---- phase 15: SSM training ----------------------------------------------------

def zero_counts():
    for fn in COUNTED.values():
        fn.launches = 0


def counts_now():
    return {name: fn.launches for name, fn in COUNTED.items()}


def scan_blocks(cfg):
    """The Mamba2 / RWKV6 blocks of a config: the scan calls of a
    full-sequence forward."""
    return sum(blk.kind in ("mamba2", "rwkv6") for blk in cfg.unit) \
        * cfg.n_repeat


def carry_fault():
    """15a's planted fault (SSM_FAULT), made from the unchanged module:
    `models.ssm._carry` hands every chunk but the first a zero state, and
    the final state keeps only the last chunk's own part."""
    def zeroed(s0, decay, inc):
        zeros = [torch.zeros_like(s0)] * (inc.shape[1] - 1)
        return torch.stack([s0] + zeros, dim=1), inc[:, -1]
    return patched(ssm_blocks, "_carry", zeroed)


def phase_ssm_parity():
    """15a: the SSMs' train step on the card against the CPU's; the scan
    kernels refuse grad and still serve the prefill."""
    gen = torch.Generator(device=DEVICE).manual_seed(15)
    for arch, (kernel, _) in SSM.items():
        cfg = get_config(arch).reduced()
        batch = next(batch_iterator(cfg, **SSM_TRAIN_BATCH))
        cpu_params = M.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
        cpu = step_on(cfg, tree_map(torch.clone, cpu_params), batch, "cpu")
        runs = {}
        for tag, fault in (("card", None), ("fault", carry_fault)):
            zero_counts()
            card = step_on(cfg, tree_map(lambda t: t.to(DEVICE), cpu_params),
                           batch, DEVICE, fault)
            runs[tag] = step_diffs(cpu, card), counts_now()
        (card, counts), (fault, _) = runs["card"], runs["fault"]
        log(f"  15a {arch} reduced (f32, batch {SSM_TRAIN_BATCH['batch']} x"
            f" {SSM_TRAIN_BATCH['seq']}): card vs CPU, error / bound: loss"
            f" {card[0]:.3e}, worst grad leaf {card[1]:.3e}, worst updated"
            f" leaf {card[2]:.3e}; launches in the card's step {counts}")
        log(f"  15a {arch} control, {SSM_FAULT} on the card: loss"
            f" {fault[0]:.3e}, grad {fault[1]:.3e}, update {fault[2]:.3e}"
            f" (must reach {SSM_FAULT_FACTOR:g})")
        if max(card) > 1:
            raise SystemExit(f"15a: {arch}'s train step on the card disagrees"
                             " with the CPU's")
        if any(counts.values()):
            raise SystemExit(f"15a: {arch}'s train step launched {counts}")
        if max(fault) < SSM_FAULT_FACTOR:
            raise SystemExit(f"15a: the gate does not catch {SSM_FAULT}")
        # the kernel itself still refuses to be recorded
        fn = SCANS[kernel][0]
        args = [a.requires_grad_() if a.is_floating_point() else a
                for a in scan_inputs(kernel, GUARD_SHAPE[kernel], gen)]
        zero_counts()
        try:
            fn(*args)
        except RuntimeError as e:
            msg = str(e)
        else:
            raise SystemExit(f"15a: {kernel} ran with grad enabled")
        launched = fn.launches
        refused = launched == 0 and msg.startswith(kernel) \
            and "chunk scans in models/ssm.py" in msg
        # a no_grad prefill of the same tokens goes through the kernel
        params = tree_map(lambda t: t.to(DEVICE), cpu_params)
        zero_counts()
        with torch.no_grad():
            M.forward(params, cfg, batch_to(batch, DEVICE)["tokens"],
                      mode="prefill")
        counts = counts_now()
        want = dict({n: 0 for n in counts}, **{kernel: scan_blocks(cfg)})
        log(f"  15a {kernel} called with grad: RuntimeError"
            f" ({msg.split(';')[0]}), launched {launched}; no_grad"
            f" prefill of the same tokens launches {counts}")
        if not refused or counts != want:
            raise SystemExit(f"15a: {kernel}'s guard or {arch}'s prefill is"
                             f" off (want {want})")


def chunk_scan_case(kind, shape, gen, w_range=None):
    """15b's float inputs, drawn as the blocks make them at init: Mamba2's
    x, B, C = silu(normal) (`_mamba_inner`'s conv output through silu), dt
    = softplus(normal), A = -linspace(1, 16, nh) (init's A_log), D = 1;
    RWKV6's r, k, v normal, w uniform in w_range, u 0.5 normal."""
    def randn(*s):
        return torch.randn(*s, generator=gen, device=DEVICE)

    if kind == "mamba2":
        B, S, nh, hd, ds = shape
        return [silu(randn(B, S, nh, hd)), silu(randn(B, S, ds)),
                silu(randn(B, S, ds)),
                torch.nn.functional.softplus(randn(B, S, nh)),
                -torch.linspace(1.0, 16.0, nh, device=DEVICE),
                torch.ones(nh, device=DEVICE)]
    B, S, H, hd = shape
    lo, hi = w_range
    w = lo + (hi - lo) * torch.rand(B, S, H, hd, generator=gen, device=DEVICE)
    return [randn(B, S, H, hd), randn(B, S, H, hd), randn(B, S, H, hd), w,
            0.5 * randn(H, hd)]


def sequential_scan(kind, *args):
    """The plain sequential scan on a chunk scan's arguments (Mamba2: on
    xt = x dt and lA = dt A, with D x added)."""
    if kind == "mamba2":
        xh, Bm, Cm, dt, A, D = args
        y, state = mamba_scan_ref(xh * dt[..., None], Bm, Cm, dt * A)
        return y + xh * D[None, None, :, None], state
    return wkv6_ref(*args)


def scan_with_grads(fn, args, cot):
    """y, the final state and the gradients of every argument under the
    cotangents `cot` (of y and the state)."""
    leaves = [a.detach().clone().requires_grad_() for a in args]
    y, state = fn(*leaves)
    grads = torch.autograd.grad((y * cot[0]).sum() + (state * cot[1]).sum(),
                                leaves)
    return y.detach(), state.detach(), [g.detach() for g in grads]


def chunk_scan_diffs(kind, got, ref):
    """(y and state error / CHUNK_SCAN_TOL's limit, worst gradient error /
    GRAD_REL of its max|g|, all finite): <= 1, <= 1 and True pass."""
    (y, st, g), (yr, sr, gr) = got, ref
    tol = CHUNK_SCAN_TOL[kind]
    out = max(float(((a - b).abs() / (tol["atol"] + tol["rtol"] * b.abs()))
                    .max()) for a, b in ((y, yr), (st, sr)))
    grad = max(float((a - b).abs().max())
               / (GRAD_REL * max(float(b.abs().max()), 1e-30))
               for a, b in zip(g, gr))
    finite = all(bool(torch.isfinite(t).all()) for t in (y, st, *g))
    return out, grad, finite


CHUNK_SCANS = {"mamba2": ssm_blocks.mamba2_chunk_scan,
               "wkv6": ssm_blocks.wkv6_chunk_scan}


def phase_chunk_scans():
    """15b: the chunk scans at full width against the sequential scans."""
    gen = torch.Generator(device=DEVICE).manual_seed(16)
    walls = {}
    for kind, w_range in [("mamba2", None)] + [("wkv6", w)
                                               for w in CHUNK_SCAN_W]:
        shape = CHUNK_SCAN_SHAPES[kind]
        args = chunk_scan_case(kind, shape, gen, w_range)
        cot = [torch.randn(shape[:4], generator=gen, device=DEVICE),
               torch.randn(shape[0], shape[2], shape[3], shape[-1],
                           generator=gen, device=DEVICE)]
        scan = CHUNK_SCANS[kind]
        scan_with_grads(scan, args, cot)                 # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = scan_with_grads(scan, args, cot)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = scan_with_grads(functools.partial(sequential_scan, kind), args,
                              cot)
        torch.cuda.synchronize()
        ref_wall = time.perf_counter() - t0
        out, grad, finite = chunk_scan_diffs(kind, got, ref)
        tag = f"{kind} {shape}" + (f" w in {list(w_range)}" if w_range
                                   else "")
        walls[tag] = wall
        log(f"  15b {tag}: chunk scan vs sequential, error / bound: y and"
            f" state {out:.3e} ({CHUNK_SCAN_TOL[kind]}; max|y|"
            f" {float(ref[0].abs().max()):.1f}, max abs err"
            f" {float((got[0] - ref[0]).abs().max()):.3e}), worst input"
            f" gradient {grad:.3e} (GRAD_REL {GRAD_REL} of max|g|); finite"
            f" {finite}; forward and backward {wall * 1e3:.1f} ms wall"
            f" (sequential {ref_wall * 1e3:.1f} ms)")
        if out > 1 or grad > 1 or not finite:
            raise SystemExit(f"15b: the {kind} chunk scan disagrees with the"
                             f" sequential scan at {tag}")
        del args, got, ref
    torch.cuda.empty_cache()
    return walls


def phase_ssm_full(name):
    """15c: `name` at full width and depth, bf16, SSM_TRAIN's AdamW steps;
    then the trained weights' prefill through the scan kernel."""
    kernel = SSM[name][0]
    cfg, params = load_model(name)
    opt = AdamW(**SSM_TRAIN["opt"])
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    it = batch_iterator(cfg, batch=SSM_TRAIN["batch"], seq=SSM_TRAIN["seq"])
    rows = []
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    for i in range(SSM_TRAIN["steps"]):
        batch = batch_to(next(it), DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        torch.cuda.synchronize()
        rows.append(dict(loss=float(m["loss"]),
                         grad_norm=float(m["grad_norm"]), lr=m["lr"],
                         wall_s=time.perf_counter() - t0))
    counts = counts_now()
    peak = torch.cuda.max_memory_allocated() / 2**30
    finite = all(bool(torch.isfinite(p).all()) for p in tree_leaves(params))
    log(f"  15c {cfg.name}: {cfg.param_count() / 1e9:.3f} B params,"
        f" {SSM_TRAIN['steps']} steps at batch {SSM_TRAIN['batch']} x"
        f" {SSM_TRAIN['seq']}: peak {peak:.2f} GiB, launches {counts},"
        f" every updated weight finite: {finite}")
    for i, r in enumerate(rows):
        log(f"    step {i}: loss {r['loss']:.4f} grad_norm"
            f" {r['grad_norm']:.3f} lr {r['lr']:.2e} wall"
            f" {r['wall_s'] * 1e3:.1f} ms")
    if not finite or not all(math.isfinite(r[k]) for r in rows
                             for k in ("loss", "grad_norm")):
        raise SystemExit(f"15c: a non-finite loss, gradient or update"
                         f" ({name})")
    if not rows[-1]["loss"] < rows[0]["loss"]:
        raise SystemExit(f"15c: {name}'s loss did not fall in"
                         f" {SSM_TRAIN['steps']} steps")
    if any(counts.values()):
        raise SystemExit(f"15c: {name}'s training launched {counts}")
    del state, step
    torch.cuda.empty_cache()
    # the trained weights' prefill: the kernels on decays moved from init
    prompt = batch_to(next(it), DEVICE)["tokens"]
    with torch.no_grad():
        zero_counts()
        a16, _ = M.forward(params, cfg, prompt, mode="prefill")
        counts = counts_now()
        cfg32, params32 = to_f32(cfg, params)
        del params
        a, _ = M.forward(params32, cfg32, prompt, mode="prefill")
        b, _ = M.forward(params32, cfg32, prompt, mode="prefill",
                         impl="plain")
    rel, agree, _, tie_ok = rel_rows(a[:, 0], b[:, 0])
    want = dict({n: 0 for n in counts}, **{kernel: scan_blocks(cfg)})
    log(f"  15c {cfg.name} trained, prefill of {tuple(prompt.shape)}: bf16"
        f" through {kernel} launches {counts}, logits finite"
        f" {bool(torch.isfinite(a16).all())}; float32 copy kernel vs plain"
        f" max|d|/max|logits| {[f'{r:.3e}' for r in rel]} (bound"
        f" {SCAN_LOGIT_BOUND}), top-1 equal {agree}")
    if counts != want or not bool(torch.isfinite(a16).all()):
        raise SystemExit(f"15c: {name}'s prefill launched {counts}, want"
                         f" {want}, or its logits are not finite")
    if max(rel) > SCAN_LOGIT_BOUND or not tie_ok:
        raise SystemExit(f"15c: {name}'s trained prefill through {kernel}"
                         " disagrees with its plain twin")
    del params32
    torch.cuda.empty_cache()
    return [r["wall_s"] for r in rows], peak


def phase_ssm_train():
    """Phase 15: 15a-15d, each timed; prints the walls beside the card."""
    walls, steps = {}, {}
    t0 = time.perf_counter()
    phase_ssm_parity()
    walls["15a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    scan_walls = phase_chunk_scans()
    walls["15b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for name in SSM:
        steps[name] = phase_ssm_full(name)
    walls["15c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for name in SSM:
        run_launcher("15d", ["--arch", name] + SSM_DEMO_ARGS)
    walls["15d"] = time.perf_counter() - t0
    log(f"  phase 15 on {PFB.card_line()}: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items())
        + "; train step " + ", ".join(
            f"{name} {min(w) * 1e3:.1f}-{max(w) * 1e3:.1f} ms (peak"
            f" {peak:.2f} GiB)" for name, (w, peak) in steps.items())
        + "; chunk scan forward and backward " + ", ".join(
            f"{tag} {w * 1e3:.1f} ms" for tag, w in scan_walls.items()))


# ---- phase 16: distribution ------------------------------------------------

def phase_dist_host():
    """16a: DIST_PAIRS traced by the dry run on the fake production mesh,
    DIST_WORKERS processes at once; each pair ok and its traced arguments
    the rules' bytes; then the planted fault must raise in `distribute`."""
    out_dir = ROOT / "build" / "chip_smoke" / "dryrun"
    t0 = time.perf_counter()
    with ProcessPoolExecutor(DIST_WORKERS, mp_context=multiprocessing
                             .get_context("spawn")) as ex:
        futures = [ex.submit(DRY.run_pair, a, s, multi_pod=mp, save=True,
                             out_dir=out_dir)
                   for a, s, mp, _ in DIST_PAIRS]
        results = [f.result() for f in futures]
    wall = time.perf_counter() - t0
    for (arch, shape, mp, rule), r in zip(DIST_PAIRS, results):
        if r["status"] != "ok":
            log(r.get("traceback", ""))
            raise SystemExit(f"16a: {arch} {shape} {r['mesh']}:"
                             f" {r['status']} {r.get('error', '')}")
        stub = types.SimpleNamespace(
            shape=dict(zip(*reversed(DRY.MULTI_POD if mp else DRY.POD))),
            axis_names=(DRY.MULTI_POD if mp else DRY.POD)[1])
        want = DRY.argument_bytes(get_config(arch), SHAPES[shape], stub)
        b, rf = r["bytes_per_device"], r["roofline"]
        coll = {k: v for k, v in r["collectives"].items() if v}
        log(f"  16a {arch} {shape} {r['mesh']} ({rule}): {r['status']},"
            f" trace {r['trace_s']} s, arguments {b['arguments'] / 2**30:.3f}"
            f" GiB/device (rules: {want}), peak {b['peak'] / 2**30:.2f} GiB,"
            f" fits_h100 {r['fits_h100']}, dominant {rf['dominant']}"
            f" (compute {rf['compute_s'] * 1e3:.1f} / memory"
            f" {rf['memory_s'] * 1e3:.1f} / collective"
            f" {rf['collective_s'] * 1e3:.1f} ms), collective bytes {coll}")
        if b["arguments"] != want:
            raise SystemExit(f"16a: {arch} {shape}: traced arguments"
                             f" {b['arguments']} != the rules' {want}")
        if (arch, shape, mp) in DIST_FIT and not r["fits_h100"]:
            raise SystemExit(f"16a: {arch} {shape} {r['mesh']}: peak"
                             f" {b['peak'] / 2**30:.2f} GiB does not fit"
                             f" one card")
        ceil = DIST_CEIL.get((arch, shape, mp))
        if ceil is not None and b["peak"] / 2**30 > ceil:
            raise SystemExit(f"16a: {arch} {shape} {r['mesh']}: peak"
                             f" {b['peak'] / 2**30:.2f} GiB above its"
                             f" ceiling {ceil} GiB")
        ceil = DIST_FLOPS.get((arch, shape, mp))
        log(f"  16a {arch} {shape} {r['mesh']}: flops a rank"
            f" {r['cost']['flops']:.4e}" + (f" (ceiling {ceil:.3e})"
                                            if ceil else ""))
        if ceil is not None and r["cost"]["flops"] > ceil:
            raise SystemExit(f"16a: {arch} {shape} {r['mesh']}: flops a"
                             f" rank {r['cost']['flops']:.4e} above its"
                             f" ceiling {ceil:.3e}")
        ceil = DIST_COLL.get((arch, shape, mp))
        if ceil is not None and r["collectives"]["total"] > ceil:
            raise SystemExit(f"16a: {arch} {shape} {r['mesh']}: collective"
                             f" bytes {r['collectives']['total'] / 1e9:.4f}"
                             f" GB above its ceiling {ceil / 1e9} GB")
    shape, spec = DIST_FAULT
    with make_production_mesh() as mesh, \
            torch._subclasses.fake_tensor.FakeTensorMode():
        try:
            distribute(torch.empty(shape, device="meta"), spec, mesh)
        except ValueError as e:
            log(f"  16a planted fault {shape} under {spec}: raised ({e})")
        else:
            raise SystemExit("16a: the planted fault (model on a"
                             " non-dividing dimension) did not raise")
    log(f"  16a {len(DIST_PAIRS)} pairs in {wall:.1f} s of host wall on"
        f" {DIST_WORKERS} processes")


def _timed(fn):
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, counts_now()


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _bit_equal(a, b):
    """Leaf by leaf: `a` (DTensors gathered) bit-equal to `b`."""
    if isinstance(a, dict):
        return all(_bit_equal(a[k], b[k]) for k in b) and set(a) == set(b)
    return torch.equal(_full(a), b)


def dist_decode(name, mesh):
    """16b: one decode step of `name` at full width on the short pool's
    shape, on plain tensors and on DTensors placed by the serve rules;
    logits and the new cache bit-equal, the same flash_decode launches."""
    cfg, params = load_model(name)
    B, T = SHORT_POOL["n_slots"], SHORT_POOL["window"]
    g = torch.Generator(device=DEVICE).manual_seed(16)
    cache = M.init_cache(cfg, B, T, device=DEVICE)
    for blk in cache.values():
        for t in blk.values():
            t.copy_(torch.randn(t.shape, generator=g, device=DEVICE))
    tokens = torch.randint(0, cfg.vocab, (B, 1), generator=g, device=DEVICE)
    pos = np.random.default_rng(16).integers(1, T, B)
    dparams = distribute(params, param_specs(cfg, params, mesh,
                                             mode="serve"), mesh)
    dtok = distribute(tokens, batch_specs(mesh, B) + (None,), mesh)
    rows = []
    with torch.no_grad():
        for _ in range(2):          # cold, then warm
            (want, wcache), plain_ms, plain_n = _timed(
                lambda: M.decode_step(params, cfg, tokens,
                                      clone_cache(cache), pos))
            dcache = distribute(clone_cache(cache), cache_specs(
                cfg, cache, mesh, batch=B), mesh)
            with set_mesh(mesh):
                (got, gcache), dt_ms, dt_n = _timed(
                    lambda: M.decode_step(dparams, cfg, dtok, dcache, pos))
            rows.append((plain_ms, dt_ms))
            equal = _bit_equal(got, want) and _bit_equal(gcache, wcache)
            if not equal or plain_n != dt_n \
                    or dt_n["flash_decode"] != cfg.attn_block_count:
                raise SystemExit(f"16b: {name}'s decode step on DTensors"
                                 f" bit-equal {equal}, launches {dt_n}"
                                 f" vs plain {plain_n}")
    log(f"  16b {name} decode {B} x {T}: logits and cache bit-equal, launches"
        f" {dt_n} in each; wall plain / DTensor cold {rows[0][0]:.1f} /"
        f" {rows[0][1]:.1f} ms, warm {rows[1][0]:.1f} / {rows[1][1]:.1f} ms")
    del params, dparams
    torch.cuda.empty_cache()
    return rows[1]


def dist_prefill(mesh):
    """16b: zamba2-2.7b prefills a DIST_PROMPT-token prompt on plain
    tensors and on DTensors; logits and states bit-equal, mamba_scan
    launched once a Mamba2 block in each."""
    name = "zamba2-2.7b"
    cfg, params = load_model(name)
    g = torch.Generator(device=DEVICE).manual_seed(17)
    tokens = torch.randint(0, cfg.vocab, (1, DIST_PROMPT), generator=g,
                           device=DEVICE)
    dparams = distribute(params, param_specs(cfg, params, mesh,
                                             mode="serve"), mesh)
    dtok = distribute(tokens, batch_specs(mesh, 1) + (None,), mesh)
    rows = []
    with torch.no_grad():
        for _ in range(2):
            (want, wcache), plain_ms, plain_n = _timed(
                lambda: M.forward(params, cfg, tokens, mode="prefill"))
            with set_mesh(mesh):
                (got, gcache), dt_ms, dt_n = _timed(
                    lambda: M.forward(dparams, cfg, dtok, mode="prefill"))
            rows.append((plain_ms, dt_ms))
            equal = _bit_equal(got, want) and _bit_equal(gcache, wcache)
            if not equal or plain_n != dt_n \
                    or dt_n["mamba_scan"] != scan_blocks(cfg):
                raise SystemExit(f"16b: {name}'s prefill on DTensors"
                                 f" bit-equal {equal}, launches {dt_n} vs"
                                 f" plain {plain_n}")
    log(f"  16b {name} prefill of {DIST_PROMPT} tokens: logits and states"
        f" bit-equal, launches {dt_n} in each; wall plain / DTensor cold"
        f" {rows[0][0]:.1f} / {rows[0][1]:.1f} ms, warm {rows[1][0]:.1f} /"
        f" {rows[1][1]:.1f} ms")
    del params, dparams
    torch.cuda.empty_cache()
    return rows[1]


def dist_train(mesh):
    """16b: one train step of llama31-8b at full width (DIST_TRAIN's
    depth and batch) on plain tensors and on DTensors placed by the train
    rules; the loss and every gradient leaf bit-equal, no kernel
    launched."""
    cfg = dataclasses.replace(get_config(DIST_TRAIN["arch"]),
                              n_repeat=DIST_TRAIN["n_repeat"])
    params = M.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(
        18), DEVICE)
    B, S = DIST_TRAIN["batch"], DIST_TRAIN["seq"]
    g = torch.Generator(device=DEVICE).manual_seed(19)
    batch = {k: torch.randint(0, cfg.vocab, (B, S), generator=g,
                              device=DEVICE) for k in ("tokens", "labels")}
    batch["labels"][0, :7] = -1                # ignored targets too
    dparams = distribute(params, param_specs(cfg, params, mesh), mesh)
    dbatch = {k: distribute(v, batch_specs(mesh, B) + (None,), mesh)
              for k, v in batch.items()}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        (loss, grads), plain_ms, plain_n = _timed(
            lambda: loss_and_grads(params, cfg, batch))
        with set_mesh(mesh):
            (dloss, dgrads), dt_ms, dt_n = _timed(
                lambda: loss_and_grads(dparams, cfg, dbatch))
    finally:
        torch.use_deterministic_algorithms(False)
    pairs = list(zip(tree_leaves(dgrads), tree_leaves(grads)))
    equal = [torch.equal(_full(a), b) for a, b in pairs]
    diff = max(float((_full(a).float() - b.float()).abs().max())
               for a, b in pairs)
    log(f"  16b {cfg.name} train step, {cfg.n_repeat} repeats, {B} x {S}:"
        f" loss plain {float(loss):.6f} / DTensor {float(_full(dloss)):.6f}"
        f" bit-equal {torch.equal(_full(dloss), loss)}; {sum(equal)} of"
        f" {len(equal)} gradient leaves bit-equal (max|diff| {diff:.3e});"
        f" launches {dt_n}; wall plain / DTensor {plain_ms:.1f} /"
        f" {dt_ms:.1f} ms")
    if not torch.equal(_full(dloss), loss) or not all(equal) \
            or any(plain_n.values()) or any(dt_n.values()):
        raise SystemExit(f"16b: {cfg.name}'s train step on DTensors is not"
                         f" the plain one's (launches {dt_n}, {plain_n})")
    del params, dparams, grads, dgrads
    torch.cuda.empty_cache()
    return plain_ms, dt_ms


def t_slices(T, R):
    """R pieces [t0, t1) of [0, T), as R ranks along T would hold them."""
    cuts = [T * i // R for i in range(R + 1)]
    return list(zip(cuts[:-1], cuts[1:]))


def sliced_decode(q, k, v, lengths, R):
    """What R ranks of a cache sharded along T run, with their pieces
    stacked: each rank's `ops.decode_piece` (the kernel over its T-piece
    at local lengths, f32 output and lse) and `ops.merge_states`, the
    merge of `ops.merge_ranks`, its all-reduces a reduction over the R
    stacked states (`ops.reduce_stacked`); q's dtype."""
    states = [ops.decode_piece(q, k[:, t0:t1], v[:, t0:t1], lengths, t0,
                               t1 - t0)
              for t0, t1 in t_slices(k.shape[1], R)]
    return ops.merge_states(torch.stack(states), ops.reduce_stacked,
                            q.dtype)[0]


def phase_seq_merge():
    """16c: at llama31-8b's decode shapes, the kernel over SEQ_SLICES
    T-pieces of one full-width cache, merged, within TOL[bf16] of the
    unsliced kernel and of the plain version; R launches a merged call
    (counts set to 0 just before, read just after); pieces that a short
    sequence leaves empty drop out.  Eager ms beside the unsliced call's."""
    dtype = torch.bfloat16
    gen = torch.Generator(device=DEVICE).manual_seed(26)
    for shape in SEQ_SHAPES:
        q, k, v, lengths = inputs(*shape, dtype, gen)
        T = shape[4]
        lengths[:4] = torch.tensor([T, 1, T // 4 - 1, T // 2 + 1],
                                   dtype=torch.int32, device=DEVICE)
        whole = flash_decode(q, k, v, lengths)
        ref = flash_decode_ref(q, k, v, lengths)
        for R in SEQ_SLICES:
            zero_counts()
            merged = sliced_decode(q, k, v, lengths, R)
            torch.cuda.synchronize()
            n = counts_now()
            empty = sum(int(((lengths - t0) <= 0).sum())
                        for t0, _ in t_slices(T, R))
            errs = [float((merged.float() - b.float()).abs().max())
                    for b in (whole, ref)]
            ok = all(torch.allclose(merged.float(), b.float(), **TOL[dtype])
                     for b in (whole, ref)) and merged.dtype == dtype
            ms = time_ms(lambda *a: sliced_decode(*a, R),
                         [(q, k, v, lengths)], 50)
            whole_ms = time_ms(flash_decode, [(q, k, v, lengths)], 50)
            log(f"  16c B,H,K,D,T={shape} in {R} T-pieces: merged vs"
                f" unsliced kernel max_abs_err {errs[0]:.3e}, vs plain"
                f" {errs[1]:.3e} ({TOL[dtype]}); flash_decode launches"
                f" {n['flash_decode']}; {empty} (piece, sequence) pairs"
                f" empty; eager {ms:.4f} ms vs unsliced {whole_ms:.4f} ms")
            if not ok or n != dict({k_: 0 for k_ in n}, flash_decode=R) \
                    or not empty:
                raise SystemExit(f"16c: the {R}-piece merge at {shape}"
                                 f" disagrees ({errs}), launched {n}, or"
                                 f" left no piece empty ({empty})")


def phase_dist():
    """Phase 16: 16a on the host, 16b on the card over an NCCL group of one
    rank (a FileStore under build/), then 16c on the card."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    phase_dist_host()
    t16a = time.perf_counter() - t0
    store = ROOT / "build" / "chip_smoke" / "pg_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1),
                            world_size=1, rank=0,
                            device_id=torch.device(DEVICE, 0))
    try:
        mesh = make_local_mesh(model=1, data=1, device=DEVICE)
        walls = {f"{n} decode": dist_decode(n, mesh) for n in DIST_DECODE}
        walls["zamba2-2.7b prefill"] = dist_prefill(mesh)
        walls[f"{DIST_TRAIN['arch']} train step"] = dist_train(mesh)
    finally:
        dist.destroy_process_group()
    t0 = time.perf_counter()
    phase_seq_merge()
    t16c = time.perf_counter() - t0
    log(f"  phase 16 on {PFB.card_line()}: 16a {t16a:.1f} s, 16c"
        f" {t16c:.1f} s; warm wall plain / DTensor " + ", ".join(
            f"{k} {a:.1f} / {b:.1f} ms" for k, (a, b) in walls.items()))


def phase_examples():
    """Phase 17: EXAMPLES run as subprocesses on the card; each must exit
    0."""
    for name in EXAMPLES:
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, str(ROOT / "examples" /
                                                  f"{name}.py")],
                             capture_output=True, text=True, cwd=ROOT,
                             timeout=EXAMPLE_TIMEOUT)
        log(f"  17 examples/{name}.py: exit {out.returncode} in"
            f" {time.perf_counter() - t0:.1f} s; last lines:")
        for line in out.stdout.strip().splitlines()[-3:]:
            log(f"    {line}")
        if out.returncode != 0:
            log(out.stderr[-4000:])
            raise SystemExit(f"17: examples/{name}.py exited"
                             f" {out.returncode}")


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
    counts, by_shape, walls, runs = phase_10(llama, zamba2, granite)
    launches.update(counts)
    fd_launches.update(by_shape)
    log(f"phase 10: {time.perf_counter() - t10:.1f} s; serve walls without"
        f" the recycled-slot checks {json.dumps(walls)}")
    t11 = time.perf_counter()
    counts = phase_11(llama, granite, runs)
    launches.update(counts)
    for tag in ("10a", "10c"):       # the same shapes and steps again
        for shape, n in runs[tag]["shapes"].items():
            fd_launches[shape] += n
    log(f"phase 11: {time.perf_counter() - t11:.1f} s")
    del runs
    del llama, zamba2, granite
    torch.cuda.empty_cache()
    log("[12] drain: the compiled fleet drain (engine=\"graph\") vs numpy")
    t12 = time.perf_counter()
    phase_drain()
    log(f"phase 12: {time.perf_counter() - t12:.1f} s")
    log("[13] search: the topology search drained by the graph engine vs"
        " numpy, and the paper's tables")
    t13 = time.perf_counter()
    phase_search()
    log(f"phase 13: {time.perf_counter() - t13:.1f} s")
    log("[14] train: loss, gradients and AdamW on the card; whisper's"
        " encoder and cross-attention, llava's patch prefix")
    t14 = time.perf_counter()
    phase_train()
    log(f"phase 14: {time.perf_counter() - t14:.1f} s")
    log("[15] SSM training: zamba2 and rwkv6 through the chunk scans of"
        " models/ssm.py")
    t15 = time.perf_counter()
    phase_ssm_train()
    log(f"phase 15: {time.perf_counter() - t15:.1f} s")
    log("[16] distribution: the dry run's pairs on the fake production"
        " mesh, DTensor steps on a (1, 1) mesh on the card, flash_decode"
        " over T-pieces merged")
    t16 = time.perf_counter()
    phase_dist()
    log(f"phase 16: {time.perf_counter() - t16:.1f} s")
    log("[17] examples: the examples/ twins of serve_demo.py and"
        " train_demo.py on the card")
    t17 = time.perf_counter()
    phase_examples()
    log(f"phase 17: {time.perf_counter() - t17:.1f} s")
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
