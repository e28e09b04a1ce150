#!/usr/bin/env python3
"""Time the port's scan kernels against another checkout's, on one card.

  python3 tools/compare_scans.py --parent DIR [--out FILE]

DIR is the root of another checkout of this repository (for example a
`git archive` of the parent commit unpacked into a directory that
.gitignore lists).  `mamba_scan` (zamba2-2.7b's prefill width: nh 80,
hd = ds = 64) and `wkv6` (rwkv6-1.6b's: H 32, hd 64) of both checkouts are
built from their own sources and timed at every prompt length that
chip_smoke.py's serve phase prefills (`launch/serve.py` `demo_requests`,
azure-conv, 16 requests, window_long 1024), each as one CUDA-graph replay
of 50 calls cycling through seeded input sets (more than 3x the 50 MB L2,
at most 256), timed with CUDA events: device ms per call, without the
host's per-call work.  Each checkout runs in a process of its own, in the
order parent, this, this, parent, on the same card; the summary gives the
mean of the two runs of each beside the bound (chip_smoke.py's
`scan_bound`).  Each run also times the full-width bf16 prefill of
zamba2-2.7b and rwkv6-1.6b (seeded random weights, as chip_smoke.py makes
them) at PREFILL_LENGTHS, host clock to synchronize, the median of 3
after one warm-up prefill at that length: the scans' effect end to end.
Prints the card's name and power limit, one JSON line per run and, last,
one JSON summary line; `--out` also writes the summary.  Needs one CUDA
card.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WIDTH = {"mamba_scan": (80, 64, 64), "wkv6": (32, 64)}
L2_BYTES = 50e6
ITERS = 50
PREFILL_LENGTHS = (300, 1000)


def served_lengths() -> list:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.serve import demo_requests
    return sorted({len(r.prompt) for r in
                   demo_requests(1000, "azure-conv", 16, 1024)})


def worker(src: str, lengths: list) -> dict:
    """Device ms per call of both scans of the package under `src`, and
    its warm prefill walls."""
    sys.path.insert(0, src)
    import torch
    from repro_torch.kernels import mamba_scan as MS
    from repro_torch.kernels import wkv6 as WK
    fns = {"mamba_scan": MS.mamba_scan, "wkv6": WK.wkv6}
    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(kind, S):
        def randn(*s):
            return torch.randn(*s, generator=gen, device="cuda")
        if kind == "mamba_scan":
            nh, hd, ds = WIDTH[kind]
            return (randn(1, S, nh, hd), randn(1, S, ds), randn(1, S, ds),
                    -0.5 * torch.rand(1, S, nh, generator=gen,
                                      device="cuda"))
        H, hd = WIDTH[kind]
        w = 0.05 + 0.95 * torch.rand(1, S, H, hd, generator=gen,
                                     device="cuda")
        return randn(1, S, H, hd), randn(1, S, H, hd), randn(1, S, H, hd), \
            w, 0.5 * randn(H, hd)

    out = {}
    for kind, fn in fns.items():
        for S in lengths:
            first = inputs(kind, S)
            per_set = sum(a.numel() * 4 for a in first)
            n = min(256, max(1, math.ceil(3 * L2_BYTES / per_set)))
            sets = [first] + [inputs(kind, S) for _ in range(n - 1)]
            for args in sets[:2]:
                fn(*args)
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for i in range(ITERS):
                    fn(*sets[i % len(sets)])
            graph.replay()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            out[f"{kind}:{S}"] = start.elapsed_time(end) / ITERS
            del graph, sets
    out.update(prefill_walls())
    return out


def prefill_walls() -> dict:
    """Warm bf16 prefill wall ms of the two SSM models at full width."""
    import time

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    out = {}
    for name in ("zamba2-2.7b", "rwkv6-1.6b"):
        cfg = get_config(name)
        params = M.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        gen = torch.Generator(device="cuda").manual_seed(2)
        with torch.inference_mode():
            for S in PREFILL_LENGTHS:
                prompt = torch.randint(0, cfg.vocab, (1, S), generator=gen,
                                       device="cuda")
                walls = []
                for _ in range(4):   # one warm-up, then 3 timed
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    M.forward(params, cfg, prompt, mode="prefill")
                    torch.cuda.synchronize()
                    walls.append(1e3 * (time.perf_counter() - t0))
                out[f"prefill:{name}:{S}"] = sorted(walls[1:])[1]
        del params
        torch.cuda.empty_cache()
    return out


def bound_ms(kind: str, S: int) -> float:
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke.scan_bound(kind, (1, S) + WIDTH[kind])[0]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="root of the other checkout")
    ap.add_argument("--out", help="also write the summary here")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--lengths", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker,
                                json.loads(args.lengths))), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available() or not args.parent:
        print("compare_scans: needs a CUDA card and --parent",
              file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0])
    lengths = served_lengths()
    trees = {"parent": str(Path(args.parent).resolve() / "src"),
             "this": str(ROOT / "src")}
    runs = {"parent": [], "this": []}
    for who in ("parent", "this", "this", "parent"):
        res = subprocess.run([sys.executable, __file__, "--worker",
                              trees[who], "--lengths", json.dumps(lengths)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return 1
        row = json.loads(res.stdout.strip().splitlines()[-1])
        runs[who].append(row)
        print(json.dumps({"run": who, "device_ms": row}), flush=True)
    summary = []
    for key in runs["this"][0]:
        if key.startswith("prefill:"):
            continue
        kind, S = key.split(":")
        this = [r[key] for r in runs["this"]]
        parent = [r[key] for r in runs["parent"]]
        summary.append(dict(
            kernel=kind, S=int(S), device_ms=sum(this) / 2,
            parent_device_ms=sum(parent) / 2,
            bound_ms=bound_ms(kind, int(S)), runs_this=this,
            runs_parent=parent))
    for r in summary:
        print(f"  {r['kernel']:10s} S={r['S']:5d} device_ms"
              f" {r['device_ms']:.5f} parent {r['parent_device_ms']:.5f}"
              f" ({r['parent_device_ms'] / r['device_ms']:.2f}x) bound"
              f" {r['bound_ms']:.5f}")
    prefill = []
    for key in runs["this"][0]:
        if key.startswith("prefill:"):
            _, name, S = key.split(":")
            this = [r[key] for r in runs["this"]]
            parent = [r[key] for r in runs["parent"]]
            prefill.append(dict(model=name, S=int(S),
                                wall_ms=sum(this) / 2,
                                parent_wall_ms=sum(parent) / 2,
                                runs_this=this, runs_parent=parent))
            print(f"  prefill {name:12s} S={S:>5s} wall_ms"
                  f" {sum(this) / 2:.2f} parent {sum(parent) / 2:.2f}"
                  f" (runs {this} / {parent})")
    line = json.dumps({"card": torch.cuda.get_device_name(0),
                       "scans": summary, "prefill": prefill})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
