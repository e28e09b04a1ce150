#!/usr/bin/env python3
"""Time full-width prefills of two checkouts of the port on one card.

  python3 tools/compare_prefill.py --parent DIR [--out FILE]

DIR is the root of another checkout of this repository (for example a
`git archive` of the parent commit unpacked into a directory that
.gitignore lists).  Each checkout prefills llama31-8b, zamba2-2.7b,
granite-moe-1b-a400m and rwkv6-1.6b at full width and depth (bf16, seeded
random weights, the same in both) on one prompt at each of chip_smoke.py's
served lengths PLENS (37, 300, 600, 1000): per length one warm-up prefill,
then the median of REPEATS host walls (the host clock to
`torch.cuda.synchronize`) and the peak of device memory the prefill adds
over the weights (`torch.cuda.max_memory_allocated`; no earlier
prefill's result is held when the base is read: one freed during the
measurement would understate the peak by its size).  Each checkout runs
in a process of its own, in the order parent, this, this, parent, on the
same card; the summary gives the mean of each checkout's two runs, and the
last-position logits of this checkout against the parent's as
max|d| / max|logits|.  rwkv6 has no attention: a control for the host's
spread.  Prints the card's name and power limit, one JSON line per run
and, last, one JSON summary line; `--out` also writes the summary.  Needs
one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MODELS = ("llama31-8b", "zamba2-2.7b", "granite-moe-1b-a400m", "rwkv6-1.6b")
PLENS = (37, 300, 600, 1000)
REPEATS = 5


def worker(src: str, save: str) -> dict:
    """Prefill walls and peaks of the package under `src`; saves the
    last-position logits."""
    sys.path.insert(0, src)
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    row, logits = {}, {}
    with torch.no_grad():
        for name in MODELS:
            cfg = get_config(name)
            params = M.init_params(
                cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
            gen = torch.Generator(device="cuda").manual_seed(1)
            for S in PLENS:
                prompt = torch.randint(0, cfg.vocab, (1, S), generator=gen,
                                       device="cuda")
                M.forward(params, cfg, prompt, mode="prefill")
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                walls = []
                for _ in range(REPEATS):
                    out = None          # no earlier result held
                    t0 = time.perf_counter()
                    out = M.forward(params, cfg, prompt, mode="prefill")[0]
                    torch.cuda.synchronize()
                    walls.append(1e3 * (time.perf_counter() - t0))
                key = f"{name}:{S}"
                row[key] = dict(
                    wall_ms=sorted(walls)[REPEATS // 2],
                    peak_gib=(torch.cuda.max_memory_allocated() - base)
                    / 2**30)
                logits[key] = out[0, -1].float().cpu()
                del out                 # before the next length's base
            del params
            torch.cuda.empty_cache()
    torch.save(logits, save)
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="root of the other checkout")
    ap.add_argument("--out", help="also write the summary here")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--save", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.save)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available() or not args.parent:
        print("compare_prefill: needs a CUDA card and --parent",
              file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    trees = {"parent": str(Path(args.parent).resolve() / "src"),
             "this": str(ROOT / "src")}
    runs = {"parent": [], "this": []}
    outs = {}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for i, who in enumerate(("parent", "this", "this", "parent")):
            save = str(Path(tmp) / f"{i}.pt")
            res = subprocess.run([sys.executable, __file__, "--worker",
                                  trees[who], "--save", save],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                print(res.stdout + res.stderr, file=sys.stderr)
                return 1
            runs[who].append(json.loads(res.stdout.strip().splitlines()[-1]))
            outs.setdefault(who, torch.load(save))
            print(json.dumps({"run": who, "prefill": runs[who][-1]}),
                  flush=True)
    summary = {}
    for key in runs["this"][0]:
        a, b = outs["this"][key], outs["parent"][key]
        summary[key] = {
            f"{m}{suffix}": sum(r[key][m] for r in runs[who]) / 2
            for who, suffix in (("this", ""), ("parent", "_parent"))
            for m in ("wall_ms", "peak_gib")}
        summary[key]["logits_rel_vs_parent"] = float(
            (a - b).abs().max() / b.abs().max())
        print(f"  {key:>26s} wall {summary[key]['wall_ms']:8.2f} ms"
              f" (parent {summary[key]['wall_ms_parent']:8.2f}), peak"
              f" {summary[key]['peak_gib']:.3f} GiB (parent"
              f" {summary[key]['peak_gib_parent']:.3f}), logits vs parent"
              f" {summary[key]['logits_rel_vs_parent']:.3e}")
    line = json.dumps({"card": card, "prefill": summary})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
