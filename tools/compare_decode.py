#!/usr/bin/env python3
"""Time the port's decode kernels against another checkout's, on one card.

  python3 tools/compare_decode.py --parent DIR [--out FILE]

DIR is the root of another checkout of this repository (for example a
`git archive` of the parent commit unpacked into a directory that
.gitignore lists).  `flash_decode_int8` and bf16 `flash_decode` of both
checkouts are built from their own sources and timed at every shape
chip_smoke.py's `time_int8` times (`INT8_SHAPES`: the JAX int8 test's
shapes, the four serve shapes, the ragged T, 16 x 1024, 16 x 8192 and the
paper's 64K window 4 x 65536), on the same seeded inputs in both: bf16 K/V
and the `quantize_kv` codes and scales of them, lengths random in [1, T]
per shape and the same in every input set.  Each kernel is timed as one
CUDA-graph replay of 50 calls cycling through input sets (more than 3x the
50 MB L2 in int8 bytes, at most 256), with CUDA events: device ms per
call, without the host's per-call work.  Each checkout runs in a process
of its own, in the order parent, this, this, parent, on the same card; the
summary gives the mean of the two runs of each beside the bounds
(chip_smoke.py's `int8_bound` and `bound`).  The bf16 outputs at the
serve shapes (`MAIN`) and the int8 outputs at every shape are saved by
each run and compared: bf16 must be bit-identical between the checkouts
(and between runs); int8 is reported as the max abs difference.  Prints
the card's name and power limit, one JSON line per run and, last, one
JSON summary line; `--out` also writes the summary.  Needs one CUDA card;
exits 1 if a run fails or the bf16 outputs differ.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
L2_BYTES = 50e6
ITERS = 50


def shapes() -> tuple[list, list]:
    """chip_smoke.py's INT8_SHAPES and MAIN (this checkout's)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return ([list(s) for s in chip_smoke.INT8_SHAPES],
            [list(s) for s in chip_smoke.MAIN])


def worker(src: str, shape_list: list, main: list, save: str) -> dict:
    """Device ms per call of both decode kernels of the package under
    `src` at every shape; saves the outputs of the first input set."""
    sys.path.insert(0, src)
    import torch
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import flash_decode_int8 as FD8

    def graph_ms(fn, sets):
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
        del graph
        return start.elapsed_time(end) / ITERS

    out, saved = {}, {}
    for shape in shape_list:
        B, H, K, D, T = shape
        gen = torch.Generator(device="cuda").manual_seed(sum(shape))
        lengths = torch.randint(1, T + 1, (B,), generator=gen,
                                device="cuda", dtype=torch.int32)
        per_set = B * T * K * (2 * D + 8)
        n = min(256, max(1, math.ceil(3 * L2_BYTES / per_set)))
        f16, i8 = [], []
        for _ in range(n):
            q = torch.randn(B, H, D, generator=gen,
                            device="cuda").to(torch.bfloat16)
            k = torch.randn(B, T, K, D, generator=gen,
                            device="cuda").to(torch.bfloat16)
            v = torch.randn(B, T, K, D, generator=gen,
                            device="cuda").to(torch.bfloat16)
            f16.append((q, k, v, lengths))
            i8.append((q, *FD8.quantize_kv(k, v), lengths))
        key = ",".join(map(str, shape))
        saved[f"int8:{key}"] = FD8.flash_decode_int8(*i8[0]).cpu()
        if list(shape) in main:
            saved[f"bf16:{key}"] = FD.flash_decode(*f16[0]).cpu()
        out[f"int8:{key}"] = graph_ms(FD8.flash_decode_int8, i8)
        out[f"bf16:{key}"] = graph_ms(FD.flash_decode, f16)
        out[f"lengths:{key}"] = lengths.tolist()
        del f16, i8
        torch.cuda.empty_cache()
    torch.save(saved, save)
    return out


def bounds(shape: tuple, lengths: list) -> tuple[float, float]:
    """(int8 bound ms, bf16 bound ms) at `shape` with these lengths."""
    import torch
    import chip_smoke
    B, H, K, D, T = shape
    q = torch.empty(B, H, D, dtype=torch.bfloat16, device="meta")
    kq = torch.empty(B, T, K, D, dtype=torch.int8, device="meta")
    k = torch.empty(B, T, K, D, dtype=torch.bfloat16, device="meta")
    lens = torch.tensor(lengths, dtype=torch.int32)
    return (chip_smoke.int8_bound(q, kq, lens)[0],
            chip_smoke.bound(q, k, lens)[0])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="root of the other checkout")
    ap.add_argument("--out", help="also write the summary here")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--save", help=argparse.SUPPRESS)
    ap.add_argument("--shapes", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        row = worker(args.worker, *json.loads(args.shapes), args.save)
        print(json.dumps(row), flush=True)
        return 0
    shape_list, main_shapes = shapes()
    import torch
    if not torch.cuda.is_available() or not args.parent:
        print("compare_decode: needs a CUDA card and --parent",
              file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0])
    trees = {"parent": str(Path(args.parent).resolve() / "src"),
             "this": str(ROOT / "src")}
    runs = {"parent": [], "this": []}
    outs = {"parent": [], "this": []}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for i, who in enumerate(("parent", "this", "this", "parent")):
            save = str(Path(tmp) / f"{i}.pt")
            res = subprocess.run([sys.executable, __file__, "--worker",
                                  trees[who], "--save", save, "--shapes",
                                  json.dumps([shape_list, main_shapes])],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                print(res.stdout + res.stderr, file=sys.stderr)
                return 1
            row = json.loads(res.stdout.strip().splitlines()[-1])
            runs[who].append(row)
            outs[who].append(torch.load(save))
            print(json.dumps({"run": who, "device_ms": row}), flush=True)
    bf16_equal = all(
        torch.equal(a[k], b[k]) for a in outs["this"] + outs["parent"]
        for b in outs["this"] + outs["parent"] for k in a
        if k.startswith("bf16:"))
    summary = []
    for shape in shape_list:
        key = ",".join(map(str, shape))
        lengths = runs["this"][0][f"lengths:{key}"]
        b8, b16 = bounds(shape, lengths)
        row = dict(shape=dict(zip("BHKDT", shape)), lengths=lengths,
                   int8_bound_ms=b8, bf16_bound_ms=b16,
                   int8_max_abs_diff_vs_parent=float(
                       (outs["this"][0][f"int8:{key}"].float()
                        - outs["parent"][0][f"int8:{key}"].float())
                       .abs().max()))
        for kind in ("int8", "bf16"):
            this = [r[f"{kind}:{key}"] for r in runs["this"]]
            parent = [r[f"{kind}:{key}"] for r in runs["parent"]]
            row.update({f"{kind}_device_ms": sum(this) / 2,
                        f"{kind}_parent_device_ms": sum(parent) / 2,
                        f"{kind}_runs_this": this,
                        f"{kind}_runs_parent": parent})
        row["int8_bound_share"] = b8 / row["int8_device_ms"]
        summary.append(row)
        print(f"  {key:>20s} int8 {row['int8_device_ms']:.5f} (parent"
              f" {row['int8_parent_device_ms']:.5f},"
              f" {row['int8_parent_device_ms'] / row['int8_device_ms']:.2f}x;"
              f" bound {b8:.5f}, {row['int8_bound_share']:.0%}) bf16"
              f" {row['bf16_device_ms']:.5f} (parent"
              f" {row['bf16_parent_device_ms']:.5f}) int8/bf16"
              f" {row['int8_device_ms'] / row['bf16_device_ms']:.2f}")
    print(f"  bf16 outputs bit-identical across checkouts and runs at the"
          f" serve shapes: {bf16_equal}")
    line = json.dumps({"card": torch.cuda.get_device_name(0),
                       "bf16_bit_identical": bf16_equal,
                       "shapes": summary})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0 if bf16_equal else 1


if __name__ == "__main__":
    sys.exit(main())
