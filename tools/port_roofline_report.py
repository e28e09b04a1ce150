#!/usr/bin/env python3
"""The roofline table of the port's dry run.

  PYTHONPATH=src python3 tools/port_roofline_report.py [--results DIR]
      [--mesh pod16x16] [--out FILE]

The twin of `benchmarks/roofline_report.py`: one row per (arch x shape)
of `python -m repro_torch.launch.dryrun`'s JSON files (default
build/port_dryrun/) with the three roofline terms in ms, the dominant one,
MODEL_FLOPS (6·N·D for training, 2·N·D for prefill, 2·N·batch for decode,
N the streamed parameters) and its ratio to the traced flops of all
CHIPS = 256 ranks, and the peak GiB per device.  The terms are the dry
run's, on the H100's constants (`launch.hlo_analysis`); they are
projections from a trace on the host, not measurements.  Prints the rows
and the `derived` summary; `--out` writes them as JSON.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

from repro_torch.configs import get_config
from repro_torch.launch.dryrun import RESULTS_DIR
from repro_torch.launch.shapes import SHAPES

CHIPS = 256  # single-pod roofline table


def model_flops(arch: str, shape_name: str) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE); decode D = global_batch tokens."""
    cfg = get_config(arch.replace("-swa", "") if arch.endswith("-swa")
                     else arch)
    n = cfg.analytical_spec().streamed_params
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch          # decode: 1 token/seq


def rows_for(results: pathlib.Path = RESULTS_DIR, mesh: str = "pod16x16"):
    rows = []
    for f in sorted(pathlib.Path(results).glob(f"*_{mesh}.json")):
        r = json.loads(f.read_text())
        if r["status"] != "ok":
            rows.append(dict(arch=r["arch"], shape=r["shape"],
                             status=r["status"],
                             note=r.get("reason", r.get("error", ""))[:60]))
            continue
        rf = r["roofline"]
        mf = model_flops(r["arch"], r["shape"])
        traced_total = rf["flops"] * CHIPS
        rows.append(dict(
            arch=r["arch"], shape=r["shape"], status="ok",
            compute_ms=round(rf["compute_s"] * 1e3, 3),
            memory_ms=round(rf["memory_s"] * 1e3, 3),
            collective_ms=round(rf["collective_s"] * 1e3, 3),
            dominant=rf["dominant"],
            model_flops=f"{mf:.2e}",
            useful_flops_ratio=round(mf / traced_total, 3)
            if traced_total else 0,
            gib_per_device=round(r["bytes_per_device"]["peak"] / 2 ** 30, 2),
            fits_h100=r["fits_h100"]))
    return rows


def run(results: pathlib.Path = RESULTS_DIR, mesh: str = "pod16x16"):
    rows = rows_for(results, mesh)
    ok = [r for r in rows if r["status"] == "ok"]
    if not ok:
        return rows, "dry-run sweep not yet executed"
    dom = {}
    for r in ok:
        dom[r["dominant"]] = dom.get(r["dominant"], 0) + 1
    return rows, f"pairs={len(rows)} ok={len(ok)} dominant_terms={dom}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default=str(RESULTS_DIR))
    ap.add_argument("--mesh", default="pod16x16")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rows, derived = run(pathlib.Path(args.results), args.mesh)
    for r in rows:
        print(json.dumps(r))
    print(derived)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(
            {"rows": rows, "derived": derived}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
