#!/usr/bin/env python3
"""Two of the port's dry-run sweeps compared, pair by pair.

  PYTHONPATH=src python3 tools/port_opt_vs_baseline.py --baseline DIR
      --new DIR [--mesh pod16x16]

The twin of `benchmarks/opt_vs_baseline.py`: for every pair `ok` in both
directories of `python -m repro_torch.launch.dryrun` JSON files, the
bounding roofline term (the largest of compute, memory and collective, in
ms on the H100's constants) before and after, their ratio and the
dominant term after, then the geometric mean of the ratios.  The port
keeps no committed baseline snapshot: both sides are directories the
caller names (say, a parent checkout's sweep and this tree's).  The terms
are projections from host traces, not measurements.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np


def rows_for(base: pathlib.Path, new: pathlib.Path,
             mesh: str = "pod16x16"):
    rows = []
    for f in sorted(pathlib.Path(new).glob(f"*_{mesh}.json")):
        b = pathlib.Path(base) / f.name
        if not b.exists():
            continue
        rb, rn = json.loads(b.read_text()), json.loads(f.read_text())
        if rb.get("status") != "ok" or rn.get("status") != "ok":
            continue
        tb = max(rb["roofline"][k]
                 for k in ("compute_s", "memory_s", "collective_s"))
        tn = max(rn["roofline"][k]
                 for k in ("compute_s", "memory_s", "collective_s"))
        rows.append(dict(pair=f.name.replace(f"_{mesh}.json", ""),
                         baseline_ms=round(tb * 1e3, 2),
                         optimized_ms=round(tn * 1e3, 2),
                         ratio=round(tn / tb, 3),
                         dominant_after=rn["roofline"]["dominant"]))
    return rows


def run(base: pathlib.Path, new: pathlib.Path, mesh: str = "pod16x16"):
    rows = rows_for(base, new, mesh)
    if not rows:
        return [], "no pair ok in both sweeps"
    g = float(np.exp(np.mean([np.log(r["ratio"]) for r in rows])))
    best = min(rows, key=lambda r: r["ratio"])
    return rows, (f"geomean bounding-term ratio {g:.2f} over {len(rows)} "
                  f"pairs; best {best['pair']} at {best['ratio']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", required=True)
    ap.add_argument("--new", required=True)
    ap.add_argument("--mesh", default="pod16x16")
    args = ap.parse_args(argv)
    rows, derived = run(pathlib.Path(args.baseline),
                        pathlib.Path(args.new), args.mesh)
    for r in rows:
        print(json.dumps(r))
    print(derived)
    return 0


if __name__ == "__main__":
    sys.exit(main())
