#!/usr/bin/env python3
"""The port's dry run beside the reference's, pair by pair.

  python3 tools/port_vs_reference_dryrun.py --port DIR --reference DIR
      [--shape S]

DIR holds one JSON file a pair, `{arch}_{shape}_{mesh}.json`: the port's
from `python -m repro_torch.launch.dryrun --all --out DIR`, the
reference's from `python -m repro.launch.dryrun`, which writes into its
checkout's `benchmarks/results/dryrun/` (run it in a `git archive` copy,
so that this checkout's results stay as they are).  For every pair in
either directory it prints a row: each side's status, the port's peak
(`bytes_per_device.peak`) and the reference's (`peak_estimate`) in GiB a
device, their ratio, each side's flops a rank (`roofline.flops`) and
their ratio, each side's collective bytes (all-gather and total, GB a
device; the reference's as its dry run reports them) and the tensor
that set the port's peak (`peak_set_by`).  Reads JSON only: it imports
neither package and writes nothing.

The two sides count differently.  The port traces every repeat and every
step of a loop.  The reference's compiled HLO counts a loop body once:
its flops are low wherever a scan runs inside a step, so a ratio above
1 is no fault by itself.  Where nothing loops the two agree: rwkv6-1.6b's
pure data-parallel train_4k reads 1.00x; whisper-medium's, where nothing
is sharded either, 1.46x (its encoder's and decoder's attention chunk
loops).  The port's own flops, split by op, show a fault.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

GIB = 2 ** 30


def load(d: pathlib.Path) -> dict:
    out = {}
    for f in sorted(d.glob("*.json")):
        r = json.loads(f.read_text())
        if {"arch", "shape", "mesh"} <= set(r):
            out[(r["arch"], r["shape"], r["mesh"])] = r
    return out


def _peak(r, key):
    if r is None or r.get("status") != "ok":
        return None
    return r["bytes_per_device"][key] / GIB


def _coll(r, kind):
    if r is None or r.get("status") != "ok":
        return None
    return r.get("collectives", {}).get(kind, 0) / 1e9


def _flops(r):
    if r is None or r.get("status") != "ok":
        return None
    return r.get("roofline", {}).get("flops")


def _f(x, spec=".2f"):
    return "-" if x is None else format(x, spec)


def rows(port: dict, ref: dict, shape=None):
    for key in sorted(set(port) | set(ref)):
        if shape and key[1] != shape:
            continue
        p, r = port.get(key), ref.get(key)
        pp, rp = _peak(p, "peak"), _peak(r, "peak_estimate")
        pf, rf = _flops(p), _flops(r)
        yield dict(
            pair=key, port=p["status"] if p else "absent",
            reference=r["status"] if r else "absent",
            peak=pp, ref_peak=rp,
            ratio=pp / rp if pp is not None and rp else None,
            flops=pf, ref_flops=rf,
            flops_ratio=pf / rf if pf is not None and rf else None,
            ag=_coll(p, "all-gather"), ref_ag=_coll(r, "all-gather"),
            total=_coll(p, "total"), ref_total=_coll(r, "total"),
            set_by=(p or {}).get("peak_set_by", ""))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--port", required=True, type=pathlib.Path)
    ap.add_argument("--reference", required=True, type=pathlib.Path)
    ap.add_argument("--shape", default=None)
    args = ap.parse_args(argv)
    head = ("| arch | shape | mesh | status port / ref | peak GiB port | "
            "ref | ratio | flops a rank port / ref | ratio | all-gather GB"
            " port / ref | collectives GB port / ref | port's peak set by |")
    print(head)
    print("|" + "---|" * head.count(" | ") + "---|")
    for row in rows(load(args.port), load(args.reference), args.shape):
        arch, shape, mesh = row["pair"]
        print(f"| {arch} | {shape} | {mesh} | {row['port']} / "
              f"{row['reference']} | {_f(row['peak'])} | "
              f"{_f(row['ref_peak'])} | {_f(row['ratio'])} | "
              f"{_f(row['flops'], '.3e')} / {_f(row['ref_flops'], '.3e')} | "
              f"{_f(row['flops_ratio'])} | "
              f"{_f(row['ag'], '.3f')} / {_f(row['ref_ag'], '.3f')} | "
              f"{_f(row['total'], '.3f')} / {_f(row['ref_total'], '.3f')} | "
              f"{row['set_by']} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
