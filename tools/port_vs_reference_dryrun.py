#!/usr/bin/env python3
"""The port's dry run beside the reference's, pair by pair.

  python3 tools/port_vs_reference_dryrun.py --port DIR --reference DIR
      [--reference-held DIR] [--shape S]

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
that set the port's peak (`peak_set_by`).  With `--reference-held DIR`
(tools/reference_dryrun_held.py's JSON) each row also gives the
reference's flops a rank, all-gather and total collective bytes under the
full model's sharding plan, and the port's ratio to each.  Reads JSON
only: it imports neither package and writes nothing.

Whose plan a number comes from.  The port traces the full model, so its
numbers are the full model's plan.  The reference's peaks are its full
compile's too, but its flops and collectives as reported come from 1- and
2-repeat cuts, each sharded by its own parameter count: a cut granite-3-8b,
yi-6b, h2o-danube-3-4b or llava-next-34b trains as pure data parallelism,
and the cuts of command-r-plus-104b and grok-1-314b serve without FSDP and
train without the sequence-parallel residual.  Hold the port's flops and
collectives to the held columns; the reported ones stand only where the
plan does not change with depth (the held tool says which: `compiled`).

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


def _held(r, key, kind=None):
    if r is None or r.get("status") != "ok" or "held" not in r:
        return None
    if kind is None:
        return r["held"][key]
    return r["held"][key].get(kind, 0) / 1e9


def _ratio(a, b):
    return a / b if a is not None and b else None


def _f(x, spec=".2f"):
    return "-" if x is None else format(x, spec)


def rows(port: dict, ref: dict, shape=None, held=None):
    held = held or {}
    for key in sorted(set(port) | set(ref)):
        if shape and key[1] != shape:
            continue
        p, r, h = port.get(key), ref.get(key), held.get(key)
        pp, rp = _peak(p, "peak"), _peak(r, "peak_estimate")
        pf, rf, hf = _flops(p), _flops(r), _held(h, "flops")
        ag, total = _coll(p, "all-gather"), _coll(p, "total")
        h_ag = _held(h, "collectives", "all-gather")
        h_total = _held(h, "collectives", "total")
        yield dict(
            pair=key, port=p["status"] if p else "absent",
            reference=r["status"] if r else "absent",
            peak=pp, ref_peak=rp, ratio=_ratio(pp, rp),
            flops=pf, ref_flops=rf, flops_ratio=_ratio(pf, rf),
            ag=ag, ref_ag=_coll(r, "all-gather"),
            total=total, ref_total=_coll(r, "total"),
            held_flops=hf, held_flops_ratio=_ratio(pf, hf),
            held_ag=h_ag, held_ag_ratio=_ratio(ag, h_ag),
            held_total=h_total, held_total_ratio=_ratio(total, h_total),
            set_by=(p or {}).get("peak_set_by", ""))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--port", required=True, type=pathlib.Path)
    ap.add_argument("--reference", required=True, type=pathlib.Path)
    ap.add_argument("--reference-held", default=None, type=pathlib.Path,
                    help="tools/reference_dryrun_held.py's JSON directory")
    ap.add_argument("--shape", default=None)
    args = ap.parse_args(argv)
    held = load(args.reference_held) if args.reference_held else None
    head = ("| arch | shape | mesh | status port / ref | peak GiB port | "
            "ref | ratio | flops a rank port / ref | ratio | all-gather GB"
            " port / ref | collectives GB port / ref |"
            + (" flops a rank held | port / held | all-gather GB held |"
               " port / held | collectives GB held | port / held |"
               if held is not None else "")
            + " port's peak set by |")
    print(head)
    print("|" + "---|" * head.count(" | ") + "---|")
    for row in rows(load(args.port), load(args.reference), args.shape,
                    held):
        arch, shape, mesh = row["pair"]
        cells = (f" {_f(row['held_flops'], '.3e')} |"
                 f" {_f(row['held_flops_ratio'])} |"
                 f" {_f(row['held_ag'], '.3f')} |"
                 f" {_f(row['held_ag_ratio'])} |"
                 f" {_f(row['held_total'], '.3f')} |"
                 f" {_f(row['held_total_ratio'])} |"
                 if held is not None else "")
        print(f"| {arch} | {shape} | {mesh} | {row['port']} / "
              f"{row['reference']} | {_f(row['peak'])} | "
              f"{_f(row['ref_peak'])} | {_f(row['ratio'])} | "
              f"{_f(row['flops'], '.3e')} / {_f(row['ref_flops'], '.3e')} | "
              f"{_f(row['flops_ratio'])} | "
              f"{_f(row['ag'], '.3f')} / {_f(row['ref_ag'], '.3f')} | "
              f"{_f(row['total'], '.3f')} / {_f(row['ref_total'], '.3f')} |"
              f"{cells} {row['set_by']} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
