#!/usr/bin/env python3
"""Which tensor sets a dry-run pair's memory peak.

  PYTHONPATH=src python3 tools/dryrun_peak_tensor.py --arch A --shape S
      [--repeats 1,2] [--multi-pod]

Traces the pair as `repro_torch.launch.dryrun` does, at each given number
of repeats of the layer stack (whisper's encoder layers alike; a cut
depth keeps the trace short where the peak lies in the head), and prints
per depth the peak GiB per device and the op, shape and dtype of the
tensor whose allocation set it (`StepRecorder.peak_at`).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.mesh import MULTI_POD, POD, fake_mesh  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--repeats", default="1,2")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    with fake_mesh(*(MULTI_POD if args.multi_pod else POD)) as mesh:
        for k in map(int, args.repeats.split(",")):
            enc = dataclasses.replace(cfg.encoder, n_layers=k) \
                if cfg.encoder is not None else None
            r = D.trace_pair(args.arch, args.shape, mesh, cfg=dataclasses
                             .replace(cfg, n_repeat=k, encoder=enc))
            print(f"{args.arch} {args.shape} at {k} repeats: peak"
                  f" {r['bytes_per_device']['peak'] / 2**30:.2f} GiB/device,"
                  f" set by {r['peak_set_by']}")


if __name__ == "__main__":
    main()
