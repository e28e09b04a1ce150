#!/usr/bin/env python3
"""Which tensor sets a dry-run pair's memory peak.

  PYTHONPATH=src python3 tools/dryrun_peak_tensor.py --arch A --shape S
      [--repeats 1,2] [--multi-pod]

Traces the pair as `repro_torch.launch.dryrun` does, at each given number
of repeats of the layer stack (whisper's encoder layers alike; a cut
depth keeps the trace short where the peak lies in the head), and prints
per depth the peak GiB per device and the op, shape and dtype of the
tensor whose allocation set it (`StepRecorder.peak_at`).  A cut config is
sharded as the full one (`cut_depth`).  Repeats 0 traces the full depth.
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
from repro_torch.models.spec import ArchConfig  # noqa: E402


@dataclasses.dataclass(frozen=True)
class CutConfig(ArchConfig):
    """A config at a cut depth whose `param_count()` is its full depth's,
    so that the launch layer's choices by model size (pure data
    parallelism below 3e9 parameters, FSDP above 8e9, the sequence-parallel
    residual above 3e10) stay those of the full config.  Only those
    sharding choices may read it: what else derives from the parameter
    count (`moe_active_params`, `analytical_spec`) would mix the full
    count with the cut layers."""
    full_params: float = 0.0

    def param_count(self) -> float:
        return self.full_params


def cut_depth(cfg: ArchConfig, n_repeat: int) -> CutConfig:
    """cfg with `n_repeat` repeats of its layer stack (whisper's encoder
    layers alike), sharded as the full config is (`CutConfig`)."""
    enc = dataclasses.replace(cfg.encoder, n_layers=n_repeat) \
        if cfg.encoder is not None else None
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(ArchConfig)}
    return CutConfig(**dict(fields, n_repeat=n_repeat, encoder=enc),
                     full_params=cfg.param_count())


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
            r = D.trace_pair(args.arch, args.shape, mesh,
                             cfg=cut_depth(cfg, k) if k else cfg)
            print(f"{args.arch} {args.shape} at {k or cfg.n_repeat}"
                  f" repeats: peak"
                  f" {r['bytes_per_device']['peak'] / 2**30:.2f} GiB/device,"
                  f" set by {r['peak_set_by']}")


if __name__ == "__main__":
    main()
