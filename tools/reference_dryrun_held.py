#!/usr/bin/env python3
"""The reference's dry run with its cost compiles held to the full
model's sharding plan.

  PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/reference_dryrun_held.py
      --arch A --shape S [--multi-pod] [--out DIR]
  PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/reference_dryrun_held.py
      --all [--multi-pod] [--swa-variants] [--out DIR]

`python -m repro.launch.dryrun` takes a pair's peaks from the full
model's compile, but its flops and collective bytes from `_corrected_cost`,
which compiles 1- and 2-repeat cuts of the config and extrapolates.  Each
cut chooses its sharding plan from its own `ArchConfig.param_count()`:
pure data parallelism under 3e9 parameters (`launch/sharding.py`
`pure_dp`), FSDP for training over 8e9 and for serving at 2 P / model of
6e9 bytes or more (`param_specs`), the sequence-parallel residual for
training over 3e10 (`launch/dryrun.py` `build_step`).  A cut granite-3-8b
thus trains as pure data parallelism, though the full model does not.

This tool runs the reference's own `run_pair` (nothing saved into
`benchmarks/results/`) and keeps its result as reported; where a cut's
plan differs from the full model's, it compiles the two cuts again with
`param_count` held at the full model's count (`held_param_count`) and
adds the extrapolated cost as `held`.  Where no decision changes, `held`
is the reported cost and no compile is made.  One JSON a pair under
build/reference_dryrun_held/ (`--out`): the reference's result (peaks,
`cost`, `roofline`, `collectives`: the same keys as its own JSON, so the
directory also serves as `--reference` of tools/port_vs_reference_dryrun.py),
and
  plan   each decision (pure_dp, fsdp, seq_shard_residual) of the full
         config and of the 1- and 2-repeat cuts as reported;
  held   flops, bytes_accessed, transcendentals, collectives (by kind, a
         device) under the full model's plan, and `compiled` (False where
         the plan did not change).

Reference side only: imports `repro`, edits nothing under src/repro/ (the
hold is a patch of the class attribute for the duration of the cuts'
compiles).  `repro.launch.dryrun` sets XLA_FLAGS to 512 host devices at
import, so it is imported inside `main`; `held_param_count` and `plan`
import neither it nor a device.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT_DIR = ROOT / "build" / "reference_dryrun_held"


@contextlib.contextmanager
def held_param_count(count: float):
    """Every `ArchConfig.param_count()` returns `count` inside the block."""
    from repro.models.spec import ArchConfig
    real = ArchConfig.param_count
    ArchConfig.param_count = lambda self: float(count)
    try:
        yield
    finally:
        ArchConfig.param_count = real


def cut(cfg, k: int):
    """`_corrected_cost`'s k-repeat cut of `cfg` (the encoder cut alike)."""
    enc = (dataclasses.replace(cfg.encoder, n_layers=k)
           if cfg.encoder is not None else None)
    return dataclasses.replace(cfg, n_repeat=k, encoder=enc)


def plan(cfg, mesh, kind: str, params_shape=None) -> dict:
    """The reference's three size-based decisions for `cfg` on `mesh` (a
    real mesh or a stub with `.shape` and `.axis_names`): pure data
    parallelism (train only), FSDP (any parameter spec names `data`) and
    the sequence-parallel residual (`build_step`'s condition)."""
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.launch.sharding import param_specs, pure_dp
    from repro.models import model as M
    train = kind == "train"
    if params_shape is None:
        params_shape = jax.eval_shape(
            lambda: M.init_params(jax.random.PRNGKey(0), cfg))
    specs = param_specs(cfg, params_shape, mesh,
                        mode="train" if train else "serve")
    named = {a for s in jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, P)) for d in s
        for a in (d if isinstance(d, tuple) else (d,))}
    return dict(pure_dp=train and pure_dp(cfg, mesh),
                fsdp="data" in named,
                seq_shard_residual=train and cfg.param_count() > 3e10)


def pairs(all_: bool, swa: bool, arch=None, shape=None):
    """`python -m repro.launch.dryrun`'s pairs, in its order."""
    from repro.configs import get_config, list_archs
    from repro.launch.shapes import SHAPES, applicability
    if not all_:
        return [(arch, shape)]
    out = []
    for a in list_archs():
        for s in SHAPES:
            out.append((a, s))
            if swa and s == "long_500k":
                cfg = get_config(a)
                if applicability(cfg, SHAPES[s]) and \
                        cfg.attn_block_count and not cfg.encoder:
                    out.append((a + "-swa", s))
    return out


def held_pair(arch: str, shape_name: str, *, multi_pod: bool) -> dict:
    """One pair: the reference's result as reported, its plans, and its
    cost under the full model's plan."""
    from repro.configs import get_config
    from repro.launch import dryrun as RD
    from repro.launch.mesh import make_production_mesh
    from repro.launch.shapes import SHAPES
    from repro.models.compat import set_mesh

    t0 = time.time()
    result = RD.run_pair(arch, shape_name, multi_pod=multi_pod, save=False)
    if result["status"] != "ok":
        return result
    cfg = get_config(arch)
    kind = SHAPES[shape_name].kind
    mesh = make_production_mesh(multi_pod=multi_pod)
    full = plan(cfg, mesh, kind)
    cuts = [plan(cut(cfg, k), mesh, kind) for k in (1, 2)]
    result["plan"] = dict(full=full, cut_1=cuts[0], cut_2=cuts[1])
    rep = {k: result["cost"][k] for k in ("flops", "bytes_accessed",
                                          "transcendentals")}
    rep["collectives"] = result["collectives"]
    if all(c == full for c in cuts):
        result["held"] = dict(rep, compiled=False)
    else:
        with set_mesh(mesh), held_param_count(cfg.param_count()):
            held = RD._corrected_cost(arch, shape_name, mesh, cfg)
        result["held"] = dict(held, compiled=True)
    result["held_s"] = round(time.time() - t0, 1)
    return result


def _gb(x) -> str:
    return f"{x / 1e9:.4g}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--swa-variants", action="store_true")
    ap.add_argument("--out", default=str(OUT_DIR), type=pathlib.Path)
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    from repro.launch import dryrun  # noqa: F401  (512 host devices)
    mesh_name = "pod2x16x16" if args.multi_pod else "pod16x16"
    args.out.mkdir(parents=True, exist_ok=True)
    bad = 0
    for a, s in pairs(args.all, args.swa_variants, args.arch, args.shape):
        r = held_pair(a, s, multi_pod=args.multi_pod)
        (args.out / f"{a}_{s}_{mesh_name}.json").write_text(
            json.dumps(r, indent=1))
        line = f"{a} {s} {mesh_name}: {r['status']}"
        if r["status"] == "ok":
            h = r["held"]
            line += (f" | {r['held_s']} s | flops {r['cost']['flops']:.4e}"
                     f" held {h['flops']:.4e} | collectives GB"
                     f" {_gb(r['collectives']['total'])} held"
                     f" {_gb(h['collectives']['total'])}"
                     + ("" if h["compiled"] else " (plan unchanged)"))
        elif r["status"] == "fail":
            bad += 1
            line += f" | {r['error']}"
        else:
            line += f" | {r['reason']}"
        print(line, flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
