"""Multi-pod dry run: trace one step of every (arch x shape x mesh) on a
fake 256- or 512-rank mesh.

The twin of the reference's AOT lower + compile on 512 placeholder XLA
devices.  Parameters, optimizer state, cache and batch are DTensors placed
by the sharding rules (`launch.sharding`) on `make_production_mesh`'s
mesh, their local shards fake tensors (FakeTensorMode: nothing is
allocated, on any device), and the step runs once, eagerly, as rank 0
of the fake group runs it: DTensor's sharding propagation and the model's
`constrain` sites choose every collective.  A placement DTensor cannot
propagate, a rule that does not divide, or an unsupported op fails the
pair, with its traceback.

Each pair writes one JSON (default directory build/port_dryrun/):
  bytes_per_device  arguments (the local shards of every input), outputs
                    (of the step's results; `aliased` of them share an
                    argument's storage: the updated parameters, moments
                    and cache), and peak (arguments + the most live local
                    bytes at once during the step, `StepRecorder`);
  fits_h100         peak <= 80 GiB (reported, not gated);
  cost              per-rank flops and bytes accessed (every local op's
                    input and output bytes, unfused: an upper bound on
                    XLA's figure for the same program);
  roofline, collectives   `hlo_analysis` on the H100's constants;
  trace_s           host seconds to build and trace the step.

Every repeat of the layer stack is traced, so nothing is undercounted:
the reference's SCAN_UNROLL / _extrapolate (XLA counts a while-loop body
once, so it compiled 1- and 2-repeat variants and extrapolated) have no
twin.  One exception keeps a 32K-token prefill tractable: the chunked
attention (`models.attention._flash_attention`) and a no-grad chunk
scan's group of chunks (`models.ssm._mamba2_chunks`, `_wkv6_chunks`) run
identical work in every layer and group, and under no_grad each is traced
once per signature and credited to the rest (`StepRecorder.memoized`;
equal to the full trace, peak included).  The step allocates on no
device by design (the twin of the reference's placeholder devices), so
there is no --device.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-6b --shape decode_32k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--skip-existing]
      [--swa-variants] [--workers N] [--out DIR]

More than one pair is traced in a pool of --workers processes, each pair
in a fresh process (`fresh_processes`), so that a pair's numbers do not
depend on the pairs traced before it.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import multiprocessing
import pathlib
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ..configs import get_config, list_archs
from ..models import attention, ssm
from ..models import model as M
from ..models.common import set_mesh
from ..training.optimizer import AdamW, AdamWState, tree_map
from ..training.train import loss_and_grads
from . import hlo_analysis
from .mesh import MULTI_POD, POD, fake_mesh
from .shapes import SHAPES, InputShape, applicability, input_specs
from .sharding import (batch_specs, cache_specs, distribute, param_specs,
                       pure_dp, to_placements, tree_shard_bytes, zip_map)

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] \
    / "build" / "port_dryrun"
H100_BYTES = 80 * 2**30


class SkipPair(Exception):
    pass


@dataclasses.dataclass
class Step:
    fn: Callable
    args: Tuple
    mesh_kwargs: dict


def _redistribute(tree, specs, mesh):
    """Each DTensor of `tree` moved to its spec's placements (the
    reference's out_shardings)."""
    return zip_map(lambda t, s: t.redistribute(mesh, to_placements(s, mesh)),
                    tree, specs)


def step_inputs(cfg, shape: InputShape, mesh, params=None):
    """The step's arguments as meta-device trees, their specs, and the
    ambient mesh's settings: (args, specs, mesh_kwargs), args a dict of
    "params" (`params`, meta `init_params` by default) and, by kind,
    "mu" / "nu" (AdamW's f32 moments, placed as the params) and "batch"
    (train, prefill), or "tokens", "cache" and "pos" (decode).  Nothing is
    allocated."""
    train = shape.kind == "train"
    if params is None:
        params = M.init_params(cfg, torch.Generator(), device="meta")
    pspecs = param_specs(cfg, params, mesh,
                         mode="train" if train else "serve")
    inputs = input_specs(cfg, shape)
    wide = train and pure_dp(cfg, mesh)
    mesh_kwargs = dict(
        batch_axes_override=("pod", "data", "model") if wide else None,
        # sequence-parallel residuals for large-model training
        seq_shard_residual=train and cfg.param_count() > 3e10)
    bspec = batch_specs(mesh, shape.global_batch, wide=wide)

    def tok(t):
        return (bspec[0],) + (None,) * (t.dim() - 1)

    args, specs = {"params": params}, {"params": pspecs}
    if train:
        moments = tree_map(lambda p: torch.empty(
            p.shape, dtype=torch.float32, device="meta"), params)
        args.update(mu=moments, nu=moments)
        specs.update(mu=pspecs, nu=pspecs)
    if shape.kind in ("train", "prefill"):
        args["batch"] = inputs
        specs["batch"] = {k: tok(v) for k, v in inputs.items()}
    else:
        args.update(inputs)
        specs.update(tokens=tok(inputs["tokens"]), pos=tok(inputs["pos"]),
                     cache=cache_specs(cfg, inputs["cache"], mesh,
                                       batch=shape.global_batch))
    return args, specs, mesh_kwargs


def argument_bytes(cfg, shape: InputShape, mesh, params=None) -> int:
    """Per-rank bytes of the step's arguments under the rules (any mesh
    with `.shape` and `.axis_names`, a stub included)."""
    args, specs, _ = step_inputs(cfg, shape, mesh, params)
    return tree_shard_bytes(args, specs, mesh)


def build_step(arch: str, shape_name: str, mesh, cfg=None,
               shape: Optional[InputShape] = None) -> Step:
    """The step of one pair on `mesh`, its DTensor arguments and the
    ambient mesh's settings.  Call under FakeTensorMode: the arguments
    are made from meta shapes and allocate nothing there."""
    cfg = cfg if cfg is not None else get_config(arch)
    shape = shape if shape is not None else SHAPES[shape_name]
    skip = applicability(cfg, shape)
    if skip:
        raise SkipPair(skip)
    meta, specs, mesh_kwargs = step_inputs(cfg, shape, mesh)
    a = distribute(meta, specs, mesh)
    bspec = specs["batch"]["tokens"] if "batch" in specs \
        else specs["tokens"]

    if shape.kind == "train":
        opt = AdamW(total_steps=1000)

        def train_step(params, opt_state, batch):
            # each gradient comes placed as its parameter
            loss, grads = loss_and_grads(params, cfg, batch, remat=True)
            params, opt_state = opt.update(grads, opt_state, params)
            return params, opt_state, loss

        return Step(train_step, (a["params"], AdamWState(
            step=0, mu=a["mu"], nu=a["nu"]), a["batch"]), mesh_kwargs)

    if shape.kind == "prefill":
        @torch.no_grad()
        def prefill_step(params, batch):
            # each layer's cache is written in the reference's
            # out_shardings, `cache_specs`, as its block returns it
            logits, cache = M.forward(
                params, cfg, batch["tokens"], mode="prefill",
                frames=batch.get("frames"), patches=batch.get("patches"),
                chunk_scans=True, cache_specs=functools.partial(
                    cache_specs, cfg, mesh=mesh, batch=shape.global_batch))
            return _redistribute(logits, bspec[:1], mesh), cache

        return Step(prefill_step, (a["params"], a["batch"]), mesh_kwargs)

    # decode / serve step: one token against a full seq_len cache.  `pos`
    # is the reference's (B,) argument; the port's decode_step reads the
    # positions on the host (its engine keeps them there): the last slot,
    # S - 1, for every row.
    host_pos = np.full(shape.global_batch, shape.seq_len - 1, np.int64)

    @torch.no_grad()
    def serve_step(params, tokens, cache, pos):
        logits, cache = M.decode_step(params, cfg, tokens, cache, host_pos)
        return _redistribute(logits, bspec[:1], mesh), cache

    return Step(serve_step, (a["params"], a["tokens"], a["cache"],
                             a["pos"]), mesh_kwargs)


def _tensors(tree):
    from torch.utils._pytree import tree_flatten
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _local(t):
    return getattr(t, "_local_tensor", t)


def _bytes(tensors) -> int:
    seen, total = set(), 0
    for t in tensors:
        st = _local(t).untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            total += st.nbytes()
    return total


def mesh_label(mesh_shape) -> str:
    if tuple(mesh_shape) == POD[0]:
        return "pod16x16"
    if tuple(mesh_shape) == MULTI_POD[0]:
        return "pod2x16x16"
    return "mesh" + "x".join(map(str, mesh_shape))


# functions of local tensors that repeat identical work in every layer:
# the chunked attention and a no-grad chunk scan's group of chunks
MEMOIZED = ((attention, "_flash_attention"), (ssm, "_mamba2_chunks"),
            (ssm, "_wkv6_chunks"))


@contextlib.contextmanager
def _memoized(rec):
    """MEMOIZED's functions memoized by `rec` inside the block."""
    real = [getattr(mod, name) for mod, name in MEMOIZED]
    for (mod, name), fn in zip(MEMOIZED, real):
        setattr(mod, name, rec.memoized(fn))
    try:
        yield
    finally:
        for (mod, name), fn in zip(MEMOIZED, real):
            setattr(mod, name, fn)


def trace_pair(arch: str, shape_name: str, mesh, *, cfg=None,
               shape: Optional[InputShape] = None) -> dict:
    """Trace one pair's step on a live fake mesh; the result's numbers."""
    with FakeTensorMode():
        step = build_step(arch, shape_name, mesh, cfg=cfg, shape=shape)
        args = _tensors(step.args)
        arg_bytes = _bytes(args)
        arg_storages = {_local(t).untyped_storage()._cdata for t in args}
        rec = hlo_analysis.StepRecorder()
        rec.exclude(step.args)
        with set_mesh(mesh, **step.mesh_kwargs), rec, _memoized(rec):
            out = step.fn(*step.args)
        outs = _tensors(out)
        aliased = _bytes([t for t in outs if _local(t).untyped_storage()
                          ._cdata in arg_storages])
        peak = arg_bytes + rec.peak
    coll = hlo_analysis.collective_bytes(rec.records)
    terms = hlo_analysis.roofline_from_counts(
        float(rec.flops), float(rec.bytes_accessed), coll)
    return dict(
        bytes_per_device=dict(arguments=arg_bytes, outputs=_bytes(outs),
                              aliased=aliased, peak=peak),
        fits_h100=peak <= H100_BYTES, peak_set_by=rec.peak_at,
        cost=dict(flops=float(rec.flops),
                  bytes_accessed=float(rec.bytes_accessed)),
        roofline=terms.row(), collectives=coll)


def run_pair(arch: str, shape_name: str, *, multi_pod: bool = False,
             save: bool = True, out_dir: Optional[pathlib.Path] = None,
             cfg=None, shape: Optional[InputShape] = None,
             mesh_shape: Optional[Tuple[int, ...]] = None,
             mesh_names: Optional[Tuple[str, ...]] = None) -> dict:
    """One pair on the production mesh (or on a fake mesh of `mesh_shape`
    / `mesh_names`, with `cfg` / `shape` in place of the registry's): a
    result dict with status "ok", "skip" (the reference's reason) or
    "fail" (error and traceback), saved as JSON unless `save` is False."""
    if mesh_shape is None:
        mesh_shape, mesh_names = MULTI_POD if multi_pod else POD
    mesh_name = mesh_label(mesh_shape)
    label = f"{arch}_{shape_name}_{mesh_name}"
    t0 = time.perf_counter()
    try:
        with fake_mesh(mesh_shape, mesh_names) as mesh:
            numbers = trace_pair(arch, shape_name, mesh, cfg=cfg,
                                 shape=shape)
        result = dict(arch=arch, shape=shape_name, mesh=mesh_name,
                      status="ok",
                      trace_s=round(time.perf_counter() - t0, 1), **numbers)
    except SkipPair as e:
        result = dict(arch=arch, shape=shape_name, mesh=mesh_name,
                      status="skip", reason=str(e))
    except Exception as e:  # a failure here is a bug in the system
        result = dict(arch=arch, shape=shape_name, mesh=mesh_name,
                      status="fail", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-2000:])
    if save:
        out_dir = pathlib.Path(out_dir) if out_dir else RESULTS_DIR
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{label}.json").write_text(json.dumps(result, indent=1))
    return result


def summary(r: dict) -> str:
    line = f"{r['arch']} {r['shape']} {r['mesh']}: {r['status']}"
    if r["status"] == "ok":
        bpd = r["bytes_per_device"]["peak"] / 2**30
        line += (f" | {r['trace_s']}s | {bpd:.2f} GiB/dev | dominant "
                 f"{r['roofline']['dominant']}")
    elif r["status"] == "fail":
        line += f" | {r['error']}"
    else:
        line += f" | {r['reason']}"
    return line


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--swa-variants", action="store_true",
                    help="also run -swa variants for long_500k-skipped archs")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=str(RESULTS_DIR),
                    help="directory of the per-pair JSON files")
    ap.add_argument("--workers", type=int, default=1,
                    help="pairs traced at once, each in a fresh process")
    args = ap.parse_args(argv)
    out_dir = pathlib.Path(args.out)

    pairs = []
    if args.all:
        for a in list_archs():
            for s in SHAPES:
                pairs.append((a, s))
                if args.swa_variants and s == "long_500k":
                    cfg = get_config(a)
                    if applicability(cfg, SHAPES[s]) and \
                            cfg.attn_block_count and not cfg.encoder:
                        pairs.append((a + "-swa", s))
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        pairs = [(args.arch, args.shape)]

    mesh_name = "pod2x16x16" if args.multi_pod else "pod16x16"
    todo = []
    for a, s in pairs:
        out = out_dir / f"{a}_{s}_{mesh_name}.json"
        if args.skip_existing and out.exists():
            prev = json.loads(out.read_text())
            if prev.get("status") in ("ok", "skip"):
                print(f"[cached] {a} {s} {mesh_name}: {prev['status']}")
                continue
        todo.append((a, s))
    kwargs = dict(multi_pod=args.multi_pod, out_dir=out_dir)
    if len(todo) == 1:      # nothing was traced in this process before it
        print(summary(run_pair(*todo[0], **kwargs)), flush=True)
        return
    with fresh_processes(args.workers) as ex:
        futures = [ex.submit(run_pair, a, s, **kwargs) for a, s in todo]
        for f in futures:
            print(summary(f.result()), flush=True)


def fresh_processes(workers: int) -> ProcessPoolExecutor:
    """A pool of `workers` spawned processes that runs each task in a
    process of its own.  A traced pair leaves DTensor's process-wide caches
    behind (sharding propagation, redistribution plans), keyed by meshes
    that compare equal across fake groups, so a pair traced after another
    in one process could read the other's entries; in a fresh process its
    numbers depend on the pair alone."""
    return ProcessPoolExecutor(
        max(workers, 1), mp_context=multiprocessing.get_context("spawn"),
        max_tasks_per_child=1)


if __name__ == "__main__":
    main()
