"""The distribution layer computing real numbers: four CPU processes over
gloo on a (2, 2) ("data", "model") mesh.

The fake process group of the dry run moves no data, so this is the one
place the placements of `launch.sharding` and the model's `constrain`
sites meet real values.  Each rank builds the same seeded reduced float32
weights, distributes them by the rules and runs:

  * yi-6b: one decode step on a random cache under the serve rules (batch
    on `data`, heads, KV heads and the cache's heads on `model`), at
    ragged positions; and once more with the cache placed (None, "data",
    "model", None, None), its sequence on `model` as the rules place it
    where the KV heads do not divide `model`: each rank attends to its
    half of the sequence and the softmax states are merged across ranks;
  * granite-moe-1b-a400m and zamba2-2.7b (one repeat): the loss and every
    gradient leaf under the train rules (pure data parallelism: the batch
    over both axes; four MoE dispatch groups; the chunk scans on each
    rank's rows), with `remat=True`;
  * yi-6b under the train rules without pure data parallelism (the batch
    on `data`, the vocabulary of the logits on `model`): the loss and every
    gradient leaf through the vocab-parallel cross-entropy, whose gradient
    must reach the head's constraint on its vocab shard (Shard(2));
  * a no-grad prefill under the serve rules, its caches written in
    `cache_specs`' placements: granite-3-8b (one repeat) with its vocab
    on `model` and with an odd vocab the head keeps whole (each rank's
    last rows times its own vocab columns), and zamba2-2.7b (one repeat)
    in Mamba2 row blocks of 4 over 11 tokens (the conv with its halo, the
    skip term and the gated norm on each rank's rows; the in-projection's
    weight gathered): the last position's logits and every cache leaf;

and holds them to the same calls on plain tensors (one group, no remat)
within 1e-5 of each tensor's largest magnitude.  A second run of four
processes holds each `model` rank's share of the heads the same way
(`test_split_heads_match_unsharded`): GQA whose KV heads do not divide
`model`, split by q heads or by rows, and zamba2's Mamba2 heads.
"""
import dataclasses
import functools
import socket
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.sharding import (batch_specs, cache_specs,
                                         distribute, param_specs, pure_dp)
from repro_torch.models import attention, common, mlp, moe
from repro_torch.models import model as M
from repro_torch.models import ssm
from repro_torch.models.common import set_mesh
from repro_torch.training.optimizer import tree_leaves
from repro_torch.training.train import loss_and_grads

TOL = 1e-5
WORLD = 4


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _rel(got, want):
    got, want = _full(got).detach(), want.detach()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1.0))


def _decode(mesh, seq_on_model=False, arch="yi-6b", fsdp="auto",
            **replace):
    cfg = dataclasses.replace(get_config(arch).reduced(), **replace)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    B, T = 4, 16
    g = torch.Generator().manual_seed(1)
    cache = M.init_cache(cfg, B, T, device="cpu")
    for blk in cache.values():
        for t in blk.values():
            t.copy_(torch.randn(t.shape, generator=g))
    tokens = torch.randint(0, cfg.vocab, (B, 1), generator=g)
    pos = np.array([3, 7, 15, 10])
    want_cache = {n: {k: t.clone() for k, t in blk.items()}
                  for n, blk in cache.items()}
    want, want_cache = M.decode_step(params, cfg, tokens, want_cache, pos)
    dparams = distribute(params, param_specs(cfg, params, mesh,
                                             mode="serve", fsdp=fsdp), mesh)
    specs = cache_specs(cfg, cache, mesh, batch=B)
    if seq_on_model:
        specs = {n: {k: (None, "data", "model", None, None) for k in blk}
                 for n, blk in specs.items()}
    dcache = distribute(cache, specs, mesh)
    dtok = distribute(tokens, batch_specs(mesh, B) + (None,), mesh)
    with set_mesh(mesh):
        got, dcache = M.decode_step(dparams, cfg, dtok, dcache, pos)
    tag = f"{arch} {replace or ''} (FSDP {fsdp}) decode" + \
        (" (KV sequence on model)" if seq_on_model else "")
    errs = {f"{tag} logits": _rel(got, want)}
    for n, blk in dcache.items():
        for k, t in blk.items():
            if seq_on_model:
                assert t.placements[1].is_shard(2), t.placements
            errs[f"{tag} cache {n}/{k}"] = _rel(t, want_cache[n][k])
    return errs


def _train(mesh, arch, n_repeat=2, wide=None, **replace):
    cfg = dataclasses.replace(get_config(arch).reduced(n_repeat=n_repeat),
                              **replace)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    B, S = 8, 12
    g = torch.Generator().manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=g),
             "labels": torch.randint(0, cfg.vocab, (B, S), generator=g)}
    loss, grads = loss_and_grads(params, cfg, batch)
    wide = pure_dp(cfg, mesh) if wide is None else wide
    bspec = batch_specs(mesh, B, wide=wide)
    dparams = distribute(params, param_specs(cfg, params, mesh), mesh)
    dbatch = {k: distribute(v, bspec + (None,), mesh)
              for k, v in batch.items()}
    with set_mesh(mesh, batch_axes_override=("pod", "data", "model")
                  if wide else None):
        dloss, dgrads = loss_and_grads(dparams, cfg, dbatch, remat=True)
    tag = (arch if wide else f"{arch} (vocab on model)") + \
        (f" {replace}" if replace else "")
    errs = {f"{tag} train loss": _rel(dloss, loss)}
    for i, (a, b) in enumerate(zip(tree_leaves(dgrads), tree_leaves(grads))):
        errs[f"{tag} grad leaf {i}"] = _rel(a, b)
    return errs


def _prefill(mesh, arch, chunk_scans=True, **replace):
    cfg = dataclasses.replace(get_config(arch).reduced(n_repeat=1),
                              **replace)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    B, S = 4, 11
    tokens = torch.randint(0, cfg.vocab, (B, S),
                           generator=torch.Generator().manual_seed(3))
    dparams = distribute(params, param_specs(cfg, params, mesh,
                                             mode="serve"), mesh)
    dtok = distribute(tokens, batch_specs(mesh, B) + (None,), mesh)
    with torch.no_grad():
        want, want_cache = M.forward(params, cfg, tokens, mode="prefill",
                                     chunk_scans=chunk_scans)
        with set_mesh(mesh):
            got, cache = M.forward(dparams, cfg, dtok, mode="prefill",
                                   chunk_scans=chunk_scans,
                                   cache_specs=functools.partial(
                                       cache_specs, cfg, mesh=mesh, batch=B))
    tag = f"{arch} {replace or ''} (vocab {cfg.vocab}) prefill" \
        f"{'' if chunk_scans else ' (ssd_scan)'}"
    errs = {f"{tag} logits": _rel(got, want)}
    assert sorted(cache) == sorted(want_cache)
    for n, blk in want_cache.items():
        for k, t in blk.items():
            errs[f"{tag} cache {n}/{k}"] = _rel(cache[n][k], t)
    return errs


def _worker(rank, port, out):
    torch.set_num_threads(1)        # four processes share the host's cores
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank)
    merges, head_grads = [], []
    real = ops.merge_ranks
    real_bind = common._Constrain.backward
    rows = ssm.MAMBA_ROWS

    def counted(piece, mesh, dims, dtype):
        merges.append(list(dims))   # the mesh dimensions that shard T
        return real(piece, mesh, dims, dtype)

    def bind(ctx, g):               # the logits' gradient at the head
        if g.ndim == 3 and g.shape[-1] == get_config("yi-6b").reduced().vocab:
            head_grads.append((tuple(g.placements), ctx.placements))
        return real_bind(ctx, g)

    try:
        mesh = make_local_mesh(model=2, data=2, device="cpu")
        errs = _decode(mesh)
        ops.merge_ranks = counted
        errs.update(_decode(mesh, seq_on_model=True))
        ops.merge_ranks = real
        errs.update({**_train(mesh, "granite-moe-1b-a400m"),
                     **_train(mesh, "zamba2-2.7b", 1)})
        common._Constrain.backward = staticmethod(bind)
        errs.update(_train(mesh, "yi-6b", wide=False))
        common._Constrain.backward = real_bind
        errs.update({**_prefill(mesh, "granite-3-8b"),
                     **_prefill(mesh, "granite-3-8b", vocab=515)})
        ssm.MAMBA_ROWS = 4
        errs.update(_prefill(mesh, "zamba2-2.7b"))
        if rank == 0:
            torch.save({"errs": errs, "merges": merges,
                        "head_grads": head_grads}, out)
    finally:
        ops.merge_ranks = real
        common._Constrain.backward = real_bind
        ssm.MAMBA_ROWS = rows
        dist.destroy_process_group()


# GQA where the KV heads do not divide `model` = 2: a KV head to the mesh's
# two model ranks, its q heads split between them ("heads"), or three q
# heads a group, which straddle them ("rows": each rank attends every head
# for half the rows)
GQA_SPLITS = {"heads": dict(n_kv_heads=1),
              "rows": dict(n_heads=3, n_kv_heads=1, head_dim=64)}


def _split_worker(rank, port, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank)
    calls = {}
    patched = [(attention, "_group_attention"), (attention, "_rows_attention"),
               (ssm, "_mamba2_heads")]
    real = [getattr(mod, name) for mod, name in patched]

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        return call

    try:
        for (mod, name), fn in zip(patched, real):
            setattr(mod, name, counted(name, fn))
        mesh = make_local_mesh(model=2, data=2, device="cpu")
        errs = {}
        for split, replace in GQA_SPLITS.items():
            errs.update(_train(mesh, "yi-6b", n_repeat=1, wide=False,
                               **replace))
            errs.update(_prefill(mesh, "yi-6b", **replace))
        for chunk_scans in (True, False):
            errs.update(_prefill(mesh, "zamba2-2.7b", chunk_scans))
        if rank == 0:
            torch.save({"errs": errs, "calls": calls}, out)
    finally:
        for (mod, name), fn in zip(patched, real):
            setattr(mod, name, fn)
        dist.destroy_process_group()


# a decode step under the serve rules with FSDP over `data`, the rules'
# choice for command-r's and grok's full sizes (forced here): a dense
# config, and an MoE whose 3 experts do not divide `model` = 2, so that its
# dispatch buffer moves onto the experts' shards of d and the combine runs
# there (`moe._combine_columns`)
FSDP_DECODES = {"command-r-plus-104b": {}, "grok-1-314b": dict(n_experts=3)}


def _shard_to_shard(mesh):
    """DTensor's redistributions from a shard of one tensor dimension to a
    shard of another, over each mesh dimension, as DTensor runs them on
    the gloo mesh (an all-gather, a chunk kept) and under the dry run's
    `hlo_analysis._gpu_alltoall` (an all-to-all): for each, whether the
    two agree bit for bit, placements and local shards."""
    x = torch.randn(4, 6, 8, generator=torch.Generator().manual_seed(4))
    same = []
    for now, to in (((Replicate(), Shard(1)), (Replicate(), Shard(2))),
                    ((Shard(0), Shard(1)), (Shard(0), Shard(2))),
                    ((Shard(1), Shard(2)), (Shard(0), Shard(2)))):
        d = distribute_tensor(x, mesh, now)
        want = d.redistribute(mesh, to)
        with H._gpu_alltoall():
            got = d.redistribute(mesh, to)
        same.append(got.placements == want.placements
                    and torch.equal(got.to_local(), want.to_local()))
    return same


def _fsdp_worker(rank, port, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank)
    calls = {"_combine_columns": 0, "onto_rows moves": 0}
    real_combine, real_onto = moe._combine_columns, common.onto_rows
    users = (attention, mlp, moe)

    def combine(*a, **kw):
        calls["_combine_columns"] += 1
        return real_combine(*a, **kw)

    def onto(x, *a, **kw):
        y = real_onto(x, *a, **kw)
        calls["onto_rows moves"] += y is not x
        return y

    try:
        moe._combine_columns = combine
        for mod in users:
            mod.onto_rows = onto
        mesh = make_local_mesh(model=2, data=2, device="cpu")
        errs = {}
        for arch, replace in FSDP_DECODES.items():
            errs.update(_decode(mesh, arch=arch, fsdp="data", **replace))
        same = _shard_to_shard(mesh)
        if rank == 0:
            torch.save({"errs": errs, "calls": calls, "same": same}, out)
    finally:
        moe._combine_columns = real_combine
        for mod in users:
            mod.onto_rows = real_onto
        dist.destroy_process_group()


def _run(worker, out, limit=60):
    ctx = mp.start_processes(worker, args=(_free_port(), str(out)),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + limit
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                pytest.fail(f"the 4-process gloo run passed {limit} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return torch.load(out)


def test_split_heads_match_unsharded(tmp_path):
    """Each `model` rank computes its share of the heads (ROADMAP C21,
    C22), on the (2, 2) mesh under the train and serve rules, within 1e-5
    of plain tensors: yi-6b (one repeat) with one KV head, its four q
    heads split two a rank against the group's KV head ("heads"), and
    with three q heads a group, each rank attending every head for its
    balanced half of the rows ("rows"): the train loss and every
    gradient leaf (the batch on `data`), the prefill's last logits and
    every cache leaf; zamba2-2.7b (one repeat) prefilled with its Mamba2
    heads split, through the chunk scans and through `ops.ssd_scan`."""
    saved = _run(_split_worker, tmp_path / "errs.pt")
    errs, calls = saved["errs"], saved["calls"]
    # the train step's forward and its recompute, and the prefill: three
    # calls a split; five Mamba2 blocks a prefill, two prefills
    assert calls == {"_group_attention": 3, "_rows_attention": 3,
                     "_mamba2_heads": 10}, calls
    assert len(errs) > 20
    bad = {k: v for k, v in errs.items() if not v <= TOL}
    assert not bad, bad


def test_fsdp_decode_matches_unsharded(tmp_path):
    """A decode step whose weights FSDP shards over `data` (ROADMAP C23),
    on the (2, 2) mesh under the serve rules, within 1e-5 of plain
    tensors: command-r-plus-104b and grok-1-314b (3 experts, which
    `model` does not divide), the logits and every cache leaf, each
    block's activations moved once onto the weights' shards of d
    (`common.onto_rows`: q/k/v, the MLP's input, the router's input and
    the MoE's dispatch buffer) and the MoE's combine run on those shards
    (`moe._combine_columns`).  The same run holds the dry run's
    all-to-all for DTensor's shard-to-shard redistribution
    (`hlo_analysis._gpu_alltoall`) to DTensor's own on gloo."""
    saved = _run(_fsdp_worker, tmp_path / "errs.pt")
    errs, calls = saved["errs"], saved["calls"]
    # two repeats a config: command-r 2 x (attention + MLP), grok 2 x
    # (attention + router + buffer)
    assert calls == {"_combine_columns": 2, "onto_rows moves": 10}, calls
    assert saved["same"] == [True] * 3, saved["same"]
    # a config's logits and its K and V caches (stacked over its repeats)
    assert len(errs) == 6, sorted(errs)
    bad = {k: v for k, v in errs.items() if not v <= TOL}
    assert not bad, bad


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_sharded_steps_match_unsharded(tmp_path):
    saved = _run(_worker, tmp_path / "errs.pt")
    errs = saved["errs"]
    # every attention block of the sequence-sharded decode merged over
    # `model` (mesh dimension 1)
    assert saved["merges"] == [[1]] * 2
    # the vocab-parallel loss's gradient arrives on the vocab shards the
    # head's constraint binds (batch on data, vocab on model): no exchange
    shard = (Shard(0), Shard(2))
    assert saved["head_grads"] == [(shard, shard)]
    assert len(errs) > 10
    bad = {k: v for k, v in errs.items() if not v <= TOL}
    assert not bad, bad
