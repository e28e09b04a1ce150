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
within 1e-5 of each tensor's largest magnitude.
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
from torch.distributed.tensor import Shard

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.sharding import (batch_specs, cache_specs,
                                         distribute, param_specs, pure_dp)
from repro_torch.models import common
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


def _decode(mesh, seq_on_model=False):
    cfg = get_config("yi-6b").reduced()
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
                                             mode="serve"), mesh)
    specs = cache_specs(cfg, cache, mesh, batch=B)
    if seq_on_model:
        specs = {n: {k: (None, "data", "model", None, None) for k in blk}
                 for n, blk in specs.items()}
    dcache = distribute(cache, specs, mesh)
    dtok = distribute(tokens, batch_specs(mesh, B) + (None,), mesh)
    with set_mesh(mesh):
        got, dcache = M.decode_step(dparams, cfg, dtok, dcache, pos)
    tag = "decode (KV sequence on model)" if seq_on_model else "decode"
    errs = {f"{tag} logits": _rel(got, want)}
    for n, blk in dcache.items():
        for k, t in blk.items():
            if seq_on_model:
                assert t.placements[1].is_shard(2), t.placements
            errs[f"{tag} cache {n}/{k}"] = _rel(t, want_cache[n][k])
    return errs


def _train(mesh, arch, n_repeat=2, wide=None):
    cfg = get_config(arch).reduced(n_repeat=n_repeat)
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
    tag = arch if wide else f"{arch} (vocab on model)"
    errs = {f"{tag} train loss": _rel(dloss, loss)}
    for i, (a, b) in enumerate(zip(tree_leaves(dgrads), tree_leaves(grads))):
        errs[f"{tag} grad leaf {i}"] = _rel(a, b)
    return errs


def _prefill(mesh, arch, **replace):
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
                                     chunk_scans=True)
        with set_mesh(mesh):
            got, cache = M.forward(dparams, cfg, dtok, mode="prefill",
                                   chunk_scans=True, cache_specs=functools.
                                   partial(cache_specs, cfg, mesh=mesh,
                                           batch=B))
    tag = f"{arch} (vocab {cfg.vocab}) prefill"
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
    real = ops.gather_states
    real_bind = common._Constrain.backward
    rows = ssm.MAMBA_ROWS

    def counted(x, mesh, dims):
        merges.append(list(dims))   # the mesh dimensions that shard T
        return real(x, mesh, dims)

    def bind(ctx, g):               # the logits' gradient at the head
        if g.ndim == 3 and g.shape[-1] == get_config("yi-6b").reduced().vocab:
            head_grads.append((tuple(g.placements), ctx.placements))
        return real_bind(ctx, g)

    try:
        mesh = make_local_mesh(model=2, data=2, device="cpu")
        errs = _decode(mesh)
        ops.gather_states = counted
        errs.update(_decode(mesh, seq_on_model=True))
        ops.gather_states = real
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
        common._Constrain.backward = real_bind
        ssm.MAMBA_ROWS = rows
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_sharded_steps_match_unsharded(tmp_path):
    out = tmp_path / "errs.pt"
    ctx = mp.start_processes(_worker, args=(_free_port(), str(out)),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + 60
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                pytest.fail("the 4-process gloo run passed 60 s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    saved = torch.load(out)
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
