"""Sharding rules: parameter / optimizer / cache / batch specs, and their
DTensor placements.

The reference's rules (`repro.launch.sharding`), line for line.  Scheme:
2D tensor parallelism —
  * `model` axis: attention heads, ffn hidden, experts (when divisible),
    vocab;
  * `data` axis: FSDP over the d_model dimension of large matrices + batch;
  * `pod` axis: pure data parallelism (batch), params replicated per pod.

A spec is the reference's PartitionSpec as a tuple: one entry per tensor
dimension (an axis name, a tuple of names, or None), `()` for fully
replicated.  The port's parameter tree keeps one entry per repeat
(`params["layers"][r]`) where the reference stacks its `unit/...` leaves
over a leading n_repeat axis, so a per-repeat spec is the reference's
without its leading None; the decode cache is stacked in both, and its
specs are the reference's.

Rules are name-based over the tree's paths.  Any dimension that does not
divide evenly by its axis falls back to replication (`_fits`; GSPMD
would reject it, and DTensor would pad it silently, which `distribute`
refuses).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from ..models.common import mesh_shape, spec_placements
from ..models.spec import ArchConfig
from .mesh import data_axes

Spec = tuple


def _fits(dim: int, mesh, axis) -> bool:
    if axis is None:
        return True
    axes = axis if isinstance(axis, tuple) else (axis,)
    sizes = mesh_shape(mesh)
    size = int(np.prod([sizes[a] for a in axes]))
    return dim % size == 0


def _spec_for_param(path: str, shape: tuple, cfg: ArchConfig, mesh,
                    fsdp: Optional[str] = "data") -> Spec:
    """Choose a spec by parameter name, then drop non-dividing axes.

    fsdp=None (serving mode) keeps weights model-sharded only: decode is
    executed every iteration, so FSDP's per-use weight all-gather costs
    ~params/model_shards bytes of interconnect per step.
    """
    name = path.split("/")[-1]
    dims = list(shape)
    tp = "model"

    def spec(*ax):
        ax = list(ax)
        while len(ax) < len(dims):
            ax.append(None)
        return tuple(a if _fits(dims[i], mesh, a) else None
                     for i, a in enumerate(ax))

    if len(dims) == 0:
        return ()
    if name in ("embed",):
        # vocab replicated, d_model sharded: the token-id gather stays local
        return spec(None, tp)
    if name in ("lm_head",):
        # vocab on model only: FSDP-sharding d as well makes the CE
        # backward gather the full f32 logits
        return spec(None, tp)
    if name in ("wq", "wk", "wv", "w_up", "w_gate", "Wr", "Wk", "Wv", "Wg",
                "Wk_cm", "Wr_cm", "w_in", "wA"):
        return spec(fsdp, tp)
    if name in ("wo", "w_down", "w_out", "Wo", "Wv_cm", "wB"):
        return spec(tp, fsdp)
    if name == "router":
        return spec(fsdp, None)
    if name in ("conv_w", "conv_b"):
        return spec(None, tp) if len(dims) == 2 else spec(tp)
    if name in ("A_log", "dt_bias", "D"):
        return spec(tp)
    if name in ("w0", "u"):
        return spec(tp, None)
    if name in ("norm_y",):
        return spec(tp)
    return spec()  # norms, maa, biases: replicated


def _spec_for_moe_param(path: str, shape: tuple, cfg: ArchConfig, mesh,
                        fsdp: Optional[str] = "data") -> Optional[Spec]:
    """MoE expert tensors: expert-parallel when E divides the model axis,
    otherwise TP inside each expert's ffn dim.  In the EP case the expert
    weights are not FSDP-sharded as well."""
    name = path.split("/")[-1]
    if name not in ("w_gate", "w_up", "w_down") or "_moe" not in path:
        return None
    ep = _fits(cfg.n_experts, mesh, "model")
    if name in ("w_gate", "w_up"):          # (E, d, fe)
        body = ("model", None, None) if ep else (None, fsdp, "model")
    else:                                    # (E, fe, d)
        body = ("model", None, None) if ep else (None, "model", fsdp)
    return tuple(a if _fits(d_, mesh, a) else None
                 for d_, a in zip(shape, body))


def tree_map_with_path(fn: Callable, tree, prefix: str = ""):
    """fn(path, leaf) over a tree of dicts and lists, paths joined by "/"
    (list entries by their index)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map_with_path(fn, v, f"{prefix}{i}/")
                for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


def param_specs(cfg: ArchConfig, params: Any, mesh, *,
                mode: str = "train", fsdp: Optional[str] = "auto") -> Any:
    """Spec tree matching a params tree (tensors of any device, meta
    included: only shapes are read).

    mode="train": FSDP over `data` + TP over `model`, FSDP only over ~8B
    params; mode="serve": TP over `model` only, unless the TP-sharded bf16
    weights pass 6e9 bytes per device (command-r, grok keep FSDP); small
    training models (`pure_dp`) replicate everything.  `fsdp` other than
    "auto" names the axis FSDP takes (None: none) whatever the size, as a
    reduced config stands in for a full one."""
    if fsdp != "auto":
        pass
    elif mode == "train":
        fsdp = "data" if cfg.param_count() > 8e9 else None
    else:
        per_chip = 2.0 * cfg.param_count() / max(
            mesh_shape(mesh).get("model", 1), 1)
        fsdp = None if per_chip < 6e9 else "data"
    if mode == "train" and pure_dp(cfg, mesh):
        return tree_map_with_path(lambda path, leaf: (), params)

    def one(path, leaf):
        moe = _spec_for_moe_param(path, tuple(leaf.shape), cfg, mesh,
                                  fsdp=fsdp)
        return moe if moe is not None \
            else _spec_for_param(path, tuple(leaf.shape), cfg, mesh,
                                 fsdp=fsdp)

    return tree_map_with_path(one, params)


def cache_specs(cfg: ArchConfig, cache: Any, mesh, *, batch: int) -> Any:
    """Decode-cache specs: batch on data axes; KV heads on model when they
    divide, else the cache *sequence* dim on model (context parallelism)."""
    dp = data_axes(mesh)
    dp_ax = dp if _fits(batch, mesh, dp) else (
        dp[-1] if _fits(batch, mesh, dp[-1]) else None)

    def one(path, leaf):
        shp = tuple(leaf.shape)          # leading axis = n_repeat
        if "wkv" in path or "ssm" in path or "conv" in path \
                or "shift" in path:
            return (None, dp_ax)              # O(1) state: batch only
        # attention kv: (R, B, T, K, hd)
        T, K = shp[2], shp[3]
        k_ax = "model" if _fits(K, mesh, "model") else None
        t_ax = None
        if dp_ax is None:
            # batch unshardable (long_500k): context parallelism on `data`
            # (+ `model` too when KV heads can't use it)
            if k_ax is None and _fits(T, mesh, ("data", "model")):
                t_ax = ("data", "model")
            elif _fits(T, mesh, ("data",)):
                t_ax = "data"
        elif k_ax is None and _fits(T, mesh, ("model",)):
            t_ax = "model"                    # seq-sharded KV (K < model)
        return (None, dp_ax, t_ax, k_ax, None)

    return tree_map_with_path(one, cache)


def pure_dp(cfg: ArchConfig, mesh, threshold: float = 3e9) -> bool:
    """True when a training model is small enough to replicate entirely
    (params + f32 optimizer state under ~half an accelerator's memory) and
    the mesh should be used as pure data parallelism."""
    return cfg.param_count() < threshold


def batch_specs(mesh, batch: int, *, wide: bool = False) -> Spec:
    dp = data_axes(mesh)
    if wide:
        axes = tuple(dp) + ("model",)
        if _fits(batch, mesh, axes):
            return (axes,)
    if _fits(batch, mesh, dp):
        return (dp,)
    if _fits(batch, mesh, dp[-1]):
        return (dp[-1],)
    return (None,)


def to_placements(spec: Spec, mesh) -> tuple:
    """The DTensor placements of a spec, one per mesh dimension (the twin
    of the reference's `to_shardings` for one leaf): Shard(dim) where a
    tensor dimension names the mesh dimension's axis, else Replicate(); a
    dimension on two axes is sharded on both, in mesh order."""
    return spec_placements(spec, mesh)


def local_shape(shape, spec: Spec, mesh) -> tuple:
    """The shape of one rank's shard; raises where an axis does not divide
    its dimension."""
    sizes = mesh_shape(mesh)
    out = list(shape)
    for i, a in enumerate(tuple(spec)[:len(out)]):
        axes = a if isinstance(a, tuple) else (a,) if a else ()
        n = int(np.prod([sizes[s] for s in axes] or [1]))
        if out[i] % n:
            raise ValueError(f"dimension {i} of {tuple(shape)} ({out[i]})"
                             f" does not divide by {axes} ({n}); DTensor"
                             f" would pad it")
        out[i] //= n
    return tuple(out)


def shard_bytes(shape, dtype: torch.dtype, spec: Spec, mesh) -> int:
    """Bytes of one rank's shard of a tensor of `shape` under `spec`."""
    return int(np.prod(local_shape(shape, spec, mesh), dtype=np.int64)) \
        * torch.empty((), dtype=dtype).element_size()


def distribute(tree, specs, mesh):
    """Each tensor of `tree` as a DTensor on `mesh` placed by its spec in
    `specs` (a tree of the same structure, or one spec for every leaf).
    Raises on any dimension its axes do not divide (DTensor would pad it
    silently).

    A tensor on the meta device becomes a DTensor whose local shard is
    allocated with `torch.empty` on the mesh's device type: under
    FakeTensorMode (the dry run) that allocates nothing.  Any other tensor
    is scattered from its value on each rank (`distribute_tensor`)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(t, spec):
        placements = to_placements(spec, mesh)
        shape = local_shape(t.shape, spec, mesh)
        if t.device.type == "meta":
            local = torch.empty(shape, dtype=t.dtype,
                                device=mesh.device_type)
            return DTensor.from_local(local, mesh, placements,
                                      run_check=False, shape=t.shape,
                                      stride=t.stride())
        return distribute_tensor(t, mesh, placements)

    if isinstance(specs, tuple) and all(
            x is None or isinstance(x, (str, tuple)) for x in specs):
        return tree_map_with_path(lambda path, t: one(t, specs), tree)
    return zip_map(one, tree, specs)


def zip_map(fn, tree, specs):
    """fn(leaf, spec) over a tree and a spec tree of one structure."""
    if isinstance(tree, dict):
        return {k: zip_map(fn, tree[k], specs[k]) for k in tree}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, torch.Tensor):
        return [zip_map(fn, t, s) for t, s in zip(tree, specs)]
    return fn(tree, specs)


def tree_shard_bytes(tree, specs, mesh) -> int:
    """Per-rank bytes of a tree of tensors (any device) under its specs."""
    total = 0

    def add(t, spec):
        nonlocal total
        total += shard_bytes(t.shape, t.dtype, spec, mesh)
        return t

    zip_map(add, tree, specs)
    return total
