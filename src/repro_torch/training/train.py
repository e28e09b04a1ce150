"""Training loop substrate: train_step + TrainState, the reference's."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..models import model as M
from ..models.common import _is_dtensor
from ..models.spec import ArchConfig
from .optimizer import AdamW, AdamWState, global_norm, tree_leaves, tree_map


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: AdamWState


def batch_to(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A `batch_iterator` batch (numpy) as tensors on `device`: tokens and
    labels as int64, patches and frames as they come (float32)."""
    return {key: torch.as_tensor(np.asarray(a), device=device)
            for key, a in batch.items()}


def _placed_as(p):
    """A hook on DTensor parameter p: its gradient placed as p, on storage
    of its own, as soon as autograd produces it.  DTensor leaves a
    gradient where the backward's product put it, whole on every rank
    where the forward gathered the weight (command-r-plus-104b's
    attention weights at train_4k on 16 x 16: 48 GiB a device held to the
    step's end), and a redistribution to a shard can be a slice of it."""
    def hook(g):
        if tuple(g.placements) != tuple(p.placements):
            g = g.redistribute(p.device_mesh, p.placements)
        local = g.to_local()
        if local.untyped_storage().nbytes() > local.numel() \
                * local.element_size():
            g = g.clone()
        return g
    return hook


def loss_and_grads(params, cfg: ArchConfig, batch, *, remat: bool = False):
    """(loss, gradient tree): `M.loss_fn`'s gradient with respect to every
    parameter, `None` for a leaf the loss does not read (JAX gives zeros:
    the optimizer counts None as zeros).  The parameters' own tensors are
    not marked: the gradient is taken through views that share their
    storage.  A DTensor parameter's gradient is placed as the parameter
    (`_placed_as`), as the reference's come out sharded as its params."""
    view = tree_map(lambda p: p.detach().requires_grad_(), params)
    for leaf in tree_leaves(view):
        if _is_dtensor(leaf):
            leaf.register_hook(_placed_as(leaf))
    loss = M.loss_fn(view, cfg, batch, remat=remat)
    leaves = tree_leaves(view)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_leaf = dict(zip(map(id, leaves), grads))
    return loss.detach(), tree_map(lambda p: by_leaf[id(p)], view)


def make_train_step(cfg: ArchConfig, opt: AdamW):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics): the loss's gradient with respect to every parameter, then one
    AdamW step, which updates params and opt_state in place.  metrics:
    "loss", "grad_norm" (the global norm before clipping), both f32
    tensors on the parameters' device, and "lr", the schedule at the new
    step.  `batch` holds tensors (`batch_to`)."""

    def train_step(params, opt_state: AdamWState, batch):
        loss, grads = loss_and_grads(params, cfg, batch)
        gnorm = global_norm(tree_leaves(grads))
        params, opt_state = opt.update(grads, opt_state, params,
                                       gnorm=gnorm)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   "lr": opt.schedule(opt_state.step)}

    return train_step


def train_loop(cfg: ArchConfig, *, steps: int, batch_iter, opt: AdamW,
               params=None, generator: Optional[torch.Generator] = None,
               device="cuda", log_every: int = 10, callback=None):
    """`steps` train steps over `batch_iter`'s (numpy) batches.  The
    weights are `params` or, without them, `init_params` drawn from
    `generator` (seed 0 on `device` by default; torch cannot draw the
    reference's `jax.random` weights).  Returns (params, opt_state,
    history), history holding {"step", "loss", "grad_norm", "lr"} every
    `log_every` steps and at the last; `callback(step, metrics)` sees each
    entry."""
    device = resolve_device(device)
    if params is None:
        generator = generator or torch.Generator(device=device).manual_seed(0)
        params = M.init_params(cfg, generator, device)
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt)
    history = []
    for i in range(steps):
        batch = batch_to(next(batch_iter), device)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if i % log_every == 0 or i == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            history.append({"step": i, **m})
            if callback:
                callback(i, m)
    return params, opt_state, history
