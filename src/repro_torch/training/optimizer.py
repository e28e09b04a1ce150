"""AdamW over a parameter tree, with the reference's arithmetic.

A parameter tree is the model's: dicts and lists whose leaves are tensors.
Not `torch.optim.AdamW`, whose order of operations differs: this keeps the
reference's (`repro.training.optimizer`), all in float32:

  * the gradients are clipped by their global norm, scale =
    min(1, clip / (norm + 1e-9));
  * lr = schedule(step): linear warmup, then cosine down to 0.1 x lr,
    computed in float32 as the reference computes it;
  * bias corrections 1 - b ** step in float32;
  * the weight decay is added to the update of every leaf, norms and
    biases included;
  * the update is taken in float32 and cast back to the leaf's dtype.

A leaf the loss does not read has no gradient in torch (`None`), where
JAX gives zeros; it counts as zeros here, so weight decay still moves it
and its moments still decay, as in the reference.

The step updates the parameters and the moments in place (the reference's
train step donates them) and returns them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

Tree = Any


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts and lists, in a fixed order (dict
    keys sorted, as JAX orders a pytree's leaves)."""
    if isinstance(tree, dict):
        return [t for key in sorted(tree) for t in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [t for item in tree for t in tree_leaves(item)]
    return [tree]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """`fn` applied leaf by leaf over trees of one structure."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest))
                for key in tree}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, *items) for items in zip(tree, *rest)]
    return fn(tree, *rest)


def global_norm(grads: List[Optional[torch.Tensor]]) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(g ** 2), in float32; a `None`
    leaf adds 0."""
    total = None
    for g in grads:
        if g is None:
            continue
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


class AdamWState(NamedTuple):
    step: int
    mu: Tree
    nu: Tree


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 20
    total_steps: int = 1000

    def init(self, params: Tree) -> AdamWState:
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return AdamWState(step=0, mu=tree_map(zeros, params),
                          nu=tree_map(zeros, params))

    def schedule(self, step: int) -> float:
        """The learning rate at `step`, in float32 arithmetic."""
        f32 = np.float32
        step = f32(step)
        warm = np.minimum(step / f32(max(self.warmup_steps, 1)), f32(1.0))
        prog = np.clip((step - f32(self.warmup_steps))
                       / f32(max(self.total_steps - self.warmup_steps, 1)),
                       f32(0), f32(1))
        cos = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * prog))
        return float(f32(self.lr) * warm * (f32(0.1) + f32(0.9) * cos))

    @torch.no_grad()
    def update(self, grads: Tree, state: AdamWState, params: Tree, *,
               gnorm: Optional[torch.Tensor] = None
               ) -> Tuple[Tree, AdamWState]:
        """One step; `grads` has the structure of `params`, with `None`
        for a leaf that got no gradient.  `gnorm` is their global norm
        where the caller has it already.  Updates params, mu and nu in
        place and returns (params, the new state)."""
        g_leaves = tree_leaves(grads)
        p_leaves = tree_leaves(params)
        m_leaves, v_leaves = tree_leaves(state.mu), tree_leaves(state.nu)
        if not len(g_leaves) == len(p_leaves) == len(m_leaves):
            raise ValueError("grads, params and moments differ in structure")
        if gnorm is None:
            gnorm = global_norm(g_leaves)
        scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
        step = state.step + 1
        lr = self.schedule(step)
        f32 = np.float32
        b1t = float(f32(1) - f32(self.b1) ** f32(step))
        b2t = float(f32(1) - f32(self.b2) ** f32(step))
        for g, m, v, p in zip(g_leaves, m_leaves, v_leaves, p_leaves):
            g = torch.zeros_like(m) if g is None else g.float() * scale
            m.copy_(self.b1 * m + (1 - self.b1) * g)
            v.copy_(self.b2 * v + (1 - self.b2) * g * g)
            upd = (m / b1t) / (torch.sqrt(v / b2t) + self.eps)
            upd = upd + self.weight_decay * p.float()
            p.copy_((p.float() - lr * upd).to(p.dtype))
        return params, AdamWState(step=step, mu=state.mu, nu=state.nu)
