"""Reference weights <-> the port's parameters.

`convert_params` takes the reference `init_params` pytree with its leaves
already turned into numpy arrays (so this module needs nothing of the
reference), and returns the port's parameter dict on `device`:

  * the stacked `params["unit"][name][leaf]` (n_repeat leading axis) is
    unstacked into the list `params["layers"]`, and the encoder's
    `params["encoder"]["unit"]` (n_layers leading axis) into
    `params["encoder"]["layers"]`;
  * `params["shared"][name][leaf]`, the blocks used at every repeat, is
    carried across as it is;
  * weights keep their (in, out) layout: the port also computes `x @ W`;
  * bfloat16 leaves (numpy has no bfloat16 of its own; the reference hands
    out `ml_dtypes` arrays, which `torch.from_numpy` refuses, and `np.load`
    reads them back as 2-byte void arrays) go through float32, which holds
    every bfloat16 value exactly.

`to_reference_layout` is the reverse: the reference's stacked pytree as
numpy arrays, bfloat16 leaves as float32 (exact), keyed as the reference's
checkpoints key them.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .. import resolve_device


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or (a.dtype.kind == "V"
                                      and a.dtype.itemsize == 2):
        # the bits of a bfloat16 are the upper half of a float32's
        bits = a.view(np.uint16).astype(np.uint32) << 16
        return torch.from_numpy(bits.view(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)   # a writable copy


def _unstack(unit: Dict[str, Dict[str, Any]], device) -> list:
    """{name: {leaf: (R, ...)}} -> R dicts {name: {leaf: (...)}}."""
    n = {np.shape(a)[0] for blk in unit.values() for a in blk.values()}
    if len(n) != 1:
        raise ValueError(f"unit leaves disagree on their leading axis: {n}")
    return [{name: {leaf: _tensor(np.asarray(a)[r], device)
                    for leaf, a in blk.items()}
             for name, blk in unit.items()}
            for r in range(n.pop())]


def convert_params(ref_params: Dict[str, Any], device="cuda"
                   ) -> Dict[str, Any]:
    device = resolve_device(device)
    out = {key: _tensor(ref_params[key], device)
           for key in ("embed", "final_norm", "lm_head") if key in ref_params}
    out["layers"] = _unstack(ref_params["unit"], device)
    if "shared" in ref_params:
        out["shared"] = {name: {leaf: _tensor(a, device)
                                for leaf, a in blk.items()}
                         for name, blk in ref_params["shared"].items()}
    if "encoder" in ref_params:
        enc = ref_params["encoder"]
        out["encoder"] = {"layers": _unstack(enc["unit"], device),
                          "final_norm": _tensor(enc["final_norm"], device)}
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _stack(layers: list) -> Dict[str, Dict[str, np.ndarray]]:
    return {name: {leaf: np.stack([_numpy(layer[name][leaf])
                                   for layer in layers])
                   for leaf in blk}
            for name, blk in layers[0].items()}


def to_reference_layout(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's parameters as the reference's pytree of numpy arrays:
    `unit` (and the encoder's `unit`) stacked over the repeats, bfloat16
    leaves as float32."""
    out: Dict[str, Any] = {key: _numpy(params[key])
                           for key in ("embed", "final_norm", "lm_head")
                           if key in params}
    out["unit"] = _stack(params["layers"])
    if "shared" in params:
        out["shared"] = {name: {leaf: _numpy(t) for leaf, t in blk.items()}
                         for name, blk in params["shared"].items()}
    if "encoder" in params:
        enc = params["encoder"]
        out["encoder"] = {"unit": _stack(enc["layers"]),
                          "final_norm": _numpy(enc["final_norm"])}
    return out


def unflatten_paths(flat: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of `flatten_paths`: {"a/b": leaf} -> {"a": {"b": leaf}}."""
    tree: Dict[str, Any] = {}
    for key, leaf in flat.items():
        *parents, name = key.split("/")
        node = tree
        for parent in parents:
            node = node.setdefault(parent, {})
        node[name] = leaf
    return tree


def flatten_paths(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """{"a": {"b": leaf}} -> {"a/b": leaf}: the reference checkpoint's keys
    (its path-flattened pytree; dict keys joined by "/")."""
    flat = {}
    for key in sorted(tree):
        value, path = tree[key], f"{prefix}{key}"
        if isinstance(value, dict):
            flat.update(flatten_paths(value, path + "/"))
        else:
            flat[path] = value
    return flat
