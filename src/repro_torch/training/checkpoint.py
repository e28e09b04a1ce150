"""Checkpoints in the reference's npz layout, readable by either package.

Keys are the reference pytree's paths joined by "/" (`embed`,
`unit/b0_attn/wq`, `shared/...`, `encoder/unit/...`,
`encoder/final_norm`), each leaf stacked over the repeats, plus
`__step__`.  bfloat16 leaves are written as float32, which holds them
exactly (the reference's loader casts each leaf to its template's dtype);
a reference file's bfloat16 leaves, which `np.load` returns as 2-byte void
arrays, are read bit for bit.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import numpy as np

from ..models.convert import (convert_params, flatten_paths,
                              to_reference_layout, unflatten_paths)
from .optimizer import tree_map


def save_checkpoint(path: str, params: Dict[str, Any], step: int = 0) -> None:
    flat = flatten_paths(to_reference_layout(params))
    flat["__step__"] = np.asarray(step)
    tmp = path + ".tmp"
    np.savez(tmp, **flat)
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def load_checkpoint(path: str, template: Dict[str, Any]
                    ) -> Tuple[Dict[str, Any], int]:
    """Restore into the structure of `template` (each leaf's shape, dtype
    and device kept); returns (params, step)."""
    keys = set(flatten_paths(to_reference_layout(template)))
    with np.load(path) as data:
        step = int(data["__step__"])
        missing = keys - set(data.files)
        if missing:
            raise KeyError(f"{path} lacks {sorted(missing)}")
        flat = {key: data[key] for key in keys}
    loaded = convert_params(unflatten_paths(flat), device="cpu")

    def restore(t, like):
        if t.shape != like.shape:
            raise ValueError(f"checkpoint leaf of shape {tuple(t.shape)} for"
                             f" a template leaf of {tuple(like.shape)}")
        return t.to(device=like.device, dtype=like.dtype)

    return tree_map(restore, loaded, template), step
