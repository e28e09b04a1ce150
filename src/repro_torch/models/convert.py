"""Reference weights -> the port's parameters.

Takes the reference `init_params` pytree with its leaves already turned
into numpy arrays (so this module needs nothing of the reference), and
returns the port's parameter dict on `device`:

  * the stacked `params["unit"][name][leaf]` (n_repeat leading axis) is
    unstacked into the list `params["layers"]`;
  * `params["shared"][name][leaf]`, the blocks used at every repeat, is
    carried across as it is;
  * weights keep their (in, out) layout: the port also computes `x @ W`;
  * bfloat16 leaves (numpy has no bfloat16 of its own; the reference hands
    out `ml_dtypes` arrays, which `torch.from_numpy` refuses) go through
    float32, which holds every bfloat16 value exactly.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .. import resolve_device


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)   # a writable copy


def convert_params(ref_params: Dict[str, Any], device="cuda"
                   ) -> Dict[str, Any]:
    device = resolve_device(device)
    if "encoder" in ref_params:
        raise NotImplementedError("reference params with an encoder are not"
                                  " ported yet")
    out = {key: _tensor(ref_params[key], device)
           for key in ("embed", "final_norm", "lm_head") if key in ref_params}
    unit = ref_params["unit"]
    n_repeat = {leaf.shape[0] for blk in unit.values()
                for leaf in blk.values()}
    if len(n_repeat) != 1:
        raise ValueError(f"unit leaves disagree on n_repeat: {n_repeat}")
    out["layers"] = [
        {name: {leaf: _tensor(np.asarray(a)[r], device)
                for leaf, a in blk.items()}
         for name, blk in unit.items()}
        for r in range(n_repeat.pop())]
    if "shared" in ref_params:
        out["shared"] = {name: {leaf: _tensor(a, device)
                                for leaf, a in blk.items()}
                         for name, blk in ref_params["shared"].items()}
    return out
