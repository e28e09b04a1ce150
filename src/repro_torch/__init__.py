"""PyTorch/CUDA port of the 1/W-law serving system, for an NVIDIA H100.

A second package beside the JAX reference `repro`: the same module names,
PyTorch inside, and hand-written CUDA kernels in place of the Pallas TPU
kernels (`csrc/`).  Entry points run on `cuda` unless the caller passes
`device="cpu"`; without a GPU they raise rather than fall back.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; raises when CUDA is asked for and
    absent, so nothing carries on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run"
                           " on the CPU")
    return dev
