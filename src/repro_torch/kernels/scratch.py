"""Per-device float32 workspaces of the scan kernels, grown on demand.

A call on one device reuses that device's buffer, so calls of one kernel
must not overlap on two streams.  A buffer grows outside a CUDA-graph
capture only (growth allocates, which a capture cannot record): call the
kernel once at a shape before capturing it.  A grown-out buffer is kept
alive, since a captured graph may still point at it.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

_buffers: Dict[Tuple[str, int], torch.Tensor] = {}
_retired: List[torch.Tensor] = []


def workspace(owner: str, device: torch.device, n: int) -> torch.Tensor:
    """`owner`'s buffer on `device`, at least `n` floats (at least one, so
    that it has an address).  Its contents are whatever the last call
    left."""
    key = (owner, device.index)
    buf = _buffers.get(key)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{owner}: its workspace must grow, which a"
                               f" CUDA graph capture cannot record; call it"
                               f" once at this shape before capturing")
        if buf is not None:
            _retired.append(buf)
            n = max(n, 2 * buf.numel())
        buf = _buffers[key] = torch.empty(max(n, 1), dtype=torch.float32,
                                          device=device)
    return buf
