"""Wrapper of the CUDA RWKV6 recurrence kernel (csrc/wkv6.cu).

Replaces the Pallas TPU kernel `repro.kernels.wkv6.wkv6`.  The kernel is
built on first use by `kernels.build` (nvcc for sm_90a, a plain C
interface loaded with ctypes).  Like the Pallas kernel it starts from a
zero state; the plain version `ref.wkv6_ref` also takes an initial state.

The wrapper only checks and launches: on a CUDA tensor it launches the
kernel or raises, and it raises on any other device.  Which version runs
is decided in `ops.wkv_scan`.  `wkv6.launches` counts kernel launches, so
a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from . import build as _build

SOURCE = "wkv6.cu"
MAX_HD = 64       # head_dim (csrc MAX_HD)
CHUNK = 64        # tokens per chunk (csrc LC)


def build() -> tuple[Path, str]:
    """Compile the kernel library (see `kernels.build.build`)."""
    return _build.build(SOURCE)


def _configure(lib: ctypes.CDLL) -> None:
    fn = lib.wkv6_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int


def check_inputs(r, k, v, w, u) -> None:
    """Raise unless the kernel (and its plain version) takes these inputs."""
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"wkv6 wants r = k = v = w (B,S,H,hd); got"
                         f" {[tuple(t.shape) for t in (r, k, v, w)]}")
    B, S, H, hd = r.shape
    if tuple(u.shape) != (H, hd):
        raise ValueError(f"wkv6 wants u (H,hd) = {(H, hd)}; got"
                         f" {tuple(u.shape)}")
    if S < 1 or H < 1 or not 1 <= hd <= MAX_HD:
        raise ValueError(f"wkv6 takes S >= 1, hd <= {MAX_HD}; got S={S}"
                         f" hd={hd}")
    if any(t.dtype != torch.float32 for t in (r, k, v, w, u)):
        raise TypeError(f"wkv6 takes float32 inputs; got"
                        f" {[t.dtype for t in (r, k, v, w, u)]}")
    if len({t.device for t in (r, k, v, w, u)}) != 1:
        raise ValueError("wkv6: inputs must share a device")
    if not all(t.is_contiguous() for t in (r, k, v, w, u)):
        raise ValueError("wkv6 wants contiguous r, k, v, w and u")


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor):
    """r, k, v, w: (B,S,H,hd); u: (H,hd), all float32.

    Returns (out (B,S,H,hd), final_state (B,H,hd,hd)), float32, from a
    zero state.  CUDA tensors only.
    """
    check_inputs(r, k, v, w, u)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6 launches a CUDA kernel; got tensors on"
                         f" {r.device}")
    lib = _build.load(SOURCE, _configure)
    B, S, H, hd = r.shape
    y = torch.empty((B, S, H, hd), dtype=torch.float32, device=r.device)
    fin = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        err = lib.wkv6_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), y.data_ptr(), fin.data_ptr(), B, S, H, hd,
            torch.cuda.current_stream(r.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wkv6 launch failed (code {err})")
    wkv6.launches += 1
    return y, fin


wkv6.launches = 0
