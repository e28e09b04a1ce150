"""Wrapper of the CUDA Mamba2 SSD scan kernel (csrc/mamba_scan.cu).

Replaces the Pallas TPU kernel `repro.kernels.mamba_scan.mamba_scan`.
The kernel is built on first use by `kernels.build` (nvcc for sm_90a, a
plain C interface loaded with ctypes).  Like the Pallas kernel it starts
from a zero state; the plain version `ref.mamba_scan_ref` also takes an
initial state.

The wrapper only checks and launches: on a CUDA tensor it launches the
kernel or raises, and it raises on any other device.  Which version runs
is decided in `ops.ssd_scan`.  `mamba_scan.launches` counts kernel
launches, so a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from . import build as _build

SOURCE = "mamba_scan.cu"
MAX_HD = 64       # head_dim (csrc MAX_HD)
MAX_DS = 64       # state size (csrc MAX_DS)
CHUNK = 128       # tokens per chunk (csrc LC)


def build() -> tuple[Path, str]:
    """Compile the kernel library (see `kernels.build.build`)."""
    return _build.build(SOURCE)


def _configure(lib: ctypes.CDLL) -> None:
    fn = lib.mamba_scan_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_int64] * 10 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


def check_inputs(xt, Bm, Cm, lA) -> None:
    """Raise unless the kernel (and its plain version) takes these inputs."""
    if xt.dim() != 4 or Bm.dim() != 3 or Cm.shape != Bm.shape \
            or lA.dim() != 3:
        raise ValueError(f"mamba_scan wants xt (B,S,nh,hd), Bm = Cm (B,S,ds),"
                         f" lA (B,S,nh); got {tuple(xt.shape)},"
                         f" {tuple(Bm.shape)}, {tuple(Cm.shape)},"
                         f" {tuple(lA.shape)}")
    B, S, nh, hd = xt.shape
    if Bm.shape[:2] != (B, S) or tuple(lA.shape) != (B, S, nh):
        raise ValueError("mamba_scan: batch, length or head counts disagree")
    ds = Bm.shape[2]
    if S < 1 or nh < 1 or not 1 <= hd <= MAX_HD or not 1 <= ds <= MAX_DS:
        raise ValueError(f"mamba_scan takes S >= 1, hd <= {MAX_HD},"
                         f" ds <= {MAX_DS}; got S={S} hd={hd} ds={ds}")
    if any(t.dtype != torch.float32 for t in (xt, Bm, Cm, lA)):
        raise TypeError(f"mamba_scan takes float32 inputs; got {xt.dtype},"
                        f" {Bm.dtype}, {Cm.dtype}, {lA.dtype}")
    if len({t.device for t in (xt, Bm, Cm, lA)}) != 1:
        raise ValueError("mamba_scan: inputs must share a device")
    if xt.stride(-1) != 1 or Bm.stride(-1) != 1 or Cm.stride(-1) != 1:
        raise ValueError("mamba_scan wants the last axis of xt, Bm and Cm"
                         " contiguous")


def mamba_scan(xt: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
               lA: torch.Tensor):
    """xt: (B,S,nh,hd); Bm, Cm: (B,S,ds); lA: (B,S,nh), all float32.

    Returns (y (B,S,nh,hd), final_state (B,nh,hd,ds)), float32, from a
    zero state.  CUDA tensors only.
    """
    check_inputs(xt, Bm, Cm, lA)
    if xt.device.type != "cuda":
        raise ValueError(f"mamba_scan launches a CUDA kernel; got tensors on"
                         f" {xt.device}")
    lib = _build.load(SOURCE, _configure)
    B, S, nh, hd = xt.shape
    ds = Bm.shape[2]
    y = torch.empty((B, S, nh, hd), dtype=torch.float32, device=xt.device)
    fin = torch.empty((B, nh, hd, ds), dtype=torch.float32,
                      device=xt.device)
    with torch.cuda.device(xt.device):
        err = lib.mamba_scan_launch(
            xt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), lA.data_ptr(),
            y.data_ptr(), fin.data_ptr(), B, S, nh, hd, ds,
            *xt.stride()[:3], *Bm.stride()[:2], *Cm.stride()[:2],
            *lA.stride(),
            torch.cuda.current_stream(xt.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan launch failed (code {err})")
    mamba_scan.launches += 1
    return y, fin


mamba_scan.launches = 0
