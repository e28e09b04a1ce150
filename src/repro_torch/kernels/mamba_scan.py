"""Wrapper of the CUDA Mamba2 SSD scan kernel (csrc/mamba_scan.cu).

Replaces the Pallas TPU kernel `repro.kernels.mamba_scan.mamba_scan`.
The kernel is built on first use by `kernels.build` (nvcc for sm_90a, a
plain C interface loaded with ctypes).  Like the Pallas kernel it starts
from a zero state; the plain version `ref.mamba_scan_ref` also takes an
initial state.

The wrapper only checks, plans and launches: on a CUDA tensor it launches
the kernel or raises, and it raises on any other device.  Which version
runs is decided in `ops.ssd_scan`.  A call issues two launches when S
fits one chunk and three otherwise (`plan`); C . B^T per chunk and the
per-chunk states go to a workspace kept per device (`kernels.scratch`).
`mamba_scan.launches` counts calls of the wrapper, one per call however
many kernels it issues, so a run can show that its main path went
through the kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from . import build as _build
from . import scratch as _scratch

SOURCE = "mamba_scan.cu"
MAX_HD = 64       # head_dim (csrc MAX_HD)
MAX_DS = 64       # state size (csrc MAX_DS)
CHUNK = 128       # tokens per chunk (csrc LC)
TILE = 16         # rows of an output or C . B^T tile (csrc TILE)
ROWS = 64         # rows of an output block past one chunk


def build() -> tuple[Path, str]:
    """Compile the kernel library (see `kernels.build.build`)."""
    return _build.build(SOURCE)


def _configure(lib: ctypes.CDLL) -> None:
    fn = lib.mamba_scan_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int64]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_void_p])
    fn.restype = ctypes.c_int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(B: int, S: int, nh: int, hd: int, ds: int) -> dict:
    """What one call launches (csrc `mamba_scan_launch` computes the same).

    chunks: 128-token chunks; tiles: 16-row tiles per chunk (a prompt
    shorter than a chunk gets only the tiles it fills); launches: 2 for
    one chunk (C . B^T and state blocks, then output blocks), else 3 (the
    pass over the chunks between them); blocks: C . B^T blocks, one per
    (batch, chunk, tile) for all heads, state blocks, one per (batch,
    head, chunk), and output blocks, one per (batch, head, tile) for one
    chunk, else one per (batch, head, chunk, 64 rows);
    workspace: floats of C . B^T and, past one chunk, of per-chunk states
    and decays.
    """
    nc = _cdiv(S, CHUNK)
    nt = min(CHUNK // TILE, _cdiv(S, TILE))
    ws = B * nc * CHUNK * CHUNK
    if nc > 1:
        ws += B * nh * nc * (hd * ds + 1)
    return dict(chunks=nc, tiles=nt, launches=2 if nc == 1 else 3,
                cb_blocks=B * nc * nt, state_blocks=B * nh * nc,
                y_blocks=B * nh * (nt if nc == 1 else nc * CHUNK // ROWS),
                workspace=ws)


def wide_path(xt: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor) -> bool:
    """True where xt, Bm and Cm can be read as 16-byte segments: hd and ds
    multiples of 4, every base on a 16-byte boundary and every stride of
    batch, token and head a multiple of 4 elements (the model's Bm and Cm
    are strided views of one projection, which qualify).  Otherwise the
    kernel loads single elements."""
    return xt.shape[-1] % 4 == 0 and Bm.shape[-1] % 4 == 0 and all(
        t.data_ptr() % 16 == 0 and all(s % 4 == 0 for s in t.stride()[:-1])
        for t in (xt, Bm, Cm))


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
    zero state.  CUDA tensors only.  Calls on one device share its
    workspace, so they must not overlap on two streams.  No backward:
    raises where autograd would record the call (`build.refuse_grad`).
    """
    check_inputs(xt, Bm, Cm, lA)
    _build.refuse_grad("mamba_scan", xt, Bm, Cm, lA)
    dev = xt.device
    if dev.type != "cuda":
        raise ValueError(f"mamba_scan launches a CUDA kernel; got tensors on"
                         f" {dev}")
    lib = _build.load(SOURCE, _configure)
    B, S, nh, hd = xt.shape
    ds = Bm.shape[2]
    ws = _scratch.workspace("mamba_scan", dev,
                            plan(B, S, nh, hd, ds)["workspace"])
    y = torch.empty((B, S, nh, hd), dtype=torch.float32, device=dev)
    fin = torch.empty((B, nh, hd, ds), dtype=torch.float32, device=dev)
    strides = (ctypes.c_int64 * 10)(*xt.stride()[:3], *Bm.stride()[:2],
                                    *Cm.stride()[:2], *lA.stride())
    with torch.cuda.device(dev):
        err = lib.mamba_scan_launch(
            xt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), lA.data_ptr(),
            y.data_ptr(), fin.data_ptr(), ws.data_ptr(), ws.numel(), B, S,
            nh, hd, ds, strides, int(wide_path(xt, Bm, Cm)),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan launch failed (code {err})")
    mamba_scan.launches += 1
    return y, fin


mamba_scan.launches = 0
