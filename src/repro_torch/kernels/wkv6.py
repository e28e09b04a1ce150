"""Wrapper of the CUDA RWKV6 recurrence kernel (csrc/wkv6.cu).

Replaces the Pallas TPU kernel `repro.kernels.wkv6.wkv6`.  The kernel is
built on first use by `kernels.build` (nvcc for sm_90a, a plain C
interface loaded with ctypes).  Like the Pallas kernel it starts from a
zero state; the plain version `ref.wkv6_ref` also takes an initial state.

The wrapper only checks, plans and launches: on a CUDA tensor it launches
the kernel or raises, and it raises on any other device.  Which version
runs is decided in `ops.wkv_scan`.  A call issues one launch when S fits
one chunk and three otherwise (`plan`); the per-chunk states go to a
workspace kept per device (`kernels.scratch`).  `wkv6.launches` counts
calls of the wrapper, one per call however many kernels it issues, so a
run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from . import build as _build
from . import scratch as _scratch

SOURCE = "wkv6.cu"
MAX_HD = 64       # head_dim (csrc MAX_HD)
CHUNK = 64        # tokens per chunk (csrc LC)
TILE = 16         # rows of an output tile and of a sub-chunk (csrc TILE)


def build() -> tuple[Path, str]:
    """Compile the kernel library (see `kernels.build.build`)."""
    return _build.build(SOURCE)


def _configure(lib: ctypes.CDLL) -> None:
    fn = lib.wkv6_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int64] \
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(B: int, S: int, H: int, hd: int) -> dict:
    """What one call launches (csrc `wkv6_launch` computes the same).

    chunks: 64-token chunks; tiles: 16-row output tiles per chunk (a
    prompt shorter than a chunk gets only the tiles it fills); launches: 1
    for one chunk (its state and output blocks together), else 3 (state
    blocks, the pass over the chunks, output blocks); state_blocks: one
    per (batch, head, chunk); y_blocks: one per (batch, head, chunk,
    tile); workspace: floats of per-chunk states, decays and prefix sums
    of log w (none for one chunk).
    """
    nc = _cdiv(S, CHUNK)
    nt = min(CHUNK // TILE, _cdiv(S, TILE))
    return dict(chunks=nc, tiles=nt, launches=1 if nc == 1 else 3,
                state_blocks=B * H * nc, y_blocks=B * H * nc * nt,
                workspace=B * H * nc * (hd * hd + hd + CHUNK * hd)
                if nc > 1 else 0)


def wide_path(*ts: torch.Tensor) -> bool:
    """True where the (B, S, H, hd) operands can be read as 16-byte
    segments: hd a multiple of 4 and every base on a 16-byte boundary (the
    tensors are contiguous, so every row stride is a multiple of hd).
    Otherwise the kernel loads single elements."""
    return ts[0].shape[-1] % 4 == 0 and all(t.data_ptr() % 16 == 0
                                            for t in ts)


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
    zero state.  CUDA tensors only.  Calls on one device share its
    workspace, so they must not overlap on two streams.  No backward:
    raises where autograd would record the call (`build.refuse_grad`).
    """
    check_inputs(r, k, v, w, u)
    _build.refuse_grad("wkv6", r, k, v, w, u)
    dev = r.device
    if dev.type != "cuda":
        raise ValueError(f"wkv6 launches a CUDA kernel; got tensors on"
                         f" {dev}")
    lib = _build.load(SOURCE, _configure)
    B, S, H, hd = r.shape
    n_ws = plan(B, S, H, hd)["workspace"]
    ws = _scratch.workspace("wkv6", dev, n_ws) if n_ws else None
    y = torch.empty((B, S, H, hd), dtype=torch.float32, device=dev)
    fin = torch.empty((B, H, hd, hd), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.wkv6_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), y.data_ptr(), fin.data_ptr(),
            ws.data_ptr() if ws is not None else None,
            ws.numel() if ws is not None else 0, B, S, H, hd,
            int(wide_path(r, k, v, w)),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wkv6 launch failed (code {err})")
    wkv6.launches += 1
    return y, fin


wkv6.launches = 0
