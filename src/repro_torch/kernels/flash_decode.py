"""Wrapper of the CUDA flash-decode kernel (csrc/flash_decode.cu).

Replaces the Pallas TPU kernel `repro.kernels.flash_decode.flash_decode`.
The kernel is built on first use by `kernels.build` (nvcc for sm_90a, a
plain C interface loaded with ctypes).

The wrapper only checks and launches: on a CUDA tensor it launches the
kernel or raises, and it raises on any other device.  Which version runs
is decided in `ops.decode_attention`.  `flash_decode.launches` counts
kernel launches, so a run can show that its main path went through the
kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from . import build as _build

SOURCE = "flash_decode.cu"
MAX_G = 16        # query heads per kv head (csrc MAX_G)
MAX_D = 256       # head_dim (csrc MAX_D)
CHUNK = 256       # KV rows per block; T is split into ceil(T / CHUNK) pieces
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def build() -> tuple[Path, str]:
    """Compile the kernel library (see `kernels.build.build`)."""
    return _build.build(SOURCE)


def _configure(lib: ctypes.CDLL) -> None:
    fn = lib.flash_decode_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 6 + [ctypes.c_int64] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


def check_inputs(q, k, v, lengths) -> None:
    """Raise unless the kernel (and its plain version) takes these inputs."""
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_decode wants q (B,H,D), k = v (B,T,K,D);"
                         f" got {tuple(q.shape)}, {tuple(k.shape)},"
                         f" {tuple(v.shape)}")
    B, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or tuple(lengths.shape) != (B,):
        raise ValueError("flash_decode: batch, head_dim or lengths shape"
                         " disagree")
    if T < 1 or K < 1 or H % K or H // K > MAX_G or D > MAX_D:
        raise ValueError(f"flash_decode takes H % K == 0, H/K <= {MAX_G},"
                         f" D <= {MAX_D}, T >= 1; got H={H} K={K} D={D}"
                         f" T={T}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_decode takes float32 or bfloat16 q/k/v of one"
                        f" dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if lengths.dtype != torch.int32:
        raise TypeError(f"flash_decode wants int32 lengths, got"
                        f" {lengths.dtype}")
    if len({t.device for t in (q, k, v, lengths)}) != 1:
        raise ValueError("flash_decode: q, k, v and lengths must share a"
                         " device")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1 \
            or not lengths.is_contiguous():
        raise ValueError("flash_decode wants the head_dim axis of q, k, v"
                         " contiguous, and contiguous lengths")


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, H, D); k, v: (B, T, K, D); lengths: (B,) int32 -> (B, H, D).

    Attends query head h to kv head h // (H/K) over t < lengths[b];
    lengths above T count as T, and a sequence with lengths[b] <= 0 gets a
    zero output.  Output in q.dtype.  CUDA tensors only.
    """
    check_inputs(q, k, v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode launches a CUDA kernel; got tensors"
                         f" on {q.device}")
    lib = _build.load(SOURCE, _configure)
    B, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    n_split = -(-T // CHUNK)
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    # per-piece softmax state (m, l, unnormalised acc) the merge pass reads
    m_part = torch.empty((B, H, n_split), dtype=torch.float32,
                         device=q.device)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty((B, H, n_split, D), dtype=torch.float32,
                           device=q.device)
    with torch.cuda.device(q.device):
        err = lib.flash_decode_launch(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), m_part.data_ptr(),
            l_part.data_ptr(), acc_part.data_ptr(), B, T, H, K, D, n_split,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_decode launch failed (code {err})")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
