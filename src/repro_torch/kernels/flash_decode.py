"""Wrapper of the CUDA flash-decode kernel (csrc/flash_decode.cu).

Replaces the Pallas TPU kernel `repro.kernels.flash_decode.flash_decode`.
The kernel is built on first use by `kernels.build` (nvcc for sm_90a, a
plain C interface loaded with ctypes).

The wrapper only checks, plans and launches: on a CUDA tensor it launches
the kernel or raises, and it raises on any other device.  Which version
runs is decided in `ops.decode_attention`.  `plan` cuts T into pieces by
the card's SM count; `wide_path` is the rule for 16-byte loads.  Partial
softmax states of multi-piece sequences go to a workspace kept per device
and grown on demand, so a call allocates only its output.
`flash_decode.launches` counts kernel launches, so a run can show that its
main path went through the kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from . import build as _build

SOURCE = "flash_decode.cu"
MAX_G = 16        # query heads per kv head (csrc MAX_G)
MAX_D = 256       # head_dim (csrc MAX_D)
MIN_PIECE = 64    # a piece is a multiple of 64 rows
MAX_PIECE = 512   # longer pieces gain no bandwidth, only a longer tail
MAX_SPLIT = 256   # pieces per sequence (csrc MAX_SPLIT)
MIN_BLOCKS_PER_SM = 2
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_n_sm: dict[int, int] = {}
_workspace: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
# buffers a captured CUDA graph may still point at, kept alive
_retired: list[tuple[torch.Tensor, torch.Tensor]] = []


def build() -> tuple[Path, str]:
    """Compile the kernel library (see `kernels.build.build`)."""
    return _build.build(SOURCE)


def _configure(lib: ctypes.CDLL) -> None:
    fn = lib.flash_decode_launch
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(B: int, K: int, T: int, n_sm: int,
         max_piece: int = MAX_PIECE) -> tuple[int, int]:
    """Rows per piece and pieces per sequence, (piece, n_split).

    The fewest pieces that give the grid (K, B, n_split) at least
    MIN_BLOCKS_PER_SM blocks per SM (every piece past the first of a
    sequence costs a merge), each a multiple of MIN_PIECE rows, at most
    `max_piece` rows (longer pieces leave a longer tail of blocks; the int8
    kernel, whose rows are half the bytes, takes its own limit) and no
    more than MAX_SPLIT pieces (the merging block keeps a weight per piece
    in shared memory).  Piece s holds rows [s * piece, (s+1) * piece)
    below T.
    """
    want = max(1, _cdiv(MIN_BLOCKS_PER_SM * n_sm, B * K))
    piece = T // want // MIN_PIECE * MIN_PIECE   # at least `want` pieces
    piece = min(max(piece, MIN_PIECE), max_piece)
    piece = max(piece, _cdiv(_cdiv(T, MAX_SPLIT), MIN_PIECE) * MIN_PIECE)
    return piece, _cdiv(T, piece)


def wide_path(k: torch.Tensor, v: torch.Tensor) -> bool:
    """True where K and V can be read as 16-byte segments: D a multiple of
    VEC = 16 / element size, both bases on 16-byte boundaries and every
    stride of batch, token and head a multiple of VEC elements.  Otherwise
    the kernel's narrow path loads single elements."""
    vec = 16 // k.element_size()
    return k.shape[3] % vec == 0 and all(
        t.data_ptr() % 16 == 0 and all(s % vec == 0 for s in t.stride()[:3])
        for t in (k, v))


def _sm_count(device: torch.device) -> int:
    n = _n_sm.get(device.index)
    if n is None:
        n = _n_sm[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def _scratch(device: torch.device, n_part: int, n_tickets: int):
    """The device's workspace, grown to n_part f32 and n_tickets int32
    (tickets start at 0; every launch leaves them at 0)."""
    ws = _workspace.get(device.index)
    if ws is None or ws[0].numel() < n_part or ws[1].numel() < n_tickets:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("flash_decode: its workspace must grow, which"
                               " a CUDA graph capture cannot record; call it"
                               " once at this shape before capturing")
        if ws is not None:
            _retired.append(ws)
            n_part = max(n_part, 2 * ws[0].numel())
            n_tickets = max(n_tickets, ws[1].numel())
        ws = _workspace[device.index] = (
            torch.empty(n_part, dtype=torch.float32, device=device),
            torch.zeros(n_tickets, dtype=torch.int32, device=device))
    return ws


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
                 lengths: torch.Tensor, *, return_lse: bool = False):
    """q: (B, H, D); k, v: (B, T, K, D); lengths: (B,) int32 -> (B, H, D).

    Attends query head h to kv head h // (H/K) over t < lengths[b];
    lengths above T count as T, and a sequence with lengths[b] <= 0 gets a
    zero output.  Output in q.dtype.  `return_lse` returns instead the
    output in float32 (the values before their rounding to q.dtype) and
    the softmax state, (B, H) f32 lse = ln sum_t exp(s_t), -inf where
    lengths[b] <= 0: what `ops.merge_decode` merges outputs over pieces
    of T with.  CUDA tensors only.  Calls on one device share its
    workspace, so they must not overlap on two streams.  No backward:
    raises where autograd would record the call (`build.refuse_grad`).
    """
    check_inputs(q, k, v, lengths)
    _build.refuse_grad("flash_decode", q, k, v, lengths)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_decode launches a CUDA kernel; got tensors"
                         f" on {dev}")
    lib = _build.load(SOURCE, _configure)
    B, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    piece, n_split = plan(B, K, T, _sm_count(dev))
    part = tickets = 0
    if n_split > 1:
        ws = _scratch(dev, B * H * n_split * (D + 2), B * K)
        part, tickets = ws[0].data_ptr(), ws[1].data_ptr()
    out = torch.empty((B, H, D), device=dev,
                      dtype=torch.float32 if return_lse else q.dtype)
    lse = torch.empty((B, H), dtype=torch.float32, device=dev) \
        if return_lse else None
    strides = (ctypes.c_int64 * 8)(q.stride(0), q.stride(1), *k.stride()[:3],
                                   *v.stride()[:3])
    with torch.cuda.device(dev):
        err = lib.flash_decode_launch(
            _DTYPE_CODE[q.dtype], wide_path(k, v), q.data_ptr(),
            k.data_ptr(), v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            lse.data_ptr() if return_lse else None, part, tickets, B, T, H,
            K, D, piece, n_split, strides,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_decode launch failed (code {err})")
    flash_decode.launches += 1
    return (out, lse) if return_lse else out


flash_decode.launches = 0
