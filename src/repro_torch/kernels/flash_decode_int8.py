"""int8-KV flash decode: `quantize_kv` and the wrapper of its CUDA kernel
(csrc/flash_decode_int8.cu).

Replaces the Pallas TPU kernel
`repro.kernels.flash_decode_int8.flash_decode_int8` and mirrors that
module's names.  K/V live in device memory as int8 codes with one f32
scale per (token, kv head); the kernel widens the codes in registers, so
the cache streams at a little over half the bytes of bf16 (2 D + 8 bytes
per token and kv head, against 4 D).  The kernel is built on first use by
`kernels.build` (nvcc for sm_90a, a plain C interface loaded with ctypes).

`quantize_kv` is plain tensor code on any device, as the reference's is jnp
outside its kernel.  `flash_decode_int8` only checks, plans and launches:
on a CUDA tensor it launches the kernel or raises, and it raises on any
other device.  Which version runs is decided in
`ops.decode_attention_int8`.  T is cut into pieces by `flash_decode.plan`
with MAX_PIECE rows at most, and the partial softmax states of
multi-piece sequences go to `flash_decode`'s per-device workspace, so a
call allocates only its output.  `flash_decode_int8.launches` counts
kernel launches, so a run can show that its path went through the kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from . import build as _build
from . import flash_decode as _fd
from .flash_decode import _DTYPE_CODE

SOURCE = "flash_decode_int8.cu"
MAX_G = 16        # query heads per kv head (csrc MAX_G)
MAX_D = 256       # head_dim (csrc MAX_D), a multiple of 16
# rows a piece at most: an int8 row is half a bf16 row's bytes, and at the
# long shapes (16 x 8192, 4 x 65536) fewer pieces leave fewer merges and a
# shorter last wave of blocks; 1536 read fastest over random lengths there
# among 512-1536 on an H100 (the serve shapes are cut finer anyway)
MAX_PIECE = 1536


def quantize_kv(k: torch.Tensor, v: torch.Tensor):
    """Symmetric per-(token, head) int8 quantization over D.

    k, v: (B, T, K, D) float -> (kq, vq int8 (B, T, K, D), ks, vs float32
    (B, T, K)): scale = max|x| / 127 in f32, floored at 1e-8; codes =
    x / scale rounded half to even, clipped to +-127.
    """
    def one(x):
        x = x.float()
        # divided by a tensor, not a Python number: given a number,
        # PyTorch's CUDA division multiplies by its reciprocal, which
        # rounds otherwise than the CPU's (and the reference's) division
        s = (x.abs().amax(-1) / x.new_tensor(127.0)).clamp(min=1e-8)
        codes = torch.round(x / s[..., None]).clamp(-127, 127)
        return codes.to(torch.int8), s

    kq, ks = one(k)
    vq, vs = one(v)
    return kq, vq, ks, vs


def build() -> tuple[Path, str]:
    """Compile the kernel library (see `kernels.build.build`)."""
    return _build.build(SOURCE)


def _configure(lib: ctypes.CDLL) -> None:
    fn = lib.flash_decode_int8_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int


def check_inputs(q, kq, vq, ks, vs, lengths) -> None:
    """Raise unless the kernel (and its plain version) takes these inputs."""
    if q.dim() != 3 or kq.dim() != 4 or vq.shape != kq.shape \
            or tuple(ks.shape) != tuple(kq.shape[:3]) \
            or vs.shape != ks.shape:
        raise ValueError(f"flash_decode_int8 wants q (B,H,D), kq = vq"
                         f" (B,T,K,D), ks = vs (B,T,K); got"
                         f" {tuple(q.shape)}, {tuple(kq.shape)},"
                         f" {tuple(vq.shape)}, {tuple(ks.shape)},"
                         f" {tuple(vs.shape)}")
    B, H, D = q.shape
    T, K = kq.shape[1], kq.shape[2]
    if kq.shape[0] != B or kq.shape[3] != D or tuple(lengths.shape) != (B,):
        raise ValueError("flash_decode_int8: batch, head_dim or lengths"
                         " shape disagree")
    if T < 1 or K < 1 or H % K or H // K > MAX_G or D % 16 \
            or not 16 <= D <= MAX_D:
        raise ValueError(f"flash_decode_int8 takes H % K == 0,"
                         f" H/K <= {MAX_G}, D a multiple of 16 up to"
                         f" {MAX_D}, T >= 1; got H={H} K={K} D={D} T={T}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_decode_int8 takes a float32 or bfloat16 q;"
                        f" got {q.dtype}")
    if kq.dtype != torch.int8 or vq.dtype != torch.int8 \
            or ks.dtype != torch.float32 or vs.dtype != torch.float32:
        raise TypeError(f"flash_decode_int8 takes int8 kq/vq and float32"
                        f" ks/vs; got {kq.dtype}, {vq.dtype}, {ks.dtype},"
                        f" {vs.dtype}")
    if lengths.dtype != torch.int32:
        raise TypeError(f"flash_decode_int8 wants int32 lengths, got"
                        f" {lengths.dtype}")
    if len({t.device for t in (q, kq, vq, ks, vs, lengths)}) != 1:
        raise ValueError("flash_decode_int8: inputs must share a device")
    if q.stride(-1) != 1 or not lengths.is_contiguous() or any(
            t.stride(-1) != 1 or t.data_ptr() % 16
            or any(s % 16 for s in t.stride()[:3]) for t in (kq, vq)):
        raise ValueError("flash_decode_int8 wants the head_dim axis of q,"
                         " kq, vq contiguous, every kq/vq row on a 16-byte"
                         " boundary, and contiguous lengths")


def plan(B: int, K: int, T: int, n_sm: int) -> tuple[int, int]:
    """Rows per piece and pieces per sequence, (piece, n_split):
    `flash_decode.plan` with pieces of at most MAX_PIECE rows."""
    return _fd.plan(B, K, T, n_sm, max_piece=MAX_PIECE)


def flash_decode_int8(q: torch.Tensor, kq: torch.Tensor, vq: torch.Tensor,
                      ks: torch.Tensor, vs: torch.Tensor,
                      lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, H, D) float32/bfloat16; kq, vq: int8 (B, T, K, D); ks, vs:
    float32 (B, T, K); lengths: (B,) int32 -> (B, H, D) in q.dtype.

    Attends query head h to kv head h // (H/K), K and V dequantized as
    codes times scale, over t < lengths[b]; lengths above T count as T, and
    a sequence with lengths[b] <= 0 gets a zero output (the Pallas kernel
    averages V over all T rows there; the model never asks).  CUDA tensors
    only.  Calls on one device share `flash_decode`'s workspace, so they
    must not overlap on two streams.  No backward: raises where autograd
    would record the call (`build.refuse_grad`).
    """
    check_inputs(q, kq, vq, ks, vs, lengths)
    _build.refuse_grad("flash_decode_int8", q, kq, vq, ks, vs, lengths)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_decode_int8 launches a CUDA kernel; got"
                         f" tensors on {dev}")
    lib = _build.load(SOURCE, _configure)
    B, H, D = q.shape
    T, K = kq.shape[1], kq.shape[2]
    piece, n_split = plan(B, K, T, _fd._sm_count(dev))
    part = tickets = 0
    if n_split > 1:
        ws = _fd._scratch(dev, B * H * n_split * (D + 2), B * K)
        part, tickets = ws[0].data_ptr(), ws[1].data_ptr()
    out = torch.empty((B, H, D), dtype=q.dtype, device=dev)
    strides = (ctypes.c_int64 * 14)(
        *q.stride()[:2], *kq.stride()[:3], *vq.stride()[:3], *ks.stride(),
        *vs.stride())
    with torch.cuda.device(dev):
        err = lib.flash_decode_int8_launch(
            _DTYPE_CODE[q.dtype], q.data_ptr(), kq.data_ptr(),
            vq.data_ptr(), ks.data_ptr(), vs.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), part, tickets, B, T, H, K, D, piece, n_split,
            strides, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_decode_int8 launch failed (code {err})")
    flash_decode_int8.launches += 1
    return out


flash_decode_int8.launches = 0
