"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled on first use with nvcc for sm_90a into a shared
library with a plain C interface under `build/repro_torch/` at the
repository root, and loaded with ctypes.  The library's file name carries
a hash of the source and of the shared headers (csrc/*.cuh), so an edited
source or header is rebuilt.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA"
                           " toolkit to build")
    return nvcc


def build(source: str) -> Tuple[Path, str]:
    """Compile `csrc/<source>` if this text has not been built yet.

    Returns the library's path and the compiler's output (`-Xptxas -v`
    register and shared-memory report; empty when the build was reused).
    """
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    tag = digest.hexdigest()[:16]
    lib = BUILD_DIR / f"lib{src.stem}_{tag}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}"
                           f"{res.stderr}")
    os.replace(tmp, lib)
    return lib, res.stdout + res.stderr


def load(source: str,
         configure: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The built library of `source`, loaded once;
    `configure` sets the argument and return types of its C functions
    (pointers and the stream as c_void_p: ctypes would otherwise pass them
    as 32-bit ints and cut them)."""
    if source not in _loaded:
        path, _ = build(source)
        lib = ctypes.CDLL(str(path))
        configure(lib)
        _loaded[source] = lib
    return _loaded[source]
