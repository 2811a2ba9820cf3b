"""Build the CUDA C++ kernels in ``csrc/`` at first use and load them.

All ``csrc/*.cu`` files are compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded through ``ctypes``. The
library lands in ``build/said_tpu_torch/<hash>/`` beside the package,
keyed by a hash of the sources and flags, so an unchanged checkout builds
once and an edited source rebuilds. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "said_tpu_torch"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
)

# dtype codes of the C entry points (csrc/common.cuh: said::DType)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes of the C entry points; each returns a cudaError_t code
_SIGNATURES = {
    # x, w1, b1, w2, b2, out, M, C, I, dtype, stream
    "said_geglu_ffn": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # x, w, out, B, T_in, T_out, C_in, C_out, K, dtype, stream
    "said_strided_conv_gelu": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); nvcc is needed to build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libsaid_kernels.so"


@functools.cache
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    out = library_path()
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp),
               *map(str, sorted(_CSRC.glob("*.cu")))]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}"
            )
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
