"""Build the CUDA C++ kernels in ``csrc/`` at first use and load them.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``,
all started together, and the objects are linked into one shared
library with a plain C interface, loaded through ``ctypes``. The library
lands in ``build/said_tpu_torch/<hash>/`` beside the package, keyed by a
hash of the sources and flags, so an unchanged checkout builds once and
an edited source rebuilds. Nothing here runs at import time.
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
    "-Xcompiler", "-fPIC",
)

# dtype codes of the C entry points (csrc/common.cuh: said::DType)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# name -> argtypes of the C entry points; each returns a cudaError_t code
_SIGNATURES = {
    # x, w1, b1, w2, b2, out, M, C, I, dtype, tile_rows, cluster, stream
    "said_geglu_ffn": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # x, w (packed), out, B, T_in, T_out, C_in, C_out, K, dtype, route, split, stream
    "said_strided_conv_gelu": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # x, w, b, y, rows, C, eps, dtype, vector route, lanes a row, chunks a lane,
    # rows a block, stream
    "said_layer_norm": (_P, _P, _P, _P, _I, _I, _F, _I, _I, _I, _I, _I, _P),
    # q, k, v, out, lengths (NULL or (B,) int32), B, T, S, H, D, dtype, stream
    "said_flash_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # x, w, b, y, lengths (NULL or (B,) int32), B, T, C, G, eps, silu, dtype,
    # groups a block, cluster size, stream
    "said_group_norm": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _P),
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


def _run_all(cmds) -> None:
    """Run the commands in parallel; raise with the output of each that failed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        output = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{output}")
    if failed:
        raise RuntimeError("\n".join(failed))


@functools.cache
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    out = library_path()
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        nvcc, tag = _nvcc(), os.getpid()
        sources = sorted(_CSRC.glob("*.cu"))
        objects = [out.with_name(f"{src.stem}.{tag}.o") for src in sources]
        tmp = out.with_name(f"{out.name}.{tag}.tmp")
        try:
            _run_all([[nvcc, *_NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                      for src, obj in zip(sources, objects)])
            _run_all([[nvcc, *_NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)]])
            os.replace(tmp, out)
        finally:
            for obj in objects:
                obj.unlink(missing_ok=True)
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
