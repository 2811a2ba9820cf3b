"""Build the CUDA C++ kernels in ``csrc/`` at first use and load them.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``,
all started together, and the objects are linked into one shared
library with a plain C interface, loaded through ``ctypes``. The library
lands in ``build/said_tpu_torch/<hash>/`` beside the package, keyed by a
hash of the sources and flags, so an unchanged checkout builds once and
an edited source rebuilds. The probe kernels (``csrc/probes/*.cu``, off
the serving and training paths) build the same way into a second
library, ``libsaid_probes.so``, with a hash of their own sources and
headers (``csrc/probes/`` and the shared ``csrc/*.cuh``): neither
library's hash sees the other's sources. Nothing here runs at import
time.

The root of these builds (and of the native QP library's and Triton's
cache) is ``build_root()``: ``BUILD_ROOT`` unless ``set_build_root``
(the CLIs' ``--compilation_cache_dir``) moved it before the first load.
"""

from __future__ import annotations

import atexit
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
_PROBES = _CSRC / "probes"
# the default root of the builds, beside the package
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "said_tpu_torch"
_root: Path | None = None  # set by set_build_root
_loaded: list[Path] = []  # what this process loaded from the root
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
# the probe library's entry points (csrc/probes/)
_PROBE_SIGNATURES = {
    # q, k, v, shift (NULL or (B, T, H) f32), out, B, T, S, H, stage, variant, ones, floor, dtype, stream
    "said_probe_flash": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P),
    # q, k, v (NULL for the dot stages), out, BH, T, S, stage, dequant_log2, pv_scale, stream
    "said_probe_int8_qk": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P),
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); nvcc is needed to build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _hash(files) -> str:
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for src in files:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_root() -> Path:
    """The directory the kernels build into and load from."""
    return BUILD_ROOT if _root is None else _root


def set_build_root(path) -> Path:
    """Build into and load from ``path`` from now on; Triton's cache moves
    to ``path/triton`` (over ``TRITON_CACHE_DIR``). Raises where the
    process has already loaded a library from another root, and where
    ``path`` cannot be made or written: no build lands elsewhere unsaid."""
    global _root
    new = Path(path).expanduser().resolve()
    if _loaded and new != build_root():
        raise RuntimeError(f"build root {new}: this process already loaded {_loaded[0]} from {build_root()}; "
                           f"set the root before the first kernel, QP or Triton load")
    try:
        new.mkdir(parents=True, exist_ok=True)
        tempfile.TemporaryFile(dir=new).close()
    except OSError as err:
        raise RuntimeError(f"build root {new} is not a writable directory: {err}") from err
    _root = new
    return new


def temporary_root() -> Path:
    """A fresh directory for this process's builds, removed at its exit."""
    path = Path(tempfile.mkdtemp(prefix="said_tpu_torch_build_"))
    atexit.register(shutil.rmtree, path, ignore_errors=True)
    return path


def triton_cache_dir() -> Path:
    """Triton's compile cache: under a root set by ``set_build_root``;
    else ``TRITON_CACHE_DIR`` where the environment sets it, else under
    the default root."""
    if _root is None and os.environ.get("TRITON_CACHE_DIR"):
        return Path(os.environ["TRITON_CACHE_DIR"])
    return build_root() / "triton"


def mark_loaded(path: Path) -> None:
    """Record a load from the root (``set_build_root`` refuses to move it
    after one)."""
    _loaded.append(path)


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    return build_root() / _hash(sorted(_CSRC.glob("*.cu*"))) / "libsaid_kernels.so"


def probe_library_path() -> Path:
    """Where the probe library for the current sources lives (built or not)."""
    files = sorted(_PROBES.glob("*.cu*")) + sorted(_CSRC.glob("*.cuh"))
    return build_root() / "probes" / _hash(files) / "libsaid_probes.so"


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


def _load(out: Path, sources, signatures) -> ctypes.CDLL:
    """Build ``out`` from ``sources`` (one nvcc each, in parallel) unless it
    exists, load it and set its entry points' signatures."""
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        nvcc, tag = _nvcc(), os.getpid()
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
    mark_loaded(out)
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    return _load(library_path(), sorted(_CSRC.glob("*.cu")), _SIGNATURES)


@functools.cache
def probe_library() -> ctypes.CDLL:
    """Build (if needed) and load the probe kernels' library."""
    return _load(probe_library_path(), sorted(_PROBES.glob("*.cu")), _PROBE_SIGNATURES)


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
