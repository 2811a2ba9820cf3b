"""ctypes bridge to the native float64 QP solver (``csrc/qp_solver.cpp``).

The shared library is built at first use with ``g++ -O3 -shared -fPIC``
into ``qp-<hash>/`` under the kernels' build root
(``said_tpu_torch._build.build_root()``: ``build/said_tpu_torch/`` beside
the package unless ``--compilation_cache_dir`` moved it; the hash
covers the source and the flags, so an edited source rebuilds), never
into the source tree. A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from said_tpu_torch import _build

_SRC = Path(__file__).resolve().parent / "csrc" / "qp_solver.cpp"
_FLAGS = ("-O3", "-shared", "-fPIC")

_D = ctypes.POINTER(ctypes.c_double)
_ARGTYPES = (
    _D,  # gram (N, N)
    _D,  # q (T, N)
    ctypes.c_int,  # T
    ctypes.c_int,  # N
    ctypes.c_double,  # delta
    ctypes.c_double,  # tol
    ctypes.c_int,  # max_iters
    _D,  # w_init (T, N) or NULL
    _D,  # out_w (T, N)
)


def library_path() -> Path:
    """Where the library for the current source lives (built or not)."""
    h = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes())
    return _build.build_root() / f"qp-{h.hexdigest()[:16]}" / "libsaidqp.so"


@functools.cache
def load() -> ctypes.CDLL:
    """Build (if needed) and load the solver; raises ``RuntimeError`` with
    the compiler's output if ``g++`` fails."""
    out = library_path()
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = ["g++", *_FLAGS, "-o", str(tmp), str(_SRC)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as err:
            raise RuntimeError(f"native QP solver: {' '.join(cmd)} did not run: {err}") from err
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"native QP solver: g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: concurrent processes each write their own file
    lib = ctypes.CDLL(str(out))
    _build.mark_loaded(out)
    lib.said_solve_sequence_qp.restype = ctypes.c_int
    lib.said_solve_sequence_qp.argtypes = _ARGTYPES
    return lib


def solve_sequence_qp_native(
    gram: np.ndarray,
    q: np.ndarray,
    delta: float = 0.1,
    init_vals: Optional[np.ndarray] = None,
    max_iters: int = 20000,
    tol: float = 1e-9,
) -> Tuple[np.ndarray, int]:
    """The sequence QP in float64 through the C++ solver → ((T, N) weights,
    iterations run)."""
    gram = np.ascontiguousarray(gram, dtype=np.float64)
    q = np.ascontiguousarray(q, dtype=np.float64)
    if q.ndim != 2 or gram.shape != (q.shape[1], q.shape[1]):
        raise ValueError(f"QP shapes: gram {gram.shape}, q {q.shape} (want (N, N) and (T, N))")
    t, n = q.shape
    w0 = None if init_vals is None else np.ascontiguousarray(init_vals, dtype=np.float64).reshape(t, n)
    out = np.empty((t, n), dtype=np.float64)
    ptr = lambda a: a.ctypes.data_as(_D)  # noqa: E731
    iters = load().said_solve_sequence_qp(ptr(gram), ptr(q), t, n, float(delta), float(tol), int(max_iters),
                                          None if w0 is None else ptr(w0), ptr(out))
    if iters < 0:
        raise ValueError(f"native QP solver refused the problem (T={t}, N={n})")
    return out, iters
