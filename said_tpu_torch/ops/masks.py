"""Alignment-bias band for audio↔frame cross-attention (numpy).

A copy of ``said_tpu.ops.masks.alignment_band`` / ``band_gather_indices``:
importing that module pulls in jax through ``said_tpu/ops/__init__.py``.
Query frame ``i`` may attend to context positions ``[c_min_i, c_max_i)``:

    r      = c_len / x_len
    kh     = r / 2 + pad
    c_mid  = (i + 0.5) * r
    c_min  = max(round(c_mid - kh), 0)
    c_max  = min(round(c_mid + kh), c_len)

``np.round`` is round-half-even, like Python's ``round``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def alignment_band(x_len: int, c_len: int, pad: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Per-query [c_min, c_max) band bounds. Returns two (x_len,) int arrays."""
    r = c_len / x_len
    kh = r / 2 + pad
    i = np.arange(x_len, dtype=np.float64)
    c_mid = (i + 0.5) * r
    c_min = np.maximum(np.round(c_mid - kh), 0).astype(np.int64)
    c_max = np.minimum(np.round(c_mid + kh), c_len).astype(np.int64)
    return c_min, c_max


def band_gather_indices(
    x_len: int, c_len: int, pad: int = 1
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Gather layout for banded cross-attention.

    Returns ``(idx, valid, width)``: ``idx`` (x_len, width) int32 context
    positions per query (clipped into range), ``valid`` the matching bool
    mask of in-band entries, ``width`` the maximum band width.
    """
    c_min, c_max = alignment_band(x_len, c_len, pad)
    width = int((c_max - c_min).max())
    offs = np.arange(width, dtype=np.int64)[None, :]
    raw = c_min[:, None] + offs
    valid = raw < c_max[:, None]
    idx = np.clip(raw, 0, c_len - 1).astype(np.int32)
    return idx, valid, width
