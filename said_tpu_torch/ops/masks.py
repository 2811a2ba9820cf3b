"""Alignment-bias band for audio↔frame cross-attention (numpy).

A copy of ``said_tpu.ops.masks.alignment_band`` / ``band_gather_indices``
/ ``alignment_band_dynamic``: importing that module pulls in jax through
``said_tpu/ops/__init__.py``.
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


def alignment_band_dynamic(
    x_len_pad: int, c_len_pad: int, x_real, c_real, pad: int = 1
) -> Tuple[np.ndarray, np.ndarray]:
    """The band of a padded (x_len_pad, c_len_pad) buffer whose real
    lengths ``x_real``/``c_real`` are scalars or (B,) vectors (bucketed and
    mixed-length batches).

    Returns (idx, valid) of shape (x_len_pad, W), or (B, x_len_pad, W) for
    vectors, with W = ceil(c_len_pad / x_len_pad) + 2·pad + 1 ≥ any real
    width. Rows at or past the real length keep entry 0 valid (a softmax
    needs one unmasked key; those rows are masked downstream). Computed in
    float32, as the JAX version computes it on the device, so both give
    the same table bit for bit.
    """
    f32 = np.float32
    width = int(np.ceil(c_len_pad / x_len_pad)) + 2 * pad + 1
    x_real = np.asarray(x_real, f32)
    c_real = np.asarray(c_real, f32)
    i = np.arange(x_len_pad, dtype=f32)
    if x_real.ndim == 1:
        x_real, c_real, i = x_real[:, None], c_real[:, None], i[None, :]
    r = c_real / x_real
    kh = r / f32(2.0) + f32(pad)
    c_mid = (i + f32(0.5)) * r
    c_min = np.maximum(np.round(c_mid - kh), f32(0.0))
    c_max = np.minimum(np.round(c_mid + kh), c_real)
    raw = c_min[..., None] + np.arange(width, dtype=f32)
    row_dead = i >= x_real
    valid = (raw < c_max[..., None]) & ~row_dead[..., None]
    valid[..., 0] |= row_dead
    idx = np.clip(raw, 0, c_len_pad - 1).astype(np.int32)
    return idx, valid
