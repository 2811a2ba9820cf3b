"""Align-corners linear resampling along time, channels-last.

Port of ``said_tpu.ops.resample.linear_interp_time`` and
``linear_interp_time_dynamic`` (bucketed mode): the reference
stretches the wav2vec2 feature sequence to exactly the blendshape frame
count with ``F.interpolate(mode="linear", align_corners=True)``; here it
is one gather + lerp on (B, T, C) with coordinates computed in numpy.
"""

from __future__ import annotations

import numpy as np
import torch


def linear_interp_time(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """Resample (B, T, C) → (B, out_len, C) with align_corners=True.

    Source coordinate of output index j is ``j * (T - 1) / (out_len - 1)``;
    endpoints map to endpoints exactly.
    """
    t = x.shape[1]
    if out_len == t:
        return x
    if out_len == 1:
        return x[:, :1, :]
    src = np.arange(out_len, dtype=np.float64) * (t - 1) / (out_len - 1)
    lo = np.minimum(np.floor(src).astype(np.int64), t - 2)
    frac = (src - lo).astype(np.float32)

    lo_t = torch.from_numpy(lo).to(x.device)
    frac_t = torch.from_numpy(frac).to(device=x.device, dtype=x.dtype)[None, :, None]
    x_lo = x[:, lo_t, :]
    x_hi = x[:, lo_t + 1, :]
    return x_lo * (1.0 - frac_t) + x_hi * frac_t


def linear_interp_time_dynamic(x: torch.Tensor, out_len_pad: int, in_real, out_real) -> torch.Tensor:
    """Resample (B, T_pad, C), whose first ``in_real`` frames are real, to
    (B, out_len_pad, C) whose first ``out_real`` frames equal the
    align-corners interpolation of the real region alone; the rest is
    garbage the caller masks. ``in_real``/``out_real``: ints, or (B,)
    arrays for per-row lengths.

    The source coordinate j·(in−1)/(out−1) is split exactly in integers,
    as the JAX version does, so bucketed and unbucketed runs agree.
    """
    t_pad = x.shape[1]
    in_real = np.asarray(in_real, np.int64)
    out_real = np.asarray(out_real, np.int64)
    j = np.arange(out_len_pad, dtype=np.int64)
    batched = in_real.ndim == 1
    if batched:
        in_real, out_real, j = in_real[:, None], out_real[:, None], j[None, :]
    denom = np.maximum(out_real - 1, 1)
    num = j * (in_real - 1)
    lo = np.clip(num // denom, 0, np.maximum(in_real - 2, 0))
    lo = np.clip(lo, 0, t_pad - 2)
    rem = num - lo * denom
    frac = rem.astype(np.float32) / denom.astype(np.float32)

    frac_t = torch.from_numpy(frac).to(device=x.device, dtype=x.dtype)[..., None]
    lo_t = torch.from_numpy(lo).to(x.device)
    if batched:
        idx = lo_t[:, :, None].expand(-1, -1, x.shape[2])
        x_lo, x_hi = torch.gather(x, 1, idx), torch.gather(x, 1, idx + 1)
    else:
        frac_t = frac_t[None]
        x_lo, x_hi = x[:, lo_t, :], x[:, lo_t + 1, :]
    return x_lo * (1.0 - frac_t) + x_hi * frac_t
