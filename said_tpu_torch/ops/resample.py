"""Align-corners linear resampling along time, channels-last.

Port of ``said_tpu.ops.resample.linear_interp_time``: the reference
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
