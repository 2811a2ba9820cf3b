"""Exponential moving average of parameters, in place.

The JAX package's ``said_tpu.train.ema``: the effective decay warms up as
``min(decay, (1 + step) / (10 + step))`` (float32), so early steps track
the raw weights closely before converging to the configured decay
(0.9999 for SAiD).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def ema_decay(decay: float, step: int) -> float:
    """The warmed-up decay at ``step``, formed in float32 as the JAX
    package forms it."""
    s = np.float32(step)
    return float(np.minimum(np.float32(decay), (np.float32(1.0) + s) / (np.float32(10.0) + s)))


@torch.no_grad()
def ema_update_(ema: Sequence[torch.Tensor], params: Sequence[torch.Tensor], decay: float, step: int) -> None:
    """One EMA step in place: ema ← d·ema + (1 − d)·param, d the warmed
    decay at ``step`` (each product rounded, then the sum, as the JAX
    ``ema_update``)."""
    d = ema_decay(decay, step)
    ema, params = list(ema), [p.detach() for p in params]
    torch._foreach_mul_(ema, d)
    torch._foreach_add_(ema, torch._foreach_mul(params, float(np.float32(1.0) - np.float32(d))))
