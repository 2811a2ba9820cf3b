"""Cyclical KL-weight annealing for BCVAE training: the port's copy of
``said_tpu.utils.scheduler`` (reference ``said/util/scheduler.py``), held
to it bit for bit."""

from __future__ import annotations

import numpy as np


def frange_cycle_linear(
    n_iter: int,
    start: float = 0.0,
    stop: float = 1.0,
    n_cycle: int = 10,
    ratio: float = 0.5,
) -> np.ndarray:
    """Cyclical linear β schedule (Fu et al., cyclical annealing).

    Each cycle ramps linearly from ``start`` for the first ``ratio``
    fraction of the cycle, then holds at ``stop``. The ramp is one
    cumulative sum (sequential accumulation, so the ``v <= stop`` cutoff
    lands on the same float as an iterative ``v += step``), scattered once
    per cycle.
    """
    beta = np.full(n_iter, float(stop))
    period = n_iter / n_cycle
    step = (stop - start) / (period * ratio)

    # v_i = start + i·step accumulated left to right; keep the prefix with
    # v <= stop (a cycle never needs more than n_iter points)
    with np.errstate(invalid="ignore", over="ignore"):
        vals = np.cumsum(np.concatenate(([float(start)], np.full(n_iter, step))))
    over = np.nonzero(~(vals <= stop))[0]
    if over.size:
        vals = vals[: over[0]]

    offsets = np.arange(vals.size)
    for c in range(n_cycle):
        idx = (offsets + c * period).astype(np.int64)
        ok = idx < n_iter
        beta[idx[ok]] = vals[ok]
    return beta
