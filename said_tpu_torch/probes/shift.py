"""What the probes compute outside their kernels, in plain torch: the
port's own copies of the JAX package's exp2 shifts and of the int8 probe's
quantization (the JAX package computes these outside any ``pallas_call``
too).

- ``exp2_shift_bound``: ``_exp2_shift_bound``
  (said_tpu/ops/pallas_attention.py:135; ``_SHIFT_SLACK``,
  ``_SHIFT_CLAMP``, ``_LANDMARK_STRIDE`` at :130-132), without its lengths
  (the probes pass none);
- ``qk_shift_bound``: tools/vpu_probe.py:68;
- ``int8_inputs``: tools/int8_qk_probe.py ``main`` (:218-232): the
  pre-folded bf16 inputs, the per-tensor symmetric int8 quantization of
  Q, K and V, ``dequant_log2`` and ``pv_scale``; ``with_ones_column``
  builds V with its ones column as the JAX probes take it (the port's
  kernels hold the column as a constant).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from said_tpu_torch.ops.attention import _q_scale
from said_tpu_torch.probes import HEAD_DIM

LOG2E = math.log2(math.e)
SHIFT_SLACK = 64.0
SHIFT_CLAMP = -120.0
LANDMARK_STRIDE = 256
# the clamp of tools/vpu_probe.py's bound variant
VPU_CLAMP = -80.0


def fold_q(q: torch.Tensor, d: int = HEAD_DIM) -> torch.Tensor:
    """Q scaled by d^-1/2 · log2(e) in f32 (K1's and the JAX probes'
    float32 constant) and rounded to its dtype."""
    return (q.float() * _q_scale(d)).to(q.dtype)


def exp2_shift_bound(qs: torch.Tensor, k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Per-row exp2 shift A (B, T, H) of the JAX ``_exp2_shift_bound``:
    min(the Cauchy-Schwarz bound ‖q̃‖·max‖k‖ + 1, the max over landmark keys
    (every 256th and the max-norm key) + 64), from the pre-folded ``qs``."""
    b, t, inner = qs.shape
    s = k.shape[1]
    h = num_heads
    d = inner // h
    qf = qs.float().reshape(b, t, h, d)
    kf = k.float().reshape(b, s, h, d)
    kn = torch.linalg.vector_norm(kf, dim=-1)  # (b, s, h)
    m = torch.linalg.vector_norm(qf, dim=-1) * kn.amax(dim=1)[:, None, :] + 1.0
    kl = kf[:, torch.arange(0, s, LANDMARK_STRIDE, device=k.device)]
    jmax = kn.argmax(dim=1)  # (b, h): the first max, as jnp.argmax
    kmax = torch.gather(kf, 1, jmax[:, None, :, None].expand(b, 1, h, d))
    sl = torch.einsum("bthd,bshd->bths", qf, torch.cat([kl, kmax], dim=1))
    a = torch.minimum(m, sl.amax(dim=-1) + SHIFT_SLACK)
    return torch.where(torch.isfinite(a), a, 0.0)


def qk_shift_bound(q: torch.Tensor, k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """tools/vpu_probe.py's per-row shift (B, T, H): ‖q̃‖ · max ‖k‖ + 1,
    q̃ the folded Q rounded to its dtype, from the raw ``q``."""
    b, t, inner = q.shape
    h = num_heads
    d = inner // h
    qn = torch.linalg.vector_norm(fold_q(q, d).float().reshape(b, t, h, d), dim=-1)
    kn = torch.linalg.vector_norm(k.float().reshape(b, k.shape[1], h, d), dim=-1).amax(dim=1)
    return qn * kn[:, None, :] + 1.0


def with_ones_column(v: torch.Tensor, value: float = 1.0) -> torch.Tensor:
    """(N, S, D) -> (N, S, D + 1): V with the JAX probes' ones column."""
    return torch.cat([v, torch.full((*v.shape[:-1], 1), value, dtype=v.dtype, device=v.device)], dim=-1)


class Int8Inputs(NamedTuple):
    q_bf: torch.Tensor   # Q · d^-1/2 · log2 e, bf16 (the bf16 stages' Q)
    k_bf: torch.Tensor
    v_bf: torch.Tensor
    q_i8: torch.Tensor   # rint(Q / sq) clipped to ±127, int8
    k_i8: torch.Tensor
    v_i8: torch.Tensor   # rint(V / sv) clipped to ±127, int8 (no ones column)
    dequant_log2: float  # sq · sk · d^-1/2 · log2 e: a raw int32 score in exp2 units
    pv_scale: float      # sv · 127


def int8_inputs(q32: torch.Tensor, k32: torch.Tensor, v32: torch.Tensor) -> Int8Inputs:
    """The int8 probe's inputs from f32 (BH, T, D) tensors, as its ``main``
    makes them: per-tensor symmetric scales max|x| / 127."""
    d = q32.shape[-1]
    scale = d**-0.5
    sq = float(q32.abs().max() / 127.0)
    sk = float(k32.abs().max() / 127.0)
    sv = float(v32.abs().max() / 127.0)

    def quant(x, s):
        return torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)

    return Int8Inputs(
        q_bf=(q32 * scale * LOG2E).to(torch.bfloat16), k_bf=k32.to(torch.bfloat16), v_bf=v32.to(torch.bfloat16),
        q_i8=quant(q32, sq), k_i8=quant(k32, sk), v_i8=quant(v32, sv),
        dequant_log2=sq * sk * scale * LOG2E, pv_scale=sv * 127.0)
