"""Multi-head attention on flat (B, T, H·D) projections, f32 softmax.

Port of ``said_tpu.ops.attention``: the banded cross-attention over
pre-gathered keys (``banded_attention_cached``) and the dense branch of
``multi_head_attention``. Below 2048 frames the JAX package runs both as
plain einsums even on the TPU, so neither is a kernel.

``self_attention`` is the router that ``flash_attention_flat`` is in the
JAX package. Above 2048 frames the TPU runs the flash kernel
``_flash_tpu_packed`` (``said_tpu/ops/pallas_attention.py:186``), which
has no Hopper port yet (ROADMAP Queue 2, K1): on CUDA such a clip raises
instead of running a substitute. On the CPU the dense path serves every
length, as the JAX package does off-TPU.
"""

from __future__ import annotations

import torch

_NEG_INF = float(torch.finfo(torch.float32).max)

# Longest self-attention (frames) the dense path serves on CUDA; the JAX
# router's ``_DENSE_MAX`` (said_tpu/ops/pallas_attention.py:522).
DENSE_MAX = 2048


def _softmax_f32(scores: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    return torch.softmax(scores.float(), dim=-1).to(out_dtype)


def banded_attention_cached(
    q: torch.Tensor,
    k_win: torch.Tensor,
    v_win: torch.Tensor,
    valid: torch.Tensor,
    num_heads: int,
) -> torch.Tensor:
    """Banded cross-attention with pre-gathered keys/values.

    q (B, T, H·D); k_win/v_win (B, T, W, H, D); valid (T, W) bool.
    """
    b, t, inner = q.shape
    d = inner // num_heads
    qh = q.reshape(b, t, num_heads, d)
    scores = torch.einsum("bthd,btwhd->bhtw", qh, k_win) * d**-0.5
    # masked in f32: -finfo(f32).max does not fit bf16
    scores = scores.float().masked_fill(~valid[None, None], -_NEG_INF)
    attn = _softmax_f32(scores, qh.dtype)
    out = torch.einsum("bhtw,btwhd->bthd", attn, v_win)
    return out.reshape(b, t, inner)


def dense_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int
) -> torch.Tensor:
    """Materialized-scores attention: q (B, T, H·D), k/v (B, S, H·D)."""
    b, t, inner = q.shape
    s = k.shape[1]
    d = inner // num_heads
    qh = q.reshape(b, t, num_heads, d)
    kh = k.reshape(b, s, num_heads, d)
    vh = v.reshape(b, s, num_heads, d)
    scores = torch.einsum("bthd,bshd->bhts", qh, kh) * d**-0.5
    attn = _softmax_f32(scores, qh.dtype)
    out = torch.einsum("bhts,bshd->bthd", attn, vh)
    return out.reshape(b, t, inner)


def self_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int
) -> torch.Tensor:
    """Router for unmasked self-attention (the JAX ``flash_attention_flat``).

    CPU: dense at any length. Any other device: dense up to
    ``DENSE_MAX`` frames; beyond, ``NotImplementedError`` — the flash
    kernel that serves those lengths on the TPU is not ported yet.
    """
    if q.device.type != "cpu" and max(q.shape[1], k.shape[1]) > DENSE_MAX:
        raise NotImplementedError(
            f"self-attention over {max(q.shape[1], k.shape[1])} frames needs "
            f"the flash-attention kernel (K1, _flash_tpu_packed, "
            f"said_tpu/ops/pallas_attention.py:186), which is not ported to "
            f"CUDA yet (ROADMAP Queue 2 item K1); clips up to {DENSE_MAX} "
            f"frames ({DENSE_MAX / 60:.1f} s at 60 fps) run on the dense path"
        )
    return dense_attention(q, k, v, num_heads)
