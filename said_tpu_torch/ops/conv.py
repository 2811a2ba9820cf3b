"""Stride-2 VALID conv1d + exact-erf GELU: router, plain twin, and the
CUDA C++ kernel wrapper.

Port of ``said_tpu.ops.pallas_conv`` (router ``strided_conv_gelu`` :87,
twin ``_strided_conv_gelu_jnp`` :62). The kernel,
``csrc/strided_conv_gelu.cu``, replaces ``strided_conv_gelu_pallas``
(said_tpu/ops/pallas_conv.py:133, K9); its source note says what bounds
it and how it is laid out.

x (B, T_in, C_in) channels-last; kernel (K, C_in, C_out) — the flax
layout, which the modules derive once from the torch (C_out, C_in, K)
weight. No bias (wav2vec2-base's ``conv_bias=False``). Both paths
accumulate the taps in f32 and apply the GELU in f32.
"""

from __future__ import annotations

import math

import torch

from said_tpu_torch import _build

_INV_SQRT2 = 1.0 / math.sqrt(2.0)


def gelu_f32(h: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU on an f32 tensor (torch ``F.gelu`` default)."""
    return h * 0.5 * (1.0 + torch.erf(h * _INV_SQRT2))


def strided_conv_gelu_plain(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Plain twin with the kernel's numerics (``_strided_conv_gelu_jnp``)."""
    k = kernel.shape[0]
    dt = x.dtype
    t_out = (x.shape[1] - k) // 2 + 1
    w = kernel.to(dt).float()
    h = None
    for j in range(k):
        tap = x[:, j : j + 2 * (t_out - 1) + 1 : 2, :].float()
        contrib = torch.matmul(tap, w[j])
        h = contrib if h is None else h + contrib
    return gelu_f32(h).to(dt)


def strided_conv_gelu(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Router: plain twin on the CPU, the CUDA kernel otherwise. The
    caller passes the kernel in x's dtype (the modules cache that cast)."""
    if x.device.type == "cpu":
        return strided_conv_gelu_plain(x, kernel)
    return strided_conv_gelu_kernel(x, kernel)


def strided_conv_gelu_kernel(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Launch ``said_strided_conv_gelu`` on a contiguous (B, T_in, C_in)
    CUDA tensor; kernel (K, C_in, C_out) contiguous in x's dtype."""
    name = "strided_conv_gelu_kernel"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: needs a CUDA tensor, got device {x.device}")
    if x.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"{name}: dtype {x.dtype} not supported (float32, bfloat16)")
    if x.ndim != 3 or kernel.ndim != 3 or kernel.shape[1] != x.shape[2]:
        raise ValueError(f"{name}: needs x (B, T, C_in) and kernel (K, C_in, C_out), "
                         f"got {tuple(x.shape)} and {tuple(kernel.shape)}")
    b, t_in, c_in = x.shape
    k, _, c_out = kernel.shape
    if t_in < k:
        raise ValueError(f"{name}: T_in={t_in} is shorter than the kernel (K={k})")
    if kernel.dtype != x.dtype or kernel.device != x.device or not kernel.is_contiguous():
        raise ValueError(f"{name}: kernel must be contiguous {x.dtype} on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: input is on {x.device}, not the current device")
    t_out = (t_in - k) // 2 + 1
    out = torch.empty((b, t_out, c_out), dtype=x.dtype, device=x.device)
    if b == 0:
        return out
    err = _build.library().said_strided_conv_gelu(
        x.data_ptr(), kernel.data_ptr(), out.data_ptr(),
        b, t_in, t_out, c_in, c_out, k, _build.DTYPE_CODE[x.dtype],
        torch.cuda.current_stream().cuda_stream,
    )
    _build.check(err, name)
    strided_conv_gelu_kernel.launches += 1
    return out


strided_conv_gelu_kernel.launches = 0
