"""GEGLU feed-forward: router, plain twin, and the CUDA C++ kernel wrapper.

Port of ``said_tpu.ops.pallas_ffn`` (router ``geglu_ffn`` :59, twin
``_geglu_ffn_jnp`` :28). The kernel, ``csrc/geglu_ffn.cu``, replaces
``geglu_ffn_pallas`` (said_tpu/ops/pallas_ffn.py:87, K8); its source note
says what bounds it and how it is laid out.

Weights are in the torch ``nn.Linear`` layout of the reference's
``ff.net.0.proj`` / ``ff.net.2``: w1 (2I, C), b1 (2I,), w2 (C, I), b2 (C,).
Numerics of both paths: both products accumulate in f32, the gate is
``a · gelu_erf(g)`` in f32, and for bf16 inputs y is rounded to bf16
before the second product.
"""

from __future__ import annotations

import math

import torch

from said_tpu_torch import _build

_INV_SQRT2 = 1.0 / math.sqrt(2.0)


def geglu_ffn_plain(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
) -> torch.Tensor:
    """Plain twin with the kernel's numerics (``_geglu_ffn_jnp``)."""
    dt = x.dtype
    h = torch.matmul(x.float(), w1.to(dt).float().t()) + b1.float()
    a, g = h.chunk(2, dim=-1)
    y = a * 0.5 * g * (1.0 + torch.erf(g * _INV_SQRT2))
    out = torch.matmul(y.to(dt).float(), w2.to(dt).float().t()) + b2.float()
    return out.to(dt)


def geglu_ffn(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
) -> torch.Tensor:
    """Router: plain twin on the CPU, the CUDA kernel otherwise. The
    caller passes the weights in x's dtype (the modules cache that cast)
    and the biases in float32."""
    if x.device.type == "cpu":
        return geglu_ffn_plain(x, w1, b1, w2, b2)
    return geglu_ffn_kernel(x, w1, b1, w2, b2)


def geglu_ffn_kernel(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
) -> torch.Tensor:
    """Launch ``said_geglu_ffn`` on a contiguous (..., C) CUDA tensor.

    w1/w2 in x's dtype, b1/b2 float32, all contiguous on x's device;
    C = 192 (the UNet's width, the only one on the path) and I a
    multiple of 64.
    """
    name = "geglu_ffn_kernel"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: needs a CUDA tensor, got device {x.device}")
    if x.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"{name}: dtype {x.dtype} not supported (float32, bfloat16)")
    c = x.shape[-1]
    inner = w1.shape[0] // 2
    if c != 192 or inner % 64 or inner == 0:
        raise ValueError(f"{name}: needs C == 192 and I % 64 == 0, got C={c}, I={inner}")
    expected = {"w1": (w1, (2 * inner, c), x.dtype), "b1": (b1, (2 * inner,), torch.float32),
                "w2": (w2, (c, inner), x.dtype), "b2": (b2, (c,), torch.float32)}
    for key, (p, shape, dtype) in expected.items():
        if tuple(p.shape) != shape or p.dtype != dtype or p.device != x.device or not p.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous {dtype} {shape} on {x.device}, "
                             f"got {p.dtype} {tuple(p.shape)} on {p.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: input is on {x.device}, not the current device")
    out = torch.empty_like(x)
    m = x.numel() // c
    if m == 0:
        return out
    err = _build.library().said_geglu_ffn(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        out.data_ptr(), m, c, inner, _build.DTYPE_CODE[x.dtype],
        torch.cuda.current_stream().cuda_stream,
    )
    _build.check(err, name)
    geglu_ffn_kernel.launches += 1
    return out


geglu_ffn_kernel.launches = 0
