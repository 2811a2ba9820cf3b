"""GEGLU feed-forward: router, plain twin, and the CUDA C++ kernel wrapper.

Port of ``said_tpu.ops.pallas_ffn`` (router ``geglu_ffn`` :59, twin
``_geglu_ffn_jnp`` :28). The kernel, ``csrc/geglu_ffn.cu``, replaces
``geglu_ffn_pallas`` (said_tpu/ops/pallas_ffn.py:87, K8); its source note
says what bounds it and how it is laid out. ``geglu_plan`` picks its rows
per block and cluster size on the host.

Weights are in the torch ``nn.Linear`` layout of the reference's
``ff.net.0.proj`` / ``ff.net.2``: w1 (2I, C), b1 (2I,), w2 (C, I), b2 (C,).
Numerics of both paths: both products accumulate in f32, the gate is
``a · gelu_erf(g)`` in f32, and for bf16 inputs y is rounded to bf16
before the second product.
"""

from __future__ import annotations

import functools
import math

import torch

from said_tpu_torch import _build
from said_tpu_torch.ops import needs_grad

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


# H100 SXM
_SMS = 132
# every plan the kernel takes, by dtype: (rows per block, cluster size)
PLANS = {torch.float32: ((64, 1), (64, 2), (64, 4)),
         torch.bfloat16: ((64, 1), (64, 2), (64, 4), (128, 1), (128, 2), (128, 4))}
# the plan's cost model, in µs on an H100 (fitted to the per-plan times of
# chip_smoke.py phase 2): a block's time per chunk of inner units, by
# (dtype, rows per block), and its fixed cost (launch, pipeline fill,
# epilogue, the cluster's sum)
_UNITS_PER_CHUNK = {torch.float32: 32, torch.bfloat16: 64}
_CHUNK_US = {(torch.float32, 64): 6.25, (torch.bfloat16, 64): 3.07, (torch.bfloat16, 128): 4.33}
_BLOCK_US = 4.0


@functools.cache
def geglu_plan(m: int, dtype: torch.dtype, sms: int = _SMS, inner: int = 768) -> tuple[int, int]:
    """(rows per block, cluster size) of the kernel for ``m`` rows.

    A block holds its rows' output in registers over the inner axis, one
    block an SM; a cluster of 2 or 4 blocks splits one row tile's inner
    units. The plan of ``PLANS`` with the least modelled time wins (the
    first on a tie): waves of blocks × (chunks a block × its time per
    chunk + a fixed cost).
    """
    chunks = inner // _UNITS_PER_CHUNK[dtype]

    def cost(plan):
        rows, cluster = plan
        waves = -(-(-(-m // rows) * cluster) // sms)
        return waves * (chunks / cluster * _CHUNK_US[dtype, rows] + _BLOCK_US)

    return min(PLANS[dtype], key=cost)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def geglu_ffn(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
) -> torch.Tensor:
    """Router: plain twin on the CPU, the CUDA kernel otherwise. The
    caller passes the weights in x's dtype (the modules cache that cast)
    and the biases in float32. Where an input needs a gradient the call
    goes through ``_GegluFn``, whose backward differentiates the plain
    twin, as the JAX ``_ffn_bwd`` (said_tpu/ops/pallas_ffn.py:78) does;
    sampling and validation run it, training the unfused path with
    dropout."""
    if needs_grad(x, w1, b1, w2, b2):
        return _GegluFn.apply(x, w1, b1, w2, b2)
    return _geglu_route(x, w1, b1, w2, b2)


def _geglu_route(x, w1, b1, w2, b2):
    if x.device.type == "cpu":
        return geglu_ffn_plain(x, w1, b1, w2, b2)
    return geglu_ffn_kernel(x, w1, b1, w2, b2)


class _GegluFn(torch.autograd.Function):
    """The GEGLU router with a gradient: the kernel (or twin) forward, the
    plain twin's autograd, recomputed, backward; saves the inputs only."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return _geglu_route(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            return torch.autograd.grad(geglu_ffn_plain(*inputs), inputs, g)


def geglu_ffn_kernel(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    *,
    _plan: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Launch ``said_geglu_ffn`` on a contiguous (..., C) CUDA tensor.

    w1/w2 in x's dtype, b1/b2 float32, all contiguous on x's device;
    x, w1 and w2 on 16-byte boundaries; C = 192 (the UNet's width, the
    only one on the path) and I a multiple of 64. ``_plan`` forces a plan
    of ``PLANS`` (tests and timing only); by default ``geglu_plan``
    picks it.
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
    if any(t.data_ptr() % 16 for t in (x, w1, w2)):
        raise ValueError(f"{name}: x, w1 and w2 must start on a 16-byte boundary")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: input is on {x.device}, not the current device")
    m = x.numel() // c
    plan = geglu_plan(m, x.dtype, _sm_count(x.device.index), inner) if _plan is None else tuple(_plan)
    if plan not in PLANS[x.dtype]:
        raise ValueError(f"{name}: plan {plan} not one of {PLANS[x.dtype]} for {x.dtype}")
    out = torch.empty_like(x)
    if m == 0:
        return out
    err = _build.library().said_geglu_ffn(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        out.data_ptr(), m, c, inner, _build.DTYPE_CODE[x.dtype], plan[0], plan[1],
        torch.cuda.current_stream().cuda_stream,
    )
    _build.check(err, name)
    geglu_ffn_kernel.launches += 1
    return out


geglu_ffn_kernel.launches = 0
