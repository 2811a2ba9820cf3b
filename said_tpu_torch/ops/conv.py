"""Stride-2 VALID conv1d + exact-erf GELU: router, plain twin, and the
CUDA C++ kernel wrapper.

Port of ``said_tpu.ops.pallas_conv`` (router ``strided_conv_gelu`` :87,
twin ``_strided_conv_gelu_jnp`` :62). The kernel,
``csrc/strided_conv_gelu.cu``, replaces ``strided_conv_gelu_pallas``
(said_tpu/ops/pallas_conv.py:133, K9); its source note says what bounds
it and how it is laid out.

x (B, T_in, C_in) channels-last; kernel (K, C_in, C_out) — the flax
layout. The kernel reads the weight K-major, as Wt (C_out, K·C_in): a
(K, C_in, C_out) tensor whose memory is laid out so is "packed"
(``pack_weight``); the modules keep their weight packed (derived once
from the torch (C_out, C_in, K) weight), so no call re-lays it out. No
bias (wav2vec2-base's ``conv_bias=False``). Both paths accumulate the
taps in f32 and apply the GELU in f32.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from said_tpu_torch import _build
from said_tpu_torch.ops import needs_grad

_INV_SQRT2 = 1.0 / math.sqrt(2.0)
# csrc/strided_conv_gelu.cu: the tensor-core routes' output tile (rows and
# columns a block), contraction columns a stage and stages a block, by
# dtype; the FMA route's 64×64 tiles serve any width. Where the tiles are
# fewer than _TARGET_BLOCKS (about one block an SM of an H100's 132), a
# cluster of up to _MAX_SPLIT blocks splits each tile's contraction. From
# the per-split times of chip_smoke.py phase 2 on an NVIDIA H100 80GB HBM3
# at 700 W (PERF.md §6):
# at conv_3 … conv_6 of a 10-s clip this split is within 18% of the
# fastest in both dtypes (aiming at two blocks an SM was up to 36% slower).
TILE = 128
_STAGES = {torch.float32: (16, 4), torch.bfloat16: (64, 3)}
_FMA_TILE = 64
_TARGET_BLOCKS = 128
_MAX_SPLIT = 8
SPLITS = (1, 2, 4, 8)
_ROUTE_CODE = {"fma": 0, "tensor_cores": 1}


class ConvPlan(NamedTuple):
    """How a strided conv call runs, from its shape alone. ``route``
    "tensor_cores" (bf16 ``wgmma``, f32 3xTF32 ``mma.sync``) where C_in is
    a multiple of 64 and C_out of 128, else "fma"; ``tile_m`` × ``tile_n``
    outputs a block, ``tile_k`` contraction columns a stage, ``stages`` in
    the ring (1: none), ``split`` blocks (a cluster) sharing a tile's
    contraction, ``blocks`` in the launch."""

    route: str
    tile_m: int
    tile_n: int
    tile_k: int
    stages: int
    split: int
    blocks: int


@functools.cache
def conv_plan(m: int, c_in: int, c_out: int, dtype: torch.dtype = torch.float32) -> ConvPlan:
    """The plan of a call with ``m`` = B·T_out output rows: the split is
    the smallest power of two (at most _MAX_SPLIT) that makes tiles ×
    split reach _TARGET_BLOCKS (1 where the tiles alone reach it)."""
    if c_in % 64 == 0 and c_out % TILE == 0:
        tile_k, stages = _STAGES[dtype]
        tiles = -(-m // TILE) * (c_out // TILE)
        split = 1
        while split < _MAX_SPLIT and tiles * split < _TARGET_BLOCKS:
            split *= 2
        return ConvPlan("tensor_cores", TILE, TILE, tile_k, stages, split, tiles * split)
    return ConvPlan("fma", _FMA_TILE, _FMA_TILE, 16, 1, 1, -(-m // _FMA_TILE) * -(-c_out // _FMA_TILE))


def gelu_f32(h: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU on an f32 tensor (torch ``F.gelu`` default)."""
    return h * 0.5 * (1.0 + torch.erf(h * _INV_SQRT2))


def pack_weight(kernel: torch.Tensor) -> torch.Tensor:
    """The (K, C_in, C_out) kernel as a packed tensor: same values and
    shape, memory laid out as (C_out, K, C_in), the kernel's Wt."""
    return kernel.permute(2, 0, 1).contiguous().permute(1, 2, 0)


def is_packed(kernel: torch.Tensor) -> bool:
    return kernel.ndim == 3 and kernel.permute(2, 0, 1).is_contiguous()


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
    caller passes the kernel in x's dtype and, to spare a copy a call,
    packed (the modules cache both). Where an input needs a gradient the
    call goes through ``_ConvFn``, whose backward differentiates the plain
    twin, as the JAX ``_conv_bwd`` (said_tpu/ops/pallas_conv.py:112) does
    (the frozen encoder runs it under ``no_grad``)."""
    if needs_grad(x, kernel):
        return _ConvFn.apply(x, kernel)
    return _conv_route(x, kernel)


def _conv_route(x, kernel):
    if x.device.type == "cpu":
        return strided_conv_gelu_plain(x, kernel)
    return strided_conv_gelu_kernel(x, kernel if is_packed(kernel) else pack_weight(kernel))


class _ConvFn(torch.autograd.Function):
    """The conv router with a gradient: the kernel (or twin) forward, the
    plain twin's autograd, recomputed, backward; saves the inputs only."""

    @staticmethod
    def forward(ctx, x, kernel):
        ctx.save_for_backward(x, kernel)
        return _conv_route(x, kernel)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            return torch.autograd.grad(strided_conv_gelu_plain(*inputs), inputs, g)


def strided_conv_gelu_kernel(x: torch.Tensor, kernel: torch.Tensor, *, _split: int | None = None) -> torch.Tensor:
    """Launch ``said_strided_conv_gelu`` on a contiguous (B, T_in, C_in)
    CUDA tensor; kernel (K, C_in, C_out) packed (``pack_weight``) in x's
    dtype. The route and tiles are ``conv_plan``'s; ``_split`` forces one
    of ``SPLITS`` on the tensor-core route, for tests and timing only."""
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
    if kernel.dtype != x.dtype or kernel.device != x.device or not is_packed(kernel):
        raise ValueError(f"{name}: kernel must be packed (conv.pack_weight) {x.dtype} on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: input is on {x.device}, not the current device")
    t_out = (t_in - k) // 2 + 1
    out = torch.empty((b, t_out, c_out), dtype=x.dtype, device=x.device)
    if b == 0:
        return out
    plan = conv_plan(b * t_out, c_in, c_out, x.dtype)
    if _split is not None:
        if plan.route != "tensor_cores" or _split not in SPLITS:
            raise ValueError(f"{name}: split {_split} not one of {SPLITS} on the tensor-core route ({plan.route})")
        plan = plan._replace(split=_split, blocks=plan.blocks // plan.split * _split)
    if plan.route == "tensor_cores" and (x.data_ptr() % 16 or kernel.data_ptr() % 16):
        raise ValueError(f"{name}: x and kernel must start on a 16-byte boundary")
    err = _build.library().said_strided_conv_gelu(
        x.data_ptr(), kernel.data_ptr(), out.data_ptr(),
        b, t_in, t_out, c_in, c_out, k, _build.DTYPE_CODE[x.dtype], _ROUTE_CODE[plan.route], plan.split,
        torch.cuda.current_stream().cuda_stream,
    )
    _build.check(err, name)
    strided_conv_gelu_kernel.launches += 1
    return out


strided_conv_gelu_kernel.launches = 0
