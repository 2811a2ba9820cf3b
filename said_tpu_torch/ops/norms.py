"""LayerNorm and GroupNorm32(+SiLU), plain and masked, with f32
statistics: routers, plain twins, and the Triton kernels for Hopper.

Ports ``said_tpu.ops.norms`` (routers ``layer_norm_f32`` :118,
``group_norm`` :69 and ``group_norm_masked`` :173) and replaces its
Pallas kernels:

- ``layer_norm_kernel`` replaces ``layer_norm_pallas``
  (said_tpu/ops/pallas_norms.py:441, K7).
- ``group_norm_kernel`` replaces ``group_norm_pallas`` (:79, K3) and its
  two-phase form ``group_norm_pallas_blocked`` (:249, K5). The split into
  phases existed only because a long row overflows the TPU's VMEM; this
  kernel streams any T.
- ``group_norm_masked_kernel`` replaces ``group_norm_masked_pallas``
  (:133, K4) and ``group_norm_masked_pallas_blocked`` (:338, K6): the
  same kernel body with a per-row length, so the two statistics streams
  stop at the row's real length while the normalise stream still covers
  all T rows (padded rows hold the finite values the JAX version gives
  them). Every caller builds its frame mask as ``arange(T) < len``, so a
  (B,) length is the same function as K4's (B, T) mask on every input
  the system makes.

What bounds them on the card: device-memory bandwidth (a few flops per
element). The UNet's (2, 600, 192) tensor is 0.9 MB in f32, so at the
main path's sizes launch latency dominates; the encoder's (1, 32k, 512)
conv_0 output is 64 MB. Design: LayerNorm is one program per block of
rows with the whole (padded) row in registers. GroupNorm is one program
per (batch, block of groups); lanes run across channels, so each row of
a tile is one contiguous run of channels and the loads coalesce for both
layouts (6 channels per group at the UNet, 1 at the encoder). It streams
T three times — sum, centred sum of squares, normalise — so the variance
is the two-pass Σ(x−mean)², never E[x²]−mean², exactly like the JAX
kernels and twins. Per-group sums are formed from per-channel sums with
a small one-hot reduction inside the program.

Routers: a CPU tensor runs the plain twin; any other tensor goes to the
kernel, whose wrapper raises unless it is a contiguous CUDA tensor of a
supported dtype. Triton is imported on the first launch only, so this
module imports where Triton is absent. (No ``from __future__ import
annotations`` here: Triton reads the kernels' annotations as written.)
"""

import functools
import os

import torch

from said_tpu_torch._build import BUILD_ROOT

# triton.language, bound by ``_kernels()`` on the first launch. The kernel
# bodies below resolve ``tl`` from this module's globals when Triton
# compiles them; their ``"tl.constexpr"`` annotations are strings.
tl = None

_DTYPES = (torch.float32, torch.bfloat16)


# ----------------------------------------------------------- plain twins


def layer_norm_plain(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """LayerNorm over the last axis, f32 statistics (``_layer_norm_jnp``)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    out = (xf - mean) / torch.sqrt(var + eps)
    return (out * weight.float() + bias.float()).to(x.dtype)


def group_norm_plain(
    x: torch.Tensor,
    num_groups: int,
    weight: torch.Tensor,
    bias: torch.Tensor,
    eps: float = 1e-5,
    act: str = "none",
) -> torch.Tensor:
    """GroupNorm over (B, T, C), stats per (batch, group) over (T, C/G) in
    f32, optional fused SiLU (``_group_norm_jnp``)."""
    b, t, c = x.shape
    g = num_groups
    xf = x.float().reshape(b, t, g, c // g)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = xf.var(dim=(1, 3), keepdim=True, correction=0)
    xf = ((xf - mean) / torch.sqrt(var + eps)).reshape(b, t, c)
    out = xf * weight.float() + bias.float()
    if act == "silu":
        out = out * torch.sigmoid(out)
    return out.to(x.dtype)


def group_norm_masked_plain(
    x: torch.Tensor,
    num_groups: int,
    weight: torch.Tensor,
    bias: torch.Tensor,
    lengths: torch.Tensor,
    eps: float = 1e-5,
    act: str = "none",
) -> torch.Tensor:
    """GroupNorm whose statistics cover only frames ``t < lengths[b]``
    (``_group_norm_masked_jnp``): count = len·C/G (at least 1), two-pass
    f32 mean and variance over the real frames; every frame, padded ones
    included, is normalised with them."""
    b, t, c = x.shape
    g = num_groups
    lens = lengths.to(device=x.device, dtype=torch.int64)
    m = (torch.arange(t, device=x.device)[None, :] < lens[:, None]).float()[:, :, None, None]
    count = (m.sum(dim=1, keepdim=True) * (c // g)).clamp(min=1.0)
    xf = x.float().reshape(b, t, g, c // g)
    mean = (xf * m).sum(dim=(1, 3), keepdim=True) / count
    var = (((xf - mean) * m) ** 2).sum(dim=(1, 3), keepdim=True) / count
    out = ((xf - mean) / torch.sqrt(var + eps)).reshape(b, t, c)
    out = out * weight.float() + bias.float()
    if act == "silu":
        out = out * torch.sigmoid(out)
    return out.to(x.dtype)


# --------------------------------------------------------------- routers


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """LayerNorm router: plain twin on the CPU, the Triton kernel otherwise."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps)
    return layer_norm_kernel(x, weight, bias, eps)


def group_norm(
    x: torch.Tensor,
    num_groups: int,
    weight: torch.Tensor,
    bias: torch.Tensor,
    eps: float = 1e-5,
    act: str = "none",
) -> torch.Tensor:
    """GroupNorm(+SiLU) router: plain twin on the CPU, the Triton kernel
    otherwise."""
    if x.device.type == "cpu":
        return group_norm_plain(x, num_groups, weight, bias, eps, act)
    return group_norm_kernel(x, num_groups, weight, bias, eps, act)


def group_norm_masked(
    x: torch.Tensor,
    num_groups: int,
    weight: torch.Tensor,
    bias: torch.Tensor,
    lengths: torch.Tensor,
    eps: float = 1e-5,
    act: str = "none",
) -> torch.Tensor:
    """Masked GroupNorm(+SiLU) router, (B,) real lengths: plain twin on
    the CPU, the Triton kernel otherwise."""
    if x.device.type == "cpu":
        return group_norm_masked_plain(x, num_groups, weight, bias, lengths, eps, act)
    return group_norm_masked_kernel(x, num_groups, weight, bias, lengths, eps, act)


# ------------------------------------------------------- Triton kernels


def _layer_norm_fwd(
    X, W, B, Y, n_rows, eps,
    C: "tl.constexpr", BLOCK_R: "tl.constexpr", BLOCK_C: "tl.constexpr",
):
    rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
    cols = tl.arange(0, BLOCK_C)
    cmask = cols < C
    mask = (rows < n_rows)[:, None] & cmask[None, :]
    offs = rows.to(tl.int64)[:, None] * C + cols[None, :]
    x = tl.load(X + offs, mask=mask, other=0.0).to(tl.float32)
    mean = tl.sum(x, axis=1) / C
    d = tl.where(mask, x - mean[:, None], 0.0)
    var = tl.sum(d * d, axis=1) / C
    rstd = 1.0 / tl.sqrt(var + eps)
    w = tl.load(W + cols, mask=cmask, other=0.0)
    b = tl.load(B + cols, mask=cmask, other=0.0)
    y = d * rstd[:, None] * w[None, :] + b[None, :]
    tl.store(Y + offs, y.to(Y.dtype.element_ty), mask=mask)


def _group_norm_fwd(
    X, W, B, Y, L, T, C, G, cg, n_gblocks, eps,
    SILU: "tl.constexpr", MASKED: "tl.constexpr", GB: "tl.constexpr",
    CG_P: "tl.constexpr", BLOCK_T: "tl.constexpr",
):
    pid = tl.program_id(0)
    batch = pid // n_gblocks
    g0 = (pid % n_gblocks) * GB
    j = tl.arange(0, GB * CG_P)
    gi = j // CG_P
    ci = j % CG_P
    cmask = (ci < cg) & (g0 + gi < G)
    ch = (g0 + gi) * cg + ci
    # same[r, s]: lanes r and s hold channels of the same (real) group
    same = (gi[:, None] == gi[None, :]) & cmask[None, :]
    base = batch.to(tl.int64) * T * C
    if MASKED:
        # the statistics streams stop at this row's real length
        t_stat = tl.maximum(tl.minimum(tl.load(L + batch), T), 0)
        n = tl.maximum(t_stat * cg, 1)
    else:
        t_stat = T
        n = T * cg

    acc = tl.zeros((BLOCK_T, GB * CG_P), dtype=tl.float32)
    for t0 in range(0, t_stat, BLOCK_T):
        t = t0 + tl.arange(0, BLOCK_T)
        mask = (t < t_stat)[:, None] & cmask[None, :]
        offs = base + t.to(tl.int64)[:, None] * C + ch[None, :]
        acc += tl.load(X + offs, mask=mask, other=0.0).to(tl.float32)
    colsum = tl.sum(acc, axis=0)
    mean = tl.sum(tl.where(same, colsum[None, :], 0.0), axis=1) / n

    acc = tl.zeros((BLOCK_T, GB * CG_P), dtype=tl.float32)
    for t0 in range(0, t_stat, BLOCK_T):
        t = t0 + tl.arange(0, BLOCK_T)
        mask = (t < t_stat)[:, None] & cmask[None, :]
        offs = base + t.to(tl.int64)[:, None] * C + ch[None, :]
        x = tl.load(X + offs, mask=mask, other=0.0).to(tl.float32)
        d = tl.where(mask, x - mean[None, :], 0.0)
        acc += d * d
    colsq = tl.sum(acc, axis=0)
    var = tl.sum(tl.where(same, colsq[None, :], 0.0), axis=1) / n
    rstd = 1.0 / tl.sqrt(var + eps)

    w = tl.load(W + ch, mask=cmask, other=0.0)
    b = tl.load(B + ch, mask=cmask, other=0.0)
    for t0 in range(0, T, BLOCK_T):
        t = t0 + tl.arange(0, BLOCK_T)
        mask = (t < T)[:, None] & cmask[None, :]
        offs = base + t.to(tl.int64)[:, None] * C + ch[None, :]
        x = tl.load(X + offs, mask=mask, other=0.0).to(tl.float32)
        y = (x - mean[None, :]) * rstd[None, :] * w[None, :] + b[None, :]
        if SILU:
            y = y / (1.0 + tl.exp(-y))
        tl.store(Y + offs, y.to(Y.dtype.element_ty), mask=mask)


@functools.cache
def _kernels():
    global tl
    # Triton's compile cache goes beside the nvcc build, inside the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_ROOT / "triton"))
    import triton
    import triton.language

    tl = triton.language
    return triton.jit(_layer_norm_fwd), triton.jit(_group_norm_fwd)


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, name: str) -> int:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: needs a CUDA tensor, got device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported (float32, bfloat16)")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    c = x.shape[-1]
    for p in (weight, bias):
        if p.shape != (c,) or p.dtype != torch.float32 or p.device != x.device or not p.is_contiguous():
            raise ValueError(f"{name}: weight/bias must be contiguous float32 ({c},) on {x.device}")
    return c


def layer_norm_kernel(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """Triton LayerNorm over the last axis of a contiguous CUDA tensor."""
    c = _check(x, weight, bias, "layer_norm_kernel")
    ln, _ = _kernels()
    y = torch.empty_like(x)
    n_rows = x.numel() // c
    block_c = _next_pow2(c)
    block_r = max(1, 4096 // block_c)
    grid = (-(-n_rows // block_r),)
    # Triton's launcher raises on a failed cuLaunchKernel.
    ln[grid](x, weight, bias, y, n_rows, eps, C=c, BLOCK_R=block_r, BLOCK_C=block_c, num_warps=4)
    layer_norm_kernel.launches += 1
    return y


layer_norm_kernel.launches = 0


def _launch_group_norm(x, num_groups, weight, bias, lengths, eps, act, name):
    c = _check(x, weight, bias, name)
    if x.ndim != 3 or c % num_groups or x.shape[1] == 0:
        raise ValueError(f"{name}: needs (B, T>0, C) with C % G == 0, got {tuple(x.shape)}, G={num_groups}")
    if act not in ("none", "silu"):
        raise ValueError(f"{name}: act {act!r} not supported")
    _, gn = _kernels()
    b, t, _ = x.shape
    cg = c // num_groups
    cg_p = _next_pow2(cg)
    gb = max(1, 32 // cg_p)  # groups per program: lanes span >= 32 channels
    n_gblocks = -(-num_groups // gb)
    block_t = max(1, 4096 // (gb * cg_p))
    y = torch.empty_like(x)
    # unmasked: L is never read (MASKED is a compile-time False)
    gn[(b * n_gblocks,)](
        x, weight, bias, y, x if lengths is None else lengths, t, c, num_groups, cg, n_gblocks, eps,
        SILU=act == "silu", MASKED=lengths is not None, GB=gb, CG_P=cg_p, BLOCK_T=block_t, num_warps=4,
    )
    return y


def group_norm_kernel(
    x: torch.Tensor,
    num_groups: int,
    weight: torch.Tensor,
    bias: torch.Tensor,
    eps: float = 1e-5,
    act: str = "none",
) -> torch.Tensor:
    """Triton GroupNorm(+SiLU) over a contiguous (B, T, C) CUDA tensor."""
    y = _launch_group_norm(x, num_groups, weight, bias, None, eps, act, "group_norm_kernel")
    group_norm_kernel.launches += 1
    return y


group_norm_kernel.launches = 0


def group_norm_masked_kernel(
    x: torch.Tensor,
    num_groups: int,
    weight: torch.Tensor,
    bias: torch.Tensor,
    lengths: torch.Tensor,
    eps: float = 1e-5,
    act: str = "none",
) -> torch.Tensor:
    """Triton masked GroupNorm(+SiLU) over a contiguous (B, T, C) CUDA
    tensor; ``lengths`` a contiguous (B,) int32 tensor on the same device
    (statistics over frames t < lengths[b], count clamped to ≥ 1)."""
    name = "group_norm_masked_kernel"
    _check(x, weight, bias, name)
    if (lengths.dtype != torch.int32 or lengths.ndim != 1 or lengths.shape[0] != x.shape[0]
            or lengths.device != x.device or not lengths.is_contiguous()):
        raise ValueError(f"{name}: lengths must be a contiguous ({x.shape[0]},) int32 tensor on {x.device}, "
                         f"got {lengths.dtype} {tuple(lengths.shape)} on {lengths.device}")
    y = _launch_group_norm(x, num_groups, weight, bias, lengths, eps, act, name)
    group_norm_masked_kernel.launches += 1
    return y


group_norm_masked_kernel.launches = 0
