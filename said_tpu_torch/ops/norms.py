"""LayerNorm and GroupNorm32(+SiLU), plain and masked, with f32
statistics: routers, plain twins, and the kernels for Hopper.

Ports ``said_tpu.ops.norms`` (routers ``layer_norm_f32`` :118,
``group_norm`` :69 and ``group_norm_masked`` :173) and replaces its
Pallas kernels:

- ``layer_norm_kernel`` replaces ``layer_norm_pallas``
  (said_tpu/ops/pallas_norms.py:441, K7): the CUDA C++ kernel
  ``csrc/layer_norm.cu`` (its source note says how), a group of lanes a
  row holding the row in registers, shuffles within the group; the host
  picks lanes a row and rows a block from the shape
  (``layer_norm_plan``), and ``layer_norm_lanes_plain`` is the plain twin
  of its reduction order.
- ``group_norm_kernel`` replaces ``group_norm_pallas`` (:79, K3) and its
  two-phase form ``group_norm_pallas_blocked`` (:249, K5).
- ``group_norm_masked_kernel`` replaces ``group_norm_masked_pallas``
  (:133, K4) and ``group_norm_masked_pallas_blocked`` (:338, K6): the
  same kernels with a per-row length, so the statistics stop at the
  row's real length while every frame is normalised (padded rows hold
  the finite values the JAX version gives them). Every caller builds its
  frame mask as ``arange(T) < len``, so a (B,) length is the same
  function as K4's (B, T) mask on every input the system makes.

What bounds them on the card: device-memory bandwidth (about 10 flops
per element). The UNet's (2, 600, 192) tensor is 0.9 MB in f32, so at
the main path's short sizes launch latency dominates; the encoder's
(1, 32k, 512) conv_0 output is 64 MB and a bucketed 60-s clip's
(1, 204799, 512) is 420 MB, where only the bytes count.

LayerNorm's and GroupNorm's variance is always a two-pass Σ(x−mean)² about
a mean, never E[x²]−mean². The host picks one of two routes from the
shape alone (``group_norm_plan``):

- one launch of the CUDA C++ kernel ``csrc/group_norm.cu`` (its source
  note says how), for rows up to ``_SPLIT_MIN_T`` frames whose slice
  fits a cluster's shared memory: a thread-block cluster per (batch,
  block of groups), its CTAs splitting T, each reading its frames into
  shared memory once; per-group sums, then centred squares, are joined
  across the cluster through distributed shared memory in rank order, and
  y is written from shared memory. x is read once and y written once.
  The plan's groups a block and cluster size put 64 CTAs on the card
  at the UNet's batch of 2, in clusters of 4 (f32) or 8 (bf16), and
  clusters of 1 where the batch alone fills it;
  ``group_norm_cluster_plain`` is the plain twin of its arithmetic.
- split, for longer rows (the UNet at 6 min, the encoder's conv_0),
  two Triton launches: T is cut into chunks so that about 1024 programs
  run (B × group blocks × chunks). Stage 1 reads each chunk once and
  writes its count, sum and M2 about its own mean per group to a small
  f32 scratch (each 128-frame tile is two-pass in registers, tiles
  Chan-combined in order; with lengths the count stops at the row's real
  length, and a chunk wholly past it has count 0). Stage 2 combines the
  partials of its (batch, group block) in a fixed order with Chan's
  formula, as K5/K6 do (``_group_stats_combine``), then normalises its own
  chunk of every frame, padded frames included. x is read twice and y
  written once. ``group_norm_chunked_plain`` is the plain twin of this
  arithmetic.

Neither route uses atomics: the result is the same bits on every call.

Gradients: where an input needs one, a router runs as a
``torch.autograd.Function`` whose forward is the same route and whose
backward is the closed form in PyTorch (``layer_norm_backward``,
``group_norm_backward``; f32 statistics, the vector-Jacobian products the
JAX package takes of its jnp twins), from the saved inputs alone.
Routers: a CPU tensor runs the plain twin; any other tensor goes to the
kernel, whose wrapper raises unless it is a contiguous CUDA tensor of a
supported dtype. Triton is imported (for the GroupNorm split), and the
CUDA library built, on the first launch only, so this module imports
where neither is present. (No
``from __future__ import annotations`` here: Triton reads the kernels'
annotations as written.)
"""

import functools
import os
from typing import NamedTuple

import torch

from said_tpu_torch import _build
from said_tpu_torch.ops import needs_grad

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


def layer_norm_lanes_plain(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """The LayerNorm kernel's arithmetic in plain PyTorch, for the tests
    (no path runs it), in the order of ``layer_norm_plan(rows, C,
    x.dtype)``: element i of a row belongs to lane (i // v) % lanes (v
    elements a 16-byte vector on the vector route, 1 on the scalar one);
    each lane adds its elements in increasing i, then the lanes' sums are
    joined by an xor butterfly (offsets 1, 2, 4, …). The mean is that sum
    over C; the variance the same reduction of (x − mean)², over C."""
    c = x.shape[-1]
    xf = x.float().reshape(-1, c)
    rows = xf.shape[0]
    plan = layer_norm_plan(max(rows, 1), c, x.dtype)
    v = 16 // (torch.finfo(x.dtype).bits // 8) if plan.route == "vector" else 1
    i = torch.arange(c)
    lane = (i // v) % plan.lanes
    slot = (i // (v * plan.lanes)) * v + i % v
    swap = [torch.arange(plan.lanes) ^ o for o in (1 << k for k in range(plan.lanes.bit_length() - 1))]

    def lane_sum(a):  # (rows, c) -> (rows,)
        grid = a.new_zeros((rows, plan.lanes, plan.chunks * v))
        grid[:, lane, slot] = a
        s = grid[:, :, 0]
        for p in range(1, grid.shape[2]):
            s = s + grid[:, :, p]
        for perm in swap:
            s = s + s[:, perm]
        return s[:, 0]

    mean = lane_sum(xf) / c
    d = xf - mean[:, None]
    rstd = 1.0 / torch.sqrt(lane_sum(d * d) / c + eps)
    out = d * rstd[:, None] * weight.float() + bias.float()
    return out.reshape(x.shape).to(x.dtype)


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


def group_norm_chunked_plain(
    x: torch.Tensor,
    num_groups: int,
    weight: torch.Tensor,
    bias: torch.Tensor,
    eps: float = 1e-5,
    act: str = "none",
    lengths: torch.Tensor | None = None,
    chunk_t: int = 128,
) -> torch.Tensor:
    """The split GroupNorm kernel's arithmetic in plain PyTorch, for the
    tests (no path runs it). T is cut into chunks of ``chunk_t`` frames;
    per (batch, chunk, group): the count of real elements (frames
    ``t < lengths[b]``, all frames without lengths), their sum and their M2
    about the chunk's own mean, two-pass. Then the chunks are combined in
    one fixed order with Chan's formula: n = Σ n_k, mean = Σ s_k / n,
    M2 = Σ (M2_k + n_k·(s_k / n_k − mean)²), every divisor clamped to ≥ 1.
    Every frame, padded ones included, is normalised with the result."""
    b, t, c = x.shape
    g = num_groups
    n_chunks = -(-t // chunk_t)
    pad = n_chunks * chunk_t - t
    real = torch.ones((b, t), device=x.device)
    if lengths is not None:
        lens = lengths.to(device=x.device, dtype=torch.int64)
        real = (torch.arange(t, device=x.device)[None, :] < lens[:, None]).float()
    xf = x.float().reshape(b, t, g, c // g)
    xk = torch.nn.functional.pad(xf, (0, 0, 0, 0, 0, pad)).reshape(b, n_chunks, chunk_t, g, c // g)
    mk = torch.nn.functional.pad(real, (0, pad)).reshape(b, n_chunks, chunk_t, 1, 1)
    cnt_k = mk.sum(dim=(2, 4)) * (c // g)  # (b, K, 1)
    sum_k = (xk * mk).sum(dim=(2, 4))  # (b, K, g)
    mean_k = sum_k / cnt_k.clamp(min=1.0)
    m2_k = (((xk - mean_k[:, :, None, :, None]) * mk) ** 2).sum(dim=(2, 4))
    n = cnt_k.sum(dim=1)  # (b, 1)
    mean = sum_k.sum(dim=1) / n.clamp(min=1.0)  # (b, g)
    shift = mean_k - mean[:, None]
    var = (m2_k + cnt_k * shift * shift).sum(dim=1) / n.clamp(min=1.0)
    out = ((xf - mean[:, None, :, None]) / torch.sqrt(var + eps)[:, None, :, None]).reshape(b, t, c)
    out = out * weight.float() + bias.float()
    if act == "silu":
        out = out * torch.sigmoid(out)
    return out.to(x.dtype)


def group_norm_cluster_plain(
    x: torch.Tensor,
    num_groups: int,
    weight: torch.Tensor,
    bias: torch.Tensor,
    eps: float = 1e-5,
    act: str = "none",
    lengths: torch.Tensor | None = None,
    cluster: int = 8,
) -> torch.Tensor:
    """The one-launch GroupNorm kernel's arithmetic in plain PyTorch, for
    the tests (no path runs it). T is cut into ``cluster`` slices of
    ceil(T / cluster) frames, one a CTA (the last ones short or empty).
    Per (batch, slice, group): the sum of the real elements (frames
    ``t < lengths[b]``, all frames without lengths); the slices' sums are
    added in rank order and divided by n = max(len·C/G, 1): the mean. Then
    each slice's Σ(x − mean)² over its real elements, added in rank order
    and divided by n: the variance. Every frame, padded ones included, is
    normalised with them."""
    b, t, c = x.shape
    g = num_groups
    frames = -(-t // cluster)
    pad = frames * cluster - t
    real = torch.ones((b, t), device=x.device)
    if lengths is not None:
        lens = lengths.to(device=x.device, dtype=torch.int64)
        real = (torch.arange(t, device=x.device)[None, :] < lens[:, None]).float()
    n = (real.sum(dim=1) * (c // g)).clamp(min=1.0)[:, None]  # (b, 1)
    xf = x.float().reshape(b, t, g, c // g)
    xk = torch.nn.functional.pad(xf, (0, 0, 0, 0, 0, pad)).reshape(b, cluster, frames, g, c // g)
    mk = torch.nn.functional.pad(real, (0, pad)).reshape(b, cluster, frames, 1, 1)

    def join(per_rank):  # (b, cluster, g), added in rank order
        total = per_rank[:, 0]
        for q in range(1, cluster):
            total = total + per_rank[:, q]
        return total

    mean = join((xk * mk).sum(dim=(2, 4))) / n  # (b, g)
    var = join((((xk - mean[:, None, None, :, None]) * mk) ** 2).sum(dim=(2, 4))) / n
    out = ((xf - mean[:, None, :, None]) / torch.sqrt(var + eps)[:, None, :, None]).reshape(b, t, c)
    out = out * weight.float() + bias.float()
    if act == "silu":
        out = out * torch.sigmoid(out)
    return out.to(x.dtype)


# ------------------------------------------------------------- backwards


def layer_norm_backward(
    x: torch.Tensor, weight: torch.Tensor, eps: float, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dweight, dbias) of ``layer_norm_plain`` at x for the output
    gradient g, in closed form with f32 statistics: the vector-Jacobian
    product the JAX package takes of ``_layer_norm_jnp``
    (said_tpu/ops/norms.py:138-146). With x̂ = (x − mean)·rstd and
    d = g·w: dx = rstd · (d − mean(d) − x̂ · mean(d·x̂)) over the row."""
    c = x.shape[-1]
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(xf.var(dim=-1, keepdim=True, correction=0) + eps)
    xhat = (xf - mean) * rstd
    gf = g.float()
    d = gf * weight.float()
    dx = rstd * (d - d.mean(dim=-1, keepdim=True) - xhat * (d * xhat).mean(dim=-1, keepdim=True))
    rows = gf.reshape(-1, c)
    return dx.to(x.dtype), (rows * xhat.reshape(-1, c)).sum(0), rows.sum(0)


def group_norm_backward(
    x: torch.Tensor,
    num_groups: int,
    weight: torch.Tensor,
    bias: torch.Tensor,
    lengths: torch.Tensor | None,
    eps: float,
    act: str,
    g: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dweight, dbias) of ``group_norm_plain`` (``lengths`` None) or
    ``group_norm_masked_plain`` at x for the output gradient g, in closed
    form with f32 statistics: the vector-Jacobian product the JAX package
    takes of ``_group_norm_jnp`` / ``_group_norm_masked_jnp``
    (said_tpu/ops/norms.py:105-111, 211-224).

    Per (batch, group), with n the count of real elements (m_t = 1 for
    a real frame), x̂ = (x − mean)·rstd over every frame and d = ∂L/∂x̂:
    dx_t = rstd · (d_t − m_t/n · (Σ d + x̂_t · Σ d·x̂)), the sums over every
    frame (a padded frame's output is normalised with the real frames'
    statistics, so its gradient reaches them too). SiLU first scales g
    by its derivative at the norm's output."""
    b, t, c = x.shape
    cg = c // num_groups
    xf = x.float().reshape(b, t, num_groups, cg)
    if lengths is None:
        m = None
        n = float(t * cg)
        mean = xf.mean(dim=(1, 3), keepdim=True)
        var = xf.var(dim=(1, 3), keepdim=True, correction=0)
    else:
        lens = lengths.to(device=x.device, dtype=torch.int64)
        m = (torch.arange(t, device=x.device)[None, :] < lens[:, None]).float()[:, :, None, None]
        n = (m.sum(dim=1, keepdim=True) * cg).clamp(min=1.0)
        mean = (xf * m).sum(dim=(1, 3), keepdim=True) / n
        var = (((xf - mean) * m) ** 2).sum(dim=(1, 3), keepdim=True) / n
    rstd = torch.rsqrt(var + eps)
    xhat = (xf - mean) * rstd
    wf = weight.float().reshape(num_groups, cg)
    gf = g.float().reshape(b, t, num_groups, cg)
    if act == "silu":
        y = xhat * wf + bias.float().reshape(num_groups, cg)
        s = torch.sigmoid(y)
        gf = gf * (s * (1.0 + y * (1.0 - s)))
    d = gf * wf
    s1 = d.sum(dim=(1, 3), keepdim=True)
    s2 = (d * xhat).sum(dim=(1, 3), keepdim=True)
    corr = (s1 + xhat * s2) / n
    dx = rstd * (d - (corr if m is None else m * corr))
    dw = (gf * xhat).sum(dim=(0, 1)).reshape(c)
    db = gf.sum(dim=(0, 1)).reshape(c)
    return dx.reshape(b, t, c).to(x.dtype), dw, db


class _LayerNormFn(torch.autograd.Function):
    """LayerNorm with a gradient: the router's forward, the closed-form
    ``layer_norm_backward``; saves x, weight and bias only."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, weight, bias)
        return _layer_norm_route(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight, _ = ctx.saved_tensors
        dx, dw, db = layer_norm_backward(x, weight, ctx.eps, g)
        return dx, dw.to(weight.dtype), db.to(weight.dtype), None


class _GroupNormFn(torch.autograd.Function):
    """GroupNorm (plain or masked) with a gradient: the router's forward,
    the closed-form ``group_norm_backward``; saves x, weight, bias and the
    lengths only."""

    @staticmethod
    def forward(ctx, x, num_groups, weight, bias, lengths, eps, act):
        ctx.args = (num_groups, eps, act)
        ctx.save_for_backward(x, weight, bias, lengths)
        if lengths is None:
            return _group_norm_route(x, num_groups, weight, bias, eps, act)
        return _group_norm_masked_route(x, num_groups, weight, bias, lengths, eps, act)

    @staticmethod
    def backward(ctx, g):
        x, weight, bias, lengths = ctx.saved_tensors
        num_groups, eps, act = ctx.args
        dx, dw, db = group_norm_backward(x, num_groups, weight, bias, lengths, eps, act, g)
        return dx, None, dw.to(weight.dtype), db.to(bias.dtype), None, None, None


# --------------------------------------------------------------- routers


def _layer_norm_route(x, weight, bias, eps):
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps)
    return layer_norm_kernel(x, weight, bias, eps)


def _group_norm_route(x, num_groups, weight, bias, eps, act):
    if x.device.type == "cpu":
        return group_norm_plain(x, num_groups, weight, bias, eps, act)
    return group_norm_kernel(x, num_groups, weight, bias, eps, act)


def _group_norm_masked_route(x, num_groups, weight, bias, lengths, eps, act):
    if x.device.type == "cpu":
        return group_norm_masked_plain(x, num_groups, weight, bias, lengths, eps, act)
    return group_norm_masked_kernel(x, num_groups, weight, bias, lengths, eps, act)


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """LayerNorm router: plain twin on the CPU, the CUDA kernel otherwise;
    differentiable (``layer_norm_backward``) where an input needs it."""
    if needs_grad(x, weight, bias):
        return _LayerNormFn.apply(x, weight, bias, eps)
    return _layer_norm_route(x, weight, bias, eps)


def group_norm(
    x: torch.Tensor,
    num_groups: int,
    weight: torch.Tensor,
    bias: torch.Tensor,
    eps: float = 1e-5,
    act: str = "none",
) -> torch.Tensor:
    """GroupNorm(+SiLU) router: plain twin on the CPU, the kernels
    otherwise; differentiable (``group_norm_backward``) where an input
    needs it."""
    if needs_grad(x, weight, bias):
        return _GroupNormFn.apply(x, num_groups, weight, bias, None, eps, act)
    return _group_norm_route(x, num_groups, weight, bias, eps, act)


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
    the CPU, the kernels otherwise; differentiable where an input needs
    it."""
    if needs_grad(x, weight, bias):
        return _GroupNormFn.apply(x, num_groups, weight, bias, lengths, eps, act)
    return _group_norm_masked_route(x, num_groups, weight, bias, lengths, eps, act)


# ------------------------------------------------------- Triton kernels


def _group_norm_stats(
    X, L, P, T, C, G, cg, n_gblocks, n_chunks, chunk_t, plane,
    MASKED: "tl.constexpr", GB: "tl.constexpr", CG_P: "tl.constexpr", BLOCK_T: "tl.constexpr",
):
    # stage 1 of the split plan: one program per (chunk, batch · group block)
    chunk = tl.program_id(0)
    pid = tl.program_id(1)
    batch = pid // n_gblocks
    g0 = (pid % n_gblocks) * GB
    j = tl.arange(0, GB * CG_P)
    gi = j // CG_P
    ci = j % CG_P
    cmask = (ci < cg) & (g0 + gi < G)
    ch = (g0 + gi) * cg + ci
    same = (gi[:, None] == gi[None, :]) & cmask[None, :]
    base = batch.to(tl.int64) * T * C
    t_end = T
    if MASKED:
        t_end = tl.maximum(tl.minimum(tl.load(L + batch), T), 0)
    t_lo = chunk * chunk_t
    t_hi = tl.minimum(t_lo + chunk_t, t_end)

    # count, mean and M2 of the chunk so far; each tile is two-pass in
    # registers and joins them by Chan's update
    cnt = tl.zeros((GB * CG_P,), dtype=tl.float32)
    mean = tl.zeros((GB * CG_P,), dtype=tl.float32)
    m2 = tl.zeros((GB * CG_P,), dtype=tl.float32)
    for t0 in range(t_lo, t_hi, BLOCK_T):
        t = t0 + tl.arange(0, BLOCK_T)
        mask = (t < t_hi)[:, None] & cmask[None, :]
        offs = base + t.to(tl.int64)[:, None] * C + ch[None, :]
        x = tl.load(X + offs, mask=mask, other=0.0).to(tl.float32)
        nb = (tl.minimum(t_hi - t0, BLOCK_T) * cg).to(tl.float32)
        mean_b = tl.sum(tl.where(same, tl.sum(x, axis=0)[None, :], 0.0), axis=1) / nb
        d = tl.where(mask, x - mean_b[None, :], 0.0)
        m2_b = tl.sum(tl.where(same, tl.sum(d * d, axis=0)[None, :], 0.0), axis=1)
        n_new = cnt + nb
        delta = mean_b - mean
        mean += delta * (nb / n_new)
        m2 += m2_b + delta * delta * (cnt * nb / n_new)
        cnt = n_new

    # partials (3, B, G, n_chunks): count, sum, M2, one lane per group
    out = (batch * G + g0 + gi) * n_chunks + chunk
    smask = cmask & (ci == 0)
    tl.store(P + out, cnt, mask=smask)
    tl.store(P + plane + out, cnt * mean, mask=smask)
    tl.store(P + 2 * plane + out, m2, mask=smask)


def _group_norm_apply(
    X, W, B, Y, P, T, C, G, cg, n_gblocks, n_chunks, chunk_t, plane, eps,
    SILU: "tl.constexpr", GB: "tl.constexpr", CG_P: "tl.constexpr", BLOCK_T: "tl.constexpr",
    NCH_P: "tl.constexpr",
):
    # stage 2 of the split plan: combine every chunk's partials, normalise this chunk
    chunk = tl.program_id(0)
    pid = tl.program_id(1)
    batch = pid // n_gblocks
    g0 = (pid % n_gblocks) * GB
    j = tl.arange(0, GB * CG_P)
    gi = j // CG_P
    ci = j % CG_P
    cmask = (ci < cg) & (g0 + gi < G)
    ch = (g0 + gi) * cg + ci
    base = batch.to(tl.int64) * T * C

    k = tl.arange(0, NCH_P)
    pofs = (batch * G + g0 + gi)[None, :] * n_chunks + k[:, None]
    pmask = (k < n_chunks)[:, None] & cmask[None, :]
    cnt_k = tl.load(P + pofs, mask=pmask, other=0.0)
    sum_k = tl.load(P + plane + pofs, mask=pmask, other=0.0)
    m2_k = tl.load(P + 2 * plane + pofs, mask=pmask, other=0.0)
    n = tl.maximum(tl.sum(cnt_k, axis=0), 1.0)
    mean = tl.sum(sum_k, axis=0) / n
    shift = sum_k / tl.maximum(cnt_k, 1.0) - mean[None, :]
    var = tl.sum(m2_k + cnt_k * shift * shift, axis=0) / n
    rstd = 1.0 / tl.sqrt(var + eps)

    w = tl.load(W + ch, mask=cmask, other=0.0)
    b = tl.load(B + ch, mask=cmask, other=0.0)
    t_lo = chunk * chunk_t
    t_hi = tl.minimum(t_lo + chunk_t, T)
    for t0 in range(t_lo, t_hi, BLOCK_T):
        t = t0 + tl.arange(0, BLOCK_T)
        mask = (t < t_hi)[:, None] & cmask[None, :]
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
    os.environ.setdefault("TRITON_CACHE_DIR", str(_build.BUILD_ROOT / "triton"))
    import triton
    import triton.language

    tl = triton.language
    return triton.jit(_group_norm_stats), triton.jit(_group_norm_apply)


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


# GroupNorm plans. Rows up to _SPLIT_MIN_T frames run the one-launch CUDA
# kernel where a cluster's shared memory holds the slice; longer rows are
# split, cut so that about _TARGET_PROGRAMS programs run (8 per SM of an
# H100's 132), at most _MAX_CHUNKS chunks per row. The threshold, from
# H100 runs (PERF.md §6): up to 4096 frames the step's GroupNorm device
# time is within 3–11% of the split's at the UNet's batch of 2 (the split
# ahead) and 23% below it at the eval batch, and one launch saves a launch
# a call on steps that wait on the host; at 21600 frames one launch was
# not faster in the 6-min step in both dtypes.
_SPLIT_MIN_T = 4096
_TARGET_PROGRAMS = 1024
_MAX_CHUNKS = 128
# The one-launch kernel (csrc/group_norm.cu: kGnThreads, kGnSmemLimit): its
# threads a CTA, the shared memory a CTA may opt in to on sm_90, the
# cluster sizes it takes (16 is past the portable 8), blocks of at most
# _MAX_BLOCK_CHANNELS channels.
_GN_THREADS = 256
_SMEM_LIMIT = 232448
_CLUSTERS = (1, 2, 4, 8, 16)
_MAX_BLOCK_CHANNELS = 64
# The plan's constants, read from the per-plan times of chip_smoke.py
# phase 2 on an H100 (PERF.md §6): without clusters, channel runs of at
# least _FILL_RUN_BYTES and blocks enough for _FILL_CTAS CTAs; with
# clusters, runs of at least _CLUSTER_RUN_BYTES and _CLUSTER_CTAS CTAs (a
# cluster's barriers cost more than spreading further saves).
_FILL_CTAS = 128
_FILL_RUN_BYTES = 48
_CLUSTER_CTAS = 64
_CLUSTER_RUN_BYTES = 96


class GroupNormPlan(NamedTuple):
    """How a GroupNorm call runs, from its shape alone.

    ``route`` "cuda": one launch of ``csrc/group_norm.cu``, ``groups``
    groups a block, clusters of ``cluster`` CTAs, ``frames`` (ceil(T /
    cluster)) frames a CTA, ``chunks`` 1. ``route`` "triton": the split,
    ``groups`` groups a program, ``chunks`` chunks of ``frames`` frames a
    row (whole 128-frame tiles; one chunk where the batch alone fills the
    card), ``cluster`` 1.
    """

    route: str
    groups: int
    cluster: int
    frames: int
    chunks: int


@functools.cache
def _group_geometry(c: int, num_groups: int) -> tuple[int, int, int, int, int]:
    """The split's (channels per group, its power of two, groups per
    program, group blocks, frames per tile): lanes span >= 32 channels,
    tiles 4096 lanes."""
    cg = c // num_groups
    cg_p = _next_pow2(cg)
    gb = max(1, 32 // cg_p)
    return cg, cg_p, gb, -(-num_groups // gb), max(1, 4096 // (gb * cg_p))


def cta_smem_bytes(frames: int, channels: int, groups: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one CTA of the one-launch kernel: its
    frames of the block in x's dtype, the threads' partial sums (one
    16-byte chunk of f32 a thread and element), per-group sums and
    statistics (``group_norm_smem`` in the source)."""
    esize = torch.finfo(dtype).bits // 8
    return frames * channels * esize + _GN_THREADS * (16 // esize) * 4 + 16 * groups


@functools.cache
def cluster_plans(t: int, c: int, num_groups: int, dtype: torch.dtype) -> tuple[tuple[int, int], ...]:
    """Every (groups a block, cluster size) the one-launch kernel takes at
    T frames: groups a block a power of two dividing G whose channels are
    whole 16-byte chunks (so every load and store is 16 bytes and aligned)
    and at most _MAX_BLOCK_CHANNELS, and a cluster whose CTAs' slices fit
    their shared memory."""
    esize = torch.finfo(dtype).bits // 8
    cg = c // num_groups
    plans = []
    gb = 1
    while gb <= num_groups:
        w = gb * cg
        if num_groups % gb == 0 and (w * esize) % 16 == 0 and w <= _MAX_BLOCK_CHANNELS:
            plans += [(gb, cl) for cl in _CLUSTERS if cta_smem_bytes(-(-t // cl), w, gb, dtype) <= _SMEM_LIMIT]
        gb *= 2
    return tuple(plans)


@functools.cache  # on the host path of every call; a few shapes per process
def group_norm_plan(b: int, t: int, c: int, num_groups: int, dtype: torch.dtype = torch.float32) -> GroupNormPlan:
    """The plan of a (b, t, c) GroupNorm with ``num_groups`` groups in
    ``dtype``. One launch up to _SPLIT_MIN_T frames where the kernel takes
    the shape: clusters of 1 and the widest blocks with channel runs of at
    least _FILL_RUN_BYTES whose count alone puts _FILL_CTAS CTAs on the
    card, where the batch allows; else the fewest groups a block whose
    channel run is at least _CLUSTER_RUN_BYTES, and the smallest cluster
    that fits and makes _CLUSTER_CTAS CTAs (else the largest that fits).
    Otherwise the split."""
    plans = cluster_plans(t, c, num_groups, dtype) if t <= _SPLIT_MIN_T else ()
    if not plans:
        return split_plan(b, t, c, num_groups)
    run = (c // num_groups) * torch.finfo(dtype).bits // 8  # bytes of one group's channels
    unclustered = [gb for gb, cl in plans
                   if cl == 1 and gb * run >= _FILL_RUN_BYTES and b * (num_groups // gb) >= _FILL_CTAS]
    if unclustered:
        return GroupNormPlan("cuda", max(unclustered), 1, t, 1)
    widths = sorted({gb for gb, _ in plans})
    gb = next((g for g in widths if g * run >= _CLUSTER_RUN_BYTES), widths[-1])
    fits = [cl for g, cl in plans if g == gb]
    cl = next((cl for cl in fits if b * (num_groups // gb) * cl >= _CLUSTER_CTAS), fits[-1])
    return GroupNormPlan("cuda", gb, cl, -(-t // cl), 1)


@functools.cache
def split_plan(b: int, t: int, c: int, num_groups: int) -> GroupNormPlan:
    """The split's plan: chunks of whole tiles, enough for about
    _TARGET_PROGRAMS programs and at most _MAX_CHUNKS (one where the batch
    alone fills the card)."""
    *_, gb, n_gblocks, block_t = _group_geometry(c, num_groups)
    want = max(1, min(_MAX_CHUNKS, -(-_TARGET_PROGRAMS // (b * n_gblocks))))
    per_chunk = -(-t // want)
    chunk_t = -(-per_chunk // block_t) * block_t
    return GroupNormPlan("triton", gb, 1, chunk_t, -(-t // chunk_t))


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


# LayerNorm plans (csrc/layer_norm.cu): at most _LN_THREADS threads a
# block; rows a block halved until the launch has _LN_TARGET_BLOCKS blocks
# (two per SM of an H100's 132) where the rows allow it; a lane holds at
# most _LN_MAX_CHUNKS 16-byte vectors of its row, and aims at
# _LN_CHUNKS_AIM (fewer lanes a row, more rows in flight a warp). From
# the per-plan times of chip_smoke.py phase 2 on an NVIDIA H100 80GB HBM3
# at 700 W (PERF.md §6):
# blocks of 128 threads were as fast as 256 at every main-path shape in
# f32 and up to 8% faster in bf16; 32 lanes a row at C = 192 were slower.
_LN_THREADS = 128
_LN_MAX_THREADS = 256  # the kernel's bound (kLnMaxThreads), for forced plans
_LN_TARGET_BLOCKS = 2 * 132
_LN_MAX_CHUNKS = 8
_LN_CHUNKS_AIM = 4


class LayerNormPlan(NamedTuple):
    """How a LayerNorm call runs, from its shape alone. ``route``
    "vector": a lane holds ``chunks`` 16-byte vectors of its row (C·size a
    multiple of 16 bytes); "scalar": ``chunks`` single elements. ``lanes``
    lanes a row (a power of two, at most 32), ``rows`` rows a block,
    ``blocks`` in the launch."""

    route: str
    lanes: int
    chunks: int
    rows: int
    blocks: int


def _ln_units(c: int, dtype: torch.dtype) -> tuple[str, int]:
    """The route a row of C channels takes by its bytes, and its units:
    16-byte vectors (vector route) or elements (scalar route)."""
    esize = torch.finfo(dtype).bits // 8
    return ("vector", c * esize // 16) if (c * esize) % 16 == 0 else ("scalar", c)


def layer_norm_forced_plan(rows: int, c: int, dtype: torch.dtype, lanes: int, per_block: int) -> LayerNormPlan:
    """The plan with ``lanes`` lanes a row and ``per_block`` rows a block,
    for tests and timing; raises where the kernel does not take it."""
    route, units = _ln_units(c, dtype)
    chunks = -(-units // lanes)
    threads = lanes * per_block
    if (lanes not in (1, 2, 4, 8, 16, 32) or threads % 32 or not 32 <= threads <= _LN_MAX_THREADS
            or (route == "vector" and chunks > _LN_MAX_CHUNKS)):
        raise ValueError(f"layer_norm_kernel: plan ({lanes} lanes, {per_block} rows a block) not taken at C={c} {dtype}")
    return LayerNormPlan(route, lanes, chunks, per_block, -(-rows // per_block))


@functools.cache  # on the host path of every call; a few shapes per process
def layer_norm_plan(rows: int, c: int, dtype: torch.dtype = torch.float32) -> LayerNormPlan:
    """The plan of a LayerNorm over ``rows`` rows of ``c`` channels in
    ``dtype``: the fewest lanes a row (a power of two) whose share is at
    most _LN_CHUNKS_AIM vectors (32 lanes past that), the scalar route
    where the row is no whole number of vectors or a lane would hold more
    than _LN_MAX_CHUNKS; then the most rows a block (up to _LN_THREADS
    threads, at least a warp) that still makes _LN_TARGET_BLOCKS blocks."""
    route, units = _ln_units(c, dtype)
    lanes = min(32, _next_pow2(-(-units // _LN_CHUNKS_AIM)))
    if route == "vector" and -(-units // lanes) > _LN_MAX_CHUNKS:
        route, units = "scalar", c
        lanes = min(32, _next_pow2(-(-units // _LN_CHUNKS_AIM)))
    per_block, least = _LN_THREADS // lanes, max(1, 32 // lanes)
    while per_block > least and -(-rows // per_block) < _LN_TARGET_BLOCKS:
        per_block //= 2
    return LayerNormPlan(route, lanes, -(-units // lanes), per_block, -(-rows // per_block))


def layer_norm_kernel(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5,
    *, _plan: tuple[int, int] | None = None,
) -> torch.Tensor:
    """LayerNorm over the last axis of a contiguous CUDA tensor: one launch
    of ``csrc/layer_norm.cu`` by ``layer_norm_plan``. ``_plan`` (lanes a
    row, rows a block) forces another, for tests and timing only."""
    name = "layer_norm_kernel"
    c = _check(x, weight, bias, name)
    if c == 0:
        raise ValueError(f"{name}: needs C >= 1, got {tuple(x.shape)}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: input is on {x.device}, not the current device")
    y = torch.empty_like(x)
    rows = x.numel() // c
    if rows == 0:
        return y
    if _plan is None:
        plan = layer_norm_plan(rows, c, x.dtype)
    else:
        plan = layer_norm_forced_plan(rows, c, x.dtype, *_plan)
    if plan.route == "vector" and (x.data_ptr() % 16 or weight.data_ptr() % 16 or bias.data_ptr() % 16):
        raise ValueError(f"{name}: x, weight and bias must start on a 16-byte boundary")
    err = _build.library().said_layer_norm(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(), rows, c, eps,
        _build.DTYPE_CODE[x.dtype], int(plan.route == "vector"), plan.lanes, plan.chunks, plan.rows,
        torch.cuda.current_stream().cuda_stream,
    )
    _build.check(err, name)
    layer_norm_kernel.launches += 1
    return y


layer_norm_kernel.launches = 0


def _launch_group_norm(x, num_groups, weight, bias, lengths, eps, act, name, plan):
    c = _check(x, weight, bias, name)
    if x.ndim != 3 or c % num_groups or x.shape[1] == 0:
        raise ValueError(f"{name}: needs (B, T>0, C) with C % G == 0, got {tuple(x.shape)}, G={num_groups}")
    if act not in ("none", "silu"):
        raise ValueError(f"{name}: act {act!r} not supported")
    b, t, _ = x.shape
    if plan is None:
        plan = group_norm_plan(b, t, c, num_groups, x.dtype)
    elif plan == "split":
        plan = split_plan(b, t, c, num_groups)
    else:
        allowed = cluster_plans(t, c, num_groups, x.dtype)
        if tuple(plan) not in allowed:
            raise ValueError(f"{name}: plan {plan} not 'split' or one of {allowed} for {tuple(x.shape)} {x.dtype}")
        plan = GroupNormPlan("cuda", plan[0], plan[1], -(-t // plan[1]), 1)
    y = torch.empty_like(x)
    if plan.route == "cuda":
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: x must start on a 16-byte boundary")
        if x.device.index != torch.cuda.current_device():
            raise ValueError(f"{name}: input is on {x.device}, not the current device")
        err = _build.library().said_group_norm(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            None if lengths is None else lengths.data_ptr(), b, t, c, num_groups, eps, int(act == "silu"),
            _build.DTYPE_CODE[x.dtype], plan.groups, plan.cluster, torch.cuda.current_stream().cuda_stream,
        )
        _build.check(err, name)
        return y
    stats, apply = _kernels()
    cg, cg_p, gb, n_gblocks, block_t = _group_geometry(c, num_groups)
    # unmasked: L is never read (MASKED is a compile-time False)
    lens = x if lengths is None else lengths
    tile = dict(GB=gb, CG_P=cg_p, BLOCK_T=block_t, num_warps=4)
    plane = b * num_groups * plan.chunks
    partials = torch.empty((3, plane), dtype=torch.float32, device=x.device)
    grid = (plan.chunks, b * n_gblocks)
    # Triton's launcher raises on a failed cuLaunchKernel.
    stats[grid](x, lens, partials, t, c, num_groups, cg, n_gblocks, plan.chunks, plan.frames, plane,
                MASKED=lengths is not None, **tile)
    apply[grid](x, weight, bias, y, partials, t, c, num_groups, cg, n_gblocks, plan.chunks, plan.frames, plane, eps,
                SILU=act == "silu", NCH_P=_next_pow2(plan.chunks), **tile)
    return y


def group_norm_kernel(
    x: torch.Tensor,
    num_groups: int,
    weight: torch.Tensor,
    bias: torch.Tensor,
    eps: float = 1e-5,
    act: str = "none",
    *,
    _plan: tuple[int, int] | str | None = None,
) -> torch.Tensor:
    """GroupNorm(+SiLU) over a contiguous (B, T, C) CUDA tensor, by the
    route ``group_norm_plan`` picks. ``_plan`` forces a one-launch plan of
    ``cluster_plans`` (groups a block, cluster size) or "split", for tests
    and timing only."""
    y = _launch_group_norm(x, num_groups, weight, bias, None, eps, act, "group_norm_kernel", _plan)
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
    *,
    _plan: tuple[int, int] | str | None = None,
) -> torch.Tensor:
    """Masked GroupNorm(+SiLU) over a contiguous (B, T, C) CUDA tensor;
    ``lengths`` a contiguous (B,) int32 tensor on the same device
    (statistics over frames t < lengths[b], count clamped to ≥ 1).
    Route and ``_plan`` as ``group_norm_kernel``."""
    name = "group_norm_masked_kernel"
    _check(x, weight, bias, name)
    if (lengths.dtype != torch.int32 or lengths.ndim != 1 or lengths.shape[0] != x.shape[0]
            or lengths.device != x.device or not lengths.is_contiguous()):
        raise ValueError(f"{name}: lengths must be a contiguous ({x.shape[0]},) int32 tensor on {x.device}, "
                         f"got {lengths.dtype} {tuple(lengths.shape)} on {lengths.device}")
    y = _launch_group_norm(x, num_groups, weight, bias, lengths, eps, act, name, _plan)
    group_norm_masked_kernel.launches += 1
    return y


group_norm_masked_kernel.launches = 0
