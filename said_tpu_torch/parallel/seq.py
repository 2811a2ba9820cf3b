"""Collectives of sequence- and tensor-parallel execution.

The JAX package shards a clip's frames over a 'seq' mesh axis (and
parameters over a 'model' axis) and lets GSPMD write the collectives
(``said_tpu/models/said.py:645-690``); here they are explicit, on an
``AxisGroup`` of ``parallel.mesh``:

- ``shard_frames``: this rank's contiguous block of frames (the group's
  size divides the frame count);
- ``gather``: every rank's block, joined in rank order along an axis; its
  gradient is this rank's slice of the gradient summed over the ranks;
- ``halo``: a block with its neighbours' edge frames on each side,
  zeros past the clip's ends, as a SAME conv pads an unsharded clip; its
  gradient adds the neighbours' gradients of those edge frames to the
  frames they came from;
- ``all_sum``: a tensor summed over the ranks.

Every exchange is one ``all_gather`` (the halo gathers the edge slices
of every rank, not ``send``/``recv``, and sums are gathered and then
added, not ``all_reduce``/``reduce_scatter``: gloo moves CUDA tensors for
neither point to point nor a reduce-scatter, and ranks that share one
card run over gloo). Every sum adds the ranks' parts in rank order, so
each rank that takes a sum gets the same bits. A group of size 1 moves
nothing.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from said_tpu_torch.parallel.mesh import AxisGroup, rank_rows


def sharded(group) -> bool:
    """Whether ``group`` (an ``AxisGroup`` or None) splits the frames."""
    return group is not None and group.size > 1


def frames_of(t: int, group: AxisGroup) -> slice:
    """This rank's frames of a T-frame clip; raises where the group's size
    does not divide T."""
    if t % group.size:
        raise ValueError(f"the seq axis size ({group.size}) must divide the frame count ({t})")
    return rank_rows(t, group.size, group.index)


def shard_frames(x: torch.Tensor, group: AxisGroup, dim: int = 1) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (contiguous)."""
    if not sharded(group):
        return x
    s = frames_of(x.shape[dim], group)
    return x.narrow(dim, s.start, s.stop - s.start).contiguous()


def _all_gather(x: torch.Tensor, group: AxisGroup) -> list[torch.Tensor]:
    """Every rank's ``x`` (one shape on every rank), in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(group.size)]
    if group.timed and x.is_cuda:
        torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        dist.all_gather(parts, x, group=group.group)
        torch.cuda.synchronize(x.device)
        group.seconds += time.perf_counter() - t0
    else:
        dist.all_gather(parts, x, group=group.group)
    group.calls += 1
    return parts


def _rank_sum(parts: list[torch.Tensor]) -> torch.Tensor:
    out = parts[0].clone()
    for p in parts[1:]:
        out += p
    return out


@torch.no_grad()
def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the ranks of ``group``, in rank order (one
    ``all_gather``; the same bits on every rank). No gradient."""
    if not sharded(group):
        return x
    return _rank_sum(_all_gather(x, group))


def gather(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """Every rank's ``x`` joined along ``dim`` in rank order (``x`` itself
    where the group does not shard); differentiable: the gradient of this
    rank's block is its slice of every rank's gradient, summed in rank
    order."""
    if not sharded(group):
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _Gather.apply(x, group, dim)
    return torch.cat(_all_gather(x, group), dim=dim)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return torch.cat(_all_gather(x, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        n, r = ctx.n, ctx.group.index
        mine = [p.narrow(ctx.dim, r * n, n) for p in _all_gather(g, ctx.group)]
        return _rank_sum(mine), None, None


def halo(x: torch.Tensor, left: int, right: int, group) -> torch.Tensor:
    """(B, left + L + right, ...) from this rank's (B, L, ...) block: the
    ``left`` frames before it and the ``right`` frames after it in the
    clip, zeros where the clip ends (a whole block is zeros-padded
    likewise where the group does not shard). A block shorter than a halo
    takes frames from as many ranks as it needs. Differentiable: the
    gradient of the halo's frames goes back to the ranks that hold them
    (one ``all_gather`` of every rank's halo gradient)."""
    if not sharded(group):
        return torch.nn.functional.pad(x, (0, 0) * (x.dim() - 2) + (left, right))
    if torch.is_grad_enabled() and x.requires_grad:
        return _Halo.apply(x, left, right, group)
    return _halo(x, left, right, group)


def _halo(x, left, right, group):
    n = x.shape[1]
    a, b = min(right, n), min(left, n)  # the leading frames a left neighbour needs, the trailing ones a right
    parts = _all_gather(torch.cat([x[:, :a], x[:, n - b:]], dim=1), group)
    r = group.index
    zeros = x.new_zeros((x.shape[0], max(left, right)) + tuple(x.shape[2:]))
    before = torch.cat([zeros[:, :left]] + [p[:, a:] for p in parts[:r]], dim=1)[:, -left:] if left else x[:, :0]
    after = torch.cat([p[:, :a] for p in parts[r + 1:]] + [zeros[:, :right]], dim=1)[:, :right]
    return torch.cat([before, x, after], dim=1)


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, left, right, group):
        ctx.args = (x.shape[1], left, right, group)
        return _halo(x, left, right, group)

    @staticmethod
    def backward(ctx, g):
        n, left, right, group = ctx.args
        r = group.index
        parts = _all_gather(torch.cat([g[:, :left], g[:, left + n:]], dim=1), group)
        dx = g[:, left:left + n].clone()
        # rank s's halo holds the clip's frames [s·n − left, s·n) before its
        # block and [s·n + n, s·n + n + right) after it; add what falls in
        # this rank's [r·n, r·n + n), in rank order
        for s, p in enumerate(parts):
            if s == r:
                continue
            for first, j0, width in ((s * n - left, 0, left), (s * n + n, left, right)):
                lo, hi = max(first, r * n), min(first + width, r * n + n)
                if lo < hi:
                    dx[:, lo - r * n:hi - r * n] += p[:, j0 + lo - first:j0 + hi - first]
        return dx, None, None, None
