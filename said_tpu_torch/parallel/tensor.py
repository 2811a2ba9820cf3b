"""Tensor parallelism over a 'model' axis: which parameters split, and how.

Port of the JAX ``param_sharding_rules`` / ``shard_params``
(``said_tpu/parallel/mesh.py:152-205``), the Megatron split: the "up"
projections are column-parallel (each rank holds a block of their
outputs) and the "down" projections row-parallel (a block of their
inputs), so one sum over the ranks ends each block. The JAX package lets
XLA write the collectives; here they are the two Megatron operators:

- ``enter``: identity forward, the gradient summed over the ranks
  backward, where a replicated activation enters column-parallel layers;
- ``reduce``: the partial outputs of a row-parallel layer summed over the
  ranks forward, identity backward; the layer's bias is added once, after
  the sum.

Both sums are ``parallel.seq.all_sum`` (one ``all_gather``, rank order),
so every rank of the axis holds the same bits of every replicated
activation and gradient, and the replicated parameters stay identical.

The rules (``RULES``) are keyed by the port's ``state_dict`` names:

- UNet: ``attn{1,2}.to_{q,k,v}`` column and ``attn{1,2}.to_out.0`` row,
  by whole heads; ``ff.net.0.proj`` column, ``ff.net.2`` row;
  ``time_embed.0`` column, ``time_embed.2`` row;
- encoder: ``attention.{q,k,v}_proj`` column and ``out_proj`` row, by
  whole heads; ``feed_forward.intermediate_dense`` column and
  ``output_dense`` row;
- everything else replicated; a rule falls back to replication where the
  axis does not divide its unit (the heads of an attention layer, else
  the split dimension), as JAX's does where it does not divide the
  dimension.

Where the port departs from the JAX placement, with results unchanged:
a column-parallel layer's bias splits with its weight (JAX replicates
every bias); ``ff.net.0.proj`` is GEGLU's 2I outputs [a | g], and rank r
holds a's block r and g's block r (JAX splits the 2I outputs
contiguously, handing a and g to different ranks), so its a·gelu(g) is
local; q/k/v split by whole heads only, or stay replicated.

``shard_model_`` cuts a whole model's parameters to a rank's shards in
place and tells its modules their group; ``shard_state_dict``,
``join_state_dict`` and ``gather_state_dict`` move between whole and
sharded ``state_dict``s, so checkpoints stay whole ``.pth`` files.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from said_tpu_torch.parallel.mesh import AxisGroup, sliced
from said_tpu_torch.parallel.seq import _all_gather, all_sum, sharded

COLUMN, ROW = 0, 1  # the split dimension of a torch (out, in) weight; a bias splits on 0


@dataclasses.dataclass(frozen=True)
class Placement:
    """How a parameter splits: along ``dim``, as ``blocks`` equal blocks
    each cut alike (2 for GEGLU's [a | g]: rank r holds a_r and g_r)."""

    dim: int
    blocks: int = 1


# (state_dict name pattern, placement, unit); the "owner" group names the
# module that holds the layer (its ``heads`` where the unit is "heads", and
# the module that applies ``enter``)
RULES = (
    (r"(?P<owner>(?:.+\.)?attn[12])\.to_[qkv]\.weight", Placement(COLUMN), "heads"),
    (r"(?P<owner>(?:.+\.)?attn[12])\.to_out\.0\.weight", Placement(ROW), "heads"),
    (r"(?P<owner>(?:.+\.)?ff)\.net\.0\.proj\.(weight|bias)", Placement(COLUMN, 2), "dim"),
    (r"(?P<owner>(?:.+\.)?ff)\.net\.2\.weight", Placement(ROW), "dim"),
    (r"(?:(?P<owner>.+)\.)?time_embed\.0\.(weight|bias)", Placement(COLUMN), "dim"),
    (r"(?:(?P<owner>.+)\.)?time_embed\.2\.weight", Placement(ROW), "dim"),
    (r"(?P<owner>(?:.+\.)?attention)\.[qkv]_proj\.(weight|bias)", Placement(COLUMN), "heads"),
    (r"(?P<owner>(?:.+\.)?attention)\.out_proj\.weight", Placement(ROW), "heads"),
    (r"(?P<owner>(?:.+\.)?feed_forward)\.intermediate_dense\.(weight|bias)", Placement(COLUMN), "dim"),
    (r"(?P<owner>(?:.+\.)?feed_forward)\.output_dense\.weight", Placement(ROW), "dim"),
)
_RULES = [(re.compile(pattern), placement, unit) for pattern, placement, unit in RULES]


def _rule(name: str):
    for pattern, placement, unit in _RULES:
        m = pattern.fullmatch(name)
        if m:
            return m.group("owner") or "", placement, unit
    return None


def tensor_plan(model: nn.Module, size: int) -> Dict[str, Placement]:
    """The placement of every parameter of ``model`` that a ``size``-rank
    model axis splits, by ``state_dict`` name (the rest are replicated)."""
    plan = {}
    for name, p in model.named_parameters():
        rule = _rule(name)
        if rule is None:
            continue
        owner, placement, unit = rule
        units = model.get_submodule(owner).heads if unit == "heads" else p.shape[placement.dim] // placement.blocks
        if units % size == 0:
            plan[name] = placement
    return plan


def shard(t: torch.Tensor, placement: Placement, index: int, size: int) -> torch.Tensor:
    """Rank ``index``'s block of a whole tensor (contiguous)."""
    dim = placement.dim if t.dim() > 1 else 0
    return torch.cat([b.chunk(size, dim)[index] for b in t.chunk(placement.blocks, dim)], dim).contiguous()


def join(shards: Sequence[torch.Tensor], placement: Placement) -> torch.Tensor:
    """The whole tensor from every rank's block, in rank order."""
    dim = placement.dim if shards[0].dim() > 1 else 0
    parts = [s.chunk(placement.blocks, dim) for s in shards]
    return torch.cat([torch.cat([p[b] for p in parts], dim) for b in range(placement.blocks)], dim)


def shard_state_dict(state: Mapping[str, torch.Tensor], plan: Mapping[str, Placement], index: int,
                     size: int) -> Dict[str, torch.Tensor]:
    """A whole ``state_dict`` cut to rank ``index``'s shards (the keys of
    ``plan``; the rest as they are)."""
    return {k: shard(v, plan[k], index, size) if k in plan else v for k, v in state.items()}


def join_state_dict(shards: Sequence[Mapping[str, torch.Tensor]],
                    plan: Mapping[str, Placement]) -> Dict[str, torch.Tensor]:
    """The whole ``state_dict`` from every rank's, in rank order (the
    replicated entries from the first)."""
    return {k: join([s[k] for s in shards], plan[k]) if k in plan else v for k, v in shards[0].items()}


def gather_state_dict(state: Mapping[str, torch.Tensor], plan: Mapping[str, Placement],
                      group: Optional[AxisGroup]) -> Dict[str, torch.Tensor]:
    """The whole ``state_dict`` from this rank's, every rank of ``group``
    taking part: the sharded entries in one ``all_gather`` of their
    concatenation (one dtype)."""
    names = [k for k in state if k in plan]
    if not sharded(group) or not names:
        return dict(state)
    local = [state[k].detach() for k in names]
    parts = _all_gather(torch.cat([t.reshape(-1) for t in local]), group)
    sizes = [t.numel() for t in local]
    ranks = [[piece.reshape(t.shape) for piece, t in zip(p.split(sizes), local)] for p in parts]
    whole = {k: join([r[i] for r in ranks], plan[k]) for i, k in enumerate(names)}
    return {k: whole.get(k, v) for k, v in state.items()}


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """A model sharded over ``group`` (the model axis) by ``plan``."""

    group: AxisGroup
    plan: Dict[str, Placement]


def shard_model_(model: nn.Module, group: Optional[AxisGroup]) -> Optional[TensorParallel]:
    """Cut ``model``'s whole parameters to this rank's shards in place and
    set its modules for the model axis ``group``: each row-parallel
    ``Dense`` gets ``reduce_group``, each module that holds a split layer
    ``model_group`` (and an attention layer its heads a rank). Records and
    returns the ``TensorParallel`` as ``model.tensor_parallel`` (None where
    ``group`` does not shard). Load whole weights before, build the
    optimizer after."""
    if not sharded(group):
        return None
    plan = tensor_plan(model, group.size)
    owners = {}
    for name, placement in plan.items():
        owner, _, unit = _rule(name)
        mod_name, attr = name.rsplit(".", 1)
        mod = model.get_submodule(mod_name)
        whole = getattr(mod, attr)
        setattr(mod, attr, nn.Parameter(shard(whole.detach(), placement, group.index, group.size),
                                        requires_grad=whole.requires_grad))
        if placement.dim == ROW and attr == "weight":
            mod.reduce_group = group
        owners[owner] = unit
    for owner, unit in owners.items():
        mod = model.get_submodule(owner)
        mod.model_group = group
        if unit == "heads":
            mod.heads //= group.size
    model.tensor_parallel = TensorParallel(group, plan)
    return model.tensor_parallel


def block_draws(generator, dim: int, n: int, group: Optional[AxisGroup]):
    """``generator`` cut to this rank's block of ``n`` along ``dim`` of an
    activation split over the model axis ``group`` (draws at the whole
    width, as one process draws them); itself where ``group`` is None."""
    if group is None:
        return generator
    return sliced(generator, dim, slice(group.index * n, (group.index + 1) * n), n * group.size)


def enter(x: torch.Tensor, group: Optional[AxisGroup]) -> torch.Tensor:
    """A replicated activation entering column-parallel layers: ``x``
    itself, whose gradient is summed over the ranks of ``group``."""
    if sharded(group) and torch.is_grad_enabled() and x.requires_grad:
        return _Enter.apply(x, group)
    return x


def reduce(x: torch.Tensor, group: Optional[AxisGroup]) -> torch.Tensor:
    """A row-parallel layer's partial output summed over the ranks of
    ``group``; the gradient passes through to every rank."""
    if not sharded(group):
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _Reduce.apply(x, group)
    return all_sum(x, group)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_sum(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None
