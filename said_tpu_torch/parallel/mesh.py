"""The process mesh: ranks laid out as ('data', 'model', 'seq').

Port of ``said_tpu.parallel.mesh`` over ``torch.distributed``, one process
a rank (a card each on CUDA, as ``torchrun`` starts them):

- ``MeshConfig`` and ``fit_data_axis`` are the JAX package's, with its
  answers and errors;
- ``maybe_init_distributed`` starts ``torch.distributed`` from torchrun's
  environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``),
  where the JAX version reads ``JAX_COORDINATOR_ADDRESS``: NCCL for a
  CUDA device with each rank on ``cuda:LOCAL_RANK``, gloo for the CPU;
- ``make_mesh`` gives a rank its place on the mesh and the process groups
  of its ``data``, ``model`` and ``seq`` axes, in the rank order of the
  JAX ``make_mesh``: ``np.reshape(ranks, (data, model, seq))``, and of
  the ranks that share its model coordinate (data × seq), over which the
  gradients are summed;
- ``rank_rows`` replaces ``host_local_slice`` / ``put_global``: every rank
  builds the same global batch from the seeded loaders and keeps its own
  rows (all of them where the data axis does not divide the batch, as
  the JAX CLI replicates such a batch);
- ``SlicedGenerator`` and the draws ``rand``, ``randn``, ``randint``: a
  random array is drawn at the global shape from a generator every rank
  seeds alike and sliced to the rank's rows, frames, heads or columns, so
  N ranks draw what one process draws.

Tensor parallelism (the JAX ``param_sharding_rules`` / ``shard_params``)
is ``parallel.tensor``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical mesh shape. ``data * model * seq`` must equal the rank count
    the mesh spans. ``seq`` > 1 shards the frame axis."""

    data: int = -1  # -1 → all remaining ranks
    model: int = 1
    seq: int = 1

    def resolve(self, n_devices: int) -> "MeshConfig":
        d = self.data
        per_data = self.model * self.seq
        if d == -1:
            if n_devices % per_data:
                raise ValueError(f"{n_devices} devices not divisible by model*seq={per_data}")
            d = n_devices // per_data
        if d * per_data != n_devices:
            raise ValueError(f"mesh {d}x{self.model}x{self.seq} != device count {n_devices}")
        return MeshConfig(data=d, model=self.model, seq=self.seq)


def fit_data_axis(batch_size: int, n_devices: int, model_axis: int = 1, seq_axis: int = 1) -> int:
    """Largest data-axis size that divides both the batch and the ranks
    left after the model and seq axes (extra ranks then hold no rows)."""
    avail = n_devices // (model_axis * seq_axis)
    d = min(batch_size, avail)
    while d > 1 and (batch_size % d or avail % d):
        d -= 1
    return max(d, 1)


@dataclasses.dataclass(frozen=True)
class DistContext:
    """This process's place in the job: its rank, the world size, its
    device, the backend (None: one process, no process group), and whether
    ``maybe_init_distributed`` started the process group (then ``shutdown``
    ends it)."""

    rank: int
    world: int
    device: torch.device
    backend: Optional[str] = None
    owned: bool = False


def maybe_init_distributed(device: str = "cuda", backend: Optional[str] = None) -> DistContext:
    """Start ``torch.distributed`` where torchrun's environment says so.

    Without ``RANK`` and ``WORLD_SIZE`` (a plain process): nothing starts,
    and the context is rank 0 of 1 on ``device``. Otherwise the process
    group is started from the environment (``env://``: ``MASTER_ADDR``,
    ``MASTER_PORT``), or joined where it already runs. ``backend`` defaults
    to NCCL for a CUDA device, each rank on ``cuda:LOCAL_RANK``, and gloo
    for the CPU. With gloo, ranks past the card count share cards
    (``LOCAL_RANK`` modulo the count): gloo moves CUDA tensors for
    ``all_reduce``, ``all_gather`` and ``broadcast``; NCCL refuses two
    ranks on one card, so that raises."""
    dev = torch.device(device)
    env = os.environ
    if "RANK" not in env or "WORLD_SIZE" not in env:
        if dist.is_available() and dist.is_initialized():
            raise RuntimeError("a process group runs, but RANK and WORLD_SIZE are not set")
        return DistContext(0, 1, dev)
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    local_rank = int(env.get("LOCAL_RANK", rank))
    owned = not dist.is_initialized()
    if owned:
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    else:
        backend = dist.get_backend()
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        if backend == "nccl" and local_rank >= count:
            raise RuntimeError(f"LOCAL_RANK {local_rank} has no card of its own ({count} cards): NCCL takes one "
                               "rank a card")
        dev = torch.device("cuda", local_rank % count)
        torch.cuda.set_device(dev)
    if owned:
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    if dist.get_rank() != rank or dist.get_world_size() != world:
        raise RuntimeError(f"the process group is rank {dist.get_rank()} of {dist.get_world_size()}, the "
                           f"environment says {rank} of {world}")
    return DistContext(rank, world, dev, backend, owned)


def shutdown(ctx: DistContext) -> None:
    """End the process group if ``maybe_init_distributed`` started it."""
    if ctx.owned and dist.is_initialized():
        dist.destroy_process_group()


@dataclasses.dataclass
class AxisGroup:
    """One mesh axis as a rank sees it: the process group of the ranks
    along it (None where the axis has one rank), this rank's index on it
    and its size. ``timed`` makes the collectives of ``parallel.seq``
    synchronise the card around each call and add its host seconds to
    ``seconds``; ``calls`` counts them either way."""

    group: Optional[object]
    index: int
    size: int
    timed: bool = False
    calls: int = 0
    seconds: float = 0.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A rank's place on a resolved mesh: its ``data``, ``model`` and
    ``seq`` axes, and ``data_seq``, the ranks that share its model
    coordinate (data-major, then seq), over which gradients are summed
    (each None for a rank past the mesh, which holds no rows)."""

    data: Optional[AxisGroup]
    seq: Optional[AxisGroup]
    model: Optional[AxisGroup] = None
    data_seq: Optional[AxisGroup] = None

    @property
    def active(self) -> bool:
        return self.data is not None


def mesh_ranks(config: MeshConfig) -> np.ndarray:
    """The ranks of a resolved mesh as a (data, model, seq) array, in the
    device order of the JAX ``make_mesh``."""
    return np.arange(config.data * config.model * config.seq).reshape(config.data, config.model, config.seq)


def axis_ranks(config: MeshConfig, axis: str) -> list[list[int]]:
    """Every group of ranks along ``axis`` ("data", "model", "seq", or
    "data_seq": the ranks of one model coordinate, data-major), each in its
    index order; the groups in the order of the other coordinates."""
    grid = mesh_ranks(config)
    if axis == "data_seq":
        return [list(map(int, grid[:, m].reshape(-1))) for m in range(config.model)]
    grid = np.moveaxis(grid, ("data", "model", "seq").index(axis), -1)
    return [list(map(int, row)) for row in grid.reshape(-1, grid.shape[-1])]


def make_mesh(config: MeshConfig, ctx: DistContext) -> Mesh:
    """Resolve ``config`` over the job's ranks and build this rank's axes.

    A mesh with ``data`` given spans its first data·model·seq ranks (a
    config that needs more ranks than the job has raises, as the JAX
    ``make_mesh`` does); ``data = -1`` spans them all. Every rank calls
    ``new_group`` for every group (torch requires it), so a rank past the
    mesh takes part in building groups it is not in."""
    n = ctx.world if config.data == -1 else min(config.data * config.model * config.seq, ctx.world)
    cfg = config.resolve(n)
    axes = {}
    for axis in ("data", "model", "seq", "data_seq"):
        size = cfg.data * cfg.seq if axis == "data_seq" else getattr(cfg, axis)
        axes[axis] = None
        for ranks in axis_ranks(cfg, axis) if size > 1 else []:
            group = dist.new_group(ranks)
            if ctx.rank in ranks:
                axes[axis] = AxisGroup(group, ranks.index(ctx.rank), size)
    if ctx.rank < n:
        data, model, seq = (int(c) for c in np.argwhere(mesh_ranks(cfg) == ctx.rank)[0])
        for axis, index in (("data", data), ("model", model), ("seq", seq), ("data_seq", data * cfg.seq + seq)):
            if axes[axis] is None:
                axes[axis] = AxisGroup(None, index, 1)
    return Mesh(axes["data"], axes["seq"], axes["model"], axes["data_seq"])


def rank_rows(n_rows: int, size: int, index: int) -> slice:
    """The rows of an ``n_rows`` global batch that index ``index`` of a
    ``size``-rank data axis holds: its contiguous block, or every row where
    ``size`` does not divide ``n_rows`` (replicated, as the JAX CLI places
    such a batch)."""
    if size <= 1 or n_rows % size:
        return slice(0, n_rows)
    per = n_rows // size
    return slice(index * per, (index + 1) * per)


# ------------------------------------------------------------------ draws


class SlicedGenerator:
    """A ``torch.Generator`` whose arrays are drawn at the global shape, of
    ``size`` along ``dim``, and sliced to ``index`` there: a rank's rows
    (dim 0), frames (dim 1), heads (dim 1 of attention probabilities) or
    feed-forward columns (dim 2). ``generator`` may itself be a
    ``SlicedGenerator``: its cuts are kept and this one is added (rows and
    frames of a data × seq mesh). Every rank seeds its generator alike and
    draws the same global shapes in the same order, so the generators stay
    in step and N ranks draw what one process draws. Draws whose shape has
    no such axis (layerdrop's one draw a layer) take ``generator`` itself.
    ``get_state``/``set_state`` (gradient checkpointing) pass through."""

    def __init__(self, generator, dim: int, index: slice, size: int):
        outer = generator.cuts if isinstance(generator, SlicedGenerator) else ()
        self.generator = unsliced(generator)
        self.cuts = outer + ((dim, index, size),)

    def get_state(self) -> torch.Tensor:
        return self.generator.get_state()

    def set_state(self, state: torch.Tensor) -> None:
        self.generator.set_state(state)

    def draw(self, fn, shape: Sequence[int], **kwargs) -> torch.Tensor:
        shape = list(shape)
        for dim, index, size in self.cuts:
            n = index.stop - index.start
            if shape[dim] != n:
                raise ValueError(f"a draw of shape {tuple(shape)} does not hold the {n} of {size} along dim "
                                 f"{dim} this generator slices")
            shape[dim] = size
        full = fn(shape, generator=self.generator, **kwargs)
        for dim, index, _ in self.cuts:
            full = full.narrow(dim, index.start, index.stop - index.start)
        return full


def sliced(generator, dim: int, index: slice, size: int):
    """``generator`` cut to ``index`` of ``size`` along ``dim`` (a
    ``SlicedGenerator``); None, or ``generator`` itself where ``index``
    spans the whole axis."""
    if generator is None or (index.start == 0 and index.stop == size):
        return generator
    return SlicedGenerator(generator, dim, index, size)


def unsliced(generator):
    """The ``torch.Generator`` under a ``SlicedGenerator`` (or itself)."""
    return generator.generator if isinstance(generator, SlicedGenerator) else generator


def rand(shape, generator, device, dtype=torch.float32) -> torch.Tensor:
    """``torch.rand`` from a generator or a ``SlicedGenerator``."""
    if isinstance(generator, SlicedGenerator):
        return generator.draw(torch.rand, shape, device=device, dtype=dtype)
    return torch.rand(tuple(shape), generator=generator, device=device, dtype=dtype)


def randn(shape, generator, device, dtype=torch.float32) -> torch.Tensor:
    """``torch.randn`` from a generator or a ``SlicedGenerator``."""
    if isinstance(generator, SlicedGenerator):
        return generator.draw(torch.randn, shape, device=device, dtype=dtype)
    return torch.randn(tuple(shape), generator=generator, device=device, dtype=dtype)


def randint(high: int, shape, generator, device) -> torch.Tensor:
    """``torch.randint(0, high)`` from a generator or a ``SlicedGenerator``."""
    if isinstance(generator, SlicedGenerator):
        return generator.draw(lambda s, **kw: torch.randint(0, high, tuple(s), **kw), shape, device=device)
    return torch.randint(0, high, tuple(shape), generator=generator, device=device)
