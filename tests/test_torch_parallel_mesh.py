"""The port's process mesh (``said_tpu_torch.parallel.mesh``) against the
JAX package's ``said_tpu.parallel.mesh``, on the CPU, in one process.

``MeshConfig.resolve`` and ``fit_data_axis`` give JAX's answers and
errors on a grid of shapes; a rank's rows of a global batch
(``rank_rows``) are the rows ``host_local_slice`` / ``_union_slice`` give
the device at the rank's place on the JAX mesh (a rank is one device, in
the order of ``make_mesh``), replicated where the data axis does not
divide the batch, as the JAX CLI places such a batch; the groups of an
axis follow ``make_mesh``'s device grid. The draws of a
``SlicedGenerator`` are the global draw's rows or frames.
"""

import itertools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from said_tpu.parallel import mesh as jmesh
from said_tpu_torch.parallel import mesh

SHAPES = [(-1, 1, 1), (-1, 2, 1), (-1, 1, 2), (-1, 2, 2), (-1, 3, 1), (2, 1, 1), (4, 2, 1), (2, 2, 2), (3, 1, 1),
          (8, 1, 1), (1, 1, 8), (5, 1, 1)]


def _outcome(fn):
    try:
        return fn()
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_mesh_config_resolve_matches_jax(shape, n):
    mine = _outcome(lambda: mesh.MeshConfig(*shape).resolve(n))
    theirs = _outcome(lambda: jmesh.MeshConfig(*shape).resolve(n))
    if isinstance(theirs, tuple):
        assert mine == theirs
    else:
        assert (mine.data, mine.model, mine.seq) == (theirs.data, theirs.model, theirs.seq)


@pytest.mark.parametrize("model,seq", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_fit_data_axis_matches_jax(model, seq):
    for batch, n in itertools.product([1, 2, 3, 4, 6, 8, 9, 12, 16], [1, 2, 3, 4, 6, 8, 16]):
        assert mesh.fit_data_axis(batch, n, model, seq) == jmesh.fit_data_axis(batch, n, model, seq), (batch, n)


@pytest.mark.parametrize("shape", [(8, 1, 1), (4, 2, 1), (2, 2, 2), (2, 1, 4), (1, 1, 8)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("rows", [8, 16, 6, 1])
def test_rank_rows_match_host_local_slice(shape, rows):
    """Each rank's rows are those of the device at its place on the JAX mesh
    (``P('data')`` where the data axis divides the batch, replicated
    otherwise); a host of several ranks holds their union."""
    cfg = mesh.MeshConfig(*shape).resolve(8)
    jm = jmesh.make_mesh(jmesh.MeshConfig(*shape))
    sharding = NamedSharding(jm, P("data") if rows % cfg.data == 0 else P(None))
    index = sharding.devices_indices_map((rows, 3))
    flat = list(jm.devices.flat)
    for rank in range(8):
        d = int(np.argwhere(mesh.mesh_ranks(cfg) == rank)[0][0])
        want = jmesh._union_slice([index[flat[rank]][0]], rows)
        assert mesh.rank_rows(rows, cfg.data, d) == want, rank
    for host in (range(0, 4), range(4, 8)):  # two hosts of four ranks each
        want = jmesh._union_slice([index[flat[r]][0] for r in host], rows)
        spans = [mesh.rank_rows(rows, cfg.data, int(np.argwhere(mesh.mesh_ranks(cfg) == r)[0][0])) for r in host]
        assert slice(min(s.start for s in spans), max(s.stop for s in spans)) == want


def test_host_local_slice_of_one_process_is_everything():
    jm = jmesh.make_mesh(jmesh.MeshConfig())
    assert jmesh.host_local_slice((8, 3), jmesh.batch_sharding(jm)) == mesh.rank_rows(8, 1, 0) == slice(0, 8)


@pytest.mark.parametrize("shape", [(8, 1, 1), (4, 2, 1), (2, 2, 2), (2, 1, 4), (1, 1, 8)],
                         ids=lambda s: "x".join(map(str, s)))
def test_axis_groups_follow_the_jax_device_grid(shape):
    """The ranks along each axis are the devices along that axis of the
    JAX mesh (rank r = device r of ``jax.devices()``)."""
    cfg = mesh.MeshConfig(*shape).resolve(8)
    grid = np.vectorize(lambda d: d.id)(jmesh.make_mesh(jmesh.MeshConfig(*shape)).devices)
    ids = {d.id: i for i, d in enumerate(jax.devices())}
    grid = np.vectorize(ids.get)(grid)
    for axis_i, axis in enumerate(("data", "model", "seq")):
        want = np.moveaxis(grid, axis_i, -1).reshape(-1, grid.shape[axis_i]).tolist()
        assert mesh.axis_ranks(cfg, axis) == want


def test_maybe_init_distributed_without_torchrun(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    ctx = mesh.maybe_init_distributed("cpu")
    assert (ctx.rank, ctx.world, ctx.backend, ctx.owned) == (0, 1, None, False)
    m = mesh.make_mesh(mesh.MeshConfig(data=-1), ctx)
    assert m.active and (m.data.size, m.seq.size, m.data.group) == (1, 1, None)
    with pytest.raises(ValueError, match="mesh 2x1x1 != device count 1"):
        mesh.make_mesh(mesh.MeshConfig(data=2), ctx)


@pytest.mark.parametrize("dim,index,size", [(0, slice(2, 4), 4), (1, slice(3, 6), 9)])
def test_sliced_generator_draws_the_global_array(dim, index, size):
    shape = [4, 9, 5]
    full_shape = list(shape)
    full_shape[dim] = size
    local = list(shape)
    local[dim] = index.stop - index.start
    g = mesh.SlicedGenerator(torch.Generator().manual_seed(3), dim, index, size)
    want_g = torch.Generator().manual_seed(3)
    for draw, ref in ((mesh.rand, torch.rand), (mesh.randn, torch.randn)):
        got = draw(local, g, "cpu")
        want = ref(full_shape, generator=want_g).narrow(dim, index.start, index.stop - index.start)
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="does not hold"):
        mesh.rand(shape, g, "cpu")
