"""The one-launch GroupNorm kernel's arithmetic and plan, on the CPU.

``norms.group_norm_cluster_plain`` repeats the CUDA kernel's arithmetic
(csrc/group_norm.cu): per-rank partial sums over the plan's frame
slices, joined in rank order, then centred squares about the joined mean,
joined the same way. It is held against the JAX package's GroupNorm —
``_group_norm_jnp`` / ``_group_norm_masked_jnp`` and K3 / K4 in interpret
mode, as the JAX package's own tests run them — on inputs of mean 30
and std 2 made from a seed with numpy, in float32, at atol 1e-5, rtol
1e-5 (``test_torch_ops.TOL``: the summation order is the only
difference). The masked comparisons take atol 4e-5, the bound
``test_torch_ops`` gives the split's twin on the same data: an f32 ulp
at 30 is 1.9e-6, and at these inputs every pair of f32 versions — the
port's shipped twin against ``_group_norm_masked_jnp`` included — differs
by up to 2.3e-5, each within 2.3e-5 of a float64 evaluation.

The plan (``norms.group_norm_plan``, ``norms.cluster_plans``) is pure
host arithmetic and is checked here over the main path's shapes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from said_tpu.ops.norms import _group_norm_jnp, _group_norm_masked_jnp
from said_tpu.ops.pallas_norms import group_norm_masked_pallas, group_norm_pallas
from said_tpu_torch.ops import norms

TOL = dict(atol=1e-5, rtol=1e-5)
MASKED_TOL = dict(atol=4e-5, rtol=1e-5)


def _rand(shape, seed, scale=1.0, offset=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale + offset).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(tol or TOL))


def _cluster(t):
    """The cluster size of the f32 plan at the UNet's CFG-folded batch."""
    return norms.group_norm_plan(2, t, 192, 32, torch.float32).cluster


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("act", ["none", "silu"])
@pytest.mark.parametrize("t", [1, 37, 600])
def test_group_norm_cluster_plain_matches_jax(t, act, eps):
    x, w, b = _rand((2, t, 192), 70 + t, 2.0, 30.0), _rand((192,), 71), _rand((192,), 72)
    got = norms.group_norm_cluster_plain(torch.from_numpy(x), 32, torch.from_numpy(w), torch.from_numpy(b), eps,
                                         act, cluster=_cluster(t)).numpy()
    jx, jw, jb = jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)
    _close(got, _group_norm_jnp(jx, 32, jw, jb, eps, act))
    _close(got, group_norm_pallas(jx, jw, jb, 32, eps, act, interpret=True))


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("act", ["none", "silu"])
@pytest.mark.parametrize("t", [1, 37, 600])
def test_group_norm_cluster_plain_masked_matches_jax(t, act, eps):
    """Lengths 0, 1, a slice edge ± 1 and T: slices wholly past a length
    add 0 and a count of 0. ``_group_norm_masked_jnp`` and K4 divide by
    the unclamped count, so they give NaN for a length-0 row; the port
    clamps the count to 1 there (finite, as ``group_norm_masked_plain``)
    and is held against them on every other row."""
    cluster = _cluster(t)
    edge = -(-t // cluster)
    lengths = np.array(sorted({0, 1, max(edge - 1, 0), min(edge + 1, t), t}), np.int32)
    b = len(lengths)
    x, w, bias = _rand((b, t, 192), 80 + t, 2.0, 30.0), _rand((192,), 81), _rand((192,), 82)
    got = norms.group_norm_cluster_plain(torch.from_numpy(x), 32, torch.from_numpy(w), torch.from_numpy(bias), eps,
                                         act, torch.from_numpy(lengths), cluster).numpy()
    jx, jw, jb = jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias)
    mask = jnp.asarray(np.arange(t)[None, :] < lengths[:, None])
    real = lengths > 0
    _close(got[real], np.asarray(_group_norm_masked_jnp(jx, 32, jw, jb, mask, eps, act))[real], **MASKED_TOL)
    _close(got[real], np.asarray(group_norm_masked_pallas(jx, jw, jb, mask, 32, eps, act, interpret=True))[real],
           **MASKED_TOL)
    assert np.isfinite(got).all()
    _close(got[~real], norms.group_norm_masked_plain(torch.from_numpy(x[~real]), 32, torch.from_numpy(w),
                                                     torch.from_numpy(bias), torch.zeros(1, dtype=torch.int32),
                                                     eps, act).numpy())


@pytest.mark.parametrize("cluster", [1, 2, 16])
def test_group_norm_cluster_plain_any_cluster_is_group_norm(cluster):
    """Every cluster size gives the plain twin, T = 37 not a multiple of
    any of them; 16 leaves ranks with no frames."""
    x, w, b = _rand((2, 37, 192), 90, 2.0, 30.0), _rand((192,), 91), _rand((192,), 92)
    xt, wt, bt = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)
    got = norms.group_norm_cluster_plain(xt, 32, wt, bt, 1e-5, "silu", cluster=cluster)
    _close(got.numpy(), norms.group_norm_plain(xt, 32, wt, bt, 1e-5, "silu").numpy())
    lens = torch.tensor([37, 5], dtype=torch.int32)
    got = norms.group_norm_cluster_plain(xt, 32, wt, bt, 1e-5, "none", lens, cluster)
    _close(got.numpy(), norms.group_norm_masked_plain(xt, 32, wt, bt, lens, 1e-5, "none").numpy(), **MASKED_TOL)


# ------------------------------------------------------------------ the plan

_WIDTHS = [(192, 32), (384, 32), (512, 512)]  # the UNet's two widths, the encoder's conv_0
_DTYPES = [torch.float32, torch.bfloat16]


def _check_one_launch(b, t, c, g, dtype, gb, cl):
    esize = torch.finfo(dtype).bits // 8
    w = gb * (c // g)
    frames = -(-t // cl)
    # slices cover every frame exactly once
    seen = np.zeros(t, np.int64)
    for rank in range(cl):
        seen[rank * frames: min((rank + 1) * frames, t)] += 1
    assert (seen == 1).all()
    assert cl in norms._CLUSTERS and g % gb == 0
    assert norms.cta_smem_bytes(frames, w, gb, dtype) <= norms._SMEM_LIMIT
    # every block's channels start on a 16-byte boundary and are whole 16-byte chunks
    assert all((blk * w * esize) % 16 == 0 for blk in range(g // gb)) and (w * esize) % 16 == 0
    assert (w * esize) // 16 <= norms._GN_THREADS


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("c,g", _WIDTHS)
@pytest.mark.parametrize("t", [1, 37, 600, 1800, 3600, 4096])
@pytest.mark.parametrize("b", [1, 2, 16, 128])
def test_group_norm_cluster_plan(b, t, c, g, dtype):
    """One launch up to the threshold; slices cover T once, shared memory
    within the opt-in limit, 16-byte channel runs, an allowed cluster;
    batch-2 rows from 37 frames put >= 64 CTAs on the card (the per-plan
    times on an H100 chose 64 CTAs in clusters over 128, PERF.md), and the
    eval batches (16 and 128) take clusters of 1 with >= 128 CTAs."""
    plan = norms.group_norm_plan(b, t, c, g, dtype)
    assert plan.route == "cuda" and plan.chunks == 1 and plan.frames == -(-t // plan.cluster)
    assert (plan.groups, plan.cluster) in norms.cluster_plans(t, c, g, dtype)
    _check_one_launch(b, t, c, g, dtype, plan.groups, plan.cluster)
    ctas = b * (g // plan.groups) * plan.cluster
    if b == 2 and t >= 37:
        assert ctas >= norms._CLUSTER_CTAS
    if b >= 16 and c in (192, 384):
        assert plan.cluster == 1 and ctas >= norms._FILL_CTAS


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("c,g", _WIDTHS)
@pytest.mark.parametrize("t", [1, 600, 4096, 21600])
def test_group_norm_cluster_plans_are_valid(t, c, g, dtype):
    """Every plan the kernel takes (the card tests force each) meets the
    same constraints."""
    plans = norms.cluster_plans(t, c, g, dtype)
    assert plans
    for gb, cl in plans:
        _check_one_launch(2, t, c, g, dtype, gb, cl)


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("shape,g", [((2, 4097, 192), 32), ((2, 21600, 192), 32), ((1, 31999, 512), 512),
                                     ((8, 27305, 512), 512), ((1, 204799, 512), 512)])
def test_group_norm_plan_splits_past_the_threshold(shape, g, dtype):
    b, t, c = shape
    assert t > norms._SPLIT_MIN_T
    plan = norms.group_norm_plan(b, t, c, g, dtype)
    assert plan.route == "triton" and plan.chunks > 1 and plan.frames % 128 == 0
    assert (plan.chunks - 1) * plan.frames < t <= plan.chunks * plan.frames


def test_group_norm_plan_splits_what_the_kernel_cannot_take():
    """C = 6 in f32: 24-byte rows, no 16-byte channel run; the split."""
    assert norms.cluster_plans(600, 6, 3, torch.float32) == ()
    assert norms.group_norm_plan(2, 600, 6, 3, torch.float32).route == "triton"
