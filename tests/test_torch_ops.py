"""The port's ops (plain twins, on the CPU) against the JAX package.

Inputs are made from a seed with numpy and go through both the JAX
function — its Pallas kernel in interpret mode where it has one, as the
JAX package's own tests run it — and the port's counterpart, in float32.
Bounds for single ops: atol 1e-5, rtol 1e-5 (summation order is the only
difference); band tables and timestep grids must be equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from said_tpu.diffusion import schedule as jsched
from said_tpu.ops import masks as jmasks
from said_tpu.ops.attention import banded_attention_cached as j_banded_cached
from said_tpu.ops.attention import multi_head_attention as j_mha
from said_tpu.ops import pallas_norms
from said_tpu.ops.norms import _group_norm_jnp, _group_norm_masked_jnp, _layer_norm_jnp
from said_tpu.ops.pallas_attention import _dense_reference
from said_tpu.ops.pallas_conv import _strided_conv_gelu_jnp, strided_conv_gelu_pallas
from said_tpu.ops.pallas_ffn import geglu_ffn_pallas
from said_tpu.ops.pallas_norms import (
    group_norm_masked_pallas,
    group_norm_masked_pallas_blocked,
    group_norm_pallas,
    layer_norm_pallas,
)
from said_tpu.ops.resample import linear_interp_time as j_interp
from said_tpu.ops.resample import linear_interp_time_dynamic as j_interp_dynamic
from said_tpu_torch.diffusion import schedule as tsched
from said_tpu_torch.ops import attention, conv, ffn, masks, norms, resample

TOL = dict(atol=1e-5, rtol=1e-5)


def _rand(shape, seed, scale=1.0, offset=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale + offset).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(tol or TOL))


# ------------------------------------------------------------------ norms


@pytest.mark.parametrize("act", ["none", "silu"])
@pytest.mark.parametrize("shape,groups", [((2, 96, 192), 32), ((1, 100, 512), 512)])
def test_group_norm_matches_jax(shape, groups, act):
    c = shape[-1]
    x, w, b = _rand(shape, 0, 3.0, 1.5), _rand((c,), 1), _rand((c,), 2)
    got = norms.group_norm(_t(x), groups, _t(w), _t(b), 1e-5, act).numpy()
    kernel = group_norm_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), groups, 1e-5, act, interpret=True)
    _close(got, kernel)
    _close(got, _group_norm_jnp(jnp.asarray(x), groups, jnp.asarray(w), jnp.asarray(b), 1e-5, act))


def test_group_norm_eps_1e6_matches_jax():
    """The spatial transformer's norm: eps 1e-6, no activation."""
    x, w, b = _rand((2, 64, 192), 3, 0.01), _rand((192,), 4), _rand((192,), 5)
    got = norms.group_norm_plain(_t(x), 32, _t(w), _t(b), 1e-6).numpy()
    _close(got, group_norm_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 32, 1e-6, interpret=True))


_MASKED_CASES = [
    ((2, 96, 192), 32, [60, 96], 1e-5, "silu"),
    ((2, 96, 192), 32, [37, 96], 1e-6, "none"),
    ((2, 100, 512), 512, [77, 41], 1e-5, "none"),
    ((2, 96, 512), 512, [96, 50], 1e-5, "silu"),
]


@pytest.mark.parametrize("shape,groups,lens,eps,act", _MASKED_CASES)
def test_group_norm_masked_matches_jax(shape, groups, lens, eps, act, monkeypatch):
    """The plain twin against ``_group_norm_masked_jnp``, K4 and (where T
    is a multiple of 8) K6 in interpret mode, on whole tensors (padded
    rows included); K6 cut into 32-frame blocks so its Chan combine runs."""
    c, t = shape[-1], shape[1]
    x, w, b = _rand(shape, 40, 3.0, 1.5), _rand((c,), 41), _rand((c,), 42)
    lengths = np.array(lens, np.int32)
    mask = jnp.asarray(np.arange(t)[None, :] < lengths[:, None])
    got = norms.group_norm_masked(_t(x), groups, _t(w), _t(b), _t(lengths), eps, act).numpy()
    jx, jw, jb = jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)
    _close(got, _group_norm_masked_jnp(jx, groups, jw, jb, mask, eps, act))
    _close(got, group_norm_masked_pallas(jx, jw, jb, mask, groups, eps, act, interpret=True))
    if t % 8 == 0:
        monkeypatch.setattr(pallas_norms, "_MAX_TC_VMEM", 32 * c)
        assert pallas_norms._t_block(t, c) == 32
        _close(got, group_norm_masked_pallas_blocked(jx, jw, jb, mask, groups, eps, act, interpret=True))
    # real frames equal the unmasked norm of the unpadded row
    for i, n in enumerate(lens):
        _close(got[i, :n], norms.group_norm_plain(_t(x[i : i + 1, :n]), groups, _t(w), _t(b), eps, act)[0].numpy())


def test_group_norm_masked_full_length_is_group_norm():
    x, w, b = _rand((3, 40, 192), 43, 2.0), _rand((192,), 44), _rand((192,), 45)
    full = torch.full((3,), 40, dtype=torch.int32)
    got = norms.group_norm_masked_plain(_t(x), 32, _t(w), _t(b), full, 1e-5, "silu")
    _close(got.numpy(), norms.group_norm_plain(_t(x), 32, _t(w), _t(b), 1e-5, "silu").numpy())


def test_group_norm_masked_length_zero_is_finite():
    """Length 0 never reaches the norm from the pipeline; the count clamp
    keeps the twin (and the kernel) from dividing by zero."""
    x = _rand((1, 8, 192), 46)
    got = norms.group_norm_masked_plain(_t(x), 32, torch.ones(192), torch.zeros(192), torch.zeros(1, dtype=torch.int32))
    assert torch.isfinite(got).all()


# (shape, groups, lengths or None, chunk frames, act); x has mean 30 and
# std 2, the data the card's kernel checks use to expose cancellation. An
# f32 ulp at 30 is 1.9e-6, which two summation orders place differently in
# the mean: after dividing by std 2 and scaling by |w| <= 4 that is up to
# ~2e-5 of difference between any two correct versions, hence atol 4e-5.
_CHUNKED_TOL = dict(atol=4e-5, rtol=1e-5)
_CHUNKED_CASES = [
    ((2, 96, 192), 32, None, 32, "silu"),      # chunks divide T
    ((2, 100, 192), 32, None, 32, "none"),     # they do not: the last chunk holds 4 frames
    ((1, 96, 512), 512, None, 40, "none"),
    ((2, 96, 192), 32, [60, 1], 32, "silu"),   # chunks 2 and 3 wholly past 60; a length-1 row
    ((3, 100, 512), 512, [100, 33, 1], 16, "none"),
    ((2, 96, 512), 512, [96, 31], 32, "silu"),
]


@pytest.mark.parametrize("shape,groups,lens,chunk_t,act", _CHUNKED_CASES)
def test_group_norm_chunked_matches_plain_and_jax(shape, groups, lens, chunk_t, act, monkeypatch):
    """The split kernel's arithmetic (per-chunk count, sum and M2, then a
    fixed-order Chan combine) against the one-pass twins and, in interpret
    mode, against K5 / K6 cut into 32-frame blocks where T is a multiple of
    8 (their blocks must divide T), else against K3 / K4."""
    b, t, c = shape
    x, w, bias = _rand(shape, 60, 2.0, 30.0), _rand((c,), 61), _rand((c,), 62)
    lengths = None if lens is None else np.array(lens, np.int32)
    got = norms.group_norm_chunked_plain(_t(x), groups, _t(w), _t(bias), 1e-5, act,
                                         None if lengths is None else _t(lengths), chunk_t).numpy()
    jx, jw, jb = jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias)
    blocked = t % 8 == 0
    if blocked:
        monkeypatch.setattr(pallas_norms, "_MAX_TC_VMEM", 32 * c)
    if lengths is None:
        tpu = pallas_norms.group_norm_pallas_blocked if blocked else group_norm_pallas
        want = [norms.group_norm_plain(_t(x), groups, _t(w), _t(bias), 1e-5, act).numpy(),
                tpu(jx, jw, jb, groups, 1e-5, act, interpret=True)]
    else:
        tpu = group_norm_masked_pallas_blocked if blocked else group_norm_masked_pallas
        mask = jnp.asarray(np.arange(t)[None, :] < lengths[:, None])
        want = [norms.group_norm_masked_plain(_t(x), groups, _t(w), _t(bias), _t(lengths), 1e-5, act).numpy(),
                tpu(jx, jw, jb, mask, groups, 1e-5, act, interpret=True)]
    for ref in want:
        _close(got, ref, **_CHUNKED_TOL)


def test_group_norm_chunked_single_chunk_is_group_norm():
    """One chunk over the whole row is the two-pass twin up to rounding."""
    x, w, bias = _rand((2, 50, 192), 63, 2.0, 30.0), _rand((192,), 64), _rand((192,), 65)
    got = norms.group_norm_chunked_plain(_t(x), 32, _t(w), _t(bias), chunk_t=50)
    _close(got.numpy(), norms.group_norm_plain(_t(x), 32, _t(w), _t(bias)).numpy(), **_CHUNKED_TOL)


@pytest.mark.parametrize(
    "shape,groups,split",
    [((2, 600, 192), 32, False), ((16, 512, 192), 32, False), ((2, 37, 192), 32, False),
     ((2, 3600, 192), 32, False), ((1, 31999, 512), 512, True), ((1, 204799, 512), 512, True),
     ((8, 27305, 512), 512, True), ((2, 3840, 192), 32, False), ((2, 4097, 192), 32, True),
     ((2, 21600, 192), 32, True)],
)
def test_group_norm_plan(shape, groups, split):
    """One launch of the CUDA kernel up to 4096 frames (the UNet up to a
    bucketed 60-s clip); otherwise the split, chunks of whole 128-frame
    tiles, enough of them for about 1024 programs and no more."""
    b, t, c = shape
    plan = norms.group_norm_plan(b, t, c, groups)
    if not split:
        assert plan.route == "cuda" and plan.chunks == 1 and plan.cluster * plan.frames >= t
        return
    n_chunks, chunk_t = plan.chunks, plan.frames
    assert plan.route == "triton" and n_chunks > 1 and chunk_t % 128 == 0
    assert (n_chunks - 1) * chunk_t < t <= n_chunks * chunk_t  # no empty chunk
    n_gblocks = norms._group_geometry(c, groups)[3]
    assert 256 <= b * n_gblocks * n_chunks <= 1024 + b * n_gblocks


@pytest.mark.parametrize("shape", [(2, 96, 192), (1, 50, 768), (1, 37, 512)])
def test_layer_norm_matches_jax(shape):
    c = shape[-1]
    x, w, b = _rand(shape, 6, 2.0, -0.5), _rand((c,), 7), _rand((c,), 8)
    got = norms.layer_norm(_t(x), _t(w), _t(b)).numpy()
    _close(got, layer_norm_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), interpret=True))
    _close(got, _layer_norm_jnp(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))


@pytest.mark.parametrize("c", [192, 512, 768, 33])
@pytest.mark.parametrize("offset", [-0.5, 30.0])
def test_layer_norm_lanes_plain_matches_jax(c, offset):
    """The LayerNorm kernel's reduction order (lanes a row, each adding its
    elements in order, then an xor butterfly) against the JAX reference, at
    the vector route's widths and the scalar route's 33, and at inputs of
    mean 30 (there at _CHUNKED_TOL: the shipped twin differs from JAX by
    up to 1.6e-5 too)."""
    x, w, b = _rand((2, 37, c), 6, 2.0, offset), _rand((c,), 7), _rand((c,), 8)
    got = norms.layer_norm_lanes_plain(_t(x), _t(w), _t(b)).numpy()
    want = _layer_norm_jnp(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    _close(got, want, **(_CHUNKED_TOL if offset > 1 else TOL))


@pytest.mark.parametrize("rows,c,f32_plan,bf16_plan", [
    (1200, 192, ("vector", 16, 3, 4, 300), ("vector", 8, 3, 4, 300)),          # the UNet at 10 s (batch 2)
    (7200, 192, ("vector", 16, 3, 8, 900), ("vector", 8, 3, 16, 450)),         # 60 s
    (43200, 192, ("vector", 16, 3, 8, 5400), ("vector", 8, 3, 16, 2700)),      # 6 min
    (600, 512, ("vector", 32, 4, 2, 300), ("vector", 16, 4, 2, 300)),          # feature projection, 10 s
    (2999, 768, ("vector", 32, 6, 4, 750), ("vector", 32, 3, 4, 750)),         # encoder layers, 50 s
    (17999, 768, ("vector", 32, 6, 4, 4500), ("vector", 32, 3, 4, 4500)),      # 5 min
    (48, 16, ("vector", 1, 4, 32, 2), ("vector", 1, 2, 32, 2)),                # the tiny encoder's C = 16
    (37, 33, ("scalar", 16, 3, 2, 19), ("scalar", 16, 3, 2, 19)),              # no whole 16-byte vectors
    (7, 2048, ("scalar", 32, 64, 1, 7), ("vector", 32, 8, 1, 7)),             # past 8 vectors a lane (f32)
])
def test_layer_norm_plan(rows, c, f32_plan, bf16_plan):
    """Lanes a row hold at most 4 vectors where 32 lanes allow it (16 × 3
    float4 at C = 192 f32, 8 × 3 in bf16, 32 × 4 at 512, 32 × 6 at 768);
    blocks are halved until the launch has 2 × 132 of them where the rows
    allow it; a block is at least a warp and at most 128 threads."""
    for dtype, want in ((torch.float32, f32_plan), (torch.bfloat16, bf16_plan)):
        plan = norms.layer_norm_plan(rows, c, dtype)
        assert tuple(plan) == want
        assert plan.lanes * plan.chunks * (16 // (torch.finfo(dtype).bits // 8) if plan.route == "vector" else 1) >= c
        assert 32 <= plan.lanes * plan.rows <= 128 and plan.blocks == -(-rows // plan.rows)
        assert plan.blocks >= 2 * 132 or plan.lanes * plan.rows == 32


def test_layer_norm_forced_plan():
    """A forced plan keeps the shape's route and takes any lanes and rows a
    block the kernel takes (whole warps, at most 256 threads, at most 8
    vectors a lane); it refuses the rest."""
    assert tuple(norms.layer_norm_forced_plan(1200, 192, torch.float32, 8, 16)) == ("vector", 8, 6, 16, 75)
    assert tuple(norms.layer_norm_forced_plan(37, 33, torch.bfloat16, 32, 1)) == ("scalar", 32, 2, 1, 37)
    for lanes, per_block in ((2, 16), (16, 1), (16, 32), (3, 32), (1, 16)):
        with pytest.raises(ValueError, match="not taken"):
            norms.layer_norm_forced_plan(1200, 192, torch.float32, lanes, per_block)


# -------------------------------------------------------------------- ffn


@pytest.mark.parametrize("rows", [64, 600])  # 600: the 10-s clip, CFG-folded to batch 2
def test_geglu_ffn_matches_jax(rows):
    c, inner = 192, 768
    x = _rand((2, rows, c), 9)
    w1, b1 = _rand((c, 2 * inner), 10, 0.05), _rand((2 * inner,), 11, 0.1)
    w2, b2 = _rand((inner, c), 12, 0.05), _rand((c,), 13, 0.1)
    want = geglu_ffn_pallas(*map(jnp.asarray, (x, w1, b1, w2, b2)), interpret=True)
    # the port takes the torch nn.Linear layout: w1 (2I, C), w2 (C, I)
    got = ffn.geglu_ffn(_t(x), _t(w1.T), _t(b1), _t(w2.T), _t(b2)).numpy()
    _close(got, want)


@pytest.mark.parametrize("m,f32_plan,bf16_plan", [
    (1200, (64, 4), (64, 4)),     # 10 s, CFG-folded: 19 row tiles of 64
    (7200, (64, 1), (128, 2)),    # 60 s: 113 row tiles of 64, 57 of 128
    (8192, (64, 1), (128, 2)),    # the eval call, 16 x 512
    (43200, (64, 2), (128, 1)),   # 6 min: 675 / 338 row tiles
    (65536, (64, 1), (128, 1)),
])
def test_geglu_plan(m, f32_plan, bf16_plan):
    """The plan of least modelled time (waves x chunk time) at the main
    path's row counts. From 1200 to 43200 rows each is also the fastest
    plan measured on an H100 (chip_smoke.py phase 2 times every plan)."""
    assert ffn.geglu_plan(m, torch.float32) == f32_plan
    assert ffn.geglu_plan(m, torch.bfloat16) == bf16_plan
    assert f32_plan in ffn.PLANS[torch.float32] and bf16_plan in ffn.PLANS[torch.bfloat16]


def _tf32(x):
    """x masked to tf32: the low 13 of f32's 23 mantissa bits cleared, as
    the kernel's split does."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_tf32(a, b, passes):
    """a @ b from tf32 operands: one pass, or 3xTF32 (hi = tf32(x), lo =
    tf32(x − hi), hi·hi + hi·lo + lo·hi; each tf32 product is exact in
    f32)."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _geglu_emulated(x, w1, b1, w2, b2, passes):
    """The f32 kernel's arithmetic: the first product over all of C, the
    gate in f32, the second product per chunk of 32 inner units, the
    chunks joined by f32 adds."""
    a, g = (_mm_tf32(x, w1.t(), passes) + b1).chunk(2, dim=-1)
    y = a * torch.nn.functional.gelu(g)
    out = b2.expand(x.shape[0], -1).clone()
    for c0 in range(0, y.shape[-1], 32):
        out += _mm_tf32(y[:, c0:c0 + 32], w2[:, c0:c0 + 32].t(), passes)
    return out


def test_geglu_3xtf32_holds_the_f32_bound():
    """The card's f32 route runs both products as 3xTF32. Emulated on the
    CPU at the main path's width and rows, it lands within 1e-5 of max
    |plain|, ten times inside the kernel's f32 bound; single-pass TF32
    does not hold the bound."""
    x = _t(_rand((1200, 192), 20))
    w1, b1 = _t(_rand((1536, 192), 21, 0.05)), _t(_rand((1536,), 22, 0.1))
    w2, b2 = _t(_rand((192, 768), 23, 0.05)), _t(_rand((192,), 24, 0.1))
    ref = ffn.geglu_ffn_plain(x, w1, b1, w2, b2)
    bound = 1e-4 * ref.abs().max().item()
    err3 = (_geglu_emulated(x, w1, b1, w2, b2, 3) - ref).abs().max().item()
    err1 = (_geglu_emulated(x, w1, b1, w2, b2, 1) - ref).abs().max().item()
    assert err3 <= bound / 10, f"3xTF32: {err3:.3g} > {bound / 10:.3g}"
    assert err1 > bound, f"single-pass TF32: {err1:.3g} <= {bound:.3g}"


# ------------------------------------------------------------------- conv


@pytest.mark.parametrize("k,t_in", [(3, 70), (2, 64), (3, 8)])
def test_strided_conv_gelu_matches_jax(k, t_in):
    x, w = _rand((2, t_in, 128), 14), _rand((k, 128, 128), 15, 0.05)
    got = conv.strided_conv_gelu(_t(x), _t(w)).numpy()
    _close(got, strided_conv_gelu_pallas(jnp.asarray(x), jnp.asarray(w), interpret=True))
    _close(got, _strided_conv_gelu_jnp(jnp.asarray(x), jnp.asarray(w)))


def _conv_emulated(x, kernel, passes):
    """The f32 tensor-core conv's arithmetic: A = the pair matrix X2 (x as
    (B, T_in/2, 2·C_in), a half pair zero-padded) taken as X2[:, t] ++
    X2[:, t+1, :C_in] (K = 3) or X2[:, t] (K = 2), i.e. the window x[b, 2t :
    2t+K]; Wt the kernel packed (C_out, K·C_in). ``conv_plan``'s split
    cuts the contraction's stages among a cluster's ranks; each rank runs
    its k-steps of 8 in order, adding lo·hi, hi·lo, hi·hi (3xTF32) or hi·hi
    (one pass) to one f32 accumulator; the ranks' partial sums are added in
    rank order; GELU in f32."""
    b, t_in, c_in = x.shape
    k, _, c_out = kernel.shape
    t_out = (t_in - k) // 2 + 1
    x2 = torch.nn.functional.pad(x, (0, 0, 0, t_in % 2)).reshape(b, -1, 2 * c_in)
    a = x2[:, :t_out] if k == 2 else torch.cat([x2[:, :t_out], x2[:, 1 : t_out + 1, :c_in]], dim=-1)
    a = a.reshape(b * t_out, k * c_in)
    wt = kernel.permute(2, 0, 1).reshape(c_out, k * c_in)
    plan = conv.conv_plan(b * t_out, c_in, c_out, torch.float32)
    stages = k * c_in // plan.tile_k
    total = torch.zeros((b * t_out, c_out))
    for rank in range(plan.split):
        acc = torch.zeros((b * t_out, c_out))
        for k0 in range(rank * stages // plan.split * plan.tile_k, (rank + 1) * stages // plan.split * plan.tile_k, 8):
            a8, w8 = a[:, k0 : k0 + 8], wt[:, k0 : k0 + 8]
            ah, wh = _tf32(a8), _tf32(w8)
            if passes == 3:
                acc = acc + _tf32(a8 - ah) @ wh.t()
                acc = acc + ah @ _tf32(w8 - wh).t()
            acc = acc + ah @ wh.t()
        total = total + acc
    return conv.gelu_f32(total).reshape(b, t_out, c_out)


@pytest.mark.parametrize("k,t_in", [(3, 70), (2, 64)])
def test_strided_conv_3xtf32_holds_the_f32_bound(k, t_in):
    """The card's f32 conv route runs as 3xTF32 over the pair matrix in
    k-steps of 8 (here in one tile whose contraction a cluster of 8
    splits). Emulated on the CPU it lands within 1e-5 of max |JAX|,
    against the JAX twin and K9 in interpret mode, ten times inside the
    kernel's f32 bound; single-pass TF32 does not hold the bound."""
    x, w = _rand((2, t_in, 128), 16), _rand((k, 128, 128), 17, 0.05)
    assert conv.conv_plan(2 * ((t_in - k) // 2 + 1), 128, 128).split == 8
    for want in (_strided_conv_gelu_jnp(jnp.asarray(x), jnp.asarray(w)),
                 strided_conv_gelu_pallas(jnp.asarray(x), jnp.asarray(w), interpret=True)):
        want = torch.from_numpy(np.array(want))
        bound = 1e-4 * want.abs().max().item()
        err3 = (_conv_emulated(_t(x), _t(w), 3) - want).abs().max().item()
        err1 = (_conv_emulated(_t(x), _t(w), 1) - want).abs().max().item()
        assert err3 <= bound / 10, f"3xTF32: {err3:.3g} > {bound / 10:.3g}"
        assert err1 > bound, f"single-pass TF32: {err1:.3g} <= {bound:.3g}"


@pytest.mark.parametrize("t_in,k,dtype,plan", [
    (31999, 3, torch.float32, ("tensor_cores", 128, 128, 16, 4, 1, 500)),   # conv_1 of a 10-s clip
    (15999, 3, torch.float32, ("tensor_cores", 128, 128, 16, 4, 1, 252)),
    (7999, 3, torch.float32, ("tensor_cores", 128, 128, 16, 4, 1, 128)),
    (3999, 3, torch.float32, ("tensor_cores", 128, 128, 16, 4, 2, 128)),
    (1999, 2, torch.float32, ("tensor_cores", 128, 128, 16, 4, 4, 128)),
    (999, 2, torch.float32, ("tensor_cores", 128, 128, 16, 4, 8, 128)),     # conv_6: 16 tiles
    (191999, 3, torch.float32, ("tensor_cores", 128, 128, 16, 4, 1, 3000)),  # conv_1 of a 60-s clip
    (31999, 3, torch.bfloat16, ("tensor_cores", 128, 128, 64, 3, 1, 500)),
    (999, 2, torch.bfloat16, ("tensor_cores", 128, 128, 64, 3, 8, 128)),
])
def test_conv_plan(t_in, k, dtype, plan):
    """At 512 -> 512 channels every conv of the path runs on the tensor
    cores in 128×128 tiles (4 across C_out), bf16 in stages of 64
    contraction columns (3 stages), f32 in stages of 16 (4); where the
    tiles number fewer than 128, a cluster of 2–8 blocks splits each
    tile's contraction so that about one block an SM runs."""
    assert tuple(conv.conv_plan((t_in - k) // 2 + 1, 512, 512, dtype)) == plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_plan_tiny_width_takes_the_fma_route(dtype):
    """The tiny test encoder (``Wav2Vec2Config.tiny``: 16 channels) is no
    whole tile: its convs run on the FMA pipes in 64×64 tiles."""
    assert tuple(conv.conv_plan(2 * 399, 16, 16, dtype)) == ("fma", 64, 64, 16, 1, 1, 13)
    assert conv.conv_plan(100, 96, 512, dtype).route == "fma" and conv.conv_plan(100, 512, 192, dtype).route == "fma"


def test_conv_weight_is_packed_once():
    """The conv layer keeps its weight packed for the kernel (C_out, K,
    C_in in memory), derived once where no gradient is recorded (the
    frozen encoder runs under no_grad): two calls get the same tensor, and
    the (K, C_in, C_out) view it passes equals the flax layout. Where a
    gradient is recorded it is derived anew, with autograd."""
    from said_tpu_torch.models.wav2vec2 import _ConvLayer

    layer = _ConvLayer(16, 32, 3, 2, False, False, 1e-5)
    with torch.no_grad():
        packed = layer._w(layer.conv.weight, torch.float32)
        assert packed is layer._w(layer.conv.weight, torch.float32)
    tracked = layer._w(layer.conv.weight, torch.float32)
    assert tracked.grad_fn is not None and tracked is not layer._w(layer.conv.weight, torch.float32)
    assert torch.equal(tracked, packed)
    view = packed.permute(1, 2, 0)
    assert conv.is_packed(view) and not conv.is_packed(view.contiguous())
    assert torch.equal(view, layer.conv.weight.detach().permute(2, 1, 0))
    assert torch.equal(conv.pack_weight(view.contiguous()), view)


def test_kernel_wrappers_refuse_non_cuda_tensors():
    """No router falls back: a non-CPU, non-CUDA tensor reaches the kernel
    wrapper, which raises, and no launch is counted."""
    x = torch.empty((2, 8, 192), device="meta")
    w = torch.empty((192,), device="meta")
    lens = torch.full((2,), 8, dtype=torch.int32, device="meta")
    before = (norms.layer_norm_kernel.launches, norms.group_norm_kernel.launches,
              norms.group_norm_masked_kernel.launches,
              ffn.geglu_ffn_kernel.launches, conv.strided_conv_gelu_kernel.launches)
    with pytest.raises(ValueError, match="CUDA"):
        norms.layer_norm(x, w, w)
    with pytest.raises(ValueError, match="CUDA"):
        norms.group_norm(x, 32, w, w)
    with pytest.raises(ValueError, match="CUDA"):
        norms.group_norm_masked(x, 32, w, w, lens)
    with pytest.raises(ValueError, match="CUDA"):
        ffn.geglu_ffn(x, torch.empty((1536, 192), device="meta"), torch.empty(1536, device="meta"),
                      torch.empty((192, 768), device="meta"), w)
    with pytest.raises(ValueError, match="CUDA"):
        conv.strided_conv_gelu(x, torch.empty((3, 192, 192), device="meta"))
    after = (norms.layer_norm_kernel.launches, norms.group_norm_kernel.launches,
             norms.group_norm_masked_kernel.launches,
             ffn.geglu_ffn_kernel.launches, conv.strided_conv_gelu_kernel.launches)
    assert after == before


# -------------------------------------------------------------- attention


def test_banded_attention_cached_matches_jax():
    b, t, s, h, d = 2, 24, 24, 6, 32
    idx, valid, w = masks.band_gather_indices(t, s)
    q = _rand((b, t, h * d), 16)
    k_win, v_win = _rand((b, t, w, h, d), 17), _rand((b, t, w, h, d), 18)
    got = attention.banded_attention_cached(_t(q), _t(k_win), _t(v_win), _t(valid), h).numpy()
    want = j_banded_cached(jnp.asarray(q), jnp.asarray(k_win), jnp.asarray(v_win), jnp.asarray(valid), h)
    _close(got, want)


@pytest.mark.parametrize("t,s,h", [(40, 40, 6), (33, 17, 2)])
def test_dense_attention_matches_jax(t, s, h):
    q, k, v = _rand((2, t, h * 32), 19), _rand((2, s, h * 32), 20), _rand((2, s, h * 32), 21)
    got = attention.dense_attention(_t(q), _t(k), _t(v), h).numpy()
    _close(got, j_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h))


def test_banded_attention_cached_per_row_band_matches_jax():
    b, t, h, d = 2, 32, 6, 32
    idx, valid = masks.alignment_band_dynamic(t, t, np.array([20, 32]), np.array([20, 32]))
    w = idx.shape[-1]
    q = _rand((b, t, h * d), 47)
    k_win, v_win = _rand((b, t, w, h, d), 48), _rand((b, t, w, h, d), 49)
    got = attention.banded_attention_cached(_t(q), _t(k_win), _t(v_win), _t(valid), h).numpy()
    want = j_banded_cached(jnp.asarray(q), jnp.asarray(k_win), jnp.asarray(v_win), jnp.asarray(valid), h)
    _close(got, want)


def test_dense_attention_with_lengths_matches_jax():
    b, t, h, d = 3, 40, 2, 32
    q, k, v = _rand((b, t, h * d), 50), _rand((b, t, h * d), 51), _rand((b, t, h * d), 52)
    lengths = np.array([40, 17, 1], np.int32)
    got = attention.self_attention(_t(q), _t(k), _t(v), h, _t(lengths)).numpy()
    want = _dense_reference(*(jnp.asarray(a).reshape(b, t, h, d) for a in (q, k, v)), lengths=jnp.asarray(lengths))
    _close(got, np.asarray(want).reshape(b, t, h * d))


def test_self_attention_router_caps_non_cpu_length():
    """Above DENSE_MAX a tensor on neither the CPU nor CUDA reaches the
    flash kernel's wrapper, which raises before any launch is counted;
    the CPU takes the plain flash version; up to DENSE_MAX every device
    takes the dense path."""
    n = attention.DENSE_MAX + 1
    meta = torch.empty((1, n, 192), device="meta")
    before = attention.flash_attention_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        attention.self_attention(meta, meta, meta, 6)
    assert attention.flash_attention_kernel.launches == before
    short = torch.empty((1, attention.DENSE_MAX, 192), device="meta")
    assert attention.self_attention(short, short, short, 6).shape == short.shape
    q, k, v = (_t(_rand((1, n, 2 * 32), 30 + i)) for i in range(3))
    got = attention.self_attention(q, k, v, 2)
    _close(got, attention.flash_attention_plain(q, k, v, 2), atol=0, rtol=0)
    _close(got, attention.dense_attention(q, k, v, 2))


# -------------------------------------------------- band tables, resample


@pytest.mark.parametrize("x_len,c_len", [(24, 24), (600, 600), (37, 91), (100, 49), (7, 1)])
def test_band_tables_equal_jax(x_len, c_len):
    for got, want in zip(masks.alignment_band(x_len, c_len), jmasks.alignment_band(x_len, c_len)):
        np.testing.assert_array_equal(got, want)
    got, want = masks.band_gather_indices(x_len, c_len), jmasks.band_gather_indices(x_len, c_len)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


@pytest.mark.parametrize(
    "x_pad,c_pad,x_real,c_real",
    [(32, 32, 20, 20), (512, 512, 258, 258), (3840, 3840, 3600, 3600), (37, 91, 30, 80),
     (48, 48, [18, 26, 48], [18, 26, 48]), (100, 49, [7, 99], [3, 40])],
)
def test_dynamic_band_equals_jax(x_pad, c_pad, x_real, c_real):
    """Exactly JAX's table, for one length and for (B,) lengths."""
    got = masks.alignment_band_dynamic(x_pad, c_pad, np.asarray(x_real), np.asarray(c_real))
    want = jmasks.alignment_band_dynamic(x_pad, c_pad, np.asarray(x_real), np.asarray(c_real))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[0].shape[-1] == -(-c_pad // x_pad) + 3


@pytest.mark.parametrize(
    "out_pad,in_real,out_real",
    [(80, 37, 60), (80, [37, 50, 12], [60, 80, 20]), (512, 49, 258), (64, 50, 1)],
)
def test_linear_interp_time_dynamic_matches_jax(out_pad, in_real, out_real):
    x = _rand((3, 50, 16), 53)
    got = resample.linear_interp_time_dynamic(_t(x), out_pad, np.asarray(in_real), np.asarray(out_real)).numpy()
    want = j_interp_dynamic(jnp.asarray(x), out_pad, np.asarray(in_real), np.asarray(out_real))
    _close(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("t,out_len", [(19, 24), (50, 30), (12, 12), (9, 1), (1999, 600)])
def test_linear_interp_time_matches_jax(t, out_len):
    x = _rand((2, t, 16), 22)
    _close(resample.linear_interp_time(_t(x), out_len).numpy(), j_interp(jnp.asarray(x), out_len))


# --------------------------------------------------------------- schedule


def test_schedule_tables_equal_jax():
    js, ts = jsched.DiffusionSchedule.create(1000), tsched.DiffusionSchedule.create(1000)
    np.testing.assert_array_equal(ts.alphas_cumprod, np.asarray(js.alphas_cumprod))
    for n in (1000, 100, 20, 7):
        np.testing.assert_array_equal(tsched.inference_timesteps(1000, n), jsched.inference_timesteps(1000, n))


@pytest.mark.parametrize("t", [999, 500, 3])
def test_add_noise_matches_jax(t):
    js, ts = jsched.DiffusionSchedule.create(), tsched.DiffusionSchedule.create()
    x, n = _rand((2, 24, 32), 23), _rand((2, 24, 32), 24)
    got = ts.add_noise(_t(x), _t(n), t).numpy()
    _close(got, js.add_noise(jnp.asarray(x), jnp.asarray(n), jnp.asarray(t)))


@pytest.mark.parametrize("pred", ["epsilon", "sample", "v_prediction"])
@pytest.mark.parametrize("eta", [0.0, 0.5])
@pytest.mark.parametrize("t,n", [(999, 20), (450, 20), (0, 20), (10, 100)])
def test_ddim_step_matches_jax(pred, eta, t, n):
    js = jsched.DiffusionSchedule.create(prediction_type=pred)
    ts = tsched.DiffusionSchedule.create(prediction_type=pred)
    out, x, noise = _rand((2, 24, 32), 25), _rand((2, 24, 32), 26), _rand((2, 24, 32), 27)
    got = tsched.ddim_step(ts, _t(out), t, _t(x), n, eta=eta, noise=_t(noise)).numpy()
    want = jsched.ddim_step(js, jnp.asarray(out), jnp.asarray(t), jnp.asarray(x), n, eta=eta,
                            noise=jnp.asarray(noise))
    _close(got, want)
    alpha = ts.alpha(t)
    _close(tsched.pred_x0_from_model_output(ts, _t(out), alpha, _t(x)).numpy(),
           jsched.pred_x0_from_model_output(js, jnp.asarray(out), jnp.asarray(alpha.numpy()), jnp.asarray(x)))


@pytest.mark.parametrize("scale,rescale", [(2.0, 0.0), (2.5, 0.7)])
def test_cfg_combine_matches_jax(scale, rescale):
    u, c = _rand((2, 24, 32), 28), _rand((2, 24, 32), 29, 1.3)
    got = tsched.cfg_combine(_t(u), _t(c), scale, rescale).numpy()
    _close(got, jsched.cfg_combine(jnp.asarray(u), jnp.asarray(c), scale, rescale))
    # SAiD's combination is cond + s·(cond − uncond), not uncond + s·(cond − uncond)
    if rescale == 0.0:
        _close(got, c + scale * (c - u))
