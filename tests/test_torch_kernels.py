"""The port's hand-written Hopper kernels against their plain PyTorch twins.

Needs a CUDA card: every test is marked ``gpu`` and skips without one.
This file imports neither jax nor the repo's conftest helpers, so it runs
on a machine without jax:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

Bounds (the kernels differ from the twins only in summation order and
in f32 sqrt/exp/erf rounding): max |kernel − plain| ≤ 1e-4 · max |plain|
in float32 and ≤ 2e-2 · max |plain| in bfloat16, compared in the
working type.
"""

import numpy as np
import pytest
import torch

from said_tpu_torch.ops import attention, conv, ffn, norms

pytestmark = pytest.mark.gpu

_BOUND = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
_DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, seed, dev, dtype, scale=1.0, offset=0.0):
    a = np.random.default_rng(seed).standard_normal(shape) * scale + offset
    return torch.from_numpy(a.astype(np.float32)).to(dev, dtype)


def _assert_close(got, ref, dtype):
    assert got.dtype == ref.dtype == dtype and got.shape == ref.shape
    err = (got.float() - ref.float()).abs().max().item()
    bound = _BOUND[dtype] * ref.float().abs().max().item()
    assert err <= bound, f"max abs err {err:.3g} > bound {bound:.3g}"


# LayerNorm widths: the tiny encoder's 16, a scalar-route 33, the UNet's
# 192 and 384, the encoder's 512 and 768; rows: 1, ragged, the UNet's 10-s
# and 60-s batch-2 rows, its 6-min ones
_LN_WIDTHS = [16, 33, 192, 384, 512, 768]
_LN_ROWS = [1, 37, 1200, 7200, 43200]


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("c", _LN_WIDTHS)
@pytest.mark.parametrize("rows", _LN_ROWS)
def test_layer_norm_kernel(dev, dtype, c, rows):
    x = _randn((1, rows, c), 0, dev, dtype, 2.0, 0.5)
    w = _randn((c,), 1, dev, torch.float32)
    b = _randn((c,), 2, dev, torch.float32)
    got = norms.layer_norm_kernel(x, w, b, 1e-5)
    _assert_close(got, norms.layer_norm_plain(x, w, b, 1e-5), dtype)
    assert torch.equal(got, norms.layer_norm_kernel(x, w, b, 1e-5))  # no atomics: the same bits


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("c", _LN_WIDTHS)
def test_layer_norm_kernel_follows_its_twin(dev, dtype, c):
    """The kernel against the plain twin of its own reduction order, at
    inputs of mean 30 (where a one-pass variance would lose digits)."""
    x = _randn((3, 37, c), 3, dev, dtype, 2.0, 30.0)
    w = _randn((c,), 4, dev, torch.float32)
    b = _randn((c,), 5, dev, torch.float32)
    got, want = norms.layer_norm_kernel(x, w, b, 1e-6), norms.layer_norm_lanes_plain(x, w, b, 1e-6)
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("c,rows", [(192, 1200), (768, 37), (33, 37)])
def test_layer_norm_kernel_every_plan(dev, dtype, c, rows):
    """Every (lanes a row, rows a block) the kernel takes gives the twin's
    values, the same bits over two calls."""
    x = _randn((rows, c), 7, dev, dtype, 2.0, 0.5)
    w, b = _randn((c,), 8, dev, torch.float32), _randn((c,), 9, dev, torch.float32)
    want = norms.layer_norm_plain(x, w, b, 1e-5)
    for lanes in (1, 2, 4, 8, 16, 32):
        for per_block in (1, 2, 4, 8, 16, 32, 64):
            try:
                norms.layer_norm_forced_plan(rows, c, dtype, lanes, per_block)
            except ValueError:
                continue
            got = norms.layer_norm_kernel(x, w, b, 1e-5, _plan=(lanes, per_block))
            _assert_close(got, want, dtype)
            assert torch.equal(got, norms.layer_norm_kernel(x, w, b, 1e-5, _plan=(lanes, per_block)))


def test_layer_norm_kernel_refuses_bad_input(dev):
    x = _randn((4, 192), 6, dev, torch.float32)
    w = torch.ones(192, device=dev)
    before = norms.layer_norm_kernel.launches
    with pytest.raises(TypeError, match="dtype"):
        norms.layer_norm_kernel(x.half(), w, w)
    with pytest.raises(ValueError, match="contiguous"):
        norms.layer_norm_kernel(x.t(), torch.ones(4, device=dev), torch.ones(4, device=dev))
    with pytest.raises(ValueError, match="weight/bias"):
        norms.layer_norm_kernel(x, w.to(torch.bfloat16), w)
    with pytest.raises(ValueError, match="weight/bias"):
        norms.layer_norm_kernel(x, torch.ones(191, device=dev), w)
    with pytest.raises(ValueError, match="16-byte"):
        norms.layer_norm_kernel(torch.empty(4 * 192 + 1, device=dev)[1:].view(4, 192), w, w)
    with pytest.raises(ValueError, match="C >= 1"):
        norms.layer_norm_kernel(torch.empty((4, 0), device=dev), torch.ones(0, device=dev), torch.ones(0, device=dev))
    assert norms.layer_norm_kernel.launches == before


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize(
    "shape,groups,eps,act",
    [
        ((2, 600, 192), 32, 1e-5, "silu"),
        ((2, 600, 192), 32, 1e-6, "none"),
        ((1, 31999, 512), 512, 1e-5, "none"),
        ((2, 37, 192), 32, 1e-5, "silu"),
    ],
)
def test_group_norm_kernel(dev, dtype, shape, groups, eps, act):
    c = shape[-1]
    # a mean far from 0: E[x²]−mean² would lose digits here
    x = _randn(shape, 3, dev, dtype, 2.0, 30.0)
    w = _randn((c,), 4, dev, torch.float32)
    b = _randn((c,), 5, dev, torch.float32)
    _assert_close(norms.group_norm_kernel(x, groups, w, b, eps, act),
                  norms.group_norm_plain(x, groups, w, b, eps, act), dtype)


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize(
    "shape,groups,eps,act,lengths",
    [
        ((2, 512, 192), 32, 1e-5, "silu", [430, 258]),
        ((16, 512, 192), 32, 1e-5, "silu", [156, 204, 258, 306] * 4),
        ((2, 3840, 192), 32, 1e-6, "none", [3600, 3600]),
        ((8, 27305, 512), 512, 1e-5, "none", [13759] * 4 + [16319] * 4),
        ((1, 204799, 512), 512, 1e-5, "none", [191999]),
        ((3, 37, 192), 32, 1e-5, "silu", [37, 20, 1]),
    ],
)
def test_group_norm_masked_kernel(dev, dtype, shape, groups, eps, act, lengths):
    c = shape[-1]
    x = _randn(shape, 3, dev, dtype, 2.0, 30.0)
    w = _randn((c,), 4, dev, torch.float32)
    b = _randn((c,), 5, dev, torch.float32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    _assert_close(norms.group_norm_masked_kernel(x, groups, w, b, lens, eps, act),
                  norms.group_norm_masked_plain(x, groups, w, b, lens, eps, act), dtype)


# the one-launch kernel at the main path's batch-2 shapes (both UNet
# widths, 37 frames ragged), the eval call's, the encoder's conv_0, and
# 6 min (past the threshold: its plans only forced)
_CLUSTER_SHAPES = [(2, 37, 192), (2, 600, 192), (2, 1800, 192), (2, 3600, 192), (2, 4096, 192), (2, 600, 384),
                   (2, 3600, 384), (16, 512, 192), (1, 2559, 512), (1, 12799, 512), (2, 21600, 192)]


def _gn_inputs(shape, dev, dtype, seed=3):
    c = shape[-1]
    return (_randn(shape, seed, dev, dtype, 2.0, 30.0), _randn((c,), seed + 1, dev, torch.float32),
            _randn((c,), seed + 2, dev, torch.float32))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("shape", _CLUSTER_SHAPES)
def test_group_norm_kernel_every_plan(dev, shape, dtype, masked):
    """Every plan the one-launch kernel takes, forced: against the plain
    twin and the plain version of the cluster arithmetic, and
    bit-identical over two calls."""
    b, t, c = shape
    g = 512 if c == 512 else 32
    x, w, bias = _gn_inputs(shape, dev, dtype)
    lens = torch.tensor([t, t // 3 + 1] * (b // 2) + [t] * (b % 2), dtype=torch.int32, device=dev) if masked else None
    if masked:
        ref = norms.group_norm_masked_plain(x, g, w, bias, lens, 1e-5, "silu")
    else:
        ref = norms.group_norm_plain(x, g, w, bias, 1e-5, "silu")
    plans = norms.cluster_plans(t, c, g, dtype)
    shipped = norms.group_norm_plan(b, t, c, g, dtype)
    assert shipped.route == "triton" or (shipped.groups, shipped.cluster) in plans
    for gb, cl in plans:
        if masked:
            run = lambda: norms.group_norm_masked_kernel(x, g, w, bias, lens, 1e-5, "silu", _plan=(gb, cl))  # noqa: E731
        else:
            run = lambda: norms.group_norm_kernel(x, g, w, bias, 1e-5, "silu", _plan=(gb, cl))  # noqa: E731
        got = run()
        _assert_close(got, ref, dtype)
        _assert_close(got, norms.group_norm_cluster_plain(x, g, w, bias, 1e-5, "silu", lens, cl), dtype)
        assert torch.equal(got, run()), f"plan {(gb, cl)}: two calls differ"


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("t", [1, 37, 1800, 4096])
def test_group_norm_kernel_length_edges(dev, dtype, t):
    """The shipped plan, plain and with lengths 0, 1, a CTA's slice edge
    ± 1 and T (slices wholly past a length add nothing)."""
    plan = norms.group_norm_plan(8, t, 192, 32, dtype)
    assert plan.route == "cuda"
    edge = plan.frames
    lengths = [0, 1, max(edge - 1, 0), min(edge, t), min(edge + 1, t), t, t // 2, 2 * edge + 1]
    x, w, bias = _gn_inputs((8, t, 192), dev, dtype, 30)
    _assert_close(norms.group_norm_kernel(x, 32, w, bias, 1e-6, "none"),
                  norms.group_norm_plain(x, 32, w, bias, 1e-6, "none"), dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    got = norms.group_norm_masked_kernel(x, 32, w, bias, lens, 1e-5, "silu")
    _assert_close(got, norms.group_norm_masked_plain(x, 32, w, bias, lens, 1e-5, "silu"), dtype)
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", _DTYPES)
def test_group_norm_kernel_is_deterministic(dev, dtype, masked):
    """No atomics in the one-launch kernel: two calls, the same bits."""
    x, w, bias = _gn_inputs((2, 3600, 192), dev, dtype, 40)
    assert norms.group_norm_plan(2, 3600, 192, 32, dtype).route == "cuda"
    if masked:
        lens = torch.tensor([3600, 1234], dtype=torch.int32, device=dev)
        a, b = (norms.group_norm_masked_kernel(x, 32, w, bias, lens, 1e-6) for _ in range(2))
    else:
        a, b = (norms.group_norm_kernel(x, 32, w, bias, 1e-6) for _ in range(2))
    assert torch.equal(a, b)


def test_group_norm_kernel_refuses_bad_input(dev):
    """Bad input raises, and nothing falls back: no launch is counted."""
    x, w, bias = _gn_inputs((2, 600, 192), dev, torch.float32)
    lens = torch.tensor([600, 300], dtype=torch.int32, device=dev)
    before = (norms.group_norm_kernel.launches, norms.group_norm_masked_kernel.launches)
    with pytest.raises(ValueError, match="contiguous"):
        norms.group_norm_kernel(x.transpose(0, 1), 32, w, bias)
    with pytest.raises(TypeError, match="dtype"):
        norms.group_norm_kernel(x.half(), 32, w, bias)
    with pytest.raises(TypeError, match="dtype"):
        norms.group_norm_masked_kernel(x.double(), 32, w, bias, lens)
    with pytest.raises(ValueError, match="lengths"):
        norms.group_norm_masked_kernel(x, 32, w, bias, lens.long())
    with pytest.raises(ValueError, match="plan"):
        norms.group_norm_kernel(x, 32, w, bias, _plan=(3, 4))  # 3 does not divide 32
    with pytest.raises(ValueError, match="plan"):
        norms.group_norm_kernel(_gn_inputs((2, 4096, 384), dev, torch.float32)[0], 32, *_gn_inputs(
            (2, 4096, 384), dev, torch.float32)[1:], _plan=(4, 1))  # 786 KB: past a CTA's shared memory
    with pytest.raises(ValueError, match="16-byte"):
        flat = torch.empty(600 * 192 + 1, device=dev)
        norms.group_norm_kernel(flat[1:].view(1, 600, 192), 32, w, bias)
    assert (norms.group_norm_kernel.launches, norms.group_norm_masked_kernel.launches) == before


@pytest.fixture
def split_past_1024(monkeypatch):
    """The split plan for rows over 1024 frames, whatever the shipped
    threshold, so the UNet-width chunk edges below run the two-stage
    kernels."""
    monkeypatch.setattr(norms, "_SPLIT_MIN_T", 1024)
    norms.group_norm_plan.cache_clear()
    yield
    norms.group_norm_plan.cache_clear()


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize(
    "shape,groups,act,lengths",
    [
        ((2, 1025, 192), 32, "silu", None),          # the shortest split row: 9 chunks, the last 1 frame
        ((2, 3600, 192), 32, "none", None),          # the 60-s step's shape
        ((2, 21600, 192), 32, "none", None),         # the 6-min step's, split at any threshold
        ((1, 2049, 512), 512, "none", None),
        ((1, 204799, 512), 512, "none", None),       # a bucketed 60-s clip's conv_0
        ((2, 3840, 192), 32, "silu", [3600, 129]),   # a length one frame past a chunk
        ((3, 2100, 192), 32, "silu", [2100, 128, 1]),  # chunks wholly past a length; a length-1 row
        ((8, 27305, 512), 512, "none", [13759] * 4 + [16319] * 4),
    ],
)
def test_group_norm_split_kernel(dev, split_past_1024, dtype, shape, groups, act, lengths):
    """Rows split in the two-stage plan, against the plain twin and
    against the plain version of the chunked arithmetic itself."""
    b, t, c = shape
    plan = norms.group_norm_plan(b, t, c, groups, dtype)
    assert plan.route == "triton" and plan.chunks > 1
    chunk_t = plan.frames
    x = _randn(shape, 3, dev, dtype, 2.0, 30.0)
    w = _randn((c,), 4, dev, torch.float32)
    bias = _randn((c,), 5, dev, torch.float32)
    if lengths is None:
        got = norms.group_norm_kernel(x, groups, w, bias, 1e-5, act)
        _assert_close(got, norms.group_norm_plain(x, groups, w, bias, 1e-5, act), dtype)
        lens = None
    else:
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        got = norms.group_norm_masked_kernel(x, groups, w, bias, lens, 1e-5, act)
        _assert_close(got, norms.group_norm_masked_plain(x, groups, w, bias, lens, 1e-5, act), dtype)
    _assert_close(got, norms.group_norm_chunked_plain(x, groups, w, bias, 1e-5, act, lens, chunk_t), dtype)


@pytest.mark.parametrize("masked", [False, True])
def test_group_norm_split_kernel_is_deterministic(dev, masked):
    """No atomics: two calls on the same input give the same bits."""
    x = _randn((1, 31999, 512), 6, dev, torch.float32, 2.0, 30.0)
    w, bias = _randn((512,), 7, dev, torch.float32), _randn((512,), 8, dev, torch.float32)
    if masked:
        lens = torch.tensor([30001], dtype=torch.int32, device=dev)
        a, b = (norms.group_norm_masked_kernel(x, 512, w, bias, lens) for _ in range(2))
    else:
        a, b = (norms.group_norm_kernel(x, 512, w, bias) for _ in range(2))
    assert torch.equal(a, b)


def test_group_norm_masked_kernel_refuses_bad_lengths(dev):
    x = _randn((2, 16, 192), 6, dev, torch.float32)
    w = torch.ones(192, device=dev)
    for bad in (torch.tensor([8, 8], device=dev),  # int64
                torch.tensor([8], dtype=torch.int32, device=dev),
                torch.tensor([8, 8], dtype=torch.int32)):  # on the CPU
        with pytest.raises(ValueError, match="lengths"):
            norms.group_norm_masked_kernel(x, 32, w, w, bad)


def _geglu_inputs(shape, dev, dtype, scale=1.0):
    c = shape[-1]
    return (_randn(shape, 6, dev, dtype, scale), _randn((8 * c, c), 7, dev, dtype, 0.05),
            _randn((8 * c,), 8, dev, torch.float32, 0.1), _randn((c, 4 * c), 9, dev, dtype, 0.05),
            _randn((c,), 10, dev, torch.float32, 0.1))


# (dtype, plan): the plan geglu_plan picks (None), and every plan the
# kernel takes, forced
_GEGLU_PLANS = [(dt, plan) for dt in _DTYPES for plan in (None, *ffn.PLANS[dt])]


@pytest.mark.parametrize("dtype,plan", _GEGLU_PLANS)
@pytest.mark.parametrize("shape", [(1, 1, 192), (1, 37, 192), (1, 63, 192), (1, 64, 192), (1, 65, 192),
                                   (2, 600, 192), (2, 3600, 192), (2, 21600, 192)])
@pytest.mark.parametrize("scale", [1.0, 30.0])  # 30: large sums, where accumulation drift would show
def test_geglu_ffn_kernel(dev, dtype, plan, shape, scale):
    """Against the plain twin, and bit-identical over two calls."""
    args = _geglu_inputs(shape, dev, dtype, scale)
    got = ffn.geglu_ffn_kernel(*args, _plan=plan)
    _assert_close(got, ffn.geglu_ffn_plain(*args), dtype)
    assert torch.equal(got, ffn.geglu_ffn_kernel(*args, _plan=plan))


def test_geglu_ffn_kernel_refuses_bad_input(dev):
    x, w1, b1, w2, b2 = _geglu_inputs((2, 40, 192), dev, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        ffn.geglu_ffn_kernel(x.transpose(0, 1), w1, b1, w2, b2)
    with pytest.raises(ValueError, match="w1"):
        ffn.geglu_ffn_kernel(x, w1.to(torch.bfloat16), b1, w2, b2)
    with pytest.raises(ValueError, match="w2"):
        ffn.geglu_ffn_kernel(x.to(torch.bfloat16), w1.to(torch.bfloat16), b1, w2, b2)
    with pytest.raises(ValueError, match="b1"):
        ffn.geglu_ffn_kernel(x, w1, b1.to(torch.bfloat16), w2, b2)
    with pytest.raises(ValueError, match="16-byte"):
        ffn.geglu_ffn_kernel(torch.empty(80 * 192 + 1, device=dev)[1:].view(80, 192), w1, b1, w2, b2)
    with pytest.raises(ValueError, match="plan"):
        ffn.geglu_ffn_kernel(x, w1, b1, w2, b2, _plan=(128, 1))  # two warpgroups: bf16 only


# (B, K, T_in) at 512 -> 512 channels: conv_1 … conv_6 of a 10-s clip, the
# shortest inputs (T_in = K, K + 1), 8 and 41 samples at batch 2 (a tile's
# rows span both batches), and T_out = 129 and 257, one row past a tile
_CONV_CASES = [(1, 3, 31999), (1, 3, 15999), (1, 3, 7999), (1, 3, 3999), (1, 2, 1999), (1, 2, 999),
               *[(2, k, t) for k in (2, 3) for t in (k, k + 1, 8, 41)],
               (2, 3, 259), (1, 2, 514), (2, 3, 514)]


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("b,k,t_in", _CONV_CASES)
def test_strided_conv_gelu_kernel(dev, dtype, b, k, t_in):
    x = _randn((b, t_in, 512), 11, dev, dtype)
    w = _randn((k, 512, 512), 12, dev, dtype, 0.03)
    t_out = (t_in - k) // 2 + 1
    assert conv.conv_plan(b * t_out, 512, 512, dtype).route == "tensor_cores"
    got = conv.strided_conv_gelu_kernel(x, conv.pack_weight(w))
    _assert_close(got, conv.strided_conv_gelu_plain(x, w), dtype)
    assert torch.equal(got, conv.strided_conv_gelu_kernel(x, conv.pack_weight(w)))  # no atomics: the same bits


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("b,k,t_in,c_in,c_out", [(2, 3, 8, 16, 16), (2, 3, 399, 16, 16), (1, 2, 64, 16, 16),
                                                 (2, 3, 41, 96, 200)])
def test_strided_conv_gelu_kernel_fma_route(dev, dtype, b, k, t_in, c_in, c_out):
    """Widths the tensor-core tiles do not take (the tiny encoder's 16
    channels) run on the FMA pipes, under the same launch counter."""
    x = _randn((b, t_in, c_in), 13, dev, dtype)
    w = _randn((k, c_in, c_out), 14, dev, dtype, 0.2)
    assert conv.conv_plan(b * ((t_in - k) // 2 + 1), c_in, c_out, dtype).route == "fma"
    before = conv.strided_conv_gelu_kernel.launches
    got = conv.strided_conv_gelu(x, w)
    assert conv.strided_conv_gelu_kernel.launches == before + 1
    _assert_close(got, conv.strided_conv_gelu_plain(x, w), dtype)


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("b,k,t_in", [(1, 3, 7999), (2, 3, 259), (1, 2, 999)])
def test_strided_conv_gelu_kernel_every_split(dev, dtype, b, k, t_in):
    """Every split of the contraction over a cluster gives the twin's
    values, the same bits over two calls."""
    x = _randn((b, t_in, 512), 17, dev, dtype)
    w = _randn((k, 512, 512), 18, dev, dtype, 0.03)
    packed, want = conv.pack_weight(w), conv.strided_conv_gelu_plain(x, w)
    for split in conv.SPLITS:
        got = conv.strided_conv_gelu_kernel(x, packed, _split=split)
        _assert_close(got, want, dtype)
        assert torch.equal(got, conv.strided_conv_gelu_kernel(x, packed, _split=split))


def test_strided_conv_gelu_kernel_refuses_bad_input(dev):
    x = _randn((1, 41, 512), 15, dev, torch.float32)
    w = _randn((3, 512, 512), 16, dev, torch.float32, 0.03)
    packed = conv.pack_weight(w)
    before = conv.strided_conv_gelu_kernel.launches
    with pytest.raises(ValueError, match="packed"):
        conv.strided_conv_gelu_kernel(x, w)  # contiguous (K, C_in, C_out), not packed
    with pytest.raises(ValueError, match="packed"):
        conv.strided_conv_gelu_kernel(x, conv.pack_weight(w.to(torch.bfloat16)))
    with pytest.raises(TypeError, match="dtype"):
        conv.strided_conv_gelu_kernel(x.half(), conv.pack_weight(w.half()))
    with pytest.raises(ValueError, match="shorter"):
        conv.strided_conv_gelu_kernel(x[:, :2].contiguous(), packed)
    with pytest.raises(ValueError, match="16-byte"):
        conv.strided_conv_gelu_kernel(torch.empty(41 * 512 + 1, device=dev)[1:].view(1, 41, 512), packed)
    with pytest.raises(ValueError, match="split"):
        conv.strided_conv_gelu_kernel(x, packed, _split=3)
    with pytest.raises(ValueError, match="split"):  # the FMA route takes no split
        conv.strided_conv_gelu_kernel(x[:, :, :16].contiguous(), conv.pack_weight(w[:, :16, :16]), _split=2)
    assert conv.strided_conv_gelu_kernel.launches == before


def test_routers_launch_kernels_on_cuda(dev):
    x = _randn((2, 40, 192), 13, dev, torch.float32)
    w = torch.ones(192, device=dev)
    b = torch.zeros(192, device=dev)
    before = (norms.layer_norm_kernel.launches, norms.group_norm_kernel.launches,
              norms.group_norm_masked_kernel.launches,
              ffn.geglu_ffn_kernel.launches, conv.strided_conv_gelu_kernel.launches)
    norms.layer_norm(x, w, b)
    norms.group_norm(x, 32, w, b, act="silu")
    norms.group_norm_masked(x, 32, w, b, torch.tensor([40, 7], dtype=torch.int32, device=dev), act="silu")
    ffn.geglu_ffn(x, _randn((1536, 192), 14, dev, torch.float32, 0.05), torch.zeros(1536, device=dev),
                  _randn((192, 768), 15, dev, torch.float32, 0.05), b)
    conv.strided_conv_gelu(_randn((1, 41, 512), 16, dev, torch.float32),
                           _randn((3, 512, 512), 17, dev, torch.float32, 0.03))
    after = (norms.layer_norm_kernel.launches, norms.group_norm_kernel.launches,
             norms.group_norm_masked_kernel.launches,
             ffn.geglu_ffn_kernel.launches, conv.strided_conv_gelu_kernel.launches)
    assert [a - b_ for a, b_ in zip(after, before)] == [1, 1, 1, 1, 1]


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("heads,d", [(6, 32), (12, 64)])
@pytest.mark.parametrize("b,t,s,lengths", [
    (2, 2100, 2100, None),           # ragged: 2100 = 32·64 + 52
    (1, 700, 1300, None),            # more keys than queries
    (3, 384, 384, [384, 200, 0]),    # straddling and length-0 rows
    (2, 130, 130, [1, 129]),
])
def test_flash_attention_kernel(dev, dtype, heads, d, b, t, s, lengths):
    q = _randn((b, t, heads * d), 18, dev, dtype)
    k = _randn((b, s, heads * d), 19, dev, dtype)
    v = _randn((b, s, heads * d), 20, dev, dtype)
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device=dev)
    got = attention.flash_attention_kernel(q, k, v, heads, lens)
    _assert_close(got, attention.flash_attention_plain(q, k, v, heads, lens), dtype)
    if lengths is not None:
        for i, n in enumerate(lengths):
            assert torch.all(got[i, n:] == 0)


# the kernel's edges: 64-row query blocks; 64-key tiles (f32) and 128-key tiles (bf16)
_FLASH_EDGES = [1, 63, 64, 65, 127, 128, 129, 2100]


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("heads,d", [(6, 32), (12, 64)])
@pytest.mark.parametrize("n", _FLASH_EDGES)
def test_flash_attention_kernel_tile_edges(dev, dtype, heads, d, n):
    """T = S = n, without lengths and with lengths 0, 1, 64 ± 1 and 128 ± 1
    (block and tile edges) and full (lengths past n are clamped to n)."""
    lengths = [0, 1, 63, 64, 65, 127, 129, n]
    b = len(lengths)
    q, k, v = (_randn((b, n, heads * d), 23 + i, dev, dtype) for i in range(3))
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    _assert_close(attention.flash_attention_kernel(q[:2], k[:2], v[:2], heads),
                  attention.flash_attention_plain(q[:2], k[:2], v[:2], heads), dtype)
    got = attention.flash_attention_kernel(q, k, v, heads, lens)
    _assert_close(got, attention.flash_attention_plain(q, k, v, heads, lens), dtype)
    for i, m in enumerate(lengths):
        assert torch.all(got[i, m:] == 0)
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("heads,d", [(6, 32), (12, 64)])
@pytest.mark.parametrize("t,s", [(1, 129), (129, 1), (65, 2100), (2100, 63)])
def test_flash_attention_kernel_uneven_edges(dev, dtype, heads, d, t, s):
    q = _randn((2, t, heads * d), 26, dev, dtype)
    k, v = (_randn((2, s, heads * d), 27 + i, dev, dtype) for i in range(2))
    _assert_close(attention.flash_attention_kernel(q, k, v, heads),
                  attention.flash_attention_plain(q, k, v, heads), dtype)


def test_flash_attention_kernel_refuses_misaligned_input(dev):
    flat = _randn((2 * 130 * 192 + 1,), 29, dev, torch.float32)
    q = flat[1:].view(2, 130, 192)  # contiguous, 4 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="16-byte"):
        attention.flash_attention_kernel(q, q, q, 6)


def test_self_attention_routes_lengths_to_the_kernel(dev):
    n = attention.DENSE_MAX + 64
    q = _randn((2, n, 192), 22, dev, torch.float32)
    lens = torch.tensor([n, 2100], dtype=torch.int32, device=dev)
    before = attention.flash_attention_kernel.launches
    out = attention.self_attention(q, q, q, 6, lens)
    assert attention.flash_attention_kernel.launches == before + 1
    _assert_close(out, attention.flash_attention_plain(q, q, q, 6, lens), torch.float32)


def test_self_attention_routes_long_clips_to_the_kernel(dev):
    n = attention.DENSE_MAX + 1
    q = _randn((1, n, 192), 21, dev, torch.float32)
    before = attention.flash_attention_kernel.launches
    out = attention.self_attention(q, q, q, 6)
    assert attention.flash_attention_kernel.launches == before + 1
    _assert_close(out, attention.flash_attention_plain(q, q, q, 6), torch.float32)
    short = q[:, : attention.DENSE_MAX]
    attention.self_attention(short, short, short, 6)
    assert attention.flash_attention_kernel.launches == before + 1


# ------------------------------------------------- the autograd wrappers
#
# Each router, where an input needs a gradient, runs its kernel forward
# and a PyTorch backward (``torch.autograd.Function``). On the card: the
# forward equals the plain twin, the backward equals autograd through the
# plain twin (bound as above, per input gradient), the kernel is launched
# once a forward and never by the backward.


def _grad_case(dev, dtype, wrapper, plain, inputs, kernel, lengths=None):
    inputs = [t.requires_grad_() for t in inputs]
    before = kernel.launches
    got = wrapper(*inputs)
    assert got.grad_fn is not None and kernel.launches == before + 1
    g = _randn(tuple(got.shape), 90, dev, dtype)
    if lengths is not None:  # a padded query row's gradient is 0 in the model (see phase 2b)
        g = g * (torch.arange(got.shape[1], device=dev)[None, :, None] < lengths[:, None, None]).to(dtype)
    grads = torch.autograd.grad(got, inputs, g)
    assert kernel.launches == before + 1  # the backward launches no kernel
    want = plain(*inputs)
    _assert_close(got, want, dtype)
    for a, r in zip(grads, torch.autograd.grad(want, inputs, g)):
        _assert_close(a, r, a.dtype)


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("act", ["none", "silu"])
@pytest.mark.parametrize("shape,groups,lengths", [((2, 600, 192), 32, None), ((2, 600, 192), 32, [597, 597]),
                                                  ((8, 304, 192), 32, [297] * 8), ((2, 4200, 192), 32, [4200, 3000])])
def test_group_norm_autograd_wrapper(dev, dtype, act, shape, groups, lengths):
    c = shape[-1]
    x = _randn(shape, 60, dev, dtype, 2.0, 0.5)
    w, b = _randn((c,), 61, dev, torch.float32), _randn((c,), 62, dev, torch.float32)
    if lengths is None:
        _grad_case(dev, dtype, lambda x, w, b: norms.group_norm(x, groups, w, b, 1e-5, act),
                   lambda x, w, b: norms.group_norm_plain(x, groups, w, b, 1e-5, act), [x, w, b],
                   norms.group_norm_kernel)
    else:
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        _grad_case(dev, dtype, lambda x, w, b: norms.group_norm_masked(x, groups, w, b, lens, 1e-5, act),
                   lambda x, w, b: norms.group_norm_masked_plain(x, groups, w, b, lens, 1e-5, act), [x, w, b],
                   norms.group_norm_masked_kernel)


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("shape", [(2, 600, 192), (8, 304, 192), (1, 300, 768)])
def test_layer_norm_autograd_wrapper(dev, dtype, shape):
    c = shape[-1]
    x = _randn(shape, 63, dev, dtype, 2.0, 0.5)
    w, b = _randn((c,), 64, dev, torch.float32), _randn((c,), 65, dev, torch.float32)
    _grad_case(dev, dtype, norms.layer_norm, norms.layer_norm_plain, [x, w, b], norms.layer_norm_kernel)


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("b,t,lengths", [(1, 2400, None), (2, 2400, [2400, 2100]), (1, 4200, None),
                                         (2, 4200, [4200, 3000])])
def test_flash_attention_autograd_wrapper(dev, dtype, b, t, lengths):
    """2400 keys: the dense-recompute backward; 4200: the blockwise one."""
    q, k, v = (_randn((b, t, 192), 66 + i, dev, dtype) for i in range(3))
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device=dev)
    _grad_case(dev, dtype, lambda q, k, v: attention.self_attention(q, k, v, 6, lens),
               lambda q, k, v: attention.flash_attention_plain(q, k, v, 6, lens), [q, k, v],
               attention.flash_attention_kernel, lens)


def test_geglu_and_conv_autograd_wrappers(dev):
    x = _randn((2, 600, 192), 70, dev, torch.float32)
    w1, b1 = _randn((1536, 192), 71, dev, torch.float32, 0.05), _randn((1536,), 72, dev, torch.float32, 0.1)
    w2, b2 = _randn((192, 768), 73, dev, torch.float32, 0.05), _randn((192,), 74, dev, torch.float32, 0.1)
    _grad_case(dev, torch.float32, ffn.geglu_ffn, ffn.geglu_ffn_plain, [x, w1, b1, w2, b2], ffn.geglu_ffn_kernel)
    x = _randn((1, 3999, 512), 75, dev, torch.float32)
    kw = conv.pack_weight(_randn((3, 512, 512), 76, dev, torch.float32, 0.03))
    _grad_case(dev, torch.float32, conv.strided_conv_gelu, conv.strided_conv_gelu_plain, [x, kw],
               conv.strided_conv_gelu_kernel)


def test_routers_record_no_gradient_without_grad(dev):
    x = _randn((2, 40, 192), 77, dev, torch.float32).requires_grad_()
    w, b = torch.ones(192, device=dev, requires_grad=True), torch.zeros(192, device=dev, requires_grad=True)
    with torch.no_grad():
        assert norms.layer_norm(x, w, b).grad_fn is None
        assert norms.group_norm(x, 32, w, b).grad_fn is None
