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


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("shape", [(2, 600, 192), (1, 600, 768), (2, 37, 192)])
def test_layer_norm_kernel(dev, dtype, shape):
    c = shape[-1]
    x = _randn(shape, 0, dev, dtype, 2.0, 0.5)
    w = _randn((c,), 1, dev, torch.float32)
    b = _randn((c,), 2, dev, torch.float32)
    _assert_close(norms.layer_norm_kernel(x, w, b, 1e-5),
                  norms.layer_norm_plain(x, w, b, 1e-5), dtype)


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


def test_group_norm_masked_kernel_refuses_bad_lengths(dev):
    x = _randn((2, 16, 192), 6, dev, torch.float32)
    w = torch.ones(192, device=dev)
    for bad in (torch.tensor([8, 8], device=dev),  # int64
                torch.tensor([8], dtype=torch.int32, device=dev),
                torch.tensor([8, 8], dtype=torch.int32)):  # on the CPU
        with pytest.raises(ValueError, match="lengths"):
            norms.group_norm_masked_kernel(x, 32, w, w, bad)


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("shape", [(2, 600, 192), (1, 37, 192)])
def test_geglu_ffn_kernel(dev, dtype, shape):
    c = shape[-1]
    x = _randn(shape, 6, dev, dtype)
    w1 = _randn((8 * c, c), 7, dev, dtype, 0.05)
    b1 = _randn((8 * c,), 8, dev, torch.float32, 0.1)
    w2 = _randn((c, 4 * c), 9, dev, dtype, 0.05)
    b2 = _randn((c,), 10, dev, torch.float32, 0.1)
    _assert_close(ffn.geglu_ffn_kernel(x, w1, b1, w2, b2),
                  ffn.geglu_ffn_plain(x, w1, b1, w2, b2), dtype)


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("k,t_in", [(3, 7999), (2, 999), (3, 8)])
def test_strided_conv_gelu_kernel(dev, dtype, k, t_in):
    x = _randn((1, t_in, 512), 11, dev, dtype)
    w = _randn((k, 512, 512), 12, dev, dtype, 0.03)
    _assert_close(conv.strided_conv_gelu_kernel(x, w),
                  conv.strided_conv_gelu_plain(x, w), dtype)


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
