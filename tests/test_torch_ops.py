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
from said_tpu.ops.norms import _group_norm_jnp, _layer_norm_jnp
from said_tpu.ops.pallas_conv import _strided_conv_gelu_jnp, strided_conv_gelu_pallas
from said_tpu.ops.pallas_ffn import geglu_ffn_pallas
from said_tpu.ops.pallas_norms import group_norm_pallas, layer_norm_pallas
from said_tpu.ops.resample import linear_interp_time as j_interp
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


@pytest.mark.parametrize("shape", [(2, 96, 192), (1, 50, 768), (1, 37, 512)])
def test_layer_norm_matches_jax(shape):
    c = shape[-1]
    x, w, b = _rand(shape, 6, 2.0, -0.5), _rand((c,), 7), _rand((c,), 8)
    got = norms.layer_norm(_t(x), _t(w), _t(b)).numpy()
    _close(got, layer_norm_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), interpret=True))
    _close(got, _layer_norm_jnp(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))


# -------------------------------------------------------------------- ffn


def test_geglu_ffn_matches_jax():
    c, inner = 192, 768
    x = _rand((2, 64, c), 9)
    w1, b1 = _rand((c, 2 * inner), 10, 0.05), _rand((2 * inner,), 11, 0.1)
    w2, b2 = _rand((inner, c), 12, 0.05), _rand((c,), 13, 0.1)
    want = geglu_ffn_pallas(*map(jnp.asarray, (x, w1, b1, w2, b2)), interpret=True)
    # the port takes the torch nn.Linear layout: w1 (2I, C), w2 (C, I)
    got = ffn.geglu_ffn(_t(x), _t(w1.T), _t(b1), _t(w2.T), _t(b2)).numpy()
    _close(got, want)


# ------------------------------------------------------------------- conv


@pytest.mark.parametrize("k,t_in", [(3, 70), (2, 64), (3, 8)])
def test_strided_conv_gelu_matches_jax(k, t_in):
    x, w = _rand((2, t_in, 128), 14), _rand((k, 128, 128), 15, 0.05)
    got = conv.strided_conv_gelu(_t(x), _t(w)).numpy()
    _close(got, strided_conv_gelu_pallas(jnp.asarray(x), jnp.asarray(w), interpret=True))
    _close(got, _strided_conv_gelu_jnp(jnp.asarray(x), jnp.asarray(w)))


def test_kernel_wrappers_refuse_non_cuda_tensors():
    """No router falls back: a non-CPU, non-CUDA tensor reaches the kernel
    wrapper, which raises, and no launch is counted."""
    x = torch.empty((2, 8, 192), device="meta")
    w = torch.empty((192,), device="meta")
    before = (norms.layer_norm_kernel.launches, norms.group_norm_kernel.launches,
              ffn.geglu_ffn_kernel.launches, conv.strided_conv_gelu_kernel.launches)
    with pytest.raises(ValueError, match="CUDA"):
        norms.layer_norm(x, w, w)
    with pytest.raises(ValueError, match="CUDA"):
        norms.group_norm(x, 32, w, w)
    with pytest.raises(ValueError, match="CUDA"):
        ffn.geglu_ffn(x, torch.empty((1536, 192), device="meta"), torch.empty(1536, device="meta"),
                      torch.empty((192, 768), device="meta"), w)
    with pytest.raises(ValueError, match="CUDA"):
        conv.strided_conv_gelu(x, torch.empty((3, 192, 192), device="meta"))
    after = (norms.layer_norm_kernel.launches, norms.group_norm_kernel.launches,
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


def test_self_attention_router_caps_non_cpu_length():
    n = attention.DENSE_MAX + 1
    meta = torch.empty((1, n, 192), device="meta")
    with pytest.raises(NotImplementedError, match="flash-attention kernel"):
        attention.self_attention(meta, meta, meta, 6)
    short = torch.empty((1, attention.DENSE_MAX, 192), device="meta")
    assert attention.self_attention(short, short, short, 6).shape == short.shape
    # the CPU serves every length on the dense path
    x = torch.zeros((1, n, 12))
    assert attention.self_attention(x, x, x, 2).shape == x.shape


# -------------------------------------------------- band tables, resample


@pytest.mark.parametrize("x_len,c_len", [(24, 24), (600, 600), (37, 91), (100, 49), (7, 1)])
def test_band_tables_equal_jax(x_len, c_len):
    for got, want in zip(masks.alignment_band(x_len, c_len), jmasks.alignment_band(x_len, c_len)):
        np.testing.assert_array_equal(got, want)
    got, want = masks.band_gather_indices(x_len, c_len), jmasks.band_gather_indices(x_len, c_len)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


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
