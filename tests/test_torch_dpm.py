"""The port's DPM-Solver++(2M) against the JAX package, on the CPU.

Mirrors tests/test_dpm_solver.py: the coefficient tables must equal
``said_tpu.diffusion.schedule.dpmpp_2m_tables`` (within 1e-7), the
sampler must match an independent numpy re-derivation of the paper's
update and the JAX sampler on a smooth toy denoiser (atol 5e-5, rtol
1e-4, the JAX test's bound), land exactly on a point-mass data
distribution for epsilon and v prediction, keep the solver order on an
analytic ODE, and reject eta > 0 and unknown solvers.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from said_tpu.diffusion import sampler as jsampler
from said_tpu.diffusion import schedule as jsched
from said_tpu_torch.diffusion import sampler as tsampler
from said_tpu_torch.diffusion import schedule as tsched


def _run(schedule, eps_fn, latents, num_steps, solver, **kw):
    config = tsampler.SamplerConfig(num_inference_steps=num_steps, guidance_scale=1.0, solver=solver, **kw)
    result, _ = tsampler.sample(schedule, eps_fn, torch.from_numpy(np.asarray(latents, np.float32)), config)
    return result.numpy()


@pytest.mark.parametrize("n,strength", [(25, 1.0), (20, 1.0), (7, 1.0), (1000, 1.0), (20, 0.6)])
def test_dpmpp_tables_equal_jax(n, strength):
    js, ts = jsched.DiffusionSchedule.create(1000), tsched.DiffusionSchedule.create(1000)
    ts_all = tsched.inference_timesteps(1000, n)
    used = ts_all[n - min(int(n * strength), n):]
    got = tsched.dpmpp_2m_tables(ts, used, n)
    want = jsched.dpmpp_2m_tables(js, used, n)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == np.float32
        np.testing.assert_allclose(got[key], np.asarray(want[key]), atol=1e-7, rtol=0)


def _numpy_dpmpp_2m(schedule, eps_fn, x, num_steps):
    """Independent DPM-Solver++(2M) loop from the paper (float64)."""
    acp = np.asarray(schedule.alphas_cumprod, np.float64)
    ts = tsched.inference_timesteps(schedule.num_train_timesteps, num_steps)
    step = schedule.num_train_timesteps // num_steps

    def lam_of(a):
        alpha, sigma = np.sqrt(a), np.sqrt(1.0 - a)
        return alpha, sigma, np.log(alpha) - np.log(sigma) if sigma > 0 else np.inf

    prev_x0 = prev_lam = None
    for t in ts:
        a_prev = acp[t - step] if t - step >= 0 else float(schedule.final_alpha_cumprod)
        _, sigma_c, lam_c = lam_of(acp[t])
        alpha_p, sigma_p, lam_p = lam_of(a_prev)
        eps = eps_fn(x, t)
        x0 = np.clip((x - np.sqrt(1.0 - acp[t]) * eps) / np.sqrt(acp[t]), -1.0, 1.0)
        h = lam_p - lam_c
        if not np.isfinite(h):
            x = x0.copy()
        elif prev_x0 is None:
            x = (sigma_p / sigma_c) * x - alpha_p * np.expm1(-h) * x0
        else:
            d1 = (x0 - prev_x0) / ((lam_c - prev_lam) / h)
            x = (sigma_p / sigma_c) * x - alpha_p * np.expm1(-h) * (x0 + 0.5 * d1)
        prev_x0, prev_lam = x0, lam_c
    return np.clip(x, 0.0, 1.0)


def test_dpmpp_matches_numpy_oracle_and_jax():
    schedule = tsched.DiffusionSchedule.create(1000)
    rng = np.random.default_rng(0)
    x_init = rng.standard_normal((2, 12, 4)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (4,)).astype(np.float32)

    def eps_torch(x, t):
        return torch.tanh(x) * torch.from_numpy(w) + float(np.sin(np.float32(t) / np.float32(1000.0)))

    got = _run(schedule, eps_torch, x_init, 20, "dpmpp_2m")
    oracle = _numpy_dpmpp_2m(schedule, lambda x, t: np.tanh(x) * w + np.sin(np.float64(t) / 1000.0),
                             x_init.astype(np.float64), 20)
    np.testing.assert_allclose(got, oracle, atol=5e-5, rtol=1e-4)

    def eps_jax(x, t, context):
        return jnp.tanh(x) * jnp.asarray(w) + jnp.sin(t.astype(x.dtype) / 1000.0)[:, None, None]

    want, _ = jsampler.sample(
        jsched.DiffusionSchedule.create(1000), eps_jax, jax.random.PRNGKey(0), jnp.asarray(x_init),
        audio_embedding=jnp.zeros((2, 4, 8)), uncond_embedding=None,
        config=jsampler.SamplerConfig(num_inference_steps=20, guidance_scale=1.0, solver="dpmpp_2m"),
    )
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
def test_dpmpp_exact_on_delta_data(prediction_type):
    """The ideal predictor of a point mass: the last (boundary) step is
    x = x0, so the chain lands on the point."""
    schedule = tsched.DiffusionSchedule.create(1000, prediction_type=prediction_type)
    acp = schedule.alphas_cumprod
    x_star = torch.from_numpy(np.random.default_rng(1).uniform(0.1, 0.9, (1, 8, 4)).astype(np.float32))

    def ideal(x, t):
        a = float(acp[t])
        eps = (x - a**0.5 * x_star) / (1.0 - a) ** 0.5
        return eps if prediction_type == "epsilon" else a**0.5 * eps - (1.0 - a) ** 0.5 * x_star

    x_init = np.random.default_rng(2).standard_normal((1, 8, 4))
    np.testing.assert_allclose(_run(schedule, ideal, x_init, 8, "dpmpp_2m"), x_star.numpy(), atol=1e-5)


def test_dpmpp_solver_order_on_analytic_ode():
    """Gaussian data N(mu, s² I): the probability-flow ODE has an exact
    endpoint. DPM++ must beat DDIM by 3x at 10 steps and by 10x at 500
    (its second order), as the JAX package's test asserts."""
    schedule = tsched.DiffusionSchedule.create(1000)
    acp = np.asarray(schedule.alphas_cumprod, np.float64)
    rng = np.random.default_rng(3)
    mu_np = rng.uniform(0.3, 0.7, (1, 1, 4))
    mu = torch.from_numpy(mu_np.astype(np.float32))
    s2 = 0.01

    def ideal(x, t):
        a = float(schedule.alphas_cumprod[t])
        x0_hat = mu + (a**0.5 * s2 / (a * s2 + 1.0 - a)) * (x - a**0.5 * mu)
        return (x - a**0.5 * x0_hat) / (1.0 - a) ** 0.5

    x_init = rng.standard_normal((1, 16, 4))

    def err(n, solver):
        a0 = acp[tsched.inference_timesteps(1000, n)[0]]
        z = (x_init - np.sqrt(a0) * mu_np) / np.sqrt(a0 * s2 + 1.0 - a0)
        exact = np.clip(mu_np + np.sqrt(s2) * z, 0.0, 1.0)
        return np.abs(_run(schedule, ideal, x_init, n, solver) - exact).max()

    assert err(10, "dpmpp_2m") < err(10, "ddim") / 3
    e_dpm_500 = err(500, "dpmpp_2m")
    assert e_dpm_500 < err(500, "ddim") / 10 and e_dpm_500 < 1e-3


def test_dpmpp_rejects_eta():
    with pytest.raises(ValueError, match="deterministic"):
        tsampler.SamplerConfig(num_inference_steps=4, eta=0.5, solver="dpmpp_2m")


def test_unknown_solver_rejected():
    with pytest.raises(ValueError, match="unknown solver"):
        tsampler.SamplerConfig(num_inference_steps=4, solver="heun")
