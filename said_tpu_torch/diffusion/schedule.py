"""Cosine noise schedule, DDIM step, DPM-Solver++(2M) tables and
classifier-free guidance.

Port of ``said_tpu.diffusion.schedule``: a DDIM scheduler with
``beta_schedule="squaredcos_cap_v2"``, ``set_alpha_to_one=True``,
``clip_sample=True`` (range 1.0), "leading" timestep spacing and
``init_noise_sigma = 1``. The sampler runs on the host, so timesteps are
Python ints; per-step scalars are formed in float32 (0-d CPU tensors)
exactly as the JAX package forms them, then applied to the device
tensors.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def alpha_bar_cosine(t: np.ndarray) -> np.ndarray:
    """cos((t + 0.008)/1.008 · π/2)² for t in [0, 1]."""
    return np.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2


def betas_squaredcos_cap_v2(num_train_timesteps: int, max_beta: float = 0.999) -> np.ndarray:
    """Per-step betas of the cosine schedule, float64 math cast to float32."""
    t = np.arange(num_train_timesteps, dtype=np.float64)
    betas = 1.0 - alpha_bar_cosine((t + 1) / num_train_timesteps) / alpha_bar_cosine(
        t / num_train_timesteps
    )
    return np.minimum(betas, max_beta).astype(np.float32)


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Schedule tables and options; ``alphas_cumprod`` is a float32 numpy
    array of length ``num_train_timesteps``."""

    alphas_cumprod: np.ndarray
    num_train_timesteps: int = 1000
    prediction_type: str = "epsilon"
    clip_sample: bool = True
    clip_sample_range: float = 1.0
    final_alpha_cumprod: float = 1.0  # set_alpha_to_one=True
    init_noise_sigma: float = 1.0

    @classmethod
    def create(
        cls,
        num_train_timesteps: int = 1000,
        prediction_type: str = "epsilon",
        clip_sample: bool = True,
    ) -> "DiffusionSchedule":
        if prediction_type not in ("epsilon", "sample", "v_prediction"):
            raise ValueError(f"unknown prediction_type: {prediction_type}")
        betas = betas_squaredcos_cap_v2(num_train_timesteps)
        return cls(
            alphas_cumprod=np.cumprod(1.0 - betas, dtype=np.float32),
            num_train_timesteps=num_train_timesteps,
            prediction_type=prediction_type,
            clip_sample=clip_sample,
        )

    def alpha(self, t: int) -> torch.Tensor:
        """Cumulative alpha at timestep ``t`` as a 0-d float32 tensor."""
        return _f32(self.alphas_cumprod[t])

    def add_noise(self, sample: torch.Tensor, noise: torch.Tensor, timestep) -> torch.Tensor:
        """q(x_t | x_0): √a_t · x0 + √(1 − a_t) · ε, at one int timestep
        (the sampler) or at (B,) timesteps, one a row (training)."""
        if not isinstance(timestep, torch.Tensor):
            a = self.alpha(int(timestep))
            return float(torch.sqrt(a)) * sample + float(torch.sqrt(1.0 - a)) * noise
        a = self._alphas(timestep, sample)
        return torch.sqrt(a) * sample + torch.sqrt(1.0 - a) * noise

    def get_velocity(self, sample: torch.Tensor, noise: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        """The v-prediction target at (B,) timesteps: √a_t · ε − √(1 − a_t) · x0."""
        a = self._alphas(timesteps, sample)
        return torch.sqrt(a) * noise - torch.sqrt(1.0 - a) * sample

    def _alphas(self, timesteps: torch.Tensor, sample: torch.Tensor) -> torch.Tensor:
        """a_t of (B,) timesteps in the sample's dtype, shaped (B, 1, …, 1)
        to broadcast over it (the JAX ``_left_broadcast``)."""
        table = torch.from_numpy(self.alphas_cumprod).to(sample.device)
        a = table[timesteps.to(device=sample.device, dtype=torch.int64)].to(sample.dtype)
        return a.reshape(a.shape + (1,) * (sample.ndim - a.ndim))


def inference_timesteps(num_train_timesteps: int, num_inference_steps: int) -> np.ndarray:
    """DDIM grid, "leading" spacing: round(arange(n) · (T // n)) reversed."""
    step_ratio = num_train_timesteps // num_inference_steps
    ts = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].copy()
    return ts.astype(np.int64)


def pred_x0_from_model_output(
    schedule: DiffusionSchedule,
    model_output: torch.Tensor,
    alpha_t: torch.Tensor,
    sample: torch.Tensor,
) -> torch.Tensor:
    """Predicted clean sample x0 from a model output (clipped), with
    ``alpha_t`` the 0-d float32 cumulative alpha of the current step."""
    beta_t = 1.0 - alpha_t
    pt = schedule.prediction_type
    if pt == "epsilon":
        x0 = (sample - float(torch.sqrt(beta_t)) * model_output) / float(torch.sqrt(alpha_t))
    elif pt == "sample":
        x0 = model_output
    elif pt == "v_prediction":
        x0 = float(torch.sqrt(alpha_t)) * sample - float(torch.sqrt(beta_t)) * model_output
    else:
        raise ValueError(pt)
    if schedule.clip_sample:
        r = schedule.clip_sample_range
        x0 = torch.clamp(x0, -r, r)
    return x0


def ddim_step(
    schedule: DiffusionSchedule,
    model_output: torch.Tensor,
    timestep: int,
    sample: torch.Tensor,
    num_inference_steps: int,
    eta: float = 0.0,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """One reverse DDIM update x_t → x_{t_prev}; ``eta > 0`` needs ``noise``."""
    prev_t = timestep - schedule.num_train_timesteps // num_inference_steps
    alpha_t = schedule.alpha(timestep)
    alpha_prev = schedule.alpha(prev_t) if prev_t >= 0 else _f32(schedule.final_alpha_cumprod)
    beta_t = 1.0 - alpha_t

    pt = schedule.prediction_type
    sa, sb = float(torch.sqrt(alpha_t)), float(torch.sqrt(beta_t))
    if pt == "epsilon":
        x0 = (sample - sb * model_output) / sa
        eps = model_output
    elif pt == "sample":
        x0 = model_output
        eps = (sample - sa * x0) / sb
    elif pt == "v_prediction":
        x0 = sa * sample - sb * model_output
        eps = sa * model_output + sb * sample
    else:
        raise ValueError(pt)

    if schedule.clip_sample:
        r = schedule.clip_sample_range
        x0 = torch.clamp(x0, -r, r)

    variance = (1.0 - alpha_prev) / (1.0 - alpha_t) * (1.0 - alpha_t / alpha_prev)
    std_dev_t = _f32(eta) * torch.sqrt(variance)
    direction = float(torch.sqrt(1.0 - alpha_prev - std_dev_t**2)) * eps
    prev_sample = float(torch.sqrt(alpha_prev)) * x0 + direction
    if eta > 0:
        if noise is None:
            raise ValueError("eta > 0 requires a noise array")
        prev_sample = prev_sample + float(std_dev_t) * noise
    return prev_sample


def dpmpp_2m_tables(
    schedule: DiffusionSchedule, ts_used: np.ndarray, num_inference_steps: int
) -> dict:
    """Per-step coefficients of DPM-Solver++(2M) (Lu et al. 2022,
    arXiv:2211.01095), data prediction, multistep; the port of
    ``said_tpu.diffusion.schedule.dpmpp_2m_tables`` (:217).

    With lambda = log(alpha / sigma), the update from step s0 to the
    previous timestep t is

        x_t = (sigma_t / sigma_s0) x − alpha_t (e^{−h} − 1) [D0 + (D0 − D1) / (2 r0)]

    (h = lambda_t − lambda_s0, r0 = h0 / h, D0 = x0(s0), D1 = the previous
    step's x0), written per step as

        new = c_x · x + c_d0 · x0 + (1 − first) · c_d1 · (x0 − prev_x0).

    ``first`` marks the first-order steps: the chain's first (no history)
    and the final boundary step, where sigma_t = 0 under
    ``set_alpha_to_one`` makes h infinite and x = x0 is exact. The tables
    are float64 host math cast to float32 (numpy arrays of len(ts_used)).
    """
    acp = np.asarray(schedule.alphas_cumprod, np.float64)
    ts = np.asarray(ts_used, np.int64)
    step = schedule.num_train_timesteps // num_inference_steps
    prev = ts - step
    a_cur = acp[ts]
    a_prev = np.where(prev >= 0, acp[np.maximum(prev, 0)], float(schedule.final_alpha_cumprod))
    alpha_c, sigma_c = np.sqrt(a_cur), np.sqrt(1.0 - a_cur)
    alpha_p, sigma_p = np.sqrt(a_prev), np.sqrt(1.0 - a_prev)
    with np.errstate(divide="ignore"):
        lam_c = np.log(alpha_c) - np.log(sigma_c)
        lam_p = np.log(alpha_p) - np.log(sigma_p)  # +inf where sigma_p == 0
    h = lam_p - lam_c
    k = len(ts)
    first = np.zeros(k)
    first[0] = 1.0
    first[~np.isfinite(h)] = 1.0

    c_x = np.where(sigma_c > 0, sigma_p / np.maximum(sigma_c, 1e-300), 0.0)
    # e^{−h} − 1, exactly −1 at h = inf (the x = x0 boundary)
    phi = np.where(np.isfinite(h), np.expm1(-np.where(np.isfinite(h), h, 0.0)), -1.0)
    c_d0 = -alpha_p * phi

    h0 = np.zeros(k)
    h0[1:] = lam_c[1:] - lam_c[:-1]
    safe_h = np.where((first > 0) | ~np.isfinite(h), 1.0, h)
    r0 = h0 / safe_h
    c_d1 = np.where(first > 0, 0.0, -0.5 * alpha_p * phi / np.maximum(r0, 1e-300))
    return {name: a.astype(np.float32) for name, a in
            (("c_x", c_x), ("c_d0", c_d0), ("c_d1", c_d1), ("first", first))}


def rescale_noise_cfg(
    noise_cfg: torch.Tensor, noise_pred_text: torch.Tensor, guidance_rescale: float
) -> torch.Tensor:
    """CFG rescale (Lin et al.), unbiased (ddof=1) std over non-batch axes."""
    dims = tuple(range(1, noise_pred_text.ndim))
    std_text = noise_pred_text.std(dim=dims, keepdim=True, correction=1)
    std_cfg = noise_cfg.std(dim=dims, keepdim=True, correction=1)
    rescaled = noise_cfg * (std_text / std_cfg)
    return guidance_rescale * rescaled + (1.0 - guidance_rescale) * noise_cfg


def cfg_combine(
    noise_pred_uncond: torch.Tensor,
    noise_pred_cond: torch.Tensor,
    guidance_scale: float,
    guidance_rescale: float = 0.0,
) -> torch.Tensor:
    """Classifier-free guidance with SAiD's combination
    ``cond + s · (cond − uncond)`` (an effective scale of 1 + s in the
    usual convention)."""
    noise_pred = noise_pred_cond + guidance_scale * (noise_pred_cond - noise_pred_uncond)
    if guidance_rescale > 0.0:
        noise_pred = rescale_noise_cfg(noise_pred, noise_pred_cond, guidance_rescale)
    return noise_pred
