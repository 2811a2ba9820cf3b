"""The sampling chain as a host loop over denoise steps: DDIM or
DPM-Solver++(2M).

Port of ``said_tpu.diffusion.sampler`` (``prepare_chain`` :62,
``make_step`` :115, ``finalize_chain`` :189, ``sample`` :195):
classifier-free guidance with SAiD's combination, guidance rescale,
eta-noised DDIM steps, DPM-Solver++(2M) with its (latent, previous x0)
carry, partial-strength denoising of an initial sample, and masked
editing that re-noises the initial latents to the *next* timestep each
step (for both solvers). Where the JAX package scans the chain inside
one compiled program, this runs one eager denoiser call per step.

torch and JAX draw different numbers from the same seed, so callers may
inject every random array: the initial latents (the pipeline), the
per-step eta noise (``eta_noise``, (K, B, T, C)) and the editing noise
(``edit_noise``, (B, T, C)). Whatever is not injected is drawn with the
given ``torch.Generator`` (or a ``parallel.mesh.SlicedGenerator``, which
draws the whole clip's noise and keeps this rank's frames).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from said_tpu_torch.core import trace
from said_tpu_torch.diffusion.schedule import (
    DiffusionSchedule,
    cfg_combine,
    ddim_step,
    dpmpp_2m_tables,
    inference_timesteps,
    pred_x0_from_model_output,
)
from said_tpu_torch.parallel.mesh import randn

SOLVERS = ("ddim", "dpmpp_2m")


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Sampling options (reference defaults)."""

    num_inference_steps: int = 100
    strength: float = 1.0
    guidance_scale: float = 2.5
    guidance_rescale: float = 0.0
    eta: float = 0.0
    # "ddim" (the reference's sampler) or "dpmpp_2m" (DPM-Solver++(2M), a
    # deterministic second-order multistep solver: far fewer steps)
    solver: str = "ddim"

    def __post_init__(self):
        if self.solver not in SOLVERS:
            raise ValueError(f"unknown solver: {self.solver!r}")
        if self.solver == "dpmpp_2m" and self.eta > 0:
            raise ValueError("dpmpp_2m is a deterministic (ODE) solver; eta > 0 is DDIM-only")

    @property
    def do_cfg(self) -> bool:
        return self.guidance_scale > 1.0


def num_used_steps(config: SamplerConfig) -> int:
    """Length of the denoise chain after the strength cut."""
    n = config.num_inference_steps
    return min(int(n * config.strength), n)


@dataclasses.dataclass
class Chain:
    """Everything the step loop needs, from :func:`prepare_chain`."""

    latents: torch.Tensor
    init_latents: torch.Tensor
    edit_noise: Optional[torch.Tensor]
    ts_used: np.ndarray  # timesteps of the used steps, descending
    ts_next: np.ndarray  # timestep of the following step; -1 after the last
    dpm: Optional[dict] = None  # dpmpp_2m_tables(...) for the used steps


def _randn_like(x: torch.Tensor, generator) -> torch.Tensor:
    return randn(x.shape, generator, x.device, x.dtype)


def prepare_chain(
    schedule: DiffusionSchedule,
    config: SamplerConfig,
    latents: torch.Tensor,
    init_samples: Optional[torch.Tensor],
    latent_scale: float,
    edit_noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Chain:
    """Latent scaling, editing-path noising and the timestep tables."""
    n = config.num_inference_steps
    ts_all = inference_timesteps(schedule.num_train_timesteps, n)
    latents = latents * (latent_scale * schedule.init_noise_sigma)
    init_latents = latents
    t_start = n - num_used_steps(config)
    ts_used = ts_all[t_start:]
    ts_next = np.concatenate([ts_all[t_start + 1 :], [-1]]).astype(np.int64)
    noise = None
    if init_samples is not None:
        # partial-strength editing: noise the inits to the first used timestep
        noise = _randn_like(latents, generator) if edit_noise is None else edit_noise
        latents = schedule.add_noise(latents, noise, int(ts_used[0]))
    dpm = dpmpp_2m_tables(schedule, ts_used, n) if config.solver == "dpmpp_2m" else None
    return Chain(latents, init_latents, noise, ts_used, ts_next, dpm)


def make_step(
    schedule: DiffusionSchedule,
    denoise_fn: Callable[[torch.Tensor, int], torch.Tensor],
    config: SamplerConfig,
    chain: Chain,
    mask: Optional[torch.Tensor],
    cfg_folded: bool,
) -> Callable[[torch.Tensor, Optional[torch.Tensor], int, Optional[torch.Tensor]],
              Tuple[torch.Tensor, Optional[torch.Tensor]]]:
    """The per-step update ``(lat, prev_x0, i, eta_noise) -> (new_lat, x0)``
    for used step ``i``; ``x0`` (the DPM++ carry) is None under DDIM.

    ``denoise_fn(x, t)`` predicts noise; with ``cfg_folded`` it takes the
    un-duplicated (B, ...) latent and returns (2B, ...) predictions itself
    (uncond first), so the step skips its own batch doubling.
    """
    cfg = config
    n = cfg.num_inference_steps

    def step(lat, prev_x0, i, eta_noise):
        t, t_next = int(chain.ts_used[i]), int(chain.ts_next[i])
        model_in = torch.cat([lat, lat]) if cfg.do_cfg and not cfg_folded else lat
        noise_pred = denoise_fn(model_in, t)
        if cfg.do_cfg:
            uncond_pred, cond_pred = noise_pred.chunk(2)
            noise_pred = cfg_combine(uncond_pred, cond_pred, cfg.guidance_scale, cfg.guidance_rescale)
        x0 = None
        if chain.dpm is not None:
            tab = chain.dpm
            x0 = pred_x0_from_model_output(schedule, noise_pred, schedule.alpha(t), lat)
            # (1 − first) · c_d1 formed in float32, as the JAX step does
            c_hist = float((np.float32(1.0) - tab["first"][i]) * tab["c_d1"][i])
            new_lat = float(tab["c_x"][i]) * lat + float(tab["c_d0"][i]) * x0
            new_lat = new_lat + c_hist * (x0 - prev_x0)
        else:
            new_lat = ddim_step(schedule, noise_pred, t, lat, n, eta=cfg.eta, noise=eta_noise)
        if mask is not None:
            init_noisy = (
                schedule.add_noise(chain.init_latents, chain.edit_noise, t_next)
                if t_next >= 0
                else chain.init_latents
            )
            new_lat = init_noisy * mask + new_lat * (1.0 - mask)
        return new_lat, x0

    return step


def finalize_chain(latents: torch.Tensor, latent_scale: float) -> torch.Tensor:
    """Unscale and clip to [0, 1]."""
    return torch.clamp(latents / latent_scale, 0.0, 1.0)


def sample(
    schedule: DiffusionSchedule,
    denoise_fn: Callable[[torch.Tensor, int], torch.Tensor],
    latents: torch.Tensor,
    config: SamplerConfig,
    init_samples: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    latent_scale: float = 1.0,
    save_intermediate: bool = False,
    cfg_folded: bool = False,
    eta_noise: Optional[torch.Tensor] = None,
    edit_noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Run the reverse chain. Returns ``(result (B, T, C) in [0, 1],
    intermediates (K, B, T, C) or None)``; intermediate k is the latent
    entering step k, as in the JAX sampler.

    ``mask`` (1 = keep the init) applies only with ``init_samples``.
    """
    dev = latents.device
    with trace.span(trace.DENOISE, dev):
        chain = prepare_chain(
            schedule, config, latents, init_samples, latent_scale, edit_noise, generator
        )
        k = len(chain.ts_used)
        if eta_noise is not None and eta_noise.shape[0] != k:
            raise ValueError(f"eta_noise holds {eta_noise.shape[0]} steps, the chain has {k}")
        step = make_step(
            schedule, denoise_fn, config, chain,
            mask if init_samples is not None else None, cfg_folded,
        )
        lat = chain.latents
        x0 = torch.zeros_like(lat) if chain.dpm is not None else None
        interms: List[torch.Tensor] = []
        for i in range(k):
            with trace.span(trace.STEP, dev, i=i):
                if save_intermediate:
                    interms.append(lat)
                noise_i = None
                if config.eta > 0:
                    noise_i = eta_noise[i] if eta_noise is not None else _randn_like(lat, generator)
                lat, x0 = step(lat, x0, i, noise_i)
        result = finalize_chain(lat, latent_scale)
        return result, torch.stack(interms) if save_intermediate else None
