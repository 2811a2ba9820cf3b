"""Generation with the plain SAiD: classifier-free guidance and
DPM-Solver++(2M) over the cosine schedule, from the published formulas.

Schedule: diffusers' DDIM scheduler as SAiD configures it
(``squaredcos_cap_v2`` betas capped at 0.999, ``set_alpha_to_one``,
x0 clipped to [−1, 1], "leading" spacing: t_k = k · (1000 // n)).
Solver: Lu et al., "DPM-Solver++" (arXiv:2211.01095), multistep second
order in data prediction, λ = log(α/σ):

    x_t = (σ_t/σ_s)·x − α_t·(e^{−h} − 1)·D,   h = λ_t − λ_s,
    D = x0 on the first step and where σ_t = 0 (the last step, x_t = x0),
    D = (1 + 1/(2r))·x0 − 1/(2r)·x0_prev otherwise, r = h_prev / h.

Guidance is SAiD's: ε = ε_c + s·(ε_c − ε_u). The result is clipped to
[0, 1]. Scalars are float64 on the host; tensors are float32.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from port_bench.reference.said import NO_DRAWS, SAiD, Precision

TRAIN_STEPS = 1000


def alphas_cumprod(n: int = TRAIN_STEPS) -> np.ndarray:
    """ᾱ_t of the capped cosine schedule (float64)."""
    def f(u):
        return math.cos((u + 0.008) / 1.008 * math.pi / 2) ** 2

    betas = np.array([min(1.0 - f((i + 1) / n) / f(i / n), 0.999) for i in range(n)])
    return np.cumprod(1.0 - betas)


def timesteps(steps: int, n: int = TRAIN_STEPS) -> np.ndarray:
    return (np.arange(steps) * (n // steps))[::-1].copy()


def normalise(wave: np.ndarray) -> np.ndarray:
    """Wav2Vec2Processor's per-utterance normalisation of a raw waveform
    (T,): (x − mean) / √(var + 1e-7), as (1, T) float32."""
    x = np.asarray(wave, np.float64)
    return ((x - x.mean()) / np.sqrt(x.var() + 1e-7)).astype(np.float32)[None]


@torch.no_grad()
def embed(model: SAiD, wave: torch.Tensor, frames: int, prec: Precision) -> torch.Tensor:
    return model.audio_encoder(wave, frames, prec)


@torch.no_grad()
def denoise(model: SAiD, x: torch.Tensor, t: int, emb: torch.Tensor, prec: Precision) -> torch.Tensor:
    """The guided pair's noise predictions for latents x (B, T, C):
    (2B, T, C), unconditional rows first."""
    b = x.shape[0]
    context = torch.cat([model.null_cond_emb.expand(b, emb.shape[1], -1), emb])
    tt = torch.full((2 * b,), t, dtype=torch.int64, device=x.device)
    return model.unet(torch.cat([x, x]), tt, context, prec, NO_DRAWS)


@torch.no_grad()
def generate(model: SAiD, emb: torch.Tensor, latents: torch.Tensor, steps: int, guidance: float,
             prec: Precision, first_eps: Optional[list] = None) -> torch.Tensor:
    """DPM-Solver++(2M) from ``latents`` (B, T, C) → coefficients in [0, 1].
    ``first_eps``, if a list, receives the first step's predictions."""
    acp = alphas_cumprod()
    step = TRAIN_STEPS // steps
    x, x0_prev, h_prev = latents, None, None
    for t in timesteps(steps):
        eps = denoise(model, x, int(t), emb, prec)
        if first_eps is not None and not first_eps:
            first_eps.append(eps)
        eps_u, eps_c = eps.chunk(2)
        eps = eps_c + guidance * (eps_c - eps_u)
        a_s = acp[t]
        x0 = ((x - math.sqrt(1.0 - a_s) * eps) / math.sqrt(a_s)).clamp(-1.0, 1.0)
        a_t = acp[t - step] if t - step >= 0 else 1.0
        if a_t >= 1.0:
            x = x0
        else:
            h = (math.log(math.sqrt(a_t)) - math.log(math.sqrt(1.0 - a_t))) - (
                math.log(math.sqrt(a_s)) - math.log(math.sqrt(1.0 - a_s)))
            if x0_prev is None:
                d = x0
            else:
                r = h_prev / h
                d = (1.0 + 1.0 / (2.0 * r)) * x0 - (1.0 / (2.0 * r)) * x0_prev
            x = math.sqrt((1.0 - a_t) / (1.0 - a_s)) * x - math.sqrt(a_t) * math.expm1(-h) * d
            h_prev = h
        x0_prev = x0
    return x.clamp(0.0, 1.0)
