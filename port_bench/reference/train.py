"""SAiD's training step with the plain SAiD: loss, backward, the clipped
AdamW update and the EMA, from the published training script
(``script/train.py``: L1 on the noise plus L1 on its frame-to-frame
velocity, the audio encoder frozen but in train mode, CFG dropout by a
per-row condition flag) and optax's ``chain(clip_by_global_norm(1.0),
adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01))``.

A batch arrives as the program's feed has it, padded to a frame bucket;
this step computes on the real frames alone, and draws its timesteps,
noise and dropout at the padded shapes (``Draws``), in the order the
published step draws them, from the generator it is given.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from port_bench.reference.said import Draws, Precision, SAiD
from port_bench.reference.sample import TRAIN_STEPS, alphas_cumprod

B1, B2, EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 0.01


def trainable(model: SAiD) -> Dict[str, torch.nn.Parameter]:
    return {n: p for n, p in model.named_parameters() if not n.startswith("audio_encoder.")}


def loss(model: SAiD, batch: dict, generator: torch.Generator, prec: Precision, weight_vel: float = 1.0):
    """The step's loss on ``batch`` (waveform (B, T_a) normalised and
    padded, coeffs (B, T_pad, C), cond (B,), mask_time_indices (B, T_pad),
    window_real, input_length)."""
    coeffs = batch["coeffs"]
    b, t_pad, c = coeffs.shape
    t, n = int(batch["window_real"]), int(batch["input_length"])
    dev = generator.device
    draws = Draws(generator, t_pad)
    ts = torch.randint(0, TRAIN_STEPS, (b,), generator=generator, device=dev)
    with torch.no_grad():
        emb = model.audio_encoder(batch["waveform"][:, :n], t, prec, draws, batch["mask_time_indices"][:, :t])
    context = torch.where(batch["cond"].reshape(-1, 1, 1), emb, model.null_cond_emb.expand(b, t, -1))
    noise = torch.randn((b, t_pad, c), generator=generator, device=dev)[:, :t]
    x0 = coeffs[:, :t]
    a = torch.from_numpy(alphas_cumprod()).float().to(coeffs.device)[ts].reshape(b, 1, 1)
    noisy = a.sqrt() * x0 + (1.0 - a).sqrt() * noise
    pred = model.unet(noisy, ts, context, prec, draws)
    vel = (pred[:, 1:] - pred[:, :-1]) - (noise[:, 1:] - noise[:, :-1])
    return (pred - noise).abs().mean() + weight_vel * vel.abs().mean()


def run_steps(model: SAiD, batches: List[dict], generator: torch.Generator, prec: Precision, lr: float = 1e-5,
              clip: float = 1.0, ema_decay: float = 0.9999) -> dict:
    """Train ``len(batches)`` steps in place. Returns each step's loss, the
    first step's clipped gradient, and the trainable parameters and their
    EMA before the first step and after the last, by name."""
    for p in model.audio_encoder.parameters():
        p.requires_grad_(False)
    params = trainable(model)
    names = list(params)
    before = {k: p.detach().clone() for k, p in params.items()}
    ema = {k: p.detach().clone() for k, p in params.items()}
    mu = {k: torch.zeros_like(p) for k, p in params.items()}
    nu = {k: torch.zeros_like(p) for k, p in params.items()}
    losses, first_grad = [], None
    for step, batch in enumerate(batches, start=1):
        with prec.backend():
            value = loss(model, batch, generator, prec)
            grads = torch.autograd.grad(value, [params[k] for k in names], allow_unused=True)
        losses.append(float(value.detach()))
        grads = {k: torch.zeros_like(params[k]) if g is None else g for k, g in zip(names, grads)}
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
        if norm >= clip:
            grads = {k: g / norm * clip for k, g in grads.items()}
        if first_grad is None:
            first_grad = {k: g.clone() for k, g in grads.items()}
        with torch.no_grad():
            for k in names:
                p, g = params[k], grads[k]
                mu[k] = B1 * mu[k] + (1.0 - B1) * g
                nu[k] = B2 * nu[k] + (1.0 - B2) * g * g
                m_hat = mu[k] / (1.0 - B1 ** step)
                v_hat = nu[k] / (1.0 - B2 ** step)
                p.add_(-lr * (m_hat / (v_hat.sqrt() + EPS) + WEIGHT_DECAY * p))
            d = float(min(np.float32(ema_decay), (1.0 + (step - 1)) / (10.0 + (step - 1))))
            for k in names:
                ema[k] = d * ema[k] + (1.0 - d) * params[k].detach()
    return {"losses": losses, "first_grad": first_grad, "before": before,
            "after": {k: p.detach().clone() for k, p in params.items()}, "ema": ema}
