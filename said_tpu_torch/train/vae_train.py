"""BCVAE training: the ELBO with a cyclical β and a velocity term.

Port of ``said_tpu.train.vae_train`` (reference ``script/train_vae.py``):
loss = 0.5·Σ(reconst − x)²/B + β·KLD + w_vel·0.5·Σ(Δreconst − Δx)²/B,
optionally reweighted by a per-channel std; AdamW lr 1e-4 with a linear
warm-up, global-norm clip 1.0, EMA 0.99. The optimizer is the SAiD
trainer's (optax's ``chain(clip_by_global_norm, adamw)`` written out),
over every parameter; a train step moves the BatchNorm running
statistics (the model's buffers) as the JAX step returns new
``batch_stats``. ε is injected or drawn from an explicit generator.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from said_tpu_torch.models.vae import BCVAE
from said_tpu_torch.train.ema import ema_update_
from said_tpu_torch.train.said_train import Optimizer, TrainState


@dataclasses.dataclass(frozen=True)
class VAETrainConfig:
    learning_rate: float = 1e-4
    warmup_steps: int = 0
    weight_vel: float = 1.0
    grad_clip: float = 1.0
    ema: bool = True
    ema_decay: float = 0.99


class VAETrainState(TrainState):
    """The SAiD train state's bookkeeping (checkpoint state, EMA export and
    swap) over every parameter of the BCVAE; its BatchNorm statistics are
    the model's buffers, so ``state_dict`` carries them."""

    def __init__(self, model: BCVAE, config: VAETrainConfig):
        self.model, self.config = model, config
        self.params = dict(model.named_parameters())
        self.optimizer = Optimizer(self.params.values(), learning_rate=config.learning_rate,
                                   warmup_steps=config.warmup_steps, grad_clip=config.grad_clip)
        self.ema = {n: p.detach().clone() for n, p in self.params.items()} if config.ema else None
        self.step = 0


def elbo_loss(
    model: BCVAE,
    coeffs: torch.Tensor,  # (B, T, C)
    std: Optional[torch.Tensor],  # (C,) or None
    config: VAETrainConfig,
    beta: float,
    train: bool = True,
    use_noise: bool = True,
    eps: Optional[torch.Tensor] = None,  # (B, z) injected
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The JAX ``elbo_loss``: the loss and its parts. ``train`` normalises
    with the batch statistics and moves the running ones; ``use_noise=False``
    decodes the mean."""
    b = coeffs.shape[0]
    out = model(coeffs, use_noise=use_noise, train=train, eps=eps, generator=generator)
    answer, pred = coeffs, out.coeffs_reconst
    if std is not None:
        inv = 1.0 / std.reshape(1, 1, -1)
        answer, pred = answer * inv, pred * inv
    loss_reconst = 0.5 * ((answer - pred) ** 2).sum() / b
    loss_kld = 0.5 * (out.mean**2 + torch.exp(out.log_var) - out.log_var - 1.0).sum(dim=1).mean()
    a_diff, p_diff = answer[:, 1:] - answer[:, :-1], pred[:, 1:] - pred[:, :-1]
    loss_vel = 0.5 * ((a_diff - p_diff) ** 2).sum() / b
    loss = loss_reconst + beta * loss_kld + config.weight_vel * loss_vel
    return loss, {"loss": loss, "loss_reconst": loss_reconst, "loss_kld": loss_kld, "loss_velocity": loss_vel}


def train_step(state: VAETrainState, coeffs: torch.Tensor, std: Optional[torch.Tensor], beta: float,
               eps: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None) -> Dict[str, float]:
    """One step (the JAX ``make_train_step``): the loss in train mode (the
    running statistics move), its gradients, the optimizer update, the
    EMA step at the pre-increment step count. Returns the metrics as
    floats."""
    loss, metrics = elbo_loss(state.model, coeffs, std, state.config, beta, True, eps=eps, generator=generator)
    params = list(state.params.values())
    grads = torch.autograd.grad(loss, params)
    state.optimizer.update(grads)
    if state.ema is not None:
        ema_update_(state.ema.values(), params, state.config.ema_decay, state.step)
    state.step += 1
    return {k: float(v.detach()) for k, v in metrics.items()}


@torch.no_grad()
def eval_step(model: BCVAE, coeffs: torch.Tensor, std: Optional[torch.Tensor], config: VAETrainConfig,
              beta: float, generator: Optional[torch.Generator] = None,
              eps: Optional[torch.Tensor] = None) -> Dict[str, float]:
    """The validation loss (running statistics, ε drawn or injected), as floats."""
    _, metrics = elbo_loss(model, coeffs, std, config, beta, False, eps=eps, generator=generator)
    return {k: float(v) for k, v in metrics.items()}
