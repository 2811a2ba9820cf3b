"""SAiD denoiser training: the loss, the optimizer, EMA and the train step.

Port of ``said_tpu.train.said_train`` (reference ``script/train.py``):

- loss = L1(pred, answer) + w_vel·L1(Δpred, Δanswer)
  [+ w_vertex·L1 through per-person normalised blendshape deltas], the
  answer by prediction type (noise, x0 or velocity), optional
  per-channel std reweighting, masked reductions for bucketed windows;
- the audio encoder frozen (it runs under ``no_grad``, and neither the
  optimizer nor the EMA holds it); AdamW at lr 1e-5 with a linear warm-up,
  global-norm clip 1.0, EMA 0.9999 with its warm-up; a non-finite loss
  skips the update (the NaN guard).

The optimizer is optax's ``chain(clip_by_global_norm, adamw)``, written
out here (``Optimizer``); ``torch.optim`` differs from it in three places
(see there). Randomness (timesteps, noise, dropout) is drawn from one
explicit ``torch.Generator``; the tests inject timesteps and noise.

Data-parallel training (``cli/train.py --mesh_data``): each rank computes
the loss of its rows with the global batch's denominators
(``global_batch``) and draws every random array at the global batch's
shape from a generator every rank seeds alike
(``parallel.mesh.SlicedGenerator``); ``train_step`` sums the gradients
and the metrics over the data axis (``reduce_group``) before the
global-norm clip, so N ranks take the step one process takes on the
whole batch (the JAX package's one jitted step with sharded inputs).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from said_tpu_torch.diffusion.schedule import DiffusionSchedule
from said_tpu_torch.models.said import SAID
from said_tpu_torch.parallel.mesh import randint, randn
from said_tpu_torch.train.ema import ema_update_


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-5
    warmup_steps: int = 0  # the CLI sets steps an epoch × warm-up epochs
    weight_vel: float = 1.0
    weight_vertex: float = 0.02
    grad_clip: float = 1.0
    ema: bool = True
    ema_decay: float = 0.9999
    prediction_type: str = "epsilon"
    # the reference trains with the frozen encoder in train mode (dropout,
    # layerdrop); False runs it deterministic
    encoder_train_mode: bool = True


# Parameters under these prefixes are frozen during SAiD training (the
# audio encoder, reference script/train.py:547-548).
FROZEN_PREFIXES = ("audio_encoder.",)


def trainable_parameters(model: SAID) -> Dict[str, torch.nn.Parameter]:
    """The trainable parameters by their ``state_dict`` name: all but the
    audio encoder's."""
    return {n: p for n, p in model.named_parameters() if not n.startswith(FROZEN_PREFIXES)}


def freeze_encoder_(model: SAID) -> None:
    """Mark the audio encoder's parameters as needing no gradient."""
    for p in model.audio_encoder.parameters():
        p.requires_grad_(False)


def said_loss(
    model: SAID,
    schedule: DiffusionSchedule,
    waveform: torch.Tensor,  # (B, T_a) processed
    coeffs: torch.Tensor,  # (B, T, C)
    cond: torch.Tensor,  # (B,) bool
    std: Optional[torch.Tensor],  # (C,) or None
    blendshape_delta: Optional[torch.Tensor],  # (B, K, V, 3) or None
    config: TrainConfig,
    train: bool = True,
    mask_time_indices: Optional[torch.Tensor] = None,  # (B, window) bool
    window_real: Optional[int] = None,  # real frames in a padded window
    input_length: Optional[int] = None,  # real samples in a padded waveform
    timesteps: Optional[torch.Tensor] = None,  # (B,) injected
    noise: Optional[torch.Tensor] = None,  # (B, T, C) injected
    generator: Optional[torch.Generator] = None,
    global_batch: Optional[int] = None,  # data parallel: the global batch's rows
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The randomised-noise training loss and its parts (the JAX
    ``said_loss``). Timesteps and noise not injected are drawn from
    ``generator``; ``train`` runs the UNet's dropout (and, with
    ``config.encoder_train_mode``, the encoder's) from it too.

    With ``window_real``/``input_length`` the batch is padded to a
    bucketed shape and every reduction is masked to the real frames,
    numerically an unpadded batch of the real window.

    ``global_batch``: these B rows are one data-parallel rank's share of a
    batch of ``global_batch`` rows; every loss term is divided by the
    global batch's count, so the ranks' losses (and gradients) sum to the
    whole batch's. Draw through a ``SlicedGenerator`` then."""
    b, window, c = coeffs.shape
    dev = coeffs.device
    dynamic = window_real is not None
    if generator is None and (train or timesteps is None or noise is None):
        raise ValueError("said_loss: draws timesteps, noise or dropout, so it needs a generator")
    frame_mask = None
    if dynamic:
        frame_mask = (torch.arange(window, device=dev) < int(window_real)).float()

    coeff_latents = coeffs * model.latent_scale
    if timesteps is None:
        timesteps = randint(schedule.num_train_timesteps, (b,), generator, dev)

    encoder_stochastic = train and config.encoder_train_mode
    cond_embedding = model.get_audio_embedding(
        waveform, window,
        input_length if dynamic else None, window_real if dynamic else None,
        mask_time_indices=mask_time_indices,
        generator=generator if encoder_stochastic else None,
    )
    uncond_embedding = model.null_embedding(b, cond_embedding.shape[1])
    audio_embedding = torch.where(cond.reshape(-1, 1, 1).to(dev), cond_embedding, uncond_embedding)

    if noise is None:
        noise = randn(coeff_latents.shape, generator, dev, coeff_latents.dtype)
    noisy = schedule.add_noise(coeff_latents, noise, timesteps)
    velocity = schedule.get_velocity(coeff_latents, noise, timesteps)

    pred = model(noisy, timesteps, audio_embedding, seq_len_real=window_real if dynamic else None,
                 generator=generator if train else None)

    answer = {"epsilon": noise, "sample": coeff_latents}.get(config.prediction_type, velocity)
    if std is not None:
        inv = 1.0 / std.reshape(1, 1, -1)
        answer_rw, pred_rw = answer * inv, pred * inv
    else:
        answer_rw, pred_rw = answer, pred

    vel_diff = (pred_rw[:, 1:] - pred_rw[:, :-1]) - (answer_rw[:, 1:] - answer_rw[:, :-1])
    if dynamic:
        m = frame_mask[None, :, None]
        loss_pred = ((pred_rw - answer_rw).abs() * m).sum() / (frame_mask.sum() * b * c)
        pairs = frame_mask[1:] * frame_mask[:-1]
        loss_vel = (vel_diff.abs() * pairs[None, :, None]).sum() / (pairs.sum().clamp(min=1.0) * b * c)
    else:
        loss_pred = (pred_rw - answer_rw).abs().mean()
        loss_vel = vel_diff.abs().mean()

    # a rank's share of the global batch's means
    share = (lambda v: v * (b / global_batch)) if global_batch not in (None, b) else (lambda v: v)
    loss_pred, loss_vel = share(loss_pred), share(loss_vel)
    loss = loss_pred + config.weight_vel * loss_vel
    metrics = {"loss_predict": loss_pred, "loss_velocity": loss_vel}

    if blendshape_delta is not None:
        bd = blendshape_delta
        bsz, k, v, i = bd.shape
        norm = bd.abs().sum(dim=(1, 2, 3)) / (k * v * i)
        bd_normalized = (bd / norm.reshape(-1, 1, 1, 1)).reshape(bsz, k, v * i)
        # Reference parity: script/train.py:118-120 reweights by std with an
        # IN-PLACE ``/=`` on the very tensors its vertex loss then reads
        # (train.py:143-149), so with std given the vertex loss runs on the
        # std-reweighted pred and answer: reproduced by using pred_rw and
        # answer_rw here (said_tpu/train/said_train.py:234-241, 268-273).
        be_answer = torch.einsum("btk,bkd->btd", answer_rw, bd_normalized)
        be_pred = torch.einsum("btk,bkd->btd", pred_rw, bd_normalized)
        if dynamic:
            mv = frame_mask[None, :, None]
            loss_vertex = ((be_pred - be_answer).abs() * mv).sum() / (frame_mask.sum() * bsz * (v * i))
        else:
            loss_vertex = (be_pred - be_answer).abs().mean()
        loss_vertex = share(loss_vertex)
        loss = loss + config.weight_vertex * loss_vertex
        metrics["loss_vertex"] = loss_vertex

    metrics["loss"] = loss
    return loss, metrics


class Optimizer:
    """optax's ``chain(clip_by_global_norm(clip), adamw(schedule, b1=0.9,
    b2=0.999, eps=1e-8, weight_decay=0.01))``, as the JAX package builds it
    (``make_optimizer``), in place on a list of float32 parameters.

    Where optax is not ``torch.optim``:
    - the clip scales by max_norm / norm only where norm ≥ max_norm, and
      has no 1e-6 in the divisor (``clip_grad_norm_`` has);
    - the warm-up is ``linear_schedule(0, lr, warmup)`` keyed on the
      optimizer's own update count, so the first update has lr 0;
    - the update is p + (−lr)·(m̂/(√v̂ + eps) + wd·p), decay inside the
      scaled update, all in float32 (f32 scalars formed as optax forms
      them).
    The state is the count and the two moments; the NaN guard of
    ``train_step`` skips ``update`` whole, so a skipped step keeps the old
    count (the bias correction's and the schedule's) as well.

    The SAiD and the BCVAE trainers share it: the learning rate, its
    warm-up steps and the clip norm are keywords, or are read from
    ``config`` (any object with those three fields).
    """

    b1, b2, eps, weight_decay = 0.9, 0.999, 1e-8, 0.01

    def __init__(self, params: Sequence[torch.Tensor], config=None, *, learning_rate: float = 1e-5,
                 warmup_steps: int = 0, grad_clip: float = 1.0):
        if config is not None:
            learning_rate, warmup_steps, grad_clip = config.learning_rate, config.warmup_steps, config.grad_clip
        self.params = list(params)
        self.lr, self.warmup_steps, self.grad_clip = learning_rate, warmup_steps, grad_clip
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def learning_rate(self, count: int) -> float:
        """The schedule at update ``count`` (before it is applied)."""
        lr, warmup = np.float32(self.lr), self.warmup_steps
        if warmup > 0 and count < warmup:
            frac = np.float32(1.0) - np.float32(count) / np.float32(warmup)
            return float((np.float32(0.0) - lr) * frac + lr)
        return float(lr)

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]) -> None:
        """One optimizer update of the parameters from their gradients."""
        grads = [g.float() for g in grads]
        max_norm = self.grad_clip
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        # clip_by_global_norm: (g / norm) · max_norm where norm ≥ max_norm,
        # g itself below it, chosen on the device (no host sync)
        below = norm < max_norm
        grads = torch._foreach_div(grads, torch.where(below, 1.0, norm))
        torch._foreach_mul_(grads, torch.where(below, 1.0, torch.tensor(max_norm, device=norm.device)))

        # moments: decay·m + (1 − decay)·g, with 1 − decay formed in
        # float64 and then rounded, as optax's Python-float arithmetic does
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1.0 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2))
        lr = self.learning_rate(self.count)
        self.count += 1
        # bias corrections 1 − decay^count in float32
        bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(self.count))
        bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(self.count))
        den = torch._foreach_sqrt(torch._foreach_div(self.nu, bc2))
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(torch._foreach_div(self.mu, bc1), den)
        torch._foreach_add_(upd, torch._foreach_mul(self.params, self.weight_decay))
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(self.params, upd)

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": list(self.mu), "nu": list(self.nu)}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        with torch.no_grad():
            for mine, theirs in ((self.mu, state["mu"]), (self.nu, state["nu"])):
                for m, t in zip(mine, theirs, strict=True):
                    m.copy_(t)


class TrainState:
    """What a training run carries from step to step: the model (its
    frozen encoder included), the trainable parameters, the optimizer over
    them, their EMA (None with ``config.ema`` off) and the step count,
    which drives the EMA's warm-up and increments on every step, skipped
    or not."""

    def __init__(self, model: SAID, config: TrainConfig):
        freeze_encoder_(model)
        self.model, self.config = model, config
        self.params = trainable_parameters(model)
        self.optimizer = Optimizer(self.params.values(), learning_rate=config.learning_rate,
                                   warmup_steps=config.warmup_steps, grad_clip=config.grad_clip)
        self.ema = {n: p.detach().clone() for n, p in self.params.items()} if config.ema else None
        self.step = 0

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "ema": self.ema}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        if (self.ema is None) != (state["ema"] is None):
            raise ValueError("the checkpoint's EMA and this run's --ema disagree")
        if self.ema is not None:
            with torch.no_grad():
                for name, e in self.ema.items():
                    e.copy_(state["ema"][name])
        self.step = int(state["step"])

    def export_state_dict(self) -> Dict[str, torch.Tensor]:
        """The full model ``state_dict`` with the EMA weights in place of
        the trainable ones (the reference saves EMA weights), on the CPU."""
        sd = {k: v.detach().cpu() for k, v in self.model.state_dict().items()}
        for name, e in (self.ema or {}).items():
            sd[name] = e.detach().cpu()
        return sd

    @contextlib.contextmanager
    def ema_weights(self):
        """Run the model with the EMA weights in place of the trainable
        ones (validation), restoring them after."""
        if self.ema is None:
            yield
            return
        params = list(self.params.values())
        with torch.no_grad():
            backup = [p.detach().clone() for p in params]
            torch._foreach_copy_(params, list(self.ema.values()))
        try:
            yield
        finally:
            with torch.no_grad():
                torch._foreach_copy_(params, backup)


def train_step(state: TrainState, schedule: DiffusionSchedule, batch: Dict, generator: torch.Generator,
               reduce_group=None) -> Dict[str, float]:
    """One training step on ``batch`` (``said_loss``'s keyword inputs):
    the loss and its gradients with respect to the trainable parameters,
    then, if the loss is finite, the optimizer update and the EMA step.

    ``reduce_group`` (a process group): ``batch`` is this rank's rows of a
    data-parallel batch (with ``global_batch``); the gradients and the
    metrics are summed over the group, in one ``all_reduce`` each, before
    the clip, so every rank clips and steps on the whole batch's gradient.

    NaN guard (said_tpu/train/said_train.py:397-416): a non-finite loss
    skips the update, so the parameters, the optimizer's state (its count
    too) and the EMA stay as they were; ``state.step`` still increments.
    Reading the loss is the step's one host sync. Returns the metrics as
    floats, with ``nan_skipped``."""
    loss, metrics = said_loss(state.model, schedule, config=state.config, train=True, generator=generator, **batch)
    params = list(state.params.values())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    if reduce_group is not None:
        grads = _all_reduce_sum(grads, reduce_group)
        metrics = dict(zip(metrics, _all_reduce_sum([v.detach() for v in metrics.values()], reduce_group)))
    out = {k: float(v.detach()) for k, v in metrics.items()}
    ok = math.isfinite(out["loss"])
    if ok:
        state.optimizer.update(grads)
        if state.ema is not None:
            ema_update_(state.ema.values(), params, state.config.ema_decay, state.step)
    state.step += 1
    out["nan_skipped"] = 0.0 if ok else 1.0
    return out


@torch.no_grad()
def _all_reduce_sum(tensors: Sequence[torch.Tensor], group) -> list[torch.Tensor]:
    """The tensors summed over ``group``: one ``all_reduce`` of their
    float32 concatenation, split back to their shapes and dtypes."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    torch.distributed.all_reduce(flat, group=group)
    return [part.reshape(t.shape).to(t.dtype) for part, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


@torch.no_grad()
def eval_step(model: SAID, schedule: DiffusionSchedule, batch: Dict, config: TrainConfig,
              generator: torch.Generator) -> Dict[str, float]:
    """The validation loss (deterministic model; timesteps and noise drawn
    from ``generator``), as floats."""
    _, metrics = said_loss(model, schedule, config=config, train=False, generator=generator, **batch)
    return {k: float(v) for k, v in metrics.items()}
