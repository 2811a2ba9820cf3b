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

Parallel training (``cli/train.py --mesh_data/--mesh_model/--mesh_seq``),
N ranks taking the step one process takes on the whole batch (the JAX
package's one jitted step with sharded inputs and parameters):

- data: each rank computes the loss of its rows with the global batch's
  denominators (``global_batch``) and draws every random array at the
  global batch's shape from a generator every rank seeds alike
  (``parallel.mesh.SlicedGenerator``);
- seq: each rank holds a block of the window's frames (``seq_group``);
  its loss is its frames' sums over the window's counts, the velocity
  term reaching the next rank's first frame, and the model's collectives
  carry the gradient between the ranks;
- model: the model's parameters are sharded (``parallel.tensor``); the
  global-norm clip counts each sharded tensor once across the model axis,
  and ``state_dict``/``export_state_dict`` gather whole tensors.

``train_step`` sums the gradients and the metrics over the ranks that
share a model coordinate (``reduce_group``), in rank order, before the
clip; AdamW and the EMA act on each rank's shards.
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
from said_tpu_torch.parallel.mesh import randint, randn, sliced
from said_tpu_torch.parallel.seq import all_sum, frames_of, halo, sharded
from said_tpu_torch.parallel.tensor import gather_state_dict, shard_state_dict
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
    seq_group=None,  # sequence parallel: coeffs hold this rank's frames
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
    whole batch's. Draw through a ``SlicedGenerator`` then.

    ``seq_group`` (a ``parallel.mesh.AxisGroup``): coeffs (and injected
    noise) are this rank's frames of a window sharded over the group;
    waveform, mask_time_indices and window_real are the whole window's.
    Each term is this rank's frames' sum over the window's count, so the
    ranks' losses (and gradients) sum to the window's; the velocity term
    takes the next rank's first frame. The noise and the UNet's dropout
    are drawn at the window's shape and cut to this rank's frames."""
    b, t, c = coeffs.shape
    dev = coeffs.device
    dynamic = window_real is not None
    sp = sharded(seq_group)
    window = t * seq_group.size if sp else t
    if generator is None and (train or timesteps is None or noise is None):
        raise ValueError("said_loss: draws timesteps, noise or dropout, so it needs a generator")
    frames = frames_of(window, seq_group) if sp else slice(0, t)
    frame_mask = window_mask = None  # this rank's frames, the window's (0/1)
    if dynamic or sp:
        window_mask = (torch.arange(window, device=dev) < (window if window_real is None else int(window_real))).float()
        frame_mask = window_mask[frames]
    unet_draws = sliced(generator, 1, frames, window) if sp else generator

    coeff_latents = coeffs * model.latent_scale
    if timesteps is None:
        timesteps = randint(schedule.num_train_timesteps, (b,), generator, dev)

    encoder_stochastic = train and config.encoder_train_mode
    cond_embedding = model.get_audio_embedding(
        waveform, window,
        input_length if dynamic else None, window_real if dynamic else None,
        mask_time_indices=mask_time_indices,
        generator=generator if encoder_stochastic else None,
        seq_group=seq_group,
    )
    uncond_embedding = model.null_embedding(b, cond_embedding.shape[1])
    audio_embedding = torch.where(cond.reshape(-1, 1, 1).to(dev), cond_embedding, uncond_embedding)

    if noise is None:
        noise = randn(coeff_latents.shape, unet_draws, dev, coeff_latents.dtype)
    noisy = schedule.add_noise(coeff_latents, noise, timesteps)
    velocity = schedule.get_velocity(coeff_latents, noise, timesteps)

    pred = model(noisy, timesteps, audio_embedding, seq_len_real=window_real if dynamic else None,
                 generator=unet_draws if train else None, seq_group=seq_group)

    answer = {"epsilon": noise, "sample": coeff_latents}.get(config.prediction_type, velocity)
    if std is not None:
        inv = 1.0 / std.reshape(1, 1, -1)
        answer_rw, pred_rw = answer * inv, pred * inv
    else:
        answer_rw, pred_rw = answer, pred

    pred_ext, answer_ext = pred_rw, answer_rw
    if sp:  # the next rank's first frame closes this block's last pair
        ext = halo(torch.cat([pred_rw, answer_rw], dim=-1), 0, 1, seq_group)
        pred_ext, answer_ext = ext[..., :c], ext[..., c:]
    vel_diff = (pred_ext[:, 1:] - pred_ext[:, :-1]) - (answer_ext[:, 1:] - answer_ext[:, :-1])
    if frame_mask is not None:
        m = frame_mask[None, :, None]
        loss_pred = ((pred_rw - answer_rw).abs() * m).sum() / (window_mask.sum() * b * c)
        pairs = window_mask[1:] * window_mask[:-1]  # pair (t, t + 1) of the window
        local_pairs = torch.nn.functional.pad(pairs, (0, 1))[frames] if sp else pairs
        loss_vel = (vel_diff.abs() * local_pairs[None, :, None]).sum() / (pairs.sum().clamp(min=1.0) * b * c)
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
        if frame_mask is not None:
            mv = frame_mask[None, :, None]
            loss_vertex = ((be_pred - be_answer).abs() * mv).sum() / (window_mask.sum() * bsz * (v * i))
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

    Tensor parallel (``model_group``, with ``sharded`` flagging the
    parameters that hold a shard): a sharded gradient's norm is joined
    over the model axis (squares summed in rank order), so every rank
    clips by the whole gradient's norm.
    """

    b1, b2, eps, weight_decay = 0.9, 0.999, 1e-8, 0.01

    def __init__(self, params: Sequence[torch.Tensor], config=None, *, learning_rate: float = 1e-5,
                 warmup_steps: int = 0, grad_clip: float = 1.0, sharded: Sequence[bool] = (), model_group=None):
        if config is not None:
            learning_rate, warmup_steps, grad_clip = config.learning_rate, config.warmup_steps, config.grad_clip
        self.params = list(params)
        self.sharded, self.model_group = [i for i, s in enumerate(sharded) if s], model_group
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
        norms = list(torch._foreach_norm(grads))
        if self.sharded and self.model_group is not None:
            joined = all_sum(torch.stack([norms[i] for i in self.sharded]) ** 2, self.model_group).sqrt()
            for i, n in zip(self.sharded, joined):
                norms[i] = n
        norm = torch.linalg.vector_norm(torch.stack(norms))
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
    or not.

    A model sharded over a model axis (``model.tensor_parallel``, from
    ``parallel.tensor.shard_model_``) holds this rank's shards, and so do
    the optimizer's moments and the EMA; ``state_dict`` and
    ``export_state_dict`` gather whole tensors (every rank of the axis
    takes part), ``load_state_dict`` takes whole ones and keeps this
    rank's shards, so checkpoints are the same files at any mesh."""

    tensor_parallel = None  # whole tensors (set from the model in __init__)

    def __init__(self, model: SAID, config: TrainConfig):
        freeze_encoder_(model)
        self.model, self.config = model, config
        self.tensor_parallel = getattr(model, "tensor_parallel", None)
        self.params = trainable_parameters(model)
        tp = self.tensor_parallel
        self.optimizer = Optimizer(self.params.values(), learning_rate=config.learning_rate,
                                   warmup_steps=config.warmup_steps, grad_clip=config.grad_clip,
                                   sharded=[tp is not None and n in tp.plan for n in self.params],
                                   model_group=None if tp is None else tp.group)
        self.ema = {n: p.detach().clone() for n, p in self.params.items()} if config.ema else None
        self.step = 0

    def _whole(self, named: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        tp = self.tensor_parallel
        return dict(named) if tp is None else gather_state_dict(named, tp.plan, tp.group)

    def _mine(self, named: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        tp = self.tensor_parallel
        return dict(named) if tp is None else shard_state_dict(named, tp.plan, tp.group.index, tp.group.size)

    def _moments(self, optimizer: dict, convert) -> dict:
        names = list(self.params)
        return {"count": optimizer["count"],
                **{k: list(convert(dict(zip(names, optimizer[k], strict=True))).values()) for k in ("mu", "nu")}}

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self._whole(self.model.state_dict()),
                "optimizer": self._moments(self.optimizer.state_dict(), self._whole),
                "ema": None if self.ema is None else self._whole(self.ema)}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(self._mine(state["model"]), strict=True)
        self.optimizer.load_state_dict(self._moments(state["optimizer"], self._mine))
        if (self.ema is None) != (state["ema"] is None):
            raise ValueError("the checkpoint's EMA and this run's --ema disagree")
        if self.ema is not None:
            ema = self._mine(state["ema"])
            with torch.no_grad():
                for name, e in self.ema.items():
                    e.copy_(ema[name])
        self.step = int(state["step"])

    def export_state_dict(self) -> Dict[str, torch.Tensor]:
        """The full model ``state_dict`` with the EMA weights in place of
        the trainable ones (the reference saves EMA weights), whole, on the
        CPU."""
        sd = {k: v.detach() for k, v in self.model.state_dict().items()}
        sd.update({name: e.detach() for name, e in (self.ema or {}).items()})
        return {k: v.cpu() for k, v in self._whole(sd).items()}

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

    ``reduce_group`` (a ``parallel.mesh.AxisGroup``: the data axis, the
    seq axis, or the ranks of one model coordinate): ``batch`` is this
    rank's share of the batch (its rows with ``global_batch``, its frames
    with ``seq_group``); the gradients and the metrics are summed over the
    group in rank order, one ``all_gather`` each, before the clip, so every
    rank clips and steps on the whole batch's gradient with the same bits.

    NaN guard (said_tpu/train/said_train.py:397-416): a non-finite loss
    skips the update, so the parameters, the optimizer's state (its count
    too) and the EMA stay as they were; ``state.step`` still increments.
    Reading the loss is the step's one host sync. Returns the metrics as
    floats, with ``nan_skipped``."""
    loss, metrics = said_loss(state.model, schedule, config=state.config, train=True, generator=generator, **batch)
    params = list(state.params.values())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    if sharded(reduce_group):
        grads = _sum_over(grads, reduce_group)
        metrics = dict(zip(metrics, _sum_over([v.detach() for v in metrics.values()], reduce_group)))
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
def _sum_over(tensors: Sequence[torch.Tensor], group) -> list[torch.Tensor]:
    """The tensors summed over ``group`` in rank order: one ``all_gather``
    of their float32 concatenation, split back to their shapes and dtypes."""
    flat = all_sum(torch.cat([t.reshape(-1).float() for t in tensors]), group)
    return [part.reshape(t.shape).to(t.dtype) for part, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


@torch.no_grad()
def eval_step(model: SAID, schedule: DiffusionSchedule, batch: Dict, config: TrainConfig,
              generator: torch.Generator, reduce_group=None) -> Dict[str, float]:
    """The validation loss (deterministic model; timesteps and noise drawn
    from ``generator``), as floats; summed over ``reduce_group`` (the seq
    axis, whose ranks each hold a block of the frames)."""
    _, metrics = said_loss(model, schedule, config=config, train=False, generator=generator, **batch)
    if sharded(reduce_group):
        metrics = dict(zip(metrics, _sum_over(list(metrics.values()), reduce_group)))
    return {k: float(v) for k, v in metrics.items()}
