"""Train the SAiD denoiser on BlendVOCA, on the card.

Flag-compatible with ``said_tpu/cli/train.py`` (the reference's
``script/train.py`` defaults: batch 8, lr 1e-5, 100000 epochs with 5000
warm-up epochs, uncond_prob 0.1, EMA 0.9999, validation every 200 epochs
× 50 repeats, a checkpoint every 200), and like it:

- random window sizes are padded up to multiples of ``--window_bucket``
  (validation clips of ``--val_window_bucket``) with masked norms,
  attention and losses, so the padding changes nothing;
- every ``--save_period`` epochs the full train state goes to
  ``<output_dir>/ckpt/<epoch>`` (``--resume`` takes that directory) and,
  with ``--export_pth``, the EMA weights to ``<output_dir>/<epoch>.pth``
  under the reference's names;
- metrics go to ``<output_dir>/SAiD/metrics.jsonl``, one line an epoch;
- validation runs with the EMA weights.

``--device`` defaults to ``cuda`` (the kernels); ``cpu`` runs their plain
twins. Unlike the JAX CLI's, whose path defaults point into
``../BlendVOCA`` and ``../output``, no path default here leaves the
working directory: ``--audio_dir`` and ``--coeffs_dir`` are required and
``--output_dir`` defaults to ``output``. ``--dtype bfloat16`` computes in bf16 with float32 parameters,
optimizer and EMA. ``--init_weights`` takes a reference-named ``.pth``,
or an HF wav2vec2 snapshot directory (``model.safetensors`` or
``pytorch_model.bin``: the reference's init, the audio encoder from the
snapshot and the rest random from ``--seed``); without it the weights are
random from ``--seed``. An orbax checkpoint directory (a JAX format) is
refused. Not ported: sharding over several cards
(``--mesh_data``/``--mesh_model``/``--mesh_seq`` > 1).

    python -m said_tpu_torch.cli.train --audio_dir BlendVOCA/audio \\
        --coeffs_dir BlendVOCA/blendshape_coeffs --output_dir output
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from said_tpu_torch.cli._common import (
    ORBAX_REFUSAL,
    build_said_model,
    configure_precision,
    load_blendshape_coeffs,
    load_said_weights,
    str2bool,
)
from said_tpu_torch.core.checkpoint import restore_train_state, save_pth, save_train_state
from said_tpu_torch.core.logging import MetricsWriter
from said_tpu_torch.data.blendvoca import BlendVOCATrainDataset, BlendVOCAValDataset
from said_tpu_torch.data.loader import DataLoader, prefetch
from said_tpu_torch.diffusion.schedule import DiffusionSchedule
from said_tpu_torch.models.said import process_audio
from said_tpu_torch.models.wav2vec2 import compute_time_mask_indices
from said_tpu_torch.train.said_train import TrainConfig, TrainState, eval_step, train_step
from said_tpu_torch.utils.hf_snapshot import snapshot_file

SR, FPS = 16000, 60


def add_arguments(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--audio_dir", type=str, required=True)
    parser.add_argument("--coeffs_dir", type=str, required=True)
    parser.add_argument("--coeffs_std_path", type=str, default="")
    parser.add_argument("--blendshape_residuals_path", type=str, default="")
    parser.add_argument("--landmarks_path", type=str, default="")
    parser.add_argument("--output_dir", type=str, default="output")
    parser.add_argument("--prediction_type", type=str, default="epsilon")
    parser.add_argument("--window_size_min", type=int, default=120)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--epochs", type=int, default=100000)
    parser.add_argument("--num_warmup_epochs", type=int, default=5000)
    parser.add_argument("--num_workers", type=int, default=0, help="ignored")
    parser.add_argument("--learning_rate", type=float, default=1e-5)
    parser.add_argument("--uncond_prob", type=float, default=0.1)
    parser.add_argument("--unet_feature_dim", type=int, default=-1)
    parser.add_argument("--weight_vel", type=float, default=1.0)
    parser.add_argument("--weight_vertex", type=float, default=0.02)
    parser.add_argument("--ema", type=str2bool, default=True)
    parser.add_argument("--ema_decay", type=float, default=0.9999)
    parser.add_argument("--val_period", type=int, default=200)
    parser.add_argument("--val_repeat", type=int, default=50)
    parser.add_argument("--save_period", type=int, default=200)
    parser.add_argument("--window_bucket", type=int, default=8,
                        help="pad training windows up to multiples of this many frames (masked)")
    parser.add_argument("--val_window_bucket", type=int, default=128,
                        help="pad validation clips up to multiples of this many frames (masked)")
    parser.add_argument("--gradient_checkpointing", type=str2bool, default=False,
                        help="recompute the UNet's blocks in the backward pass")
    parser.add_argument("--mesh_data", type=int, default=-1)
    parser.add_argument("--mesh_model", type=int, default=1)
    parser.add_argument("--mesh_seq", type=int, default=1)
    parser.add_argument("--init_weights", type=str, default="",
                        help="optional reference-named .pth, or an HF wav2vec2 snapshot directory")
    parser.add_argument("--resume", type=str, default="", help="a checkpoint directory <output_dir>/ckpt/<epoch>")
    parser.add_argument("--export_pth", type=str2bool, default=True)
    parser.add_argument("--spec_augment", type=str2bool, default=True,
                        help="wav2vec2 time masking during training")
    parser.add_argument("--encoder_train_mode", type=str2bool, default=True,
                        help="run the frozen encoder with train-mode dropout and layerdrop; '' disables")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (the kernels) or cpu (their plain twins)")


def _refuse_unported(args: argparse.Namespace) -> None:
    for flag in ("mesh_data", "mesh_model", "mesh_seq"):
        if getattr(args, flag) > 1:
            raise SystemExit(f"--{flag} > 1 is not ported to said_tpu_torch yet: "
                             "ROADMAP Queue 1 item 13 (multi-GPU, data- and sequence-parallel training)")
    if args.init_weights and os.path.isdir(args.init_weights) and snapshot_file(args.init_weights) is None:
        raise SystemExit("--init_weights " + ORBAX_REFUSAL.format(path=args.init_weights))


def _bucket_up(window_size: int, bucket: int) -> int:
    if bucket <= 1:
        return window_size
    return int(np.ceil(window_size / bucket) * bucket)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Train the SAiD model using BlendVOCA dataset (PyTorch/CUDA)")
    add_arguments(parser)
    args = parser.parse_args(argv)
    _refuse_unported(args)

    device = torch.device(args.device)
    configure_precision(args.dtype)
    model = build_said_model(args.prediction_type, args.unet_feature_dim, args.dtype,
                             remat=bool(args.gradient_checkpointing))
    load_said_weights(model, args.init_weights, seed=args.seed)
    model.to(device)
    schedule = DiffusionSchedule.create(model.diffusion_steps, args.prediction_type)

    std = None
    if args.coeffs_std_path:
        std = torch.from_numpy(load_blendshape_coeffs(args.coeffs_std_path)[0]).to(device)

    data_kw = dict(audio_dir=args.audio_dir, blendshape_coeffs_dir=args.coeffs_dir,
                   blendshape_deltas_path=args.blendshape_residuals_path or None,
                   landmarks_path=args.landmarks_path or None, sampling_rate=SR, uncond_prob=args.uncond_prob)
    train_dataset = BlendVOCATrainDataset(window_size_min=args.window_size_min, seed=args.seed, **data_kw)
    val_dataset = BlendVOCAValDataset(seed=args.seed + 1, **data_kw)
    train_loader = DataLoader(train_dataset, batch_size=args.batch_size, sampler_replacement=True,
                              collate_fn=train_dataset.collate_fn, seed=args.seed)

    config = TrainConfig(
        learning_rate=args.learning_rate,
        warmup_steps=len(train_loader) * args.num_warmup_epochs,
        weight_vel=args.weight_vel,
        weight_vertex=args.weight_vertex,
        ema=args.ema,
        ema_decay=args.ema_decay,
        prediction_type=args.prediction_type,
        encoder_train_mode=bool(args.encoder_train_mode),
    )
    state = TrainState(model, config)
    if args.resume:
        restore_train_state(args.resume, state)
        print(f"resumed from {args.resume} at step {state.step}")

    writer = MetricsWriter(args.output_dir, "SAiD")
    generator = torch.Generator(device=device).manual_seed(args.seed)
    spec_rng = np.random.default_rng(args.seed + 17)
    os.makedirs(args.output_dir, exist_ok=True)

    def prepare_batch(batch, bucket_size=None, augment=True):
        """A collated numpy batch → ``said_loss``'s keyword inputs on the
        device. The window is padded up to the next multiple of
        ``bucket_size`` (default ``--window_bucket``) and the real lengths
        go along, so the masked model and losses see an unpadded batch;
        the waveform is normalised over its real samples first."""
        if bucket_size is None:
            bucket_size = args.window_bucket
        coeffs = batch.blendshape_coeffs
        ws_real, wave_real = coeffs.shape[1], len(batch.waveform[0])
        dynamic = bucket_size > 1
        wave_np = process_audio(np.stack([w[:wave_real] for w in batch.waveform]))
        if dynamic:
            target = _bucket_up(ws_real, bucket_size)
            wave_target = int(np.ceil(target * SR / FPS))
            coeffs = np.pad(coeffs, ((0, 0), (0, target - ws_real), (0, 0)))
            wave_np = np.pad(wave_np, ((0, 0), (0, wave_target - wave_real)))
        mask_time = None
        if augment and args.spec_augment:
            mask_time = compute_time_mask_indices((wave_np.shape[0], ws_real), rng=spec_rng)
            if dynamic and coeffs.shape[1] > ws_real:
                mask_time = np.pad(mask_time, ((0, 0), (0, coeffs.shape[1] - ws_real)))

        def dev(a, dtype=None):
            return None if a is None else torch.from_numpy(np.asarray(a, dtype)).to(device)

        return {
            "waveform": dev(wave_np),
            "coeffs": dev(coeffs, np.float32),
            "cond": dev(batch.cond),
            "std": std,
            "blendshape_delta": dev(batch.blendshape_delta, np.float32),
            "mask_time_indices": dev(mask_time),
            "window_real": ws_real if dynamic else None,
            "input_length": wave_real if dynamic else None,
        }

    for epoch in range(1, args.epochs + 1):
        t0 = time.time()
        totals, count = {}, 0
        for batch in prefetch(train_loader):
            metrics = train_step(state, schedule, prepare_batch(batch), generator)
            bsz = len(batch.waveform)
            for k, v in metrics.items():
                totals[k] = totals.get(k, 0.0) + v * bsz
            count += bsz
        logs = {f"Train/{k}": v / count for k, v in totals.items()}
        logs["Train/epoch_time_s"] = time.time() - t0

        if epoch % args.val_period == 0:
            v_totals, v_count = {}, 0
            val_loader = DataLoader(val_dataset, batch_size=1, collate_fn=val_dataset.collate_fn)
            with state.ema_weights():
                for _ in range(args.val_repeat):
                    for batch in prefetch(val_loader):
                        metrics = eval_step(model, schedule,
                                            prepare_batch(batch, bucket_size=args.val_window_bucket, augment=False),
                                            config, generator)
                        bsz = len(batch.waveform)
                        for k, v in metrics.items():
                            v_totals[k] = v_totals.get(k, 0.0) + v * bsz
                        v_count += bsz
            logs.update({f"Validation/{k}": v / v_count for k, v in v_totals.items()})

        writer.log(logs, epoch)
        print(f"epoch {epoch}: " + ", ".join(f"{k}={v:.5f}" for k, v in logs.items()))

        if epoch % args.save_period == 0:
            path = save_train_state(os.path.join(args.output_dir, "ckpt"), state, epoch)
            print(f"saved train state → {path}")
            if args.export_pth:
                save_pth(state.export_state_dict(), os.path.join(args.output_dir, f"{epoch}.pth"))

    writer.close()


if __name__ == "__main__":
    main()
