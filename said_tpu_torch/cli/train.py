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
refused.

Parallel training over several cards: run under ``torchrun`` (one
process a card; NCCL, or gloo with ``--device cpu``) on a mesh of
``--mesh_data`` × ``--mesh_model`` × ``--mesh_seq`` ranks, laid out as the
JAX CLI's mesh:

- ``--mesh_data N`` splits each batch's rows over N ranks (``-1``: the
  largest count that divides the batch and the ranks left by the other
  axes, ``fit_data_axis``; ranks past it hold no rows and stop after
  set-up); a batch the data axis does not divide (the batch-1
  validation) is computed whole on every rank;
- ``--mesh_seq N`` splits each window's frames over N ranks (the window
  buckets become multiples of N, as the JAX CLI makes them: every batch
  is then a bucketed one); the frozen encoder runs whole on every rank;
- ``--mesh_model N`` splits the attention heads, the feed-forward widths
  and the timestep MLP over N ranks (``parallel.tensor``).

Every rank builds the same global batch from the seeded loaders, keeps
its rows and frames, and draws every random array at the global shape;
the gradients are summed over the ranks that share a model coordinate
before the clip, so the mesh takes the step one process takes. Rank 0
alone writes the metrics, checkpoints and ``.pth`` exports, whole
tensors gathered over the model axis; ``--resume`` loads them whole on
every rank, which keeps its shards.

    python -m said_tpu_torch.cli.train --audio_dir BlendVOCA/audio \\
        --coeffs_dir BlendVOCA/blendshape_coeffs --output_dir output
    torchrun --nproc_per_node 4 -m said_tpu_torch.cli.train --mesh_data 4 ...
    torchrun --nproc_per_node 4 -m said_tpu_torch.cli.train --mesh_data 1 --mesh_model 2 --mesh_seq 2 ...
"""

from __future__ import annotations

import argparse
import math
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
    parse_cli_args,
    str2bool,
)
from said_tpu_torch.core.checkpoint import restore_train_state, save_pth, save_train_state
from said_tpu_torch.core.logging import MetricsWriter
from said_tpu_torch.data.blendvoca import BlendVOCATrainDataset, BlendVOCAValDataset
from said_tpu_torch.data.loader import DataLoader, prefetch
from said_tpu_torch.diffusion.schedule import DiffusionSchedule
from said_tpu_torch.models.said import process_audio
from said_tpu_torch.models.wav2vec2 import compute_time_mask_indices
from said_tpu_torch.parallel.mesh import (
    MeshConfig,
    SlicedGenerator,
    fit_data_axis,
    make_mesh,
    maybe_init_distributed,
    rank_rows,
    shutdown,
)
from said_tpu_torch.parallel.seq import frames_of, sharded
from said_tpu_torch.parallel.tensor import shard_model_
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
    if args.init_weights and os.path.isdir(args.init_weights) and snapshot_file(args.init_weights) is None:
        raise SystemExit("--init_weights " + ORBAX_REFUSAL.format(path=args.init_weights))


def _bucket_up(window_size: int, bucket: int) -> int:
    if bucket <= 1:
        return window_size
    return int(np.ceil(window_size / bucket) * bucket)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Train the SAiD model using BlendVOCA dataset (PyTorch/CUDA)")
    add_arguments(parser)
    args = parse_cli_args(parser, argv)
    _refuse_unported(args)
    if args.mesh_seq > 1:
        # every padded window (train and validation buckets) splits evenly
        # over the seq axis (said_tpu/cli/train.py:157-165)
        args.window_bucket = math.lcm(max(args.window_bucket, 1), args.mesh_seq)
        args.val_window_bucket = math.lcm(max(args.val_window_bucket, 1), args.mesh_seq)
    ctx = maybe_init_distributed(args.device)
    try:
        _train(args, ctx)
    finally:
        shutdown(ctx)


def _train(args: argparse.Namespace, ctx) -> None:
    data_axis = args.mesh_data if args.mesh_data > 0 else fit_data_axis(args.batch_size, ctx.world,
                                                                         args.mesh_model, args.mesh_seq)
    try:
        mesh = make_mesh(MeshConfig(data=data_axis, model=args.mesh_model, seq=args.mesh_seq), ctx)
    except ValueError as e:
        raise SystemExit(f"--mesh_data {args.mesh_data}: {e} (the ranks of this job: {ctx.world})") from e
    if not mesh.active:
        print(f"rank {ctx.rank}: past the {data_axis}-rank data axis, holds no rows")
        return
    data, seq = mesh.data, mesh.seq
    writer_rank = ctx.rank == 0

    def log(msg):
        if writer_rank:
            print(msg)

    device = ctx.device
    configure_precision(args.dtype)
    model = build_said_model(args.prediction_type, args.unet_feature_dim, args.dtype,
                             remat=bool(args.gradient_checkpointing))
    load_said_weights(model, args.init_weights, seed=args.seed)
    model.to(device)
    shard_model_(model, mesh.model)  # whole weights in, this rank's shards kept
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
        log(f"resumed from {args.resume} at step {state.step}")

    writer = MetricsWriter(args.output_dir, "SAiD") if writer_rank else None
    generator = torch.Generator(device=device).manual_seed(args.seed)
    spec_rng = np.random.default_rng(args.seed + 17)
    if writer_rank:
        os.makedirs(args.output_dir, exist_ok=True)

    def prepare_batch(batch, bucket_size=None, augment=True):
        """A collated numpy batch → ``said_loss``'s keyword inputs on the
        device, this rank's rows and frames of it, the generator to draw
        with (data parallel: the global batch's draws, sliced to the rows;
        ``said_loss`` cuts the frames) and the group to sum the gradients
        over. The window is padded up to the next multiple of
        ``bucket_size`` (default ``--window_bucket``) and the real lengths
        go along, so the masked model and losses see an unpadded batch;
        the waveform is normalised over its real samples first.
        Spec-augment's masks are drawn for the global batch. The waveform
        and the masks stay whole (the encoder runs whole)."""
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

        n = wave_np.shape[0]
        rows = rank_rows(n, data.size, data.index)
        split = rows != slice(0, n)
        frames = frames_of(coeffs.shape[1], seq) if sharded(seq) else slice(None)

        def dev(a, dtype=None):
            return None if a is None else torch.from_numpy(np.ascontiguousarray(a[rows], dtype)).to(device)

        inputs = {
            "waveform": dev(wave_np),
            "coeffs": dev(coeffs[:, frames], np.float32),
            "cond": dev(batch.cond),
            "std": std,
            "blendshape_delta": dev(batch.blendshape_delta, np.float32),
            "mask_time_indices": dev(mask_time),
            "window_real": ws_real if dynamic else None,
            "input_length": wave_real if dynamic else None,
            "seq_group": seq,
        }
        if not split:
            return inputs, generator, seq
        inputs["global_batch"] = n
        return inputs, SlicedGenerator(generator, 0, rows, n), mesh.data_seq

    for epoch in range(1, args.epochs + 1):
        t0 = time.time()
        totals, count = {}, 0
        for batch in prefetch(train_loader):
            inputs, draws, group = prepare_batch(batch)
            metrics = train_step(state, schedule, inputs, draws, group)
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
                        # batch 1: whole on every rank, which keeps its generator in step
                        inputs, _, _ = prepare_batch(batch, bucket_size=args.val_window_bucket, augment=False)
                        metrics = eval_step(model, schedule, inputs, config, generator, seq)
                        bsz = len(batch.waveform)
                        for k, v in metrics.items():
                            v_totals[k] = v_totals.get(k, 0.0) + v * bsz
                        v_count += bsz
            logs.update({f"Validation/{k}": v / v_count for k, v in v_totals.items()})

        log(f"epoch {epoch}: " + ", ".join(f"{k}={v:.5f}" for k, v in logs.items()))
        if writer_rank:
            writer.log(logs, epoch)
        # whole tensors: every rank of the model axis takes part in the gather
        if epoch % args.save_period == 0 and (writer_rank or state.tensor_parallel is not None):
            train_state = state.state_dict()
            export = state.export_state_dict() if args.export_pth else None
            if writer_rank:
                path = save_train_state(os.path.join(args.output_dir, "ckpt"), train_state, epoch)
                print(f"saved train state → {path}")
                if export is not None:
                    save_pth(export, os.path.join(args.output_dir, f"{epoch}.pth"))

    if writer is not None:
        writer.close()


if __name__ == "__main__":
    main()
