"""Train the blendshape-coefficient VAE (BCVAE) on BlendVOCA, on the card.

Flag-compatible with ``said_tpu/cli/train_vae.py`` (the reference's
``script/train_vae.py`` defaults: batch 32 from a with-replacement
sampler, lr 1e-4 with a warm-up over 10% of all steps, 20000 epochs, β
per epoch from a cyclical schedule over ``--beta_cycle`` cycles, EMA 0.99,
validation every 10 epochs × 10 repeats on the EMA weights, a train-state
checkpoint every 200), and like it:

- metrics go to ``<output_dir>/SAiD-VAE/metrics.jsonl``, one line an
  epoch;
- every ``--save_period`` epochs the train state (model with its
  BatchNorm statistics, optimizer, EMA, step) goes to
  ``<output_dir>/ckpt/<epoch>/train_state.pt``.

``--device`` defaults to ``cuda``; ``--coeffs_dir`` is required and
``--output_dir`` defaults to ``output-vae`` in the working directory. ε
is drawn from one generator seeded by ``--seed``. The TPU-only
``--compilation_cache_dir`` is not carried over.

    python -m said_tpu_torch.cli.train_vae --coeffs_dir BlendVOCA/blendshape_coeffs
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from said_tpu_torch.cli._common import configure_precision, load_blendshape_coeffs, load_vae, parse_cli_args, str2bool
from said_tpu_torch.core.checkpoint import save_train_state
from said_tpu_torch.core.logging import MetricsWriter
from said_tpu_torch.data.blendvoca import BlendVOCAVAEDataset
from said_tpu_torch.data.loader import DataLoader, prefetch
from said_tpu_torch.train.vae_train import VAETrainConfig, VAETrainState, eval_step, train_step
from said_tpu_torch.utils.scheduler import frange_cycle_linear


def main(argv=None) -> VAETrainState:
    """Run the CLI; returns the final train state."""
    parser = argparse.ArgumentParser(description="Train the VAE for blendshape coefficients (PyTorch/CUDA)")
    parser.add_argument("--coeffs_dir", type=str, required=True)
    parser.add_argument("--coeffs_std_path", type=str, default="")
    parser.add_argument("--output_dir", type=str, default="output-vae")
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--epochs", type=int, default=20000)
    parser.add_argument("--learning_rate", type=float, default=1e-4)
    parser.add_argument("--weight_vel", type=float, default=1.0)
    parser.add_argument("--beta", type=float, default=1.0)
    parser.add_argument("--beta_cycle", type=int, default=10)
    parser.add_argument("--ema", type=str2bool, default=True)
    parser.add_argument("--ema_decay", type=float, default=0.99)
    parser.add_argument("--val_period", type=int, default=10)
    parser.add_argument("--val_repeat", type=int, default=10)
    parser.add_argument("--save_period", type=int, default=200)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda")
    args = parse_cli_args(parser, argv)

    device = torch.device(args.device)
    configure_precision("float32")
    model = load_vae("", seed=args.seed, device=device)  # random from the seed
    std = None
    if args.coeffs_std_path:
        std = torch.from_numpy(load_blendshape_coeffs(args.coeffs_std_path)[0]).to(device)

    train_dataset = BlendVOCAVAEDataset(args.coeffs_dir, dataset_type="train", seed=args.seed)
    val_dataset = BlendVOCAVAEDataset(args.coeffs_dir, dataset_type="val", seed=args.seed + 1)
    train_loader = DataLoader(train_dataset, batch_size=args.batch_size, sampler_replacement=True,
                              collate_fn=BlendVOCAVAEDataset.collate_fn, seed=args.seed)
    val_loader = DataLoader(val_dataset, batch_size=1, collate_fn=BlendVOCAVAEDataset.collate_fn)

    config = VAETrainConfig(learning_rate=args.learning_rate, warmup_steps=int(0.1 * len(train_loader) * args.epochs),
                            weight_vel=args.weight_vel, ema=args.ema, ema_decay=args.ema_decay)
    state = VAETrainState(model, config)
    betas = frange_cycle_linear(args.epochs, stop=args.beta, n_cycle=args.beta_cycle)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    writer = MetricsWriter(args.output_dir, "SAiD-VAE")
    os.makedirs(args.output_dir, exist_ok=True)

    try:
        for epoch in range(1, args.epochs + 1):
            beta = float(betas[epoch - 1])
            t0 = time.time()
            totals, count = {}, 0
            for batch in prefetch(train_loader):
                coeffs = torch.from_numpy(batch.blendshape_coeffs).to(device)
                metrics = train_step(state, coeffs, std, beta, generator=generator)
                for k, v in metrics.items():
                    totals[k] = totals.get(k, 0.0) + v * coeffs.shape[0]
                count += coeffs.shape[0]
            logs = {f"Train/{k}": v / count for k, v in totals.items()}
            logs["Train/Beta"] = beta
            logs["Train/epoch_time_s"] = time.time() - t0

            if epoch % args.val_period == 0:
                v_totals, v_count = {}, 0
                with state.ema_weights():
                    for _ in range(args.val_repeat):
                        for batch in prefetch(val_loader):
                            coeffs = torch.from_numpy(batch.blendshape_coeffs).to(device)
                            for k, v in eval_step(model, coeffs, std, config, beta, generator=generator).items():
                                v_totals[k] = v_totals.get(k, 0.0) + v * coeffs.shape[0]
                            v_count += coeffs.shape[0]
                logs.update({f"Validation/{k}": v / v_count for k, v in v_totals.items()})

            writer.log(logs, epoch)
            print(f"epoch {epoch}: " + ", ".join(f"{k}={v:.5f}" for k, v in logs.items()))
            if epoch % args.save_period == 0:
                path = save_train_state(os.path.join(args.output_dir, "ckpt"), state.state_dict(), epoch)
                print(f"saved train state → {path}")
    finally:
        writer.close()
    return state


if __name__ == "__main__":
    main()
