"""Reconstruct a blendshape-coefficient CSV through the BCVAE.

Flag-compatible with ``said_tpu/cli/inference_vae.py`` (the reference's
``script/inference_vae.py``): the first 120 frames are encoded and
decoded (``--use_noise true`` samples the latent, from ``--seed``) and
written as a CSV (+ a PNG with ``--save_image``, from the port's own writer).
``--device`` defaults to ``cuda``; path defaults stay in the working
directory, and without ``--weights_path`` the VAE is random from
``--seed``. ``--compilation_cache_dir`` is TPU-only and not carried over.

    python -m said_tpu_torch.cli.inference_vae --weights_path vae.pth \\
        --blendshape_coeffs_path sentence01.csv --output_path out.csv
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from said_tpu_torch.cli._common import (
    ARKIT_BLENDSHAPES,
    configure_precision,
    load_blendshape_coeffs,
    load_vae,
    parse_cli_args,
    save_blendshape_coeffs,
    save_blendshape_coeffs_image,
    str2bool,
)


def main(argv=None) -> np.ndarray:
    """Run the CLI; returns the (120, 32) reconstruction it wrote."""
    parser = argparse.ArgumentParser(description="Reconstruct blendshape coefficients using the VAE (PyTorch/CUDA)")
    parser.add_argument("--weights_path", type=str, default="", help="empty: random weights from --seed")
    parser.add_argument("--blendshape_coeffs_path", type=str, required=True)
    parser.add_argument("--output_path", type=str, default="out.csv")
    parser.add_argument("--output_image_path", type=str, default="out.png")
    parser.add_argument("--save_image", type=str2bool, default=False)
    parser.add_argument("--use_noise", type=str2bool, default=False)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--seed", type=int, default=0)
    args = parse_cli_args(parser, argv)

    device = torch.device(args.device)
    configure_precision("float32")
    model = load_vae(args.weights_path, seed=args.seed, device=device)
    coeffs = load_blendshape_coeffs(args.blendshape_coeffs_path)[: model.seq_len][None]
    with torch.no_grad():
        out = model(torch.from_numpy(coeffs).to(device), use_noise=args.use_noise,
                    generator=torch.Generator(device=device).manual_seed(args.seed) if args.use_noise else None)
    result = out.coeffs_reconst[0].cpu().numpy()
    save_blendshape_coeffs(result, ARKIT_BLENDSHAPES, args.output_path)
    if args.save_image:
        save_blendshape_coeffs_image(result, args.output_image_path)
    return result


if __name__ == "__main__":
    main()
