"""Single-WAV → blendshape-coefficient CSV inference on the card.

Flag-compatible with ``said_tpu/cli/inference.py`` (the reference's
``script/inference.py`` defaults: 1000 DDIM steps, guidance 2.0, eta 0,
60 fps; ``--init_sample_path``/``--mask_path`` masked editing and
intermediate dumps). ``--device`` defaults to ``cuda``. Unlike the JAX
CLI's, whose path defaults point into ``../BlendVOCA``, every path
default here lies in the working directory: ``--audio_path`` is
required, and without ``--weights_path`` the weights are random from
``--seed``.

Options of the JAX CLI that are not ported yet fail with an error naming
the ROADMAP item; the TPU-only ``--denoise_chunk``,
``--compilation_cache_dir`` and ``--profile_dir`` are not carried over.

    python -m said_tpu_torch.cli.inference --weights_path SAiD.pth \\
        --audio_path speech.wav --output_path out.csv
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from said_tpu.utils.audio import fit_audio_unet, load_audio
from said_tpu_torch.cli._common import (
    ARKIT_BLENDSHAPES,
    build_said_model,
    configure_precision,
    load_blendshape_coeffs,
    load_said_weights,
    save_blendshape_coeffs,
    save_blendshape_coeffs_image,
    str2bool,
)
from said_tpu_torch.models.said import SAIDPipeline, process_audio


def add_arguments(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--weights_path", type=str, default="",
                        help="reference-named torch state_dict; empty: random weights from --seed")
    parser.add_argument("--audio_path", type=str, default="", help="16 kHz WAV (required)")
    parser.add_argument("--output_path", type=str, default="out.csv")
    parser.add_argument("--output_image_path", type=str, default="out.png")
    parser.add_argument("--intermediate_dir", type=str, default="interm")
    parser.add_argument("--prediction_type", type=str, default="epsilon")
    parser.add_argument("--save_image", type=str2bool, default=False)
    parser.add_argument("--save_intermediate", type=str2bool, default=False)
    parser.add_argument("--num_steps", type=int, default=1000)
    parser.add_argument("--strength", type=float, default=1.0)
    parser.add_argument("--guidance_scale", type=float, default=2.0)
    parser.add_argument("--guidance_rescale", type=float, default=0.0)
    parser.add_argument("--eta", type=float, default=0.0)
    parser.add_argument("--solver", type=str, default="ddim", choices=["ddim", "dpmpp_2m"])
    parser.add_argument("--fps", type=int, default=60)
    parser.add_argument("--divisor_unet", type=int, default=1)
    parser.add_argument("--unet_feature_dim", type=int, default=-1)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (the kernels) or cpu (their plain twins)")
    parser.add_argument("--init_sample_path", type=str)
    parser.add_argument("--mask_path", type=str)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    parser.add_argument("--attn_impl", type=str, default="auto",
                        choices=["auto", "dense", "flash", "flash_sp"],
                        help="auto/dense: dense self-attention and the banded "
                             "cross-attention (numerically the masked dense form)")
    parser.add_argument("--seq_shards", type=int, default=0)
    parser.add_argument("--length_bucket", type=int, default=0)
    parser.add_argument("--streaming_window", type=int, default=0)
    parser.add_argument("--streaming_overlap", type=int, default=360)


def _refuse_unported(args: argparse.Namespace) -> None:
    unported = [
        (args.solver == "dpmpp_2m", "--solver dpmpp_2m", "ROADMAP Queue 1 item 9 (DPM++ serving)"),
        (args.length_bucket > 0, "--length_bucket > 0", "ROADMAP Queue 1 item 8 (bucketed batches)"),
        (args.streaming_window > 0, "--streaming_window > 0", "ROADMAP Queue 1 item 9 (streaming)"),
        (args.seq_shards > 1, "--seq_shards > 1", "ROADMAP Queue 1 item 13 (multi-GPU)"),
        (args.attn_impl.startswith("flash"), f"--attn_impl {args.attn_impl}",
         "ROADMAP Queue 2 K1 (the flash-attention kernel)"),
    ]
    for bad, flag, item in unported:
        if bad:
            raise SystemExit(f"{flag} is not ported to said_tpu_torch yet: {item}")


def main(argv=None) -> np.ndarray:
    """Run the CLI; returns the (frames, 32) coefficients it wrote."""
    parser = argparse.ArgumentParser(description="Inference the lipsync using the SAiD model (PyTorch/CUDA)")
    add_arguments(parser)
    args = parser.parse_args(argv)
    _refuse_unported(args)
    if not args.audio_path:
        parser.error("--audio_path is required")

    device = torch.device(args.device)
    configure_precision(args.dtype)
    model = build_said_model(args.prediction_type, args.unet_feature_dim, args.dtype)
    load_said_weights(model, args.weights_path, seed=args.seed)
    pipeline = SAIDPipeline(model.to(device).eval())

    waveform = load_audio(args.audio_path, pipeline.sampling_rate)
    fit = fit_audio_unet(waveform, pipeline.sampling_rate, args.fps, args.divisor_unet)
    waveform_processed = process_audio(fit.waveform)
    window_len = fit.window_size

    init_samples = None
    if args.init_sample_path:
        init_samples = load_blendshape_coeffs(args.init_sample_path)[None]
    mask = None
    if args.mask_path:
        mask = load_blendshape_coeffs(args.mask_path)[None]

    output = pipeline.inference(
        waveform_processed,
        init_samples=init_samples,
        mask=mask,
        num_inference_steps=args.num_steps,
        strength=args.strength,
        guidance_scale=args.guidance_scale,
        guidance_rescale=args.guidance_rescale,
        eta=args.eta,
        fps=args.fps,
        generator=torch.Generator(device=device).manual_seed(args.seed),
        save_intermediate=args.save_intermediate,
    )

    result = output.result[0, :window_len]
    save_blendshape_coeffs(result, ARKIT_BLENDSHAPES, args.output_path)
    if args.save_image:
        save_blendshape_coeffs_image(result, args.output_image_path)
    if args.save_intermediate:
        os.makedirs(args.intermediate_dir, exist_ok=True)
        interms = output.intermediates  # (K, B, T, C), ordered start → end
        for t in range(interms.shape[0]):
            step = interms.shape[0] - t  # the reference numbers from the end
            coeffs = np.clip(interms[t][0, :window_len], 0.0, 1.0)
            save_blendshape_coeffs(coeffs, ARKIT_BLENDSHAPES, os.path.join(args.intermediate_dir, f"{step}.csv"))
            save_blendshape_coeffs_image(coeffs, os.path.join(args.intermediate_dir, f"{step}.png"))
    return result


if __name__ == "__main__":
    main()
