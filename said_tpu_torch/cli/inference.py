"""Single-WAV → blendshape-coefficient CSV inference on the card.

Flag-compatible with ``said_tpu/cli/inference.py`` (the reference's
``script/inference.py`` defaults: 1000 DDIM steps, guidance 2.0, eta 0,
60 fps; ``--init_sample_path``/``--mask_path`` masked editing and
intermediate dumps; ``--solver dpmpp_2m`` for DPM-Solver++(2M), e.g.
with ``--num_steps 25``; ``--length_bucket N`` pads the window to a
multiple of N frames and runs length-bucketed mode; ``--streaming_window
N`` serves the clip as N-frame windows stitched through the editing path,
each pinning ``--streaming_overlap`` frames of the one before). Clips of
any length run: self-attention over more than 2048 frames goes to the
flash-attention kernel on the card.
``--device`` defaults to ``cuda``. Unlike the JAX CLI's, whose path
defaults point into ``../BlendVOCA``, every path default here lies in
the working directory: ``--audio_path`` is required, and without
``--weights_path`` the weights are random from ``--seed``.

Sequence-parallel serving of one long clip over N cards: ``--seq_shards
N`` under ``torchrun`` with N processes (in the JAX CLI, N local devices
of one process): the clip is padded so that N divides its frames
(``lcm(--divisor_unet, N)``), each rank runs the encoder and the denoise
loop on its T/N frames (``--attn_impl`` auto or flash_sp: self-attention
over gathered K/V), and rank 0 writes the outputs. ``--attn_impl
flash_sp`` without ``--seq_shards`` takes the normal route. The TPU-only
``--denoise_chunk``, ``--compilation_cache_dir`` and ``--profile_dir``
are not carried over.

    python -m said_tpu_torch.cli.inference --weights_path SAiD.pth \\
        --audio_path speech.wav --output_path out.csv
    torchrun --nproc_per_node 2 -m said_tpu_torch.cli.inference --seq_shards 2 --audio_path long.wav ...
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np
import torch

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
from said_tpu_torch.parallel.mesh import MeshConfig, make_mesh, maybe_init_distributed, shutdown
from said_tpu_torch.utils.audio import fit_audio_unet, load_audio


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
                        help="auto, dense and flash: self-attention by clip length (dense up "
                             "to 2048 frames, the flash kernel above) and the banded "
                             "cross-attention (numerically the masked dense form)")
    parser.add_argument("--seq_shards", type=int, default=0)
    parser.add_argument("--length_bucket", type=int, default=0,
                        help="pad the window to a multiple of this many frames (0: exact shape)")
    parser.add_argument("--streaming_window", type=int, default=0,
                        help="serve the clip as overlapping windows of this many frames stitched through the "
                             "inpainting path (0: off; a multiple of 3)")
    parser.add_argument("--streaming_overlap", type=int, default=360,
                        help="frames of each window pinned from the one before, with --streaming_window")


def _refuse_with_streaming(args: argparse.Namespace) -> None:
    """The JAX CLI's refusals in streaming mode (said_tpu/cli/inference.py:167-178)."""
    if args.streaming_window <= 0:
        return
    for flag, bad in (("--init_sample_path", args.init_sample_path), ("--mask_path", args.mask_path),
                      ("--save_intermediate", args.save_intermediate), ("--length_bucket", args.length_bucket),
                      ("--seq_shards", args.seq_shards > 1)):
        if bad:
            raise SystemExit(f"{flag} is not supported with --streaming_window")
    if args.strength != 1.0:
        raise SystemExit("--strength is not supported with --streaming_window")


def main(argv=None) -> np.ndarray:
    """Run the CLI; returns the (frames, 32) coefficients it wrote (every
    rank returns them; rank 0 alone writes)."""
    parser = argparse.ArgumentParser(description="Inference the lipsync using the SAiD model (PyTorch/CUDA)")
    add_arguments(parser)
    args = parser.parse_args(argv)
    _refuse_with_streaming(args)
    if args.seq_shards > 1 and args.attn_impl not in ("auto", "flash_sp"):
        raise SystemExit(f"--seq_shards requires the flash_sp attention partitioning rule; drop --attn_impl "
                         f"{args.attn_impl} (or --seq_shards)")
    ctx = maybe_init_distributed(args.device)
    try:
        return _infer(parser, args, ctx)
    finally:
        shutdown(ctx)


def _infer(parser: argparse.ArgumentParser, args: argparse.Namespace, ctx) -> np.ndarray:
    shards = max(args.seq_shards, 1)
    if ctx.world != shards:
        raise SystemExit(f"--seq_shards {args.seq_shards} runs under torchrun with as many processes; this job has "
                         f"{ctx.world}")
    if not args.audio_path:
        parser.error("--audio_path is required")
    seq_group = make_mesh(MeshConfig(data=1, seq=shards), ctx).seq if shards > 1 else None
    writes = ctx.rank == 0
    device = ctx.device
    configure_precision(args.dtype)
    model = build_said_model(args.prediction_type, args.unet_feature_dim, args.dtype)
    load_said_weights(model, args.weights_path, seed=args.seed)
    pipeline = SAIDPipeline(model.to(device).eval())

    waveform = load_audio(args.audio_path, pipeline.sampling_rate)
    fit = fit_audio_unet(waveform, pipeline.sampling_rate, args.fps, math.lcm(args.divisor_unet, shards))
    waveform_processed = process_audio(fit.waveform)
    window_len = fit.window_size

    init_samples = None
    if args.init_sample_path:
        init_samples = load_blendshape_coeffs(args.init_sample_path)[None]
    mask = None
    if args.mask_path:
        mask = load_blendshape_coeffs(args.mask_path)[None]

    generator = torch.Generator(device=device).manual_seed(args.seed)
    sampling = dict(num_inference_steps=args.num_steps, guidance_scale=args.guidance_scale,
                    guidance_rescale=args.guidance_rescale, eta=args.eta, solver=args.solver, fps=args.fps,
                    generator=generator)
    if args.streaming_window > 0:
        output = pipeline.inference_streaming(waveform_processed, window_frames=args.streaming_window,
                                              overlap_frames=args.streaming_overlap, **sampling)
    else:
        output = pipeline.inference(
            waveform_processed,
            init_samples=init_samples,
            mask=mask,
            strength=args.strength,
            save_intermediate=args.save_intermediate,
            length_bucket=args.length_bucket,
            seq_group=seq_group,
            **sampling,
        )

    result = output.result[0, :window_len]
    if not writes:
        return result
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
