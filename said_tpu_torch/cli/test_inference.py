"""Batched generation over the BlendVOCA test split, on the card.

Flag-compatible with ``said_tpu/cli/test_inference.py`` (the reference's
``script/test_inference.py``): for each test clip, ``--num_repeats``
samples in chunks of ``--batch_size``, written as
``<output_dir>/<person>/sentenceXX-<k>.csv`` with the clip's real rows.
``--length_bucket`` (default 256) pads each window to a multiple of that
many frames; ``--mixed_batching`` packs (clip, repeat) pairs of different
clips into one batch, length-sorted, with per-row lengths.

Randomness comes from one ``torch.Generator`` on ``--device``, seeded
with ``--seed`` and drawn chunk after chunk: torch cannot reproduce the
JAX CLI's key splitting. ``--device`` defaults to ``cuda``;
``--weights_path`` empty means random weights from ``--seed``;
``--audio_dir`` is required. The TPU-only ``--compilation_cache_dir`` is
not carried over.

    python -m said_tpu_torch.cli.test_inference --weights_path SAiD.pth \\
        --audio_dir BlendVOCA/audio --output_dir out
"""

from __future__ import annotations

import argparse
import math
import os
from typing import List

import numpy as np
import torch

from said_tpu_torch.cli._common import (
    ARKIT_BLENDSHAPES,
    build_said_model,
    configure_precision,
    load_said_weights,
    save_blendshape_coeffs,
)
from said_tpu_torch.data.blendvoca import get_data_paths, load_test_audio
from said_tpu_torch.models.said import SAIDPipeline, process_audio
from said_tpu_torch.utils.audio import fit_audio_unet


def add_arguments(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--weights_path", type=str, default="",
                        help="reference-named torch state_dict; empty: random weights from --seed")
    parser.add_argument("--audio_dir", type=str, default="", help="<dir>/<person>/sentenceXX.wav (required)")
    parser.add_argument("--output_dir", type=str, default="out")
    parser.add_argument("--prediction_type", type=str, default="epsilon")
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
    parser.add_argument("--num_repeats", type=int, default=72)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    parser.add_argument("--attn_impl", type=str, default="auto", choices=["auto", "dense", "flash"],
                        help="all three: self-attention by clip length (dense up to 2048 frames, "
                             "the flash kernel above) and the banded cross-attention")
    parser.add_argument("--length_bucket", type=int, default=256,
                        help="pad each window to a multiple of this many frames (0: exact shape)")
    parser.add_argument("--mixed_batching", action="store_true",
                        help="fill batches with (clip, repeat) pairs of different clips, "
                             "length-sorted; requires --length_bucket")


def main(argv=None) -> List[str]:
    """Run the CLI; returns the CSV paths it wrote, in order."""
    parser = argparse.ArgumentParser(description="Batched SAiD inference over the test split (PyTorch/CUDA)")
    add_arguments(parser)
    args = parser.parse_args(argv)
    if not args.audio_dir:
        parser.error("--audio_dir is required")
    if args.mixed_batching and args.length_bucket <= 0:
        raise SystemExit("--mixed_batching requires --length_bucket > 0")

    device = torch.device(args.device)
    configure_precision(args.dtype)
    model = build_said_model(args.prediction_type, args.unet_feature_dim, args.dtype)
    load_said_weights(model, args.weights_path, seed=args.seed)
    pipeline = SAIDPipeline(model.to(device).eval())
    generator = torch.Generator(device=device).manual_seed(args.seed)

    # (person, clip name, real frames, processed waveform) per test clip
    clips = []
    for path in get_data_paths(args.audio_dir):
        fit = fit_audio_unet(load_test_audio(path, pipeline.sampling_rate), pipeline.sampling_rate,
                             args.fps, args.divisor_unet)
        base = os.path.splitext(os.path.basename(path.audio))[0]
        clips.append((path.person_id, base, fit.window_size, process_audio(fit.waveform)[0]))
        os.makedirs(os.path.join(args.output_dir, path.person_id), exist_ok=True)

    def generate(wave, lengths=None):
        return pipeline.inference(
            wave,
            num_inference_steps=args.num_steps,
            strength=args.strength,
            guidance_scale=args.guidance_scale,
            guidance_rescale=args.guidance_rescale,
            eta=args.eta,
            solver=args.solver,
            fps=args.fps,
            generator=generator,
            length_bucket=args.length_bucket,
            waveform_lengths=lengths,
        ).result

    written = []
    if args.mixed_batching:
        # one task per (clip, repeat), length-sorted to keep padding small
        tasks = [(clip, k) for clip in clips for k in range(args.num_repeats)]
        tasks.sort(key=lambda task: len(task[0][3]))
        for lo in range(0, len(tasks), args.batch_size):
            chunk = tasks[lo : lo + args.batch_size]
            lens = np.array([len(clip[3]) for clip, _ in chunk], np.int64)
            wave = np.zeros((len(chunk), lens.max()), np.float32)
            for i, (clip, _) in enumerate(chunk):
                wave[i, : lens[i]] = clip[3]
            result = generate(wave, lens)
            for i, ((person, base, frames, _), k) in enumerate(chunk):
                written.append(os.path.join(args.output_dir, person, f"{base}-{k}.csv"))
                save_blendshape_coeffs(result[i, :frames], ARKIT_BLENDSHAPES, written[-1])
            print(f"mixed batches: {lo + len(chunk)}/{len(tasks)} samples")
        return written

    num_chunks = math.ceil(args.num_repeats / args.batch_size)
    for cdx, (person, base, frames, processed) in enumerate(clips):
        k = 0
        for chunk_idx in range(num_chunks):
            n = min(args.batch_size, args.num_repeats - chunk_idx * args.batch_size)
            result = generate(np.repeat(processed[None], n, axis=0))
            for i in range(n):
                written.append(os.path.join(args.output_dir, person, f"{base}-{k}.csv"))
                save_blendshape_coeffs(result[i, :frames], ARKIT_BLENDSHAPES, written[-1])
                k += 1
        print(f"[{cdx + 1}/{len(clips)}] {person}/{base}: {k} samples")
    return written


if __name__ == "__main__":
    main()
