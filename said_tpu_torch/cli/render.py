"""Render a blendshape-coefficient CSV to a video with audio.

Flag-compatible with ``said_tpu/cli/render.py`` (the reference's
``script/render.py``): a neutral mesh and 32 blendshape meshes, deformed
per frame, drawn by the host rasterizer and written as an MJPEG AVI with
the WAV as a PCM track (if it exists). ``--show_difference`` with
``--target_diff_blendshape_coeffs_path`` (or ``--target_coeffs_path``)
colours each vertex by its error against the target (viridis up to
``--max_diff``); ``--save_images`` also writes each frame as
``<output_images_dir>/<index>.png``. JPEG and PNG come from the port's
own encoders (numpy and zlib, no PIL). Path defaults stay in the working
directory; ``--compilation_cache_dir`` is TPU-only and not carried over.

    python -m said_tpu_torch.cli.render --neutral_path templates_head/<person>.obj \\
        --blendshapes_dir blendshapes_head/<person> --audio_path sentence01.wav \\
        --blendshape_coeffs_path out.csv --output_path out.avi
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from said_tpu_torch.cli._common import parse_cli_args, str2bool
from said_tpu_torch.data.assets import asset_path
from said_tpu_torch.data.blendvoca import BLENDSHAPE_CLASSES
from said_tpu_torch.render.rasterizer import Renderer, render_blendshape_coefficients
from said_tpu_torch.render.video import write_mjpeg_avi
from said_tpu_torch.utils.audio import load_audio
from said_tpu_torch.utils.blendshape import load_blendshape_coeffs
from said_tpu_torch.utils.mesh import load_mesh
from said_tpu_torch.utils.parser import parse_list
from said_tpu_torch.utils.png import write_png


def load_blendshape_setup(neutral_path: str, blendshapes_dir: str, names):
    """(neutral mesh, (3|V|, C) matrix of the blendshape meshes' vertices)."""
    neutral = load_mesh(neutral_path)
    matrix = np.stack([load_mesh(os.path.join(blendshapes_dir, f"{n}.obj")).vertices.reshape(-1) for n in names],
                      axis=1)
    return neutral, matrix


def blendshape_names(path: str):
    return parse_list(path, str) if os.path.exists(path) else BLENDSHAPE_CLASSES


def render_video(renderer, neutral, matrix, coeffs, output_path, fps, audio, target=None, max_diff=0.001):
    """Rasterize and write one video → (frames, rasterize s, encode s)."""
    t0 = time.perf_counter()
    frames = render_blendshape_coefficients(renderer, neutral, matrix, coeffs, target, max_diff=max_diff)
    t1 = time.perf_counter()
    write_mjpeg_avi(output_path, frames, fps, audio, 16000)
    return frames, t1 - t0, time.perf_counter() - t1


def add_arguments(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--neutral_path", type=str, default="templates_head/FaceTalk_170731_00024_TA.obj")
    parser.add_argument("--blendshapes_dir", type=str, default="blendshapes_head/FaceTalk_170731_00024_TA")
    parser.add_argument("--audio_path", type=str, default="audio/FaceTalk_170731_00024_TA/sentence01.wav")
    parser.add_argument("--blendshape_coeffs_path", type=str, default="out.csv")
    parser.add_argument("--target_coeffs_path", type=str, default=None,
                        help="optional GT CSV for a per-vertex error heatmap")
    # the reference's pair: the heatmap is gated on --show_difference and
    # reads --target_diff_blendshape_coeffs_path
    parser.add_argument("--show_difference", type=str2bool, default=False)
    parser.add_argument("--target_diff_blendshape_coeffs_path", type=str, default=None)
    parser.add_argument("--save_images", type=str2bool, default=False, help="also write each frame as a PNG")
    parser.add_argument("--output_images_dir", type=str, default="render_images")
    parser.add_argument("--blendshape_list_path", type=str, default=asset_path("ARKit_blendshapes.txt"))
    parser.add_argument("--output_path", type=str, default="out.avi")
    parser.add_argument("--fps", type=int, default=60)
    parser.add_argument("--max_diff", type=float, default=0.001)
    parser.add_argument("--width", type=int, default=800)
    parser.add_argument("--height", type=int, default=800)


def main(argv=None) -> dict:
    """Run the CLI; returns the frame count and the rasterize and encode
    seconds."""
    parser = argparse.ArgumentParser(description="Render the blendshape coefficients into a video (PyTorch port)")
    add_arguments(parser)
    args = parse_cli_args(parser, argv)

    neutral, matrix = load_blendshape_setup(args.neutral_path, args.blendshapes_dir,
                                            blendshape_names(args.blendshape_list_path))
    coeffs = load_blendshape_coeffs(args.blendshape_coeffs_path)
    target_path = args.target_coeffs_path or (
        args.target_diff_blendshape_coeffs_path if args.show_difference else None)
    target = load_blendshape_coeffs(target_path) if target_path else None
    if target is not None:
        n = min(len(coeffs), len(target))
        coeffs, target = coeffs[:n], target[:n]

    audio = load_audio(args.audio_path, 16000) if os.path.exists(args.audio_path) else None
    frames, raster_s, encode_s = render_video(Renderer(width=args.width, height=args.height), neutral, matrix,
                                              coeffs, args.output_path, args.fps, audio, target, args.max_diff)
    print(f"wrote {len(frames)} frames → {args.output_path} (rasterize {1e3 * raster_s / len(frames):.1f} ms a "
          f"frame, encode and mux {1e3 * encode_s / len(frames):.1f} ms a frame)")
    if args.save_images:
        os.makedirs(args.output_images_dir, exist_ok=True)
        for idx, frame in enumerate(frames):
            write_png(os.path.join(args.output_images_dir, f"{idx}.png"), frame)
        print(f"wrote {len(frames)} PNGs → {args.output_images_dir}")
    return {"frames": len(frames), "rasterize_s": raster_s, "encode_s": encode_s}


if __name__ == "__main__":
    main()
